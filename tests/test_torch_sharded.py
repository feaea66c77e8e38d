"""The port's model-parallel pieces over gloo ranks, against the port's
1-device path and the JAX package.

Each world size M in (1, 2, 4) is one ``torch.multiprocessing.spawn`` of M
ranks (a ``FileStore`` in ``tmp_path``, one thread each) that runs every
check of this file and writes its results; the test process holds them
against the references.  This module imports nothing of JAX at its top,
so the ranks, which import it, do not load it either.

* ``bucket_rows``: the tensor twin equals the numpy one.
* The routed lookup (reduced Criteo at ``k_multiple=4``, host-bucketed and
  device-bucketed rows): forward bit for bit the 1-device lookup and JAX's
  ``lookup_all``; the slab gradient under a fixed output gradient bit for
  bit the 1-device one (each row sums its terms in global batch order,
  ``index_add_`` on the CPU).
* ``materialize`` and ``assign_all`` over the group bit for bit the
  same without one; ``remap_moments`` over the group within rtol 1e-6
  (its counts exact); the pointer table's column-sharded at-rest layout
  through ``ptr_to_tile`` / ``ptr_from_tile`` and back.
* ``distributed_kmeans`` (one column) and ``kmeans_columns`` (three)
  against JAX's ``distributed_kmeans`` under ``jax.vmap(axis_name=)`` on
  the same stacked shards, column by column, JAX's kmeans++ seeds handed
  to the port (the port's float draws are not JAX's): centroids within
  rtol 1e-5, assignments equal; on one rank bit for bit the port's serial
  ``kmeans`` of each column.
* ``cluster`` over the group: on one rank bit for bit the same without
  one (from JAX's kmeans++ seeds), its ``hs`` on JAX's key schedule; on M
  ranks its pointers are the serial assignment to its centroids, equal on
  every rank.  (``test_torch_transition.py`` holds ``cluster`` against
  JAX's; an eager JAX ``cluster_sharded`` of this table takes ~100 s on a
  CPU.)
* The first sharded step: loss against JAX's serial ``bce_loss`` (rtol
  1e-5); on one rank loss, every param and moment bit for bit the 1-device
  step, and ``dlrm.cluster_tables`` bit for bit the serial transition; on
  M ranks the loss and MLP gradients within rtol 1e-5 of the 1-device
  ones, the slab gradient within 1e-6 relative (the MLP backward over B/M
  rows may round each example's embedding gradient otherwise).
* ``dlrm.cluster_tables(group=)`` on odd vocabularies (two pointer tables
  column-sharded at rest at M = 2, 4) and random moments, gathered whole:
  every CCE table's pointers bit for bit the serial ``assign_all`` to the
  centroids the group produced, its momentum within rtol 1e-6 of the
  serial ``remap_moments`` with those pointers (this holds the reshard of
  the slabs and of both at-rest pointer layouts around the transition).
* Per rank, the slab, its moments and every pointer table hold 1/M of the
  whole."""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLDS = (1, 2, 4)
B = 32  # the global batch
SEED = 0
RAGGED = dict(d1=1003, d2=16, k=12, c=4)  # an odd vocabulary: ptr column-sharded at M = 2, 4
CHUNK = 97
NITER = 6
KM_KEY = 7  # the k-means checks' keys: KM_KEY + column
TRAINER_STEPS = 4  # the one-rank trainer's run, a transition every 2 steps


def _trainer_args():
    import argparse

    return argparse.Namespace(emb="cce", emb_cap=512, seed=SEED, batch=B, accum=1, lr=0.05,
                              momentum=0.9, clip=1.0, ckpt_dir=None, ckpt_every=0,
                              cluster_every=2, fail_at=[], device="cpu")


def _group(rank, M, store):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_model_group

    return init_model_group("cpu", world_size=M, rank=rank, store=dist.FileStore(store, M))


def _mesh(M):
    """The (1, M) mesh over the world ``_group`` joined: its model group is
    the world."""
    from repro_torch.launch.mesh import Mesh

    return Mesh(1, M)


def _cfg():
    from repro_torch.configs import dlrm_criteo

    return dlrm_criteo.reduced(k_multiple=4)


def _ragged_cfg():
    """``_cfg`` with two odd vocabularies: at M = 2, 4 their pointer tables
    are column-sharded at rest, the others id-sharded."""
    import dataclasses

    return dataclasses.replace(_cfg(), vocab_sizes=(1000, 5001, 20000, 100, 50003))


def _batch(cfg):
    from repro_torch.data.synthetic import ClickstreamConfig, clickstream_batches

    return next(clickstream_batches(ClickstreamConfig(vocab_sizes=cfg.vocab_sizes, seed=SEED), B))


def _init(cfg):
    from repro_torch.models import dlrm

    return dlrm.init(cfg, torch.Generator().manual_seed(SEED), device="cpu")


def _ragged():
    """A small CCE table with an odd vocabulary, its params, a random
    pointer table and moments, and centroids (numpy-seeded)."""
    from repro_torch.core.cce import CCE

    t = CCE(**RAGGED, seed_salt=3)
    rng = np.random.default_rng(11)
    params = {"tables": torch.from_numpy(rng.normal(size=(t.c, 2, t.k, t.dsub)).astype(np.float32))}
    b = t.init_buffers()
    buffers = {"ptr": torch.from_numpy(rng.integers(0, t.k, (t.c, t.d1)).astype(np.int32)),
               "hs": torch.from_numpy(b["hs"].astype(np.int64)),
               "epoch": torch.tensor(2, dtype=torch.int32)}
    new_ptr = torch.from_numpy(rng.integers(0, t.k, (t.c, t.d1)).astype(np.int32))
    moments = {"tables": torch.from_numpy(
        rng.normal(size=(t.c, 2, t.k, t.dsub)).astype(np.float32))}
    cents = torch.from_numpy(rng.normal(size=(t.c, t.k, t.dsub)).astype(np.float32))
    weights = torch.from_numpy(rng.integers(0, 9, t.d1).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, t.d1, 200))
    return t, params, buffers, new_ptr, moments, cents, weights, ids


def _kmeans_shards(M):
    """(M, 48, 4) stacked sample shards of 6 blobs and their weights."""
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(6, 4)) * 3.0
    x = centers[rng.integers(0, 6, M * 48)] + rng.normal(size=(M * 48, 4)) * 0.3
    w = rng.integers(1, 9, M * 48).astype(np.float32)
    return x.astype(np.float32).reshape(M, 48, 4), w.reshape(M, 48)


def _columns(x):
    """Three columns of points from ``_kmeans_shards``' (M, n, d): (3, M, n, d)."""
    return np.stack([x, x[:, ::-1], x * 2]).astype(np.float32)


def _transition_against_serial(cfg, before, new, counts):
    """Of every CCE table of the universal group, the whole pointers and
    momentum that ``cluster_tables(group=)`` gave (``new``: params, ebuf,
    opt), beside the serial ``assign_all`` to its centroids and the serial
    ``remap_moments`` with its pointers, from the whole state ``before``."""
    from repro_torch.core.cce import CCE

    coll = cfg.collection
    g = coll.univ_groups[0]
    grp = coll.groups[g]
    old_p = coll.unstack_group_params(grp, before.params["emb"][g])
    old_m = coll.unstack_group_params(grp, before.opt["m"]["emb"][g])
    new_p = coll.unstack_group_params(grp, new[0]["emb"][g])
    new_m = coll.unstack_group_params(grp, new[2]["m"]["emb"][g])
    out = {}
    for f, t in enumerate(grp.tables):
        if not isinstance(t, CCE):
            continue
        old_b, ptr = before.ebuf["emb"][g][f], new[1]["emb"][g][f]["ptr"]
        cents = new_p[f]["tables"][:, 0]
        out[f"tr_ptr_{f}"] = ptr.numpy()
        out[f"tr_ptr_ref_{f}"] = t.assign_all(old_p[f], old_b, cents,
                                              chunk_size=CHUNK * 10).numpy()
        out[f"tr_m_{f}"] = new_m[f]["tables"].numpy()
        out[f"tr_m_ref_{f}"] = t.remap_moments(
            old_m[f], old_b, dict(old_b, ptr=ptr), chunk_size=CHUNK * 10,
            id_weights=torch.from_numpy(counts[grp.features[f]]))["tables"].numpy()
    return out


def _rank_main(rank, M, store, out, seeds):
    """Every check's sharded side on this rank; writes ``{out}/{rank}.npz``."""
    from repro_torch import random as jr
    from repro_torch.core import kmeans as tkm
    from repro_torch.core.cce import CCE
    from repro_torch.core.collection import bucket_rows
    from repro_torch.data.translate import HostTranslator
    from repro_torch.launch.steps import build_dlrm_train_step, dlrm_state_specs
    from repro_torch.models import dlrm
    from repro_torch.optim import sgd
    from repro_torch.shard import gather_tree, shard_tree
    from repro_torch.train import loop
    from repro_torch.train.transition import ptr_from_tile, ptr_to_tile
    from repro_torch.tree import tree_leaves, tree_map

    group = _group(rank, M, store)
    mesh = _mesh(M)
    own_kmeans_pp = tkm.kmeans_plus_plus
    res = {}
    cfg = _cfg()
    coll = cfg.collection
    params, buffers = _init(cfg)
    raw = _batch(cfg)
    b = B // M
    mine = slice(rank * b, (rank + 1) * b)

    # bucket_rows' twins
    rows_np = np.random.default_rng(1).integers(-1, 16, (5, 3, 7)).astype(np.int32)
    res["bucket_equal"] = np.array_equal(
        bucket_rows(torch.from_numpy(rows_np), 4, 4).numpy(), bucket_rows(rows_np, 4, 4))

    # the routed lookup: forward, and the slab gradient under a fixed dout
    opt = sgd(momentum=0.9)
    whole = loop.init_state(tree_map(torch.clone, params), opt, buffers)
    specs = dlrm_state_specs(cfg, whole, M)
    st = shard_tree(whole, specs, rank, M)
    g = coll.univ_groups[0]
    rows_b = torch.from_numpy(
        HostTranslator(coll, buffers["emb"], n_shards=M).rows(raw["sparse"][mine]))
    rows_g = torch.from_numpy(HostTranslator(coll, buffers["emb"]).rows(raw["sparse"][mine]))
    dout = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, cfg.n_sparse, cfg.emb_dim)).astype(np.float32))[mine]
    slab = st.params["emb"][g]["tables"].detach().requires_grad_(True)
    emb_p = list(st.params["emb"])
    emb_p[g] = {"tables": slab}
    fwd = coll.lookup_all(emb_p, st.ebuf["emb"], None, rows=rows_b, group=group)
    (grad,) = torch.autograd.grad(fwd, slab, dout)
    res["lookup"] = fwd.detach().numpy()
    res["lookup_device_bucketed"] = coll.lookup_all(
        st.params["emb"], st.ebuf["emb"], None, rows=rows_g, group=group).numpy()
    res["slab_grad"] = grad.numpy()

    # per-rank bytes of the slab, its moments and the pointer tables
    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree))

    ptrs = [fb["ptr"] for fb in st.ebuf["emb"][g] if "ptr" in fb]
    res["bytes"] = np.array([nbytes(st.params["emb"][g]), nbytes(st.opt["m"]["emb"][g]),
                             nbytes(ptrs)])

    # the transition's pieces on a ragged table
    t, tp, tb, new_ptr, moments, cents, weights, ids = _ragged()
    from repro_torch.launch.mesh import ptr_partition_spec

    dim = ptr_partition_spec(t.c, t.d1, M)
    at_rest = shard_tree(tb["ptr"], dim, rank, M)
    tile = ptr_to_tile(t, at_rest, dim, group)
    res["tile_equal"] = torch.equal(tile, t.ptr_tile(tb["ptr"], rank, M))
    res["at_rest_equal"] = torch.equal(ptr_from_tile(t, tile, dim, group), at_rest)
    tiled = dict(tb, ptr=tile)
    res["materialize"] = t.materialize(tp, tiled, ids, group).numpy()
    res["assign_tile"] = t.assign_all(tp, tiled, cents, group=group, chunk_size=CHUNK).numpy()
    new_tiled = dict(tb, ptr=t.ptr_tile(new_ptr, rank, M))
    for w_name, w in (("", None), ("_weighted", weights)):
        rm = t.remap_moments(moments, tiled, new_tiled, group=group, chunk_size=CHUNK,
                             id_weights=w)
        res["remap" + w_name] = rm["tables"].numpy()

    # distributed k-means from JAX's seeds of shard 0
    x, w = _kmeans_shards(M)
    for name, wt in (("km", None), ("km_weighted", w)):
        tkm.kmeans_plus_plus = lambda *a, _s=seeds[name]: torch.tensor(_s)
        c, a = tkm.distributed_kmeans(jr.PRNGKey(KM_KEY), torch.from_numpy(x[rank]), 6, group,
                                      niter=NITER,
                                      weights=None if wt is None else torch.from_numpy(wt[rank]))
        res[name + "_c"], res[name + "_a"] = c.numpy(), a.numpy()
    # three columns in lockstep, from JAX's seeds of each column's shard 0
    it = iter(seeds["columns"])
    tkm.kmeans_plus_plus = lambda *a: torch.tensor(next(it))
    res["columns"] = tkm.kmeans_columns([jr.PRNGKey(KM_KEY + i) for i in range(3)],
                                        torch.from_numpy(_columns(x)[:, rank]), 6, group,
                                        niter=NITER).numpy()

    # cluster over the group, on one rank from JAX's seeds of each column handed over in order
    tkm.kmeans_plus_plus = own_kmeans_pp
    if seeds["cluster"] is not None:
        it = iter(seeds["cluster"])
        tkm.kmeans_plus_plus = lambda *a: torch.tensor(next(it))
    cp, cb = t.cluster(jr.PRNGKey(6), tp, tiled, group=group, niter=NITER, chunk_size=CHUNK)
    res["cluster_tables"], res["cluster_tile"] = cp["tables"].numpy(), cb["ptr"].numpy()
    res["cluster_hs"], res["cluster_epoch"] = cb["hs"].numpy(), cb["epoch"].numpy()

    # the first sharded step, and (one rank) the sharded transition
    step, _ = build_dlrm_train_step(cfg, mesh, specs, batch_size=B, optimizer=opt,
                                    lr_fn=lambda s: 0.05)
    mb = {"dense": torch.from_numpy(raw["dense"][mine])[None],
          "label": torch.from_numpy(raw["label"][mine])[None], "rows": rows_b[None]}
    pre = tree_map(torch.clone, st.params)
    loss, grads = loop.value_and_grad(
        lambda p, bb, m: (dlrm.bce_loss(p, bb, cfg, m, group=group, global_batch=B), {}),
        pre, st.ebuf, tree_map(lambda v: v[0], mb))
    from repro_torch.launch.steps import GradSync

    GradSync(specs.params, mesh).grads(grads)
    gathered = gather_tree(grads, specs.params, group)
    res["grad_leaves"] = np.array([len(tree_leaves(gathered))])
    for i, leaf in enumerate(tree_leaves(gathered)):
        res[f"grad_{i}"] = leaf.numpy()
    st, m = step(st, mb)
    res["loss"] = np.float32(m["loss"].item())
    res["gnorm"] = np.float32(m["gnorm"].item())
    after = gather_tree(st, specs, group)
    for i, leaf in enumerate(tree_leaves((after.params, after.opt))):
        res[f"state_{i}"] = leaf.numpy()
    # the transition over the group, gathered whole, against the serial pieces, on
    # odd vocabularies (two pointer tables column-sharded at rest) and random moments
    tkm.kmeans_plus_plus = own_kmeans_pp
    rcfg = _ragged_cfg()
    rp, rb = _init(rcfg)
    gen = torch.Generator().manual_seed(SEED)
    rwhole = loop.init_state(rp, opt, rb)
    rwhole = rwhole._replace(opt=tree_map(lambda x: torch.randn(x.shape, generator=gen),
                                          rwhole.opt))
    rspecs = dlrm_state_specs(rcfg, rwhole, M)
    rst = shard_tree(rwhole, rspecs, rank, M)
    rcounts = [np.bincount(_batch(rcfg)["sparse"][:, f], minlength=v)
               for f, v in enumerate(rcfg.vocab_sizes)]
    new = dlrm.cluster_tables(jr.PRNGKey(3), rst.params, rst.ebuf, rcfg, rst.opt,
                              id_counts=rcounts, chunk_size=CHUNK * 10, group=group)
    new = (gather_tree(new[0], rspecs.params, group), gather_tree(new[1], rspecs.ebuf, group),
           gather_tree(new[2], rspecs.opt, group))
    if rank == 0:
        res.update(_transition_against_serial(rcfg, rwhole, new, rcounts))
        res["ptr_dims"] = np.array([-1 if d is None else d for d in (
            ptr_partition_spec(t.c, t.d1, M) for t in rcfg.collection.tables
            if isinstance(t, CCE))])
    if M == 1:
        counts = [np.bincount(raw["sparse"][:, f], minlength=v)
                  for f, v in enumerate(cfg.vocab_sizes)]
        new = dlrm.cluster_tables(jr.PRNGKey(3), st.params, st.ebuf, cfg, st.opt,
                                  id_counts=counts, chunk_size=CHUNK * 10, group=group)
        for i, leaf in enumerate(tree_leaves(new)):
            res[f"transition_{i}"] = leaf.numpy()
        from repro_torch.launch.train import build_dlrm_sharded_trainer

        tr = build_dlrm_sharded_trainer(cfg, _trainer_args(), mesh=mesh)
        tr.run(TRAINER_STEPS)
        res["trainer_losses"] = np.array([h["loss"] for h in tr.history])
        for i, leaf in enumerate(tree_leaves((tr.state.params, tr.state.opt, tr.state.ebuf))):
            res[f"trainer_{i}"] = leaf.numpy()
    np.savez(os.path.join(out, f"{rank}.npz"), **res)
    dist.destroy_process_group()


def _jax_seeds(M):
    """JAX's kmeans++ seeds: of shard 0 of ``_kmeans_shards`` (unweighted
    and weighted) and of each of its ``_columns``, and on one rank of each
    column of the ragged table's sample (``cluster`` draws its sample
    uniformly)."""
    import jax
    import jax.numpy as jnp

    from repro.core import kmeans as jkm
    from repro_torch import random as jr

    x, w = _kmeans_shards(M)
    key = jax.random.PRNGKey(KM_KEY)
    out = {"km_weighted": np.asarray(jkm.kmeans_plus_plus(key, jnp.asarray(x[0]), 6,
                                                          jnp.asarray(w[0]))),
           "columns": [np.asarray(jkm.kmeans_plus_plus(jax.random.PRNGKey(KM_KEY + i),
                                                       jnp.asarray(xc[0]), 6))
                       for i, xc in enumerate(_columns(x))]}
    out["km"] = out["columns"][0]
    if M > 1:  # cluster_sharded on M ranks runs the port's own kmeans++
        out["cluster"] = None
        return out
    t, tp, tb, *_ = _ragged()
    k1, k2 = jr.split(jr.fold_in(jr.PRNGKey(6), int(tb["epoch"])))
    from repro_torch.core import kmeans as tkm

    sample_ids = tkm.subsample(k1, t.d1, t.k, device="cpu")
    n = sample_ids.shape[0] - sample_ids.shape[0] % M
    sample = t.materialize(tp, tb, sample_ids[:n]).numpy()
    out["cluster"] = [np.asarray(jkm.kmeans_plus_plus(
        jnp.asarray(np.asarray(jr.fold_in(k2, i), np.uint32)),
        jnp.asarray(sample[i, : n // M]), t.k)) for i in range(t.c)]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{M: [rank results]} for every world size, and {M: JAX's seeds}
    under "seeds"."""
    out = {"seeds": {M: _jax_seeds(M) for M in WORLDS}}
    dirs = {M: tmp_path_factory.mktemp(f"world{M}") for M in WORLDS}
    ctxs = [mp.spawn(_rank_main, args=(M, str(d / "store"), str(d), out["seeds"][M]),
                     nprocs=M, join=False) for M, d in dirs.items()]  # the worlds side by side
    for ctx in ctxs:
        while not ctx.join():
            pass
    for M, d in dirs.items():
        out[M] = [dict(np.load(d / f"{r}.npz")) for r in range(M)]
    return out


def _rows_1dev(cfg, params, buffers, raw):
    from repro_torch.data.translate import HostTranslator

    return torch.from_numpy(HostTranslator(cfg.collection, buffers["emb"]).rows(raw["sparse"]))


@pytest.mark.parametrize("M", WORLDS)
def test_bucket_rows_twins_and_routed_lookup(runs, M):
    """The routed lookup's forward, host- and device-bucketed, equals the
    1-device lookup and JAX's ``lookup_all`` bit for bit; its slab gradient
    under a fixed output gradient equals the 1-device one bit for bit."""
    import jax.numpy as jnp

    from repro.configs import dlrm_criteo as jcfg
    from repro_torch import convert
    from repro_torch.kernels import ref as kref

    cfg = _cfg()
    coll = cfg.collection
    params, buffers = _init(cfg)
    raw = _batch(cfg)
    rows = _rows_1dev(cfg, params, buffers, raw)
    g = coll.univ_groups[0]
    ref = coll.lookup_all(params["emb"], buffers["emb"], None, rows=rows).numpy()
    jc = jcfg.reduced(k_multiple=4)
    jref = np.asarray(jc.collection.lookup_all(
        convert.to_numpy(params)["emb"], convert.to_numpy(buffers)["emb"], None,
        use_kernel=False, rows=jnp.asarray(rows.numpy())))
    np.testing.assert_array_equal(ref, jref)
    dout = np.random.default_rng(2).normal(size=(B, cfg.n_sparse, cfg.emb_dim)).astype(np.float32)
    want_grad = kref.cce_lookup_bwd_ref(
        rows.movedim(0, 1), torch.from_numpy(dout).reshape(B, coll.groups[g].n_cols, -1),
        coll.groups[g].k_pad).numpy()
    res = runs[M]
    assert all(bool(r["bucket_equal"]) for r in res)
    np.testing.assert_array_equal(np.concatenate([r["lookup"] for r in res]), ref)
    np.testing.assert_array_equal(np.concatenate([r["lookup_device_bucketed"] for r in res]), ref)
    np.testing.assert_array_equal(np.concatenate([r["slab_grad"] for r in res], axis=2), want_grad)


@pytest.mark.parametrize("M", WORLDS)
def test_per_rank_bytes_are_a_shard(runs, M):
    cfg = _cfg()
    params, buffers = _init(cfg)
    g = cfg.collection.univ_groups[0]
    slab = params["emb"][g]["tables"]
    ptr = sum(fb["ptr"].numel() * 4 for fb in buffers["emb"][g] if "ptr" in fb)
    whole = np.array([slab.numel() * 4, slab.numel() * 4, ptr])
    for r in runs[M]:
        np.testing.assert_array_equal(r["bytes"] * M, whole)


@pytest.mark.parametrize("M", WORLDS)
def test_transition_pieces_against_serial(runs, M):
    """``materialize_sharded`` and ``assign_all_sharded`` bit for bit;
    ``remap_moments_sharded`` within rtol 1e-6 (bit for bit on one rank);
    the ptr layouts round-trip."""
    t, tp, tb, new_ptr, moments, cents, weights, ids = _ragged()
    res = runs[M]
    assert all(bool(r["tile_equal"]) and bool(r["at_rest_equal"]) for r in res)
    want = t.materialize(tp, tb, ids).numpy()
    for r in res:
        np.testing.assert_array_equal(r["materialize"], want)
    got = np.concatenate([r["assign_tile"] for r in res], axis=1)[:, : t.d1]
    np.testing.assert_array_equal(got, t.assign_all(tp, tb, cents, chunk_size=CHUNK).numpy())
    new_b = dict(tb, ptr=new_ptr)
    for w_name, w in (("", None), ("_weighted", weights)):
        want = t.remap_moments(moments, tb, new_b, chunk_size=CHUNK, id_weights=w)["tables"].numpy()
        for r in res:
            if M == 1:
                np.testing.assert_array_equal(r["remap" + w_name], want)
            else:
                np.testing.assert_allclose(r["remap" + w_name], want, rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(r["remap" + w_name], res[0]["remap" + w_name])


@pytest.mark.parametrize("M", WORLDS)
def test_distributed_kmeans_matches_jax_vmap(runs, M):
    """``distributed_kmeans`` at M = 2, 4 and ``kmeans_columns`` at every M:
    JAX's ``distributed_kmeans`` under ``jax.vmap``, column by column; one
    rank: the port's serial ``kmeans`` from the same seeds, bit for bit."""
    import jax
    import jax.numpy as jnp

    from repro.core import kmeans as jkm
    from repro_torch import random as jr
    from repro_torch.core import kmeans as tkm

    x, w = _kmeans_shards(M)
    seeds = runs["seeds"][M]
    cols = _columns(x)  # column 0 is x itself
    keys = jnp.stack([jax.random.PRNGKey(KM_KEY + i) for i in range(len(cols))])
    jc, ja = jax.jit(jax.vmap(lambda kc, xc: jax.vmap(lambda xs: jkm.distributed_kmeans(
        kc, xs, 6, "data", niter=NITER), axis_name="data")(xc)))(keys, jnp.asarray(cols))
    wc, wa = jax.jit(jax.vmap(lambda xs, ws: jkm.distributed_kmeans(
        keys[0], xs, 6, "data", niter=NITER, weights=ws), axis_name="data"))(
        jnp.asarray(x), jnp.asarray(w))
    for r, res in enumerate(runs[M]):
        np.testing.assert_allclose(res["columns"], np.asarray(jc[:, r]), rtol=1e-5, atol=1e-5)
        for name, c, a in (("km", jc[0, r], ja[0, r]), ("km_weighted", wc[r], wa[r])):
            np.testing.assert_allclose(res[name + "_c"], np.asarray(c), rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(res[name + "_a"], np.asarray(a))
    if M > 1:
        return

    def serial(xs, seed, wt=None):
        with pytest.MonkeyPatch.context() as mpatch:
            mpatch.setattr(tkm, "kmeans_plus_plus", lambda *a: torch.tensor(seed))
            return tkm.kmeans(jr.PRNGKey(0), torch.from_numpy(xs), 6, niter=NITER,
                              weights=wt).centroids

    res = runs[1][0]
    for i, xc in enumerate(cols):
        np.testing.assert_array_equal(res["columns"][i],
                                      serial(xc[0], seeds["columns"][i]).numpy())
    for name, wt in (("km", None), ("km_weighted", torch.from_numpy(w[0]))):
        c = serial(x[0], seeds[name], wt)
        np.testing.assert_array_equal(res[name + "_c"], c.numpy())
        np.testing.assert_array_equal(res[name + "_a"],
                                      tkm.assign(torch.from_numpy(x[0]), c).numpy())


@pytest.mark.parametrize("M", WORLDS)
def test_cluster_sharded(runs, M):
    """One rank: ``cluster`` bit for bit (same seeds), hs on JAX's key
    schedule.  M ranks: the pointers are the serial assignment to the
    centroids."""
    from repro_torch import random as jr
    from repro_torch.core import kmeans as tkm

    t, tp, tb, *_ = _ragged()
    res = runs[M]
    tables = res[0]["cluster_tables"]
    ptr = np.concatenate([r["cluster_tile"] for r in res], axis=1)[:, : t.d1]
    for r in res:
        np.testing.assert_array_equal(r["cluster_tables"], tables)
        np.testing.assert_array_equal(r["cluster_hs"], res[0]["cluster_hs"])
        assert int(r["cluster_epoch"]) == int(tb["epoch"]) + 1
    cents = torch.from_numpy(tables[:, 0])
    np.testing.assert_array_equal(ptr, t.assign_all(tp, tb, cents, chunk_size=CHUNK).numpy())
    if M > 1:
        return
    seeds = iter(runs["seeds"][1]["cluster"])
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(tkm, "kmeans_plus_plus", lambda *a: torch.tensor(next(seeds)))
        sp, sb = t.cluster(jr.PRNGKey(6), tp, tb, niter=NITER, chunk_size=CHUNK)
    np.testing.assert_array_equal(tables, sp["tables"].numpy())
    np.testing.assert_array_equal(ptr, sb["ptr"].numpy())
    np.testing.assert_array_equal(res[0]["cluster_hs"], sb["hs"].numpy())

    # hs on the JAX package's key schedule
    import jax

    from repro.core import hashing as jhash

    _, k2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(6), int(tb["epoch"])))
    want = jhash.pack_hashes(jhash.make_hashes(jax.random.fold_in(k2, 777), t.c, t.k))
    np.testing.assert_array_equal(res[0]["cluster_hs"], np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("M", WORLDS)
def test_first_sharded_step(runs, M):
    """The loss against JAX's serial ``bce_loss``; against the port's
    1-device step: bit for bit on one rank (loss, params, moments, and the
    transition after it), within rtol 1e-5 on M ranks (loss, MLP
    gradients), the slab gradient within 1e-6 relative."""
    import jax.numpy as jnp

    from repro.configs import dlrm_criteo as jcfg
    from repro.models import dlrm as jdlrm
    from repro_torch import convert
    from repro_torch import random as jr
    from repro_torch.models import dlrm
    from repro_torch.optim import sgd
    from repro_torch.train import loop
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _cfg()
    params, buffers = _init(cfg)
    raw = _batch(cfg)
    rows = _rows_1dev(cfg, params, buffers, raw)
    jc = jcfg.reduced(k_multiple=4)
    jloss = float(jdlrm.bce_loss(
        convert.to_numpy(params), convert.to_numpy(buffers), jc,
        {"dense": jnp.asarray(raw["dense"]), "label": jnp.asarray(raw["label"]),
         "rows": jnp.asarray(rows.numpy())}))
    res = runs[M]
    np.testing.assert_allclose(float(res[0]["loss"]), jloss, rtol=1e-5)

    def lf(p, b, mb):
        return dlrm.bce_loss(p, b, cfg, mb), {}

    mb = {"dense": torch.from_numpy(raw["dense"])[None],
          "label": torch.from_numpy(raw["label"])[None], "rows": rows[None]}
    _, grads = loop.value_and_grad(lf, params, buffers, tree_map(lambda v: v[0], mb))
    opt = sgd(momentum=0.9)
    state = loop.init_state(tree_map(torch.clone, params), opt, buffers)
    step = loop.make_train_step(lf, opt, lambda s: 0.05)
    state, m = step(state, mb)
    want_state = [x.numpy() for x in tree_leaves((state.params, state.opt))]
    g_slab = cfg.collection.univ_groups[0]
    slab_i = [i for i, x in enumerate(tree_leaves(grads))
              if x is grads["emb"][g_slab]["tables"]]
    for r in res:
        assert float(r["loss"]) == float(res[0]["loss"])
        got = [r[f"grad_{i}"] for i in range(int(r["grad_leaves"][0]))]
        for i, (a, want) in enumerate(zip(got, tree_leaves(grads))):
            want = want.numpy()
            if M == 1:
                np.testing.assert_array_equal(a, want)
            elif i in slab_i:
                np.testing.assert_allclose(a, want, rtol=0, atol=1e-6 * np.abs(want).max())
            else:
                np.testing.assert_allclose(a, want, rtol=1e-5, atol=1e-7)
    if M == 1:
        assert float(res[0]["loss"]) == m["loss"].item()
        assert float(res[0]["gnorm"]) == m["gnorm"].item()
        for i, want in enumerate(want_state):
            np.testing.assert_array_equal(res[0][f"state_{i}"], want)
        counts = [np.bincount(raw["sparse"][:, f], minlength=v)
                  for f, v in enumerate(cfg.vocab_sizes)]
        new = dlrm.cluster_tables(jr.PRNGKey(3), state.params, state.ebuf, cfg, state.opt,
                                  id_counts=counts, chunk_size=CHUNK * 10)
        for i, want in enumerate(tree_leaves(new)):
            np.testing.assert_array_equal(res[0][f"transition_{i}"], want.numpy())
    else:
        np.testing.assert_allclose(float(res[0]["loss"]), m["loss"].item(), rtol=1e-5)
        for i, want in enumerate(want_state):
            np.testing.assert_allclose(res[0][f"state_{i}"], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("M", WORLDS)
def test_cluster_tables_over_the_group_against_serial(runs, M):
    """``dlrm.cluster_tables(group=)`` gathered whole: each CCE table's
    pointers bit for bit the serial assignment to the group's centroids,
    its momentum within rtol 1e-6 of the serial remap with those pointers
    (bit for bit on one rank)."""
    r = runs[M][0]
    names = sorted(n[len("tr_ptr_ref_"):] for n in r if n.startswith("tr_ptr_ref_"))
    assert names
    assert (0 in r["ptr_dims"]) == (M > 1)  # both at-rest layouts are resharded
    for f in names:
        np.testing.assert_array_equal(r[f"tr_ptr_{f}"], r[f"tr_ptr_ref_{f}"])
        if M == 1:
            np.testing.assert_array_equal(r[f"tr_m_{f}"], r[f"tr_m_ref_{f}"])
        else:
            np.testing.assert_allclose(r[f"tr_m_{f}"], r[f"tr_m_ref_{f}"], rtol=1e-6, atol=1e-7)


def test_one_rank_trainer_equals_the_1device_trainer(runs):
    """``build_dlrm_sharded_trainer`` on one rank (host-translated rows, the
    tracker fed the global ids, the sharded transitions) against
    ``build_dlrm_trainer`` with the dense tracker: every loss and every
    state leaf bit for bit through two transitions."""
    from repro_torch.launch import train as tlaunch
    from repro_torch.tree import tree_leaves

    tr = tlaunch.build_dlrm_trainer(_cfg(), _trainer_args())
    tr.run(TRAINER_STEPS)
    assert tr.clusters_done == TRAINER_STEPS // 2
    res = runs[1][0]
    np.testing.assert_array_equal(res["trainer_losses"], [h["loss"] for h in tr.history])
    for i, want in enumerate(tree_leaves((tr.state.params, tr.state.opt, tr.state.ebuf))):
        np.testing.assert_array_equal(res[f"trainer_{i}"], want.numpy())
