"""The port's model-parallel DLRM trainer and its checkpoints: cheap
versions of the JAX package's slow ``test_sharded_train.py`` cases.

The 4-rank trainers run as gloo ranks of ``torch.multiprocessing.spawn``
(a ``FileStore`` in ``tmp_path``, one thread each); this module imports
nothing of JAX at its top, so the ranks, which import it, do not load it.

* ``build_dlrm_sharded_trainer`` on 4 ranks (reduced Criteo at cap 300,
  ``k_multiple=4``: k_pad 12 where the 1-device layout has 9) through two
  sharded transitions: finite losses, the state still a shard on every
  rank (slab, moments and pointer tables at 1/4 of their bytes).
* Its checkpoint (gathered to rank 0, the whole layout) restores into a
  1-device port trainer at ``k_multiple=1`` through
  ``dlrm.checkpoint_migrations`` bit for bit (compared through the
  per-feature view), and trains on.
* A 1-device port trainer's checkpoint (k_multiple 1) and one written by
  the JAX package at k_multiple 4 restore into the 4-rank trainer bit for
  bit, and it trains on; the JAX one restores into the 1-device port
  trainer too.
* The per-feature and pre-universal ("group") layout migrations: the
  port's ``to_old`` equals JAX's on the same state, and a checkpoint
  written in the old layout by the JAX package restores bit for bit.
* ``ptr_partition_spec``'s policy, and the launcher's refusals:
  ``--data-shards 2`` in a world of one process, and ``--model-shards 2``
  on ``cuda`` with one card.
"""
import argparse
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

M = 4
SEED = 0
CAP = 300  # k = 9: k_pad 9 at k_multiple 1 and 12 at 4, so the migrations fire
B = 32
STEPS = 6  # the 4-rank run: transitions at 3 and 6, its checkpoint at 6


def _cfg(k_multiple: int, cap: int = CAP):
    from repro_torch.configs import dlrm_criteo

    return dlrm_criteo.reduced(cap=cap, k_multiple=k_multiple)


def _args(ckpt_dir=None, ckpt_every=0, cluster_every=0, seed=SEED):
    return argparse.Namespace(emb="cce", emb_cap=CAP, seed=seed, batch=B, accum=1, lr=0.05,
                              momentum=0.9, clip=1.0, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                              cluster_every=cluster_every, fail_at=[], device="cpu")


def _group(rank, store):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_model_group

    return init_model_group("cpu", world_size=M, rank=rank, store=dist.FileStore(store, M))


def _per_feature(cfg, state) -> list:
    """The emb params, moments and buffers through the per-feature view,
    and the MLPs, as numpy leaves in ``jax.tree`` order: equal for two
    states that differ only in ``k_multiple`` padding."""
    from repro_torch import convert
    from repro_torch.tree import jax_leaves

    coll = cfg.collection
    trees = [coll.unstack_params(state.params["emb"]), coll.unstack_params(state.opt["m"]["emb"]),
             coll.unstack_buffers(state.ebuf["emb"]), state.params["bottom"], state.params["top"]]
    return [np.asarray(x) for x in jax_leaves(convert.to_numpy(trees))]


def _assert_same(got: list, want: list):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _shard_bytes_ok(tr) -> bool:
    """Every split leaf of the trainer's state is 1/M of its whole."""
    from repro_torch.launch.steps import _pairs

    pairs = _pairs(tr.state, tr.specs)
    splits = [(x, d) for x, d, _ in pairs if d is not None]
    return bool(splits) and all(
        x.numel() * M == torch.Size([s * (M if i == d else 1) for i, s in
                                     enumerate(x.shape)]).numel() for x, d in splits)


def _rank_main(rank, store, out, ckpt_dir, cases):
    """The 4-rank trainer through two transitions (rank 0 writes its losses
    and whole state); then each of ``cases`` (checkpoint dir, step,
    per-feature leaves, id counts) restores into a fresh 4-rank trainer bit
    for bit, as a shard, and trains on."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import build_dlrm_sharded_trainer
    from repro_torch.shard import gather_tree

    group = _group(rank, store)
    mesh = Mesh(1, M)
    cfg = _cfg(M)
    tr = build_dlrm_sharded_trainer(cfg, _args(ckpt_dir, ckpt_every=STEPS, cluster_every=3),
                                    mesh=mesh)
    tr.run(STEPS)
    assert tr.clusters_done == 2, tr.clusters_done
    losses = [h["loss"] for h in tr.history]
    assert all(np.isfinite(losses)), losses
    assert _shard_bytes_ok(tr)
    g = cfg.collection.univ_groups[0]
    assert tr.state.params["emb"][g]["tables"].shape[2] * M == cfg.collection.groups[g].k_pad
    whole = gather_tree(tr.state, tr.specs, group)
    if rank == 0:
        np.savez(os.path.join(out, "train.npz"), losses=np.array(losses),
                 *_per_feature(cfg, whole))
    for ckpt, step, want, counts in cases:
        tr = build_dlrm_sharded_trainer(cfg, _args(ckpt, seed=SEED + 7), mesh=mesh)
        assert tr.restore_latest() == step
        assert _shard_bytes_ok(tr)
        _assert_same(_per_feature(cfg, gather_tree(tr.state, tr.specs, group)), want)
        for a, b in zip(tr.id_tracker.counts, counts):
            np.testing.assert_array_equal(a, b)
        tr.run(1)
        assert np.isfinite(tr.history[-1]["loss"])
    if rank == 0:
        np.save(os.path.join(out, "restored.npy"), np.array(len(cases)))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One spawn of 4 ranks: the run (its checkpoint directory and rank
    0's record), then the 1-device port trainer's and the JAX package's
    checkpoints restored into it (how many did)."""
    from repro_torch.launch.train import build_dlrm_trainer

    d = tmp_path_factory.mktemp("shard4")
    ckpt = d / "ckpt"
    cfg1 = _cfg(1)
    tr1 = build_dlrm_trainer(cfg1, _args(str(d / "one"), ckpt_every=2))
    tr1.run(2)
    tr1.ckpt.wait()
    _, jstate, counts = _jax_state(M)
    _save_jax(d / "jax", jstate, counts)
    cases = [(str(d / "one"), 2, _per_feature(cfg1, tr1.state), tr1.id_tracker.counts),
             (str(d / "jax"), 5, _per_feature(_cfg(M), _port_state(jstate)), counts)]
    mp.spawn(_rank_main, args=(str(d / "store"), str(d), str(ckpt), cases), nprocs=M)
    rec = np.load(d / "train.npz")
    leaves = [rec[f"arr_{i}"] for i in range(len(rec.files) - 1)]
    return str(ckpt), rec["losses"], leaves, int(np.load(d / "restored.npy"))


def test_sharded_trainer_through_two_transitions(trained):
    """Two sharded transitions, finite losses, every rank's state a shard
    (asserted on the ranks), and the run wrote its checkpoint."""
    from repro_torch.checkpoint import list_checkpoints

    ckpt, losses, _, _ = trained
    assert len(losses) == STEPS and np.isfinite(losses).all()
    assert [s for s, _ in list_checkpoints(ckpt)] == [STEPS]


def test_4shard_checkpoint_restores_into_a_1device_trainer(trained):
    from repro_torch.launch.train import build_dlrm_trainer

    ckpt, _, want, _ = trained
    cfg1 = _cfg(1)
    tr = build_dlrm_trainer(cfg1, _args(ckpt, seed=SEED + 1))
    assert tr.restore_latest() == STEPS
    _assert_same(_per_feature(cfg1, tr.state), want)
    tr.run(1)
    assert np.isfinite(tr.history[-1]["loss"])


def _jax_state(k_multiple: int, cap: int = CAP):
    """A JAX-package DLRM TrainState (the port's init from another seed
    carried across: JAX's eager init costs seconds; moments half the
    params, so zero on the pad rows as training keeps them), step 5, and
    dense id counts."""
    import jax
    import jax.numpy as jnp

    from repro.configs import dlrm_criteo as jcfg
    from repro.train import loop as jloop
    from repro_torch import convert
    from repro_torch.models import dlrm

    jc = jcfg.reduced(cap=cap, k_multiple=k_multiple)
    tp, tb = dlrm.init(_cfg(k_multiple, cap), torch.Generator().manual_seed(3), device="cpu")
    params, buffers = convert.to_numpy(tp), convert.to_numpy(tb)
    dyn, _ = jloop.split_buffers(buffers)
    opt = {"m": jax.tree.map(lambda p: p * np.float32(0.5), params)}
    state = jloop.TrainState(params=params, opt=opt, ebuf=dyn, step=jnp.int32(5), err=None)
    rng = np.random.default_rng(4)
    counts = [rng.integers(0, 3, v).astype(np.int64) for v in jc.vocab_sizes]
    return jc, state, counts


def _port_state(jstate):
    from repro_torch import convert

    return convert.train_state_to_torch(jstate, "cpu")


def _save_jax(directory, jstate, counts, to_old=None):
    from repro.checkpoint import save_checkpoint

    tree = {"state": jstate, "clusters_done": np.int32(1), "id_counts": counts}
    if to_old is not None:
        tree = to_old(tree)
    save_checkpoint(str(directory), 5, tree)


def test_1device_and_jax_checkpoints_restore_into_the_4shard_trainer(trained):
    """Both restored on every rank, bit for bit (asserted on the ranks)."""
    assert trained[3] == 2


def test_jax_k4_checkpoint_restores_into_the_1device_port_trainer(tmp_path):
    from repro_torch.launch.train import build_dlrm_trainer

    _, jstate, counts = _jax_state(M)
    _save_jax(tmp_path, jstate, counts)
    cfg1 = _cfg(1)
    tr = build_dlrm_trainer(cfg1, _args(str(tmp_path)))
    assert tr.restore_latest() == 5
    _assert_same(_per_feature(cfg1, tr.state), _per_feature(_cfg(M), _port_state(jstate)))
    for a, b in zip(tr.id_tracker.counts, counts):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["legacy", "grouped"])
def test_layout_migrations_match_jax(layout, tmp_path):
    """At cap 2048 the 100-id table stays a full table, so the
    pre-universal grouping differs from the universal layout."""
    import jax

    from repro.core import collection as jcoll
    from repro_torch.core import collection as tcoll
    from repro_torch.launch.train import build_dlrm_trainer
    from repro_torch.train import loop as tloop
    from repro_torch.tree import jax_leaves

    jc, jstate, counts = _jax_state(1, cap=2048)
    cfg = _cfg(1, cap=2048)
    if layout == "legacy":
        jmig = jcoll.legacy_layout_migration(jc.collection)
        tmig = tcoll.legacy_layout_migration(cfg.collection)
    else:
        jmig = jcoll.grouped_layout_migration(
            jc.collection, jcoll.EmbeddingCollection.build(jc.collection.tables, mode="group"))
        tmig = tcoll.grouped_layout_migration(
            cfg.collection, tcoll.EmbeddingCollection.build(cfg.collection.tables, mode="group"))
    tstate = _port_state(jstate)
    jold = jmig[0]({"state": jstate})["state"]
    told = tmig[0]({"state": tstate})["state"]
    from repro_torch import convert

    jl = [np.asarray(x) for x in jax.tree.leaves(jold)]
    tl = [np.asarray(x) for x in jax_leaves(convert.to_numpy(told._replace(step=np.int32(5))))]
    assert len(jl) == len(tl) and len(jl) != len(jax.tree.leaves(jstate))
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)
    _save_jax(tmp_path, jstate, counts, to_old=jmig[0])
    args = _args(str(tmp_path))
    args.emb_cap = 2048
    tr = build_dlrm_trainer(cfg, args)
    assert tr.restore_latest() == 5
    assert isinstance(tr.state, tloop.TrainState)
    _assert_same(_per_feature(cfg, tr.state), _per_feature(cfg, tstate))


@pytest.mark.parametrize("c, d1, n, want", [
    (4, 100, 1, None), (4, 100, 4, 1), (4, 8, 2, 1), (4, 101, 4, 0), (3, 101, 4, None),
    (4, 10131227, 4, 0)])
def test_ptr_partition_spec_policy(c, d1, n, want):
    from repro_torch.launch.mesh import ptr_partition_spec

    assert ptr_partition_spec(c, d1, n) == want


@pytest.mark.parametrize("argv, err", [
    (["--data-shards", "2", "--device", "cpu"], ValueError),
    (["--model-shards", "2", "--device", "cuda"], RuntimeError)])
def test_launcher_refusals(argv, err, monkeypatch):
    """``--data-shards 2`` runs as 2 processes, and a world of one refuses
    it; two model shards on a machine with one card refuse before any
    process group (no fallback to gloo)."""
    from repro_torch.launch import train as tlaunch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: pytest.fail("a group was made"))
    with pytest.raises(err, match="the world has 1" if err is ValueError else "CUDA devices"):
        tlaunch.main(argv)


def test_sharded_batches_keep_the_global_ids_on_the_host():
    """A rank's batch holds its rows, dense and label slices and the global
    batch's ids; the ids (read by the tracker alone) never reach the
    device, and no per-rank id slice is made."""
    import types

    from repro_torch.data.translate import HostTranslator
    from repro_torch.launch.train import dlrm_data, sharded_batches
    from repro_torch.models import dlrm
    from repro_torch.train.loop import Trainer

    cfg = _cfg(M)
    _, buffers = dlrm.init(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    raw = next(dlrm_data(cfg, _args())(0))
    got = next(sharded_batches(iter([raw]), HostTranslator(cfg.collection, buffers["emb"],
                                                           n_shards=M), 1, M))
    b = B // M
    assert set(got) == set(raw) - {"sparse"} | {"rows", "global_sparse"}
    np.testing.assert_array_equal(got["dense"], raw["dense"][b: 2 * b])
    np.testing.assert_array_equal(got["global_sparse"], raw["sparse"])
    assert got["rows"].shape[:2] == (b, M)
    fake = types.SimpleNamespace(host_keys=frozenset({"global_sparse"}), accum=1,
                                 device=torch.device("cpu"))
    assert set(Trainer._to_device(fake, got)) == {"dense", "label", "rows"}
