"""Port vs JAX package: the clustering transition on ``reduced()``
(``dlrm.cluster_tables`` -> ``transition_collection`` -> ``CCE.cluster``).

With dense ``id_counts`` the k-means point sets (ids and weights) are
identical, and so are the new helper hashes ``hs`` and the epoch (the
threefry mirror).  The port's kmeans++ draws are not JAX's, so the test
hands the port JAX's seeds (``kmeans_plus_plus`` monkeypatched to call the
JAX package on the same inputs); from there the centroids agree within
1e-5, at least 99% of the new pointers agree with JAX's ``assign_all``,
the remapped moments agree within 1e-5, and two more train steps still
track the JAX params."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import dlrm_criteo as jcfg
from repro.core import cce as jcce
from repro.core import kmeans as jkm
from repro.data.synthetic import ClickstreamConfig, clickstream_batches
from repro.models import dlrm as jdlrm
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch import optim as toptim
from repro_torch import random as jr
from repro_torch.configs import dlrm_criteo as tcfg
from repro_torch.core import cce as tcce
from repro_torch.core import hashing as thash
from repro_torch.core import kmeans as tkm
from repro_torch.kernels import ops as tkops
from repro_torch.models import dlrm as tdlrm
from repro_torch.train import loop as tloop
from repro_torch.tree import tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread in this module: beside the suite's other
    workers its threads would wait on each other at every small op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KEY = 5
CHUNK = 1000
STEP_TOL = dict(rtol=1e-4, atol=1e-6)


def _jax_seeds(key, x, k, weights=None):
    """The JAX package's kmeans++ on the port's (bit-identical) inputs."""
    return torch.from_numpy(np.array(jkm.kmeans_plus_plus(
        jnp.asarray(np.asarray(key, np.uint32)), jnp.asarray(x.numpy()), k,
        None if weights is None else jnp.asarray(weights.numpy()))))


def _record(monkeypatch, cls, log):
    """Wrap ``cls.cluster`` to log the sample each table clusters."""
    orig = cls.cluster

    def cluster(self, key, params, buffers, **kw):
        log.append((np.asarray(kw["sample_ids"]).copy(), np.asarray(kw["sample_weights"]).copy()))
        return orig(self, key, params, buffers, **kw)

    monkeypatch.setattr(cls, "cluster", cluster)


def _batches(jc, n, start):
    stream = clickstream_batches(ClickstreamConfig(vocab_sizes=jc.vocab_sizes), 32, start_step=start)
    return [{k: v[None] for k, v in next(stream).items() if k != "step"} for _ in range(n)]


def _steps(jc, tc, static):
    def jloss(pp, bb, mb):
        return jdlrm.bce_loss(pp, bb, jc, mb), {}

    def tloss(pp, bb, mb):
        return tdlrm.bce_loss(pp, bb, tc, mb), {}

    return (jax.jit(jloop.make_train_step(jloss, joptim.sgd(momentum=0.9), lambda s: 0.05, static)),
            tloop.make_train_step(tloss, toptim.sgd(momentum=0.9), lambda s: 0.05))


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _counts(vocab_sizes, seed=0, n_ids=64):
    """Dense per-feature id histograms: ``n_ids`` observed ids per feature
    with skewed counts (one sample size for every feature keeps the JAX
    side's compilations few)."""
    rng = np.random.default_rng(seed)
    out = []
    for v in vocab_sizes:
        c = np.zeros(v, np.int64)
        c[rng.choice(v, n_ids, replace=False)] = rng.zipf(1.5, n_ids).clip(max=500)
        out.append(c)
    return out


@pytest.fixture(scope="module")
def transitioned():
    """Both packages from one state (the port's init, random momenta):
    one transition with dense id counts and the moments remapped, then
    two train steps.  The vocabulary streams in chunks of 1000 ids."""
    jc, tc = jcfg.reduced(), tcfg.reduced()
    tp, tb = tdlrm.init(tc, torch.Generator().manual_seed(7), device="cpu")
    g = torch.Generator().manual_seed(8)
    topt = {"m": tree_map(lambda x: torch.randn(x.shape, generator=g) * 0.01, tp)}
    p, b, opt = convert.to_numpy(tp), convert.to_numpy(tb), convert.to_numpy(topt)
    counts = _counts(jc.vocab_sizes)

    jlog, tlog = [], []
    with pytest.MonkeyPatch.context() as mp:
        _record(mp, jcce.CCE, jlog)
        _record(mp, tcce.CCE, tlog)
        mp.setattr(tkm, "kmeans_plus_plus", _jax_seeds)
        jp2, jb2, jo2 = jdlrm.cluster_tables(jax.random.PRNGKey(KEY), p, b, jc, opt,
                                             id_counts=counts, chunk_size=CHUNK)
        tp2, tb2, to2 = tdlrm.cluster_tables(jr.PRNGKey(KEY), tp, tb, tc, topt,
                                             id_counts=counts, chunk_size=CHUNK)
    out = dict(jc=jc, tc=tc, state=(tp, tb, topt), jlog=jlog, tlog=tlog, counts=counts,
               j=(jax.tree.map(np.asarray, jp2), jax.tree.map(np.asarray, jb2),
                  jax.tree.map(np.asarray, jo2)),
               t=(tp2, tb2, to2))
    # the port's step updates in place: train copies, keep the transition's output
    dyn, static = jloop.split_buffers(jb2)
    jstep, tstep = _steps(jc, tc, static)
    js = jloop.TrainState(jp2, jo2, dyn, jnp.int32(0))
    ts = tloop.TrainState(tree_map(torch.clone, tp2), tree_map(torch.clone, to2), tb2, 0)
    for batch in _batches(jc, 2, start=5):
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, _tb(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    out["after"] = (js, ts)
    return out


def _cce_features(cfg):
    return [i for i, t in enumerate(cfg.collection.tables) if isinstance(t, tcce.CCE)]


def test_sample_ids_and_weights_identical(transitioned):
    jlog, tlog = transitioned["jlog"], transitioned["tlog"]
    assert len(tlog) == len(jlog) == len(_cce_features(transitioned["tc"])) > 0
    for (ji, jw), (ti, tw) in zip(jlog, tlog):
        np.testing.assert_array_equal(ti, ji)
        assert tw.dtype == jw.dtype == np.float32
        np.testing.assert_array_equal(tw, jw)


def test_hs_and_epoch_identical(transitioned):
    (_, jb2, _), (_, tb2, _) = transitioned["j"], transitioned["t"]
    for jg, tg in zip(jb2["emb"], convert.to_numpy(tb2)["emb"]):
        for jf, tf in zip(jg, tg):
            assert int(tf["epoch"]) == int(jf["epoch"]) == 1
            assert tf["hs"].dtype == np.uint32
            np.testing.assert_array_equal(tf["hs"], jf["hs"])
    for g in tb2["emb"]:
        for f in g:
            assert f["hs"].dtype == torch.int64 and f["epoch"].dtype == torch.int32


def test_hs_follows_the_key_schedule(transitioned):
    """hs == make_hashes(_seed_of(fold_in(k2, 777))), k2 from
    split(fold_in(fold_in(key, feature), epoch))."""
    tc, (_, tb2, _) = transitioned["tc"], transitioned["t"]
    for i in _cce_features(tc):
        table = tc.collection.tables[i]
        _, k2 = jr.split(jr.fold_in(jr.fold_in(jr.PRNGKey(KEY), i), 0))
        want = thash.pack_hashes(thash.make_hashes(thash._seed_of(jr.fold_in(k2, 777)), table.c,
                                                   table.k))
        got = tc.collection.feature_buffers(tb2["emb"], i)["hs"].numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_centroids_and_slab_agree(transitioned):
    (jp2, _, _), (tp2, _, _) = transitioned["j"], transitioned["t"]
    for jg, tg in zip(jp2["emb"], tp2["emb"]):
        np.testing.assert_allclose(tg["tables"].numpy(), jg["tables"], rtol=0, atol=1e-5)
    tc = transitioned["tc"]
    for i in _cce_features(tc):
        helper = tc.collection.feature_params(tp2["emb"], i)["tables"][:, 1]
        assert not helper.any()  # the fresh helper table starts at zero


def test_pointers_agree_with_jax_assign_all(transitioned):
    (_, jb2, _), (_, tb2, _) = transitioned["j"], transitioned["t"]
    tc = transitioned["tc"]
    for i in _cce_features(tc):
        got = tc.collection.feature_buffers(tb2["emb"], i)["ptr"]
        want = transitioned["jc"].collection.feature_buffers(jb2["emb"], i)["ptr"]
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        assert int(got.min()) >= 0 and int(got.max()) < tc.collection.tables[i].k
        assert (got.numpy() == want).mean() >= 0.99


def test_moments_remapped_alike(transitioned):
    (_, _, jo2), (_, _, to2) = transitioned["j"], transitioned["t"]
    for jg, tg in zip(jo2["m"]["emb"], to2["m"]["emb"]):
        np.testing.assert_allclose(tg["tables"].numpy(), jg["tables"], rtol=0, atol=1e-5)
    tc = transitioned["tc"]
    for i in _cce_features(tc):
        assert not tc.collection.feature_params(to2["m"]["emb"], i)["tables"][:, 1].any()
    # the MLP moments pass through untouched
    assert to2["m"]["top"][0]["w"] is transitioned["state"][2]["m"]["top"][0]["w"]


def test_two_more_steps_track_jax(transitioned):
    js2, ts2 = transitioned["after"]
    assert ts2.step == int(js2.step) == 2
    got = jax.tree.leaves(convert.to_numpy(ts2.params))
    for a, b in zip(got, jax.tree.leaves(jax.tree.map(np.asarray, js2.params))):
        np.testing.assert_allclose(a, b, **STEP_TOL)


def test_inputs_untouched_and_repeatable(transitioned):
    """The transition returns new tensors and leaves its inputs as they
    were, and the same state and key give bitwise the same result (its
    segment sums run in a fixed order)."""
    tc, (tp, tb, topt) = transitioned["tc"], transitioned["state"]
    before = convert.to_numpy((tp, tb, topt))
    runs = [tdlrm.cluster_tables(jr.PRNGKey(KEY), tp, tb, tc, topt,
                                 id_counts=transitioned["counts"], chunk_size=CHUNK)
            for _ in range(2)]
    for x, y in zip(jax.tree.leaves(before), jax.tree.leaves(convert.to_numpy((tp, tb, topt)))):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(jax.tree.leaves(convert.to_numpy(runs[0])),
                    jax.tree.leaves(convert.to_numpy(runs[1]))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("chunk", [None, 700])
def test_assign_all_kernel_route_is_the_per_column_function(chunk):
    """``use_kernel``: one batched call a chunk, written into the chunk's
    slice of the pointer table (strided when chunked), gives bit for bit
    what the kernel entry point gives column by column on the whole
    vocabulary."""
    table = tcce.CCE(3000, 16, k=12, c=4)
    p, b = table.init(torch.Generator().manual_seed(0), device="cpu")
    cent = torch.randn(4, 12, 4, generator=torch.Generator().manual_seed(1))
    emb = table.materialize(p, b, torch.arange(3000))
    want = torch.stack([tkops.kmeans_assign(emb[i], cent[i]) for i in range(4)])
    got = table.assign_all(p, b, cent, chunk_size=chunk, use_kernel=True)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_chunked_assign_and_remap_equal_unchunked():
    table = tcce.CCE(3000, 16, k=12, c=4)
    p, b = table.init(torch.Generator().manual_seed(0), device="cpu")
    cent = torch.randn(4, 12, 4, generator=torch.Generator().manual_seed(1))
    whole = table.assign_all(p, b, cent)
    assert torch.equal(table.assign_all(p, b, cent, chunk_size=700), whole)
    assert torch.equal(table.assign_all(p, b, cent, chunk_size=700, use_kernel=True), whole)
    nb = dict(b, ptr=whole)
    m = {"tables": torch.randn(4, 2, 12, 4, generator=torch.Generator().manual_seed(2))}
    w = torch.rand(3000, generator=torch.Generator().manual_seed(3))
    w[::3] = 0.0
    a = table.remap_moments(m, b, nb, id_weights=w)
    c = table.remap_moments(m, b, nb, chunk_size=700, id_weights=w)
    np.testing.assert_allclose(c["tables"].numpy(), a["tables"].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("policy", ["reset", "keep"])
def test_reset_and_keep_policies(policy):
    tc = tcfg.reduced()
    p, b = tdlrm.init(tc, torch.Generator().manual_seed(1), device="cpu")
    opt = {"m": {k: [dict((n, torch.ones_like(x)) for n, x in layer.items()) for layer in v]
                 if k != "emb" else [{"tables": torch.ones_like(g["tables"])} for g in v]
                 for k, v in p.items()}}
    _, _, new = tdlrm.cluster_tables(jr.PRNGKey(0), p, b, tc, opt, policy=policy)
    slab = new["m"]["emb"][0]["tables"]
    if policy == "keep":
        assert new is opt
    else:
        (grp,) = tc.collection.groups
        real = torch.zeros_like(slab, dtype=torch.bool)
        off = 0
        for t, n in zip(grp.tables, grp.col_counts):
            real[off:off + n, :, :t.fuse_spec.k] = True
            off += n
        assert not slab[real].any()
        assert torch.equal(new["m"]["top"][0]["w"], opt["m"]["top"][0]["w"])
