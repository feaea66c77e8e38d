"""Port vs JAX package: the DLRM serve engine.  Logits agree with the
JAX engine within 1e-5 (float32 matmul order differs) and with the
port's own forward exactly; launch and hit counters equal the JAX
engine's."""
import jax
import numpy as np
import pytest
import torch

from repro.models import dlrm as jdlrm
from repro.serve import dlrm as jserve
from repro.stream.trigger import head_churn as jhead_churn
from repro_torch import convert
from repro_torch.models import dlrm as tdlrm
from repro_torch.serve import dlrm as tserve
from repro_torch.stream.trigger import head_churn

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B = 8
# features 0 and 3 are small full tables (cached whole); the others are
# CCE tables whose hot heads come from the tracker
MIXED = dict(vocab_sizes=(24, 1000, 5000, 10, 20000), emb_method="cce", emb_param_cap=512,
             bottom_mlp=(64, 32, 16), top_mlp=(64, 1))


class StubTracker:
    """Fixed heads: the duck-typed tracker surface both engines read."""

    key = "sparse"

    def __init__(self, heads):
        self.heads = heads

    def export_heads(self, n=None):
        return {f: ids[:n] for f, ids in self.heads.items()}

    def observe(self, batch):
        pass


@pytest.fixture(scope="module")
def state():
    jc, tc = jdlrm.DLRMConfig(**MIXED), tdlrm.DLRMConfig(**MIXED)
    p, b = jdlrm.init(jax.random.PRNGKey(0), jc)
    p, b = jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, b)
    rng = np.random.default_rng(0)
    heads = {f: rng.choice(v, 32, replace=False).astype(np.int32)
             for f, v in enumerate(jc.vocab_sizes) if f not in (0, 3)}
    return jc, tc, p, b, convert.to_torch(p, "cpu"), convert.to_torch(b, "cpu"), heads


def _engines(state, **kw):
    jc, tc, p, b, pt, bt, heads = state
    tracker = StubTracker(heads)
    je = jserve.DLRMServeEngine(jax.tree.map(jax.numpy.asarray, p), b, jc, tracker=tracker,
                                max_batch=B, use_kernel=False, **kw)
    te = tserve.DLRMServeEngine(pt, bt, tc, tracker=tracker, max_batch=B, **kw)
    return je, te


def _hit_sparse(cache, cfg, n):
    return np.stack([cache.ids[f][np.arange(n) % cache.ids[f].size]
                     for f in range(cfg.n_sparse)], axis=1)


def _miss_sparse(cache, cfg, rng, n):
    """Ids outside the cache for every feature that has any (the small
    full tables are cached whole, so their lookups always hit)."""
    cols = []
    for f, v in enumerate(cfg.vocab_sizes):
        cand = np.setdiff1d(np.arange(v), cache.ids.get(f, np.empty(0)))
        cols.append(rng.choice(cand if cand.size else cache.ids[f], n))
    return np.stack(cols, axis=1)


def _forward(state, dense, sparse):
    """The port's forward on the batch the engine runs.  A ragged batch
    pads to the bucket (zero dense features, all-sentinel rows), since on
    the CPU a float32 matmul's rows can differ in the last bit between
    batch sizes."""
    tc, pt, bt = state[1], state[4], state[5]
    n = sparse.shape[0]
    if n == B:
        return tdlrm.forward(pt, bt, tc, {"dense": torch.from_numpy(dense),
                                          "sparse": torch.from_numpy(sparse)}).numpy()
    coll = tc.collection
    rows = np.full((B, coll.rows_n_cols, coll.rows_n_tables), -1, np.int32)
    rows[:n] = tserve.HostTranslator(coll, bt["emb"]).rows(sparse)
    dense_p = np.zeros((B, dense.shape[1]), np.float32)
    dense_p[:n] = dense
    return tdlrm.forward(pt, bt, tc, {"dense": torch.from_numpy(dense_p),
                                      "rows": torch.from_numpy(rows)}).numpy()[:n]


@pytest.mark.parametrize("kind", ["hit", "mixed", "ragged", "uncached"])
def test_engine_matches_jax_engine_and_forward(state, kind):
    jc = state[0]
    je, te = _engines(state, cache=kind != "uncached")
    rng = np.random.default_rng(["hit", "mixed", "ragged", "uncached"].index(kind))
    dense = rng.normal(size=(B, jc.n_dense)).astype(np.float32)
    if kind == "uncached":
        sparse = np.stack([rng.integers(0, v, B) for v in jc.vocab_sizes], axis=1)
    else:
        assert te.cache.ids.keys() == je.cache.ids.keys()
        sparse = _hit_sparse(te.cache, jc, B)
        if kind != "hit":
            sparse[::2] = _miss_sparse(te.cache, jc, rng, B)[::2]
    n = 3 if kind == "ragged" else B  # ragged pads to the bucket
    dense, sparse = dense[:n], sparse[:n]
    got = te.predict(dense, sparse)
    np.testing.assert_allclose(got, je.predict(dense, sparse), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, _forward(state, dense, sparse))
    for key in ("n_launches", "n_hit_batches", "n_cold_batches", "n_id_hits", "n_batches"):
        assert te.counters[key] == je.counters[key], key
    assert te.counters["n_launches"] == (0 if kind == "hit" else 1)


def test_request_path_matches_jax(state):
    jc = state[0]
    t = [0.0]
    je, te = _engines(state, latency_budget_s=0.01, clock=lambda: t[0])
    rng = np.random.default_rng(7)
    dense = rng.normal(size=(B + 3, jc.n_dense)).astype(np.float32)
    sparse = _hit_sparse(te.cache, jc, B + 3)
    sparse[B:] = _miss_sparse(te.cache, jc, rng, 3)
    out = {}
    for name, eng in (("jax", je), ("torch", te)):
        for i in range(B + 3):
            eng.submit(jserve.ServeRequest(uid=i, dense=dense[i], sparse=sparse[i]))
        res = eng.step()  # one full batch: all hits
        assert len(res) == B and all(r.cache_hit for r in res)
        assert eng.step() == []  # 3 pending, under the budget
        t[0] += 0.02
        res += eng.step()  # the budget expired: the cold rest
        out[name] = res
        t[0] = 0.0
    assert [r.uid for r in out["torch"]] == list(range(B + 3))
    np.testing.assert_allclose([r.logit for r in out["torch"]], [r.logit for r in out["jax"]],
                               rtol=1e-5, atol=1e-5)
    assert [r.cache_hit for r in out["torch"]] == [r.cache_hit for r in out["jax"]]
    assert te.flush_stats() == je.flush_stats()


def test_stale_cache_is_refused_not_served(state):
    jc = state[0]
    _, te = _engines(state)
    sparse = _hit_sparse(te.cache, jc, B)
    dense = np.zeros((B, jc.n_dense), np.float32)
    # a transition bumps the epochs; serving without a refresh must raise
    bumped = {"emb": [[dict(fb, epoch=fb["epoch"] + 1) if "epoch" in fb else fb
                       for fb in grp] for grp in te.buffers["emb"]]}
    te.update_state(te.params, bumped, refresh_cache=False)
    with pytest.raises(tserve.StaleCacheError):
        te.predict(dense, sparse)
    te.refresh_cache()
    assert te.predict(dense, sparse).shape == (B,)
    assert te.counters["n_refreshes"] == 2


def test_microbatcher_latency_budget():
    t = [0.0]
    mb = tserve.MicroBatcher(max_batch=4, latency_budget_s=0.010, clock=lambda: t[0])

    def req(i):
        return tserve.ServeRequest(uid=i, dense=np.zeros(2), sparse=np.zeros(3))

    mb.submit(req(0))
    assert not mb.ready()  # under budget, under max_batch: hold
    t[0] = 0.005
    assert not mb.ready()
    t[0] = 0.011  # the oldest request exceeded the budget: dispatch
    assert mb.ready()
    assert [q.uid for q in mb.take()] == [0]
    for i in range(1, 6):
        mb.submit(req(i))
    assert mb.ready()  # a full batch dispatches at once
    assert len(mb.take()) == 4
    assert len(mb) == 1


def test_head_churn_matches_jax():
    cases = [([1, 2, 3], [3, 2, 1]), ([1, 2], [3, 4]), ([1, 2, -1], [2, 3]), ([], []), ([], [1])]
    for a, b in cases:
        assert head_churn(np.array(a), np.array(b)) == jhead_churn(np.array(a), np.array(b))


@pytest.mark.parametrize("method", ["hash", "ce"])
def test_hash_and_ce_serve_like_jax(method):
    """The universally fused comparison methods serve, cold and from a
    cache of their hot ids, equal to the JAX engine within 1e-5 and to
    the port's forward exactly."""
    cfg = dict(MIXED, emb_method=method)
    jc, tc = jdlrm.DLRMConfig(**cfg, emb_use_kernel=False), tdlrm.DLRMConfig(**cfg)
    pt, bt = tdlrm.init(tc, torch.Generator().manual_seed(3), device="cpu")
    p, b = convert.to_numpy(pt), convert.to_numpy(bt)
    rng = np.random.default_rng(4)
    tracker = StubTracker({f: rng.choice(v, 16, replace=False).astype(np.int32)
                           for f, v in enumerate(jc.vocab_sizes) if f not in (0, 3)})
    sparse = np.stack([rng.integers(0, v, B) for v in jc.vocab_sizes], axis=1).astype(np.int32)
    sparse[:3] = np.stack([tracker.heads[f][:3] if f in tracker.heads else np.arange(3)
                           for f in range(5)], axis=1)  # three fully cached requests
    dense = rng.normal(size=(B, 13)).astype(np.float32)
    for cache in (False, True):
        je = jserve.DLRMServeEngine(jax.tree.map(jax.numpy.asarray, p), b, jc, tracker=tracker,
                                    cache=cache, max_batch=B, use_kernel=False)
        te = tserve.DLRMServeEngine(pt, bt, tc, tracker=tracker, cache=cache, max_batch=B)
        got = te.predict(dense, sparse)
        np.testing.assert_allclose(got, je.predict(dense, sparse), rtol=1e-5, atol=1e-5)
        with torch.no_grad():
            fwd = tdlrm.forward(pt, bt, tc, {"dense": torch.from_numpy(dense),
                                             "sparse": torch.from_numpy(sparse)})
        np.testing.assert_allclose(got, fwd.numpy(), rtol=0, atol=1e-6)
        assert te.counters["n_launches"] == je.counters["n_launches"]


@pytest.mark.parametrize("method", ["hemb", "dhe"])
def test_engine_refuses_loop_groups(method):
    tc = tdlrm.DLRMConfig(**dict(MIXED, emb_method=method))
    pt, bt = tdlrm.init(tc, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="universal groups only"):
        tserve.DLRMServeEngine(pt, bt, tc, max_batch=B)
