"""Port vs JAX package: EmbeddingCollection group layout, lookup_all on
the sparse= and rows= paths, stacking, and host translation, all bit
for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_criteo as jcfg
from repro.data.translate import HostTranslator as JTranslator
from repro.models import dlrm as jdlrm
from repro_torch import convert
from repro_torch.configs import dlrm_criteo as tcfg
from repro_torch.data.translate import HostTranslator as TTranslator
from repro_torch.models import dlrm as tdlrm

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# two small full tables ride the CCE supertable as T=1 columns (-1 in
# their second slot); all-full configs fall back to padded full gathers
MIXED = dict(vocab_sizes=(24, 1000, 5000, 10, 20000), emb_method="cce", emb_param_cap=512,
             bottom_mlp=(64, 32, 16), top_mlp=(64, 1))
ALL_FULL = dict(vocab_sizes=(10, 50, 3000), emb_method="full",
                bottom_mlp=(32, 16), top_mlp=(32, 1))


def _configs(name):
    if name == "CONFIG":
        return jcfg.CONFIG, tcfg.CONFIG
    if name == "reduced":
        return jcfg.reduced(), tcfg.reduced()
    if name == "reduced_k2":
        return jcfg.reduced(k_multiple=2), tcfg.reduced(k_multiple=2)
    kw = MIXED if name == "mixed" else ALL_FULL
    return jdlrm.DLRMConfig(**kw), tdlrm.DLRMConfig(**kw)


def _group_facts(coll):
    return [
        (g.kind, g.features, g.n_tables,
         g.col_counts if g.kind == "univ" else None,
         g.k_pad if g.kind == "univ" else None, g.dsub)
        for g in coll.groups
    ]


@pytest.mark.parametrize("name,expect", [
    ("CONFIG", (104, 2, 305, 4)),
    ("reduced", (20, 2, 16, 4)),
    ("mixed", (20, 2, 24, 4)),
    ("all_full", None),
])
def test_group_layout_equals_jax(name, expect):
    """Built only: no table is allocated (CONFIG holds 33.7M ids)."""
    jc, tc = _configs(name)
    a, b = jc.collection, tc.collection
    assert _group_facts(b) == _group_facts(a)
    assert (b.rows_n_cols, b.rows_n_tables) == (a.rows_n_cols, a.rows_n_tables)
    np.testing.assert_array_equal(b.rows_col_feature, a.rows_col_feature)
    if expect is not None:
        (g,) = b.groups
        assert (g.n_cols, g.n_tables, g.k_pad, g.dsub) == expect
    else:
        assert all(g.kind == "full" for g in b.groups) and len(b.groups) == 2


def _state(name, seed=0):
    jc, tc = _configs(name)
    p, b = jdlrm.init(jax.random.PRNGKey(seed), jc)
    p, b = jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, b)
    return jc, tc, p, b, convert.to_torch(p, "cpu"), convert.to_torch(b, "cpu")


def _sparse(vocabs, B, seed, edges=False):
    rng = np.random.default_rng(seed)
    sparse = np.stack([rng.integers(0, v, B) for v in vocabs], axis=1).astype(np.int32)
    if edges:  # ids at and past every vocab edge
        sparse[:4] = np.stack([np.array([0, v - 1, v, v + 99]) for v in vocabs], axis=1)
    return sparse


@pytest.mark.parametrize("name", ["reduced", "mixed", "all_full"])
def test_lookup_all_sparse_path_bit_exact(name):
    jc, tc, p, b, pt, bt = _state(name)
    sparse = _sparse(jc.vocab_sizes, 13, seed=1, edges=True)
    want = np.asarray(jax.jit(
        lambda pe, be, s: jc.collection.lookup_all(pe, be, s, use_kernel=True)
    )(p["emb"], b["emb"], sparse))
    got = tc.collection.lookup_all(pt["emb"], bt["emb"], torch.from_numpy(sparse))
    assert got.shape == (13, jc.n_sparse, jc.emb_dim)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["reduced", "mixed"])
def test_lookup_all_rows_path_bit_exact(name):
    jc, tc, p, b, pt, bt = _state(name, seed=1)
    sparse = _sparse(jc.vocab_sizes, 11, seed=2, edges=True)
    rows = JTranslator(jc.collection, b["emb"]).rows(sparse)
    want = np.asarray(jax.jit(
        lambda pe, r: jc.collection.lookup_all(pe, None, None, use_kernel=True, rows=r)
    )(p["emb"], rows))
    got = tc.collection.lookup_all(pt["emb"], None, None, rows=torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    # the rows path equals the device-translation (sparse) path
    dev = tc.collection.lookup_all(pt["emb"], bt["emb"], torch.from_numpy(sparse))
    assert torch.equal(got, dev)


@pytest.mark.parametrize("name", ["reduced", "mixed"])
def test_host_translator_bit_exact(name):
    jc, tc, _, b, _, bt = _state(name, seed=2)
    sparse = _sparse(jc.vocab_sizes, 17, seed=3, edges=True)
    jtr, ttr = JTranslator(jc.collection, b["emb"]), TTranslator(tc.collection, bt["emb"])
    np.testing.assert_array_equal(ttr.rows(sparse), jtr.rows(sparse))
    skip = np.random.default_rng(4).random(sparse.shape) < 0.5
    np.testing.assert_array_equal(ttr.rows_masked(sparse, skip), jtr.rows_masked(sparse, skip))
    # the device translation gives the same rows
    coll = tc.collection
    (g,) = coll.univ_groups
    dev = coll.group_rows(coll.groups[g], bt["emb"][g], torch.from_numpy(sparse).long())
    np.testing.assert_array_equal(dev.movedim(0, 1).numpy(), jtr.rows(sparse))


def test_host_translator_shard_buckets_bit_exact():
    jc, tc, _, b, _, bt = _state("reduced_k2", seed=3)
    sparse = _sparse(jc.vocab_sizes, 9, seed=5)
    jtr = JTranslator(jc.collection, b["emb"], n_shards=2)
    ttr = TTranslator(tc.collection, bt["emb"], n_shards=2)
    got = ttr.rows(sparse)
    assert got.shape == (9, 2, tc.collection.rows_n_cols, tc.collection.rows_n_tables)
    np.testing.assert_array_equal(got, jtr.rows(sparse))


@pytest.mark.parametrize("name", ["mixed", "all_full"])
def test_stack_unstack_matches_jax(name):
    jc, tc, p, _, pt, _ = _state(name, seed=4)
    want = jc.collection.unstack_params(jax.tree.map(jnp.asarray, p["emb"]))
    got = tc.collection.unstack_params(pt["emb"])
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for key in w:
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
    restacked = tc.collection.stack_params(got)
    for a, c in zip(restacked, pt["emb"]):
        for key in a:
            assert torch.equal(a[key], c[key])


# --- the comparison methods (hash, CE, hash embeddings, ROBE, DHE, TT-Rec) ---------

METHODS = ("full", "hash", "hemb", "ce", "robe", "dhe", "tt", "cce")
# heavy lookups a forward of the full Criteo configuration in "univ" mode
CONFIG_LAUNCHES = dict(full=6, hash=1, ce=1, cce=1, hemb=20, robe=20, dhe=20, tt=20)


def _method_configs(base, method, mode):
    import dataclasses

    jc = jcfg.CONFIG if base == "CONFIG" else jcfg.reduced()
    tc = tcfg.CONFIG if base == "CONFIG" else tcfg.reduced()
    kw = dict(emb_method=method, emb_fuse=mode)
    return (dataclasses.replace(jc, emb_use_kernel=False, **kw),
            dataclasses.replace(tc, **kw))


def _layout(coll):
    return [(g.kind, g.features, g.n_tables, g.dsub,
             g.col_counts if g.kind == "univ" else None,
             g.k_pad if g.kind == "univ" else None) for g in coll.groups]


@pytest.mark.parametrize("mode", ["univ", "group", "loop"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("base", ["reduced", "CONFIG"])
def test_method_layouts_equal_jax(base, method, mode):
    """Built only (no table is allocated): groups, kinds, launch counts and
    the rows tensor's shape."""
    jc, tc = _method_configs(base, method, mode)
    a, b = jc.collection, tc.collection
    assert _layout(b) == _layout(a)
    assert (b.n_groups, b.n_lookup_launches) == (a.n_groups, a.n_lookup_launches)
    assert (b.rows_n_cols, b.rows_n_tables) == (a.rows_n_cols, a.rows_n_tables)
    assert tc.n_emb_params() == jc.n_emb_params() and tc.compression() == jc.compression()
    assert [type(tc.table(i)).__name__ for i in range(tc.n_sparse)] == \
        [type(jc.table(i)).__name__ for i in range(jc.n_sparse)]
    if base == "CONFIG" and mode == "univ":
        assert b.n_lookup_launches == CONFIG_LAUNCHES[method]
    if mode == "loop":
        assert b.n_lookup_launches == tc.n_sparse


def _method_state(method, mode="univ", seed=0):
    """Both configurations and one state: the port's init (JAX's own init
    of some methods costs seconds of eager dispatch), its params carried
    to numpy for the JAX side and its buffers, which equal JAX's
    (``test_method_buffers_equal_jax``); ``jb`` holds them as JAX arrays
    and python ints, for closing over."""
    jc, tc = _method_configs("reduced", method, mode)
    pt, bt = tdlrm.init(tc, torch.Generator().manual_seed(seed), device="cpu")
    p, b = convert.to_numpy(pt), convert.to_numpy(bt)
    jb = jax.tree.map(lambda x: jnp.asarray(x) if hasattr(x, "shape") else x, b)
    return jc, tc, p, b, jb, pt, bt


@pytest.mark.parametrize("method", METHODS)
def test_method_buffers_equal_jax(method):
    jc, tc = _method_configs("reduced", method, "univ")
    want = jc.collection.stack_buffers([t.init_buffers() for t in jc.collection.tables])
    _, got = tc.collection.init(torch.Generator().manual_seed(0), "cpu")
    got = convert.to_numpy(got)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert type(a) is type(w) if isinstance(w, int) else np.asarray(a).dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w))


@pytest.mark.parametrize("method,mode", [(m, "univ") for m in METHODS]
                         + [("cce", "group"), ("cce", "loop"), ("hash", "group")])
def test_lookup_all_methods_match_jax(method, mode):
    """Exact for the gather methods, within 1e-5 for DHE and TT-Rec."""
    jc, tc, p, _, jb, pt, bt = _method_state(method, mode, seed=6)
    sparse = _sparse(jc.vocab_sizes, 13, seed=7)
    want = np.asarray(jax.jit(
        lambda pe, s: jc.collection.lookup_all(pe, jb["emb"], s, use_kernel=False)
    )(p["emb"], sparse))
    got = tc.collection.lookup_all(pt["emb"], bt["emb"], torch.from_numpy(sparse))
    assert got.shape == (13, jc.n_sparse, jc.emb_dim)
    if method in ("dhe", "tt"):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", ["hash", "ce"])
def test_host_translator_methods_bit_exact(method):
    jc, tc, _, b, _, _, bt = _method_state(method, seed=8)
    sparse = _sparse(jc.vocab_sizes, 17, seed=9, edges=True)
    jtr, ttr = JTranslator(jc.collection, b["emb"]), TTranslator(tc.collection, bt["emb"])
    rows = ttr.rows(sparse)
    assert rows.shape == (17, tc.collection.rows_n_cols, 1)
    np.testing.assert_array_equal(rows, jtr.rows(sparse))
    coll = tc.collection
    (g,) = coll.univ_groups
    dev = coll.group_rows(coll.groups[g], bt["emb"][g], torch.from_numpy(sparse).long())
    np.testing.assert_array_equal(dev.movedim(0, 1).numpy(), rows)
    assert "sparse" not in ttr({"sparse": sparse}, drop_sparse=True)


@pytest.mark.parametrize("method", ["hemb", "full"])
def test_drop_sparse_refuses_loop_and_full_groups(method):
    _, tc, _, _, _, _, bt = _method_state(method)
    with pytest.raises(ValueError, match="universally fused"):
        TTranslator(tc.collection, bt["emb"])({"sparse": np.zeros((2, 5), np.int64)},
                                               drop_sparse=True)


@pytest.mark.parametrize("method", ["dhe", "robe"])
def test_loop_group_stack_unstack(method):
    jc, tc, p, _, _, pt, _ = _method_state(method, seed=10)
    assert all(g.kind == "loop" for g in tc.collection.groups)
    want = jc.collection.unstack_params(p["emb"])
    got = tc.collection.unstack_params(pt["emb"])
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for key in w:
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
    for a, c in zip(tc.collection.stack_params(got), pt["emb"]):
        assert all(torch.equal(a[0][k], c[0][k]) for k in a[0])
