"""Port vs JAX package: every table-compression method of
``core/embeddings.py`` (and CCE's ``sketch_matrix``) on one feature.

Integer buffers equal bit for bit, as do the budget-solved shapes and
``n_params``.  With one set of weights (a numpy draw, carried to the port
by ``convert.to_torch``), the gather methods (full, hash, hemb, ce, robe) look up exactly, DHE and
TT-Rec within 1e-5; ``logits`` agree within 1e-5, ``sketch_matrix``
exactly, and the gradient of a weighted lookup within 1e-5.  The JAX side
runs with its buffers closed over, as its train step holds the python-int
hash coefficients static."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cce as jcce
from repro.core import embeddings as jemb
from repro_torch import convert
from repro_torch.core import cce as tcce
from repro_torch.core import embeddings as temb

torch.backends.cuda.matmul.allow_tf32 = False

D1, D2, BUDGET, SALT = 5000, 16, 512, 3
METHODS = sorted(jemb.METHODS) + ["cce"]
GATHER = {"full", "hash", "hemb", "ce", "robe", "cce"}
TOL = dict(rtol=1e-5, atol=1e-5)


def _tables(method, d1=D1):
    kw = {} if method == "full" else dict(seed_salt=SALT)
    return (jemb.make_table(method, d1, D2, budget=BUDGET, **kw),
            temb.make_table(method, d1, D2, budget=BUDGET, **kw))


def _host(tree):
    """JAX arrays -> numpy; python ints (static hash coefficients) stay."""
    return jax.tree.map(lambda x: np.asarray(x) if hasattr(x, "shape") else x, tree)


def _state(method, d1=D1, seed=0):
    """(JAX table, port table, params (numpy), JAX buffers (device arrays
    and python ints, for closing over), port params, port buffers).  The
    params are one numpy draw from the seed (JAX's own init of TT-Rec
    costs seconds of eager dispatch); the buffers are JAX's."""
    jt, tt = _tables(method, d1)
    shapes = jax.eval_shape(jt.init, jax.random.PRNGKey(0))[0]
    rng = np.random.default_rng(seed)
    p = {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in shapes.items()}
    b = _host(jt.init_buffers())
    jb = jax.tree.map(lambda x: jnp.asarray(x) if hasattr(x, "shape") else x, b)
    return jt, tt, p, jb, convert.to_torch(p, "cpu"), convert.to_torch(b, "cpu")


def _ids(d1, n=64, seed=1):
    rng = np.random.default_rng(seed)
    return np.concatenate([[0, d1 - 1], rng.integers(0, d1, n - 2)]).astype(np.int32)


def _fields(t):
    return {k: v for k, v in dataclasses.asdict(t).items() if k != "dtype"}


@pytest.mark.parametrize("method", METHODS)
def test_budget_shape_and_buffers_equal_jax(method):
    jt, tt = _tables(method)
    assert type(tt).__name__ == type(jt).__name__
    assert _fields(tt) == _fields(jt) and tt.n_params == jt.n_params
    jb, tb = jt.init_buffers(), tt.init_buffers()
    assert jb.keys() == tb.keys()
    for key in jb:
        j, t = jb[key], tb[key]
        if isinstance(j, tuple):  # python-int hash coefficients
            assert t == j and all(type(x) is int for pair in
                                  (t if isinstance(t[0], tuple) else (t,)) for x in pair)
        else:
            assert np.asarray(t).dtype == np.asarray(j).dtype
            np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    # the port's init returns the same buffers (tensors where JAX has arrays)
    _, tb2 = tt.init(torch.Generator().manual_seed(0), "cpu")
    assert convert.to_numpy(tb2).keys() == jb.keys()
    for key in jb:
        if isinstance(jb[key], tuple):
            assert tb2[key] == jb[key]
        else:
            np.testing.assert_array_equal(convert.to_numpy(tb2)[key], np.asarray(jb[key]))


def test_dhe_coefficients_wrap_negative_in_int32():
    b = temb.make_table("dhe", D1, D2, budget=BUDGET, seed_salt=SALT).init_buffers()
    assert b["a"].dtype == np.int32 and (b["a"] < 0).any() and (b["a"] % 2 != 0).all()


@pytest.mark.parametrize("method", METHODS)
def test_lookup_matches_jax(method):
    jt, tt, p, b, pt, bt = _state(method)
    ids = _ids(D1)
    want = np.asarray(jax.jit(lambda pp, i: jt.lookup(pp, b, i))(p, ids))
    got = tt.lookup(pt, bt, torch.from_numpy(ids).long())
    assert got.shape == (ids.size, D2) and got.dtype == torch.float32
    if method in GATHER:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a (B, F)-shaped id block looks up the same
    got2 = tt.lookup(pt, bt, torch.from_numpy(ids.reshape(8, 8)).long())
    assert torch.equal(got2.reshape(-1, D2), got)


def test_dhe_mish_is_logaddexp_form():
    v = torch.linspace(-30.0, 30.0, 1201)
    want = np.asarray(v.numpy() * jnp.tanh(jax.nn.softplus(jnp.asarray(v.numpy()))))
    np.testing.assert_allclose(temb._mish(v).numpy(), want, rtol=1e-6, atol=1e-7)
    assert torch.equal(temb._mish(v), v * torch.tanh(torch.logaddexp(v, torch.zeros_like(v))))


def test_dhe_features_are_jax_uint32_hash():
    jt, tt, _, b, _, bt = _state("dhe")
    ids = np.concatenate([_ids(D1), [2**31 - 1, -1, -7]]).astype(np.int32)
    want = np.asarray(jt._features(b, jnp.asarray(ids)))
    got = tt._features(bt, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", METHODS)
def test_logits_match_jax(method):
    d1 = 700  # the head covers the vocabulary; DHE/TT/ROBE chunk it
    jt, tt, p, b, pt, bt = _state(method, d1=d1, seed=2)
    h = np.random.default_rng(3).normal(size=(5, D2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda pp, x: jt.logits(pp, b, x))(p, h))
    got = tt.logits(pt, bt, torch.from_numpy(h))
    assert got.shape == (5, d1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the head is the lookup of every id against h
    emb = tt.lookup(pt, bt, torch.arange(d1))
    np.testing.assert_allclose(got.numpy(), (torch.from_numpy(h) @ emb.T).numpy(), **TOL)


@pytest.mark.parametrize("method", ["full", "hash", "hemb", "ce", "cce"])
def test_sketch_matrix_matches_jax(method):
    d1 = 300
    jt, tt, p, b, pt, bt = _state(method, d1=d1, seed=4)
    want = jt.sketch_matrix(b)
    got = tt.sketch_matrix(bt)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if method != "full":  # H @ M is the table: T[v] = (e_v H) M
        M = {"hash": lambda: pt["M"], "hemb": lambda: pt["M"],
             "ce": lambda: torch.block_diag(*pt["tables"]),
             "cce": lambda: torch.block_diag(*pt["tables"].reshape(
                 tt.c, 2 * tt.k, tt.dsub))}[method]()
        emb = tt.lookup(pt, bt, torch.arange(d1))
        np.testing.assert_allclose(got @ M.numpy(), emb.numpy(), **TOL)


@pytest.mark.parametrize("method", METHODS)
def test_lookup_gradients_match_jax(method):
    jt, tt, p, b, pt, bt = _state(method, seed=5)
    ids = _ids(D1, seed=6)
    w = np.random.default_rng(7).normal(size=(ids.size, D2)).astype(np.float32)

    def jloss(pp):
        return jnp.sum(jt.lookup(pp, b, jnp.asarray(ids)) * w)

    want = jax.jit(jax.grad(jloss))(p)
    leaves = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    (tt.lookup(leaves, bt, torch.from_numpy(ids).long()) * torch.from_numpy(w)).sum().backward()
    assert leaves.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(want[k]), **TOL)


def test_lookup_many_loop_stacks_features():
    tabs = [temb.make_table(m, d1, D2, budget=BUDGET, seed_salt=i)
            for i, (m, d1) in enumerate((("hemb", 900), ("dhe", 400), ("tt", 1200)))]
    inits = [t.init(torch.Generator().manual_seed(i), "cpu") for i, t in enumerate(tabs)]
    ids = torch.stack([torch.arange(10) * 7 % t.d1 for t in tabs], dim=1)
    got = temb.lookup_many_loop(tabs, [p for p, _ in inits], [b for _, b in inits], ids)
    assert got.shape == (10, 3, D2)
    for f, (t, (p, b)) in enumerate(zip(tabs, inits)):
        assert torch.equal(got[:, f], t.lookup(p, b, ids[:, f]))


def test_cce_sketch_matrix_counts_two_ones_a_column():
    t = tcce.CCE(d1=50, d2=8, k=6, c=2, seed_salt=1)
    _, b = t.init(torch.Generator().manual_seed(0), "cpu")
    H = t.sketch_matrix(b)
    assert H.shape == (50, 24) and np.all(H.reshape(50, 2, 12).sum(-1) == 2)
    jt = jcce.CCE(d1=50, d2=8, k=6, c=2, seed_salt=1)
    np.testing.assert_array_equal(H, jt.sketch_matrix(jt.init_buffers()))


def test_tt_ids_outside_the_vocabulary():
    """Ids past the vocabulary clamp each core index and a negative id's
    first core index wraps once, as the jitted JAX gather does (id -1
    reads row d1-1 when q1*q2*q3 = d1; the eager JAX lookup raises)."""
    jt, tt, p, b, pt, bt = _state("tt", d1=1000, seed=9)
    assert tt.qs == (10, 10, 10)
    lookup = jax.jit(lambda pp, i: jt.lookup(pp, b, i))
    ids = np.array([1000, 1500, 99_999, -1, -5, -999, -1000, -1500, -99_999], np.int32)
    np.testing.assert_allclose(tt.lookup(pt, bt, torch.from_numpy(ids)).numpy(),
                               np.asarray(lookup(p, ids)), **TOL)
    np.testing.assert_allclose(tt.lookup(pt, bt, torch.tensor([-1])).numpy(),
                               tt.lookup(pt, bt, torch.tensor([999])).numpy(), **TOL)
