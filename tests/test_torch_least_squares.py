"""Port vs JAX package: least squares (Algorithms 1 and 2, Theorem 3.1)
and the count-sketch hashing they draw on.

``loss``, ``optimal_loss`` and ``theorem_bound`` agree within float32
tolerance (rtol 1e-4); with JAX's Gaussian draws handed to the port
(``least_squares._normal``), ``dense_cce`` tracks JAX's losses in all
three noise modes, and with JAX's kmeans++ seeds too, ``sparse_cce`` and
``kmeans_factorize`` track JAX's (rtol 1e-3: Lloyd's float sums differ
in order), sparse CCE at Figure 1b's scale too.  The sign hash, ``countsketch_matrix`` and
``apply_countsketch`` equal JAX's bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jhash
from repro.core import kmeans as jkm
from repro.core import least_squares as jls
from repro_torch import random as jr
from repro_torch.core import hashing as thash
from repro_torch.core import kmeans as tkm
from repro_torch.core import least_squares as tls

torch.backends.cuda.matmul.allow_tf32 = False

N, D1, D2, K = 300, 60, 6, 20
LS_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, D1)).astype(np.float32)
    Y = rng.normal(size=(N, D2)).astype(np.float32)
    return X, Y, torch.from_numpy(X), torch.from_numpy(Y)


def _jkey(key):
    return jnp.asarray(np.asarray(key, np.uint32))


def _jax_normal(key, shape, dtype, device):
    return torch.from_numpy(np.array(jax.random.normal(_jkey(key), shape, jnp.float32)))


def _jax_seeds(key, x, k, weights=None):
    return torch.from_numpy(np.array(jkm.kmeans_plus_plus(_jkey(key), jnp.asarray(x.numpy()), k)))


def test_loss_optimum_and_bound_match_jax(problem):
    X, Y, tX, tY = problem
    T = np.random.default_rng(1).normal(size=(D1, D2)).astype(np.float32)
    np.testing.assert_allclose(float(tls.loss(tX, torch.from_numpy(T), tY)),
                               float(jls.loss(X, T, Y)), rtol=1e-5)
    (jopt, jT), (topt, tT) = jls.optimal_loss(X, Y), tls.optimal_loss(tX, tY)
    np.testing.assert_allclose(float(topt), float(jopt), rtol=1e-4)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tls.theorem_bound(tX, tY, K, 12).numpy(),
                               np.asarray(jls.theorem_bound(X, Y, K, 12)), rtol=1e-4)


@pytest.mark.parametrize("mode", ["plain", "smart_noise", "half_noise"])
def test_dense_cce_tracks_jax(problem, monkeypatch, mode):
    X, Y, tX, tY = problem
    kw = {"smart_noise": dict(smart_noise=True),
          "half_noise": dict(identity_prefix=False)}.get(mode, {})
    want = jls.dense_cce(jax.random.PRNGKey(2), X, Y, K, 10, **kw)
    monkeypatch.setattr(tls, "_normal", _jax_normal)
    got = tls.dense_cce(jr.PRNGKey(2), tX, tY, K, 10, **kw)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), **LS_TOL)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), rtol=1e-2, atol=1e-3)
    bound = tls.theorem_bound(tX, tY, K, 10)
    opt, _ = tls.optimal_loss(tX, tY)
    assert (got.losses[1:] - opt <= 3 * (bound[1:] - opt) + 1e-3).all()


def test_sparse_cce_tracks_jax(problem, monkeypatch):
    X, Y, tX, tY = problem
    want = jls.sparse_cce(jax.random.PRNGKey(5), X, Y, 24, 6)
    monkeypatch.setattr(tkm, "kmeans_plus_plus", _jax_seeds)
    got = tls.sparse_cce(jr.PRNGKey(5), tX, tY, 24, 6)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=1e-3)
    assert got.losses[-1] < got.losses[0]


def test_sparse_cce_tracks_jax_at_fig1b_scale(monkeypatch):
    """Figure 1b's scale, the problem ``chip_smoke.py`` runs on the card (n=10^4,
    d1=10^3, d2=10, k=100, 25 iterations).  With JAX's kmeans++ seeds the
    port tracks JAX's Algorithm 2 (rtol 1e-3, as above), and both lie above
    Theorem 3.1's bound from iteration 4 on: the theorem bounds dense CCE,
    and JAX's own sparse CCE is above it at this scale too."""
    n, d1, d2, k, iters = 10_000, 1000, 10, 100, 25
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, d1)).astype(np.float32)
    Y = rng.normal(size=(n, d2)).astype(np.float32)
    tX, tY = torch.from_numpy(X), torch.from_numpy(Y)
    want = np.asarray(jls.sparse_cce(jax.random.PRNGKey(1), X, Y, k, iters).losses)
    monkeypatch.setattr(tkm, "kmeans_plus_plus", _jax_seeds)
    got = tls.sparse_cce(jr.PRNGKey(1), tX, tY, k, iters).losses.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    bound = tls.theorem_bound(tX, tY, k, iters).numpy()
    assert list(np.nonzero(want > bound)[0]) == list(range(4, iters + 1))
    assert list(np.nonzero(got > bound)[0]) == list(range(4, iters + 1))


@pytest.mark.parametrize("ones", [1, 2])
def test_kmeans_factorize_tracks_jax(monkeypatch, ones):
    rng = np.random.default_rng(7)
    T = (rng.normal(size=(80, 3)) @ rng.normal(size=(3, 8))
         + 0.05 * rng.normal(size=(80, 8))).astype(np.float32)
    want = np.asarray(jls.kmeans_factorize(jax.random.PRNGKey(7), jnp.asarray(T), 16, ones))
    monkeypatch.setattr(tkm, "kmeans_plus_plus", _jax_seeds)
    got = tls.kmeans_factorize(jr.PRNGKey(7), torch.from_numpy(T), 16, ones)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


def test_sign_hash_equals_jax():
    ids = np.concatenate([np.arange(500), [2**31 - 1, -1, -12345]]).astype(np.int32)
    for seed in (0, 3, 99):
        js, ts = jhash.make_sign_hash(seed), thash.make_sign_hash(seed)
        assert (ts.a, ts.b) == (js.a, js.b)
        got = ts(torch.from_numpy(ids))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(js(jnp.asarray(ids))))
    key = np.array([7, 11], np.uint32)
    js, ts = jhash.make_sign_hash(jnp.asarray(key)), thash.make_sign_hash(key)
    assert (ts.a, ts.b) == (js.a, js.b)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("seed", [0, 4])
def test_countsketch_matrix_equals_jax(seed, signed):
    want = jhash.countsketch_matrix(jax.random.PRNGKey(seed), 200, 32, signed=signed)
    got = thash.countsketch_matrix(jr.PRNGKey(seed), 200, 32, signed=signed)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_apply_countsketch_equals_jax():
    ids = np.random.default_rng(2).integers(0, 10_000, 700).astype(np.int32)
    hs = (12345, 678, 91011, 1213)
    want = np.asarray(jhash.apply_countsketch(jnp.asarray(ids), hs, 64))
    got = thash.apply_countsketch(torch.from_numpy(ids), hs, 64)
    np.testing.assert_array_equal(got.numpy(), want)
