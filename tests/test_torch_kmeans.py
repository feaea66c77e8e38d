"""Port vs JAX package: k-means (``core/kmeans.py``) and the k-means point
sets (``stream/points.py``).  Lloyd iterations from the same seed
centroids agree within 1e-5 (float32 sums in another order); the point
sets are identical.  The float draws of kmeans++ and ``subsample`` come
from a torch generator and are checked for their properties, not
against JAX's draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkm
from repro.stream import points as jpoints
from repro_torch import random as jr
from repro_torch.core import kmeans as tkm
from repro_torch.kernels.ops import kmeans_assign as tops_assign
from repro_torch.stream import points as tpoints

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _blobs(n, k, d, seed, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 3.0
    x = centers[rng.integers(0, k, n)] + rng.normal(size=(n, d)) * spread
    return x.astype(np.float32)


def test_sq_dists_and_assign_match_jax():
    x = _blobs(300, 6, 4, seed=0)
    c = _blobs(6, 6, 4, seed=1)
    want = np.asarray(jkm._sq_dists(jnp.asarray(x), jnp.asarray(c)))
    got = tkm._sq_dists(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    a = tkm.assign(torch.from_numpy(x), torch.from_numpy(c))
    assert a.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), np.asarray(jkm.assign(jnp.asarray(x), jnp.asarray(c))))
    # the kernel route (its plain version on a CPU tensor) picks the same ids here
    np.testing.assert_array_equal(
        tkm.assign(torch.from_numpy(x), torch.from_numpy(c), use_kernel=True).numpy(), a.numpy())


@pytest.mark.parametrize("weighted", [False, True])
def test_lloyd_step_matches_jax_and_keeps_empty_clusters(weighted):
    x = _blobs(400, 5, 4, seed=2)
    c = np.concatenate([x[:5], np.full((1, 4), 1e3, np.float32)])  # the last stays empty
    w = np.random.default_rng(3).integers(1, 9, 400).astype(np.float32) if weighted else None
    jc, ja, ji = jkm._lloyd_step(jnp.asarray(x), jnp.asarray(c), 6,
                                 weights=None if w is None else jnp.asarray(w))
    tc, ta, ti = tkm._lloyd_step(torch.from_numpy(x), torch.from_numpy(c), 6,
                                 weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tc.numpy()[5], c[5])
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_kmeans_from_jax_seeds_matches_jax(weighted, monkeypatch):
    """With JAX's kmeans++ seeds handed to the port (``kmeans_plus_plus``
    monkeypatched), the Lloyd iterations track JAX's within 1e-5."""
    x = _blobs(600, 8, 4, seed=4)
    w = np.random.default_rng(5).integers(1, 20, 600).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    key = jax.random.PRNGKey(6)
    seeds = np.array(jkm.kmeans_plus_plus(key, jnp.asarray(x), 8, jw))
    want = jkm.kmeans(key, jnp.asarray(x), 8, niter=12, weights=jw)
    monkeypatch.setattr(tkm, "kmeans_plus_plus", lambda *a, **k: torch.from_numpy(seeds))
    got = tkm.kmeans(jr.PRNGKey(6), torch.from_numpy(x), 8, niter=12,
                     weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids), atol=1e-5)
    np.testing.assert_array_equal(got.assignments.numpy(), np.asarray(want.assignments))
    np.testing.assert_allclose(float(got.inertia), float(want.inertia), rtol=1e-5)


def test_kmeans_use_kernel_matches_jax(monkeypatch):
    """``use_kernel=True`` routes every Lloyd assignment through the kernel
    entry point (its plain version here), as JAX's routes them through the
    Pallas kernel (interpret mode): from JAX's seeds, the same picks and
    centroids within 1e-5."""
    x = _blobs(200, 6, 4, seed=8)
    key = jax.random.PRNGKey(9)
    seeds = np.array(jkm.kmeans_plus_plus(key, jnp.asarray(x), 6))
    want = jkm.kmeans(key, jnp.asarray(x), 6, niter=3, use_kernel=True)
    monkeypatch.setattr(tkm, "kmeans_plus_plus", lambda *a, **k: torch.from_numpy(seeds))
    calls = []
    monkeypatch.setattr(tkm.kops, "kmeans_assign",
                        lambda *a: calls.append(1) or tops_assign(*a))
    got = tkm.kmeans(jr.PRNGKey(9), torch.from_numpy(x), 6, niter=3, use_kernel=True)
    assert len(calls) == 3
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids), atol=1e-5)
    np.testing.assert_array_equal(got.assignments.numpy(), np.asarray(want.assignments))
    np.testing.assert_allclose(float(got.inertia), float(want.inertia), rtol=1e-5)


def test_kmeans_plus_plus_properties():
    x = torch.from_numpy(_blobs(500, 10, 4, seed=7))
    a = tkm.kmeans_plus_plus(jr.PRNGKey(1), x, 10)
    b = tkm.kmeans_plus_plus(jr.PRNGKey(1), x, 10)
    assert torch.equal(a, b)  # a key fixes the draws
    rows = {tuple(r) for r in x.numpy().tolist()}
    assert all(tuple(r) in rows for r in a.numpy().tolist())  # seeds are points of x
    assert len({tuple(r) for r in a.numpy().tolist()}) == 10  # distinct on distinct data
    assert not torch.equal(a, tkm.kmeans_plus_plus(jr.PRNGKey(2), x, 10))
    # weighted: a zero-weight point is never a seed
    w = torch.zeros(500)
    w[::7] = 1.0
    s = tkm.kmeans_plus_plus(jr.PRNGKey(3), x, 10, w).numpy()
    allowed = {tuple(r) for r in x.numpy()[::7].tolist()}
    assert all(tuple(r) in allowed for r in s.tolist())


def test_kmeans_recovers_separated_clusters():
    rng = np.random.default_rng(8)
    centers = rng.normal(size=(6, 4)).astype(np.float32) * 50
    x = torch.from_numpy((centers[rng.integers(0, 6, 600)] + rng.normal(size=(600, 4)) * 0.1)
                         .astype(np.float32))
    res = tkm.kmeans(jr.PRNGKey(0), x, 6, niter=20)
    got = np.sort(res.centroids.numpy(), axis=0)
    np.testing.assert_allclose(got, np.sort(centers, axis=0), atol=0.1)


def test_subsample_properties():
    key = jr.PRNGKey(4)
    small = tkm.subsample(key, 100, 4, 256, device="cpu")
    assert torch.equal(small, torch.arange(100))
    ids = tkm.subsample(key, 10_000, 4, 256, device="cpu")
    assert ids.shape == (1024,) and ids.dtype == torch.int64
    assert ids.unique().numel() == 1024 and int(ids.min()) >= 0 and int(ids.max()) < 10_000
    assert torch.equal(ids, tkm.subsample(key, 10_000, 4, 256, device="cpu"))


@pytest.mark.parametrize("n", [50, 400, 5000])
def test_points_from_counts_identical(n):
    rng = np.random.default_rng(n)
    counts = rng.zipf(1.3, 3000).astype(np.float64)
    counts[rng.random(3000) < 0.4] = 0
    want = jpoints.points_from_counts(counts, n, seed=11)
    got = tpoints.points_from_counts(counts, n, seed=11)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tpoints.points_from_counts(np.zeros(10), 5, seed=0) is None


def test_stratified_points_identical_on_float_counts():
    rng = np.random.default_rng(12)
    ids = rng.choice(10_000, 700, replace=False)
    counts = rng.random(700) * 0.5 + 1e-3
    for n in (100, 699, 700, 800):
        want = jpoints.stratified_points(ids, counts, n, seed=n)
        got = tpoints.stratified_points(ids, counts, n, seed=n)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
