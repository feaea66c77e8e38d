"""K-means in PyTorch: kmeans++ init, Lloyd iterations and FAISS-style
subsampling, the port of the JAX package's ``core/kmeans.py``.

Following the paper's reproducibility notes the defaults are ``niter=50``
and at most ``max_points_per_centroid=256`` points per centroid.  Every
entry point takes optional per-point ``weights``: a weighted Lloyd
iteration on unique points equals the unweighted iteration on the
multiset where point i appears weights[i] times.

Keys are the JAX package's (``repro_torch.random``).  Integer work on keys
is bit-exact with it; the float draws of kmeans++ and of ``subsample``
come from a ``torch.Generator`` seeded with ``_seed_of(key)`` and are not
JAX's draws.  Lloyd iterations run the plain-torch assignment, as the
JAX package's ``CCE.cluster`` runs them outside any kernel; only
``assign(..., use_kernel=True)`` (``CCE.assign_all``) takes the kernel.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from repro_torch.core.hashing import _seed_of
from repro_torch.kernels import ops as kops


class KMeansResult(NamedTuple):
    centroids: torch.Tensor  # (k, d)
    assignments: torch.Tensor  # (n,) int32
    inertia: torch.Tensor  # () sum of squared distances


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, k) squared distances, ``||x||^2 + ||c||^2 - 2 x c^T``."""
    xn = (x * x).sum(-1, keepdim=True)  # (n, 1)
    cn = (c * c).sum(-1)  # (k,)
    return xn + cn[None, :] - (2.0 * x) @ c.T


def assign(x: torch.Tensor, c: torch.Tensor, *, use_kernel: bool = False) -> torch.Tensor:
    """Nearest-centroid assignment, (n,) int32.  ``use_kernel`` routes
    through ``kops.kmeans_assign`` (the CUDA kernel on a CUDA tensor, its
    plain version on a CPU tensor)."""
    if use_kernel:
        return kops.kmeans_assign(x, c)
    return torch.argmin(_sq_dists(x, c), dim=-1).to(torch.int32)


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms on for the block only.  On CUDA, a float
    ``cumsum`` (a decoupled look-back scan) and ``index_add_`` (atomics)
    otherwise sum in an order that can change from run to run."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn_only)


def _cumsum(p: torch.Tensor) -> torch.Tensor:
    with deterministic():
        return torch.cumsum(p, 0)


def _generator(key) -> torch.Generator:
    return torch.Generator().manual_seed(_seed_of(key))


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without a host synchronisation."""
    return x.index_select(0, i.reshape(1))[0]


def _choice(p_cuml: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One draw (a 0-d int64 index) ~ the cumulative weights ``p_cuml``
    from a uniform ``u`` in [0, 1), inverting the CDF as
    ``jax.random.choice`` does."""
    r = p_cuml[-1] * (1.0 - u)
    idx = torch.searchsorted(p_cuml, r.reshape(1))[0]
    return idx.clamp(max=p_cuml.shape[0] - 1)


def kmeans_plus_plus(key, x: torch.Tensor, k: int,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """kmeans++ seeding, (k, d).  With ``weights`` the D^2 sampling
    distribution becomes w*D^2 (a weight-w point seeds like w coincident
    unit-weight copies).  All k uniforms are drawn up front on the host, so
    the loop runs on the device without a synchronisation, and the
    cumulative sums are deterministic, so a key gives the same seeds on
    every run."""
    n = x.shape[0]
    u = torch.rand(k, generator=_generator(key), dtype=torch.float32).to(x.device)
    if weights is None:
        first = torch.clamp((u[0] * n).to(torch.int64), max=n - 1)
    else:
        w = weights.to(torch.float32)
        first = _choice(_cumsum(w / torch.clamp(w.sum(), min=1e-30)), u[0])
    centroids = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    c0 = _row(x, first)
    centroids[0] = c0
    d2 = ((x - c0) ** 2).sum(-1)
    for i in range(1, k):
        score = d2 if weights is None else d2 * weights
        p = score / torch.clamp(score.sum(), min=1e-30)
        c = _row(x, _choice(_cumsum(p), u[i]))
        centroids[i] = c
        d2 = torch.minimum(d2, ((x - c) ** 2).sum(-1))
    return centroids


def _lloyd_step(x, centroids, k: int, weights=None):
    a = assign(x, centroids)
    onehot = torch.nn.functional.one_hot(a.to(torch.int64), k).to(x.dtype)  # (n, k)
    if weights is None:
        counts = onehot.sum(0)  # (k,)
        sums = onehot.T @ x  # (k, d)
    else:
        w = weights.to(x.dtype)[:, None]  # (n, 1)
        counts = (onehot * w).sum(0)
        sums = onehot.T @ (x * w)
    new_c = sums / torch.clamp(counts[:, None], min=1e-12 if weights is not None else 1.0)
    # keep empty clusters where they were
    new_c = torch.where(counts[:, None] > 0, new_c, centroids)
    d2 = ((x - new_c[a.to(torch.int64)]) ** 2).sum(-1)
    inertia = (d2 if weights is None else d2 * weights).sum()
    return new_c, a, inertia


def kmeans(key, x: torch.Tensor, k: int, niter: int = 50,
           weights: torch.Tensor | None = None) -> KMeansResult:
    """Full-batch Lloyd's algorithm with kmeans++ init.  ``weights`` runs
    the count-weighted variant: the result equals unweighted k-means on the
    expanded multiset.  Assignments sum one-hot products (no atomics), so a
    run repeats bit for bit on the card."""
    x = x.to(torch.float32)
    if weights is not None:
        weights = weights.to(torch.float32)
    c = kmeans_plus_plus(key, x, k, weights)
    a = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    inertia = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(niter):
        c, a, inertia = _lloyd_step(x, c, k, weights)
    return KMeansResult(c, a, inertia)


def subsample(key, n: int, k: int, max_points_per_centroid: int = 256,
              device="cuda") -> torch.Tensor:
    """FAISS-style subsampling: train on at most 256*k of the ``n`` ids,
    drawn without replacement (int64 ids on ``device``)."""
    cap = max_points_per_centroid * k
    if n <= cap:
        return torch.arange(n, device=device)
    return torch.randperm(n, generator=_generator(key))[:cap].to(device)

