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
JAX's draws.  As in the JAX package, ``kmeans(..., use_kernel=True)``
routes every Lloyd assignment through the kernel and the default does
not; ``CCE.cluster`` takes the default, and only ``CCE.assign_all`` takes
the kernel.
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


def assign_chunks(chunks, centroids: torch.Tensor, out: torch.Tensor, *,
                  use_kernel: bool | None = None) -> torch.Tensor:
    """Nearest centroid of every column's points, streamed: ``chunks``
    yields (first row, (c, n, d) points), ``centroids`` is (c, k, d), and
    each chunk's picks land in ``out[:, first: first + n]`` ((c, d1)
    int32).  When ``use_kernel`` (default: on a CUDA device, as the JAX
    package takes its kernel on the TPU) a chunk is ONE
    ``kops.kmeans_assign_batched`` call for all columns, written straight
    into its slice; else each column goes through ``assign``.  Chunking
    cannot change an argmin: each point's distances are its own."""
    if use_kernel is None:
        use_kernel = centroids.device.type == "cuda"
    for s, x in chunks:
        block = out[:, s: s + x.shape[1]]
        if use_kernel:
            kops.kmeans_assign_batched(x, centroids, out=block)
        else:
            for i in range(x.shape[0]):
                block[i] = assign(x[i], centroids[i])
    return out


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


def _lloyd_step(x, centroids, k: int, use_kernel: bool = False, weights=None):
    a, moments = _local_moments(x, centroids, k, use_kernel, weights)
    new_c = _centroid_update(moments, centroids, weights is not None)
    d2 = ((x - new_c[a.to(torch.int64)]) ** 2).sum(-1)
    inertia = (d2 if weights is None else d2 * weights).sum()
    return new_c, a, inertia


def _local_moments(x, centroids, k: int, use_kernel: bool, weights):
    """(assignments, (k, 1 + d) [count | sum] moments) of the points x."""
    a = assign(x, centroids, use_kernel=use_kernel)
    onehot = torch.nn.functional.one_hot(a.to(torch.int64), k).to(x.dtype)  # (n, k)
    if weights is None:
        counts, sums = onehot.sum(0), onehot.T @ x
    else:
        w = weights.to(x.dtype)[:, None]  # (n, 1)
        counts, sums = (onehot * w).sum(0), onehot.T @ (x * w)
    return a, torch.cat([counts[:, None], sums], dim=1)


def _centroid_update(moments, centroids, weighted: bool):
    counts, sums = moments[:, 0], moments[:, 1:]
    new_c = sums / torch.clamp(counts[:, None], min=1e-12 if weighted else 1.0)
    # keep empty clusters where they were
    return torch.where(counts[:, None] > 0, new_c, centroids)


def kmeans(key, x: torch.Tensor, k: int, niter: int = 50, use_kernel: bool = False,
           weights: torch.Tensor | None = None) -> KMeansResult:
    """Full-batch Lloyd's algorithm with kmeans++ init.  ``use_kernel``
    routes every iteration's assignment through ``kops.kmeans_assign``.
    ``weights`` runs the count-weighted variant: the result equals
    unweighted k-means on the expanded multiset.  Assignments sum one-hot
    products (no atomics), so a run repeats bit for bit on the card."""
    x = x.to(torch.float32)
    if weights is not None:
        weights = weights.to(torch.float32)
    c = kmeans_plus_plus(key, x, k, weights)
    a = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    inertia = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(niter):
        c, a, inertia = _lloyd_step(x, c, k, use_kernel, weights)
    return KMeansResult(c, a, inertia)


def subsample(key, n: int, k: int, max_points_per_centroid: int = 256,
              device="cuda") -> torch.Tensor:
    """FAISS-style subsampling: train on at most 256*k of the ``n`` ids,
    drawn without replacement (int64 ids on ``device``)."""
    cap = max_points_per_centroid * k
    if n <= cap:
        return torch.arange(n, device=device)
    return torch.randperm(n, generator=_generator(key))[:cap].to(device)



# --- k-means of many columns, over a process group -----------------------
# Each rank of a group holds a slice of the sample.  One Lloyd iteration:
# local assignment, local (count, sum) moments, one all-reduce, the same
# centroid update on every rank.  With no group (or on one rank) it is the
# serial ``_lloyd_step`` bit for bit.


def _seed_on_every_rank(centroids, group):
    """Rank 0's kmeans++ seeds on every rank: a masked all-reduce (exactly
    one non-zero term)."""
    from repro_torch.shard import all_reduce_, rank_and_size

    if rank_and_size(group)[0] != 0:
        centroids = torch.zeros_like(centroids)
    return all_reduce_(centroids.contiguous(), group)


def kmeans_columns(keys, x: torch.Tensor, k: int, group=None, niter: int = 50,
                   use_kernel: bool = False,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """k-means of every column of x (c, n, d), column i under ``keys[i]``:
    (c, k, d) centroids.  The columns run in lockstep, so that each
    iteration's moments of all of them go in ONE all-reduce (c times fewer
    collectives than a column at a time).

    With no ``group`` each column is ``kmeans(keys[i], x[i], ...)``'s
    centroids bit for bit.  Over a group each rank holds its slice of
    every column's points (and their ``weights``), and each column is the
    JAX package's ``distributed_kmeans``: kmeans++ on rank 0's slice (its
    approximation), sent to every rank by a masked all-reduce, then
    ``niter`` Lloyd iterations over all the points.  The result is equal
    on every rank; on one rank it is the serial one bit for bit."""
    from repro_torch.shard import all_reduce_

    x = x.to(torch.float32)
    if weights is not None:
        weights = weights.to(torch.float32)
    cols = range(x.shape[0])
    cents = _seed_on_every_rank(
        torch.stack([kmeans_plus_plus(keys[i], x[i], k, weights) for i in cols]), group)
    for _ in range(niter):
        moments = all_reduce_(torch.stack(
            [_local_moments(x[i], cents[i], k, use_kernel, weights)[1] for i in cols]), group)
        cents = torch.stack([_centroid_update(moments[i], cents[i], weights is not None)
                             for i in cols])
    return cents


def distributed_kmeans(key, x_local: torch.Tensor, k: int, group, niter: int = 50,
                       use_kernel: bool = False, weights: torch.Tensor | None = None):
    """The JAX package's ``distributed_kmeans``: ``kmeans_columns`` of one
    column.  Returns (centroids, the local assignments)."""
    c = kmeans_columns([key], x_local[None], k, group, niter, use_kernel, weights)[0]
    return c, assign(x_local.to(torch.float32), c, use_kernel=use_kernel)
