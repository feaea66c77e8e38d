"""Dense and sparse CCE for least squares: Algorithms 1 and 2 and the
machinery of Theorem 3.1, the port of the JAX package's
``core/least_squares.py``.

Problem: given X (n, d1), Y (n, d2), find T minimising ||X T - Y||_F^2
without storing a d1 x d2 matrix.  T stays factored as H @ M with H
(d1, k) sparse or random and M (k, d2) dense, k << d1.

Dense CCE (Alg. 1): H_i = [T_{i-1} | G_i] with G_i fresh Gaussian noise;
M_i solves the k-dim least squares; T_i = H_i M_i.  Theorem 3.1:

    E||X T_i - Y||^2 <= (1 - rho)^{i(k-d2)} ||X T*||^2 + ||X T* - Y||^2,
    rho = sigma_min(X)^2 / ||X||_F^2.

Sparse CCE (Alg. 2): k-means the rows of T_{i-1} into k/2 clusters (a
one-hot assignment A), add a fresh count-sketch C, H_i = [A | C], solve
M_i exactly.  Only the assignments and M are ever stored.

Keys are ``repro_torch.random`` keys, split as the JAX package splits
them, so the count-sketch hashes are JAX's.  The Gaussian draws
(``_normal``) and the k-means++ seeds come from ``torch.Generator``s
seeded from the keys and are not JAX's.  Least-squares solves take the
SVD with JAX's default cut-off, so the rank-deficient first iteration
(T_0 = 0) has the same minimum-norm solution on every device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as jr
from repro_torch.core import hashing
from repro_torch.core import kmeans as km


class LSTrace(NamedTuple):
    losses: torch.Tensor  # (iters+1,) ||X T_i - Y||_F^2
    T: torch.Tensor  # final (d1, d2)


def _normal(key, shape, dtype, device) -> torch.Tensor:
    """Standard normal draws for ``key``."""
    return torch.randn(shape, generator=km._generator(key), dtype=dtype).to(device)


def _lstsq(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """argmin_M ||A M - B||_F^2, the minimum-norm solution: singular values
    below eps * max(A.shape) * s_max count as zero, as in
    ``jnp.linalg.lstsq``."""
    U, S, Vh = torch.linalg.svd(A, full_matrices=False)
    keep = S >= torch.finfo(A.dtype).eps * max(A.shape) * S[0]
    inv = torch.where(keep, 1.0 / torch.where(keep, S, 1.0), 0.0)
    return Vh.T @ (inv[:, None] * (U.T @ B))


def loss(X, T, Y) -> torch.Tensor:
    return torch.sum((X @ T - Y) ** 2)


def optimal_loss(X, Y) -> tuple[torch.Tensor, torch.Tensor]:
    T_star = _lstsq(X, Y)
    return loss(X, T_star, Y), T_star


def theorem_bound(X, Y, k: int, iters: int) -> torch.Tensor:
    """The right-hand side of Theorem 3.1 per iteration:
    (1-rho)^{i(k-d2)} ||X T*||^2 + opt, (iters+1,)."""
    d2 = Y.shape[1]
    sig = torch.linalg.svdvals(X)
    rho = sig[-1] ** 2 / torch.sum(sig ** 2)
    opt, T_star = optimal_loss(X, Y)
    xt2 = torch.sum((X @ T_star) ** 2)
    i = torch.arange(iters + 1, device=X.device, dtype=X.dtype)
    return (1 - rho) ** (i * (k - d2)) * xt2 + opt


def dense_cce(key, X: torch.Tensor, Y: torch.Tensor, k: int, iters: int, *,
              smart_noise: bool = False, identity_prefix: bool = True) -> LSTrace:
    """Algorithm 1.  ``smart_noise`` aligns G with the SVD of X (Appendix
    B); ``identity_prefix=False`` restricts M to [I | M'] as the proof
    does (Figure 6's "half noise"); the default optimises M whole."""
    _, d1 = X.shape
    d2 = Y.shape[1]
    if not d1 > k > d2:
        raise ValueError(f"dense_cce needs d1 > k > d2, got {(d1, k, d2)}")
    T = torch.zeros((d1, d2), dtype=X.dtype, device=X.device)
    losses = [loss(X, T, Y)]
    if smart_noise:
        _, S, Vh = torch.linalg.svd(X, full_matrices=False)
        VSinv = Vh.T / S[None, :]
    for _ in range(iters):
        key, kg = jr.split(key)
        if smart_noise:
            G = VSinv @ _normal(kg, (VSinv.shape[1], k - d2), X.dtype, X.device)
        else:
            G = _normal(kg, (d1, k - d2), X.dtype, X.device)
        H = torch.cat([T, G], dim=1)  # (d1, k)
        if identity_prefix:
            M = _lstsq(X @ H, Y)
        else:
            Mp = _lstsq(X @ G, Y - X @ T)
            M = torch.cat([torch.eye(d2, dtype=X.dtype, device=X.device), Mp], dim=0)
        T = H @ M
        losses.append(loss(X, T, Y))
    return LSTrace(torch.stack(losses), T)


def sparse_cce(key, X: torch.Tensor, Y: torch.Tensor, k: int, iters: int, *,
               kmeans_iters: int = 25) -> LSTrace:
    """Algorithm 2.  T is only ever held factored: assignments (d1,) plus
    M (k, d2), the clustered half A and a fresh count-sketch C each
    round."""
    n, d1 = X.shape
    d2 = Y.shape[1]
    kc = k // 2  # rows of the clustered part A
    ks = k - kc  # rows of the count-sketch part C
    T = torch.zeros((d1, d2), dtype=X.dtype, device=X.device)
    losses = [loss(X, T, Y)]
    ids = torch.arange(d1, device=X.device)
    for _ in range(iters):
        key, k1, k2, k3 = jr.split(key, 4)
        # line 5: cluster the rows of the (implicit) T
        A_rows = km.kmeans(k1, T, kc, niter=kmeans_iters).assignments.to(torch.int64)
        # line 6: a fresh count-sketch C
        C_rows = hashing.make_hash(hashing._seed_of(k2), ks)(ids).to(torch.int64)
        C_signs = hashing.make_sign_hash(k3)(ids).to(X.dtype)
        # line 7: X @ [A | C] without H, then M on the sketched problem
        with km.deterministic():
            XA = torch.zeros((n, kc), dtype=X.dtype, device=X.device).index_add_(1, A_rows, X)
            XC = torch.zeros((n, ks), dtype=X.dtype, device=X.device).index_add_(
                1, C_rows, X * C_signs)
        M = _lstsq(torch.cat([XA, XC], dim=1), Y)  # (k, d2)
        T = M[A_rows] + C_signs[:, None] * M[kc + C_rows]
        losses.append(loss(X, T, Y))
    return LSTrace(torch.stack(losses), T)


def kmeans_factorize(key, T: torch.Tensor, k: int, ones_per_row: int = 1, niter: int = 50):
    """Post-hoc factorisation T ~= H M by k-means (Figure 1b's comparison
    lines): one 1 a row is plain PQ of the whole row; two ones a row
    cluster, then cluster the residuals."""
    res = km.kmeans(key, T, k if ones_per_row == 1 else k // 2, niter=niter)
    approx = res.centroids[res.assignments.to(torch.int64)]
    if ones_per_row == 1:
        return approx
    res2 = km.kmeans(jr.fold_in(key, 1), T - approx, k // 2, niter=niter)
    return approx + res2.centroids[res2.assignments.to(torch.int64)]
