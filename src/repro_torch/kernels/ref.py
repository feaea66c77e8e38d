"""Plain PyTorch versions of the port's kernels: what a CPU tensor runs,
and what each kernel is held against on the card."""
from __future__ import annotations

import torch


def cce_lookup_ref(idx: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Fused multi-column gather-sum.

    idx (c, B, T) int32, any strides; tables (c, T, k, dsub) float32 or
    bfloat16.  Returns (B, c*dsub) in the table dtype with
    ``out[b, i*dsub:(i+1)*dsub] = sum_t tables[i, t, idx[i, b, t]]``.
    An index < 0 or >= k contributes exactly zero (the -1 sentinel of a
    T=1 table riding a T=2 supertable, or a cache-masked column).  Sums
    in float32 as ``acc = 0; acc += row_t`` in t order, the order the
    CUDA kernel uses, so float32 results agree bit for bit.
    """
    c, B, T = idx.shape
    _, _, k, dsub = tables.shape
    acc = torch.zeros((c, B, dsub), dtype=torch.float32, device=tables.device)
    for t in range(T):
        r = idx[:, :, t].to(torch.int64)
        valid = (r >= 0) & (r < k)
        picked = torch.gather(
            tables[:, t], 1, r.clamp(0, k - 1)[..., None].expand(c, B, dsub)
        )  # (c, B, dsub)
        acc = acc + torch.where(valid[..., None], picked.to(torch.float32), 0.0)
    return acc.to(tables.dtype).transpose(0, 1).reshape(B, c * dsub)


def cce_lookup_bwd_ref(idx: torch.Tensor, dout: torch.Tensor, k: int) -> torch.Tensor:
    """Gradient of ``cce_lookup_ref`` with respect to the tables.

    idx (c, B, T) int32, any strides; dout (B, c, dsub).  Returns
    (c, T, k, dsub) in the dout dtype with
    ``dtab[i, t, r] = sum over b with idx[i, b, t] == r of dout[b, i]``.
    An index < 0 or >= k adds nothing; rows no index names are 0.

    Each row sums its terms in float32 in increasing b, rounded once to
    the dout dtype: the additions of the CUDA kernel, so the two agree bit
    for bit on any device.  A stable sort by destination row ranks every
    term within its row; round j then adds the j-th term of every row with
    one ``index_add_`` whose destinations are all distinct, so no two
    terms of one row meet in an unordered sum (the number of rounds is the
    largest count of one row)."""
    c, B, T = idx.shape
    dsub = dout.shape[2]
    dev = idx.device
    r = idx.to(torch.int64).transpose(1, 2)  # (c, T, B): b fastest
    valid = (r >= 0) & (r < k)
    col_t = torch.arange(c, device=dev)[:, None, None] * T + torch.arange(T, device=dev)[None, :, None]
    dest = (col_t * k + r)[valid]  # flat (i, t, row), in (i, t, b) order
    src = (torch.arange(B, device=dev)[None, None, :] * c
           + torch.arange(c, device=dev)[:, None, None]).expand(c, T, B)[valid]  # row b*c + i of dout
    dest, perm = torch.sort(dest, stable=True)
    src = src[perm]
    pos = torch.arange(dest.numel(), device=dev)
    first = torch.ones_like(dest, dtype=torch.bool)
    first[1:] = dest[1:] != dest[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    flat = dout.reshape(B * c, dsub).to(torch.float32)
    acc = torch.zeros((c * T * k, dsub), dtype=torch.float32, device=dev)
    for j in range(int(rank.max()) + 1 if rank.numel() else 0):
        m = rank == j
        acc.index_add_(0, dest[m], flat[src[m]])
    return acc.reshape(c, T, k, dsub).to(dout.dtype)


def kmeans_assign_ref(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(n, d) points, (k, d) centroids -> (n,) int32
    ``argmin_j (||c_j||^2 - 2 <x, c_j>)`` in float32, ties to the lowest j:
    the expression of the TPU kernel and of the CUDA kernel (no ``||x||^2``
    term).  Callers comparing against the kernel turn TF32 off."""
    x = x.to(torch.float32)
    c = centroids.to(torch.float32)
    cn = (c * c).sum(-1)
    return torch.argmin(cn[None, :] - 2.0 * (x @ c.T), dim=-1).to(torch.int32)
