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
