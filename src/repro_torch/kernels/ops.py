"""Public entry points of the port's kernels.

A CPU tensor runs the kernel's plain version (``ref.py``); a CUDA tensor
launches the hand-written kernel or raises.  There is no fallback from
one to the other.  ``LAUNCHES`` counts the kernel launches by name.

Unlike the JAX wrappers, nothing here pads the batch or codebook axes:
the TPU kernel's ``b_blk``/``k_blk`` blocks existed for the MXU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cce_lookup as _cl
from repro_torch.kernels import ref
from repro_torch.kernels.build import LAUNCHES  # noqa: F401  (re-exported)


def cce_lookup(idx: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Fused multi-table gather-sum: (c, B, T) int32 idx + (c, T, k, dsub)
    tables -> (B, c*dsub) embeddings.  An idx < 0 (the -1 sentinel) or
    >= k contributes exactly zero; sums in float32, returns the table
    dtype.  Forward only: the backward kernel is not ported yet."""
    if idx.device.type == "cpu" and tables.device.type == "cpu":
        return ref.cce_lookup_ref(idx, tables)
    return _cl.cce_lookup_fwd(idx, tables)


def pad_stack_tables(slabs, *, k_pad: int | None = None) -> torch.Tensor:
    """Per-feature slabs (c_f, T, k_f, dsub) with ragged k_f -> one
    (sum c_f, T, k_pad, dsub) supertable, zero-padding the codebook axis.
    Row ids into column f are always < k_f, so the padded rows are never
    read."""
    k_pad = k_pad or max(s.shape[2] for s in slabs)
    return torch.cat(
        [torch.nn.functional.pad(s, (0, 0, 0, k_pad - s.shape[2])) for s in slabs],
        dim=0,
    )
