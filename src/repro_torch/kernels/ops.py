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
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kmeans_assign as _ka
from repro_torch.kernels import ref
from repro_torch.kernels.build import LAUNCHES  # noqa: F401  (re-exported)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


class _CCELookup(torch.autograd.Function):
    """The lookup with its gradient: the JAX package's ``custom_vjp``.  The
    backward is the scatter-add kernel on CUDA tensors and its plain
    version on CPU tensors; idx gets no gradient."""

    @staticmethod
    def forward(ctx, idx, tables):
        ctx.save_for_backward(idx)
        ctx.k, ctx.dtype = tables.shape[2], tables.dtype
        if _on_cpu(idx, tables):
            return ref.cce_lookup_ref(idx, tables)
        return _cl.cce_lookup_fwd(idx, tables)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        c, B, _ = idx.shape
        dout = g.reshape(B, c, -1).to(ctx.dtype)
        if _on_cpu(idx, dout):
            return None, ref.cce_lookup_bwd_ref(idx, dout, ctx.k)
        return None, _cl.cce_lookup_bwd(idx, dout, ctx.k)


def cce_lookup(idx: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Fused multi-table gather-sum: (c, B, T) int32 idx + (c, T, k, dsub)
    tables -> (B, c*dsub) embeddings.  An idx < 0 (the -1 sentinel) or
    >= k contributes exactly zero; sums in float32, returns the table
    dtype.  Differentiable with respect to ``tables``: the gradient is the
    deterministic scatter-add (sentinel and padding rows get exactly 0)."""
    return _CCELookup.apply(idx, tables)


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(n, d) points, (k, d) centroids -> (n,) int32 nearest-centroid ids,
    ``argmin_j (||c_j||^2 - 2 <x, c_j>)`` in float32, ties to the lowest j."""
    if _on_cpu(x, centroids):
        return ref.kmeans_assign_ref(x, centroids)
    return _ka.kmeans_assign(x.to(torch.float32).contiguous(),
                             centroids.to(torch.float32).contiguous())


def kmeans_assign_batched(x: torch.Tensor, centroids: torch.Tensor,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """(c, n, d) points, (c, k, d) centroids -> (c, n) int32: column i's
    nearest-centroid ids among centroids[i], as ``kmeans_assign`` gives
    them, in one launch for all columns.  Written into ``out`` ((c, n)
    int32; on CUDA with unit last stride, any row stride) when given."""
    if _on_cpu(x, centroids, *(() if out is None else (out,))):
        return ref.kmeans_assign_batched_ref(x, centroids, out)
    return _ka.kmeans_assign(x.to(torch.float32).contiguous(),
                             centroids.to(torch.float32).contiguous(), out=out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Causal (or full) GQA softmax attention, forward only: q (B, Sq, H,
    D), k/v (B, S, KVH, D) -> (B, Sq, H, D) in q's dtype; query head h
    reads KV head h // (H // KVH); scale 1/sqrt(D); query i sees keys
    j <= i when ``causal``.  Sq and S are taken as they are: nothing is
    padded.  Raises where autograd would need a gradient: the kernel has
    no backward, as the JAX package's has none."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is forward-only: call it under torch.no_grad() "
                           "or torch.inference_mode()")
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    return _fa.flash_attention(q, k, v, causal=causal)


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
