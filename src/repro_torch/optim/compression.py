"""Gradient compression with error feedback, the port of the JAX
package's ``optim/compression.py``: int8 per-tensor-scale quantization,
with the quantization residual carried into the next step's gradient so
the compression bias vanishes in expectation."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map

Pytree = Any


def int8_compress(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(values int8, scale float32).  Symmetric per-tensor scaling."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def init_error_feedback(params: Pytree) -> Pytree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def compressed_grad_transform(grads: Pytree, error: Pytree) -> tuple[Pytree, Pytree]:
    """Quantize (grad + carried error) to int8; return the dequantized
    gradient and the new error-feedback state."""

    def one(g, e):
        target = g.to(torch.float32) + e
        q, scale = int8_compress(target)
        deq = int8_decompress(q, scale)
        return deq.to(g.dtype), target - deq

    out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(error))]
    it = iter(out)
    new_g = tree_map(lambda _: next(it)[0], grads)
    it = iter(out)
    new_e = tree_map(lambda _: next(it)[1], grads)
    return new_g, new_e
