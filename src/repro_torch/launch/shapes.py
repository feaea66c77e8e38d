"""The assigned input shapes and their input descriptions per (arch,
shape): the port of the JAX package's ``launch/shapes.py``.

Shapes (from the assignment):
    train_4k     seq 4,096   global_batch 256   -> train_step
    prefill_32k  seq 32,768  global_batch 32    -> prefill
    decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token)
    long_500k    seq 524,288 global_batch 1     -> serve_step; SSM/hybrid only

The input descriptions are ``(shape, dtype)`` pairs in the tree of the
inputs, the counterpart of the JAX package's ``ShapeDtypeStruct``s;
nothing is allocated (the cache's come from ``lm.init_cache`` on the meta
device).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape_name: str) -> bool:
    """long_500k needs sub-quadratic attention (DESIGN.md §long_500k)."""
    if shape_name == "long_500k":
        return cfg.subquadratic
    return True


def microbatch(cfg: ModelConfig, shape: Shape, n_dp: int) -> tuple[int, int]:
    """(accum, micro) for a train shape given the data-parallel degree."""
    micro = max(cfg.train_microbatch, n_dp)  # at least 1 seq per dp shard
    micro = min(micro, shape.global_batch)
    accum = shape.global_batch // micro
    return accum, micro


def sds(shape, dtype):
    """One input's description: ``(shape, dtype)``."""
    return (tuple(shape), dtype)


def _cache(cfg: ModelConfig, batch: int, seq: int):
    cache = lm.init_cache(cfg, batch, seq, device="meta")
    return {k: sds(v.shape, v.dtype) for k, v in cache.items()}


def train_input_specs(cfg: ModelConfig, shape: Shape, n_dp: int):
    """The batch's descriptions, leaves (accum, micro, ...)."""
    accum, micro = microbatch(cfg, shape, n_dp)
    S = shape.seq
    if cfg.n_codebooks:
        return {"tokens": sds((accum, micro, S, cfg.n_codebooks), torch.int32)}
    if cfg.family == "vlm":
        # n_patches image positions + text fill the seq budget
        return {"tokens": sds((accum, micro, S - cfg.n_patches), torch.int32),
                "patch_emb": sds((accum, micro, cfg.n_patches, cfg.d_model), cfg.dtype)}
    return {"tokens": sds((accum, micro, S), torch.int32)}


def prefill_input_specs(cfg: ModelConfig, shape: Shape):
    B, S = shape.global_batch, shape.seq
    toks = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    return {"tokens": sds(toks, torch.int32), "cache": _cache(cfg, B, S)}


def decode_input_specs(cfg: ModelConfig, shape: Shape):
    B, S = shape.global_batch, shape.seq
    toks = (B, cfg.n_codebooks) if cfg.n_codebooks else (B,)
    return {"tokens": sds(toks, torch.int32), "pos": sds((B,), torch.int32),
            "cache": _cache(cfg, B, S)}


def input_specs(cfg: ModelConfig, shape_name: str, n_dp: int = 16):
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return train_input_specs(cfg, shape, n_dp)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
