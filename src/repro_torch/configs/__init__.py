"""LM config registry: ``get(name)`` -> full-size ModelConfig,
``get_reduced(name)`` -> its CPU test variant.  ``ARCHS`` lists the
architectures the port serves (the dense family); the DLRM configuration
lives in ``configs/dlrm_criteo.py``."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import qwen2_1_5b, qwen3_4b, qwen3_14b

ARCHS = {
    "qwen2-1.5b": qwen2_1_5b.CONFIG,
    "qwen3-4b": qwen3_4b.CONFIG,
    "qwen3-14b": qwen3_14b.CONFIG,
}


def get(name: str, **overrides):
    cfg = ARCHS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_reduced(name: str, **overrides):
    return ARCHS[name].reduced(**overrides)
