"""LM config registry: ``get(name)`` -> full-size ModelConfig,
``get_reduced(name)`` -> its CPU test variant.  ``ARCHS`` lists the
architectures the port runs, every one of the JAX package's: the dense
family (qwen2-1.5b, qwen3-4b, qwen3-14b and command-r-35b, whose 28.4 B
params fit one card only cut in depth, or split over a model axis:
``launch.steps``), the hybrid family's hymba-1.5b, the xlstm family's
xlstm-1.3b and the vlm family's paligemma-3b, each trained and served;
the moe family's phi3.5-moe-42b-a6.6b and qwen3-moe-235b-a22b, served;
the audio family's musicgen-medium, trained and run through
``lm.prefill`` and ``lm.decode_step``, which the serving engine does not
take.  ``UNPORTED`` (configuration -> family) is empty; a name in it
would raise.  The DLRM configuration lives in ``configs/dlrm_criteo.py``."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    command_r_35b,
    hymba_1_5b,
    musicgen_medium,
    paligemma_3b,
    phi3_5_moe,
    qwen2_1_5b,
    qwen3_4b,
    qwen3_14b,
    qwen3_moe_235b,
    xlstm_1_3b,
)

ARCHS = {
    "qwen2-1.5b": qwen2_1_5b.CONFIG,
    "qwen3-4b": qwen3_4b.CONFIG,
    "qwen3-14b": qwen3_14b.CONFIG,
    "command-r-35b": command_r_35b.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "paligemma-3b": paligemma_3b.CONFIG,
    "xlstm-1.3b": xlstm_1_3b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b.CONFIG,
    "musicgen-medium": musicgen_medium.CONFIG,
}

#: The JAX package's configurations that the port lacks -> their family.
UNPORTED: dict[str, str] = {}


def _config(name: str):
    if name in UNPORTED:
        raise NotImplementedError(f"{name} (the {UNPORTED[name]} family) is not ported; "
                                  f"the port has {sorted(ARCHS)}")
    return ARCHS[name]


def get(name: str, **overrides):
    cfg = _config(name)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_reduced(name: str, **overrides):
    return _config(name).reduced(**overrides)
