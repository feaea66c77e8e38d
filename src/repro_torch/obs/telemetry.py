"""In-step telemetry — health metrics that ride the train step (the port
of the JAX package's ``obs/telemetry.py``).

Plain torch reductions over values the step already holds (the averaged
gradients, the params, the batch), returned under
``metrics["telemetry"]`` as 0-d and 1-d tensors on the step's device.
Nothing here reads a value back to the host (no ``.item()``): the metrics
pump (``obs/pump.py``) copies them out a few steps late.

Signals (each gated by a ``TelemetryConfig`` flag):

  * ``emb_grad_norm`` / ``emb_param_norm`` — (G,) per-embedding-group L2
    norms of gradient / slab.
  * ``grad_nonfinite`` / ``param_nonfinite`` — (L,) per-param-leaf
    counts of non-finite elements, in ``jax.tree`` leaf order
    (``telemetry_labels`` names each index, as the JAX package does).
  * ``rows_occupancy`` — fraction of non-sentinel entries in a
    host-translated ``rows`` batch (-1 marks padded sub-table slots).
  * ``shard_occupancy`` — (M,) per-model-shard occupancy when rows
    arrive pre-bucketed (accum, micro, M, n_cols, T).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import jax_leaves, jax_leaves_with_paths


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Which in-step signals to compute (all default on)."""

    emb_norms: bool = True
    nonfinite: bool = True
    occupancy: bool = True


def telemetry_labels(params) -> dict:
    """Names for the telemetry vector indices: ``leaves[i]`` labels
    ``grad_nonfinite[i]`` / ``param_nonfinite[i]`` (``jax.tree_util.keystr``
    paths, ``jax.tree`` order); ``emb_groups`` is G, the length of the
    ``emb_*_norm`` vectors (0 when params carry no per-group emb list)."""
    emb = params.get("emb") if isinstance(params, dict) else None
    return {
        "leaves": tuple(path for path, _ in jax_leaves_with_paths(params)),
        "emb_groups": len(emb) if isinstance(emb, (list, tuple)) else 0,
    }


def _group_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in jax_leaves(tree)))


def _nonfinite_counts(tree) -> torch.Tensor:
    return torch.stack([torch.sum(~torch.isfinite(leaf), dtype=torch.int32)
                        for leaf in jax_leaves(tree)])


def telemetry_metrics(tcfg: TelemetryConfig, grads, params, batch) -> dict:
    """The in-step telemetry tree: call inside the step with the averaged
    (pre-clip) grads, the current params, and the full batch (leaves
    shaped (accum, micro, ...)).  Returns a flat dict of small tensors."""
    out: dict = {}
    emb = params.get("emb") if isinstance(params, dict) else None
    if tcfg.emb_norms and isinstance(emb, (list, tuple)):
        out["emb_grad_norm"] = torch.stack([_group_norm(g) for g in grads["emb"]])
        out["emb_param_norm"] = torch.stack([_group_norm(p) for p in emb])
    if tcfg.nonfinite:
        out["grad_nonfinite"] = _nonfinite_counts(grads)
        out["param_nonfinite"] = _nonfinite_counts(params)
    rows = batch.get("rows") if isinstance(batch, dict) else None
    if tcfg.occupancy and rows is not None:
        live = (rows >= 0).to(torch.float32)
        out["rows_occupancy"] = torch.mean(live)
        if rows.ndim == 5:  # (accum, micro, M, n_cols, T): pre-bucketed
            out["shard_occupancy"] = torch.mean(live, dim=(0, 1, 3, 4))
    return out
