"""Optimizer-state handling for the CCE clustering transition, the port of
the JAX package's ``optim/remap.py``.

``CCE.cluster`` rewrites a table's rows (centroids into the main table,
zeros into the helper) and its pointer array, but the momentum / Adam
moments of those rows still describe the OLD rows.  ``remap_opt_state``
threads a moment transform through the optimizer-state tree, by policy:

  * ``"remap"``: per-row moments follow the cluster assignments (mean of
    the merged rows' moments, zeros for the fresh helper table; see
    ``CCE.remap_moments``).
  * ``"reset"``: zero the transitioned tables' moments.
  * ``"keep"``: leave the state untouched (for ablation).

Only per-row moment slots are touched; scalar slots (Adam's step count
``t``) pass through.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.tree import tree_map

Pytree = Any

#: Per-row moment slots of the optimizers (sgd-momentum: {"m"}; adamw:
#: {"m", "v"}).
MOMENT_KEYS = ("m", "v")

POLICIES = ("remap", "reset", "keep")


def remap_opt_state(opt: Pytree, update_fn: Callable[[Pytree, str], Pytree], *,
                    policy: str = "remap") -> Pytree:
    """Apply ``update_fn(moment_tree, slot_name)`` to each per-parameter
    moment tree of an optimizer state; returns a new state dict.  Plain-SGD
    state ({}) and ``policy="keep"`` are no-ops."""
    if policy not in POLICIES:
        raise ValueError(f"unknown transition policy {policy!r}; want one of {POLICIES}")
    if opt is None or policy == "keep" or not opt:
        return opt
    new = dict(opt)
    for slot in MOMENT_KEYS:
        if slot in new:
            new[slot] = update_fn(new[slot], slot)
    return new


def zeros_like_moments(moments: Pytree) -> Pytree:
    """The ``"reset"`` policy for one table's moment subtree."""
    return tree_map(torch.zeros_like, moments)


def collection_moment_updater(coll, group_updates):
    """Moment transform for the GROUPED embedding layout: moments mirror
    params, so a universal group's moments are one stacked slab.
    ``group_updates`` maps group index -> {feature-local index -> that
    feature's moment-update fn (``transition_table``)}; the returned
    function slices each transitioned feature's block out of the slab,
    applies its update and re-stacks (zero-padded rows stay zero)."""

    def update(emb_moments):
        out = list(emb_moments)
        for g, fns in group_updates.items():
            grp = coll.groups[g]
            per = coll.unstack_group_params(grp, emb_moments[g])
            for f_local, fn in fns.items():
                per[f_local] = fn(per[f_local])
            out[g] = coll.stack_group_params(grp, per)
        return out

    return update
