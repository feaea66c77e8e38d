"""Optimizers as (init, update) pairs over param trees, the port of the
JAX package's ``optim/optimizers.py``.

SGD(+momentum) is the paper's choice for DLRM; AdamW is the LM default.
Where the JAX step donates its buffers, ``update`` writes the new values
INTO the param and moment tensors it is given (under ``torch.no_grad``)
and returns the same trees, so a step allocates no second copy of the
state.  ``torch.optim`` is not used: the clustering transition remaps the
moment tree (``optim/remap.py``), which needs the moments as a tree that
mirrors params.

ZeRO-1: ``zero1_specs`` extends a param spec tree (``shard.Spec`` leaves)
so that the optimizer moments also split over the data axis wherever a
dim divides; ``zero1(optimizer, moment_specs, group)`` makes the update of
that layout: each data rank updates its slice of the moments and of the
params, then the params' slices are gathered over the data group.  A
param split over the data axis itself (the moe family's experts) is this
rank's slice already, as are its moments and gradients: it is updated
whole and not gathered.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.shard import Spec, all_gather_cat, rank_and_size, spec_dim
from repro_torch.tree import tree_leaves, tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Pytree], Pytree]
    update: Callable[[Pytree, Pytree, Pytree, torch.Tensor], tuple[Pytree, Pytree]]
    # update(grads, state, params, lr) -> (params, state), updated in place


def sgd(momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"m": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        if momentum == 0.0:
            tree_map(lambda p, g: p.sub_(lr * g), params, grads)
            return params, state
        # m = momentum * m + g; p = p - lr * m
        tree_map(lambda m, g: m.mul_(momentum).add_(g), state["m"], grads)
        tree_map(lambda p, m: p.sub_(lr * m), params, state["m"])
        return params, state

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        leaf = tree_leaves(params)[0]
        return {
            "m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "t": torch.zeros((), dtype=torch.int32, device=leaf.device),
        }

    @torch.no_grad()
    def update(grads, state, params, lr):
        t = state["t"] + 1
        tree_map(lambda m, g: m.mul_(b1).add_((1 - b1) * g), state["m"], grads)
        tree_map(lambda v, g: v.mul_(b2).add_((1 - b2) * g * g), state["v"], grads)
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=tf.device), tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=tf.device), tf)

        def step(p, m, v):
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p.copy_(p - lr * (upd + weight_decay * p))

        tree_map(step, params, state["m"], state["v"])
        return params, {"m": state["m"], "v": state["v"], "t": t}

    return Optimizer(init, update)


def clip_by_global_norm(grads: Pytree, max_norm: float) -> tuple[Pytree, torch.Tensor]:
    """Scale ``grads`` by ``min(1, max_norm / max(gnorm, 1e-12))`` (not
    ``clip_grad_norm_``'s ``max_norm / (gnorm + 1e-6)``); returns the
    scaled grads and the float32 global norm."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gnorm


def clip_by_global_norm_(grads: Pytree, max_norm: float) -> tuple[Pytree, torch.Tensor]:
    """``clip_by_global_norm`` in place: each leaf of ``grads`` (no two
    sharing memory) is scaled where it lies, the same values without a
    second copy of the gradients.  Returns ``grads`` and the norm."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    for g in leaves:
        g.mul_(scale)
    return grads, gnorm


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """step -> float32 learning rate: linear warm-up, then cosine decay to
    ``min_frac * base_lr`` at ``total``."""

    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(1, warmup)
        prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr


def zero1_specs(param_specs: Pytree, params_shape: Pytree, dp_size: int = 0) -> Pytree:
    """The moments' specs: each param spec with the data axis added on the
    largest dim that no axis splits yet and ``dp_size`` divides (the
    first such dim on a tie), as the JAX package's ``zero1_specs`` picks
    it; unchanged where none divides, where the data axis is already used
    or for ``dp_size`` 0.  ``params_shape``: the whole params (tensors,
    meta tensors or anything with ``.shape``)."""

    def extend(spec, leaf):
        if spec.data is not None or not dp_size:
            return spec
        best, best_dim = -1, None
        for i, n in enumerate(leaf.shape):
            if i != spec.model and n % dp_size == 0 and n > best:
                best, best_dim = n, i
        return dataclasses.replace(spec, data=best_dim)

    return tree_map(extend, param_specs, params_shape)


def moment_specs(opt_name: str, param_specs: Pytree, params_shape: Pytree,
                 dp_size: int = 0) -> Pytree:
    """The spec tree of the optimizer state: "sgd" {}, "sgdm" {"m"},
    "adamw" {"m", "v", "t"}, the moments under ``zero1_specs``."""
    z = zero1_specs(param_specs, params_shape, dp_size)
    if opt_name == "sgd":
        return {}
    if opt_name == "sgdm":
        return {"m": z}
    return {"m": z, "v": z, "t": Spec()}


def zero1(optimizer: Optimizer, moment_specs: Pytree, group) -> Optimizer:
    """``optimizer`` over moments split by ``moment_specs``' data dims
    (its "m" tree) across the data ``group``: ``update`` takes the params
    and gradients (the gradients already summed over the group) and this
    rank's moment slices, updates the matching slices of the params in
    place, then gathers every split param over the group.  A param whose
    moments have its own shape is this rank's slice already (split over
    the data axis by its own spec), as is its gradient: updated whole,
    not gathered.  With a group of one (or none) each slice is the whole
    leaf and the update is ``optimizer``'s bit for bit.  ``init`` is left
    to the caller: the moments come from slicing a whole state
    (``shard.shard_tree``)."""
    rank, n = rank_and_size(group)

    def view(x, d):
        if d is None:
            return x
        size = x.shape[d] // n
        return x.narrow(d, rank * size, size)

    @torch.no_grad()
    def update(grads, state, params, lr):
        dims = tree_map(lambda s, p, m: spec_dim(s, "data") if n > 1 and p.shape != m.shape
                        else None, moment_specs["m"], params, state["m"])
        pv = tree_map(view, params, dims)
        _, new_state = optimizer.update(tree_map(view, grads, dims), state, pv, lr)

        def gather(p, v, d):
            if d is not None:
                p.copy_(all_gather_cat(v, d, group))

        tree_map(gather, params, pv, dims)
        return params, new_state

    return Optimizer(optimizer.init, update)
