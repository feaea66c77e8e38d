"""Rank slices of a model-parallel state and the collectives that move them.

A sharded state is a tree whose every leaf has a spec, in a tree of the
same structure (``launch.steps.dlrm_state_specs``): the dim the leaf splits
over the model group's M ranks, or None for a leaf every rank holds whole.
Every split is even (the supertable's ``k_pad`` is a multiple of M, the
pointer tables split only a dim M divides), so rank r holds the r-th of M
equal slices.

* ``shard_tree(tree, specs, rank, M)`` cuts rank r's slices out of a whole
  tree: a 1-device state, a checkpoint's host tree or the JAX package's
  arrays (numpy leaves stay numpy).
* ``gather_tree(tree, specs, group, dst=None)`` puts the slices back
  together, on every rank, or on ``dst`` alone (None elsewhere).
* ``all_to_all`` is the differentiable all-to-all of the routed lookup;
  ``all_reduce_`` and ``all_gather_cat`` are the sums and gathers the
  step and the transition write by hand where GSPMD inserted them in JAX.
  Code that runs with or without a group (the transition) passes
  ``group=None`` for none: ``all_reduce_`` then returns its input, and
  ``rank_and_size`` gives (0, 1).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

Pytree = Any


def shard_leaf(x, dim: int | None, rank: int, n_shards: int):
    """Rank ``rank``'s slice of ``x`` along ``dim`` (``x`` itself when
    ``dim`` is None), as a tensor or array of its own."""
    if dim is None or n_shards == 1 or x is None:
        return x
    n = x.shape[dim]
    if n % n_shards:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n_shards}")
    size = n // n_shards
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, rank * size, size).clone(memory_format=torch.contiguous_format)
    sl = [slice(None)] * np.ndim(x)
    sl[dim] = slice(rank * size, (rank + 1) * size)
    return np.ascontiguousarray(np.asarray(x)[tuple(sl)])


def shard_tree(tree: Pytree, specs: Pytree, rank: int, n_shards: int) -> Pytree:
    """Rank ``rank``'s part of a whole ``tree`` under ``specs``."""
    return tree_map(lambda x, d: shard_leaf(x, d, rank, n_shards), tree, specs)


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in
    rank order, on every rank."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def gather_cat(x: torch.Tensor, dim: int, group, dst: int = 0) -> torch.Tensor | None:
    """``all_gather_cat`` onto group rank ``dst`` only; None elsewhere."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)] if rank == dst else None
    dist.gather(x, parts, dst=dist.get_global_rank(group, dst), group=group)
    return torch.cat(parts, dim=dim) if rank == dst else None


def gather_tree(tree: Pytree, specs: Pytree, group, dst: int | None = None) -> Pytree:
    """The whole tree from every rank's slices: on every rank when ``dst``
    is None, else on group rank ``dst`` (the other ranks get None at every
    split leaf and their own whole leaves)."""
    if dist.get_world_size(group) == 1:
        return tree

    def leaf(x, d):
        if d is None or not isinstance(x, torch.Tensor):
            return x
        return all_gather_cat(x, d, group) if dst is None else gather_cat(x, d, group, dst)

    return tree_map(leaf, tree, specs)


def rank_and_size(group) -> tuple[int, int]:
    """(this rank, world size) of ``group``; (0, 1) for no group."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over the group, in place; returns ``x`` (unchanged for no
    group: never the default group)."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    """All-to-all over dim 0: ``x`` (M, ...) sends ``x[s]`` to rank s;
    ``out[r]`` is what rank r sent here."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """``_a2a`` with its gradient: the reverse all-to-all, which moves the
    same values back (a permutation keeps every bit)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-to-all over dim 0 of ``x`` (M, ...)."""
    if x.requires_grad:
        return _AllToAll.apply(x, group)
    return _a2a(x, group)
