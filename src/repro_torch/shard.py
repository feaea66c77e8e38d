"""Rank slices of a sharded state and the collectives that move them.

A sharded state is a tree whose every leaf has a spec, in a tree of the
same structure (``launch.steps.dlrm_state_specs``, ``models.lm.param_specs``,
``optim.optimizers.zero1_specs``): a ``Spec``, which names the dim the leaf
splits over each axis of the (data, model) mesh (``launch.mesh.Mesh``),
the counterpart of a JAX ``PartitionSpec``.  ``Spec()`` is a leaf every
rank holds whole.  An int (or None) in place of a ``Spec`` is a model dim
alone.  A split is even unless the spec says otherwise (the supertable's
``k_pad`` is a multiple of M, the pointer tables split only a dim M
divides, the LM's head and ff axes divide by M), so rank r of an axis of
size n holds the r-th of n equal slices; a leaf split over both axes is
cut by its model rank first.  Over the model axis a ``Spec`` may also say
how its dim is cut: ``parts`` (one weight a rank: rank r holds the r-th
piece, of ``parts[r] / sum(parts)`` of the dim; the LM's whole KV groups
where M does not divide the heads) and ``blocks`` (the dim is that many
equal blocks, each cut over the ranks, and a rank holds its piece of
every block, in block order: a projection whose output is two halves,
each read by the rank's own channels).

* ``shard_tree(tree, specs, rank, n, axis="model")`` cuts rank r's slices
  along ``axis`` out of a whole tree: a 1-device state, a checkpoint's host
  tree or the JAX package's arrays (numpy leaves stay numpy).
* ``gather_tree(tree, specs, group, dst=None, axis="model")`` puts the
  slices back together, on every rank, or on ``dst`` alone (None elsewhere).
* ``all_to_all`` is the differentiable all-to-all of the routed lookup;
  ``all_reduce_`` and ``all_gather_cat`` are the sums and gathers the
  step and the transition write by hand where GSPMD inserted them in JAX.
  Code that runs with or without a group (the transition) passes
  ``group=None`` for none: ``all_reduce_`` then returns its input, and
  ``rank_and_size`` gives (0, 1).
* ``copy_to_group`` and ``reduce_from_group`` are the conjugate pair of a
  tensor-parallel region (Megatron's f and g): the first is the identity
  forward and sums its gradient over the group, the second sums its
  input over the group and passes its gradient on unchanged.
  ``gather_last`` concatenates the ranks' slices along the last dim and
  hands each rank its slice of the gradient.  Without a group, or over a
  group of one, all three are the identity.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class Spec:
    """The dims a leaf splits over the mesh's axes: ``model`` and ``data``
    (None: held whole over that axis).  A leaf of the tree maps, not a
    node: ``tree_map`` passes it whole."""

    model: int | None = None
    data: int | None = None
    parts: tuple[int, ...] | None = None  # the model dim's cut: a weight a rank
    blocks: int = 1  # the model dim as equal blocks, each cut over the ranks


def spec_dim(spec, axis: str = "model") -> int | None:
    """The dim ``spec`` splits over ``axis``: a ``Spec``'s, or an int (a
    model dim alone)."""
    if isinstance(spec, Spec):
        return getattr(spec, axis)
    return spec if axis == "model" else None


def _cut(spec, axis: str) -> tuple[tuple[int, ...] | None, int]:
    """(parts, blocks) of ``spec``'s cut over ``axis``: the model axis's
    may be uneven or blocked, the data axis's is even."""
    if axis == "model" and isinstance(spec, Spec):
        return spec.parts, spec.blocks
    return None, 1


def _sizes(n: int, n_shards: int, parts=None) -> list[int] | None:
    """The ranks' sizes of a dim of ``n``: equal, or in proportion to
    ``parts``; None where they do not divide it."""
    weights = (1,) * n_shards if parts is None else parts
    if len(weights) != n_shards or n % sum(weights):
        return None
    return [n // sum(weights) * w for w in weights]


def shard_leaf(x, dim: int | None, rank: int, n_shards: int, parts=None, blocks: int = 1):
    """Rank ``rank``'s slice of ``x`` along ``dim`` (``x`` itself when
    ``dim`` is None), as a tensor or array of its own: the r-th of equal
    slices, or of ``parts``' pieces, of each of ``blocks`` equal blocks."""
    if dim is None or n_shards == 1 or x is None:
        return x
    n = x.shape[dim] // blocks
    sizes = _sizes(n, n_shards, parts) if n * blocks == x.shape[dim] else None
    if sizes is None:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n_shards}"
                         + (f" as {parts}" if parts else "")
                         + (f" in {blocks} blocks" if blocks > 1 else ""))
    start, size = sum(sizes[:rank]), sizes[rank]
    if isinstance(x, torch.Tensor):
        if blocks == 1:
            return x.narrow(dim, start, size).clone(memory_format=torch.contiguous_format)
        return torch.cat([x.narrow(dim, b * n + start, size) for b in range(blocks)],
                         dim=dim).contiguous()
    pieces = []
    for b in range(blocks):
        sl = [slice(None)] * np.ndim(x)
        sl[dim] = slice(b * n + start, b * n + start + size)
        pieces.append(np.asarray(x)[tuple(sl)])
    return np.ascontiguousarray(np.concatenate(pieces, axis=dim))


def shard_tree(tree: Pytree, specs: Pytree, rank: int, n_shards: int,
               axis: str = "model") -> Pytree:
    """Rank ``rank``'s part along ``axis`` of a whole ``tree`` under
    ``specs``."""
    return tree_map(lambda x, s: shard_leaf(x, spec_dim(s, axis), rank, n_shards,
                                            *_cut(s, axis)), tree, specs)


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in
    rank order, on every rank."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _join(pieces: list, dim: int, blocks: int = 1) -> torch.Tensor:
    """The ranks' slices, in rank order, put back together along ``dim``:
    concatenated, or each rank's piece of each of ``blocks`` blocks in
    place."""
    if blocks == 1:
        return torch.cat(pieces, dim=dim)
    chunks = [p.chunk(blocks, dim=dim) for p in pieces]
    return torch.cat([c[b] for b in range(blocks) for c in chunks], dim=dim)


def _gather_pieces(x: torch.Tensor, dim: int, group, dst: int | None, parts=None,
                   blocks: int = 1) -> list | None:
    """Every group rank's slice along ``dim`` (``parts``' sizes, padded to
    the largest for the collective), on every rank, or on ``dst`` alone
    (None elsewhere)."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    sizes = None
    if parts is not None:
        unit = x.shape[dim] // (blocks * parts[rank])
        sizes = [blocks * unit * w for w in parts]
        if max(sizes) > x.shape[dim]:
            pad = list(x.shape)
            pad[dim] = max(sizes) - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    bufs = [torch.empty_like(x) for _ in range(n)] if dst is None or rank == dst else None
    if dst is None:
        dist.all_gather(bufs, x, group=group)
    else:
        dist.gather(x, bufs, dst=dist.get_global_rank(group, dst), group=group)
    if bufs is None:
        return None
    return bufs if sizes is None else [b.narrow(dim, 0, k) for b, k in zip(bufs, sizes)]


def gather_tree(tree: Pytree, specs: Pytree, group, dst: int | None = None,
                axis: str = "model") -> Pytree:
    """The whole tree along ``axis`` from the slices of ``group``'s ranks
    (``shard_tree``'s inverse, uneven and blocked cuts included): on every
    rank when ``dst`` is None, else on group rank ``dst`` (the other ranks
    get None at every split leaf and their own whole leaves)."""
    if dist.get_world_size(group) == 1:
        return tree

    def leaf(x, s):
        d = spec_dim(s, axis)
        if d is None or not isinstance(x, torch.Tensor):
            return x
        parts, blocks = _cut(s, axis)
        pieces = _gather_pieces(x, d, group, dst, parts, blocks)
        return None if pieces is None else _join(pieces, d, blocks)

    return tree_map(leaf, tree, specs)


def rank_and_size(group) -> tuple[int, int]:
    """(this rank, world size) of ``group``; (0, 1) for no group."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def group_size(group) -> int:
    """The size of ``group``; 1 for no group."""
    return 1 if group is None else dist.get_world_size(group)


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


# --- the tensor-parallel region (models/lm.py over a model group) ------------


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """The input summed over the group; the gradient passed on."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """The ranks' slices concatenated along the last dim in rank order;
    the gradient's slice of this rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return all_gather_cat(x, x.dim() - 1, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g[..., r * ctx.n:(r + 1) * ctx.n], None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a tensor-parallel region: ``x`` forward, its gradient summed
    over ``group`` backward (each rank's part of the region adds its share)."""
    if group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group) if torch.is_grad_enabled() else x


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Leave a tensor-parallel region: the ranks' partial sums ``x`` added
    over ``group``; the gradient reaches every rank whole."""
    if group_size(group) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromGroup.apply(x, group)
    return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along the last dim in
    rank order; backward, each rank keeps its slice of the gradient."""
    if group_size(group) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherLast.apply(x, group)
    return all_gather_cat(x, x.dim() - 1, group)
