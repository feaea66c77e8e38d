"""The (data, model) mesh and the canonical axis names: the port of the
JAX package's ``launch/mesh.py``.

The JAX package shards over a device mesh; the port runs one process per
rank over ``torch.distributed``.  ``Mesh(data, model)`` is the counterpart
of ``make_host_mesh(data, model)``: world rank r sits at ``(r // model, r %
model)``, the row-major order of ``jax.make_mesh``, and holds the model
group of its data index (the ranks that split the model), the data group
of its model index (the replicas of its slices) and the world.
``MODEL_AXIS`` splits DLRM's supertables (rank m of M owns codebook rows
``[m*k_loc, (m+1)*k_loc)``) and the LM's heads, ff and embedding columns;
``DATA_AXIS`` splits the batch, and the LM's optimizer moments (ZeRO-1).
``batch_axes``, ``all_batch_axes`` and ``model_axis`` read a mesh as the
JAX package's do.

``ptr_partition_spec`` is the one definition of the pointer tables'
at-rest layout; ``init_model_group`` makes the process group (NCCL on the
card, gloo on the CPU) and never falls back from one to the other;
``init_mesh`` joins it and builds the mesh's subgroups.
"""
from __future__ import annotations

import os

DATA_AXIS = "data"
MODEL_AXIS = "model"


def ptr_partition_spec(c: int, d1: int, n_shards: int) -> int | None:
    """At-rest layout of a (c, d1) CCE pointer table over ``n_shards``
    ranks: the dim it splits, or None when every rank holds all of it.

    Ids (dim 1) when the vocabulary divides (the transition's compute
    layout, no reshard); columns (dim 0) when only c divides (ragged
    vocabularies: Criteo's 10,131,227 is odd), which costs one
    all-to-all each way at a transition; replicated when nothing
    divides.  The JAX package's policy, as a dim instead of a
    ``PartitionSpec``."""
    if n_shards <= 1:
        return None
    if d1 % n_shards == 0:
        return 1
    if c % n_shards == 0:
        return 0
    return None


class Mesh:
    """A (data, model) mesh over the world of ``torch.distributed``, built
    on every rank (``new_group`` is collective: every rank makes every
    subgroup, in one order).  ``model``/``data`` are this rank's groups,
    ``world`` the whole; ``coords`` its (data, model) index and ``shape``
    the axis sizes.  A world of one is the (1, 1) mesh, whose collectives
    are all identities."""

    def __init__(self, data: int, model: int):
        import torch.distributed as dist

        world = dist.group.WORLD
        n = dist.get_world_size(world)
        if data * model != n:
            raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks, "
                             f"the world has {n}")
        rank = dist.get_rank(world)
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.coords = (rank // model, rank % model)
        self.world = world
        model_groups = [_subgroup([d * model + m for m in range(model)], world)
                        for d in range(data)]
        data_groups = [_subgroup([d * model + m for d in range(data)], world)
                       for m in range(model)]
        self.model = model_groups[self.coords[0]]
        self.data = data_groups[self.coords[1]]

    @property
    def axis_names(self) -> tuple[str, str]:
        return (DATA_AXIS, MODEL_AXIS)

    @property
    def rank(self) -> int:
        """World rank: ``data_index * model + model_index``."""
        return self.coords[0] * self.shape[MODEL_AXIS] + self.coords[1]

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]


def _subgroup(ranks: list[int], world):
    """The group of ``ranks``: the world itself when they are all of it."""
    import torch.distributed as dist

    if len(ranks) == dist.get_world_size(world):
        return world
    return dist.new_group(ranks)


def batch_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes: the model axis is left out (the LM's batch
    is replicated over it)."""
    return tuple(a for a in (DATA_AXIS,) if a in mesh.axis_names)


def all_batch_axes(mesh) -> tuple[str, ...]:
    """Batch axes over EVERY rank (DLRM's sharded step: each rank runs the
    MLPs on a distinct slice while the supertable is model-sharded)."""
    axes = batch_axes(mesh)
    if model_axis(mesh) is not None:
        axes = axes + (MODEL_AXIS,)
    return axes


def model_axis(mesh) -> str | None:
    """The model axis, or None when the mesh has no nontrivial one."""
    if MODEL_AXIS in mesh.axis_names and mesh.shape.get(MODEL_AXIS, 1) > 1:
        return MODEL_AXIS
    return None


def init_mesh(data: int, model: int, device: str = "cuda", **kw) -> Mesh:
    """Join the world (``init_model_group``, ``kw`` passed on: world size,
    rank, store) and build the (data, model) mesh over it."""
    kw.setdefault("world_size", data * model)
    init_model_group(device, **kw)
    return Mesh(data, model)


def init_model_group(device: str = "cuda", *, world_size: int | None = None,
                     rank: int | None = None, store=None, init_method: str | None = None):
    """Join the model-parallel process group; returns
    ``torch.distributed.group.WORLD``.

    NCCL for ``device="cuda"`` (each rank on ``cuda:LOCAL_RANK``), gloo for
    ``device="cpu"``.  ``world_size`` and ``rank`` default to what
    ``torchrun`` puts in the environment (``WORLD_SIZE``, ``RANK``);
    ``store`` (a ``torch.distributed.FileStore``, as tests pass) or
    ``init_method`` (``file://...``) replace its rendezvous.  Raises when
    ``device="cuda"`` and the world is larger than the visible cards: one
    rank a card, and no fallback to gloo or the CPU."""
    import torch
    import torch.distributed as dist

    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if device == "cuda":
        n_cards = torch.cuda.device_count()
        if world_size > n_cards:
            raise RuntimeError(
                f"{world_size} ranks need {world_size} CUDA devices, "
                f"this machine has {n_cards}")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"model shards run on 'cuda' or 'cpu', not {device!r}")
    kw = {}
    if store is not None:
        kw["store"] = store
    elif init_method is not None:
        kw["init_method"] = init_method
    elif "MASTER_ADDR" not in os.environ:
        raise RuntimeError("no rendezvous: run under torchrun, or pass store= or init_method=")
    dist.init_process_group(backend, world_size=world_size, rank=rank, **kw)
    return dist.group.WORLD

