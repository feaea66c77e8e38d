"""The model-parallel group and the canonical axis names: the port of the
JAX package's ``launch/mesh.py``.

The JAX package shards over a device mesh; the port runs one process per
rank over ``torch.distributed``.  ``MODEL_AXIS`` is the supertable's shard
axis: rank r of M owns codebook rows ``[r*k_loc, (r+1)*k_loc)`` of every
universal supertable, and the batch is split over the same ranks.
``DATA_AXIS`` names the second axis of JAX's 2-D (data, model) mesh, which
the port does not run yet (``--data-shards``, ROADMAP).

``ptr_partition_spec`` is the one definition of the pointer tables'
at-rest layout; ``init_model_group`` makes the process group (NCCL on the
card, gloo on the CPU) and never falls back from one to the other.
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
                f"{world_size} model shards need {world_size} CUDA devices, "
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

