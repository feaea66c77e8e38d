"""The clustering transition: the port of the JAX package's
``train/transition.py``.

``transition_table`` is one CCE table's transition: derive a sampling seed
from the transition key, build the k-means point set from observed id
frequencies when a histogram exists (count-weighted: every observed id
once, weighted by frequency), cluster, and build the moment-update
function that ``remap_opt_state`` applies to each optimizer slot.

``transition_collection`` runs it across an ``EmbeddingCollection``:
per-feature slices come out of the grouped supertables, transition with
``fold_in(key, feature_index)`` and re-stack, so the trainer keeps one
stacked slab per group.  Keys are ``repro_torch.random`` keys, scheduled
as in the JAX package, so ``hs`` and ``epoch`` match it bit for bit.

With ``group`` (a ``torch.distributed`` process group) every O(d1) phase
runs sharded over its ranks (``CCE.cluster`` / ``remap_moments`` with
``group=``), each CCE buffer's ``ptr`` this rank's id tile (the compute
layout).  ``ptr_to_tile`` / ``ptr_from_tile`` reshard a
pointer table between its at-rest layout (``launch.mesh.ptr_partition_spec``)
and that tile: the all-to-all GSPMD inserted in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import random as jr
from repro_torch.core.cce import CCE
from repro_torch.optim.remap import collection_moment_updater, zeros_like_moments
from repro_torch.stream.points import points_from_counts


def _draw_points(counts, n: int, seed: int):
    """(ids, weights) from a per-feature count source: a DENSE histogram
    array, or a sketch provider (``stream.sketch.FeatureSketch``) with
    ``points(n, seed)``: exact head + unbiased tail at vocab-independent
    tracker memory."""
    if hasattr(counts, "points"):
        return counts.points(n, seed)
    return points_from_counts(counts, n, seed)


def _dense_weights(counts, d1: int) -> np.ndarray:
    """Per-id weights for the count-weighted moment remap: a dense
    histogram verbatim; a sketch provider streams an O(d1) transient
    estimate on the host (``FeatureSketch.id_weights``)."""
    if hasattr(counts, "id_weights"):
        return counts.id_weights(d1)
    return np.asarray(counts)


def transition_table(table, key, params, buffers, *, counts=None, policy: str = "remap",
                     chunk_size: int | None = None, use_kernel: bool | None = None,
                     max_points_per_centroid: int = 256, group=None):
    """Returns ``(new_params, new_buffers, update_moments)`` for one CCE
    table.  ``counts`` is the table's observed id histogram: a dense (d1,)
    array or a sketch provider with ``points``/``id_weights``.  When it
    holds any count the k-means runs count-weighted on the observed ids
    and the moment remap averages with the same weights.  None or all-zero falls back to uniform subsampling.
    ``update_moments(moment_subtree)`` remaps / resets / keeps that
    table's per-row optimizer moments per ``policy``.  ``group`` runs the
    sharded transition (``buffers["ptr"]`` this rank's id tile); on one
    rank it equals the serial one bit for bit."""
    device = params["tables"].device
    sample_ids = sample_weights = id_weights = None
    if counts is not None:
        seed = int(jr.randint(jr.fold_in(key, 10_007), (), 0, 2**31 - 1))
        drawn = _draw_points(counts, min(table.d1, max_points_per_centroid * table.k), seed)
        if drawn is not None:
            sample_ids = torch.from_numpy(np.asarray(drawn[0], np.int64)).to(device)
            sample_weights = torch.from_numpy(drawn[1].astype(np.float32)).to(device)
            id_weights = torch.from_numpy(
                np.asarray(_dense_weights(counts, table.d1), np.float32)).to(device)
    new_params, new_buffers = table.cluster(
        key, params, buffers, group=group, sample_ids=sample_ids, sample_weights=sample_weights,
        chunk_size=chunk_size, use_kernel=use_kernel,
        max_points_per_centroid=max_points_per_centroid)

    def update_moments(moments):
        if policy == "keep":
            return moments
        if policy == "reset":
            return zeros_like_moments(moments)
        return table.remap_moments(moments, buffers, new_buffers, group=group,
                                   chunk_size=chunk_size, id_weights=id_weights)

    return new_params, new_buffers, update_moments


def transition_collection(coll, key, emb_params, emb_buffers, *, id_counts=None,
                          policy: str = "remap", chunk_size: int | None = None,
                          use_kernel: bool | None = None,
                          max_points_per_centroid: int = 256, group=None):
    """Transition every CCE table behind an ``EmbeddingCollection``.

    ``emb_params``/``emb_buffers`` are the grouped layout; each CCE
    feature's (c, 2, k, dsub) block is sliced out of its group,
    transitioned with ``fold_in(key, feature_index)`` and re-stacked; a
    group's non-CCE members pass through untouched.  Returns
    ``(new_params, new_buffers, update_emb)`` where ``update_emb``
    transforms a grouped moments["emb"] list.  ``id_counts`` indexes
    per-feature histograms by global feature index.  ``group``: the
    sharded transition of every table (whole slabs, ptr id tiles)."""
    new_p, new_b = list(emb_params), list(emb_buffers)
    group_updates: dict[int, dict[int, object]] = {}
    for g, grp in enumerate(coll.groups):
        cce_locals = [f_local for f_local, t in enumerate(grp.tables) if isinstance(t, CCE)]
        if not cce_locals:
            continue
        per_p = coll.unstack_group_params(grp, emb_params[g])
        per_b = list(emb_buffers[g])
        fns = {}
        for f_local in cce_locals:
            i = grp.features[f_local]
            per_p[f_local], per_b[f_local], fns[f_local] = transition_table(
                grp.tables[f_local], jr.fold_in(key, i), per_p[f_local], per_b[f_local],
                counts=id_counts[i] if id_counts is not None else None,
                policy=policy, chunk_size=chunk_size, use_kernel=use_kernel,
                max_points_per_centroid=max_points_per_centroid, group=group,
            )
        new_p[g] = coll.stack_group_params(grp, per_p)
        new_b[g] = per_b
        group_updates[g] = fns
    return new_p, new_b, collection_moment_updater(coll, group_updates)


def ptr_to_tile(table: CCE, ptr: torch.Tensor, dim: int | None, group) -> torch.Tensor:
    """This rank's (c, d1_loc) compute tile of a pointer table held in
    its at-rest layout ``dim`` (``ptr_partition_spec``): an id slice is
    the tile itself; a column slice (c/M, d1) goes through one
    all-to-all (rank r sends each rank s its columns' ids of s's range);
    a whole table is cut locally."""
    from repro_torch.shard import all_to_all

    rank, M = dist.get_rank(group), dist.get_world_size(group)
    if dim == 1:
        return ptr
    if dim is None:
        return table.ptr_tile(ptr, rank, M)
    n = table.d1_loc(M)
    cols = ptr.shape[0]
    blocks = table._ptr_padded(ptr, n * M).reshape(cols, M, n).transpose(0, 1)
    return all_to_all(blocks, group).reshape(M * cols, n)  # (c, d1_loc)


def ptr_from_tile(table: CCE, tile: torch.Tensor, dim: int | None, group) -> torch.Tensor:
    """Inverse of ``ptr_to_tile``: the at-rest layout ``dim`` of the
    pointer table whose compute tiles the ranks hold."""
    from repro_torch.shard import all_gather_cat, all_to_all

    M = dist.get_world_size(group)
    if dim == 1:
        return tile
    if dim is None:
        return all_gather_cat(tile, 1, group)[:, : table.d1].contiguous()
    n = tile.shape[1]
    back = all_to_all(tile.reshape(M, -1, n), group)  # [s]: my columns over s's ids
    return back.transpose(0, 1).reshape(-1, M * n)[:, : table.d1].contiguous()
