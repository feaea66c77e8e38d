"""The clustering transition, single-device: the port of the JAX package's
``train/transition.py`` (its unsharded paths).

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
"""
from __future__ import annotations

import numpy as np
import torch

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
                     max_points_per_centroid: int = 256):
    """Returns ``(new_params, new_buffers, update_moments)`` for one CCE
    table.  ``counts`` is the table's observed id histogram: a dense (d1,)
    array or a sketch provider with ``points``/``id_weights``.  When it
    holds any count the k-means runs count-weighted on the observed ids
    and the moment remap averages with the same weights.  None or all-zero falls back to uniform subsampling.
    ``update_moments(moment_subtree)`` remaps / resets / keeps that
    table's per-row optimizer moments per ``policy``."""
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
        key, params, buffers, sample_ids=sample_ids, sample_weights=sample_weights,
        chunk_size=chunk_size, use_kernel=use_kernel,
        max_points_per_centroid=max_points_per_centroid,
    )
    cluster_counts = table.assignment_counts(new_buffers) if policy == "remap" else None

    def update_moments(moments):
        if policy == "keep":
            return moments
        if policy == "reset":
            return zeros_like_moments(moments)
        return table.remap_moments(moments, buffers, new_buffers, chunk_size=chunk_size,
                                   counts=cluster_counts, id_weights=id_weights)

    return new_params, new_buffers, update_moments


def transition_collection(coll, key, emb_params, emb_buffers, *, id_counts=None,
                          policy: str = "remap", chunk_size: int | None = None,
                          use_kernel: bool | None = None,
                          max_points_per_centroid: int = 256):
    """Transition every CCE table behind an ``EmbeddingCollection``.

    ``emb_params``/``emb_buffers`` are the grouped layout; each CCE
    feature's (c, 2, k, dsub) block is sliced out of its group,
    transitioned with ``fold_in(key, feature_index)`` and re-stacked; a
    group's non-CCE members pass through untouched.  Returns
    ``(new_params, new_buffers, update_emb)`` where ``update_emb``
    transforms a grouped moments["emb"] list.  ``id_counts`` indexes
    per-feature histograms by global feature index."""
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
                max_points_per_centroid=max_points_per_centroid,
            )
        new_p[g] = coll.stack_group_params(grp, per_p)
        new_b[g] = per_b
        group_updates[g] = fns
    return new_p, new_b, collection_moment_updater(coll, group_updates)
