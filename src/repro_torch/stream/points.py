"""K-means point sets from frequency statistics: a numpy copy of the JAX
package's ``stream/points.py`` (which the port cannot import: its package
imports JAX).

The transition's k-means wants (unique ids, frequency weights), the
paper's epoch-boundary sample in its zero-variance weighted form.
``points_from_counts`` builds it from a DENSE histogram through
``stratified_points``: when the candidate set exceeds the FAISS-style
cap, the n/2 highest-count ids enter deterministically with their exact
counts and the tail is sampled uniformly without replacement with counts
inflated by the inverse sampling fraction (Horvitz-Thompson), which keeps
the estimator unbiased for the weighted k-means objective.
"""
from __future__ import annotations

import numpy as np


def sample_from_counts(counts: np.ndarray, n: int, seed: int) -> np.ndarray | None:
    """Draw ``n`` ids ~ ``counts`` (with replacement: duplicates are the
    frequency weighting).  None when nothing has been counted yet.  Counts
    may be float (decayed histograms)."""
    counts = np.asarray(counts)
    total = float(counts.sum())
    if total <= 0.0:
        return None
    rng = np.random.default_rng(seed)
    return rng.choice(counts.shape[0], size=n, replace=True, p=counts / total)


def stratified_points(
    ids: np.ndarray, counts: np.ndarray, n: int, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """Cap a sparse (ids, counts) candidate set at ``n`` points, unbiased.

    ``ids``/``counts`` are parallel arrays of observed ids with strictly
    positive (float) counts.  At or under the cap: every candidate with
    its exact count.  Over the cap: deterministic top-``n//2`` head plus
    a uniform without-replacement tail draw, Horvitz-Thompson-inflated by
    ``|rest| / n_tail`` so the tail's expected weight mass is preserved.
    Returns (ids, weights-float32) sorted by id."""
    ids = np.asarray(ids)
    counts = np.asarray(counts)
    if ids.size <= n:
        order = np.argsort(ids, kind="stable")
        return ids[order], counts[order].astype(np.float32)
    n_head = n // 2
    order = np.argsort(counts, kind="stable")[::-1]
    head = ids[order[:n_head]]
    head_w = counts[order[:n_head]]
    rest = ids[order[n_head:]]
    rest_w = counts[order[n_head:]]
    rng = np.random.default_rng(seed)
    n_tail = n - n_head
    pick = rng.choice(rest.size, size=n_tail, replace=False)
    w = np.concatenate(
        [head_w, rest_w[pick] * (rest.size / n_tail)]
    ).astype(np.float32)
    out = np.concatenate([head, rest[pick]])
    order = np.argsort(out, kind="stable")
    return out[order], w[order]


def points_from_counts(
    counts: np.ndarray, n: int, seed: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """(ids, weights) for COUNT-WEIGHTED k-means from a DENSE histogram:
    every observed id exactly once, weighted by its observed frequency.
    None when nothing has been counted yet (uniform fallback).  Counts
    may be float — exponential decay scales every weight by the same
    factor, which leaves the weighted k-means objective (and the HT
    subsampling) invariant."""
    counts = np.asarray(counts)
    nz = np.flatnonzero(counts > 0)
    if nz.size == 0:
        return None
    return stratified_points(nz, counts[nz], n, seed)
