"""Entropy/drift-triggered clustering — the adaptive transition schedule
(a numpy copy of the JAX package's ``stream/trigger.py``).

A fixed ``cluster_every`` re-clusters on a wall-clock-ish cadence that
has nothing to do with what the stream is doing: it fires when nothing
changed (wasted full-vocab passes, churned optimizer moments) and sleeps
through a distribution shift (the k-means sample goes stale exactly when
re-clustering would pay).  ``ClusterTrigger`` replaces the fixed cadence
with two signals computed from the sketch tracker's window statistics:

  * **entropy collapse** — the observed-entropy estimate dropping by
    ``entropy_drop`` (relative) below the highest entropy seen since the
    last firing.  Concentration rising means the head ids now carry more
    of the mass than the centroids were fit for.  The reference ratchets
    UP with the stream and resets to the current entropy on firing, so a
    collapse fires exactly ONCE — staying low never re-fires; only a
    fresh collapse from a recovered reference does.
  * **drift** — mean total-variation distance between consecutive
    windows' head distributions.  A shifted head with unchanged entropy
    (new ids replacing old at similar frequencies) is invisible to the
    entropy signal but exactly the case where the old centroids and the
    old k-means sample are both wrong.

All trigger state is fixed-shape (scalars + padded head snapshots) so it
rides checkpoints and resume replays the schedule exactly — the
transition schedule is training state, not host-process state, same as
``clusters_done``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TriggerEvent:
    """One trigger evaluation (one closed window)."""

    step: int
    entropy: float
    drift: float
    fire: bool
    reason: str = ""  # "entropy-collapse" | "drift" | ""

    def as_dict(self) -> dict:
        """Plain-python fields for the run log's ``trigger`` event
        (numpy scalars coerced so the record is json-clean)."""
        return {
            "step": int(self.step),
            "entropy": float(self.entropy),
            "drift": float(self.drift),
            "fire": bool(self.fire),
            "reason": self.reason,
        }


def _tv_distance(prev_ids, prev_p, ids, p) -> float:
    """Total-variation distance between two truncated head distributions
    (mass outside both heads is not comparable and is ignored)."""
    union = np.union1d(prev_ids[prev_ids >= 0], ids[ids >= 0])
    if union.size == 0:
        return 0.0

    def dense(u_ids, u_p):
        out = np.zeros(union.size)
        keep = u_ids >= 0
        out[np.searchsorted(union, u_ids[keep])] = u_p[keep]
        return out

    return 0.5 * float(np.abs(dense(prev_ids, prev_p) - dense(ids, p)).sum())


def head_churn(prev_ids, ids) -> float:
    """Jaccard distance between two head id SETS (order/count agnostic,
    negatives = empty slots ignored).  0.0 = identical membership,
    1.0 = disjoint.  The serve cache refresh policy (serve/dlrm.py)
    compares its cached head against a fresh tracker export with this —
    membership is what decides cache coverage, so it is the right churn
    signal there (the trigger's ``_tv_distance`` weighs probability
    mass instead)."""
    prev_ids = np.unique(np.asarray(prev_ids)[np.asarray(prev_ids) >= 0])
    ids = np.unique(np.asarray(ids)[np.asarray(ids) >= 0])
    union = np.union1d(prev_ids, ids)
    if union.size == 0:
        return 0.0
    inter = np.intersect1d(prev_ids, ids)
    return 1.0 - inter.size / union.size


class ClusterTrigger:
    """Stateful trigger policy over the tracker's window summaries.

    ``update(stats, step)`` consumes one closed-window summary (the dict
    ``SketchFrequencyTracker.poll_window`` returns) and decides whether
    the transition fires this window.  ``warmup`` windows establish the
    entropy reference before anything may fire; ``min_windows_between``
    spaces firings.  An empty window (no mass → stats None) is a no-op:
    callers simply don't call update, or pass None and get a non-firing
    event.
    """

    def __init__(
        self,
        *,
        entropy_drop: float = 0.15,
        drift_threshold: float = 0.35,
        warmup: int = 2,
        min_windows_between: int = 1,
        head_cap: int = 256,
    ):
        self.entropy_drop = entropy_drop
        self.drift_threshold = drift_threshold
        self.warmup = warmup
        self.min_windows_between = min_windows_between
        self.head_cap = head_cap
        self.windows = 0
        self.windows_since_fire = np.inf
        self.fired = 0
        self.peak_entropy = 0.0
        # previous-window head snapshot, fixed (n_heads, cap) for checkpoints
        self._prev_ids: np.ndarray | None = None
        self._prev_p: np.ndarray | None = None
        self.events: list[TriggerEvent] = []  # observability, not state

    # --- the decision -----------------------------------------------------

    def _pad_heads(self, heads):
        n = len(heads)
        ids = np.full((n, self.head_cap), -1, np.int64)
        p = np.zeros((n, self.head_cap))
        for j, h in enumerate(heads):
            if h is None:
                continue
            hi, hp = h
            k = min(len(hi), self.head_cap)
            ids[j, :k] = hi[:k]
            p[j, :k] = hp[:k]
        return ids, p

    def update(self, stats: dict | None, step: int,
               *, can_fire: bool = True) -> TriggerEvent:
        """``can_fire=False`` evaluates the window (reference/drift
        baselines advance as usual) but suppresses firing — the caller's
        transition is unavailable (no cluster_fn, or cluster_max
        exhausted), and committing fire-state for a transition that never
        runs would reset the entropy reference against nothing."""
        if stats is None:  # empty window: nothing observed, nothing to do
            ev = TriggerEvent(step, float("nan"), 0.0, False, "")
            self.events.append(ev)
            return ev
        self.windows += 1
        self.windows_since_fire += 1
        ent = float(stats["entropy"])
        ids, p = self._pad_heads(stats["heads"])
        drift = 0.0
        if (
            self._prev_ids is not None
            and self._prev_ids.shape[0] != ids.shape[0]
        ):
            # tracked-feature count changed under us (config change across
            # a restore — the wildcard restore template deliberately
            # accepts any stored row count): feature-wise TV would pair
            # mismatched features, so treat this window as having no
            # baseline
            self._prev_ids = self._prev_p = None
        if self._prev_ids is not None:
            per = [
                _tv_distance(self._prev_ids[j], self._prev_p[j], ids[j], p[j])
                for j in range(ids.shape[0])
            ]
            drift = float(np.mean(per)) if per else 0.0
        self._prev_ids, self._prev_p = ids, p

        fire, reason = False, ""
        armed = (
            can_fire
            and self.windows > self.warmup
            and self.windows_since_fire >= self.min_windows_between
        )
        # strict: a stream that STARTS concentrated (single-id: entropy 0
        # from the first window) never "collapses" — the reference must
        # have been meaningfully higher first
        if armed and self.peak_entropy > 0.0 and ent < self.peak_entropy * (
            1.0 - self.entropy_drop
        ):
            fire, reason = True, "entropy-collapse"
        elif armed and drift >= self.drift_threshold:
            fire, reason = True, "drift"
        if fire:
            self.fired += 1
            self.windows_since_fire = 0
            self.peak_entropy = ent  # re-arm only on a FRESH collapse
        else:
            self.peak_entropy = max(self.peak_entropy, ent)
        ev = TriggerEvent(step, ent, drift, fire, reason)
        self.events.append(ev)
        return ev

    # --- checkpoint integration -------------------------------------------

    def state_template(self) -> list[np.ndarray]:
        """Restore-template form of the state, FRESH-valued: the
        previous-head snapshot leaves are (0, head_cap) — zero-size
        WILDCARDS to the checkpoint layout matcher — because their stored
        row count depends on how many windows had closed when the writer
        saved (a template built from the live ``state_tree`` would
        hard-require the live shape and reject a pre-first-window
        checkpoint).  The scalars are a fresh trigger's, not the live
        one's: when a sectioned checkpoint has NO trigger section, the
        template value IS what gets restored, and a deterministic fresh
        start beats a stale live-state mix."""
        return [
            np.int64(0),
            np.float64(-1.0),  # windows_since_fire: inf sentinel
            np.int64(0),
            np.float64(0.0),
            np.full((0, self.head_cap), -1, np.int64),
            np.zeros((0, self.head_cap)),
        ]

    def state_tree(self) -> list[np.ndarray]:
        if self._prev_ids is None:
            prev_ids = np.full((0, self.head_cap), -1, np.int64)
            prev_p = np.zeros((0, self.head_cap))
        else:
            prev_ids, prev_p = self._prev_ids, self._prev_p
        return [
            np.int64(self.windows),
            np.float64(
                -1.0 if np.isinf(self.windows_since_fire)
                else self.windows_since_fire
            ),
            np.int64(self.fired),
            np.float64(self.peak_entropy),
            prev_ids.copy(),
            prev_p.copy(),
        ]

    def load_state_tree(self, tree) -> None:
        tree = list(tree)
        self.windows = int(tree[0])
        wsf = float(tree[1])
        self.windows_since_fire = np.inf if wsf < 0 else wsf
        self.fired = int(tree[2])
        self.peak_entropy = float(tree[3])
        prev_ids = np.asarray(tree[4], np.int64)
        if prev_ids.shape[0] == 0:
            self._prev_ids = self._prev_p = None
        else:
            self._prev_ids = prev_ids.copy()
            self._prev_p = np.asarray(tree[5], np.float64).copy()
