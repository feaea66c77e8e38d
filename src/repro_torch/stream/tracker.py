"""`SketchFrequencyTracker` — the drop-in, vocab-independent replacement
for the dense ``IdFrequencyTracker`` (the port of the JAX package's
``stream/tracker.py``; the host state and its checkpoint leaves are the
same numpy arrays).

Same Trainer surface (``observe`` / ``state_tree`` / ``load_state_tree``
/ a ``counts`` view the cluster callbacks index per feature), but each
tracked feature's state is a ``FeatureSketch`` (count-min + SpaceSaving
head + recent-id ring — O(width·depth + heavy + ring) memory regardless
of vocabulary), the ``counts`` entries are the sketches themselves
(``train/transition.py`` duck-types providers against dense arrays), and
three streaming behaviours the dense tracker never had:

  * windowing/decay — every ``window`` observed batches the tracker
    multiplies all counters by ``decay`` and snapshots window statistics
    (entropy estimate + head distributions), so the histogram tracks the
    RECENT stream and the trigger policy can see shift;
  * async updates — the per-batch sketch increment is a cell count on the
    device (``stream/device.py``: in the train step when it carries
    ``sketch_fn``, else the tracker's own counter on ``device``), copied
    to the host without a sync and folded into the host sketch on a
    background thread with ``async_fold``: the train step never waits on
    tracking;
  * tracked-feature selection — only features that actually transition
    (the collection's CCE groups) carry sketches; the rest report None
    and the transition's uniform fallback applies (they never cluster
    anyway).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.convert import HostCopy
from repro_torch.stream.points import sample_from_counts
from repro_torch.stream.sketch import FeatureSketch


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Sketch-tracker shape + streaming semantics (per feature)."""

    width: int = 1 << 12   # CMS cells per hash row (power of two)
    depth: int = 4         # hash rows
    heavy: int = 256       # SpaceSaving head capacity
    ring: int = 4096       # recent-id ring (tail candidates / tail support)
    decay: float = 1.0     # per-window counter multiplier (1 = never forget)
    window: int = 0        # batches per window; 0 = no windowing
    async_fold: bool = False  # device cell count + background host fold
    seed: int = 0


class IdFrequencyTracker:
    """Per-feature DENSE id histograms from the training stream — the
    exact reference the sketch tracker approximates (one int64 per vocab
    row; fine for small vocabs and for tests, defeats CCE's memory point
    at production vocab sizes)."""

    def __init__(self, vocab_sizes: Sequence[int], key: str = "sparse"):
        self.key = key
        self.counts = [np.zeros(v, np.int64) for v in vocab_sizes]

    def observe(self, batch: dict) -> None:
        """Accumulate one (un-reshaped) batch: ``batch[self.key]`` is
        (B, n_features) int.  Runs on the training hot path, so the
        update is O(batch) — never O(vocab) (a full-vocab bincount per
        step would dwarf the step itself on 100M-row tables)."""
        sparse = np.asarray(batch[self.key]).reshape(-1, len(self.counts))
        for f, c in enumerate(self.counts):
            np.add.at(c, sparse[:, f], 1)

    def sample_ids(self, seed: int, feature: int, n: int) -> np.ndarray | None:
        """Draw ``n`` ids ~ the observed frequency of ``feature``."""
        return sample_from_counts(self.counts[feature], n, seed)

    # --- checkpoint integration (host state must resume too) ---------------

    def state_tree(self) -> list[np.ndarray]:
        return [c.copy() for c in self.counts]

    def state_template(self) -> list[np.ndarray]:
        """Restore-template form: FRESH (zero) histograms.  When a
        sectioned checkpoint has no ``id_counts`` section, the template
        value IS what gets restored — a deterministic empty tracker, not
        whatever the live tracker happened to hold at restore time."""
        return [np.zeros_like(c) for c in self.counts]

    def load_state_tree(self, tree: Sequence[np.ndarray]) -> None:
        self.counts = [np.asarray(c).astype(np.int64).copy() for c in tree]

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.counts)


class SketchFrequencyTracker:
    """Sketch-backed per-feature frequency tracking with decay/windowing."""

    def __init__(
        self,
        vocab_sizes: Sequence[int],
        config: StreamConfig = StreamConfig(),
        *,
        tracked: Sequence[int] | None = None,
        key: str = "sparse",
        device="cuda",
    ):
        """``device`` is where the tracker's own cell counter runs (the
        async path when ``observe`` gets no delta from the step)."""
        self.key = key
        self.config = config
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        n = len(self.vocab_sizes)
        self.tracked = tuple(sorted(tracked)) if tracked is not None else tuple(range(n))
        self.features: list[FeatureSketch | None] = [None] * n
        for f in self.tracked:
            self.features[f] = FeatureSketch(
                config.width, config.depth, config.heavy, config.ring,
                seed=config.seed * 1_000_003 + f,
            )
        self.batches_seen = 0
        self._pending_summary: dict | None = None
        self._folder = None
        self._cell_counter = None
        if config.async_fold and self.tracked:  # nothing tracked: no-op tracker
            from repro_torch.stream.device import AsyncFolder, make_cell_counter

            self._cell_counter = make_cell_counter(
                [self.features[f].cms for f in self.tracked], device
            )
            self._folder = AsyncFolder(self._fold)

    # --- updates ----------------------------------------------------------

    @property
    def counts(self) -> list:
        """Per-feature count providers, indexed by GLOBAL feature index —
        the sketches themselves (``.points`` / ``.id_weights`` duck-typed
        by the transition), None for untracked features (uniform
        fallback; those tables never transition)."""
        return list(self.features)

    def observe(self, batch: dict, *, delta=None) -> None:
        """Accumulate one (un-reshaped) batch.

        ``delta`` — an (F_tracked, depth, width) cell-increment tensor the
        TRAIN STEP already computed (``stream.device.make_step_cell_counter``
        passed as ``make_train_step(sketch_fn=)``): the sketch update then
        costs no extra launch; only the O(unique-ids) head/ring bookkeeping
        runs on host (off-thread with ``async_fold``, synchronously
        otherwise — same FIFO per-batch fold either way, so flushed state
        stays a pure function of the batch sequence and restart-exactness
        is preserved).  A delta on the card is copied to pinned host memory
        without a sync; the fold waits for that copy alone."""
        sparse = np.asarray(batch[self.key]).reshape(-1, len(self.features))
        if delta is not None and self.tracked:
            cols = np.ascontiguousarray(sparse[:, list(self.tracked)])
            item = (HostCopy(delta), cols)
            if self._folder is not None:
                self._folder.submit(item)
            else:
                self._fold(item)
        elif self._folder is not None:
            cols = np.ascontiguousarray(sparse[:, list(self.tracked)])
            self._folder.submit((HostCopy(self._cell_counter(cols)), cols))
        else:
            for f in self.tracked:
                self.features[f].observe(sparse[:, f])
        self.batches_seen += 1
        w = self.config.window
        if w and self.batches_seen % w == 0:
            self._close_window()

    def _fold(self, item) -> None:
        delta, cols = item
        delta = delta.get()  # blocks the FOLD thread, not the step
        for j, f in enumerate(self.tracked):
            self.features[f].fold_cells(delta[j], cols[:, j])

    def _close_window(self) -> None:
        """Window boundary: snapshot trigger statistics, then decay."""
        self.flush()
        self._pending_summary = self._summarize()
        if self.config.decay != 1.0:
            for f in self.tracked:
                self.features[f].decay(self.config.decay)

    def flush(self) -> None:
        """Barrier for the async fold path (no-op otherwise) — call before
        sampling, checkpointing, or reading statistics."""
        if self._folder is not None:
            self._folder.flush()

    # --- trigger-facing statistics ----------------------------------------

    def _summarize(self) -> dict | None:
        per = [self.features[f].summary() for f in self.tracked]
        live = [s for s in per if s is not None]
        if not live:
            return None
        mass = sum(s["mass"] for s in live)
        entropy = sum(s["mass"] * s["entropy"] for s in live) / mass
        return {
            "entropy": float(entropy),
            "mass": float(mass),
            "heads": [
                (s["head_ids"], s["head_probs"]) if s is not None else None
                for s in per
            ],
            "batches_seen": self.batches_seen,
        }

    def export_heads(self, n: int | None = None) -> dict[int, np.ndarray]:
        """Current SpaceSaving head ids per tracked feature (descending
        estimated count, at most ``n`` each) — the hot-id set a serve
        cache materializes (serve/dlrm.py).  Flushes the async fold so
        the export reflects every observed batch."""
        self.flush()
        out: dict[int, np.ndarray] = {}
        for f in self.tracked:
            ids, _ = self.features[f].hh.head()
            out[f] = ids[:n] if n is not None else ids
        return out

    def poll_window(self) -> dict | None:
        """The statistics snapshot of the most recently CLOSED window, once
        (cleared on read) — the Trainer feeds it to the trigger policy."""
        s, self._pending_summary = self._pending_summary, None
        return s

    # --- memory / checkpoint ----------------------------------------------

    @property
    def nbytes(self) -> int:
        """Tracker state memory: O(width·depth + heavy + ring) per tracked
        feature — NO term scales with the vocabulary."""
        return sum(self.features[f].nbytes for f in self.tracked)

    def state_tree(self) -> list[np.ndarray]:
        self.flush()
        leaves: list[np.ndarray] = [np.int64(self.batches_seen)]
        for f in self.tracked:
            leaves.extend(self.features[f].state_tree())
        return leaves

    def state_template(self) -> list[np.ndarray]:
        """Restore-template form: a FRESH tracker's state (same fixed
        shapes as the live one).  When a sectioned checkpoint has no
        ``id_counts`` section, the template value IS what gets restored —
        a deterministic empty tracker beats a stale live-state mix (same
        reasoning as ``ClusterTrigger.state_template``)."""
        fresh = SketchFrequencyTracker(
            self.vocab_sizes,
            dataclasses.replace(self.config, async_fold=False),
            tracked=self.tracked, key=self.key,
        )
        return fresh.state_tree()

    def load_state_tree(self, tree: Sequence[np.ndarray]) -> None:
        self.flush()
        tree = list(tree)
        self.batches_seen = int(tree[0])
        per = len(self.features[self.tracked[0]].state_tree()) if self.tracked else 0
        off = 1
        for f in self.tracked:
            self.features[f].load_state_tree(tree[off : off + per])
            off += per
        self._pending_summary = None

    # --- legacy dense-checkpoint migration --------------------------------

    def state_from_dense(self, counts: Sequence[np.ndarray]) -> list[np.ndarray]:
        """The state tree a fresh sketch tracker holds after ingesting a
        dense per-feature histogram list (``IdFrequencyTracker`` layout):
        exact top-``heavy`` head per feature (bit-for-bit), tail folded
        into the sketch, ring seeded with the highest-count tail ids."""
        # scratch tracker is read once for its state: no async machinery
        # (a folder thread + a device counter would be spawned and leaked)
        fresh = SketchFrequencyTracker(
            self.vocab_sizes, dataclasses.replace(self.config, async_fold=False),
            tracked=self.tracked, key=self.key,
        )
        for f in fresh.tracked:
            fresh.features[f].ingest_dense(np.asarray(counts[f]))
        # batches_seen restarts at 0: dense-era checkpoints carried no
        # batch count, and seeding it from the LIVE tracker would make
        # the window phase (and thus the trigger schedule) depend on
        # whether the restore ran in-process or in a fresh process
        return fresh.state_tree()

    def checkpoint_migrations(self):
        """The (to_old, to_new) pair ``Trainer.restore_latest`` tries: a
        checkpoint whose ``id_counts`` is the legacy dense layout restores
        into sketch state via ``state_from_dense``."""

        def to_old(template):
            if not (isinstance(template, dict) and "id_counts" in template):
                return template
            # zero-size WILDCARD per feature, not np.zeros(vocab): the
            # template only has to match the legacy layout's leaf COUNT
            # (one per feature — the sketch layout has a different count),
            # and materializing full-vocab zeros for every restore
            # candidate would reintroduce the very O(vocab) transients
            # this tracker exists to avoid
            return dict(
                template,
                id_counts=[np.zeros(0, np.int64) for _ in self.vocab_sizes],
            )

        def to_new(tree):
            if isinstance(tree, dict) and "id_counts" in tree:
                tree = dict(tree, id_counts=self.state_from_dense(tree["id_counts"]))
            return tree

        return [(to_old, to_new)]
