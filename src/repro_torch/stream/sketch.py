"""Sketch-based frequency statistics: count-min + SpaceSaving + recent ring
(a numpy copy of the JAX package's ``stream/sketch.py``, with identical
output; the port cannot import it, since that package imports JAX).

One ``FeatureSketch`` replaces one dense per-vocab histogram row of the
old ``IdFrequencyTracker`` at O(width·depth + heavy + ring) memory —
independent of the vocabulary size, which is the whole point at the
multi-hundred-million-row scale the ROADMAP targets (CAFE, Zhang et al.
2023, is the production precedent for exactly this split):

  * ``CountMinSketch`` — (depth, width) float counters, multiply-shift
    hashing (width a power of two so the row hash is one uint32 multiply
    + shift, expressible identically in numpy and in torch's int64
    emulation — the in-step batch counter in ``stream/device.py`` must
    land in the same cells).
    ``add`` is the CONSERVATIVE update (only raise a cell to the new
    minimum-estimate, vectorized over a batch of unique ids);
    ``add_cells`` folds a device-computed (depth, width) delta (plain
    CMS add — conservativeness needs per-id estimates the segment-sum
    path deliberately avoids).  ``estimate`` is the classic min-row
    upper bound; ``estimate_unbiased`` the count-mean correction
    (subtract each row's expected collision noise, take the median) —
    what the k-means tail weights use so collisions don't systematically
    inflate the tail.
  * ``SpaceSaving`` — fixed-capacity exact counters for the head.  An
    id's increments go to its counter while it is resident; a non-
    resident id whose sketch estimate exceeds the minimum resident count
    evicts it (the classic SpaceSaving overestimate guarantee, with the
    sketch playing the count-of-evicted role).  Evicted counts are
    pushed back into the sketch (``raise_to``) so the min-row invariant
    `estimate >= true count` survives residency round-trips.
  * a recent-id RING — the last ``ring`` observed ids verbatim.  The
    sketch cannot enumerate the ids it has seen, so the ring supplies
    the tail candidates for the k-means point set and the tail-support
    estimate for the entropy signal.  It is also what makes the
    statistics *windowed*: ring contents always reflect the recent
    stream regardless of decay.

Decay: ``decay(gamma)`` scales sketch counters, resident counts and the
total mass — applied once per window by the tracker, giving the
exponential forgetting the trigger policy needs to see distribution
shift instead of an ever-growing prefix sum.
"""
from __future__ import annotations

import numpy as np

_MASS_DTYPE = np.float64  # exact for integer counts < 2**53 (bit-for-bit
#                           dense-checkpoint migration relies on this)


def _hash_coeffs(rng: np.random.Generator, depth: int):
    """Per-row multiply-shift coefficients: odd multiplier + offset."""
    a = rng.integers(0, 2**32, depth, dtype=np.uint32) | np.uint32(1)
    b = rng.integers(0, 2**32, depth, dtype=np.uint32)
    return a, b


class CountMinSketch:
    """Conservative-update count-min sketch over non-negative float mass."""

    def __init__(self, width: int, depth: int = 4, seed: int = 0):
        if width & (width - 1) or width <= 0:
            raise ValueError(f"width must be a power of two, got {width}")
        self.width = width
        self.depth = depth
        self.shift = np.uint32(32 - int(width).bit_length() + 1)
        self.a, self.b = _hash_coeffs(np.random.default_rng(seed), depth)
        self.counters = np.zeros((depth, width), _MASS_DTYPE)
        # mass absorbed by THIS sketch (diagnostics; rides the state so
        # it resumes).  NOT the stream mass — FeatureSketch.mass is that:
        # on the sync path resident head ids bypass the sketch entirely,
        # on the async fold the whole batch lands here.
        self.total = 0.0
        self._rows = np.arange(depth)[:, None]

    def cells(self, ids: np.ndarray) -> np.ndarray:
        """(depth, n) uint32 cell index per hash row — multiply-shift on
        uint32 (wraps mod 2^32), top bits select the cell."""
        x = np.asarray(ids).astype(np.uint32)[None, :]
        return (self.a[:, None] * x + self.b[:, None]) >> self.shift

    def add(self, ids: np.ndarray, counts: np.ndarray) -> None:
        """Conservative update for a batch of UNIQUE ids: raise each id's
        cells to (min-estimate + its count).  Per-id the invariant
        `every cell >= the id's true mass` is preserved even batched —
        colliding ids max into the cell, and max of overestimates is an
        overestimate."""
        ids = np.asarray(ids)
        if ids.size == 0:
            return
        counts = np.asarray(counts, _MASS_DTYPE)
        cells = self.cells(ids)
        new = self.counters[self._rows, cells].min(axis=0) + counts
        for r in range(self.depth):
            np.maximum.at(self.counters[r], cells[r], new)
        self.total += float(counts.sum())

    def add_cells(self, delta: np.ndarray) -> None:
        """Fold a device-computed (depth, width) increment (plain CMS add;
        each row received the full batch, so total rises by one row's
        mass)."""
        self.counters += delta
        self.total += float(np.asarray(delta)[0].sum())

    def raise_to(self, ids: np.ndarray, counts: np.ndarray) -> None:
        """Raise each id's cells to at least ``counts`` — re-absorbs a
        SpaceSaving eviction without double-adding mass."""
        ids = np.asarray(ids)
        if ids.size == 0:
            return
        cells = self.cells(ids)
        for r in range(self.depth):
            np.maximum.at(self.counters[r], cells[r], np.asarray(counts, _MASS_DTYPE))

    def estimate(self, ids: np.ndarray) -> np.ndarray:
        """Min-row estimate: an upper bound on each id's true mass."""
        ids = np.asarray(ids)
        if ids.size == 0:
            return np.zeros(0, _MASS_DTYPE)
        return self.counters[self._rows, self.cells(ids)].min(axis=0)

    def estimate_unbiased(self, ids: np.ndarray) -> np.ndarray:
        """Count-mean(-min) estimate: subtract each row's expected
        collision noise ``(row_mass - cell) / (width - 1)`` (the row's
        ACTUAL counter mass, not the stream total — under conservative
        update rows hold less than the total and a total-based correction
        over-subtracts), average the corrected rows, clip into
        [0, min-estimate].  Not exactly unbiased — the clip and the
        shared-cell correlations leave a small centered-ish residual —
        but on tail ids its error is a fraction of the min-estimate's
        upward collision bias, which is what matters when the estimates
        become k-means tail WEIGHTS: collisions must not masquerade as
        frequency."""
        ids = np.asarray(ids)
        if ids.size == 0:
            return np.zeros(0, _MASS_DTYPE)
        raw = self.counters[self._rows, self.cells(ids)]
        row_mass = self.counters.sum(axis=1, keepdims=True)
        noise = (row_mass - raw) / max(self.width - 1, 1)
        est = (raw - noise).mean(axis=0)
        return np.clip(est, 0.0, raw.min(axis=0))

    def decay(self, gamma: float) -> None:
        self.counters *= gamma
        self.total *= gamma

    @property
    def nbytes(self) -> int:
        return self.counters.nbytes + self.a.nbytes + self.b.nbytes

    def state_tree(self) -> list[np.ndarray]:
        return [self.counters.copy(), np.float64(self.total)]

    def load_state_tree(self, tree) -> None:
        counters, total = tree
        self.counters = np.asarray(counters, _MASS_DTYPE).reshape(
            self.depth, self.width
        ).copy()
        self.total = float(total)


class SpaceSaving:
    """Fixed-capacity exact head counters (SpaceSaving with the sketch as
    the evicted-mass oracle).  Resident ids live in parallel arrays —
    slots [0, n) filled contiguously — so decay/state are vectorized and
    checkpoint leaves are fixed-shape.  Residency lookup is a lazily
    rebuilt sorted index (searchsorted per batch, O(u·log H)): admissions
    become rare once the head stabilizes, so the rebuild amortizes away
    and the hot path stays free of per-id python work."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.ids = np.full(capacity, -1, np.int64)
        self.counts = np.zeros(capacity, _MASS_DTYPE)
        self.n = 0
        self._dirty = True
        self._sorted_ids: np.ndarray | None = None
        self._sorted_slots: np.ndarray | None = None

    def _index(self):
        if self._dirty:
            order = np.argsort(self.ids[: self.n], kind="stable")
            self._sorted_ids = self.ids[: self.n][order]
            self._sorted_slots = order
            self._dirty = False

    def split_resident(self, ids: np.ndarray):
        """-> (slot index per id, resident mask) for a batch of ids."""
        ids = np.asarray(ids, np.int64)
        if self.n == 0:
            return np.full(ids.shape, -1, np.int64), np.zeros(ids.shape, bool)
        self._index()
        pos = np.clip(np.searchsorted(self._sorted_ids, ids), 0, self.n - 1)
        hit = self._sorted_ids[pos] == ids
        return np.where(hit, self._sorted_slots[pos], -1), hit

    def bump(self, slots: np.ndarray, counts: np.ndarray) -> None:
        """Add exact counts to resident slots (slots unique per batch —
        callers pass unique ids)."""
        self.counts[slots] += np.asarray(counts, _MASS_DTYPE)

    def offer(self, ids: np.ndarray, ests: np.ndarray, sketch: CountMinSketch):
        """SpaceSaving admission for NON-resident ids with sketch-estimate
        ``ests``: fill free slots first, then evict the minimum-count
        resident when the candidate's estimate exceeds it (pushing the
        evictee's count back into the sketch).  Candidates descend by
        estimate, so the first non-admitting one ends the batch."""
        order = np.argsort(np.asarray(ests), kind="stable")[::-1]
        evicted_ids: list[int] = []
        evicted_cnt: list[float] = []
        for j in order.tolist():
            i, est = int(ids[j]), float(ests[j])
            if self.n < self.capacity:
                self.ids[self.n], self.counts[self.n] = i, est
                self.n += 1
                self._dirty = True
                continue
            s = int(np.argmin(self.counts))
            if est <= self.counts[s]:
                break  # candidates are descending: nothing else admits
            evicted_ids.append(int(self.ids[s]))
            evicted_cnt.append(float(self.counts[s]))
            self.ids[s], self.counts[s] = i, est
            self._dirty = True
        if evicted_ids:  # one vectorized sketch push for the whole batch
            sketch.raise_to(np.asarray(evicted_ids), np.asarray(evicted_cnt))

    def head(self) -> tuple[np.ndarray, np.ndarray]:
        """(ids, counts) of resident entries, descending by count."""
        n = self.n
        order = np.argsort(self.counts[:n], kind="stable")[::-1]
        return self.ids[:n][order].copy(), self.counts[:n][order].copy()

    def decay(self, gamma: float) -> None:
        self.counts[: self.n] *= gamma

    @property
    def nbytes(self) -> int:
        return self.ids.nbytes + self.counts.nbytes

    def state_tree(self) -> list[np.ndarray]:
        return [self.ids.copy(), self.counts.copy()]

    def load_state_tree(self, tree) -> None:
        ids, counts = tree
        self.ids = np.asarray(ids, np.int64).reshape(self.capacity).copy()
        self.counts = np.asarray(counts, _MASS_DTYPE).reshape(self.capacity).copy()
        self.n = int((self.ids >= 0).sum())
        self._dirty = True


class FeatureSketch:
    """One feature's complete streaming state: sketch + head + ring + mass.

    This object IS the transition's count provider — it exposes
    ``points(n, seed)`` (the k-means point set) and ``id_weights(d1)``
    (dense per-id weights for the moment remap, a TRANSITION-TIME
    transient of the same order as the pointer table, never tracker
    state), so ``id_counts[i]`` entries duck-type against dense arrays
    in ``train/transition.py``.
    """

    def __init__(self, width: int, depth: int, heavy: int, ring: int,
                 seed: int = 0):
        self.cms = CountMinSketch(width, depth, seed=seed)
        self.hh = SpaceSaving(heavy)
        self.ring = np.full(ring, -1, np.int64)
        self.ring_pos = 0
        self.mass = 0.0  # total (decayed) observed mass, heavy + tail

    # --- updates ---------------------------------------------------------

    def _push_ring(self, raw_ids: np.ndarray) -> None:
        r = self.ring.shape[0]
        ids = np.asarray(raw_ids, np.int64).reshape(-1)[-r:]
        pos = self.ring_pos % r
        k = min(ids.size, r - pos)
        self.ring[pos : pos + k] = ids[:k]
        if k < ids.size:
            self.ring[: ids.size - k] = ids[k:]
        self.ring_pos = (pos + ids.size) % r

    def observe(self, raw_ids: np.ndarray) -> None:
        """Host (synchronous, conservative) update with one batch of raw
        (with-multiplicity) ids."""
        self._ingest(raw_ids, into_sketch=True)

    def fold_cells(self, delta: np.ndarray, raw_ids: np.ndarray) -> None:
        """Async path: fold a device-computed (depth, width) cell delta
        (the sketch update never touched the host hot path) and run the
        id-level head/ring bookkeeping from the host batch copy.  Resident
        ids' mass lands in the sketch too (their cells go stale-HIGH,
        which the min/offer invariants tolerate); their exact counters
        still get the increments."""
        self.cms.add_cells(delta)
        self._ingest(raw_ids, into_sketch=False)

    def _ingest(self, raw_ids: np.ndarray, *, into_sketch: bool) -> None:
        """The id-level bookkeeping BOTH update paths share (so they
        cannot drift apart — restart-exactness depends on sync and async
        computing identical head/ring/mass state): resident head ids take
        exact increments, absent ids go through SpaceSaving admission,
        the ring and mass advance.  ``into_sketch`` adds the absent mass
        to the CMS too (the async path already folded it as cells)."""
        raw_ids = np.asarray(raw_ids).reshape(-1)
        if raw_ids.size == 0:
            return
        uids, ucnt = np.unique(raw_ids, return_counts=True)
        ucnt = ucnt.astype(_MASS_DTYPE)
        slots, resident = self.hh.split_resident(uids)
        self.hh.bump(slots[resident], ucnt[resident])
        absent_ids, absent_cnt = uids[~resident], ucnt[~resident]
        if into_sketch:
            self.cms.add(absent_ids, absent_cnt)
        self.hh.offer(absent_ids, self.cms.estimate(absent_ids), self.cms)
        self.mass += float(ucnt.sum())
        self._push_ring(raw_ids)

    def decay(self, gamma: float) -> None:
        self.cms.decay(gamma)
        self.hh.decay(gamma)
        self.mass *= gamma

    # --- queries ----------------------------------------------------------

    def estimate(self, ids: np.ndarray) -> np.ndarray:
        """Best per-id estimate: exact for resident head ids, min-row
        sketch upper bound for the rest."""
        ids = np.asarray(ids)
        slots, resident = self.hh.split_resident(ids)
        out = self.cms.estimate(ids)
        out[resident] = self.hh.counts[slots[resident]]
        return out

    def tail_candidates(self) -> np.ndarray:
        """Distinct recently-seen ids that are NOT resident in the head —
        the only enumerable view of the tail a sketch-based tracker has."""
        seen = np.unique(self.ring)
        seen = seen[seen >= 0]
        if seen.size == 0:
            return seen
        _, resident = self.hh.split_resident(seen)
        return seen[~resident]

    def points(self, n: int, seed: int) -> tuple[np.ndarray, np.ndarray] | None:
        """K-means point set: exact head counts + unbiased tail estimates
        over ring candidates, capped at ``n`` by the same stratified-HT
        subsampling the dense tracker uses.  None before any mass."""
        from repro_torch.stream.points import stratified_points

        if self.mass <= 0.0:
            return None
        head_ids, head_cnt = self.hh.head()
        tail_ids = self.tail_candidates()
        # ring membership PROVES one recent occurrence — floor the
        # collision-corrected estimate there so a zeroed-out tail id
        # still enters the point set with its minimum honest weight
        tail_w = np.maximum(self.cms.estimate_unbiased(tail_ids), 1.0)
        ids = np.concatenate([head_ids, tail_ids])
        w = np.concatenate([head_cnt, tail_w])
        if ids.size == 0:
            return None
        return stratified_points(ids, w, n, seed)

    def id_weights(self, d1: int, chunk: int = 1 << 20) -> np.ndarray:
        """Dense (d1,) float32 weight estimate for the moment remap:
        unbiased sketch estimates streamed in chunks, exact head counts
        spliced over the top.  O(d1) TRANSIENT work at transition time
        (the transition's assign_all pass is already O(d1)); tracker
        state stays O(sketch)."""
        w = np.empty(d1, np.float32)
        for lo in range(0, d1, chunk):
            hi = min(lo + chunk, d1)
            w[lo:hi] = self.cms.estimate_unbiased(np.arange(lo, hi))
        head_ids, head_cnt = self.hh.head()
        ok = head_ids < d1
        w[head_ids[ok]] = head_cnt[ok]
        return w

    def summary(self) -> dict | None:
        """Window statistics for the trigger policy: observed-entropy
        estimate (exact head distribution + tail mass spread uniformly
        over the ring's distinct tail support) and the head snapshot the
        drift signal compares across windows.  None before any mass."""
        if self.mass <= 0.0:
            return None
        head_ids, head_cnt = self.hh.head()
        p = head_cnt[head_cnt > 0] / self.mass
        ent = float(-(p * np.log(p)).sum()) if p.size else 0.0
        tail_mass = max(self.mass - float(head_cnt.sum()), 0.0)
        support = int(self.tail_candidates().size)
        if tail_mass > 0.0 and support > 0:
            q = tail_mass / self.mass
            ent += float(-q * np.log(q / support))
        return {
            "entropy": ent,
            "mass": self.mass,
            "head_ids": head_ids,
            "head_probs": head_cnt / self.mass,
        }

    # --- memory / checkpoint ----------------------------------------------

    @property
    def nbytes(self) -> int:
        return self.cms.nbytes + self.hh.nbytes + self.ring.nbytes

    def state_tree(self) -> list[np.ndarray]:
        return (
            self.cms.state_tree()
            + self.hh.state_tree()
            + [self.ring.copy(), np.int64(self.ring_pos), np.float64(self.mass)]
        )

    def load_state_tree(self, tree) -> None:
        tree = list(tree)
        self.cms.load_state_tree(tree[0:2])
        self.hh.load_state_tree(tree[2:4])
        self.ring = np.asarray(tree[4], np.int64).reshape(self.ring.shape).copy()
        self.ring_pos = int(tree[5])
        self.mass = float(tree[6])

    def ingest_dense(self, counts: np.ndarray) -> None:
        """Absorb a dense histogram (legacy-checkpoint migration): the
        top-``heavy`` ids become resident with their EXACT counts
        (bit-for-bit — float64 is exact for int64 counts < 2^53), the
        rest conservative-update into the sketch, and the highest-count
        tail ids seed the ring so tail candidates survive the migration."""
        counts = np.asarray(counts)
        nz = np.flatnonzero(counts > 0)
        if nz.size == 0:
            return
        order = nz[np.argsort(counts[nz], kind="stable")[::-1]]
        head = order[: self.hh.capacity]
        self.hh.ids[: head.size] = head
        self.hh.counts[: head.size] = counts[head].astype(_MASS_DTYPE)
        self.hh.n = int(head.size)
        self.hh._dirty = True
        tail = order[self.hh.capacity :]
        self.cms.add(tail, counts[tail].astype(_MASS_DTYPE))
        self.mass = float(counts[nz].astype(_MASS_DTYPE).sum())
        if tail.size:
            self._push_ring(tail[: self.ring.shape[0]])
