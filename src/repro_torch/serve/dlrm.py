"""Batched DLRM serving with a hot-id cache (the JAX package's
``serve/dlrm.py``).

* **One fused launch per cold serve batch.**  Lookups run through
  ``collection.lookup_all`` on HOST-translated rows (``HostTranslator``),
  so the device never gathers the pointer tables.
* **The hot head never touches the supertable.**  :class:`HotCache`
  holds the decoded embeddings of each feature's hot ids (small full
  tables whole, and the head a tracker names for the others) in one
  dense device table.  A hit is a gather from it; the cold tail runs the
  fused lookup on a compacted sub-batch whose hit features are masked to
  the ``-1`` sentinel, so the kernel works on true misses only and adds
  an exact zero for the rest.  A fully-hit batch launches nothing.
* **Freshness is enforced.**  The cache records the transition epoch of
  every cached feature; serving across a transition without a refresh
  raises :class:`StaleCacheError`.

Requests aggregate in :class:`MicroBatcher` under a latency budget; a
batch pads to fixed bucket shapes, as in the JAX package.  Every
host->device copy (slots, dense features, rows, cold indices) is an
explicit ``.to(device)``.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import embeddings as emb_lib
from repro_torch.data.translate import HostTranslator
from repro_torch.models import dlrm as dlrm_lib
from repro_torch.obs.runlog import LatencyHistogram
from repro_torch.stream.trigger import head_churn


class StaleCacheError(RuntimeError):
    """The hot cache was built against a pre-transition supertable."""


# --- the two serve programs -------------------------------------------------


def make_serve_fns(cfg):
    """The (hit, cold) serve functions of one DLRM config.

    ``hit_fn(mlp_params, cache_tab, slots, dense)``: a fully-hit batch,
    ONE gather of the decoded-embedding cache (slot -1 gathers zero)
    feeding the interaction MLPs.  No lookup launch.

    ``cold_fn(params, cache_tab, slots, dense, rows, cold_idx)``: the same
    cache gather plus ONE fused supertable lookup over the compacted cold
    sub-batch (hit features masked to -1 in ``rows``), added back at
    ``cold_idx`` with ``index_add_`` into a buffer with one extra row:
    pad entries of ``cold_idx`` point at that row, which is dropped.
    """
    coll = cfg.collection

    def _cache_gather(cache_tab, slots):
        live = (slots >= 0)[..., None].to(cache_tab.dtype)
        return cache_tab[slots.clamp(min=0)] * live  # (B, F, d2)

    def hit_fn(mlp_params, cache_tab, slots, dense):
        emb = _cache_gather(cache_tab, slots)
        return dlrm_lib.interact(mlp_params, cfg, dense, emb)

    def cold_fn(params, cache_tab, slots, dense, rows, cold_idx):
        emb = _cache_gather(cache_tab, slots)
        B = emb.shape[0]
        cold = coll.lookup_all(params["emb"], None, None, rows=rows)  # (B_cold, F, d2)
        buf = torch.cat([emb, emb.new_zeros((1,) + emb.shape[1:])])
        buf.index_add_(0, cold_idx, cold.to(emb.dtype))
        mlp = {"bottom": params["bottom"], "top": params["top"]}
        return dlrm_lib.interact(mlp, cfg, dense, buf[:B])

    return hit_fn, cold_fn


# --- the hot-id cache -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HotCache:
    """Dense decoded-embedding cache over each feature's hot-id set: one
    (n_slots, emb_dim) device table, and per cached feature a SORTED
    unique id array plus its base offset (the host-side slot lookup is a
    ``searchsorted``).  ``epochs`` snapshots the transition epoch of
    every cached feature that has one."""

    ids: dict[int, np.ndarray]  # feature -> sorted unique cached ids
    base: dict[int, int]  # feature -> row offset into `table`
    table: torch.Tensor  # (max(n_slots, 1), emb_dim) decoded embeddings
    epochs: dict[int, int]  # feature -> transition epoch at build time
    n_slots: int

    @classmethod
    def build(cls, collection, emb_params, emb_buffers,
              head_ids: dict[int, np.ndarray]) -> "HotCache":
        """Decode ``head_ids[f]`` through each feature's own table
        (unstacking each touched group once).  Out-of-range and negative
        ids are dropped; features left with no ids are not cached."""
        per_feature: dict[int, np.ndarray] = {}
        for f, ids in head_ids.items():
            t = collection.tables[f]
            ids = np.unique(np.asarray(ids, np.int64))
            ids = ids[(ids >= 0) & (ids < t.d1)]
            if ids.size:
                per_feature[f] = ids

        groups_needed = sorted({collection._locate[f][0] for f in per_feature})
        unstacked = {
            g: collection.unstack_group_params(collection.groups[g], emb_params[g])
            for g in groups_needed
        }

        base: dict[int, int] = {}
        epochs: dict[int, int] = {}
        chunks = []
        off = 0
        for f in sorted(per_feature):
            g, f_local = collection._locate[f]
            t = collection.tables[f]
            fb = emb_buffers[g][f_local]
            p = unstacked[g][f_local]
            device = next(iter(p.values())).device
            chunks.append(t.lookup(p, fb, torch.from_numpy(per_feature[f]).to(device)))
            base[f] = off
            off += per_feature[f].size
            if "epoch" in fb:
                epochs[f] = int(fb["epoch"])
        if chunks:
            table = torch.cat(chunks, dim=0)
        else:
            first = next(iter(emb_params[0].values()))
            table = torch.zeros((1, collection.tables[0].d2), dtype=first.dtype,
                                device=first.device)
        return cls(ids=per_feature, base=base, table=table, epochs=epochs, n_slots=off)

    def slots(self, sparse: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(B, n_features) raw ids -> (slots, hit): the cache row of each
        lookup (-1 = miss) and the boolean hit mask."""
        sparse = np.asarray(sparse)
        B, F = sparse.shape
        slots = np.full((B, F), -1, np.int32)
        hit = np.zeros((B, F), bool)
        for f, ids in self.ids.items():
            col = sparse[:, f]
            pos = np.searchsorted(ids, col)
            ok = (pos < ids.size) & (ids[np.minimum(pos, ids.size - 1)] == col)
            slots[ok, f] = self.base[f] + pos[ok]
            hit[:, f] = ok
        return slots, hit


# --- request aggregation ----------------------------------------------------


@dataclasses.dataclass
class ServeRequest:
    uid: int
    dense: np.ndarray  # (n_dense,)
    sparse: np.ndarray  # (n_sparse,) raw ids
    t_arrival: float | None = None


@dataclasses.dataclass(frozen=True)
class ServeResult:
    uid: int
    logit: float
    latency_s: float
    cache_hit: bool  # every feature answered from the hot cache


class MicroBatcher:
    """Aggregate concurrent requests into fixed-shape micro-batches.

    A batch is ready when ``max_batch`` requests are pending or the
    OLDEST pending request has waited ``latency_budget_s``: the budget
    bounds queue wait before dispatch, nothing downstream of it.  The
    clock is injectable so tests drive time."""

    def __init__(self, *, max_batch: int, latency_budget_s: float = 2e-3,
                 clock=time.monotonic):
        self.max_batch = int(max_batch)
        self.latency_budget_s = float(latency_budget_s)
        self.clock = clock
        self._pending: collections.deque[ServeRequest] = collections.deque()

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, req: ServeRequest) -> None:
        if req.t_arrival is None:
            req.t_arrival = self.clock()
        self._pending.append(req)

    def ready(self) -> bool:
        if len(self._pending) >= self.max_batch:
            return True
        if not self._pending:
            return False
        return self.clock() - self._pending[0].t_arrival >= self.latency_budget_s

    def take(self) -> list[ServeRequest]:
        return [self._pending.popleft() for _ in range(min(self.max_batch, len(self._pending)))]


def _pick_bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


# --- the engine -------------------------------------------------------------


class DLRMServeEngine:
    """Batched DLRM inference over the fused supertable + hot-id cache.

    ``tracker`` is any object with ``export_heads(n)`` (feature -> hot
    ids), ``observe(batch)`` and ``key``; its heads name the cached ids of
    the features it tracks, and small full tables (``d1 <=
    full_cache_max``) are cached whole.  ``cache=False`` sends every
    batch down the cold path.  ``batch_buckets``/``cold_buckets`` default
    to ``(max_batch,)``: every batch runs at one of two fixed shapes.
    The engine runs on the device of ``params``."""

    def __init__(self, params, buffers, cfg, *, tracker=None, cache=True,
                 max_batch: int = 8, latency_budget_s: float = 2e-3,
                 batch_buckets: tuple[int, ...] | None = None,
                 cold_buckets: tuple[int, ...] | None = None,
                 head_n: int | None = None, full_cache_max: int = 8192,
                 churn_threshold: float = 0.5, run_log=None,
                 clock=time.monotonic):
        coll = cfg.collection
        unfused = sorted({g.kind for g in coll.groups if g.kind != "univ"})
        if unfused:
            raise ValueError(
                "DLRMServeEngine serves host-translated rows, which cover "
                f"universal groups only; this collection has {unfused} groups"
            )
        self.cfg = cfg
        self.params = params
        self.buffers = buffers
        self.device = params["top"][0]["w"].device
        self.tracker = tracker
        self.run_log = run_log
        self.clock = clock
        self.head_n = head_n
        self.full_cache_max = int(full_cache_max)
        self.churn_threshold = float(churn_threshold)
        self.max_batch = int(max_batch)
        self.batch_buckets = tuple(sorted(batch_buckets or (max_batch,)))
        self.cold_buckets = tuple(sorted(cold_buckets or (max_batch,)))
        if self.batch_buckets[-1] < max_batch:
            raise ValueError("batch_buckets must cover max_batch")

        self._hit, self._cold = make_serve_fns(cfg)
        self._mlp_params = {"bottom": params["bottom"], "top": params["top"]}
        self.translator = HostTranslator(coll, buffers["emb"])
        self._live_epochs = self._read_epochs(buffers["emb"])
        self._empty_tab = torch.zeros((1, cfg.emb_dim), dtype=cfg.dtype, device=self.device)

        self.batcher = MicroBatcher(max_batch=max_batch,
                                    latency_budget_s=latency_budget_s, clock=clock)
        self.hist = LatencyHistogram()
        self.hist_hit = LatencyHistogram()
        self.hist_cold = LatencyHistogram()
        self.counters = collections.Counter()

        self.cache: HotCache | None = None
        self._use_cache = bool(cache)
        if self._use_cache:
            self.refresh_cache(reason="init")

    # --- cache lifecycle --------------------------------------------------

    def _read_epochs(self, emb_buffers) -> dict[int, int]:
        coll = self.cfg.collection
        out = {}
        for f in range(self.cfg.n_sparse):
            fb = coll.feature_buffers(emb_buffers, f)
            if "epoch" in fb:
                out[f] = int(fb["epoch"])
        return out

    def _head_ids(self) -> dict[int, np.ndarray]:
        """Cache coverage: whole full tables small enough to hold, and
        the tracker's heads for the other features."""
        out: dict[int, np.ndarray] = {}
        for f, t in enumerate(self.cfg.collection.tables):
            if isinstance(t, emb_lib.FullTable) and t.d1 <= self.full_cache_max:
                out[f] = np.arange(t.d1, dtype=np.int32)
        if self.tracker is not None:
            for f, ids in self.tracker.export_heads(self.head_n).items():
                if f not in out:
                    out[f] = ids
        return out

    def refresh_cache(self, *, reason: str = "manual", churn: float | None = None) -> HotCache:
        """(Re)build the hot cache from the live params/buffers and the
        tracker's heads; logs a ``cache_refresh`` run-log event."""
        self._use_cache = True
        with torch.no_grad():
            self.cache = HotCache.build(
                self.cfg.collection, self.params["emb"], self.buffers["emb"],
                self._head_ids(),
            )
        self.counters["n_refreshes"] += 1
        if self.run_log is not None:
            fields = dict(reason=reason, n_slots=self.cache.n_slots,
                          n_features=len(self.cache.ids))
            if churn is not None:
                fields["churn"] = float(churn)
            self.run_log.append("cache_refresh", dedupe=False, **fields)
        return self.cache

    def update_state(self, params, buffers, *, refresh_cache: bool = True):
        """Point the engine at post-transition params/buffers: re-syncs the
        host translator and (by default) rebuilds the cache.  With
        ``refresh_cache=False`` the stale cache is kept and the next batch
        raises :class:`StaleCacheError`."""
        self.params = params
        self.buffers = buffers
        self._mlp_params = {"bottom": params["bottom"], "top": params["top"]}
        self.translator.update(buffers["emb"])
        self._live_epochs = self._read_epochs(buffers["emb"])
        if refresh_cache and self._use_cache:
            self.refresh_cache(reason="transition")

    def maybe_refresh(self) -> float | None:
        """Refresh when the Jaccard distance between a cached head and the
        tracker's current head reaches ``churn_threshold``.  Returns the
        largest churn seen (None without tracker and cache)."""
        if self.tracker is None or self.cache is None:
            return None
        fresh = self.tracker.export_heads(self.head_n)
        churns = [head_churn(self.cache.ids[f], fresh[f]) for f in self.cache.ids if f in fresh]
        if not churns:
            return None
        churn = max(churns)
        if churn >= self.churn_threshold:
            self.refresh_cache(reason="head-churn", churn=churn)
        return churn

    # --- serving ----------------------------------------------------------

    def predict(self, dense: np.ndarray, sparse: np.ndarray) -> np.ndarray:
        """Synchronous batch inference: (B, n_dense) + (B, n_sparse) ids
        -> (B,) logits, through the same bucketed functions as requests."""
        logits, _ = self._serve_batch(np.asarray(dense), np.asarray(sparse))
        return logits

    def submit(self, req: ServeRequest) -> None:
        self.batcher.submit(req)

    def step(self) -> list[ServeResult]:
        """Serve ONE micro-batch if the batcher is ready."""
        if not self.batcher.ready():
            return []
        return self._run(self.batcher.take())

    def drain(self) -> list[ServeResult]:
        """Serve everything pending regardless of the budget."""
        out = []
        while len(self.batcher):
            out.extend(self._run(self.batcher.take()))
        return out

    def _run(self, reqs: list[ServeRequest]) -> list[ServeResult]:
        dense = np.stack([r.dense for r in reqs]).astype(np.float32)
        sparse = np.stack([r.sparse for r in reqs]).astype(np.int64)
        logits, elem_hit = self._serve_batch(dense, sparse)
        t_done = self.clock()
        results = []
        for i, r in enumerate(reqs):
            lat = t_done - (r.t_arrival if r.t_arrival is not None else t_done)
            hit = bool(elem_hit[i])
            results.append(ServeResult(uid=r.uid, logit=float(logits[i]),
                                       latency_s=lat, cache_hit=hit))
            self.hist.observe(lat)
            (self.hist_hit if hit else self.hist_cold).observe(lat)
            self.counters["n_requests"] += 1
            self.counters["n_hit_requests"] += int(hit)
            if self.run_log is not None:
                self.run_log.append("request", dedupe=False, uid=r.uid,
                                    latency_s=lat, cache_hit=hit)
        return results

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    @torch.no_grad()
    def _serve_batch(self, dense, sparse) -> tuple[np.ndarray, np.ndarray]:
        """Cache slots on the host, compact the cold tail, ONE fused
        lookup iff it is non-empty."""
        cache = self.cache
        if cache is not None:
            stale = [f for f, ep in cache.epochs.items() if self._live_epochs.get(f) != ep]
            if stale:
                raise StaleCacheError(
                    f"hot cache is stale for features {stale}: the supertable "
                    "transitioned since the last refresh; call update_state() "
                    "or refresh_cache() before serving"
                )
        n_real, F = sparse.shape[0], self.cfg.n_sparse
        if self.tracker is not None and n_real:
            self.tracker.observe({self.tracker.key: sparse})
        B = _pick_bucket(n_real, self.batch_buckets)
        dense_p = np.zeros((B, dense.shape[1]), np.float32)
        dense_p[:n_real] = dense
        if cache is not None and cache.n_slots:
            slots, hit = cache.slots(sparse)
            cache_tab = cache.table
        else:
            slots = np.full((n_real, F), -1, np.int32)
            hit = np.zeros((n_real, F), bool)
            cache_tab = self._empty_tab
        # pad elements are fully "hit": slot -1 gathers zero, no cold work
        slots_p = np.full((B, F), -1, np.int64)
        slots_p[:n_real] = slots
        hit_p = np.ones((B, F), bool)
        hit_p[:n_real] = hit
        elem_hit = hit.all(axis=1) if n_real else np.zeros((0,), bool)

        self.counters["n_batches"] += 1
        self.counters["n_id_lookups"] += int(n_real) * F
        self.counters["n_id_hits"] += int(hit.sum())

        cold = np.flatnonzero(~hit_p.all(axis=1))
        if cold.size == 0:
            self.counters["n_hit_batches"] += 1
            out = self._hit(self._mlp_params, cache_tab,
                            self._to_device(slots_p), self._to_device(dense_p))
        else:
            self.counters["n_cold_batches"] += 1
            self.counters["n_launches"] += 1
            Bc = _pick_bucket(cold.size, self.cold_buckets)
            coll = self.cfg.collection
            rows = self.translator.rows_masked(sparse[cold], hit[cold])
            rows_p = np.full((Bc, coll.rows_n_cols, coll.rows_n_tables), -1, np.int32)
            rows_p[: cold.size] = rows
            # pad entries point at the extra row B, which cold_fn drops
            cold_idx = np.full((Bc,), B, np.int64)
            cold_idx[: cold.size] = cold
            out = self._cold(self.params, cache_tab, self._to_device(slots_p),
                             self._to_device(dense_p), self._to_device(rows_p),
                             self._to_device(cold_idx))
        return out.cpu().numpy()[:n_real], elem_hit

    # --- stats ------------------------------------------------------------

    def flush_stats(self) -> dict:
        """Summary rates + (with a run log) three labeled ``latency_hist``
        events: overall / cache-hit / cold."""
        c = self.counters
        out = {
            "n_requests": int(c["n_requests"]),
            "n_batches": int(c["n_batches"]),
            "n_launches": int(c["n_launches"]),
            "n_refreshes": int(c["n_refreshes"]),
            "hit_rate_requests": c["n_hit_requests"] / c["n_requests"] if c["n_requests"] else 0.0,
            "hit_rate_ids": c["n_id_hits"] / c["n_id_lookups"] if c["n_id_lookups"] else 0.0,
            "launches_per_batch": c["n_launches"] / c["n_batches"] if c["n_batches"] else 0.0,
        }
        if self.run_log is not None:
            for hist, label in ((self.hist, "serve-dlrm"),
                                (self.hist_hit, "serve-dlrm-hit"),
                                (self.hist_cold, "serve-dlrm-cold")):
                if hist.n:
                    self.run_log.append("latency_hist", dedupe=False,
                                        **(hist.to_dict() | {"label": label}))
        return out
