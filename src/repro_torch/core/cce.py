"""Clustered Compositional Embeddings (Algorithm 3 of the paper): state,
buffer init, row translation, the fused lookup and the clustering
transition (``cluster``, alone or over a process group).

A CCE table with vocabulary ``d1``, output dim ``d2``, ``c`` columns and
``2k`` rows per column (main table M indexed by a learned pointer array,
helper table M' indexed by a random hash):

    lookup(id) = concat_i( M_i[ptr_i(id)] + M'_i[h'_i(id)] )

State layout (the JAX package's):

    params["tables"]  : (c, 2, k, dsub) -- [:,0] main M, [:,1] helper M'
    buffers["ptr"]    : (c, d1) int32   -- learned pointer arrays
    buffers["hs"]     : (c, 2)          -- multiply-shift coeffs of h'_i
                                           (uint32 in numpy, int64 tensors)
    buffers["epoch"]  : () int32        -- transition counter

``cluster()`` is the paper's training-time transition (Alg. 3, lines
10-17): per column, materialize (a sample of) the current vocabulary
embeddings, k-means them into k centroids, set ptr_i <- assignments,
M_i <- centroids, draw a fresh random h'_i and zero M'_i.  It returns new
tensors and leaves its inputs untouched.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch import shard
from repro_torch.core import embeddings as emb_lib
from repro_torch.core import hashing
from repro_torch.core import kmeans as km
from repro_torch.kernels import ops as kops


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """(n, m) float32 values summed by segment id (n,) -> (n_seg, m), with
    deterministic algorithms on: the same inputs give the same bits on
    every run (on CUDA a sorted reduction instead of atomics)."""
    out = torch.zeros((n_seg, vals.shape[1]), dtype=torch.float32, device=vals.device)
    with km.deterministic():
        out.index_add_(0, seg, vals)
    return out


@dataclasses.dataclass(frozen=True)
class CCE:
    """Algorithm 3: CCE table with ``c`` columns and ``2k`` rows/column."""

    d1: int
    d2: int
    k: int
    c: int = 4
    seed_salt: int = 0
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.d2 % self.c or self.k < 1:
            raise ValueError(f"CCE needs c | d2 and k >= 1, got {self}")

    @classmethod
    def from_budget(cls, d1, d2, budget, c=4, **kw):
        # 2 tables of (k, d2/c) per column -> 2*k*d2 params total
        k = max(1, min(d1, budget // (2 * d2)))
        return cls(d1, d2, k=k, c=c, **kw)

    @property
    def dsub(self) -> int:
        return self.d2 // self.c

    @property
    def n_params(self) -> int:
        return 2 * self.k * self.d2

    # --- universal fusion -----------------------------------------------

    @property
    def fuse_spec(self) -> emb_lib.FuseSpec:
        return emb_lib.FuseSpec(cols=self.c, n_tables=2, k=self.k, dsub=self.dsub)

    def fuse_slab(self, params):
        return params["tables"]  # (c, 2, k, dsub) is already the natural slab

    def unfuse_slab(self, slab):
        return {"tables": slab}

    def fuse_rows(self, buffers, ids):
        return self._rows(buffers, ids)  # (c, B, 2)

    def fuse_rows_np(self, buffers, ids):
        """Host twin of ``fuse_rows`` (host-side pointer translation).  The
        ptr gather clamps out-of-range ids; the helper hash consumes the
        raw id."""
        ids = np.asarray(ids)
        ptr = np.asarray(buffers["ptr"])
        hs = np.asarray(buffers["hs"])
        main = ptr[:, np.clip(ids, 0, self.d1 - 1)]  # (c, B)
        helper = hashing.multiply_shift_np(ids[None], hs[:, :1], hs[:, 1:], self.k)
        return np.stack([main, helper], axis=-1).astype(np.int32)

    # --- init -----------------------------------------------------------

    def init_buffers(self):
        """Numpy buffers, bit-exact with the JAX package: the hash
        coefficients derive from ``seed_salt``."""
        ptr_hashes = hashing.make_hashes(self.seed_salt * 7919 + 66, self.c, self.k)
        ids = np.arange(self.d1)
        ptr = np.stack([h.np(ids) for h in ptr_hashes])  # (c, d1) int32
        hs = hashing.pack_hashes(
            hashing.make_hashes(self.seed_salt * 7919 + 77, self.c, self.k)
        )
        return {"ptr": ptr, "hs": hs, "epoch": np.int32(0)}

    def init(self, generator: torch.Generator, device="cuda"):
        scale = 1.0 / math.sqrt(self.d2)
        if generator is None:  # shapes only (``lm.init`` on the meta device)
            tables = torch.empty((self.c, 2, self.k, self.dsub), device="meta")
        else:
            tables = torch.randn((self.c, 2, self.k, self.dsub), generator=generator,
                                 device=generator.device) * scale
        b = self.init_buffers()
        buffers = {
            "ptr": torch.from_numpy(b["ptr"]).to(device),
            "hs": torch.from_numpy(b["hs"].astype(np.int64)).to(device),
            "epoch": torch.tensor(0, dtype=torch.int32, device=device),
        }
        return {"tables": tables.to(device=device, dtype=self.dtype)}, buffers

    # --- lookup ---------------------------------------------------------

    def _helper_rows(self, buffers, ids):
        hs = buffers["hs"]
        shape = (self.c,) + (1,) * ids.dim()
        return hashing.multiply_shift(
            ids[None], hs[:, 0].reshape(shape), hs[:, 1].reshape(shape), self.k
        )  # (c, ...)

    def _rows(self, buffers, ids):
        """(c, ..., 2) int32: main rows from the learned ptr, helper rows
        from the random hash.  The ptr gather clamps out-of-range ids, as
        the XLA gather of the JAX package does (on CUDA an out-of-range
        index would be a device assert)."""
        main = buffers["ptr"][:, ids.clamp(0, self.d1 - 1)]  # (c, ...)
        helper = self._helper_rows(buffers, ids)
        return torch.stack([main, helper], dim=-1)

    def lookup(self, params, buffers, ids):
        """ids (...) -> (..., d2) through the fused lookup: the kernel on a
        CUDA tensor, its plain version on a CPU tensor."""
        rows = self._rows(buffers, ids).reshape(self.c, -1, 2)
        # a per-feature view of a supertable is strided; the kernel reads
        # contiguous tables
        out = kops.cce_lookup(rows, params["tables"].contiguous())  # (n, c*dsub)
        return out.reshape(*ids.shape, self.d2)

    def logits(self, params, buffers, h):
        """Factored output head: per column a k-sized matmul and an integer
        gather over the whole vocabulary,

            logits[..., v] = sum_i scores_i[..., ptr_i(v)] + scores_i[..., k + h'_i(v)]

        with scores_i = h_col_i @ [M_i; M'_i]^T (..., 2k).  Adds main then
        helper, column by column, in the dtype h and the tables promote to:
        the JAX package's order, so float32 agrees with it."""
        return self.logits_from_scores(buffers, self.logit_scores(params, h))

    def logit_scores(self, params, h):
        """The head's k-sized products, column by column: column i's
        ``h_col_i @ [M_i; M'_i]^T`` (..., 2k), made as the caller takes it
        (a generator, so that ``logits`` holds one column's products at a
        time).  ``params["tables"]`` may hold a slice of the dsub axis (c,
        2, k, dsub/M) and ``h`` the same slice of each column (..., c *
        dsub/M): the scores are then that slice's partial sums (the
        tensor-parallel head stacks them and adds them over the ranks)."""
        tables = params["tables"]
        ds = tables.shape[-1]
        hc = h.reshape(*h.shape[:-1], self.c, ds)
        return (emb_lib.promote_matmul(hc[..., i, :], tables[i].reshape(2 * self.k, ds).T)
                for i in range(self.c))

    def logits_from_scores(self, buffers, scores):
        """The c columns' (..., 2k) scores, in column order -> (..., d1)
        logits: per column the main and the helper row's score gathered over
        the vocabulary and added."""
        rows = None
        out = None
        for i, s in enumerate(scores):
            if rows is None:
                rows = self._rows(buffers, torch.arange(self.d1, device=s.device)).to(torch.int64)
            main = s[..., rows[i, :, 0]]
            out = main if out is None else out + main
            out = out + s[..., self.k + rows[i, :, 1]]
        return out

    def sketch_matrix(self, buffers) -> np.ndarray:
        """Dense H (d1, c*2k) for tests: one 1 per (column, table) block."""
        rows = self._rows(buffers, torch.arange(self.d1, device=buffers["ptr"].device))
        rows = rows.cpu().numpy()  # (c, d1, 2)
        H = np.zeros((self.d1, self.c * 2 * self.k), np.float32)
        ids = np.arange(self.d1)
        for i in range(self.c):
            base = i * 2 * self.k
            H[ids, base + rows[i, :, 0]] = 1.0
            H[ids, base + self.k + rows[i, :, 1]] += 1.0
        return H

    # --- the clustering transition (Alg. 3 lines 10-17) ------------------
    #
    # Every step takes an optional process ``group`` of M ranks (DESIGN.md
    # section 9; the JAX package's ``*_sharded`` methods).  Over a group the
    # pointer table is ID-SHARDED in the transition's compute layout: rank r
    # holds ``ptr_tile``, the ids ``[r*d1_loc, (r+1)*d1_loc)`` of
    # ``_ptr_padded(ptr, M*d1_loc)`` (d1_loc = ceil(d1/M)), and no rank
    # holds the whole pointer table.  With no group ``buffers["ptr"]`` is
    # the whole table (the one tile of a group of one) and no collective
    # runs.  The (c, 2, k, dsub) tables, ``hs`` and ``epoch`` are whole on
    # every rank.  On one rank a group changes no bit: the same chunks, the
    # same addition order, identity collectives.

    def d1_loc(self, n_shards: int) -> int:
        return -(-self.d1 // n_shards)

    def _ptr_padded(self, ptr, d1_pad: int):
        """(c, d1) -> (c, d1_pad), the tail repeating the last column so an
        even id shard exists; padded entries are masked out or produce
        row-wise duplicates that change no result."""
        if d1_pad > self.d1:
            ptr = torch.cat([ptr, ptr[:, -1:].expand(-1, d1_pad - self.d1)], dim=1)
        return ptr

    def ptr_tile(self, ptr, rank: int, n_shards: int):
        """Rank ``rank``'s (c, d1_loc) compute tile of a whole (c, d1) ptr."""
        n = self.d1_loc(n_shards)
        return self._ptr_padded(ptr, n * n_shards)[:, rank * n: (rank + 1) * n].contiguous()

    def _local_ids(self, group, device):
        """(ids, valid) of this rank's tile: its id range, clamped to d1-1
        past the vocabulary, and which of them are real ids."""
        rank, M = shard.rank_and_size(group)
        n = self.d1_loc(M)
        ids = torch.arange(rank * n, (rank + 1) * n, device=device)
        return ids.clamp(max=self.d1 - 1), ids < self.d1

    def materialize(self, params, buffers, ids, group=None):
        """Current embeddings of any (scattered) 1-d ``ids``, per column:
        (c, n, dsub), main row + helper row in the table dtype.  Over a
        group each rank gathers the main rows of the ids its tile owns,
        zeros the rest, and an all-reduce assembles them on every rank
        (exactly one non-zero term per id, so the sum is exact in any
        order); the helper part needs only ``hs``.  The ptr gather clamps
        out-of-range ids."""
        tabs = params["tables"]
        col = torch.arange(self.c, device=tabs.device)[:, None]
        ptr = buffers["ptr"]
        if group is None:
            main = tabs[col, 0, ptr[:, ids.clamp(0, self.d1 - 1)].to(torch.int64)]
        else:
            rank, M = shard.rank_and_size(group)
            n = self.d1_loc(M)
            lo = rank * n
            owned = (ids >= lo) & (ids < lo + n)
            main = tabs[col, 0, ptr[:, (ids - lo).clamp(0, n - 1)].to(torch.int64)]
            main = torch.where(owned[None, :, None], main, 0).contiguous()
            main = shard.all_reduce_(main, group)
        return main + tabs[col, 1, self._helper_rows(buffers, ids).to(torch.int64)]

    def assign_all(self, params, buffers, centroids, *, group=None,
                   chunk_size: int | None = None, use_kernel: bool | None = None):
        """Single-pass nearest-centroid assignment of every id of this
        rank's tile (the whole vocabulary with no group).

        ``centroids`` (c, k, dsub) -> (c, d1_loc) int32, the new pointer
        tile.  The ids are materialized once, in ``chunk_size`` slices,
        each assigned for all c columns by ``km.assign_chunks`` (one
        ``kmeans_assign_batched`` launch a chunk when ``use_kernel``, by
        default on a CUDA device).  The tail's clamped ids are row-wise
        duplicates and change nothing."""
        n = self.d1_loc(shard.rank_and_size(group)[1])
        ids, _ = self._local_ids(group, centroids.device)
        ptr, hs = buffers["ptr"], buffers["hs"]
        tabs = params["tables"]
        col = torch.arange(self.c, device=tabs.device)[:, None]
        step = chunk_size if chunk_size and chunk_size < n else n

        def chunks():
            for s in range(0, n, step):
                main = tabs[col, 0, ptr[:, s: s + step].to(torch.int64)]
                helper = tabs[col, 1, self._helper_rows({"hs": hs}, ids[s: s + step])
                              .to(torch.int64)]
                yield s, main + helper  # (c, n_chunk, dsub)

        out = torch.empty((self.c, n), dtype=torch.int32, device=centroids.device)
        return km.assign_chunks(chunks(), centroids, out, use_kernel=use_kernel)

    def _finish_transition(self, key, centroids, assignments, buffers):
        """Install centroids as the main tables, zero the helper tables
        (Alg. 3 line 17), draw fresh helper hashes, advance the epoch."""
        tables = torch.stack(
            [centroids.to(self.dtype), torch.zeros_like(centroids, dtype=self.dtype)], dim=1
        )  # (c, 2, k, dsub)
        hs = hashing.pack_hashes(
            hashing.make_hashes(hashing._seed_of(jr.fold_in(key, 777)), self.c, self.k)
        )
        new_buffers = {
            "ptr": assignments,
            "hs": torch.from_numpy(hs.astype(np.int64)).to(centroids.device),
            "epoch": torch.as_tensor(buffers["epoch"], dtype=torch.int32,
                                     device=centroids.device) + 1,
        }
        return {"tables": tables}, new_buffers

    def cluster(self, key, params, buffers, *, group=None, sample_ids=None,
                sample_weights=None, niter: int = 50, max_points_per_centroid: int = 256,
                chunk_size: int | None = None, use_kernel: bool | None = None):
        """One CCE iteration: returns new (params, buffers), ``ptr`` the new
        tile (with no group, the whole table).

        K-means runs on a sample (FAISS-style, 256 points per centroid by
        default), every column in lockstep (``km.kmeans_columns``); over a
        group the sample is split evenly over the ranks, the remainder of
        fewer than M points dropped, as the JAX package drops it.  The
        assignments of the FULL vocabulary are then one materialization
        pass shared by all columns (``assign_all``).  ``sample_weights``
        (aligned with ``sample_ids``) runs count-weighted k-means: each
        observed id once, weighted by its frequency.  The key schedule is
        the JAX package's, so ``hs`` and ``epoch`` match it bit for bit."""
        rank, M = shard.rank_and_size(group)
        device = params["tables"].device
        k1, k2 = jr.split(jr.fold_in(key, int(buffers["epoch"])))
        if sample_ids is None:
            sample_ids = km.subsample(k1, self.d1, self.k, max_points_per_centroid,
                                      device=device)
        n = sample_ids.shape[0] - sample_ids.shape[0] % M
        sample = self.materialize(params, buffers, sample_ids[:n], group)  # (c, n, dsub)
        n_loc = n // M
        mine = slice(rank * n_loc, (rank + 1) * n_loc)
        w = None if sample_weights is None else sample_weights[:n][mine]
        centroids = km.kmeans_columns(
            [jr.fold_in(k2, i) for i in range(self.c)], sample[:, mine], self.k, group,
            niter=niter, weights=w)  # (c, k, dsub), equal on every rank
        new_ptr = self.assign_all(params, buffers, centroids, group=group,
                                  chunk_size=chunk_size, use_kernel=use_kernel)
        return self._finish_transition(k2, centroids, new_ptr, buffers)

    def remap_moments(self, moments, old_buffers, new_buffers, *, group=None,
                      chunk_size=None, id_weights=None):
        """Carry per-row optimizer moments (momentum / Adam m, v) through a
        ``cluster()`` transition; both pointer tables are this rank's tiles.

        ``moments`` mirrors params ({"tables": (c, 2, k, dsub)}) and
        describes the OLD rows.  An id's virtual moment is its materialized
        row-sum under the OLD pointers; each new main row takes the mean
        over the ids assigned to it (count-weighted by ``id_weights``, the
        whole (d1,) vector, when given, falling back to the uniform mean
        for clusters of zero weight); the fresh helper table starts at
        zero.  Each rank streams its tile in ``chunk_size`` slices,
        segment-summing (deterministic) into (c, k) accumulators, with the
        per-cluster id counts (exact: sums of ones), and one all-reduce
        assembles them.  The tail padding is masked (weight zero), not
        clamped: a duplicate would be counted twice."""
        rank, M = shard.rank_and_size(group)
        mt = moments["tables"]
        c, k, dsub = self.c, self.k, self.dsub
        dev = mt.device
        n = self.d1_loc(M)
        ids, valid = self._local_ids(group, dev)
        v = valid.to(torch.float32)
        old_ptr, new_ptr = old_buffers["ptr"], new_buffers["ptr"]
        weighted = id_weights is not None
        if weighted:
            w_pad = torch.zeros(n * M, dtype=torch.float32, device=dev)
            w_pad[: self.d1] = id_weights.to(torch.float32)
            w_loc = w_pad[rank * n: (rank + 1) * n]
        col = torch.arange(c, device=dev)[:, None]
        sums = torch.zeros((c, k, dsub), dtype=torch.float32, device=dev)
        cnts = torch.zeros((c, k), dtype=torch.float32, device=dev)
        wsums = torch.zeros_like(sums)
        wcounts = torch.zeros_like(cnts)
        step = chunk_size if chunk_size and chunk_size < n else n
        for s in range(0, n, step):
            ids_c, v_c = ids[s: s + step], v[s: s + step]
            m = ids_c.shape[0]
            main = mt[col, 0, old_ptr[:, s: s + step].to(torch.int64)]
            helper = mt[col, 1, self._helper_rows(old_buffers, ids_c).to(torch.int64)]
            per_id = (main + helper).to(torch.float32) * v_c[None, :, None]
            seg = (col * k + new_ptr[:, s: s + step].to(torch.int64)).reshape(-1)
            sums = sums + _segment_sum(per_id.reshape(-1, dsub), seg, c * k).reshape(c, k, dsub)
            cnts = cnts + _segment_sum(v_c.expand(c, m).reshape(-1, 1), seg, c * k).reshape(c, k)
            if weighted:
                w = w_loc[s: s + step] * v_c
                wsums = wsums + _segment_sum(
                    (per_id * w[None, :, None]).reshape(-1, dsub), seg, c * k).reshape(c, k, dsub)
                wcounts = wcounts + _segment_sum(
                    w.expand(c, m).reshape(-1, 1), seg, c * k).reshape(c, k)
        if group is not None:
            acc = shard.all_reduce_(torch.cat([sums.reshape(c, -1), cnts, wsums.reshape(c, -1),
                                         wcounts], dim=1), group)  # one collective
            sums = acc[:, : k * dsub].reshape(c, k, dsub)
            cnts = acc[:, k * dsub: k * dsub + k]
            wsums = acc[:, k * dsub + k: 2 * k * dsub + k].reshape(c, k, dsub)
            wcounts = acc[:, 2 * k * dsub + k:]
        mean = sums / torch.clamp(cnts[..., None], min=1.0)
        if weighted:
            wmean = wsums / torch.clamp(wcounts[..., None], min=1e-12)
            mean = torch.where(wcounts[..., None] > 0, wmean, mean)
        mean = mean.to(mt.dtype)
        return {"tables": torch.stack([mean, torch.zeros_like(mean)], dim=1)}
