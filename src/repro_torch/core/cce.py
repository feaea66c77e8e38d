"""Clustered Compositional Embeddings (Algorithm 3 of the paper): state,
buffer init, row translation, the fused lookup and the clustering
transition (``cluster``, single-device).

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
        tables = torch.randn((self.c, 2, self.k, self.dsub), generator=generator) * scale
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

    # --- the clustering transition (Alg. 3 lines 10-17) ------------------

    def materialize(self, params, buffers, ids):
        """Current embeddings of 1-d ``ids``, per column: (c, n, dsub)
        (main row + helper row, in the table dtype)."""
        rows = self._rows(buffers, ids).to(torch.int64)  # (c, n, 2)
        tabs = params["tables"]
        col = torch.arange(self.c, device=tabs.device)[:, None]
        return tabs[col, 0, rows[..., 0]] + tabs[col, 1, rows[..., 1]]

    def _id_chunks(self, chunk_size: int | None, device):
        """Full-vocab id ranges as (first id, ids): one range when
        unchunked, else a stream of ``chunk_size`` slices so (c, d1, dsub)
        is never materialized."""
        step = chunk_size if chunk_size and chunk_size < self.d1 else self.d1
        for s in range(0, self.d1, step):
            yield s, torch.arange(s, min(s + step, self.d1), device=device)

    def assign_all(self, params, buffers, centroids, *, chunk_size: int | None = None,
                   use_kernel: bool | None = None) -> torch.Tensor:
        """Single-pass full-vocab nearest-centroid assignment.

        ``centroids`` (c, k, dsub) -> (c, d1) int32.  The vocabulary is
        materialized once, in ``chunk_size`` id slices; per chunk and
        column the assignment routes through ``kops.kmeans_assign`` when
        ``use_kernel`` (default: on a CUDA device, as the JAX package takes
        its kernel on the TPU).  Chunking cannot change an argmin: each
        point's distances are its own."""
        device = centroids.device
        if use_kernel is None:
            use_kernel = device.type == "cuda"
        out = torch.empty((self.c, self.d1), dtype=torch.int32, device=device)
        for s, ids in self._id_chunks(chunk_size, device):
            emb = self.materialize(params, buffers, ids)  # (c, n, dsub)
            for i in range(self.c):
                out[i, s: s + ids.shape[0]] = km.assign(
                    emb[i], centroids[i], use_kernel=use_kernel)
        return out

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

    def cluster(self, key, params, buffers, *, sample_ids=None, sample_weights=None,
                niter: int = 50, max_points_per_centroid: int = 256,
                chunk_size: int | None = None, use_kernel: bool | None = None):
        """One CCE iteration: returns new (params, buffers).

        K-means runs on a sample (FAISS-style, 256 points per centroid by
        default); the assignments of the FULL vocabulary are then one
        materialization pass shared by all columns (``assign_all``).
        ``sample_weights`` (aligned with ``sample_ids``) runs count-weighted
        k-means: each observed id once, weighted by its frequency.  The key
        schedule is the JAX package's, so ``hs`` and ``epoch`` match it bit
        for bit."""
        device = params["tables"].device
        k1, k2 = jr.split(jr.fold_in(key, int(buffers["epoch"])))
        if sample_ids is None:
            sample_ids = km.subsample(k1, self.d1, self.k, max_points_per_centroid,
                                      device=device)
        sample = self.materialize(params, buffers, sample_ids)  # (c, n, dsub)
        centroids = torch.stack([
            km.kmeans(jr.fold_in(k2, i), sample[i], self.k, niter=niter,
                      weights=sample_weights).centroids
            for i in range(self.c)
        ])  # (c, k, dsub)
        new_ptr = self.assign_all(params, buffers, centroids, chunk_size=chunk_size,
                                  use_kernel=use_kernel)
        return self._finish_transition(k2, centroids, new_ptr, buffers)

    def assignment_counts(self, buffers) -> torch.Tensor:
        """Per-cluster id counts (c, k) float32 from the pointer table."""
        return torch.stack(
            [torch.bincount(a, minlength=self.k) for a in buffers["ptr"]]
        ).to(torch.float32)

    def remap_moments(self, moments, old_buffers, new_buffers, *, chunk_size=None,
                      counts=None, id_weights=None):
        """Carry per-row optimizer moments (momentum / Adam m, v) through a
        ``cluster()`` transition.

        ``moments`` mirrors params ({"tables": (c, 2, k, dsub)}) and
        describes the OLD rows.  An id's virtual moment is its materialized
        row-sum under the OLD pointers; each new main row takes the mean
        over the ids assigned to it (count-weighted by ``id_weights`` (d1,)
        when given, falling back to the uniform mean for clusters of zero
        weight); the fresh helper table starts at zero.  Streams the vocab
        in ``chunk_size`` slices; the segment sums are deterministic."""
        mt = moments["tables"]
        new_ptr = new_buffers["ptr"]
        if counts is None:
            counts = self.assignment_counts(new_buffers)  # (c, k)
        c, k, dsub = self.c, self.k, self.dsub
        dev = mt.device
        sums = torch.zeros((c, k, dsub), dtype=torch.float32, device=dev)
        wsums = torch.zeros_like(sums)
        wcounts = torch.zeros((c, k), dtype=torch.float32, device=dev)
        col = torch.arange(c, device=dev)[:, None] * k
        for _, ids in self._id_chunks(chunk_size, dev):
            n = ids.shape[0]
            per_id = self.materialize({"tables": mt}, old_buffers, ids).to(torch.float32)
            seg = (col + new_ptr[:, ids].to(torch.int64)).reshape(-1)  # (c*n,)
            sums = sums + _segment_sum(per_id.reshape(-1, dsub), seg, c * k).reshape(c, k, dsub)
            if id_weights is not None:
                w = id_weights[ids].to(torch.float32)  # (n,)
                wsums = wsums + _segment_sum(
                    (per_id * w[None, :, None]).reshape(-1, dsub), seg, c * k
                ).reshape(c, k, dsub)
                wcounts = wcounts + _segment_sum(
                    w.expand(c, n).reshape(-1, 1), seg, c * k).reshape(c, k)
        mean = sums / torch.clamp(counts[..., None], min=1.0)
        if id_weights is not None:
            wmean = wsums / torch.clamp(wcounts[..., None], min=1e-12)
            mean = torch.where(wcounts[..., None] > 0, wmean, mean)
        mean = mean.to(mt.dtype)
        return {"tables": torch.stack([mean, torch.zeros_like(mean)], dim=1)}
