"""Clustered Compositional Embeddings (Algorithm 3 of the paper), the
lookup half: state, buffer init, row translation and the fused lookup.
The clustering transition is ported in a later slice.

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import embeddings as emb_lib
from repro_torch.core import hashing
from repro_torch.kernels import ops as kops


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
