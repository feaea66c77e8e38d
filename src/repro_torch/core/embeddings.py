"""Embedding-table methods of the paper's Section 2 that this port
carries so far: the uncompressed ``FullTable`` and (in ``core/cce.py``)
CCE.  Each is a frozen config with functional state:

    table.init(generator, device)          -> (params, buffers)
    table.lookup(params, buffers, ids)     -> (..., d2) embeddings

plus the ``FuseSpec`` protocol through which the collection fuses every
gather-sum table into one supertable (``core/collection.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch


class FuseSpec(NamedTuple):
    """A table's natural shape inside the universal supertable: ``cols``
    columns of ``n_tables`` stacked (k, dsub) sub-tables, looked up as
    ``sum_t tab[t][rows[:, t]]`` per column."""

    cols: int
    n_tables: int
    k: int
    dsub: int


@dataclasses.dataclass(frozen=True)
class FullTable:
    """The uncompressed baseline: one row per id."""

    d1: int
    d2: int
    dtype: Any = torch.float32

    @property
    def n_params(self) -> int:
        return self.d1 * self.d2

    def init_buffers(self):
        return {}

    def init(self, generator: torch.Generator, device="cuda"):
        scale = 1.0 / math.sqrt(self.d2)
        table = torch.randn((self.d1, self.d2), generator=generator,
                            device=generator.device) * scale
        return {"table": table.to(device=device, dtype=self.dtype)}, {}

    def lookup(self, params, buffers, ids):
        return params["table"][ids.clamp(0, self.d1 - 1)]

    def logits(self, params, buffers, h):
        """Output head over the whole vocabulary: ``h @ table.T`` (...,
        d1), in the dtype the two promote to (as jnp promotes)."""
        return promote_matmul(h, params["table"].T)

    # --- the padded gather of full-table groups -------------------------

    @staticmethod
    def stack_many(tables, params_seq):
        """Per-feature {"table": (d1_f, d2)} -> {"table": (F, max d1_f, d2)},
        zero-padding the row axis."""
        d1_pad = max(t.d1 for t in tables)
        return {
            "table": torch.stack(
                [
                    torch.nn.functional.pad(p["table"], (0, 0, 0, d1_pad - t.d1))
                    for t, p in zip(tables, params_seq)
                ]
            )
        }

    @staticmethod
    def unstack_many(tables, group_params):
        return [
            {"table": group_params["table"][f, : t.d1]}
            for f, t in enumerate(tables)
        ]

    @staticmethod
    def lookup_many(tables, group_params, buffers_seq, ids):
        """ONE padded gather for the group: ids (B, F) -> (B, F, d2), each
        id clamped to its own feature's vocab."""
        F = len(tables)
        caps = torch.tensor([t.d1 - 1 for t in tables], device=ids.device)
        ids = torch.minimum(ids.clamp(min=0), caps[None, :])
        return group_params["table"][torch.arange(F, device=ids.device)[None, :], ids]

    # --- universal fusion -----------------------------------------------

    @property
    def fuse_spec(self) -> FuseSpec:
        """One column whose codebook IS the table (identity rows)."""
        return FuseSpec(cols=1, n_tables=1, k=self.d1, dsub=self.d2)

    def group_signature(self):
        return ("full", self.d2, str(self.dtype))

    def fuse_slab(self, params):
        return params["table"][None, None]  # (1, 1, d1, d2)

    def unfuse_slab(self, slab):
        return {"table": slab[0, 0]}

    def fuse_rows(self, buffers, ids):
        return ids.clamp(0, self.d1 - 1).to(torch.int32)[None, :, None]

    def fuse_rows_np(self, buffers, ids):
        return np.clip(np.asarray(ids), 0, self.d1 - 1).astype(np.int32)[None, :, None]


def promote_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the dtype the two promote to: jnp promotes a bf16 by
    f32 product to f32, while ``torch.matmul`` refuses mixed dtypes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def make_table(method: str, d1: int, d2: int, budget: int | None = None, **kw):
    """Factory for the methods the port carries: "full" and "cce"."""
    if method == "cce":
        from repro_torch.core.cce import CCE

        return CCE.from_budget(d1, d2, budget, **kw)
    if method == "full":
        kw.pop("c", None)
        kw.pop("seed_salt", None)
        return FullTable(d1, d2, **kw)
    raise ValueError(f"table method {method!r} is not ported yet (only 'full' and 'cce')")
