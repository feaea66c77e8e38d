"""Host-side pointer translation: raw ids -> supertable rows on the host.

Every table's row function has a numpy twin (``table.fuse_rows_np``:
learned-pointer gather + ``multiply_shift_np`` helper hash for CCE,
clamped identity for fused full tables), so a translated batch ships ONE
int32 tensor

    rows : (B, collection.rows_n_cols, collection.rows_n_tables)

and the device never gathers the (c, d1) pointer tables
(``EmbeddingCollection.lookup_all(rows=...)``).  ``-1`` marks padded
sub-table slots; the lookup treats them as no-ops.

The mirrors are snapshots: after a clustering transition or a restore,
``HostTranslator.update(emb_buffers)`` must run before translating more
batches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.collection import EmbeddingCollection, _expand_rows, bucket_rows


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class HostTranslator:
    """ids -> supertable rows on the host, bit-exact with the device path.

    With ``n_shards=M`` each universal group's rows are bucketed by owning
    model shard (shard ``s`` owns codebook rows ``[s*k_pad/M,
    (s+1)*k_pad/M)``) and ``rows()`` emits shard-local indices
    (B, M, rows_n_cols, rows_n_tables)."""

    def __init__(self, collection: EmbeddingCollection, emb_buffers=None,
                 *, n_shards: int = 1):
        self.collection = collection
        self.n_shards = int(n_shards)
        for g in collection.univ_groups:
            grp = collection.groups[g]
            if grp.k_pad % self.n_shards:
                raise ValueError(
                    f"group {g}: k_pad {grp.k_pad} not divisible by "
                    f"n_shards {n_shards}; build the collection with "
                    f"k_multiple={n_shards}"
                )
        self._buffers = None
        if emb_buffers is not None:
            self.update(emb_buffers)

    def update(self, emb_buffers) -> None:
        """Refresh the host mirrors (numpy copies of every buffer the row
        functions read; the pointer tables' device->host copy is the
        point: afterwards the device never touches them)."""
        self._buffers = [
            [{k: _host(v) for k, v in feat.items()} for feat in emb_buffers[g]]
            if grp.kind == "univ" else emb_buffers[g]
            for g, grp in enumerate(self.collection.groups)
        ]

    def rows(self, sparse: np.ndarray) -> np.ndarray:
        """(B, n_features) raw ids -> (B, rows_n_cols, rows_n_tables)
        int32 rows, or (B, M, rows_n_cols, rows_n_tables) shard-local
        rows with ``n_shards=M`` > 1."""
        if self._buffers is None:
            raise RuntimeError("HostTranslator.update(emb_buffers) first")
        coll = self.collection
        M = self.n_shards
        sparse = np.asarray(sparse)
        T = coll.rows_n_tables
        blocks = []
        for g in coll.univ_groups:
            grp = coll.groups[g]
            grows = np.concatenate(
                [
                    _expand_rows(
                        t.fuse_rows_np(self._buffers[g][f], sparse[:, i]),
                        grp.col_counts[f] // t.fuse_spec.cols,
                        grp.n_tables,
                    )
                    for f, (i, t) in enumerate(zip(grp.features, grp.tables))
                ],
                axis=0,
            )  # (n_cols, B, T_g)
            if grows.shape[-1] < T:
                pad = np.full(grows.shape[:-1] + (T - grows.shape[-1],), -1, np.int32)
                grows = np.concatenate([grows, pad], axis=-1)
            if M > 1:
                grows = bucket_rows(grows, grp.k_pad // M, M)  # (M, n_cols, B, T)
            blocks.append(grows)
        rows = np.concatenate(blocks, axis=-3)
        if M > 1:
            return np.moveaxis(rows, (0, 1, 2), (1, 2, 0)).astype(np.int32)
        return np.moveaxis(rows, 0, 1).astype(np.int32)

    def rows_masked(self, sparse: np.ndarray, skip: np.ndarray) -> np.ndarray:
        """Translate like :meth:`rows`, then set every column of a skipped
        (batch element, feature) pair to the ``-1`` sentinel.  ``skip``
        (B, n_features) bool is True where the serve cache already holds
        the embedding, so the lookup does no work for it.  Single-shard
        only."""
        if self.n_shards != 1:
            raise ValueError(
                "rows_masked is a serve-path helper; it does not emit "
                f"shard-bucketed rows (n_shards={self.n_shards})"
            )
        rows = self.rows(sparse)
        m = np.asarray(skip, bool)[:, self.collection.rows_col_feature]
        return np.where(m[:, :, None], np.int32(-1), rows)

    def __call__(self, batch: dict, *, drop_sparse: bool = False) -> dict:
        """Translate one batch dict: adds ``rows``; ``drop_sparse=True``
        removes the raw ids (only when every table is universally fused,
        since full groups still read them)."""
        if drop_sparse:
            unfused = sorted({g.kind for g in self.collection.groups if g.kind != "univ"})
            if unfused:
                raise ValueError(
                    "drop_sparse=True needs every table universally fused; "
                    f"this collection still has {unfused} groups that consume raw ids"
                )
        out = dict(batch, rows=self.rows(batch["sparse"]))
        if drop_sparse:
            del out["sparse"]
        return out


def translate_batches(batches, translator: HostTranslator, *, drop_sparse: bool = False):
    """Wrap a batch iterator with the host translation stage."""
    for batch in batches:
        yield translator(batch, drop_sparse=drop_sparse)
