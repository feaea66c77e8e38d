"""EmbeddingCollection -- grouped supertables for multi-feature models.

Every table whose lookup is a per-column gather-sum (``fuse_spec``: CCE,
CE, the hashing trick and small full tables) stacks into ONE universal
supertable (total cols, T, max k_f, dsub) per dtype, looked up by ONE
fused ``kops.cce_lookup`` launch.  Tables with different natural column
widths split into sub-columns of the group gcd; tables with fewer than T
sub-tables pad their row tensor with the ``-1`` sentinel, which
contributes exactly zero.  Big full tables, which the waste bound keeps
out of the supertable, batch into one padded (F, max d1, d2) gather.
Tables without a ``fuse_spec`` (hash embeddings, ROBE, DHE, TT-Rec) take
one "loop" group each: their own lookup, feature by feature.

State layout (the JAX package's "grouped layout"):

    params["emb"]  : [group_params, ...]         one entry per group
    buffers["emb"] : [[feat_buffers, ...], ...]  per group, per feature

Model-parallel (DESIGN.md section 9): with a process group of M ranks each
rank holds a k-slice of every universal supertable, and ``lookup_all(...,
group=)`` routes each id to its owning rank by all-to-all
(``_univ_lookup_sharded``).  ``legacy_layout_migration`` and
``grouped_layout_migration`` restore checkpoints of other layouts (the
per-feature one, the pre-universal grouping, another ``k_multiple``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import embeddings as emb_lib
from repro_torch.core.cce import CCE
from repro_torch.kernels import ops as kops

#: Sub-partition a "full" group when padding every table to the group max
#: would blow past this multiple of the smallest table in the bucket.
FULL_PAD_RATIO = 8

#: A universal supertable may cost at most this multiple of its members'
#: natural parameter count; buckets split greedily (largest k first).
UNIV_PAD_WASTE = 3.5

#: Each member's padded slab must also stay within UNIV_PAD_WASTE of its
#: own natural size, unless it is below this many elements.
UNIV_PAD_SLACK_ELEMS = 1 << 20


@dataclasses.dataclass(frozen=True)
class TableGroup:
    kind: str  # "univ" | "full" | "loop"
    features: tuple[int, ...]  # global feature indices, ascending
    tables: tuple[Any, ...]  # the features' method objects, same order
    # universal groups only: the shared sub-column width (gcd of member
    # natural dsubs) and stacked-table count (max member n_tables)
    dsub: int | None = None
    n_tables: int | None = None
    #: round the codebook axis up to a multiple of this (the model-shard
    #: count of a sharded layout); extra rows are zero and unreachable
    k_multiple: int = 1

    @functools.cached_property
    def col_counts(self) -> tuple[int, ...]:
        """Supertable columns per feature (natural cols x dsub split)."""
        return tuple(
            t.fuse_spec.cols * (t.fuse_spec.dsub // self.dsub) for t in self.tables
        )

    @property
    def n_cols(self) -> int:
        return sum(self.col_counts)

    @property
    def k_pad(self) -> int:
        k = max(t.fuse_spec.k for t in self.tables)
        return -(-k // self.k_multiple) * self.k_multiple


# --- universal-slab plumbing --------------------------------------------------


def _split_slab(nat: torch.Tensor, dsub: int, n_tables: int) -> torch.Tensor:
    """Natural (c, T, k, d) slab -> group layout (c*s, T_g, k, dsub): each
    column splits into s = d/dsub sub-columns, missing sub-tables are
    zero-padded."""
    c, T, k, d = nat.shape
    s = d // dsub
    x = nat.reshape(c, T, k, s, dsub).movedim(3, 1).reshape(c * s, T, k, dsub)
    if T < n_tables:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n_tables - T))
    return x


def _merge_slab(slab: torch.Tensor, spec: emb_lib.FuseSpec, dsub: int) -> torch.Tensor:
    """Inverse of ``_split_slab`` (slab already sliced to the feature's k)."""
    s = spec.dsub // dsub
    x = slab[:, : spec.n_tables]
    x = x.reshape(spec.cols, s, spec.n_tables, x.shape[2], dsub)
    return x.movedim(1, 3).reshape(spec.cols, spec.n_tables, x.shape[3], spec.dsub)


def _expand_rows(rows, s: int, n_tables: int):
    """Natural (c, B, T) rows -> group (c*s, B, T_g): sub-columns share
    their parent column's rows; padded T slots get the -1 sentinel.
    ``rows`` is a numpy array (host translation) or a tensor (device),
    with bit-identical results."""
    T = rows.shape[-1]
    if isinstance(rows, torch.Tensor):
        if s > 1:
            rows = rows.repeat_interleave(s, dim=0)
        if T < n_tables:
            pad = rows.new_full(rows.shape[:-1] + (n_tables - T,), -1)
            rows = torch.cat([rows, pad], dim=-1)
        return rows
    if s > 1:
        rows = np.repeat(rows, s, axis=0)
    if T < n_tables:
        pad = np.full(rows.shape[:-1] + (n_tables - T,), -1, rows.dtype)
        rows = np.concatenate([rows, pad], axis=-1)
    return rows


def bucket_rows(rows, k_loc: int, n_shards: int):
    """Route global rows (with the -1 sentinel) to their owning model
    shard: (n_shards, *rows.shape) int32, bucket ``s`` holding shard-local
    indices for the rows in ``[s*k_loc, (s+1)*k_loc)`` and -1 elsewhere,
    so each valid row lands in exactly one bucket.  ``rows`` is a numpy
    array (host translation) or a tensor (in-step bucketing), with
    bit-identical results."""
    owner = rows // k_loc
    if isinstance(rows, torch.Tensor):
        return torch.stack(
            [torch.where((rows >= 0) & (owner == s), rows - s * k_loc, -1)
             for s in range(n_shards)]
        ).to(torch.int32)
    return np.stack(
        [np.where((rows >= 0) & (owner == s), rows - s * k_loc, -1)
         for s in range(n_shards)]
    ).astype(np.int32)


def _gcd_all(vals) -> int:
    return functools.reduce(math.gcd, vals)


@dataclasses.dataclass(frozen=True)
class EmbeddingCollection:
    tables: tuple[Any, ...]
    groups: tuple[TableGroup, ...]

    # --- construction ----------------------------------------------------

    @classmethod
    def build(cls, tables: Sequence[Any], mode: str = "univ",
              k_multiple: int = 1) -> "EmbeddingCollection":
        """``mode``:
        * "univ" (default): universal fusion, every gather-sum table
          (``fuse_spec``) joins one waste-bounded supertable per dtype;
          full-only buckets keep the padded gather; the rest loop.
        * "group": the JAX package's pre-universal grouping (one
          supertable per CCE signature, padded full-gather buckets, a
          loop group for every other table), in its historical order.
        * "loop": one loop group per feature.

        ``k_multiple`` rounds every universal group's ``k_pad`` up; the
        "group" and "loop" layouts ignore it, as the JAX package does."""
        tables = tuple(tables)
        if mode == "loop":
            return cls(tables, tuple(TableGroup("loop", (i,), (t,)) for i, t in enumerate(tables)))
        if mode not in ("univ", "group"):
            raise ValueError(f"unknown collection mode {mode!r}")
        legacy: list[int] = []  # features grouped by the pre-universal rules
        groups: list[TableGroup] = []
        if mode == "univ":
            fusable: dict[str, list[int]] = {}
            for i, t in enumerate(tables):
                if hasattr(t, "fuse_spec"):
                    fusable.setdefault(str(t.dtype), []).append(i)
                else:
                    legacy.append(i)
            for feats in fusable.values():
                for bucket in cls._partition_univ(feats, tables):
                    if all(isinstance(tables[i], emb_lib.FullTable) for i in bucket):
                        legacy.extend(bucket)
                        continue
                    groups.append(cls._univ_group(sorted(bucket), tables, k_multiple))
        else:
            legacy = list(range(len(tables)))
        by_sig: dict[Any, list[int]] = {}
        for i in legacy:
            t = tables[i]
            if mode == "group" and isinstance(t, CCE):
                sig = ("cce", t.c, t.dsub, str(t.dtype))
            elif isinstance(t, emb_lib.FullTable):
                sig = t.group_signature()
            else:
                sig = ("loop", i)
            by_sig.setdefault(sig, []).append(i)
        for sig, feats in by_sig.items():  # insertion order: first feature
            if sig[0] == "cce":
                groups.append(cls._univ_group(feats, tables, 1))
                continue
            kind = "full" if sig[0] == "full" else "loop"
            for bucket in cls._partition(kind, feats, tables):
                groups.append(TableGroup(kind, tuple(bucket), tuple(tables[i] for i in bucket)))
        if mode == "univ":
            groups.sort(key=lambda g: g.features[0])
        return cls(tables, tuple(groups))

    @staticmethod
    def _univ_group(members, tables, k_multiple: int) -> TableGroup:
        specs = [tables[i].fuse_spec for i in members]
        return TableGroup(
            "univ", tuple(members), tuple(tables[i] for i in members),
            dsub=_gcd_all(s.dsub for s in specs),
            n_tables=max(s.n_tables for s in specs),
            k_multiple=k_multiple,
        )

    @staticmethod
    def _partition_univ(feats, tables):
        """Split a universal bucket so the padded supertable never costs
        more than ``UNIV_PAD_WASTE`` times the members' natural parameters,
        in aggregate and per member (unless that member's padded slab is
        below ``UNIV_PAD_SLACK_ELEMS``).  Greedy, largest k first."""

        def admits(members):
            specs = [tables[i].fuse_spec for i in members]
            k_pad = max(s.k for s in specs)
            T = max(s.n_tables for s in specs)
            padded = natural = 0
            for s in specs:
                w = s.cols * s.dsub
                p, n = w * T * k_pad, w * s.n_tables * s.k
                if p > UNIV_PAD_WASTE * n and p > UNIV_PAD_SLACK_ELEMS:
                    return False
                padded += p
                natural += n
            return padded <= UNIV_PAD_WASTE * natural

        order = sorted(feats, key=lambda i: (-tables[i].fuse_spec.k, i))
        buckets, cur = [], [order[0]]
        for i in order[1:]:
            if admits(cur + [i]):
                cur.append(i)
            else:
                buckets.append(cur)
                cur = [i]
        buckets.append(cur)
        return buckets

    @staticmethod
    def _partition(kind, feats, tables):
        """Split a full-table bucket by d1 ratio (``FULL_PAD_RATIO``); other
        kinds stay whole."""
        if kind != "full" or len(feats) <= 1:
            return [feats]
        feats = sorted(feats, key=lambda i: tables[i].d1)
        buckets, cur = [], [feats[0]]
        for i in feats[1:]:
            if tables[i].d1 > FULL_PAD_RATIO * tables[cur[0]].d1:
                buckets.append(cur)
                cur = [i]
            else:
                cur.append(i)
        buckets.append(cur)
        return buckets

    # --- shape facts ------------------------------------------------------

    @property
    def n_features(self) -> int:
        return len(self.tables)

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    @property
    def n_lookup_launches(self) -> int:
        """Heavy table lookups a forward: one per universal or full group,
        one per feature of a loop group."""
        return sum(len(g.features) if g.kind == "loop" else 1 for g in self.groups)

    @functools.cached_property
    def _locate(self) -> dict[int, tuple[int, int]]:
        """feature index -> (group index, index within group)."""
        return {
            i: (g, f_local)
            for g, grp in enumerate(self.groups)
            for f_local, i in enumerate(grp.features)
        }

    @functools.cached_property
    def univ_groups(self) -> tuple[int, ...]:
        return tuple(g for g, grp in enumerate(self.groups) if grp.kind == "univ")

    @property
    def rows_n_tables(self) -> int:
        """T of the host-translated rows tensor."""
        return max((self.groups[g].n_tables for g in self.univ_groups), default=0)

    @property
    def rows_n_cols(self) -> int:
        """Supertable columns across universal groups: the rows tensor is
        (B, rows_n_cols, rows_n_tables) int32."""
        return sum(self.groups[g].n_cols for g in self.univ_groups)

    @functools.cached_property
    def rows_col_feature(self) -> np.ndarray:
        """(rows_n_cols,) int32: the global feature owning each column of
        the rows tensor, in the order ``rows`` concatenates groups."""
        out = []
        for g in self.univ_groups:
            grp = self.groups[g]
            for f_local, n in enumerate(grp.col_counts):
                out.extend([grp.features[f_local]] * n)
        return np.asarray(out, np.int32)

    # --- init / stacking --------------------------------------------------

    def init(self, generator: torch.Generator, device="cuda"):
        """Per-feature init in feature order from one generator, then
        stack into the grouped layout."""
        per_p, per_b = [], []
        for t in self.tables:
            p, b = t.init(generator, device)
            per_p.append(p)
            per_b.append(b)
        return self.stack_params(per_p), self.stack_buffers(per_b)

    def stack_group_params(self, grp: TableGroup, params_seq):
        if grp.kind == "univ":
            slabs = [
                _split_slab(t.fuse_slab(p), grp.dsub, grp.n_tables)
                for t, p in zip(grp.tables, params_seq)
            ]
            return {"tables": kops.pad_stack_tables(slabs, k_pad=grp.k_pad)}
        if grp.kind == "full":
            return emb_lib.FullTable.stack_many(grp.tables, params_seq)
        return list(params_seq)

    def unstack_group_params(self, grp: TableGroup, group_params):
        if grp.kind == "univ":
            out, off = [], 0
            for t, n in zip(grp.tables, grp.col_counts):
                spec = t.fuse_spec
                slab = group_params["tables"][off : off + n, :, : spec.k, :]
                out.append(t.unfuse_slab(_merge_slab(slab, spec, grp.dsub)))
                off += n
            return out
        if grp.kind == "full":
            return emb_lib.FullTable.unstack_many(grp.tables, group_params)
        return list(group_params)

    def stack_params(self, per_feature):
        """Per-feature params list -> grouped layout."""
        return [
            self.stack_group_params(grp, [per_feature[i] for i in grp.features])
            for grp in self.groups
        ]

    def unstack_params(self, grouped):
        """Grouped layout -> per-feature params list."""
        out = [None] * self.n_features
        for g, grp in enumerate(self.groups):
            for f_local, p in enumerate(self.unstack_group_params(grp, grouped[g])):
                out[grp.features[f_local]] = p
        return out

    def stack_buffers(self, per_feature):
        """Buffers regroup only; they are never stacked."""
        return [[per_feature[i] for i in grp.features] for grp in self.groups]

    def unstack_buffers(self, grouped):
        out = [None] * self.n_features
        for g, grp in enumerate(self.groups):
            for f_local, i in enumerate(grp.features):
                out[i] = grouped[g][f_local]
        return out

    def feature_params(self, emb_params, i: int):
        g, f_local = self._locate[i]
        return self.unstack_group_params(self.groups[g], emb_params[g])[f_local]

    def feature_buffers(self, emb_buffers, i: int):
        g, f_local = self._locate[i]
        return emb_buffers[g][f_local]

    # --- the hot path -----------------------------------------------------

    def group_rows(self, grp: TableGroup, buffers_seq, ids):
        """Device-side row translation for one universal group:
        ids (B, Fg) -> (n_cols, B, T) int32 (ptr gather + helper hash);
        the host twin is ``data.translate.HostTranslator``."""
        return torch.cat(
            [
                _expand_rows(
                    t.fuse_rows(buffers_seq[f], ids[:, f]),
                    grp.col_counts[f] // t.fuse_spec.cols,
                    grp.n_tables,
                )
                for f, t in enumerate(grp.tables)
            ],
            dim=0,
        )

    def _univ_lookup(self, grp: TableGroup, group_params, rows):
        """(n_cols, B, T) rows + supertable -> (B, n_cols*dsub): ONE fused
        lookup (the kernel on CUDA tensors)."""
        return kops.cce_lookup(rows, group_params["tables"])

    def _univ_lookup_sharded(self, grp: TableGroup, group_params, rows, group):
        """Model-parallel universal lookup.  This rank holds codebook rows
        ``[r*k_loc, (r+1)*k_loc)`` of the supertable (``group_params
        ["tables"]`` is its (n_cols, T, k_loc, dsub) slice) and a
        contiguous slice of the batch; ``rows`` are its batch rows, global
        (B_loc, n_cols, T) or pre-bucketed shard-local (B_loc, M, n_cols, T)
        (``HostTranslator(n_shards=M)``).

        Bucket, all-to-all (each rank receives the rows it owns from every
        rank's batch slice, in rank order, so its received batch is the
        global batch in order), ONE local lookup launch over them (rows
        another rank owns are the -1 sentinel: exact-zero partials),
        all-to-all back, sum over ranks.  Each output sums the T rows of
        its column and at most T ranks contribute non-zero partials, so
        with T <= 2 the forward equals the unsharded launch bit for bit.
        The backward runs the same routes in reverse; each slab row's
        gradient sums its terms in global batch order, as the unsharded
        backward does."""
        from repro_torch.shard import all_to_all

        M = dist.get_world_size(group)
        k_loc = grp.k_pad // M
        if k_loc * M != grp.k_pad:
            raise ValueError(f"k_pad {grp.k_pad} not divisible by {M} model shards; "
                             f"build the collection with k_multiple={M}")
        if rows.dim() == 4:
            b = rows.movedim(1, 0)  # (M, B_loc, n_cols, T)
        else:
            b = bucket_rows(rows, k_loc, M)
        B_loc = rows.shape[0]
        recv = all_to_all(b, group)  # (M, B_loc, n_cols, T): rank r's rows I own
        r = recv.reshape(M * B_loc, grp.n_cols, -1).movedim(0, 1)
        part = self._univ_lookup(grp, group_params, r)  # (M*B_loc, n_cols*dsub)
        back = all_to_all(part.reshape(M, B_loc, -1), group)
        return back.sum(dim=0)  # (B_loc, n_cols*dsub)

    def lookup_all(self, emb_params, emb_buffers, sparse, *, rows=None, group=None):
        """All features' embeddings, one heavy lookup per group (ONE on
        the compressed Criteo configuration).

        sparse (B, n_features) integer ids -> (B, n_features, d2).
        ``rows`` (B, rows_n_cols, rows_n_tables) int32 are HOST-translated
        supertable rows (``data.translate``): universal groups then read
        their column slice of it, through a strided view the kernel takes
        without a copy, and never touch the pointer tables.  ``sparse``
        may be None when every group is universal.

        ``group`` (a ``torch.distributed`` process group) switches
        universal groups to the model-parallel lookup
        (``_univ_lookup_sharded``): the slabs are this rank's k-slices,
        the batch this rank's slice, and ``rows`` may also arrive
        pre-bucketed as (B, M, rows_n_cols, rows_n_tables).  The sharded
        lookup needs host-translated rows: the device never holds a whole
        pointer table."""
        if group is None and rows is not None and rows.dim() == 4:
            raise ValueError("pre-bucketed 4-d rows need a model group")
        outs = [None] * self.n_features
        col_off = 0
        for g, grp in enumerate(self.groups):
            if grp.kind == "univ":
                if group is not None:
                    if rows is None:
                        raise NotImplementedError(
                            "the sharded lookup needs host-translated rows "
                            "(the device program must not gather ptr)")
                    grows = rows[..., col_off: col_off + grp.n_cols, : grp.n_tables]
                    col_off += grp.n_cols
                    flat = self._univ_lookup_sharded(grp, emb_params[g], grows, group)
                elif rows is not None:
                    grows = rows[:, col_off : col_off + grp.n_cols, : grp.n_tables]
                    grows = grows.movedim(0, 1)  # (n_cols, B, T)
                    col_off += grp.n_cols
                    flat = self._univ_lookup(grp, emb_params[g], grows)
                else:
                    ids = sparse[:, list(grp.features)]
                    grows = self.group_rows(grp, emb_buffers[g], ids)
                    flat = self._univ_lookup(grp, emb_params[g], grows)
                off = 0
                for f_local, i in enumerate(grp.features):
                    n = grp.col_counts[f_local]
                    outs[i] = flat[:, off * grp.dsub : (off + n) * grp.dsub]
                    off += n
                continue
            ids = sparse[:, list(grp.features)]
            lookup_many = (emb_lib.FullTable.lookup_many if grp.kind == "full"
                           else emb_lib.lookup_many_loop)
            vecs = lookup_many(grp.tables, emb_params[g], emb_buffers[g], ids)
            for f_local, i in enumerate(grp.features):
                outs[i] = vecs[:, f_local]
        return torch.stack(outs, dim=1)


# --- checkpoint layout migrations ---------------------------------------------


def _emb_layout_migration(old_p, old_b, new_p, new_b):
    """(to_old, to_new) pair converting a checkpoint tree's embedding
    subtrees (params["emb"], the optimizer's moment slots, the error
    feedback, and ebuf["emb"]) between two layouts through the given
    emb-tree transforms.  Every transform is value-preserving (unstacking
    slices blocks; stacking reshapes and pads with zeros that training
    keeps zero), so a restore through a migration is bit-exact."""

    def _emb(tree, fn):
        if isinstance(tree, dict) and "emb" in tree:
            return dict(tree, emb=fn(tree["emb"]))
        return tree

    def _state(state, pfn, bfn):
        opt = state.opt
        if isinstance(opt, dict):
            opt = {k: _emb(v, pfn) if isinstance(v, dict) else v for k, v in opt.items()}
        return state._replace(
            params=_emb(state.params, pfn),
            opt=opt,
            ebuf=_emb(state.ebuf, bfn),
            err=_emb(state.err, pfn) if isinstance(state.err, dict) else state.err,
        )

    def to_old(tree):
        return dict(tree, state=_state(tree["state"], old_p, old_b))

    def to_new(tree):
        return dict(tree, state=_state(tree["state"], new_p, new_b))

    return to_old, to_new


def legacy_layout_migration(coll: EmbeddingCollection):
    """Migration pair for the pre-collection per-feature layout:
    ``to_old(template)`` derives the per-feature template such a writer
    produced, ``to_new(tree)`` stacks a restored per-feature tree into the
    grouped layout, bit for bit."""
    return _emb_layout_migration(
        coll.unstack_params, coll.unstack_buffers,
        coll.stack_params, coll.stack_buffers,
    )


def grouped_layout_migration(coll: EmbeddingCollection, old_coll: EmbeddingCollection):
    """Migration pair between two grouped layouts of the same tables: the
    pre-universal grouping (``build(mode="group")``), or another
    ``k_multiple``.  Both convert losslessly through the per-feature view,
    so the restore is bit-exact."""
    return _emb_layout_migration(
        lambda emb: old_coll.stack_params(coll.unstack_params(emb)),
        lambda emb: old_coll.stack_buffers(coll.unstack_buffers(emb)),
        lambda emb: coll.stack_params(old_coll.unstack_params(emb)),
        lambda emb: coll.stack_buffers(old_coll.unstack_buffers(emb)),
    )
