"""DLRM (Naumov et al. 2019), the paper's recommendation model.

13 dense features -> bottom MLP; 26 categorical features -> one embedding
table each (``emb_method``: any key of ``core.embeddings.METHODS`` or
"cce"), behind an ``EmbeddingCollection`` (one fused supertable lookup for
the CCE, CE and hashing-trick Criteo configurations); pairwise dot-product
interaction; top MLP -> 1 logit; binary cross-entropy loss.  The CCE
clustering transition runs group-wise through the collection
(``cluster_tables``).

Parameters are the JAX package's pytree layout as plain dicts and lists
of tensors: ``{"bottom": [{"w", "b"}, ...], "emb": [group, ...],
"top": [...]}`` and buffers ``{"emb": [[feature buffers, ...], ...]}``,
so ``convert.py`` carries them across unchanged.  A universal group's
CUDA tensors always go through the lookup kernel; there is no gather
fallback.

Model-parallel (``group=``, DESIGN.md section 9): each rank of a process
group holds a k-slice of every universal supertable and of its moments,
its pointer tables in their at-rest layout, and a contiguous slice of the
batch; ``forward``/``bce_loss`` route ids by all-to-all and
``cluster_tables`` runs the sharded transition.  ``checkpoint_migrations``
restores checkpoints of the per-feature, pre-universal and other
``k_multiple`` layouts bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Sequence

import torch

from repro_torch.core import embeddings as emb_lib
from repro_torch.core.collection import (
    EmbeddingCollection,
    grouped_layout_migration,
    legacy_layout_migration,
)
from repro_torch.optim.remap import remap_opt_state
from repro_torch.train.transition import transition_collection


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    vocab_sizes: tuple[int, ...]  # one per categorical feature (26 on Criteo)
    n_dense: int = 13
    emb_dim: int = 16
    bottom_mlp: tuple[int, ...] = (512, 256, 64, 16)
    top_mlp: tuple[int, ...] = (512, 256, 1)
    # per-table compression: method + cap on each table's params
    emb_method: str = "full"
    emb_param_cap: int = 0  # 0 = uncapped
    emb_c: int = 4
    # CCE transition: what happens to per-row optimizer moments when
    # cluster() rewrites a table ("remap" | "reset" | "keep", see
    # repro_torch.optim.remap), and the id-chunk size of the full-vocab
    # assignment pass (0 = unchunked)
    emb_opt_policy: str = "remap"
    emb_cluster_chunk: int = 1 << 18
    # collection grouping mode: "univ" (universal fusion, ONE heavy launch
    # for the compressed Criteo configuration), "group" (the JAX package's
    # pre-universal grouping) or "loop" (per-feature lookups)
    emb_fuse: str = "univ"
    # codebook rows round up to a multiple of this (model-shard count)
    emb_k_multiple: int = 1
    dtype: Any = torch.float32

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    def _build_table(self, i: int):
        v = self.vocab_sizes[i]
        cap = self.emb_param_cap
        if self.emb_method == "full" or not cap or v * self.emb_dim <= cap:
            # small tables stay uncompressed (paper: full table for small
            # features, compressed for the big ones)
            return emb_lib.make_table("full", v, self.emb_dim, dtype=self.dtype)
        return emb_lib.make_table(
            self.emb_method, v, self.emb_dim, budget=cap, c=self.emb_c,
            dtype=self.dtype, seed_salt=i,
        )

    @functools.cached_property
    def collection(self) -> EmbeddingCollection:
        return EmbeddingCollection.build(
            tuple(self._build_table(i) for i in range(self.n_sparse)),
            mode=self.emb_fuse,
            k_multiple=self.emb_k_multiple,
        )

    def table(self, i: int):
        return self.collection.tables[i]

    def n_emb_params(self) -> int:
        return sum(self.table(i).n_params for i in range(self.n_sparse))

    def compression(self) -> float:
        """Uncompressed embedding parameters over this configuration's."""
        full = sum(v * self.emb_dim for v in self.vocab_sizes)
        return full / max(1, self.n_emb_params())


def _init_mlp(generator, sizes: Sequence[int], dtype, device):
    return [
        {
            "w": (torch.randn((a, b), generator=generator, device=generator.device)
                  / math.sqrt(a)).to(
                device=device, dtype=dtype
            ),
            "b": torch.zeros((b,), dtype=dtype, device=device),
        }
        for a, b in zip(sizes[:-1], sizes[1:])
    ]


def _apply_mlp(params, x, final_act: bool = False):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1 or final_act:
            x = torch.relu(x)
    return x


def init(cfg: DLRMConfig, generator: torch.Generator, device="cuda"):
    """(params, buffers) with float draws from ``generator`` (they do not
    reproduce the JAX package's draws; tests carry its weights across
    with ``convert.py``) and integer buffers bit-exact with it."""
    params: dict[str, Any] = {
        "bottom": _init_mlp(generator, (cfg.n_dense, *cfg.bottom_mlp), cfg.dtype, device),
    }
    buffers: dict[str, Any] = {}
    params["emb"], buffers["emb"] = cfg.collection.init(generator, device)
    n_pairs = (cfg.n_sparse + 1) * cfg.n_sparse // 2
    top_in = cfg.bottom_mlp[-1] + n_pairs
    params["top"] = _init_mlp(generator, (top_in, *cfg.top_mlp), cfg.dtype, device)
    return params, buffers


def interact(params, cfg: DLRMConfig, dense, emb):
    """Everything after the embedding lookup: bottom MLP, pairwise dot
    interaction (upper triangle, no self, row-major pair order as
    ``jnp.triu_indices``), top MLP -> (B,) logits.  ``params`` needs only
    the ``bottom``/``top`` entries."""
    dense = dense.to(cfg.dtype)
    x0 = _apply_mlp(params["bottom"], dense, final_act=True)  # (B, emb_dim)
    V = torch.cat([x0[:, None, :], emb.to(cfg.dtype)], dim=1)
    inter = torch.bmm(V, V.transpose(1, 2))
    n = V.shape[1]
    iu, ju = torch.triu_indices(n, n, 1, device=V.device)
    feats = torch.cat([x0, inter[:, iu, ju]], dim=-1)
    return _apply_mlp(params["top"], feats)[:, 0]


def forward(params, buffers, cfg: DLRMConfig, batch, *, group=None):
    """batch: {"dense": (B, 13) float, "sparse": (B, 26) ids} and/or
    {"rows": (B, rows_n_cols, rows_n_tables) int32 host-translated rows}
    -> (B,) logits.  With ``group`` the supertables are this rank's
    k-slices, the batch this rank's slice (``rows`` global or
    pre-bucketed (B, M, ...)), and the lookup routes by all-to-all."""
    emb = cfg.collection.lookup_all(
        params["emb"], buffers["emb"], batch.get("sparse"), rows=batch.get("rows"),
        group=group,
    )  # (B, n_sparse, emb_dim): ONE fused lookup on Criteo
    return interact(params, cfg, batch["dense"], emb)


def bce_loss(params, buffers, cfg: DLRMConfig, batch, *, group=None, global_batch=None):
    """Mean binary cross-entropy of the logits, in the stable form
    ``max(lg, 0) - lg*y + log1p(exp(-|lg|))`` (float32).  With ``group``
    this rank's term of the global mean over ``global_batch`` examples:
    its local mean times B_loc / B (the ranks' terms sum to the global
    mean; on one rank the factor is 1 and the loss is the 1-device loss
    bit for bit)."""
    lg = forward(params, buffers, cfg, batch, group=group).to(torch.float32)
    y = batch["label"].to(torch.float32)
    loss = torch.mean(torch.clamp(lg, min=0) - lg * y + torch.log1p(torch.exp(-lg.abs())))
    if global_batch is not None and global_batch != lg.shape[0]:
        loss = loss * (lg.shape[0] / global_batch)
    return loss


def cluster_tables(key, params, buffers, cfg: DLRMConfig, opt=None, *, id_counts=None,
                   policy: str | None = None, chunk_size: int | None = None,
                   use_kernel: bool | None = None, max_points_per_centroid: int = 256,
                   group=None):
    """The CCE clustering transition of every CCE table (Alg. 3
    ``Cluster``), group-wise through the collection; ``key`` is a
    ``repro_torch.random`` key.

    With ``opt`` (the optimizer state, ``TrainState.opt``) the per-row
    moments of every transitioned table follow the new assignments per
    ``policy`` (default ``cfg.emb_opt_policy``) and the new state is the
    third return; without it, returns (params, buffers).  ``id_counts``
    (per-feature dense histograms) runs each table's k-means
    count-weighted on the observed ids and weights the moment remap the
    same way; an entry may also be a sketch provider (``points`` /
    ``id_weights``, e.g. ``make_id_tracker(cfg, stream).counts``).
    Returns new trees; the inputs are left as they were.

    ``group``: the sharded transition over a model group, the state in its
    sharded layout (``launch.steps.dlrm_state_specs``) in and out: the
    small slabs are gathered whole, each pointer table resharded to its id
    tile (``transition.ptr_to_tile``) and back, and every O(d1) phase runs
    over the ranks' id tiles.  ``id_counts`` must be equal on every rank.
    On one rank it equals the 1-device transition bit for bit."""
    policy = policy or cfg.emb_opt_policy
    if chunk_size is None:
        chunk_size = cfg.emb_cluster_chunk or None
    emb_p, emb_b = params["emb"], buffers["emb"]
    to_shards = from_shards = None
    if group is not None:
        emb_p, emb_b, to_shards, from_shards = _transition_layout(cfg, emb_p, emb_b, group)
    new_emb_p, new_emb_b, update_emb = transition_collection(
        cfg.collection, key, emb_p, emb_b, id_counts=id_counts,
        policy=policy, chunk_size=chunk_size, use_kernel=use_kernel,
        max_points_per_centroid=max_points_per_centroid, group=group,
    )
    if group is not None:
        new_emb_p, new_emb_b = to_shards(new_emb_p), _ptr_at_rest(cfg, new_emb_b, group)
        update = update_emb

        def update_emb(moments):
            return to_shards(update(from_shards(moments)))

    new_params = dict(params, emb=new_emb_p)
    new_buffers = dict(buffers, emb=new_emb_b)
    if opt is None:
        return new_params, new_buffers

    def update_moments(moments, _slot):
        return dict(moments, emb=update_emb(moments["emb"]))

    return new_params, new_buffers, remap_opt_state(opt, update_moments, policy=policy)


def _cce_ptr_dims(cfg: DLRMConfig, n_shards: int):
    """{(group, feature-local index): at-rest dim of the CCE ptr} over the
    universal groups."""
    from repro_torch.core.cce import CCE
    from repro_torch.launch.mesh import ptr_partition_spec

    coll = cfg.collection
    return {(g, f): ptr_partition_spec(t.c, t.d1, n_shards)
            for g in coll.univ_groups for f, t in enumerate(coll.groups[g].tables)
            if isinstance(t, CCE)}


def _transition_layout(cfg: DLRMConfig, emb_p, emb_b, group):
    """The sharded state's emb trees in the transition's layout (whole
    slabs, ptr id tiles), and the maps of a slab list to k-slices and
    back."""
    import torch.distributed as dist

    from repro_torch.shard import all_gather_cat, shard_leaf
    from repro_torch.train.transition import ptr_to_tile

    coll = cfg.collection
    rank, M = dist.get_rank(group), dist.get_world_size(group)
    univ = set(coll.univ_groups)

    def from_shards(emb):
        return [{"tables": all_gather_cat(e["tables"], 2, group)} if g in univ else e
                for g, e in enumerate(emb)]

    def to_shards(emb):
        return [{"tables": shard_leaf(e["tables"], 2, rank, M)} if g in univ else e
                for g, e in enumerate(emb)]

    dims = _cce_ptr_dims(cfg, M)
    tiles = [[dict(fb, ptr=ptr_to_tile(coll.groups[g].tables[f], fb["ptr"], dims[g, f], group))
              if (g, f) in dims else fb for f, fb in enumerate(feats)]
             for g, feats in enumerate(emb_b)]
    return from_shards(emb_p), tiles, to_shards, from_shards


def _ptr_at_rest(cfg: DLRMConfig, emb_b, group):
    """Inverse of ``_transition_layout``'s ptr tiles."""
    import torch.distributed as dist

    from repro_torch.train.transition import ptr_from_tile

    coll = cfg.collection
    dims = _cce_ptr_dims(cfg, dist.get_world_size(group))
    return [[dict(fb, ptr=ptr_from_tile(coll.groups[g].tables[f], fb["ptr"], dims[g, f], group))
             if (g, f) in dims else fb for f, fb in enumerate(feats)]
            for g, feats in enumerate(emb_b)]


def make_id_tracker(cfg: DLRMConfig, stream=None, *, key: str = "sparse", device="cuda"):
    """The frequency tracker the Trainer/transition pair consumes.

    ``stream=None`` returns the DENSE reference tracker (one int64 per
    vocab row).  A ``stream.tracker.StreamConfig`` returns the
    sketch-backed tracker at vocab-independent memory, with sketches only
    on the features that transition (the CCE tables); ``device`` is where
    its own cell counter runs when ``async_fold`` is on and the step does
    not count."""
    from repro_torch.core.cce import CCE
    from repro_torch.stream.tracker import IdFrequencyTracker, SketchFrequencyTracker

    if stream is None:
        return IdFrequencyTracker(cfg.vocab_sizes, key=key)
    tracked = tuple(i for i, t in enumerate(cfg.collection.tables) if isinstance(t, CCE))
    return SketchFrequencyTracker(cfg.vocab_sizes, stream, tracked=tracked, key=key,
                                  device=device)


#: ``k_multiple`` layouts every DLRM trainer restores checkpoints from (and
#: writes checkpoints readable by): 1 is the 1-device trainer's, the powers
#: of two the common model-shard counts.
KNOWN_K_MULTIPLES = (1, 2, 4, 8)


def checkpoint_migrations(cfg: DLRMConfig):
    """``Trainer(migrations=...)`` entries for every older emb layout: the
    per-feature (pre-collection) layout, the pre-universal grouping, and
    each ``KNOWN_K_MULTIPLES`` padding of the universal layout; all
    restore into this configuration's supertables bit for bit (params,
    moments, buffers, error feedback).  The k_multiple entries let a
    model-sharded trainer's checkpoint restore into a 1-device trainer and
    back: the extra pad rows are unreachable and stay zero."""
    migrations = [legacy_layout_migration(cfg.collection)]
    grouped = EmbeddingCollection.build(cfg.collection.tables, mode="group")
    layout = [(g.kind, g.features) for g in cfg.collection.groups]
    if [(g.kind, g.features) for g in grouped.groups] != layout:
        migrations.append(grouped_layout_migration(cfg.collection, grouped))

    def k_pads(coll):
        return tuple(coll.groups[g].k_pad for g in coll.univ_groups)

    for m in KNOWN_K_MULTIPLES:
        if m == cfg.emb_k_multiple:
            continue
        other = EmbeddingCollection.build(cfg.collection.tables, mode=cfg.emb_fuse,
                                          k_multiple=m)
        if k_pads(other) != k_pads(cfg.collection):
            migrations.append(grouped_layout_migration(cfg.collection, other))
    return migrations
