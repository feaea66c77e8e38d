"""The model-parallel DLRM train step: the port of the JAX package's
``launch/steps.py`` (its DLRM builders).

Layout (DESIGN.md section 9): rank r of a model group of M holds codebook
rows ``[r*k_loc, (r+1)*k_loc)`` of every universal supertable
``(C, T, k_pad, dsub)`` and the optimizer moments of those rows; each CCE
pointer table in its at-rest layout (``mesh.ptr_partition_spec``); the
MLPs, ``hs``, the epochs and the step counter whole; and a contiguous
B/M slice of the global batch, in rank order.  ``dlrm_state_specs`` says
which dim of each state leaf is split.

In JAX, GSPMD inserts the step's collectives.  Here ``GradSync`` writes
them: the gradients of the whole (replicated) leaves are summed over the
ranks in one all-reduce; the global-norm clip adds the split leaves'
squared norms over the ranks and counts each whole leaf once; the loss
terms are summed into the global mean.  The lookup's all-to-alls are in
``EmbeddingCollection._univ_lookup_sharded``.  A split leaf's gradient is
already complete on its rank (it received every id it owns), so the
momentum update stays on the rank.  On one rank every collective is an
identity and the step equals the 1-device step bit for bit.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.launch.mesh import ptr_partition_spec
from repro_torch.tree import tree_map

Pytree = Any


def dlrm_state_specs(cfg, state, n_shards: int):
    """The dim each leaf of a DLRM ``TrainState`` splits over ``n_shards``
    model ranks, or None: a tree of ``state``'s structure (a whole or a
    sharded state).  Universal supertables and their moments split the
    codebook axis (2); each CCE ``ptr`` takes ``ptr_partition_spec`` of its
    table's (c, d1); everything else is whole."""
    from repro_torch.core.cce import CCE

    coll = cfg.collection
    univ = set(coll.univ_groups)

    def whole(tree):
        return tree_map(lambda _: None, tree)

    def param_specs(params):
        return {k: ([{"tables": 2} if g in univ else whole(e) for g, e in enumerate(v)]
                    if k == "emb" else whole(v)) for k, v in params.items()}

    def feat_specs(t, fb):
        if isinstance(t, CCE) and isinstance(fb, dict):
            return {k: ptr_partition_spec(t.c, t.d1, n_shards) if k == "ptr" else whole(v)
                    for k, v in fb.items()}
        return whole(fb)

    ebuf = {k: ([[feat_specs(t, fb) for t, fb in zip(coll.groups[g].tables, feats)]
                 if g in univ else whole(feats) for g, feats in enumerate(v)]
                if k == "emb" else whole(v)) for k, v in state.ebuf.items()}
    pspecs = param_specs(state.params)
    opt = {slot: (pspecs if slot in ("m", "v") else whole(v)) for slot, v in state.opt.items()}
    return type(state)(params=pspecs, opt=opt, ebuf=ebuf, step=None,
                       err=None if state.err is None else param_specs(state.err))


def dlrm_batch_struct(cfg, batch_size: int, *, accum: int = 1, n_shards: int = 1) -> dict:
    """{name: (shape, dtype)} of one rank's batch of the sharded step,
    leaves (accum, micro, ...) with micro = batch_size / (accum *
    n_shards): host-translated rows (pre-bucketed (micro, M, n_cols, T)
    when n_shards > 1), dense and label."""
    coll = cfg.collection
    micro = batch_size // (accum * n_shards)
    if micro * accum * n_shards != batch_size:
        raise ValueError(f"batch {batch_size} does not split into {accum} microbatches "
                         f"over {n_shards} model shards")
    rows = (micro, coll.rows_n_cols, coll.rows_n_tables)
    if n_shards > 1:
        rows = (micro, n_shards) + rows[1:]
    batch = {"dense": ((micro, cfg.n_dense), torch.float32),
             "label": ((micro,), torch.float32),
             "rows": (rows, torch.int32)}
    return {k: ((accum, *shape), dt) for k, (shape, dt) in batch.items()}


def _pairs(tree, specs) -> list:
    """(leaf, spec) of every tensor leaf of ``tree``, in ``tree_leaves``
    order."""
    out = []
    tree_map(lambda x, d: out.append((x, d)) if isinstance(x, torch.Tensor) else None,
             tree, specs)
    return out


class GradSync:
    """The step's collectives over a model group (``make_train_step(sync=)``):
    ``param_specs`` is the params part of ``dlrm_state_specs``."""

    def __init__(self, param_specs, group):
        self.specs = param_specs
        self.group = group

    def grads(self, grads):
        """Sum the whole leaves' gradients over the ranks, in place, in one
        all-reduce."""
        from repro_torch.shard import all_reduce_

        whole = [g for g, d in _pairs(grads, self.specs) if d is None]
        if whole:
            flat = all_reduce_(torch.cat([g.reshape(-1) for g in whole]), self.group)
            for g, part in zip(whole, flat.split([g.numel() for g in whole])):
                g.copy_(part.view_as(g))
        return grads

    def loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The ranks' loss terms summed: the global mean."""
        from repro_torch.shard import all_reduce_

        return all_reduce_(loss.detach().clone().reshape(1), self.group)[0]

    def clip_(self, grads, max_norm: float):
        """``clip_by_global_norm_`` over the whole model: each split leaf's
        squared norm summed over the ranks (one all-reduce), each whole
        leaf's taken once, added in leaf order as the 1-device clip adds
        them."""
        from repro_torch.shard import all_reduce_

        pairs = _pairs(grads, self.specs)
        sq = [(g.to(torch.float32) ** 2).sum() for g, _ in pairs]
        split = [i for i, (_, d) in enumerate(pairs) if d is not None]
        if split:
            summed = all_reduce_(torch.stack([sq[i] for i in split]), self.group)
            for i, s in zip(split, summed.unbind(0)):
                sq[i] = s
        gnorm = torch.sqrt(sum(sq))
        scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        for g, _ in pairs:
            g.mul_(scale)
        return grads, gnorm


def build_dlrm_train_step(cfg, group, specs, *, batch_size: int, accum: int = 1,
                          optimizer=None, lr_fn=None, clip_norm: float = 1.0,
                          telemetry=None):
    """The model-parallel DLRM step over ``group`` (M ranks) for the
    sharded state whose ``specs`` are ``dlrm_state_specs``.  Returns
    ``(train_step, batch_struct)``: ``train_step(state, batch)`` takes
    this rank's batch (``dlrm_batch_struct``), updates this rank's state
    in place and returns metrics whose ``loss`` and ``gnorm`` are the
    global ones.  ``telemetry`` adds the in-step health metrics, among
    them the per-shard occupancy of the pre-bucketed rows."""
    import torch.distributed as dist

    from repro_torch.models import dlrm
    from repro_torch.optim import sgd
    from repro_torch.train.loop import make_train_step

    if optimizer is None:
        optimizer = sgd(momentum=0.9)
    if lr_fn is None:
        def lr_fn(step):
            return 1e-3
    n_shards = dist.get_world_size(group)
    batch_struct = dlrm_batch_struct(cfg, batch_size, accum=accum, n_shards=n_shards)
    micro = batch_size // accum

    def loss_fn(p, b, mb):
        mb = {k: mb[k] for k in ("dense", "label", "rows")}
        return dlrm.bce_loss(p, b, cfg, mb, group=group, global_batch=micro), {}

    step = make_train_step(loss_fn, optimizer, lr_fn, accum=accum, clip_norm=clip_norm,
                           telemetry=telemetry, sync=GradSync(specs.params, group))
    return step, batch_struct
