"""The sharded train and serve steps over a (data, model) mesh: the port
of the JAX package's ``launch/steps.py``.

DLRM (DESIGN.md section 9): model rank m of M holds codebook rows
``[m*k_loc, (m+1)*k_loc)`` of every universal supertable ``(C, T, k_pad,
dsub)`` and the optimizer moments of those rows, each CCE pointer table
in its at-rest layout (``mesh.ptr_partition_spec``), and the MLPs,
``hs``, the epochs and the step counter whole; the data axis replicates
all of it.  The batch splits over every rank (``mesh.all_batch_axes``): a
contiguous slice of the global batch a world rank, in rank order.
``dlrm_state_specs`` says which dim of each state leaf is split.

The LMs (the dense, vlm, audio and moe families): ``param_specs`` splits
the heads, the ff axis and the tables' columns (the audio family's full
head its vocabulary) over the model axis, and the moe family's experts
over the data axis (``models/lm.py``); the adamw moments split over the
data axis too (ZeRO-1, ``optim.optimizers.zero1_specs``) where the param
does not already; the batch splits over the data axis alone and is
replicated over the model axis (``mesh.batch_axes``).
``build_train_step`` accumulates the micro-batches ``shapes.microbatch``
sets, sums the gradients over the data group, clips by the global norm,
updates each data rank's slice of the moments and params and gathers the
params over the data group;
``build_serve_step`` prefills or decodes with the cache laid out by
``cache_specs``.

In JAX, GSPMD inserts the steps' collectives.  Here ``GradSync`` writes
them: a leaf split over the model axis has a gradient complete over the
model group (DLRM: it received every id it owns; the LM: each rank
computes its own slice), so it is summed over the data group alone; a
leaf split over the data axis (an expert) has its whole gradient on its
owner already, which the all-to-alls brought every rank's tokens to, and
is summed over nothing; a whole leaf's gradient is summed over every rank
that holds a share of the batch (DLRM: the world; the LM: the data group,
its model ranks holding equal gradients already); the global-norm clip
adds the split leaves' squared norms over the model group and those of
the data-split leaves over the data group too (each slice counted once)
and counts each whole leaf once; the loss terms are summed into the
global mean.  The lookup's all-to-alls are in
``EmbeddingCollection._univ_lookup_sharded``, the LM's tensor-parallel
collectives in ``models/lm.py``.  On one rank every collective is an
identity and each step equals the 1-device step bit for bit.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import batch_axes, ptr_partition_spec
from repro_torch.shard import Spec, all_gather_cat, shard_tree, spec_dim
from repro_torch.tree import tree_map

Pytree = Any


def dlrm_state_specs(cfg, state, n_shards: int):
    """The ``shard.Spec`` of each leaf of a DLRM ``TrainState`` over
    ``n_shards`` model ranks: a tree of ``state``'s structure (a whole or a
    sharded state).  Universal supertables and their moments split the
    codebook axis (2); each CCE ``ptr`` takes ``ptr_partition_spec`` of its
    table's (c, d1); everything else is whole.  No leaf splits over the
    data axis: its ranks hold replicas."""
    from repro_torch.core.cce import CCE

    coll = cfg.collection
    univ = set(coll.univ_groups)

    def whole(tree):
        return tree_map(lambda _: Spec(), tree)

    def param_specs(params):
        return {k: ([{"tables": Spec(model=2)} if g in univ else whole(e)
                     for g, e in enumerate(v)]
                    if k == "emb" else whole(v)) for k, v in params.items()}

    def feat_specs(t, fb):
        if isinstance(t, CCE) and isinstance(fb, dict):
            return {k: Spec(model=ptr_partition_spec(t.c, t.d1, n_shards)) if k == "ptr"
                    else whole(v) for k, v in fb.items()}
        return whole(fb)

    ebuf = {k: ([[feat_specs(t, fb) for t, fb in zip(coll.groups[g].tables, feats)]
                 if g in univ else whole(feats) for g, feats in enumerate(v)]
                if k == "emb" else whole(v)) for k, v in state.ebuf.items()}
    pspecs = param_specs(state.params)
    opt = {slot: (pspecs if slot in ("m", "v") else whole(v)) for slot, v in state.opt.items()}
    return type(state)(params=pspecs, opt=opt, ebuf=ebuf, step=None,
                       err=None if state.err is None else param_specs(state.err))


def dlrm_batch_struct(cfg, batch_size: int, *, accum: int = 1, n_shards: int = 1,
                      data_shards: int = 1) -> dict:
    """{name: (shape, dtype)} of one rank's batch of the sharded step,
    leaves (accum, micro, ...) with micro = batch_size / (accum *
    data_shards * n_shards): host-translated rows (pre-bucketed (micro, M,
    n_cols, T) when n_shards > 1), dense and label."""
    coll = cfg.collection
    ranks = n_shards * data_shards
    micro = batch_size // (accum * ranks)
    if micro * accum * ranks != batch_size:
        raise ValueError(f"batch {batch_size} does not split into {accum} microbatches "
                         f"over {data_shards} x {n_shards} ranks")
    rows = (micro, coll.rows_n_cols, coll.rows_n_tables)
    if n_shards > 1:
        rows = (micro, n_shards) + rows[1:]
    batch = {"dense": ((micro, cfg.n_dense), torch.float32),
             "label": ((micro,), torch.float32),
             "rows": (rows, torch.int32)}
    return {k: ((accum, *shape), dt) for k, (shape, dt) in batch.items()}


def _pairs(tree, specs) -> list:
    """(leaf, model dim, data dim) of every tensor leaf of ``tree``, in
    ``tree_leaves`` order."""
    out = []
    tree_map(lambda x, s: out.append((x, spec_dim(s), spec_dim(s, "data")))
             if isinstance(x, torch.Tensor) else None, tree, specs)
    return out


class GradSync:
    """The step's collectives (``make_train_step(sync=)``) over ``mesh``
    (``mesh.Mesh``): ``param_specs`` is the params part of the state's
    specs.  ``batch_over_model``: the batch splits over the model ranks
    too (DLRM, ``all_batch_axes``), so a whole leaf's gradient is a share
    to sum over the world; else (the LM, ``batch_axes``) the model ranks
    hold it whole and it is summed over the data group."""

    def __init__(self, param_specs, mesh, *, batch_over_model: bool = True):
        self.specs = param_specs
        self.group = mesh.model
        self.data = mesh.data if mesh.shape["data"] > 1 else None
        self.whole_group = mesh.world if batch_over_model else mesh.data

    def grads(self, grads):
        """Sum the whole leaves' gradients in place, in one all-reduce, and
        each leaf split over the model axis alone over the data group; a
        data-split leaf's is its owner's whole."""
        from repro_torch.shard import all_reduce_

        pairs = _pairs(grads, self.specs)
        whole = [g for g, m, d in pairs if m is None and d is None]
        if whole and self.whole_group is not None:
            flat = all_reduce_(torch.cat([g.reshape(-1) for g in whole]), self.whole_group)
            for g, part in zip(whole, flat.split([g.numel() for g in whole])):
                g.copy_(part.view_as(g))
        if self.data is not None:
            for g, m, d in pairs:
                if m is not None and d is None:
                    all_reduce_(g, self.data)
        return grads

    def loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The ranks' loss terms summed: the global mean."""
        from repro_torch.shard import all_reduce_

        return all_reduce_(loss.detach().clone().reshape(1), self.whole_group)[0]

    def clip_(self, grads, max_norm: float):
        """``clip_by_global_norm_`` over the whole model: each split leaf's
        squared norm summed over the model ranks (one all-reduce), a
        data-split leaf's over the data ranks too (one more), each whole
        leaf's taken once, added in leaf order as the 1-device clip adds
        them."""
        from repro_torch.shard import all_reduce_

        pairs = _pairs(grads, self.specs)
        sq = [(g.to(torch.float32) ** 2).sum() for g, _, _ in pairs]
        for group, at in ((self.group, 1), (self.data, 2)):
            split = [i for i, p in enumerate(pairs) if p[at] is not None]
            if split and group is not None:
                summed = all_reduce_(torch.stack([sq[i] for i in split]), group)
                for i, s in zip(split, summed.unbind(0)):
                    sq[i] = s
        gnorm = torch.sqrt(sum(sq))
        scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        for g, _, _ in pairs:
            g.mul_(scale)
        return grads, gnorm


def build_dlrm_train_step(cfg, mesh, specs, *, batch_size: int, accum: int = 1,
                          optimizer=None, lr_fn=None, clip_norm: float = 1.0,
                          telemetry=None):
    """The model-parallel DLRM step over ``mesh`` (``mesh.Mesh``, D x M
    ranks: the lookup over the model group, the slab's gradient summed
    over the data group after the lookup's backward, the whole leaves'
    over the world), for the sharded state whose ``specs`` are
    ``dlrm_state_specs``.  Returns ``(train_step, batch_struct)``:
    ``train_step(state, batch)`` takes this rank's batch
    (``dlrm_batch_struct``), updates this rank's state in place and returns
    metrics whose ``loss`` and ``gnorm`` are the global ones.
    ``telemetry`` adds the in-step health metrics, among them the
    per-shard occupancy of the pre-bucketed rows."""
    from repro_torch.models import dlrm
    from repro_torch.optim import sgd
    from repro_torch.train.loop import make_train_step

    if optimizer is None:
        optimizer = sgd(momentum=0.9)
    if lr_fn is None:
        def lr_fn(step):
            return 1e-3
    batch_struct = dlrm_batch_struct(cfg, batch_size, accum=accum,
                                     n_shards=mesh.shape["model"],
                                     data_shards=mesh.shape["data"])
    micro = batch_size // accum

    def loss_fn(p, b, mb):
        mb = {k: mb[k] for k in ("dense", "label", "rows")}
        return dlrm.bce_loss(p, b, cfg, mb, group=mesh.model, global_batch=micro), {}

    step = make_train_step(loss_fn, optimizer, lr_fn, accum=accum, clip_norm=clip_norm,
                           telemetry=telemetry, sync=GradSync(specs.params, mesh))
    return step, batch_struct


# --- the LMs -----------------------------------------------------------------------


def abstract_state(cfg, optimizer):
    """The whole ``TrainState`` on the meta device: shapes and dtypes, no
    memory (``lm.init`` with no generator)."""
    from repro_torch.models import lm
    from repro_torch.train.loop import init_state

    params, buffers = lm.init(cfg, None, device="meta")
    return init_state(params, optimizer, buffers)


def static_buffers_for(cfg):
    """The embedding buffers as numpy (``lm.init_buffers``): the values
    ``lm.init`` gives, with no tables made."""
    from repro_torch.models import lm

    return lm.init_buffers(cfg)


def state_specs(cfg, state_shape, *, n_model: int = 1, dp_size: int = 1):
    """The ``TrainState``'s specs: ``lm.param_specs`` over ``n_model``
    ranks, the adamw moments ZeRO-1 over ``dp_size`` data ranks, the
    buffers whole."""
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import moment_specs
    from repro_torch.train.loop import TrainState

    pspecs = lm.param_specs(cfg, n_model)
    return TrainState(params=pspecs,
                      opt=moment_specs("adamw", pspecs, state_shape.params, dp_size),
                      ebuf=tree_map(lambda _: Spec(), state_shape.ebuf), step=None, err=None)


def shard_state(state, specs, mesh, device=None):
    """This rank's part of a whole ``state`` (or of any tree under
    ``specs``, the params alone among them): its model slices, and its
    data slices of those (the moments', the experts'), moved to
    ``device`` when given."""
    (d, m), (D, M) = mesh.coords, (mesh.shape["data"], mesh.shape["model"])
    out = shard_tree(shard_tree(state, specs, m, M, "model"), specs, d, D, "data")
    if device is None:
        return out
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, out)


def _data_slice(x, mesh, dim: int):
    """This rank's contiguous slice of ``x`` along ``dim`` over the data
    axis (``x`` itself on one data rank)."""
    d, D = mesh.coords[0], mesh.shape["data"]
    if D == 1:
        return x
    if x.shape[dim] % D:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {D} data ranks")
    n = x.shape[dim] // D
    return x.narrow(dim, d * n, n)


def _shape(shape_name, shape):
    return shp.SHAPES[shape_name] if shape is None else shape


def _n_dp(mesh) -> int:
    """The data-parallel degree: the product of ``batch_axes``' sizes."""
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def build_train_step(cfg, mesh, shape_name: str = "train_4k", *, shape=None):
    """The sharded LM train step on ``mesh`` (``mesh.Mesh``), as the JAX
    package builds it: adamw (weight decay 0.1, moments ZeRO-1 over the
    data axis), a cosine schedule (3e-4, 100 warm-up steps, 10,000 in all),
    clip 1.0, ``shapes.microbatch``'s micro-batches.  ``shape`` (a
    ``shapes.Shape``) replaces ``SHAPES[shape_name]``.

    Returns ``(train_step, (state_shape, batch_struct), specs)``:
    ``train_step(state, batch)`` takes this rank's state
    (``shard_state``) and the global batch, {"tokens": (accum, micro, S)}
    (and the vlm family's "patch_emb"), of which it keeps its data rank's
    rows; it updates the state in place and returns metrics with the
    global loss and gnorm, and for the moe family the global mean of the
    load-balancing loss, "aux", summed over the data group as the loss is."""
    from repro_torch.models import lm
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.optim.optimizers import zero1
    from repro_torch.train.loop import make_train_step

    shape = _shape(shape_name, shape)
    D, M = _n_dp(mesh), mesh.shape["model"]
    accum, micro = shp.microbatch(cfg, shape, D)
    optimizer = adamw(weight_decay=0.1)
    lr_fn = cosine_schedule(3e-4, 100, 10_000)
    state_shape = abstract_state(cfg, optimizer)
    specs = state_specs(cfg, state_shape, n_model=M, dp_size=D)

    auxes = []  # the moe family's aux terms of the step's micro-batches

    def loss_fn(p, b, mb):
        loss, parts = lm.next_token_loss(p, b, cfg, mb, group=mesh.model, data=mesh.data,
                                         global_batch=micro)
        if cfg.family == "moe":
            auxes.append(parts["aux"].detach() * (mb["tokens"].shape[0] / micro))
        return loss, parts

    sync = GradSync(specs.params, mesh, batch_over_model=False)
    step = make_train_step(loss_fn, zero1(optimizer, specs.opt, mesh.data), lr_fn,
                           accum=accum, clip_norm=1.0, sync=sync)

    def train_step(state, batch):
        auxes.clear()
        state, metrics = step(state, {k: _data_slice(v, mesh, 1) for k, v in batch.items()})
        if auxes:
            metrics["aux"] = sync.loss(sum(auxes) / len(auxes))
        return state, metrics

    return train_step, (state_shape, shp.train_input_specs(cfg, shape, D)), specs


def build_serve_step(cfg, mesh, shape_name: str, *, shape=None):
    """The sharded prefill or decode step (the shape's kind) on ``mesh``:
    the params split by ``lm.param_specs`` over the model axis and the moe
    family's experts over the data axis, the batch over the data axis
    where it divides (else every data rank serves all of it), the cache
    laid out by ``lm.cache_specs``.

    Returns ``(step, args, (param_specs, cache_specs))``.  The step takes
    this rank's params (``shard_state(params, param_specs, mesh)``), the
    buffers, the global tokens (and positions) and
    this rank's cache (``lm.init_cache(cfg, B_loc, S, group=mesh.model)``),
    writes the cache in place and returns the global logits on every rank:
    decode ``step(params, buffers, tokens, pos, cache)``, prefill
    ``step(params, buffers, tokens, cache, last_idx=None)``.  ``args``
    describes the inputs (``shapes``), the params on the meta device."""
    from repro_torch.models import lm

    shape = _shape(shape_name, shape)
    D, M = _n_dp(mesh), mesh.shape["model"]
    split = shape.global_batch % D == 0
    pspecs = lm.param_specs(cfg, M)
    cspecs = lm.cache_specs(cfg, M, batch_split=split)
    params_shape, _ = lm.init(cfg, None, device="meta")

    def local(x):
        return _data_slice(x, mesh, 0) if split else x

    def whole(logits):
        return all_gather_cat(logits, 0, mesh.data) if split and D > 1 else logits

    if shape.kind == "decode":
        def step(params, buffers, tokens, pos, cache):
            logits, cache = lm.decode_step(params, buffers, cfg, local(tokens), local(pos),
                                           cache, group=mesh.model, data=mesh.data)
            return whole(logits), cache

        specs = shp.decode_input_specs(cfg, shape)
        args = {"params": params_shape, "tokens": specs["tokens"], "pos": specs["pos"],
                "cache": specs["cache"]}
    else:
        def step(params, buffers, tokens, cache, last_idx=None):
            logits, cache = lm.prefill(params, buffers, cfg, local(tokens), cache,
                                       last_idx=last_idx, group=mesh.model, data=mesh.data)
            return whole(logits), cache

        specs = shp.prefill_input_specs(cfg, shape)
        args = {"params": params_shape, "tokens": specs["tokens"], "cache": specs["cache"]}
    return step, args, (pspecs, cspecs)


def build_step(cfg, mesh, shape_name: str, *, shape=None):
    """``build_train_step`` for a train shape (its step and input
    descriptions), else ``build_serve_step``'s step and inputs."""
    shape = _shape(shape_name, shape)
    if shape.kind == "train":
        step, structs, _ = build_train_step(cfg, mesh, shape_name, shape=shape)
        return step, structs
    step, args, _ = build_serve_step(cfg, mesh, shape_name, shape=shape)
    return step, args
