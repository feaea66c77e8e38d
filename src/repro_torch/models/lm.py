"""Decoder LM of the dense family (qwen2/qwen3 style), the moe family
(phi3.5-moe, qwen3-moe: each layer's FFN a top-k mixture of experts,
``models/moe.py``), the hybrid family (hymba: sliding-window attention
beside a selective-SSM branch in each layer), the xlstm family
(xlstm-1.3b: superblocks of mLSTM blocks and one sLSTM block, no
attention, a recurrent cache), the vlm family (paligemma: a dense gemma
backbone whose ``forward`` prepends projected patch embeddings to the
text) and the audio family (musicgen: a dense backbone over
``n_codebooks`` token streams, their embeddings summed at the input, a
head of n_codebooks x vocab rows, sinusoidal positions), the
counterpart of the JAX package's ``repro/models/lm.py``.

The input embedding and the output head are the paper's integration
points: ``cfg.emb_method`` "cce" makes the token table a CCE table, looked
up through the fused lookup kernel, and the head a second CCE table in the
factored form (k-sized matmuls and integer gathers instead of a vocab by
d matmul); "full" keeps both uncompressed.

Params are stacked ``(L, ...)`` per leaf, as the JAX package stacks them
for ``lax.scan`` (the xlstm family's ``(n_super, n_m, ...)`` and
``(n_super, ...)``), so ``convert`` carries a JAX state across leaf by leaf;
Python loops over the layers replace the scans.  The cache is written
in place (``prefill`` into the slice it is given, ``decode_step`` at each
row's position, or its ring slot under a sliding window; the hybrid
family's SSM and conv states and the xlstm family's recurrent states row
by row), where the JAX functions return a new cache.  ``forward`` takes
each layer's params through one ``unbind`` a leaf, whose backward stacks
the layers' gradients once, and checkpoints each block under
``cfg.remat="full"`` (the JAX package's ``nothing_saveable``): the
backward recomputes the block, so the forward keeps only each block's
input.  The xlstm family's forward under autograd walks its stack the
same way, two levels deep (superblocks, then their mLSTM blocks), and
under ``remat="full"`` checkpoints each mLSTM block and, around them,
each superblock, as the JAX package does.  ``next_token_loss`` is the
training loss, the moe family's auxiliary load-balancing loss summed
over the layers and weighted in.  The moe family routes a sequence
through ``cfg.moe_impl``'s route in ``forward`` ("einsum", "sort" or
"sort_sm") and through the einsum route in ``prefill`` unless it is
"sort", and decodes through every expert (``apply_moe_decode``), as the
JAX package does.  The audio family's tokens are (B, S, n_codebooks)
(a decode step's (B, n_codebooks)), codebook j looked up at rows
j x vocab + token of one table, and its logits (..., n_codebooks,
vocab).  Not ported: ``remat="dots"``, and the JAX package's sharding
options that no configuration sets (``seq_shard``, ``zero2_grads``,
``parallelism="fsdp"``), which raise by name.

Tensor parallel, the dense, vlm, audio and moe families (``group=``, a
model group of M ranks; ``data=``, the data group, which the moe family's
experts split over; ``param_specs`` and ``cache_specs`` give the layout,
``launch/steps.py`` builds the steps): each rank holds its slices of the
weights, and
``forward``, ``next_token_loss``, ``prefill`` and ``decode_step`` run a
rank's share.  A block enters the region through ``shard.copy_to_group``
(identity forward, gradient summed over the group) and leaves it through
``shard.reduce_from_group`` (one all-reduce of the partial sums); under
``parallel_block`` attention's and the MLP's partial sums are added
first, then reduced once (a group of one keeps the unsharded order of the
sums).  The CCE token table splits each column's dsub: a rank looks up
its slice of every column through the lookup kernel and ``gather_last``
puts the columns back together.  The CCE head splits the same way: a
rank's k-sized products (``CCE.logit_scores``) of its slices are summed
over the group, (tokens, c, 2k), 4x fewer values than the vocabulary's
logits for command-r-35b, and every rank gathers the whole logits from
them.  The audio family's full token table splits d (a rank looks up its
columns, gathered as the CCE slices are) and its untied full head splits
the vocabulary's rows: a rank's slice of the logits, gathered along the
vocabulary, so that every rank returns the whole (..., n_codebooks,
vocab).  The vlm family's ``patch_proj`` splits its output columns,
gathered before the patches are prepended.  The moe family's FFN is
``models/moe.py``'s: experts over the data group, their ff axis over the
model group, one reduce in token space.  What a rank computes between the
collectives is a function of its own (``embed_share``,
``patch_share``, ``prefill_attention_share``, ``parallel_share``,
``head_share``, ``vocab_share``; ``moe.dispatch`` and
``moe.grouped_experts``), which takes its (rank, M) where its slice of
the inputs depends on it: with the collectives replaced by a
concatenation or a sum in rank order, the same calls emulate the M
ranks in one process.  Without a group every function is the unsharded
one.  The hybrid and xlstm families have no sharded layout yet and raise
by name.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import embeddings as emb_lib
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.shard import (
    Spec,
    copy_to_group,
    gather_last,
    group_size,
    rank_and_size,
    reduce_from_group,
)


def _check(cfg: ModelConfig, group=None) -> None:
    if cfg.family not in ("dense", "moe", "hybrid", "xlstm", "vlm", "audio"):
        raise NotImplementedError(f"LM family {cfg.family!r} is not ported "
                                  f"(dense, moe, hybrid, xlstm, vlm and audio only)")
    if cfg.pos_emb not in ("rope", "sinusoidal", "none"):
        raise NotImplementedError(f"pos_emb={cfg.pos_emb!r} is not ported")
    for name in ("seq_shard", "zero2_grads"):
        if getattr(cfg, name):
            raise NotImplementedError(f"{name}=True is not ported")
    if cfg.parallelism != "tp":
        raise NotImplementedError(f"parallelism={cfg.parallelism!r} is not ported (tp only)")
    L.check_attention(cfg)
    if group is not None:
        _check_tp(cfg)


TP_FAMILIES = ("dense", "vlm", "audio", "moe")


def _check_tp(cfg: ModelConfig) -> None:
    """The tensor-parallel layout: the dense, vlm, audio and moe families,
    with CCE tables, or the audio family's full table and head."""
    if cfg.family not in TP_FAMILIES:
        raise NotImplementedError(f"the {cfg.family} family's sharded layout is not ported "
                                  f"(the {', '.join(TP_FAMILIES)} families only)")
    if cfg.emb_method != "cce" and not (cfg.emb_method == "full" and cfg.family == "audio"):
        raise NotImplementedError(f"emb_method={cfg.emb_method!r} under tensor parallelism "
                                  f"(CCE tables, and the audio family's full table)")


# --- embedding table construction -------------------------------------------


def make_emb(cfg: ModelConfig):
    """The token table: vocab rows, or n_codebooks x vocab (codebook j's
    tokens at rows j x vocab on)."""
    return emb_lib.make_table(
        cfg.emb_method,
        cfg.vocab * (cfg.n_codebooks or 1),
        cfg.d_model,
        budget=cfg.emb_budget or None,
        c=cfg.emb_c,
        dtype=cfg.param_dtype,
    )


def _head_table(cfg: ModelConfig):
    """The compressed factored head: a second table instance (own seed)."""
    return dataclasses.replace(make_emb(cfg), seed_salt=1)


# --- init ----------------------------------------------------------------------


def _init_layer(generator: torch.Generator, cfg: ModelConfig, device):
    p = {"ln1": L.init_norm(cfg, device=device),
         "attn": L.init_attention(generator, cfg, device=device)}
    if cfg.family == "hybrid":
        p["ssm"] = ssm_lib.init_ssm(generator, cfg, device=device)
        # per-branch output norms (hymba averages normed branch outputs)
        p["attn_norm"] = torch.ones((cfg.d_model,), dtype=cfg.param_dtype, device=device)
        p["ssm_norm"] = torch.ones((cfg.d_model,), dtype=cfg.param_dtype, device=device)
    if not cfg.parallel_block:
        p["ln2"] = L.init_norm(cfg, device=device)
    if cfg.family == "moe":
        p["moe"] = moe_lib.init_moe(generator, cfg, device=device)
    elif cfg.d_ff:
        p["mlp"] = L.init_mlp(generator, cfg, device=device)
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _stack_layers(make, n: int):
    """``_stack`` of ``make()`` called ``n`` times, each layer copied into
    the stacked tensors as it is made: a full-width moe layer holds 5.2 GB
    of float32, so ``n`` layers beside their stack would not fit a card."""
    first = make()

    def empty(t):
        if isinstance(t, dict):
            return {k: empty(v) for k, v in t.items()}
        return t.new_empty((n, *t.shape))

    def put(out, t, i):
        if isinstance(t, dict):
            for k in t:
                put(out[k], t[k], i)
        else:
            out[i].copy_(t)

    out = empty(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, make(), i)
    return out


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Returns (params, buffers).  Float draws come from ``generator``, on
    its own device (a CUDA generator keeps a full-width init on the card);
    buffers (CCE pointer arrays and hash coefficients) come from numpy and
    equal the JAX package's bit for bit."""
    _check(cfg)
    emb = make_emb(cfg)
    emb_params, emb_buffers = emb.init(generator, device=device)
    params: dict[str, Any] = {"emb": emb_params}
    buffers: dict[str, Any] = {"emb": emb_buffers}
    if cfg.family == "xlstm":
        params["blocks"] = _init_xlstm_stack(generator, cfg, device)
    else:
        params["blocks"] = _stack_layers(lambda: _init_layer(generator, cfg, device),
                                         cfg.n_layers)
    params["ln_f"] = L.init_norm(cfg, device=device)
    if cfg.tie_embeddings:
        pass  # head reuses emb params
    elif cfg.emb_method == "full":  # the audio family's codebooks' heads stacked
        params["head"] = L.truncated_normal(
            generator, ((cfg.n_codebooks or 1) * cfg.vocab, cfg.d_model),
            1.0 / math.sqrt(cfg.d_model), cfg.param_dtype).to(device)
    else:
        hp, hb = _head_table(cfg).init(generator, device=device)
        params["head"] = hp
        buffers["head"] = hb
    if cfg.family == "vlm":
        # the adapter of precomputed patch embeddings (the vision tower is a stub)
        params["patch_proj"] = L.truncated_normal(
            generator, (cfg.d_model, cfg.d_model), 1.0 / math.sqrt(cfg.d_model),
            cfg.param_dtype).to(device)
    return params, buffers


def _xlstm_shape(cfg: ModelConfig) -> tuple[int, int]:
    """(superblocks, mLSTM blocks in each) under ``slstm_every``."""
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


def _init_xlstm_stack(generator: torch.Generator, cfg: ModelConfig, device):
    """{"mlstm": (n_super, n_m, ...), "slstm": (n_super, ...), "norms":
    {"m": (n_super, n_m, d), "s": (n_super, d)}} under ``slstm_every``,
    else {"mlstm": (L, ...), "norms": (L, d)}: the JAX package's layout."""

    def stacked_norm(*lead):
        return {"scale": torch.ones((*lead, cfg.d_model), dtype=cfg.param_dtype,
                                    device=device)}

    def mlstm(n):
        return _stack([xlstm_lib.init_mlstm(generator, cfg, device=device) for _ in range(n)])

    if cfg.slstm_every:
        n_super, n_m = _xlstm_shape(cfg)
        return {"mlstm": _stack([mlstm(n_m) for _ in range(n_super)]),
                "slstm": _stack([xlstm_lib.init_slstm(generator, cfg, device=device)
                                 for _ in range(n_super)]),
                "norms": {"m": stacked_norm(n_super, n_m), "s": stacked_norm(n_super)}}
    return {"mlstm": mlstm(cfg.n_layers), "norms": stacked_norm(cfg.n_layers)}


def init_buffers(cfg: ModelConfig):
    """Only the embedding buffers, as numpy (no tensors): the values
    ``init`` gives, derived from ``seed_salt``."""
    buffers: dict[str, Any] = {"emb": make_emb(cfg).init_buffers()}
    if not cfg.tie_embeddings and cfg.emb_method != "full":
        buffers["head"] = _head_table(cfg).init_buffers()
    return buffers


def layer_params(blocks, i: int):
    """Layer ``i`` of the stacked block params (views)."""
    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    return blocks[i]


def _unstack(blocks, n: int) -> list:
    """The ``n`` layers' params, one ``unbind`` a stacked leaf.  Indexing
    each layer instead would give every layer's backward an (L, ...)
    zero gradient of each leaf to add up."""
    if isinstance(blocks, dict):
        per = {k: _unstack(v, n) for k, v in blocks.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return torch.unbind(blocks, 0)


# --- sharding specs -----------------------------------------------------------


def param_specs(cfg: ModelConfig, n_model: int = 1):
    """The ``shard.Spec`` of every leaf of ``init``'s params over a model
    axis of ``n_model`` ranks and the data axis: the JAX package's
    ``param_specs`` (``ep="data"``) as dims, stacked leaves counting their
    layer axis.

    * the CCE token table and head (c, 2, k, dsub) split dsub (3); the
      audio family's full table (n_codebooks x vocab, d) splits d (1) and
      its full head the vocabulary's rows (0);
    * the vlm family's ``patch_proj`` (d, d) splits its columns (1);
    * attention: wq, bq and wk, wv, bk, bv split their head axis, wo its
      rows; q_norm and k_norm whole;
    * the MLP: wi, wg, bi split the ff axis, wo its rows; bo whole;
    * the moe family's experts: wi, wg (E, d, f) and wo (E, f, d) split
      the experts (0) over the data axis and the ff axis over the model
      axis; the router whole;
    * the norms whole.

    One deviation: where ``n_model`` does not divide the KV heads (qwen2's
    2 at 4 ranks) the JAX package splits wk and wv through half heads; the
    port holds them, bk and bv whole on every rank (``layers.kv_heads_split``),
    so that a rank computes whole KV heads."""
    _check(cfg)
    _check_tp(cfg)
    kv = 1 if L.kv_heads_split(cfg, n_model) else None
    whole = Spec()

    def norm():
        return {"scale": whole} | ({"bias": whole} if cfg.norm == "layernorm" else {})

    attn = {"wq": Spec(model=1), "wk": Spec(model=kv), "wv": Spec(model=kv),
            "wo": Spec(model=0)}
    if cfg.qkv_bias:
        attn |= {"bq": Spec(model=0), "bk": Spec(model=0 if kv else None),
                 "bv": Spec(model=0 if kv else None)}
    if cfg.qk_norm:
        attn |= {"q_norm": whole, "k_norm": whole}
    if cfg.act == "swiglu":
        mlp = {"wi": Spec(model=1), "wg": Spec(model=1), "wo": Spec(model=0)}
    else:
        mlp = {"wi": Spec(model=1), "bi": Spec(model=0), "wo": Spec(model=0), "bo": whole}
    layer = {"ln1": norm(), "attn": attn}
    if not cfg.parallel_block:
        layer["ln2"] = norm()
    if cfg.family == "moe":
        layer["moe"] = {"router": whole, "wi": Spec(model=2, data=0),
                        "wg": Spec(model=2, data=0), "wo": Spec(model=1, data=0)}
    elif cfg.d_ff:
        layer["mlp"] = mlp

    def stacked(spec):  # the leading layer axis
        if isinstance(spec, dict):
            return {k: stacked(v) for k, v in spec.items()}
        return Spec(*(None if d is None else d + 1 for d in (spec.model, spec.data)))

    full = cfg.emb_method == "full"
    specs = {"emb": {"table": Spec(model=1)} if full else {"tables": Spec(model=3)},
             "blocks": stacked(layer), "ln_f": norm()}
    if not cfg.tie_embeddings:
        specs["head"] = Spec(model=0) if full else {"tables": Spec(model=3)}
    if cfg.family == "vlm":
        specs["patch_proj"] = Spec(model=1)
    return specs


def cache_specs(cfg: ModelConfig, n_model: int = 1, *, batch_split: bool = True):
    """The ``shard.Spec`` of the cache's "k" and "v" (L, B, S, KVH, D), for
    every family with a sharded layout: the batch over the data axis
    (``batch_split``), the KV heads (3) over the model axis.  The JAX
    package splits head_dim (4) instead, since its
    KV-head counts rarely divide the axis; the port's attention reads
    whole heads, so it splits the heads where they divide, and where they
    do not (``layers.kv_heads_split``) every rank holds them all."""
    _check(cfg)
    _check_tp(cfg)
    spec = Spec(model=3 if L.kv_heads_split(cfg, n_model) else None,
                data=1 if batch_split else None)
    return {"k": spec, "v": spec}


# --- embedding lookup / logits -----------------------------------------------


def embed(params, buffers, cfg: ModelConfig, tokens, group=None):
    """tokens (B, S), or (B, S, n_codebooks) for the audio family, whose
    codebooks' rows are summed -> (B, S, d) in ``cfg.dtype``; a CCE table
    takes the fused lookup (the kernel on CUDA tensors).  Under ``group``
    the table holds this rank's dsub slice of every column (a full
    table's, its columns): one lookup of the slices, then the columns
    gathered from the ranks."""
    emb = make_emb(cfg)
    if group_size(group) > 1:
        x = gather_last(embed_share(params, buffers, cfg, tokens), group)
        x = x.reshape(*tokens.shape[:2], cfg.d_model)
    elif cfg.n_codebooks:
        x = emb.lookup(params["emb"], buffers["emb"], _codebook_rows(cfg, tokens)).sum(dim=-2)
    else:
        x = emb.lookup(params["emb"], buffers["emb"], tokens)
    if cfg.emb_scale:
        x = x * math.sqrt(cfg.d_model)
    return x.to(cfg.dtype)


def _codebook_rows(cfg: ModelConfig, tokens):
    """The audio family's (..., n_codebooks) tokens as rows of its table:
    codebook j's at j x vocab on."""
    offs = torch.arange(cfg.n_codebooks, dtype=tokens.dtype, device=tokens.device) * cfg.vocab
    return tokens + offs


def logits_fn(params, buffers, cfg: ModelConfig, h, group=None):
    """h (..., d) -> (..., vocab), or (..., n_codebooks, vocab).  A table
    head (tied or compressed) promotes ``cfg.dtype`` activations against
    its ``param_dtype`` table, as jnp does; an untied full head multiplies
    in ``cfg.dtype``.  Under ``group`` the CCE head's scores of this rank's
    slices are summed over the group and every rank gathers the whole
    logits; a full head's ranks each give their rows' logits, gathered."""
    if group_size(group) > 1:
        hc = copy_to_group(h, group)
        if cfg.emb_method == "full":
            out = gather_last(vocab_share(params, cfg, hc), group)
        else:
            scores = head_share(params, cfg, hc, *rank_and_size(group))
            out = head_logits(buffers, cfg, reduce_from_group(scores, group))
    elif cfg.tie_embeddings or cfg.emb_method != "full":
        key = "emb" if cfg.tie_embeddings else "head"
        out = make_emb(cfg).logits(params[key], buffers[key], h.to(cfg.dtype))
    else:
        out = vocab_share(params, cfg, h)
    if cfg.n_codebooks:
        out = out.reshape(*h.shape[:-1], cfg.n_codebooks, cfg.vocab)
    return out


# --- a model rank's share (tensor parallel) -----------------------------------
# What one rank of a model group computes between the collectives.  The
# sharded functions call these with ``rank_and_size(group)`` around one
# all-gather or all-reduce; with the collectives replaced by a
# concatenation or a sum in rank order, the same calls emulate M ranks in
# one process.


def embed_share(params, buffers, cfg: ModelConfig, tokens):
    """A rank's slice of the token table's lookup of tokens (B, S), or (B,
    S, n_codebooks) summed over the codebooks: (B, S, c, dsub/M), the
    lookup kernel (on CUDA tensors) on its dsub slice of every column,
    ``params["emb"]["tables"]`` (c, 2, k, dsub/M); a full table's (B, S,
    d/M), a torch gather of its columns (the JAX package's ``jnp.take``).
    The ranks' slices, concatenated in rank order on the last dim, are
    the lookup."""
    emb = make_emb(cfg)
    ids = _codebook_rows(cfg, tokens) if cfg.n_codebooks else tokens
    if cfg.emb_method == "full":
        x = emb.lookup(params["emb"], buffers["emb"], ids)
    else:
        tables = params["emb"]["tables"]
        rows = emb._rows(buffers["emb"], ids).reshape(emb.c, -1, 2)
        x = kops.cce_lookup(rows, tables.contiguous()).reshape(*ids.shape, emb.c,
                                                                tables.shape[-1])
    return x.sum(dim=2) if cfg.n_codebooks else x


def patch_share(params, cfg: ModelConfig, patch_emb):
    """A rank's columns of the vlm family's projected patches, (B,
    n_patches, d/M): ``patch_emb`` (B, n_patches, d) times its slice of
    ``patch_proj``, in ``cfg.dtype``."""
    return patch_emb.to(cfg.dtype) @ params["patch_proj"].to(cfg.dtype)


def vocab_share(params, cfg: ModelConfig, h):
    """A rank's slice of an untied full head's logits, (..., rows/M): h
    (..., d) in ``cfg.dtype`` against its rows of ``params["head"]``
    (n_codebooks x vocab / M, d).  Concatenated in rank order on the last
    dim, they are the logits."""
    return h.to(cfg.dtype) @ params["head"].to(cfg.dtype).T


def head_share(params, cfg: ModelConfig, h, rank: int, M: int):
    """Rank ``rank`` of M's partial scores of the CCE head, (..., c, 2k):
    its dsub slice of each column of h (..., d) against its slice of the
    table.  Summed over the ranks, they are the head's scores
    (``head_logits``)."""
    key = "emb" if cfg.tie_embeddings else "head"
    tab = make_emb(cfg)
    ds = tab.dsub // M
    hc = h.to(cfg.dtype).reshape(*h.shape[:-1], tab.c, tab.dsub)[..., rank * ds:(rank + 1) * ds]
    cols = tab.logit_scores(params[key], hc.reshape(*h.shape[:-1], tab.c * ds))
    return torch.stack(list(cols), dim=-2)


def head_logits(buffers, cfg: ModelConfig, scores):
    """The whole logits (..., vocab) from the head's scores (..., c, 2k)
    summed over the ranks."""
    key = "emb" if cfg.tie_embeddings else "head"
    return make_emb(cfg).logits_from_scores(buffers[key], scores.unbind(-2))


def prefill_attention_share(lp, cfg: ModelConfig, h, positions, freqs, rank: int, M: int,
                            group=None):
    """Rank ``rank`` of M's share of a prefill's attention on one layer's
    params ``lp`` (its slices): (its partial output (B, S, d), through its
    rows of ``wo``; k and v (B, S, KVH_held, D), the KV heads it holds, for
    the cache).  The flash kernel on its query heads and the KV heads they
    read (``layers.local_kv``), or SDPA past a sliding window.  ``group``
    only routes the gradient of replicated KV weights
    (``layers._project_qkv``)."""
    B, S = h.shape[0], h.shape[1]
    q, k, v = L._project_qkv(lp["attn"], cfg, h, group)
    if cfg.pos_emb == "rope":
        q = L.apply_rope(q, positions, freqs)
        k = L.apply_rope(k, positions, freqs)
    kl, vl = L.local_kv(cfg, k, rank, M), L.local_kv(cfg, v, rank, M)
    if not cfg.sliding_window or S <= cfg.sliding_window:
        attn = kops.flash_attention(q, kl, vl, causal=True)
    else:
        attn = L._sdpa(cfg, q, kl, vl, L.causal_mask(S, S, cfg.sliding_window, device=h.device))
    return attn.reshape(B, S, -1) @ lp["attn"]["wo"].to(h.dtype), k, v


def parallel_share(p, cfg: ModelConfig, attn, ht):
    """A ``parallel_block`` layer's share of its residual update: this
    rank's partial attention output ``attn`` plus its MLP's partial sum
    over its ff slice, both reading ``ht`` = ln1(x)."""
    return attn + L.mlp_partial(p["mlp"], cfg, ht)


def parallel_residual(p, cfg: ModelConfig, x, y):
    """A ``parallel_block`` layer's output from ``y``, the ranks'
    ``parallel_share`` summed: x + y + the MLP's output bias."""
    return x + L.mlp_bias(p["mlp"], cfg, y)


def _add_positions(cfg: ModelConfig, x, positions):
    """x plus the sinusoidal embedding of ``positions`` in x's dtype, under
    ``pos_emb="sinusoidal"``; else x."""
    if cfg.pos_emb != "sinusoidal":
        return x
    return x + L.sinusoidal_pos_emb(positions, cfg.d_model).to(x.dtype)


# --- forward (training / prefill) ---------------------------------------------


def _block_train(p, cfg: ModelConfig, x, positions, freqs, *, decode_cache=None, group=None,
                 data=None):
    """One block over a full sequence, or one decode token when
    ``decode_cache`` (this layer's rows of the cache, written in place) is
    given.  Returns (x, aux): aux the moe family's load-balancing loss
    over a sequence, else None.  Under ``group`` this rank's share of a
    dense block (``_dense_out``) or of a moe block (its attention heads,
    its experts' ff slices; its experts over ``data``)."""
    h = L.apply_norm(p["ln1"], x)
    ht = copy_to_group(h, group)
    if decode_cache is None:
        attn = L.attention_train(p["attn"], cfg, ht, positions, freqs, group)
    else:
        attn, _, _ = L.attention_decode(p["attn"], cfg, ht, positions, decode_cache["k"],
                                        decode_cache["v"], freqs, group)
    if cfg.family == "hybrid":
        if decode_cache is None:
            s = ssm_lib.ssm_train(p["ssm"], cfg, h)
        else:
            s, hst, cst = ssm_lib.ssm_decode(p["ssm"], cfg, h, decode_cache["ssm"],
                                             decode_cache["conv"])
            decode_cache["ssm"].copy_(hst)
            decode_cache["conv"].copy_(cst)
        return _hybrid_out(p, cfg, x, attn, s), None
    if cfg.family == "moe":
        x = x + reduce_from_group(attn, group)
        h2 = L.apply_norm(p["ln2"], x)
        if decode_cache is not None:
            return x + moe_lib.apply_moe_decode(p["moe"], cfg, h2, group=group, data=data), None
        route = {"sort": moe_lib.apply_moe_sort, "sort_sm": moe_lib.apply_moe_sort_sm,
                 "einsum": moe_lib.apply_moe}[cfg.moe_impl]
        mo, aux = route(p["moe"], cfg, h2, group_size=cfg.moe_group, group=group, data=data)
        return x + mo, aux
    return _dense_out(p, cfg, x, attn, ht, group), None


def _dense_out(p, cfg: ModelConfig, x, attn, ht, group):
    """A block's residual update after attention, for every family but the
    moe and hybrid ones: from ``attn``, this rank's partial attention
    output, and ``ht``, the block's normed input inside the region.
    ``parallel_block`` (command-r: attention and the MLP both read ln1(x))
    adds the two partial sums (``parallel_share``), then reduces them once;
    otherwise attention's sum is reduced, and the MLP reads ln2 of the new
    x.  A group of one (or none) keeps the unsharded order
    ``x + attn + mlp``."""
    if cfg.parallel_block:
        if group_size(group) == 1:
            return x + attn + L.apply_mlp(p["mlp"], cfg, ht)
        y = reduce_from_group(parallel_share(p, cfg, attn, ht), group)
        return parallel_residual(p, cfg, x, y)
    x = x + reduce_from_group(attn, group)
    if cfg.d_ff:
        h2 = copy_to_group(L.apply_norm(p["ln2"], x), group)
        x = x + L.mlp_bias(p["mlp"], cfg,
                           reduce_from_group(L.mlp_partial(p["mlp"], cfg, h2), group))
    return x


def _hybrid_out(p, cfg: ModelConfig, x, attn, s):
    """hymba's residual update: the mean of the RMS-normed attention and
    SSM branch outputs, then the MLP."""
    attn = L.rms_norm_dim(attn, p["attn_norm"])
    s = L.rms_norm_dim(s, p["ssm_norm"])
    x = x + 0.5 * (attn + s)
    if cfg.d_ff:
        x = x + L.apply_mlp(p["mlp"], cfg, L.apply_norm(p["ln2"], x))
    return x


def forward(params, buffers, cfg: ModelConfig, batch, *, group=None, data=None):
    """Full-sequence forward.  batch: {"tokens": (B, S) integer, or (B, S,
    n_codebooks)} and, for the vlm family, optionally "patch_emb" (B,
    n_patches, d): projected by ``patch_proj`` in ``cfg.dtype`` and
    prepended to the text, with positions over the whole sequence; only
    the text positions give logits.  Returns (logits (B, S, vocab) or (B,
    S, n_codebooks, vocab), aux), aux float32: the moe family's
    load-balancing losses summed over the layers, else zero.  Under
    ``group`` each rank returns the whole logits; ``data`` is the data
    group the moe family's experts split over (its aux is then this
    rank's term: ``next_token_loss``)."""
    _check(cfg, group)
    tokens = batch["tokens"]
    x = embed(params, buffers, cfg, tokens, group)
    patches = cfg.family == "vlm" and "patch_emb" in batch
    if patches:
        x = torch.cat([gather_last(patch_share(params, cfg, batch["patch_emb"]), group), x], dim=1)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    x = _add_positions(cfg, x, positions)
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(f"remat={cfg.remat!r} is not ported (none, full)")
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    if cfg.family == "xlstm":
        walk = _xlstm_train_forward if torch.is_grad_enabled() else _xlstm_forward
        x = L.apply_norm(params["ln_f"], walk(params["blocks"], cfg, x))
        return logits_fn(params, buffers, cfg, x), torch.zeros((), dtype=torch.float32,
                                                               device=x.device)
    freqs = L.rope_freqs(cfg, device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    block = functools.partial(_block_train, group=group, data=data)
    for lp in _unstack(params["blocks"], cfg.n_layers):
        x, aux = _maybe_checkpoint(remat, block, lp, cfg, x, positions, freqs)
        if aux is not None:
            aux_total = aux_total + aux
    x = L.apply_norm(params["ln_f"], x)
    if patches:
        x = x[:, -tokens.shape[1]:]
    return logits_fn(params, buffers, cfg, x, group), aux_total


_XLSTM_STATE = {"m": ("C", "n", "m"), "s": ("s_c", "s_n", "s_h", "s_m")}  # cache keys a block


def _xlstm_blocks(blocks, cfg: ModelConfig):
    """The xlstm stack in block order: ("m", (s, j), params, norm) for
    mLSTM block j of superblock s, ("s", s, params, norm) for its sLSTM
    block; without ``slstm_every``, ("m", i, params, norm) a layer."""
    if not cfg.slstm_every:
        for i in range(cfg.n_layers):
            yield "m", i, layer_params(blocks["mlstm"], i), layer_params(blocks["norms"], i)
        return
    n_super, n_m = _xlstm_shape(cfg)
    for s in range(n_super):
        sp = layer_params(blocks, s)
        for j in range(n_m):
            yield ("m", (s, j), layer_params(sp["mlstm"], j),
                   layer_params(sp["norms"]["m"], j))
        yield "s", s, sp["slstm"], sp["norms"]["s"]


def _xlstm_forward(blocks, cfg: ModelConfig, x, cache=None):
    """The xlstm stack over a whole sequence (the chunkwise mLSTM, the
    sequential sLSTM), each block ``x + block(norm(x))``.  With ``cache``
    every block's terminal state is copied into it (prefill), every leaf
    whole."""
    for kind, at, p, norm in _xlstm_blocks(blocks, cfg):
        block = xlstm_lib.mlstm_train if kind == "m" else xlstm_lib.slstm_seq
        y, state = block(p, cfg, L.apply_norm(norm, x))
        if cache is not None:
            for key, t in zip(_XLSTM_STATE[kind], state):
                cache[key][at].copy_(t)
        x = x + y
    return x


def _maybe_checkpoint(remat: bool, fn, *args):
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def _mlstm_block(p, norm, cfg: ModelConfig, x):
    return x + xlstm_lib.mlstm_train(p, cfg, L.apply_norm(norm, x))[0]


def _superblock(sp, cfg: ModelConfig, x, n_m: int, remat: bool):
    """Superblock ``sp``'s n_m mLSTM blocks, then its sLSTM block."""
    for p, norm in zip(_unstack(sp["mlstm"], n_m), _unstack(sp["norms"]["m"], n_m)):
        x = _maybe_checkpoint(remat, _mlstm_block, p, norm, cfg, x)
    return x + xlstm_lib.slstm_seq(sp["slstm"], cfg, L.apply_norm(sp["norms"]["s"], x))[0]


def _xlstm_train_forward(blocks, cfg: ModelConfig, x):
    """The xlstm stack under autograd: the params through one ``unbind``
    a stacked leaf and level (superblocks, then their mLSTM blocks), no
    state kept; under ``remat="full"`` each mLSTM block and each
    superblock checkpointed (JAX's ``nothing_saveable`` on ``m_body`` and
    ``super_body``)."""
    remat = cfg.remat == "full"
    if not cfg.slstm_every:
        for p, norm in zip(_unstack(blocks["mlstm"], cfg.n_layers),
                           _unstack(blocks["norms"], cfg.n_layers)):
            x = _maybe_checkpoint(remat, _mlstm_block, p, norm, cfg, x)
        return x
    n_super, n_m = _xlstm_shape(cfg)
    for sp in _unstack(blocks, n_super):
        x = _maybe_checkpoint(remat, _superblock, sp, cfg, x, n_m, remat)
    return x


def next_token_loss(params, buffers, cfg: ModelConfig, batch, *, group=None, data=None,
                    global_batch=None):
    """Causal LM loss with next-token targets: the mean over (B, S - 1),
    and the codebooks of the audio family, of the float32 ``logsumexp`` of
    the logits minus the target's logit, plus 0.01 x the auxiliary loss.
    The target's logit is gathered, where the JAX package sums a one-hot
    product over the vocabulary: the same number, since x·1 plus zeros is
    exact.  Returns (loss, {"ce", "aux"}).  ``group``, ``data``:
    ``forward``'s model and data groups.  ``global_batch``: the sequences
    of the whole (data-parallel) batch, of which this rank holds B; the
    loss is then this rank's term of the global mean, its local mean times
    B / global_batch (the data ranks' terms sum to it, the moe family's
    aux among them; with B == global_batch the factor is left out and the
    loss is the unsharded one bit for bit)."""
    logits, aux = forward(params, buffers, cfg, batch, group=group, data=data)
    lg = logits[:, :-1].to(torch.float32)
    tg = batch["tokens"][:, 1:].to(torch.int64)
    logz = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tg[..., None])[..., 0]
    ce = (logz - picked).mean()
    loss = ce + 0.01 * aux
    B = batch["tokens"].shape[0]
    if global_batch is not None and global_batch != B:
        loss = loss * (B / global_batch)
    return loss, {"ce": ce, "aux": aux}


# --- decode --------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda", group=None):
    """Decode cache of zeros: "k", "v" (L, batch, S, KVH, D) in
    ``cfg.dtype``, S = max_seq, or min(max_seq, window), a ring, under a
    sliding window; the hybrid family adds "ssm" (L, batch, di, ds) and
    "conv" (L, batch, K-1, di), both float32.  The xlstm family's cache is
    its recurrent state (``_init_xlstm_cache``), whatever ``max_seq``.
    Under ``group`` the KV heads this rank holds (``cache_specs``)."""
    _check(cfg, group)
    if cfg.family == "xlstm":
        return _init_xlstm_cache(cfg, batch, device)
    S = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    Lc = cfg.n_layers
    M = group_size(group)
    kvh = cfg.n_kv_heads // M if L.kv_heads_split(cfg, M) else cfg.n_kv_heads
    shape = (Lc, batch, S, kvh, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    if cfg.family == "hybrid":
        cache["ssm"] = torch.zeros((Lc, batch, cfg.ssm_inner, cfg.ssm_state),
                                   dtype=torch.float32, device=device)
        cache["conv"] = torch.zeros((Lc, batch, cfg.ssm_conv - 1, cfg.ssm_inner),
                                    dtype=torch.float32, device=device)
    return cache


def _init_xlstm_cache(cfg: ModelConfig, batch: int, device):
    """The mLSTM states "C" (..., batch, H, hd, hd), "n" (..., batch, H,
    hd), "m" (..., batch, H) at -inf, float32, the leading dims (n_super,
    n_m) under ``slstm_every``, else (L,); under ``slstm_every`` also the
    sLSTM states "s_c", "s_n", "s_h" and "s_m" (at -inf), each (n_super,
    batch, d) float32."""
    lead = _xlstm_shape(cfg) if cfg.slstm_every else (cfg.n_layers,)
    cache = {key: t.expand(*lead, *t.shape).clone() for key, t in
             zip(_XLSTM_STATE["m"], xlstm_lib.init_mlstm_state(cfg, batch, device=device))}
    if cfg.slstm_every:
        cache |= {key: t.expand(lead[0], *t.shape).clone() for key, t in
                  zip(_XLSTM_STATE["s"], xlstm_lib.init_slstm_state(cfg, batch, device=device))}
    return cache


def cache_batch_axis(cfg: ModelConfig):
    """The batch-dimension index of each cache leaf."""
    if cfg.family == "xlstm" and cfg.slstm_every:
        return {"C": 2, "n": 2, "m": 2, "s_c": 1, "s_n": 1, "s_h": 1, "s_m": 1}
    if cfg.family == "xlstm":
        return {"C": 1, "n": 1, "m": 1}
    base = {"k": 1, "v": 1}
    if cfg.family == "hybrid":
        base |= {"ssm": 1, "conv": 1}
    return base


def decode_step(params, buffers, cfg: ModelConfig, tokens, pos, cache, *, group=None,
                data=None):
    """One-token decode.  tokens (B,), or (B, n_codebooks) for the audio
    family, pos (B,) integer positions; the token's k/v go into ``cache``
    in place at ``pos`` (its ring slot under a sliding window), and the
    hybrid family's SSM and conv states move on by one token in place, as
    do the xlstm family's recurrent states (which ignore ``pos``).
    Returns (logits (B, vocab) or (B, n_codebooks, vocab), cache).  Under
    ``group`` this rank's heads and cache; every rank returns the logits.
    ``data``: the data group the moe family's experts split over."""
    _check(cfg, group)
    x = _add_positions(cfg, embed(params, buffers, cfg, tokens[:, None], group), pos[:, None])
    if cfg.family == "xlstm":
        x = L.apply_norm(params["ln_f"], _xlstm_decode(params["blocks"], cfg, x, cache))
        return logits_fn(params, buffers, cfg, x[:, 0]), cache
    freqs = L.rope_freqs(cfg, device=x.device)
    pos = pos.to(torch.int64)
    for i in range(cfg.n_layers):
        lc = {key: c[i] for key, c in cache.items()}
        x, _ = _block_train(layer_params(params["blocks"], i), cfg, x, pos, freqs,
                            decode_cache=lc, group=group, data=data)
    x = L.apply_norm(params["ln_f"], x)
    return logits_fn(params, buffers, cfg, x[:, 0], group), cache


def _xlstm_decode(blocks, cfg: ModelConfig, x, cache):
    """One token through the xlstm stack, every block's state in
    ``cache`` moved on by one token in place."""
    for kind, at, p, norm in _xlstm_blocks(blocks, cfg):
        h = L.apply_norm(norm, x)
        state = tuple(cache[key][at] for key in _XLSTM_STATE[kind])
        if kind == "m":  # C, n and m move on in place
            y, _ = xlstm_lib.mlstm_decode(p, cfg, h, state)
        else:
            y, state = xlstm_lib.slstm_seq(p, cfg, h, state)
            for key, t in zip(_XLSTM_STATE[kind], state):
                cache[key][at].copy_(t)
        x = x + y
    return x


def prefill(params, buffers, cfg: ModelConfig, tokens, cache, *, last_idx=None, group=None,
            data=None):
    """Process a full prompt, tokens (B, S) or (B, S, n_codebooks): write
    its k/v into ``cache[:, :, :S]`` in place and return (logits of one
    position (B, vocab) or (B, n_codebooks, vocab), cache).  Under a
    sliding window with S longer than the cache's ring, the last ring's
    worth of k/v is written in ring order (position t at t % ring), and
    attention runs through ``_sdpa`` under the windowed mask, as in the JAX
    package; otherwise through the flash kernel (where S <= window the
    windowed mask is the causal one).  The hybrid family also writes the
    SSM branch's terminal state and conv inputs into the cache.

    ``last_idx`` (default ``S - 1``) picks that position: a serving engine
    that right-pads prompts into power-of-two buckets passes the true last
    token's index, and causal attention keeps every position up to it
    blind to the padding (only families without a window or a recurrent
    state pad: ring and recurrent caches would take the pads in).  The vlm
    family prefills text only, as in the JAX package.  The xlstm family
    runs its chunkwise and sequential forms and writes every block's
    terminal state into ``cache``, every leaf of the slice whole.  Under
    ``group`` each rank runs the flash kernel on its heads, writes the KV
    heads it holds and returns the logits; the moe family's experts split
    over ``data``, whose ranks each prefill whole groups of tokens."""
    _check(cfg, group)
    B, S = tokens.shape[0], tokens.shape[1]
    x = embed(params, buffers, cfg, tokens, group)
    last = S - 1 if last_idx is None else int(last_idx)
    if cfg.family == "xlstm":
        x = _xlstm_forward(params["blocks"], cfg, x, cache=cache)
        return logits_fn(params, buffers, cfg, L.apply_norm(params["ln_f"], x[:, last])), cache
    positions = torch.arange(S, device=x.device).expand(B, S)
    x = _add_positions(cfg, x, positions)
    freqs = L.rope_freqs(cfg, device=x.device)
    rank, M = rank_and_size(group)
    for i in range(cfg.n_layers):
        lp = layer_params(params["blocks"], i)
        h = L.apply_norm(lp["ln1"], x)
        attn, k, v = prefill_attention_share(lp, cfg, h, positions, freqs, rank, M, group)
        Sc = cache["k"].shape[2]
        if cfg.sliding_window and Sc < S:
            # keep only the last window of k/v in the ring buffer
            ring = (torch.arange(Sc, device=x.device) + (S - Sc) % Sc) % Sc
            cache["k"][i, :, ring] = k[:, -Sc:]
            cache["v"][i, :, ring] = v[:, -Sc:]
        else:
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        if cfg.family == "hybrid":
            s, (st, cv) = ssm_lib.ssm_train(lp["ssm"], cfg, h, return_state=True)
            cache["ssm"][i] = st
            cache["conv"][i] = cv
            x = _hybrid_out(lp, cfg, x, attn, s)
        elif cfg.family == "moe":
            x = x + reduce_from_group(attn, group)
            # the JAX package's prefill takes the einsum route under "sort_sm"
            route = moe_lib.apply_moe_sort if cfg.moe_impl == "sort" else moe_lib.apply_moe
            x = x + route(lp["moe"], cfg, L.apply_norm(lp["ln2"], x),
                          group_size=cfg.moe_group, group=group, data=data)[0]
        else:
            x = _dense_out(lp, cfg, x, attn, h, group)
    x = L.apply_norm(params["ln_f"], x[:, last])
    return logits_fn(params, buffers, cfg, x, group), cache
