"""Transformer layers of the LM stack: functions over param dicts, the
counterpart of the JAX package's ``repro/models/layers.py``.

Conventions (the JAX package's):
  * params are nested dicts of tensors; init functions return params.
  * activations are (B, S, d) in ``cfg.dtype``; params kept in
    ``cfg.param_dtype`` and cast at use (mixed precision).

Training attention (``attention_train``) takes the JAX package's route:
the dense ``_sdpa`` under a causal mask, or, for ``attn_impl="chunked"``
past ``attn_chunk`` tokens, ``_sdpa_chunked``'s online softmax over KV
chunks; both are plain torch, as the JAX package computes them outside
any kernel, and both take a gradient.  The LM's prefill calls the flash
kernel itself (``models/lm.py``), which has no backward.  Decode
attention over the cache is ``_sdpa`` too; with a sliding window the
cache is a ring of ``min(max_seq, window)`` rows.  ``attn_impl="dense_bf16p"``
and logit soft-caps raise ``NotImplementedError``.

Tensor parallel (``group=``, a model group of M ranks; ``models/lm.py``):
the functions take a rank's slices of the weights and count heads from
their shapes.  q and wo split by heads, the MLP's ``wi``/``wg``/``bi``
and ``wo`` by the ff axis; the attention output and ``mlp_partial`` are
this rank's partial sums, which the caller adds over the group.  The KV
projections split by KV heads when M divides them (``kv_split``); where M
is a multiple of the KV heads every rank holds them whole, computes every
KV head (its cache holds them all) and attends with the one its query
heads read; where M divides neither the query heads nor the KV heads but
M <= KVH, each rank holds a contiguous range of whole GQA groups (its KV
heads and the query heads that read them), the first KVH % M ranks one
group more: hymba's 5 groups are 3 / 2 at M = 2 and 2 / 1 / 1 / 1 at M =
4, and every rank's flash call keeps the uniform GQA ratio.  A
replicated weight used inside the region enters it through
``shard.copy_to_group``, so that its gradient is summed over the ranks'
shares.  Without a group every function is the unsharded one.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.shard import copy_to_group, group_size, rank_and_size

Params = Any


def truncated_normal(generator: torch.Generator, shape, scale, dtype=torch.float32):
    """Normal draws cut to [-2, 2], times ``scale``, on the generator's
    device.  Another stream of numbers than ``jax.random``'s: tests carry
    the JAX package's params over with ``convert``.  With no generator,
    an empty tensor on the meta device (shapes only: ``lm.init`` on
    "meta")."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * scale).to(dtype)


def check_attention(cfg: ModelConfig) -> None:
    """Raise on the attention variants this slice does not port."""
    if cfg.attn_impl not in ("dense", "chunked"):
        raise NotImplementedError(f"attn_impl={cfg.attn_impl!r} is not ported")
    if cfg.logit_softcap:
        raise NotImplementedError("attention logit soft-capping is not ported")


# --- norms -------------------------------------------------------------------


def init_norm(cfg: ModelConfig, with_bias: bool | None = None, device="cuda"):
    p = {"scale": torch.ones((cfg.d_model,), dtype=cfg.param_dtype, device=device)}
    if with_bias if with_bias is not None else cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=cfg.param_dtype, device=device)
    return p


def apply_norm(p, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:  # rmsnorm
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return out.to(x.dtype)


def rms_norm_dim(x, scale, eps: float = 1e-6):
    """RMS-norm over the last dim with a given scale vector (qk_norm etc.)."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


# --- positions ---------------------------------------------------------------


def rope_freqs(cfg: ModelConfig, device="cuda") -> torch.Tensor:
    half = cfg.head_dim // 2
    return 1.0 / (cfg.rope_theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) with positions (..., S) -> rotated x, in the
    split-half layout (the first D/2 features pair with the last D/2)."""
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_emb(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions (...) -> (..., d) float32: the sines of position x
    10000^(-i / (d/2)) for i < d/2, then their cosines."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --- attention ---------------------------------------------------------------


def init_attention(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    d = cfg.d_model
    s = 1.0 / math.sqrt(d)
    pd = cfg.param_dtype
    p = {
        "wq": truncated_normal(generator, (d, cfg.q_dim), s, pd),
        "wk": truncated_normal(generator, (d, cfg.kv_dim), s, pd),
        "wv": truncated_normal(generator, (d, cfg.kv_dim), s, pd),
        "wo": truncated_normal(generator, (cfg.q_dim, d), s / math.sqrt(2 * cfg.n_layers), pd),
    }
    p = {k: v.to(device) for k, v in p.items()}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=pd, device=device)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=pd, device=device)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=pd, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.head_dim,), dtype=pd, device=device)
        p["k_norm"] = torch.ones((cfg.head_dim,), dtype=pd, device=device)
    return p


def kv_split(cfg: ModelConfig, n_model: int) -> tuple[int, ...] | None:
    """The KV heads each of ``n_model`` ranks holds, in rank order, each
    with the query heads of its GQA groups; None where every rank holds
    them all.  KVH/M each where M divides the query and KV heads; None
    where M divides the query heads and is a multiple of KVH (each rank's
    query heads then read one KV head); else, where M <= KVH, whole groups,
    the first KVH % M ranks one more (``kv_range``).  Raises otherwise."""
    H, KVH, M = cfg.n_heads, cfg.n_kv_heads, n_model
    if H % M == 0 and KVH % M == 0:
        return (KVH // M,) * M
    if H % M == 0 and M % KVH == 0:
        return None
    if M <= KVH:
        base, extra = divmod(KVH, M)
        return tuple(base + (r < extra) for r in range(M))
    if H % M:
        raise ValueError(f"{H} query heads do not split over {M} ranks")
    raise ValueError(f"{KVH} KV heads neither split over nor divide {M} ranks")


def kv_range(cfg: ModelConfig, rank: int, M: int) -> tuple[int, int]:
    """[start, stop) of the KV heads ``rank`` of M holds (``kv_split``);
    rank r's query heads are those of its KV heads' groups."""
    counts = kv_split(cfg, M)
    if counts is None:
        return 0, cfg.n_kv_heads
    start = sum(counts[:rank])
    return start, start + counts[rank]


def kv_parts(cfg: ModelConfig, n_model: int) -> tuple[int, ...] | None:
    """The ``shard.Spec.parts`` of the heads' cut over ``n_model`` ranks:
    ``kv_split``'s counts where they differ, else None (an even cut)."""
    counts = kv_split(cfg, n_model)
    return counts if counts is not None and len(set(counts)) > 1 else None


def local_kv(cfg: ModelConfig, k, rank: int, M: int):
    """The KV heads the query heads of ``rank`` of M read, out of the KV
    heads it holds (k (..., KVH_held, D), heads on dim -2): all of them
    when they split, else the one of ``rank // (M / KVH)``."""
    if kv_split(cfg, M) is not None:
        return k
    j = rank // (M // cfg.n_kv_heads)
    return k[..., j:j + 1, :]


def _project_qkv(p, cfg: ModelConfig, x, group=None):
    """x (B, S, d) -> q (B, S, H, D), k/v (B, S, KVH, D): this rank's
    query heads and the KV heads it holds under ``group``."""
    B, S, _ = x.shape
    dt = x.dtype
    whole = group_size(group) > 1 and kv_split(cfg, group_size(group)) is None

    def kv(name):  # a replicated KV weight enters the region
        return copy_to_group(p[name], group) if whole else p[name]

    q = x @ p["wq"].to(dt)
    k = x @ kv("wk").to(dt)
    v = x @ kv("wv").to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + kv("bk").to(dt)
        v = v + kv("bv").to(dt)
    q = q.reshape(B, S, -1, cfg.head_dim)
    k = k.reshape(B, S, -1, cfg.head_dim)
    v = v.reshape(B, S, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm_dim(q, copy_to_group(p["q_norm"], group))
        k = rms_norm_dim(k, copy_to_group(p["k_norm"], group))
    return q, k, v


def _sdpa(cfg: ModelConfig, q, k, v, mask) -> torch.Tensor:
    """Grouped-query scaled dot-product attention, plain torch (training
    and decode).

    q (B, Sq, H, D); k/v (B, Sk, KVH, D); mask broadcastable to
    (B, 1, Sq, Sk), True where a key is seen.  Returns (B, Sq, H, D).
    Scores are the product in q's dtype, then float32 over sqrt(D);
    masked scores are -1e30 (not -inf), as in the JAX package.  Each KV
    head serves its group of query heads without being copied."""
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, D)
    scores = torch.einsum("bqngd,bknd->bngqk", qg, k).to(torch.float32)
    scores = scores.reshape(B, H, Sq, k.shape[1]) / math.sqrt(D)
    if mask is not None:
        scores = torch.where(mask, scores, torch.tensor(-1e30, dtype=torch.float32,
                                                        device=scores.device))
    w = torch.softmax(scores, dim=-1).to(q.dtype).reshape(B, KVH, G, Sq, -1)
    return torch.einsum("bngqk,bknd->bqngd", w, v).reshape(B, Sq, H, D)


def causal_mask(Sq: int, Sk: int, sliding_window: int = 0, offset: int = 0, device="cuda"):
    """(Sq, Sk) boolean mask; with ``sliding_window`` w a query also sees
    only the w keys up to its own.  ``offset`` = absolute position of
    query 0 relative to key 0."""
    qi = torch.arange(Sq, device=device)[:, None] + offset
    kj = torch.arange(Sk, device=device)[None, :]
    m = qi >= kj
    if sliding_window:
        m = m & (qi - kj < sliding_window)
    return m


def _chunk_step(qf, kj, vj, kpos, acc, m, ell, window):
    """One KV chunk of ``_sdpa_chunked``'s online softmax: qf (B, H, S, D)
    float32 and pre-scaled, kj/vj (B, H, C, D) float32, kpos (C,) key
    positions, ``window`` the sliding window (0: none); carries acc (B, H,
    S, D), the running max m and denominator ell (B, H, S)."""
    qpos = torch.arange(qf.shape[2], device=qf.device)
    valid = qpos[:, None] >= kpos[None, :]
    if window:
        valid &= qpos[:, None] - kpos[None, :] < window
    s = torch.einsum("bhqd,bhcd->bhqc", qf, kj)
    s = torch.where(valid, s, float("-inf"))
    m_new = torch.maximum(m, torch.amax(s, dim=-1))  # stays -inf if all masked
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    pexp = torch.where(valid, torch.exp(s - safe_m[..., None]), 0.0)
    ell = ell * alpha + pexp.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bhqc,bhcd->bhqd", pexp, vj)
    return acc, m_new, ell


def _sdpa_chunked(cfg: ModelConfig, q, k, v) -> torch.Tensor:
    """Causal attention as a loop over KV chunks of ``cfg.attn_chunk``
    keys with an online softmax (running max, denominator and output
    accumulator in float32): the (S, S) scores never exist at once.  Each
    chunk's step is checkpointed (recomputed in the backward, nothing
    saved), as the JAX package remats its scan body, so the backward's
    working set stays (B, H, S, chunk).  q (B, S, H, D); k/v (B, S, KVH,
    D).  Returns (B, S, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    C = min(cfg.attn_chunk, Sq)
    if Sq % C:
        raise ValueError(f"_sdpa_chunked needs S % attn_chunk == 0, got S={Sq} chunk={C}")
    qf = (q.to(torch.float32) * (1.0 / math.sqrt(D))).transpose(1, 2)  # (B, H, S, D)
    kf = k.to(torch.float32).transpose(1, 2)
    vf = v.to(torch.float32).transpose(1, 2)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), float("-inf"), dtype=torch.float32, device=q.device)
    ell = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for j in range(Sq // C):
        kpos = torch.arange(j * C, (j + 1) * C, device=q.device)
        acc, m, ell = checkpoint(_chunk_step, qf, kf[:, :, j * C:(j + 1) * C],
                                 vf[:, :, j * C:(j + 1) * C], kpos, acc, m, ell,
                                 cfg.sliding_window, use_reentrant=False)
    out = acc / torch.clamp(ell, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention_train(p, cfg: ModelConfig, x, positions, freqs, group=None) -> torch.Tensor:
    """Full-sequence causal attention for training: the dense ``_sdpa``,
    or ``_sdpa_chunked`` for ``attn_impl="chunked"`` past ``attn_chunk``
    tokens, as the JAX package routes it.  Under ``group``, this rank's
    heads and its partial sum of the output projection."""
    check_attention(cfg)
    q, k, v = _project_qkv(p, cfg, x, group)
    rank, M = rank_and_size(group)
    k, v = local_kv(cfg, k, rank, M), local_kv(cfg, v, rank, M)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, freqs)
        k = apply_rope(k, positions, freqs)
    S = x.shape[1]
    if cfg.attn_impl == "chunked" and S > cfg.attn_chunk:
        out = _sdpa_chunked(cfg, q, k, v)
    else:
        out = _sdpa(cfg, q, k, v, causal_mask(S, S, cfg.sliding_window, device=x.device))
    return out.reshape(*x.shape[:2], -1) @ p["wo"].to(x.dtype)


def attention_decode(p, cfg: ModelConfig, x, pos, cache_k, cache_v, freqs, group=None):
    """One-token decode with a KV cache.

    x (B, 1, d); pos (B,) int positions; cache_k/v (B, S_max, KVH, D),
    written in place at each row's position, or, with a sliding window,
    at ``pos % S_max`` of the ring (S_max = min(max_seq, window)), every
    slot of which is live once ``pos >= S_max``.  Returns (out (B, 1, d),
    cache_k, cache_v).  Under ``group`` the cache holds the KV heads this
    rank holds, and ``out`` is its partial sum."""
    check_attention(cfg)
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, group)  # q (B,1,H,D), k/v (B,1,KVH,D)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, pos[:, None], freqs)
        k = apply_rope(k, pos[:, None], freqs)
    S_max = cache_k.shape[1]
    ring = bool(cfg.sliding_window)
    slot = pos % S_max if ring else pos
    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, slot] = k[:, 0]
    cache_v[bidx, slot] = v[:, 0]
    valid = torch.arange(S_max, device=x.device)[None, :] <= slot[:, None]
    if ring:
        valid = valid | (pos[:, None] >= S_max)
    rank, M = rank_and_size(group)
    out = _sdpa(cfg, q, local_kv(cfg, cache_k, rank, M), local_kv(cfg, cache_v, rank, M),
                valid[:, None, None, :])
    out = out.reshape(B, 1, -1) @ p["wo"].to(x.dtype)
    return out, cache_k, cache_v


# --- MLP ---------------------------------------------------------------------


def init_mlp(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    d, f = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    so = 1.0 / math.sqrt(f) / math.sqrt(2 * cfg.n_layers)
    pd = cfg.param_dtype
    if cfg.act == "swiglu":
        p = {
            "wi": truncated_normal(generator, (d, f), s, pd),
            "wg": truncated_normal(generator, (d, f), s, pd),
            "wo": truncated_normal(generator, (f, d), so, pd),
        }
        return {k: v.to(device) for k, v in p.items()}
    return {
        "wi": truncated_normal(generator, (d, f), s, pd).to(device),
        "bi": torch.zeros((f,), dtype=pd, device=device),
        "wo": truncated_normal(generator, (f, d), so, pd).to(device),
        "bo": torch.zeros((d,), dtype=pd, device=device),
    }


def mlp_partial(p, cfg: ModelConfig, x):
    """The MLP without its output bias: under tensor parallelism this
    rank's partial sum over its slice of the ff axis."""
    dt = x.dtype
    if cfg.act == "swiglu":
        h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
    else:
        h = F.gelu(x @ p["wi"].to(dt) + p["bi"].to(dt), approximate="tanh")  # jax.nn.gelu's default
    return h @ p["wo"].to(dt)


def mlp_bias(p, cfg: ModelConfig, y):
    """``y`` plus the MLP's output bias (the GELU MLP's ``bo``; swiglu has
    none), added once after the partial sums."""
    return y if cfg.act == "swiglu" else y + p["bo"].to(y.dtype)


def apply_mlp(p, cfg: ModelConfig, x):
    return mlp_bias(p, cfg, mlp_partial(p, cfg, x))
