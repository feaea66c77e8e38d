"""Selective SSM (Mamba-style S6), the SSM branch of hymba's hybrid heads:
the counterpart of the JAX package's ``repro/models/ssm.py``.

Diagonal selective state space: per channel i and state n,
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t
    y_t = <C_t, h_t> + D * x_t
with input-dependent dt_t, B_t, C_t (the "selective" part).

``ssm_train`` evaluates the recurrence chunkwise, as the JAX package
does: a loop over chunks of ``chunk`` tokens carries the (B, di, ds)
float32 state, and inside a chunk a log-depth scan runs over the chunk
axis (Hillis-Steele doubling of (a, b) o (a', b') = (a a', a' b + b')),
so the 4-D (B, chunk, di, ds) decay and drive tensors exist one chunk at
a time: 52 MB at hymba's widths (di 3200, ds 16, chunk 256).  Any S is
taken, the last chunk ragged (the JAX package asserts S % chunk == 0).
The carry enters the chunk's first drive term before the scan, where the
JAX package adds ``A_cum * h0`` after it: the same recurrence, rounded in
another order.  With ``return_state`` it also returns the terminal
(ssm_state, conv_state) that a prefill leaves in the cache, which the
JAX package recomputes with a second, sequential scan
(``lm._ssm_terminal_state``).

Decode carries the state explicitly: O(1) a token.  Plain torch
throughout, as the JAX package computes all of it in ``jnp``, outside
any Pallas kernel.

Tensor parallel (``group=``, a model group of M ranks; ``models/lm.py``):
a rank holds di/M channels: its slice of ``in_proj``'s x half and of its
z half, of ``conv``, ``dt_bias``, ``A_log`` and ``D``, and its rows of
``x_proj`` and ``out_proj``.  ``ssm_project`` gives its channels' conv'd
x, gate z and its partial sum of the (B, S, 2 ds + 1) selective
projection, which is reduced over the group and enters the region again
through ``shard.copy_to_group`` (its gradient from each rank's channels
summed); ``ssm_scan`` runs the recurrence on the rank's channels and
returns its partial sum of the output, which the caller reduces.  The
cache's state and conv input split their channels.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import truncated_normal
from repro_torch.shard import copy_to_group, reduce_from_group

DEFAULT_CHUNK = 256


def init_ssm(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    d, di, ds = cfg.d_model, cfg.ssm_inner, cfg.ssm_state
    pd = cfg.param_dtype
    s = 1.0 / math.sqrt(d)
    # S4D-real init for A: -(1..ds) per state, shared log-param per channel
    A = torch.arange(1, ds + 1, dtype=torch.float32, device=device).repeat(di, 1)
    p = {
        "in_proj": truncated_normal(generator, (d, 2 * di), s, pd),
        "conv": truncated_normal(generator, (cfg.ssm_conv, di), 1.0 / math.sqrt(cfg.ssm_conv),
                                 pd),
        "x_proj": truncated_normal(generator, (di, 2 * ds + 1), 1.0 / math.sqrt(di), pd),
        "out_proj": truncated_normal(
            generator, (di, d), 1.0 / math.sqrt(di) / math.sqrt(2 * cfg.n_layers), pd),
    }
    p = {k: v.to(device) for k, v in p.items()}
    p["dt_bias"] = torch.full((di,), -4.6, dtype=pd, device=device)  # softplus^-1(0.01)
    p["A_log"] = torch.log(A).to(pd)
    p["D"] = torch.ones((di,), dtype=pd, device=device)
    return p


def _split_proj(p, cfg: ModelConfig, proj):
    """The selective terms from the projection: dt (B, S, di) float32,
    B_t, C_t (B, S, ds)."""
    ds = cfg.ssm_state
    B_t = proj[..., :ds]
    C_t = proj[..., ds:2 * ds]
    # dt: shared per-token scalar + per-channel bias (dt_rank=1 variant)
    dt = F.softplus(proj[..., 2 * ds:].to(torch.float32) + p["dt_bias"].to(torch.float32))
    return dt, B_t, C_t


def ssm_project(p, cfg: ModelConfig, x_in, conv_state=None):
    """A rank's share of the branch before its one collective: x_in (B,
    S, d) through its slice of ``in_proj`` and the conv -> (its channels'
    conv'd x (B, S, di), gate z, its partial sum of the selective
    projection (B, S, 2*ds+1), its channels' new conv state (B, K-1, di)
    in x's dtype: the last K-1 inputs of the conv, for the next decode
    step).  Summed over the ranks, the projections are the whole one
    (``ssm_scan`` takes it)."""
    x, z = torch.chunk(x_in @ p["in_proj"].to(x_in.dtype), 2, dim=-1)  # (B, S, di) each
    K, S = cfg.ssm_conv, x.shape[1]
    if conv_state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    new_conv_state = xp[:, -(K - 1):] if K > 1 else None
    # depthwise causal conv via K shifted adds (K is tiny, typically 4)
    w = p["conv"].to(x.dtype)
    conv = xp[:, :S] * w[0]
    for i in range(1, K):
        conv = conv + xp[:, i:i + S] * w[i]
    x = F.silu(conv)
    return x, z, x @ p["x_proj"].to(x.dtype), new_conv_state


def _whole_proj(proj, group):
    """The ranks' partial projections summed; the gradient each rank's
    channels send back summed over the group."""
    return copy_to_group(reduce_from_group(proj, group), group)


def _scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over axis 1
    of a, b (B, n, di, ds), in ceil(log2 n) doubling steps: after the step
    of offset d each (a_t, b_t) composes the terms (t - 2d, t]."""
    n, d = a.shape[1], 1
    while d < n:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], dim=1)
        if 2 * d < n:  # the last step needs no products of a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def selective_scan(dt, B_t, C_t, x, A, *, chunk: int = DEFAULT_CHUNK):
    """The recurrence over a sequence from a zero state, chunk by chunk:
    dt, x (B, S, di) and B_t, C_t (B, S, ds), all float32, A (di, ds).
    Returns (y (B, S, di) = <C_t, h_t> without the skip term, the state
    h (B, di, ds) after the last token)."""
    B, S, di = x.shape
    h = torch.zeros((B, di, A.shape[1]), dtype=torch.float32, device=x.device)
    ys = []
    for s0 in range(0, S, chunk):
        dt_i = dt[:, s0:s0 + chunk]
        a = torch.exp(dt_i[..., None] * A)  # (B, chunk, di, ds)
        bx = (dt_i * x[:, s0:s0 + chunk])[..., None] * B_t[:, s0:s0 + chunk, None, :]
        bx[:, 0] += a[:, 0] * h  # the carry
        hs = _scan(a, bx)
        del a, bx
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, C_t[:, s0:s0 + chunk]))
        h = hs[:, -1].clone()
        del hs
    return torch.cat(ys, dim=1), h


def ssm_scan(p, cfg: ModelConfig, x, z, proj, *, chunk: int = DEFAULT_CHUNK):
    """The recurrence on a rank's channels: its conv'd x and gate z (B, S,
    di/M) and the whole selective projection ``proj`` -> (its partial sum
    of the output (B, S, d) through its rows of ``out_proj``, its channels'
    state (B, di/M, ds) float32 after the last token)."""
    dt, B_t, C_t = _split_proj(p, cfg, proj)
    A = -torch.exp(p["A_log"].to(torch.float32))  # (di, ds)
    xf = x.to(torch.float32)
    y, h = selective_scan(dt, B_t.to(torch.float32), C_t.to(torch.float32), xf, A, chunk=chunk)
    y = y + xf * p["D"].to(torch.float32)
    y = (y * F.silu(z.to(torch.float32))).to(z.dtype)
    return y @ p["out_proj"].to(z.dtype), h


def ssm_train(p, cfg: ModelConfig, x_in, *, chunk: int = DEFAULT_CHUNK,
              return_state: bool = False, group=None):
    """Full-sequence chunked selective scan.  x_in (B, S, d) -> (B, S, d);
    with ``return_state``, (y, (ssm_state (B, di, ds) float32, conv_state
    (B, K-1, di))), the state after the last token.  Under ``group`` (x_in
    inside the region) this rank's channels: its partial sum of y, its
    channels' states."""
    x, z, proj, conv_state = ssm_project(p, cfg, x_in)
    out, h = ssm_scan(p, cfg, x, z, _whole_proj(proj, group), chunk=chunk)
    return (out, (h, conv_state)) if return_state else out


def ssm_decode(p, cfg: ModelConfig, x_in, ssm_state, conv_state, group=None):
    """One-token step.  x_in (B, 1, d); ssm_state (B, di, ds) float32;
    conv_state (B, K-1, di).  Returns (y (B, 1, d), ssm_state, conv_state);
    under ``group`` this rank's channels, as ``ssm_train``."""
    x, z, proj, new_conv = ssm_project(p, cfg, x_in, conv_state)
    dt, B_t, C_t = _split_proj(p, cfg, _whole_proj(proj, group))
    A = -torch.exp(p["A_log"].to(torch.float32))
    a = torch.exp(dt[:, 0, :, None] * A)  # (B, di, ds)
    x0 = x[:, 0].to(torch.float32)
    bx = (dt[:, 0] * x0)[..., None] * B_t[:, 0].to(torch.float32)[:, None, :]
    h = a * ssm_state + bx  # (B, di, ds)
    y = torch.einsum("bdn,bn->bd", h, C_t[:, 0].to(torch.float32))
    y = y + x0 * p["D"].to(torch.float32)
    y = (y * F.silu(z[:, 0].to(torch.float32)))[:, None].to(x_in.dtype)
    return y @ p["out_proj"].to(x_in.dtype), h, new_conv


def init_ssm_state(cfg: ModelConfig, batch: int, device="cuda"):
    return (
        torch.zeros((batch, cfg.ssm_inner, cfg.ssm_state), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.ssm_conv - 1, cfg.ssm_inner), dtype=torch.float32,
                    device=device),
    )
