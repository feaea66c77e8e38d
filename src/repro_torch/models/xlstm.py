"""xLSTM blocks (Beck et al. 2024): the mLSTM (a matrix memory, chunkwise
parallel) and the sLSTM (a scalar memory, strictly recurrent), the
counterpart of the JAX package's ``repro/models/xlstm.py``.

xlstm-1.3b stacks 48 blocks, one sLSTM after every 7 mLSTM blocks (the
xLSTM[7:1] ratio).  There is no separate FFN: the mLSTM block carries its
own 2x up-projection, the sLSTM a gated FFN.

mLSTM:
  * train/prefill (``mlstm_train``): the stabilised chunkwise form, as the
    JAX package computes it.  Inside a chunk of ``chunk`` tokens
    D_tj = exp(sum_{l=j+1..t} logsig(f_l) + log i_j - m_t) weighs
    h = (Q K^T * D) V; a (C, n, m) state carries the rest of the sequence
    from chunk to chunk.  Any S is taken, the last chunk ragged (the JAX
    package asserts S % chunk == 0); the chunkwise form is exact algebra,
    so chunk sizes agree to float noise.  The state update
    einsum("bjh,bjhd,bjhe->bhde") is one batched product (gate * K)^T V
    into C in place: the (B, chunk, H, hd, hd) product never exists.
  * decode (``mlstm_decode``): the recurrent (C, n, m) update, O(1) a
    token, C updated in place (a scale, then a rank-1 ``baddbmm_``).

sLSTM (``slstm_seq``): the scalar recurrence with exponential gating, a
Python loop over time where the JAX package runs ``lax.scan``: one
``baddbmm`` with the per-head recurrent weights (H, hd, 4hd) and eleven
elementwise launches a step, written into buffers made once (at 4 heads,
xlstm-1.3b's, the product's output is the gates' split as it stands).

The projections run in the activations' dtype, the gates and the chunk
and recurrence math in float32, the output norms in the activations'
dtype, step for step as in the JAX package.  The stabiliser m starts at
-inf, as there: exp(-inf) gives 0, and every max keeps a finite term, so
no -inf - -inf arises.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import truncated_normal

MLSTM_CHUNK = 256


# --- mLSTM -------------------------------------------------------------------


def init_mlstm(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    d = cfg.d_model
    di = 2 * d  # fixed 2x up-projection (xLSTM paper)
    H = cfg.n_heads
    hd = di // H
    pd = cfg.param_dtype
    s = 1.0 / math.sqrt(d)
    si = 1.0 / math.sqrt(hd)
    p = {
        "up": truncated_normal(generator, (d, 2 * di), s, pd),  # x & gate z
        "wq": truncated_normal(generator, (di, di), si, pd),
        "wk": truncated_normal(generator, (di, di), si, pd),
        "wv": truncated_normal(generator, (di, di), si, pd),
        "wi": truncated_normal(generator, (di, H), s, pd),  # input gate
        "wf": truncated_normal(generator, (di, H), s, pd),  # forget gate
    }
    p = {k: v.to(device) for k, v in p.items()}
    p["bf"] = torch.full((H,), 3.0, dtype=pd, device=device)  # forget-bias init (remember)
    p["bi"] = torch.zeros((H,), dtype=pd, device=device)
    p["ln_scale"] = torch.ones((di,), dtype=pd, device=device)
    p["down"] = truncated_normal(
        generator, (di, d), 1.0 / math.sqrt(di) / math.sqrt(2 * cfg.n_layers), pd).to(device)
    return p


def _mlstm_qkvgates(p, cfg: ModelConfig, x):
    """x (B, S, d) -> q, k, v (B, S, H, hd) in x's dtype, log-gates i, f
    (B, S, H) float32, gate z (B, S, di)."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = 2 * d // H
    dt = x.dtype
    up = x @ p["up"].to(dt)  # (B, S, 2di)
    xm, z = torch.chunk(up, 2, dim=-1)
    q = (xm @ p["wq"].to(dt)).view(B, S, H, hd)
    k = (xm @ p["wk"].to(dt)).view(B, S, H, hd) / math.sqrt(hd)
    v = (xm @ p["wv"].to(dt)).view(B, S, H, hd)
    ig = (xm @ p["wi"].to(dt)).to(torch.float32) + p["bi"].to(torch.float32)
    fg = (xm @ p["wf"].to(dt)).to(torch.float32) + p["bf"].to(torch.float32)
    return q, k, v, ig, fg, z


def _headnorm(h, scale, eps=1e-6):
    """Per-head RMS norm, then the heads flattened (the xLSTM output norm)."""
    B, S, H, hd = h.shape
    var = (h * h).mean(-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return h.reshape(B, S, H * hd) * scale.to(h.dtype)


def _out(p, x_in, h, z):
    """The block's output from h (B, S, H, hd) float32: the head norm in
    x's dtype, the z gate, the down projection."""
    out = _headnorm(h.to(x_in.dtype), p["ln_scale"]) * F.silu(z)
    return out @ p["down"].to(x_in.dtype)


def mlstm_train(p, cfg: ModelConfig, x_in, *, chunk: int = MLSTM_CHUNK):
    """Chunkwise-parallel stabilised mLSTM.  x_in (B, S, d) -> (out (B, S,
    d), (C (B, H, hd, hd), n (B, H, hd), m (B, H)) float32, the state after
    the last token)."""
    q, k, v, ig, fg, z = _mlstm_qkvgates(p, cfg, x_in)
    B, S, H, hd = q.shape
    f32 = torch.float32
    dev = x_in.device
    # (B, H, S, .) float32, made once for every chunk
    qf, kf, vf = (t.transpose(1, 2).to(f32, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    ii = ig.transpose(1, 2).contiguous()  # (B, H, S) log input gate
    lf = F.logsigmoid(fg).transpose(1, 2).contiguous()  # (B, H, S) log forget gate
    C, n, m = init_mlstm_state(cfg, B, device=dev)
    Cb = C.view(B * H, hd, hd)
    hs = torch.empty((B, H, S, hd), dtype=f32, device=dev)
    tri = torch.ones((min(chunk, S),) * 2, dtype=torch.bool, device=dev).tril_()
    for s0 in range(0, S, chunk):
        s1 = min(s0 + chunk, S)
        n_t = s1 - s0
        qi, ki, vi = qf[:, :, s0:s1], kf[:, :, s0:s1], vf[:, :, s0:s1]
        ic = ii[:, :, s0:s1]
        csum = lf[:, :, s0:s1].cumsum(-1)  # inclusive logf cumsum over the chunk
        # intra gate matrix: sum_{l=j+1..t} logf_l + log i_j = csum_t - csum_j + i_j
        logD = csum[..., :, None] - csum[..., None, :] + ic[..., None, :]  # (B, H, t, j)
        logD.masked_fill_(~tri[:n_t, :n_t], -math.inf)
        # per-query stabiliser: the max over the intra gates and the carried m
        m_inter = m[..., None] + csum  # (B, H, t)
        m_new = torch.maximum(logD.amax(-1), m_inter)
        w = (qi @ ki.transpose(-1, -2)) * torch.exp(logD - m_new[..., None])
        inter = torch.exp(m_inter - m_new)  # (B, H, t)
        # numerator: the intra attention-like term and the carried state's readout
        h_num = (qi @ C) * inter[..., None]
        h_num += w @ vi
        # denominator: q . n_total = sum_j w[t, j] + the inter part
        qn = w.sum(-1) + (qi @ n[..., None])[..., 0] * inter
        den = torch.maximum(qn.abs(), torch.exp(-m_new))
        torch.div(h_num, den[..., None], out=hs[:, :, s0:s1])
        # ---- the state at the end of the chunk ----
        tot = csum[..., -1]  # (B, H) total decay across the chunk
        decay = tot[..., None] - csum  # sum_{l=j+1..end} logf_l
        m_next = torch.maximum(m + tot, (ic + decay).amax(-1))
        scale_old = torch.exp(m + tot - m_next)  # (B, H)
        gk = ki * torch.exp(decay + ic - m_next[..., None])[..., None]  # (B, H, j, hd)
        C.mul_(scale_old[..., None, None])
        Cb.baddbmm_(gk.reshape(B * H, n_t, hd).transpose(1, 2), vi.reshape(B * H, n_t, hd))
        n.mul_(scale_old[..., None]).add_(gk.sum(-2))
        m = m_next
    return _out(p, x_in, hs.transpose(1, 2), z), (C, n, m)


def mlstm_decode(p, cfg: ModelConfig, x_in, state):
    """One-token recurrent mLSTM step.  x_in (B, 1, d); state = (C (B, H,
    hd, hd) contiguous, n (B, H, hd), m (B, H)) float32, each updated in
    place.  Returns (out (B, 1, d), state)."""
    q, k, v, ig, fg, z = _mlstm_qkvgates(p, cfg, x_in)  # S = 1
    C, n, m = state
    B, _, H, hd = q.shape
    q1, k1, v1 = (t[:, 0].to(torch.float32) for t in (q, k, v))  # (B, H, hd)
    lfm = F.logsigmoid(fg[:, 0]) + m  # (B, H)
    m_new = torch.maximum(lfm, ig[:, 0])
    f = torch.exp(lfm - m_new)
    ik = k1 * torch.exp(ig[:, 0] - m_new)[..., None]
    C.mul_(f[..., None, None])
    C.view(B * H, hd, hd).baddbmm_(ik[..., None].view(B * H, hd, 1), v1.reshape(B * H, 1, hd))
    n.mul_(f[..., None]).add_(ik)
    num = torch.bmm(q1.reshape(B * H, 1, hd), C.view(B * H, hd, hd)).view(B, H, hd)
    den = torch.maximum((q1 * n).sum(-1).abs(), torch.exp(-m_new))
    m.copy_(m_new)
    return _out(p, x_in, (num / den[..., None])[:, None], z), (C, n, m)


def init_mlstm_state(cfg: ModelConfig, batch: int, device="cuda"):
    di = 2 * cfg.d_model
    H = cfg.n_heads
    hd = di // H
    return (
        torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        torch.zeros((batch, H, hd), dtype=torch.float32, device=device),
        torch.full((batch, H), -math.inf, dtype=torch.float32, device=device),
    )


# --- sLSTM -------------------------------------------------------------------


def slstm_ffn_dim(cfg: ModelConfig) -> int:
    """~4/3·d gated-FFN width, rounded up to a multiple of 128."""
    return ((4 * cfg.d_model // 3) + 127) // 128 * 128


def init_slstm(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    f = slstm_ffn_dim(cfg)
    pd = cfg.param_dtype
    s = 1.0 / math.sqrt(d)
    p = {
        # z/i/f/o pre-activations from the input and per-head recurrent weights
        "wx": truncated_normal(generator, (d, 4 * d), s, pd),
        "wr": truncated_normal(generator, (H, hd, 4 * hd), 1.0 / math.sqrt(hd), pd),
        "up": truncated_normal(generator, (d, 2 * f), s, pd),
        "down": truncated_normal(
            generator, (f, d), 1.0 / math.sqrt(f) / math.sqrt(2 * cfg.n_layers), pd),
    }
    p = {k: v.to(device) for k, v in p.items()}
    p["b"] = torch.cat([torch.zeros((2 * d,)), torch.full((d,), 3.0),
                        torch.zeros((d,))]).to(pd).to(device)
    p["ln_scale"] = torch.ones((d,), dtype=pd, device=device)
    return {key: p[key] for key in ("wx", "wr", "b", "ln_scale", "up", "down")}


def slstm_seq(p, cfg: ModelConfig, x_in, state=None):
    """The sLSTM over a whole sequence.  x_in (B, S, d) -> (out (B, S, d),
    (c, n, h, m) each (B, d) float32, the state after the last token).
    ``state`` (optional, the same four) is the state before the first
    token (decode passes its cache's); the default is
    ``init_slstm_state``'s."""
    B, S, d = x_in.shape
    H = cfg.n_heads
    hd = d // H
    f32 = torch.float32
    dev = x_in.device
    zx = x_in @ p["wx"].to(x_in.dtype) + p["b"].to(x_in.dtype)  # (B, S, 4d)
    # (S, H, B, 4hd): step t's input to the per-head product, float32
    zx_t = zx.view(B, S, H, 4 * hd).permute(1, 2, 0, 3).to(
        f32, memory_format=torch.contiguous_format)
    wr = p["wr"].to(f32)  # (H, hd, 4hd)
    if state is None:
        state = init_slstm_state(cfg, B, device=dev)
    c, n, h, m = state
    # step buffers and their views, made once: each step writes into them
    za = torch.empty((H, B, 4 * hd), dtype=f32, device=dev)
    g = za.transpose(0, 1).reshape(B, 4, d)  # JAX's split of (B, 4d): z, i, f, o
    split = g.data_ptr() != za.data_ptr()  # not a view (n_heads not 4): copied a step
    g_z, g_i, g_f, g_o, g_if = g[:, 0], g[:, 1], g[:, 2], g[:, 3], g[:, 1:3]
    cn = torch.stack([c, n], 1)  # (B, 2, d): c and n scale and add together
    c_now, n_now = cn[:, 0], cn[:, 1]
    zo = torch.ones((B, 2, d), dtype=f32, device=dev)  # [tanh(z), 1]
    z_now = zo[:, 0]
    m = m.clone()
    m_col = m[:, None]
    s = torch.empty((B, 2, d), dtype=f32, device=dev)  # [i_s, f_s]
    i_s, f_s = s[:, 0:1], s[:, 1:2]
    hs = torch.empty((S, B, d), dtype=f32, device=dev)
    h_heads = hs.view(S, B, H, hd).transpose(1, 2)  # (S, H, B, hd) views of each step's h
    h_prev = h.reshape(B, H, hd).transpose(0, 1)
    for t in range(S):
        torch.baddbmm(zx_t[t], h_prev, wr, out=za)
        if split:
            g.copy_(za.transpose(0, 1).reshape(B, 4, d))
        torch.add(F.logsigmoid(g_f), m, out=g_f)  # logf + m
        torch.maximum(g_f, g_i, out=m)
        torch.sub(g_if, m_col, out=s).exp_()
        torch.tanh(g_z, out=z_now)
        cn.mul_(f_s).addcmul_(i_s, zo)  # c = f_s c + i_s z, n = f_s n + i_s
        h = hs[t]
        torch.mul(torch.sigmoid(g_o), c_now, out=h)
        h.div_(n_now.clamp_min(1.0))
        h_prev = h_heads[t]
    hseq = hs.transpose(0, 1).to(x_in.dtype)  # (B, S, d)
    # output norm and gated FFN (xLSTM post-up-projection, factor 4/3)
    var = (hseq.to(f32) ** 2).mean(-1, keepdim=True)
    hseq = (hseq * torch.rsqrt(var + 1e-6).to(hseq.dtype)) * p["ln_scale"].to(hseq.dtype)
    a, gate = torch.chunk(hseq @ p["up"].to(hseq.dtype), 2, dim=-1)
    out = (F.gelu(a, approximate="tanh") * gate) @ p["down"].to(hseq.dtype)  # jax.nn.gelu
    return out, (c_now, n_now, h, m)


def init_slstm_state(cfg: ModelConfig, batch: int, device="cuda"):
    d = cfg.d_model
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return (z, z, z, torch.full((batch, d), -math.inf, dtype=torch.float32, device=device))
