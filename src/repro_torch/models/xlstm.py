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
    added to C: the (B, chunk, H, hd, hd) product never exists.
  * decode (``mlstm_decode``): the recurrent (C, n, m) update, O(1) a
    token, C updated in place (a scale, then a rank-1 ``baddbmm_``).

sLSTM (``slstm_seq``): the scalar recurrence with exponential gating, a
Python loop over time where the JAX package runs ``lax.scan``: one
``baddbmm`` with the per-head recurrent weights (H, hd, 4hd) and the
gates' elementwise ops a step (at 4 heads, xlstm-1.3b's, the product's
output is the gates' split as it stands).

Each sequence form has two bodies.  Under ``torch.no_grad()`` or
``inference_mode()`` (serving) the state moves on in place and the steps
write into buffers made once; with grad enabled (training) every update
is out of place, the chunks and steps are taken through one ``split`` or
``unbind`` (whose backward concatenates once, where indexing would give
each chunk or step a zero gradient of the whole sequence), the chunks'
and steps' h are concatenated once, and the sLSTM's gradients at a tie
are those of JAX's ``maximum`` (half to each side; from the zero state
the first step's n is exactly 1, though that gradient cancels, since the
first step's i_s is 1 whatever the input gate).  The two bodies give the
same values (the mLSTM's bit for bit).

The projections run in the activations' dtype, the gates and the chunk
and recurrence math in float32, the output norms in the activations'
dtype, step for step as in the JAX package.  The stabiliser m starts at
-inf, as there: exp(-inf) gives 0, and every max keeps a finite term, so
no -inf - -inf arises.

Tensor parallel (``group=``, a model group of M ranks; ``models/lm.py``).
The mLSTM splits its heads: a rank holds its di/M slice of ``up``'s x
half and of its z half (``mlstm_up``), the columns of its heads of
``wq``, ``wk``, ``wv``, ``wi`` and ``wf`` and their slices of ``bi``,
``bf`` and ``ln_scale``, and its rows of ``down``.  The x half is
gathered (every head reads all of it) and enters the region again, so
that the heads' gradients of it are summed; a rank's heads then run the
chunkwise form and the recurrent state (C, n, m) alone, and its partial
output through ``down`` is reduced.  The sLSTM keeps its recurrence
whole on every rank: JAX's split of the (B, 4d) pre-activations into z,
i, f and o puts gate g of every channel on head g's recurrent product
(at 4 heads), so each channel's step reads every head's h, and a split
state would need an all-gather of h every token.  A rank computes its
columns of ``wx`` and ``b`` (``slstm_input``), the (B, S, 4d) input is
gathered once before the loop, every rank runs the same steps with
``wr`` and the state whole (no collective inside the loop), and the FFN
after the output norm splits ``up``'s a and gate halves and ``down``'s
rows, reduced once.  Without a group every function is the unsharded
one.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import truncated_normal
from repro_torch.shard import copy_to_group, gather_last, reduce_from_group

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


def mlstm_up(p, x):
    """x (B, S, d) -> the up-projection's x half and gate z (B, S, di):
    under tensor parallelism a rank's di/M of each."""
    return torch.chunk(x @ p["up"].to(x.dtype), 2, dim=-1)


def _whole_xm(xm, group):
    """The ranks' slices of the x half gathered; backward, the heads'
    gradients of it summed over the group, and each rank's slice kept."""
    return copy_to_group(gather_last(xm, group), group)


def _mlstm_qkvgates(p, cfg: ModelConfig, xm):
    """xm (B, S, di), the whole x half -> q, k, v (B, S, H, hd) in xm's
    dtype and log-gates i, f (B, S, H) float32, of the heads whose columns
    of wq, wk, wv, wi and wf ``p`` holds."""
    B, S, di = xm.shape
    hd = di // cfg.n_heads
    dt = xm.dtype
    q = (xm @ p["wq"].to(dt)).view(B, S, -1, hd)
    k = (xm @ p["wk"].to(dt)).view(B, S, -1, hd) / math.sqrt(hd)
    v = (xm @ p["wv"].to(dt)).view(B, S, -1, hd)
    ig = (xm @ p["wi"].to(dt)).to(torch.float32) + p["bi"].to(torch.float32)
    fg = (xm @ p["wf"].to(dt)).to(torch.float32) + p["bf"].to(torch.float32)
    return q, k, v, ig, fg


def _headnorm(h, scale, eps=1e-6):
    """Per-head RMS norm, then the heads flattened (the xLSTM output norm)."""
    B, S, H, hd = h.shape
    var = (h * h).mean(-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return h.reshape(B, S, H * hd) * scale.to(h.dtype)


def _out(p, h, z):
    """The block's output from h (B, S, H, hd) float32: the head norm in
    z's dtype (x's), the z gate, the down projection (a rank's partial
    sum through its rows)."""
    out = _headnorm(h.to(z.dtype), p["ln_scale"]) * F.silu(z)
    return out @ p["down"].to(z.dtype)


def mlstm_train(p, cfg: ModelConfig, x_in, *, chunk: int = MLSTM_CHUNK, group=None):
    """Chunkwise-parallel stabilised mLSTM.  x_in (B, S, d) -> (out (B, S,
    d), (C (B, H, hd, hd), n (B, H, hd), m (B, H)) float32, the state after
    the last token).  With grad enabled, out of place (see the module
    docstring).  Under ``group`` this rank's heads' states, and the output
    summed over the ranks."""
    x_in = copy_to_group(x_in, group)
    xm, z = mlstm_up(p, x_in)
    out, state = mlstm_heads(p, cfg, _whole_xm(xm, group), z, chunk=chunk)
    return reduce_from_group(out, group), state


def mlstm_heads(p, cfg: ModelConfig, xm, z, *, chunk: int = MLSTM_CHUNK):
    """A rank's share of ``mlstm_train`` from the whole x half xm (B, S,
    di) and its slice of the gate z: (its partial sum of the output, its
    heads' terminal state)."""
    q, k, v, ig, fg = _mlstm_qkvgates(p, cfg, xm)
    B, S, H, hd = q.shape
    f32 = torch.float32
    dev = xm.device
    grad = torch.is_grad_enabled()
    # (B, H, S, .) float32, made once for every chunk
    qf, kf, vf = (t.transpose(1, 2).to(f32, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    ii = ig.transpose(1, 2).contiguous()  # (B, H, S) log input gate
    lf = F.logsigmoid(fg).transpose(1, 2).contiguous()  # (B, H, S) log forget gate
    C, n, m = init_mlstm_state(cfg, B, device=dev, heads=H)
    hs = [] if grad else torch.empty((B, H, S, hd), dtype=f32, device=dev)
    tri = torch.ones((min(chunk, S),) * 2, dtype=torch.bool, device=dev).tril_()
    chunks = zip(*(t.split(chunk, dim=2) for t in (qf, kf, vf, ii, lf)))
    for s0, (qi, ki, vi, ic, lfi) in zip(range(0, S, chunk), chunks):
        n_t = qi.shape[2]
        csum = lfi.cumsum(-1)  # inclusive logf cumsum over the chunk
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
        if grad:
            hs.append(h_num / den[..., None])
        else:
            torch.div(h_num, den[..., None], out=hs[:, :, s0:s0 + n_t])
        # ---- the state at the end of the chunk ----
        tot = csum[..., -1]  # (B, H) total decay across the chunk
        decay = tot[..., None] - csum  # sum_{l=j+1..end} logf_l
        m_next = torch.maximum(m + tot, (ic + decay).amax(-1))
        scale_old = torch.exp(m + tot - m_next)  # (B, H)
        gk = ki * torch.exp(decay + ic - m_next[..., None])[..., None]  # (B, H, j, hd)
        gkt = gk.reshape(B * H, n_t, hd).transpose(1, 2)
        if grad:
            C = torch.baddbmm((C * scale_old[..., None, None]).view(B * H, hd, hd), gkt,
                              vi.reshape(B * H, n_t, hd)).view(B, H, hd, hd)
            n = n * scale_old[..., None] + gk.sum(-2)
        else:
            C.mul_(scale_old[..., None, None])
            C.view(B * H, hd, hd).baddbmm_(gkt, vi.reshape(B * H, n_t, hd))
            n.mul_(scale_old[..., None]).add_(gk.sum(-2))
        m = m_next
    if grad:
        hs = torch.cat(hs, dim=2)
    return _out(p, hs.transpose(1, 2), z), (C, n, m)


def mlstm_decode(p, cfg: ModelConfig, x_in, state, group=None):
    """One-token recurrent mLSTM step.  x_in (B, 1, d); state = (C (B, H,
    hd, hd) contiguous, n (B, H, hd), m (B, H)) float32, each updated in
    place.  Returns (out (B, 1, d), state); under ``group`` this rank's
    heads' state, as ``mlstm_train``."""
    xm, z = mlstm_up(p, x_in)
    q, k, v, ig, fg = _mlstm_qkvgates(p, cfg, _whole_xm(xm, group))  # S = 1
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
    return reduce_from_group(_out(p, (num / den[..., None])[:, None], z), group), (C, n, m)


def init_mlstm_state(cfg: ModelConfig, batch: int, device="cuda", heads: int | None = None):
    """The zero state (C, n, m) of ``heads`` heads (all of them by
    default)."""
    hd = 2 * cfg.d_model // cfg.n_heads
    H = cfg.n_heads if heads is None else heads
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


def slstm_input(p, x):
    """x (B, S, d) -> the gates' input pre-activations x wx + b (B, S, 4d)
    in x's dtype: under tensor parallelism a rank's 4d/M columns."""
    return x @ p["wx"].to(x.dtype) + p["b"].to(x.dtype)


def slstm_recur(p, cfg: ModelConfig, zx, state=None):
    """The recurrence from the whole pre-activations zx (B, S, 4d) and its
    output norm: (h (B, S, d) normed in zx's dtype, (c, n, h, m) each (B,
    d) float32 after the last token).  ``state`` as ``slstm_seq``'s."""
    B, S, d4 = zx.shape
    H = cfg.n_heads
    hd = d4 // 4 // H
    f32 = torch.float32
    # (S, H, B, 4hd): step t's input to the per-head product, float32
    zx_t = zx.view(B, S, H, 4 * hd).permute(1, 2, 0, 3).to(
        f32, memory_format=torch.contiguous_format)
    wr = p["wr"].to(f32)  # (H, hd, 4hd)
    if state is None:
        state = init_slstm_state(cfg, B, device=zx.device)
    if torch.is_grad_enabled():
        hs, c, n, m = _Recurrence.apply(zx_t, wr, *state)  # hs (S, B, d)
        state = (c, n, hs[-1], m)
    else:
        hs, state = _slstm_steps_in_place(zx_t, wr, state)
    hseq = hs.transpose(0, 1).to(zx.dtype)  # (B, S, d)
    # output norm (the FFN, ``slstm_ffn``, follows: xLSTM post-up-projection, factor 4/3)
    var = (hseq.to(f32) ** 2).mean(-1, keepdim=True)
    return (hseq * torch.rsqrt(var + 1e-6).to(hseq.dtype)) * p["ln_scale"].to(hseq.dtype), state


def slstm_ffn(p, h):
    """The gated FFN on the normed h (B, S, d): a rank's partial sum over
    its slices of ``up``'s a and gate halves and its rows of ``down``."""
    a, gate = torch.chunk(h @ p["up"].to(h.dtype), 2, dim=-1)
    return (F.gelu(a, approximate="tanh") * gate) @ p["down"].to(h.dtype)  # jax.nn.gelu


def slstm_seq(p, cfg: ModelConfig, x_in, state=None, *, group=None):
    """The sLSTM over a whole sequence.  x_in (B, S, d) -> (out (B, S, d),
    (c, n, h, m) each (B, d) float32, the state after the last token).
    ``state`` (optional, the same four) is the state before the first
    token (decode passes its cache's); the default is
    ``init_slstm_state``'s.  With grad enabled, out of place (see the module
    docstring).  Under ``group`` every rank runs the whole recurrence from
    the gathered pre-activations (one all-gather before the loop) and the
    FFN's partial sums are reduced (one all-reduce after it)."""
    x_in = copy_to_group(x_in, group)
    h, state = slstm_recur(p, cfg, gather_last(slstm_input(p, x_in), group), state)
    return reduce_from_group(slstm_ffn(p, copy_to_group(h, group)), group), state


def _gates(za, B: int, d: int):
    """The step's product (H, B, 4hd) as JAX's split of (B, 4d): (B, 4, d),
    z, i, f, o along axis 1 (a view at 4 heads)."""
    return za.transpose(0, 1).reshape(B, 4, d)


def _slstm_steps(zx_t, wr, state):
    """The recurrence as plain autograd sees it: one step of JAX's
    ``lax.scan`` body a token, every value a new tensor.  zx_t (S, H, B,
    4hd) float32 -> (hs (S, B, d), (c, n, h, m)).  ``_Recurrence``'s
    gradients are held against this one's."""
    S, H, B, _ = zx_t.shape
    c, n, h, m = state
    d = c.shape[1]
    one = torch.ones((), dtype=c.dtype, device=c.device)
    hs = []
    for zt in zx_t.unbind(0):
        g_z, g_i, g_f, g_o = _gates(torch.baddbmm(zt, h.reshape(B, H, -1).transpose(0, 1), wr),
                                    B, d).unbind(1)
        lfm = F.logsigmoid(g_f) + m  # logf + m
        m = torch.maximum(lfm, g_i)
        i_s = torch.exp(g_i - m)
        f_s = torch.exp(lfm - m)
        c = torch.addcmul(c * f_s, i_s, torch.tanh(g_z))  # f_s c + i_s z
        n = n * f_s + i_s
        h = torch.sigmoid(g_o) * c / torch.maximum(n, one)
        hs.append(h)
    return torch.stack(hs), (c, n, h, m)


def _slstm_steps_in_place(zx_t, wr, state):
    """``_slstm_steps`` for serving: the same values, each step written
    into buffers and views made once."""
    S, H, B, hd4 = zx_t.shape
    c, n, h, m = state
    d = c.shape[1]
    dev = zx_t.device
    f32 = torch.float32
    # step buffers and their views, made once: each step writes into them
    za = torch.empty((H, B, hd4), dtype=f32, device=dev)
    g = _gates(za, B, d)  # JAX's split of (B, 4d): z, i, f, o
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
    h_heads = hs.view(S, B, H, -1).transpose(1, 2)  # (S, H, B, hd) views of each step's h
    h_prev = h.reshape(B, H, -1).transpose(0, 1)
    for t in range(S):
        torch.baddbmm(zx_t[t], h_prev, wr, out=za)
        if split:
            g.copy_(_gates(za, B, d))
        torch.add(F.logsigmoid(g_f), m, out=g_f)  # logf + m
        torch.maximum(g_f, g_i, out=m)
        torch.sub(g_if, m_col, out=s).exp_()
        torch.tanh(g_z, out=z_now)
        cn.mul_(f_s).addcmul_(i_s, zo)  # c = f_s c + i_s z, n = f_s n + i_s
        h = hs[t]
        torch.mul(torch.sigmoid(g_o), c_now, out=h)
        h.div_(n_now.clamp_min(1.0))
        h_prev = h_heads[t]
    return hs, (c_now, n_now, h, m)


def _slstm_record(zx_t, wr, state):
    """``_slstm_steps_in_place``'s steps (the same ops, the same values),
    each step's gates and state kept for the backward.  Returns hs (S, B,
    d) and (gates (S, B, 4, d): z, i, logf + m, o, their pre-activations
    but the forget gate's; logf (S, B, d); m (S + 1, B, d); [i_s, f_s]
    (S, B, 2, d); [tanh z, 1] (S, B, 2, d); [c, n] (S + 1, B, 2, d)), the
    m and [c, n] histories starting with the state before the first
    step."""
    S, H, B, hd4 = zx_t.shape
    c, n, h, m = state
    d = c.shape[1]
    dev = zx_t.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    za = empty(S, H, B, hd4)
    g = za.transpose(1, 2).reshape(S, B, 4, d)  # JAX's split, z, i, f, o (a view at 4 heads)
    split = g.data_ptr() != za.data_ptr()  # not a view: copied a step
    m_all, s_all, cn_all, hs = empty(S + 1, B, d), empty(S, B, 2, d), empty(S + 1, B, 2, d), \
        empty(S, B, d)
    zo = torch.ones((S, B, 2, d), dtype=torch.float32, device=dev)
    m_all[0], cn_all[0, :, 0], cn_all[0, :, 1] = m, c, n
    # every step's views, made at once
    zx_s, za_s, g_s, gif_s, m_s, s_s, zo_s, cn_s, h_s = (t.unbind(0) for t in (
        zx_t, za, g, g[:, :, 1:3], m_all, s_all, zo, cn_all, hs))
    gz_s, gi_s, gf_s, go_s = (g[:, :, j].unbind(0) for j in range(4))
    mcol_s, is_s, fs_s = m_all[:, :, None].unbind(0), s_all[:, :, 0:1].unbind(0), \
        s_all[:, :, 1:2].unbind(0)
    z_s, c_s, n_s = zo[:, :, 0].unbind(0), cn_all[:, :, 0].unbind(0), cn_all[:, :, 1].unbind(0)
    hh_s = hs.view(S, B, H, -1).transpose(1, 2).unbind(0)
    logf = []
    h_prev = h.reshape(B, H, -1).transpose(0, 1)
    for t in range(S):
        torch.baddbmm(zx_s[t], h_prev, wr, out=za_s[t])
        if split:
            g_s[t].copy_(_gates(za_s[t], B, d))
        logf.append(F.logsigmoid(gf_s[t]))
        torch.add(logf[-1], m_s[t], out=gf_s[t])  # logf + m
        torch.maximum(gf_s[t], gi_s[t], out=m_s[t + 1])
        torch.sub(gif_s[t], mcol_s[t + 1], out=s_s[t]).exp_()
        torch.tanh(gz_s[t], out=z_s[t])
        torch.mul(cn_s[t], fs_s[t], out=cn_s[t + 1]).addcmul_(is_s[t], zo_s[t])
        torch.mul(torch.sigmoid(go_s[t]), c_s[t + 1], out=h_s[t])
        h_s[t].div_(n_s[t + 1].clamp_min(1.0))
        h_prev = hh_s[t]
    return hs, (g, torch.stack(logf), m_all, s_all, zo, cn_all)


class _Recurrence(torch.autograd.Function):
    """The sLSTM recurrence for training: (zx_t (S, H, B, 4hd), wr, c, n,
    h, m) -> (hs (S, B, d), c, n, m after the last step).  The forward is
    the serving loop's steps with each step's gates and state kept
    (``_slstm_record``); the backward walks the steps in reverse, 11
    elementwise launches and one product with wr a step, the factors they
    multiply by made for all steps at once beforehand, and wr's gradient
    one product over all steps afterwards.  Plain autograd over
    ``_slstm_steps`` records ~20 ops a step twice under remat and runs ~25
    backward nodes a step: this does the same sums (ties included) in a
    third of the host time.  Its gradients equal that one's to float
    rounding."""

    @staticmethod
    def forward(ctx, zx_t, wr, c, n, h, m):
        hs, saved = _slstm_record(zx_t, wr, (c, n, h, m))
        ctx.save_for_backward(wr, h, hs, *saved)
        cn, m_all = saved[5], saved[2]
        return hs, cn[-1, :, 0].clone(), cn[-1, :, 1].clone(), m_all[-1].clone()

    @staticmethod
    def backward(ctx, ghs, gc, gn, gm):
        wr, h0, hs, g, logf, m_all, s_all, zo, cn_all = ctx.saved_tensors
        S, B, d = hs.shape
        H, hd, hd4 = wr.shape
        dev = hs.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        # the factors of every step, at once (the forward's values: h = o c / D)
        lfm, ii, o = g[:, :, 2], g[:, :, 1], torch.sigmoid(g[:, :, 3])
        c, n = cn_all[1:, :, 0], cn_all[1:, :, 1]
        zv, i_s = zo[:, :, 0], s_all[:, :, 0]
        D = n.clamp_min(1.0)
        # torch.maximum passes each side half the gradient at a tie (n == 1
        # on the first step from the zero state; m's two terms)
        rho = torch.where(n > 1, 1.0, torch.where(n == 1, 0.5, 0.0))
        tau = torch.where(lfm > ii, 1.0, torch.where(lfm == ii, 0.5, 0.0))  # to logf + m
        acn = torch.stack([-(o * c) / (D * D) * rho, o / D], 2)  # d[n, c] / dh
        # d(the gates' pre-activations) / d[c, i, logf + m, h]: tanh', 1, logsigmoid', sigmoid'
        fac = torch.stack([i_s * (1 - zv * zv), torch.ones_like(zv), -torch.expm1(logf),
                           c / D * (o * (1 - o))], 2)
        tau2 = torch.stack([1 - tau, tau], 2)  # d m / d[i, logf + m]
        ghs = ghs if ghs is not None else zeros(S, B, d)
        # one buffer [Gn, Gc, di, gm, Gh]: [Gn, Gc] scale and add together, and
        # [Gc, di, gm, Gh] times fac is the gates' gradient [z, i, f, o]
        X = zeros(B, 5, d)
        if gn is not None:
            X[:, 0] = gn
        if gc is not None:
            X[:, 1] = gc
        if gm is not None:
            X[:, 3] = gm
        gcn = X[:, 0:2].clone()  # the gradient of [n, c] one step on
        Gcn, Gn, Gc, gm, Gh = X[:, 0:2], X[:, 0], X[:, 1], X[:, 3], X[:, 4]
        Gh3, Gm, D2 = Gh.view(B, H, hd), zeros(B, d), zeros(B, 2, d)  # D2: d[i_s, f_s]
        # the gates' gradients, JAX's split (a view of the products' layout at 4 heads)
        dza = torch.empty((S, H, B, hd4), dtype=torch.float32, device=dev)
        dg = dza.transpose(1, 2).reshape(S, B, 4, d)
        split = dg.data_ptr() != dza.data_ptr()
        gh_rec = zeros(H, B, hd)  # the gradient of the step before's h, by head
        wrT = wr.transpose(1, 2)
        ghs_s, acn_s, zv_s, fac_s, tau2_s, s_s, dza_s, dg_s = (t.unbind(0) for t in (
            ghs.reshape(S, B, H, hd), acn, zv, fac, tau2, s_all, dza, dg))
        fscol_s = s_all[:, :, 1:2].unbind(0)
        cprev_s, nprev_s = cn_all[:-1, :, 0].unbind(0), cn_all[:-1, :, 1].unbind(0)
        for t in range(S - 1, -1, -1):
            torch.add(ghs_s[t], gh_rec.transpose(0, 1), out=Gh3)
            torch.addcmul(gcn, Gh[:, None], acn_s[t], out=Gcn)
            torch.addcmul(Gn, Gc, zv_s[t], out=D2[:, 0])  # d i_s
            torch.mul(Gc, cprev_s[t], out=D2[:, 1]).addcmul_(Gn, nprev_s[t])  # d f_s
            a_if = D2 * s_s[t]  # d[i - m, logf + m_prev - m]
            torch.sub(gm, a_if.sum(1), out=Gm)  # d m
            torch.addcmul(a_if, Gm[:, None], tau2_s[t], out=X[:, 2:4])  # d[i, logf + m_prev]
            torch.mul(X[:, 1:5], fac_s[t], out=dg_s[t])
            torch.mul(Gcn, fscol_s[t], out=gcn)
            if split:
                dza_s[t].copy_(dg_s[t].reshape(B, H, hd4).transpose(0, 1))
            torch.bmm(dza_s[t], wrT, out=gh_rec)
        # wr's gradient over all steps: sum_t h_(t-1)^T dza_t, by head
        h_prev = torch.cat([h0[None], hs[:-1]]).view(S, B, H, hd)
        dwr = torch.bmm(h_prev.permute(2, 3, 0, 1).reshape(H, hd, S * B),
                        dza.transpose(0, 1).reshape(H, S * B, hd4))
        return (dza, dwr, gcn[:, 1], gcn[:, 0], gh_rec.transpose(0, 1).reshape(B, d),
                gm.clone())


def init_slstm_state(cfg: ModelConfig, batch: int, device="cuda"):
    d = cfg.d_model
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return (z, z, z, torch.full((batch, d), -math.inf, dtype=torch.float32, device=device))
