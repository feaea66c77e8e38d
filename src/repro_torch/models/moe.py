"""GShard-style top-k Mixture-of-Experts FFN, the counterpart of the JAX
package's ``repro/models/moe.py``: plain functions over a param dict
{"router" (d, E), "wi", "wg" (E, d, f), "wo" (E, f, d)}.

Tokens are routed within groups of ``group_size`` tokens (the whole
batch when it is smaller; the token count must be a whole number of
groups), each expert taking at most ``C = max(k, ceil(g k / E cf))``
tokens a group, computed in Python floats as the JAX package computes
it.  Priority is choice-major: every token's first choice is queued, in
token order, before any second choice, so a token's later choice can lose
its slot to any token's earlier one.  Pads that a serving engine appends
to a prompt are routed like any other token and take capacity, as in the
JAX package.

Routing decisions are the JAX package's to the bit where its inputs are:
the router product is taken in the activation dtype and then cast to
float32, and the top k come from a stable descending sort, which keeps
the lower expert index on a tie as ``jax.lax.top_k`` does (``torch.topk``
promises no order).  While ``TRACE`` is a list, every route appends the
decisions it took (``gate_idx`` and which choices kept a slot) to it, on
the input's device, with no launch and no synchronisation: tests and
checks read them there.

Three routes over a sequence give one function: ``apply_moe`` (the
GShard einsums over a (G, g, E, C) dispatch tensor), ``apply_moe_sort``
(tokens sorted stably by expert, scattered into their slots and gathered
back) and ``apply_moe_sort_sm``, which in the JAX package places the
collectives of an expert-parallel mesh by hand and without a mesh falls
back to ``apply_moe_sort``: the port has no mesh, so it is that fallback.
``apply_moe_decode`` runs every expert on every token and masks by the
top-k gates, with no capacity.  Each expert's FFN is one batched matmul
over the experts (``_experts``); the float32 weights are cast to the
activation dtype at each use.  The JAX package's sharding hints
(``_to_experts``, ``_to_groups``) are left out: without a mesh they are
identities.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import truncated_normal

DEFAULT_GROUP = 2048
#: None, or a list that each route appends its decisions to: ("seq",
#: gate_idx (B, S, k), keep (B, S, k)) from a route over a sequence,
#: ("decode", gate_idx (B, S, k), None) from ``apply_moe_decode``
TRACE: list | None = None


def init_moe(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = 1.0 / math.sqrt(d)
    so = 1.0 / math.sqrt(f) / math.sqrt(2 * cfg.n_layers)
    pd = cfg.param_dtype
    return {
        "router": truncated_normal(generator, (d, E), s, pd).to(device),
        "wi": truncated_normal(generator, (E, d, f), s, pd).to(device),
        "wg": truncated_normal(generator, (E, d, f), s, pd).to(device),
        "wo": truncated_normal(generator, (E, f, d), so, pd).to(device),
    }


def _groups(cfg: ModelConfig, T: int, group_size: int) -> tuple[int, int, int]:
    """(g, G, C): the group size, the number of groups and each expert's
    capacity a group."""
    g = min(group_size, T)
    if T % g:
        raise ValueError(f"{T} tokens are not a whole number of groups of {g}")
    k = cfg.top_k
    return g, T // g, max(k, int(math.ceil(g * k / cfg.n_experts * cfg.capacity_factor)))


def route(p, cfg: ModelConfig, x):
    """x (..., d) -> (probs (..., E) float32, gate_vals (..., k) float32
    renormalised over the top k, gate_idx (..., k) int64): the router
    product in x's dtype, its softmax in float32, the top k of a stable
    descending sort (on a tie the lower expert first)."""
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, gate_idx


def _positions(gate_idx, E: int):
    """gate_idx (G, g, k) -> each choice's place in its expert's queue of
    the group (G, g, k) int64, choice-major: the tokens before it in the
    group that made the same choice at the same rank, plus every token's
    choices of that expert at earlier ranks."""
    counts = gate_idx.new_zeros((gate_idx.shape[0], E))
    pos = []
    for j in range(gate_idx.shape[-1]):
        mask = F.one_hot(gate_idx[..., j], E)  # (G, g, E)
        before = torch.cumsum(mask, dim=1) - mask + counts[:, None, :]
        pos.append(before.gather(-1, gate_idx[..., j, None])[..., 0])
        counts = counts + mask.sum(dim=1)
    return torch.stack(pos, dim=-1)


def _trace(kind: str, gate_idx, keep, shape) -> None:
    if TRACE is not None:
        TRACE.append((kind, gate_idx.reshape(shape),
                      None if keep is None else keep.reshape(shape)))


def _experts(p, expert_in):
    """expert_in (E, n, d) -> (E, n, d): each expert's SwiGLU FFN on its
    own n rows, the weights cast to the rows' dtype."""
    dt = expert_in.dtype
    h = F.silu(torch.bmm(expert_in, p["wg"].to(dt))) * torch.bmm(expert_in, p["wi"].to(dt))
    return torch.bmm(h, p["wo"].to(dt))


def _aux(probs, gate_idx, E: int):
    """GShard's load-balancing loss: E x sum_e (share of tokens whose
    first choice is e) x (mean probability of e)."""
    frac = F.one_hot(gate_idx[..., 0], E).to(torch.float32).mean(dim=(0, 1))
    return E * torch.sum(frac * probs.mean(dim=(0, 1)))


def _grouped_experts(p, expert_in):
    """(G, E, C, d) slots -> (G, E, C, d), the experts' FFN over every
    group's slots at once."""
    G, E, C, d = expert_in.shape
    out = _experts(p, expert_in.transpose(0, 1).reshape(E, G * C, d))
    return out.reshape(E, G, C, d).transpose(0, 1)


def _combine_weights(cfg: ModelConfig, gate_vals, gate_idx, C: int):
    """(combine (G, g, E, C) float32, keep (G, g, k)): each kept choice's
    gate at its slot, zero elsewhere.  One value a cell (a token's k
    choices are distinct experts), so the JAX package's sum of one-hot
    products is this scatter, exactly."""
    E = cfg.n_experts
    G, g, _ = gate_idx.shape
    pos = _positions(gate_idx, E)
    keep = pos < C
    cell = torch.where(keep, gate_idx * C + pos, E * C)  # E * C: the drop bin
    combine = gate_vals.new_zeros((G, g, E * C + 1)).scatter(-1, cell, gate_vals)
    return combine[..., :E * C].reshape(G, g, E, C), keep


def apply_moe(p, cfg: ModelConfig, x, *, group_size: int = DEFAULT_GROUP):
    """x (B, S, d) -> (out (B, S, d), aux float32 scalar): the GShard
    route.  ``dispatch`` is the support of ``combine`` (``_combine_weights``)
    in x's dtype; both products are einsums over it, the combine cast to
    x's dtype first."""
    B, S, d = x.shape
    E = cfg.n_experts
    g, G, C = _groups(cfg, B * S, group_size)
    xg = x.reshape(G, g, d)
    probs, gate_vals, gate_idx = route(p, cfg, xg)
    combine, keep = _combine_weights(cfg, gate_vals, gate_idx, C)
    _trace("seq", gate_idx, keep, (B, S, cfg.top_k))
    dispatch = (combine > 0).to(x.dtype)
    expert_in = torch.einsum("gtec,gtd->gecd", dispatch, xg)
    expert_out = _grouped_experts(p, expert_in)
    out = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), expert_out)
    return out.reshape(B, S, d), _aux(probs, gate_idx, E)


def apply_moe_sort(p, cfg: ModelConfig, x, *, group_size: int = DEFAULT_GROUP):
    """x (B, S, d) -> (out, aux): the sort route, the same capacity and
    drops as ``apply_moe``.  Each group's choices, flattened choice-major,
    are sorted stably by expert; a choice's place in its expert's run is
    its slot, past C the drop bin.  The slots are filled by a scatter and
    read back by a gather, each times its gate, and a token's k rows are
    summed in choice order (the JAX package's ``segment_sum``; an order
    fixed on the card too, where an atomic sum's is not)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    g, G, C = _groups(cfg, B * S, group_size)
    xg = x.reshape(G, g, d)
    probs, gate_vals, gate_idx = route(p, cfg, xg)
    flat_e = gate_idx.transpose(1, 2).reshape(G, k * g)
    flat_gate = gate_vals.transpose(1, 2).reshape(G, k * g)
    token_of = torch.arange(g, device=x.device).repeat(k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    e_sorted = flat_e.gather(1, order)
    counts = F.one_hot(flat_e, E).sum(dim=1)  # (G, E)
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(k * g, device=x.device) - starts.gather(1, e_sorted)
    keep = pos < C
    slot = torch.where(keep, e_sorted * C + pos, E * C)  # E * C: the drop bin
    tok_sorted = token_of[order]
    if TRACE is not None:  # keep back in token order
        by_token = torch.zeros_like(keep).scatter(1, order, keep)
        _trace("seq", gate_idx, by_token.reshape(G, k, g).transpose(1, 2), (B, S, k))

    def rows(idx):
        return idx[..., None].expand(-1, -1, d)

    buf = xg.new_zeros((G, E * C + 1, d)).scatter_add(1, rows(slot),
                                                      xg.gather(1, rows(tok_sorted)))
    expert_in = buf[:, :E * C].reshape(G, E, C, d)
    flat_out = _grouped_experts(p, expert_in).reshape(G, E * C, d)
    picked = torch.where(keep[..., None], flat_out.gather(1, rows(slot.clamp(max=E * C - 1))),
                         0.0) * flat_gate.gather(1, order)[..., None].to(flat_out.dtype)
    # back to choice-major order, then each token's k rows summed
    by_choice = torch.zeros_like(picked).scatter(1, rows(order), picked)
    out = by_choice.reshape(G, k, g, d).sum(dim=1)
    return out.reshape(B, S, d), _aux(probs, gate_idx, E)


def apply_moe_sort_sm(p, cfg: ModelConfig, x, *, group_size: int = DEFAULT_GROUP):
    """The JAX package's sort route with hand-placed collectives over an
    expert-parallel mesh; without a mesh (always, in the port) it is
    ``apply_moe_sort``, as the JAX package falls back."""
    return apply_moe_sort(p, cfg, x, group_size=group_size)


def apply_moe_decode(p, cfg: ModelConfig, x):
    """x (B, S, d) -> (B, S, d), the decode route: every expert on every
    token, weighted by a dense (T, E) gate matrix that is zero outside the
    top k (cast to x's dtype), no capacity and no drops."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    probs, gate_vals, gate_idx = route(p, cfg, xf)
    _trace("decode", gate_idx, None, (B, S, cfg.top_k))
    gates = torch.zeros_like(probs).scatter(1, gate_idx, gate_vals)
    y = _experts(p, xf.expand(cfg.n_experts, -1, -1))  # (E, T, d)
    out = torch.einsum("te,etd->td", gates.to(x.dtype), y)
    return out.reshape(B, S, d)
