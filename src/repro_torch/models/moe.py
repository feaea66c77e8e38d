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
back) and ``apply_moe_sort_sm``, the JAX package's sort route with
hand-placed collectives, which here is ``apply_moe_sort``: every route
places them by hand.  ``apply_moe_decode`` runs every expert on every
token and masks by the top-k gates, with no capacity.  Each expert's FFN
is one batched matmul over the experts (``grouped_experts``); the float32
weights are cast to the activation dtype at each use.

Sharded (``group=``, the model group; ``data=``, the data group; the
layout is ``lm.param_specs``': experts over the data axis, the ff axis
over the model axis, the router whole): each data rank routes its own
groups (``dispatch``: its tokens must be a whole number of ``group_size``
groups, so that they are the unsharded groups), one all-to-all over the
data group moves the (G_loc, E, C, d) slots to the experts' ranks, which
run their f-slices of the FFN on every group's slots, and a second moves
them back (``expert_parallel``, the JAX package's ``apply_moe_sort_sm``
placement).  The slots are combined in token space on each model rank,
and the partial sums over the ff slices are reduced over the model group
once, in float32 as the JAX package's psum is: top_k x capacity_factor
times fewer values than the slot tensor.  All three routes do this, so at
more than one model rank the einsum route's sums run in another order
than GSPMD's, which reduces the slot tensor.  The gates and the tokens
enter the model group's region through ``shard.copy_to_group`` (their
gradients are partial sums over the ff slices); the router, whole on
every rank, reads the tokens outside it.  The load-balancing loss takes
the share of first choices over the whole batch (summed over the data
group) and each data rank's own mean probabilities: the data ranks'
terms, each scaled by its share of the batch, sum to the unsharded loss
and its gradient.  Decode all-gathers the tick's tokens over the data
group, runs this rank's experts gated on every token, sums over the data
group and keeps this rank's rows.  Where the data ranks do not split the
experts or a rank's tokens are not whole groups, a ``ValueError`` names
it (the JAX package falls back to replicated experts).  With no group,
or groups of one, every route is the unsharded one bit for bit.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import shard
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


def _groups(cfg: ModelConfig, T: int, group_size: int, data=None) -> tuple[int, int, int]:
    """(g, G, C): the group size, the number of groups and each expert's
    capacity a group.  Over a data group of D > 1 ranks, ``T`` is this
    rank's tokens: D must split the experts and ``T`` be whole groups."""
    D = shard.group_size(data)
    if D > 1:
        if cfg.n_experts % D:
            raise ValueError(f"{cfg.n_experts} experts do not split over {D} data ranks")
        if T % group_size:
            raise ValueError(f"a data rank's {T} tokens are not a whole number of groups of "
                             f"{group_size} (moe_group): its groups would not be the "
                             f"unsharded ones")
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


def _aux(probs, gate_idx, E: int, data=None):
    """GShard's load-balancing loss: E x sum_e (share of tokens whose
    first choice is e) x (mean probability of e).  Over a data group the
    share is the whole batch's (summed over the group) and the mean this
    rank's: this rank's term of the unsharded loss, times D."""
    frac = F.one_hot(gate_idx[..., 0], E).to(torch.float32).mean(dim=(0, 1))
    D = shard.group_size(data)
    if D > 1:
        frac = shard.all_reduce_(frac, data) / D
    return E * torch.sum(frac * probs.mean(dim=(0, 1)))


def grouped_experts(p, expert_in):
    """(G, E, C, d) slots -> (G, E, C, d), the experts' FFN over every
    group's slots at once: a rank's share, on its experts' f-slices."""
    G, E, C, d = expert_in.shape
    out = _experts(p, expert_in.transpose(0, 1).reshape(E, G * C, d))
    return out.reshape(E, G, C, d).transpose(0, 1)


def expert_parallel(p, slots, data=None):
    """``grouped_experts`` over the data group: ``slots`` (G_loc, E, C, d)
    of this rank's groups, ``p`` its E/D experts.  One all-to-all sends
    each rank the slots of its experts from every rank's groups, (D x
    G_loc, E/D, C, d) in rank order; a second brings the outputs back.
    Without a data group (or over one rank) ``grouped_experts``."""
    D = shard.group_size(data)
    if D == 1:
        return grouped_experts(p, slots)
    G, E, C, d = slots.shape
    x = shard.all_to_all(slots.reshape(G, D, E // D, C, d).transpose(0, 1), data)
    y = grouped_experts(p, x.reshape(D * G, E // D, C, d)).reshape(D, G, E // D, C, d)
    return shard.all_to_all(y, data).transpose(0, 1).reshape(G, E, C, d)


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


class Dispatched(NamedTuple):
    """A data rank's routed tokens: ``slots`` (G, E, C, d), each expert's
    tokens of each group; ``combine``, the experts' outputs at the slots
    -> the tokens' outputs (G, g, d); the router's ``probs`` and
    ``gate_idx`` (G, g, ...), for the load-balancing loss."""

    slots: torch.Tensor
    combine: Callable[[torch.Tensor], torch.Tensor]
    probs: torch.Tensor
    gate_idx: torch.Tensor


def _dispatch_einsum(cfg: ModelConfig, xg, gate_vals, gate_idx, C: int, shape):
    """The GShard route's slots and combine: ``dispatch`` is the support of
    ``combine`` (``_combine_weights``) in x's dtype; both products are
    einsums over it, the combine cast to x's dtype first."""
    combine, keep = _combine_weights(cfg, gate_vals, gate_idx, C)
    _trace("seq", gate_idx, keep, (*shape, cfg.top_k))
    dispatch = (combine > 0).to(xg.dtype)
    slots = torch.einsum("gtec,gtd->gecd", dispatch, xg)
    return slots, lambda out: torch.einsum("gtec,gecd->gtd", combine.to(xg.dtype), out)


def _dispatch_sort(cfg: ModelConfig, xg, gate_vals, gate_idx, C: int, shape):
    """The sort route's slots and combine, the same capacity and drops as
    the einsum route's.  Each group's choices, flattened choice-major, are
    sorted stably by expert; a choice's place in its expert's run is its
    slot, past C the drop bin.  The slots are filled by a scatter and read
    back by a gather, each times its gate, and a token's k rows are summed
    in choice order (the JAX package's ``segment_sum``; an order fixed on
    the card too, where an atomic sum's is not)."""
    G, g, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    flat_e = gate_idx.transpose(1, 2).reshape(G, k * g)
    flat_gate = gate_vals.transpose(1, 2).reshape(G, k * g)
    token_of = torch.arange(g, device=xg.device).repeat(k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    e_sorted = flat_e.gather(1, order)
    counts = F.one_hot(flat_e, E).sum(dim=1)  # (G, E)
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(k * g, device=xg.device) - starts.gather(1, e_sorted)
    keep = pos < C
    slot = torch.where(keep, e_sorted * C + pos, E * C)  # E * C: the drop bin
    tok_sorted = token_of[order]
    if TRACE is not None:  # keep back in token order
        by_token = torch.zeros_like(keep).scatter(1, order, keep)
        _trace("seq", gate_idx, by_token.reshape(G, k, g).transpose(1, 2), (*shape, k))

    def rows(idx):
        return idx[..., None].expand(-1, -1, d)

    buf = xg.new_zeros((G, E * C + 1, d)).scatter_add(1, rows(slot),
                                                      xg.gather(1, rows(tok_sorted)))

    def combine(expert_out):
        flat_out = expert_out.reshape(G, E * C, d)
        picked = torch.where(keep[..., None], flat_out.gather(1, rows(slot.clamp(max=E * C - 1))),
                             0.0) * flat_gate.gather(1, order)[..., None].to(flat_out.dtype)
        # back to choice-major order, then each token's k rows summed
        by_choice = torch.zeros_like(picked).scatter(1, rows(order), picked)
        return by_choice.reshape(G, k, g, d).sum(dim=1)

    return buf[:, :E * C].reshape(G, E, C, d), combine


def dispatch(p, cfg: ModelConfig, x, *, impl: str = "einsum", group_size: int = DEFAULT_GROUP,
             group=None, data=None) -> Dispatched:
    """Route x (B, S, d), a data rank's tokens, in groups of ``group_size``
    and fill each expert's slots: the einsum route (``impl="einsum"``) or
    the sort route ("sort", "sort_sm").  Under ``group`` the gates and the
    tokens enter the model group's region; ``data`` only checks that this
    rank's groups are the unsharded ones (``_groups``)."""
    B, S, d = x.shape
    g, G, C = _groups(cfg, B * S, group_size, data)
    xg = x.reshape(G, g, d)
    probs, gate_vals, gate_idx = route(p, cfg, xg)
    fill = _dispatch_einsum if impl == "einsum" else _dispatch_sort
    slots, combine = fill(cfg, shard.copy_to_group(xg, group),
                          shard.copy_to_group(gate_vals, group), gate_idx, C, (B, S))
    return Dispatched(slots, combine, probs, gate_idx)


def reduce_tokens(out, group):
    """The model ranks' partial sums (their ff slices) of the MoE output,
    added over ``group`` in float32; ``out`` itself for a group of one."""
    if shard.group_size(group) == 1:
        return out
    return shard.reduce_from_group(out.to(torch.float32), group).to(out.dtype)


def _apply(impl: str, p, cfg: ModelConfig, x, group_size: int, group, data):
    B, S, d = x.shape
    r = dispatch(p, cfg, x, impl=impl, group_size=group_size, group=group, data=data)
    out = r.combine(expert_parallel(p, r.slots, data))
    return reduce_tokens(out, group).reshape(B, S, d), _aux(r.probs, r.gate_idx,
                                                            cfg.n_experts, data)


def apply_moe(p, cfg: ModelConfig, x, *, group_size: int = DEFAULT_GROUP, group=None,
              data=None):
    """x (B, S, d) -> (out (B, S, d), aux float32 scalar): the GShard
    einsum route (``_dispatch_einsum``)."""
    return _apply("einsum", p, cfg, x, group_size, group, data)


def apply_moe_sort(p, cfg: ModelConfig, x, *, group_size: int = DEFAULT_GROUP, group=None,
                   data=None):
    """x (B, S, d) -> (out, aux): the sort route (``_dispatch_sort``)."""
    return _apply("sort", p, cfg, x, group_size, group, data)


def apply_moe_sort_sm(p, cfg: ModelConfig, x, *, group_size: int = DEFAULT_GROUP, group=None,
                      data=None):
    """The JAX package's sort route with hand-placed collectives over an
    expert-parallel mesh: ``apply_moe_sort``, whose collectives are placed
    by hand (``expert_parallel``, ``reduce_tokens``)."""
    return apply_moe_sort(p, cfg, x, group_size=group_size, group=group, data=data)


def apply_moe_decode(p, cfg: ModelConfig, x, *, group=None, data=None):
    """x (B, S, d) -> (B, S, d), the decode route: every expert on every
    token, weighted by a dense (T, E) gate matrix that is zero outside the
    top k (cast to x's dtype), no capacity and no drops.  Over a data
    group of D ranks the tokens of every rank are gathered, this rank's
    E/D experts run on all of them and the outputs are summed over the
    group, of which this rank keeps its rows."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    rank, D = shard.rank_and_size(data)
    if D > 1:
        if cfg.n_experts % D:
            raise ValueError(f"{cfg.n_experts} experts do not split over {D} data ranks")
        xf = shard.all_gather_cat(xf, 0, data)
    probs, gate_vals, gate_idx = route(p, cfg, xf)
    mine = slice(rank * B * S, (rank + 1) * B * S)
    _trace("decode", gate_idx[mine], None, (B, S, cfg.top_k))
    gates = torch.zeros_like(probs).scatter(1, gate_idx, gate_vals)
    E = p["wi"].shape[0]
    if D > 1:
        gates = gates[:, rank * E:(rank + 1) * E]
    y = _experts(p, xf.expand(E, -1, -1))  # (E, T, d)
    out = torch.einsum("te,etd->td", gates.to(x.dtype), y)
    if D > 1:
        out = shard.all_reduce_(out, data)[mine]
    return reduce_tokens(out, group).reshape(B, S, d)
