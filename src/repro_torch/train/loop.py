"""The train step, the port of the JAX package's ``train/loop.py``
(``TrainState``, ``init_state``, ``make_train_step``).

The step is a plain function of (state, batch): microbatch gradient
accumulation (grads summed in float32, then divided by ``accum``),
optional int8 gradient compression with error feedback, global-norm
clipping and the optimizer update.  The JAX step is jitted and donates
its state; this one runs eagerly and updates params and moments in place
instead (``Optimizer.update``).

Not ported yet (they come with the tracker, the ``Trainer`` and the run
telemetry): the step's ``sketch_fn`` and ``telemetry`` hooks.  The JAX
package's ``split_buffers``/``merge_buffers`` exist only to keep static
python leaves out of ``jit``; an eager step takes the buffers whole, so
``TrainState.ebuf`` holds all of them.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.optim.compression import compressed_grad_transform, init_error_feedback
from repro_torch.tree import tree_leaves, tree_map

Pytree = Any


class TrainState(NamedTuple):
    params: Pytree
    opt: Pytree
    ebuf: Pytree  # the embedding buffers (ptr, hs, epoch per feature)
    step: int  # a host counter (an int32 array in the JAX package)
    err: Pytree | None = None  # int8-compression error feedback


def init_state(params, optimizer: Optimizer, buffers, *, compress_grads: bool = False):
    return TrainState(
        params=params,
        opt=optimizer.init(params),
        ebuf=buffers,
        step=0,
        err=init_error_feedback(params) if compress_grads else None,
    )


def value_and_grad(loss_fn, params, buffers, mb):
    """(loss, d loss / d params) of ``loss_fn(params, buffers, mb)``, with
    the params as fresh autograd leaves that share the state's storage (the
    state itself never requires grad)."""
    leaves = tree_leaves(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(req)
    loss, _metrics = loss_fn(tree_map(lambda _: next(it), params), buffers, mb)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(req, grads)]
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(
    loss_fn: Callable[[Pytree, Pytree, Pytree], tuple[torch.Tensor, dict]],
    optimizer: Optimizer,
    lr_fn: Callable[[int], Any],
    *,
    accum: int = 1,
    clip_norm: float = 1.0,
    compress_grads: bool = False,
):
    """loss_fn(params, buffers, microbatch) -> (loss, metrics dict).

    The returned ``train_step(state, batch) -> (state, metrics)`` expects
    batch leaves shaped (accum, micro, ...); ``metrics`` holds ``loss``,
    ``gnorm`` and ``lr`` as 0-d float32 tensors.  The state's params and
    moments are updated in place."""

    def train_step(state: TrainState, batch: Pytree):
        params = state.params
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)
        loss_sum = 0.0
        for a in range(accum):
            mb = tree_map(lambda x: x[a], batch)
            loss, grads = value_and_grad(loss_fn, params, state.ebuf, mb)
            gsum = tree_map(lambda s, g: s + g.to(s.dtype), gsum, grads)
            loss_sum = loss_sum + loss.to(torch.float32)
        grads = tree_map(lambda g: g / accum, gsum)
        loss = loss_sum / accum

        err = state.err
        if compress_grads:
            grads, err = compressed_grad_transform(grads, err)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        # a 0-d CPU tensor: it scales CUDA tensors without a copy
        lr = torch.as_tensor(lr_fn(state.step), dtype=torch.float32)
        new_params, new_opt = optimizer.update(grads, state.opt, params, lr)
        new_state = TrainState(params=new_params, opt=new_opt, ebuf=state.ebuf,
                               step=state.step + 1, err=err)
        return new_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return train_step
