"""Port vs JAX package: command-r-35b (the dense family: a parallel
attention + FFN block, layernorm, rope theta 8e6, GQA, no biases, untied
CCE tables), reduced (2 layers, d 64, 4 heads over 2 KV heads of 16, d_ff
128, vocab 257), float32 on the CPU.  Both sides start from the port's
init carried to numpy with ``convert`` (JAX's eager init costs seconds).

* The registry: ``get("command-r-35b")`` is JAX's configuration field
  for field, its ``n_params`` 28,448,530,432, and ``UNPORTED`` is empty.
* ``forward``'s logits, a bucket-padded ``prefill`` with ``last_idx``, a
  ``decode_step`` and both caches within rtol 1e-4 / atol 1e-5
  (``test_torch_lm.py``'s tolerance: the port's prefill runs the flash
  route).
* ``next_token_loss`` and every gradient leaf within rtol 1e-5 / atol
  1e-6 of ``jax.value_and_grad``.
* One adamw + cosine step of ``make_train_step``: loss, gnorm and lr
  within rtol 1e-5, moments and params within rtol 1e-4 / atol 1e-6 of
  the JAX package's jitted step, but for param entries whose gradient is
  float noise (JAX's adam sqrt(v) under ``NOISE_RMS``, against a median
  of ~5e-4; adam's first step moves any entry by about ±lr whatever its
  gradient's size): those, under 1% of any leaf, within lr."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JConfig
from repro.train import loop as jloop
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import optim as toptim
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.train import loop as tloop
from repro_torch.tree import jax_leaves_with_paths

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "command-r-35b"
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
LR = 3e-3
NOISE_RMS = 1e-6  # tests/test_torch_lm_trainer.py's bound on a noise entry's sqrt(v)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _port_config(jcfg) -> TConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(JConfig)}
    kw["dtype"] = _DTYPES[jnp.dtype(jcfg.dtype).name]
    kw["param_dtype"] = _DTYPES[jnp.dtype(jcfg.param_dtype).name]
    return TConfig(**kw)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    tp, tb = tlm.init(tcfg, torch.Generator().manual_seed(5), device="cpu")
    return jcfg, tcfg, convert.to_numpy(tp), convert.to_numpy(tb), tp, tb


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _assert_tree_close(got, want, **tol):
    g, w = jax_leaves_with_paths(convert.to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for (path, a), b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=path, **tol)


def test_registry_has_command_r():
    jcfg, tcfg = jconfigs.get(ARCH), tconfigs.get(ARCH)
    assert _port_config(jcfg) == tcfg
    assert _port_config(jconfigs.get_reduced(ARCH)) == tconfigs.get_reduced(ARCH)
    assert tcfg.parallel_block and tcfg.norm == "layernorm" and tcfg.family == "dense"
    assert tcfg.n_params() == jcfg.n_params() == 28_448_530_432
    assert tconfigs.UNPORTED == {} and set(tconfigs.ARCHS) == set(jconfigs.ARCHS)


def test_forward_matches_jax(model):
    jcfg, tcfg, params, buffers, tp, tb = model
    toks = _tokens(jcfg.vocab, (2, 11), seed=1)
    want, _ = jlm.forward(params, buffers, jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = tlm.forward(tp, tb, tcfg, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_padded_prefill_and_decode_match_jax(model):
    jcfg, tcfg, params, buffers, tp, tb = model
    B, S, L, max_seq = 2, 5, 8, 16
    toks = np.zeros((B, L), np.int32)
    toks[:, :S] = _tokens(jcfg.vocab, (B, S), seed=2)
    jc = jlm.init_cache(jcfg, B, max_seq)
    want, jc = jlm.prefill(params, buffers, jcfg, jnp.asarray(toks), jc, last_idx=S - 1)
    tc = tlm.init_cache(tcfg, B, max_seq, device="cpu")
    got, tc = tlm.prefill(tp, tb, tcfg, torch.from_numpy(toks).long(), tc, last_idx=S - 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    nxt = _tokens(jcfg.vocab, (B,), seed=3)
    pos = np.full((B,), S, np.int32)
    want, jc = jlm.decode_step(params, buffers, jcfg, jnp.asarray(nxt), jnp.asarray(pos), jc)
    got, tc = tlm.decode_step(tp, tb, tcfg, torch.from_numpy(nxt).long(),
                              torch.from_numpy(pos), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL)


def test_next_token_loss_and_grads_match_jax(model):
    jcfg, tcfg, params, buffers, tp, tb = model
    tokens = _tokens(jcfg.vocab, (2, 16), seed=4)

    def jloss(p, b, x):
        return jlm.next_token_loss(p, b, jcfg, x, batch_axes=None)[0]

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(params, buffers, {"tokens": tokens})
    loss, got = tloop.value_and_grad(lambda p, b, mb: tlm.next_token_loss(p, b, tcfg, mb),
                                     tp, tb, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), float(want_loss), **GRAD_TOL)
    _assert_tree_close(got, want, **GRAD_TOL)


def test_adamw_step_tracks_jax(model):
    jcfg, tcfg, params, buffers, _, _ = model
    batch = {"tokens": _tokens(jcfg.vocab, (1, 2, 16), seed=6)}
    jopt, topt = joptim.adamw(weight_decay=0.1), toptim.adamw(weight_decay=0.1)
    dyn, static = jloop.split_buffers(buffers)
    jstep = jax.jit(jloop.make_train_step(
        lambda p, b, mb: jlm.next_token_loss(p, b, jcfg, mb, batch_axes=None), jopt,
        joptim.cosine_schedule(LR, 0, 4), static))
    tstep = tloop.make_train_step(lambda p, b, mb: tlm.next_token_loss(p, b, tcfg, mb), topt,
                                  toptim.cosine_schedule(LR, 0, 4))
    js, jm = jstep(jloop.init_state(params, jopt, dyn), batch)
    tp, tb = convert.lm_to_torch(params, buffers, "cpu")
    ts, tm = tstep(tloop.init_state(tp, topt, tb), {"tokens": torch.from_numpy(batch["tokens"])})
    for key in ("loss", "gnorm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-6)
    assert float(tm["lr"]) == pytest.approx(LR)
    _assert_tree_close(ts.opt, js.opt, **STEP_TOL)
    rms = [np.sqrt(np.asarray(v)) for v in jax.tree.leaves(js.opt["v"])]
    g = jax_leaves_with_paths(convert.to_numpy(ts.params))
    for (path, a), b, r in zip(g, jax.tree.leaves(js.params), rms):
        noise = (r > 0) & (r < NOISE_RMS)  # a row no token reads has v = 0 exactly
        assert noise.mean() < 1e-2, path
        np.testing.assert_allclose(a[noise], np.asarray(b)[noise], rtol=0, atol=LR, err_msg=path)
        np.testing.assert_allclose(a[~noise], np.asarray(b)[~noise], err_msg=path, **STEP_TOL)
