"""Port vs JAX package: the hybrid family (hymba: a selective-SSM branch
beside sliding-window attention in each layer) and sliding-window
attention, in float32 on the CPU, within rtol 1e-4 / atol 1e-5.

* ``ssm_train`` in chunks of 4 with a ragged last chunk against JAX's
  ``ssm_train`` at a chunk that divides S (JAX asserts S % chunk == 0; its
  own tests show the result does not depend on the chunk); the terminal
  state it returns against JAX's ``lm._ssm_terminal_state``; decode steps
  from that state against JAX's ``ssm_decode``; one SSM layer at hymba's
  own widths (d 1600, di 3200, state 16).
* Reduced hymba-1.5b (2 layers, d 64, window 8, CCE table and factored
  head) with JAX's params carried across by ``convert.lm_to_torch`` (and
  back, unchanged): ``forward``; ``prefill`` of prompts shorter and longer than the window,
  then decode steps until the ring has wrapped, logits and every cache
  leaf; ``next_token_loss`` and every gradient leaf against ``jax.grad``;
  ``launch.train.build_lm_trainer``'s first step against JAX's.
* The dense family with ``sliding_window=3`` (the JAX package's
  ``tests/test_models.py`` config): forward, a prefill past the window and
  decode steps over the ring."""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import train as jlaunch
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JConfig
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.train import loop as tloop
from repro_torch.tree import jax_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread in this module: beside the suite's other
    workers its threads would wait on each other at every small op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "hymba-1.5b"
MAX_SEQ = 32  # the reduced window is 8: the cache is a ring of 8 rows
SWA = dict(name="swa", family="dense", sliding_window=3, n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab=97, remat="none")
# the JAX side jitted (the config static): eagerly, its scans and vmaps
# take several times as long
JINIT = jax.jit(jlm.init, static_argnums=1)
JSSM = jax.jit(jssm.ssm_train, static_argnums=1, static_argnames="chunk")
JTERMINAL = jax.jit(jlm._ssm_terminal_state, static_argnums=1)
JSSM_DECODE = jax.jit(jssm.ssm_decode, static_argnums=1)
JPREFILL = jax.jit(lambda p, b, cfg, toks, cache: jlm.prefill(p, b, cfg, toks, cache,
                                                              batch_axes=None),
                   static_argnums=2)
JDECODE = jax.jit(lambda p, b, cfg, toks, pos, cache: jlm.decode_step(p, b, cfg, toks, pos, cache,
                                                                      batch_axes=None),
                  static_argnums=2)
JFORWARD = jax.jit(lambda p, b, cfg, toks: jlm.forward(p, b, cfg, {"tokens": toks},
                                                       batch_axes=None)[0],
                   static_argnums=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def hymba():
    jcfg = jconfigs.get_reduced(ARCH)
    params, buffers = _np(JINIT(jax.random.PRNGKey(7), jcfg))
    tp, tb = convert.lm_to_torch(params, buffers, "cpu")
    return jcfg, tconfigs.get_reduced(ARCH), params, buffers, tp, tb


@pytest.fixture(scope="module")
def swa():
    jcfg = JConfig(dtype=jnp.float32, **SWA)
    params, buffers = _np(JINIT(jax.random.PRNGKey(4), jcfg))
    tp, tb = convert.lm_to_torch(params, buffers, "cpu")
    return jcfg, TConfig(dtype=torch.float32, **SWA), params, buffers, tp, tb


def _layer(params, i=0):
    return jax.tree.map(lambda t: t[i], params["blocks"]["ssm"])


def _x(B, S, d, seed):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(np.float32)


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def test_registry_and_n_params_match_the_jax_package():
    full = tconfigs.get(ARCH)
    assert full.family == "hybrid" and ARCH not in tconfigs.UNPORTED
    assert full.n_params() == jconfigs.get(ARCH).n_params() == 1_545_576_200
    assert full.ssm_inner == 3200 and full.subquadratic and not full.is_recurrent
    assert tconfigs.get_reduced(ARCH).n_params() == jconfigs.get_reduced(ARCH).n_params()


@pytest.mark.parametrize("S,chunk", [(10, 4), (13, 4), (3, 4)])
def test_ssm_train_ragged_chunks_match_jax(hymba, S, chunk):
    """The port in chunks of ``chunk`` (the last one ragged, or one chunk
    shorter than ``chunk``) against JAX's in one chunk of S, and its
    terminal state against JAX's sequential ``_ssm_terminal_state``."""
    jcfg, tcfg, params, _, tp, _ = hymba
    p = _layer(params)
    x = _x(2, S, jcfg.d_model, seed=S)
    want = JSSM(p, jcfg, jnp.asarray(x), chunk=S)
    got, (h, conv) = tssm.ssm_train(convert.to_torch(p, "cpu"), tcfg, torch.from_numpy(x),
                                    chunk=chunk, return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_h, want_conv = JTERMINAL(p, jcfg, jnp.asarray(x))
    assert h.shape == (2, tcfg.ssm_inner, tcfg.ssm_state) and h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(want_conv))
    assert torch.equal(tssm.ssm_train(convert.to_torch(p, "cpu"), tcfg, torch.from_numpy(x),
                                      chunk=chunk), got)


def test_ssm_decode_steps_match_jax(hymba):
    """Three decode steps from the state a 6-token prefill leaves, against
    JAX's ``ssm_decode`` from JAX's terminal state; the outputs also equal
    the last three of ``ssm_train`` over all 9 tokens."""
    jcfg, tcfg, params, _, _, _ = hymba
    p = _layer(params, 1)
    tp = convert.to_torch(p, "cpu")
    x = _x(2, 9, jcfg.d_model, seed=5)
    _, (h, conv) = tssm.ssm_train(tp, tcfg, torch.from_numpy(x[:, :6]), return_state=True)
    jh, jconv = JTERMINAL(p, jcfg, jnp.asarray(x[:, :6]))
    full = tssm.ssm_train(tp, tcfg, torch.from_numpy(x), chunk=4)
    for t in range(6, 9):
        xt = x[:, t:t + 1]
        want, jh, jconv = JSSM_DECODE(p, jcfg, jnp.asarray(xt), jh, jconv)
        got, h, conv = tssm.ssm_decode(tp, tcfg, torch.from_numpy(xt), h, conv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), **TOL)
        np.testing.assert_allclose(got.numpy(), full[:, t:t + 1].numpy(), **TOL)
    zero_h, zero_conv = tssm.init_ssm_state(tcfg, 2, device="cpu")
    assert zero_h.shape == h.shape and zero_conv.shape == conv.shape


def test_ssm_layer_at_hymba_widths_matches_jax():
    """One SSM layer at hymba-1.5b's widths (d 1600, di 3200, state 16,
    conv 4) over 6 tokens in chunks of 4, against JAX's in one chunk."""
    jcfg, tcfg = jconfigs.get(ARCH), tconfigs.get(ARCH)
    jcfg, tcfg = (dataclasses.replace(c, dtype=dt) for c, dt in ((jcfg, jnp.float32),
                                                                  (tcfg, torch.float32)))
    p = _np(jssm.init_ssm(jax.random.PRNGKey(3), jcfg))
    tp = tssm.init_ssm(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert {k: (v.shape, v.dtype.name) for k, v in p.items()} == {
        k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in tp.items()}
    x = _x(1, 6, 1600, seed=9)
    want = JSSM(p, jcfg, jnp.asarray(x))
    got = tssm.ssm_train(convert.to_torch(p, "cpu"), tcfg, torch.from_numpy(x), chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_layout_matches_the_jax_package(hymba):
    _, tcfg, params, _, _, _ = hymba
    tp, _ = tlm.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name), params)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tp)
    assert got == want


def test_convert_carries_the_hybrid_leaves_unchanged(hymba):
    """``lm_to_torch`` and back: every leaf (the SSM's, the branch norms)
    equal in value and dtype."""
    _, _, params, buffers, tp, tb = hymba
    assert set(tp["blocks"]) == {"ln1", "attn", "ssm", "attn_norm", "ssm_norm", "ln2", "mlp"}
    for back, want in ((convert.to_numpy(tp), params), (convert.to_numpy(tb), buffers)):
        bl, bdef = jax.tree.flatten(back)
        wl, wdef = jax.tree.flatten(want)
        assert bdef == wdef
        for a, b in zip(bl, wl):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["hymba", "swa"])
def test_forward_matches_jax(which, request):
    jcfg, tcfg, params, buffers, tp, tb = request.getfixturevalue(which)
    toks = _tokens(jcfg.vocab, 2, 11, seed=1)
    want = JFORWARD(params, buffers, jcfg, jnp.asarray(toks))
    got, aux = tlm.forward(tp, tb, tcfg, {"tokens": torch.from_numpy(toks).long()})
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("which,S,steps", [("hymba", 5, 6), ("hymba", 11, 3), ("swa", 7, 3)])
def test_prefill_and_decode_over_the_ring_match_jax(which, S, steps, request):
    """A prompt of S tokens (shorter or longer than the window), then
    ``steps`` decode steps, the ring wrapping: logits and every cache leaf
    (ring k/v, SSM state, conv inputs) after each call."""
    jcfg, tcfg, params, buffers, tp, tb = request.getfixturevalue(which)
    B = 2
    toks = _tokens(jcfg.vocab, B, S, seed=2)
    jc = jlm.init_cache(jcfg, B, MAX_SEQ)
    tc = tlm.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}
    assert tlm.cache_batch_axis(tcfg) == jlm.cache_batch_axis(jcfg)
    want, jc = JPREFILL(params, buffers, jcfg, jnp.asarray(toks), jc)
    got, tc = tlm.prefill(tp, tb, tcfg, torch.from_numpy(toks).long(), tc)

    def check():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for key in jc:
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL)

    check()
    for t in range(steps):
        nxt = _tokens(jcfg.vocab, B, 1, seed=10 + t)[:, 0]
        pos = np.full((B,), S + t, np.int32)
        want, jc = JDECODE(params, buffers, jcfg, jnp.asarray(nxt), jnp.asarray(pos), jc)
        got, tc = tlm.decode_step(tp, tb, tcfg, torch.from_numpy(nxt).long(),
                                  torch.from_numpy(pos), tc)
        check()
    assert S + steps > tc["k"].shape[2]  # the ring wrapped


def test_next_token_loss_and_grads_match_jax(hymba):
    jcfg, tcfg, params, buffers, tp, tb = hymba
    toks = _tokens(jcfg.vocab, 2, 12, seed=3)

    def jloss(p, b):
        return jlm.next_token_loss(p, b, jcfg, {"tokens": jnp.asarray(toks)},
                                   batch_axes=None)[0]

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(params, buffers)
    loss, got = tloop.value_and_grad(
        lambda p, b, mb: tlm.next_token_loss(p, b, tcfg, mb), tp, tb,
        {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    g, w = jax_leaves(convert.to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert float(np.abs(a).sum()) > 0
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_build_lm_trainer_first_step_matches_jax():
    """``launch.train.build_lm_trainer`` on reduced hymba: one adamw step
    from JAX's initial state gives JAX's loss, params and moments."""
    args = argparse.Namespace(seed=3, lr=3e-3, warmup=1, steps=1, batch=2, seq=16, accum=1,
                              ckpt_dir=None, ckpt_every=0, cluster_every=0, fail_at=[],
                              emb="cce", device="cpu")
    jtr = jlaunch.build_lm_trainer(jconfigs.get_reduced(ARCH), args)
    start = jax.tree.map(np.array, jtr.state)  # copies: the jitted step donates the state
    jtr.run(1)
    ttr = tlaunch.build_lm_trainer(tconfigs.get_reduced(ARCH), args)
    ttr.state = convert.train_state_to_torch(start, "cpu")
    ttr.run(1)
    np.testing.assert_allclose(ttr.history[0]["loss"], jtr.history[0]["loss"], rtol=1e-5)
    for got, want in ((ttr.state.params, jtr.state.params), (ttr.state.opt, jtr.state.opt)):
        g, w = jax_leaves(convert.to_numpy(got)), jax.tree.leaves(_np(want))
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
