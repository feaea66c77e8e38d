"""Port vs JAX package: the xlstm family (xlstm-1.3b: superblocks of
chunkwise mLSTM blocks and one recurrent sLSTM block), in float32 on the
CPU, within rtol 1e-4 / atol 1e-5 unless a test says otherwise.

* ``mlstm_train`` at JAX's chunk (S=12 in chunks of 4 and of 12), output
  and terminal state; a ragged S=10 in chunks of 4 against JAX in one chunk
  of 10, at JAX's own chunk tolerance (``tests/test_models.py``: rtol
  2e-3); ``mlstm_decode`` steps from that state; ``slstm_seq`` from a zero
  state and from a carried one, and at 8 heads.  ``forward``'s logits at atol 3e-5
  (``FORWARD_TOL``: the reduced model's own float noise).
* Reduced xlstm-1.3b (4 blocks, ``slstm_every`` 2: two superblocks of one
  mLSTM and one sLSTM block) and a variant without sLSTM blocks, with
  JAX's params carried across by ``convert.lm_to_torch`` (and back,
  unchanged): the init's tree, ``n_params``, ``init_cache``; ``forward``;
  ``prefill`` at S=7 and S=256, then decode steps, the logits and every
  cache leaf after each call; a ragged S=300 prefill (the port's last
  mLSTM chunk 44 tokens) against JAX's with its ``mlstm_train`` bound to a
  chunk of 100 (JAX asserts S % chunk == 0)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.data.synthetic import lm_token_batches as jbatches
from repro.models import lm as jlm
from repro.train import loop as jloop
from repro.models import xlstm as jxlstm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import optim as toptim
from repro_torch.models import lm as tlm
from repro_torch.models import xlstm as txlstm
from repro_torch.train import loop as tloop
from repro_torch.tree import jax_leaves_with_paths, tree_leaves


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
CHUNK_TOL = dict(rtol=2e-3, atol=2e-4)  # JAX's own chunk-vs-chunk tolerance
# forward's logits (2 x 11 tokens through 4 blocks): the reduced model's
# random blocks amplify a change of 1e-7 in their input 5-10 times (JAX
# against itself), so float noise reaches ~1.6e-5 on logits of ~4.5
FORWARD_TOL = dict(rtol=1e-4, atol=3e-5)
GRAD_TOL = TOL  # every gradient leaf of the LM's loss against JAX's
BODY_TOL = 1e-6  # the sLSTM recurrence's backward vs plain autograd, of each leaf's largest
# a block's gradients of a weighted sum of its output (values up to ~17):
# atol 1e-5 per unit of the leaf's largest magnitude (measured: 1.1e-5 of
# it, wq's at chunk 12)
BLOCK_GRAD_RTOL = 1e-4
# a param entry whose gradient RMS (JAX's adam sqrt(v)) is below this is
# float noise beside its leaf's, and adam's first steps move it ~lr whatever
# its size
NOISE_RMS = 1e-6
# the leaves (and their entries) that may be noise: the input-gate biases,
# the mLSTM's bi and the sLSTM's b[d:2d] (the mLSTM's h and, where n > 1,
# the sLSTM's c / n are invariant to a shift of every input gate: the
# normaliser divides it out); those under NOISE_RMS are held within
# lr x steps
NOISE_ENTRIES = {"['blocks']['mlstm']['bi']": lambda d: np.s_[...],
                 "['blocks']['slstm']['b']": lambda d: np.s_[..., d:2 * d]}
ARCH = "xlstm-1.3b"
# the JAX side jitted with the config static: eagerly, its scans take
# several times as long
JINIT = jax.jit(jlm.init, static_argnums=1)
JMLSTM = jax.jit(jxlstm.mlstm_train, static_argnums=1, static_argnames="chunk")
JMLSTM_DECODE = jax.jit(jxlstm.mlstm_decode, static_argnums=1)
JSLSTM = jax.jit(jxlstm.slstm_seq, static_argnums=1)
JFORWARD = jax.jit(lambda p, b, cfg, toks: jlm.forward(p, b, cfg, {"tokens": toks},
                                                       batch_axes=None)[0],
                   static_argnums=2)
JDECODE = jax.jit(lambda p, b, cfg, toks, pos, cache: jlm.decode_step(p, b, cfg, toks, pos, cache,
                                                                      batch_axes=None),
                  static_argnums=2)


JLOSS_GRAD = jax.jit(jax.value_and_grad(
    lambda p, b, cfg, toks: jlm.next_token_loss(p, b, cfg, {"tokens": toks}, batch_axes=None)[0]),
    static_argnums=2)


def _weighted(fn, w):
    """The weighted sum of ``fn``'s first output: a scalar whose
    gradients reach every input."""
    return lambda *a, **kw: (fn(*a, **kw)[0] * w).sum()


def _jprefill(p, b, cfg, toks, cache):
    return jlm.prefill(p, b, cfg, toks, cache, batch_axes=None)


JPREFILL = jax.jit(_jprefill, static_argnums=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _model(slstm_every: int, seed: int):
    jcfg = jconfigs.get_reduced(ARCH, n_layers=4, slstm_every=slstm_every)
    params, buffers = _np(JINIT(jax.random.PRNGKey(seed), jcfg))
    tp, tb = convert.lm_to_torch(params, buffers, "cpu")
    tcfg = tconfigs.get_reduced(ARCH, n_layers=4, slstm_every=slstm_every)
    return jcfg, tcfg, params, buffers, tp, tb


@pytest.fixture(scope="module")
def xlstm():
    return _model(2, 7)


@pytest.fixture(scope="module")
def mlstm_only():
    return _model(0, 8)


def _x(B, S, d, seed):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(np.float32)


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _mlstm(params, s=0, j=0):
    return jax.tree.map(lambda t: t[s, j], params["blocks"]["mlstm"])


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _close_trees(got, want, tol, *, noise=None, noise_atol=0.0):
    """Every leaf within ``tol``; with ``noise`` ({leaf path: a boolean
    array}) those entries within ``noise_atol`` absolute instead."""
    g, w = jax_leaves_with_paths(convert.to_numpy(got)), jax.tree.leaves(_np(want))
    assert len(g) == len(w)
    noise = noise or {}
    assert set(noise) <= {path for path, _ in g}
    for (path, a), b in zip(g, w):
        b = np.asarray(b)
        at = noise.get(path, np.zeros(b.shape, bool))
        _close(a[at], b[at], dict(rtol=0, atol=noise_atol))
        _close(a[~at], b[~at], tol)


def _close_block_grads(got, want):
    want = np.asarray(want)
    _close(got, want, dict(rtol=BLOCK_GRAD_RTOL, atol=1e-5 * max(1.0, np.abs(want).max())))


def _torch_grads(fn, tree, x):
    """Gradients of the scalar ``fn(params, x)`` with respect to every leaf
    of ``tree`` and to ``x``: ({leaf: grad}, d x)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in tree.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    grads = torch.autograd.grad(fn(leaves, xt), [*leaves.values(), xt])
    return dict(zip(leaves, grads[:-1])), grads[-1]


def _rel(a, b) -> float:
    """max |a - b| over the largest |b|."""
    return float((a - b).abs().max() / b.abs().max())


def test_registry_and_n_params_match_the_jax_package():
    full = tconfigs.get(ARCH)
    assert full.family == "xlstm" and ARCH not in tconfigs.UNPORTED
    assert full.n_params() == jconfigs.get(ARCH).n_params() == 3_637_348_352
    assert full.is_recurrent and full.subquadratic
    for every in (2, 0):
        tcfg = tconfigs.get_reduced(ARCH, slstm_every=every)
        assert tcfg.n_params() == jconfigs.get_reduced(ARCH, slstm_every=every).n_params()
    assert txlstm.slstm_ffn_dim(full) == jxlstm.slstm_ffn_dim(jconfigs.get(ARCH)) == 2816


@pytest.mark.parametrize("which", ["xlstm", "mlstm_only"])
def test_init_tree_cache_and_convert_match_the_jax_package(which, request):
    """The port's init has JAX's tree, shapes and dtypes; its cache equals
    JAX's ``init_cache`` (m at -inf); ``lm_to_torch`` and back carries
    every leaf unchanged in value and dtype."""
    jcfg, tcfg, params, buffers, tp, tb = request.getfixturevalue(which)
    mine, _ = tlm.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name), params)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), mine)
    assert got == want
    keys = {"mlstm", "slstm", "norms"} if jcfg.slstm_every else {"mlstm", "norms"}
    assert set(tp["blocks"]) == keys and "head" in tp
    for back, ref in ((convert.to_numpy(tp), params), (convert.to_numpy(tb), buffers)):
        bl, bdef = jax.tree.flatten(back)
        wl, wdef = jax.tree.flatten(ref)
        assert bdef == wdef
        for a, b in zip(bl, wl):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    cache = tlm.init_cache(tcfg, 3, 32, device="cpu")
    jcache = _np(jlm.init_cache(jcfg, 3, 32))
    assert set(cache) == set(jcache)
    for key, t in cache.items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), jcache[key])
    assert tlm.cache_batch_axis(tcfg) == jlm.cache_batch_axis(jcfg)


@pytest.mark.parametrize("chunk", [4, 12])
def test_mlstm_train_matches_jax_at_its_chunk(xlstm, chunk):
    jcfg, tcfg, params, _, _, _ = xlstm
    p = _mlstm(params, 1, 0)
    x = _x(2, 12, jcfg.d_model, seed=chunk)
    want, wstate = JMLSTM(p, jcfg, jnp.asarray(x), chunk=chunk)
    got, state = txlstm.mlstm_train(convert.to_torch(p, "cpu"), tcfg, torch.from_numpy(x),
                                    chunk=chunk)
    _close(got, want)
    for a, b in zip(state, wstate):
        assert a.dtype == torch.float32
        _close(a, b)


def test_mlstm_train_ragged_chunk_matches_jax_in_one_chunk(xlstm):
    """S=10 in chunks of 4 (the last of 2 tokens) against JAX's one chunk
    of 10."""
    jcfg, tcfg, params, _, _, _ = xlstm
    p = _mlstm(params)
    x = _x(2, 10, jcfg.d_model, seed=3)
    want, wstate = JMLSTM(p, jcfg, jnp.asarray(x), chunk=10)
    got, state = txlstm.mlstm_train(convert.to_torch(p, "cpu"), tcfg, torch.from_numpy(x),
                                    chunk=4)
    _close(got, want, CHUNK_TOL)
    for a, b in zip(state, wstate):
        _close(a, b, CHUNK_TOL)


def test_mlstm_decode_steps_match_jax(xlstm):
    """Three decode steps from the state a 5-token chunkwise pass leaves,
    against JAX's ``mlstm_decode`` from JAX's state; the state is updated
    in place, and the outputs equal the last three of the chunkwise form
    over all 8 tokens."""
    jcfg, tcfg, params, _, _, _ = xlstm
    p = _mlstm(params, 0, 0)
    tp = convert.to_torch(p, "cpu")
    x = _x(2, 8, jcfg.d_model, seed=5)
    _, state = txlstm.mlstm_train(tp, tcfg, torch.from_numpy(x[:, :5]), chunk=4)
    _, jstate = JMLSTM(p, jcfg, jnp.asarray(x[:, :5]), chunk=5)
    full, _ = txlstm.mlstm_train(tp, tcfg, torch.from_numpy(x), chunk=4)
    ptrs = [t.data_ptr() for t in state]
    for t in range(5, 8):
        xt = x[:, t:t + 1]
        want, jstate = JMLSTM_DECODE(p, jcfg, jnp.asarray(xt), jstate)
        got, state = txlstm.mlstm_decode(tp, tcfg, torch.from_numpy(xt), state)
        _close(got, want)
        for a, b in zip(state, jstate):
            _close(a, b)
        _close(got, full[:, t:t + 1])
    assert [t.data_ptr() for t in state] == ptrs


def test_slstm_seq_matches_jax_from_zero_and_carried_state(xlstm):
    jcfg, tcfg, params, _, _, _ = xlstm
    p = jax.tree.map(lambda t: t[1], params["blocks"]["slstm"])
    tp = convert.to_torch(p, "cpu")
    x = _x(2, 9, jcfg.d_model, seed=6)
    want, wstate = JSLSTM(p, jcfg, jnp.asarray(x[:, :6]))
    got, state = txlstm.slstm_seq(tp, tcfg, torch.from_numpy(x[:, :6]))
    _close(got, want)
    for a, b in zip(state, wstate):
        _close(a, b)
    want, wstate = JSLSTM(p, jcfg, jnp.asarray(x[:, 6:]), wstate)
    got, state = txlstm.slstm_seq(tp, tcfg, torch.from_numpy(x[:, 6:]), state)
    _close(got, want)
    for a, b in zip(state, wstate):
        _close(a, b)
    whole, _ = txlstm.slstm_seq(tp, tcfg, torch.from_numpy(x))
    _close(whole[:, 6:], got)


def test_slstm_seq_at_eight_heads_matches_jax():
    """At 8 heads the gates' split (z, i, f, o over 4d) cuts across the
    recurrent product's heads: the port copies it out each step."""
    jcfg = jconfigs.get_reduced(ARCH, n_heads=8)
    tcfg = tconfigs.get_reduced(ARCH, n_heads=8)
    p = _np(jxlstm.init_slstm(jax.random.PRNGKey(2), jcfg))
    x = _x(3, 5, jcfg.d_model, seed=8)
    want, wstate = JSLSTM(p, jcfg, jnp.asarray(x))
    got, state = txlstm.slstm_seq(convert.to_torch(p, "cpu"), tcfg, torch.from_numpy(x))
    _close(got, want)
    for a, b in zip(state, wstate):
        _close(a, b)


@pytest.mark.parametrize("which", ["xlstm", "mlstm_only"])
def test_forward_matches_jax_and_refuses_autograd(which, request):
    """``forward`` under no_grad gives JAX's logits; under autograd (it
    refused before training was ported) ``next_token_loss`` gives JAX's
    loss and every gradient leaf ``jax.value_and_grad`` gives."""
    jcfg, tcfg, params, buffers, tp, tb = request.getfixturevalue(which)
    toks = _tokens(jcfg.vocab, 2, 11, seed=1)
    want = JFORWARD(params, buffers, jcfg, jnp.asarray(toks))
    batch = {"tokens": torch.from_numpy(toks).long()}
    with torch.no_grad():
        got, aux = tlm.forward(tp, tb, tcfg, batch)
    assert float(aux) == 0.0
    _close(got, want, FORWARD_TOL)
    want_loss, want_grads = JLOSS_GRAD(params, buffers, jcfg, jnp.asarray(toks))
    loss, grads = tloop.value_and_grad(lambda p, b, mb: tlm.next_token_loss(p, b, tcfg, mb),
                                       tp, tb, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _close_trees(grads, want_grads, GRAD_TOL)


def _prefill_and_decode(model, S, steps, seed, B=1):
    """The port's and JAX's prefill of one S-token prompt a row, then
    ``steps`` greedy decode steps (JAX's picks fed to both), comparing
    the logits and every cache leaf after each call; the port's cache is
    written in place."""
    jcfg, tcfg, params, buffers, tp, tb = model
    toks = _tokens(jcfg.vocab, B, S, seed)
    jcache = jlm.init_cache(jcfg, B, S + steps)
    cache = tlm.init_cache(tcfg, B, S + steps, device="cpu")
    ptrs = {k: t.data_ptr() for k, t in cache.items()}
    want, jcache = JPREFILL(params, buffers, jcfg, jnp.asarray(toks), jcache)
    with torch.inference_mode():
        got, cache = tlm.prefill(tp, tb, tcfg, torch.from_numpy(toks).long(), cache)

    def compare(got, want, cache, jcache):
        tol = CHUNK_TOL if S % min(S, txlstm.MLSTM_CHUNK) else TOL
        _close(got, want, tol)
        assert set(cache) == set(jcache)
        for key in cache:
            assert cache[key].data_ptr() == ptrs[key]
            _close(cache[key], jcache[key], tol)

    compare(got, want, cache, jcache)
    for t in range(steps):
        nxt = np.asarray(want).argmax(-1).astype(np.int32)
        pos = np.full((B,), S + t, np.int32)
        want, jcache = JDECODE(params, buffers, jcfg, jnp.asarray(nxt), jnp.asarray(pos), jcache)
        with torch.inference_mode():
            got, cache = tlm.decode_step(tp, tb, tcfg, torch.from_numpy(nxt).long(),
                                         torch.from_numpy(pos).long(), cache)
        compare(got, want, cache, jcache)


@pytest.mark.parametrize("which,S,B", [("xlstm", 7, 2), ("xlstm", 256, 1), ("mlstm_only", 7, 2),
                                       ("mlstm_only", 256, 1)])
def test_prefill_and_decode_match_jax(which, S, B, request):
    _prefill_and_decode(request.getfixturevalue(which), S, 3, seed=S, B=B)


def test_ragged_prefill_matches_jax_at_a_dividing_chunk(xlstm, monkeypatch):
    """S=300: the port's chunks of 256 and 44, against JAX's prefill with
    its ``mlstm_train`` bound to chunks of 100 (its own, 256, asserts), at
    JAX's chunk tolerance; then decode steps."""
    monkeypatch.setattr(jxlstm, "mlstm_train", functools.partial(jxlstm.mlstm_train, chunk=100))
    jcfg = xlstm[0]
    # a config JAX has not compiled yet, so that its prefill traces the patched chunk
    model = (dataclasses.replace(jcfg, name="xlstm-ragged"), *xlstm[1:])
    _prefill_and_decode(model, 300, 2, seed=11)


# --- training ------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [4, 12])
def test_mlstm_train_grads_match_jax(xlstm, chunk):
    """The gradients of a weighted sum of ``mlstm_train``'s output (S=12
    in chunks of ``chunk``) with respect to x and every param, against
    JAX's at the same chunk."""
    jcfg, tcfg, params, _, _, _ = xlstm
    p = _mlstm(params, 1, 0)
    x = _x(2, 12, jcfg.d_model, seed=20 + chunk)
    w = _x(2, 12, jcfg.d_model, seed=30 + chunk)
    jfn = _weighted(lambda p, x: jxlstm.mlstm_train(p, jcfg, x, chunk=chunk), w)
    want_p, want_x = jax.jit(jax.grad(jfn, argnums=(0, 1)))(p, jnp.asarray(x))
    got_p, got_x = _torch_grads(
        _weighted(lambda p, x: txlstm.mlstm_train(p, tcfg, x, chunk=chunk), torch.from_numpy(w)),
        convert.to_torch(p, "cpu"), x)
    _close_block_grads(got_x, want_x)
    assert set(got_p) == set(want_p)
    for key in got_p:
        _close_block_grads(got_p[key], want_p[key])


def test_slstm_seq_grads_match_jax_from_zero_state(xlstm):
    """The gradients of a weighted sum of ``slstm_seq``'s output with
    respect to x and every param against JAX's.  From the zero state the
    first step's n is exactly 1, a tie in ``maximum(n, 1)`` where JAX
    passes half the gradient to n; that gradient cancels (the first step's
    i_s = exp(i - max(-inf, i)) is 1 whatever i), so no rule at the tie
    moves these gradients, and the test holds the tie's existence, not
    its rule."""
    jcfg, tcfg, params, _, _, _ = xlstm
    p = jax.tree.map(lambda t: t[0], params["blocks"]["slstm"])
    x = _x(2, 9, jcfg.d_model, seed=40)
    w = _x(2, 9, jcfg.d_model, seed=41)
    tp = convert.to_torch(p, "cpu")
    with torch.no_grad():  # the tie is there: the first step's n
        _, (_, n, _, _) = txlstm.slstm_seq(tp, tcfg, torch.from_numpy(x[:, :1]))
    assert bool((n == 1.0).all())
    jfn = _weighted(lambda p, x: jxlstm.slstm_seq(p, jcfg, x), w)
    want_p, want_x = jax.jit(jax.grad(jfn, argnums=(0, 1)))(p, jnp.asarray(x))
    got_p, got_x = _torch_grads(
        _weighted(lambda p, x: txlstm.slstm_seq(p, tcfg, x), torch.from_numpy(w)), tp, x)
    _close_block_grads(got_x, want_x)
    assert set(got_p) == set(want_p)
    for key in got_p:
        _close_block_grads(got_p[key], want_p[key])


def _plain_recurrence(zx_t, wr, c, n, h, m):
    """``_Recurrence.apply`` through plain autograd over ``_slstm_steps``."""
    hs, (c, n, _, m) = txlstm._slstm_steps(zx_t, wr, (c, n, h, m))
    return hs, c, n, m


@pytest.mark.parametrize("block,heads", [("mlstm", 4), ("slstm", 4), ("slstm", 8)])
def test_no_grad_and_autograd_bodies_agree(xlstm, block, heads, monkeypatch):
    """Each block's serving body (no_grad: state and steps in place) and
    its training body (autograd) give the same output and terminal state
    bit for bit; the sLSTM recurrence's reverse-time backward gives plain
    autograd's gradients over its steps (of every param and of the state
    before the first step, from the output and the state after the last)
    within BODY_TOL of each leaf's largest (at 8 heads the gates' split is
    a copy, not a view).  The sLSTM runs from a carried state, as decode's
    continuation would."""
    jcfg, tcfg, params, _, _, _ = xlstm
    tcfg = dataclasses.replace(tcfg, n_heads=heads)
    fn = txlstm.mlstm_train if block == "mlstm" else txlstm.slstm_seq
    gen = torch.Generator().manual_seed(heads)
    if block == "mlstm":
        tp, kw = convert.to_torch(_mlstm(params, 0, 0), "cpu"), dict(chunk=5)
    else:
        tp, kw = txlstm.init_slstm(gen, tcfg, device="cpu"), {}
        with torch.no_grad():
            _, kw["state"] = fn(tp, tcfg, torch.randn((3, 4, tcfg.d_model), generator=gen))
    x = torch.randn((3, 12, tcfg.d_model), generator=gen)
    with torch.no_grad():
        want, want_state = fn(tp, tcfg, x, **kw)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    got, state = fn(leaves, tcfg, x, **kw)
    assert got.requires_grad and torch.equal(got.detach(), want)
    assert all(torch.equal(a.detach(), b) for a, b in zip(state, want_state))
    if block == "mlstm":
        return
    w = torch.randn(got.shape, generator=gen)
    state0 = tuple(t.clone().requires_grad_(True) for t in kw["state"])
    wrt = [*leaves.values(), *state0]

    def grads():  # of the output and of every state after the last step
        out, state = fn(leaves, tcfg, x, state=state0)
        return torch.autograd.grad((out * w).sum() + sum((0.1 * (i + 1)) * t.sum()
                                                         for i, t in enumerate(state)), wrt)

    got = grads()
    monkeypatch.setattr(txlstm._Recurrence, "apply", _plain_recurrence)
    for key, a, b in zip([*leaves, "c", "n", "h", "m"], got, grads()):
        assert _rel(a, b) <= BODY_TOL, key


@pytest.mark.parametrize("which", ["xlstm", "mlstm_only"])
def test_remat_full_equals_none_bit_for_bit(which, request):
    """Checkpointing each mLSTM block and each superblock changes no bit of
    the loss or of any gradient."""
    _, tcfg, _, _, tp, tb = request.getfixturevalue(which)
    batch = {"tokens": torch.from_numpy(_tokens(tcfg.vocab, 2, 9, seed=2)).long()}
    (l0, g0), (l1, g1) = (tloop.value_and_grad(
        lambda p, b, mb, c=dataclasses.replace(tcfg, remat=r): tlm.next_token_loss(p, b, c, mb),
        tp, tb, batch) for r in ("none", "full"))
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))


def test_two_adamw_cosine_steps_track_jax(xlstm):
    """Two adamw + cosine steps of the port's ``make_train_step`` against
    the JAX package's jitted step from the same state: the losses, norms
    and rates, then every param and moment within rtol 1e-4 / atol 1e-6,
    the input-gate biases' entries whose gradients are float noise within
    lr x steps (NOISE_RMS)."""
    jcfg, tcfg, params, buffers, _, _ = xlstm
    lr = 3e-3
    data = jbatches(jcfg.vocab, 2, 16, seed=5)
    batches = [{"tokens": next(data)["tokens"][None]} for _ in range(2)]
    jopt, topt = joptim.adamw(weight_decay=0.1), toptim.adamw(weight_decay=0.1)
    dyn, static = jloop.split_buffers(buffers)
    jstep = jax.jit(jloop.make_train_step(
        lambda p, b, mb: jlm.next_token_loss(p, b, jcfg, mb, batch_axes=None), jopt,
        joptim.cosine_schedule(lr, 1, 4), static))
    tstep = tloop.make_train_step(lambda p, b, mb: tlm.next_token_loss(p, b, tcfg, mb), topt,
                                  toptim.cosine_schedule(lr, 1, 4))
    js = jloop.init_state(params, jopt, dyn)
    tp, tb = convert.lm_to_torch(params, buffers, "cpu")
    ts = tloop.init_state(tp, topt, tb)
    for batch in batches:
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, {"tokens": torch.from_numpy(batch["tokens"])})
        for key in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-6)
    assert ts.step == int(js.step) == 2
    paths = [p for p, _ in jax_leaves_with_paths(convert.to_numpy(ts.params))]
    rms = dict(zip(paths, (np.sqrt(np.asarray(v)) for v in jax.tree.leaves(js.opt["v"]))))
    noise = {}
    for path, entries in NOISE_ENTRIES.items():
        noise[path] = np.zeros(rms[path].shape, bool)
        noise[path][entries(tcfg.d_model)] = True
        noise[path] &= rms[path] < NOISE_RMS
        assert noise[path].any(), path  # the named entries are float noise
    _close_trees(ts.params, js.params, dict(rtol=1e-4, atol=1e-6), noise=noise,
                 noise_atol=lr * 2)
    _close_trees(ts.opt, js.opt, dict(rtol=1e-4, atol=1e-6))
