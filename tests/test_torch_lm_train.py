"""Port vs JAX package: the LM's training pieces on ``reduced()`` (2
layers, d 64, vocab 257, float32) on the CPU.

* ``lm_token_batches`` gives the JAX package's batches bit for bit, the
  audio family's codebook streams too.
* ``next_token_loss`` and every gradient leaf (the CCE token table
  through the lookup's backward, the factored CCE head through its
  gathers) agree with ``jax.value_and_grad`` of the JAX loss to rtol 1e-5
  / atol 1e-6, for reduced qwen2-1.5b (QKV bias) and qwen3-4b (qk_norm)
  with a CCE and a full token table.  Both sides start from the port's
  init carried to numpy (JAX's eager init costs seconds a config).
* ``remat="full"`` gives the loss and gradients of ``remat="none"`` bit
  for bit.
* ``_sdpa_chunked`` (a loop over KV chunks, each checkpointed) agrees
  with the JAX package's scan in value and gradients.
* Two adamw + cosine steps track the JAX package's jitted
  ``make_train_step`` to rtol 1e-4 / atol 1e-6 on reduced qwen2-1.5b and
  qwen3-4b, qwen2-1.5b's key bias within lr x steps."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.data.synthetic import lm_token_batches as jbatches
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.train import loop as jloop
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import optim as toptim
from repro_torch.data.synthetic import lm_token_batches as tbatches
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
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

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
KEY_BIAS = "['blocks']['attn']['bk']"
B, S = 2, 16
LR = 3e-3  # adamw's peak in the step tests
CASES = {  # name -> (arch, overrides of both packages' reduced config)
    "qwen2-1.5b-cce": ("qwen2-1.5b", {}),
    "qwen2-1.5b-full": ("qwen2-1.5b", {"emb_method": "full"}),
    "qwen3-4b-cce": ("qwen3-4b", {}),
    "qwen3-4b-full": ("qwen3-4b", {"emb_method": "full"}),
}


def _configs(case):
    arch, kw = CASES[case]
    return jconfigs.get_reduced(arch, **kw), tconfigs.get_reduced(arch, **kw)


def _tokens(vocab, seed=0):
    return next(jbatches(vocab, B, S, seed=seed, start_step=3))["tokens"]


def _assert_tree_close(got, want, *, bias_atol=None, **tol):
    """Every leaf within ``tol``; the params' key bias within ``bias_atol``
    absolute where given."""
    g, w = jax_leaves_with_paths(convert.to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for (path, a), b in zip(g, w):
        leaf_tol = tol if bias_atol is None or path != KEY_BIAS else dict(rtol=0, atol=bias_atol)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **leaf_tol)


def _init(case):
    """(JAX config, port config, numpy params, numpy buffers)."""
    jcfg, tcfg = _configs(case)
    params, buffers = tlm.init(tcfg, torch.Generator().manual_seed(7), device="cpu")
    return jcfg, tcfg, convert.to_numpy(params), convert.to_numpy(buffers)


@pytest.fixture(scope="module", params=sorted(CASES))
def model(request):
    return request.param, *_init(request.param)


@pytest.mark.parametrize("vocab,batch,seq,seed,start", [
    (257, 2, 16, 0, 0), (257, 3, 9, 5, 7), (151936, 2, 32, 1, 2)])
def test_lm_token_batches_bit_for_bit(vocab, batch, seq, seed, start):
    want, got = (f(vocab, batch, seq, seed=seed, start_step=start) for f in (jbatches, tbatches))
    for _ in range(2):
        w, g = next(want), next(got)
        assert g["step"] == w["step"]
        assert g["tokens"].dtype == w["tokens"].dtype == np.int32
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


@pytest.mark.parametrize("seed,start", [(0, 0), (6, 3)])
def test_lm_token_batches_codebooks_bit_for_bit(seed, start):
    """The audio family's (batch, seq, n_codebooks) stream, each codebook
    a chain of its own."""
    want, got = (f(2048, 2, 12, seed=seed, start_step=start, n_codebooks=4)
                 for f in (jbatches, tbatches))
    for _ in range(2):
        w, g = next(want), next(got)
        assert g["step"] == w["step"]
        assert g["tokens"].shape == w["tokens"].shape == (2, 12, 4)
        assert g["tokens"].dtype == w["tokens"].dtype == np.int32
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


def test_next_token_loss_and_grads_match_jax(model):
    case, jcfg, tcfg, params, buffers = model
    tokens = _tokens(jcfg.vocab)

    def jloss(p, b, x):
        return jlm.next_token_loss(p, b, jcfg, x, batch_axes=None)[0]

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(params, buffers, {"tokens": tokens})
    tp, tb = convert.lm_to_torch(params, buffers, "cpu")
    loss, got = tloop.value_and_grad(
        lambda p, b, mb: tlm.next_token_loss(p, b, tcfg, mb), tp, tb,
        {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), float(want_loss), **GRAD_TOL)
    assert all(float(g.abs().sum()) > 0 for g in tree_leaves(got["emb"]))
    _assert_tree_close(got, want, **GRAD_TOL)


@pytest.mark.parametrize("attn", ["dense", "chunked"])
def test_remat_full_equals_none_bit_for_bit(attn):
    cfg = tconfigs.get_reduced("qwen2-1.5b", attn_impl=attn, attn_chunk=4)
    params, buffers = tlm.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    mb = {"tokens": torch.from_numpy(_tokens(cfg.vocab, seed=4))}
    out = [tloop.value_and_grad(lambda p, b, x, c=dataclasses.replace(cfg, remat=r):
                                tlm.next_token_loss(p, b, c, x), params, buffers, mb)
           for r in ("none", "full")]
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))
    with pytest.raises(NotImplementedError, match="dots"):
        tlm.forward(params, buffers, dataclasses.replace(cfg, remat="dots"), mb)


def test_sdpa_chunked_matches_jax():
    """S=32 in chunks of 8, 4 query heads over 2 KV heads: the output and
    the gradients of a weighted sum with respect to q, k and v."""
    jcfg, tcfg = _configs("qwen2-1.5b-cce")
    jcfg, tcfg = (dataclasses.replace(c, attn_impl="chunked", attn_chunk=8)
                  for c in (jcfg, tcfg))
    rng = np.random.default_rng(11)
    q = rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 32, 2, 16)).astype(np.float32) for _ in range(2))
    w = rng.normal(size=q.shape).astype(np.float32)

    def jfn(q, k, v):
        return (jlayers._sdpa_chunked(jcfg, q, k, v) * w).sum()

    want_out = np.asarray(jlayers._sdpa_chunked(jcfg, q, k, v))
    want_grads = jax.grad(jfn, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tlayers._sdpa_chunked(tcfg, tq, tk, tv)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **GRAD_TOL)
    dense = tlayers._sdpa(tcfg, tq, tk, tv, tlayers.causal_mask(32, 32, device="cpu"))
    np.testing.assert_allclose(out.detach().numpy(), dense.detach().numpy(), **GRAD_TOL)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for g, want in zip(got, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **GRAD_TOL)
    with pytest.raises(ValueError, match="attn_chunk"):
        tlayers._sdpa_chunked(dataclasses.replace(tcfg, attn_chunk=5), tq, tk, tv)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-4b"])
def test_two_adamw_cosine_steps_track_jax(arch):
    """qwen2-1.5b's key bias has gradients that vanish but for float noise
    (a bias added to every key shifts the scores of a query by a constant
    along the slowly turning rope dimensions, and the softmax drops
    constants), and adam's first steps scale any gradient to about ±1,
    noise included: the bias is held within lr x steps, its gradients at
    GRAD_TOL above and its moments at STEP_TOL here."""
    jcfg, tcfg, params, buffers = _init(f"{arch}-cce")
    data = jbatches(jcfg.vocab, B, S, seed=2)
    batches = [{"tokens": next(data)["tokens"][None]} for _ in range(2)]
    jopt, topt = joptim.adamw(weight_decay=0.1), toptim.adamw(weight_decay=0.1)
    dyn, static = jloop.split_buffers(buffers)
    jstep = jax.jit(jloop.make_train_step(
        lambda p, b, mb: jlm.next_token_loss(p, b, jcfg, mb, batch_axes=None), jopt,
        joptim.cosine_schedule(LR, 1, 4), static))
    tstep = tloop.make_train_step(lambda p, b, mb: tlm.next_token_loss(p, b, tcfg, mb), topt,
                                  toptim.cosine_schedule(LR, 1, 4))
    js = jloop.init_state(params, jopt, dyn)
    tp, tb = convert.lm_to_torch(params, buffers, "cpu")
    ts = tloop.init_state(tp, topt, tb)
    for batch in batches:
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, {"tokens": torch.from_numpy(batch["tokens"])})
        for key in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-6)
    assert ts.step == int(js.step) == 2
    _assert_tree_close(ts.params, js.params, bias_atol=LR * 2, **STEP_TOL)
    _assert_tree_close(ts.opt, js.opt, **STEP_TOL)
