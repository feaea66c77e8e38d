"""Port vs JAX package: the vlm family (paligemma-3b: a gemma backbone with
tied input and output embeddings, sqrt(d) embedding scaling, a GELU MLP
with biases, MQA, and projected patch embeddings prepended in
``forward``), in float32 on the CPU, within rtol 1e-4 / atol 1e-5.

Reduced paligemma-3b (2 layers, d 64, 4 query heads over 1 KV head,
head_dim 16, vocab 257, 4 patches, a CCE token table that is also the
head) starts from JAX's own ``lm.init``, carried across by
``convert.lm_to_torch``: the init layout and ``n_params``; ``forward``
with and without ``patch_emb``, and that the patches move the text
logits; ``next_token_loss`` with patches and every gradient leaf;
``prefill`` (bucket-padded, as the engine runs it) then 4 ``decode_step``s,
logits and every cache leaf.  The same prefill and decode at head_dim 256,
the head_dim of the full model, so that the flash route's plain version
runs a whole prefill at D = 256."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import lm as tlm
from repro_torch.train import loop as tloop
from repro_torch.tree import jax_leaves

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "paligemma-3b"
MAX_SEQ = 32
DECODE_STEPS = 4
# the JAX side jitted with the config static: eagerly its scans take longer
JINIT = jax.jit(jlm.init, static_argnums=1)
JFORWARD = jax.jit(lambda p, b, cfg, batch: jlm.forward(p, b, cfg, batch, batch_axes=None)[0],
                   static_argnums=2)
JPREFILL = jax.jit(lambda p, b, cfg, toks, cache, last: jlm.prefill(
    p, b, cfg, toks, cache, batch_axes=None, last_idx=last), static_argnums=2)
JDECODE = jax.jit(lambda p, b, cfg, toks, pos, cache: jlm.decode_step(p, b, cfg, toks, pos, cache,
                                                                      batch_axes=None),
                  static_argnums=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _state(jcfg, tcfg, seed):
    params, buffers = _np(JINIT(jax.random.PRNGKey(seed), jcfg))
    tp, tb = convert.lm_to_torch(params, buffers, "cpu")
    return jcfg, tcfg, params, buffers, tp, tb


@pytest.fixture(scope="module")
def vlm():
    return _state(jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH), seed=9)


@pytest.fixture(scope="module")
def vlm_d256():
    return _state(jconfigs.get_reduced(ARCH, head_dim=256),
                  tconfigs.get_reduced(ARCH, head_dim=256), seed=11)


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _patches(B, cfg, seed, fill=None):
    if fill is not None:
        return np.full((B, cfg.n_patches, cfg.d_model), fill, np.float32)
    return np.random.default_rng(seed).normal(size=(B, cfg.n_patches, cfg.d_model)).astype(
        np.float32)


def test_registry_and_n_params_match_the_jax_package():
    full, small = tconfigs.get(ARCH), tconfigs.get_reduced(ARCH)
    assert full.family == "vlm" and ARCH not in tconfigs.UNPORTED
    assert full.n_params() == jconfigs.get(ARCH).n_params() == 1_410_828_288
    assert (full.tie_embeddings, full.emb_scale, full.act, full.n_kv_heads, full.head_dim) == (
        True, True, "gelu", 1, 256)
    assert (small.n_layers, small.d_model, small.n_heads, small.n_kv_heads, small.head_dim,
            small.vocab, small.n_patches) == (2, 64, 4, 1, 16, 257, 4)
    assert small.n_params() == jconfigs.get_reduced(ARCH).n_params()


def test_init_layout_matches_the_jax_package(vlm):
    """``patch_proj`` (d, d), the GELU MLP's ``wi``/``bi``/``wo``/``bo``,
    and no ``head`` params or buffers: the CCE token table is the head."""
    _, tcfg, params, buffers, _, _ = vlm
    tp, tb = tlm.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name), params)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tp)
    assert got == want
    assert "head" not in tp and "head" not in tb and set(tb) == set(buffers) == {"emb"}
    assert tuple(tp["patch_proj"].shape) == (64, 64)
    assert set(tp["blocks"]["mlp"]) == {"wi", "bi", "wo", "bo"}
    assert set(tlm.init_buffers(tcfg)) == {"emb"}


def test_convert_carries_the_vlm_leaves_unchanged(vlm):
    """``lm_to_torch`` and back: every leaf (``patch_proj``, the MLP
    biases, the tied table's buffers) equal in value and dtype."""
    _, _, params, buffers, tp, tb = vlm
    for back, want in ((convert.to_numpy(tp), params), (convert.to_numpy(tb), buffers)):
        bl, bdef = jax.tree.flatten(back)
        wl, wdef = jax.tree.flatten(want)
        assert bdef == wdef
        for a, b in zip(bl, wl):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_patches", [False, True])
def test_forward_matches_jax(vlm, with_patches):
    jcfg, tcfg, params, buffers, tp, tb = vlm
    toks = _tokens(jcfg.vocab, 2, 7, seed=1)
    jbatch, tbatch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks).long()}
    if with_patches:
        pe = _patches(2, jcfg, seed=2)
        jbatch["patch_emb"], tbatch["patch_emb"] = jnp.asarray(pe), torch.from_numpy(pe)
    want = JFORWARD(params, buffers, jcfg, jbatch)
    got, aux = tlm.forward(tp, tb, tcfg, tbatch)
    assert float(aux) == 0.0 and tuple(got.shape) == (2, 7, jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_patches_shift_text_logits(vlm):
    """JAX's ``test_vlm_patches_shift_logits`` on the port: logits only
    for the text positions, and other patches give other logits, the
    same as JAX's for each."""
    jcfg, tcfg, params, buffers, tp, tb = vlm
    toks = _tokens(jcfg.vocab, 1, 6, seed=3)
    out = []
    for fill in (0.0, 1.0):
        pe = _patches(1, jcfg, seed=0, fill=fill)
        got, _ = tlm.forward(tp, tb, tcfg, {"tokens": torch.from_numpy(toks).long(),
                                            "patch_emb": torch.from_numpy(pe)})
        want = JFORWARD(params, buffers, jcfg, {"tokens": jnp.asarray(toks),
                                               "patch_emb": jnp.asarray(pe)})
        assert tuple(got.shape) == (1, 6, jcfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        out.append(got.numpy())
    assert not np.allclose(out[0], out[1])


def test_next_token_loss_with_patches_and_grads_match_jax(vlm):
    """The loss over the text with patches prepended, and every gradient
    leaf (``patch_proj``'s and the tied table's among them)."""
    jcfg, tcfg, params, buffers, tp, tb = vlm
    toks = _tokens(jcfg.vocab, 2, 12, seed=4)
    pe = _patches(2, jcfg, seed=5)

    def jloss(p, b):
        batch = {"tokens": jnp.asarray(toks), "patch_emb": jnp.asarray(pe)}
        return jlm.next_token_loss(p, b, jcfg, batch, batch_axes=None)[0]

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(params, buffers)
    loss, got = tloop.value_and_grad(
        lambda p, b, mb: tlm.next_token_loss(p, b, tcfg, mb), tp, tb,
        {"tokens": torch.from_numpy(toks), "patch_emb": torch.from_numpy(pe)})
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    g, w = jax_leaves(convert.to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert float(np.abs(a).sum()) > 0
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("which,S,bucket", [("vlm", 5, 8), ("vlm", 8, 8), ("vlm_d256", 11, 16)])
def test_prefill_and_decode_match_jax(which, S, bucket, request):
    """A prompt of S tokens right-padded into its power-of-two bucket and
    prefilled with ``last_idx`` S - 1 (the engine's call), then
    DECODE_STEPS decode steps: logits and every cache leaf after each
    call.  ``vlm_d256`` runs the prefill's attention at head_dim 256."""
    jcfg, tcfg, params, buffers, tp, tb = request.getfixturevalue(which)
    B = 2
    toks = np.zeros((B, bucket), np.int32)
    toks[:, :S] = _tokens(jcfg.vocab, B, S, seed=6)
    jc = jlm.init_cache(jcfg, B, MAX_SEQ)
    tc = tlm.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}
    assert tc["k"].shape[-2:] == (1, tcfg.head_dim)
    want, jc = JPREFILL(params, buffers, jcfg, jnp.asarray(toks), jc, jnp.int32(S - 1))
    got, tc = tlm.prefill(tp, tb, tcfg, torch.from_numpy(toks).long(), tc, last_idx=S - 1)

    def check():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for key in jc:
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL)

    check()
    for t in range(DECODE_STEPS):
        nxt = _tokens(jcfg.vocab, B, 1, seed=10 + t)[:, 0]
        pos = np.full((B,), S + t, np.int32)
        want, jc = JDECODE(params, buffers, jcfg, jnp.asarray(nxt), jnp.asarray(pos), jc)
        got, tc = tlm.decode_step(tp, tb, tcfg, torch.from_numpy(nxt).long(),
                                  torch.from_numpy(pos), tc)
        check()
