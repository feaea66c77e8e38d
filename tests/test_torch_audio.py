"""Port vs JAX package: the audio family (musicgen-medium: 4 EnCodec
codebook streams whose embeddings are summed at the input, one table of
4 x vocab rows with codebook j at rows j x vocab on, a head of 4 x vocab
rows read as (..., 4, vocab) logits, layernorm, a GELU MLP with biases,
sinusoidal positions), in float32 on the CPU, within rtol 1e-4 / atol
1e-5.

Reduced musicgen-medium (2 layers, d 64, 4 query heads over 2 KV heads of
16, vocab 257, full table and head), the same with 4 KV heads (MHA, the
layout of the full model), and the same under CCE (the launcher's default
``--emb``: the token table and the factored head through the lookup's
plain version) start from JAX's own ``lm.init``, carried across by
``convert.lm_to_torch``: the init layout and the convert round trip;
``embed`` with the codebook offsets and ``sinusoidal_pos_emb`` (at
positions to 2047, where torch's and XLA's float32 ``sin`` may differ by
ulps: held at the tolerance, not bit for bit); ``forward``;
``next_token_loss`` (its mean over batch, positions and codebooks) and
every gradient leaf; prompts prefilled one by one into their own rows of a
cache, then 4 ``decode_step``s at each row's own position, logits and
every cache leaf after each call.  ``n_params`` is JAX's formula (which
counts the token table as vocab x d and no biases); the serving engine
refuses a codebook model, as JAX's does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as tengine
from repro_torch.train import loop as tloop
from repro_torch.tree import jax_leaves, tree_leaves

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "musicgen-medium"
MAX_SEQ = 32
DECODE_STEPS = 4
CASES = {  # name -> overrides of both packages' reduced config
    "gqa": {},
    "mha": {"n_kv_heads": 4},
    "cce": {"emb_method": "cce", "emb_budget": 2048},
}
# the JAX side jitted with the config static: eagerly its scans take longer
JINIT = jax.jit(jlm.init, static_argnums=1)
JEMBED = jax.jit(jlm.embed, static_argnums=2)
JFORWARD = jax.jit(lambda p, b, cfg, batch: jlm.forward(p, b, cfg, batch, batch_axes=None)[0],
                   static_argnums=2)
JPREFILL = jax.jit(lambda p, b, cfg, toks, cache: jlm.prefill(p, b, cfg, toks, cache,
                                                              batch_axes=None), static_argnums=2)
JDECODE = jax.jit(lambda p, b, cfg, toks, pos, cache: jlm.decode_step(p, b, cfg, toks, pos, cache,
                                                                      batch_axes=None),
                  static_argnums=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(CASES))
def model(request):
    kw = CASES[request.param]
    jcfg, tcfg = jconfigs.get_reduced(ARCH, **kw), tconfigs.get_reduced(ARCH, **kw)
    params, buffers = _np(JINIT(jax.random.PRNGKey(5), jcfg))
    tp, tb = convert.lm_to_torch(params, buffers, "cpu")
    return request.param, jcfg, tcfg, params, buffers, tp, tb


def _tokens(vocab, *shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_registry_and_n_params_match_the_jax_package():
    """The configs field by field (``test_torch_lm.py``'s registry test
    too), and ``n_params`` equal to JAX's formula at full and reduced
    size, below what the init holds (the table's 3 x vocab x d further
    rows, the layernorm and MLP biases)."""
    full, small = tconfigs.get(ARCH), tconfigs.get_reduced(ARCH)
    assert full.family == "audio" and ARCH not in tconfigs.UNPORTED
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff, full.vocab, full.n_codebooks) == (48, 1536, 24, 24, 64, 6144, 2048, 4)
    assert (full.norm, full.act, full.pos_emb, full.emb_method) == (
        "layernorm", "gelu", "sinusoidal", "full")
    assert full.n_params() == jconfigs.get(ARCH).n_params() == 1_374_832_128
    assert small.n_params() == jconfigs.get_reduced(ARCH).n_params() == 139_904
    cce = tconfigs.get_reduced(ARCH, **CASES["cce"])
    assert cce.n_params() == jconfigs.get_reduced(ARCH, **CASES["cce"]).n_params()
    tp, _ = tlm.init(small, torch.Generator().manual_seed(0), device="cpu")
    assert sum(t.numel() for t in tree_leaves(tp)) == 189_952


def test_init_layout_matches_the_jax_package(model):
    """Every leaf's shape and dtype, the table of n_codebooks x vocab rows
    (full or CCE) and the head's; the buffers equal."""
    case, jcfg, tcfg, params, buffers, _, _ = model
    tp, tb = tlm.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name), params)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tp)
    assert got == want
    rows = jcfg.n_codebooks * jcfg.vocab
    assert tlm.make_emb(tcfg).d1 == jlm.make_emb(jcfg).d1 == rows
    if case == "cce":
        assert set(tb) == {"emb", "head"}
    else:
        assert tuple(tp["emb"]["table"].shape) == tuple(tp["head"].shape) == (rows, 64)
        assert set(tp["blocks"]["mlp"]) == {"wi", "bi", "wo", "bo"}
        assert set(tp["blocks"]["ln1"]) == {"scale", "bias"}
    gl, wl = jax.tree.leaves(convert.to_numpy(tb)), jax.tree.leaves(buffers)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_convert_round_trip(model):
    _, _, _, params, buffers, tp, tb = model
    for back, want in ((convert.to_numpy(tp), params), (convert.to_numpy(tb), buffers)):
        bl, bdef = jax.tree.flatten(back)
        wl, wdef = jax.tree.flatten(want)
        assert bdef == wdef
        for a, b in zip(bl, wl):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_embed_sums_the_offset_codebooks(model):
    """``embed`` of (B, S, 4) tokens: JAX's, and the sum over j of the
    table's rows j x vocab + token."""
    case, jcfg, tcfg, params, buffers, tp, tb = model
    toks = _tokens(jcfg.vocab, 2, 5, jcfg.n_codebooks, seed=1)
    want = JEMBED(params, buffers, jcfg, jnp.asarray(toks))
    got = tlm.embed(tp, tb, tcfg, torch.from_numpy(toks).long())
    assert tuple(got.shape) == (2, 5, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    table = tlm.make_emb(tcfg)
    rows = torch.from_numpy(toks).long() + torch.arange(jcfg.n_codebooks) * jcfg.vocab
    each = table.lookup(tp["emb"], tb["emb"], rows)  # (2, 5, 4, 64)
    np.testing.assert_allclose(got.numpy(), each.sum(-2).numpy(), **TOL)


def test_sinusoidal_pos_emb_matches_jax():
    """At the positions the CPU tests' prompts reach, within the LM
    tolerance.  To 2047 (1500 EnCodec frames and more) not so: XLA's and
    torch's float32 ``exp`` on the CPU differ by an ulp at some of the
    frequencies, and at position p an ulp of frequency moves the angle by
    p of them (up to 1.2e-4 rad at 2047, past atol 1e-5).  There each
    entry is held within p ulps of JAX's frequency, two of the angle and
    one of sin and cos."""
    for d in (64, 1536):
        half = d // 2
        pos = np.arange(2048, dtype=np.int32).reshape(2, 1024)
        want = np.asarray(jlayers.sinusoidal_pos_emb(jnp.asarray(pos), d))
        got = tlayers.sinusoidal_pos_emb(torch.from_numpy(pos).long(), d)
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1024, d)
        got = got.numpy()
        np.testing.assert_allclose(got[0, :64], want[0, :64], **TOL)
        freqs = np.asarray(jnp.exp(-np.log(10000.0) * jnp.arange(half, dtype=jnp.float32)
                                   / half))
        p = pos[..., None].astype(np.float32)
        bound = p * np.spacing(freqs) + 2 * np.spacing(p * freqs) + 2.0 ** -23
        assert (np.abs(got - want) <= np.concatenate([bound, bound], -1)).all()


def test_forward_matches_jax(model):
    _, jcfg, tcfg, params, buffers, tp, tb = model
    toks = _tokens(jcfg.vocab, 2, 9, jcfg.n_codebooks, seed=2)
    want = JFORWARD(params, buffers, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = tlm.forward(tp, tb, tcfg, {"tokens": torch.from_numpy(toks).long()})
    assert float(aux) == 0.0 and tuple(got.shape) == (2, 9, jcfg.n_codebooks, jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_next_token_loss_and_grads_match_jax(model):
    """The loss (the mean over B x (S - 1) x codebooks of logsumexp minus
    the target's logit) and every gradient leaf."""
    _, jcfg, tcfg, params, buffers, tp, tb = model
    toks = _tokens(jcfg.vocab, 2, 10, jcfg.n_codebooks, seed=3)

    def jloss(p, b):
        return jlm.next_token_loss(p, b, jcfg, {"tokens": jnp.asarray(toks)}, batch_axes=None)[0]

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(params, buffers)
    batch = {"tokens": torch.from_numpy(toks)}
    loss, got = tloop.value_and_grad(lambda p, b, mb: tlm.next_token_loss(p, b, tcfg, mb),
                                     tp, tb, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    with torch.no_grad():
        lg = tlm.forward(tp, tb, tcfg, batch)[0][:, :-1].double()
    tg = torch.from_numpy(toks[:, 1:]).long()
    terms = torch.logsumexp(lg, -1) - torch.gather(lg, -1, tg[..., None])[..., 0]
    assert tuple(terms.shape) == (2, 9, jcfg.n_codebooks)
    np.testing.assert_allclose(float(loss), float(terms.mean()), **TOL)
    g, w = jax_leaves(convert.to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert float(np.abs(a).sum()) > 0
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_prefill_rows_and_decode_match_jax(model):
    """Prompts of 5 and 11 frames, each prefilled alone (unpadded) into
    its own row of a 2-row cache (JAX: a 1-row cache each, the rows then
    stacked); then DECODE_STEPS decode steps with each row at its own
    position: logits (B, 4, vocab) and every cache leaf after each call."""
    _, jcfg, tcfg, params, buffers, tp, tb = model
    cb, lens = jcfg.n_codebooks, (5, 11)
    tc = tlm.init_cache(tcfg, len(lens), MAX_SEQ, device="cpu")
    jrows = []
    for row, S in enumerate(lens):
        toks = _tokens(jcfg.vocab, 1, S, cb, seed=4 + row)
        want, jc = JPREFILL(params, buffers, jcfg, jnp.asarray(toks),
                            jlm.init_cache(jcfg, 1, MAX_SEQ))
        view = {k: c.narrow(1, row, 1) for k, c in tc.items()}
        got, _ = tlm.prefill(tp, tb, tcfg, torch.from_numpy(toks).long(), view)
        assert tuple(got.shape) == (1, cb, jcfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        jrows.append(jc)
    jc = {k: jnp.concatenate([r[k] for r in jrows], axis=1) for k in jrows[0]}
    for key in jc:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL)
    for t in range(DECODE_STEPS):
        nxt = _tokens(jcfg.vocab, len(lens), cb, seed=10 + t)
        pos = np.asarray(lens, np.int32) + t
        want, jc = JDECODE(params, buffers, jcfg, jnp.asarray(nxt), jnp.asarray(pos), jc)
        got, tc = tlm.decode_step(tp, tb, tcfg, torch.from_numpy(nxt).long(),
                                  torch.from_numpy(pos), tc)
        assert tuple(got.shape) == (len(lens), cb, jcfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for key in jc:
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL)


def test_serve_engine_refuses_codebooks_as_jax_does():
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    with pytest.raises(AssertionError, match="audio"):
        jengine.ServeEngine(jcfg, {}, {})
    tp, tb = tlm.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="codebooks"):
        tengine.ServeEngine(tcfg, tp, tb)
