"""Port vs JAX package: the dense LM.  The JAX package's params (from
``lm.init``) cross into the port with ``convert.lm_to_torch``; both sides
then run ``forward``, a bucket-padded ``prefill`` with ``last_idx`` and a
``decode_step`` on the same numpy tokens, in float32 on the CPU.  Logits
and caches agree within rtol 1e-4 / atol 1e-5: the CCE lookup is exact,
but XLA and torch sum the matmuls in different orders, and the port's
prefill attention is the flash route (online softmax) where the JAX
prefill is dense.  Configs: reduced qwen2-1.5b (CCE table, factored CCE
head, QKV bias), reduced qwen3-4b (qk_norm), and the "dense" and
"parallel" fixtures of the JAX package's model tests (full-table head;
layernorm and the parallel block)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import cce as jcce
from repro.core import embeddings as jemb
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JConfig
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import cce as tcce
from repro_torch.core import embeddings as temb
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig as TConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-5)
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=97,
            dtype=jnp.float32, remat="none")
JCONFIGS = {
    "qwen2-1.5b": jconfigs.get_reduced("qwen2-1.5b"),
    "qwen3-4b": jconfigs.get_reduced("qwen3-4b"),
    "dense": JConfig(name="dense", family="dense", qk_norm=True, qkv_bias=True, **BASE),
    "parallel": JConfig(name="par", family="dense", parallel_block=True, norm="layernorm",
                        **BASE),
}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def port_config(jcfg) -> TConfig:
    """The port's config with every field of the JAX one."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(JConfig)}
    kw["dtype"] = _DTYPES[jnp.dtype(jcfg.dtype).name]
    kw["param_dtype"] = _DTYPES[jnp.dtype(jcfg.param_dtype).name]
    return TConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(JCONFIGS))
def model(request):
    jcfg = JCONFIGS[request.param]
    params, buffers = _np(jlm.init(jax.random.PRNGKey(7), jcfg))
    tp, tb = convert.lm_to_torch(params, buffers, "cpu")
    return request.param, jcfg, port_config(jcfg), params, buffers, tp, tb


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def test_registry_matches_the_jax_package():
    for name in tconfigs.ARCHS:
        assert port_config(jconfigs.get(name)) == tconfigs.get(name)
        assert port_config(jconfigs.get_reduced(name)) == tconfigs.get_reduced(name)
        assert tconfigs.get(name).n_params() == jconfigs.get(name).n_params()


def test_init_layout_and_buffers_match_the_jax_package(model):
    _, jcfg, tcfg, params, buffers, _, _ = model
    tp, tb = tlm.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name), params)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tp)
    assert got == want
    # integer buffers are bit-exact: numpy on both sides
    for got_b, want_b in ((convert.to_numpy(tb), buffers),
                          (tlm.init_buffers(tcfg), jlm.init_buffers(jcfg))):
        gl, gdef = jax.tree.flatten(got_b)
        wl, wdef = jax.tree.flatten(want_b)
        assert gdef == wdef
        for a, b in zip(gl, wl):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_forward_matches_jax(model):
    name, jcfg, tcfg, params, buffers, tp, tb = model
    toks = _tokens(jcfg.vocab, 2, 11, seed=1)
    want, _ = jlm.forward(params, buffers, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = tlm.forward(tp, tb, tcfg, {"tokens": torch.from_numpy(toks).long()})
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_padded_prefill_and_decode_match_jax(model):
    """A 5-token prompt right-padded to its 8-token bucket, logits taken
    at ``last_idx`` 4; then one decode step at position 5 reading the
    cache the prefill wrote."""
    name, jcfg, tcfg, params, buffers, tp, tb = model
    B, S, L, max_seq = 2, 5, 8, 16
    toks = np.zeros((B, L), np.int32)
    toks[:, :S] = _tokens(jcfg.vocab, B, S, seed=2)
    jc = jlm.init_cache(jcfg, B, max_seq)
    want, jc = jlm.prefill(params, buffers, jcfg, jnp.asarray(toks), jc, last_idx=S - 1)
    tc = tlm.init_cache(tcfg, B, max_seq, device="cpu")
    got, tc = tlm.prefill(tp, tb, tcfg, torch.from_numpy(toks).long(), tc, last_idx=S - 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL)

    nxt = _tokens(jcfg.vocab, B, 1, seed=3)[:, 0]
    pos = np.full((B,), S, np.int32)
    want, jc = jlm.decode_step(params, buffers, jcfg, jnp.asarray(nxt), jnp.asarray(pos), jc)
    got, tc = tlm.decode_step(tp, tb, tcfg, torch.from_numpy(nxt).long(),
                              torch.from_numpy(pos), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL)


@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
def test_cce_logits_head_matches_jax(h_dtype):
    """The factored head alone: a (c=4, k=16) table with the head's
    seed_salt over a 300-id vocabulary; a bf16 h promotes to float32
    against the float32 tables on both sides."""
    jt = jcce.CCE(300, 32, k=16, c=4, seed_salt=1)
    tt = tcce.CCE(300, 32, k=16, c=4, seed_salt=1)
    p, b = _np(jt.init(jax.random.PRNGKey(5)))
    h = np.random.default_rng(6).normal(size=(3, 32)).astype(np.float32)
    jh = jnp.asarray(h, {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[h_dtype])
    want = jt.logits(p, b, jh)
    got = tt.logits(convert.to_torch(p, "cpu"), convert.to_torch(b, "cpu"),
                    torch.from_numpy(h).to(_DTYPES[h_dtype]))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_full_table_logits_match_jax():
    p = {"table": np.random.default_rng(8).normal(size=(50, 16)).astype(np.float32)}
    h = np.random.default_rng(9).normal(size=(2, 3, 16)).astype(np.float32)
    want = jemb.FullTable(50, 16).logits(p, {}, jnp.asarray(h))
    got = temb.FullTable(50, 16).logits(convert.to_torch(p, "cpu"), {}, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_convert_round_trip(model):
    _, _, _, params, buffers, tp, tb = model
    for back, want in ((convert.to_numpy(tp), params), (convert.to_numpy(tb), buffers)):
        bl, bdef = jax.tree.flatten(back)
        wl, wdef = jax.tree.flatten(want)
        assert bdef == wdef
        for a, b in zip(bl, wl):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("override", [dict(logit_softcap=30.0), dict(attn_impl="dense_bf16p")])
def test_unported_variants_raise(override):
    cfg = dataclasses.replace(tconfigs.get_reduced("qwen2-1.5b"), **override)
    with pytest.raises(NotImplementedError):
        tlm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
