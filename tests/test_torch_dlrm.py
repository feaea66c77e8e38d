"""Port vs JAX package: DLRM init layout, interact and forward.  Logits
agree within rtol = atol = 1e-5 in float32: the embeddings are bit-exact,
but XLA and torch sum the MLP and interaction matmuls in different
orders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_criteo as jcfg
from repro.data.synthetic import ClickstreamConfig as JClick
from repro.data.synthetic import clickstream_batches as jbatches
from repro.data.translate import HostTranslator as JTranslator
from repro.models import dlrm as jdlrm
from repro_torch import convert
from repro_torch.configs import dlrm_criteo as tcfg
from repro_torch.data.synthetic import ClickstreamConfig as TClick
from repro_torch.data.synthetic import clickstream_batches as tbatches
from repro_torch.models import dlrm as tdlrm

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)
MIXED = dict(vocab_sizes=(24, 1000, 5000, 10, 20000), emb_method="cce", emb_param_cap=512,
             bottom_mlp=(64, 32, 16), top_mlp=(64, 1))


@pytest.fixture(scope="module", params=["reduced", "mixed"])
def state(request):
    if request.param == "reduced":
        jc, tc = jcfg.reduced(), tcfg.reduced()
    else:
        jc, tc = jdlrm.DLRMConfig(**MIXED), tdlrm.DLRMConfig(**MIXED)
    p, b = jdlrm.init(jax.random.PRNGKey(3), jc)
    p, b = jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, b)
    return jc, tc, p, b, convert.to_torch(p, "cpu"), convert.to_torch(b, "cpu")


def test_synthetic_batches_identical():
    a = jbatches(JClick(vocab_sizes=(1000, 20, 5000)), 16, start_step=3)
    b = tbatches(TClick(vocab_sizes=(1000, 20, 5000)), 16, start_step=3)
    for _ in range(2):
        x, y = next(a), next(b)
        assert x.keys() == y.keys()
        for key in x:
            np.testing.assert_array_equal(x[key], y[key])


@pytest.mark.parametrize("n", [2, 6, 27])
def test_triu_pair_order_matches_jnp(n):
    iu, ju = jnp.triu_indices(n, k=1)
    t = torch.triu_indices(n, n, 1)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(iu))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(ju))


def test_init_layout_matches_jax(state):
    jc, tc, p, b, _, _ = state
    pt, bt = tdlrm.init(tc, torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        return jax.tree.map(lambda x: (tuple(np.shape(x)), str(np.asarray(x).dtype)), tree)

    assert shapes(convert.to_numpy(pt)) == shapes(p)
    assert shapes(convert.to_numpy(bt)) == shapes(b)
    for g_want, g_got in zip(b["emb"], convert.to_numpy(bt)["emb"]):  # ints bit-exact
        for w, g in zip(g_want, g_got):
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])


def test_interact_matches_jax(state):
    jc, tc, p, _, pt, _ = state
    rng = np.random.default_rng(0)
    B = 9
    dense = rng.normal(size=(B, jc.n_dense)).astype(np.float32)
    emb = rng.normal(size=(B, jc.n_sparse, jc.emb_dim)).astype(np.float32)
    want = np.asarray(jdlrm.interact(p, jc, jnp.asarray(dense), jnp.asarray(emb)))
    got = tdlrm.interact(pt, tc, torch.from_numpy(dense), torch.from_numpy(emb))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_forward_matches_jax_on_sparse_and_rows(state):
    jc, tc, p, b, pt, bt = state
    batch = next(jbatches(JClick(vocab_sizes=jc.vocab_sizes), 16, start_step=5))
    want = np.asarray(jax.jit(lambda p, b, d, s: jdlrm.forward(p, b, jc, {"dense": d, "sparse": s}))(
        p, b, batch["dense"], batch["sparse"]))
    got = tdlrm.forward(pt, bt, tc, {"dense": torch.from_numpy(batch["dense"]),
                                     "sparse": torch.from_numpy(batch["sparse"])})
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    rows = JTranslator(jc.collection, b["emb"]).rows(batch["sparse"])
    got_rows = tdlrm.forward(pt, bt, tc, {"dense": torch.from_numpy(batch["dense"]),
                                            "rows": torch.from_numpy(rows)})
    assert torch.equal(got_rows, got)
