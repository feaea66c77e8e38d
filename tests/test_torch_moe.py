"""Port vs JAX package: the moe family, in float32 on the CPU.

The routes of ``models/moe.py`` at the shapes of the JAX package's MoE
tests (d 32, 8 experts, top-2, 2 x 64 tokens in groups of 64), with
capacity drops (capacity factor 1.25) and without (8.0): ``apply_moe``,
``apply_moe_sort``, ``apply_moe_sort_sm`` (without a mesh, the sort
route in both packages) and ``apply_moe_decode`` against JAX's, outputs
and aux within rtol 1e-5 / atol 1e-6; the routing decisions (``gate_idx``
and which choices kept a slot) equal to those of JAX's ``apply_moe``
(its lines in jnp, checked to give its output), as each route records
them in ``moe.TRACE``; a planted three-way tie at the top-2 boundary,
which JAX's ``top_k`` and the port's stable sort both break towards the
lower experts; gradients of both routes against ``jax.grad``.

The LM: the "moe" fixture of the JAX package's model tests (capacity
8.0), reduced phi3.5-moe-42b-a6.6b and reduced qwen3-moe-235b-a22b
(qk_norm), both at capacity 1.25 (tokens drop), from JAX's own
``lm.init`` carried across by ``convert.lm_to_torch``: ``forward`` and
its aux, ``next_token_loss`` and every gradient leaf, a bucket-padded
``prefill`` with ``last_idx`` (the pads routed and taking capacity, as in
JAX) then decode steps, at ``test_torch_lm.py``'s rtol 1e-4 / atol 1e-5;
the init layout, ``convert``'s round trip, and ``n_params`` /
``n_active_params`` against JAX's."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
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

MOE_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)  # test_torch_lm.py's
GROUP = 64
MAX_SEQ = 32
DECODE_STEPS = 3
ROUTES = {"einsum": (jmoe.apply_moe, tmoe.apply_moe),
          "sort": (jmoe.apply_moe_sort, tmoe.apply_moe_sort),
          "sort_sm": (jmoe.apply_moe_sort_sm, tmoe.apply_moe_sort_sm)}
ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b")
# test_models.py's "moe" fixture
FIXTURE = dict(name="moe", family="moe", n_experts=4, top_k=2, capacity_factor=8.0, n_layers=2,
               d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=97, remat="none")
JINIT = jax.jit(jlm.init, static_argnums=1)
JFORWARD = jax.jit(lambda p, b, cfg, toks: jlm.forward(p, b, cfg, {"tokens": toks},
                                                       batch_axes=None), static_argnums=2)
JLOSS_GRAD = jax.jit(jax.value_and_grad(
    lambda p, b, cfg, toks: jlm.next_token_loss(p, b, cfg, {"tokens": toks}, batch_axes=None)[0]),
    static_argnums=2)
JPREFILL = jax.jit(lambda p, b, cfg, toks, cache, last: jlm.prefill(
    p, b, cfg, toks, cache, batch_axes=None, last_idx=last), static_argnums=2)
JDECODE = jax.jit(lambda p, b, cfg, toks, pos, cache: jlm.decode_step(p, b, cfg, toks, pos, cache,
                                                                      batch_axes=None),
                  static_argnums=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _moe_cfgs(cf):
    kw = dict(name="m", family="moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=48,
              vocab=97, n_experts=8, top_k=2, capacity_factor=cf, remat="none")
    return JConfig(dtype=jnp.float32, **kw), TConfig(dtype=torch.float32, **kw)


def _layer(cf, seed=0):
    """(JAX cfg, port cfg, params as numpy, as tensors, x (2, 64, 32))."""
    jcfg, tcfg = _moe_cfgs(cf)
    p = _np(jmoe.init_moe(jax.random.PRNGKey(seed), jcfg))
    x = np.random.default_rng(seed + 1).normal(size=(2, 64, 32)).astype(np.float32)
    return jcfg, tcfg, p, convert.to_torch(p, "cpu"), x


def _jax_routing(p, cfg, x, group_size):
    """(gate_idx, keep (G, g, k), combine (G, g, E, C)) as the JAX
    package's ``apply_moe`` computes them: its lines, in jnp."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    g = min(group_size, B * S)
    G = B * S // g
    C = max(k, int(math.ceil(g * k / E * cfg.capacity_factor)))
    xg = x.reshape(G, g, d)
    logits = (xg @ p["router"].astype(x.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True), 1e-9)
    combine = jnp.zeros((G, g, E, C), jnp.float32)
    counts = jnp.zeros((G, E), jnp.float32)
    keeps = []
    for j in range(k):
        mask = jax.nn.one_hot(gate_idx[..., j], E, dtype=jnp.float32)
        pos = jnp.cumsum(mask, axis=1) - mask + counts[:, None, :]
        counts = counts + mask.sum(axis=1)
        keep = mask * (pos < C)
        keeps.append(keep.sum(-1) > 0)
        pos_oh = jax.nn.one_hot(pos.astype(jnp.int32), C, dtype=jnp.float32)
        combine = combine + gate_vals[..., j, None, None] * keep[..., None] * pos_oh
    return np.asarray(gate_idx), np.stack([np.asarray(kp) for kp in keeps], -1), combine


def _jax_combined(p, x, combine, G, g):
    """JAX's ``apply_moe`` output from a given ``combine`` (its lines)."""
    xg = x.reshape(G, g, -1)
    dispatch = (combine > 0).astype(x.dtype)
    ein = jnp.einsum("gtec,gtd->gecd", dispatch, xg)
    h = jax.nn.silu(jnp.einsum("gecd,edf->gecf", ein, p["wg"])) * jnp.einsum(
        "gecd,edf->gecf", ein, p["wi"])
    eo = jnp.einsum("gecf,efd->gecd", h, p["wo"])
    return jnp.einsum("gtec,gecd->gtd", combine, eo).reshape(x.shape)


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("route", list(ROUTES))
def test_routes_match_jax(route, cf):
    jcfg, tcfg, p, tp, x = _layer(cf)
    jfn, tfn = ROUTES[route]
    want, want_aux = jfn(p, jcfg, jnp.asarray(x), group_size=GROUP)
    got, aux = tfn(tp, tcfg, torch.from_numpy(x), group_size=GROUP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def _traced(fn, *args, **kw):
    """(fn's output, the decisions ``moe.TRACE`` recorded during it)."""
    tmoe.TRACE = []
    try:
        out = fn(*args, **kw)
    finally:
        trace, tmoe.TRACE = tmoe.TRACE, None
    return out, trace


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("route", ["einsum", "sort"])
def test_routing_decisions_equal_jax(route, cf):
    """The gate_idx and keep each route records in ``TRACE`` (the sort
    route's keep put back in token order) equal JAX's, bit for bit; drops
    at 1.25, none at 8.0."""
    jcfg, tcfg, p, tp, x = _layer(cf)
    gate_idx, keep, combine = _jax_routing(p, jcfg, jnp.asarray(x), GROUP)
    # the jnp lines above are what JAX's apply_moe ran
    np.testing.assert_allclose(np.asarray(_jax_combined(p, jnp.asarray(x), combine, 2, GROUP)),
                               np.asarray(jmoe.apply_moe(p, jcfg, jnp.asarray(x),
                                                         group_size=GROUP)[0]), atol=1e-6)
    _, trace = _traced(ROUTES[route][1], tp, tcfg, torch.from_numpy(x), group_size=GROUP)
    ((kind, got_idx, got_keep),) = trace
    assert kind == "seq" and tuple(got_idx.shape) == tuple(got_keep.shape) == (2, 64, 2)
    np.testing.assert_array_equal(got_idx.numpy().reshape(gate_idx.shape), gate_idx)
    np.testing.assert_array_equal(got_keep.numpy().reshape(keep.shape), keep)
    drops = int((~keep).sum())
    assert (drops > 0) == (cf == 1.25)
    assert tmoe.TRACE is None and _traced(lambda: None)[1] == []


def test_decode_route_matches_jax():
    """Every expert on each of 128 single-token rows, masked by the top-2
    gates; with capacity 8.0 nothing drops, so the sort route gives the
    same (JAX's ``test_no_drops_at_high_capacity``)."""
    jcfg, tcfg, p, tp, x = _layer(8.0)
    rows = x.reshape(128, 1, 32)
    want = jmoe.apply_moe_decode(p, jcfg, jnp.asarray(rows))
    got, trace = _traced(tmoe.apply_moe_decode, tp, tcfg, torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    seq, _ = tmoe.apply_moe_sort(tp, tcfg, torch.from_numpy(x), group_size=GROUP)
    np.testing.assert_allclose(seq.numpy().reshape(128, 1, 32), got.numpy(), atol=1e-5)
    gate_idx, _, _ = _jax_routing(p, jcfg, jnp.asarray(x), GROUP)
    ((kind, idx, keep),) = trace
    assert kind == "decode" and keep is None
    np.testing.assert_array_equal(idx.numpy().reshape(gate_idx.shape), gate_idx)


@pytest.mark.parametrize("route", ["einsum", "sort", "decode"])
def test_planted_tie_goes_to_the_lower_experts(route):
    """Router columns 2, 5 and 7 equal and scaled up: every token whose
    product with them is positive ties three ways for the top 2.  JAX's
    ``top_k`` and the port's stable sort both keep experts 2 then 5: the
    decisions the route records equal JAX's, and the outputs agree."""
    jcfg, tcfg, p, tp, x = _layer(1.25)
    router = p["router"].copy()
    router[:, [2, 5, 7]] = 4.0 * router[:, [2]]
    p = dict(p, router=router)
    tp = convert.to_torch(p, "cpu")
    tx = torch.from_numpy(x)
    probs, _, idx = tmoe.route(tp, tcfg, tx)
    tied = probs[..., 2] > probs.max(-1).values * (1 - 1e-7)  # the tied three are the top
    assert int(tied.sum()) > 20
    assert bool((probs[..., 2] == probs[..., 5]).all() and (probs[..., 5] == probs[..., 7]).all())
    assert bool((idx[tied] == torch.tensor([2, 5])).all())
    gate_idx, keep, _ = _jax_routing(p, jcfg, jnp.asarray(x), GROUP)
    if route == "decode":
        rows = x.reshape(128, 1, 32)
        want = jmoe.apply_moe_decode(p, jcfg, jnp.asarray(rows))
        got, trace = _traced(tmoe.apply_moe_decode, tp, tcfg, torch.from_numpy(rows))
    else:
        jfn, tfn = ROUTES[route]
        want, _ = jfn(p, jcfg, jnp.asarray(x), group_size=GROUP)
        (got, _), trace = _traced(tfn, tp, tcfg, tx, group_size=GROUP)
        np.testing.assert_array_equal(trace[0][2].numpy().reshape(keep.shape), keep)
    np.testing.assert_array_equal(trace[0][1].numpy().reshape(gate_idx.shape), gate_idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)


@pytest.mark.parametrize("route", ["einsum", "sort"])
def test_route_gradients_match_jax(route):
    """d/d(params, x) of a weighted sum of the output plus the aux, at
    capacity 1.25 (dropped choices carry no gradient)."""
    jcfg, tcfg, p, tp, x = _layer(1.25)
    w = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    jfn, tfn = ROUTES[route]

    def jloss(p, x):
        out, aux = jfn(p, jcfg, x, group_size=GROUP)
        return (out * w).sum() + aux

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tfn(leaves, tcfg, tx, group_size=GROUP)
    ((out * torch.from_numpy(w)).sum() + aux).backward()
    for k in leaves:
        assert float(leaves[k].grad.abs().sum()) > 0
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(want_p[k]), **MOE_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), **MOE_TOL)


def _port_config(jcfg) -> TConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(JConfig)}
    kw["dtype"], kw["param_dtype"] = torch.float32, torch.float32
    return TConfig(**kw)


@pytest.fixture(scope="module", params=["fixture", *ARCHS])
def model(request):
    if request.param == "fixture":
        jcfg = JConfig(dtype=jnp.float32, **FIXTURE)
    else:
        jcfg = jconfigs.get_reduced(request.param)
    tcfg = _port_config(jcfg)
    if request.param != "fixture":
        assert tcfg == tconfigs.get_reduced(request.param)
    params, buffers = _np(JINIT(jax.random.PRNGKey(13), jcfg))
    tp, tb = convert.lm_to_torch(params, buffers, "cpu")
    return request.param, jcfg, tcfg, params, buffers, tp, tb


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def test_registry_and_param_counts_match_the_jax_package():
    for name in ARCHS:
        full = tconfigs.get(name)
        assert full.family == "moe" and name not in tconfigs.UNPORTED
        assert _port_config(jconfigs.get(name)) == dataclasses.replace(full,
                                                                       dtype=torch.float32)
        for got, want in ((full, jconfigs.get(name)),
                          (tconfigs.get_reduced(name), jconfigs.get_reduced(name))):
            assert got.n_params() == want.n_params()
            assert got.n_active_params() == want.n_active_params()
    phi = tconfigs.get(ARCHS[0])
    assert (phi.n_experts, phi.top_k, phi.d_ff, phi.capacity_factor) == (16, 2, 6400, 1.25)
    assert tconfigs.get(ARCHS[1]).qk_norm


def test_init_layout_matches_the_jax_package(model):
    """The ``moe`` subtree (router (L, d, E); wi, wg (L, E, d, f); wo (L,
    E, f, d)) in place of ``mlp``, and the count ``n_params`` gives."""
    _, jcfg, tcfg, params, _, _, _ = model
    tp, _ = tlm.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name), params)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tp)
    assert got == want and "mlp" not in tp["blocks"]
    L, d, E, f = tcfg.n_layers, tcfg.d_model, tcfg.n_experts, tcfg.d_ff
    assert {k: tuple(v.shape) for k, v in tp["blocks"]["moe"].items()} == {
        "router": (L, d, E), "wi": (L, E, d, f), "wg": (L, E, d, f), "wo": (L, E, f, d)}


def test_convert_round_trip(model):
    _, _, _, params, buffers, tp, tb = model
    for back, want in ((convert.to_numpy(tp), params), (convert.to_numpy(tb), buffers)):
        bl, bdef = jax.tree.flatten(back)
        wl, wdef = jax.tree.flatten(want)
        assert bdef == wdef
        for a, b in zip(bl, wl):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("impl", ["einsum", "sort", "sort_sm"])
def test_forward_and_aux_match_jax(model, impl):
    _, jcfg, tcfg, params, buffers, tp, tb = model
    jcfg, tcfg = (dataclasses.replace(c, moe_impl=impl) for c in (jcfg, tcfg))
    toks = _tokens(jcfg.vocab, 2, 11, seed=1)
    want, want_aux = JFORWARD(params, buffers, jcfg, jnp.asarray(toks))
    got, aux = tlm.forward(tp, tb, tcfg, {"tokens": torch.from_numpy(toks).long()})
    assert float(aux) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_next_token_loss_and_grads_match_jax(model):
    """ce + 0.01 aux, and every gradient leaf (the router's, the
    experts', the CCE tables')."""
    _, jcfg, tcfg, params, buffers, tp, tb = model
    toks = _tokens(jcfg.vocab, 2, 12, seed=4)
    want_loss, want = JLOSS_GRAD(params, buffers, jcfg, jnp.asarray(toks))
    loss, got = tloop.value_and_grad(lambda p, b, mb: tlm.next_token_loss(p, b, tcfg, mb),
                                     tp, tb, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    g, w = jax_leaves(convert.to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert float(np.abs(a).sum()) > 0
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("impl", ["einsum", "sort_sm"])
def test_padded_prefill_and_decode_match_jax(model, impl, monkeypatch):
    """A 3-token prompt right-padded with 13 zeros into its 16-token
    bucket (the engine's call), ``last_idx`` 2: the pads are routed and
    take capacity as in JAX (at capacity 1.25 a real token's second
    choice drops behind the pads' first choices), the prefill takes the
    einsum route under "sort_sm" as JAX's does; then DECODE_STEPS decode
    steps through every expert.  Logits and the k/v cache after each
    call."""
    name, jcfg, tcfg, params, buffers, tp, tb = model
    jcfg, tcfg = (dataclasses.replace(c, moe_impl=impl) for c in (jcfg, tcfg))
    monkeypatch.setattr(tmoe, "apply_moe_sort", None)  # never reached in a prefill here
    B, S, bucket = 1, 3, 16
    toks = np.zeros((B, bucket), np.int32)
    toks[:, :S] = _tokens(jcfg.vocab, B, S, seed=6)
    jc = jlm.init_cache(jcfg, B, MAX_SEQ)
    tc = tlm.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    want, jc = JPREFILL(params, buffers, jcfg, jnp.asarray(toks), jc, jnp.int32(S - 1))
    (got, tc), routes = _traced(tlm.prefill, tp, tb, tcfg, torch.from_numpy(toks).long(), tc,
                                last_idx=S - 1)
    assert [kind for kind, _, _ in routes] == ["seq"] * tcfg.n_layers
    # at 1.25 a real token's later choice loses its slot to the pads' first ones
    real_drops = sum(int((~keep[:, :S]).sum()) for _, _, keep in routes)
    assert (real_drops > 0) == (tcfg.capacity_factor < 8)

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
