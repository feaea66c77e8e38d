"""Port vs JAX package: the train step on ``reduced()``.  The loss agrees
to 1e-6, every gradient leaf (the supertable slab through the lookup's
backward included) to rtol 1e-5 / atol 1e-6, and three steps of
``make_train_step`` track the JAX params to rtol 1e-4 / atol 1e-6 (the
MLP matmuls sum in another order).  Training on host-translated rows
equals training on raw ids bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import dlrm_criteo as jcfg
from repro.data.synthetic import ClickstreamConfig
from repro.data.synthetic import clickstream_batches
from repro.models import dlrm as jdlrm
from repro.optim import compression as jcomp
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch import optim as toptim
from repro_torch.configs import dlrm_criteo as tcfg
from repro_torch.data.translate import HostTranslator
from repro_torch.models import dlrm as tdlrm
from repro_torch.optim import compression as tcomp
from repro_torch.train import loop as tloop
from repro_torch.tree import tree_leaves, tree_map


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


@pytest.fixture(scope="module")
def setup():
    jc, tc = jcfg.reduced(), tcfg.reduced()
    p, b = jdlrm.init(jax.random.PRNGKey(7), jc)
    p, b = jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, b)
    stream = clickstream_batches(ClickstreamConfig(vocab_sizes=jc.vocab_sizes), 32, start_step=2)
    batches = [{k: v for k, v in next(stream).items() if k != "step"} for _ in range(6)]
    return jc, tc, p, b, batches


def _tbatch(batch, lead=()):
    return {k: torch.from_numpy(np.asarray(v)).reshape(*lead, *np.shape(v))
            for k, v in batch.items()}


def _assert_tree_close(got, want, **tol):
    g, w = jax.tree.leaves(convert.to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def test_bce_loss_matches_jax(setup):
    jc, tc, p, b, batches = setup
    batch = batches[0]
    want = float(jax.jit(lambda p, b, x: jdlrm.bce_loss(p, b, jc, x))(p, b, batch))
    got = tdlrm.bce_loss(convert.to_torch(p, "cpu"), convert.to_torch(b, "cpu"), tc, _tbatch(batch))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=0, atol=1e-6)


def test_bce_loss_stable_at_large_logits():
    lg = torch.tensor([-200.0, -30.0, 0.0, 30.0, 200.0])
    y = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0])
    want = np.asarray(jnp.maximum(jnp.asarray(lg.numpy()), 0) - jnp.asarray(lg.numpy()) * y.numpy()
                      + jnp.log1p(jnp.exp(-jnp.abs(jnp.asarray(lg.numpy())))))
    got = torch.clamp(lg, min=0) - lg * y + torch.log1p(torch.exp(-lg.abs()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert torch.isfinite(got).all()


def test_grads_of_every_leaf_match_jax(setup):
    jc, tc, p, b, batches = setup
    batch = batches[1]
    want = jax.jit(jax.grad(lambda p, b, x: jdlrm.bce_loss(p, b, jc, x)))(p, b, batch)
    tb = convert.to_torch(b, "cpu")
    _, got = tloop.value_and_grad(lambda pp, bb, mb: (tdlrm.bce_loss(pp, bb, tc, mb), {}),
                          convert.to_torch(p, "cpu"), tb, _tbatch(batch))
    slab = got["emb"][0]["tables"]
    assert slab.shape == np.shape(want["emb"][0]["tables"]) and slab.abs().sum() > 0
    _assert_tree_close(got, want, **GRAD_TOL)


def _jax_step(jc, opt, lr_fn, static, accum):
    def loss_fn(pp, bb, mb):
        return jdlrm.bce_loss(pp, bb, jc, mb), {}

    return jax.jit(jloop.make_train_step(loss_fn, opt, lr_fn, static, accum=accum, clip_norm=1.0))


CASES = {
    "sgdm_clip": (lambda m: m.sgd(momentum=0.9), lambda m: (lambda s: 0.05), 1),
    "adamw_cosine": (lambda m: m.adamw(weight_decay=0.01),
                     lambda m: m.cosine_schedule(3e-3, warmup=1, total=3), 1),
    "accum2": (lambda m: m.sgd(momentum=0.9), lambda m: (lambda s: 0.05), 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_train_steps_track_jax(setup, case):
    jc, tc, p, b, batches = setup
    make_opt, make_lr, accum = CASES[case]
    jopt, topt = make_opt(joptim), make_opt(toptim)
    dyn, static = jloop.split_buffers(b)
    jstep = _jax_step(jc, jopt, make_lr(joptim), static, accum)
    tstep = tloop.make_train_step(lambda pp, bb, mb: (tdlrm.bce_loss(pp, bb, tc, mb), {}), topt,
                                  make_lr(toptim), accum=accum, clip_norm=1.0)
    js = jloop.init_state(p, jopt, dyn)
    ts = tloop.init_state(convert.to_torch(p, "cpu"), topt, convert.to_torch(b, "cpu"))
    for i in range(3):
        mb = [batches[(i * accum + a) % len(batches)] for a in range(accum)]
        stacked = {k: np.stack([m[k] for m in mb]) for k in mb[0]}
        js, jm = jstep(js, stacked)
        ts, tm = tstep(ts, _tbatch(stacked))
        for key in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-6)
    assert ts.step == int(js.step) == 3
    _assert_tree_close(ts.params, js.params, **STEP_TOL)
    _assert_tree_close(ts.opt, js.opt, **STEP_TOL)


def test_host_rows_training_equals_raw_ids(setup):
    jc, tc, p, b, batches = setup
    opt = toptim.sgd(momentum=0.9)
    step = tloop.make_train_step(lambda pp, bb, mb: (tdlrm.bce_loss(pp, bb, tc, mb), {}), opt,
                                 lambda s: 0.05)
    tb = convert.to_torch(b, "cpu")
    translator = HostTranslator(tc.collection, tb["emb"])
    raw = tloop.init_state(convert.to_torch(p, "cpu"), opt, tb)
    hosted = tloop.init_state(convert.to_torch(p, "cpu"), opt, tb)
    for batch in batches[:3]:
        raw, m1 = step(raw, _tbatch(batch, lead=(1,)))
        rows = dict(batch, rows=translator.rows(batch["sparse"]))
        del rows["sparse"]
        hosted, m2 = step(hosted, _tbatch(rows, lead=(1,)))
        assert torch.equal(m1["loss"], m2["loss"])
    for x, y in zip(tree_leaves(raw.params) + tree_leaves(raw.opt),
                    tree_leaves(hosted.params) + tree_leaves(hosted.opt)):
        assert torch.equal(x, y)


def test_clip_and_schedule_match_jax():
    rng = np.random.default_rng(0)
    grads = {"a": rng.normal(size=(5, 3)).astype(np.float32), "b": [rng.normal(size=7).astype(np.float32)]}
    for max_norm in (0.1, 1.0, 100.0):
        jg, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), max_norm)
        tg, tn = toptim.clip_by_global_norm(convert.to_torch(grads, "cpu"), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_tree_close(tg, jg, rtol=1e-6, atol=0)
    jl, tl = joptim.cosine_schedule(0.1, 10, 100), toptim.cosine_schedule(0.1, 10, 100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(tl(s)), float(jl(s)), rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_norm", [0.1, 1.0, 100.0])
def test_clip_in_place_equals_clip(dtype, max_norm):
    """``clip_by_global_norm_`` (the step's: the gradients scaled where they
    lie) gives ``clip_by_global_norm``'s norm and values bit for bit."""
    gen = torch.Generator().manual_seed(3)
    grads = {"a": (torch.randn((50, 3), generator=gen) * 4).to(dtype),
             "b": [torch.randn(7, generator=gen), torch.randn((2, 5), generator=gen).to(dtype)]}
    want, wn = toptim.clip_by_global_norm(grads, max_norm)
    copies = tree_map(torch.clone, grads)
    got, gn = toptim.clip_by_global_norm_(copies, max_norm)
    assert got is copies and torch.equal(gn, wn)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_step_owns_the_gradients_it_scales():
    """Autograd hands one tensor to both params of ``a + b`` (and an
    expanded one to a param summed whole): the step copies those before it
    adds, divides and clips in place, so each param's update is its own
    gradient's, accumulated over 2 microbatches and clipped once."""
    params = {"a": torch.full((4,), 2.0), "b": torch.full((4,), 3.0), "c": torch.ones(4)}

    def loss_fn(p, _b, mb):
        return ((p["a"] + p["b"]) * mb["x"]).sum() + 5.0 * p["c"].sum(), {}

    x = torch.stack([torch.arange(4.0), torch.arange(4.0) + 2])[:, None]  # (accum, micro=1, 4)
    step = tloop.make_train_step(loss_fn, toptim.sgd(), lambda s: 0.5, accum=2, clip_norm=1.0)
    state, m = step(tloop.init_state(params, toptim.sgd(), {}), {"x": x})
    g = {"a": x.mean(0)[0], "b": x.mean(0)[0], "c": torch.full((4,), 5.0)}
    gnorm = torch.sqrt(sum((v ** 2).sum() for v in g.values()))
    torch.testing.assert_close(m["gnorm"], gnorm)
    for key, start in (("a", 2.0), ("b", 3.0), ("c", 1.0)):
        torch.testing.assert_close(state.params[key], start - 0.5 * g[key] / gnorm)


def test_int8_compression_matches_jax():
    rng = np.random.default_rng(1)
    grads = {"w": rng.normal(size=(40, 8)).astype(np.float32), "b": rng.normal(size=8).astype(np.float32)}
    err = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32) for k, v in grads.items()}
    jg, je = jcomp.compressed_grad_transform(jax.tree.map(jnp.asarray, grads),
                                             jax.tree.map(jnp.asarray, err))
    tg, te = tcomp.compressed_grad_transform(convert.to_torch(grads, "cpu"),
                                             convert.to_torch(err, "cpu"))
    for k in grads:
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
        np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]), rtol=0, atol=1e-7)


def test_compressed_step_keeps_error_feedback(setup):
    jc, tc, p, b, batches = setup
    opt = toptim.sgd()
    step = tloop.make_train_step(lambda pp, bb, mb: (tdlrm.bce_loss(pp, bb, tc, mb), {}), opt,
                                 lambda s: 0.05, compress_grads=True)
    s = tloop.init_state(convert.to_torch(p, "cpu"), opt, convert.to_torch(b, "cpu"),
                         compress_grads=True)
    assert all(not e.any() for e in tree_leaves(s.err))
    s, m = step(s, _tbatch(batches[0], lead=(1,)))
    assert torch.isfinite(m["loss"]) and any(e.abs().sum() > 0 for e in tree_leaves(s.err))


def test_train_state_carries_across(setup):
    """A JAX TrainState (adamw moments, step counter, error feedback)
    converts whole, and the port's step runs on from it."""
    jc, tc, p, b, batches = setup
    jopt = joptim.adamw()
    dyn, static = jloop.split_buffers(b)
    jstep = jax.jit(jloop.make_train_step(lambda pp, bb, mb: (jdlrm.bce_loss(pp, bb, jc, mb), {}),
                                          jopt, lambda s: 1e-3, static, compress_grads=True))
    js, _ = jstep(jloop.init_state(p, jopt, dyn, compress_grads=True), {k: v[None] for k, v in batches[0].items()})
    ts = convert.train_state_to_torch(js, "cpu")
    assert isinstance(ts, tloop.TrainState) and ts.step == 1
    assert ts.opt["t"].dtype == torch.int32 and int(ts.opt["t"]) == 1
    _assert_tree_close(ts.params, js.params, rtol=0, atol=0)
    _assert_tree_close(ts.opt, js.opt, rtol=0, atol=0)
    _assert_tree_close(ts.err, js.err, rtol=0, atol=0)
    tstep = tloop.make_train_step(lambda pp, bb, mb: (tdlrm.bce_loss(pp, bb, tc, mb), {}),
                                  toptim.adamw(), lambda s: 1e-3, compress_grads=True)
    ts, tm = tstep(ts, _tbatch({k: v[None] for k, v in batches[1].items()}))
    assert ts.step == 2 and int(ts.opt["t"]) == 2 and torch.isfinite(tm["loss"])


# --- the comparison methods on reduced() ------------------------------------------

METHODS = ("full", "hash", "hemb", "ce", "robe", "dhe", "tt")


@pytest.fixture(scope="module", params=METHODS)
def method_setup(request):
    """``reduced(emb_method=m)`` on both sides (the JAX side on its jnp
    lookup path), one state (the port's init: its buffers equal JAX's, see
    test_torch_collection.py; its params carried to numpy) and 4 batches.
    ``jb`` holds the buffers as JAX arrays and python ints, closed over as
    JAX's train step holds its static leaves."""
    import dataclasses

    m = request.param
    jc = dataclasses.replace(jcfg.reduced(emb_method=m), emb_use_kernel=False)
    tc = tcfg.reduced(emb_method=m)
    pt, bt = tdlrm.init(tc, torch.Generator().manual_seed(11), device="cpu")
    p, b = convert.to_numpy(pt), convert.to_numpy(bt)
    jb = jax.tree.map(lambda x: jnp.asarray(x) if hasattr(x, "shape") else x, b)
    stream = clickstream_batches(ClickstreamConfig(vocab_sizes=jc.vocab_sizes), 32, start_step=5)
    batches = [{k: v for k, v in next(stream).items() if k != "step"} for _ in range(4)]
    return m, jc, tc, p, b, jb, batches


def test_method_forward_and_loss_match_jax(method_setup):
    _, jc, tc, p, b, jb, batches = method_setup
    batch = batches[0]
    fwd, loss = jax.jit(lambda pp, x: (jdlrm.forward(pp, jb, jc, x),
                                       jdlrm.bce_loss(pp, jb, jc, x)))(p, batch)
    tp, tb = convert.to_torch(p, "cpu"), convert.to_torch(b, "cpu")
    np.testing.assert_allclose(tdlrm.forward(tp, tb, tc, _tbatch(batch)).detach().numpy(),
                               np.asarray(fwd), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tdlrm.bce_loss(tp, tb, tc, _tbatch(batch))), float(loss),
                               rtol=0, atol=1e-6)


def test_method_grads_of_every_leaf_match_jax(method_setup):
    _, jc, tc, p, b, jb, batches = method_setup
    batch = batches[1]
    want = jax.jit(jax.grad(lambda pp, x: jdlrm.bce_loss(pp, jb, jc, x)))(p, batch)
    _, got = tloop.value_and_grad(lambda pp, bb, mb: (tdlrm.bce_loss(pp, bb, tc, mb), {}),
                                  convert.to_torch(p, "cpu"), convert.to_torch(b, "cpu"),
                                  _tbatch(batch))
    assert all(g.abs().sum() > 0 for g in tree_leaves(got["emb"]))
    _assert_tree_close(got, want, **GRAD_TOL)


def test_method_three_train_steps_track_jax(method_setup):
    """sgd momentum 0.9, lr 0.05, clip 1.0: the JAX step jitted with the
    python-int buffer leaves static (``split_buffers``)."""
    _, jc, tc, p, b, jb, batches = method_setup
    opt_j, opt_t = joptim.sgd(momentum=0.9), toptim.sgd(momentum=0.9)
    dyn, static = jloop.split_buffers(jb)
    jstep = _jax_step(jc, opt_j, lambda s: 0.05, static, 1)
    tstep = tloop.make_train_step(lambda pp, bb, mb: (tdlrm.bce_loss(pp, bb, tc, mb), {}), opt_t,
                                  lambda s: 0.05, clip_norm=1.0)
    js = jloop.init_state(p, opt_j, dyn)
    ts = tloop.init_state(convert.to_torch(p, "cpu"), opt_t, convert.to_torch(b, "cpu"))
    for i in range(3):
        batch = {k: v[None] for k, v in batches[i].items()}
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, _tbatch(batch))
        for key in ("loss", "gnorm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-6)
    _assert_tree_close(ts.params, js.params, **STEP_TOL)
    _assert_tree_close(ts.opt, js.opt, **STEP_TOL)
