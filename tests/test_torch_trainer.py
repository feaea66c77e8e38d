"""Port vs JAX package: the ``Trainer`` on ``reduced()`` with the sketch
tracker (async fold), the in-step cell counter, the entropy/drift
trigger, telemetry and checkpoints.

* 12 steps with one periodic transition track JAX's Trainer from the same
  weights, with JAX's kmeans++ seeds handed to the port (its float draws
  are not JAX's; ``test_torch_transition.py`` does the same): every
  step's loss within 1e-5 relative, and ptr/hs/epoch, the tracker's
  state, the trigger's state and events and ``clusters_done`` equal.
* JAX's checkpoint of that run resumes in the port Trainer.
* A port crash and resume equals an uninterrupted run bit for bit.
* ``StragglerMonitor`` / ``FailureInjector`` twins, and the port twin of
  ``test_system.py::test_cce_with_clustering_beats_without``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import dlrm_criteo as jcfg
from repro.core import kmeans as jkm
from repro.data.synthetic import ClickstreamConfig, clickstream_batches
from repro.models import dlrm as jdlrm
from repro.obs import TelemetryConfig as JTelemetry
from repro.stream import ClusterTrigger as JTrigger
from repro.stream import make_step_cell_counter as jcounter
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import dlrm_criteo as tcfg
from repro_torch.core import kmeans as tkm
from repro_torch.launch import train as tlaunch
from repro_torch.models import dlrm as tdlrm
from repro_torch.obs.telemetry import TelemetryConfig
from repro_torch.optim import sgd
from repro_torch.stream.device import make_step_cell_counter
from repro_torch.stream.trigger import ClusterTrigger
from repro_torch.train import loop as tloop
from repro_torch.tree import jax_leaves

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STEPS = 12
CLUSTER_EVERY = 6
SEED = 3
LOSS_RTOL = 1e-5
TRIGGER = dict(entropy_drop=0.1, drift_threshold=0.25, warmup=1)


def _jax_seeds(key, x, k, weights=None):
    """The JAX package's kmeans++ on the port's (bit-identical) inputs."""
    return torch.from_numpy(np.array(jkm.kmeans_plus_plus(
        jnp.asarray(np.asarray(key, np.uint32)), jnp.asarray(x.numpy()), k,
        None if weights is None else jnp.asarray(weights.numpy()))))


def _data(cfg, start=0):
    return clickstream_batches(ClickstreamConfig(vocab_sizes=cfg.vocab_sizes, seed=SEED), 32,
                               start_step=start)


def _port_trainer(tc, p, b, ckpt_dir=None, *, failures=None, ckpt_every=4, start=0):
    tracker = tdlrm.make_id_tracker(tc, tcfg.reduced_stream(window=4, async_fold=True),
                                    device="cpu")
    opt = sgd(momentum=0.9)

    def loss_fn(pp, bb, mb):
        return tdlrm.bce_loss(pp, bb, tc, mb), {}

    def cluster_fn(key, pp, bb, o):
        return tdlrm.cluster_tables(key, pp, bb, tc, o, id_counts=tracker.counts)

    step = tloop.make_train_step(loss_fn, opt, lambda s: 0.05,
                                 sketch_fn=make_step_cell_counter(tracker),
                                 telemetry=TelemetryConfig())
    return tloop.Trainer(
        step, tloop.init_state(p, opt, b), _data(tc, start), ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every, cluster_fn=cluster_fn, cluster_every=CLUSTER_EVERY,
        cluster_max=1, id_tracker=tracker, trigger=ClusterTrigger(**TRIGGER),
        failures=failures, seed=SEED)


def _init(tc, seed=7):
    return tdlrm.init(tc, torch.Generator().manual_seed(seed), device="cpu")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """One JAX Trainer run and one port Trainer run from the same weights."""
    jc, tc = jcfg.reduced(), tcfg.reduced()
    tp, tb = _init(tc)
    p_np, b_np = convert.to_numpy(tp), convert.to_numpy(tb)

    jtracker = jdlrm.make_id_tracker(jc, jcfg.reduced_stream(window=4, async_fold=True))
    dyn, static = jloop.split_buffers(jax.tree.map(jnp.asarray, b_np))
    jopt = joptim.sgd(momentum=0.9)

    def jloss(pp, bb, mb):
        return jdlrm.bce_loss(pp, bb, jc, mb), {}

    def jcluster(key, pp, bb, o):
        return jdlrm.cluster_tables(key, pp, bb, jc, o, id_counts=jtracker.counts)

    jstep = jloop.make_train_step(jloss, jopt, lambda s: jnp.float32(0.05), static,
                                  sketch_fn=jcounter(jtracker), telemetry=JTelemetry())
    jdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    jtr = jloop.Trainer(
        jax.jit(jstep, donate_argnums=(0,)),
        jloop.init_state(jax.tree.map(jnp.asarray, p_np), jopt, dyn), static, _data(jc),
        ckpt_dir=jdir, ckpt_every=4, cluster_fn=jcluster, cluster_every=CLUSTER_EVERY,
        cluster_max=1, id_tracker=jtracker, trigger=JTrigger(**TRIGGER), seed=SEED)
    jtr.run(STEPS)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tkm, "kmeans_plus_plus", _jax_seeds)
        ttr = _port_trainer(tc, tp, tb)
        ttr.run(STEPS)
    return dict(jc=jc, tc=tc, jtr=jtr, ttr=ttr, jdir=jdir)


def test_losses_track_jax(both):
    jh, th = list(both["jtr"].history), list(both["ttr"].history)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(range(STEPS))
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh],
                               rtol=LOSS_RTOL)
    for a, b in zip(th, jh):  # telemetry rides the records as in JAX
        np.testing.assert_array_equal(a["telemetry"]["grad_nonfinite"],
                                      b["telemetry"]["grad_nonfinite"])


def test_buffers_tracker_and_trigger_equal_jax(both):
    jtr, ttr = both["jtr"], both["ttr"]
    assert ttr.clusters_done == jtr.clusters_done == 1
    assert ttr.state.step == int(jtr.state.step) == STEPS
    got = jax_leaves(convert.to_numpy(ttr.state.ebuf))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jtr.state.ebuf))
    assert len(got) == len(want)
    for a, b in zip(got, want):  # ptr, hs (uint32), epoch
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert all(int(f["epoch"]) == 1 for g in ttr.state.ebuf["emb"] for f in g)
    for a, b in zip(ttr.id_tracker.state_tree(), jtr.id_tracker.state_tree()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(ttr.trigger.state_tree(), jtr.trigger.state_tree()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert [e.as_dict() for e in ttr.trigger.events] == [e.as_dict() for e in jtr.trigger.events]
    assert len(ttr.trigger.events) == STEPS // 4


def test_jax_checkpoint_resumes_in_port(both):
    """The port Trainer restores JAX's last checkpoint (step 12), every
    leaf equal, and trains on."""
    jtr, tc = both["jtr"], both["tc"]
    tr = _port_trainer(tc, *_init(tc, seed=11), both["jdir"], start=STEPS)
    assert tr.restore_latest() == STEPS
    assert tr.state.step == STEPS and tr.clusters_done == 1
    for got, want in ((tr.state.params, jtr.state.params), (tr.state.opt, jtr.state.opt),
                      (tr.state.ebuf, jtr.state.ebuf)):
        g = jax_leaves(convert.to_numpy(got))
        w = jax.tree.leaves(jax.tree.map(np.asarray, want))
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tr.id_tracker.state_tree(), jtr.id_tracker.state_tree()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tr.ckpt = None  # train on without writing into JAX's directory
    hist = tr.run(2)
    assert [h["step"] for h in hist] == [STEPS, STEPS + 1]
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_port_crash_and_resume_is_bit_exact(tmp_path):
    """A crash at step 9 (after the transition at 6), in-process restore
    from the checkpoint at 8 and a replay to 12 end bit for bit where an
    uninterrupted run ends: params, moments, buffers, tracker, trigger,
    clusters_done and every step's loss."""
    tc = tcfg.reduced()
    clean = _port_trainer(tc, *_init(tc), str(tmp_path / "a"))
    clean.run(STEPS)
    tr = _port_trainer(tc, *_init(tc), str(tmp_path / "b"),
                       failures=tloop.FailureInjector((9,)))
    restored = tlaunch.run_with_restart(tr, STEPS, lambda s: _data(tc, s))
    assert restored == [8]
    for got, want in ((tr.state.params, clean.state.params), (tr.state.opt, clean.state.opt),
                      (tr.state.ebuf, clean.state.ebuf)):
        assert all(torch.equal(a, b) for a, b in zip(jax_leaves(got), jax_leaves(want)))
    for a, b in zip(tr.id_tracker.state_tree() + tr.trigger.state_tree(),
                    clean.id_tracker.state_tree() + clean.trigger.state_tree()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tr.clusters_done == clean.clusters_done == 1
    clean_loss = {h["step"]: h["loss"] for h in clean.history}
    assert sorted({h["step"] for h in tr.history}) == list(range(STEPS))
    assert all(h["loss"] == clean_loss[h["step"]] for h in tr.history)  # replays too
    assert [e.as_dict() for e in tr.trigger.events] == [
        e.as_dict() for e in clean.trigger.events]


def test_straggler_monitor_twin():
    rng = np.random.default_rng(0)
    dts = list(rng.uniform(0.01, 0.012, 30))
    dts[12] = dts[20] = 0.5  # two injected stragglers
    got, want = tloop.StragglerMonitor(), jloop.StragglerMonitor()
    flags = [(got.observe(i, dt), want.observe(i, dt)) for i, dt in enumerate(dts)]
    assert all(a == b for a, b in flags)
    assert got.flagged == want.flagged == [(12, 0.5), (20, 0.5)]
    assert got.mean == want.mean and got.var == want.var


def test_failure_injector_twin():
    got, want = tloop.FailureInjector((2, 5)), jloop.FailureInjector((2, 5))
    for inj in (got, want):
        inj.maybe_fail(1)
        with pytest.raises(RuntimeError, match="injected failure at step 2"):
            inj.maybe_fail(2)
        inj.maybe_fail(2)  # once each
    assert got.fired == want.fired == {2}
    with pytest.raises(tloop.InjectedFailure):
        got.maybe_fail(5)


def test_cluster_fn_arity_detection_twin():
    def legacy(key, p, b):
        return p, b

    def with_opt(key, p, b, opt):
        return p, b, opt

    def extras(key, p, b, verbose=False):
        return p, b

    def kw_only(key, p, b, *, opt=None):
        return p, b

    for fn in (legacy, with_opt, extras, kw_only):
        assert tloop._cluster_fn_takes_opt(fn) == jloop._cluster_fn_takes_opt(fn)
    assert tloop._cluster_fn_takes_opt(with_opt) and not tloop._cluster_fn_takes_opt(extras)


def _train_bce(cluster_every: int, seed: int, steps: int = 120, cap: int = 256) -> float:
    """The port run of ``test_system.py::_train``: sketch tracker (no
    windows), sgd momentum 0.9 at lr 0.05, batch 64, up to 3 transitions,
    then the BCE of a held-out batch of 512."""
    cfg = tcfg.reduced(emb_method="cce", cap=cap)
    p, b = tdlrm.init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    opt = sgd(momentum=0.9)

    def loss_fn(pp, bb, mb):
        return tdlrm.bce_loss(pp, bb, cfg, mb), {}

    tracker = cluster_fn = None
    if cluster_every:
        tracker = tdlrm.make_id_tracker(cfg, tcfg.reduced_stream(window=0), device="cpu")

        def cluster_fn(key, pp, bb, o):
            return tdlrm.cluster_tables(key, pp, bb, cfg, o, id_counts=tracker.counts)

    data_cfg = ClickstreamConfig(vocab_sizes=cfg.vocab_sizes, seed=seed)
    tr = tloop.Trainer(tloop.make_train_step(loss_fn, opt, lambda s: 0.05),
                       tloop.init_state(p, opt, b), clickstream_batches(data_cfg, 64),
                       cluster_fn=cluster_fn, cluster_every=cluster_every, cluster_max=3,
                       id_tracker=tracker, seed=seed)
    tr.run(steps)
    test = next(clickstream_batches(data_cfg, 512, host_id=1, n_hosts=2))
    with torch.no_grad():
        return float(tdlrm.bce_loss(tr.state.params, tr.state.ebuf, cfg,
                                    {k: torch.from_numpy(v) for k, v in test.items()
                                     if k != "step"}))


@pytest.mark.slow
def test_cce_with_clustering_beats_without():
    """The paper's core mechanism in the port: interleaved clustering
    (the sketch tracker's counts feeding each transition) helps."""
    seeds = [0, 1]
    with_c = np.mean([_train_bce(30, s) for s in seeds])
    without = np.mean([_train_bce(0, s) for s in seeds])
    assert with_c <= without + 0.005, (with_c, without)
