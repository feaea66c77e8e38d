"""Port vs JAX package: observability (``obs/``).

In-step telemetry equals JAX's ``telemetry_metrics`` on the same grads,
params and batch (counts exactly, norms within 1e-6 relative: float32
sums in another order) and its labels equal JAX's ``telemetry_labels``;
the train step's telemetry and sketch hooks leave its math bit for bit as
it was; the pump drains ``lag`` steps late and completely on ``flush``;
``default_manifest`` has JAX's keys; ``ProfileWindow`` steps through its
states and writes a Chrome trace; and ``summarize`` of a port run log
(from the CLI launcher, crash and resume included) equals JAX's
``summarize_dict`` of it."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import runlog as jrunlog
from repro.obs import summary as jsummary
from repro.obs import telemetry as jtel
from repro_torch import convert
from repro_torch.configs import dlrm_criteo as tcfg
from repro_torch.data.synthetic import ClickstreamConfig, clickstream_batches
from repro_torch.launch import train as tlaunch
from repro_torch.models import dlrm as tdlrm
from repro_torch.obs import runlog as trunlog
from repro_torch.obs import summary as tsummary
from repro_torch.obs import telemetry as ttel
from repro_torch.obs.pump import MetricsPump
from repro_torch.obs.trace import ProfileWindow, span
from repro_torch.optim import sgd
from repro_torch.stream.device import make_step_cell_counter
from repro_torch.train import loop as tloop
from repro_torch.tree import jax_leaves, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(seed=0):
    cfg = tcfg.reduced()
    p, b = tdlrm.init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    stream = clickstream_batches(ClickstreamConfig(vocab_sizes=cfg.vocab_sizes, seed=seed), 32)
    batches = [{k: torch.from_numpy(v[None]) for k, v in next(stream).items() if k != "step"}
               for _ in range(2)]
    return cfg, p, b, batches


def _loss(cfg):
    def loss_fn(pp, bb, mb):
        return tdlrm.bce_loss(pp, bb, cfg, mb), {}
    return loss_fn


@pytest.mark.parametrize("poison", [False, True])
def test_telemetry_equals_jax(poison):
    cfg, p, b, batches = _setup()
    if poison:  # one NaN in the supertable: counts light up its leaf
        p["emb"][0]["tables"][0, 0, 0, 0] = float("nan")
    _, grads = tloop.value_and_grad(_loss(cfg), p, b, tree_map(lambda x: x[0], batches[0]))
    batch = dict(batches[0], rows=torch.randint(-1, 5, (1, 32, 3, 2),
                                                generator=torch.Generator().manual_seed(1)))
    tc = ttel.TelemetryConfig()
    got = ttel.telemetry_metrics(tc, grads, p, batch)
    want = jtel.telemetry_metrics(jtel.TelemetryConfig(), convert.to_numpy(grads),
                                  convert.to_numpy(p),
                                  {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for k in ("grad_nonfinite", "param_nonfinite"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("emb_grad_norm", "emb_param_norm", "rows_occupancy"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
    labels = ttel.telemetry_labels(p)
    assert labels == jtel.telemetry_labels(convert.to_numpy(p))
    if poison:
        target = labels["leaves"].index("['emb'][0]['tables']")
        assert got["param_nonfinite"][target] == 1 and int(got["param_nonfinite"].sum()) == 1


def test_step_hooks_leave_the_math_untouched():
    """With telemetry and the sketch counter (accum 2: the delta is the
    sum over microbatches) the step's loss and params equal the plain
    step's bit for bit."""
    cfg, p, b, batches = _setup()
    batch = {k: torch.cat([x[k] for x in batches]) for k in batches[0]}  # (2, 32, ...)
    tracker = tdlrm.make_id_tracker(cfg, tcfg.reduced_stream(), device="cpu")
    opt = sgd(momentum=0.9)
    plain = tloop.make_train_step(_loss(cfg), opt, lambda s: 0.05, accum=2)
    hooked = tloop.make_train_step(_loss(cfg), opt, lambda s: 0.05, accum=2,
                                   sketch_fn=make_step_cell_counter(tracker),
                                   telemetry=ttel.TelemetryConfig())
    s0, m0 = plain(tloop.init_state(tree_map(torch.clone, p), opt, b), batch)
    s1, m1 = hooked(tloop.init_state(tree_map(torch.clone, p), opt, b), batch)
    assert torch.equal(m0["loss"], m1["loss"])
    assert all(torch.equal(x, y) for x, y in zip(jax_leaves(s0.params), jax_leaves(s1.params)))
    counter = make_step_cell_counter(tracker)
    want = counter({"sparse": batch["sparse"][0]}) + counter({"sparse": batch["sparse"][1]})
    assert torch.equal(m1["sketch_delta"], want)
    assert int(m1["sketch_delta"].sum()) == 2 * 32 * len(tracker.tracked) * 4
    assert set(m1["telemetry"]) == {"emb_grad_norm", "emb_param_norm", "grad_nonfinite",
                                    "param_nonfinite"}
    assert "sketch_delta" not in m0 and "telemetry" not in m0


def test_pump_lag_and_flush():
    drained = []
    pump = MetricsPump(lag=3, sink=drained.append)
    for s in range(5):
        pump.push(s, {"loss": torch.tensor(float(s)),
                      "telemetry": {"v": torch.arange(3, dtype=torch.int32) + s}})
    assert len(drained) == 2 and len(pump) == 3  # 5 pushed, lag 3
    pump.flush()
    assert [r["step"] for r in drained] == [0, 1, 2, 3, 4]
    assert [r["loss"] for r in drained] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert all(isinstance(r["loss"], float) for r in drained)
    np.testing.assert_array_equal(drained[4]["telemetry"]["v"], [4, 5, 6])
    assert len(pump.history) == 5 and len(pump) == 0


def test_pump_history_is_bounded():
    pump = MetricsPump(lag=0, maxlen=4)
    for s in range(10):
        pump.push(s, {"loss": torch.tensor(1.0)}, extra={"dt": 0.5})
    assert [r["step"] for r in pump.history] == [6, 7, 8, 9]
    assert pump.history[-1]["dt"] == 0.5


def test_default_manifest_has_the_jax_keys():
    got = trunlog.default_manifest("dlrm", a=1)
    want = jrunlog.default_manifest("dlrm", a=1)
    assert list(got) == list(want)
    assert got["backend"] in ("cpu", "cuda") and got["n_devices"] >= 1 and got["a"] == 1


def test_profile_window_state_machine(tmp_path):
    pw = ProfileWindow(1, 3, log_dir=str(tmp_path / "prof"))
    pw.observe(0)
    assert not pw.active
    pw.observe(1)
    assert pw.active
    with span("work"):
        torch.square(torch.arange(8.0))
    pw.observe(2)
    assert pw.active
    pw.observe(3)
    assert not pw.active and pw.done
    pw.observe(1)  # one window per run: never re-arms
    assert not pw.active
    pw.close()  # idempotent after done
    trace = json.load(open(pw.path))
    assert any(e.get("name") == "work" for e in trace["traceEvents"])
    with pytest.raises(ValueError):
        ProfileWindow(3, 3, log_dir=str(tmp_path))


def test_summarize_port_run_log_equals_jax(tmp_path):
    log = tmp_path / "run.jsonl"
    tlaunch.main(["--device", "cpu", "--steps", "12", "--cluster-every", "6",
                  "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "4", "--fail-at", "10",
                  "--window", "4", "--trigger", "--obs", str(log)])
    recs = trunlog.read_runlog(log)
    got, want = tsummary.summarize_dict(recs), jsummary.summarize_dict(recs)
    assert got == want
    assert got["steps"]["n"] == 12 and got["steps"]["contiguous"]
    assert got["faults"] == [10] and got["checkpoints"]["restored"] == [8]
    assert got["transitions"] == [{"step": 6, "reason": "periodic"},
                                  {"step": 12, "reason": "periodic"}]
    assert got["triggers"]["n"] == 3  # one evaluation a closed window, no replays
    assert tsummary.format_summary(recs) == jsummary.format_summary(recs)
    assert recs[0]["backend"] == "cpu" and recs[0]["config"] == "dlrm"
    step_recs = [r for r in recs if r["event"] == "step"]
    assert len(step_recs[0]["telemetry"]["grad_nonfinite"]) == len(
        ttel.telemetry_labels(tdlrm.init(tcfg.reduced(), torch.Generator(), "cpu")[0])["leaves"])
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs", "summarize", str(log),
                          "--json", str(tmp_path / "s.json")], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "fault injected: step 10" in out.stdout
    assert json.load(open(tmp_path / "s.json")) == json.loads(json.dumps(want))
