"""The training loop: the port of the JAX package's ``train/loop.py``.

Pieces:
  * ``make_train_step`` — the step as a plain function of (state, batch):
    microbatch gradient accumulation (grads summed in float32, then
    divided by ``accum``), optional int8 gradient compression with error
    feedback, global-norm clipping and the optimizer update.  The JAX step
    is jitted and donates its state; this one runs eagerly and updates
    params and moments in place (``Optimizer.update``).  Its ``sketch_fn``
    hook counts the tracker's sketch cells in the step and its
    ``telemetry`` hook computes health metrics from the averaged pre-clip
    grads, both as tensors left on the device.
  * ``Trainer`` — host-side orchestration: data feed, the CCE clustering
    callback every ``cluster_every`` steps or when the trigger fires (the
    paper's Algorithm 3 line 10 interleaving), async checkpointing,
    straggler monitor, failure injection for fault-tolerance tests,
    restart-exact resume.

The JAX package's ``split_buffers``/``merge_buffers`` exist only to keep
static python leaves out of ``jit``; an eager step takes the buffers
whole, so ``TrainState.ebuf`` holds all of them (the DLRM buffers have no
static leaves, so its checkpoints have the JAX package's layout).
``state_shardings`` and ``reshard_restore`` wait for the sharded port.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import os
import time
import warnings
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.checkpoint import CheckpointManager, list_checkpoints, load_checkpoint
from repro_torch.obs.pump import MetricsPump
from repro_torch.obs.trace import ProfileWindow, span
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.optim.compression import compressed_grad_transform, init_error_feedback
from repro_torch.tree import jax_leaves, tree_leaves, tree_map

Pytree = Any

# the metrics pump's lag (steps between a push and its host read) and the
# most step records ``Trainer.history`` keeps
PUMP_LAG = 8
HISTORY_MAX = 10_000


class TrainState(NamedTuple):
    params: Pytree
    opt: Pytree
    ebuf: Pytree  # the embedding buffers (ptr, hs, epoch per feature)
    step: int  # a host counter (an int32 array in the JAX package)
    err: Pytree | None = None  # int8-compression error feedback


def init_state(params, optimizer: Optimizer, buffers, *, compress_grads: bool = False):
    return TrainState(
        params=params,
        opt=optimizer.init(params),
        ebuf=buffers,
        step=0,
        err=init_error_feedback(params) if compress_grads else None,
    )


def value_and_grad(loss_fn, params, buffers, mb):
    """(loss, d loss / d params) of ``loss_fn(params, buffers, mb)``, with
    the params as fresh autograd leaves that share the state's storage (the
    state itself never requires grad)."""
    leaves = tree_leaves(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(req)
    loss, _metrics = loss_fn(tree_map(lambda _: next(it), params), buffers, mb)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(req, grads)]
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(
    loss_fn: Callable[[Pytree, Pytree, Pytree], tuple[torch.Tensor, dict]],
    optimizer: Optimizer,
    lr_fn: Callable[[int], Any],
    *,
    accum: int = 1,
    clip_norm: float = 1.0,
    compress_grads: bool = False,
    sketch_fn: Callable[[Pytree], torch.Tensor] | None = None,
    telemetry=None,
):
    """loss_fn(params, buffers, microbatch) -> (loss, metrics dict).

    The returned ``train_step(state, batch) -> (state, metrics)`` expects
    batch leaves shaped (accum, micro, ...); ``metrics`` holds ``loss``,
    ``gnorm`` and ``lr`` as 0-d float32 tensors.  The state's params and
    moments are updated in place.

    ``sketch_fn(microbatch) -> (F, depth, width) int32`` (see
    ``stream.device.make_step_cell_counter``) counts the frequency
    tracker's sketch cells in the step; the deltas are summed over the
    microbatches and returned as ``metrics["sketch_delta"]`` (the Trainer
    hands it to ``tracker.observe(batch, delta=...)``).  ``telemetry`` (an
    ``obs.telemetry.TelemetryConfig``) adds ``metrics["telemetry"]``,
    computed from the averaged grads before compression and clipping.
    Neither reads a value back to the host."""

    def train_step(state: TrainState, batch: Pytree):
        params = state.params
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)
        loss_sum = 0.0
        delta = None
        for a in range(accum):
            mb = tree_map(lambda x: x[a], batch)
            loss, grads = value_and_grad(loss_fn, params, state.ebuf, mb)
            gsum = tree_map(lambda s, g: s + g.to(s.dtype), gsum, grads)
            loss_sum = loss_sum + loss.to(torch.float32)
            if sketch_fn is not None:
                d = sketch_fn(mb)
                delta = d if delta is None else delta + d
        grads = tree_map(lambda g: g / accum, gsum)
        loss = loss_sum / accum

        health = None
        if telemetry is not None:
            from repro_torch.obs.telemetry import telemetry_metrics

            # the averaged gradient, before compression and clipping rewrite it
            with span("telemetry"):
                health = telemetry_metrics(telemetry, grads, params, batch)

        err = state.err
        if compress_grads:
            grads, err = compressed_grad_transform(grads, err)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        # a 0-d CPU tensor: it scales CUDA tensors without a copy
        lr = torch.as_tensor(lr_fn(state.step), dtype=torch.float32)
        new_params, new_opt = optimizer.update(grads, state.opt, params, lr)
        new_state = TrainState(params=new_params, opt=new_opt, ebuf=state.ebuf,
                               step=state.step + 1, err=err)
        metrics = {"loss": loss, "gnorm": gnorm, "lr": lr}
        if delta is not None:
            metrics["sketch_delta"] = delta
        if health is not None:
            metrics["telemetry"] = health
        return new_state, metrics

    return train_step


# --- host-side orchestration ----------------------------------------------------


class StragglerMonitor:
    """EMA step-time tracker; flags steps slower than mean + k·std.

    ``Trainer.run`` feeds it DISPATCH-TO-DISPATCH wall time (the step is
    never synchronised): once the device queue applies backpressure the
    interval converges to true per-step throughput.  The ``warmup``
    window absorbs the early, shorter intervals."""

    def __init__(self, alpha: float = 0.1, k: float = 4.0, warmup: int = 5):
        self.alpha, self.k, self.warmup = alpha, k, warmup
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            if self.n == 1:
                self.mean = dt
            elif self.n == 2:
                self.mean = (self.mean + dt) / 2
            else:
                self.mean = self.mean + self.alpha * (dt - self.mean)
            self.var = max(self.var, (dt - self.mean) ** 2)
            return False
        is_straggler = dt > self.mean + self.k * max(self.var, 1e-12) ** 0.5
        if is_straggler:
            self.flagged.append((step, dt))
        else:  # stragglers don't poison the EMA
            d = dt - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler


class InjectedFailure(RuntimeError):
    """The fault ``FailureInjector`` raises."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministic fault injection for restart tests: raises
    ``InjectedFailure`` (a RuntimeError) at the given steps (once each)."""

    at_steps: tuple[int, ...] = ()
    fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


def _cluster_fn_takes_opt(fn) -> bool:
    """The transition callback comes in two arities:
    ``(key, params, buffers)`` (legacy) and
    ``(key, params, buffers, opt) -> (params, buffers, opt)``, which carries
    the per-row optimizer moments through the new assignments.  An explicit
    ``fn.cluster_takes_opt`` attribute wins; otherwise the 4-arg form needs
    a positional parameter named ``opt``, or four REQUIRED positional
    parameters."""
    explicit = getattr(fn, "cluster_takes_opt", None)
    if explicit is not None:
        return bool(explicit)
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    ps = [p for p in sig.parameters.values()
          if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    if any(p.name == "opt" for p in ps):
        return True
    return len([p for p in ps if p.default is p.empty]) >= 4


class Trainer:
    """data -> step -> [cluster] -> [checkpoint], restart-exact.

    ``cluster_fn`` is the CCE transition (Alg. 3); it runs between steps
    every ``cluster_every`` steps or when ``trigger`` fires on a closed
    tracker window (``cluster_max`` caps their union), with the key
    ``fold_in(PRNGKey(seed), step)``.  The 4-arg form also receives and
    returns the optimizer state.  ``clusters_done``, the tracker's and the
    trigger's state ride the checkpoint with the TrainState, so a resume
    replays the schedule exactly.

    Batches come from ``data_iter`` as numpy dicts; each is reshaped to
    (accum, micro, ...) and copied to the state's device through pinned
    memory without a sync.  Metrics leave the device through the pump
    (``PUMP_LAG`` steps late); ``history`` is exact after ``run`` returns."""

    def __init__(
        self,
        train_step,
        state: TrainState,
        data_iter,
        *,
        ckpt_dir: str | None = None,
        ckpt_every: int = 0,
        keep_last: int = 3,
        cluster_fn=None,
        cluster_every: int = 0,
        cluster_max: int = 0,
        id_tracker=None,
        trigger=None,
        translator=None,
        accum: int = 1,
        failures: FailureInjector | None = None,
        seed: int = 0,
        runlog=None,
        profile_steps: tuple[int, int] | None = None,
        profile_dir: str | None = None,
    ):
        self.train_step = train_step
        self.state = state
        self.data_iter = data_iter
        self.device = tree_leaves(state.params)[0].device
        self.ckpt = CheckpointManager(ckpt_dir, keep_last) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.cluster_fn = cluster_fn
        self._cluster_takes_opt = cluster_fn is not None and _cluster_fn_takes_opt(cluster_fn)
        self.cluster_every = cluster_every
        self.cluster_max = cluster_max
        self.id_tracker = id_tracker  # feeds the transition's k-means sample
        # adaptive schedule: a ClusterTrigger evaluated on every closed
        # tracker window, firing the same transition the periodic schedule
        # does; needs a windowed tracker (poll_window)
        self.trigger = trigger
        if trigger is not None:
            windowed = getattr(id_tracker, "poll_window", None) is not None
            window = getattr(getattr(id_tracker, "config", None), "window", None)
            if not windowed or window == 0:
                warnings.warn(
                    "Trainer(trigger=...) needs a windowed tracker "
                    "(SketchFrequencyTracker with StreamConfig(window>0)); "
                    "the adaptive schedule will never evaluate"
                )
        # a host-translating pipeline (data.translate.HostTranslator around
        # data_iter) mirrors the pointer buffers: re-synced after every
        # transition and every restore
        self.translator = translator
        self.clusters_done = 0
        self.accum = accum
        self.monitor = StragglerMonitor()
        self.failures = failures
        self.seed = seed
        # (to_old, to_new) template/convert pairs for checkpoints written
        # under older tracker layouts (the sketch tracker restores legacy
        # DENSE id_counts by ingesting them)
        tracker_migrations = getattr(id_tracker, "checkpoint_migrations", None)
        self.migrations = tuple(tracker_migrations()) if tracker_migrations else ()
        self.runlog = runlog
        self.pump = MetricsPump(
            lag=PUMP_LAG, maxlen=HISTORY_MAX,
            sink=runlog.log_step if runlog is not None else None,
        )
        self.profile = (
            ProfileWindow(*profile_steps, log_dir=profile_dir or "profile")
            if profile_steps is not None else None
        )
        self._last_dispatch: float | None = None

    @property
    def history(self):
        return self.pump.history

    def _to_device(self, batch):
        """numpy batch -> tensors of (accum, micro, ...) on the device; a
        CUDA copy goes through pinned memory, non-blocking (a pageable
        copy synchronises the stream)."""
        out = {}
        for k, v in batch.items():
            if k == "step":
                continue
            x = np.asarray(v)
            x = x[None] if self.accum == 1 else x.reshape(
                self.accum, x.shape[0] // self.accum, *x.shape[1:])
            t = torch.from_numpy(np.ascontiguousarray(x))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def run(self, n_steps: int):
        step = int(self.state.step)
        try:
            for _ in range(n_steps):
                if self.profile is not None:
                    self.profile.observe(step)
                if self.failures is not None:
                    try:
                        self.failures.maybe_fail(step)
                    except Exception as e:
                        # make the completed steps' records durable before the
                        # crash propagates, and log the fire (dedupe off: a
                        # from-scratch restart re-fires at the same step)
                        self.pump.flush()
                        if self.runlog is not None:
                            self.runlog.append("fault", step=step, dedupe=False, error=str(e))
                        raise
                raw = next(self.data_iter)
                batch = self._to_device(raw)
                with span("dispatch"):
                    self.state, metrics = self.train_step(self.state, batch)
                # dispatch-to-dispatch wall time (StragglerMonitor's note)
                t1 = time.perf_counter()
                dt = None
                if self._last_dispatch is not None:
                    dt = t1 - self._last_dispatch
                    self.monitor.observe(step, dt)
                self._last_dispatch = t1
                # a step built with sketch_fn= already counted the tracker's
                # cells: hand the delta over (the host head/ring bookkeeping
                # is unchanged)
                delta = metrics.pop("sketch_delta", None)
                if self.id_tracker is not None:
                    with span("sketch-fold"):
                        if delta is not None:
                            self.id_tracker.observe(raw, delta=delta)
                        else:
                            self.id_tracker.observe(raw)
                self.pump.push(step, metrics, extra={"dt": dt})

                new_step = step + 1
                # adaptive schedule: a windowed tracker snapshots statistics
                # at window close; the trigger turns them into fire/hold,
                # deterministically given the batches and its restored state
                can_cluster = self.cluster_fn is not None and (
                    not self.cluster_max or self.clusters_done < self.cluster_max
                )
                triggered = False
                if self.id_tracker is not None and self.trigger is not None:
                    poll = getattr(self.id_tracker, "poll_window", None)
                    stats = poll() if poll is not None else None
                    if stats is not None:
                        # a fire that cannot run a transition must not commit
                        # fire-state
                        ev = self.trigger.update(stats, step=new_step, can_fire=can_cluster)
                        triggered = ev.fire
                        if self.runlog is not None:
                            self.runlog.append("trigger", **ev.as_dict())
                periodic = bool(self.cluster_every and new_step % self.cluster_every == 0)
                if can_cluster and (periodic or triggered):
                    with span("transition"):
                        self._transition(new_step)
                    if self.runlog is not None:
                        self.runlog.append(
                            "transition", step=new_step,
                            reason="trigger" if triggered else "periodic",
                            clusters_done=self.clusters_done,
                        )

                if self.ckpt and self.ckpt_every and new_step % self.ckpt_every == 0:
                    # every step record up to the checkpoint is durable
                    # before the save event: resume replays dedupe against
                    # a complete prefix of the log
                    self.pump.flush()
                    with span("checkpoint"):
                        self.ckpt.save_async(new_step, self._ckpt_tree())
                    if self.runlog is not None:
                        self.runlog.append("checkpoint_save", step=new_step)
                step = new_step
        finally:
            self.pump.flush()
            if self.profile is not None:
                self.profile.close()
        if self.ckpt:
            self.ckpt.wait()
        return list(self.history)

    def _transition(self, new_step: int) -> None:
        if self.id_tracker is not None:  # async folds must land
            getattr(self.id_tracker, "flush", lambda: None)()
        key = jr.fold_in(jr.PRNGKey(self.seed), new_step)
        if self._cluster_takes_opt:
            params, buffers, opt = self.cluster_fn(
                key, self.state.params, self.state.ebuf, self.state.opt)
        else:
            params, buffers = self.cluster_fn(key, self.state.params, self.state.ebuf)
            opt = self.state.opt
        # int8-EF residuals are per-row state the rewritten rows make
        # meaningless; zeroing them is always sound
        err = init_error_feedback(params) if self.state.err is not None else None
        self.state = self.state._replace(params=params, ebuf=buffers, opt=opt, err=err)
        self.clusters_done += 1
        if self.translator is not None:  # mirrors went stale
            self.translator.update(buffers["emb"])

    def _ckpt_tree(self):
        # clusters_done, the tracker and the trigger ride the checkpoint so
        # that a restart neither re-runs nor skips transitions and the
        # k-means sample resumes exactly; the step is stored as the JAX
        # package's int32
        tree = {"state": self.state._replace(step=np.int32(self.state.step)),
                "clusters_done": np.int32(self.clusters_done)}
        if self.id_tracker is not None:
            tree["id_counts"] = self.id_tracker.state_tree()
        if self.trigger is not None:
            tree["trigger"] = self.trigger.state_tree()
        return tree

    def _stored_n_leaves(self):
        """Leaf count of the latest committed checkpoint (None if none)."""
        ckpts = list_checkpoints(self.ckpt.directory)
        if not ckpts:
            return None
        with open(os.path.join(ckpts[-1][1], "manifest.json")) as f:
            return int(json.load(f)["n_leaves"])

    def _with_id_counts_placeholder(self, template):
        """When the WRITER had a tracker this Trainer doesn't, absorb the
        saved id_counts leaves via zero-size wildcards sized against THIS
        template's leaf count (the histograms are dropped)."""
        if self.id_tracker is not None or "id_counts" in template:
            return None
        n_stored = self._stored_n_leaves()
        if n_stored is None:
            return None
        extra = n_stored - len(jax_leaves(template))
        if extra <= 0:
            return None
        return dict(template, id_counts=[np.zeros(0)] * extra)

    def _restore_templates(self):
        """Candidate checkpoint layouts, most- to least-informative: the
        current layout, then what a differently-configured writer could
        have produced.  Templates hold FRESH tracker/trigger state: a
        sectioned checkpoint missing a section restores the template's
        value."""
        cur = {"state": self.state, "clusters_done": np.int32(self.clusters_done)}
        if self.id_tracker is not None:
            tmpl = getattr(self.id_tracker, "state_template", None)
            cur["id_counts"] = tmpl() if tmpl else self.id_tracker.state_tree()
        if self.trigger is not None:
            cur["trigger"] = self.trigger.state_template()
        templates = [cur]
        if self.trigger is not None:  # the writer predates the trigger
            templates.append({k: v for k, v in cur.items() if k != "trigger"})
        base = {"state": self.state, "clusters_done": np.int32(0)}
        if self.id_tracker is not None:
            templates.append(base)  # writer had no tracker
        else:
            with_counts = self._with_id_counts_placeholder(base)
            if with_counts is not None:  # writer-side id_counts, dropped
                templates.append(with_counts)
        templates.append({"state": self.state})  # pre-transition layout
        return templates

    def restore_latest(self):
        self.ckpt.wait()  # an async save may still be in flight post-crash
        templates = self._restore_templates()
        candidates = [(t, None) for t in templates]
        # legacy layouts: each migration's to_old derives an old-layout
        # template, its to_new converts what it restores
        for to_old, to_new in self.migrations:
            candidates += [(to_old(t), to_new) for t in templates]
        step, tree, _ = load_checkpoint(self.ckpt.directory, migrations=candidates)
        state = tree["state"]
        self.state = state._replace(step=int(state.step))
        self.clusters_done = int(tree.get("clusters_done", 0))
        if self.id_tracker is not None:
            if "id_counts" in tree:
                self.id_tracker.load_state_tree(tree["id_counts"])
            else:
                template = getattr(self.id_tracker, "state_template", None)
                if template is not None:
                    self.id_tracker.load_state_tree(template())
                warnings.warn("checkpoint had no usable id_counts section; tracker "
                              "restarted fresh from the restored step")
        if self.trigger is not None:
            if "trigger" in tree:
                self.trigger.load_state_tree(tree["trigger"])
            else:
                self.trigger.load_state_tree(self.trigger.state_template())
                warnings.warn("checkpoint had no trigger section; trigger restarted "
                              "fresh from the restored step")
            # windows evaluated between this checkpoint and the crash are
            # evaluated again on replay: the log shows each closed window once
            self.trigger.events = [e for e in self.trigger.events if e.step <= step]
        if self.translator is not None:  # mirrors must match restored ptr/hs
            self.translator.update(self.state.ebuf["emb"])
        # the restore gap is not a step interval
        self._last_dispatch = None
        if self.runlog is not None:
            self.runlog.append("checkpoint_restore", step=step, dedupe=False)
        return step
