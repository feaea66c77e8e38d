"""Training launcher: DLRM with CCE tables, the paper's loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm --steps 40
    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm --device cpu \
        --steps 40 --cluster-every 20 --ckpt-dir /tmp/ckpt --ckpt-every 10 --fail-at 30

Trains the reduced Criteo DLRM configuration on the synthetic clickstream
with the sketch frequency tracker (cell count in the step, host fold on a
background thread), the CCE transition every ``--cluster-every`` steps
(and, with ``--trigger``, when the entropy/drift trigger fires), async
checkpoints, and an injected failure at each ``--fail-at`` step, after
which it restores the latest checkpoint and resumes.  Runs on the card
unless ``--device`` names another; on the CPU every kernel's plain version
runs instead.  ``--obs RUN.jsonl`` writes a run log and turns on the
in-step telemetry (``python -m repro_torch.obs summarize RUN.jsonl``).

``build_dlrm_trainer`` takes the configuration as an argument, so a
caller can train the full ``configs/dlrm_criteo.py::CONFIG``.  LM
training is not ported (ROADMAP Queue 1 #3).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.data.synthetic import ClickstreamConfig, clickstream_batches
from repro_torch.models import dlrm
from repro_torch.obs.runlog import RunLog, default_manifest
from repro_torch.obs.telemetry import TelemetryConfig
from repro_torch.optim import sgd
from repro_torch.stream.device import make_step_cell_counter
from repro_torch.stream.trigger import ClusterTrigger
from repro_torch.train.loop import (
    FailureInjector,
    InjectedFailure,
    Trainer,
    init_state,
    make_train_step,
)


def _obs_kit(args, config_name: str):
    """(telemetry, trainer obs kwargs) for ``--obs PATH``: in-step health
    metrics + a run log; ``--profile-steps A B`` also opens a profiler
    window."""
    telemetry, kw = None, {}
    obs = getattr(args, "obs", None)
    if obs:
        telemetry = TelemetryConfig()
        kw["runlog"] = RunLog(obs, manifest=default_manifest(
            config_name, device=getattr(args, "device", "cuda")))
    profile_steps = getattr(args, "profile_steps", None)
    if profile_steps:
        kw["profile_steps"] = tuple(profile_steps)
        kw["profile_dir"] = getattr(args, "profile_dir", "profile")
    return telemetry, kw


def dlrm_data(cfg, args):
    """``start_step -> batch iterator``: the synthetic clickstream over
    ``cfg``'s vocabularies, seeded by ``args.seed``."""
    data_cfg = ClickstreamConfig(vocab_sizes=cfg.vocab_sizes, seed=args.seed)

    def data_from(start_step: int):
        return clickstream_batches(data_cfg, args.batch, start_step=start_step)

    return data_from


def build_dlrm_trainer(cfg, args, *, stream=None, trigger=None, data_from=None):
    """The DLRM ``Trainer`` on ``args.device``: sgd with ``args.momentum``
    at constant ``args.lr``, clip ``args.clip``; with ``args.emb == "cce"``
    a tracker (``dlrm.make_id_tracker(cfg, stream)``: the sketch tracker
    for a ``StreamConfig``, the dense one for None) whose cell count rides
    the step, and the transition with the moments remapped.
    ``data_from(start_step)`` gives the batches (default ``dlrm_data``)."""
    device = getattr(args, "device", "cuda")
    params, buffers = dlrm.init(cfg, torch.Generator().manual_seed(args.seed), device=device)
    optimizer = sgd(momentum=args.momentum)  # paper default: SGD

    def loss_fn(p, b, mb):
        return dlrm.bce_loss(p, b, cfg, mb), {}

    track = args.emb == "cce"
    tracker = dlrm.make_id_tracker(cfg, stream, device=device) if track else None
    telemetry, obs_kw = _obs_kit(args, "dlrm")
    lr = args.lr
    step = make_train_step(
        loss_fn, optimizer, lambda s: lr, accum=args.accum,
        clip_norm=getattr(args, "clip", 1.0),
        sketch_fn=make_step_cell_counter(tracker) if tracker is not None else None,
        telemetry=telemetry,
    )

    def cluster_fn(key, p, b, opt):
        return dlrm.cluster_tables(key, p, b, cfg, opt, id_counts=tracker.counts)

    data_from = data_from or dlrm_data(cfg, args)
    return Trainer(
        step, init_state(params, optimizer, buffers), data_from(0),
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        keep_last=getattr(args, "keep_last", 3),
        cluster_fn=cluster_fn if track else None,
        cluster_every=args.cluster_every, cluster_max=getattr(args, "cluster_max", 0),
        id_tracker=tracker, trigger=trigger, accum=args.accum,
        failures=FailureInjector(tuple(args.fail_at)),
        seed=args.seed,
        **obs_kw,
    )


def run_with_restart(trainer: Trainer, n_steps: int, data_from) -> list[int]:
    """Train to step ``n_steps``; after each injected failure restore the
    latest checkpoint, restart the data at its step and go on.  Returns
    the steps restored to."""
    restored = []
    start = int(trainer.state.step)
    while True:
        try:
            trainer.run(n_steps - start)
            return restored
        except InjectedFailure as e:
            if trainer.ckpt is None:
                raise
            start = trainer.restore_latest()
            print(f"!! {e}; resumed from the checkpoint at step {start}", flush=True)
            restored.append(start)
            trainer.data_iter = data_from(start)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--emb", default="cce")
    ap.add_argument("--emb-cap", type=int, default=512)
    ap.add_argument("--window", type=int, default=8,
                    help="sketch tracker window in batches (0: no windows)")
    ap.add_argument("--trigger", action="store_true",
                    help="also cluster when the entropy/drift trigger fires")
    ap.add_argument("--cluster-every", type=int, default=0)
    ap.add_argument("--cluster-max", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs", default=None, metavar="RUN.jsonl")
    ap.add_argument("--profile-steps", type=int, nargs=2, default=None)
    ap.add_argument("--profile-dir", default="profile")
    args = ap.parse_args(argv)

    if args.arch != "dlrm":
        raise NotImplementedError(
            f"--arch {args.arch}: LM training is not ported yet (ROADMAP Queue 1 #3)")
    if args.fail_at and not (args.ckpt_dir and args.ckpt_every):
        ap.error("--fail-at needs --ckpt-dir and --ckpt-every to resume from")
    from repro_torch.configs import dlrm_criteo

    cfg = dlrm_criteo.reduced(emb_method=args.emb, cap=args.emb_cap)
    stream = dlrm_criteo.reduced_stream(window=args.window, async_fold=True)
    trigger = (ClusterTrigger(entropy_drop=0.1, drift_threshold=0.25, warmup=2)
               if args.trigger else None)
    data_from = dlrm_data(cfg, args)
    trainer = build_dlrm_trainer(cfg, args, stream=stream, trigger=trigger,
                                 data_from=data_from)
    t0 = time.time()
    restored = run_with_restart(trainer, args.steps, data_from)
    dt = time.time() - t0
    losses = [h["loss"] for h in trainer.history]
    print(f"dlrm on {args.device}: step {trainer.state.step} in {dt:.1f}s, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, clusterings {trainer.clusters_done}, "
          f"restored at {restored}, stragglers={len(trainer.monitor.flagged)}")
    if args.obs:
        trainer.runlog.close()
        print(f"run log: {args.obs}  "
              f"(summarize: python -m repro_torch.obs summarize {args.obs})")


if __name__ == "__main__":
    main()
