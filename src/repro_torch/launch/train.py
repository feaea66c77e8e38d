"""Training launcher: DLRM with CCE tables (or any of the paper's
comparison methods), the paper's loop, and the dense LMs.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm --steps 40
    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm --device cpu \
        --steps 40 --cluster-every 20 --ckpt-dir /tmp/ckpt --ckpt-every 10 --fail-at 30
    PYTHONPATH=src python -m repro_torch.launch.train --emb hash --device cpu --steps 40
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --device cpu \
        --steps 12 --cluster-every 6
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b --device cpu \
        --steps 6 --cluster-every 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium --device cpu \
        --steps 4 --cluster-every 2
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --model-shards 4 \
        --device cpu --steps 40 --cluster-every 20
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --data-shards 2 \
        --model-shards 2 --device cpu --steps 40 --cluster-every 20

``--arch dlrm`` trains the reduced Criteo DLRM configuration on the
synthetic clickstream with the sketch frequency tracker (cell count in
the step, host fold on a background thread), the CCE transition every
``--cluster-every`` steps (and, with ``--trigger``, when the
entropy/drift trigger fires), async checkpoints, and an injected failure
at each ``--fail-at`` step, after which it restores the latest
checkpoint and resumes.  ``--arch <lm>`` (a key of
``repro_torch.configs.ARCHS``) trains that LM's reduced configuration on
the synthetic token stream (``--batch`` sequences of ``--seq`` tokens)
with adamw and a cosine schedule (``--warmup``); with a CCE token table a
dense token-frequency tracker feeds the transition of the token table
(dense, hybrid, vlm and xlstm), but for the audio family, whose table
rows are codebook-offset tokens: its transition samples the rows
uniformly, as the JAX package's does.  A compressed ``--emb`` on a
configuration that keeps a full table (musicgen-medium) gets
``REDUCED_EMB_BUDGET``, the budget ``reduced()`` gives the others.
Runs on the card unless ``--device`` names another; on the CPU every
kernel's plain version runs instead.  ``--obs RUN.jsonl`` writes a run
log and turns on the in-step telemetry (``python -m repro_torch.obs
summarize RUN.jsonl``).  ``--emb`` takes "cce" or any key of
``core.embeddings.METHODS`` (full, hash, hemb, ce, robe, dhe, tt); the
tracker, the transition and the trigger run with "cce" only, as in the
JAX package.  The options both packages' launchers share have the JAX
package's defaults.

``--model-shards M`` and ``--data-shards D`` (DLRM, under ``torchrun
--nproc-per-node D*M``; also any run under ``torchrun``) train the
model-parallel DLRM on the (data, model) mesh, JAX's 2-D layout
(``build_dlrm_sharded_trainer``): one process a rank, NCCL on the card
(one card a rank: more ranks than cards raise) and gloo with ``--device
cpu``, the world size checked against D x M.  The supertable splits over
the M ranks of a model group and is replicated over the D data replicas;
the batch splits over every rank.

``build_dlrm_trainer``, ``build_dlrm_sharded_trainer`` and
``build_lm_trainer`` take the configuration as an argument, so a caller
can train the full ``CONFIG``s.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch.core.embeddings import METHODS
from repro_torch.data.synthetic import ClickstreamConfig, clickstream_batches, lm_token_batches
from repro_torch.models import dlrm, lm
from repro_torch.obs.runlog import RunLog, default_manifest
from repro_torch.obs.telemetry import TelemetryConfig
from repro_torch.optim import adamw, cosine_schedule, sgd
from repro_torch.optim.remap import remap_opt_state
from repro_torch.stream.device import make_step_cell_counter
from repro_torch.stream.tracker import IdFrequencyTracker
from repro_torch.stream.trigger import ClusterTrigger
from repro_torch.train.loop import (
    FailureInjector,
    InjectedFailure,
    Trainer,
    init_state,
    make_train_step,
)
from repro_torch.train.transition import transition_table


#: The parameter budget of a reduced configuration's compressed tables.
#: ``reduced()`` sets it only where the full configuration compresses its
#: own, so the JAX package's launcher fails on musicgen-medium under
#: ``--emb cce`` (a budget of None); the port's gives it this one.
REDUCED_EMB_BUDGET = 2048


def lm_config(arch: str, emb: str = "cce"):
    """The configuration ``--arch arch --emb emb`` trains: ``arch``'s
    reduced one under ``emb``, with REDUCED_EMB_BUDGET for a compressed
    table that ``reduced()`` left without a budget."""
    from repro_torch import configs

    cfg = configs.get_reduced(arch, emb_method=emb)
    if cfg.emb_method != "full" and not cfg.emb_budget:
        cfg = dataclasses.replace(cfg, emb_budget=REDUCED_EMB_BUDGET)
    return cfg


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
        # checkpoints of the other emb layouts (per-feature, pre-universal,
        # another k_multiple: a model-sharded trainer's) restore too
        migrations=dlrm.checkpoint_migrations(cfg),
        **obs_kw,
    )


def sharded_batches(batches, translator, rank: int, n_shards: int):
    """Each global batch -> rank ``rank``'s contiguous slice of it, of
    ``n_shards`` (on a (data, model) mesh the world rank of data x model
    ranks), its rows host-translated and pre-bucketed by owning model
    shard (the sharded lookup reads rows, not ids), and the global batch's
    ids as
    ``global_sparse``, for the host alone: the frequency tracker counts
    them on every rank, so the ranks' counts, and their transitions,
    agree (``Trainer(host_keys=)`` keeps them off the device)."""
    for batch in batches:
        b = batch["sparse"].shape[0] // n_shards
        mine = slice(rank * b, (rank + 1) * b)
        out = {k: (v[mine] if k in ("dense", "label") else v)
               for k, v in batch.items() if k != "sparse"}
        out["rows"] = translator.rows(batch["sparse"][mine])
        out["global_sparse"] = batch["sparse"]
        yield out


def build_dlrm_sharded_trainer(cfg, args, *, mesh, data_from=None):
    """The model-parallel DLRM ``Trainer`` on this rank of ``mesh`` (a
    ``launch.mesh.Mesh``: the supertable over its model group, replicated
    over its data group, each world rank a slice of the batch; data
    replica 0 writes the checkpoints): the 1-device trainer's init (the
    whole state made on the host from ``args.seed``, then this rank's
    shard moved to ``args.device``), sgd with ``args.momentum``, clip
    ``args.clip``, the step of ``launch.steps.build_dlrm_train_step``
    over host-translated, pre-bucketed rows, a dense tracker of the
    global batch's ids, the sharded transition, whole-layout checkpoints
    and ``dlrm.checkpoint_migrations``.  ``data_from(start_step)`` gives
    the global batches (default ``dlrm_data``); each rank keeps its
    slice.  ``cfg.emb_k_multiple`` must be a multiple of the model ranks.
    Every model group runs the same transition on the same global counts,
    so the data replicas stay equal bit for bit.  A run log is written by
    world rank 0 only."""
    from repro_torch.checkpoint import reshard_restore
    from repro_torch.data.translate import HostTranslator
    from repro_torch.launch.steps import build_dlrm_train_step, dlrm_state_specs

    device = getattr(args, "device", "cuda")
    group = mesh.model
    rank, M = mesh.coords[1], mesh.shape["model"]
    if cfg.emb_k_multiple % M:
        raise ValueError(f"emb_k_multiple {cfg.emb_k_multiple} is no multiple of {M} shards")
    params, buffers = dlrm.init(cfg, torch.Generator().manual_seed(args.seed), device="cpu")
    optimizer = sgd(momentum=args.momentum)
    whole = init_state(params, optimizer, buffers)
    specs = dlrm_state_specs(cfg, whole, M)
    state = reshard_restore(whole, specs, rank, M, device=device)
    translator = HostTranslator(cfg.collection, buffers["emb"], n_shards=M)
    del whole, params, buffers
    telemetry, obs_kw = _obs_kit(args, "dlrm_sharded")
    if mesh.rank != 0:
        obs_kw.pop("runlog", None)
    lr = args.lr
    step, _ = build_dlrm_train_step(
        cfg, mesh, specs, batch_size=args.batch, accum=args.accum, optimizer=optimizer,
        lr_fn=lambda s: lr, clip_norm=getattr(args, "clip", 1.0), telemetry=telemetry)
    track = args.emb == "cce"
    tracker = IdFrequencyTracker(cfg.vocab_sizes, key="global_sparse") if track else None

    def cluster_fn(key, p, b, opt):
        return dlrm.cluster_tables(key, p, b, cfg, opt, id_counts=tracker.counts, group=group)

    global_from = data_from or dlrm_data(cfg, args)

    def local_from(start_step: int):
        return sharded_batches(global_from(start_step), translator, mesh.rank, mesh.size)

    return Trainer(
        step, state, local_from(0),
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        keep_last=getattr(args, "keep_last", 3),
        cluster_fn=cluster_fn if track else None,
        cluster_every=args.cluster_every, cluster_max=getattr(args, "cluster_max", 0),
        id_tracker=tracker, translator=translator, accum=args.accum,
        failures=FailureInjector(tuple(args.fail_at)),
        seed=args.seed,
        migrations=dlrm.checkpoint_migrations(cfg),
        state_shardings=specs, mesh=mesh,
        host_keys=("global_sparse",),
        **obs_kw,
    )


def lm_data(cfg, args):
    """``start_step -> batch iterator``: the synthetic token stream over
    ``cfg.vocab``, ``args.batch`` sequences of ``args.seq`` tokens, seeded
    by ``args.seed``."""

    def data_from(start_step: int):
        return lm_token_batches(cfg.vocab, args.batch, args.seq, seed=args.seed,
                                start_step=start_step, n_codebooks=cfg.n_codebooks)

    return data_from


def build_lm_trainer(cfg, args, *, data_from=None):
    """The LM ``Trainer`` on ``args.device``, as the JAX package builds it:
    ``next_token_loss``, adamw (weight decay 0.1) under a cosine schedule
    (``args.lr``, ``args.warmup`` steps of warm-up, ``args.steps`` in
    all), clip 1.0.  With a CCE token table, a dense tracker counts the
    tokens and the transition re-clusters the token table (the head's
    table is not transitioned) from those counts, streaming the
    vocabulary in chunks of 2^18 ids, with the adamw moments remapped; a
    codebook model's token counts are not its table's rows (each codebook
    is offset), so it has no tracker and its transition samples the rows
    uniformly.
    Weights are drawn by a generator on the device.  ``data_from(start_step)``
    gives the batches (default ``lm_data``)."""
    device = getattr(args, "device", "cuda")
    params, buffers = lm.init(cfg, torch.Generator(device=device).manual_seed(args.seed),
                              device=device)
    optimizer = adamw(weight_decay=0.1)

    def loss_fn(p, b, mb):
        return lm.next_token_loss(p, b, cfg, mb)

    telemetry, obs_kw = _obs_kit(args, cfg.name)
    step = make_train_step(loss_fn, optimizer, cosine_schedule(args.lr, args.warmup, args.steps),
                           accum=args.accum, telemetry=telemetry)
    tracker = cluster_fn = None
    if cfg.emb_method == "cce":
        emb = lm.make_emb(cfg)
        if not cfg.n_codebooks:
            tracker = IdFrequencyTracker((emb.d1,), key="tokens")

        def cluster_fn(key, p, b, opt):
            ep, eb, update = transition_table(
                emb, key, p["emb"], b["emb"],
                counts=tracker.counts[0] if tracker is not None else None, chunk_size=1 << 18)

            def upd(moments, _slot):
                return dict(moments, emb=update(moments["emb"]))

            return dict(p, emb=ep), dict(b, emb=eb), remap_opt_state(opt, upd)

    data_from = data_from or lm_data(cfg, args)
    return Trainer(
        step, init_state(params, optimizer, buffers), data_from(0),
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        cluster_fn=cluster_fn, cluster_every=args.cluster_every,
        cluster_max=getattr(args, "cluster_max", 0), id_tracker=tracker, accum=args.accum,
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


def parser() -> argparse.ArgumentParser:
    """The launcher's options; those the JAX package's launcher has too
    take its defaults."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm",
                    help="dlrm or a key of repro_torch.configs.ARCHS")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64, help="LM sequence length")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--momentum", type=float, default=0.0, help="DLRM's sgd momentum")
    ap.add_argument("--warmup", type=int, default=10, help="LM warm-up steps")
    ap.add_argument("--emb", default="cce", choices=["cce", *METHODS])
    ap.add_argument("--emb-cap", type=int, default=512)
    ap.add_argument("--window", type=int, default=8,
                    help="DLRM's sketch tracker window in batches (0: no windows)")
    ap.add_argument("--trigger", action="store_true",
                    help="DLRM: also cluster when the entropy/drift trigger fires")
    ap.add_argument("--cluster-every", type=int, default=0)
    ap.add_argument("--cluster-max", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-shards", type=int, default=1,
                    help="DLRM: shard the supertable over this many ranks (run under "
                    "torchrun --nproc-per-node D*M)")
    ap.add_argument("--data-shards", type=int, default=1,
                    help="DLRM: replicas of the sharded supertable, the data axis of the "
                    "(data, model) mesh")
    ap.add_argument("--obs", default=None, metavar="RUN.jsonl")
    ap.add_argument("--profile-steps", type=int, nargs=2, default=None)
    ap.add_argument("--profile-dir", default="profile")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.fail_at and not (args.ckpt_dir and args.ckpt_every):
        ap.error("--fail-at needs --ckpt-dir and --ckpt-every to resume from")
    mesh = None
    if args.model_shards > 1 or args.data_shards > 1 or "WORLD_SIZE" in os.environ:
        if args.arch != "dlrm":
            ap.error("--model-shards/--data-shards: the sharded trainer is DLRM's")
        mesh = launch_mesh(args)
    if mesh is not None:
        from repro_torch.configs import dlrm_criteo

        cfg = dlrm_criteo.reduced(emb_method=args.emb, cap=args.emb_cap,
                                  k_multiple=args.model_shards)
        global_from = dlrm_data(cfg, args)
        trainer = build_dlrm_sharded_trainer(cfg, args, mesh=mesh, data_from=global_from)

        def data_from(start_step: int):
            return sharded_batches(global_from(start_step), trainer.translator,
                                   mesh.rank, mesh.size)
    elif args.arch == "dlrm":
        from repro_torch.configs import dlrm_criteo

        cfg = dlrm_criteo.reduced(emb_method=args.emb, cap=args.emb_cap)
        stream = dlrm_criteo.reduced_stream(window=args.window, async_fold=True)
        trigger = (ClusterTrigger(entropy_drop=0.1, drift_threshold=0.25, warmup=2)
                   if args.trigger and args.emb == "cce" else None)
        data_from = dlrm_data(cfg, args)
        trainer = build_dlrm_trainer(cfg, args, stream=stream, trigger=trigger,
                                     data_from=data_from)
    else:
        if args.trigger:
            ap.error("--trigger needs a windowed tracker: DLRM only")
        cfg = lm_config(args.arch, args.emb)
        data_from = lm_data(cfg, args)
        trainer = build_lm_trainer(cfg, args, data_from=data_from)
    t0 = time.time()
    restored = run_with_restart(trainer, args.steps, data_from)
    dt = time.time() - t0
    losses = [h["loss"] for h in trainer.history]
    rank = 0
    if mesh is not None:
        rank = mesh.rank
        dist.destroy_process_group()
    if rank == 0:
        shards = ""
        if mesh is not None:
            shards = f", {args.model_shards} model shards" + (
                f" x {args.data_shards} data shards" if args.data_shards > 1 else "")
        print(f"{args.arch} on {args.device}{shards}: step {trainer.state.step} in {dt:.1f}s, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, clusterings {trainer.clusters_done}, "
              f"restored at {restored}, stragglers={len(trainer.monitor.flagged)}")
    if args.obs and trainer.runlog is not None:
        trainer.runlog.close()
        print(f"run log: {args.obs}  "
              f"(summarize: python -m repro_torch.obs summarize {args.obs})")
    return trainer


def launch_mesh(args):
    """The (data, model) mesh of ``--data-shards D --model-shards M``:
    refuses more ranks than cards on ``cuda`` and a world (``torchrun``'s
    ``WORLD_SIZE``) of another size than D x M, then joins it
    (``launch.mesh.init_mesh``)."""
    from repro_torch.launch.mesh import init_mesh

    D, M = args.data_shards, args.model_shards
    n = D * M
    if args.device == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"--data-shards {D} --model-shards {M} needs {n} CUDA devices, "
                           f"this machine has {torch.cuda.device_count()}")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != n:
        raise ValueError(f"--data-shards {D} --model-shards {M} runs as {n} processes "
                         f"(torchrun --nproc-per-node {n}); the world has {world}")
    return init_mesh(D, M, args.device)


if __name__ == "__main__":
    main()
