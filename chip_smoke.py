#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (into ``build/repro_torch/``), one nvcc per source, all at once.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the main paths (the lookup and its backward bit for bit, the
   k-means assignment by the tie-tolerant rule) and times kernel, plain
   version and a library call that computes the same function.
3. Trains the full-width Criteo DLRM configuration (26 features, 33.7M ids,
   random weights from a seed) for 8 steps at batch 2048, holding the
   first step against the same step on CPU copies of the state; runs one
   CCE clustering transition with the optimizer moments remapped (checked
   for its invariants and for bitwise repeatability); trains 4 more steps;
   then serves the trained state through ``DLRMServeEngine.update_state``.
4. Serves freshly initialised weights through ``DLRMServeEngine``
   (submit/step/drain), the serving path of the first slice.
Each path runs with the launch counts reset just before it and read just
after.  Prints the kernels' JSON line, the card line and, last,
``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when there is no CUDA device, when the
port is missing, or when any phase fails.  Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
SERVE_BATCH = 256
SERVE_BATCHES = 4  # host-side id sampling over 10M-row vocabularies costs ~1 s a batch
TRAIN_BATCH = 2048
TRAIN_STEPS = 8  # before the transition
POST_STEPS = 4  # after it
TRAIN_LR = 0.05  # constant, with momentum 0.9 and clip 1.0
LOOKUP_BATCHES = (1, 7, SERVE_BATCH, TRAIN_BATCH, 4096)
BWD_BATCHES = (256, TRAIN_BATCH, 4096)
ASSIGN_SHAPES = ((1 << 18, 250, 4), (64000, 250, 4))  # an assign_all chunk; a Lloyd sample
ASSIGN_RTOL = 1e-5  # the plain distance of the kernel's pick vs the plain minimum
STEP_RTOL = 1e-4  # card vs CPU, per leaf, relative to the leaf's largest magnitude


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, *, iters: int = 200, reps: int = 5, warmup: int = 10) -> float:
    """Median over ``reps`` of CUDA-event time per call, over ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, kernel_name: str, *, iters: int = 50):
    """Mean device time of the named CUDA kernel per launch from
    torch.profiler, or None where the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if kernel_name in e.key and e.count:
            us = getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0)
            return us / 1e3 if us else None
    return None


def device_busy_ms(fn, *, iters: int = 1) -> float:
    """Device time of every CUDA kernel and copy that a call of ``fn``
    runs, summed from torch.profiler, mean over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum((getattr(e, "device_time", None) or 0.0) * e.count for e in prof.key_averages())
    return total_us / 1e3 / iters


def lookup_case(collection, B: int, dtype, seed: int, device="cuda"):
    """idx and tables at the supertable's shape, in the serving layout
    (rows (B, c, T) seen as a (c, B, T) view).  Columns of full tables
    carry -1 in their second slot, as host translation gives them; on top,
    10% random -1 sentinels and 5% rows at or past k."""
    import numpy as np
    import torch

    from repro_torch.core.embeddings import FullTable

    (g,) = collection.univ_groups
    grp = collection.groups[g]
    c, T, k, dsub = grp.n_cols, grp.n_tables, grp.k_pad, grp.dsub
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, k, (B, c, T)).astype(np.int32)
    full_col = np.array([isinstance(collection.tables[f], FullTable)
                         for f in collection.rows_col_feature])
    rows[:, full_col, 1] = -1
    u = rng.random((B, c, T))
    rows[u < 0.10] = -1
    rows[(u >= 0.10) & (u < 0.15)] = k + rng.integers(0, 3 * k, int(((u >= 0.10) & (u < 0.15)).sum()))
    tables = torch.from_numpy(rng.normal(size=(c, T, k, dsub)).astype(np.float32))
    idx = torch.from_numpy(rows).to(device).movedim(0, 1)  # (c, B, T), strided
    return idx, tables.to(device=device, dtype=dtype)


def lookup_bound(idx, tables):
    """Least time for the lookup on an H100: bytes it must move (idx read
    once, the distinct rows this data gathers read once, the output written
    once) over the memory rate, against its float adds over the float32
    rate.  Returns (ms, "bytes" | "operations")."""
    import torch

    c, B, T = idx.shape
    k, dsub, esize = tables.shape[2], tables.shape[3], tables.element_size()
    r = idx.to(torch.int64)
    valid = (r >= 0) & (r < k)
    key = (torch.arange(c, device=r.device)[:, None, None] * T
           + torch.arange(T, device=r.device)[None, None, :]) * k + r
    n_rows = int(torch.unique(key[valid]).numel())
    n_bytes = B * c * T * 4 + n_rows * dsub * esize + B * c * dsub * esize
    n_ops = int(valid.sum()) * dsub
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def embedding_bag_args(idx, tables):
    """The same lookup as one F.embedding_bag(mode="sum") over the
    flattened slab: one bag per (b, column) holding its valid rows."""
    import torch

    c, B, T = idx.shape
    k = tables.shape[2]
    r = idx.movedim(0, 1).to(torch.int64)  # (B, c, T)
    flat = (torch.arange(c, device=r.device)[None, :, None] * T
            + torch.arange(T, device=r.device)[None, None, :]) * k + r
    valid = (r >= 0) & (r < k)
    counts = valid.sum(-1).reshape(-1)
    offsets = torch.zeros_like(counts)
    offsets[1:] = torch.cumsum(counts, 0)[:-1]
    return flat[valid], tables.reshape(-1, tables.shape[3]), offsets


def kernel_phase(card: str, collection, device="cuda"):
    """The lookup kernel against its plain version at the supertable's
    shape, with its times.  Returns (max float32 error, {batch: numbers}
    at the serve and the train batch)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ref

    (g,) = collection.univ_groups
    grp = collection.groups[g]
    print(f"supertable: c={grp.n_cols} T={grp.n_tables} k={grp.k_pad} dsub={grp.dsub}")
    max_err = 0.0
    at = {}
    for dtype in (torch.float32, torch.bfloat16):
        for B in LOOKUP_BATCHES:
            idx, tables = lookup_case(collection, B, dtype, seed=B, device=device)
            got = cl.cce_lookup_fwd(idx, tables)
            want = ref.cce_lookup_ref(idx, tables)
            contig = cl.cce_lookup_fwd(idx.contiguous(), tables)
            err = (got.float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                check(torch.equal(got, want), f"f32 kernel != plain at B={B} (max err {err})")
                check(torch.equal(contig, got), f"contiguous idx differs at B={B}")
                max_err = max(max_err, err)
            else:
                # both round the same float32 sum to bf16: allow one step
                check(torch.allclose(got.float(), want.float(), rtol=2**-7, atol=0.0),
                      f"bf16 kernel vs plain beyond 2^-7 relative at B={B} (max err {err})")
            ms = time_ms(lambda: cl.cce_lookup_fwd(idx, tables))
            plain = time_ms(lambda: ref.cce_lookup_ref(idx, tables))
            dev = device_ms(lambda: cl.cce_lookup_fwd(idx, tables), "cce_lookup_fwd_kernel")
            plain_dev = device_busy_ms(lambda: ref.cce_lookup_ref(idx, tables), iters=20)
            bound, bound_by = lookup_bound(idx, tables)
            line = (f"[{card}] cce_lookup_fwd {str(dtype).split('.')[-1]} B={B}: "
                    f"max_abs_err={err!r} ms={ms!r} device_ms={dev!r} plain_ms={plain!r} "
                    f"plain_device_ms={plain_dev!r} bound_ms={bound!r} ({bound_by})")
            lib = lib_dev = None
            if dtype == torch.float32:
                bag, weight, offsets = embedding_bag_args(idx, tables)
                lib_out = F.embedding_bag(bag, weight, offsets, mode="sum")
                check(torch.allclose(lib_out.reshape(B, -1), got, rtol=1e-6, atol=1e-6),
                      f"embedding_bag yardstick computes another function at B={B}")
                lib = time_ms(lambda: F.embedding_bag(bag, weight, offsets, mode="sum"))
                lib_dev = device_busy_ms(
                    lambda: F.embedding_bag(bag, weight, offsets, mode="sum"), iters=20)
                line += f" library_ms(embedding_bag)={lib!r} library_device_ms={lib_dev!r}"
            print(line, flush=True)
            if dtype == torch.float32 and B in (SERVE_BATCH, TRAIN_BATCH):
                at[B] = dict(ms=ms, device_ms=dev, plain_ms=plain, plain_device_ms=plain_dev,
                             bound_ms=bound, bound_by=bound_by, library_ms=lib,
                             library_device_ms=lib_dev)
    return max_err, at


def column_ks(collection) -> list[int]:
    """The real codebook size of every supertable column (its feature's k;
    rows from there to k_pad are padding)."""
    return [collection.tables[f].fuse_spec.k for f in collection.rows_col_feature]


def bwd_case(collection, B: int, dtype, seed: int, device="cuda"):
    """idx as the train step gives it to the backward (the (c, B, T) view of
    rows drawn below each column's real k, the second slot of full-table
    columns -1, 10% more -1 sentinels) and a random upstream gradient."""
    import numpy as np
    import torch

    from repro_torch.core.embeddings import FullTable

    (g,) = collection.univ_groups
    grp = collection.groups[g]
    c, T, dsub = grp.n_cols, grp.n_tables, grp.dsub
    rng = np.random.default_rng(seed)
    ks = np.array(column_ks(collection))
    rows = (rng.random((B, c, T)) * ks[None, :, None]).astype(np.int32)
    full_col = np.array([isinstance(collection.tables[f], FullTable)
                         for f in collection.rows_col_feature])
    rows[:, full_col, 1] = -1
    rows[rng.random((B, c, T)) < 0.10] = -1
    idx = torch.from_numpy(rows).to(device).movedim(0, 1)  # (c, B, T), strided
    dout = torch.from_numpy(rng.normal(size=(B, c, dsub)).astype(np.float32))
    return idx, dout.to(device=device, dtype=dtype)


def bwd_bound(idx, dout, k: int):
    """Least time for the backward on an H100: idx and dout read once, the
    (c, T, k, dsub) gradient written once, against one float add per valid
    index and element.  Returns (ms, "bytes" | "operations")."""
    c, B, T = idx.shape
    dsub, esize = dout.shape[2], dout.element_size()
    n_valid = int(((idx >= 0) & (idx < k)).sum())
    n_bytes = B * c * T * 4 + B * c * dsub * esize + c * T * k * dsub * esize
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, n_valid * dsub / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def index_add_args(idx, dout, k: int):
    """The same gradient as one ``index_add_`` into the flattened
    (c*T*k, dsub) slab: destination rows and source rows of dout."""
    import torch

    c, B, T = idx.shape
    r = idx.to(torch.int64)
    col_t = (torch.arange(c, device=r.device)[:, None, None] * T
             + torch.arange(T, device=r.device)[None, None, :])
    src = (torch.arange(B, device=r.device)[None, :, None] * c
           + torch.arange(c, device=r.device)[:, None, None]).expand(c, B, T)
    valid = (r >= 0) & (r < k)
    return (col_t * k + r)[valid], dout.reshape(B * c, -1)[src[valid]]


def bwd_kernel_phase(card: str, collection, device="cuda"):
    """The backward kernel against its plain version at the supertable's
    shape: equal bit for bit (both sum each row in float32 in increasing b
    and round once), equal to itself across calls, and exactly zero on
    rows no index names (sentinels, padding past a column's k).  Returns
    (max error, numbers at the train batch)."""
    import torch

    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ref

    (g,) = collection.univ_groups
    k = collection.groups[g].k_pad
    ks = torch.tensor(column_ks(collection), device=device)
    max_err, at = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for B in BWD_BATCHES:
            idx, dout = bwd_case(collection, B, dtype, seed=100 + B, device=device)
            got = cl.cce_lookup_bwd(idx, dout, k)
            again = cl.cce_lookup_bwd(idx, dout, k)
            want = ref.cce_lookup_bwd_ref(idx, dout, k)
            err = (got.float() - want.float()).abs().max().item()
            check(torch.equal(got, want), f"bwd kernel != plain at B={B} {dtype} (max err {err})")
            check(torch.equal(got, again), f"bwd kernel not repeatable at B={B} {dtype}")
            c, _, T = idx.shape
            named = torch.zeros((c, T, k), dtype=torch.bool, device=device)
            r = idx.to(torch.int64)
            valid = (r >= 0) & (r < k)
            cc, _, tt = torch.nonzero(valid, as_tuple=True)
            named[cc, tt, r[valid]] = True
            check(not got[~named].any(), f"bwd kernel wrote a row no index names at B={B}")
            pad = torch.arange(k, device=device)[None, None, :] >= ks[:, None, None]
            check(not got[pad.expand(c, T, k)].any(), f"bwd padding rows not zero at B={B}")
            max_err = max(max_err, err)
            ms = time_ms(lambda: cl.cce_lookup_bwd(idx, dout, k))
            plain = time_ms(lambda: ref.cce_lookup_bwd_ref(idx, dout, k), iters=3, reps=3,
                            warmup=1)
            dev = device_ms(lambda: cl.cce_lookup_bwd(idx, dout, k), "cce_lookup_bwd_kernel")
            plain_dev = device_busy_ms(lambda: ref.cce_lookup_bwd_ref(idx, dout, k))
            bound, bound_by = bwd_bound(idx, dout, k)
            line = (f"[{card}] cce_lookup_bwd {str(dtype).split('.')[-1]} B={B}: "
                    f"max_abs_err={err!r} repeatable=True zero_unnamed_rows=True ms={ms!r} "
                    f"device_ms={dev!r} plain_ms={plain!r} plain_device_ms={plain_dev!r} "
                    f"bound_ms={bound!r} ({bound_by})")
            lib = lib_dev = None
            if dtype == torch.float32:
                dest, rows = index_add_args(idx, dout, k)
                flat = (c * T * k, dout.shape[2])

                def library():
                    return torch.zeros(flat, device=device).index_add_(0, dest, rows)

                # atomics add a hot row's hundreds of terms in another order
                lib_err = (library().reshape(got.shape) - got).abs().max().item()
                check(lib_err <= 1e-5 * got.abs().max().item(),
                      f"index_add_ yardstick computes another function at B={B} ({lib_err})")
                lib = time_ms(library)
                lib_dev = device_busy_ms(library, iters=20)
                line += f" library_ms(zeros+index_add_)={lib!r} library_device_ms={lib_dev!r}"
            print(line, flush=True)
            if dtype == torch.float32 and B == TRAIN_BATCH:
                at = dict(ms=ms, device_ms=dev, plain_ms=plain, plain_device_ms=plain_dev,
                          bound_ms=bound, bound_by=bound_by, library_ms=lib,
                          library_device_ms=lib_dev)
    return max_err, at


def assign_bound(n: int, k: int, d: int):
    """Least time for the assignment on an H100: x, the centroids and the
    output moved once, against n*k*(d+1) float32 FMAs (2 operations each)
    at the data-sheet rate.  Returns (ms, "bytes" | "operations")."""
    n_bytes = (n * d + k * d) * 4 + n * 4
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, 2 * n * k * (d + 1) / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kmeans_phase(card: str, device="cuda"):
    """The assignment kernel against its plain version at an assign_all
    chunk and at a Lloyd-sample shape: for every point the plain distance
    of the kernel's pick is within ASSIGN_RTOL*(|min|+1) of the plain
    minimum.  Returns (max excess, numbers at the chunk shape)."""
    import torch

    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import ref

    max_excess, at = 0.0, {}
    for n, k, d in ASSIGN_SHAPES:
        g = torch.Generator(device=device).manual_seed(n)
        x = torch.randn((n, d), generator=g, device=device)
        cent = torch.randn((k, d), generator=g, device=device)
        got = ka.kmeans_assign(x, cent)
        want = ref.kmeans_assign_ref(x, cent)
        dist = (cent * cent).sum(-1)[None, :] - 2.0 * (x @ cent.T)
        best = dist.min(1).values
        excess = dist.gather(1, got.long()[:, None])[:, 0] - best
        check(bool((excess <= ASSIGN_RTOL * (best.abs() + 1)).all()),
              f"kmeans_assign picks beyond tolerance at n={n} (max excess {excess.max().item()})")
        agree = (got == want).float().mean().item()
        max_excess = max(max_excess, excess.max().item())
        ms = time_ms(lambda: ka.kmeans_assign(x, cent))
        plain = time_ms(lambda: ref.kmeans_assign_ref(x, cent), iters=50)
        dev = device_ms(lambda: ka.kmeans_assign(x, cent), "kmeans_assign_kernel")
        plain_dev = device_busy_ms(lambda: ref.kmeans_assign_ref(x, cent), iters=10)

        def library():
            return torch.cdist(x, cent).argmin(1)

        lib_agree = (library() == got.long()).float().mean().item()
        lib = time_ms(library, iters=50)
        lib_dev = device_busy_ms(library, iters=10)
        bound, bound_by = assign_bound(n, k, d)
        print(f"[{card}] kmeans_assign n={n} k={k} d={d}: max_excess={excess.max().item()!r} "
              f"agree_with_plain={agree!r} agree_with_cdist={lib_agree!r} ms={ms!r} "
              f"device_ms={dev!r} plain_ms={plain!r} plain_device_ms={plain_dev!r} "
              f"library_ms(cdist+argmin, two calls)={lib!r} library_device_ms={lib_dev!r} "
              f"bound_ms={bound!r} ({bound_by})", flush=True)
        if not at:
            at = dict(agree_with_plain=agree, ms=ms, device_ms=dev, plain_ms=plain,
                      plain_device_ms=plain_dev, bound_ms=bound, bound_by=bound_by,
                      library_ms=lib, library_device_ms=lib_dev)
    return max_excess, at


class PhaseClock:
    """Host ms of the transition by phase: wraps the functions that make up
    the phases so that each top-level call (not one nested in another
    phase) is timed between two synchronisations and runs inside a
    profiler range named ``transition:<phase>``."""

    def __init__(self, targets):
        self.ms = collections.Counter()
        self._targets = targets  # (owner, attribute, phase)
        self._saved = []
        self._depth = 0

    def __enter__(self):
        import torch

        for owner, name, phase in self._targets:
            orig = getattr(owner, name)

            def wrapped(*args, _orig=orig, _phase=phase, **kw):
                if self._depth:
                    return _orig(*args, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                self._depth += 1
                try:
                    with torch.profiler.record_function(f"transition:{_phase}"):
                        return _orig(*args, **kw)
                finally:
                    self._depth -= 1
                    torch.cuda.synchronize()
                    self.ms[_phase] += (time.perf_counter() - t0) * 1e3

            self._saved.append((owner, name, orig))
            setattr(owner, name, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()


def _leaf_errors(got, want) -> list[tuple[float, float]]:
    """(max |got - want|, max |want|) of every leaf of two trees."""
    from repro_torch.tree import tree_leaves

    out = []
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        out.append(((a - b).abs().max().item(), b.abs().max().item()))
    return out


def _check_close(errs, what: str) -> float:
    """Every leaf within STEP_RTOL of its largest magnitude; returns the
    largest relative error."""
    rel = max(e / max(m, 1e-30) for e, m in errs)
    check(all(e <= STEP_RTOL * m + 1e-7 for e, m in errs),
          f"{what}: card vs CPU beyond {STEP_RTOL} relative (largest {rel})")
    return rel


def train_phase(card: str, cfg, device="cuda"):
    """Full-width DLRM training with one clustering transition: 8 steps,
    ``dlrm.cluster_tables`` with dense id counts and the moments remapped,
    4 steps, then serving the trained state.  Returns {path: launches}."""
    import numpy as np
    import torch

    from repro_torch import random as jr
    from repro_torch.core import cce as cce_lib
    from repro_torch.core import hashing
    from repro_torch.core import kmeans as km
    from repro_torch.data.synthetic import ClickstreamConfig, clickstream_batches
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm
    from repro_torch.optim import sgd
    from repro_torch.serve.dlrm import DLRMServeEngine
    from repro_torch.train import loop
    from repro_torch.train.transition import transition_table
    from repro_torch.tree import tree_leaves, tree_map

    coll = cfg.collection
    t0 = time.perf_counter()
    params, buffers = dlrm.init(cfg, torch.Generator().manual_seed(1), device=device)
    engine = DLRMServeEngine(params, buffers, cfg, max_batch=SERVE_BATCH)
    print(f"train init: {time.perf_counter() - t0:.3f} s (with the serve engine)")
    t0 = time.perf_counter()
    stream = clickstream_batches(ClickstreamConfig(vocab_sizes=cfg.vocab_sizes, seed=1),
                                 TRAIN_BATCH)
    raw = [next(stream) for _ in range(TRAIN_STEPS + POST_STEPS)]
    print(f"train data: {len(raw)} batches of {TRAIN_BATCH} in {time.perf_counter() - t0:.3f} s")

    def on(batch, dev):  # one microbatch: leaves (1, B, ...)
        return {k: torch.from_numpy(batch[k][None]).to(dev) for k in ("dense", "sparse", "label")}

    batches = [on(b, device) for b in raw]

    def loss_fn(p, b, mb):
        return dlrm.bce_loss(p, b, cfg, mb), {}

    opt = sgd(momentum=0.9)
    step = loop.make_train_step(loss_fn, opt, lambda s: TRAIN_LR, clip_norm=1.0)
    state = loop.init_state(params, opt, buffers)
    launches = {}

    # the first step on CPU copies of the state, with the plain versions
    cpu_state = loop.TrainState(*(tree_map(lambda t: t.detach().to("cpu", copy=True), x)
                                  for x in (state.params, state.opt, state.ebuf)), step=0)
    cpu_mb = on(raw[0], "cpu")
    loss_dev, g_dev = loop.value_and_grad(loss_fn, state.params, state.ebuf,
                                          tree_map(lambda x: x[0], batches[0]))
    loss_cpu, g_cpu = loop.value_and_grad(loss_fn, cpu_state.params, cpu_state.ebuf,
                                          tree_map(lambda x: x[0], cpu_mb))
    check(abs(loss_dev.item() - loss_cpu.item()) <= 1e-5 * abs(loss_cpu.item()),
          f"first-step loss card {loss_dev.item()} vs CPU {loss_cpu.item()}")
    grad_rel = _check_close(_leaf_errors(g_dev, g_cpu), "first-step gradients")
    del g_dev, g_cpu

    ops.LAUNCHES.clear()
    losses, step_ms = [], []
    for i, mb in enumerate(batches[:TRAIN_STEPS]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, mb)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        if i == 0:
            first_params = tree_map(torch.clone, state.params)
    launches["train"] = dict(ops.LAUNCHES)
    check(launches["train"].get("cce_lookup_fwd") == TRAIN_STEPS
          and launches["train"].get("cce_lookup_bwd") == TRAIN_STEPS,
          f"train steps {TRAIN_STEPS}, launches {launches['train']}")
    check(all(math.isfinite(x) for x in losses), f"non-finite train loss {losses}")
    cpu_state, cpu_m = step(cpu_state, cpu_mb)
    check(abs(cpu_m["loss"].item() - losses[0]) <= 1e-5 * abs(losses[0]),
          f"first step loss card {losses[0]} vs CPU {cpu_m['loss'].item()}")
    param_rel = _check_close(_leaf_errors(first_params, cpu_state.params), "first-step params")
    del cpu_state, first_params
    print(f"[{card}] train: {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, losses {losses!r}; "
          f"launches {launches['train']}; first step vs CPU: loss {loss_cpu.item()!r} vs "
          f"{loss_dev.item()!r}, gradients max rel err {grad_rel!r}, params max rel err "
          f"{param_rel!r}", flush=True)

    # the transition, with dense per-feature id counts from the batches seen
    counts = [np.bincount(np.concatenate([b["sparse"][:, f] for b in raw[:TRAIN_STEPS]]),
                          minlength=v) for f, v in enumerate(cfg.vocab_sizes)]
    cce_feats = [i for i, t in enumerate(coll.tables) if isinstance(t, cce_lib.CCE)]
    want_assign = sum(coll.tables[i].c * -(-coll.tables[i].d1 // cfg.emb_cluster_chunk)
                      for i in cce_feats)
    key = jr.PRNGKey(2)
    phases = [(cce_lib.CCE, "materialize", "sample materialize"),
              (km, "kmeans", "kmeans++/Lloyd"),
              (cce_lib.CCE, "assign_all", "assign_all"),
              (cce_lib.CCE, "remap_moments", "moment remap")]
    ops.LAUNCHES.clear()
    with PhaseClock(phases) as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_p, new_b, new_opt = dlrm.cluster_tables(key, state.params, state.ebuf, cfg, state.opt,
                                                    id_counts=counts)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
    launches["transition"] = dict(ops.LAUNCHES)
    check(launches["transition"].get("kmeans_assign") == want_assign,
          f"kmeans_assign launches {launches['transition']} != {want_assign}")

    # its invariants
    ptr_device = state.params["top"][0]["w"].device
    for i in cce_feats:
        t = coll.tables[i]
        old_b, nb = coll.feature_buffers(state.ebuf["emb"], i), coll.feature_buffers(new_b["emb"], i)
        epoch = int(old_b["epoch"])
        check(int(nb["epoch"]) == epoch + 1, f"feature {i}: epoch {int(nb['epoch'])}")
        _, k2 = jr.split(jr.fold_in(jr.fold_in(key, i), epoch))
        hs = hashing.pack_hashes(hashing.make_hashes(hashing._seed_of(jr.fold_in(k2, 777)),
                                                     t.c, t.k)).astype(np.int64)
        check(np.array_equal(nb["hs"].cpu().numpy(), hs), f"feature {i}: hs off the key schedule")
        check(nb["hs"].dtype == torch.int64 and nb["hs"].device == ptr_device,
              f"feature {i}: hs {nb['hs'].dtype} on {nb['hs'].device}")
        ptr = nb["ptr"]
        check(int(ptr.min()) >= 0 and int(ptr.max()) < t.k, f"feature {i}: ptr outside [0, k)")
        check(not coll.feature_params(new_p["emb"], i)["tables"][:, 1].any(),
              f"feature {i}: helper table not zero")
        check(not coll.feature_params(new_opt["m"]["emb"], i)["tables"][:, 1].any(),
              f"feature {i}: helper moments not zero")
    # bitwise repeatable from the same state and key
    again = dlrm.cluster_tables(key, state.params, state.ebuf, cfg, state.opt, id_counts=counts)
    for a, b, what in ((new_p["emb"], again[0]["emb"], "tables"), (new_b["emb"], again[1]["emb"],
                       "ptr/hs/epoch"), (new_opt["m"]["emb"], again[2]["m"]["emb"], "moments")):
        check(all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b))),
              f"a second transition from the same state differs in {what}")
    del again
    phase_ms = dict(clock.ms)
    other = total_ms - sum(phase_ms.values())
    print(f"[{card}] transition: {len(cce_feats)} CCE features, {total_ms!r} ms host; "
          f"launches {launches['transition']} (expected kmeans_assign {want_assign}); "
          f"invariants hold; a second run from the same state is bitwise equal", flush=True)
    print(f"[{card}] transition host ms by phase: " + ", ".join(
        f"{k} {v!r}" for k, v in phase_ms.items()) + f", other {other!r}", flush=True)

    # device busy by phase: the largest CCE table's transition alone, profiled
    from torch.profiler import ProfilerActivity, profile

    big = max(cce_feats, key=lambda i: coll.tables[i].d1)
    (g,) = [g for g, grp in enumerate(coll.groups) if big in grp.features]
    grp = coll.groups[g]
    f_local = grp.features.index(big)
    per_p = coll.unstack_group_params(grp, state.params["emb"][g])[f_local]
    per_m = coll.unstack_group_params(grp, state.opt["m"]["emb"][g])[f_local]
    per_b = state.ebuf["emb"][g][f_local]
    with PhaseClock(phases) as one, profile(activities=[ProfilerActivity.CPU,
                                                          ProfilerActivity.CUDA]) as prof:
        _, _, upd = transition_table(coll.tables[big], jr.fold_in(key, big), per_p, per_b,
                                     counts=counts[big], chunk_size=cfg.emb_cluster_chunk)
        upd(per_m)
        torch.cuda.synchronize()
    busy = {e.key.split(":", 1)[1]: e.device_time_total / 1e3 for e in prof.key_averages()
            if e.key.startswith("transition:")}
    print(f"[{card}] transition of feature {big} (d1={coll.tables[big].d1}) alone, by phase: "
          + ", ".join(f"{k}: host {v!r} ms, device busy "
                      f"{busy.get(k) if busy.get(k) else 'not measured'!r} ms"
                      for k, v in one.ms.items()), flush=True)
    top = sorted((e for e in prof.key_averages() if not e.key.startswith("transition:")),
                 key=lambda e: e.self_device_time_total, reverse=True)[:8]
    print(f"[{card}] transition of feature {big}, top device time: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3!r} ms x{e.count}" for e in top), flush=True)
    del per_p, per_m, per_b

    state = loop.TrainState(new_p, new_opt, new_b, state.step)
    ops.LAUNCHES.clear()
    post = []
    for mb in batches[TRAIN_STEPS:]:
        state, m = step(state, mb)
        post.append(m["loss"].item())
    launches["train_after_transition"] = dict(ops.LAUNCHES)
    check(launches["train_after_transition"].get("cce_lookup_fwd") == POST_STEPS
          and launches["train_after_transition"].get("cce_lookup_bwd") == POST_STEPS,
          f"post-transition steps {POST_STEPS}, launches {launches['train_after_transition']}")
    check(all(math.isfinite(x) for x in post), f"non-finite loss after the transition {post}")
    print(f"[{card}] train after the transition: losses {post!r}; "
          f"launches {launches['train_after_transition']}", flush=True)

    # one train step's breakdown (host clock, device busy from the profiler)
    mb = batches[-1]
    busy_ms = device_busy_ms(lambda: step(state, mb))
    host_ms = statistics.median(step_ms[1:])
    print(f"[{card}] train step breakdown, batch {TRAIN_BATCH}: host {host_ms!r} ms (median of "
          f"steps 2-{TRAIN_STEPS}; first {step_ms[0]!r} ms), device busy {busy_ms!r} ms "
          f"(idle share {1 - busy_ms / host_ms!r})", flush=True)

    # serving the trained, transitioned state
    engine.update_state(state.params, state.ebuf)
    dense, sparse = raw[-1]["dense"][:SERVE_BATCH], raw[-1]["sparse"][:SERVE_BATCH]
    served = engine.predict(dense, sparse)
    with torch.no_grad():
        fwd = dlrm.forward(state.params, state.ebuf, cfg, {
            "dense": torch.from_numpy(dense).to(device),
            "sparse": torch.from_numpy(sparse).to(device)}).cpu().numpy()
    diff = float(np.abs(fwd - served).max())
    check(bool(np.isfinite(served).all()) and diff <= 1e-5,
          f"served logits after training differ from forward by {diff}")
    print(f"[{card}] serve after train: {len(served)} requests through update_state, "
          f"logits vs forward max_abs_diff={diff!r}", flush=True)
    return launches


def serve_phase(card: str, cfg, n_batches: int, device="cuda") -> int:
    """Serve ``n_batches`` batches of requests through DLRMServeEngine
    (submit/step/drain), with the launch counts reset just before; hold
    the logits against the port's forward.  Returns the lookup kernel's
    launches in that run."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import ClickstreamConfig, clickstream_batches
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm
    from repro_torch.serve.dlrm import DLRMServeEngine, ServeRequest

    t0 = time.perf_counter()
    params, buffers = dlrm.init(cfg, torch.Generator().manual_seed(0), device=device)
    engine = DLRMServeEngine(params, buffers, cfg, max_batch=SERVE_BATCH)
    on_card = torch.cuda.memory_allocated() / 2**20 if device == "cuda" else 0.0
    print(f"init: {sum(cfg.vocab_sizes)} ids, {cfg.n_emb_params()} embedding params, "
          f"{on_card:.1f} MiB on the card, {time.perf_counter() - t0:.3f} s")
    print(f"hot cache: {len(engine.cache.ids)} features, {engine.cache.n_slots} slots")
    t0 = time.perf_counter()
    stream = clickstream_batches(ClickstreamConfig(vocab_sizes=cfg.vocab_sizes), SERVE_BATCH)
    batches = [next(stream) for _ in range(n_batches + 1)]
    print(f"data: {n_batches + 1} batches of {SERVE_BATCH} in {time.perf_counter() - t0:.3f} s")
    warm = batches.pop()
    engine.predict(warm["dense"], warm["sparse"])  # first-call set-up stays out of the run

    ops.LAUNCHES.clear()
    n0 = engine.counters["n_launches"]
    results = []
    t0 = time.perf_counter()
    uid = 0
    for batch in batches:
        for i in range(SERVE_BATCH):
            engine.submit(ServeRequest(uid=uid, dense=batch["dense"][i], sparse=batch["sparse"][i]))
            uid += 1
            results.extend(engine.step())
    results.extend(engine.drain())
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["cce_lookup_fwd"]
    served_launches = engine.counters["n_launches"] - n0
    check(served_launches > 0, "the serve run launched no lookup")
    check(launches == served_launches,
          f"kernel launches {launches} != engine cold launches {served_launches}")
    check(sorted(r.uid for r in results) == list(range(uid)), "not every request was answered once")
    logits = np.array([r.logit for r in sorted(results, key=lambda r: r.uid)], np.float32)
    check(bool(np.isfinite(logits).all()), "non-finite served logits")

    diffs = []
    with torch.no_grad():
        for j, batch in enumerate(batches):
            fwd = dlrm.forward(params, buffers, cfg, {
                "dense": torch.from_numpy(batch["dense"]).to(device),
                "sparse": torch.from_numpy(batch["sparse"]).to(device).long(),
            }).cpu().numpy()
            diffs.append(float(np.abs(fwd - logits[j * SERVE_BATCH:(j + 1) * SERVE_BATCH]).max()))
    check(max(diffs) <= 1e-5, f"served logits differ from forward by {max(diffs)}")
    lat = np.array([r.latency_s for r in results]) * 1e3
    print(f"[{card}] serve: {uid} requests, {engine.counters['n_batches'] - 1} batches, "
          f"{served_launches} cold launches, cce_lookup_fwd launches {launches}, "
          f"{wall:.3f} s wall, {uid / wall:.1f} requests/s")
    print(f"[{card}] serve latency (submit to result, host clock): "
          f"p50={float(np.percentile(lat, 50))!r} ms p99={float(np.percentile(lat, 99))!r} ms")
    print(f"served logits vs forward: max_abs_diff={max(diffs)!r}; "
          f"logit range [{float(logits.min())!r}, {float(logits.max())!r}]")

    # where one full batch's time goes (host clock, device busy from the profiler)
    dense, sparse = batches[0]["dense"], batches[0]["sparse"].astype(np.int64)
    t0 = time.perf_counter()
    _, hit = engine.cache.slots(sparse)
    t1 = time.perf_counter()
    engine.translator.rows_masked(sparse, hit)
    t2 = time.perf_counter()
    engine.predict(dense, sparse)
    if device == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    busy = device_busy_ms(lambda: engine.predict(dense, sparse))
    predict_ms = (t3 - t2) * 1e3
    print(f"[{card}] serve breakdown, one batch of {SERVE_BATCH}: cache.slots "
          f"{(t1 - t0) * 1e3!r} ms, translator.rows_masked {(t2 - t1) * 1e3!r} ms, "
          f"predict {predict_ms!r} ms, device busy {busy!r} ms "
          f"(idle share {1 - busy / predict_ms!r})")
    return launches


KERNELS = {  # name -> (CUDA source, the TPU kernel's pallas_call it replaces)
    "cce_lookup_fwd": ("src/repro_torch/kernels/csrc/cce_lookup.cu",
                       "src/repro/kernels/cce_lookup.py:106"),
    "cce_lookup_bwd": ("src/repro_torch/kernels/csrc/cce_lookup_bwd.cu",
                       "src/repro/kernels/cce_lookup.py:134"),
    "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign.py:67"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 1
    from repro_torch.configs.dlrm_criteo import CONFIG
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t_run = time.perf_counter()
    libs = sorted({pathlib.Path(src).stem for src, _ in KERNELS.values()})
    t0 = time.perf_counter()
    build.build(*libs)
    for lib in libs:
        build.library(lib)
    print(f"[{card}] build: {', '.join(f'{n}.cu' for n in libs)} in parallel, "
          f"{time.perf_counter() - t0:.3f} s")
    for lib in libs:
        for line in build.BUILD_LOGS.get(lib, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib}: {line.strip()}")

    fwd_err, fwd_at = kernel_phase(card, CONFIG.collection)
    bwd_err, bwd_at = bwd_kernel_phase(card, CONFIG.collection)
    assign_excess, assign_at = kmeans_phase(card)
    launches = train_phase(card, CONFIG)
    launches["serve"] = {"cce_lookup_fwd": serve_phase(card, CONFIG, SERVE_BATCHES)}

    def by_path(name):
        return {path: counts.get(name, 0) for path, counts in launches.items()}

    def entry(name, main_paths, err, at, **extra):
        src, replaces = KERNELS[name]
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(launches[p].get(name, 0) for p in main_paths),
                "launches_by_path": by_path(name), "max_abs_err": err, **at, **extra}

    steps = ("train", "train_after_transition")
    kernels = [
        entry("cce_lookup_fwd", steps, fwd_err, fwd_at[TRAIN_BATCH], batch=TRAIN_BATCH,
              at_serve_batch=fwd_at[SERVE_BATCH]),
        entry("cce_lookup_bwd", steps, bwd_err, bwd_at, batch=TRAIN_BATCH),
        entry("kmeans_assign", ("transition",), assign_excess, assign_at,
              shape=list(ASSIGN_SHAPES[0])),
    ]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_run:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
