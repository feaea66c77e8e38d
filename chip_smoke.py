#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (into ``build/repro_torch/``), one nvcc per source, all at once.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the main paths (the lookup and its backward bit for bit, the
   k-means assignment by the tie-tolerant rule, one column a launch, the
   four columns of a table in one, and every chunk shape the transition
   launches) and times kernel, plain
   version and a library call that computes the same function (the
   lookup at the LM's table and at the wide widths with the L2 flushed
   before each call, as a serving caller finds the table).
3. Trains the full-width Criteo DLRM configuration (26 features, 33.7M ids,
   random weights from a seed) for 8 steps at batch 2048, holding the
   first step against the same step on CPU copies of the state; runs one
   CCE clustering transition with the optimizer moments remapped (checked
   for its invariants and for bitwise repeatability); trains 4 more steps;
   then serves the trained state through ``DLRMServeEngine.update_state``.
4. Runs the paper's training loop at that width through
   ``launch.train.build_dlrm_trainer``: a ``Trainer`` with the sketch
   frequency tracker (cell count in the step, host fold on a background
   thread), the entropy/drift trigger beside a periodic fallback,
   telemetry, a run log and async checkpoints, for 48 steps (windows of 8
   batches) with up to 2 transitions.  Holds one step's in-step sketch
   delta against the host cell count; crashes a second run at step 40,
   restores and resumes it, and holds it bit for bit against the first;
   restores the card's last checkpoint into a CPU Trainer; serves a batch
   with the trained tracker's heads in the hot cache.  Then times the
   step against the plain step, and the Trainer's own loop with the fold
   on its thread, on the step's thread and without a tracker.
5. Serves freshly initialised weights through ``DLRMServeEngine``
   (submit/step/drain), the serving path of the first slice.
6. Holds the flash-attention kernel against its plain version (float32
   and bfloat16 at both CTA heights, GQA and plain heads, D 64 and 128,
   ragged lengths, causal and not) and times it beside
   ``scaled_dot_product_attention`` at the LM's prefill buckets.
7. Serves full-width qwen2-1.5b (28 layers, CCE token table and factored
   CCE head, random weights from a seed) through the LM ``ServeEngine``:
   16 requests of 16-1900 prompt tokens over 8 slots, 16 greedy tokens
   each; holds a 2-layer cut's prefill logits against CPU copies.
Each path runs with the launch counts reset just before it and read just
after.  Prints the kernels' JSON line, the card line and, last,
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --phases flash,lm_serve

runs only the named phases (of lookup, bwd, kmeans, train, loop, serve,
flash, lm_serve) and prints neither result line.

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
H100_BF16_FLOPS = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
SERVE_BATCH = 256
SERVE_BATCHES = 4  # host-side id sampling over 10M-row vocabularies costs ~1 s a batch
TRAIN_BATCH = 2048
TRAIN_STEPS = 8  # before the transition
POST_STEPS = 4  # after it
TRAIN_LR = 0.05  # constant, with momentum 0.9 and clip 1.0
LOOP_STEPS = 48  # the loop phase's run, cut in depth
LOOP_WINDOW = 8  # tracker window in batches (the deployment's STREAM has 256)
LOOP_CLUSTER_EVERY = 24  # the periodic fallback beside the trigger
LOOP_CLUSTER_MAX = 2
LOOP_CKPT_EVERY = 16
LOOP_KEEP_LAST = 2
LOOP_FAIL_AT = 40  # the crash run's injected failure
LOOP_SEED = 4
LOOP_TIMED_STEPS = 16  # each unsynchronised Trainer run of the loop's timing
LOOKUP_BATCHES = (1, 7, SERVE_BATCH, TRAIN_BATCH, 4096)
BWD_BATCHES = (256, TRAIN_BATCH, 4096)
LM_DSUB = 384  # the LM token table's sub-row width (qwen2-1.5b: d 1536 over c=4)
# other widths of both lookup kernels: (c, T, k, dsub) -> the layout each
# dtype takes; the first is the LM token table's shape
WIDE_LOOKUP = {
    (4, 2, 4748, LM_DSUB): {"float32": "wide_vector", "bfloat16": "wide_vector"},
    (26, 2, 305, 36): {"float32": "wide_vector", "bfloat16": "wide_scalar"},
    (26, 2, 305, 6): {"float32": "wide_scalar", "bfloat16": "wide_scalar"},
}
WIDE_BATCHES = (1, 8, TRAIN_BATCH)
ASSIGN_SHAPES = ((1 << 18, 250, 4), (64000, 250, 4))  # an assign_all chunk; a Lloyd sample
ASSIGN_BATCHED = (4, 1 << 18, 250, 4)  # (c, n, k, d): an assign_all chunk of a c=4 table
ASSIGN_GENERAL = ((5000, 250, 3), (3000, 40, 16))  # (n, k, d) off the d = 4 kernel
ASSIGN_RTOL = 1e-5  # the plain distance of the kernel's pick vs the plain minimum
STEP_RTOL = 1e-4  # card vs CPU, per leaf, relative to the leaf's largest magnitude
FLASH_HEADS = ((12, 2), (32, 8), (4, 4))  # (H, KVH): qwen2-1.5b, qwen3-4b/14b style, no GQA
FLASH_DIMS = (64, 128)
FLASH_LENGTHS = (1, 7, 127, 128, 129, 1000, 2048)  # Sq = S, causal
FLASH_NONCAUSAL = ((129, 129), (1000, 1000), (129, 300))  # (Sq, S) without the causal mask
FLASH_STRIDED = 129  # the causal case at this length reads q from a (B, H, S, D) layout
FLASH_TIMED = (128, 512, 1024, 2048)  # bf16, qwen2-1.5b's heads: the LM's prefill buckets
# kernel vs plain on unit-normal inputs: float32 sums in another order;
# bfloat16 rounds P to bf16 for the tensor cores and the output once
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# bfloat16, each row's error over that row's scale (flash_row_err): a late causal
# row averages ~1/sqrt(i) and is small against FLASH_TOL, but rounding P to bf16
# leaves every row ~2^-9 of its own scale, at any length; a key masked wrongly on
# late rows gives > 0.1 (tests/test_torch_flash.py emulates both on the CPU)
FLASH_ROW_TOL = 2 ** -6
LM_ARCH = "qwen2-1.5b"
LM_SEED = 0
LM_REQUESTS = 16
LM_MAX_BATCH = 8
LM_MAX_SEQ = 2048
LM_PROMPTS = (16, 1900)  # prompt lengths, uniform: buckets 16..2048
LM_MAX_TOKENS = 16
LM_CHECK_LAYERS = 2  # the depth of the card-vs-CPU prefill check
LM_CHECK_PROMPT = 256
# card vs CPU prefill logits, relative to the largest logit: float32 sums
# in other orders; bfloat16 also rounds every activation (8 mantissa bits)
LM_LOGIT_RTOL = {"float32": 1e-4, "bfloat16": 3e-2}


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


def _profile(fn, iters: int, flush=None):
    """torch.profiler's per-name averages over ``iters`` calls of ``fn``
    (after one warm-up call), each after a call of ``flush`` where one is
    given.  A trace may come back with fewer records than the calls made,
    or with none: the callers take it again over more calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def _device_us(event) -> float:
    return getattr(event, "device_time_total", None) or getattr(event, "cuda_time_total", 0.0)


_L2_BYTES = 128 << 20  # over twice the H100's 50 MB L2
_l2_flush = {}


def l2_flush():
    """(flush, counts): ``flush()`` reads a buffer of _L2_BYTES, so that
    the call after it finds its inputs in HBM, not in the L2, as a caller
    does whose other work streams through the L2 between calls (an LM's
    weights between two prefills).  It sums rows of 4096 floats, one
    kernel with no memset, and writes 32 KB; ``counts`` holds its launches
    a call by kernel name."""
    import torch

    if not _l2_flush:
        buf = torch.ones((_L2_BYTES // 4 // 4096, 4096), device="cuda")

        def flush():
            buf.sum(dim=1)

        counts = {}
        for n_calls in (100, 400, 1600):
            counts = {e.key: round(e.count / n_calls) for e in _profile(flush, n_calls)
                      if _device_us(e) and round(e.count / n_calls)}
            if counts:
                break
        check(bool(counts), "three traces of the L2 flush hold none of its kernels")
        _l2_flush.update(flush=flush, counts=counts)
    return _l2_flush["flush"], _l2_flush["counts"]


# The profiler drops records now and then, up to a few dozen a trace of any
# length (PERF.md section 7), so device_ms and device_busy_ms take traces of
# at least TRACE_RECORDS records, and take one that lacks too many again
# over four times as many calls, at most three times.
TRACE_RECORDS = 400


def device_ms(fn, kernel_name: str, *, iters: int = TRACE_RECORDS,
              cold: bool = False) -> float:
    """Device time a call of ``fn`` spent in the CUDA kernel whose name
    holds ``kernel_name`` (launched once a call), from torch.profiler over
    ``iters`` calls; with ``cold``, every call comes after ``l2_flush``.
    Where the trace lacks launches the time is the mean over those it
    holds, with a line that says so, and one that holds fewer than nine
    tenths is taken again.  Fails where a trace holds more than one a call,
    or none holds nine tenths, so that a renamed kernel cannot lose its
    time without a word."""
    flush = l2_flush()[0] if cold else None
    for attempt in range(4):
        n_calls = iters * 4 ** attempt
        hits = [e for e in _profile(fn, n_calls, flush) if kernel_name in e.key and e.count]
        n = sum(e.count for e in hits)
        us = sum(_device_us(e) for e in hits)
        check(n <= n_calls, f"{n} launches of *{kernel_name}* in {n_calls} calls")
        if n >= n_calls - n_calls // 10 and us > 0:
            if n < n_calls:
                print(f"chip_smoke: the trace holds {n} of {n_calls} launches of "
                      f"*{kernel_name}*; its time is their mean", flush=True)
            return us / 1e3 / n
        print(f"chip_smoke: trace {attempt + 1} holds {n} launches of *{kernel_name}* in "
              f"{n_calls} calls; taken again", flush=True)
    check(False, f"four traces without one launch of *{kernel_name}* a call")


def device_busy_ms(fn, *, iters: int = 5, cold: bool = False) -> float:
    """Device time of every CUDA kernel and copy that a call of ``fn``
    runs, from torch.profiler over at least ``iters`` (and 5) calls, as
    many more as TRACE_RECORDS needs; with ``cold``, every call comes after
    ``l2_flush``, whose kernels are not counted.  Each kernel counts as its
    mean time a record times its launches a call, the trace's count over
    the calls rounded; a line says when the trace lacks records, and one
    that lacks more than a tenth is taken again, over more calls where the
    trace took less than a second."""
    flush, flushed = l2_flush() if cold else (None, {})
    n_calls = max(iters, 5)
    for attempt in range(5):
        us = lost = want = 0
        t0 = time.perf_counter()
        for e in _profile(fn, n_calls, flush):
            check(e.count <= flushed.get(e.key, 1 << 60) * n_calls,
                  f"the call launches {e.key[:80]}, a kernel of the L2 flush")
            per_call = round(e.count / n_calls)
            if e.key not in flushed and per_call and _device_us(e):
                us += _device_us(e) / e.count * per_call
                lost += max(0, per_call * n_calls - e.count)
                want += per_call * n_calls
        if want >= TRACE_RECORDS and lost <= want // 10:
            if lost:
                print(f"chip_smoke: the trace lacks {lost} of {want} records; each kernel's "
                      f"time is its mean over those it holds", flush=True)
            return us / 1e3
        if lost or not want:
            print(f"chip_smoke: a trace of {n_calls} calls lacks {lost} of {want} records"
                  f"{'' if want else ' (it holds no device activity)'}; taken again", flush=True)
        if time.perf_counter() - t0 < 1.0:  # a second or more of calls: take as many again
            n_calls = max(4 * n_calls, -(-TRACE_RECORDS * n_calls // want) if want else 0)
    check(False, "five traces without nine tenths of their records")


def cl_path(t) -> str:
    """The layout both lookup kernels take for rows along the last dim of
    ``t`` (a table or an upstream gradient) at its address."""
    from repro_torch.kernels import cce_lookup as cl

    return cl.lookup_path(t.shape[-1], t.element_size(), t.data_ptr())


def lookup_kernel(entry: str, t) -> str:
    """The CUDA function that ``entry`` launches for the float tensor
    ``t`` (outputs are fresh allocations, so aligned)."""
    return f"{entry}_{cl_path(t)}_kernel"


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


def random_lookup(c: int, T: int, k: int, dsub: int, B: int, dtype, seed: int, device="cuda",
                  offset: int = 0):
    """idx and tables of one shape, in the serving layout (the (c, B, T)
    view of (B, c, T) rows) with 10% -1 sentinels and 5% rows at or past
    k; ``offset`` > 0 starts the tables that many elements into their
    storage, so that they are not aligned."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    rows = rng.integers(0, k, (B, c, T)).astype(np.int32)
    u = rng.random((B, c, T))
    rows[u < 0.10] = -1
    rows[(u >= 0.10) & (u < 0.15)] = k + 7
    n = c * T * k * dsub
    flat = torch.from_numpy(rng.normal(size=n + offset).astype(np.float32))
    tables = flat.to(device=device, dtype=dtype)[offset:].view(c, T, k, dsub)
    return torch.from_numpy(rows).to(device).movedim(0, 1), tables


def wide_lookup_cases(card: str, device="cuda") -> float:
    """The lookup at widths other than the Criteo supertable's dsub=4: the
    LM token table's 384, and 36 and 6, at B in WIDE_BATCHES, on strided
    idx; float32 bit for bit, bfloat16 within one bf16 step; each takes
    the layout ``lookup_path`` names for it, and an unaligned table takes
    wide_scalar.  Times the largest batch with the L2 flushed before each
    call, beside ``embedding_bag`` (float32), flushed the same way.
    Returns the largest float32 error."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ref

    max_err = 0.0
    for (c, T, k, dsub), paths in WIDE_LOOKUP.items():
        for dtype, offset in ((torch.float32, 0), (torch.bfloat16, 0), (torch.float32, 1)):
            dn = str(dtype).split(".")[-1]
            path = paths[dn] if not offset else "wide_scalar"
            for B in WIDE_BATCHES:
                idx, tables = random_lookup(c, T, k, dsub, B, dtype, seed=dsub * 10 + B,
                                            device=device, offset=offset)
                check(cl_path(tables) == path,
                      f"dsub={dsub} {dn} offset {offset} does not take {path}")
                got = cl.cce_lookup_fwd(idx, tables)
                want = ref.cce_lookup_ref(idx, tables)
                err = (got.float() - want.float()).abs().max().item()
                if dtype == torch.float32:
                    check(torch.equal(got, want),
                          f"f32 kernel != plain at dsub={dsub} B={B} {path} (max err {err})")
                    max_err = max(max_err, err)
                else:
                    check(torch.allclose(got.float(), want.float(), rtol=2**-7, atol=0.0),
                          f"bf16 kernel vs plain beyond 2^-7 relative at dsub={dsub} B={B}")
            dev = device_ms(lambda: cl.cce_lookup_fwd(idx, tables),
                            lookup_kernel("cce_lookup_fwd", tables), cold=True)
            bound, bound_by = lookup_bound(idx, tables)
            line = (f"[{card}] cce_lookup_fwd c={c} T={T} k={k} dsub={dsub} {dn} {path}: equal to "
                    f"plain at B={WIDE_BATCHES}; B={B} L2 flushed: device_ms={dev!r} "
                    f"bound_ms={bound!r} ({bound_by})")
            if dtype == torch.float32:
                bag, weight, offsets = embedding_bag_args(idx, tables)
                lib_dev = device_busy_ms(
                    lambda: F.embedding_bag(bag, weight, offsets, mode="sum"), iters=20, cold=True)
                line += f" library_device_ms(embedding_bag)={lib_dev!r}"
            print(line, flush=True)
    return max_err


def kernel_phase(card: str, collection, device="cuda"):
    """The lookup kernel against its plain version at the supertable's
    shape, with its times, then at other widths (``wide_lookup_cases``).
    Returns (max float32 error, {batch: numbers} at the serve and the train
    batch)."""
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
            dev = device_ms(lambda: cl.cce_lookup_fwd(idx, tables),
                            lookup_kernel("cce_lookup_fwd", tables))
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
    max_err = max(max_err, wide_lookup_cases(card, device=device))
    return max_err, at


def column_ks(collection) -> list[int]:
    """The real codebook size of every supertable column (its feature's k;
    rows from there to k_pad are padding)."""
    return [collection.tables[f].fuse_spec.k for f in collection.rows_col_feature]


def bwd_case(collection, B: int, dtype, seed: int, device="cuda"):
    """idx with uniform rows (the (c, B, T) view of rows drawn below each
    column's real k, the second slot of full-table columns -1, 10% more -1
    sentinels) and a random upstream gradient."""
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


def bwd_train_case(cfg, B: int, seed: int, device="cuda"):
    """idx as the train step gives it to the backward: the rows
    ``EmbeddingCollection.group_rows`` makes on fresh buffers from one
    synthetic clickstream batch (Zipf 1.1 ids), and a random float32
    upstream gradient."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import ClickstreamConfig, clickstream_batches

    coll = cfg.collection
    (g,) = coll.univ_groups
    grp = coll.groups[g]
    _, buffers = coll.init(torch.Generator().manual_seed(seed), device)
    batch = next(clickstream_batches(ClickstreamConfig(vocab_sizes=cfg.vocab_sizes, seed=seed), B))
    ids = torch.from_numpy(batch["sparse"]).to(device)[:, list(grp.features)]
    idx = coll.group_rows(grp, buffers[g], ids)
    del buffers
    rng = np.random.default_rng(seed)
    dout = torch.from_numpy(rng.normal(size=(B, grp.n_cols, grp.dsub)).astype(np.float32))
    return idx, dout.to(device)


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


def hottest_share(idx, k: int) -> float:
    """The largest share of the batch that one row of one (column,
    sub-table) holds."""
    import torch

    c, B, T = idx.shape
    r = idx.to(torch.int64)
    valid = (r >= 0) & (r < k)
    key = ((torch.arange(c, device=r.device)[:, None, None] * T
            + torch.arange(T, device=r.device)[None, None, :]) * k + r)[valid]
    return torch.bincount(key).max().item() / B if key.numel() else 0.0


def bwd_check(card: str, label: str, idx, dout, k: int, ks=None, *, timed=True):
    """The backward kernel on one input against its plain version: equal
    bit for bit (both sum each row in float32 in increasing b and round
    once), equal to itself across calls, exactly zero on rows no index
    names and on padding rows past a column's real k (``ks``).  With
    ``timed``, prints and returns its numbers beside its bound, its plain
    version's and (float32) ``zeros``+``index_add_``'s.  Returns (max
    error, numbers or None)."""
    import torch

    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ref

    device = idx.device
    c, B, T = idx.shape
    dsub = dout.shape[2]
    got = cl.cce_lookup_bwd(idx, dout, k)
    again = cl.cce_lookup_bwd(idx, dout, k)
    want = ref.cce_lookup_bwd_ref(idx, dout, k)
    err = (got.float() - want.float()).abs().max().item()
    check(torch.equal(got, want), f"bwd kernel != plain on {label} (max err {err})")
    check(torch.equal(got, again), f"bwd kernel not repeatable on {label}")
    named = torch.zeros((c, T, k), dtype=torch.bool, device=device)
    r = idx.to(torch.int64)
    valid = (r >= 0) & (r < k)
    cc, _, tt = torch.nonzero(valid, as_tuple=True)
    named[cc, tt, r[valid]] = True
    check(not got[~named].any(), f"bwd kernel wrote a row no index names on {label}")
    if ks is not None:
        pad = torch.arange(k, device=device)[None, None, :] >= ks[:, None, None]
        check(not got[pad.expand(c, T, k)].any(), f"bwd padding rows not zero on {label}")
    hot = hottest_share(idx, k)
    if not timed:
        print(f"[{card}] cce_lookup_bwd {label}: equal to plain, repeatable, zero on unnamed "
              f"rows; hottest row {hot!r} of the batch", flush=True)
        return err, None
    ms = time_ms(lambda: cl.cce_lookup_bwd(idx, dout, k))
    plain = time_ms(lambda: ref.cce_lookup_bwd_ref(idx, dout, k), iters=3, reps=3, warmup=1)
    dev = device_ms(lambda: cl.cce_lookup_bwd(idx, dout, k),
                    lookup_kernel("cce_lookup_bwd", dout))
    plain_dev = device_busy_ms(lambda: ref.cce_lookup_bwd_ref(idx, dout, k))
    bound, bound_by = bwd_bound(idx, dout, k)
    line = (f"[{card}] cce_lookup_bwd {label}: max_abs_err={err!r} repeatable=True "
            f"zero_unnamed_rows=True hottest_row_share={hot!r} ms={ms!r} device_ms={dev!r} "
            f"plain_ms={plain!r} plain_device_ms={plain_dev!r} bound_ms={bound!r} ({bound_by})")
    lib = lib_dev = None
    if dout.dtype == torch.float32:
        dest, rows = index_add_args(idx, dout, k)
        flat = (c * T * k, dsub)

        def call():
            return torch.zeros(flat, device=device).index_add_(0, dest, rows)

        # atomics add a hot row's hundreds of terms in another order
        lib_err = (call().reshape(got.shape) - got).abs().max().item()
        check(lib_err <= 1e-5 * got.abs().max().item(),
              f"index_add_ yardstick computes another function on {label} ({lib_err})")
        lib = time_ms(call)
        lib_dev = device_busy_ms(call, iters=20)
        line += f" library_ms(zeros+index_add_)={lib!r} library_device_ms={lib_dev!r}"
    print(line, flush=True)
    return err, dict(ms=ms, device_ms=dev, plain_ms=plain, plain_device_ms=plain_dev,
                     bound_ms=bound, bound_by=bound_by, library_ms=lib,
                     library_device_ms=lib_dev, hottest_row_share=hot)


def bwd_kernel_phase(card: str, cfg, device="cuda"):
    """The backward kernel against its plain version (``bwd_check``) at the
    supertable's shape on uniform rows at BWD_BATCHES, on the rows a real
    train batch gives (Zipf ids through ``group_rows``), on every valid
    index of a column naming one row, on an unaligned dout (wide_scalar),
    then at the wide widths of WIDE_LOOKUP.  Returns (max error, numbers at
    the train batch: uniform ids at the top level, the skewed, the one-row
    and the LM-shape cases under their own keys)."""
    import torch

    collection = cfg.collection
    (g,) = collection.univ_groups
    k = collection.groups[g].k_pad
    ks = torch.tensor(column_ks(collection), device=device)
    max_err, at = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for B in BWD_BATCHES:
            idx, dout = bwd_case(collection, B, dtype, seed=100 + B, device=device)
            err, nums = bwd_check(card, f"{dn} B={B}", idx, dout, k, ks)
            max_err = max(max_err, err)
            if dtype == torch.float32 and B == TRAIN_BATCH:
                at.update(nums)
                uniform = idx
    idx, dout = bwd_train_case(cfg, TRAIN_BATCH, seed=3, device=device)
    err, at["at_skewed_train_batch"] = bwd_check(
        card, f"float32 B={TRAIN_BATCH} skewed (a train batch's rows)", idx, dout, k, ks)
    max_err = max(max_err, err)
    valid = (uniform >= 0) & (uniform < ks[:, None, None])
    one_row = torch.where(valid, (ks - 1).to(torch.int32)[:, None, None], uniform)
    err, at["at_one_row"] = bwd_check(
        card, f"float32 B={TRAIN_BATCH} one row a column", one_row, dout, k, ks)
    max_err = max(max_err, err)
    flat = torch.empty(dout.numel() + 1, device=device)[1:]
    odd = flat.view(dout.shape).copy_(dout)
    check(cl_path(odd) == "wide_scalar", "an unaligned dout does not take wide_scalar")
    err, _ = bwd_check(card, f"float32 B={TRAIN_BATCH} unaligned dout", uniform, odd, k, ks,
                       timed=False)
    max_err = max(max_err, err)
    for (c, T, kw, dsub), paths in WIDE_LOOKUP.items():
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            idx, _ = random_lookup(c, T, kw, dsub, TRAIN_BATCH, torch.float32, seed=dsub,
                                   device=device)
            gen = torch.Generator(device=device).manual_seed(dsub)
            dout = torch.randn((TRAIN_BATCH, c, dsub), generator=gen, device=device).to(dtype)
            check(cl_path(dout) == paths[dn], f"dsub={dsub} {dn} dout does not take {paths[dn]}")
            label = f"{dn} B={TRAIN_BATCH} c={c} T={T} k={kw} dsub={dsub} {paths[dn]}"
            err, nums = bwd_check(card, label, idx, dout, kw, timed=dtype == torch.float32)
            if dtype == torch.float32:
                max_err = max(max_err, err)
                if dsub == LM_DSUB:
                    at["at_lm_shape"] = nums
    return max_err, at


def assign_bound(n: int, k: int, d: int, c: int = 1):
    """Least time for the assignment of c columns on an H100: x, the
    centroids and the output moved once, against c*n*k*(d+1) float32 FMAs
    (2 operations each) at the data-sheet rate.  Returns (ms, "bytes" |
    "operations")."""
    n_bytes = c * ((n * d + k * d) * 4 + n * 4)
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, 2 * c * n * k * (d + 1) / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_registers(log: str) -> dict:
    """{function: (registers, spill store bytes)} from an ``nvcc -Xptxas -v``
    log."""
    import re

    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            out[fn] = (out.get(fn, (None, 0))[0], int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = (int(m.group(1)), out.get(fn, (None, 0))[1])
    return out


def assign_excess(got, x, cent):
    """Per point, how far the plain distance of the kernel's pick lies
    above the plain minimum, checked against ASSIGN_RTOL*(|min|+1)
    (float32 sums in another order may swap near ties); x (n, d), cent
    (k, d).  Returns the largest excess."""
    dist = (cent * cent).sum(-1)[None, :] - 2.0 * (x @ cent.T)
    best = dist.min(1).values
    excess = dist.gather(1, got.long()[:, None])[:, 0] - best
    check(bool((excess <= ASSIGN_RTOL * (best.abs() + 1)).all()),
          f"kmeans_assign picks beyond tolerance at n={x.shape[0]} k={cent.shape[0]} "
          f"(max excess {excess.max().item()})")
    return excess.max().item()


def assign_chunk_shapes(cfg) -> list[tuple[int, int, int, int]]:
    """Every distinct (c, n, k, d) launch of the transition's
    ``CCE.assign_all`` over cfg's CCE tables: each table's full chunks and
    its last, ragged one, as ``CCE._id_chunks`` cuts them."""
    from repro_torch.core import cce as cce_lib

    shapes = set()
    for t in cfg.collection.tables:
        if isinstance(t, cce_lib.CCE):
            ch = cfg.emb_cluster_chunk
            step = ch if ch and ch < t.d1 else t.d1
            shapes.update((t.c, min(step, t.d1 - s), t.k, t.dsub) for s in range(0, t.d1, step))
    return sorted(shapes)


def check_batched_assign(c, n, k, d, device):
    """One batched launch over random (c, n, d) points and (c, k, d)
    centroids into columns [5, 5 + n) of a (c, n + 9) table, as
    ``CCE.assign_all`` writes a chunk: nothing outside the slice written,
    every pick within ASSIGN_RTOL of the plain minimum (column by column),
    and a second launch, into a new array, bit for bit.  Returns (x,
    centroids, the table, picks, max excess, agreement with
    ``ref.kmeans_assign_batched_ref``)."""
    import torch

    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import ref

    g = torch.Generator(device=device).manual_seed(n)
    x = torch.randn((c, n, d), generator=g, device=device)
    cent = torch.randn((c, k, d), generator=g, device=device)
    table = torch.full((c, n + 9), -1, dtype=torch.int32, device=device)
    got = ka.kmeans_assign(x, cent, out=table[:, 5:5 + n]).clone()
    check(bool((table[:, :5] == -1).all() and (table[:, 5 + n:] == -1).all()),
          f"the batched kernel wrote outside its slice at c={c} n={n}")
    excess = max(assign_excess(got[i], x[i], cent[i]) for i in range(c))
    check(torch.equal(ka.kmeans_assign(x, cent), got), f"a second launch differs at c={c} n={n}")
    agree = (got == ref.kmeans_assign_batched_ref(x, cent)).float().mean().item()
    return x, cent, table, got, excess, agree


def kmeans_phase(card: str, cfg, device="cuda"):
    """The assignment kernel against its plain version at an assign_all
    chunk and at a Lloyd-sample shape (one column), at the chunk of a c=4
    table in one launch (ASSIGN_BATCHED, written into a strided slice of a
    pointer table, as ``CCE.assign_all`` does), at every other chunk shape
    the transition over cfg's tables launches (``assign_chunk_shapes``:
    each template instance and each table's ragged last chunk) and,
    through the general kernel, at d 3 and 16: for every point the plain
    distance of the kernel's pick is within ASSIGN_RTOL*(|min|+1) of the
    plain minimum, and a second launch gives the same picks bit for bit.
    Times each d = 4 shape of ASSIGN_SHAPES and ASSIGN_BATCHED beside
    ``cdist``+``argmin``.  Returns (max excess, numbers at the chunk shape,
    with the others under ``at_lloyd_sample`` and ``batched``)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import ref

    sm = torch.cuda.get_device_properties(device).multi_processor_count if device == "cuda" else 132
    regs = {fn: r for fn, r in ptxas_registers(build.BUILD_LOGS.get("kmeans_assign", "")).items()
            if "kmeans_assign" in fn}
    max_excess, at = 0.0, []
    for c, n, k, d in [(None, n, k, d) for n, k, d in ASSIGN_SHAPES] + [ASSIGN_BATCHED]:
        if c is None:
            g = torch.Generator(device=device).manual_seed(n)
            x = torch.randn((n, d), generator=g, device=device)
            cent = torch.randn((k, d), generator=g, device=device)
            got = ka.kmeans_assign(x, cent)
            excess = assign_excess(got, x, cent)
            check(torch.equal(ka.kmeans_assign(x, cent), got), f"a second launch differs at n={n}")
            agree = (got == ref.kmeans_assign_ref(x, cent)).float().mean().item()
            run = (lambda: ka.kmeans_assign(x, cent))
            plain_fn = (lambda: ref.kmeans_assign_ref(x, cent))
        else:
            x, cent, table, got, excess, agree = check_batched_assign(c, n, k, d, device)
            run = (lambda: ka.kmeans_assign(x, cent, out=table[:, 5:5 + n]))
            plain_fn = (lambda: ref.kmeans_assign_batched_ref(x, cent))
        max_excess = max(max_excess, excess)
        ms = time_ms(run)
        plain = time_ms(plain_fn, iters=50)
        dev = device_ms(run, "kmeans_assign_kernel")
        plain_dev = device_busy_ms(plain_fn, iters=10)

        def library():
            return torch.cdist(x, cent).argmin(-1)

        lib_agree = (library() == got.long()).float().mean().item()
        lib = time_ms(library, iters=50)
        lib_dev = device_busy_ms(library, iters=10)
        bound, bound_by = assign_bound(n, k, d, c or 1)
        p, threads = ka.assign_geometry(n, c or 1, k, d, sm)
        reg = next((r for fn, r in regs.items() if f"kmeans_assign_kernelILi{p}E" in fn),
                   "not measured")
        print(f"[{card}] kmeans_assign c={c or 1} n={n} k={k} d={d}: max_excess={excess!r} "
              f"agree_with_plain={agree!r} agree_with_cdist={lib_agree!r}; repeats bit for bit; "
              f"ms={ms!r} device_ms={dev!r} plain_ms={plain!r} plain_device_ms={plain_dev!r} "
              f"library_ms(cdist+argmin, two calls)={lib!r} library_device_ms={lib_dev!r} "
              f"bound_ms={bound!r} ({bound_by}), share of bound {bound / dev!r}; points a "
              f"thread {p}, threads a CTA {threads}, (registers, spill bytes) {reg}", flush=True)
        at.append(dict(c=c or 1, n=n, k=k, d=d, agree_with_plain=agree, ms=ms, device_ms=dev,
                       plain_ms=plain, plain_device_ms=plain_dev, bound_ms=bound,
                       bound_by=bound_by, library_ms=lib, library_device_ms=lib_dev,
                       points_per_thread=p, threads=threads))
    for n, k, d in ASSIGN_GENERAL:  # the general kernel, one point a thread
        g = torch.Generator(device=device).manual_seed(n)
        x = torch.randn((2, n, d), generator=g, device=device)
        cent = torch.randn((2, k, d), generator=g, device=device)
        got = ka.kmeans_assign(x, cent)
        excess = max(assign_excess(got[i], x[i], cent[i]) for i in range(2))
        check(torch.equal(ka.kmeans_assign(x, cent), got), f"a second launch differs at d={d}")
        max_excess = max(max_excess, excess)
        print(f"[{card}] kmeans_assign (general kernel) c=2 n={n} k={k} d={d}: "
              f"max_excess={excess!r}; repeats bit for bit", flush=True)
    main_path = assign_chunk_shapes(cfg)
    geometries = collections.Counter()
    for c, n, k, d in main_path:  # what the transition launches, held as above
        *_, excess, agree = check_batched_assign(c, n, k, d, device)
        max_excess = max(max_excess, excess)
        geometries[ka.assign_geometry(n, c, k, d, sm)] += 1
        print(f"[{card}] kmeans_assign (transition chunk) c={c} n={n} k={k} d={d}: "
              f"max_excess={excess!r} agree_with_plain={agree!r}; repeats bit for bit; "
              f"(points a thread, threads a CTA) {ka.assign_geometry(n, c, k, d, sm)}", flush=True)
    print(f"[{card}] kmeans_assign: all {len(main_path)} chunk shapes of the transition held; "
          f"launch geometries {dict(geometries)}", flush=True)
    chunk, lloyd, batched = at
    return max_excess, dict(chunk, at_lloyd_sample=lloyd, batched=batched,
                            transition_chunk_shapes_held=len(main_path))


class PhaseClock:
    """Host ms of the transition by phase: wraps the functions that make up
    the phases so that each top-level call (not one nested in another
    phase) is timed between two synchronisations."""

    def __init__(self, targets):
        self.ms = collections.Counter()
        self.calls = collections.Counter()
        self._targets = targets  # (owner, attribute, phase)
        self._saved = []
        self._depth = 0

    def _measure(self, phase, call):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return call()
        finally:
            torch.cuda.synchronize()
            self.ms[phase] += (time.perf_counter() - t0) * 1e3

    def __enter__(self):
        for owner, name, phase in self._targets:
            orig = getattr(owner, name)

            def wrapped(*args, _orig=orig, _phase=phase, **kw):
                if self._depth:
                    return _orig(*args, **kw)
                self._depth += 1
                self.calls[_phase] += 1
                try:
                    return self._measure(_phase, lambda: _orig(*args, **kw))
                finally:
                    self._depth -= 1

            self._saved.append((owner, name, orig))
            setattr(owner, name, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()


class PhaseBusy(PhaseClock):
    """Device busy of the transition by phase: each top-level call of a
    phase runs under its own torch.profiler trace of the card, and the
    device time of every kernel and copy in it adds up in ``ms``."""

    def _measure(self, phase, call):
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = call()
            torch.cuda.synchronize()
        self.ms[phase] += sum(_device_us(e) for e in prof.key_averages()) / 1e3
        return out


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
    # one launch a chunk, for all c columns of a table
    want_assign = sum(-(-coll.tables[i].d1 // cfg.emb_cluster_chunk) for i in cce_feats)
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
    # bitwise repeatable from the same state and key; this run also takes
    # the device busy of assign_all (each of its calls profiled; the other
    # phases' busy comes from feature 2 alone, below)
    with PhaseBusy([ph for ph in phases if ph[2] == "assign_all"]) as busy:
        again = dlrm.cluster_tables(key, state.params, state.ebuf, cfg, state.opt,
                                    id_counts=counts)
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
    print(f"[{card}] transition by phase: " + ", ".join(
        f"{k}: host {v!r} ms" + (f", device busy {busy.ms[k]!r} ms" if k in busy.ms else "")
        for k, v in phase_ms.items())
        + f"; other host {other!r} ms (host: the first run; device busy: the second, "
        f"each assign_all call profiled)", flush=True)

    # device busy by phase: the largest CCE table's transition alone, profiled
    from torch.profiler import ProfilerActivity, profile

    big = max(cce_feats, key=lambda i: coll.tables[i].d1)
    (g,) = [g for g, grp in enumerate(coll.groups) if big in grp.features]
    grp = coll.groups[g]
    f_local = grp.features.index(big)
    per_p = coll.unstack_group_params(grp, state.params["emb"][g])[f_local]
    per_m = coll.unstack_group_params(grp, state.opt["m"]["emb"][g])[f_local]
    per_b = state.ebuf["emb"][g][f_local]

    def feature_transition():
        _, _, upd = transition_table(coll.tables[big], jr.fold_in(key, big), per_p, per_b,
                                     counts=counts[big], chunk_size=cfg.emb_cluster_chunk)
        upd(per_m)
        torch.cuda.synchronize()

    with PhaseClock(phases) as one, profile(activities=[ProfilerActivity.CPU,
                                                          ProfilerActivity.CUDA]) as prof:
        feature_transition()
    with PhaseBusy(phases) as one_busy:
        feature_transition()
    print(f"[{card}] transition of feature {big} (d1={coll.tables[big].d1}) alone, by phase: "
          + ", ".join(f"{k}: host {v!r} ms, device busy {one_busy.ms[k]!r} ms"
                      for k, v in one.ms.items()) + " (host: profiled for the top list below; "
          "device busy: a second run, each call of a phase profiled)", flush=True)
    top = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)[:8]
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


def _host_cells(tracker, sparse):
    """The tracker's sketch cells of one batch, counted on the host with
    ``CountMinSketch.cells``: (F_tracked, depth, width) int32."""
    import numpy as np

    cms0 = tracker.features[tracker.tracked[0]].cms
    out = np.zeros((len(tracker.tracked), cms0.depth, cms0.width), np.int32)
    for j, f in enumerate(tracker.tracked):
        cells = tracker.features[f].cms.cells(sparse[:, f])
        for r in range(cells.shape[0]):
            np.add.at(out[j, r], cells[r], 1)
    return out


def loop_phase(card: str, cfg, device="cuda"):
    """The paper's training loop at full width, through
    ``launch.train.build_dlrm_trainer``: a Trainer with the sketch tracker
    (cell count in the step, async host fold), the entropy/drift trigger
    and the periodic fallback, telemetry, a run log and async checkpoints.
    One run of LOOP_STEPS steps; a second run crashes at LOOP_FAIL_AT,
    restores the latest checkpoint and resumes, and must end bit for bit
    where the first ended; the last checkpoint restores into a CPU
    Trainer; the trained tracker's heads feed a served batch.  Then the
    timings: the step against the plain step, synchronised, and the
    Trainer's loop unsynchronised three ways.  Returns {"loop": launches}."""
    import argparse
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import list_checkpoints
    from repro_torch.configs.dlrm_criteo import STREAM
    from repro_torch.core import cce as cce_lib
    from repro_torch.core import kmeans as km
    from repro_torch.data.synthetic import ClickstreamConfig, clickstream_batches
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.models import dlrm
    from repro_torch.obs.pump import MetricsPump
    from repro_torch.obs.runlog import read_runlog
    from repro_torch.optim import sgd
    from repro_torch.serve.dlrm import DLRMServeEngine
    from repro_torch.stream.trigger import ClusterTrigger
    from repro_torch.train import loop
    from repro_torch.train import transition as trans_mod
    from repro_torch.tree import jax_leaves, jax_leaves_with_paths

    coll = cfg.collection
    cce_feats = [i for i, t in enumerate(coll.tables) if isinstance(t, cce_lib.CCE)]
    assign_per_transition = sum(-(-coll.tables[i].d1 // cfg.emb_cluster_chunk)
                                for i in cce_feats)
    t0 = time.perf_counter()
    stream = clickstream_batches(ClickstreamConfig(vocab_sizes=cfg.vocab_sizes, seed=LOOP_SEED),
                                 TRAIN_BATCH)
    raw = [next(stream) for _ in range(LOOP_STEPS)]  # made once, replayed from any step
    print(f"loop data: {len(raw)} batches of {TRAIN_BATCH} in {time.perf_counter() - t0:.3f} s",
          flush=True)

    def data_from(start):
        return iter(raw[start:])

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_loop_"))
    stream_cfg = dataclasses.replace(STREAM, window=LOOP_WINDOW)

    def build(tag, fail_at=(), dev=device, ckpt_dir=None, obs=True):
        args = argparse.Namespace(
            device=dev, seed=LOOP_SEED, momentum=0.9, lr=TRAIN_LR, clip=1.0, accum=1,
            emb="cce", batch=TRAIN_BATCH, ckpt_dir=ckpt_dir or str(tmp / tag / "ckpt"),
            ckpt_every=LOOP_CKPT_EVERY, keep_last=LOOP_KEEP_LAST,
            cluster_every=LOOP_CLUSTER_EVERY, cluster_max=LOOP_CLUSTER_MAX,
            fail_at=list(fail_at), obs=str(tmp / tag / "run.jsonl") if obs else None)
        if obs:
            (tmp / tag).mkdir(parents=True, exist_ok=True)
        t = time.perf_counter()
        trainer = launch.build_dlrm_trainer(
            cfg, args, stream=stream_cfg, data_from=data_from,
            trigger=ClusterTrigger(entropy_drop=0.1, drift_threshold=0.25, warmup=2))
        print(f"loop: {tag} Trainer built on {dev} in {time.perf_counter() - t:.3f} s", flush=True)
        return trainer

    phases = [(trans_mod, "_draw_points", "sketch points"),
              (trans_mod, "_dense_weights", "sketch id_weights"),
              (cce_lib.CCE, "materialize", "sample materialize"),
              (km, "kmeans", "kmeans++/Lloyd"),
              (cce_lib.CCE, "assign_all", "assign_all"),
              (cce_lib.CCE, "remap_moments", "moment remap")]
    try:
        # the uninterrupted run; its first step's in-step delta kept aside
        clean = build("clean")
        tracker = clean.id_tracker
        seen, observe_ms = {}, []
        orig_observe = tracker.observe

        def observe(batch, *, delta=None):
            if "delta" not in seen:
                seen.update(delta=delta.clone(), sparse=np.asarray(batch["sparse"]).copy())
            t = time.perf_counter()
            orig_observe(batch, delta=delta)
            observe_ms.append((time.perf_counter() - t) * 1e3)

        tracker.observe = observe
        ops.LAUNCHES.clear()
        t0 = time.perf_counter()
        with PhaseClock([(loop.Trainer, "_transition", "transition")]) as whole, \
                PhaseClock(phases) as by_phase:
            clean.run(LOOP_STEPS)
        torch.cuda.synchronize()
        clean_s = time.perf_counter() - t0
        launches_clean = dict(ops.LAUNCHES)
        n_trans = whole.calls["transition"]
        check(clean.state.step == LOOP_STEPS and clean.clusters_done == n_trans >= 1,
              f"clean run: step {clean.state.step}, clusters {clean.clusters_done}, "
              f"transitions {n_trans}")
        check(launches_clean.get("cce_lookup_fwd") == LOOP_STEPS
              and launches_clean.get("cce_lookup_bwd") == LOOP_STEPS
              and launches_clean.get("kmeans_assign") == assign_per_transition * n_trans,
              f"clean run launches {launches_clean}: {LOOP_STEPS} steps, {n_trans} transitions "
              f"of {assign_per_transition} assignment launches")
        losses = {h["step"]: h["loss"] for h in clean.history}
        check(sorted(losses) == list(range(LOOP_STEPS))
              and all(math.isfinite(x) for x in losses.values()), f"clean losses {losses}")
        trig = [e.as_dict() for e in clean.trigger.events]
        print(f"[{card}] loop: {LOOP_STEPS} steps at batch {TRAIN_BATCH} in {clean_s:.3f} s, "
              f"{n_trans} transitions (steps {[r['step'] for r in read_runlog(clean.runlog.path) if r['event'] == 'transition']}), "
              f"launches {launches_clean}; losses first {losses[0]!r} last "
              f"{losses[LOOP_STEPS - 1]!r}; trigger {[(e['step'], round(e['entropy'], 4), round(e['drift'], 4), e['reason'] or 'held') for e in trig]}",
              flush=True)

        # check 2: the in-step delta of step 0 == the host cells of its batch
        want = _host_cells(tracker, seen["sparse"])
        got = seen["delta"].cpu().numpy()
        check(got.dtype == np.int32 and got.shape == want.shape and np.array_equal(got, want),
              f"step 0's in-step sketch delta differs from the host cells "
              f"({int(np.abs(got.astype(np.int64) - want).sum())} counts off)")
        print(f"[{card}] loop: step 0's in-step sketch delta {got.shape} equals the host "
              f"CountMinSketch.cells count of its batch bit for bit ({int(got.sum())} counts)",
              flush=True)

        # check 3: crash at LOOP_FAIL_AT, restore, resume: bit for bit
        crash = build("crash", fail_at=(LOOP_FAIL_AT,))
        ops.LAUNCHES.clear()
        with PhaseClock([(loop.Trainer, "_transition", "transition")]) as crash_whole:
            try:
                crash.run(LOOP_STEPS)
                check(False, f"no failure at step {LOOP_FAIL_AT}")
            except loop.InjectedFailure:
                pass
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restored = crash.restore_latest()
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
            check(restored == LOOP_FAIL_AT // LOOP_CKPT_EVERY * LOOP_CKPT_EVERY,
                  f"restored to step {restored}")
            crash.data_iter = data_from(restored)
            crash.run(LOOP_STEPS - restored)
        launches_crash = dict(ops.LAUNCHES)
        n_steps_run = LOOP_FAIL_AT + LOOP_STEPS - restored
        n_trans_crash = crash_whole.calls["transition"]
        check(launches_crash.get("cce_lookup_fwd") == n_steps_run
              and launches_crash.get("cce_lookup_bwd") == n_steps_run
              and launches_crash.get("kmeans_assign") == assign_per_transition * n_trans_crash,
              f"crash run launches {launches_crash}: {n_steps_run} steps run, "
              f"{n_trans_crash} transitions")
        diffs = []
        for what, a, b in (("params", crash.state.params, clean.state.params),
                           ("moments", crash.state.opt, clean.state.opt),
                           ("ptr/hs/epoch", crash.state.ebuf, clean.state.ebuf)):
            la, lb = jax_leaves(a), jax_leaves(b)
            if len(la) != len(lb) or not all(torch.equal(x, y) for x, y in zip(la, lb)):
                diffs.append(what)
        for what, a, b in (("tracker", crash.id_tracker.state_tree(), tracker.state_tree()),
                           ("trigger", crash.trigger.state_tree(), clean.trigger.state_tree())):
            if len(a) != len(b) or not all(np.array_equal(x, y) for x, y in zip(a, b)):
                diffs.append(what)
        if crash.clusters_done != clean.clusters_done or crash.state.step != LOOP_STEPS:
            diffs.append(f"clusters_done {crash.clusters_done} / step {crash.state.step}")
        bad_loss = sorted({h["step"] for h in crash.history if h["loss"] != losses[h["step"]]})
        if bad_loss or sorted({h["step"] for h in crash.history}) != list(range(LOOP_STEPS)):
            diffs.append(f"losses at steps {bad_loss}")
        check(not diffs, f"crash and resume differs from the uninterrupted run in {diffs}")
        recs = read_runlog(crash.runlog.path)
        keys = [(r["event"], r["step"]) for r in recs
                if "step" in r and r["event"] not in ("fault", "checkpoint_restore")]
        dup = sorted({k for k in keys if keys.count(k) > 1})
        check(not dup, f"the crash run's log repeats {dup}")
        check([r["step"] for r in recs if r["event"] == "step"] == list(range(LOOP_STEPS)),
              "the crash run's log does not hold each step once")
        print(f"[{card}] loop: crash at step {LOOP_FAIL_AT}, restore from step {restored} in "
              f"{restore_ms!r} ms, resume to {LOOP_STEPS}: params, moments, ptr/hs/epoch, "
              f"tracker, trigger, clusters_done ({crash.clusters_done}) and all {LOOP_STEPS} "
              f"losses equal the uninterrupted run bit for bit ({n_steps_run} steps run, "
              f"launches {launches_crash}); its run log holds no (event, step) twice",
              flush=True)
        del crash

        # check 4: the card's last checkpoint restores into a CPU Trainer
        last = list_checkpoints(clean.ckpt.directory)[-1]
        with open(pathlib.Path(last[1]) / "manifest.json") as f:
            manifest = json.load(f)
        on_cpu = build("cpu", dev="cpu", ckpt_dir=clean.ckpt.directory, obs=False)
        t0 = time.perf_counter()
        check(on_cpu.restore_latest() == LOOP_STEPS, "the CPU restore found another step")
        cpu_restore_ms = (time.perf_counter() - t0) * 1e3
        paths = [p for p, _ in jax_leaves_with_paths(on_cpu._ckpt_tree())]
        hs = [i for i, p in enumerate(paths) if p.endswith("['hs']")]
        check(manifest["n_leaves"] == len(paths) and hs
              and all(manifest["leaves"][i]["dtype"] == "uint32" for i in hs),
              f"the checkpoint's hs leaves on disk: "
              f"{sorted({manifest['leaves'][i]['dtype'] for i in hs})}")
        bad = [p for (p, x), y in zip(jax_leaves_with_paths(on_cpu.state), jax_leaves(clean.state))
               if not (torch.equal(x, y.cpu()) if isinstance(x, torch.Tensor) else x == y)]
        bad += ["tracker"] * (not all(np.array_equal(x, y) for x, y in zip(
            on_cpu.id_tracker.state_tree(), tracker.state_tree())))
        check(not bad and on_cpu.clusters_done == clean.clusters_done
              and all(x.device.type == "cpu" for x in jax_leaves(on_cpu.state.params)),
              f"the card checkpoint restored on the CPU differs at {bad[:5]}")
        print(f"[{card}] loop: the card's checkpoint of step {LOOP_STEPS} ({manifest['n_leaves']} "
              f"leaves, {len(hs)} hs leaves uint32 on disk) restores into a CPU Trainer in "
              f"{cpu_restore_ms!r} ms with every leaf equal", flush=True)
        del on_cpu

        # check 5: serve a batch from the final state with the trained tracker's heads
        engine = DLRMServeEngine(clean.state.params, clean.state.ebuf, cfg, tracker=tracker,
                                 max_batch=SERVE_BATCH)
        dense, sparse = raw[-1]["dense"][:SERVE_BATCH], raw[-1]["sparse"][:SERVE_BATCH]
        ops.LAUNCHES.clear()
        served = engine.predict(dense, sparse)
        launches_serve = dict(ops.LAUNCHES)
        with torch.no_grad():
            fwd = dlrm.forward(clean.state.params, clean.state.ebuf, cfg, {
                "dense": torch.from_numpy(dense).to(device),
                "sparse": torch.from_numpy(sparse).to(device)}).cpu().numpy()
        diff = float(np.abs(fwd - served).max())
        hits = engine.counters["n_id_hits"]
        check(bool(np.isfinite(served).all()) and diff <= 1e-5,
              f"served logits differ from forward by {diff}")
        check(hits > 0 and launches_serve.get("cce_lookup_fwd", 0) == engine.counters["n_launches"],
              f"serve: {hits} cache hits, launches {launches_serve}, engine {engine.counters}")
        print(f"[{card}] loop: served {len(served)} requests from the final state with the "
              f"tracker's heads ({engine.cache.n_slots} cache slots): logits vs forward "
              f"max_abs_diff={diff!r}, {hits} of {engine.counters['n_id_lookups']} id lookups "
              f"hit the cache, launches {launches_serve}", flush=True)
        launches = collections.Counter(launches_clean)
        launches.update(launches_crash)
        launches.update(launches_serve)

        # where the time goes
        dts = [h["dt"] * 1e3 for h in clean.history if h.get("dt") is not None]
        folds = tracker._folder.fold_ms
        print(f"[{card}] loop step timing: dispatch-to-dispatch host {statistics.median(dts)!r} "
              f"ms (median of {len(dts)}; max {max(dts)!r}); tracker.observe on the step's "
              f"thread {statistics.median(observe_ms)!r} ms (median; max {max(observe_ms)!r}); "
              f"sketch fold on its thread {statistics.median(folds)!r} ms (median of "
              f"{len(folds)}; max {max(folds)!r})", flush=True)
        print(f"[{card}] loop checkpoints: enqueue (host copy) ms {clean.ckpt.enqueue_ms!r}, "
              f"write ms {clean.ckpt.write_ms!r}; restore {restore_ms!r} ms on the card, "
              f"{cpu_restore_ms!r} ms on the CPU", flush=True)
        print(f"[{card}] loop transition by phase ({n_trans} transitions): total host "
              f"{whole.ms['transition']!r} ms; " + ", ".join(
                  f"{k}: host {v!r} ms over {by_phase.calls[k]} calls"
                  for k, v in by_phase.ms.items())
              + f"; other host {whole.ms['transition'] - sum(by_phase.ms.values())!r} ms",
              flush=True)

        # the step with the tracker and telemetry against the plain step, on
        # one state and batch: plain; the step with its sketch count and
        # telemetry alone; that and the tracker's observe and the pump
        # (the loop's step); in turns, forth and back
        batch = clean._to_device(raw[-1])

        def loss_fn(p, b, mb):
            return dlrm.bce_loss(p, b, cfg, mb), {}

        plain_step = loop.make_train_step(loss_fn, sgd(momentum=0.9), lambda s: TRAIN_LR,
                                          clip_norm=1.0)
        pump = MetricsPump(lag=8)

        def plain():
            clean.state, _ = plain_step(clean.state, batch)

        def hooks():
            clean.state, _ = clean.train_step(clean.state, batch)

        def full():
            clean.state, m = clean.train_step(clean.state, batch)
            tracker.observe(raw[-1], delta=m.pop("sketch_delta"))
            pump.push(clean.state.step, m)

        def drain():
            # the loop step's folds run on the fold thread after it returns:
            # no variant is timed while an earlier one's backlog drains
            tracker.flush()
            pump.flush()

        def host_ms(fn, n=8):
            ts = []
            for _ in range(n):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t) * 1e3)
            drain()
            return statistics.median(ts)

        variants = {"plain": plain, "step with hooks": hooks, "loop step": full}
        order = list(variants) + list(variants)[::-1]
        host = collections.defaultdict(list)
        for name in order:
            host[name].append(host_ms(variants[name]))
        busy = {}
        for name, fn in variants.items():
            busy[name] = device_busy_ms(fn)
            drain()
        print(f"[{card}] loop step vs the plain step, batch {TRAIN_BATCH}, synchronised "
              f"({', '.join(order)}; medians of 8, the fold drained after each block): "
              + "; ".join(f"{name}: host {host[name]!r} ms, device busy {busy[name]!r} ms"
                          for name in variants), flush=True)

        # the Trainer's own loop, unsynchronised, dispatch to dispatch: the
        # fold on its thread (as the loop runs it), on the step's thread
        # (after each step), and no tracker.  If the fold and the step's
        # dispatch serialise on the host, the first two are alike and near
        # the third plus a fold; if they overlap, the first is near the
        # larger of the third and a fold
        clean.ckpt = None  # no saves in these runs
        folder = tracker._folder

        def run_loop(mode):
            clean.id_tracker = None if mode == "no tracker" else tracker
            tracker._folder = None if mode == "fold on the step's thread" else folder
            clean.data_iter = iter(raw[:LOOP_TIMED_STEPS])
            clean._last_dispatch = None
            start, n_folds, n_observes = clean.state.step, len(folder.fold_ms), len(observe_ms)
            clean.run(LOOP_TIMED_STEPS)
            tracker._folder = folder
            clean.id_tracker = tracker
            drain()
            # a fold's ms: on its thread, or inside observe on the step's
            folds = list(folder.fold_ms)[n_folds:] or observe_ms[n_observes:]
            return (statistics.median(h["dt"] * 1e3 for h in clean.history
                                      if h["step"] >= start and h.get("dt") is not None),
                    statistics.median(folds) if folds else None)

        modes = ("fold on its thread", "fold on the step's thread", "no tracker")
        order = list(modes) + list(modes)[::-1]
        d2d, fold = collections.defaultdict(list), collections.defaultdict(list)
        for mode in order:
            dt, fold_ms = run_loop(mode)
            d2d[mode].append(dt)
            fold[mode].append(fold_ms)
        print(f"[{card}] loop dispatch to dispatch, the Trainer unsynchronised ({', '.join(order)}; "
              f"medians of {LOOP_TIMED_STEPS - 1} steps): " + "; ".join(
                  f"{mode}: {d2d[mode]!r} ms (a fold {fold[mode]!r} ms)" for mode in modes),
              flush=True)
        return {"loop": dict(launches)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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


def flash_flops(B: int, Sq: int, S: int, H: int, D: int, causal: bool) -> int:
    """The two products' operations over the (query, key) pairs the mask
    keeps: 4*D a pair and head."""
    pairs = sum(min(i + 1, S) for i in range(Sq)) if causal else Sq * S
    return 4 * D * H * B * pairs


def flash_bound(B: int, Sq: int, S: int, H: int, KVH: int, D: int, esize: int, causal: bool,
                flops: float):
    """Least time for the attention on an H100: q, k, v read once and the
    output written once, against the two products over the (query, key)
    pairs the mask keeps (4*D flops a pair and head) at ``flops``.
    Returns (ms, "bytes" | "operations")."""
    n_bytes = (2 * B * Sq * H * D + 2 * B * S * KVH * D) * esize
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flash_flops(B, Sq, S, H, D, causal) / flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_row_err(got, want) -> float:
    """The largest over (b, s, h) rows of max_d |got - want| / (max_d |want|
    + 1e-3): the error of each query row and head against its own scale."""
    want = want.float()
    diff = (got.float() - want).abs().amax(-1)
    return (diff / (want.abs().amax(-1) + 1e-3)).max().item()


def flash_phase(card: str, device="cuda"):
    """The flash-attention kernel against its plain version on unit-normal
    inputs: within FLASH_TOL, bfloat16 also within FLASH_ROW_TOL of each
    row's scale against the plain version in float32, repeatable bit for
    bit, the causal first row equal to v's first row; a strided
    (B, H, S, D)-layout view read in place.  Times the kernel, the plain
    version and SDPA at FLASH_TIMED.  Returns ({dtype: max error}, {S: numbers})."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def case(B, Sq, S, H, KVH, D, dtype, causal, seed, head_major=False):
        g = torch.Generator(device=device).manual_seed(seed)
        if head_major:  # (B, H, S, D) storage seen as (B, S, H, D)
            q = torch.randn((B, H, Sq, D), generator=g, device=device).to(dtype).transpose(1, 2)
        else:
            q = torch.randn((B, Sq, H, D), generator=g, device=device).to(dtype)
        k = torch.randn((B, S, KVH, D), generator=g, device=device).to(dtype)
        v = torch.randn((B, S, KVH, D), generator=g, device=device).to(dtype)
        return q, k, v

    max_err = {"float32": 0.0, "bfloat16": 0.0}
    max_row_err = 0.0
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        tol = FLASH_TOL[dn]
        for H, KVH in FLASH_HEADS:
            for D in FLASH_DIMS:
                shapes = [(n, n, True) for n in FLASH_LENGTHS]
                shapes += [(sq, sk, False) for sq, sk in FLASH_NONCAUSAL]
                for Sq, S, causal in shapes:
                    B = 1 if S >= 1000 else 2
                    q, k, v = case(B, Sq, S, H, KVH, D, dtype, causal, seed=n_cases,
                                   head_major=(Sq == FLASH_STRIDED and causal))
                    want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                                     causal=causal)
                    want = want32.to(dtype)
                    # bf16: CTAs of 64 and of 128 query rows, whichever the wrapper picks
                    for rows in (None,) if dtype == torch.float32 else (64, 128):
                        if rows:
                            got = fa._launch(q, k, v, causal, rows)
                            again = fa._launch(q, k, v, causal, rows)
                        else:
                            got = fa.flash_attention(q, k, v, causal=causal)
                            again = fa.flash_attention(q, k, v, causal=causal)
                        torch.cuda.synchronize()
                        err = (got.float() - want.float()).abs().max().item()
                        what = (f"{dn} H={H} KVH={KVH} D={D} Sq={Sq} S={S} causal={causal}"
                                f"{f' rows={rows}' if rows else ''}")
                        check(err <= tol, f"flash kernel vs plain {err} > {tol} at {what}")
                        if rows:
                            row_err = flash_row_err(got, want32)
                            check(row_err <= FLASH_ROW_TOL, f"flash kernel vs plain {row_err} "
                                  f"> {FLASH_ROW_TOL} of a row's scale at {what}")
                            max_row_err = max(max_row_err, row_err)
                        check(torch.equal(got, again), f"flash kernel not repeatable at {what}")
                        if causal:
                            first = v[:, 0].repeat_interleave(H // KVH, dim=1)
                            row_err = (got[:, 0].float() - first.float()).abs().max().item()
                            check(row_err <= tol, f"flash first row != v[0] ({row_err}) at {what}")
                        max_err[dn] = max(max_err[dn], err)
                    n_cases += 1
    print(f"[{card}] flash_attention: {n_cases} cases (heads {FLASH_HEADS}, D {FLASH_DIMS}, "
          f"causal S {FLASH_LENGTHS}, non-causal (Sq, S) {FLASH_NONCAUSAL}) in float32 and "
          f"bfloat16 (at 64 and 128 query rows a CTA): max_abs_err {max_err!r}, bfloat16 "
          f"max_row_scaled_err {max_row_err!r} (<= {FLASH_ROW_TOL!r}), repeatable, "
          f"causal first row == v[0]",
          flush=True)

    at = {}
    H, KVH = FLASH_HEADS[0]
    D = FLASH_DIMS[-1]
    for S in FLASH_TIMED:
        q, k, v = case(1, S, S, H, KVH, D, torch.bfloat16, True, seed=10_000 + S)
        got = fa.flash_attention(q, k, v)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

        # each side rounds to bf16 on its own: two roundings apart at most
        lib_err = (library().transpose(1, 2).float() - got.float()).abs().max().item()
        check(lib_err <= 2 * FLASH_TOL["bfloat16"],
              f"SDPA yardstick computes another function at S={S} ({lib_err})")
        ms = time_ms(lambda: fa.flash_attention(q, k, v), iters=50)
        dev = device_ms(lambda: fa.flash_attention(q, k, v), "flash_fwd_wgmma_kernel")
        # both CTA heights, whichever the wrapper picks: 64 or 128 query rows
        by_rows = {r: device_ms(lambda r=r: fa._launch(q, k, v, True, r),
                                "flash_fwd_wgmma_kernel") for r in (64, 128)}
        picked = fa.block_rows(1, S, H, torch.cuda.get_device_properties(0).multi_processor_count)
        plain = time_ms(lambda: ref.flash_attention_ref(q, k, v), iters=10, reps=3)
        plain_dev = device_busy_ms(lambda: ref.flash_attention_ref(q, k, v), iters=5)
        lib = time_ms(library, iters=50)
        lib_dev = device_busy_ms(library, iters=20)
        bound, bound_by = flash_bound(1, S, S, H, KVH, D, 2, True, H100_BF16_FLOPS)
        tflops = flash_flops(1, S, S, H, D, True) / (dev * 1e-3) / 1e12
        at[S] = dict(ms=ms, device_ms=dev, device_ms_by_rows=by_rows, rows=picked, tflops=tflops,
                     bound_share=bound / dev, plain_ms=plain, plain_device_ms=plain_dev,
                     bound_ms=bound, bound_by=bound_by, library_ms=lib,
                     library_device_ms=lib_dev)
        print(f"[{card}] flash_attention bf16 B=1 H={H} KVH={KVH} D={D} S={S} causal: "
              f"ms={ms!r} device_ms={dev!r} (rows {picked}; "
              f"64 rows {by_rows[64]!r}, 128 rows {by_rows[128]!r}) {tflops!r} TFLOP/s, "
              f"{bound / dev!r} of bound_ms={bound!r} ({bound_by}) plain_ms={plain!r} "
              f"plain_device_ms={plain_dev!r} library_ms(sdpa)={lib!r} "
              f"library_device_ms={lib_dev!r} sdpa_vs_kernel_max_abs_diff={lib_err!r}",
              flush=True)
    return max_err, at


def _lm_prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPTS[0], LM_PROMPTS[1] + 1, LM_REQUESTS)
    return [rng.integers(0, cfg.vocab, int(n)).astype(np.int32) for n in lens]


def lm_lookup_numbers(card: str, cfg, params, buffers, prompts) -> dict:
    """The lookup kernel at the LM's token-table shape (c=emb_c, T=2, the
    table's k and dsub): a 2048-token prefill and an 8-slot decode,
    against its plain version (bit for bit in float32), with its times.
    Device times of kernel and ``embedding_bag`` are taken with the L2
    flushed before each call, as serving finds the table (the layers'
    weights stream through the L2 between two lookups), and warm beside."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ref
    from repro_torch.models import lm

    table = lm.make_emb(cfg)
    tables = params["emb"]["tables"].contiguous()
    toks = np.concatenate(prompts)
    out = {}
    for name, n in (("prefill", LM_MAX_SEQ), ("decode", LM_MAX_BATCH)):
        ids = torch.from_numpy(np.resize(toks, n).astype(np.int64)).to(tables.device)
        idx = table._rows(buffers["emb"], ids).reshape(table.c, -1, 2)
        got = cl.cce_lookup_fwd(idx, tables)
        want = ref.cce_lookup_ref(idx, tables)
        check(torch.equal(got, want), f"LM-shape lookup kernel != plain at B={n}")
        bag, weight, offsets = embedding_bag_args(idx, tables)
        check(torch.allclose(F.embedding_bag(bag, weight, offsets, mode="sum").reshape(n, -1),
                             got, rtol=1e-6, atol=1e-6),
              f"embedding_bag yardstick computes another function at B={n}")
        ms = time_ms(lambda: cl.cce_lookup_fwd(idx, tables))
        kernel = lookup_kernel("cce_lookup_fwd", tables)
        dev = device_ms(lambda: cl.cce_lookup_fwd(idx, tables), kernel, cold=True)
        dev_warm = device_ms(lambda: cl.cce_lookup_fwd(idx, tables), kernel)
        plain = time_ms(lambda: ref.cce_lookup_ref(idx, tables))
        plain_dev = device_busy_ms(lambda: ref.cce_lookup_ref(idx, tables), iters=20)

        def library():
            return F.embedding_bag(bag, weight, offsets, mode="sum")

        lib = time_ms(library)
        lib_dev = device_busy_ms(library, iters=20, cold=True)
        lib_dev_warm = device_busy_ms(library, iters=20)
        bound, bound_by = lookup_bound(idx, tables)
        out[name] = dict(B=n, ms=ms, device_ms=dev, device_ms_warm=dev_warm, plain_ms=plain,
                         plain_device_ms=plain_dev, bound_ms=bound, bound_by=bound_by,
                         library_ms=lib, library_device_ms=lib_dev,
                         library_device_ms_warm=lib_dev_warm)
        print(f"[{card}] cce_lookup_fwd LM shape c={table.c} T=2 k={table.k} "
              f"dsub={table.dsub} f32 B={n} ({name}): equal to plain, ms={ms!r} "
              f"device_ms(L2 flushed)={dev!r} device_ms(warm)={dev_warm!r} plain_ms={plain!r} "
              f"plain_device_ms={plain_dev!r} "
              f"bound_ms={bound!r} ({bound_by}) library_ms(embedding_bag)={lib!r} "
              f"library_device_ms(L2 flushed)={lib_dev!r} library_device_ms(warm)="
              f"{lib_dev_warm!r}", flush=True)
    return out


def lm_serve_phase(card: str, cfg, device="cuda"):
    """Full-width LM serving through ``ServeEngine``: LM_REQUESTS prompts
    over LM_MAX_BATCH slots, greedy, LM_MAX_TOKENS tokens each, with the
    launch counts reset just before the run and read just after; then a
    request served alone against itself in the batch, a LM_CHECK_LAYERS
    cut's prefill logits on the card against CPU copies (float32 and the
    served bfloat16), the idle share of one decode tick and one full-bucket
    prefill, and the lookup kernel at the LM's shape.  Returns (launches,
    lookup numbers)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    params, buffers = lm.init(cfg, gen, device=device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    on_card = torch.cuda.memory_allocated() / 2**30 if device == "cuda" else 0.0
    print(f"[{card}] lm init: {cfg.name} {cfg.n_layers}L d={cfg.d_model} {cfg.n_heads}H/"
          f"{cfg.n_kv_heads}KV hd={cfg.head_dim} ff={cfg.d_ff} vocab={cfg.vocab} "
          f"emb={cfg.emb_method}: {n_params} params (analytic, without biases: "
          f"{cfg.n_params()}), {on_card:.2f} GiB on the card, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    prompts = _lm_prompts(cfg)

    def engine():
        return ServeEngine(cfg, params, buffers, max_batch=LM_MAX_BATCH, max_seq=LM_MAX_SEQ)

    warm = engine()  # first-call set-up (cuBLAS handles, the kernels' libraries) stays out
    warm.submit(Request(uid=-1, prompt=prompts[0][:LM_PROMPTS[0]], max_tokens=2))
    warm.run()
    del warm

    eng = engine()
    prefill_ms, decode_ms = collections.defaultdict(list), []
    orig_prefill, orig_decode = eng._prefill_one, eng._decode

    def timed_prefill(slot, toks, last_idx):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_prefill(slot, toks, last_idx)
        torch.cuda.synchronize()
        prefill_ms[toks.shape[1]].append((time.perf_counter() - t) * 1e3)
        return out

    def timed_decode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_decode()
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t) * 1e3)
        return out

    eng._prefill_one, eng._decode = timed_prefill, timed_decode
    reqs = [Request(uid=i, prompt=p, max_tokens=LM_MAX_TOKENS) for i, p in enumerate(prompts)]
    ops.LAUNCHES.clear()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    n_dec = len(decode_ms)
    check(len(done) == LM_REQUESTS and eng.prefills == LM_REQUESTS,
          f"served {len(done)} requests with {eng.prefills} prefills")
    check(launches.get("flash_attention") == cfg.n_layers * eng.prefills,
          f"flash_attention launches {launches} != {cfg.n_layers} x {eng.prefills} prefills")
    check(launches.get("cce_lookup_fwd") == eng.prefills + n_dec,
          f"cce_lookup_fwd launches {launches} != {eng.prefills} prefills + {n_dec} decodes")
    check(all(len(r.generated) == LM_MAX_TOKENS and all(0 <= t < cfg.vocab for t in r.generated)
              for r in done), "a request came back with the wrong number or range of tokens")
    n_tok = sum(len(r.generated) for r in done)
    lat = np.array([r.latency_s for r in done]) * 1e3
    hist = eng.flush_stats()
    buckets = {b: statistics.median(v) for b, v in sorted(prefill_ms.items())}
    counts = {b: len(v) for b, v in sorted(prefill_ms.items())}
    print(f"[{card}] lm serve: {LM_REQUESTS} requests (prompts {sorted(len(p) for p in prompts)}) "
          f"over {LM_MAX_BATCH} slots, max_seq {LM_MAX_SEQ}, {n_tok} tokens in {wall!r} s "
          f"({n_tok / wall!r} tokens/s), {eng.prefills} prefills, {n_dec} decode ticks; "
          f"launches {launches}", flush=True)
    print(f"[{card}] lm serve prefill host ms by bucket (median, count): "
          + ", ".join(f"{b}: {buckets[b]!r} ({counts[b]})" for b in buckets)
          + f"; decode tick host ms median {statistics.median(decode_ms)!r} "
          f"(min {min(decode_ms)!r}, max {max(decode_ms)!r})", flush=True)
    print(f"[{card}] lm serve request latency (admit to retire, host clock): histogram "
          f"p50={hist['p50']!r} s p99={hist['p99']!r} s (upper bucket edges); exact "
          f"p50={float(np.percentile(lat, 50))!r} ms p99={float(np.percentile(lat, 99))!r} ms",
          flush=True)

    # a request served alone gives the tokens it gave in the batch
    solo_req = max(done, key=lambda r: len(r.prompt))
    solo = engine()
    solo.submit(Request(uid=0, prompt=solo_req.prompt, max_tokens=LM_MAX_TOKENS))
    alone = solo.run()[0].generated
    check(alone == solo_req.generated,
          f"request {solo_req.uid} alone {alone} != in the batch {solo_req.generated}")
    del solo
    print(f"[{card}] lm serve: request {solo_req.uid} ({len(solo_req.prompt)} prompt tokens) "
          f"alone gives its batch tokens {alone}", flush=True)

    # idle share of one decode tick and of one full-bucket prefill
    with torch.inference_mode():
        toks = np.resize(np.concatenate(prompts), (1, LM_MAX_SEQ)).astype(np.int64)
        for name, fn in (("decode tick", orig_decode),
                         (f"prefill {LM_MAX_SEQ}", lambda: orig_prefill(0, toks, LM_MAX_SEQ - 1))):
            fn()
            host = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t) * 1e3)
            busy = device_busy_ms(fn)
            h = statistics.median(host)
            print(f"[{card}] lm serve {name}: host {h!r} ms, device busy {busy!r} ms "
                  f"(idle share {1 - busy / h!r})", flush=True)

    lookup = lm_lookup_numbers(card, cfg, params, buffers, prompts)

    # prefill logits of a LM_CHECK_LAYERS cut: the card against CPU copies
    cut_p = dict(params, blocks=tree_map(lambda t: t[:LM_CHECK_LAYERS], params["blocks"]))
    cpu_p = tree_map(lambda t: t.detach().to("cpu", copy=True), cut_p)
    cpu_b = tree_map(lambda t: t.detach().to("cpu", copy=True), buffers)
    toks = torch.from_numpy(np.resize(prompts[-1], (1, LM_CHECK_PROMPT)).astype(np.int64))
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        cut = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS, dtype=dtype)
        with torch.inference_mode():
            on_card, _ = lm.prefill(cut_p, buffers, cut, toks.to(device),
                                    lm.init_cache(cut, 1, LM_CHECK_PROMPT, device=device))
            on_cpu, _ = lm.prefill(cpu_p, cpu_b, cut, toks,
                                   lm.init_cache(cut, 1, LM_CHECK_PROMPT, device="cpu"))
        err = (on_card.float().cpu() - on_cpu.float()).abs().max().item()
        top = on_cpu.float().abs().max().item()
        check(bool(torch.isfinite(on_card).all()) and err <= LM_LOGIT_RTOL[dn] * top,
              f"{LM_CHECK_LAYERS}-layer prefill logits card vs CPU ({dn}): max abs diff {err} "
              f"> {LM_LOGIT_RTOL[dn]} x largest {top}")
        print(f"[{card}] lm prefill logits, {LM_CHECK_LAYERS}-layer cut, {LM_CHECK_PROMPT} "
              f"tokens, {dn}: card vs CPU max abs diff {err!r} (largest logit {top!r}, "
              f"relative {err / top!r}, tolerance {LM_LOGIT_RTOL[dn]})", flush=True)
    del cpu_p, cpu_b, cut_p, eng
    return launches, lookup


KERNELS = {  # name -> (CUDA source, the TPU kernel's pallas_call it replaces)
    "cce_lookup_fwd": ("src/repro_torch/kernels/csrc/cce_lookup.cu",
                       "src/repro/kernels/cce_lookup.py:106"),
    "cce_lookup_bwd": ("src/repro_torch/kernels/csrc/cce_lookup_bwd.cu",
                       "src/repro/kernels/cce_lookup.py:134"),
    "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign.py:67"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:97"),
}
PHASES = ("lookup", "bwd", "kmeans", "train", "loop", "serve", "flash", "lm_serve")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (a subset prints no result line)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    check(set(phases) <= set(PHASES), f"unknown phase in {phases}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 1
    from repro_torch import configs
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

    def phase(name, fn, *a):
        if name not in phases:
            return None
        t = time.perf_counter()
        out = fn(*a)
        print(f"[{card}] phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
        return out

    fwd = phase("lookup", kernel_phase, card, CONFIG.collection)
    bwd = phase("bwd", bwd_kernel_phase, card, CONFIG)
    assign = phase("kmeans", kmeans_phase, card, CONFIG)
    launches = phase("train", train_phase, card, CONFIG) or {}
    launches.update(phase("loop", loop_phase, card, CONFIG) or {})
    serve = phase("serve", serve_phase, card, CONFIG, SERVE_BATCHES)
    if serve is not None:
        launches["serve"] = {"cce_lookup_fwd": serve}
    flash = phase("flash", flash_phase, card)
    lm_out = phase("lm_serve", lm_serve_phase, card, configs.get(LM_ARCH))
    if lm_out is not None:
        launches["lm_serve"] = lm_out[0]
    if set(phases) != set(PHASES):
        print(f"chip_smoke: phases {phases} passed in {time.perf_counter() - t_run:.1f} s "
              f"(a partial run: no result line)")
        return 0
    (fwd_err, fwd_at), (bwd_err, bwd_at), (assign_err, assign_at) = fwd, bwd, assign
    (flash_err, flash_at), lm_lookup = flash, lm_out[1]

    def by_path(name):
        return {path: counts.get(name, 0) for path, counts in launches.items()}

    def entry(name, main_paths, err, at, **extra):
        src, replaces = KERNELS[name]
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(launches[p].get(name, 0) for p in main_paths),
                "launches_by_path": by_path(name), "max_abs_err": err, **at, **extra}

    steps = ("train", "train_after_transition", "loop")
    S = FLASH_TIMED[-1]
    kernels = [
        entry("cce_lookup_fwd", steps, fwd_err, fwd_at[TRAIN_BATCH], batch=TRAIN_BATCH,
              at_serve_batch=fwd_at[SERVE_BATCH], at_lm_shape=lm_lookup),
        entry("cce_lookup_bwd", steps, bwd_err, bwd_at, batch=TRAIN_BATCH),
        entry("kmeans_assign", ("transition", "loop"), assign_err, assign_at),
        entry("flash_attention", ("lm_serve",), flash_err["bfloat16"], flash_at[S],
              max_abs_err_float32=flash_err["float32"],
              shape=dict(B=1, S=S, H=FLASH_HEADS[0][0], KVH=FLASH_HEADS[0][1], D=FLASH_DIMS[-1],
                         dtype="bfloat16", causal=True),
              library="scaled_dot_product_attention",
              at_other_lengths={s: flash_at[s] for s in FLASH_TIMED[:-1]}),
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
