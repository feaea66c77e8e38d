#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (into ``build/repro_torch/``).
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the main path (float32 bit for bit, bfloat16 within one
   rounding step) and times kernel, plain version and a library call that
   computes the same function.
3. Serves the full-width Criteo DLRM configuration (26 features, 33.7M ids,
   random weights from a seed) through ``DLRMServeEngine``: requests go
   through submit/step/drain with the launch counts reset just before, and
   the served logits are held against the port's own forward.
4. Prints the kernels' JSON line, the card line and, last,
   ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when there is no CUDA device, when the
port is missing, or when any phase fails.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
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
LOOKUP_BATCHES = (1, 7, SERVE_BATCH, 4096)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, *, iters: int = 200, reps: int = 5) -> float:
    """Median over ``reps`` of CUDA-event time per call, over ``iters``
    back-to-back calls after a warm-up."""
    import torch

    for _ in range(10):
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
    """Each kernel against its plain version at the supertable's shape,
    with its times.  Returns (max float32 error, numbers at the serve
    batch)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ref

    (g,) = collection.univ_groups
    grp = collection.groups[g]
    print(f"supertable: c={grp.n_cols} T={grp.n_tables} k={grp.k_pad} dsub={grp.dsub}")
    max_err = 0.0
    main_shape = {}
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
            if dtype == torch.float32 and B == SERVE_BATCH:
                main_shape = dict(ms=ms, device_ms=dev, plain_ms=plain, plain_device_ms=plain_dev,
                                  bound_ms=bound, bound_by=bound_by, library_ms=lib,
                                  library_device_ms=lib_dev)
    return max_err, main_shape


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

    t0 = time.perf_counter()
    build.build("cce_lookup")
    build.library("cce_lookup")
    print(f"[{card}] build: cce_lookup.cu {time.perf_counter() - t0:.3f} s")
    for line in build.BUILD_LOGS.get("cce_lookup", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    max_err, at_serve = kernel_phase(card, CONFIG.collection)
    launches = serve_phase(card, CONFIG, SERVE_BATCHES)

    kernels = [{
        "name": "cce_lookup_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cce_lookup.cu",
        "replaces": "src/repro/kernels/cce_lookup.py:106",
        "launches": launches,
        "max_abs_err": max_err,
        **at_serve,
    }]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
