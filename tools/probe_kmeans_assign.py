#!/usr/bin/env python3
"""The k-means assignment kernels on one GPU: their instructions, their
launch geometries and tile variants, and each against an earlier build.

    python3 tools/probe_kmeans_assign.py [--only d4|tiled] [--old OLD.cu]
                                         [--old-general OLD.cu]

Prints ptxas' registers and spills of ``csrc/kmeans_assign.cu``, then:

The tiled kernel (``kmeans_assign_tiled_kernel``, every shape off the
d = 4 kernel; ``--only tiled`` runs this part alone):
- From ``cuobjdump -sass``, the instructions of its d-step loop by opcode:
  the FFMA share and the LDS per FFMA.
- Tile variants of the same source built with ``-D`` switches (ring
  stages, CTAs an SM, points a thread), each with its ptxas line,
  its picks equal to the port's build, and the device ms of the port's
  build, every variant, then the port's build again, at qwen2-1.5b's
  token table (``chip_smoke.ASSIGN_LM_TABLE``) on random inputs.
- With ``--old-general``: builds OLD.cu, a source with this C interface
  whose other shapes take the one-point-a-thread general kernel (e.g.
  ``git show a9138c8:src/repro_torch/kernels/csrc/kmeans_assign.cu``),
  and at every ``chip_smoke.ASSIGN_GENERAL`` shape (planted ties too) and
  at qwen2's table checks that its picks equal the tiled kernel's bit for
  bit and times the two old, new, new, old (one traced call each).

The d = 4 kernel (``kmeans_assign_kernel<P>``; ``--only d4``):
- The instructions of each template instance's centroid loop by opcode,
  and over the (point, centroid) pairs one pass of the loop covers.
- At ``chip_smoke.ASSIGN_SHAPES`` (an ``assign_all`` chunk, a Lloyd
  sample), on ``chip_smoke``'s inputs: the device ms of every geometry
  (points a thread, threads a CTA), each one's picks equal to the
  geometry ``assign_geometry`` picks; and at the batched chunk (c=4
  columns in one launch) against four one-column launches.
- With ``--old``: builds OLD.cu, a source of the one-column kernel with
  the earlier C interface ``kmeans_assign(x, centroids, out, n, k, d,
  stream)`` (the kernel of ``git show 5cb4393:src/repro_torch/kernels/
  csrc/kmeans_assign.cu``), checks that its picks equal this kernel's bit
  for bit at every shape, times the two in the order old, new, new, old,
  and runs ``CCE.assign_all`` over the 17 CCE tables of the full Criteo
  configuration (33.8M ids, c=4, k=250, dsub=4, chunks of 2^18) both
  ways, old (a launch and a copy a column and chunk) and new (one launch a
  chunk): host ms and device busy of each, old, new, new, old, the
  pointers equal.
- Builds this source once more with ``-DKMEANS_ASSIGN_FFMA_ONLY`` (the
  loop's 5 FFMA a pair without the min, compare and selects: wrong picks)
  and times it against this kernel, this, it, it, this, at both shapes:
  the floor that the FFMAs alone set.  Reads the SM clock under load.
Each result is one JSON line.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

BATCHED = (4, 1 << 18, 250, 4)  # (c, n, k, d): one assign_all chunk of a c=4 table


def build_libs(jobs: dict) -> dict:
    """{name: (src, defines)} built with the port's flags (and their
    defines) as ``lib<name>.so`` under ``build/repro_torch/probe``, one
    nvcc each, all at once; returns {name: (path, ptxas lines)}."""
    from repro_torch.kernels import build

    procs = {}
    for name, (src, defines) in jobs.items():
        out = build.BUILD_DIR / "probe" / f"lib{name}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        procs[name] = out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *defines, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = out, [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return built


def build_lib(src: pathlib.Path, name: str, *defines: str):
    """``src`` built with the port's flags (and ``defines``) as
    ``lib<name>.so`` under ``build/repro_torch/probe``; returns (path,
    ptxas lines)."""
    return build_libs({name: (src, defines)})[name]


def old_launcher(path: pathlib.Path):
    """assign(x (n, d), cent (k, d)) -> (n,) through the one-column C
    interface of ``path``."""
    import torch

    fn = ctypes.CDLL(str(path)).kmeans_assign
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def assign(x, cent):
        out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
        err = fn(x.data_ptr(), cent.data_ptr(), out.data_ptr(), x.shape[0], cent.shape[0],
                 x.shape[1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old kmeans_assign launch failed ({err})")
        return out

    return assign


def batched_launcher(path: pathlib.Path, points: int, threads: int):
    """assign(x (c, n, d), cent (c, k, d)) -> (c, n) through the C
    interface of this source in the build at ``path``, with the geometry
    given."""
    import torch

    from repro_torch.kernels import kmeans_assign as ka

    fn = ctypes.CDLL(str(path)).kmeans_assign
    fn.argtypes = ka._kernel().argtypes
    fn.restype = ctypes.c_int

    def assign(x, cent):
        (c, n, d), k = x.shape, cent.shape[1]
        out = torch.empty((c, n), dtype=torch.int32, device=x.device)
        err = fn(x.data_ptr(), cent.data_ptr(), out.data_ptr(), c, n, k, d, n, points, threads,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kmeans_assign launch of {path.name} failed ({err})")
        return out

    return assign


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_loops(lib_path: pathlib.Path) -> dict:
    """{function: [(opcodes of a backward-branch loop, its length)]} over
    the functions of ``lib_path``, from ``cuobjdump -sass``."""
    from repro_torch.kernels import build

    cuobjdump = str(pathlib.Path(build._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], check=True, capture_output=True,
                          text=True).stdout
    funcs = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.split("\n", 1)[0].strip()
        insns = [(int(a, 16), op, rest) for a, op, rest in _INSN.findall(block)]
        loops = []
        for addr, op, rest in insns:
            target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            if target and int(target.group(1), 16) < addr:
                lo = int(target.group(1), 16)
                body = [o.split(".")[0] for a, o, _ in insns if lo <= a <= addr]
                loops.append((collections.Counter(body), len(body)))
        funcs[name] = loops
    return funcs


def loop_report(lib_path: pathlib.Path, label: str):
    """One JSON line for each d = 4 kernel's centroid loop in
    ``lib_path`` (its longest loop): its instructions by opcode and over
    the pairs a pass covers (5 FFMA a pair, however far ptxas unrolled)."""
    for name, loops in sass_loops(lib_path).items():
        m = re.search(r"kmeans_assign_kernelILi(\d+)E", name)
        if not (m and loops):
            continue
        ops, length = max(loops, key=lambda lp: lp[1])
        pairs = ops["FFMA"] // 5
        print(json.dumps({"sass_loop": label, "P": int(m.group(1)), "instructions": length,
                          "pairs": pairs, "per_pair": length / pairs,
                          "by_opcode": dict(ops.most_common())}), flush=True)


def long_kernel_call(fn, kernel_name: str):
    """One call of ``fn``, which launches the kernel whose name holds
    ``kernel_name`` once and runs for seconds (device_ms's 400 calls would
    take minutes): (its output, CUDA-event ms of the call, the
    kernel's device ms from a trace of the same call, or None where the
    trace lost its record)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        out = fn()
        end.record()
        end.synchronize()
    hits = [e for e in prof.key_averages() if kernel_name in e.key and e.count]
    n = sum(e.count for e in hits)
    cs.check(n <= 1, f"{n} launches of *{kernel_name}* in one call")
    if not n:
        print(f"probe_kmeans_assign: the trace lost the launch of *{kernel_name}*", flush=True)
    return out, start.elapsed_time(end), sum(cs._device_us(e) for e in hits) / 1e3 if n else None


def timed(fn, kernel_name: str) -> dict:
    """CUDA-event ms of one call of ``fn`` and the device ms of its kernel:
    from a trace of 10 calls (``chip_smoke.device_ms``, which takes a trace
    that lost records again) where a call takes under a second, else from
    the trace of that one call."""
    import chip_smoke as cs

    _, ms, dev = long_kernel_call(fn, kernel_name)
    if ms < 1e3:
        dev = cs.device_ms(fn, kernel_name, iters=10)
    return {"ms": ms, "device_ms": dev}


def tiled_loop_report(lib_path: pathlib.Path, label: str):
    """One JSON line for each tiled-kernel instance's d-step loop in
    ``lib_path`` (its longest loop): its instructions by opcode, the FFMA
    share of them and the LDS per FFMA."""
    for name, loops in sass_loops(lib_path).items():
        if "kmeans_assign_tiled_kernel" not in name or not loops:
            continue
        ops, length = max(loops, key=lambda lp: lp[1])
        print(json.dumps({"sass_loop": label, "function": name, "instructions": length,
                          "ffma_share": ops["FFMA"] / length,
                          "lds_per_ffma": ops["LDS"] / max(ops["FFMA"], 1),
                          "by_opcode": dict(ops.most_common())}), flush=True)


# -D builds of the tiled kernel: (label, defines, points a thread, threads a CTA)
TILED_VARIANTS = (
    ("stages 2", ("-DKMEANS_ASSIGN_STAGES=2",), 8, 256),
    ("stages 4", ("-DKMEANS_ASSIGN_STAGES=4",), 8, 256),
    ("2 CTAs an SM", ("-DKMEANS_ASSIGN_MIN_BLOCKS=2",), 8, 256),
    ("4 points a thread, 512 threads", ("-DKMEANS_ASSIGN_TM=4",), 4, 512),
)


def tiled_part(old_general: pathlib.Path | None):
    """The tiled kernel's SASS, tile variants and, with ``old_general``,
    the earlier general kernel against it (module docstring)."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import kmeans_assign as ka

    tiled_loop_report(build._target("kmeans_assign"), "kmeans_assign")
    name = "kmeans_assign_tiled_kernel"
    jobs = {f"kmeans_assign_v{i}": (build.CSRC / "kmeans_assign.cu", defines)
            for i, (_, defines, _, _) in enumerate(TILED_VARIANTS)}
    if old_general:
        jobs["kmeans_assign_old_general"] = (old_general, ())
    built = build_libs(jobs)
    c, n, k, d = cs.ASSIGN_LM_TABLE
    x, cent = cs.tiled_assign_inputs(c, n, k, d, "cuda")
    want = ka.kmeans_assign(x, cent)

    def port():
        return ka.kmeans_assign(x, cent)

    rows = []
    for i, (label, defines, points, threads) in enumerate(TILED_VARIANTS):
        path, ptxas = built[f"kmeans_assign_v{i}"]
        run = batched_launcher(path, points, threads)
        rows.append({"variant": label, "defines": defines, "ptxas": ptxas,
                     "picks_equal": torch.equal(run(x, cent), want),
                     "run": (lambda run=run: run(x, cent))})
    times = [cs.device_ms(port, name, iters=10)]
    for row in rows:
        row["device_ms"] = cs.device_ms(row.pop("run"), name, iters=10)
    times.append(cs.device_ms(port, name, iters=10))
    print(json.dumps({"c": c, "n": n, "k": k, "d": d, "tiles": ka.tiles(n, c, k, d)._asdict(),
                      "bound_ms": cs.assign_bound(n, k, d, c)[0],
                      "port_device_ms_first_last": times, "variants": rows,
                      "clocks_sm_max_power_temp_under_load": clocks_during(port)}), flush=True)
    if not old_general:
        return
    path, ptxas = built["kmeans_assign_old_general"]
    print(json.dumps({"old_general_ptxas": ptxas}), flush=True)
    old = batched_launcher(path, 1, 256)  # its general kernel: a point a thread, 256 threads
    for c, n, k, d, ties in (*cs.ASSIGN_GENERAL, (*cs.ASSIGN_LM_TABLE, False)):
        x, cent = cs.tiled_assign_inputs(c, n, k, d, "cuda")
        if ties:
            cs.plant_ties(x, cent)
        new = ka.kmeans_assign(x, cent)
        row = {"c": c, "n": n, "k": k, "d": d, "ties": ties,
               "old_picks_equal": torch.equal(old(x, cent), new)}
        runs = [("old", lambda: old(x, cent), "kmeans_assign_general_kernel"),
                ("new", lambda: ka.kmeans_assign(x, cent), name)]
        row["old_new_new_old"] = [dict(which=w, **timed(f, kn))
                                  for w, f, kn in (runs[0], runs[1], runs[1], runs[0])]
        print(json.dumps(row), flush=True)


def inputs(n, k, d, c=None, device="cuda"):
    """chip_smoke's kmeans-phase inputs: x (n, d), centroids (k, d) from a
    generator seeded with n (with c: (c, n, d) and (c, k, d))."""
    import torch

    g = torch.Generator(device=device).manual_seed(n)
    lead = () if c is None else (c,)
    return (torch.randn(lead + (n, d), generator=g, device=device),
            torch.randn(lead + (k, d), generator=g, device=device))


def host_and_busy(fn, reps: int = 3):
    """(median host ms of ``fn`` between two synchronisations, device busy ms)."""
    import torch

    import chip_smoke as cs

    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(host), cs.device_busy_ms(fn)


def clocks_during(fn, seconds: float = 1.0) -> str:
    """``nvidia-smi``'s SM clock (now and its maximum), power draw and
    temperature, read a third of the way through ``seconds`` of
    back-to-back calls of ``fn``."""
    import threading

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    calls = max(1, int(seconds / max(time.perf_counter() - t0, 1e-6)))
    seen = []

    def query():
        time.sleep(seconds / 3)
        seen.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip())

    th = threading.Thread(target=query)
    th.start()
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        for _ in range(min(calls, 200)):
            fn()
    torch.cuda.synchronize()
    th.join()
    return seen[0] if seen else "not read"


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import kmeans_assign as ka

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("d4", "tiled"), help="one kernel's part only")
    ap.add_argument("--old", type=pathlib.Path,
                    help="an earlier kmeans_assign.cu with the one-column C interface")
    ap.add_argument("--old-general", type=pathlib.Path,
                    help="an earlier kmeans_assign.cu with this C interface and the "
                         "one-point-a-thread general kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_kmeans_assign: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}")
    build.library("kmeans_assign")
    print(json.dumps({"ptxas": [ln.strip() for ln in build.BUILD_LOGS.get(
        "kmeans_assign", "").splitlines() if "registers" in ln or "spill" in ln
        or "Compiling entry" in ln]}), flush=True)
    if args.only != "d4":
        tiled_part(args.old_general)
    if args.only == "tiled":
        return 0
    loop_report(build._target("kmeans_assign"), "kmeans_assign")
    old = None
    if args.old:
        path, ptxas = build_lib(args.old, "kmeans_assign_old")
        old = old_launcher(path)
        print(json.dumps({"old_ptxas": ptxas}), flush=True)
        for name, loops in sass_loops(path).items():
            # the centroid loop: the shortest loop holding a compare, one a pair
            loops = [lp for lp in loops if lp[0].get("FSETP")]
            if "kmeans_assign_kernelILi4E" in name and loops:
                ops, length = min(loops, key=lambda lp: lp[1])
                print(json.dumps({"old_sass_loop": name, "instructions": length,
                                  "pairs (one FSETP a pair)": ops["FSETP"],
                                  "per_pair": length / ops["FSETP"],
                                  "by_opcode": dict(ops.most_common())}), flush=True)
    # the FFMA floor: this source with the loop's min, compare and selects taken out
    ffma_only, ptxas = build_lib(build.CSRC / "kmeans_assign.cu", "kmeans_assign_ffma_only",
                                 "-DKMEANS_ASSIGN_FFMA_ONLY")
    print(json.dumps({"ffma_only_ptxas": ptxas}), flush=True)
    loop_report(ffma_only, "ffma_only")

    sm = torch.cuda.get_device_properties(0).multi_processor_count
    name = "kmeans_assign_kernel"
    for n, k, d in cs.ASSIGN_SHAPES:
        x, cent = inputs(n, k, d)
        pick = ka.assign_geometry(n, 1, k, d, sm)
        want = ka.kmeans_assign(x, cent)

        def this():
            return ka.kmeans_assign(x, cent)

        row = {"n": n, "k": k, "d": d, "geometry": pick, "bound_ms": cs.assign_bound(n, k, d)[0],
               "clocks_sm_max_power_temp_under_load": clocks_during(this)}
        if old is not None:
            row["old_picks_equal"] = torch.equal(old(x, cent), want)
            row["old_new_new_old_ms"] = [cs.device_ms(f, name) for f in (
                lambda: old(x, cent), this, this, lambda: old(x, cent))]
        floor_run = batched_launcher(ffma_only, *pick)
        floor = (lambda: floor_run(x[None], cent[None]))
        row["this_ffma_only_ffma_only_this_ms"] = [cs.device_ms(f, name)
                                                   for f in (this, floor, floor, this)]
        times = {}
        for p, t in [(p, t) for p in ka.POINTS for t in ka.THREADS]:
            out = torch.empty(n, dtype=torch.int32, device="cuda")
            shape = ka.check_args(x, cent, out)
            ka._launch(x, cent, out, shape, p, t)
            if not torch.equal(out, want):
                row[f"picks differ at {p}x{t}"] = int((out != want).sum())
            times[f"{p}x{t}"] = cs.device_ms(lambda: ka._launch(x, cent, out, shape, p, t), name)
        row["device_ms_by_geometry"] = times
        print(json.dumps(row), flush=True)

    c, n, k, d = BATCHED
    x, cent = inputs(n, k, d, c=c)
    got = ka.kmeans_assign(x, cent)
    cols = [ka.kmeans_assign(x[i], cent[i]) for i in range(c)]
    row = {"c": c, "n": n, "k": k, "d": d, "geometry": ka.assign_geometry(n, c, k, d, sm),
           "equal_to_columns": all(torch.equal(got[i], cols[i]) for i in range(c)),
           "batched_ms": cs.device_ms(lambda: ka.kmeans_assign(x, cent), name),
           "four_launches_busy_ms": cs.device_busy_ms(
               lambda: [ka.kmeans_assign(x[i], cent[i]) for i in range(c)], iters=100)}
    out = torch.empty_like(got)
    shape = ka.check_args(x, cent, out)
    row["device_ms_by_geometry"] = {
        f"{p}x{t}": cs.device_ms(lambda: ka._launch(x, cent, out, shape, p, t), name)
        for p in ka.POINTS for t in ka.THREADS}
    if old is not None:
        row["old_equal"] = all(torch.equal(old(x[i], cent[i]), got[i]) for i in range(c))
    print(json.dumps(row), flush=True)

    if old is not None:
        print(json.dumps(assign_all_before_after(old)), flush=True)
    return 0


def assign_all_before_after(old) -> dict:
    """``CCE.assign_all`` over the vocabularies of every CCE table of the
    full Criteo configuration (random tables and centroids from a seed,
    chunks of ``emb_cluster_chunk``), as it was (``old``: a launch and a
    copy a column and chunk) and as it is (one launch a chunk): whether the
    pointers agree, the launches now, and host ms and device busy of each,
    old, new, new, old."""
    import torch

    from repro_torch.configs.dlrm_criteo import CONFIG
    from repro_torch.core.cce import CCE
    from repro_torch.kernels import build

    chunk = CONFIG.emb_cluster_chunk
    tables = []
    for i, t in enumerate(CONFIG.collection.tables):
        if isinstance(t, CCE):
            params, buffers = t.init(torch.Generator().manual_seed(i), device="cuda")
            cent = torch.randn((t.c, t.k, t.dsub), device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(i))
            tables.append((t, params, buffers, cent))

    def before():
        outs = []
        for t, params, buffers, cent in tables:
            out = torch.empty((t.c, t.d1), dtype=torch.int32, device="cuda")
            for s, ids in t._id_chunks(chunk, "cuda"):
                emb = t.materialize(params, buffers, ids)
                for i in range(t.c):
                    out[i, s: s + ids.shape[0]] = old(emb[i].contiguous(), cent[i])
            outs.append(out)
        return outs

    def after():
        return [t.assign_all(params, buffers, cent, chunk_size=chunk)
                for t, params, buffers, cent in tables]

    row = {"tables": len(tables), "ids": sum(t.d1 for t, *_ in tables), "chunk": chunk,
           "pointers_equal": all(torch.equal(a, b) for a, b in zip(before(), after()))}
    build.LAUNCHES.clear()
    after()
    row["launches_after"] = build.LAUNCHES["kmeans_assign"]
    runs = [("old", before), ("new", after), ("new", after), ("old", before)]
    row["old_new_new_old"] = [dict(zip(("which", "host_ms", "device_busy_ms"),
                                       (w, *host_and_busy(f)))) for w, f in runs]
    return row


if __name__ == "__main__":
    sys.exit(main())
