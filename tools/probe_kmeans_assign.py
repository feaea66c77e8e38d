#!/usr/bin/env python3
"""The k-means assignment kernel on one GPU: its instructions a pair, its
launch geometries, and the kernel against an earlier build of it.

    python3 tools/probe_kmeans_assign.py [--old OLD.cu]

- Prints ptxas' registers and spills of ``csrc/kmeans_assign.cu`` and,
  from ``cuobjdump -sass``, the instructions of each d = 4 kernel's
  centroid loop by opcode, and over the (point, centroid) pairs one pass
  of the loop covers.
- At ``chip_smoke.ASSIGN_SHAPES`` (an ``assign_all`` chunk, a Lloyd
  sample), on ``chip_smoke``'s inputs: the device ms of every geometry
  (points a thread, threads a CTA) of the d = 4 kernel, each one's picks
  equal to the geometry ``assign_geometry`` picks; and at the batched
  chunk (c=4 columns in one launch) against four one-column launches.
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


def build_lib(src: pathlib.Path, name: str, *defines: str):
    """``src`` built with the port's flags (and ``defines``) as
    ``lib<name>.so`` under ``build/repro_torch/probe``; returns (path,
    ptxas lines)."""
    from repro_torch.kernels import build

    out = build.BUILD_DIR / "probe" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *defines, "-o", str(out), str(src)],
                          check=True, capture_output=True, text=True)
    return out, [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


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


def variant_launcher(path: pathlib.Path):
    """assign(x (n, d), cent (k, d), points, threads) -> (n,) through
    another build of this kernel."""
    import torch

    from repro_torch.kernels import kmeans_assign as ka

    fn = ctypes.CDLL(str(path)).kmeans_assign
    fn.argtypes = ka._kernel().argtypes
    fn.restype = ctypes.c_int

    def assign(x, cent, points, threads):
        out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
        err = fn(x.data_ptr(), cent.data_ptr(), out.data_ptr(), 1, x.shape[0], cent.shape[0],
                 x.shape[1], x.shape[0], points, threads, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant kmeans_assign launch failed ({err})")
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
    ap.add_argument("--old", type=pathlib.Path, help="an earlier kmeans_assign.cu to compare")
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
    path, ptxas = build_lib(build.CSRC / "kmeans_assign.cu", "kmeans_assign_ffma_only",
                            "-DKMEANS_ASSIGN_FFMA_ONLY")
    ffma_only = variant_launcher(path)
    print(json.dumps({"ffma_only_ptxas": ptxas}), flush=True)
    loop_report(path, "ffma_only")

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
        floor = (lambda: ffma_only(x, cent, *pick))
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
