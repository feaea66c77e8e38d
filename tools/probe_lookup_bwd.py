#!/usr/bin/env python3
"""Phase times of the CCE lookup backward kernel on one GPU, and the
kernel against variant builds of its source.

    python3 tools/probe_lookup_bwd.py [--layout vec4|narrow] [--old OLD.cu]

Builds ``src/repro_torch/kernels/csrc/cce_lookup_bwd.cu`` again into
``build/repro_torch/probe/``:
- with ``-DCCE_BWD_STAMPS``: every CTA then meets at a barrier at the start
  and the end of each phase of its first chunk, and thread 0 writes
  ``%globaltimer`` once all have;
- with ``-DCCE_BWD_HOT_TERMS=2048``: no row is split along d, each is
  walked by its owner alone;
- with ``--old OLD.cu``, that source as it is (an earlier commit's
  ``cce_lookup_bwd.cu``, unpacked with its header, e.g. by ``git
  archive``), timed as one more variant.
``--layout vec4`` (the default) runs them at the Criteo train shape (c=104,
T=2, k=305, dsub=4, float32, B=2048); ``--layout narrow`` at the hashing
trick's supertable (``emb_method="hash"``: c=26, T=1, k=500, dsub=16,
float32, B=2048).  Each on the three inputs of ``chip_smoke.py``'s ``bwd``
phase (uniform rows, a train batch's Zipf rows, one row a column), checks
each build against the plain version, and prints one JSON line a case: for
each phase the median and the largest ns over CTAs and calls, the same for
each CTA's start after the grid's first, the median span from the grid's
first start to its last end (the stamped build adds a barrier a stamp: its
phase shares, not its total, are what it measures), and the device ms of
the port's build and of each variant, timed in the order A B C C B A,
with the SM clock that ``nvidia-smi`` reads every 50 ms meanwhile (median
and largest MHz).
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("load idx, zero counts", "rank", "scan", "place rows", "walk", "store")
CALLS = 20
STAMPS = len(PHASES) + 1
LAYOUTS = ("vec4", "narrow")
# -D switches of the variants the port's build is timed against: name -> defines
VARIANTS = {"unsplit": ("-DCCE_BWD_HOT_TERMS=2048",)}


def build_variant(name: str, layout: str, *defines: str, src: pathlib.Path | None = None):
    """``src`` (the port's cce_lookup_bwd.cu by default) built with
    ``defines`` as ``lib<name>.so``; prints ptxas' registers and spill of
    its float32 ``layout`` kernel."""
    from repro_torch.kernels import build

    import chip_smoke as cs

    out = build.BUILD_DIR / "probe" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = src or build.CSRC / "cce_lookup_bwd.cu"
    log = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *defines, "-o", str(out), str(src)],
                         check=True, capture_output=True, text=True)
    regs = {fn: r for fn, r in cs.ptxas_registers(log.stdout + log.stderr).items()
            if f"{layout}_kernelIf" in fn}  # float32
    print(f"{name}: ptxas (registers, spill store bytes) of the float32 {layout} kernel: "
          f"{sorted(regs.values())}", flush=True)
    lib = ctypes.CDLL(str(out))
    lib.cce_lookup_bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
    return lib


def launcher(lib, layout: str):
    """fn(idx, dout, k) -> dtab through ``lib``'s float32 kernel of ``layout``."""
    import torch

    from repro_torch.kernels import cce_lookup as cl

    def fn(idx, dout, k):
        c, B, T = idx.shape
        if cl.lookup_path(dout.shape[2], dout.element_size(), dout.data_ptr()) != layout:
            raise RuntimeError(f"the probe times the {layout} layout")
        dtab = torch.empty((c, T, k, dout.shape[2]), device=dout.device)
        err = lib.cce_lookup_bwd(idx.data_ptr(), dout.data_ptr(), dtab.data_ptr(), 0, c, B, T, k,
                                 dout.shape[2], *idx.stride(), cl.PATHS.index(layout),
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe backward launch failed ({err})")
        return dtab

    return fn


def phases(lib, layout: str, idx, dout, k: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ref

    c, B, T = idx.shape
    if k > 512:
        raise RuntimeError("the probe reads one CTA a (column, sub-table): k <= 512")
    n_ctas = c * T
    run = launcher(lib, layout)
    per_phase = [[] for _ in PHASES]
    starts, spans = [], []
    host = np.zeros((n_ctas, STAMPS), dtype=np.uint64)
    for _ in range(CALLS):
        dtab = run(idx, dout, k)
        torch.cuda.synchronize()
        if lib.cce_lookup_bwd_stamps(host.ctypes.data, n_ctas):
            raise RuntimeError("reading the stamps failed")
        if not torch.equal(dtab, ref.cce_lookup_bwd_ref(idx, dout, k)):
            raise RuntimeError("stamped backward != plain")
        s = host.astype(np.int64)
        for i in range(len(PHASES)):
            per_phase[i].extend((s[:, i + 1] - s[:, i]).tolist())
        starts.extend((s[:, 0] - s[:, 0].min()).tolist())
        spans.append(int(s[:, -1].max() - s[:, 0].min()))
    return {"phase_ns_median_max": {name: [statistics.median(p), max(p)]
                                    for name, p in zip(PHASES, per_phase)},
            "start_ns_median_max": [statistics.median(starts), max(starts)],
            "span_ns_median": statistics.median(spans)}


def against_variants(variants: dict, layout: str, idx, dout, k: int) -> dict:
    """Device ms of the port's kernel and of each variant build on the same
    input, in the order A B C ... C B A, after checking each against the
    plain version."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ref

    want = ref.cce_lookup_bwd_ref(idx, dout, k)
    fns = {"port_ms": lambda: cl.cce_lookup_bwd(idx, dout, k)}
    for name, lib in variants.items():
        run = launcher(lib, layout)
        fns[f"{name}_ms"] = lambda run=run: run(idx, dout, k)
    for key, fn in fns.items():
        if not torch.equal(fn(), want):
            raise RuntimeError(f"the {key[:-3]} build of the backward != plain")
    name = f"cce_lookup_bwd_{layout}_kernel"
    order = list(fns) + list(fns)[::-1]
    times = {key: [] for key in fns}
    clocks = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                               "--format=csv,noheader,nounits", "-lms", "50"],
                              stdout=subprocess.PIPE, text=True)
    try:
        for key in order:
            times[key].append(cs.device_ms(fns[key], name))
    finally:
        clocks.terminate()
    mhz = [float(x) for x in clocks.communicate()[0].split() if x.strip().isdigit()]
    times["sm_clock_mhz_median_max"] = [statistics.median(mhz), max(mhz)] if mhz else None
    return times


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.configs.dlrm_criteo import CONFIG

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layout", choices=LAYOUTS, default="vec4",
                    help="vec4: the Criteo train shape; narrow: the hashing trick's supertable")
    ap.add_argument("--old", type=pathlib.Path,
                    help="an earlier cce_lookup_bwd.cu, built and timed as one more variant")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_lookup_bwd: no CUDA device", file=sys.stderr)
        return 1
    cfg = CONFIG if args.layout == "vec4" else dataclasses.replace(CONFIG, emb_method="hash")
    stamped = build_variant(f"cce_lookup_bwd_{args.layout}_stamps", args.layout,
                            "-DCCE_BWD_STAMPS")
    stamped.cce_lookup_bwd_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    variants = {name: build_variant(f"cce_lookup_bwd_{args.layout}_{name}", args.layout, *defines)
                for name, defines in VARIANTS.items()}
    if args.old:
        variants["old"] = build_variant(f"cce_lookup_bwd_{args.layout}_old", args.layout,
                                        src=args.old.resolve())
    coll = cfg.collection
    (g,) = coll.univ_groups
    grp = coll.groups[g]
    k = grp.k_pad
    ks = torch.tensor(cs.column_ks(coll), device="cuda")
    uniform, dout = cs.bwd_case(coll, cs.TRAIN_BATCH, torch.float32, seed=100 + cs.TRAIN_BATCH)
    skewed, dout_s = cs.bwd_train_case(cfg, cs.TRAIN_BATCH, seed=3)
    valid = (uniform >= 0) & (uniform < ks[:, None, None])
    one_row = torch.where(valid, (ks - 1).to(torch.int32)[:, None, None], uniform)
    print(f"card: {cs.card_line()}")
    print(f"layout {args.layout}: c={grp.n_cols} T={grp.n_tables} k={k} dsub={grp.dsub} "
          f"B={cs.TRAIN_BATCH}", flush=True)
    for label, idx, d in (("uniform", uniform, dout), ("skewed train batch", skewed, dout_s),
                          ("one row a column", one_row, dout)):
        print(json.dumps({"case": label, "layout": args.layout, "B": cs.TRAIN_BATCH,
                          "hottest_row_share": cs.hottest_share(idx, k),
                          **phases(stamped, args.layout, idx, d, k),
                          **against_variants(variants, args.layout, idx, d, k)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
