#!/usr/bin/env python3
"""Phase times of the CCE lookup backward kernel on one GPU, and the
kernel with and without its hot-row split.

    python3 tools/probe_lookup_bwd.py

Builds ``src/repro_torch/kernels/csrc/cce_lookup_bwd.cu`` twice more into
``build/repro_torch/probe/``:
- with ``-DCCE_BWD_STAMPS``: every CTA then meets at a barrier at the start
  and the end of each phase of its first chunk, and thread 0 writes
  ``%globaltimer`` once all have;
- with ``-DCCE_BWD_HOT_TERMS=2048``: no row is split along d, each is
  walked by its owner alone.
Runs them at the Criteo train shape (c=104, T=2, k=305, dsub=4, float32,
B=2048) on the three inputs of ``chip_smoke.py``'s ``bwd`` phase (uniform
rows, a train batch's Zipf rows, one row a column), checks each against
the plain version, and prints one JSON line a case: for each phase the
median and the largest ns over CTAs and calls, the same for each CTA's
start after the grid's first, the median span from the grid's first start
to its last end (the stamped build adds a barrier a stamp: its phase
shares, not its total, are what it measures), and the device ms of the
port's build and of the unsplit one, timed in the order A B B A.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("load idx, zero counts", "rank (ballots)", "scan", "place rows", "walk", "store")
CALLS = 20
STAMPS = len(PHASES) + 1


def build_variant(name: str, *defines: str):
    """cce_lookup_bwd.cu built with ``defines`` as ``lib<name>.so``."""
    from repro_torch.kernels import build

    out = build.BUILD_DIR / "probe" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *defines, "-o", str(out),
                    str(build.CSRC / "cce_lookup_bwd.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.cce_lookup_bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
    return lib


def launcher(lib):
    """fn(idx, dout, k) -> dtab through ``lib``'s vec4 float32 kernel."""
    import torch

    from repro_torch.kernels import cce_lookup as cl

    def fn(idx, dout, k):
        c, B, T = idx.shape
        if cl.lookup_path(dout.shape[2], dout.element_size(), dout.data_ptr()) != "vec4":
            raise RuntimeError("the probe times the vec4 layout")
        dtab = torch.empty((c, T, k, dout.shape[2]), device=dout.device)
        err = lib.cce_lookup_bwd(idx.data_ptr(), dout.data_ptr(), dtab.data_ptr(), 0, c, B, T, k,
                                 dout.shape[2], *idx.stride(), cl.PATHS.index("vec4"),
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe backward launch failed ({err})")
        return dtab

    return fn


def phases(lib, idx, dout, k: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ref

    c, B, T = idx.shape
    n_ctas = c * T  # k <= 512: one CTA a (column, sub-table)
    run = launcher(lib)
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


def split_or_not(unsplit, idx, dout, k: int) -> dict:
    """Device ms of the port's kernel (hot rows split along d) and of the
    unsplit build on the same input, in the order A B B A."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ref

    run = launcher(unsplit)
    want = ref.cce_lookup_bwd_ref(idx, dout, k)
    if not (torch.equal(cl.cce_lookup_bwd(idx, dout, k), want) and torch.equal(run(idx, dout, k),
                                                                                 want)):
        raise RuntimeError("a build of the backward != plain")
    name = "cce_lookup_bwd_vec4_kernel"
    times = {"split_ms": [], "unsplit_ms": []}
    for key in ("split_ms", "unsplit_ms", "unsplit_ms", "split_ms"):
        fn = (lambda: cl.cce_lookup_bwd(idx, dout, k)) if key == "split_ms" else (
            lambda: run(idx, dout, k))
        times[key].append(cs.device_ms(fn, name))
    return times


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.configs.dlrm_criteo import CONFIG

    if not torch.cuda.is_available():
        print("probe_lookup_bwd: no CUDA device", file=sys.stderr)
        return 1
    stamped = build_variant("cce_lookup_bwd_stamps", "-DCCE_BWD_STAMPS")
    stamped.cce_lookup_bwd_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    unsplit = build_variant("cce_lookup_bwd_unsplit", "-DCCE_BWD_HOT_TERMS=2048")
    coll = CONFIG.collection
    (g,) = coll.univ_groups
    k = coll.groups[g].k_pad
    ks = torch.tensor(cs.column_ks(coll), device="cuda")
    uniform, dout = cs.bwd_case(coll, cs.TRAIN_BATCH, torch.float32, seed=100 + cs.TRAIN_BATCH)
    skewed, dout_s = cs.bwd_train_case(CONFIG, cs.TRAIN_BATCH, seed=3)
    valid = (uniform >= 0) & (uniform < ks[:, None, None])
    one_row = torch.where(valid, (ks - 1).to(torch.int32)[:, None, None], uniform)
    print(f"card: {cs.card_line()}")
    for label, idx, d in (("uniform", uniform, dout), ("skewed train batch", skewed, dout_s),
                          ("one row a column", one_row, dout)):
        print(json.dumps({"case": label, "B": cs.TRAIN_BATCH, **phases(stamped, idx, d, k),
                          **split_or_not(unsplit, idx, d, k)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
