#!/usr/bin/env python3
"""Phase times of the CCE lookup backward on one GPU, and the port's build
against variant builds of its source.

    python3 tools/probe_lookup_bwd.py [--layout vec4|narrow|wide_vector] [--old OLD.cu]
    python3 tools/probe_lookup_bwd.py --widths [--old OLD.cu]

Builds ``src/repro_torch/kernels/csrc/cce_lookup_bwd.cu`` again into
``build/repro_torch/probe/``:
- with ``-DCCE_BWD_STAMPS``, which stamps ``%globaltimer``:
  - vec4 and narrow (one kernel): every CTA meets at a barrier at the start
    and the end of each phase of its first chunk, and thread 0 writes the
    time once all have;
  - wide_vector (a sort kernel, then a walk kernel): each sort CTA at a
    barrier after each of its phases, lane 0 of each walk warp at its
    start, once its row starts are in, and after its last store, beside the
    count of terms it walked, and thread 0 of each hot CTA at its start and
    end, beside the terms of the hot rows it walked;
- with the layout's variant switches (VARIANTS; none at the wide layouts,
  whose variants are geometries: ``--widths`` walks the port's build at
  every rows-a-warp of ``ROWS_PER_WARP``);
- with ``--old OLD.cu``, that source as it is (an earlier commit's
  ``cce_lookup_bwd.cu``, unpacked with its header, e.g. by ``git
  archive``), stamped and timed as one more variant.  A source without the
  two wide kernels (before the sort-once design) takes the one-kernel
  stamps at every layout.
``--layout vec4`` (the default) runs them at the Criteo train shape (c=104,
T=2, k=305, dsub=4, float32, B=2048); ``--layout narrow`` at the hashing
trick's supertable (``emb_method="hash"``: c=26, T=1, k=500, dsub=16,
float32, B=2048); ``--layout wide_vector`` at the LM train shape
(qwen2-1.5b's token table: c=4, T=2, k=4748, dsub=384, float32, B=8192).
Each on three inputs: uniform rows; a train batch's rows (Zipf ids through
``group_rows``; at the LM shape a training step's token rows); every valid
index of a column on one row.  Checks each build against the plain
version, and prints one JSON line a case: for each phase the median and
the largest ns over CTAs (or warps) and calls, the same for each CTA's
start after the kernel's first, the median span from the kernel's first
start to its last end (the stamped build adds a barrier a stamp: its phase
shares, not its total, are what it measures), and the device ms of every
kernel of a call of the port's build and of each variant, timed in the
order A B C C B A, with the SM clock that ``nvidia-smi`` reads every 50 ms
meanwhile (median and largest MHz).  ``--widths`` instead runs at every width of
``chip_smoke.py``'s WIDE_LOOKUP whose float32 rows take a wide layout
(B=2048, its random rows) and at the token tables of its WIDE_BWD_TABLES
(a training step's rows), one JSON line each: the stamps of the port's
build, and the device ms of the port's build, of ``--old`` and of the
port's build at each other rows-a-warp of ROWS_PER_WARP (A B C .. C B A).
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

# the one-kernel design (vec4, narrow; every layout before the sort-once
# wide design): stamps at the phases of a CTA's first chunk, then the store
CHUNK_PHASES = ("load idx, zero counts", "rank", "scan", "place rows", "walk", "store")
CHUNK_RANGE = {"vec4": 512, "narrow": 512, "wide_vector": 64}  # rows a CTA owns
# the wide layouts' sort kernel, a CTA a (column, sub-table, b-chunk, row range)
SORT_PHASES = ("load idx, clear counts", "rank", "count", "scan", "place")
# the wide layouts' walk kernel, a warp a block of rows and a slice of d
WALK_PHASES = ("load row starts", "walk and store")
CALLS = 20
STAMP_CTAS = 4096  # the one-kernel build stamps its first 4096 CTAs of grid row 0
LAYOUTS = ("vec4", "narrow", "wide_vector")
# -D switches of the variants the port's build is timed against: name -> defines
VARIANTS = {
    "vec4": {"unsplit": ("-DCCE_BWD_HOT_TERMS=2048",)},
    "narrow": {"unsplit": ("-DCCE_BWD_HOT_TERMS=2048",)},
}
ROWS_PER_WARP = (1, 2, 4, 8, 16, 32)  # the wide walk's rows a warp that --widths times
HOT_SCAN = 128  # rows a hot CTA of the wide walk scans (kHotScan)


def sort_once(lib) -> bool:
    """Whether ``lib`` holds the wide layouts' sort and walk kernels."""
    return hasattr(lib, "cce_lookup_bwd_wide")


def build_variant(name: str, layout: str, *defines: str, src: pathlib.Path | None = None):
    """``src`` (the port's cce_lookup_bwd.cu by default) built with
    ``defines`` as ``lib<name>.so``; prints ptxas' registers and spill of
    the kernels a float32 ``layout`` call launches."""
    from repro_torch.kernels import build

    import chip_smoke as cs

    out = build.BUILD_DIR / "probe" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = src or build.CSRC / "cce_lookup_bwd.cu"
    log = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *defines, "-o", str(out), str(src)],
                         check=True, capture_output=True, text=True)
    regs = {fn: r for fn, r in cs.ptxas_registers(log.stdout + log.stderr).items()
            if f"{layout}_kernelIf" in fn or "sort_kernel" in fn}  # float32
    print(f"{name}: ptxas (registers, spill store bytes) of the float32 {layout} call's "
          f"kernels: {sorted(regs.values())}", flush=True)
    return with_argtypes(ctypes.CDLL(str(out)))


def with_argtypes(lib):
    """``lib`` with the argument types of its backward entry points."""
    lib.cce_lookup_bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
    if sort_once(lib):
        lib.cce_lookup_bwd_wide.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
            ctypes.c_int] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


def geometry(c: int, B: int, T: int, k: int, dsub: int, layout: str, overrides=None):
    """The port's wide geometry for a float32 call, with the fields of
    ``overrides`` (a dict) in place of its own, and its sort CTAs, walk
    warps and hot CTAs over every slice of d."""
    from repro_torch.kernels import cce_lookup as cl

    n_slices = cl.wide_slices(dsub, 4, layout)
    g = cl.wide_bwd_geometry(c, B, T, k, n_slices, cl.wide_groups(dsub, 4, layout))
    g = g._replace(**(overrides or {}))
    n_ranges = -(-k // g.range_rows)
    return g, (c * T * g.n_chunks * n_ranges, c * T * n_slices * -(-k // g.rows_per_warp),
               c * T * n_slices * -(-k // HOT_SCAN))


def launcher(lib, layout: str, overrides=None):
    """fn(idx, dout, k) -> dtab through ``lib``'s float32 kernels of
    ``layout`` (wide: in its geometry with ``overrides``)."""
    import torch

    from repro_torch.kernels import cce_lookup as cl

    wide = layout.startswith("wide") and sort_once(lib)

    def fn(idx, dout, k):
        c, B, T = idx.shape
        dsub = dout.shape[2]
        if cl.lookup_path(dsub, dout.element_size(), dout.data_ptr()) != layout:
            raise RuntimeError(f"the probe times the {layout} layout")
        dtab = torch.empty((c, T, k, dsub), device=dout.device)
        stream = torch.cuda.current_stream().cuda_stream
        if wide:
            g = geometry(c, B, T, k, dsub, layout, overrides)[0]
            scratch = torch.empty(g.scratch_ints, dtype=torch.int32, device=dout.device)
            err = lib.cce_lookup_bwd_wide(idx.data_ptr(), dout.data_ptr(), dtab.data_ptr(),
                                          scratch.data_ptr(), g.scratch_ints, 0, c, B, T, k, dsub,
                                          *idx.stride(), cl.PATHS.index(layout), *g[:4], stream)
        else:
            err = lib.cce_lookup_bwd(idx.data_ptr(), dout.data_ptr(), dtab.data_ptr(), 0, c, B,
                                     T, k, dsub, *idx.stride(), cl.PATHS.index(layout), stream)
        if err:
            raise RuntimeError(f"probe backward launch failed ({err})")
        return dtab

    return fn


def _median_max(xs) -> list:
    return [statistics.median(xs), max(xs)]


def chunk_phases(lib, layout: str, idx, dout, k: int, want) -> dict:
    """The one-kernel design's stamps: a CTA's first chunk by phase."""
    import numpy as np
    import torch

    c, B, T = idx.shape
    n_ctas = min(STAMP_CTAS, c * T * -(-k // CHUNK_RANGE[layout]))
    run = launcher(lib, layout)
    per_phase = [[] for _ in CHUNK_PHASES]
    starts, spans = [], []
    host = np.zeros((n_ctas, len(CHUNK_PHASES) + 1), dtype=np.uint64)
    lib.cce_lookup_bwd_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for _ in range(CALLS):
        dtab = run(idx, dout, k)
        torch.cuda.synchronize()
        if lib.cce_lookup_bwd_stamps(host.ctypes.data, n_ctas):
            raise RuntimeError("reading the stamps failed")
        if not torch.equal(dtab, want):
            raise RuntimeError("stamped backward != plain")
        s = host.astype(np.int64)
        for i in range(len(CHUNK_PHASES)):
            per_phase[i].extend((s[:, i + 1] - s[:, i]).tolist())
        starts.extend((s[:, 0] - s[:, 0].min()).tolist())
        spans.append(int(s[:, -1].max() - s[:, 0].min()))
    return {"stamped_ctas": n_ctas,
            "phase_ns_median_max": {name: _median_max(p) for name, p in zip(CHUNK_PHASES,
                                                                            per_phase)},
            "start_ns_median_max": _median_max(starts),
            "span_ns_median": statistics.median(spans)}


def wide_phases(lib, layout: str, idx, dout, k: int, want) -> dict:
    """The sort-once design's stamps: each sort CTA by phase, each walk warp
    (its row starts, then its walk and stores, and its count of terms),
    each kernel's span and the gap between them."""
    import numpy as np
    import torch

    c, B, T = idx.shape
    g, (n_sort, n_walk, n_hot) = geometry(c, B, T, k, dout.shape[2], layout)
    run = launcher(lib, layout)
    lib.cce_lookup_bwd_wide_stamps.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    sort_host = np.zeros((n_sort, len(SORT_PHASES) + 1), dtype=np.uint64)
    walk_host = np.zeros((n_walk, len(WALK_PHASES) + 2), dtype=np.uint64)  # + terms
    hot_host = np.zeros((n_hot, 3), dtype=np.uint64)  # start, end, terms
    sort_phase = [[] for _ in SORT_PHASES]
    walk_phase = [[] for _ in WALK_PHASES]
    sort_starts, sort_spans, walk_spans, gaps, longest, hot = [], [], [], [], [], []
    for _ in range(CALLS):
        dtab = run(idx, dout, k)
        torch.cuda.synchronize()
        if (lib.cce_lookup_bwd_wide_stamps(0, sort_host.ctypes.data, n_sort)
                or lib.cce_lookup_bwd_wide_stamps(1, walk_host.ctypes.data, n_walk)
                or lib.cce_lookup_bwd_wide_stamps(2, hot_host.ctypes.data, n_hot)):
            raise RuntimeError("reading the stamps failed")
        if not torch.equal(dtab, want):
            raise RuntimeError("stamped backward != plain")
        s, w, h = (x.astype(np.int64) for x in (sort_host, walk_host, hot_host))
        busy = h[:, 2] > 0  # hot CTAs that found a hot row
        slow = int(np.argmax(h[:, 1] - h[:, 0]))
        hot.append([int(busy.sum()), int(h[:, 2].sum()), int(h[slow, 1] - h[slow, 0]),
                    int(h[slow, 2]), int(h[:, 1].max() - w[:, 0].min())])
        for i in range(len(SORT_PHASES)):
            sort_phase[i].extend((s[:, i + 1] - s[:, i]).tolist())
        for i in range(len(WALK_PHASES)):
            walk_phase[i].extend((w[:, i + 1] - w[:, i]).tolist())
        sort_starts.extend((s[:, 0] - s[:, 0].min()).tolist())
        sort_spans.append(int(s[:, -1].max() - s[:, 0].min()))
        walk_spans.append(int(w[:, 2].max() - w[:, 0].min()))
        gaps.append(int(w[:, 0].min() - s[:, -1].max()))
        slow = int(np.argmax(w[:, 2] - w[:, 0]))
        longest.append([int(w[slow, 2] - w[slow, 0]), int(w[slow, 3]),
                        int(w[slow, 0] - w[:, 0].min())])
    terms = walk_host[:, 3].astype(np.int64)
    return {"sort_ctas": n_sort, "walk_warps": n_walk, "rows_per_warp": g.rows_per_warp,
            "groups": g.groups,
            "sort_phase_ns_median_max": {n: _median_max(p) for n, p in zip(SORT_PHASES,
                                                                           sort_phase)},
            "sort_start_ns_median_max": _median_max(sort_starts),
            "sort_span_ns_median": statistics.median(sort_spans),
            "sort_end_to_walk_start_ns_median": statistics.median(gaps),
            "walk_phase_ns_median_max": {n: _median_max(p) for n, p in zip(WALK_PHASES,
                                                                           walk_phase)},
            "walk_terms_a_warp_median_max": _median_max(terms.tolist()),
            "walk_span_ns_median": statistics.median(walk_spans),
            "longest_warp_ns_terms_start_ns_median": [
                statistics.median(x) for x in zip(*longest)],
            "hot_ctas": n_hot,
            "hot_busy_ctas_terms_longest_ns_its_terms_end_ns_median": [
                statistics.median(x) for x in zip(*hot)]}


def phases(lib, layout: str, idx, dout, k: int, want) -> dict:
    if layout.startswith("wide") and sort_once(lib):
        return wide_phases(lib, layout, idx, dout, k, want)
    return chunk_phases(lib, layout, idx, dout, k, want)


def against_variants(variants: dict, layout: str, idx, dout, k: int, want) -> dict:
    """Device ms of every kernel of a call of the port's build and of each
    variant (a build, or (build, geometry overrides)) on the same input,
    in the order A B C ... C B A, after checking each against the plain
    version."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import cce_lookup as cl

    fns = {"port_ms": lambda: cl.cce_lookup_bwd(idx, dout, k)}
    for name, lib in variants.items():
        run = launcher(lib[0], layout, lib[1]) if isinstance(lib, tuple) else launcher(lib, layout)
        fns[f"{name}_ms"] = lambda run=run: run(idx, dout, k)
    for key, fn in fns.items():
        if not torch.equal(fn(), want):
            raise RuntimeError(f"the {key[:-3]} build of the backward != plain")
    order = list(fns) + list(fns)[::-1]
    times = {key: [] for key in fns}
    clocks = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                               "--format=csv,noheader,nounits", "-lms", "50"],
                              stdout=subprocess.PIPE, text=True)
    try:
        for key in order:
            times[key].append(cs.device_busy_ms(fns[key], iters=cs.TRACE_RECORDS))
    finally:
        clocks.terminate()
    mhz = [float(x) for x in clocks.communicate()[0].split() if x.strip().isdigit()]
    times["sm_clock_mhz_median_max"] = [statistics.median(mhz), max(mhz)] if mhz else None
    return times


def widths(stamped, old) -> None:
    """At each WIDE_LOOKUP width whose float32 rows take a wide layout (B =
    2048, random rows) and at each token table of WIDE_BWD_TABLES (a
    training step's rows): the stamps of ``stamped`` (the port's source),
    and the port's build against ``old`` (where given) and against itself
    at every other rows a walk warp of ROWS_PER_WARP."""
    import torch

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import build, ref

    port = with_argtypes(build.library("cce_lookup_bwd"))
    inputs = []  # (label, idx, k, dsub)
    for (c, T, k, dsub), paths in cs.WIDE_LOOKUP.items():
        if paths["float32"].startswith("wide"):
            idx, _ = cs.random_lookup(c, T, k, dsub, cs.TRAIN_BATCH, torch.float32, seed=dsub)
            inputs.append(("random rows", idx, k, dsub))
    for arch, (c, T, k, dsub) in cs.WIDE_BWD_TABLES.values():
        inputs.append((f"{arch}'s step rows", cs.lm_step_rows(configs.get(arch)), k, dsub))
    for label, idx, k, dsub in inputs:
        c, B, T = idx.shape
        gen = torch.Generator(device="cuda").manual_seed(dsub)
        dout = torch.randn((B, c, dsub), generator=gen, device="cuda")
        layout = cs.cl_path(dout)
        want = ref.cce_lookup_bwd_ref(idx, dout, k)
        line = {"shape": [c, T, k, dsub], "layout": layout, "B": B, "rows": label,
                "port_stamps": wide_phases(stamped, layout, idx, dout, k, want)}
        variants = {"old": old} if old else {}
        g = geometry(c, B, T, k, dsub, layout)[0]
        variants.update({f"rows_per_warp_{r}": (port, {"rows_per_warp": r})
                         for r in ROWS_PER_WARP
                         if r != g.rows_per_warp and r >= g.groups and r * g.n_chunks <= 1024})
        line.update(against_variants(variants, layout, idx, dout, k, want))
        print(json.dumps(line), flush=True)


def cases(layout: str):
    """(shape line, k, [(label, idx, dout)]) of the layout's three inputs."""
    import torch

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.configs.dlrm_criteo import CONFIG
    from repro_torch.models import lm

    if layout == "wide_vector":
        cfg = configs.get(cs.LM_ARCH)
        skewed = cs.lm_step_rows(cfg)
        c, B, T = skewed.shape
        table = lm.make_emb(cfg)
        k, dsub = table.k, table.dsub
        uniform, _ = cs.random_lookup(c, T, k, dsub, B, torch.float32, seed=dsub)
        ks = torch.full((c,), k, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(cs.LM_SEED)
        dout = torch.randn((B, c, dsub), generator=g, device="cuda")
        dout_s = dout
    else:
        cfg = CONFIG if layout == "vec4" else dataclasses.replace(CONFIG, emb_method="hash")
        coll = cfg.collection
        (gi,) = coll.univ_groups
        grp = coll.groups[gi]
        c, T, k, dsub, B = grp.n_cols, grp.n_tables, grp.k_pad, grp.dsub, cs.TRAIN_BATCH
        ks = torch.tensor(cs.column_ks(coll), device="cuda")
        uniform, dout = cs.bwd_case(coll, B, torch.float32, seed=100 + B)
        skewed, dout_s = cs.bwd_train_case(cfg, B, seed=3)
    valid = (uniform >= 0) & (uniform < ks[:, None, None])
    one_row = torch.where(valid, (ks - 1).to(torch.int32)[:, None, None], uniform)
    return (f"layout {layout}: c={c} T={T} k={k} dsub={dsub} B={B}", k,
            [("uniform", uniform, dout), ("skewed train batch", skewed, dout_s),
             ("one row a column", one_row, dout)])


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ref

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layout", choices=LAYOUTS, default="vec4",
                    help="vec4: the Criteo train shape; narrow: the hashing trick's "
                         "supertable; wide_vector: the LM train shape")
    ap.add_argument("--widths", action="store_true",
                    help="time the port against --old at WIDE_LOOKUP's wide widths instead")
    ap.add_argument("--old", type=pathlib.Path,
                    help="an earlier cce_lookup_bwd.cu, built, stamped and timed as one more "
                         "variant")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_lookup_bwd: no CUDA device", file=sys.stderr)
        return 1
    if args.widths:
        print(f"card: {cs.card_line()}")
        widths(build_variant("cce_lookup_bwd_widths_stamps", "wide_vector", "-DCCE_BWD_STAMPS"),
               build_variant("cce_lookup_bwd_widths_old", "wide_vector", src=args.old.resolve())
               if args.old else None)
        return 0
    stamped = {"port": build_variant(f"cce_lookup_bwd_{args.layout}_stamps", args.layout,
                                     "-DCCE_BWD_STAMPS")}
    variants = {name: build_variant(f"cce_lookup_bwd_{args.layout}_{name}", args.layout, *defines)
                for name, defines in VARIANTS.get(args.layout, {}).items()}
    if args.old:
        old = args.old.resolve()
        stamped["old"] = build_variant(f"cce_lookup_bwd_{args.layout}_old_stamps", args.layout,
                                       "-DCCE_BWD_STAMPS", src=old)
        variants["old"] = build_variant(f"cce_lookup_bwd_{args.layout}_old", args.layout, src=old)
    shape, k, inputs = cases(args.layout)
    print(f"card: {cs.card_line()}")
    print(shape, flush=True)
    for label, idx, d in inputs:
        want = ref.cce_lookup_bwd_ref(idx, d, k)
        line = {"case": label, "layout": args.layout, "B": idx.shape[1],
                "hottest_row_share": cs.hottest_share(idx, k)}
        for name, lib in stamped.items():
            line[f"{name}_stamps"] = phases(lib, args.layout, idx, d, k, want)
        line.update(against_variants(variants, args.layout, idx, d, k, want))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
