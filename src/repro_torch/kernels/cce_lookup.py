"""Launchers of the fused CCE lookup: the forward ``csrc/cce_lookup.cu``
and the backward ``csrc/cce_lookup_bwd.cu``.

The CUDA kernels replace the TPU kernels
``repro/kernels/cce_lookup.py::cce_lookup_fwd_pallas`` and
``cce_lookup_bwd_pallas``; each source's header gives its bound and
design.  ``kernels/ops.py::cce_lookup`` is the public, differentiable
entry point and sends CPU tensors to the plain versions
(``kernels/ref.py::cce_lookup_ref`` / ``cce_lookup_bwd_ref``) instead.

The wide layouts' backward (a sort, then a walk) takes its launch geometry
and scratch size from ``wide_bwd_geometry``, the one place that chooses
them, so that they can be checked without a card.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: The kernels' layouts, in the order the C entry points number them
#: (each source's header describes them).
PATHS = ("vec4", "wide_vector", "wide_scalar", "narrow")
#: Row sizes in bytes that take ``narrow``: 2, 4, 8 or 16 16-byte vectors.
NARROW_ROW_BYTES = (32, 64, 128, 256)
_fns: dict[str, ctypes._CFuncPtr] = {}

# the wide backward's geometry: csrc/cce_lookup_bwd.cu takes it from
# wide_bwd_geometry and checks only that its kernels stay in bounds
WIDE_SORT_CHUNK = 1024  # b a sort CTA ranks (kSortChunk there)
WIDE_SORT_ROWS = 4096  # rows a sort CTA counts, at most (kSortRows)
WIDE_WALK_TABLE = 1024  # (row, chunk) starts a walk warp holds (kWalkTable)
WIDE_WALK_LOAD = 2048  # walk warps the card holds at once: 132 SMs, 16 warps each, less hot CTAs
WIDE_MAX_B = WIDE_SORT_CHUNK * WIDE_WALK_TABLE  # a chunk a table entry, a row at least


class WideBwd(NamedTuple):
    """The wide layouts' backward at one (c, B, T, k): what the launch
    takes (``csrc/cce_lookup_bwd.cu::cce_lookup_bwd_wide``)."""
    n_chunks: int  # b-chunks of WIDE_SORT_CHUNK a (column, sub-table) is sorted in
    range_rows: int  # rows of a sort range (the last may hold fewer)
    rows_per_warp: int  # rows a walk warp sums (a power of two <= 32), rows_per_warp / groups a group
    groups: int  # groups of 32 / groups lanes a walk warp walks its rows in, at once
    scratch_ints: int  # int32 scratch: row starts, then the sorted b


def wide_slices(dsub: int, element_size: int, path: str) -> int:
    """The slices of d a wide row is walked in (the walk's grid y): 512
    bytes on ``wide_vector``, 128 elements on ``wide_scalar``."""
    return -(-dsub // (512 // element_size if path == "wide_vector" else 128))


def wide_groups(dsub: int, element_size: int, path: str) -> int:
    """The most groups (1, 2 or 4) a walk warp's lanes can split into with
    a group's lanes still covering a row: a 16-byte vector a lane on
    ``wide_vector``, 4 elements on ``wide_scalar``."""
    lanes = -(-dsub // (16 // element_size if path == "wide_vector" else 4))
    return 4 if lanes <= 8 else 2 if lanes <= 16 else 1


def wide_bwd_geometry(c: int, B: int, T: int, k: int, n_slices: int, groups: int = 1) -> WideBwd:
    """The wide backward's geometry for idx (c, B, T) into k rows of
    ``n_slices`` slices (``wide_slices``), at most ``groups`` groups of
    lanes a walk warp (``wide_groups``): B in chunks of WIDE_SORT_CHUNK
    (one even for B = 0, so that every row is written), k in as few even
    ranges of at most WIDE_SORT_ROWS as will do, rounded up to 32 rows,
    and walk warps of the fewest rows (a power of two from the groups up
    to 32) that bring them over all slices down to WIDE_WALK_LOAD, so that
    they walk in one wave, but no more than leave every chunk's starts
    within WIDE_WALK_TABLE (the groups shrink first where even theirs do
    not).  The scratch holds k + one a range row starts, and
    WIDE_SORT_CHUNK b a range, for every (column, sub-table, chunk).  Raises
    ValueError past WIDE_MAX_B."""
    if B > WIDE_MAX_B:
        raise ValueError(f"the wide lookup backward takes B <= {WIDE_MAX_B}, got {B}")
    n_chunks = max(1, -(-B // WIDE_SORT_CHUNK))
    n0 = -(-k // WIDE_SORT_ROWS)
    range_rows = -(-(-(-k // n0)) // 32) * 32
    n_ranges = -(-k // range_rows)
    while groups > 1 and groups * n_chunks > WIDE_WALK_TABLE:
        groups //= 2
    rpw = groups
    while (rpw < 32 and 2 * rpw * n_chunks <= WIDE_WALK_TABLE
           and c * T * n_slices * -(-k // rpw) > WIDE_WALK_LOAD):
        rpw *= 2
    lists = c * T * n_chunks
    return WideBwd(n_chunks, range_rows, rpw, groups,
                   lists * (k + n_ranges) + lists * n_ranges * WIDE_SORT_CHUNK)


def lookup_path(dsub: int, element_size: int, *addresses: int) -> str:
    """The layout both kernels take for rows of ``dsub`` elements of
    ``element_size`` bytes in tensors at ``addresses`` (the float tensors'
    data pointers):

    - ``"vec4"``: dsub 4 with every address aligned to the row (a thread
      a row; the Criteo supertable);
    - ``"narrow"``: rows of 2, 4, 8 or 16 16-byte vectors (float32 dsub 8,
      16, 32, 64; bfloat16 16, 32, 64, 128) with every address 16-byte
      aligned (a lane group a row; the hashing trick's dsub 16);
    - ``"wide_vector"``: any other dsub that is a multiple of a 16-byte
      vector, every address 16-byte aligned (the lanes of a warp along d;
      the LM token tables);
    - ``"wide_scalar"``: anything else, unaligned views included."""
    aligned = all(a % 16 == 0 for a in addresses)
    if dsub == 4 and all(a % (4 * element_size) == 0 for a in addresses):
        return "vec4"
    if aligned and dsub * element_size in NARROW_ROW_BYTES:
        return "narrow"
    if aligned and dsub % (16 // element_size) == 0:
        return "wide_vector"
    return "wide_scalar"


# idx, a float tensor in, a float tensor out, dtype code, c B T k dsub, idx
# strides, path: the signature the forward and the backward share
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # idx, in, out
    ctypes.c_int,  # dtype code
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # c B T k dsub
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # idx strides
    ctypes.c_int,  # path: its index in PATHS
    ctypes.c_void_p,  # stream
]
# the wide backward's cce_lookup_bwd_wide: scratch and its ints after the
# float tensors, the geometry (WideBwd's first four) after the path
_WIDE_BWD_ARGTYPES = (_ARGTYPES[:3] + [ctypes.c_void_p, ctypes.c_longlong] + _ARGTYPES[3:-1]
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _kernel(lib_name: str, entry: str, argtypes=_ARGTYPES):
    """The C entry point ``entry`` of ``csrc/<lib_name>.cu`` (by default the
    signature the forward and the backward share).  The path is the
    layout's index in PATHS, one of the four that ``lookup_path`` names;
    the source compiles every layout into one library."""
    if entry not in _fns:
        lib = build.library(lib_name)
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{lib_name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns[entry] = fn
    return _fns[entry]


def _launch(lib_name: str, entry: str, idx, src, out, k: int, dsub: int) -> None:
    """Launches ``entry`` in the layout ``lookup_path`` picks, on the
    current stream (the backward's wide layouts: its sort and its walk,
    with scratch from torch's caching allocator), and counts it once in
    ``LAUNCHES[entry]``; raises if a launch fails."""
    c, B, T = idx.shape
    path = lookup_path(dsub, out.element_size(), src.data_ptr(), out.data_ptr())
    code, strides = _DTYPE_CODE[out.dtype], idx.stride()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        if entry == "cce_lookup_bwd" and path.startswith("wide"):
            esize = out.element_size()
            g = wide_bwd_geometry(c, B, T, k, wide_slices(dsub, esize, path),
                                  wide_groups(dsub, esize, path))
            scratch = torch.empty(g.scratch_ints, dtype=torch.int32, device=out.device)
            fn = _kernel(lib_name, "cce_lookup_bwd_wide", _WIDE_BWD_ARGTYPES)
            err = fn(idx.data_ptr(), src.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                     g.scratch_ints, code, c, B, T, k, dsub, *strides, PATHS.index(path),
                     *g[:4], stream)
        else:
            err = _kernel(lib_name, entry)(idx.data_ptr(), src.data_ptr(), out.data_ptr(), code,
                                           c, B, T, k, dsub, *strides, PATHS.index(path), stream)
    if err:
        msg = getattr(build.library(lib_name), f"{lib_name}_error_string")(err).decode()
        raise RuntimeError(f"{entry} kernel launch failed: {msg} ({err})")
    build.LAUNCHES[entry] += 1


def _check_idx(idx: torch.Tensor, other: torch.Tensor) -> None:
    if idx.device.type != "cuda" or other.device != idx.device:
        raise ValueError(
            f"cce_lookup kernels need idx and the float tensor on one CUDA device, "
            f"got {idx.device} and {other.device}"
        )
    if idx.dtype != torch.int32 or idx.dim() != 3:
        raise ValueError(f"idx must be (c, B, T) int32, got {tuple(idx.shape)} {idx.dtype}")
    if min(idx.stride(), default=0) < 0:
        raise ValueError(f"idx strides must be non-negative, got {idx.stride()}")


def _check(idx: torch.Tensor, tables: torch.Tensor) -> None:
    _check_idx(idx, tables)
    if tables.dtype not in _DTYPE_CODE or tables.dim() != 4:
        raise ValueError(
            f"tables must be (c, T, k, dsub) float32 or bfloat16, "
            f"got {tuple(tables.shape)} {tables.dtype}"
        )
    if not tables.is_contiguous():
        raise ValueError("tables must be contiguous")
    c, _, T = idx.shape
    if tables.shape[0] != c or tables.shape[1] != T:
        raise ValueError(
            f"idx {tuple(idx.shape)} does not match tables {tuple(tables.shape)}"
        )


def cce_lookup_fwd(idx: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """idx (c, B, T) int32, any non-negative strides; tables
    (c, T, k, dsub) float32/bfloat16, contiguous; both on one CUDA
    device -> (B, c*dsub) in the table dtype.  Raises on anything else,
    or if the launch fails."""
    _check(idx, tables)
    c, B, T = idx.shape
    _, _, k, dsub = tables.shape
    out = torch.empty((B, c * dsub), dtype=tables.dtype, device=tables.device)
    if out.numel() == 0:
        return out
    _launch("cce_lookup", "cce_lookup_fwd", idx, tables, out, k, dsub)
    return out


def cce_lookup_bwd(idx: torch.Tensor, dout: torch.Tensor, k: int) -> torch.Tensor:
    """idx (c, B, T) int32, any non-negative strides (the view the forward
    took); dout (B, c, dsub) float32/bfloat16; both on one CUDA device ->
    dtables (c, T, k, dsub) in the dout dtype, every row written (rows no
    index names are 0).  Deterministic: no atomics.  Raises on anything
    else (the wide layouts: B past WIDE_MAX_B), or if a launch fails."""
    _check_idx(idx, dout)
    c, B, T = idx.shape
    if dout.dtype not in _DTYPE_CODE or dout.dim() != 3 or dout.shape[:2] != (B, c):
        raise ValueError(
            f"dout must be (B, c, dsub) = ({B}, {c}, dsub) float32 or bfloat16, "
            f"got {tuple(dout.shape)} {dout.dtype}"
        )
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    dsub = dout.shape[2]
    dout = dout.contiguous()
    dtab = torch.empty((c, T, k, dsub), dtype=dout.dtype, device=dout.device)
    if dtab.numel() == 0:
        return dtab
    _launch("cce_lookup_bwd", "cce_lookup_bwd", idx, dout, dtab, k, dsub)
    return dtab
