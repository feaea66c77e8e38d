"""Launcher of the nearest-centroid assignment, ``csrc/kmeans_assign.cu``.

The CUDA kernel replaces the TPU kernel
``repro/kernels/kmeans_assign.py::kmeans_assign_pallas``; the source's
header gives its bound and design.  One launch assigns every column of a
table: x (c, n, d) against centroids (c, k, d), written into a (c, n)
view.  ``kernels/ops.py::kmeans_assign`` and ``kmeans_assign_batched`` are
the public entry points and send CPU tensors to the plain versions
(``kernels/ref.py``) instead.

The launch geometry (points a thread, threads a CTA) is computed here by
``assign_geometry``, and the tiled kernel's tiles, shared memory and grid
by ``tiles``, so that they can be checked without a card.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

TILE = 8  # centroids a step of the d = 4 kernel (kTile)
# the largest k the d = 4 kernel takes: 20 bytes a centroid slot (a float4
# and its norm), k rounded up to TILE, in 48 KB of shared memory (kFastMaxK)
FAST_MAX_K = 48 * 1024 // (TILE * 20) * TILE
POINTS = (4, 2, 1)  # points a thread, the d = 4 kernel's template instances
THREADS = (128, 64)  # threads a CTA of the d = 4 kernel
SMEM_LIMIT = 232448  # bytes of shared memory a CTA can opt into on an H100


class Tiles(NamedTuple):
    """The tiled kernel's launch (``csrc/kmeans_assign.cu``: kTiledM,
    kTiledN, kBK, kStages, kTM, kTN, kTiledThreads, kTiledSmemBytes)."""
    bm: int  # points a CTA
    bn: int  # centroids a tile
    bk: int  # floats of d a ring stage
    stages: int  # ring stages
    tm: int  # points a thread
    tn: int  # centroids a thread
    threads: int  # a CTA
    smem_bytes: int  # dynamic shared memory a CTA: the ring and one tile's norms
    grid: tuple[int, int]  # (point blocks, columns)
    k_tiles: int  # centroid tiles a CTA loops over
    d_steps: int  # ring steps a centroid tile
    vec: bool  # 16-byte copies (d % 4 == 0), else 4-byte


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.library("kmeans_assign")
        fn = lib.kmeans_assign
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, centroids, out
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # c n k d
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # out row stride, points, threads
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.kmeans_assign_error_string.argtypes = [ctypes.c_int]
        lib.kmeans_assign_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


def fast_path(k: int, d: int) -> bool:
    """Whether (k, d) takes the register-blocked d = 4 kernel."""
    return d == 4 and k <= FAST_MAX_K


def tiles(n: int, c: int, k: int, d: int) -> Tiles:
    """The tiled kernel's launch over c columns of n points against k
    centroids of width d (every shape off ``fast_path``): a CTA of
    ``bm`` points loops over all centroid tiles of ``bn``, d in steps of
    ``bk`` through a ring of ``stages``, rows padded by 16 bytes."""
    bm, bn, bk, stages, tm, tn = 128, 128, 32, 3, 8, 8
    ring = stages * (bm + bn) * (bk + 4)
    return Tiles(bm, bn, bk, stages, tm, tn, threads=(bm // tm) * (bn // tn),
                 smem_bytes=(ring + bn) * 4, grid=(-(-n // bm), c), k_tiles=-(-k // bn),
                 d_steps=-(-d // bk), vec=d % 4 == 0)


def assign_geometry(n: int, c: int, k: int, d: int, sm_count: int) -> tuple[int, int]:
    """(points a thread, threads a CTA) of a launch over c columns of n
    points: on the d = 4 kernel the largest P, then the largest CTA, that
    still gives each of the ``sm_count`` SMs a CTA (the smallest pair
    where none does); on the tiled kernel its fixed 8 points (by 8
    centroids) a thread and 256 threads (``tiles``)."""
    if not fast_path(k, d):
        t = tiles(n, c, k, d)
        return t.tm, t.threads
    for p in POINTS:
        for threads in THREADS:
            if c * -(-n // (p * threads)) >= sm_count:
                return p, threads
    return POINTS[-1], THREADS[-1]


def check_args(x: torch.Tensor, centroids: torch.Tensor, out: torch.Tensor | None):
    """(c, n, k, d) of a launch over x (c, n, d) or (n, d), centroids
    (c, k, d) or (k, d), and ``out`` (c, n) or (n,) int32 with unit last
    stride; raises ValueError on anything the kernel does not take."""
    if x.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise ValueError(f"x and centroids must be float32, got {x.dtype} and {centroids.dtype}")
    if x.dim() not in (2, 3) or centroids.dim() != x.dim():
        raise ValueError(f"x must be (n, d) or (c, n, d) and centroids (k, d) or (c, k, d), "
                         f"got shapes {tuple(x.shape)} and {tuple(centroids.shape)}")
    x3 = x if x.dim() == 3 else x[None]
    c3 = centroids if centroids.dim() == 3 else centroids[None]
    (c, n, d), (ck, k, dk) = x3.shape, c3.shape
    if ck != c or dk != d:
        raise ValueError(f"x shape {tuple(x.shape)} and centroids shape "
                         f"{tuple(centroids.shape)} differ in columns or d")
    if c < 1 or k < 1 or d < 1:
        raise ValueError(f"kmeans_assign needs c, k, d >= 1, got c={c} k={k} d={d}")
    if c > 65535:
        raise ValueError(f"kmeans_assign takes at most 65535 columns a launch, got {c}")
    if not (x.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("x and centroids must be contiguous")
    if out is not None:
        if out.dtype != torch.int32 or out.shape != x.shape[:-1]:
            raise ValueError(f"out must be int32 of shape {tuple(x.shape[:-1])}, got "
                             f"{out.dtype} {tuple(out.shape)}")
        if n and out.stride(-1) != 1:
            raise ValueError(f"out must have unit last stride, got strides {out.stride()}")
    return c, n, k, d


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor, *,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """x (c, n, d) and centroids (c, k, d) (or (n, d) and (k, d), one
    column), float32, contiguous, on one CUDA device -> (c, n) (or (n,))
    int32: column i's argmin_j (||c_ij||^2 - 2 <x_ip, c_ij>), ties to the
    lowest j.  Written into ``out`` (int32, unit last stride, any row
    stride) when given.  Raises on anything else, or if the launch fails."""
    c, n, k, d = check_args(x, centroids, out)
    tensors = (x, centroids) if out is None else (x, centroids, out)
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError(f"kmeans_assign kernel needs its tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if out is None:
        out = torch.empty(x.shape[:-1], dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    return _launch(x, centroids, out, (c, n, k, d), *assign_geometry(n, c, k, d, sm))


def _launch(x: torch.Tensor, centroids: torch.Tensor, out: torch.Tensor,
            shape: tuple[int, int, int, int], points: int, threads: int) -> torch.Tensor:
    """The launch behind ``kmeans_assign``, on arguments it has checked
    (``shape``: their (c, n, k, d) from ``check_args``), with the geometry
    given: (points a thread, threads a CTA)."""
    c, n, k, d = shape
    if d % 4 == 0:  # both kernels read rows of float4s
        x, centroids = (t.clone() if t.data_ptr() % 16 else t for t in (x, centroids))
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), centroids.data_ptr(), out.data_ptr(), c, n, k, d,
                 out.stride(0) if out.dim() == 2 else n, points, threads, stream)
    if err:
        msg = build.library("kmeans_assign").kmeans_assign_error_string(err).decode()
        raise RuntimeError(f"kmeans_assign kernel launch failed: {msg} ({err})")
    build.LAUNCHES["kmeans_assign"] += 1
    return out
