"""Launcher of the nearest-centroid assignment, ``csrc/kmeans_assign.cu``.

The CUDA kernel replaces the TPU kernel
``repro/kernels/kmeans_assign.py::kmeans_assign_pallas``; the source's
header gives its bound and design.  ``kernels/ops.py::kmeans_assign`` is
the public entry point and sends CPU tensors to the plain version
(``kernels/ref.py::kmeans_assign_ref``) instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.library("kmeans_assign")
        fn = lib.kmeans_assign
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, centroids, out
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # n k d
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.kmeans_assign_error_string.argtypes = [ctypes.c_int]
        lib.kmeans_assign_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """x (n, d) and centroids (k, d), float32, contiguous, on one CUDA
    device -> (n,) int32 argmin_j (||c_j||^2 - 2 <x, c_j>), ties to the
    lowest j.  Raises on anything else, or if the launch fails."""
    if x.device.type != "cuda" or centroids.device != x.device:
        raise ValueError(
            f"kmeans_assign kernel needs x and centroids on one CUDA device, "
            f"got {x.device} and {centroids.device}"
        )
    if x.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise ValueError(f"x and centroids must be float32, got {x.dtype} and {centroids.dtype}")
    if x.dim() != 2 or centroids.dim() != 2 or x.shape[1] != centroids.shape[1]:
        raise ValueError(
            f"x must be (n, d) and centroids (k, d), got {tuple(x.shape)} and "
            f"{tuple(centroids.shape)}"
        )
    if not (x.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("x and centroids must be contiguous")
    n, d = x.shape
    k = centroids.shape[0]
    if k < 1 or d < 1:
        raise ValueError(f"kmeans_assign needs k >= 1 and d >= 1, got k={k} d={d}")
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), centroids.data_ptr(), out.data_ptr(), n, k, d, stream)
    if err:
        msg = build.library("kmeans_assign").kmeans_assign_error_string(err).decode()
        raise RuntimeError(f"kmeans_assign kernel launch failed: {msg} ({err})")
    build.LAUNCHES["kmeans_assign"] += 1
    return out
