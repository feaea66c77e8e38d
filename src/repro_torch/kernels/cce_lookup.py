"""Launcher of the fused CCE lookup forward, ``csrc/cce_lookup.cu``.

The CUDA kernel replaces the TPU kernel
``repro/kernels/cce_lookup.py::cce_lookup_fwd_pallas``; the source's
header gives its bound and design.  ``kernels/ops.py::cce_lookup`` is
the public entry point and sends CPU tensors to the plain version
(``kernels/ref.py::cce_lookup_ref``) instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.library("cce_lookup")
        fn = lib.cce_lookup_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # idx, tables, out
            ctypes.c_int,  # dtype code
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # c B T k dsub
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # idx strides
            ctypes.c_int,  # vec4
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.cce_lookup_error_string.argtypes = [ctypes.c_int]
        lib.cce_lookup_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


def _check(idx: torch.Tensor, tables: torch.Tensor) -> None:
    if idx.device.type != "cuda" or tables.device != idx.device:
        raise ValueError(
            f"cce_lookup kernel needs idx and tables on one CUDA device, "
            f"got {idx.device} and {tables.device}"
        )
    if idx.dtype != torch.int32 or idx.dim() != 3:
        raise ValueError(f"idx must be (c, B, T) int32, got {tuple(idx.shape)} {idx.dtype}")
    if tables.dtype not in _DTYPE_CODE or tables.dim() != 4:
        raise ValueError(
            f"tables must be (c, T, k, dsub) float32 or bfloat16, "
            f"got {tuple(tables.shape)} {tables.dtype}"
        )
    if not tables.is_contiguous():
        raise ValueError("tables must be contiguous")
    if min(idx.stride()) < 0:
        raise ValueError(f"idx strides must be non-negative, got {idx.stride()}")
    c, _, T = idx.shape
    if tables.shape[0] != c or tables.shape[1] != T:
        raise ValueError(
            f"idx {tuple(idx.shape)} does not match tables {tuple(tables.shape)}"
        )
    if tables.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "the cce_lookup backward kernel is not ported yet; call under "
            "torch.no_grad() or with tables that do not require grad"
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
    vec4 = dsub == 4 and tables.data_ptr() % (4 * tables.element_size()) == 0
    fn = _kernel()
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(idx.data_ptr(), tables.data_ptr(), out.data_ptr(),
                 _DTYPE_CODE[tables.dtype], c, B, T, k, dsub, *idx.stride(),
                 int(vec4), stream)
    if err:
        msg = build.library("cce_lookup").cce_lookup_error_string(err).decode()
        raise RuntimeError(f"cce_lookup kernel launch failed: {msg} ({err})")
    build.LAUNCHES["cce_lookup_fwd"] += 1
    return out
