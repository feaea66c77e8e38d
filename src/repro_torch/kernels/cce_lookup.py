"""Launchers of the fused CCE lookup: the forward ``csrc/cce_lookup.cu``
and the backward ``csrc/cce_lookup_bwd.cu``.

The CUDA kernels replace the TPU kernels
``repro/kernels/cce_lookup.py::cce_lookup_fwd_pallas`` and
``cce_lookup_bwd_pallas``; each source's header gives its bound and
design.  ``kernels/ops.py::cce_lookup`` is the public, differentiable
entry point and sends CPU tensors to the plain versions
(``kernels/ref.py::cce_lookup_ref`` / ``cce_lookup_bwd_ref``) instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _kernel(lib_name: str, entry: str):
    """The C entry point ``entry`` of ``csrc/<lib_name>.cu`` (forward and
    backward share one signature: idx, a float tensor in, a float tensor
    out, dtype code, c B T k dsub, idx strides, vec4, stream)."""
    if entry not in _fns:
        lib = build.library(lib_name)
        fn = getattr(lib, entry)
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # idx, in, out
            ctypes.c_int,  # dtype code
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # c B T k dsub
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # idx strides
            ctypes.c_int,  # vec4
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{lib_name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns[entry] = fn
    return _fns[entry]


def _launch(lib_name: str, entry: str, idx, src, out, k: int, dsub: int) -> None:
    """Launches ``entry`` on the current stream and counts it in
    ``LAUNCHES[entry]``; raises if the launch fails."""
    c, B, T = idx.shape
    vec4 = dsub == 4 and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in (src, out)
    )
    fn = _kernel(lib_name, entry)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(idx.data_ptr(), src.data_ptr(), out.data_ptr(), _DTYPE_CODE[out.dtype],
                 c, B, T, k, dsub, *idx.stride(), int(vec4), stream)
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
    else, or if the launch fails."""
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
