"""Launcher of the flash-attention forward, ``csrc/flash_attention.cu``.

The CUDA kernel replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``; the source's
header gives its bound and design.  ``kernels/ops.py::flash_attention``
is the public entry point and sends CPU tensors to the plain version
(``kernels/ref.py::flash_attention_ref``) instead.

Unlike the JAX wrapper, nothing is padded: the kernel takes the true
lengths and the (b, s, h) strides of each tensor and masks the ragged
tails itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.library("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 4  # q k v o
            + [ctypes.c_int] * 7  # dtype B Sq S H KVH D
            + [ctypes.c_longlong] * 12  # (b, s, h) strides of q k v o
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale causal stream
        )
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


def _aligned(t: torch.Tensor) -> bool:
    """d contiguous, the (b, s, h) strides whole 16-byte steps and the
    base 16-byte aligned: what the kernel's vector loads need."""
    step = 16 // t.element_size()
    return (t.stride(3) == 1 and all(s % step == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, S, KVH, D), one dtype (float32 or
    bfloat16), on one CUDA device, D in ``HEAD_DIMS``, H a multiple of
    KVH -> (B, Sq, H, D) in q's dtype.  Strided inputs are read in place
    where their strides allow 16-byte loads, else copied into fresh
    contiguous storage.
    Raises on anything else, or if the launch fails."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype, float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, S, KVH, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KVH < 1 or H % KVH:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         f"(same B and D, H a multiple of KVH)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {D}")
    if S < 1:
        raise ValueError("flash_attention needs at least one key")
    q, k, v = (t if _aligned(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPE_CODE[q.dtype], B, Sq, S, H, KVH, D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 1.0 / D ** 0.5, int(causal), stream)
    if err:
        msg = build.library("flash_attention").flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({err})")
    build.LAUNCHES["flash_attention"] += 1
    return out
