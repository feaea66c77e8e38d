"""Launcher of the flash-attention forward, ``csrc/flash_attention.cu``.

The CUDA kernel replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``; the source's
header gives its bound and design.  ``kernels/ops.py::flash_attention``
is the public entry point and sends CPU tensors to the plain version
(``kernels/ref.py::flash_attention_ref``) instead.

Unlike the JAX wrapper, nothing is padded: the kernel takes the true
lengths and the (b, s, h) strides of each tensor and masks the ragged
tails itself.  bfloat16 tensors reach the kernel through TMA tensor maps
whose geometry ``tma_geometry`` computes here, so that it can be checked
without a card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
BOX_COLS = 64  # bf16 columns of one 128-byte-swizzled TMA box
_GEOM = 11  # values per tensor map: 4 dims, 3 byte strides, 4 box dims
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
            + [ctypes.c_float, ctypes.c_int]  # scale causal
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]  # tma_geom block_rows
            + [ctypes.c_void_p]  # stream
        )
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


def needs_copy(t: torch.Tensor) -> bool:
    """Whether ``t`` (B, S, H, D) must be copied before the kernel reads
    it: d not contiguous, a (b, s, h) stride that is not a positive
    multiple of 16 bytes, or a base not 16-byte aligned.  TMA (bfloat16)
    and the float32 kernel's loads read everything else in place."""
    step = 16 // t.element_size()
    return not (t.stride(3) == 1 and all(s > 0 and s % step == 0 for s in t.stride()[:3])
                and t.data_ptr() % 16 == 0)


def tma_geometry(t: torch.Tensor, box_rows: int):
    """The tensor map of a bf16 (B, S, H, D) tensor as the kernel loads it:
    (dims, strides, box).  dims innermost first, (D, S, H, B); strides in
    bytes of s, h and b (d, dim 0, is contiguous and has none); box: 64
    columns by ``box_rows`` rows of one (h, b), so a row of D = 128 comes
    as two boxes, at columns 0 and 64, and one of D = 256 as four."""
    B, S, H, D = t.shape
    es = t.element_size()
    return ((D, S, H, B), (t.stride(1) * es, t.stride(2) * es, t.stride(0) * es),
            (BOX_COLS, box_rows, 1, 1))


def block_n(D: int) -> int:
    """Keys of one K/V tile, the rows of k's and v's boxes: 128, or 64 at
    D = 256, where two stages of 128-key tiles would not fit a CTA's
    shared memory."""
    return 64 if D == 256 else 128


def block_rows(B: int, Sq: int, H: int, n_sm: int, D: int) -> int:
    """Query rows of a CTA: 128 (two consumer warpgroups) where that still
    gives each of the ``n_sm`` SMs a CTA, else 64; always 64 at D = 256,
    whose accumulators fill a consumer's registers."""
    return 128 if D != 256 and B * H * -(-Sq // 128) >= n_sm else 64


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, S, KVH, D), one dtype (float32 or
    bfloat16), on one CUDA device, D in ``HEAD_DIMS``, H a multiple of
    KVH -> (B, Sq, H, D) in q's dtype.  Strided inputs are read in place
    unless ``needs_copy``, then copied into fresh contiguous storage.
    Raises on anything else, or if a tensor map or the launch fails."""
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
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    n_rows = 0
    if q.dtype == torch.bfloat16:
        n_rows = block_rows(
            B, Sq, H, torch.cuda.get_device_properties(q.device).multi_processor_count, D)
    return _launch(q, k, v, causal, n_rows)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            n_rows: int) -> torch.Tensor:
    """The launch behind ``flash_attention``, on inputs it has checked:
    a bf16 CTA takes ``n_rows`` (64 or 128; 64 at D = 256) query rows;
    float32 takes 0."""
    B, Sq, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    q, k, v = (t.clone(memory_format=torch.contiguous_format) if needs_copy(t) else t
               for t in (q, k, v))
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    geom = None
    if q.dtype == torch.bfloat16:
        flat = [x for t, r in ((q, n_rows), (k, block_n(D)), (v, block_n(D)))
                for part in tma_geometry(t, r) for x in part]
        geom = (ctypes.c_longlong * (3 * _GEOM))(*flat)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPE_CODE[q.dtype], B, Sq, S, H, KVH, D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 1.0 / D ** 0.5, int(causal), geom, n_rows, stream)
    if err:
        msg = build.library("flash_attention").flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({err})")
    build.LAUNCHES["flash_attention"] += 1
    return out
