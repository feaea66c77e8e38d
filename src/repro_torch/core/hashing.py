"""Multiply-shift hashing and count-sketch (Appendix D of the paper), as
torch ops plus a numpy copy of the host-side helpers.

h(x) = mix(a*x + b) mod m in uint32 wraparound arithmetic.  Torch has no
usable uint32 arithmetic, so the torch pipeline emulates it in int64 and
masks to the low 32 bits after every step.  A product of two 32-bit
values does not fit in int64, so every multiply splits its second factor
into 16-bit halves (``_mul32``).  Negative and int64 ids map to the same
low 32 bits as numpy's ``astype(np.uint32)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random as jr

_MERSENNE = 2654435761  # Knuth's multiplicative constant
_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, y) -> torch.Tensor:
    """(x * y) mod 2^32 for int64 tensors (or ints) holding values in
    [0, 2^32): each partial product stays below 2^48."""
    lo = x * (y & 0xFFFF)
    hi = ((x * (y >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def multiply_shift(ids: torch.Tensor, a, b, m: int) -> torch.Tensor:
    """Bit-exact torch counterpart of ``multiply_shift_np``: ids of any
    integer dtype and shape; ``a``/``b`` ints or int64 tensors broadcast
    against ``ids`` (e.g. the columns of a (c, 2) ``hs`` buffer).
    Returns int32."""
    x = ids.to(torch.int64) & _MASK32
    if isinstance(a, torch.Tensor):
        a = a.to(torch.int64) & _MASK32
        b = b.to(torch.int64) & _MASK32
    else:
        a, b = int(a) & _MASK32, int(b) & _MASK32
    h = (_mul32(x, a) + b) & _MASK32
    h = _mul32(h ^ (h >> 15), _MERSENNE)
    h = h ^ (h >> 13)
    return (h % m).to(torch.int32)


def multiply_shift_np(ids, a, b, m: int) -> np.ndarray:
    """The numpy pipeline (host-side pointer translation, buffer init)."""
    with np.errstate(over="ignore"):
        x = np.asarray(ids).astype(np.uint32)
        h = x * np.asarray(a).astype(np.uint32) + np.asarray(b).astype(np.uint32)
        h = (h ^ (h >> np.uint32(15))) * np.uint32(_MERSENNE)
        h = h ^ (h >> np.uint32(13))
        return (h % np.uint32(m)).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class MultiplyShiftHash:
    """h : [d1] -> [m].  Stored as (a, b) with odd ``a``."""

    a: int
    b: int
    m: int

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        return multiply_shift(ids, self.a, self.b, self.m)

    def np(self, ids: np.ndarray) -> np.ndarray:
        return multiply_shift_np(ids, self.a, self.b, self.m)


def pack_hashes(hashes) -> np.ndarray:
    """(n, 2) uint32 coefficient array from a MultiplyShiftHash list."""
    return np.asarray([[h.a, h.b] for h in hashes], np.uint32)


def make_hash(seed: int, m: int) -> MultiplyShiftHash:
    """Sample a multiply-shift hash with range ``m`` from an int seed."""
    rng = np.random.default_rng(seed)
    # 31-bit coefficients; the LSB keeps `a` odd
    a = (int(rng.integers(0, 2**31 - 1)) * 2 + 1) & 0x7FFFFFFF
    b = int(rng.integers(0, 2**31 - 1)) & 0x7FFFFFFF
    return MultiplyShiftHash(a=a, b=b, m=m)


def make_hashes(seed: int, n: int, m: int) -> list[MultiplyShiftHash]:
    return [make_hash(seed * 1_000_003 + i, m) for i in range(n)]


def _seed_of(key) -> int:
    """The int seed the JAX package derives from a PRNG key
    (``repro_torch.random``): the sum of its uint32 words."""
    return int(np.asarray(key, np.uint32).astype(np.uint64).sum())


# --- count-sketch as an explicit (sparse) linear map --------------------------


@dataclasses.dataclass(frozen=True)
class SignHash:
    """s : [d1] -> {-1, +1} for count-sketch."""

    a: int
    b: int

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        x = ids.to(torch.int64) & _MASK32
        h = (_mul32(x, int(self.a) & _MASK32) + (int(self.b) & _MASK32)) & _MASK32
        h = _mul32(h ^ (h >> 16), _MERSENNE)
        return torch.where((h >> 31) > 0, 1, -1).to(torch.int32)


def make_sign_hash(key) -> SignHash:
    """A sign hash from an int seed or a ``repro_torch.random`` key."""
    seed = key if isinstance(key, int) else _seed_of(key)
    rng = np.random.default_rng(seed ^ 0xABCDEF)
    a = (int(rng.integers(0, 2**31 - 1)) * 2 + 1) & 0x7FFFFFFF
    b = int(rng.integers(0, 2**31 - 1)) & 0x7FFFFFFF
    return SignHash(a=a, b=b)


def countsketch_matrix(key, d1: int, k: int, signed: bool = True) -> np.ndarray:
    """The d1 x k count-sketch matrix H (tests, tiny d1): H[j, h(j)] = s(j),
    one nonzero a row (Charikar et al. 2002).  ``key`` is a
    ``repro_torch.random`` key; the hashes are the JAX package's."""
    kh, ks = jr.split(key)
    h = make_hash(_seed_of(kh), k)
    ids = torch.arange(d1)
    rows = h(ids).numpy()
    signs = make_sign_hash(ks)(ids).numpy() if signed else np.ones(d1, np.int32)
    H = np.zeros((d1, k), np.float32)
    H[np.arange(d1), rows] = signs
    return H


def apply_countsketch(x: torch.Tensor, hs: tuple[int, int, int, int], k: int) -> torch.Tensor:
    """The dense k-vector sketch of the basis vectors e_i, i in ``x``: each
    id adds its sign at its row.  ``hs`` is (a, b, sign a, sign b)."""
    a, b, sa, sb = hs
    rows = MultiplyShiftHash(a, b, k)(x).to(torch.int64)
    signs = SignHash(sa, sb)(x).to(torch.float32)
    return torch.zeros(k, dtype=torch.float32, device=x.device).index_add_(0, rows, signs)
