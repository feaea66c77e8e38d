"""A numpy mirror, exact to the bit, of the part of ``jax.random`` that the
CCE transition consumes: legacy ``uint32[2]`` threefry keys with
``PRNGKey``, ``split``, ``fold_in``, ``key_data`` and ``randint``.

The transition derives its hash coefficients and sampling seeds from
keys (``fold_in(key, epoch)`` then ``split`` in ``CCE.cluster``,
``fold_in(key, 777)`` for the fresh helper hashes, ``fold_in(key, i)``
per feature and a ``randint`` seed per table), so without this mirror the
port's ``hs`` buffers drift from the JAX package's after the first
transition.  Float draws (k-means++, subsampling) do not go through here:
they come from a ``torch.Generator`` seeded from the key.

Mirrors JAX with ``jax_threefry_partitionable=True`` (the default since
jax 0.5): ``split`` and ``random_bits`` hash the 64-bit iota of the output
shape as (hi, lo) counter pairs, and ``fold_in`` hashes (0, data).  Keys
are numpy ``uint32`` arrays of shape (2,), as ``jax.random.key_data``
gives them.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) of ``key`` (2,) uint32
    over counter words ``x0``, ``x1`` (uint32 arrays of one shape)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802  (jax's name)
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the key
    (0, seed mod 2^32)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def key_data(key) -> np.ndarray:
    return np.asarray(key, np.uint32)


def _iota_hash(key, shape) -> tuple[np.ndarray, np.ndarray]:
    """Threefry of the 64-bit iota over ``shape``, as (hi, lo) words."""
    n = int(np.prod(shape, dtype=np.int64))
    count = np.arange(n, dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (count & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    return threefry2x32(key, hi, lo)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> (num, 2) uint32 keys."""
    b0, b1 = _iota_hash(key_data(key), (num,))
    return np.stack([b0, b1], axis=-1)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: ``data`` (an int, numpy scalar or
    0-d tensor) is taken mod 2^32, as JAX casts it to uint32."""
    d = np.uint32(int(data) & 0xFFFFFFFF)
    y0, y1 = threefry2x32(key_data(key), np.uint32(0), d)
    return np.array([y0, y1], np.uint32)


def _bits32(key, shape) -> np.ndarray:
    b0, b1 = _iota_hash(key_data(key), shape)
    return b0 ^ b1


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` for the default
    int32 dtype: two 32-bit draws combined modulo the span, in uint32
    wraparound arithmetic as JAX does it."""
    shape = tuple(shape)
    minval, maxval = int(minval), int(maxval)
    for v in (minval, maxval):
        if not -(2**31) <= v < 2**31:
            raise OverflowError(f"randint bound {v} does not fit int32")
    k1, k2 = split(key)
    higher, lower = _bits32(k1, shape), _bits32(k2, shape)
    span = (maxval - minval) if maxval > minval else 1
    span32 = np.uint32(span)
    # 2^32 mod span, squared in uint32 (it wraps, as in JAX)
    mult = np.uint32(((((2**16) % span) ** 2) & 0xFFFFFFFF) % span)
    with np.errstate(over="ignore"):
        offset = ((higher % span32) * mult + (lower % span32)) % span32
    return ((np.int64(minval) + offset.astype(np.int64)) & 0xFFFFFFFF).astype(
        np.uint32).view(np.int32).reshape(shape)
