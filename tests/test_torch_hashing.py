"""Port vs JAX package: multiply-shift hashing and CCE buffer init are
bit-exact (the integer state of the port must match to the bit)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cce as jcce
from repro.core import hashing as jh
from repro_torch.core import cce as tcce
from repro_torch.core import hashing as th

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M = 997


def _ids(kind: str, rng) -> np.ndarray:
    if kind == "random":
        return rng.integers(0, 2**31 - 1, 4096).astype(np.int32)
    if kind == "negative":
        return rng.integers(-(2**31), 0, 4096).astype(np.int32)
    if kind == "int64":  # beyond 32 bits: only the low 32 bits count
        return rng.integers(-(2**62), 2**62, 4096, dtype=np.int64)
    if kind == "past_vocab":
        return np.arange(5000, 5000 + 4096, dtype=np.int64)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "negative", "int64", "past_vocab"])
def test_multiply_shift_matches_numpy_and_jax(kind):
    rng = np.random.default_rng(0)
    ids = _ids(kind, rng)
    # full 32-bit coefficients exercise both 16-bit halves of every product
    for a, b in [(2654435761, 12345), (0xFFFFFFFF, 0xFFFFFFFF), (1, 0), (0x7FFFFFFF, 7)]:
        want = jh.multiply_shift_np(ids, a, b, M)
        got = th.multiply_shift(torch.from_numpy(ids), a, b, M).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(th.multiply_shift_np(ids, a, b, M), want)
        if ids.dtype == np.int32:  # jnp without x64 holds int32 ids only
            dev = jh.multiply_shift(jnp.asarray(ids), np.uint32(a), np.uint32(b), M)
            np.testing.assert_array_equal(got, np.asarray(dev))


def test_multiply_shift_with_coefficient_arrays():
    rng = np.random.default_rng(1)
    hs = rng.integers(0, 2**32, (6, 2), dtype=np.uint64).astype(np.uint32)
    ids = rng.integers(-(2**31), 2**31 - 1, 512).astype(np.int32)
    want = jh.multiply_shift_np(ids[None], hs[:, :1], hs[:, 1:], M)
    hs_t = torch.from_numpy(hs.astype(np.int64))
    got = th.multiply_shift(torch.from_numpy(ids)[None], hs_t[:, :1], hs_t[:, 1:], M)
    np.testing.assert_array_equal(got.numpy(), want)


def test_make_hashes_and_pack_match():
    for seed in (0, 5, 123457):
        a = jh.make_hashes(seed, 4, 250)
        b = th.make_hashes(seed, 4, 250)
        assert [(h.a, h.b, h.m) for h in a] == [(h.a, h.b, h.m) for h in b]
        np.testing.assert_array_equal(jh.pack_hashes(a), th.pack_hashes(b))


@pytest.mark.parametrize("d1,k,salt", [(5000, 16, 3), (1460, 250, 0), (24, 24, 7)])
def test_cce_init_buffers_bit_exact(d1, k, salt):
    want = jcce.CCE(d1, 16, k=k, seed_salt=salt).init_buffers()
    got = tcce.CCE(d1, 16, k=k, seed_salt=salt).init_buffers()
    for key in ("ptr", "hs"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert got["epoch"] == want["epoch"]


def test_cce_rows_device_and_host_agree_with_jax():
    jt = jcce.CCE(5000, 16, k=16, seed_salt=2)
    tt = tcce.CCE(5000, 16, k=16, seed_salt=2)
    b = jt.init_buffers()
    bt = {"ptr": torch.from_numpy(b["ptr"]), "hs": torch.from_numpy(b["hs"].astype(np.int64))}
    # in range, at and past the vocab edge (the ptr gather clamps)
    ids = np.array([0, 1, 4999, 5000, 5099, 123456], np.int32)
    want = np.asarray(jt._rows({"ptr": jnp.asarray(b["ptr"]), "hs": b["hs"]}, jnp.asarray(ids)))
    np.testing.assert_array_equal(tt._rows(bt, torch.from_numpy(ids)).numpy(), want)
    np.testing.assert_array_equal(tt.fuse_rows_np(b, ids), jt.fuse_rows_np(b, ids))
    # negative ids: the JAX device gather wraps them (-1 -> d1-1) while its
    # host twin clamps to 0; the port clamps on both paths
    neg = np.array([-1, -5, -(2**31)], np.int32)
    np.testing.assert_array_equal(tt._rows(bt, torch.from_numpy(neg)).numpy(), jt.fuse_rows_np(b, neg))
