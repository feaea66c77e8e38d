"""Port vs JAX package: the fused CCE lookup, its backward and the k-means
assignment.  On the CPU the port's ``ops`` entry points run their plain
versions, held against the Pallas kernels in interpret mode (the lookup
bit for bit in float32, the backward at rtol 1e-5 / atol 1e-6, the
assignment by the tie-tolerant rule); the CUDA kernels themselves are
held against the same plain versions on the card by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import cce_lookup as tcl
from repro_torch.kernels import kmeans_assign as tka
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _case(c, B, T, k, dsub, seed):
    """Rows in range plus the cases that must contribute zero: the -1
    sentinel, other negatives, and rows at or past k."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, k, (c, B, T)).astype(np.int32)
    special = rng.random((c, B, T))
    idx[special < 0.15] = -1
    idx[(special >= 0.15) & (special < 0.2)] = -7
    idx[(special >= 0.2) & (special < 0.25)] = k
    idx[(special >= 0.25) & (special < 0.3)] = 10 * k + 3
    tables = rng.normal(size=(c, T, k, dsub)).astype(np.float32)
    return idx, tables


@pytest.mark.parametrize(
    "c,B,T,k,dsub",
    [
        (3, 1, 2, 7, 4),
        (5, 7, 2, 16, 4),
        (4, 13, 1, 40, 8),
        (104, 9, 2, 305, 4),  # the full-Criteo supertable shape
        (2, 33, 1, 300, 3),
        (6, 20, 2, 130, 2),
    ],
)
def test_cce_lookup_bit_exact_vs_pallas(c, B, T, k, dsub):
    idx, tables = _case(c, B, T, k, dsub, seed=c * 1000 + B)
    want = np.asarray(jops.cce_lookup(jnp.asarray(idx), jnp.asarray(tables)))
    got = tops.cce_lookup(torch.from_numpy(idx), torch.from_numpy(tables))
    assert got.shape == (B, c * dsub) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cce_lookup_bf16_within_tolerance():
    idx, tables = _case(8, 24, 2, 64, 4, seed=3)
    want = np.asarray(
        jops.cce_lookup(jnp.asarray(idx), jnp.asarray(tables, jnp.bfloat16)).astype(jnp.float32)
    )
    got = tops.cce_lookup(torch.from_numpy(idx), torch.from_numpy(tables).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # both sum two bf16 rows in f32 and round once to bf16 (relative
    # step 2^-8); allow one rounding step of the largest magnitude
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=2**-7)


def test_cce_lookup_strided_idx_equals_contiguous():
    """The serving path hands the lookup a (c, B, T) view of (B, c, T)
    rows; the result must not depend on the strides."""
    idx, tables = _case(10, 12, 2, 50, 4, seed=4)
    rows = torch.from_numpy(np.ascontiguousarray(idx.transpose(1, 0, 2)))  # (B, c, T)
    view = rows.movedim(0, 1)
    assert not view.is_contiguous()
    t = torch.from_numpy(tables)
    assert torch.equal(tops.cce_lookup(view, t), tops.cce_lookup(view.contiguous(), t))


def test_cuda_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the kernel's launcher raises instead of running
    anything (``ops.cce_lookup`` never sends a CPU tensor there)."""
    idx, tables = _case(2, 3, 2, 5, 4, seed=5)
    with pytest.raises(ValueError, match="CUDA"):
        tcl.cce_lookup_fwd(torch.from_numpy(idx), torch.from_numpy(tables))


def test_pad_stack_tables_matches_jax():
    rng = np.random.default_rng(6)
    slabs = [rng.normal(size=(c, 2, k, 4)).astype(np.float32) for c, k in [(4, 9), (8, 16), (1, 3)]]
    want = np.asarray(jops.pad_stack_tables([jnp.asarray(s) for s in slabs], k_pad=20))
    got = tops.pad_stack_tables([torch.from_numpy(s) for s in slabs], k_pad=20)
    np.testing.assert_array_equal(got.numpy(), want)


# --- the lookup's backward ------------------------------------------------------


@pytest.mark.parametrize(
    "c,B,T,k,dsub",
    [
        (3, 1, 2, 7, 4),
        (5, 19, 2, 16, 4),
        (4, 13, 1, 40, 8),
        (104, 6, 2, 305, 4),  # the full-Criteo supertable shape
        (6, 40, 2, 130, 2),
    ],
)
def test_cce_lookup_bwd_matches_pallas_vjp(c, B, T, k, dsub):
    """The plain backward against ``jax.vjp`` of the Pallas lookup, with
    -1 sentinels, other negatives and rows at or past k (they get no
    gradient and give none)."""
    idx, tables = _case(c, B, T, k, dsub, seed=c * 100 + B)
    dout = np.random.default_rng(B).normal(size=(B, c * dsub)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jops.cce_lookup(jnp.asarray(idx), t), jnp.asarray(tables))
    (want,) = vjp(jnp.asarray(dout))
    got = tref.cce_lookup_bwd_ref(torch.from_numpy(idx), torch.from_numpy(dout).reshape(B, c, dsub),
                                  k)
    assert got.shape == (c, T, k, dsub) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_cce_lookup_autograd_matches_pallas_vjp_on_strided_idx():
    """``ops.cce_lookup`` is differentiable: its gradient through the
    autograd Function equals the Pallas vjp, on the serving layout's
    strided idx view, and idx gets none."""
    c, B, T, k, dsub = 10, 12, 2, 50, 4
    idx, tables = _case(c, B, T, k, dsub, seed=8)
    view = torch.from_numpy(np.ascontiguousarray(idx.transpose(1, 0, 2))).movedim(0, 1)
    w = np.random.default_rng(9).normal(size=(B, c * dsub)).astype(np.float32)
    t = torch.from_numpy(tables).requires_grad_(True)
    (tops.cce_lookup(view, t) * torch.from_numpy(w)).sum().backward()
    _, vjp = jax.vjp(lambda x: jops.cce_lookup(jnp.asarray(idx), x), jnp.asarray(tables))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(jnp.asarray(w))[0]),
                               rtol=1e-5, atol=1e-6)


def test_cce_lookup_bwd_zero_rows_and_b_order():
    """Rows no index names (sentinel, padding past the largest index) are
    exactly zero, and each row sums its b in increasing order: the same
    float32 additions as a sequential loop."""
    c, B, T, k, dsub = 3, 50, 2, 20, 4
    rng = np.random.default_rng(10)
    idx = rng.integers(-1, 12, (c, B, T)).astype(np.int32)  # rows 12..19 unnamed
    dout = (rng.normal(size=(B, c, dsub)) * 10.0 ** rng.integers(-3, 4, (B, c, 1))).astype(np.float32)
    got = tref.cce_lookup_bwd_ref(torch.from_numpy(idx), torch.from_numpy(dout), k).numpy()
    want = np.zeros((c, T, k, dsub), np.float32)
    for i in range(c):
        for b in range(B):
            for t in range(T):
                if idx[i, b, t] >= 0:
                    want[i, t, idx[i, b, t]] += dout[b, i]
    np.testing.assert_array_equal(got, want)
    assert not got[:, :, 12:].any()


def test_cce_lookup_bwd_bf16_within_tolerance():
    """bf16: the plain version sums in float32 and rounds once; the JAX
    kernel rounds once per b-block.  Within a few bf16 steps of the float32
    gradient scale."""
    c, B, T, k, dsub = 6, 300, 2, 24, 4
    idx, tables = _case(c, B, T, k, dsub, seed=12)
    dout = np.random.default_rng(13).normal(size=(B, c * dsub)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jops.cce_lookup(jnp.asarray(idx), t),
                     jnp.asarray(tables, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(dout, jnp.bfloat16))
    got = tref.cce_lookup_bwd_ref(
        torch.from_numpy(idx), torch.from_numpy(dout).to(torch.bfloat16).reshape(B, c, dsub), k)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2**-6, atol=2**-6)


def test_cuda_bwd_wrapper_refuses_cpu_tensors():
    idx, _ = _case(2, 3, 2, 5, 4, seed=14)
    with pytest.raises(ValueError, match="CUDA"):
        tcl.cce_lookup_bwd(torch.from_numpy(idx), torch.zeros(3, 2, 4), 5)


# --- k-means assignment ---------------------------------------------------------


def _assign_distances(x, cent):
    """The kernels' expression ||c||^2 - 2<x, c> in float64, (n, k)."""
    x64, c64 = x.astype(np.float64), cent.astype(np.float64)
    return (c64 * c64).sum(-1)[None] - 2.0 * x64 @ c64.T


def _tie_tolerant(got, x, cent):
    """Every point's chosen centroid is within 1e-5 * (|min| + 1) of the
    nearest one (float32 sums in another order may swap near ties)."""
    d = _assign_distances(x, cent)
    best = d.min(1)
    chosen = d[np.arange(len(x)), got]
    assert (chosen - best <= 1e-5 * (np.abs(best) + 1)).all()


@pytest.mark.parametrize("n,k,d", [(1, 3, 4), (200, 250, 4), (513, 17, 4), (97, 40, 3), (64, 5, 16)])
def test_kmeans_assign_ref_matches_pallas(n, k, d):
    rng = np.random.default_rng(n + k)
    x = rng.normal(size=(n, d)).astype(np.float32)
    cent = rng.normal(size=(k, d)).astype(np.float32)
    want = np.asarray(jops.kmeans_assign(jnp.asarray(x), jnp.asarray(cent)))
    got = tops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(cent))
    assert got.dtype == torch.int32 and got.shape == (n,)
    _tie_tolerant(got.numpy(), x, cent)
    _tie_tolerant(want, x, cent)
    assert (got.numpy() == want).mean() >= 0.99


def test_kmeans_assign_exact_on_separated_data_and_ties_to_lowest():
    """Well-separated clusters: both agree exactly.  Duplicate centroids:
    the tie goes to the lowest index in both."""
    rng = np.random.default_rng(15)
    k, d = 30, 4
    cent = (rng.normal(size=(k, d)) * 100).astype(np.float32)
    lab = rng.integers(0, k, 400)
    x = (cent[lab] + rng.normal(size=(400, d)) * 0.01).astype(np.float32)
    cent = np.concatenate([cent, cent[:5]])  # ids 30..34 duplicate 0..4
    want = np.asarray(jops.kmeans_assign(jnp.asarray(x), jnp.asarray(cent)))
    got = tops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(cent)).numpy()
    np.testing.assert_array_equal(got, lab)
    np.testing.assert_array_equal(want, lab)


def test_cuda_kmeans_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tka.kmeans_assign(torch.zeros(4, 4), torch.zeros(2, 4))
