"""Port vs JAX package: the fused CCE lookup.  On the CPU the port's
``ops.cce_lookup`` runs its plain version, held bit for bit (float32)
against the Pallas kernel in interpret mode; the CUDA kernel itself is
held against the same plain version on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import cce_lookup as tcl
from repro_torch.kernels import ops as tops

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
