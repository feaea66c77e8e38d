"""Port vs JAX package: flash attention.  On the CPU the port's
``ops.flash_attention`` runs its plain version, held here against the JAX
oracle ``repro.kernels.ref.flash_attention_ref`` (the Pallas kernel itself
does not run under this jax) on the same numpy inputs: float32 within
rtol 1e-4 / atol 1e-5 (the two sum in different orders), bfloat16 within
2e-2 (one bf16 rounding of the output), the tolerances of the JAX
package's own flash tests.  The CUDA kernel is held against the same
plain version on the card by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_ORACLE = jax.jit(jref.flash_attention_ref, static_argnames="causal")  # one compile a shape
TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(B, Sq, S, H, KVH, D, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, Sq, H, D)) * scale).astype(np.float32)
    k = (rng.normal(size=(B, S, KVH, D)) * scale).astype(np.float32)
    v = (rng.normal(size=(B, S, KVH, D)) * scale).astype(np.float32)
    return q, k, v


def _both(q, k, v, dtype, causal):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = _ORACLE(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal)
    got = tops.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,S,H,KVH,D", [
    (128, 128, 4, 2, 16),  # the JAX package's flash sweep
    (256, 256, 2, 1, 32),
    (64, 64, 8, 8, 8),
])
def test_flash_matches_jax_oracle(Sq, S, H, KVH, D, dtype):
    q, k, v = _inputs(2, Sq, S, H, KVH, D, seed=Sq + H)
    got, want = _both(q, k, v, dtype, causal=True)
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,S", [(1, 1), (7, 7), (127, 127), (129, 129), (5, 9), (9, 5)])
def test_flash_ragged_lengths_match_jax_oracle(Sq, S, causal):
    """Lengths that no block size divides, and Sq != S (query 0 aligned
    with key 0), with and without the causal mask; GQA 12 over 2."""
    q, k, v = _inputs(1, Sq, S, 12, 2, 16, seed=100 * Sq + S, scale=1.0)
    got, want = _both(q, k, v, "float32", causal=causal)
    np.testing.assert_allclose(got, want, **TOL["float32"])


def test_flash_first_row_attends_self_only():
    q, k, v = _inputs(1, 64, 64, 4, 2, 8, seed=2, scale=1.0)
    out = tops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(out[0, 0].numpy(), np.repeat(v[0, 0], 2, axis=0), rtol=1e-5)


def test_flash_launcher_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 2, 1, 64, seed=3))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k, v)


def test_flash_refuses_inputs_that_need_a_gradient():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 2, 1, 16, seed=4))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        tops.flash_attention(q, k, v)
    with torch.no_grad():
        assert tops.flash_attention(q, k, v).shape == (1, 8, 2, 16)
