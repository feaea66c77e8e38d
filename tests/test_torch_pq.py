"""Port vs JAX package: post-training product quantisation
(``core/pq.py``).  Given one PQ result, ``pq_lookup`` and ``pq_table``
equal JAX's bit for bit.  ``product_quantize`` with JAX's kmeans++ seeds
(and, with ``sample``, JAX's row draw) handed to the port gives JAX's
codebooks within 1e-5, at least 99% of its assignments and its MSE within
1e-5 relative.  The chunked assignment through the assignment kernel's
entry point equals the per-block assignment."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkm
from repro.core import pq as jpq
from repro_torch import random as jr
from repro_torch.core import kmeans as tkm
from repro_torch.core import pq as tpq
from repro_torch.kernels import ops as tkops

torch.backends.cuda.matmul.allow_tf32 = False

KEY = 3


def _table(d1=1500, d2=16, seed=0):
    """A clusterable table: 24 centres plus noise."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(24, d2)).astype(np.float32)
    return (centres[rng.integers(0, 24, d1)]
            + 0.1 * rng.normal(size=(d1, d2))).astype(np.float32)


def _jax_seeds(key, x, k, weights=None):
    """The JAX package's kmeans++ on the port's (identical) inputs."""
    return torch.from_numpy(np.array(jkm.kmeans_plus_plus(
        jnp.asarray(np.asarray(key, np.uint32)), jnp.asarray(x.numpy()), k,
        None if weights is None else jnp.asarray(weights.numpy()))))


def _jax_sample(key, d1, n, device):
    return torch.from_numpy(np.array(jax.random.choice(
        jnp.asarray(np.asarray(key, np.uint32)), d1, (n,), replace=False))).long()


def test_pq_lookup_and_table_equal_jax():
    rng = np.random.default_rng(1)
    codebooks = rng.normal(size=(4, 10, 3)).astype(np.float32)
    assignments = rng.integers(0, 10, (4, 200)).astype(np.int32)
    jres = jpq.PQResult(jnp.asarray(codebooks), jnp.asarray(assignments), 0.0)
    tres = tpq.PQResult(torch.from_numpy(codebooks), torch.from_numpy(assignments), 0.0)
    ids = rng.integers(0, 200, (7, 5))
    got = tpq.pq_lookup(tres, torch.from_numpy(ids))
    assert got.shape == (7, 5, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpq.pq_lookup(jres, jnp.asarray(ids))))
    np.testing.assert_array_equal(tpq.pq_table(tres).numpy(), np.asarray(jpq.pq_table(jres)))


@pytest.mark.parametrize("sample", [None, 600])
def test_product_quantize_matches_jax(monkeypatch, sample):
    table = _table()
    want = jpq.product_quantize(jax.random.PRNGKey(KEY), jnp.asarray(table), 16, 4, niter=8,
                                sample=sample)
    monkeypatch.setattr(tkm, "kmeans_plus_plus", _jax_seeds)
    monkeypatch.setattr(tpq, "_sample", _jax_sample)
    got = tpq.product_quantize(jr.PRNGKey(KEY), torch.from_numpy(table), 16, 4, niter=8,
                               sample=sample)
    assert got.codebooks.shape == (4, 16, 4) and got.assignments.dtype == torch.int32
    np.testing.assert_allclose(got.codebooks.numpy(), np.asarray(want.codebooks),
                               rtol=1e-5, atol=1e-5)
    agree = (got.assignments.numpy() == np.asarray(want.assignments)).mean()
    assert agree >= 0.99, agree
    np.testing.assert_allclose(got.mse, want.mse, rtol=1e-5)
    # the MSE is that of the reconstruction
    recon = tpq.pq_table(got)
    np.testing.assert_allclose(got.mse, float(((recon - torch.from_numpy(table)) ** 2).mean()),
                               rtol=1e-5)


def test_chunked_kernel_assignment_equals_per_block():
    table = torch.from_numpy(_table(d1=1000, seed=2))
    codebooks = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 12, 4))
                                 .astype(np.float32))
    calls = []
    orig = tkops.kmeans_assign_batched

    def counted(x, c, out=None):
        calls.append(x.shape)
        return orig(x, c, out=out)

    plain = tpq.assign_rows(table, codebooks)  # a CPU table: km.assign per block
    blocks = table.reshape(1000, 4, 4)
    chunks = ((s, blocks[s: s + 333].movedim(1, 0)) for s in range(0, 1000, 333))
    out = torch.full((4, 1000), -1, dtype=torch.int32)
    tkops.kmeans_assign_batched = counted
    try:
        kern = tkm.assign_chunks(chunks, codebooks, out, use_kernel=True)
    finally:
        tkops.kmeans_assign_batched = orig
    assert kern is out
    assert torch.equal(kern, plain)
    assert calls == [(4, 333, 4)] * 3 + [(4, 1, 4)]
    for i in range(4):
        assert torch.equal(plain[i], tkm.assign(blocks[:, i], codebooks[i]))


def test_quantisation_error_falls_with_k():
    table = torch.from_numpy(_table(d1=800, seed=4))
    mses = [tpq.product_quantize(jr.PRNGKey(1), table, k, 4, niter=10).mse for k in (2, 8, 32)]
    assert mses[0] > mses[1] > mses[2] > 0
