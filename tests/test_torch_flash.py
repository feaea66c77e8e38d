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
from repro_torch.kernels import ref as tref

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
    (40, 40, 8, 1, 256),  # paligemma-3b's heads: MQA (a group of 8) at head_dim 256
    (129, 129, 8, 1, 256),
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


@pytest.mark.parametrize("D", [8, 32, 96, 192, 512])
def test_flash_launcher_refuses_other_head_dims(D):
    """The kernel takes head_dim 64, 128 and 256 only, in both dtypes, and
    refuses every other before it looks for a card."""
    assert tfa.HEAD_DIMS == (64, 128, 256)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(x).to(dtype) for x in _inputs(1, 8, 8, 2, 1, D, seed=5))
        with pytest.raises(ValueError, match="head_dim"):
            tfa.flash_attention(q, k, v)


def test_flash_refuses_inputs_that_need_a_gradient():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 2, 1, 16, seed=4))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        tops.flash_attention(q, k, v)
    with torch.no_grad():
        assert tops.flash_attention(q, k, v).shape == (1, 8, 2, 16)


@pytest.mark.parametrize("H,KVH", [(12, 2), (32, 8)])  # qwen2-1.5b; qwen3-4b/14b style
@pytest.mark.parametrize("S", [16, 64, 129])
def test_flash_lm_head_geometry_matches_jax_oracle(S, H, KVH):
    """The plain version at the LM's real head geometry (D=128) in
    bfloat16, causal, against the JAX oracle."""
    q, k, v = _inputs(1, S, S, H, KVH, 128, seed=7 * S + H)
    got, want = _both(q, k, v, "bfloat16", causal=True)
    np.testing.assert_allclose(got, want, **TOL["bfloat16"])


def _fused_qkv(B, S, H, KVH, D):
    """q, k, v as the slices of one (B, S, (H + 2 KVH) D) projection."""
    qkv = torch.zeros((B, S, (H + 2 * KVH) * D), dtype=torch.bfloat16)
    q = qkv[..., :H * D].unflatten(-1, (H, D))
    k = qkv[..., H * D:(H + KVH) * D].unflatten(-1, (KVH, D))
    v = qkv[..., (H + KVH) * D:].unflatten(-1, (KVH, D))
    return q, k, v


def test_tma_geometry_contiguous():
    """(B, S, H, D) contiguous: dims innermost first, byte strides of s,
    h, b, and a box of 64 columns by the rows asked for."""
    t = torch.zeros((2, 300, 12, 128), dtype=torch.bfloat16)
    dims, strides, box = tfa.tma_geometry(t, 128)
    assert dims == (128, 300, 12, 2)
    assert strides == (12 * 128 * 2, 128 * 2, 300 * 12 * 128 * 2)
    assert box == (64, 128, 1, 1)
    assert dims[0] // box[0] == 2  # a row of D = 128 is two 64-column boxes


def test_tma_geometry_head_major_view():
    """(B, H, S, D) storage seen as (B, S, H, D), read in place: s steps
    one row of D, h one whole sequence."""
    t = torch.zeros((2, 12, 129, 128), dtype=torch.bfloat16).transpose(1, 2)
    dims, strides, box = tfa.tma_geometry(t, 64)
    assert dims == (128, 129, 12, 2)
    assert strides == (128 * 2, 129 * 128 * 2, 12 * 129 * 128 * 2)
    assert box == (64, 64, 1, 1)


@pytest.mark.parametrize("D", [64, 128])
def test_tma_geometry_fused_projection_slice(D):
    """q, k, v sliced from one fused projection: all three step a whole
    (H + 2 KVH) D row a position; a row of D = 64 is one box."""
    H, KVH, S = 12, 2, 40
    row = (H + 2 * KVH) * D * 2
    q, k, v = _fused_qkv(1, S, H, KVH, D)
    assert tfa.tma_geometry(q, 128) == ((D, S, H, 1), (row, D * 2, S * row), (64, 128, 1, 1))
    for t in (k, v):
        assert tfa.tma_geometry(t, tfa.block_n(D)) == ((D, S, KVH, 1), (row, D * 2, S * row),
                                                       (64, 128, 1, 1))
    assert D // 64 == (2 if D == 128 else 1)


def test_tma_geometry_at_head_dim_256():
    """paligemma-3b's q (B, S, 8, 256) and k, v (B, S, 1, 256): a row comes
    as four 64-column boxes; K/V tiles are 64 keys, so k's and v's boxes
    have 64 rows, and a q tile 64 (``block_rows`` never picks 128 at
    D = 256)."""
    q = torch.zeros((1, 300, 8, 256), dtype=torch.bfloat16)
    k = torch.zeros((1, 300, 1, 256), dtype=torch.bfloat16)
    assert tfa.block_n(256) == 64 and tfa.block_n(128) == tfa.block_n(64) == 128
    rows = tfa.block_rows(8, 2048, 8, 132, 256)
    assert rows == 64
    dims, strides, box = tfa.tma_geometry(q, rows)
    assert dims == (256, 300, 8, 1) and box == (64, 64, 1, 1)
    assert strides == (8 * 256 * 2, 256 * 2, 300 * 8 * 256 * 2)
    assert dims[0] // box[0] == 4
    assert tfa.tma_geometry(k, tfa.block_n(256)) == (
        (256, 300, 1, 1), (256 * 2, 256 * 2, 300 * 256 * 2), (64, 64, 1, 1))


def _unaligned_stride(B, S, H, D):
    """A (B, S, H, D) view whose s stride is 4 elements (8 bytes) past a
    16-byte multiple."""
    return torch.zeros((B, S, H * D + 4), dtype=torch.bfloat16)[..., :H * D].unflatten(-1, (H, D))


@pytest.mark.parametrize("case", ["contiguous", "head_major", "fused_slice", "unaligned_stride",
                                  "unaligned_base"])
def test_needs_copy_decision(case):
    """Copied: a (b, s, h) stride that is not a multiple of 16 bytes, or a
    base off 16 bytes.  Read in place (TMA): the other three layouts."""
    B, S, H, D = 1, 33, 4, 64
    if case == "contiguous":
        t, want = torch.zeros((B, S, H, D), dtype=torch.bfloat16), False
    elif case == "head_major":
        t, want = torch.zeros((B, H, S, D), dtype=torch.bfloat16).transpose(1, 2), False
    elif case == "fused_slice":
        t, want = _fused_qkv(B, S, H, H, D)[1], False  # k: base H*D elements in
    elif case == "unaligned_stride":
        t, want = _unaligned_stride(B, S, H, D), True
    else:
        flat = torch.zeros(B * S * H * D + 1, dtype=torch.bfloat16)
        t, want = flat[1:].view(B, S, H, D), True
    assert t.shape == (B, S, H, D)
    assert tfa.needs_copy(t) is want


@pytest.mark.parametrize("B,Sq,H,D,rows", [(1, 2048, 12, 128, 128), (1, 1024, 12, 128, 64),
                                            (1, 128, 12, 128, 64), (8, 1024, 12, 128, 128),
                                            (8, 2048, 8, 256, 64), (1, 2048, 32, 64, 128)])
def test_block_rows_fills_the_sms(B, Sq, H, D, rows):
    """128-row CTAs only where they still give each of 132 SMs one, and
    never at D = 256."""
    assert tfa.block_rows(B, Sq, H, 132, D) == rows


def _chip_smoke():
    """``chip_smoke.py`` at the repo root, imported without running it."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16_attention(q, k, v, allow):
    """One head as the bf16 kernel rounds it: P = exp(s - max) rounded to
    bf16, l summing the rounded values, the output rounded once."""
    s = (q @ k.T / q.shape[-1] ** 0.5).masked_fill(~allow, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True)).to(torch.bfloat16).float()
    return ((p @ v) / p.sum(-1, keepdim=True)).to(torch.bfloat16)


@pytest.mark.parametrize("fault", [None, "sees_next_key", "misses_own_key", "drops_a_tile"])
def test_flash_row_check_catches_a_mask_fault_on_late_rows(fault):
    """``chip_smoke.py``'s row-scaled check at S=2048, D=128, unit-normal
    bf16 inputs: the kernel's own roundings stay within FLASH_ROW_TOL of
    each row's scale; a mask wrong by one key on the late half of the
    rows, or one 128-key tile dropped from the last q tile, exceeds it
    many times over."""
    smoke = _chip_smoke()
    S, D = 2048, 128
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((S, D), dtype=np.float32))
               .to(torch.bfloat16).float() for _ in range(3))
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    causal = j <= i
    allow = {
        None: causal,
        "sees_next_key": torch.where(i >= S // 2, j <= i + 1, causal),
        "misses_own_key": torch.where(i >= S // 2, j < i, causal),
        "drops_a_tile": causal & ~((i >= S - 128) & (j >= S - 256) & (j < S - 128)),
    }[fault]
    want32 = tref.flash_attention_ref(*(x[None, :, None] for x in (q, k, v)), causal=True)
    got = _bf16_attention(q, k, v, allow)[None, :, None]
    err = smoke.flash_row_err(got, want32)
    if fault is None:
        assert err <= smoke.FLASH_ROW_TOL / 2
        assert (got.float() - want32).abs().max().item() <= smoke.FLASH_TOL["bfloat16"]
    else:
        assert err > 8 * smoke.FLASH_ROW_TOL
