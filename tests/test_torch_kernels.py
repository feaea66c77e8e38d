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
        (2, 5, 2, 300, 384),  # the LM token table's width (wide_vector on the card)
        (3, 9, 2, 300, 36),
        (3, 48, 1, 50, 16),  # the hashing trick's width (narrow on the card)
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
        (2, 24, 2, 300, 384),  # the LM token table's width (wide_vector on the card)
        (3, 48, 1, 50, 16),  # the hashing trick's width (narrow on the card)
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


@pytest.mark.parametrize("dsub", [4, 16, 384])
def test_cce_lookup_bwd_hot_row_matches_pallas_vjp(dsub):
    """Half the batch of every (column, sub-table) names one row: the
    plain backward against ``jax.vjp`` of the Pallas lookup, and that
    row's gradient equals the float32 sum in increasing b."""
    c, B, T, k = 3, 48, 2, 300
    idx, tables = _case(c, B, T, k, dsub, seed=dsub)
    hot = np.random.default_rng(dsub + 1).permutation(B)[: B // 2]
    idx[:, hot, :] = 17
    dout = np.random.default_rng(dsub + 2).normal(size=(B, c * dsub)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jops.cce_lookup(jnp.asarray(idx), t), jnp.asarray(tables))
    (want,) = vjp(jnp.asarray(dout))
    got = tref.cce_lookup_bwd_ref(torch.from_numpy(idx), torch.from_numpy(dout).reshape(B, c, dsub),
                                  k).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    d = dout.reshape(B, c, dsub)
    for i in range(c):
        for t in range(T):
            seq = np.zeros(dsub, np.float32)
            for b in range(B):
                if idx[i, b, t] == 17:
                    seq += d[b, i]
            np.testing.assert_array_equal(got[i, t, 17], seq)


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


@pytest.mark.parametrize("dsub", [384, 6, 16])
def test_cuda_wrappers_refuse_cpu_tensors_at_wide_widths(dsub):
    idx, tables = _case(2, 3, 2, 5, dsub, seed=dsub)
    with pytest.raises(ValueError, match="CUDA"):
        tcl.cce_lookup_fwd(torch.from_numpy(idx), torch.from_numpy(tables))
    with pytest.raises(ValueError, match="CUDA"):
        tcl.cce_lookup_bwd(torch.from_numpy(idx), torch.zeros(3, 2, dsub), 5)


@pytest.mark.parametrize(
    "dsub,dtype,offset,path",
    [
        (4, torch.float32, 0, "vec4"),  # the Criteo supertable
        (4, torch.bfloat16, 0, "vec4"),
        (384, torch.float32, 0, "wide_vector"),  # the LM token table
        (384, torch.bfloat16, 0, "wide_vector"),
        (36, torch.float32, 0, "wide_vector"),
        (36, torch.bfloat16, 0, "wide_scalar"),  # 36 bf16 is not whole 16-byte vectors
        (6, torch.float32, 0, "wide_scalar"),
        (384, torch.float32, 1, "wide_scalar"),  # a view one element into its storage
        (4, torch.float32, 1, "wide_scalar"),
        (4, torch.bfloat16, 4, "vec4"),  # 8 bytes in: still aligned to its 8-byte rows
        (8, torch.float32, 0, "narrow"),  # rows of 2, 4, 8 or 16 16-byte vectors
        (16, torch.float32, 0, "narrow"),  # the hashing trick's supertable
        (64, torch.float32, 0, "narrow"),
        (16, torch.bfloat16, 0, "narrow"),
        (128, torch.bfloat16, 0, "narrow"),
        (16, torch.float32, 1, "wide_scalar"),  # one element off its storage
        (128, torch.float32, 0, "wide_vector"),  # 512-byte rows: a warp's slice
    ],
)
def test_lookup_path_selection(dsub, dtype, offset, path):
    """Which layout both kernels take for each width, dtype and alignment,
    read from the tensors' addresses as the launcher reads them."""
    flat = torch.zeros(64 * dsub + offset, dtype=dtype)
    view = flat[offset:].view(64, dsub)
    aligned = torch.zeros(64, dsub, dtype=dtype)
    assert aligned.data_ptr() % 16 == 0
    got = tcl.lookup_path(dsub, view.element_size(), view.data_ptr(), aligned.data_ptr())
    assert got == path and got in tcl.PATHS


# csrc/cce_lookup_bwd.cu's wide constants that the geometry must fit:
# b a sort CTA ranks, rows it counts at most, (row, chunk) starts a walk
# warp holds, warps a walk CTA, rows a hot CTA scans
_WIDE_SOURCE = {"kSortChunk": 1024, "kSortRows": 4096, "kWalkTable": 1024, "kWalkWarps": 4,
                "kHotScan": 128}


@pytest.mark.parametrize("c,B,T,k,slices,want", [
    # (n_chunks, range_rows, n_ranges, rows_per_warp, n_blocks, sort_ctas, walk_ctas,
    #  walk_warps, st_ints, sorted_ints)
    (4, 8192, 2, 4748, 3, (8, 2400, 2, 32, 149, 128, 304, 1192, 304000, 131072)),  # qwen2-1.5b
    (4, 8192, 2, 1000, 4, (8, 1024, 1, 16, 63, 64, 128, 504, 64064, 65536)),  # hymba-1.5b
    (4, 8192, 2, 8038, 4, (8, 4032, 2, 32, 252, 128, 504, 2016, 514560, 131072)),  # paligemma-3b
    (4, 8192, 2, 1572, 4, (8, 1600, 1, 32, 50, 64, 104, 400, 100672, 65536)),  # xlstm-1.3b
    (104, 2048, 2, 129, 2, (2, 160, 1, 32, 5, 416, 416, 1040, 54080, 425984)),  # 1 past 128 rows
    (1, 1024, 2, 4097, 8, (1, 2080, 2, 32, 129, 4, 66, 258, 8198, 4096)),  # 1 past a sort range
    (4, 1, 2, 4748, 3, (1, 2400, 2, 32, 149, 16, 304, 1192, 38000, 16384)),  # B=1
    (4, 0, 2, 4748, 3, (1, 2400, 2, 32, 149, 16, 304, 1192, 38000, 16384)),  # B=0: zeros written
    (2, 5003, 2, 4748, 3, (5, 2400, 2, 32, 149, 40, 152, 596, 95000, 40960)),  # ragged
    (26, 2048, 2, 305, 1, (2, 320, 1, 8, 39, 104, 520, 2028, 31824, 106496)),  # dsub 36: 8 rows
    (16, 40000, 2, 4748, 3, (40, 2400, 2, 16, 297, 2560, 2400, 9504, 6080000, 2621440)),  # table
    (1, tcl.WIDE_MAX_B, 1, 3, 1, (1024, 32, 1, 1, 3, 1024, 1, 3, 4096, 1 << 20)),  # largest B
])
def test_wide_bwd_geometry(c, B, T, k, slices, want):
    """The wide backward's geometry (one group of lanes a warp) and what the
    source launches from it: B in chunks of 1024, k in even 32-row-aligned
    ranges of at most 4096, walk warps of the fewest rows (a power of two
    up to 32) that bring them over all slices down to 2048, unless their
    starts in every chunk would pass 1024 ints, 4 warps a CTA, a hot CTA for
    every 128 rows of a (column, sub-table); the scratch holds every range's
    row starts and sorted b; every range and block inside one range, every
    shared memory within what a CTA may use."""
    src = _WIDE_SOURCE
    g = tcl.wide_bwd_geometry(c, B, T, k, slices)
    n_ranges = -(-k // g.range_rows)
    n_blocks = -(-k // g.rows_per_warp)
    lists = c * T * g.n_chunks
    st_ints, sorted_ints = lists * (k + n_ranges), lists * n_ranges * src["kSortChunk"]
    assert (g.n_chunks, g.range_rows, n_ranges, g.rows_per_warp, n_blocks, lists * n_ranges,
            c * T * -(-n_blocks // src["kWalkWarps"]), c * T * n_blocks, st_ints,
            sorted_ints) == want
    assert g.scratch_ints == st_ints + sorted_ints
    assert (tcl.WIDE_SORT_CHUNK, tcl.WIDE_SORT_ROWS, tcl.WIDE_WALK_TABLE) == (
        src["kSortChunk"], src["kSortRows"], src["kWalkTable"])
    assert g.n_chunks * 1024 >= max(B, 1) > (g.n_chunks - 1) * 1024
    assert n_ranges * g.range_rows >= k > (n_ranges - 1) * g.range_rows
    assert g.range_rows <= 4096 and g.range_rows % 32 == 0 and 32 % g.rows_per_warp == 0
    assert g.rows_per_warp * g.n_chunks <= 1024
    assert g.groups == 1

    def warps(r):
        return c * T * slices * -(-k // r)

    assert g.rows_per_warp == 1 or warps(g.rows_per_warp // 2) > 2048
    assert (g.rows_per_warp == 32 or 2 * g.rows_per_warp * g.n_chunks > 1024
            or warps(g.rows_per_warp) <= 2048)
    assert tcl.WIDE_WALK_LOAD == 2048
    rows_pad = -(-g.range_rows // 8) * 8  # 16-bit counts of 8 warps, row starts, warp sums
    assert 8 * rows_pad * 2 + (rows_pad + 1 + 8) * 4 <= tka.SMEM_LIMIT
    walk_ints = 4 * (2 * g.rows_per_warp + 1) * g.n_chunks  # a walk CTA's tables
    hot_ints = src["kHotScan"] + 8 + 2 * g.n_chunks + 2048  # a hot CTA's lists
    assert max(walk_ints, hot_ints) * 4 <= 48 * 1024  # no opt-in


def test_wide_bwd_constants_match_the_source():
    """The constants the geometry and its test take from
    csrc/cce_lookup_bwd.cu are the source's."""
    import pathlib
    import re

    src = (pathlib.Path(tcl.__file__).parent / "csrc" / "cce_lookup_bwd.cu").read_text()
    consts = {m[1]: m[2] for m in re.finditer(r"constexpr int (k\w+) = ([^;]+);", src)}

    def value(name):
        return eval(re.sub(r"k\w+", lambda m: str(value(m[0])), consts[name]))

    assert {name: value(name) for name in _WIDE_SOURCE} == _WIDE_SOURCE


@pytest.mark.parametrize("c,B,T,k,dsub,esize,path,want", [
    # (groups, rows_per_warp): one group wherever a row needs more than 16 lanes
    (4, 8192, 2, 4748, 384, 4, "wide_vector", (1, 32)),  # qwen2-1.5b
    (4, 2048, 2, 4748, 384, 4, "wide_vector", (1, 32)),  # a prefill's rows
    (4, 8192, 2, 8038, 512, 2, "wide_vector", (1, 32)),  # paligemma-3b, bfloat16
    (4, 8192, 2, 1572, 512, 4, "wide_vector", (1, 32)),  # xlstm-1.3b's training step
    (26, 2048, 2, 305, 36, 4, "wide_vector", (2, 8)),  # 9 lanes: 2 groups of 16, 4 rows each
    (26, 2048, 2, 305, 6, 4, "wide_scalar", (4, 8)),  # 2 lanes: 4 groups of 8, 2 rows each
    (26, 2048, 2, 305, 36, 2, "wide_scalar", (2, 8)),  # 9 lanes of 4 elements
    (26, 2048, 2, 305, 130, 4, "wide_scalar", (1, 32)),  # 33 lanes: 2 slices, 32 rows a warp
    (1, 1 << 20, 1, 3, 6, 4, "wide_scalar", (1, 1)),  # 1024 chunks: one group fits the table
    (1, 1 << 19, 1, 3, 6, 4, "wide_scalar", (2, 2)),  # 512 chunks: two groups of a row
])
def test_wide_bwd_geometry_groups(c, B, T, k, dsub, esize, path, want):
    """A walk warp splits into the most groups (1, 2, 4) whose lanes still
    cover a row, as many as the starts table of every chunk allows, each
    group walking rows_per_warp / groups rows: narrow tables walk two or
    four rows at once."""
    g = tcl.wide_bwd_geometry(c, B, T, k, tcl.wide_slices(dsub, esize, path),
                              tcl.wide_groups(dsub, esize, path))
    assert (g.groups, g.rows_per_warp) == want
    lanes = 32 // g.groups
    assert -(-dsub // (16 // esize if path == "wide_vector" else 4)) <= lanes or g.groups == 1
    assert g.rows_per_warp % g.groups == 0 and g.groups * g.n_chunks <= 1024


def test_wide_bwd_geometry_refuses_past_the_largest_batch():
    with pytest.raises(ValueError, match="B <="):
        tcl.wide_bwd_geometry(1, tcl.WIDE_MAX_B + 1, 1, 3, 1)


@pytest.mark.parametrize("dsub,esize,path,want", [
    (384, 4, "wide_vector", 3),  # qwen2-1.5b: 512-byte slices of 128 floats
    (384, 2, "wide_vector", 2),  # bfloat16: 256 elements a slice
    (400, 4, "wide_vector", 4),  # hymba-1.5b: a tail of 16 floats
    (512, 4, "wide_vector", 4),  # paligemma-3b
    (36, 2, "wide_scalar", 1),  # 128 elements a slice, one a lane and step
    (129, 4, "wide_scalar", 2),
])
def test_wide_slices(dsub, esize, path, want):
    assert tcl.wide_slices(dsub, esize, path) == want


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


@pytest.mark.parametrize("c,n,k,d", [
    (1, 1, 5, 4), (3, 1, 250, 4), (1, 513, 250, 4), (3, 513, 5, 4), (3, 1000, 250, 4),
    (1, 1000, 5, 3), (3, 513, 250, 3), (1, 513, 5, 16), (3, 1000, 250, 16), (3, 1, 5, 16),
])
def test_kmeans_assign_batched_ref_matches_pallas(c, n, k, d):
    """The batched plain version: each column tie-tolerant against the
    Pallas kernel (interpret mode) and bit for bit the one-column plain
    version."""
    rng = np.random.default_rng(c * 7 + n + k + d)
    x = rng.normal(size=(c, n, d)).astype(np.float32)
    cent = rng.normal(size=(c, k, d)).astype(np.float32)
    got = tops.kmeans_assign_batched(torch.from_numpy(x), torch.from_numpy(cent))
    assert got.dtype == torch.int32 and got.shape == (c, n)
    for i in range(c):
        want = np.asarray(jops.kmeans_assign(jnp.asarray(x[i]), jnp.asarray(cent[i])))
        _tie_tolerant(got[i].numpy(), x[i], cent[i])
        _tie_tolerant(want, x[i], cent[i])
        assert (got[i].numpy() == want).mean() >= 0.99
        assert torch.equal(got[i], tops.kmeans_assign(torch.from_numpy(x[i]),
                                                      torch.from_numpy(cent[i])))


def test_kmeans_assign_batched_writes_a_strided_slice_only():
    """``out`` a (c, n) slice of a wider int32 table (row stride > n): the
    picks land in the slice and nothing else changes."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(3, 50, 4)).astype(np.float32))
    cent = torch.from_numpy(rng.normal(size=(3, 9, 4)).astype(np.float32))
    table = torch.full((3, 70), -1, dtype=torch.int32)
    block = table[:, 7:57]
    assert not block.is_contiguous()
    got = tops.kmeans_assign_batched(x, cent, out=block)
    assert got.data_ptr() == block.data_ptr()
    assert torch.equal(table[:, 7:57], tref.kmeans_assign_batched_ref(x, cent))
    assert (table[:, :7] == -1).all() and (table[:, 57:] == -1).all()


@pytest.mark.parametrize("n,c,k,d,want", [
    (1 << 18, 1, 250, 4, (4, 128)),  # an assign_all chunk, one column: 512 CTAs
    (1 << 18, 4, 250, 4, (4, 128)),  # the chunk of a c=4 table in one launch: 2048 CTAs
    (64000, 1, 250, 4, (4, 64)),  # a Lloyd sample: 250 CTAs
    (1000, 1, 250, 4, (1, 64)),  # nothing fills the card: the smallest
    (1 << 18, 4, 250, 3, (8, 256)),  # d != 4: the tiled kernel, 8 x 8 pairs a thread
    (1 << 18, 4, tka.FAST_MAX_K + 1, 4, (8, 256)),  # k past the d = 4 kernel's slots
])
def test_assign_geometry(n, c, k, d, want):
    assert tka.assign_geometry(n, c, k, d, 132) == want
    p, threads = want
    if tka.fast_path(k, d) and p > 1:  # at least one CTA an SM
        assert c * -(-n // (p * threads)) >= 132
    if not tka.fast_path(k, d):
        assert want == (tka.tiles(n, c, k, d).tm, tka.tiles(n, c, k, d).threads)


@pytest.mark.parametrize("n,c,k,d,grid,k_tiles,d_steps", [
    (151936, 4, 4748, 384, (1187, 4), 38, 12),  # qwen2-1.5b's token table
    (32001, 4, 1000, 400, (251, 4), 8, 13),  # hymba-1.5b's: a d tail, n ragged
    (257216, 4, 8038, 512, (2010, 4), 63, 16),  # paligemma-3b's
    (5000, 2, 250, 3, (40, 2), 2, 1),  # d = 3: 4-byte copies
    (128 * 40 + 1, 2, 128 * 9 + 1, 64, (41, 2), 10, 2),  # ragged n and k
])
def test_tiled_geometry(n, c, k, d, grid, k_tiles, d_steps):
    """The tiled kernel's launch (csrc/kmeans_assign.cu's constants):
    128 points by 128 centroids a CTA of 256 threads, each 8 x 8, d in
    32-float steps through 3 stages of 16-byte padded rows, within the
    shared memory a CTA can opt into."""
    t = tka.tiles(n, c, k, d)
    assert (t.bm, t.bn, t.bk, t.stages, t.tm, t.tn, t.threads) == (128, 128, 32, 3, 8, 8, 256)
    assert t.threads == (t.bm // t.tm) * (t.bn // t.tn)
    assert t.smem_bytes == (3 * (128 + 128) * 36 + 128) * 4 == 111104
    assert 48 * 1024 < t.smem_bytes <= tka.SMEM_LIMIT == 232448
    assert (t.grid, t.k_tiles, t.d_steps) == (grid, k_tiles, d_steps)
    assert t.grid[0] * t.bm >= n > (t.grid[0] - 1) * t.bm and t.grid[1] <= 65535
    assert t.vec == (d % 4 == 0)


def test_fast_path_bounds():
    assert tka.FAST_MAX_K == 2456  # 20 bytes a slot, k rounded up to 8, in 48 KB
    assert tka.fast_path(250, 4) and tka.fast_path(tka.FAST_MAX_K, 4)
    assert not tka.fast_path(tka.FAST_MAX_K + 1, 4) and not tka.fast_path(250, 16)


@pytest.mark.parametrize("x,cent,out,match", [
    (torch.zeros(2, 5, 4), torch.zeros(3, 7, 4), None, "columns"),
    (torch.zeros(2, 5, 4), torch.zeros(2, 7, 3), None, "columns or d"),
    (torch.zeros(5, 4), torch.zeros(2, 7, 4), None, "shape"),
    (torch.zeros(2, 5, 4), torch.zeros(2, 7, 4), torch.zeros(2, 10, dtype=torch.int32)[:, ::2],
     "unit last stride"),
    (torch.zeros(2, 5, 4), torch.zeros(2, 7, 4), torch.zeros(2, 5), "int32"),
    (torch.zeros(2, 5, 4), torch.zeros(2, 7, 4), torch.zeros(2, 6, dtype=torch.int32), "shape"),
    (torch.zeros(2, 5, 4).double(), torch.zeros(2, 7, 4), None, "float32"),
    (torch.zeros(2, 4, 5).transpose(1, 2), torch.zeros(2, 7, 4), None, "contiguous"),
    (torch.zeros(2, 5, 4), torch.zeros(2, 7, 4), torch.zeros(2, 5, dtype=torch.int32), "CUDA"),
])
def test_cuda_kmeans_launcher_refuses(x, cent, out, match):
    with pytest.raises(ValueError, match=match):
        tka.kmeans_assign(x, cent, out=out)
