// Fused CCE lookup, forward: the hot loop of the paper,
// concat_i M_i[h_i(id)] + M'_i[h'_i(id)], for every column of the
// universal supertable in ONE launch.
//
// Replaces the TPU kernel src/repro/kernels/cce_lookup.py::cce_lookup_fwd_pallas
// (body _fwd_kernel), which writes the gather as blocked one-hot matmuls so
// that the MXU can do it.  Hopper gathers directly, so the one-hot matmul is
// not carried over.
//
// Computes, for idx (c, B, T) int32 (any strides) and tables (c, T, k, dsub)
// float32 or bfloat16 (contiguous):
//   out[b, i*dsub + d] = sum over t < T with 0 <= idx[i,b,t] < k of
//                        tables[i, t, idx[i,b,t], d]
// accumulated in float32 as `acc = 0; acc += row_t` in t order and stored in
// the table dtype.  An index < 0 (the -1 sentinel) or >= k adds nothing, as
// in the Pallas kernel.  In float32 this is bit for bit the plain version,
// src/repro_torch/kernels/ref.py::cce_lookup_ref.
//
// Bound.  The function must move B*c*T*4 bytes of idx, the distinct rows it
// gathers (at most B*c*T*dsub*esize bytes) and B*c*dsub*esize bytes of
// output, and it does at most B*c*T*dsub float adds: it is bound by bytes.
// On the Criteo supertable (c=104, T=2, k=305, dsub=4, float32) at the serve
// batch B=256 that is about 1.1 MB, 0.3 us at 3.35 TB/s: a launch costs
// more, so serving batches are bound by launch latency.  On the LM token
// table (c=4, T=2, k=4748, dsub=384, float32) a 2048-token prefill moves
// about 33 MB, 9.8 us; a decode tick of 8 tokens about 0.15 MB, 0.04 us.
//
// Design.  One launch covers every column and both sub-tables, with no
// scratch memory, no second pass and no atomics.  Four layouts, chosen by
// the launcher (cce_lookup.py::lookup_path) and named by the path argument:
//   vec4         dsub == 4, rows aligned: one thread owns one (b, column)
//                output row, the column fastest, and reads each stored row
//                with one 16-byte load (8 bytes in bfloat16).  A Criteo row
//                is 16 bytes, so a thread per row already reads whole rows.
//   narrow       rows of 2, 4, 8 or 16 16-byte vectors (float32 dsub 8, 16,
//                32, 64; bfloat16 16, 32, 64, 128), rows aligned: a group of
//                that many lanes owns one (b, column) output row, each lane
//                one 16-byte vector, and a warp holds 32/group consecutive
//                output rows, so its stores are one run of 512 bytes.  The
//                hashing trick's rows (dsub 16) take it.
//   wide_vector  any other dsub that is a multiple of 16 bytes' worth of
//                elements, rows aligned: the lanes of a warp run along d.
//                One warp owns a 512-byte slice of one (b, column) output
//                row (128 float32 or 256 bfloat16 elements); each lane loads
//                16 bytes, so one warp instruction reads 512 contiguous
//                bytes of a stored row.  The LM's dsub=384 takes it.
//   wide_scalar  any other width or an unaligned pointer: the same warp per
//                (row, slice), each lane holding elements lane + 32*j, j < 4,
//                loaded one at a time; still coalesced.
// The first version of this kernel gave every width the vec4 layout with a scalar loop over
// d: at dsub=384 the 32 lanes of a warp read 32 different 1.5 KB rows (no
// load coalesced), the index was reloaded inside the d loop, and a decode
// tick's 32 rows ran as one warp on one SM, 2 x 384 dependent loads deep.
// In the wide layouts each (row, t) index is one broadcast load, requested for
// two sub-tables before either row is loaded, and the grid has one warp per
// (row, slice): 96 warps over 24 CTAs for a decode tick, 24576 warps for a
// 2048-token prefill.  At dsub=16 that warp left 28 of its 32 lanes idle
// and took 11.8 times the byte bound; narrow puts 8 rows in a warp.

#include "cce_lookup_common.cuh"

namespace {

constexpr int kThreads = 256;      // vec4: a thread per output row; narrow: a lane group
constexpr int kWideThreads = 128;  // wide: 4 warps a CTA, so a decode tick spreads over SMs
constexpr int kTStep = 2;          // sub-tables whose indices are loaded before their rows

template <typename scalar_t>
__global__ void __launch_bounds__(kThreads)
cce_lookup_fwd_vec4_kernel(const int32_t* __restrict__ idx, const scalar_t* __restrict__ tables,
                           scalar_t* __restrict__ out, int c, int B, int T, int k,
                           int64_t s_col, int64_t s_b, int64_t s_t) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (tid >= static_cast<int64_t>(B) * c) return;
  const int col = static_cast<int>(tid % c);
  const int64_t b = tid / c;
  const int32_t* ip = idx + col * s_col + b * s_b;
  const scalar_t* tab = tables + static_cast<int64_t>(col) * T * k * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < T; ++t) {
    const int r = __ldg(ip + t * s_t);
    if (r >= 0 && r < k) {
      float v[4];
      load4(tab + (static_cast<int64_t>(t) * k + r) * 4, v);
      acc[0] += v[0];
      acc[1] += v[1];
      acc[2] += v[2];
      acc[3] += v[3];
    }
  }
  store4(out + tid * 4, acc);  // out[b, col*4]: (b*c + col)*4
}

// One warp per (output row, slice); warps are numbered (b, column, slice)
// with the slice fastest.
template <typename scalar_t, bool kVector>
__device__ __forceinline__ void fwd_wide(const int32_t* __restrict__ idx,
                                         const scalar_t* __restrict__ tables,
                                         scalar_t* __restrict__ out, int c, int B, int T, int k,
                                         int dsub, int64_t s_col, int64_t s_b, int64_t s_t) {
  using L = Lanes<scalar_t, kVector>;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int n_slices = (dsub + L::kSlice - 1) / L::kSlice;
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * (kWideThreads / 32) + (static_cast<int>(threadIdx.x) >> 5);
  if (w >= static_cast<int64_t>(B) * c * n_slices) return;  // the whole warp
  const int e0 = static_cast<int>(w % n_slices) * L::kSlice;
  const int64_t row = w / n_slices;  // b*c + col
  const int col = static_cast<int>(row % c);
  const int64_t b = row / c;
  const int32_t* ip = idx + col * s_col + b * s_b;
  const scalar_t* tab = tables + static_cast<int64_t>(col) * T * k * dsub;
  float acc[L::kPer];
#pragma unroll
  for (int j = 0; j < L::kPer; ++j) acc[j] = 0.f;
  for (int t0 = 0; t0 < T; t0 += kTStep) {
    int r[kTStep];
#pragma unroll
    for (int u = 0; u < kTStep; ++u) {  // every lane loads the same index: one broadcast
      const int t = t0 + u;
      r[u] = t < T ? __ldg(ip + t * s_t) : -1;
      if (r[u] >= k) r[u] = -1;
    }
    float v[kTStep][L::kPer];
#pragma unroll
    for (int u = 0; u < kTStep; ++u)
      if (r[u] >= 0) L::load(tab + (static_cast<int64_t>(t0 + u) * k + r[u]) * dsub, e0, lane,
                             dsub, v[u]);
#pragma unroll
    for (int u = 0; u < kTStep; ++u)  // in t order
      if (r[u] >= 0) {
#pragma unroll
        for (int j = 0; j < L::kPer; ++j) acc[j] += v[u][j];
      }
  }
  L::store(out + row * dsub, e0, lane, dsub, acc);
}

template <typename scalar_t>
__global__ void __launch_bounds__(kWideThreads)
cce_lookup_fwd_wide_vector_kernel(const int32_t* __restrict__ idx,
                                  const scalar_t* __restrict__ tables, scalar_t* __restrict__ out,
                                  int c, int B, int T, int k, int dsub, int64_t s_col, int64_t s_b,
                                  int64_t s_t) {
  fwd_wide<scalar_t, true>(idx, tables, out, c, B, T, k, dsub, s_col, s_b, s_t);
}

template <typename scalar_t>
__global__ void __launch_bounds__(kWideThreads)
cce_lookup_fwd_wide_scalar_kernel(const int32_t* __restrict__ idx,
                                  const scalar_t* __restrict__ tables, scalar_t* __restrict__ out,
                                  int c, int B, int T, int k, int dsub, int64_t s_col, int64_t s_b,
                                  int64_t s_t) {
  fwd_wide<scalar_t, false>(idx, tables, out, c, B, T, k, dsub, s_col, s_b, s_t);
}

// narrow: a group of dsub*esize/16 lanes per output row, groups numbered
// b*c + column; lane v of a group loads vector v of each stored row.  Each
// lane loads the indices of kTStep sub-tables before their rows, as
// fwd_wide does.
template <typename scalar_t>
__global__ void __launch_bounds__(kThreads)
cce_lookup_fwd_narrow_kernel(const int32_t* __restrict__ idx, const scalar_t* __restrict__ tables,
                             scalar_t* __restrict__ out, int c, int B, int T, int k, int dsub,
                             int64_t s_col, int64_t s_b, int64_t s_t) {
  using G = Group<scalar_t>;
  const int lg = __ffs(dsub / G::kPer) - 1;  // log2 of the lanes a row
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = gid >> lg;  // b*c + col
  if (row >= static_cast<int64_t>(B) * c) return;
  const int v = static_cast<int>(gid) & ((1 << lg) - 1);
  const int col = static_cast<int>(row % c);
  const int64_t b = row / c;
  const int32_t* ip = idx + col * s_col + b * s_b;
  const scalar_t* tab = tables + static_cast<int64_t>(col) * T * k * dsub;
  float acc[G::kPer];
#pragma unroll
  for (int j = 0; j < G::kPer; ++j) acc[j] = 0.f;
  for (int t0 = 0; t0 < T; t0 += kTStep) {
    int r[kTStep];
#pragma unroll
    for (int u = 0; u < kTStep; ++u) {  // the group's lanes load the same index
      const int t = t0 + u;
      r[u] = t < T ? __ldg(ip + t * s_t) : -1;
      if (r[u] >= k) r[u] = -1;
    }
    float x[kTStep][G::kPer];
#pragma unroll
    for (int u = 0; u < kTStep; ++u)
      if (r[u] >= 0) G::load(tab + (static_cast<int64_t>(t0 + u) * k + r[u]) * dsub, v, x[u]);
#pragma unroll
    for (int u = 0; u < kTStep; ++u)  // in t order
      if (r[u] >= 0) {
#pragma unroll
        for (int j = 0; j < G::kPer; ++j) acc[j] += x[u][j];
      }
  }
  G::store(out + row * dsub, v, acc);
}

template <typename scalar_t>
int launch(const void* idx, const void* tables, void* out, int c, int B, int T, int k, int dsub,
           int64_t s_col, int64_t s_b, int64_t s_t, int path, cudaStream_t stream) {
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const scalar_t* tp = static_cast<const scalar_t*>(tables);
  scalar_t* op = static_cast<scalar_t*>(out);
  const int64_t rows = static_cast<int64_t>(B) * c;
  if (path == kVec4) {
    if (dsub != 4) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>((rows + kThreads - 1) / kThreads);
    cce_lookup_fwd_vec4_kernel<scalar_t><<<blocks, kThreads, 0, stream>>>(
        ip, tp, op, c, B, T, k, s_col, s_b, s_t);
    return 0;
  }
  if (path == kNarrow) {
    const int lanes = dsub / Group<scalar_t>::kPer;
    if (dsub % Group<scalar_t>::kPer || lanes < 2 || lanes > 16 || (lanes & (lanes - 1)))
      return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>((rows * lanes + kThreads - 1) / kThreads);
    cce_lookup_fwd_narrow_kernel<scalar_t><<<blocks, kThreads, 0, stream>>>(
        ip, tp, op, c, B, T, k, dsub, s_col, s_b, s_t);
    return 0;
  }
  const int slice = path == kWideVector ? Lanes<scalar_t, true>::kSlice
                                        : Lanes<scalar_t, false>::kSlice;
  const int64_t warps = rows * ((dsub + slice - 1) / slice);
  const int64_t per_block = kWideThreads / 32;
  const unsigned blocks = static_cast<unsigned>((warps + per_block - 1) / per_block);
  if (path == kWideVector)
    cce_lookup_fwd_wide_vector_kernel<scalar_t><<<blocks, kWideThreads, 0, stream>>>(
        ip, tp, op, c, B, T, k, dsub, s_col, s_b, s_t);
  else if (path == kWideScalar)
    cce_lookup_fwd_wide_scalar_kernel<scalar_t><<<blocks, kWideThreads, 0, stream>>>(
        ip, tp, op, c, B, T, k, dsub, s_col, s_b, s_t);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  path: 0 = vec4 (dsub == 4, tables and
// out aligned to 4 elements), 1 = wide_vector (dsub a multiple of 16 bytes
// of elements, tables and out aligned to 16 bytes), 2 = wide_scalar (any),
// 3 = narrow (rows of 2, 4, 8 or 16 16-byte vectors, tables and out aligned
// to 16 bytes); the caller checks the alignment.  Returns the cudaError_t of the launch
// (0 on success).  B*c >= 1.
extern "C" int cce_lookup_fwd(const void* idx, const void* tables, void* out, int dtype, int c,
                              int B, int T, int k, int dsub, long long s_col, long long s_b,
                              long long s_t, int path, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0)
    err = launch<float>(idx, tables, out, c, B, T, k, dsub, s_col, s_b, s_t, path, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(idx, tables, out, c, B, T, k, dsub, s_col, s_b, s_t, path, st);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  return err ? err : static_cast<int>(cudaGetLastError());
}

extern "C" const char* cce_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
