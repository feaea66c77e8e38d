// Fused CCE lookup, backward: the gradient of every column and sub-table of
// the universal supertable in ONE launch, deterministic, without atomics.
//
// Replaces the TPU kernel src/repro/kernels/cce_lookup.py::cce_lookup_bwd_pallas
// (body _bwd_kernel), which writes the scatter-add as the transposed blocked
// one-hot matmul onehot(idx).T @ dout so that the MXU can do it.  Its
// b_blk/k_blk blocks exist to feed the MXU and are not carried over.
//
// Computes, for idx (c, B, T) int32 (any non-negative strides) and dout
// (B, c, dsub) float32 or bfloat16 (contiguous):
//   dtab[i, t, r, d] = sum over b with idx[i,b,t] == r of dout[b, i, d]
// for every r < k, accumulated in float32 as `acc = 0; acc += dout[b]` in
// increasing b and stored once in the dout dtype.  An index < 0 (the -1
// sentinel) or >= k matches no row, so it adds nothing; rows that no index
// names, and the padding rows of a ragged supertable, get exactly 0.
//
// Bound.  The function must read B*c*T*4 bytes of idx and B*c*dsub*esize
// bytes of dout and write c*T*k*dsub*esize bytes of dtab, and it does
// B*c*T*dsub float adds (fewer for sentinels): it is bound by bytes.  On the
// full Criteo configuration (c=104, T=2, k=305, dsub=4, float32) at a
// training batch of B=2048 that is 1.7 MB + 3.4 MB + 1.0 MB, about 6.1 MB,
// or about 1.8 us at the H100's 3.35 TB/s.
//
// Design response.  No float atomics anywhere (the JAX reference has none,
// and a train step must be bitwise repeatable), so every output row has ONE
// owner: one CTA per (column i, sub-table t), one thread per row r.  The CTA
// stages idx[i, :, t] through shared memory in chunks of kChunk entries
// (strided reads, passed by strides, never copied); every thread walks the
// chunk in b order (broadcast shared loads, four indices per 16-byte load)
// and, where the index is its own row, adds dout[b, i, :] (one 16-byte load
// at dsub=4 in float32, 8 bytes in bfloat16).  It writes its row once.  The
// scan costs B comparisons per thread, O(B*k) per CTA; that is the price of
// determinism without a sort, and it is far above the byte bound at large B.
// Making it fast (a counting sort per CTA, several CTAs per column) is a
// later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Four consecutive elements: one 16-byte load for float32, 8 bytes for bfloat16.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &x.x, sizeof(lo));
  memcpy(&hi, &x.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  memcpy(&x.x, &lo, sizeof(lo));
  memcpy(&x.y, &hi, sizeof(hi));
  *reinterpret_cast<uint2*>(p) = x;
}

constexpr int kMaxThreads = 1024;
constexpr int kChunk = 2048;  // idx entries staged per pass (8 KB), a multiple of 4

// Adds dout[b, col, :] (or its element d when !kVec4) to acc when the
// staged index q equals row r.
template <typename scalar_t, bool kVec4>
__device__ __forceinline__ void take(int q, int r, const scalar_t* src, int d, float acc[4]) {
  if (q != r) return;
  if (kVec4) {
    float v[4];
    load4(src, v);
    acc[0] += v[0];
    acc[1] += v[1];
    acc[2] += v[2];
    acc[3] += v[3];
  } else {
    acc[0] += to_float(src[d]);
  }
}

// Grid: c*T blocks, block b = col*T + t.  Threads own rows r0 + threadIdx.x.
// Without kVec4 each element d of a row is a separate pass over idx.
template <typename scalar_t, bool kVec4>
__global__ void __launch_bounds__(kMaxThreads)
cce_lookup_bwd_kernel(const int32_t* __restrict__ idx, const scalar_t* __restrict__ dout,
                      scalar_t* __restrict__ dtab, int c, int B, int T, int k, int dsub,
                      int64_t s_col, int64_t s_b, int64_t s_t) {
  __shared__ __align__(16) int32_t s_idx[kChunk];
  const int col = static_cast<int>(blockIdx.x) / T;
  const int t = static_cast<int>(blockIdx.x) - col * T;
  const int32_t* ip = idx + col * s_col + t * s_t;
  const scalar_t* dp = dout + static_cast<int64_t>(col) * dsub;  // dout[0, col, :]
  const int64_t d_b = static_cast<int64_t>(c) * dsub;            // stride of b in dout
  scalar_t* out = dtab + (static_cast<int64_t>(col) * T + t) * k * dsub;
  const int n_pass = kVec4 ? 1 : dsub;

  for (int r0 = 0; r0 < k; r0 += blockDim.x) {
    const int r = r0 + static_cast<int>(threadIdx.x);
    for (int d = 0; d < n_pass; ++d) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int b0 = 0; b0 < B; b0 += kChunk) {
        const int nb = min(kChunk, B - b0);
        const int nb4 = (nb + 3) & ~3;
        __syncthreads();  // every thread is done with the previous chunk
        for (int j = threadIdx.x; j < nb4; j += blockDim.x)
          s_idx[j] = j < nb ? __ldg(ip + static_cast<int64_t>(b0 + j) * s_b) : -1;
        __syncthreads();
        if (r < k) {
          const scalar_t* src = dp + static_cast<int64_t>(b0) * d_b;
          const int4* q4 = reinterpret_cast<const int4*>(s_idx);
          for (int j4 = 0; j4 < nb4 / 4; ++j4) {
            const int4 q = q4[j4];  // padded slots hold -1 and match no row
            const scalar_t* s = src + static_cast<int64_t>(4 * j4) * d_b;
            take<scalar_t, kVec4>(q.x, r, s, d, acc);
            take<scalar_t, kVec4>(q.y, r, s + d_b, d, acc);
            take<scalar_t, kVec4>(q.z, r, s + 2 * d_b, d, acc);
            take<scalar_t, kVec4>(q.w, r, s + 3 * d_b, d, acc);
          }
        }
      }
      if (r < k) {
        if (kVec4)
          store4(out + static_cast<int64_t>(r) * 4, acc);
        else
          store1(out + static_cast<int64_t>(r) * dsub + d, acc[0]);
      }
    }
  }
}

template <typename scalar_t>
void launch(const void* idx, const void* dout, void* dtab, int c, int B, int T, int k, int dsub,
            int64_t s_col, int64_t s_b, int64_t s_t, bool vec4, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(c) * static_cast<unsigned>(T);
  const int rows = (k + 31) / 32 * 32;
  const int threads = rows < kMaxThreads ? rows : kMaxThreads;
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const scalar_t* gp = static_cast<const scalar_t*>(dout);
  scalar_t* op = static_cast<scalar_t*>(dtab);
  if (vec4)
    cce_lookup_bwd_kernel<scalar_t, true><<<blocks, threads, 0, stream>>>(
        ip, gp, op, c, B, T, k, dsub, s_col, s_b, s_t);
  else
    cce_lookup_bwd_kernel<scalar_t, false><<<blocks, threads, 0, stream>>>(
        ip, gp, op, c, B, T, k, dsub, s_col, s_b, s_t);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of dout and dtab).  vec4 requires
// dsub == 4 and dout/dtab aligned to 4 elements (the caller checks).
// Writes every element of dtab (c, T, k, dsub).  Returns the cudaError_t of
// the launch (0 on success).  c*T >= 1, k >= 1, B >= 0.
extern "C" int cce_lookup_bwd(const void* idx, const void* dout, void* dtab, int dtype, int c,
                              int B, int T, int k, int dsub, long long s_col, long long s_b,
                              long long s_t, int vec4, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(idx, dout, dtab, c, B, T, k, dsub, s_col, s_b, s_t, vec4 != 0, st);
  else if (dtype == 1)
    launch<__nv_bfloat16>(idx, dout, dtab, c, B, T, k, dsub, s_col, s_b, s_t, vec4 != 0, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cce_lookup_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
