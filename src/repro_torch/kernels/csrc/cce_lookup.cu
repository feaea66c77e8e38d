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
// Bound.  The function must move B*c*T*4 bytes of idx, at most
// B*c*T*dsub*esize bytes of gathered rows (fewer when rows repeat, are
// sentinels or lie past k) and B*c*dsub*esize bytes of output, and it does
// at most B*c*T*dsub float adds: it is bound by bytes.  On the full Criteo
// configuration (c=104, T=2, k=305, dsub=4, float32) at a serving batch of
// B=256 that is 213 KB + <= 852 KB + 426 KB, about 1.5 MB, or about 0.45 us at
// the H100's 3.35 TB/s: far below the few microseconds a launch costs, so at
// serving batch sizes the kernel is bound by launch latency.
//
// Design response.  One launch covers every column and both sub-tables
// (main + helper) of the whole supertable, with no scratch memory, no second
// pass and no atomics.  One thread owns one (b, column) pair, the column
// index varying fastest, so the output stores of a warp are contiguous; in
// the serving layout (rows (B, c, T) seen through a (c, B, T) view, passed by
// strides without a copy) the idx reads are contiguous too.  At dsub=4 each
// stored row is one 16-byte load (8 bytes in bfloat16) and each output one
// vector store; other widths take a scalar loop.  The slab (about 1 MB on
// the Criteo configuration) stays resident in the 50 MB L2 from one launch
// to the next.  What remains is launch latency, which only fewer launches
// (a CUDA graph around the serve program) can cut.

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

constexpr int kThreads = 256;

template <typename scalar_t, bool kVec4>
__global__ void __launch_bounds__(kThreads)
cce_lookup_fwd_kernel(const int32_t* __restrict__ idx, const scalar_t* __restrict__ tables,
                      scalar_t* __restrict__ out, int c, int B, int T, int k, int dsub,
                      int64_t s_col, int64_t s_b, int64_t s_t) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (tid >= static_cast<int64_t>(B) * c) return;
  const int col = static_cast<int>(tid % c);
  const int64_t b = tid / c;
  const int32_t* ip = idx + col * s_col + b * s_b;
  const scalar_t* tab = tables + static_cast<int64_t>(col) * T * k * dsub;
  scalar_t* op = out + tid * dsub;  // out[b, col*dsub]: (b*c + col)*dsub
  if (kVec4) {
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
    store4(op, acc);
  } else {
    for (int d = 0; d < dsub; ++d) {
      float acc = 0.f;
      for (int t = 0; t < T; ++t) {
        const int r = __ldg(ip + t * s_t);
        if (r >= 0 && r < k) acc += to_float(tab[(static_cast<int64_t>(t) * k + r) * dsub + d]);
      }
      store1(op + d, acc);
    }
  }
}

template <typename scalar_t>
void launch(const void* idx, const void* tables, void* out, int c, int B, int T, int k, int dsub,
            int64_t s_col, int64_t s_b, int64_t s_t, bool vec4, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(B) * c;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const scalar_t* tp = static_cast<const scalar_t*>(tables);
  scalar_t* op = static_cast<scalar_t*>(out);
  if (vec4)
    cce_lookup_fwd_kernel<scalar_t, true><<<blocks, kThreads, 0, stream>>>(
        ip, tp, op, c, B, T, k, dsub, s_col, s_b, s_t);
  else
    cce_lookup_fwd_kernel<scalar_t, false><<<blocks, kThreads, 0, stream>>>(
        ip, tp, op, c, B, T, k, dsub, s_col, s_b, s_t);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec4 requires dsub == 4 and tables/out
// aligned to 4 elements (the caller checks).  Returns the cudaError_t of the
// launch (0 on success).  B*c >= 1.
extern "C" int cce_lookup_fwd(const void* idx, const void* tables, void* out, int dtype, int c,
                              int B, int T, int k, int dsub, long long s_col, long long s_b,
                              long long s_t, int vec4, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(idx, tables, out, c, B, T, k, dsub, s_col, s_b, s_t, vec4 != 0, st);
  else if (dtype == 1)
    launch<__nv_bfloat16>(idx, tables, out, c, B, T, k, dsub, s_col, s_b, s_t, vec4 != 0, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cce_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
