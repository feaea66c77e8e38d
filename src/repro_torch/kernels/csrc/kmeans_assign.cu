// Nearest-centroid assignment: the inner loop of the CCE clustering
// transition's full-vocabulary pass (CCE.assign_all, Algorithm 3 line 13).
//
// Replaces the TPU kernel src/repro/kernels/kmeans_assign.py::kmeans_assign_pallas
// (body _kernel), which runs a blocked X @ C.T on the MXU and carries a
// running (min, argmin) across its sequential k grid axis.  At the shapes of
// the transition (d = dsub = 4, k = 250) there is nothing for a tensor core
// to do, so it is written for the CUDA cores; the MXU blocks, the padding of
// n and k and the 1e15 pad centroids of the JAX wrapper are not carried over.
//
// Computes, for x (n, d) and centroids (k, d), both float32 and contiguous:
//   out[p] = argmin_j ( ||c_j||^2 - 2 <x_p, c_j> )      (int32)
// the TPU kernel's expression, without the ||x_p||^2 term (constant in j).
// ||c_j||^2 and the dot product are float32; j runs in increasing order with
// a strict `<`, so a tie goes to the lowest index, as in the TPU kernel.  The
// (n, k) distances never leave registers.
//
// Bound.  The function reads n*d*4 + k*d*4 bytes and writes n*4; it does
// n*k*(d + 1) fused multiply-adds (d for <x, c_j>, one for cn - 2*dot) plus a
// compare.  At the transition's chunk shape (n = 262144, k = 250, d = 4)
// that is 5.2 MB (1.6 us at 3.35 TB/s) against 655 MFLOP (9.8 us at the
// H100's 67 TFLOP/s in float32 outside the tensor cores): bound by
// operations.
//
// Design response.  One thread per point, x in registers; each CTA stages
// the centroids and their squared norms in shared memory once per tile of
// `tile` centroids (k = 250 is one tile of 5 KB), and every warp reads each
// centroid as one broadcast 16-byte shared load at d = 4.  Nothing else
// leaves the chip but the (n,) assignments.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// D > 0: the dimension is D at compile time (D == 4 is the main path);
// D == 0: any d, x read from global memory.
template <int D>
__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ cent,
                     int32_t* __restrict__ out, int64_t n, int k, int d, int tile) {
  extern __shared__ __align__(16) float smem[];
  const int dd = D > 0 ? D : d;
  float* s_c = smem;               // (tile, dd) centroids
  float* s_cn = smem + tile * dd;  // (tile,) squared norms
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = p < n;
  const float* xp = x + p * dd;
  float xv[D > 0 ? D : 1];
  if (D > 0 && live) {
#pragma unroll
    for (int e = 0; e < (D > 0 ? D : 1); ++e) xv[e] = __ldg(xp + e);
  }
  float best = INFINITY;
  int arg = 0;
  for (int j0 = 0; j0 < k; j0 += tile) {
    const int m = min(tile, k - j0);
    __syncthreads();  // every thread is done with the previous tile
    for (int q = threadIdx.x; q < m * dd; q += kThreads)
      s_c[q] = __ldg(cent + static_cast<int64_t>(j0) * dd + q);
    __syncthreads();
    for (int q = threadIdx.x; q < m; q += kThreads) {
      float s = 0.f;
      for (int e = 0; e < dd; ++e) s += s_c[q * dd + e] * s_c[q * dd + e];
      s_cn[q] = s;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < m; ++j) {
      float dot = 0.f;
      if (D == 4) {
        const float4 cj = reinterpret_cast<const float4*>(s_c)[j];
        dot = fmaf(xv[0], cj.x, dot);
        dot = fmaf(xv[D > 1 ? 1 : 0], cj.y, dot);
        dot = fmaf(xv[D > 2 ? 2 : 0], cj.z, dot);
        dot = fmaf(xv[D > 3 ? 3 : 0], cj.w, dot);
      } else if (D > 0) {
#pragma unroll
        for (int e = 0; e < (D > 0 ? D : 1); ++e) dot = fmaf(xv[e], s_c[j * dd + e], dot);
      } else {
        for (int e = 0; e < dd; ++e) dot = fmaf(__ldg(xp + e), s_c[j * dd + e], dot);
      }
      const float dist = s_cn[j] - 2.f * dot;
      if (dist < best) {
        best = dist;
        arg = j0 + j;
      }
    }
  }
  if (live) out[p] = arg;
}

}  // namespace

// The centroids tile that fits the 48 KB of shared memory a launch gets
// without opting in: tile * (d + 1) floats.
extern "C" int kmeans_assign_tile(int k, int d) {
  const int cap = (48 * 1024 / 4) / (d + 1);
  return k < cap ? k : cap;
}

// x (n, d) float32, centroids (k, d) float32, out (n,) int32, all contiguous
// on one device; n >= 1, k >= 1, 1 <= d.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int kmeans_assign(const void* x, const void* centroids, void* out, long long n, int k,
                             int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile = kmeans_assign_tile(k, d);
  if (tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tile) * (d + 1) * sizeof(float);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(centroids);
  int32_t* op = static_cast<int32_t*>(out);
  if (d == 4)
    kmeans_assign_kernel<4><<<blocks, kThreads, smem, st>>>(xp, cp, op, n, k, d, tile);
  else
    kmeans_assign_kernel<0><<<blocks, kThreads, smem, st>>>(xp, cp, op, n, k, d, tile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kmeans_assign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
