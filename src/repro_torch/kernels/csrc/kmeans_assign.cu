// Nearest-centroid assignment: the inner loop of the CCE clustering
// transition's full-vocabulary pass (CCE.assign_all, Algorithm 3 line 13),
// for all c columns of a table in one launch.
//
// Replaces the TPU kernel src/repro/kernels/kmeans_assign.py::kmeans_assign_pallas
// (body _kernel), which runs a blocked X @ C.T on the MXU, takes the min and
// argmin of each k block and merges it into a running (min, argmin) with a
// strict `<` across its sequential k grid axis.  At the shapes of the
// transition (d = dsub = 4, k = 250) there is nothing for a tensor core to
// do; the MXU blocks, the padding of n and k and the 1e15 pad centroids of
// the JAX wrapper are not carried over.
//
// Computes, for x (c, n, d) and centroids (c, k, d), both float32 and
// contiguous, and out (c, n) int32 with a row stride (last stride 1):
//   out[i, p] = argmin_j ( ||c_ij||^2 - 2 <x_ip, c_ij> )
// the TPU kernel's expression, without the ||x||^2 term (constant in j).
// The arithmetic is the first version of this kernel's, so the picks equal
// its picks bit for bit: ||c_j||^2 = fma(c3, c3, fma(c2, c2, fma(c1, c1, c0*c0)))
// (the FMA chain that nvcc's default contraction made of its `s += c*c`);
// dot = fma(x3, c3, fma(x2, c2, fma(x1, c1, fma(x0, c0, 0)))); dist =
// fma(-2, dot, cn), which is cn - 2*dot rounded once, since 2*dot is exact;
// j in increasing order with a strict `<`, so a tie goes to the lowest j.
// The (c, n, k) distances never leave registers.
//
// Bound.  The function reads c*(n + k)*d*4 bytes, writes c*n*4 and does
// c*n*k*(d + 1) fused multiply-adds (d for <x, c_j>, one for cn - 2*dot) and
// a compare.  At the transition's chunk shape (n = 262144, k = 250, d = 4)
// that is 5.2 MB a column (1.6 us at 3.35 TB/s) against 655 MFLOP (9.8 us
// at the H100's 67 TFLOP/s in float32 outside the tensor cores): bound by
// operations.  The bound counts the FMAs only; every other instruction in
// the loop (loads, compares, selects, loop control) takes issue slots too.
//
// What held the first kernel back (0.0323 ms at the chunk shape, 3.3x the
// bound): one point a thread, so every (point, centroid) pair paid its own
// shared-memory loads of the centroid and its norm, two float adds and a
// compare-and-two-selects: 12.25 instructions a pair (its SASS) in one
// dependent chain a thread; and one launch (plus one copy) a column.
//
// Design.
// - Register blocking: a thread holds P points (P = 4, 2 or 1, a template
//   parameter): thread t of a CTA of T threads takes the points
//   base + t + i*T, i < P, so each warp-wide float4 load of x reads 512
//   contiguous bytes.  Each centroid is read from shared memory once for
//   P points, as one broadcast LDS.128 (its norms, 8 at a time, as two).
// - Centroids and their norms are staged in shared memory once per CTA
//   (k = 250 rounds up to 256 slots, 5 KB); the pad slots hold a zero
//   centroid with norm +inf, whose distance is +inf (or NaN), never a pick.
// - The centroid loop runs over fixed tiles of kTile = 8, each fully
//   unrolled: for every point the tile's 8 distances, their min by 7 FMNMX,
//   one strict compare against the running best and two selects that keep
//   the best and the tile's first index.  Once all tiles are done, each
//   point recomputes the 8 distances of its winning tile (the same
//   instructions on the same values) and takes the first that equals its
//   best.  That is the TPU kernel's blocked (min, argmin) merge, with the
//   argmin inside a block deferred to the end; the pick is the first j at
//   the minimum, as in a sequential strict scan (a NaN distance is never
//   picked; a point whose distances are all +inf or NaN gets 0).  It costs
//   5 FFMA + 7/8 FMNMX + 3/8 compare-and-select a pair, against 5 + 3.
// - P x 8 independent dot chains a tile give the schedulers instruction-
//   level parallelism without relying on occupancy.
// - Column batching: blockIdx.y is the column; a CTA reads x, centroids and
//   out at the column's offsets, so one launch assigns a whole
//   materialised (c, n, 4) chunk and writes straight into out[:, s:s+n] of
//   the (c, d1) pointer table.
// - The launcher picks (P, threads) with kernels/kmeans_assign.py::
//   assign_geometry (the largest P, then the larger CTA of 128 or 64
//   threads, that still gives at least one CTA an SM) and passes it in.
// - Tensor cores are not used.  The product is (n, 4) x (4, k): as an
//   augmented K = 8 TF32 product its 10-bit mantissas move distances by
//   ~1e-3 relative, far too coarse for the picks; 3xTF32 to recover float32
//   costs about the 5 FMAs a pair it replaces; and the compare and select
//   stay on the CUDA cores either way.
// Other shapes (d != 4, or a k whose slots do not fit 48 KB of shared
// memory) take kmeans_assign_general_kernel: one point a thread, the
// centroids staged in tiles, the same arithmetic in a sequential strict
// scan.
//
// What it reaches, and what bounds it (one H100, tools/probe_kmeans_assign.py).
// The P = 4 loop is 215 SASS instructions for 32 pairs, 6.72 a pair (160
// FFMA, 28 FMNMX, 10 LDS, 4 each of FSETP, FSEL and SEL, 5 of loop control);
// ptxas gives P = 4 64 registers (P = 2 43, P = 1 36, the general kernel
// 32), no spill.  At the chunk shape it takes ~0.027 ms, 2.8x the bound and
// twice what 6.72 instructions a pair would take at one a clock.  Built with
// -DKMEANS_ASSIGN_FFMA_ONLY (the same loop without its min, compare and
// selects; wrong picks) it takes ~0.016 ms: the 1.34 FMNMX, FSETP, FSEL
// and SEL a pair cost ~4 issue cycles each beside the FFMAs, and they are
// what separates the kernel from the FFMA floor.  The compare is the floor
// of any argmin on the CUDA cores: one per pair at least.
//
// KMEANS_ASSIGN_FFMA_ONLY is a diagnostic switch of the same kind as
// CCE_BWD_STAMPS in cce_lookup_bwd.cu: only tools/probe_kmeans_assign.py
// defines it, in a build of its own under build/repro_torch/probe;
// build.py never does, so the port's library always has the exact loop.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;  // centroids a step of the d = 4 loop
constexpr int kMaxThreads = 256;
constexpr int kSmemBytes = 48 * 1024;  // what a launch gets without opting in
constexpr int kSlotBytes = 5 * sizeof(float);  // a centroid (float4) and its norm
// the largest k the d = 4 kernel takes: its slots, rounded up to kTile, in kSmemBytes
constexpr int kFastMaxK = kSmemBytes / (kTile * kSlotBytes) * kTile;

__device__ __forceinline__ float norm4(const float4 c) {
  float s = fmaf(c.x, c.x, 0.f);
  s = fmaf(c.y, c.y, s);
  s = fmaf(c.z, c.z, s);
  return fmaf(c.w, c.w, s);
}

__device__ __forceinline__ float dist4(const float4 x, const float4 c, const float cn) {
  float dot = fmaf(x.x, c.x, 0.f);
  dot = fmaf(x.y, c.y, dot);
  dot = fmaf(x.z, c.z, dot);
  dot = fmaf(x.w, c.w, dot);
  return fmaf(-2.f, dot, cn);
}

template <int P>
__global__ void __launch_bounds__(kMaxThreads)
kmeans_assign_kernel(const float4* __restrict__ x, const float4* __restrict__ cent,
                     int32_t* __restrict__ out, int64_t n, int k, int k_slots,
                     int64_t out_stride) {
  extern __shared__ __align__(16) float4 s_c[];  // (k_slots,) centroids
  float* s_cn = reinterpret_cast<float*>(s_c + k_slots);  // (k_slots,) norms
  const int col = blockIdx.y;
  x += col * n;
  cent += static_cast<int64_t>(col) * k;
  out += col * out_stride;
  for (int j = threadIdx.x; j < k_slots; j += blockDim.x) {
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    float cn = INFINITY;
    if (j < k) {
      c = __ldg(cent + j);
      cn = norm4(c);
    }
    s_c[j] = c;
    s_cn[j] = cn;
  }
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x * P + threadIdx.x;
  float4 xv[P];
  float best[P];
  int tile[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int64_t p = first + static_cast<int64_t>(i) * blockDim.x;
    xv[i] = p < n ? __ldg(x + p) : make_float4(0.f, 0.f, 0.f, 0.f);
    best[i] = INFINITY;
    tile[i] = 0;
  }
  __syncthreads();
  for (int j0 = 0; j0 < k_slots; j0 += kTile) {
    float4 c[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) c[t] = s_c[j0 + t];
    const float4 n0 = reinterpret_cast<const float4*>(s_cn + j0)[0];
    const float4 n1 = reinterpret_cast<const float4*>(s_cn + j0)[1];
    const float cn[kTile] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
#pragma unroll
    for (int i = 0; i < P; ++i) {
#ifdef KMEANS_ASSIGN_FFMA_ONLY
      // a diagnostic build (tools/probe_kmeans_assign.py): the loop's 5 FFMA
      // a pair with no min, compare or select; its picks are wrong
#pragma unroll
      for (int t = 0; t < kTile; ++t) best[i] = dist4(xv[i], c[t], best[i]);
#else
      float m = dist4(xv[i], c[0], cn[0]);
#pragma unroll
      for (int t = 1; t < kTile; ++t) m = fminf(m, dist4(xv[i], c[t], cn[t]));
      if (m < best[i]) {
        best[i] = m;
        tile[i] = j0;
      }
#endif
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int64_t p = first + static_cast<int64_t>(i) * blockDim.x;
    if (p >= n) continue;
    int arg = 0;
    if (best[i] < INFINITY) {  // else no distance beat +inf: 0, as a sequential scan gives
#pragma unroll
      for (int t = kTile - 1; t >= 0; --t) {
        const int j = tile[i] + t;
        if (dist4(xv[i], s_c[j], s_cn[j]) == best[i]) arg = j;
      }
    }
    out[p] = arg;
  }
}

// Any d and k: one point a thread, x read from global memory, the
// centroids and their norms staged `tile` at a time.
__global__ void __launch_bounds__(kMaxThreads)
kmeans_assign_general_kernel(const float* __restrict__ x, const float* __restrict__ cent,
                             int32_t* __restrict__ out, int64_t n, int k, int d, int tile,
                             int64_t out_stride) {
  extern __shared__ __align__(16) float smem[];
  float* s_c = smem;              // (tile, d) centroids
  float* s_cn = smem + tile * d;  // (tile,) squared norms
  const int col = blockIdx.y;
  x += col * n * d;
  cent += static_cast<int64_t>(col) * k * d;
  out += col * out_stride;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = p < n;
  const float* xp = x + p * d;
  float best = INFINITY;
  int arg = 0;
  for (int j0 = 0; j0 < k; j0 += tile) {
    const int m = min(tile, k - j0);
    __syncthreads();  // every thread is done with the previous tile
    for (int q = threadIdx.x; q < m * d; q += blockDim.x)
      s_c[q] = __ldg(cent + static_cast<int64_t>(j0) * d + q);
    __syncthreads();
    for (int q = threadIdx.x; q < m; q += blockDim.x) {
      float s = 0.f;
      for (int e = 0; e < d; ++e) s = fmaf(s_c[q * d + e], s_c[q * d + e], s);
      s_cn[q] = s;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < m; ++j) {
      float dot = 0.f;
      for (int e = 0; e < d; ++e) dot = fmaf(__ldg(xp + e), s_c[j * d + e], dot);
      const float dist = fmaf(-2.f, dot, s_cn[j]);
      if (dist < best) {
        best = dist;
        arg = j0 + j;
      }
    }
  }
  if (live) out[p] = arg;
}

template <int P>
cudaError_t launch_fast(const float* x, const float* cent, int32_t* out, int c, int64_t n, int k,
                        int64_t out_stride, int threads, cudaStream_t st) {
  const int k_slots = (k + kTile - 1) / kTile * kTile;
  const int64_t per_cta = static_cast<int64_t>(threads) * P;
  const dim3 grid(static_cast<unsigned>((n + per_cta - 1) / per_cta), static_cast<unsigned>(c));
  kmeans_assign_kernel<P><<<grid, threads, static_cast<size_t>(k_slots) * kSlotBytes, st>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(cent), out, n, k,
      k_slots, out_stride);
  return cudaGetLastError();
}

}  // namespace

// x (c, n, d) float32 and centroids (c, k, d) float32, contiguous, x and
// centroids 16-byte aligned where d == 4; out (c, n) int32 with row stride
// out_stride (elements) and unit last stride; all on one device; c, n, k,
// d >= 1.  points (a thread) and threads (a CTA) come from
// assign_geometry: points in {1, 2, 4} (1 off the d = 4 kernel, which
// takes d == 4 and k <= kFastMaxK), threads in {64, 128, 256}.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int kmeans_assign(const void* x, const void* centroids, void* out, int c, long long n,
                             int k, int d, long long out_stride, int points, int threads,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(centroids);
  int32_t* op = static_cast<int32_t*>(out);
  if (c < 1 || c > 65535 || n < 1 || k < 1 || d < 1 ||
      (threads != 64 && threads != 128 && threads != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 4 && k <= kFastMaxK) {
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(centroids)) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
    switch (points) {
      case 4: return static_cast<int>(launch_fast<4>(xp, cp, op, c, n, k, out_stride, threads, st));
      case 2: return static_cast<int>(launch_fast<2>(xp, cp, op, c, n, k, out_stride, threads, st));
      case 1: return static_cast<int>(launch_fast<1>(xp, cp, op, c, n, k, out_stride, threads, st));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (points != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = kSmemBytes / static_cast<int>(sizeof(float)) / (d + 1);
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = k < cap ? k : cap;
  const dim3 grid(static_cast<unsigned>((n + threads - 1) / threads), static_cast<unsigned>(c));
  kmeans_assign_general_kernel<<<grid, threads, static_cast<size_t>(tile) * (d + 1) * sizeof(float),
                                 st>>>(xp, cp, op, n, k, d, tile, out_stride);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kmeans_assign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
