// Nearest-centroid assignment: the inner loop of the CCE clustering
// transition's full-vocabulary pass (CCE.assign_all, Algorithm 3 line 13),
// for all c columns of a table in one launch.
//
// Replaces the TPU kernel src/repro/kernels/kmeans_assign.py::kmeans_assign_pallas
// (body _kernel), which runs a blocked X @ C.T on the MXU, takes the min and
// argmin of each k block and merges it into a running (min, argmin) with a
// strict `<` across its sequential k grid axis.  The MXU blocks, the padding
// of n and k and the 1e15 pad centroids of the JAX wrapper are not carried
// over.
//
// Computes, for x (c, n, d) and centroids (c, k, d), both float32 and
// contiguous, and out (c, n) int32 with a row stride (last stride 1):
//   out[i, p] = argmin_j ( ||c_ij||^2 - 2 <x_ip, c_ij> )
// the TPU kernel's expression, without the ||x||^2 term (constant in j).
// Both kernels below do the same arithmetic, so their picks equal the first
// version's bit for bit: ||c_j||^2 and dot = <x, c_j> are each one FMA chain
// from +0 over e = 0 .. d-1 in increasing order (||c||^2: s = fma(c_e, c_e,
// s); dot = fma(x_e, c_e, dot)); dist = fma(-2, dot, cn), which is cn - 2*dot
// rounded once, since 2*dot is exact; the pick is the first j at the minimum,
// as in a sequential scan over j with a strict `<` (a NaN distance is never
// picked; a point whose distances are all +inf or NaN gets 0).  The (c, n, k)
// distances never leave registers.
//
// Bound.  The function reads c*(n + k)*d*4 bytes, writes c*n*4 and does
// c*n*k*(d + 1) fused multiply-adds (d for <x, c_j>, one for cn - 2*dot) and
// a compare: bound by operations at every shape the port launches, at the
// H100's 67 TFLOP/s in float32 outside the tensor cores.  At the transition's
// chunk shape (n = 262144, k = 250, d = 4) that is 9.8 us a column; at the LM
// token table (c = 4, n = 151936, k = 4748, d = 384) 33.16 ms.
//
// 1. kmeans_assign_kernel<P>: d = 4, k <= kFastMaxK (the DLRM tables).
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
//   argmin inside a block deferred to the end.  It costs 5 FFMA + 7/8
//   FMNMX + 3/8 compare-and-select a pair, against 5 + 3.
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
//
// What it reaches (one H100, tools/probe_kmeans_assign.py).  The P = 4 loop
// is 215 SASS instructions for 32 pairs, 6.72 a pair (160 FFMA, 28 FMNMX, 10
// LDS, 4 each of FSETP, FSEL and SEL, 5 of loop control); ptxas gives P = 4
// 64 registers (P = 2 43, P = 1 36), no spill.  At the chunk shape it takes
// ~0.027 ms, 2.8x the bound and twice what 6.72 instructions a pair would
// take at one a clock.  Built with -DKMEANS_ASSIGN_FFMA_ONLY (the same loop
// without its min, compare and selects; wrong picks) it takes ~0.016 ms:
// the 1.34 FMNMX, FSETP, FSEL and SEL a pair cost ~4 issue cycles each
// beside the FFMAs, and they are what separates the kernel from the FFMA
// floor.  The compare is the floor of any argmin on the CUDA cores: one
// per pair at least.
//
// 2. kmeans_assign_tiled_kernel: every other shape (any d >= 1, or d = 4
// with k > kFastMaxK); the LM token tables (d = dsub = 384, 400, 512).
//
// What held the kernel it replaces back (kmeans_assign_general_kernel, one
// point a thread: 5976.8 ms at the LM token table, 180x the bound and ~88x
// slower than cdist+argmin, which writes and re-reads a (4, 151936, 4748)
// float32 matrix): each thread walked its own point with __ldg at a stride
// of d*4 = 1536 B, so a warp's load touched 32 sectors for 128 useful
// bytes; every FFMA paid one global and one shared load; a CTA's 256
// points (384 KB) fell out of L1 for every centroid; and only 31 centroids
// of d = 384 fitted a 48 KB tile, re-read for each of 153 tiles with three
// barriers each.
//
// Design: a SIMT float32 GEMM of X (BM x d) by C^T (d x BN) whose epilogue
// is the argmin.
// - Tiles.  A CTA owns kTiledM = 128 points of one column (blockIdx.x,
//   blockIdx.y = the column) and loops over all centroid tiles of kTiledN =
//   128; that loop takes the place of the TPU kernel's sequential k grid
//   axis.  256 threads, each with a kTM x kTN = 8 x 8 block of dot
//   accumulators in registers: thread (ty, tx) = (tid / 16, tid % 16) holds
//   points ty + 16 i and centroids tx + 16 j of the tile.
// - The ring.  d goes in steps of kBK = 32 floats through kStages = 3
//   stages of shared memory, each an x tile (128 x 32) and a centroid tile
//   (128 x 32), rows padded by 16 B to 36 floats.  The ring runs over the
//   flattened (centroid tile, d step) sequence, so the next tile's first
//   steps are in flight during a tile's epilogue.  Where d % 4 == 0 (rows
//   16-B aligned; the wrapper clones a misaligned tensor) each thread fills
//   its share with cp.async.cg 16-byte copies, warp by warp 128 contiguous
//   bytes of a row; elsewhere (d = 3) with 4-byte cp.async.ca copies.
//   Rows past n or k and floats past d are zero-filled (src-size 0): a zero
//   adds +-0 to a chain, which moves no distance.  cp.async.wait_group and
//   one barrier a step.  Each thread sets up its copies' addresses once
//   (StageCopy) and the ring's position lives in counters, so a step does
//   no division and no 64-bit row arithmetic.  111,104 B of dynamic shared
//   memory, opted into with cudaFuncSetAttribute once a device before the
//   first launch.
// - The inner loop.  Both operands are d-contiguous (the product is
//   X C^T, "NT"), so for each 4-float e step a thread reads its 8 points'
//   and its 8 centroids' float4s as LDS.128 and issues 8 x 8 x 4 FFMA, in
//   e order for each accumulator: 16 loads for 256 FMAs.  The 16-B pad puts
//   the 8 rows a quarter-warp reads at one e in 8 different bank groups,
//   and the 16 threads that share a point read its row as a broadcast.
// - Norms.  Threads 0..127 each carry one centroid's ||c||^2 chain over
//   the d steps of a tile, read from the same stages (32 FMAs a step beside
//   2048), and write it to shared memory at the tile's end; a pad slot
//   (j >= k) gets NaN, so its distance is NaN and never a pick.
// - Selection.  After each centroid tile a thread turns its 64 dots into
//   distances, dist = fma(-2, dot, cn), and keeps a running (best, arg) for
//   each of its points in increasing j with a strict `<`.  At the end the
//   16 threads of a point merge by (dist, j) lexicographically through
//   warp shuffles: the first j at the minimum, as a sequential scan gives.
// - Tensor cores are not used, on purpose: TF32 (or 3xTF32 with an exact
//   re-check) would give up the bit-equal FMA chain, and the assignment is
//   now a small share of a transition.  The bound above is this design's.
// KMEANS_ASSIGN_TM, KMEANS_ASSIGN_STAGES and KMEANS_ASSIGN_MIN_BLOCKS set
// the tiled kernel's points a thread, ring depth and CTAs an SM for
// tools/probe_kmeans_assign.py's variant builds; build.py defines none of
// them, so the port's library has the values above
// (kernels/kmeans_assign.py::tiles mirrors them).
//
// What it reaches ("NVIDIA H100 80GB HBM3, 700.00 W", SM clock 1980 MHz
// under load; tools/probe_kmeans_assign.py).  ptxas: 254 registers, no
// spill, so one CTA (8 warps) an SM.  The d-step loop, its tile-end branch
// included, is 2683 SASS instructions: 2144 FFMA (0.80), 0.069 LDS a FFMA.
// At qwen2-1.5b's token table it takes ~54.5 ms, 0.61 of the 33.16 ms
// bound and ~110x faster than the general kernel; the first version of
// this kernel, which divided the step index and recomputed 64-bit offsets
// each step, took ~60.4 ms.  The schedulers issue ~0.72 instructions a
// cycle: with two warps each, their stalls and not the issue slots hold
// it back.  Variants timed in the same call (the probe's -D builds): 2 or
// 4 stages no faster; 2 CTAs an SM (128 registers) spill and lose; 4
// points a thread with 512 threads (16 warps, 128 registers) loses to its
// 50% more loads a FFMA.
//
// KMEANS_ASSIGN_FFMA_ONLY is a diagnostic switch of the same kind as
// CCE_BWD_STAMPS in cce_lookup_bwd.cu: only tools/probe_kmeans_assign.py
// defines it, in a build of its own under build/repro_torch/probe;
// build.py never does, so the port's library always has the exact loop.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- 1. the d = 4 kernel ----

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

// ---- 2. the tiled kernel: any d, any k ----

#ifndef KMEANS_ASSIGN_TM
#define KMEANS_ASSIGN_TM 8
#endif
#ifndef KMEANS_ASSIGN_STAGES
#define KMEANS_ASSIGN_STAGES 3
#endif
#ifndef KMEANS_ASSIGN_MIN_BLOCKS
#define KMEANS_ASSIGN_MIN_BLOCKS 1
#endif

constexpr int kTM = KMEANS_ASSIGN_TM;  // points a thread
constexpr int kTN = 8;  // centroids a thread
constexpr int kTiledM = 128;  // points a CTA
constexpr int kTiledN = 128;  // centroids a tile
constexpr int kTiledThreads = (kTiledM / kTM) * (kTiledN / kTN);
constexpr int kBK = 32;  // floats of d a stage
constexpr int kBKP = kBK + 4;  // a staged row, padded by 16 B
constexpr int kStages = KMEANS_ASSIGN_STAGES;
constexpr size_t kTiledSmemBytes =
    (static_cast<size_t>(kStages) * (kTiledM + kTiledN) * kBKP + kTiledN) * sizeof(float);
static_assert(kBK % 4 == 0 && kStages >= 2, "the ring takes float4 steps and two stages at least");
static_assert(32 % (kTiledN / kTN) == 0, "the threads of a point share a warp");
static_assert(kTiledN <= kTiledThreads, "a thread a centroid norm");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's share of the copies of R rows of a (rows, d) matrix into a
// stage (R, kBKP): kPerRow copies a row (16 or 4 bytes each), the thread's
// rows r0 + i * kRowStep, its floats e .. of each d step.  Rows past the
// matrix and floats past d are zero-filled.
template <int R, bool VEC>
struct StageCopy {
  static constexpr int kPerRow = VEC ? kBK / 4 : kBK;
  static constexpr int kRowStep = kTiledThreads / kPerRow;
  static_assert(kTiledThreads % kPerRow == 0 && R % kRowStep == 0, "copies split evenly");
  const float* src;  // the thread's first row, at its first float
  int64_t row_step;  // kRowStep rows, in floats
  int r0, e, d;

  __device__ StageCopy(const float* g, int d_) : d(d_) {
    r0 = threadIdx.x / kPerRow;
    e = VEC ? 4 * (threadIdx.x % kPerRow) : threadIdx.x % kPerRow;
    src = g + static_cast<int64_t>(r0) * d + e;
    row_step = static_cast<int64_t>(kRowStep) * d;
  }

  // rows [0, rows) of the block that starts `first` floats into the
  // matrix, floats e0 .. e0 + kBK of them, into stage s; a zero-filled
  // copy names `safe`, an address inside the tensor
  __device__ __forceinline__ void issue(float* s, int64_t first, int64_t rows, int e0,
                                        const float* safe) const {
    const bool e_ok = e0 + e < d;
    const float* g = src + first + e0;
#pragma unroll
    for (int i = 0; i < R / kRowStep; ++i) {
      const bool ok = e_ok && r0 + i * kRowStep < rows;
      float* dst = s + (r0 + i * kRowStep) * kBKP + e;
      if (VEC)
        cp_async16(dst, ok ? g + i * row_step : safe, ok);
      else
        cp_async4(dst, ok ? g + i * row_step : safe, ok);
    }
  }
};

template <bool VEC>
__global__ void __launch_bounds__(kTiledThreads, KMEANS_ASSIGN_MIN_BLOCKS)
kmeans_assign_tiled_kernel(const float* __restrict__ x, const float* __restrict__ cent,
                           int32_t* __restrict__ out, int64_t n, int k, int d,
                           int64_t out_stride) {
  constexpr int kGX = kTiledN / kTN;  // threads that share a point (lanes of one warp)
  constexpr int kRM = kTiledM / kTM;  // row step of a thread's points
  extern __shared__ __align__(16) float smem[];
  float* s_x = smem;                                  // (kStages, kTiledM, kBKP)
  float* s_c = s_x + kStages * kTiledM * kBKP;        // (kStages, kTiledN, kBKP)
  float* s_cn = s_c + kStages * kTiledN * kBKP;       // (kTiledN,) the tile's norms
  const int tid = threadIdx.x;
  const int tx = tid % kGX, ty = tid / kGX;
  const int col = blockIdx.y;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kTiledM;
  const StageCopy<kTiledM, VEC> copy_x(x + (static_cast<int64_t>(col) * n + p0) * d, d);
  const StageCopy<kTiledN, VEC> copy_c(cent + static_cast<int64_t>(col) * k * d, d);
  out += col * out_stride;
  const int steps = (d + kBK - 1) / kBK;  // d steps a centroid tile
  const int total = (k + kTiledN - 1) / kTiledN * steps;
  const int64_t tile_floats = static_cast<int64_t>(kTiledN) * d;

  // the next step to load: its stage, d step and centroid tile
  int ld_stage = 0, ld_step = 0, ld_tile = 0;
  auto load = [&]() {
    copy_x.issue(s_x + ld_stage * kTiledM * kBKP, 0, n - p0, ld_step * kBK, x);
    copy_c.issue(s_c + ld_stage * kTiledN * kBKP, ld_tile * tile_floats,
                 k - ld_tile * kTiledN, ld_step * kBK, cent);
    ld_stage = ld_stage + 1 == kStages ? 0 : ld_stage + 1;
    if (++ld_step == steps) {
      ld_step = 0;
      ++ld_tile;
    }
  };

  float acc[kTM][kTN];
  float best[kTM];
  int arg[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    best[i] = INFINITY;
    arg[i] = INT32_MAX;
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }
  float cn = 0.f;  // thread tid < kTiledN: the norm chain of the tile's centroid tid

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load();
    cp_async_commit();
  }
  int stage = 0, step = 0, j0 = 0;  // of step s
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();  // step s's stage has landed (this thread's copies)
    __syncthreads();  // ... everyone's, and everyone is done with step s - 1's stage
    if (s + kStages - 1 < total) load();  // into step s - 1's stage
    cp_async_commit();
    const float* xs = s_x + stage * kTiledM * kBKP + ty * kBKP;
    const float* cs = s_c + stage * kTiledN * kBKP + tx * kBKP;
    if (tid < kTiledN) {
      const float* row = s_c + stage * kTiledN * kBKP + tid * kBKP;
#pragma unroll
      for (int e = 0; e < kBK; e += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + e);
        cn = fmaf(v.x, v.x, cn);
        cn = fmaf(v.y, v.y, cn);
        cn = fmaf(v.z, v.z, cn);
        cn = fmaf(v.w, v.w, cn);
      }
    }
#pragma unroll
    for (int e = 0; e < kBK; e += 4) {
      float4 a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        a[i] = *reinterpret_cast<const float4*>(xs + i * kRM * kBKP + e);
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        b[j] = *reinterpret_cast<const float4*>(cs + j * kGX * kBKP + e);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
    if (++step == steps) {  // the tile's last d step: its distances
      step = 0;
      if (tid < kTiledN) {
        s_cn[tid] = j0 + tid < k ? cn : NAN;  // a pad slot's distance is NaN: never a pick
        cn = 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kTN; ++j) {  // increasing j, strict `<`: the first j at a tie
        const float cnj = s_cn[tx + j * kGX];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float dist = fmaf(-2.f, acc[i][j], cnj);
          if (dist < best[i]) {
            best[i] = dist;
            arg[i] = j0 + tx + j * kGX;
          }
          acc[i][j] = 0.f;
        }
      }
      j0 += kTiledN;
    }
  }
  // the kGX threads of a point hold the first minimum of their centroids:
  // the least (dist, j) of them is the first j at the point's minimum
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float b = best[i];
    int a = arg[i];
#pragma unroll
    for (int off = kGX / 2; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, b, off);
      const int oa = __shfl_xor_sync(0xffffffffu, a, off);
      if (ob < b || (ob == b && oa < a)) {
        b = ob;
        a = oa;
      }
    }
    const int64_t p = p0 + ty + i * kRM;
    if (tx == 0 && p < n) out[p] = b < INFINITY ? a : 0;  // no distance beat +inf: 0
  }
}

template <bool VEC>
cudaError_t launch_tiled(const float* x, const float* cent, int32_t* out, int c, int64_t n, int k,
                         int d, int64_t out_stride, cudaStream_t st) {
  constexpr int kMaxDevices = 64;
  static bool opted_in[kMaxDevices];  // the shared-memory opt-in, once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(kmeans_assign_tiled_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kTiledSmemBytes));
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>((n + kTiledM - 1) / kTiledM), static_cast<unsigned>(c));
  kmeans_assign_tiled_kernel<VEC><<<grid, kTiledThreads, kTiledSmemBytes, st>>>(
      x, cent, out, n, k, d, out_stride);
  return cudaGetLastError();
}

}  // namespace

// x (c, n, d) float32 and centroids (c, k, d) float32, contiguous, both
// 16-byte aligned where d % 4 == 0; out (c, n) int32 with row stride
// out_stride (elements) and unit last stride; all on one device; 1 <= c <=
// 65535, n, k, d >= 1.  points (a thread) and threads (a CTA) come from
// assign_geometry: on the d = 4 kernel (d == 4 and k <= kFastMaxK) points
// in {1, 2, 4} and threads in {64, 128}; on the tiled kernel points ==
// kTM and threads == kTiledThreads.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int kmeans_assign(const void* x, const void* centroids, void* out, int c, long long n,
                             int k, int d, long long out_stride, int points, int threads,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(centroids);
  int32_t* op = static_cast<int32_t*>(out);
  if (c < 1 || c > 65535 || n < 1 || k < 1 || d < 1 ||
      (threads != 64 && threads != 128 && threads != 256 && threads != 512))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(centroids)) % 16 == 0;
  if (d == 4 && k <= kFastMaxK) {
    if (!aligned) return static_cast<int>(cudaErrorMisalignedAddress);
    switch (points) {
      case 4: return static_cast<int>(launch_fast<4>(xp, cp, op, c, n, k, out_stride, threads, st));
      case 2: return static_cast<int>(launch_fast<2>(xp, cp, op, c, n, k, out_stride, threads, st));
      case 1: return static_cast<int>(launch_fast<1>(xp, cp, op, c, n, k, out_stride, threads, st));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (points != kTM || threads != kTiledThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (d % 4) return static_cast<int>(launch_tiled<false>(xp, cp, op, c, n, k, d, out_stride, st));
  if (!aligned) return static_cast<int>(cudaErrorMisalignedAddress);
  return static_cast<int>(launch_tiled<true>(xp, cp, op, c, n, k, d, out_stride, st));
}

extern "C" const char* kmeans_assign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
