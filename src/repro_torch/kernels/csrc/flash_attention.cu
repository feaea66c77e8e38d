// Flash attention, forward: causal (or full) grouped-query softmax attention
// whose (Sq, S) score matrix never reaches device memory.  The LM's prefill
// and full-sequence attention run through it.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _kernel), which stages a q block and the whole per-head K/V in VMEM
// and runs an online softmax over kv blocks of 512 on the MXU.  Here blocks
// run in parallel on 132 SMs with 227 KB of shared memory each, so a CTA
// owns 64 or 128 query rows of one (b, h) and K/V stream through a ring of
// shared-memory tiles.  The JAX wrapper's zero-padding of Sq and S to block
// multiples is not carried over: the kernel takes true lengths and (b, s, h)
// strides and masks the ragged tails itself (a padded key would otherwise
// enter the softmax when causal is off).
//
// Computes, for q (B, Sq, H, D) and k, v (B, S, KVH, D), d contiguous:
//   out[b, i, h] = sum_j p_ij v[b, j, h / (H/KVH)] / sum_j p_ij,
//   p_ij = exp(s_ij - m_i),  s_ij = (q[b, i, h] . k[b, j, h / (H/KVH)]) / sqrt(D)
// over keys j < S, and j <= i when causal (query 0 aligned with key 0, as the
// JAX oracle).  Scores, the running max m, the running sum l and the
// accumulator are float32; a row whose keys are all masked so far keeps
// m = -inf and the TPU kernel's isfinite guards keep it out of every exp.
// The output is acc / max(l, 1e-30) in q's dtype.  No atomics and a fixed
// order of sums: every output element is written once by one thread, so the
// result repeats bit for bit.
//
// Bound.  For B=1, H=12, KVH=2, D=128 in bfloat16 (qwen2-1.5b's prefill at a
// 2048-token bucket) the function reads q, k, v and writes o: 14.7 MB, 4.4 us
// at 3.35 TB/s; its two causal products are 4*D*H*S(S+1)/2 = 12.9 GFLOP,
// 13 us at the H100's 989 TFLOP/s dense bf16.  It is bound by operations; at
// a 128-token bucket both are under 1 us and a launch costs more.  For
// paligemma-3b's prefill (B=1, H=8, KVH=1, D=256) at 2048 tokens: 18.9 MB,
// 5.6 us, against 17.2 GFLOP, 17.4 us: bound by operations too.
//
// Design response (bfloat16, the LM's path).  Only wgmma reaches the tensor
// cores' full rate on Hopper, so both products are warpgroup MMAs fed from
// shared memory by TMA:
// - Warp specialisation.  Warpgroup 0 is the producer: one thread issues
//   every TMA load (cp.async.bulk.tensor, 4-d tensor maps over the (b, s, h)
//   strides) and the other warps retire at once.  NC = 1 or 2 consumer
//   warpgroups own 64 query rows each (a consumer needs ~155 registers, so
//   the 168 of a 384-thread CTA suffice: no setmaxnreg).
// - Q (64 NC rows) lands once and stays in shared memory as the A operand of
//   S = Q K^T.  K and V tiles of 128 keys (64 at D = 256) stream through a
//   2-stage ring; each stage has a full barrier for K and one for V (Q K^T
//   starts before V has landed) and a free barrier for each, so K goes back
//   to the producer as soon as Q K^T has read it.
// - Every tile is 128-byte swizzled.  A 64-column bf16 row is 128 bytes, the
//   widest box that swizzle takes, so a row of D = 128 arrives as two boxes
//   of 64 columns and the wgmma descriptors follow the same atoms.
// - S = Q K^T: wgmma m64n128k16, both operands K-major in shared memory, f32
//   accumulators in registers.
// - The online softmax runs in registers in the exp2 domain: the row max of
//   the raw scores, then one FFMA (scale log2(e)/sqrt(D) and the max folded
//   in) and one ex2.approx an element; the masks run only on tiles that
//   cross the diagonal or the S tail.  P is rounded to bf16 once and l sums
//   the rounded values.  At D = 128 an exponential costs the SM's special
//   function units about half what the element's 512 flops cost the tensor
//   cores, so this is the loop's other half.
// - O += P V: wgmma m64nDk16 with A = P from registers (the accumulator
//   layout of S, packed to bf16 pairs, is the A-register layout of each k16
//   slice) and B = V read MN-major from shared memory (the transpose bit).
// - D = 256 (paligemma-3b) takes K/V tiles of 64 keys (block_n) and 64-row
//   CTAs only: Q 32 KB and two stages of 32 KB K and 32 KB V tiles make
//   160 KB of shared memory, and a consumer holds 128 accumulators and 32
//   scores.  S = Q K^T is wgmma m64n64k16, and each k-step of O += P V
//   issues two m64n128k16, one on each half of V's 256 columns.
// - Heaviest q tiles first: the q tile is the grid's slow index, reversed,
//   so the causal diagonal's longest rows start in the first wave.  The
//   wrapper picks 64-row tiles where 128-row tiles would leave SMs idle.
// Not yet done: overlapping a warpgroup's softmax with its own products
// (issuing P V of tile n-1 under the softmax of tile n, as FlashAttention-3
// does).  Built here, it made ptxas serialise the wgmmas (C7513) and spill
// at two warpgroups, whether or not setmaxnreg raised the consumers to 240
// registers, and ran slower; turn-taking between the two warpgroups through
// named barriers gained nothing.  Also not done: a persistent grid, TMA
// stores of O, an fp8 path.
//
// float32 inputs, which the LM serves only in tests, run the same online
// softmax on the CUDA cores in full float32 (two threads per query row,
// 32-key tiles), with natural exp.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma, TMA, mbarriers (sm_90a).

constexpr int kStages = 2;    // K/V ring depth
constexpr int kBoxCols = 64;  // bf16 columns of one 128-byte-swizzled TMA box
constexpr int kGeom = 11;     // per tensor map: 4 dims, 3 byte strides, 4 box dims

// Keys per K/V tile: 128, or 64 at D = 256, where two stages of 128-key
// K and V tiles (256 KB) would not fit a CTA's 227 KB of shared memory and
// 64 scores a thread beside the 128 accumulators would pass 255 registers.
constexpr int block_n(int D) { return D == 256 ? 64 : 128; }

template <int D, int NC>
struct Tiles {
  static constexpr int kBlockN = block_n(D);
  static constexpr int kChunks = D / kBoxCols;  // boxes per row
  static constexpr int kRows = 64 * NC;         // query rows per CTA
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr uint32_t kQBytes = kChunks * kRows * 128;
  static constexpr uint32_t kKVBytes = kChunks * kBlockN * 128;  // one K or V tile
  // byte offsets from the 1024-byte-aligned base; a chunk holds rows of 128 bytes
  static constexpr uint32_t kQ = 0, kK = kQBytes, kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kSmem = kV + kStages * kKVBytes + 1024;  // + room to align
};

struct WParams {
  void* o;
  int Sq, S, H, G;  // G = H / KVH
  int64_t o_sb, o_ss, o_sh;
  float scale_log2;  // log2(e) / sqrt(D)
  int causal;
  int n_qtiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of this parity has completed.  A wait of
// 2^26 polls (seconds: a load that never lands) traps, so that a fault
// surfaces as a launch error and not as a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// One box of the 4-d tensor map (d, s, h, b) into shared memory at dst;
// its bytes complete the transaction count of bar.  Rows past the tensor's
// end arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int s, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(s), "r"(h), "r"(b)
      : "memory");
}

// Starts fetching a tensor map (a kernel parameter) before its first load.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Shared-memory matrix descriptor of wgmma for 128-byte-swizzled atoms (8
// rows of 128 bytes, 1024-byte aligned).  K-major: sbo = the stride of 8-row
// groups, lbo unused.  MN-major: sbo = the stride of 8-row (k) groups, lbo =
// the stride of 64-element column blocks.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2^x on the special-function unit; subnormal results flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Pin registers that a wgmma reads or writes: the compiler may not move
// their other uses across this point (before wg_fence, after wg_wait_all).
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (m64n128, f32) = A (64x16 bf16, shared, K-major) * B (16x128 bf16, shared, K-major) [+ d]
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n64, f32) = A (64x16 bf16, shared, K-major) * B (16x64 bf16, shared, K-major) [+ d]
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[OFF .. OFF + 63] (m64n128, f32) += A (64x16 bf16, registers) * B (16x128
// bf16, shared, MN-major): OFF 64 takes columns 128..255 of a D = 256 accumulator
template <int OFF, int N>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N], const uint32_t (&a)[4], uint64_t db) {
  static_assert(OFF + 64 <= N, "accumulator too short");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),
        "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),
        "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n64, f32) += A (64x16 bf16, registers) * B (16x64 bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// grid (B*H, n_qtiles), Tiles::kThreads threads: warpgroup 0 loads,
// warpgroups 1..NC compute 64 query rows each.
template <int D, int NC>
__global__ void __launch_bounds__(Tiles<D, NC>::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const WParams p) {
  using T = Tiles<D, NC>;
  constexpr int kBlockN = T::kBlockN;
  extern __shared__ uint8_t tiles[];  // (the float32 kernel's is `smem`)
  // bars[0]: Q landed; per stage s: K landed, V landed, K free, V free
  __shared__ __align__(8) uint64_t bars[1 + 4 * kStages];
  const uint32_t base = (smem_u32(tiles) + 1023u) & ~1023u;
  const uint32_t bar_q = smem_u32(bars);
  const auto full_k = [bar_q](int s) { return bar_q + 8u * (1 + s); };
  const auto full_v = [bar_q](int s) { return bar_q + 8u * (1 + kStages + s); };
  const auto free_k = [bar_q](int s) { return bar_q + 8u * (1 + 2 * kStages + s); };
  const auto free_v = [bar_q](int s) { return bar_q + 8u * (1 + 3 * kStages + s); };

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kvh = h / p.G;
  const int q0 = (p.n_qtiles - 1 - static_cast<int>(blockIdx.y)) * T::kRows;  // heaviest first
  const int kv_end = p.causal ? min(p.S, q0 + T::kRows) : p.S;
  const int n_kv = (kv_end + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    prefetch_map(&tq);
    prefetch_map(&tk);
    prefetch_map(&tv);
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(free_k(s), 4 * NC);  // one arrival per consumer warp
      mbar_init(free_v(s), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(base + T::kQ + c * T::kRows * 128, &tq, bar_q, c * kBoxCols, q0, h, b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % kStages;
        const uint32_t parity = ((it / kStages) & 1) ^ 1;  // the first round passes at once
        mbar_wait(free_k(s), parity);
        mbar_expect_tx(full_k(s), T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(base + T::kK + s * T::kKVBytes + c * kBlockN * 128, &tk, full_k(s),
                   c * kBoxCols, it * kBlockN, kvh, b);
        mbar_wait(free_v(s), parity);
        mbar_expect_tx(full_v(s), T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(base + T::kV + s * T::kKVBytes + c * kBlockN * 128, &tv, full_v(s),
                   c * kBoxCols, it * kBlockN, kvh, b);
      }
    }
    return;
  }

  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + cw * 64;  // this warpgroup's first row
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  const uint32_t q_base = base + T::kQ + cw * 64 * 128;
  const float c = p.scale_log2;

  // accumulator layout of m64nN: element 4n + e is row (e < 2 ? r0 : r1),
  // column 8n + 2t + (e & 1)
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // running max of the raw scores and this thread's part of the running sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_kv; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int kv0 = it * kBlockN;

    // S = Q K^T: D/16 k-steps; step kk reads 16 columns of box kk/4
    const uint32_t k_base = base + T::kK + s * T::kKVBytes;
    float sc[kBlockN / 2];
    mbar_wait(full_k(s), parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // 16 bf16 columns = 32 bytes
      const uint64_t dq = desc_sw128(q_base + (kk / 4) * T::kRows * 128 + col, 16, 1024);
      const uint64_t dk = desc_sw128(k_base + (kk / 4) * kBlockN * 128 + col, 16, 1024);
      if constexpr (kBlockN == 128)
        wgmma_ss_n128(sc, dq, dk, kk > 0);
      else
        wgmma_ss_n64(sc, dq, dk, kk > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(sc);
    if (lane == 0) mbar_arrive(free_k(s));  // this warp is done with K

    // mask (only tiles that cross the diagonal or the S tail), then the row
    // max of the raw scores (the scale is positive)
    if (kv0 + kBlockN > p.S || (p.causal && kv0 + kBlockN - 1 > row0)) {
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + n * 8 + 2 * t + (e & 1);
          if (col >= p.S || (p.causal && col > (e < 2 ? r0 : r1))) sc[4 * n + e] = -INFINITY;
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    // exp2 domain: p = 2^(s c - max c), c = log2(e) / sqrt(D)
    const float safe0 = isfinite(mn0) ? mn0 * c : 0.f, safe1 = isfinite(mn1) ? mn1 * c : 0.f;
    const float a0 = isfinite(m0) ? ex2(m0 * c - safe0) : 0.f;
    const float a1 = isfinite(m1) ? ex2(m1 * c - safe1) : 0.f;
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] *= a0;
      o[4 * i + 1] *= a0;
      o[4 * i + 2] *= a1;
      o[4 * i + 3] *= a1;
    }
    // P rounded to bf16 once, packed in pairs: pk[2n] row r0, pk[2n + 1] row
    // r1 of key chunk n; l sums the rounded values, so the weights that
    // multiply V are exactly the ones that normalise
    uint32_t pk[kBlockN / 4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float sf = hr ? safe1 : safe0;
        const float x0 = sc[4 * n + 2 * hr], x1 = sc[4 * n + 2 * hr + 1];
        const __nv_bfloat162 pr = __floats2bfloat162_rn(
            isfinite(x0) ? ex2(fmaf(x0, c, -sf)) : 0.f, isfinite(x1) ? ex2(fmaf(x1, c, -sf)) : 0.f);
        const float2 pf = __bfloat1622float2(pr);
        if (hr) l1 += pf.x + pf.y; else l0 += pf.x + pf.y;
        pk[2 * n + hr] = *reinterpret_cast<const uint32_t*>(&pr);
      }
    }

    // O += P V: k-step kk takes key chunks 2kk, 2kk+1 (A = pk[4kk..4kk+3])
    // and V's rows 16kk..16kk+15
    const uint32_t v_base = base + T::kV + s * T::kKVBytes;
    mbar_wait(full_v(s), parity);
    pin(o);
    pin(pk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2], pk[4 * kk + 3]};
      // the next 64 columns of V lie one box (kBlockN rows) away; at D = 256
      // columns 128..255 (boxes 2 and 3) take a second m64n128 into o[64..127]
      const uint64_t dv = desc_sw128(v_base + kk * 16 * 128, kBlockN * 128, 1024);
      if constexpr (D == 64) {
        wgmma_rs_n64(o, a, dv);
      } else {
        wgmma_rs_n128<0>(o, a, dv);
        if constexpr (D == 256)
          wgmma_rs_n128<64>(o, a, desc_sw128(v_base + 2 * kBlockN * 128 + kk * 16 * 128,
                                             kBlockN * 128, 1024));
      }
    }
    wg_commit();
    wg_wait_all();
    pin(o);
    if (lane == 0) mbar_arrive(free_v(s));  // this warp is done with V
  }

  const float L0 = fmaxf(quad_sum(l0), 1e-30f), L1 = fmaxf(quad_sum(l1), 1e-30f);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(op + r0 * p.o_ss + col) =
          pack_bf16(o[4 * i] / L0, o[4 * i + 1] / L0);
    if (r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(op + r1 * p.o_ss + col) =
          pack_bf16(o[4 * i + 2] / L1, o[4 * i + 3] / L1);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, full float32.  Thread (row, half): row = tid / 2 of
// the 64-row tile, half = tid % 2 owns 16 of each 32-key tile's scores and
// D/2 of the output columns.

constexpr int kBlockQ = 64;  // query rows per CTA
constexpr int kThreads = 128;
constexpr int kBlockKF = 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, S, H, G;  // G = H / KVH
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (kBlockQ * (D + 1) + kBlockKF * (D + 1) + kBlockKF * D +
                          kBlockQ * (kBlockKF + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(Params p) {
  constexpr int LD = D + 1;  // odd stride: rows of one column in distinct banks
  constexpr int LP = kBlockKF + 1;
  constexpr int HALF = D / 2;
  constexpr int KH = kBlockKF / 2;
  extern __shared__ float smem[];
  float* qs = smem;                  // (kBlockQ, LD)
  float* ks = qs + kBlockQ * LD;     // (kBlockKF, LD)
  float* vs = ks + kBlockKF * LD;    // (kBlockKF, D)
  float* ps = vs + kBlockKF * D;     // (kBlockQ, LP)

  const int q0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, kvh = h / p.G;
  const int rr = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int row = q0 + rr;
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * LD + c] = q0 + r < p.Sq ? qp[static_cast<int64_t>(q0 + r) * p.q_ss + c] : 0.f;
  }
  float acc[HALF];
#pragma unroll
  for (int d = 0; d < HALF; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;  // l: this thread's part of the row sum

  const int kv_end = p.causal ? min(p.S, q0 + kBlockQ) : p.S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockKF) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockKF * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = kv0 + r < p.S;
      ks[r * LD + c] = in ? kp[static_cast<int64_t>(kv0 + r) * p.k_ss + c] : 0.f;
      vs[r * D + c] = in ? vp[static_cast<int64_t>(kv0 + r) * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[KH];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      const int kj = half * KH + j;
      const float* qr = qs + rr * LD;
      const float* kr = ks + kj * LD;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int col = kv0 + kj;
      const bool ok = col < p.S && (!p.causal || col <= row);
      s[j] = ok ? dot * p.scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float mn = fmaxf(m, mx);
    const float safe = isfinite(mn) ? mn : 0.f;
    const float alpha = isfinite(m) ? expf(m - safe) : 0.f;
    m = mn;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HALF; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      const float pe = isfinite(s[j]) ? expf(s[j] - safe) : 0.f;
      l += pe;
      ps[rr * LP + half * KH + j] = pe;
    }
    __syncwarp();  // the partner thread's p values are in shared memory
    const float* pr = ps + rr * LP;
    const float* vc = vs + half * HALF;
    for (int j = 0; j < kBlockKF; ++j) {
      const float pj = pr[j];
#pragma unroll
      for (int d = 0; d < HALF; ++d) acc[d] = fmaf(pj, vc[j * D + d], acc[d]);
    }
  }

  const float L = fmaxf(l + __shfl_xor_sync(0xffffffffu, l, 1), 1e-30f);
  if (row < p.Sq) {
    float* op = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh +
                static_cast<int64_t>(row) * p.o_ss + half * HALF;
#pragma unroll
    for (int d = 0; d < HALF; ++d) op[d] = acc[d] / L;
  }
}

// ---------------------------------------------------------------------------
// Host side.

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes of this file beside cudaError_t's: the driver has no
// cuTensorMapEncodeTiled, or it refused a map (kEncodeError + its CUresult).
constexpr int kEncodeError = 100000;

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                                                    : nullptr;
  }();
  return fn;
}

// The 128-byte-swizzled bf16 map of a (B, S, H, D) tensor from its geometry
// g: dims (D, S, H, B), the byte strides of s, h, b, the box dims.
int encode(CUtensorMap* map, const void* base, const long long* g) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = static_cast<cuuint64_t>(g[i]);
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(g[4 + i]);
  for (int i = 0; i < 4; ++i) box[i] = static_cast<cuuint32_t>(g[7 + i]);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int D, int NC>
int launch_wgmma(const void* q, const void* k, const void* v, const long long* geom,
                 const WParams& p, int BH, cudaStream_t st) {
  using T = Tiles<D, NC>;
  // the boxes must be the tiles whose bytes the barriers expect
  for (int i = 0; i < 3; ++i) {
    const long long* g = geom + i * kGeom;
    if (g[0] != D || g[7] != kBoxCols || g[8] != (i == 0 ? T::kRows : T::kBlockN) || g[9] != 1 ||
        g[10] != 1)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv;
  int e = encode(&tq, q, geom);
  if (e == 0) e = encode(&tk, k, geom + kGeom);
  if (e == 0) e = encode(&tv, v, geom + 2 * kGeom);
  if (e != 0) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (a != cudaSuccess) return static_cast<int>(a);
  flash_fwd_wgmma_kernel<D, NC><<<dim3(BH, p.n_qtiles), T::kThreads, T::kSmem, st>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Params& p, dim3 grid, cudaStream_t st) {
  const size_t smem = f32_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, D), k and v (B, S, KVH, D), o (B, Sq, H, D), all of `dtype`
// (0 = float32, 1 = bfloat16), d contiguous, strides in elements.  The
// caller guarantees D in {64, 128, 256}, H % KVH == 0, S >= 1, B*Sq*H >= 1.
// For bfloat16 it also gives 16-byte aligned bases and (b, s, h) strides,
// each tensor's TMA geometry in tma_geom (q, k, v: kGeom values each, see
// encode) and block_rows, the query rows of a CTA (64 or 128, and 64 at
// D = 256: q's box rows; k's and v's are block_n(D)); float32 ignores both.  Returns 0, the
// cudaError_t of the launch, or kEncodeError (+ a CUresult) where a tensor
// map could not be made.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int S, int H, int KVH, int D,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   long long o_sb, long long o_ss, long long o_sh,
                                   float scale, int causal, const long long* tma_geom,
                                   int block_rows, void* stream) {
  if ((dtype != 0 && dtype != 1) || KVH < 1 || H % KVH || S < 1 || (D != 64 && D != 128 && D != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int n_qtiles = block_rows > 0 ? (Sq + block_rows - 1) / block_rows : 0;
    if ((block_rows != 64 && block_rows != 128) || (D == 256 && block_rows != 64) ||
        tma_geom == nullptr || n_qtiles > 65535 || static_cast<long long>(B) * H > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    const WParams p{o, Sq, S, H, H / KVH, o_sb, o_ss, o_sh,
                    scale * 1.4426950408889634f, causal, n_qtiles};
    const int BH = B * H;
    if (D == 64)
      return block_rows == 64 ? launch_wgmma<64, 1>(q, k, v, tma_geom, p, BH, st)
                              : launch_wgmma<64, 2>(q, k, v, tma_geom, p, BH, st);
    if (D == 128)
      return block_rows == 64 ? launch_wgmma<128, 1>(q, k, v, tma_geom, p, BH, st)
                              : launch_wgmma<128, 2>(q, k, v, tma_geom, p, BH, st);
    return launch_wgmma<256, 1>(q, k, v, tma_geom, p, BH, st);
  }
  if (static_cast<long long>(B) * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, Sq, S, H, H / KVH,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                 scale, causal};
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  if (D == 64) return launch_f32<64>(p, grid, st);
  return D == 128 ? launch_f32<128>(p, grid, st) : launch_f32<256>(p, grid, st);
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code == kEncodeError) return "the driver has no cuTensorMapEncodeTiled";
  if (code > kEncodeError) return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
