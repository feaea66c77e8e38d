// Flash attention, forward: causal (or full) grouped-query softmax attention
// whose (Sq, S) score matrix never reaches device memory.  The LM's prefill
// and full-sequence attention run through it.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _kernel), which stages a q block and the whole per-head K/V in VMEM
// and runs an online softmax over kv blocks of 512 on the MXU.  Here blocks
// run in parallel on 132 SMs with 227 KB of shared memory each, so the tiles
// are small (64 queries by 64 keys) and K/V stream through shared memory.
// The JAX wrapper's zero-padding of Sq and S to block multiples is not
// carried over: the kernel takes true lengths and (b, s, h) strides and masks
// the ragged tails itself (a padded key would otherwise enter the softmax
// when causal is off).
//
// Computes, for q (B, Sq, H, D) and k, v (B, S, KVH, D), d contiguous:
//   out[b, i, h] = sum_j p_ij v[b, j, h / (H/KVH)] / sum_j p_ij,
//   p_ij = exp(s_ij - m_i),  s_ij = (q[b, i, h] . k[b, j, h / (H/KVH)]) / sqrt(D)
// over keys j < S, and j <= i when causal (query 0 aligned with key 0, as the
// JAX oracle).  Scores, the running max m, the running sum l and the
// accumulator are float32; a row whose keys are all masked so far keeps
// m = -inf and the TPU kernel's isfinite guards keep it out of every exp.
// The output is acc / max(l, 1e-30) in q's dtype.  No atomics: every output
// element is written once by one thread, so the result repeats bit for bit.
//
// Bound.  For B=1, H=12, KVH=2, D=128 in bfloat16 (qwen2-1.5b's prefill at a
// 2048-token bucket) the function reads q, k, v and writes o: 14.7 MB, 4.4 us
// at 3.35 TB/s; its two causal products are 4*D*H*S(S+1)/2 = 12.9 GFLOP,
// 13 us at the H100's 989 TFLOP/s dense bf16.  It is bound by operations; at
// a 128-token bucket both are under 1 us and a launch costs more.
//
// Design response (a first, simple version).  One CTA per (64-query tile,
// b*h), four warps of 16 query rows each.  bfloat16 runs on the tensor cores
// with mma.sync.m16n8k16 (bf16 in, f32 accumulate): each warp keeps its Q
// fragments in registers for the whole kv loop, a 64-key K tile and V tile
// are staged in shared memory (row stride D+8 so fragment reads hit 32
// distinct banks), S = Q K^T and the online softmax stay in registers, P is
// rounded to bfloat16 in registers and fed straight back as the A operand of
// P V.  The kv loop stops at the causal diagonal.  float32 inputs, which the
// LM serves only in tests, run the same online softmax on the CUDA cores in
// full float32 (two threads per query row, 32-key tiles).  Not yet done:
// wgmma, TMA, double-buffered tiles, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;  // query rows per CTA
constexpr int kThreads = 128;

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  const uint16_t l = *reinterpret_cast<const uint16_t*>(&lo);
  const uint16_t h = *reinterpret_cast<const uint16_t*>(&hi);
  return static_cast<uint32_t>(l) | (static_cast<uint32_t>(h) << 16);
}

// d[0..3] += A (16x16, row) * B (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
// bfloat16: tensor cores.  Fragment layouts of m16n8k16 (g = lane / 4,
// t = lane % 4): A holds rows g and g+8 at columns 2t, 2t+1 (regs 0, 1) and
// 2t+8, 2t+9 (regs 2, 3); B holds column g at rows 2t, 2t+1 (reg 0) and
// 2t+8, 2t+9 (reg 1); C holds rows g (regs 0, 1) and g+8 (regs 2, 3) at
// columns 2t, 2t+1.

constexpr int kBlockK = 64;  // keys per kv tile

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16_kernel(Params p) {
  constexpr int LDS = D + 8;  // shared row stride in elements (16-byte multiple)
  constexpr int KD = D / 16;  // k-steps of Q K^T
  constexpr int NT = kBlockK / 8;  // 8-key column tiles of S
  constexpr int DT = D / 8;  // 8-wide column tiles of O
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * LDS];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK * LDS];

  const int q0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, kvh = h / p.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // this warp's Q rows as A fragments, for the whole kv loop; rows past Sq are 0
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < p.Sq ? *reinterpret_cast<const uint32_t*>(qp + r0 * p.q_ss + c) : 0u;
    qf[kk][1] = r1 < p.Sq ? *reinterpret_cast<const uint32_t*>(qp + r1 * p.q_ss + c) : 0u;
    qf[kk][2] = r0 < p.Sq ? *reinterpret_cast<const uint32_t*>(qp + r0 * p.q_ss + c + 8) : 0u;
    qf[kk][3] = r1 < p.Sq ? *reinterpret_cast<const uint32_t*>(qp + r1 * p.q_ss + c + 8) : 0u;
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows r0, r1 (l: this thread's part)

  const int kv_end = p.causal ? min(p.S, q0 + kBlockQ) : p.S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    constexpr int CH = D / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < kBlockK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (kv0 + r < p.S) {  // keys past S are zero, and masked below
        kx = *reinterpret_cast<const uint4*>(kp + static_cast<int64_t>(kv0 + r) * p.k_ss + c);
        vx = *reinterpret_cast<const uint4*>(vp + static_cast<int64_t>(kv0 + r) * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(ks + r * LDS + c) = kx;
      *reinterpret_cast<uint4*>(vs + r * LDS + c) = vx;
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * LDS + kk * 16 + 2 * t;
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    // scale, mask, row max over the quad that shares a row
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool ok = col < p.S && (!p.causal || col <= row);
        const float x = ok ? s[n][e] * p.scale : -INFINITY;
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float safe0 = isfinite(mn0) ? mn0 : 0.f, safe1 = isfinite(mn1) ? mn1 : 0.f;
    const float a0 = isfinite(m0) ? expf(m0 - safe0) : 0.f;
    const float a1 = isfinite(m1) ? expf(m1 - safe1) : 0.f;
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= a0;
      acc[i][1] *= a0;
      acc[i][2] *= a1;
      acc[i][3] *= a1;
    }
    // p rounded to bf16 once; l sums the rounded values, so the weights that
    // multiply V are exactly the ones that normalise
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float pe = isfinite(x) ? expf(x - (e < 2 ? safe0 : safe1)) : 0.f;
        const float pr = __bfloat162float(__float2bfloat16_rn(pe));
        s[n][e] = pr;
        if (e < 2) l0 += pr; else l1 += pr;
      }
    }
    // O += P V: P's C fragments of key tiles 2kk, 2kk+1 are the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vr = vs + (kk * 16 + 2 * t) * LDS + g;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        const __nv_bfloat16* vc = vr + i * 8;
        mma_bf16(acc[i], pa, pack_raw(vc[0], vc[LDS]), pack_raw(vc[8 * LDS], vc[9 * LDS]));
      }
    }
  }

  const float L0 = fmaxf(quad_sum(l0), 1e-30f), L1 = fmaxf(quad_sum(l1), 1e-30f);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int c = i * 8 + 2 * t;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(op + r0 * p.o_ss + c) = pack_bf16(acc[i][0] / L0, acc[i][1] / L0);
    if (r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(op + r1 * p.o_ss + c) = pack_bf16(acc[i][2] / L1, acc[i][3] / L1);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, full float32.  Thread (row, half): row = tid / 2 of
// the 64-row tile, half = tid % 2 owns 16 of each 32-key tile's scores and
// D/2 of the output columns.

constexpr int kBlockKF = 32;

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

template <int D>
int launch(const Params& p, int dtype, dim3 grid, cudaStream_t st) {
  if (dtype == 1) {
    flash_fwd_bf16_kernel<D><<<grid, kThreads, 0, st>>>(p);
  } else {
    const size_t smem = f32_smem_bytes<D>();
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_fwd_f32_kernel<D><<<grid, kThreads, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, D), k and v (B, S, KVH, D), o (B, Sq, H, D), all of `dtype`
// (0 = float32, 1 = bfloat16), d contiguous, strides in elements.  The
// caller guarantees D in {64, 128}, H % KVH == 0, S >= 1, B*Sq*H >= 1, and
// (for bfloat16) 16-byte aligned bases and strides.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int S, int H, int KVH, int D,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   long long o_sb, long long o_ss, long long o_sh,
                                   float scale, int causal, void* stream) {
  if ((dtype != 0 && dtype != 1) || KVH < 1 || H % KVH || S < 1 ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, Sq, S, H, H / KVH,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                 scale, causal};
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(p, dtype, grid, st);
  if (D == 128) return launch<128>(p, dtype, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
