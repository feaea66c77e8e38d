// Fused CCE lookup, backward: the gradient of every column and sub-table of
// the universal supertable in ONE launch, deterministic, without atomics on
// floats.
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
// names, and the padding rows of a ragged supertable, get exactly 0.  This
// is bit for bit the plain version, src/repro_torch/kernels/ref.py::
// cce_lookup_bwd_ref, in both dtypes.
//
// Bound.  The function must read B*c*T*4 bytes of idx and B*c*dsub*esize
// bytes of dout and write c*T*k*dsub*esize bytes of dtab, and it does
// B*c*T*dsub float adds (fewer for sentinels): it is bound by bytes.  On the
// Criteo supertable (c=104, T=2, k=305, dsub=4, float32) at the training
// batch B=2048 that is 1.7 MB + 3.4 MB + 1.0 MB, about 6.1 MB, or 1.8 us at
// the H100's 3.35 TB/s.
//
// What held the first design back.  It gave each of the k threads of a
// (column, sub-table) CTA one row and had every thread scan all B staged
// indices: O(B*k) comparisons per CTA, and where a thread's row matched, a
// global load of dout under a divergent branch.  A warp of 32 rows matched
// in about one b of ten, so it serialised some 200 L2 round trips at
// B=2048 (0.109 ms, on uniform ids as on the train step's); other widths
// made dsub such passes.
//
// Design.  Every output row still has ONE owner that adds its terms in
// increasing b and writes the row once, so no float is ever added
// atomically.  A CTA owns the rows [r_lo, r_lo + R) of one (column,
// sub-table) (one CTA per (column, sub-table) wherever k <= R); for each
// chunk of kChunk b it
//   1. loads its 2048 indices (4 a thread, strided reads of the view, no
//      copy) and, on vec4 and narrow, the dout rows (narrow: one 16-byte
//      vector of each) of the same entries into registers, so that the
//      sort below hides their latency;
//   2. buckets the chunk by row with a stable counting sort in shared
//      memory: each warp takes 128 consecutive b as 4 tiles of 32, in
//      order, ranks each entry among the equal rows of its tile (vec4 and
//      wide: one __ballot_sync a key bit, cheaper there than
//      __match_any_sync; narrow: __match_any_sync, 0.9 us the cheaper at
//      the hashing trick's shape) and keeps per-warp counts (integers,
//      written by one lane a row: exact and deterministic); an exclusive
//      scan over (row, warp) gives every entry its place, so each row's
//      terms form one segment, ascending in b.  On vec4 and narrow the
//      entries' dout rows themselves are placed, so that a row's terms lie
//      side by side;
//   3. lets each owner walk only its own segment, carrying acc in
//      registers from chunk to chunk: no comparisons against other rows,
//      no index to chase, no data-dependent branch in the loop.
// A row is never split along b, since that would change the order of its
// adds.  On vec4 and narrow a row of more than kHot terms is split along d
// instead: its kOwn elements are independent chains of adds, walked by
// kOwn threads in warps on the SM's 4 schedulers, each with kHotAhead loads
// in flight.  One row holding the whole chunk is still 2048 dependent adds.
// Layouts (the launcher's path, as in the forward):
//   vec4         dsub == 4, aligned: a thread owns a row (R = 512); the
//                sorted rows take 32 KB of shared memory a chunk in
//                float32, 16 KB in bfloat16.
//   narrow       rows of 2, 4, 8 or 16 16-byte vectors, aligned (float32
//                dsub 8-64, bfloat16 16-128): vec4 on one 16-byte vector
//                of each row a CTA (grid y numbers the vectors), a thread
//                owning that vector of one row (R = 512).  A column's
//                gather and its hot rows' chains so spread over as many
//                SMs as a row has vectors (one CTA a (column, sub-table,
//                vector) at the hashing trick's k=500: 104 CTAs at dsub 16
//                in float32).  The sorted vectors take 32 KB a chunk.
//   wide_vector  a warp owns kWarpRows rows (R = 64) and one 512-byte slice
//   wide_scalar  of d (grid y); its lanes run along d and read dout from
//                global memory, 16 bytes (or one element) a lane, as in the
//                forward.  The LM's dsub=384 takes this path, in one pass.
// The hashing trick's rows (c=26, T=1, k=500, dsub=16) took wide_vector
// until narrow came: 8 CTAs a column, each sorting all 2048 indices, 28 of
// a warp's 32 lanes idle, and a hot row walked by one warp that read each
// term's dout row from global memory at an address from the sorted list:
// on a train batch 1117 dependent L2 round trips, 0.19 ms.
// What bounds it (phase times from tools/probe_lookup_bwd.py in PERF.md).
// On the train step's shape each CTA first gathers 2048 dout rows of 16
// bytes that lie 1664 bytes apart (and, from the serving layout, 2048
// indices as far apart): one L1 request each, two CTAs on 76 of the 132
// SMs.  Then come the ballots, the scan and the placement, and last the
// walk of the CTA's longest row, whose chain of adds ends the grid: a
// small-vocabulary column's row on uniform ids, the Zipf head on a train
// batch.  Together several times the byte bound.

#include "cce_lookup_common.cuh"

namespace {

// The kPer consecutive elements of a row that a thread owns on vec4 (4) and
// narrow (a 16-byte vector: 4 in float32, 8 in bfloat16): `type` moves them
// as one access, their bits untouched.
template <typename scalar_t, int kPer>
struct Own;
template <>
struct Own<float, 4> {
  using type = float4;
  __device__ static __forceinline__ void unpack(float4 x, float v[4]) {
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ static __forceinline__ void store(float* p, const float v[4]) { store4(p, v); }
};
template <>
struct Own<__nv_bfloat16, 4> {
  using type = uint2;
  __device__ static __forceinline__ void unpack(uint2 x, float v[4]) {
    unpack_bf16x2(x.x, v);
    unpack_bf16x2(x.y, v + 2);
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, const float v[4]) {
    store4(p, v);
  }
};
template <>
struct Own<__nv_bfloat16, 8> {
  using type = uint4;
  __device__ static __forceinline__ void unpack(uint4 x, float v[8]) {
    Group<__nv_bfloat16>::unpack(x, v);
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, const float v[8]) {
    store8(p, v);
  }
};

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;                     // b bucketed at once
constexpr int kTiles = kChunk / kThreads;        // 32-entry tiles a warp sorts, in order
constexpr int kWarpRows = 4;                     // rows a warp owns on the wide paths
constexpr int kThreadRange = kThreads;           // rows a CTA owns: vec4, narrow
constexpr int kWarpRange = kWarps * kWarpRows;   // wide
// vec4, narrow: a row of more than kHot terms is walked along d, a thread an
// element;
// -DCCE_BWD_HOT_TERMS=2048 compiles that out (tools/probe_lookup_bwd.py
// times the kernel with and without it)
#ifndef CCE_BWD_HOT_TERMS
#define CCE_BWD_HOT_TERMS 32
#endif
constexpr int kHot = CCE_BWD_HOT_TERMS;
constexpr bool kSplit = kHot < kChunk;
constexpr int kMaxHot = kChunk / (kHot + 1) + 1;  // hot rows a chunk can hold
constexpr int kHotAhead = 16;                     // loads in flight ahead of a hot row's adds

#ifdef CCE_BWD_STAMPS
// A build for timing the kernel's phases (tools/probe_lookup_bwd.py): at the
// start and at the end of each phase of the first chunk, and after the
// store, a barrier, then thread 0 of each of the first kStampCtas CTAs
// writes %globaltimer (ns).  The barrier does not stall a warp until an
// instruction needs it, so the timer is read under a predicate on the
// barrier's count, which exists only once every thread has arrived.
constexpr int kStamps = 7;
constexpr int kStampCtas = 4096;
__device__ unsigned long long g_stamps[kStampCtas][kStamps];
__device__ __forceinline__ void stamp(int b0, int i) {
  const int arrived = __syncthreads_count(1);
  if (arrived == static_cast<int>(blockDim.x) && b0 == 0 && threadIdx.x == 0 &&
      blockIdx.y == 0 && blockIdx.x < kStampCtas) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    g_stamps[blockIdx.x][i] = ns;
  }
}
#else
__device__ __forceinline__ void stamp(int, int) {}
#endif

// The lanes of this warp whose key equals this lane's, for keys < 2^nbits:
// one ballot a bit, cheaper than __match_any_sync.
__device__ __forceinline__ unsigned match_key(int key, int nbits) {
  unsigned m = 0xffffffffu;
  for (int b = 0; b < nbits; ++b) {
    const bool one = (key >> b) & 1;
    const unsigned set = __ballot_sync(0xffffffffu, one);
    m &= one ? set : ~set;
  }
  return m;
}

// Exclusive prefix sum of v over the CTA, in thread order; s_wsum holds
// kWarps ints.  Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_wsum) {
  const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) s_wsum[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  return x - v + (warp ? s_wsum[warp - 1] : 0);
}

// Shared memory of one CTA, in bytes: the sorted chunk (on vec4 and narrow
// its dout rows of own_bytes a thread, padded for the hot walk's reads
// ahead; its b otherwise), per-warp row counts, row starts and counts, warp
// sums, the hot rows and their sums.
__host__ __device__ constexpr size_t smem_bytes(int own_bytes, int esize, int rows) {
  return (own_bytes ? static_cast<size_t>(kChunk + kHotAhead) * own_bytes
                    : kChunk * sizeof(int)) +
         (static_cast<size_t>(kWarps) * rows + 2 * static_cast<size_t>(rows) + kWarps + 1 +
          kMaxHot + own_bytes / esize * kMaxHot) * sizeof(int);
}

// Grid: x = (column*T + t) * n_ranges + range, y = slice of d (narrow and
// wide paths).
template <typename scalar_t, int kPath>
__device__ __forceinline__ void bwd(const int32_t* __restrict__ idx,
                                    const scalar_t* __restrict__ dout,
                                    scalar_t* __restrict__ dtab, int c, int B, int T, int k,
                                    int dsub, int64_t s_col, int64_t s_b, int64_t s_t) {
  constexpr bool kByThread = kPath == kVec4 || kPath == kNarrow;
  constexpr int kRange = kByThread ? kThreadRange : kWarpRange;
  using L = Lanes<scalar_t, kPath == kWideVector>;
  // vec4, narrow: the elements of its row that a thread owns
  constexpr int kOwn = kPath == kNarrow ? 16 / static_cast<int>(sizeof(scalar_t)) : 4;
  using O = Own<scalar_t, kOwn>;
  constexpr int kOwned = kByThread ? 1 : kWarpRows;  // rows an owner holds
  constexpr int kPer = kByThread ? kOwn : L::kPer;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = static_cast<int>(threadIdx.x), lane = tid & 31, warp = tid >> 5;
  const int n_ranges = (k + kRange - 1) / kRange;
  const int range = static_cast<int>(blockIdx.x) % n_ranges;
  const int ct = static_cast<int>(blockIdx.x) / n_ranges;  // column*T + t
  const int col = ct / T, t = ct - col * T;
  const int r_lo = range * kRange;
  const int rows = min(kRange, k - r_lo);  // rows [r_lo, r_lo + rows), keys 0..rows-1
  const int stride = min(kRange, k);       // of the count table, as the launcher sized it
  const int nbits = 32 - __clz(rows);      // keys, the sentinel `rows` included, < 2^nbits
  // the first element of d this CTA covers: narrow's vector, the wide paths' slice
  const int e0 =
      kPath == kVec4 ? 0 : static_cast<int>(blockIdx.y) * (kByThread ? kOwn : L::kSlice);
  // vec4, narrow hot rows: hot row h's element e is walked by the thread in
  // warp 4*(h/(32/kHotLanes)) + e/kHotLanes, lane (h%(32/kHotLanes)) *
  // kHotLanes + e%kHotLanes, so that its chains of adds run on the 4
  // schedulers of the SM at once, kHotLanes lanes of one warp each
  constexpr int kHotLanes = kOwn / 4;
  static_assert(kThreads / kOwn >= kMaxHot, "kOwn threads for every hot row of a chunk");
  const int hot_h = (warp >> 2) * (32 / kHotLanes) + lane / kHotLanes;
  const int hot_e = (warp & 3) * kHotLanes + lane % kHotLanes;

  using row_t = typename O::type;
  row_t* s_rows = reinterpret_cast<row_t*>(smem);  // vec4, narrow: the chunk's dout rows, sorted
  int* s_sorted = reinterpret_cast<int*>(smem);    // wide: the chunk's b, sorted
  int* s_hist = reinterpret_cast<int*>(smem + (kByThread ? (kChunk + kHotAhead) * sizeof(row_t)
                                                          : kChunk * sizeof(int)));
  int* s_start = s_hist + kWarps * stride;
  int* s_count = s_start + stride;
  int* s_wsum = s_count + stride;
  int* s_nhot = s_wsum + kWarps;  // vec4, narrow: hot rows of the chunk, then each one's row
  int* s_hot = s_nhot + 1;
  float* s_hotacc = reinterpret_cast<float*>(s_hot + kMaxHot);  // their kOwn running sums

  const int32_t* ip = idx + col * s_col + t * s_t;
  const scalar_t* dp = dout + static_cast<int64_t>(col) * dsub;  // dout[0, col, :]
  const int64_t d_b = static_cast<int64_t>(c) * dsub;            // stride of b in dout
  int* hist = s_hist + warp * stride;

  float acc[kOwned][kPer];
#pragma unroll
  for (int o = 0; o < kOwned; ++o)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[o][j] = 0.f;

  for (int b0 = 0; b0 < B; b0 += kChunk) {
    const int nb = min(kChunk, B - b0);
    __syncthreads();  // every owner is done with the previous chunk
    stamp(b0, 0);
    // this warp's entries: j = warp*32*kTiles + 32*i + lane, key = row - r_lo
    // or `rows` for an index outside [r_lo, r_lo + rows) (sentinels, >= k);
    // on vec4 and narrow also their dout rows (the CTA's vector of each),
    // loaded now so that the sort hides them
    int key[kTiles];
    row_t row[kTiles];
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int j = warp * 32 * kTiles + 32 * i + lane;
      const int r = j < nb ? __ldg(ip + static_cast<int64_t>(b0 + j) * s_b) : -1;
      key[i] = r >= r_lo && r - r_lo < rows ? r - r_lo : rows;
      if (kByThread && j < nb)
        row[i] = __ldg(
            reinterpret_cast<const row_t*>(dp + static_cast<int64_t>(b0 + j) * d_b + e0));
    }
    for (int j = tid; j < kWarps * stride; j += kThreads) s_hist[j] = 0;
    __syncthreads();
    stamp(b0, 1);
    // rank of each entry among the equal keys before it in this warp's b
    int rank[kTiles];
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const unsigned same =
          kPath == kNarrow ? __match_any_sync(0xffffffffu, key[i]) : match_key(key[i], nbits);
      const unsigned before_me = same & ((1u << lane) - 1u);
      const bool real = key[i] < rows;
      const int seen = real ? hist[key[i]] : 0;
      rank[i] = seen + __popc(before_me);
      __syncwarp();
      if (real && before_me == 0) hist[key[i]] = seen + __popc(same);
      __syncwarp();
    }
    __syncthreads();
    stamp(b0, 2);
    // per row: counts of the warps before each warp, then the row's start
    int total = 0;
    if (tid < rows)
      for (int w = 0; w < kWarps; ++w) {
        int* h = s_hist + w * stride + tid;
        const int n = *h;
        *h = total;
        total += n;
      }
    const int start = block_exclusive_scan(total, s_wsum);
    if (tid < rows) {
      s_start[tid] = start;
      s_count[tid] = total;
    }
    __syncthreads();
    stamp(b0, 3);
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
      if (key[i] < rows) {
        const int pos = s_start[key[i]] + hist[key[i]] + rank[i];
        if (kByThread)
          s_rows[pos] = row[i];
        else
          s_sorted[pos] = warp * 32 * kTiles + 32 * i + lane;
      }
    if (kByThread && kSplit && tid == 0) *s_nhot = 0;
    __syncthreads();
    stamp(b0, 4);

    if (kByThread) {
      // a row of at most kHot terms is walked by its owner; a longer one is
      // handed, with its running sums, to kOwn threads, one per element
      const int n = tid < rows ? s_count[tid] : 0;
      int my_hot = -1;
      if (kSplit && n > kHot) {
        my_hot = atomicAdd(s_nhot, 1);  // in any order: each hot row is walked alone
        s_hot[my_hot] = tid;
#pragma unroll
        for (int j = 0; j < kOwn; ++j) s_hotacc[kOwn * my_hot + j] = acc[0][j];
      } else if (n > 0) {  // the row's terms lie side by side: no index to chase
        const row_t* seg = s_rows + s_start[tid];
#pragma unroll 8
        for (int p = 0; p < n; ++p) {
          float v[kOwn];
          O::unpack(seg[p], v);
#pragma unroll
          for (int j = 0; j < kOwn; ++j) acc[0][j] += v[j];
        }
      }
      if (kSplit) {
        __syncthreads();
        if (*s_nhot) {  // the same for the whole CTA
          if (hot_h < *s_nhot) {
            const int lr = s_hot[hot_h], m = s_count[lr];
            // element hot_e of term p is q[kOwn*p]; kHotAhead loads stay in flight
            // ahead of the adds (reads past the segment stay inside the padded
            // shared memory and are not added)
            const scalar_t* q = reinterpret_cast<const scalar_t*>(s_rows + s_start[lr]) + hot_e;
            float a = s_hotacc[kOwn * hot_h + hot_e];
            scalar_t ahead[kHotAhead];
#pragma unroll
            for (int u = 0; u < kHotAhead; ++u) ahead[u] = q[kOwn * u];
            int p = 0;
            for (; p + kHotAhead <= m; p += kHotAhead)
#pragma unroll
              for (int u = 0; u < kHotAhead; ++u) {
                a += to_float(ahead[u]);
                ahead[u] = q[kOwn * (p + kHotAhead + u)];
              }
#pragma unroll
            for (int u = 0; u < kHotAhead; ++u)
              if (p + u < m) a += to_float(ahead[u]);
            s_hotacc[kOwn * hot_h + hot_e] = a;
          }
          __syncthreads();
          if (my_hot >= 0)
#pragma unroll
            for (int j = 0; j < kOwn; ++j) acc[0][j] = s_hotacc[kOwn * my_hot + j];
        }
      }
    } else {
#pragma unroll
      for (int o = 0; o < kOwned; ++o) {
        const int lr = warp * kWarpRows + o;
        if (lr < rows) {  // the same for the whole warp
          const int* seg = s_sorted + s_start[lr];
          const int n = s_count[lr];
          const scalar_t* src = dp + static_cast<int64_t>(b0) * d_b;
#pragma unroll 4
          for (int p = 0; p < n; ++p) {
            float v[kPer] = {};
            L::load(src + seg[p] * d_b, e0, lane, dsub, v);
#pragma unroll
            for (int j = 0; j < kPer; ++j) acc[o][j] += v[j];
          }
        }
      }
    }
    stamp(b0, 5);
  }

  scalar_t* out = dtab + (static_cast<int64_t>(ct) * k + r_lo) * dsub;  // dtab[col, t, r_lo]
#pragma unroll
  for (int o = 0; o < kOwned; ++o) {
    if (kByThread) {
      if (tid < rows) O::store(out + static_cast<int64_t>(tid) * dsub + e0, acc[0]);
    } else {
      const int lr = warp * kWarpRows + o;
      if (lr < rows) L::store(out + static_cast<int64_t>(lr) * dsub, e0, lane, dsub, acc[o]);
    }
  }
  stamp(0, 6);
}

template <typename scalar_t>
__global__ void __launch_bounds__(kThreads, 2)
cce_lookup_bwd_vec4_kernel(const int32_t* __restrict__ idx, const scalar_t* __restrict__ dout,
                           scalar_t* __restrict__ dtab, int c, int B, int T, int k, int dsub,
                           int64_t s_col, int64_t s_b, int64_t s_t) {
  bwd<scalar_t, kVec4>(idx, dout, dtab, c, B, T, k, dsub, s_col, s_b, s_t);
}

template <typename scalar_t>
__global__ void __launch_bounds__(kThreads)
cce_lookup_bwd_wide_vector_kernel(const int32_t* __restrict__ idx,
                                  const scalar_t* __restrict__ dout, scalar_t* __restrict__ dtab,
                                  int c, int B, int T, int k, int dsub, int64_t s_col, int64_t s_b,
                                  int64_t s_t) {
  bwd<scalar_t, kWideVector>(idx, dout, dtab, c, B, T, k, dsub, s_col, s_b, s_t);
}

template <typename scalar_t>
__global__ void __launch_bounds__(kThreads)
cce_lookup_bwd_wide_scalar_kernel(const int32_t* __restrict__ idx,
                                  const scalar_t* __restrict__ dout, scalar_t* __restrict__ dtab,
                                  int c, int B, int T, int k, int dsub, int64_t s_col, int64_t s_b,
                                  int64_t s_t) {
  bwd<scalar_t, kWideScalar>(idx, dout, dtab, c, B, T, k, dsub, s_col, s_b, s_t);
}

template <typename scalar_t>
__global__ void __launch_bounds__(kThreads, 1)
cce_lookup_bwd_narrow_kernel(const int32_t* __restrict__ idx, const scalar_t* __restrict__ dout,
                             scalar_t* __restrict__ dtab, int c, int B, int T, int k, int dsub,
                             int64_t s_col, int64_t s_b, int64_t s_t) {
  bwd<scalar_t, kNarrow>(idx, dout, dtab, c, B, T, k, dsub, s_col, s_b, s_t);
}

template <typename scalar_t>
int launch(const void* idx, const void* dout, void* dtab, int c, int B, int T, int k, int dsub,
           int64_t s_col, int64_t s_b, int64_t s_t, int path, cudaStream_t stream) {
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const scalar_t* gp = static_cast<const scalar_t*>(dout);
  scalar_t* op = static_cast<scalar_t*>(dtab);
  constexpr int esize = static_cast<int>(sizeof(scalar_t));
  const int vectors = dsub * esize / 16;  // narrow: the 16-byte vectors of a row
  if (path == kVec4 && dsub != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (path == kNarrow && (dsub * esize != 16 * vectors || vectors < 2 || vectors > 16 ||
                          (vectors & (vectors - 1))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path != kVec4 && path != kWideVector && path != kWideScalar && path != kNarrow)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool by_thread = path == kVec4 || path == kNarrow;
  const int range = by_thread ? kThreadRange : kWarpRange;
  const int own_bytes = path == kVec4 ? 4 * esize : path == kNarrow ? 16 : 0;
  const int slice = path == kWideVector ? Lanes<scalar_t, true>::kSlice
                                        : Lanes<scalar_t, false>::kSlice;
  const int n_ranges = (k + range - 1) / range;
  const dim3 grid(static_cast<unsigned>(c) * T * n_ranges,
                  path == kVec4     ? 1u
                  : path == kNarrow ? static_cast<unsigned>(vectors)
                                    : static_cast<unsigned>((dsub + slice - 1) / slice));
  const size_t smem = smem_bytes(own_bytes, esize, range < k ? range : k);
  void (*kernel)(const int32_t*, const scalar_t*, scalar_t*, int, int, int, int, int, int64_t,
                 int64_t, int64_t) =
      path == kVec4         ? cce_lookup_bwd_vec4_kernel<scalar_t>
      : path == kNarrow     ? cce_lookup_bwd_narrow_kernel<scalar_t>
      : path == kWideVector ? cce_lookup_bwd_wide_vector_kernel<scalar_t>
                            : cce_lookup_bwd_wide_scalar_kernel<scalar_t>;
  // the shared-memory opt-in, once a kernel and device, for its largest range
  constexpr int kMaxDevices = 64;
  static bool opted_in[4][kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[path][dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(own_bytes, esize, range)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[path][dev] = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(ip, gp, op, c, B, T, k, dsub, s_col, s_b, s_t);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of dout and dtab).  path: 0 = vec4
// (dsub == 4, dout and dtab aligned to 4 elements), 1 = wide_vector (dsub a
// multiple of 16 bytes of elements, dout and dtab aligned to 16 bytes),
// 2 = wide_scalar (any), 3 = narrow (rows of 2, 4, 8 or 16 16-byte vectors,
// dout and dtab aligned to 16 bytes); the caller checks the alignment.  Writes every
// element of dtab (c, T, k, dsub).  Returns the cudaError_t of the launch
// (0 on success).  c*T >= 1, k >= 1, B >= 0.
extern "C" int cce_lookup_bwd(const void* idx, const void* dout, void* dtab, int dtype, int c,
                              int B, int T, int k, int dsub, long long s_col, long long s_b,
                              long long s_t, int path, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0)
    err = launch<float>(idx, dout, dtab, c, B, T, k, dsub, s_col, s_b, s_t, path, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(idx, dout, dtab, c, B, T, k, dsub, s_col, s_b, s_t, path, st);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  return err ? err : static_cast<int>(cudaGetLastError());
}

extern "C" const char* cce_lookup_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef CCE_BWD_STAMPS
// Copies the stamps of the first n_ctas CTAs of the last launch, kStamps
// each, to host memory.  Returns the cudaError_t.
extern "C" int cce_lookup_bwd_stamps(unsigned long long* host, int n_ctas) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_stamps, static_cast<size_t>(n_ctas) * kStamps * sizeof(unsigned long long)));
}
#endif
