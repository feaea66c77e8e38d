// Fused CCE lookup, backward: the gradient of every column and sub-table of
// the universal supertable, deterministic, without atomics on floats.
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
// the H100's 3.35 TB/s; on the LM token table (c=4, T=2, k=4748, dsub=384,
// float32) at a training step's B=8192, 0.26 MB + 50.3 MB + 58.3 MB, 32.5 us.
//
// Every output row has ONE owner that adds its terms in increasing b and
// writes the row once, so no float is ever added atomically, and a row is
// never split along b, since that would change the order of its adds.
// The terms of a row are found by a stable counting sort of the indices by
// row (integers only: exact and deterministic).  Two designs, by layout
// (the launcher's path, as in the forward):
//
// vec4, narrow: one kernel.  A CTA owns the rows [r_lo, r_lo + 512) of
// one (column, sub-table) (one CTA per (column, sub-table) wherever
// k <= 512); for each chunk of kChunk b it
//   1. loads its 2048 indices (4 a thread, strided reads of the view, no
//      copy) and the dout rows (narrow: one 16-byte vector of each) of the
//      same entries into registers, so that the sort below hides their
//      latency;
//   2. buckets the chunk by row in shared memory: each warp takes 128
//      consecutive b as 4 tiles of 32, in order, ranks each entry among the
//      equal rows of its tile (vec4: one __ballot_sync a key bit, cheaper
//      there than __match_any_sync; narrow: __match_any_sync, 0.9 us the
//      cheaper at the hashing trick's shape) and keeps per-warp counts
//      (written by one lane a row); an exclusive scan over (row, warp) gives
//      every entry its place, so each row's dout rows lie side by side,
//      ascending in b;
//   3. lets each owner walk only its own segment, carrying acc in registers
//      from chunk to chunk.
// A row of more than kHot terms is split along d instead: its kOwn
// elements are independent chains of adds, walked by kOwn threads in warps
// on the SM's 4 schedulers, each with kHotAhead loads in flight.
//   vec4    dsub == 4, aligned: a thread owns a row; the sorted rows take 32
//           KB of shared memory a chunk in float32, 16 KB in bfloat16.
//   narrow  rows of 2, 4, 8 or 16 16-byte vectors, aligned (float32 dsub
//           8-64, bfloat16 16-128): vec4 on one 16-byte vector of each row a
//           CTA (grid y numbers the vectors), a thread owning that vector of
//           one row.  A column's gather and its hot rows' chains so spread
//           over as many SMs as a row has vectors (104 CTAs at the hashing
//           trick's dsub 16 in float32).
//
// wide_vector, wide_scalar (every other width: the LM token tables' 384, 400
// and 512; wide_scalar for unaligned views and widths that are not whole
// 16-byte vectors): sort once, then walk whole rows, two launches on the
// caller's stream with scratch from the caller (torch's caching allocator),
// in the geometry that the launcher chooses (cce_lookup.py::
// wide_bwd_geometry; launch_wide checks only its bounds).
//   1. cce_lookup_bwd_sort_kernel: one CTA of 256 threads a (column,
//      sub-table, chunk of kSortChunk b, range of at most kSortRows rows).
//      It reads its chunk's indices once, ranks each entry among the equal
//      rows of its 32-entry tile (__match_any_sync) behind per-warp 16-bit
//      counts of every row of its range, turns those into counts of the
//      warps before (four rows a thread at once, packed), scans the rows'
//      totals, and writes the range's row starts (st) and the b of its
//      entries, grouped by row and ascending in b within each row (sorted):
//      a CSR of the chunk.  The LM train shape (B=8192, k=4748) takes 8
//      chunks x 2 ranges x 8 (column, sub-table): 128 CTAs, each ranking
//      1024 indices once.
//   2. cce_lookup_bwd_wide_{vector,scalar}_kernel: one warp a block of up to
//      32 rows of one (column, sub-table) and one slice of d (grid y: 128
//      float32 or 256 bfloat16 elements, lanes past dsub off).  It copies
//      its rows' starts in every chunk into shared memory (cp.async), so
//      that a row's terms are its segments of chunk 0, 1, ... in order, which
//      is increasing b; numbers the block's terms row by row, 32 at a time,
//      a lane a term (the row by a search over the lanes' offsets, the chunk
//      by a search over the row's chunk offsets); keeps kAhead dout loads
//      (wide_scalar: half as many) in flight, across row ends, ahead of the
//      adds, each load unpredicated (a predicated load's select waits on its
//      data: one round trip a term); stores each row once, coalesced, and
//      zeros for rows with no term.  Where a row is 16 or 8 lanes wide or
//      less (dsub 36 and 6 in float32), the warp is 2 or 4 groups of lanes,
//      each walking rows of its own in the same way, so that the lanes that
//      would load nothing walk other rows.  A warp takes the fewest rows
//      that bring the walk to one load of the card (2048 warps): each warp
//      is a chain of round trips (its row starts, its terms' b, then dout a
//      kAhead at a time), so a second wave costs a whole chain.  A row of
//      more than kHotTerms terms (27% of the terms of a LM step's token
//      rows) is left to the hot CTAs at the front of the same grid, one a
//      128 rows of a (column, sub-table) and slice: it finds its hot rows
//      and walks each with a thread an element, 32 loads in flight and 64
//      more terms prefetched into the L2, so that the hottest row's chain
//      runs beside the bulk instead of after it.
// What held the one-kernel design back at the LM train shape (0.2452 ms
// against a bound of 0.0325): a CTA owned 64 rows and one 512-byte slice of
// d, so each of the 1800 CTAs loaded and ranked all 8192 indices of its
// (column, sub-table) to find the ~109 in its rows (~2.9 us a chunk of its
// ~20 us), and the CTA of the hottest row (482 terms) walked it one
// dependent load at a time for ~140 us, which ended the grid.  What bounds
// the sort-once design (tools/probe_lookup_bwd.py; PERF.md): at the LM
// train shape, the walk's bytes (~44 us of walk on uniform rows, about 1.4x
// the byte bound) and the hot CTA of the hottest row (~45 us on a step's
// token rows, beside the bulk), after the sort (~4 us); at hymba's token
// table, its hot CTAs (one walks ~880 terms in ~61 us); at narrow tables
// (c=26, k=305, B=2048), the sort's ~4 us and a walk warp's chain of ~4
// round trips (~6.5 us at dsub 36), which the one-kernel design ran in one
// wave without a second launch.

#include "cce_lookup_common.cuh"

namespace {

// ---- vec4 and narrow: one kernel --------------------------------------------

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
constexpr int kRange = kThreads;                 // rows a CTA owns
// a row of more than kHot terms is walked along d, a thread an element;
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
// A build for timing the kernels' phases (tools/probe_lookup_bwd.py).
// vec4 and narrow: at the start and at the end of each phase of the first
// chunk, and after the store, a barrier, then thread 0 of each of the
// first kStampCtas CTAs writes %globaltimer (ns).  The barrier does not
// stall a warp until an instruction needs it, so the timer is read under a
// predicate on the barrier's count, which exists only once every thread
// has arrived.  The wide layouts' sort kernel does the same after each of
// its phases; lane 0 of each walk warp writes the time at its start, once
// its row starts are in and after its last store, then its count of terms.
constexpr int kStamps = 7;
constexpr int kStampCtas = 4096;
constexpr int kSortStamps = 6;
constexpr int kWalkStamps = 4;
constexpr int kHotStamps = 3;
constexpr int kStampWarps = 1 << 16;
__device__ unsigned long long g_stamps[kStampCtas][kStamps];
__device__ unsigned long long g_sort_stamps[kStampCtas][kSortStamps];
__device__ unsigned long long g_walk_stamps[kStampWarps][kWalkStamps];
__device__ unsigned long long g_hot_stamps[kStampCtas][kHotStamps];
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}
__device__ __forceinline__ void stamp(int b0, int i) {
  const int arrived = __syncthreads_count(1);
  if (arrived == static_cast<int>(blockDim.x) && b0 == 0 && threadIdx.x == 0 &&
      blockIdx.y == 0 && blockIdx.x < kStampCtas)
    g_stamps[blockIdx.x][i] = globaltimer();
}
__device__ __forceinline__ void sort_stamp(int i) {
  const int arrived = __syncthreads_count(1);
  if (arrived == static_cast<int>(blockDim.x) && threadIdx.x == 0 && blockIdx.x < kStampCtas)
    g_sort_stamps[blockIdx.x][i] = globaltimer();
}
__device__ __forceinline__ void walk_stamp(int slot, int i, unsigned long long v) {
  if ((threadIdx.x & 31) == 0 && slot < kStampWarps) g_walk_stamps[slot][i] = v;
}
__device__ __forceinline__ void hot_stamp(int slot, int i, unsigned long long v) {
  if (threadIdx.x == 0 && slot < kStampCtas) g_hot_stamps[slot][i] = v;
}
#else
__device__ __forceinline__ void stamp(int, int) {}
__device__ __forceinline__ void sort_stamp(int) {}
__device__ __forceinline__ void walk_stamp(int, int, unsigned long long) {}
__device__ __forceinline__ void hot_stamp(int, int, unsigned long long) {}
__device__ __forceinline__ unsigned long long globaltimer() { return 0; }
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

// Inclusive prefix sum of v over each group of kW lanes of a warp.
template <int kW = 32>
__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = static_cast<int>(threadIdx.x) & (kW - 1);
#pragma unroll
  for (int o = 1; o < kW; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o, kW);
    if (lane >= o) v += y;
  }
  return v;
}

// Exclusive prefix sum of v over the CTA, in thread order; s_wsum holds
// kWarps ints.  Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_wsum) {
  const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
  const int x = warp_inclusive_scan(v);
  if (lane == 31) s_wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_inclusive_scan(lane < kWarps ? s_wsum[lane] : 0);
    if (lane < kWarps) s_wsum[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  return x - v + (warp ? s_wsum[warp - 1] : 0);
}

// Shared memory of one CTA, in bytes: the sorted chunk's dout rows of
// own_bytes a thread, padded for the hot walk's reads ahead, per-warp row
// counts, row starts and counts, warp sums, the hot rows and their sums.
__host__ __device__ constexpr size_t smem_bytes(int own_bytes, int esize, int rows) {
  return static_cast<size_t>(kChunk + kHotAhead) * own_bytes +
         (static_cast<size_t>(kWarps) * rows + 2 * static_cast<size_t>(rows) + kWarps + 1 +
          kMaxHot + own_bytes / esize * kMaxHot) * sizeof(int);
}

// Grid: x = (column*T + t) * n_ranges + range, y = narrow's vector of a row.
template <typename scalar_t, int kPath>
__device__ __forceinline__ void bwd(const int32_t* __restrict__ idx,
                                    const scalar_t* __restrict__ dout,
                                    scalar_t* __restrict__ dtab, int c, int B, int T, int k,
                                    int dsub, int64_t s_col, int64_t s_b, int64_t s_t) {
  static_assert(kPath == kVec4 || kPath == kNarrow, "the wide layouts sort once and walk");
  // the elements of its row that a thread owns
  constexpr int kOwn = kPath == kNarrow ? 16 / static_cast<int>(sizeof(scalar_t)) : 4;
  using O = Own<scalar_t, kOwn>;
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
  // the first element of d this CTA covers: narrow's vector
  const int e0 = kPath == kVec4 ? 0 : static_cast<int>(blockIdx.y) * kOwn;
  // hot rows: hot row h's element e is walked by the thread in warp
  // 4*(h/(32/kHotLanes)) + e/kHotLanes, lane (h%(32/kHotLanes)) * kHotLanes
  // + e%kHotLanes, so that its chains of adds run on the 4 schedulers of
  // the SM at once, kHotLanes lanes of one warp each
  constexpr int kHotLanes = kOwn / 4;
  static_assert(kThreads / kOwn >= kMaxHot, "kOwn threads for every hot row of a chunk");
  const int hot_h = (warp >> 2) * (32 / kHotLanes) + lane / kHotLanes;
  const int hot_e = (warp & 3) * kHotLanes + lane % kHotLanes;

  using row_t = typename O::type;
  row_t* s_rows = reinterpret_cast<row_t*>(smem);  // the chunk's dout rows, sorted
  int* s_hist = reinterpret_cast<int*>(smem + (kChunk + kHotAhead) * sizeof(row_t));
  int* s_start = s_hist + kWarps * stride;
  int* s_count = s_start + stride;
  int* s_wsum = s_count + stride;
  int* s_nhot = s_wsum + kWarps;  // hot rows of the chunk, then each one's row
  int* s_hot = s_nhot + 1;
  float* s_hotacc = reinterpret_cast<float*>(s_hot + kMaxHot);  // their kOwn running sums

  const int32_t* ip = idx + col * s_col + t * s_t;
  const scalar_t* dp = dout + static_cast<int64_t>(col) * dsub;  // dout[0, col, :]
  const int64_t d_b = static_cast<int64_t>(c) * dsub;            // stride of b in dout
  int* hist = s_hist + warp * stride;

  float acc[kOwn];
#pragma unroll
  for (int j = 0; j < kOwn; ++j) acc[j] = 0.f;

  for (int b0 = 0; b0 < B; b0 += kChunk) {
    const int nb = min(kChunk, B - b0);
    __syncthreads();  // every owner is done with the previous chunk
    stamp(b0, 0);
    // this warp's entries: j = warp*32*kTiles + 32*i + lane, key = row - r_lo
    // or `rows` for an index outside [r_lo, r_lo + rows) (sentinels, >= k),
    // and their dout rows (the CTA's vector of each), loaded now so that the
    // sort hides them
    int key[kTiles];
    row_t row[kTiles];
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int j = warp * 32 * kTiles + 32 * i + lane;
      const int r = j < nb ? __ldg(ip + static_cast<int64_t>(b0 + j) * s_b) : -1;
      key[i] = r >= r_lo && r - r_lo < rows ? r - r_lo : rows;
      if (j < nb)
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
      if (key[i] < rows) s_rows[s_start[key[i]] + hist[key[i]] + rank[i]] = row[i];
    if (kSplit && tid == 0) *s_nhot = 0;
    __syncthreads();
    stamp(b0, 4);

    // a row of at most kHot terms is walked by its owner; a longer one is
    // handed, with its running sums, to kOwn threads, one per element
    const int n = tid < rows ? s_count[tid] : 0;
    int my_hot = -1;
    if (kSplit && n > kHot) {
      my_hot = atomicAdd(s_nhot, 1);  // in any order: each hot row is walked alone
      s_hot[my_hot] = tid;
#pragma unroll
      for (int j = 0; j < kOwn; ++j) s_hotacc[kOwn * my_hot + j] = acc[j];
    } else if (n > 0) {  // the row's terms lie side by side: no index to chase
      const row_t* seg = s_rows + s_start[tid];
#pragma unroll 8
      for (int p = 0; p < n; ++p) {
        float v[kOwn];
        O::unpack(seg[p], v);
#pragma unroll
        for (int j = 0; j < kOwn; ++j) acc[j] += v[j];
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
          for (int j = 0; j < kOwn; ++j) acc[j] = s_hotacc[kOwn * my_hot + j];
      }
    }
    stamp(b0, 5);
  }

  scalar_t* out = dtab + (static_cast<int64_t>(ct) * k + r_lo) * dsub;  // dtab[col, t, r_lo]
  if (tid < rows) O::store(out + static_cast<int64_t>(tid) * dsub + e0, acc);
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
__global__ void __launch_bounds__(kThreads, 1)
cce_lookup_bwd_narrow_kernel(const int32_t* __restrict__ idx, const scalar_t* __restrict__ dout,
                             scalar_t* __restrict__ dtab, int c, int B, int T, int k, int dsub,
                             int64_t s_col, int64_t s_b, int64_t s_t) {
  bwd<scalar_t, kNarrow>(idx, dout, dtab, c, B, T, k, dsub, s_col, s_b, s_t);
}

// the shared-memory opt-in, once a kernel and device, to `bytes`
constexpr int kMaxDevices = 64;
template <typename Kernel>
int opt_in(Kernel kernel, bool (&done)[kMaxDevices], size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    done[dev] = true;
  }
  return 0;
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
  if (path != kVec4 && path != kNarrow) return static_cast<int>(cudaErrorInvalidValue);
  const int own_bytes = path == kVec4 ? 4 * esize : 16;
  const int n_ranges = (k + kRange - 1) / kRange;
  const dim3 grid(static_cast<unsigned>(c) * T * n_ranges,
                  path == kVec4 ? 1u : static_cast<unsigned>(vectors));
  const size_t smem = smem_bytes(own_bytes, esize, kRange < k ? kRange : k);
  void (*kernel)(const int32_t*, const scalar_t*, scalar_t*, int, int, int, int, int, int64_t,
                 int64_t, int64_t) = path == kVec4 ? cce_lookup_bwd_vec4_kernel<scalar_t>
                                                   : cce_lookup_bwd_narrow_kernel<scalar_t>;
  static bool opted_in[2][kMaxDevices];
  const int err = opt_in(kernel, opted_in[path == kNarrow], smem_bytes(own_bytes, esize, kRange));
  if (err) return err;
  kernel<<<grid, kThreads, smem, stream>>>(ip, gp, op, c, B, T, k, dsub, s_col, s_b, s_t);
  return 0;
}

// ---- wide_vector, wide_scalar: sort once, then walk --------------------------

constexpr int kSortWarps = 8;
constexpr int kSortThreads = 32 * kSortWarps;
constexpr int kSortTiles = 4;                            // 32-entry tiles a warp ranks, in order
constexpr int kSortChunk = kSortThreads * kSortTiles;    // b a sort CTA takes
constexpr int kSortRows = 4096;                          // rows a sort CTA takes, at most
constexpr int kWalkWarps = 4;
constexpr int kWalkThreads = 32 * kWalkWarps;
constexpr int kWalkTable = 1024;  // (row, chunk) starts a walk warp holds: rows x chunks
constexpr int kAhead = 16;  // dout loads a walk warp keeps in flight ahead of its adds
// A row of more than kHotTerms terms is walked by a hot CTA, a thread an
// element (two in bfloat16 on wide_vector) with kHotDepth loads in flight
// and kHotPrefetch more terms prefetched into the L2, and skipped by its walk
// warp
constexpr int kHotTerms = 64;
constexpr int kHotScan = kWalkThreads;  // rows a hot CTA scans, one a thread
constexpr int kHotPiece = 2048;         // a hot row's b staged in shared memory at once
constexpr int kHotDepth = 32;           // loads a hot CTA's thread keeps in flight
constexpr int kHotPrefetch = 64;        // and, beyond them, terms it prefetches into the L2

// The launcher chooses the geometry (cce_lookup.py::wide_bwd_geometry): B in
// n_chunks chunks of kSortChunk, k in ranges of rr rows (a multiple of 32,
// at most kSortRows, so that a walk warp's rows never straddle two ranges),
// rpw rows a walk warp (a power of two up to 32, rpw * n_chunks <=
// kWalkTable).  launch_wide checks only that the kernels stay in bounds.

// Sort shared memory for `rows` rows: 16-bit counts a warp and row, row
// starts, warp sums.
__host__ __device__ constexpr size_t sort_smem_bytes(int rows) {
  return static_cast<size_t>(kSortWarps) * ((rows + 7) & ~7) * sizeof(uint16_t) +
         (static_cast<size_t>((rows + 7) & ~7) + 1 + kSortWarps) * sizeof(int);
}

// Grid x = ((column*T + t) * n_chunks + chunk) * n_ranges + range, a range
// rr rows.  Writes
// st[(column*T + t) * n_chunks + chunk][r + range] (k + n_ranges ints
// each): the start of row r's entries in its range's list, the range's
// count after its last row; and the b of the range's entries, grouped by
// row, ascending in b, into sorted[((column*T + t) * n_chunks + chunk) *
// n_ranges + range][0 .. count).
__global__ void __launch_bounds__(kSortThreads)
cce_lookup_bwd_sort_kernel(const int32_t* __restrict__ idx, int B, int T, int k, int64_t s_col,
                           int64_t s_b, int64_t s_t, int n_chunks, int rr,
                           int* __restrict__ st, int* __restrict__ sorted) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = static_cast<int>(threadIdx.x), lane = tid & 31, warp = tid >> 5;
  const int n_ranges = (k + rr - 1) / rr;
  int x = static_cast<int>(blockIdx.x);
  const int q = x % n_ranges;
  x /= n_ranges;
  const int j = x % n_chunks;
  const int ct = x / n_chunks, col = ct / T, t = ct - col * T;
  const int r_lo = q * rr, rows = min(rr, k - r_lo);
  const int rows_pad = (rows + 7) & ~7;
  uint16_t* s_hist = reinterpret_cast<uint16_t*>(smem);                   // [warp][rows_pad]
  int* s_start = reinterpret_cast<int*>(s_hist + kSortWarps * rows_pad);  // [rows_pad + 1]
  int* s_wsum = s_start + rows_pad + 1;                                   // [kSortWarps]
  sort_stamp(0);

  // this warp's entries: b = b0 + 32*i + lane, key = row - r_lo, or -1 for
  // an index outside [r_lo, r_lo + rows) (sentinels, >= k, other ranges)
  const int32_t* ip = idx + col * s_col + t * s_t;
  const int b0 = j * kSortChunk + warp * 32 * kSortTiles;
  int key[kSortTiles];
#pragma unroll
  for (int i = 0; i < kSortTiles; ++i) {
    const int b = b0 + 32 * i + lane;
    const int r = b < B ? __ldg(ip + static_cast<int64_t>(b) * s_b) : -1;
    const unsigned u = static_cast<unsigned>(r) - static_cast<unsigned>(r_lo);
    key[i] = u < static_cast<unsigned>(rows) ? static_cast<int>(u) : -1;
  }
  for (int i = tid; i < rows_pad; i += kSortThreads)  // kSortWarps 16-bit counts a 16 bytes
    reinterpret_cast<int4*>(s_hist)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  sort_stamp(1);

  // rank of each entry among the equal rows before it in this warp's b
  uint16_t* hist = s_hist + warp * rows_pad;
  int rank[kSortTiles];
#pragma unroll
  for (int i = 0; i < kSortTiles; ++i) {
    const unsigned same = __match_any_sync(0xffffffffu, key[i]);
    const unsigned before_me = same & ((1u << lane) - 1u);
    const bool real = key[i] >= 0;
    const int seen = real ? hist[key[i]] : 0;
    rank[i] = seen + __popc(before_me);
    __syncwarp();
    if (real && before_me == 0) hist[key[i]] = static_cast<uint16_t>(seen + __popc(same));
    __syncwarp();
  }
  __syncthreads();
  sort_stamp(2);

  // per row: the counts of the warps before each warp, four rows a thread
  // as packed 16-bit lanes (a row's count in a chunk is at most 1024), and
  // the row's count in s_start
  for (int i = tid; i < rows_pad / 4; i += kSortThreads) {
    uint2 run = make_uint2(0u, 0u);
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      uint2* h = reinterpret_cast<uint2*>(s_hist + w * rows_pad) + i;
      const uint2 n = *h;
      *h = run;
      run.x += n.x;
      run.y += n.y;
    }
    s_start[4 * i] = static_cast<int>(run.x & 0xffffu);
    s_start[4 * i + 1] = static_cast<int>(run.x >> 16);
    s_start[4 * i + 2] = static_cast<int>(run.y & 0xffffu);
    s_start[4 * i + 3] = static_cast<int>(run.y >> 16);
  }
  __syncthreads();
  sort_stamp(3);

  // the rows' exclusive starts, a warp a segment of rows, into s_start and st
  const int seg = ((rows + kSortWarps - 1) / kSortWarps + 31) / 32 * 32;
  const int lo = min(rows, warp * seg), hi = min(rows, lo + seg);
  int sum = 0;
  for (int r = lo + lane; r < hi; r += 32) sum += s_start[r];
#pragma unroll
  for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) s_wsum[warp] = sum;
  __syncthreads();
  int carry = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const int v = s_wsum[w];
    carry += w < warp ? v : 0;
    total += v;
  }
  int* st_out = st + (static_cast<int64_t>(ct) * n_chunks + j) * (k + n_ranges) + r_lo + q;
  for (int base = lo; base < hi; base += 32) {
    const int r = base + lane;
    const int v = r < hi ? s_start[r] : 0;
    const int incl = warp_inclusive_scan(v);
    if (r < hi) {
      s_start[r] = carry + incl - v;
      st_out[r] = carry + incl - v;
    }
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (tid == 0) st_out[rows] = total;
  __syncthreads();
  sort_stamp(4);

  // each entry's place: its row's start, the warps before, its rank
  int* out = sorted + ((static_cast<int64_t>(ct) * n_chunks + j) * n_ranges + q) * kSortChunk;
#pragma unroll
  for (int i = 0; i < kSortTiles; ++i)
    if (key[i] >= 0) out[s_start[key[i]] + hist[key[i]] + rank[i]] = b0 + 32 * i + lane;
  sort_stamp(5);
}

// One lane's share of one term's slice of a dout row, its bits untouched,
// for a group of kW lanes that covers the slice: wide_vector a 16-byte
// vector (elements e0 + lane*kPer ..), wide_scalar 4 elements (e0 + lane +
// kW*j), lane counted within the group.  At kW = 32 that is the wide
// layouts' element order (Lanes).  An element at or past dsub reads the
// row's first instead and is never stored: the load takes no predicate, so
// nothing waits on its data before the add that needs it.
template <typename scalar_t, bool kVector, int kW>
struct Term;
template <typename scalar_t, int kW>
struct Term<scalar_t, true, kW> {
  static constexpr int kPer = 16 / static_cast<int>(sizeof(scalar_t));
  static constexpr int kSlice = kW * kPer;
  using type = uint4;
  __device__ static __forceinline__ type load(const scalar_t* row, int e0, int lane, int dsub) {
    const int e = e0 + lane * kPer;
    return __ldg(reinterpret_cast<const uint4*>(row + (e < dsub ? e : 0)));
  }
  __device__ static __forceinline__ void add(float acc[kPer], type x) {
    float v[kPer];
    Group<scalar_t>::unpack(x, v);
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] += v[j];
  }
  __device__ static __forceinline__ void store(scalar_t* row, int e0, int lane, int dsub,
                                               const float acc[kPer]) {
    const int e = e0 + lane * kPer;
    if (e >= dsub) return;
    if constexpr (sizeof(scalar_t) == 4)
      store4(reinterpret_cast<float*>(row) + e, acc);
    else
      store8(reinterpret_cast<__nv_bfloat16*>(row) + e, acc);
  }
};
template <typename scalar_t, int kW>
struct Term<scalar_t, false, kW> {
  static constexpr int kPer = 4;
  static constexpr int kSlice = kW * kPer;
  struct type {
    scalar_t v[4];
  };
  __device__ static __forceinline__ type load(const scalar_t* row, int e0, int lane, int dsub) {
    type x;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = e0 + lane + kW * j;
      x.v[j] = __ldg(row + (e < dsub ? e : 0));
    }
    return x;
  }
  __device__ static __forceinline__ void add(float acc[kPer], type x) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] += to_float(x.v[j]);
  }
  __device__ static __forceinline__ void store(scalar_t* row, int e0, int lane, int dsub,
                                               const float acc[kPer]) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = e0 + lane + kW * j;
      if (e < dsub) store1(row + e, acc[j]);
    }
  }
};

// A hot CTA thread's kM elements of a term's slice (kM = kSlice /
// kWalkThreads: two bfloat16 on wide_vector, else one), one access.
template <typename scalar_t, int kM>
struct HotElems;
template <typename scalar_t>
struct HotElems<scalar_t, 1> {
  using type = scalar_t;
  __device__ static __forceinline__ type load(const scalar_t* row, int e) {
    return __ldg(row + e);
  }
  __device__ static __forceinline__ void add(float acc[1], type x) { acc[0] += to_float(x); }
  __device__ static __forceinline__ void store(scalar_t* p, const float acc[1]) {
    store1(p, acc[0]);
  }
};
template <>
struct HotElems<__nv_bfloat16, 2> {
  using type = unsigned int;
  __device__ static __forceinline__ type load(const __nv_bfloat16* row, int e) {
    return __ldg(reinterpret_cast<const unsigned int*>(row + e));
  }
  __device__ static __forceinline__ void add(float acc[2], type x) {
    float v[2];
    unpack_bf16x2(x, v);
    acc[0] += v[0];
    acc[1] += v[1];
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, const float acc[2]) {
    *reinterpret_cast<unsigned int*>(p) = pack_bf16x2(acc[0], acc[1]);
  }
};

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}


// A hot CTA: hx = (column*T + t) * ceil(k / kHotScan) + g scans the rows
// [g*kHotScan, (g+1)*kHotScan) of its (column, sub-table) for rows of more
// than kHotTerms terms and walks each in turn on slice y of d: the row's
// starts in every chunk and their exclusive prefix, its b copied into
// shared memory kHotPiece at a time (cp.async), then each thread its kM
// elements with kHotDepth loads in flight (unpredicated, as in Term), in
// increasing b.
template <typename scalar_t, bool kVector>
__device__ __forceinline__ void walk_hot(const int* __restrict__ st,
                                         const int* __restrict__ sorted,
                                         const scalar_t* __restrict__ dout,
                                         scalar_t* __restrict__ dtab, int c, int T, int k,
                                         int dsub, int n_chunks, int rr, int hx) {
  using L = Lanes<scalar_t, kVector>;
  constexpr int kM = L::kSlice / kWalkThreads;
  using H = HotElems<scalar_t, kM>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = static_cast<int>(threadIdx.x), lane = tid & 31, warp = tid >> 5;
  const unsigned long long t0 = globaltimer();
  const int per_ct = (k + kHotScan - 1) / kHotScan;
  const int ct = hx / per_ct, col = ct / T, h_lo = (hx - ct * per_ct) * kHotScan;
  const int n_ranges = (k + rr - 1) / rr;
  const int64_t st_stride = k + n_ranges;
  const int* st_ct = st + static_cast<int64_t>(ct) * n_chunks * st_stride;
  const int slot = static_cast<int>(blockIdx.y) * (c * T * per_ct) + hx;
  int* s_list = reinterpret_cast<int*>(smem);  // [kHotScan]: the hot rows, in any order
  int* s_n = s_list + kHotScan;                // [8]: their count; warp sums
  int* s_start = s_n + 8;                      // [n_chunks]: a row's start in each chunk
  int* s_f = s_start + n_chunks;               // [n_chunks]: its terms in the chunks before
  int* s_terms = s_f + n_chunks;               // [kHotPiece]: its b
  if (tid == 0) s_n[0] = 0;
  __syncthreads();
  const int row = h_lo + tid;  // this thread's row: its terms over every chunk
  if (row < k) {
    const int* s = st_ct + row + row / rr;
    int n = 0;
#pragma unroll 4
    for (int jj = 0; jj < n_chunks; ++jj, s += st_stride) n += __ldg(s + 1) - __ldg(s);
    if (n > kHotTerms) s_list[atomicAdd(s_n, 1)] = row;
  }
  __syncthreads();
  const int n_hot = s_n[0];
  const scalar_t* dcol = dout + static_cast<int64_t>(col) * dsub;  // dout[0, col, :]
  const int64_t d_b = static_cast<int64_t>(c) * dsub;              // stride of b in dout
  const int e = static_cast<int>(blockIdx.y) * L::kSlice + tid * kM;  // this thread's first
  const int e_rd = e < dsub ? e : 0;  // past dsub: read element 0, never stored
  const int top = n_chunks > 1 ? 1 << (31 - __clz(n_chunks - 1)) : 0;
  const int per = (n_chunks + kWalkThreads - 1) / kWalkThreads;  // chunks a thread
  int hot_terms = 0;
  for (int h = 0; h < n_hot; ++h) {
    const int r = s_list[h], q = r / rr;
    const int* s = st_ct + r + q;
    int sum = 0;
    for (int jj = tid * per; jj < min(n_chunks, tid * per + per); ++jj) {
      const int a = __ldg(s + jj * st_stride);
      s_start[jj] = a;
      s_f[jj] = sum;
      sum += __ldg(s + jj * st_stride + 1) - a;
    }
    const int incl = warp_inclusive_scan(sum);
    if (lane == 31) s_n[4 + warp] = incl;
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWalkWarps; ++w) {
      const int x = s_n[4 + w];
      off += w < warp ? x : 0;
      n += x;
    }
    for (int jj = tid * per; jj < min(n_chunks, tid * per + per); ++jj) s_f[jj] += off + incl - sum;
    __syncthreads();
    hot_terms += n;
    float acc[kM];
#pragma unroll
    for (int j = 0; j < kM; ++j) acc[j] = 0.f;
    for (int base = 0; base < n; base += kHotPiece) {
      const int np = min(kHotPiece, n - base);
      for (int i = tid; i < np; i += kWalkThreads) {
        const int p = base + i;
        int jj = 0;  // the last chunk whose first term of the row is at or before p
        for (int step = top; step; step >>= 1)
          if (jj + step < n_chunks && s_f[jj + step] <= p) jj += step;
        cp_async4(s_terms + i, sorted + ((static_cast<int64_t>(ct) * n_chunks + jj) * n_ranges +
                                         q) * kSortChunk + s_start[jj] + p - s_f[jj]);
      }
      cp_async_wait_all();
      __syncthreads();
      typename H::type ring[kHotDepth];  // ring[u]: term p + u, in flight
#pragma unroll
      for (int u = 0; u < kHotDepth; ++u)
        ring[u] = H::load(dcol + s_terms[min(u, np - 1)] * d_b, e_rd);
      for (int p = 0; p < np; p += kHotDepth) {
#pragma unroll
        for (int u = 0; u < kHotDepth; ++u) {
          if (p + u < np) H::add(acc, ring[u]);
          ring[u] = H::load(dcol + s_terms[min(p + u + kHotDepth, np - 1)] * d_b, e_rd);
          prefetch_l2(dcol + s_terms[min(p + u + kHotDepth + kHotPrefetch, np - 1)] * d_b + e_rd);
        }
      }
      __syncthreads();  // every thread is done with s_terms, s_start, s_f and s_n
    }
    if (e < dsub) H::store(dtab + (static_cast<int64_t>(ct) * k + r) * dsub + e, acc);
  }
  hot_stamp(slot, 0, t0);
  hot_stamp(slot, 1, globaltimer());
  hot_stamp(slot, 2, static_cast<unsigned long long>(hot_terms));
}

// A walk warp: bx = (column*T + t) * ctas + g, the row block g*kWalkWarps +
// warp of rpw rows, slice y of d (X::kSlice elements); its rows of more
// than kHotTerms terms are a hot CTA's.  The warp is kG groups of kW lanes,
// each of which walks rpw / kG of the block's rows on its own (kG > 1 where
// a row is at most kW lanes wide: then the block's rows are walked kG at a
// time, and d is one slice).  Shared memory: a warp's table of (2*rpw + 1)
// * n_chunks ints.
template <typename scalar_t, bool kVector, int kG>
__device__ __forceinline__ void walk(const int* __restrict__ st, const int* __restrict__ sorted,
                                     const scalar_t* __restrict__ dout,
                                     scalar_t* __restrict__ dtab, int c, int T, int k, int dsub,
                                     int n_chunks, int rr, int rpw, int bx) {
  constexpr int kW = 32 / kG;  // lanes a group
  using X = Term<scalar_t, kVector, kW>;
  constexpr int kPer = X::kPer;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
  const int gl = lane & (kW - 1), grp = lane / kW;  // this lane in its group; the group
  const int n_blocks = (k + rpw - 1) / rpw;
  const int ctas = (n_blocks + kWalkWarps - 1) / kWalkWarps;  // a (column, sub-table)
  const int ct = bx / ctas;
  const int block = (bx - ct * ctas) * kWalkWarps + warp;
  if (block >= n_blocks) return;  // the whole warp; no barrier below but the warp's own
  const unsigned long long t0 = globaltimer();
  const int col = ct / T;
  const int n_ranges = (k + rr - 1) / rr;
  const int r0 = block * rpw, rows = min(rpw, k - r0), q = r0 / rr;
  const int per = rpw / kG;  // rows a group: the warp's rows g0 .. g0 + per
  const int g0 = grp * per;
  const int e0 = static_cast<int>(blockIdx.y) * X::kSlice;
  const int slot = (static_cast<int>(blockIdx.y) * c * T + ct) * n_blocks + block;
  walk_stamp(slot, 0, t0);

  // the rows' starts in every chunk, and one past the last row: s_st[chunk][l]
  int* s_st = reinterpret_cast<int*>(smem) + warp * (2 * rpw + 1) * n_chunks;
  int* s_f = s_st + (rpw + 1) * n_chunks;  // [chunk][l]: row l's terms in the chunks before
  const int64_t st_stride = k + n_ranges;
  const int* st_row = st + static_cast<int64_t>(ct) * n_chunks * st_stride + r0 + q;
  for (int e = lane; e < n_chunks * (rows + 1); e += 32) {
    const int jj = e / (rows + 1), l = e - jj * (rows + 1);
    cp_async4(s_st + jj * (rpw + 1) + l, st_row + jj * st_stride + l);
  }
  cp_async_wait_all();
  __syncwarp();
  const int my_row = g0 + gl;  // lane gl < per of a group: the terms of row r0 + my_row
  int n_l = 0;
  if (gl < per && my_row < rows)
    for (int jj = 0; jj < n_chunks; ++jj) {
      const int* s = s_st + jj * (rpw + 1) + my_row;
      s_f[jj * rpw + my_row] = n_l;
      n_l += s[1] - s[0];
    }
  const bool hot = n_l > kHotTerms;  // a hot CTA's
  if (hot) n_l = 0;
  const int incl = warp_inclusive_scan<kW>(n_l);
  const int rowoff = incl - n_l;  // the group's terms, row by row: row my_row's first
  const int n_terms = __shfl_sync(0xffffffffu, incl, kW - 1, kW);  // the group's
  const int n_most = __reduce_max_sync(0xffffffffu, n_terms);      // the warp's largest
  __syncwarp();
  walk_stamp(slot, 1, globaltimer());

  scalar_t* out = dtab + (static_cast<int64_t>(ct) * k + r0 + g0) * dsub;  // the group's rows
  {  // rows no index names
    const float zero[kPer] = {};
    const unsigned empty =
        __ballot_sync(0xffffffffu, gl < per && my_row < rows && n_l == 0 && !hot);
    unsigned mine = empty;  // this group's lanes' bits, from its first
    if constexpr (kG > 1) mine = (empty >> (grp * kW)) & ((1u << kW) - 1u);
    while (mine) {  // the group's lanes alike; groups apart
      const int l = __ffs(mine) - 1;
      mine &= mine - 1;
      X::store(out + static_cast<int64_t>(l) * dsub, e0, gl, dsub, zero);
    }
  }
  if (n_most == 0) {  // the same for the whole warp
    walk_stamp(slot, 2, globaltimer());
    walk_stamp(slot, 3, 0);
    return;
  }

  // term p of the group: its b and its row l of the group (b = -1 past the
  // group's last term)
  const int* srt = sorted + (static_cast<int64_t>(ct) * n_chunks * n_ranges + q) * kSortChunk;
  const int64_t chunk_stride = static_cast<int64_t>(n_ranges) * kSortChunk;
  const int top = n_chunks > 1 ? 1 << (31 - __clz(n_chunks - 1)) : 0;
  auto term = [&](int p, int& b, int& l) {
    int lo = 0;  // the last row whose first term is at or before p
#pragma unroll
    for (int step = kW / 2; step; step >>= 1) {
      const int v = __shfl_sync(0xffffffffu, rowoff, lo + step, kW);
      if (v <= p) lo += step;
    }
    const int w = p - __shfl_sync(0xffffffffu, rowoff, lo, kW);  // within the row
    l = lo;
    b = -1;
    if (p < n_terms) {
      const int lw = g0 + lo;  // the row in the warp's table
      int jj = 0;  // the last chunk whose first term of the row is at or before w
      for (int step = top; step; step >>= 1)
        if (jj + step < n_chunks && s_f[(jj + step) * rpw + lw] <= w) jj += step;
      b = __ldg(srt + jj * chunk_stride + s_st[jj * (rpw + 1) + lw] + w - s_f[jj * rpw + lw]);
    }
  };

  const scalar_t* dcol = dout + static_cast<int64_t>(col) * dsub;  // dout[0, col, :]
  const int64_t d_b = static_cast<int64_t>(c) * dsub;              // stride of b in dout
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
  // wide_scalar's 4 loads a term take more registers: half the depth; no
  // more than a group's lanes, which resolve a batch of kW terms at once
  constexpr int kDepth = (kVector ? kAhead : kAhead / 2) < kW ? (kVector ? kAhead : kAhead / 2)
                                                              : kW;
  static_assert(kW % kDepth == 0, "a group of loads ahead never crosses a batch of kW terms");
  typename X::type buf[kDepth];  // buf[u]: term p + u, in flight
  int b_cur, l_cur, b_nxt, l_nxt;  // this lane's term of the batch of p, and of the next
  term(gl, b_cur, l_cur);
  term(kW + gl, b_nxt, l_nxt);
  // every load reads a row of dout (row 0 past the group's last term, which
  // B >= 1 holds when the warp has a term): no predicate, see Term
#pragma unroll
  for (int u = 0; u < kDepth; ++u) {
    const int b = __shfl_sync(0xffffffffu, b_cur, u, kW);
    buf[u] = X::load(dcol + (u < n_terms ? b : 0) * d_b, e0, gl, dsub);
  }
  int cur = -1;  // the row being summed
  for (int p = 0; p < n_most; p += kDepth) {
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int pp = p + u;
      const int l = __shfl_sync(0xffffffffu, l_cur, pp & (kW - 1), kW);
      if (pp < n_terms) {
        if (l != cur) {
          if (cur >= 0) X::store(out + static_cast<int64_t>(cur) * dsub, e0, gl, dsub, acc);
#pragma unroll
          for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
          cur = l;
        }
        X::add(acc, buf[u]);
      }
      const int pn = pp + kDepth;  // the term that takes buf[u]
      const int bn = __shfl_sync(0xffffffffu, (pn / kW) == (p / kW) ? b_cur : b_nxt,
                                 pn & (kW - 1), kW);
      buf[u] = X::load(dcol + (pn < n_terms ? bn : 0) * d_b, e0, gl, dsub);
    }
    if (((p + kDepth) & (kW - 1)) == 0) {  // the next group of loads starts a batch
      b_cur = b_nxt;
      l_cur = l_nxt;
      term(p + kDepth + kW + gl, b_nxt, l_nxt);
    }
  }
  if (cur >= 0) X::store(out + static_cast<int64_t>(cur) * dsub, e0, gl, dsub, acc);
  walk_stamp(slot, 2, globaltimer());
  walk_stamp(slot, 3, static_cast<unsigned long long>(n_terms));
}

// Grid x: n_hot hot CTAs (walk_hot), first so that they start first, then
// the walk CTAs (walk, kG groups a warp); y: the slice of d.
template <typename scalar_t, int kG>
__global__ void __launch_bounds__(kWalkThreads, 4)
cce_lookup_bwd_wide_vector_kernel(const int* __restrict__ st, const int* __restrict__ sorted,
                                  const scalar_t* __restrict__ dout, scalar_t* __restrict__ dtab,
                                  int c, int T, int k, int dsub, int n_chunks, int rr, int rpw,
                                  int n_hot) {
  const int x = static_cast<int>(blockIdx.x);
  if (x < n_hot)
    walk_hot<scalar_t, true>(st, sorted, dout, dtab, c, T, k, dsub, n_chunks, rr, x);
  else
    walk<scalar_t, true, kG>(st, sorted, dout, dtab, c, T, k, dsub, n_chunks, rr, rpw,
                             x - n_hot);
}

template <typename scalar_t, int kG>
__global__ void __launch_bounds__(kWalkThreads, 4)
cce_lookup_bwd_wide_scalar_kernel(const int* __restrict__ st, const int* __restrict__ sorted,
                                  const scalar_t* __restrict__ dout, scalar_t* __restrict__ dtab,
                                  int c, int T, int k, int dsub, int n_chunks, int rr, int rpw,
                                  int n_hot) {
  const int x = static_cast<int>(blockIdx.x);
  if (x < n_hot)
    walk_hot<scalar_t, false>(st, sorted, dout, dtab, c, T, k, dsub, n_chunks, rr, x);
  else
    walk<scalar_t, false, kG>(st, sorted, dout, dtab, c, T, k, dsub, n_chunks, rr, rpw,
                              x - n_hot);
}

template <typename scalar_t>
int launch_wide(const void* idx, const void* dout, void* dtab, int* scratch,
                long long scratch_ints, int c, int B, int T, int k, int dsub, int64_t s_col,
                int64_t s_b, int64_t s_t, int path, int n_chunks, int rr, int rpw, int groups,
                cudaStream_t stream) {
  using Kernel = void (*)(const int*, const int*, const scalar_t*, scalar_t*, int, int, int, int,
                          int, int, int, int);
  const bool vec = path == kWideVector;
  const Kernel kernels[2][3] = {
      {cce_lookup_bwd_wide_scalar_kernel<scalar_t, 1>,
       cce_lookup_bwd_wide_scalar_kernel<scalar_t, 2>,
       cce_lookup_bwd_wide_scalar_kernel<scalar_t, 4>},
      {cce_lookup_bwd_wide_vector_kernel<scalar_t, 1>,
       cce_lookup_bwd_wide_vector_kernel<scalar_t, 2>,
       cce_lookup_bwd_wide_vector_kernel<scalar_t, 4>}};
  const int per = vec ? Lanes<scalar_t, true>::kPer : Lanes<scalar_t, false>::kPer;
  const int g_log = groups == 1 ? 0 : groups == 2 ? 1 : groups == 4 ? 2 : -1;
  if ((!vec && path != kWideScalar) || B < 0 || (vec && dsub % per) || g_log < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slice = 32 / groups * per;  // a group's lanes' elements
  const long long n_slices = (dsub + slice - 1) / slice;
  // the launcher's geometry, as far as the kernels' bounds need it
  if (n_chunks < 1 || static_cast<long long>(n_chunks) * kSortChunk < B || rr < 32 || rr % 32 ||
      rr > kSortRows || rpw < groups || rpw > 32 || (rpw & (rpw - 1)) ||
      static_cast<long long>(rpw) * n_chunks > kWalkTable || (groups > 1 && n_slices > 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_ranges = (k + rr - 1) / rr;
  const long long lists = static_cast<long long>(c) * T * n_chunks;
  const long long st_ints = lists * (k + n_ranges);
  const long long sort_ctas = lists * n_ranges;
  const long long n_blocks = (k + rpw - 1) / rpw;
  const long long n_hot = static_cast<long long>(c) * T * ((k + kHotScan - 1) / kHotScan);
  const long long walk_x =
      n_hot + static_cast<long long>(c) * T * ((n_blocks + kWalkWarps - 1) / kWalkWarps);
  if (scratch_ints < st_ints + sort_ctas * kSortChunk || sort_ctas > 0x7fffffff ||
      walk_x > 0x7fffffff || n_slices > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int* st = scratch;
  int* sorted = scratch + st_ints;
  static bool sort_opted[kMaxDevices];
  int err = opt_in(cce_lookup_bwd_sort_kernel, sort_opted, sort_smem_bytes(kSortRows));
  if (err) return err;
  cce_lookup_bwd_sort_kernel<<<static_cast<unsigned>(sort_ctas), kSortThreads,
                               sort_smem_bytes(rr < k ? rr : k), stream>>>(
      static_cast<const int32_t*>(idx), B, T, k, s_col, s_b, s_t, n_chunks, rr, st, sorted);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  // the larger of a walk CTA's tables and a hot CTA's lists (at most 48 KB)
  const size_t walk_ints = static_cast<size_t>(kWalkWarps) * (2 * rpw + 1) * n_chunks;
  const size_t hot_ints = static_cast<size_t>(kHotScan) + 8 + 2 * n_chunks + kHotPiece;
  const size_t smem = (walk_ints > hot_ints ? walk_ints : hot_ints) * sizeof(int);
  const dim3 grid(static_cast<unsigned>(walk_x), static_cast<unsigned>(n_slices));
  kernels[vec][g_log]<<<grid, kWalkThreads, smem, stream>>>(
      st, sorted, static_cast<const scalar_t*>(dout), static_cast<scalar_t*>(dtab), c, T, k,
      dsub, n_chunks, rr, rpw, static_cast<int>(n_hot));
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of dout and dtab).  path: 0 = vec4
// (dsub == 4, dout and dtab aligned to 4 elements), 3 = narrow (rows of 2,
// 4, 8 or 16 16-byte vectors, dout and dtab aligned to 16 bytes); the
// caller checks the alignment.  The wide layouts (1, 2) take
// cce_lookup_bwd_wide.  Writes every element of dtab (c, T, k, dsub).
// Returns the cudaError_t of the launch (0 on success).  c*T >= 1, k >= 1,
// B >= 0.
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

// The wide layouts: path 1 = wide_vector (dsub a multiple of 16 bytes of
// elements, dout and dtab aligned to 16 bytes), 2 = wide_scalar (any).  Two
// launches on `stream`, the sort and the walk, with `scratch` (int32,
// scratch_ints of them) for the row starts and the sorted b, in the
// launcher's geometry (cce_lookup.py::wide_bwd_geometry): n_chunks chunks
// of 1024 b, row ranges of range_rows, rows_per_warp rows a walk warp in
// groups (1, 2 or 4) of lanes; refused where the kernels would leave their
// bounds.  Writes every element
// of dtab (c, T, k, dsub).  Returns the cudaError_t of the launches (0 on
// success).  c*T >= 1, k >= 1, B >= 0.
extern "C" int cce_lookup_bwd_wide(const void* idx, const void* dout, void* dtab, void* scratch,
                                   long long scratch_ints, int dtype, int c, int B, int T, int k,
                                   int dsub, long long s_col, long long s_b, long long s_t,
                                   int path, int n_chunks, int range_rows, int rows_per_warp,
                                   int groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* s = static_cast<int*>(scratch);
  int err;
  if (dtype == 0)
    err = launch_wide<float>(idx, dout, dtab, s, scratch_ints, c, B, T, k, dsub, s_col, s_b, s_t,
                             path, n_chunks, range_rows, rows_per_warp, groups, st);
  else if (dtype == 1)
    err = launch_wide<__nv_bfloat16>(idx, dout, dtab, s, scratch_ints, c, B, T, k, dsub, s_col,
                                     s_b, s_t, path, n_chunks, range_rows, rows_per_warp, groups,
                                     st);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  return err ? err : static_cast<int>(cudaGetLastError());
}

extern "C" const char* cce_lookup_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef CCE_BWD_STAMPS
// Copies the stamps of the first n_ctas CTAs of the last vec4 or narrow
// launch, kStamps each, to host memory.  Returns the cudaError_t.
extern "C" int cce_lookup_bwd_stamps(unsigned long long* host, int n_ctas) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_stamps, static_cast<size_t>(n_ctas) * kStamps * sizeof(unsigned long long)));
}

// The last wide call's stamps: which = 0, the first n sort CTAs (kSortStamps
// each); 1, the first n walk warps (kWalkStamps each); 2, the first n hot
// CTAs (kHotStamps each: start, end, terms walked).  Returns the
// cudaError_t.
extern "C" int cce_lookup_bwd_wide_stamps(int which, unsigned long long* host, int n) {
  if (which == 0)
    return static_cast<int>(cudaMemcpyFromSymbol(
        host, g_sort_stamps, static_cast<size_t>(n) * kSortStamps * sizeof(unsigned long long)));
  if (which == 1)
    return static_cast<int>(cudaMemcpyFromSymbol(
        host, g_walk_stamps, static_cast<size_t>(n) * kWalkStamps * sizeof(unsigned long long)));
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_hot_stamps, static_cast<size_t>(n) * kHotStamps * sizeof(unsigned long long)));
}
#endif
