// Shared by the CCE lookup kernels (cce_lookup.cu, cce_lookup_bwd.cu):
// their layouts, and element access in float32 and bfloat16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// The layouts; the launcher (cce_lookup.py::lookup_path) picks one and
// passes its number.
enum Path { kVec4 = 0, kWideVector = 1, kWideScalar = 2, kNarrow = 3 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void unpack_bf16x2(uint32_t x, float* v) {
  __nv_bfloat162 h;
  memcpy(&h, &x, sizeof(h));
  const float2 f = __bfloat1622float2(h);
  v[0] = f.x;
  v[1] = f.y;
}
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  uint32_t x;
  memcpy(&x, &h, sizeof(x));
  return x;
}

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
  unpack_bf16x2(x.x, v);
  unpack_bf16x2(x.y, v + 2);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

// Eight consecutive bfloat16 elements: one 16-byte load or store.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  unpack_bf16x2(x.x, v);
  unpack_bf16x2(x.y, v + 2);
  unpack_bf16x2(x.z, v + 4);
  unpack_bf16x2(x.w, v + 6);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                            pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

// The wide layouts: a warp covers a slice of kSlice elements of a row, each
// lane kPer of them.  kVector: lane l holds elements [l*kPer, l*kPer + kPer)
// of the slice, one 16-byte access (dsub is a multiple of kPer, so a lane's
// elements lie all inside the row or all past it).  Otherwise lane l holds
// elements l + 32*j, j < kPer, one access each.
template <typename scalar_t, bool kVector>
struct Lanes {
  static constexpr int kPer = kVector ? 16 / static_cast<int>(sizeof(scalar_t)) : 4;
  static constexpr int kSlice = 32 * kPer;

  // This lane's elements of the slice at e0 of the row at p, as float32;
  // elements at or past dsub are neither read nor changed.
  __device__ static __forceinline__ void load(const scalar_t* p, int e0, int lane, int dsub,
                                              float v[kPer]) {
    if (kVector) {
      const int e = e0 + lane * kPer;
      if (e >= dsub) return;
      if constexpr (sizeof(scalar_t) == 4)
        load4(reinterpret_cast<const float*>(p) + e, v);
      else
        load8(reinterpret_cast<const __nv_bfloat16*>(p) + e, v);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = e0 + lane + 32 * j;
        if (e < dsub) v[j] = to_float(__ldg(p + e));
      }
    }
  }

  __device__ static __forceinline__ void store(scalar_t* p, int e0, int lane, int dsub,
                                               const float v[kPer]) {
    if (kVector) {
      const int e = e0 + lane * kPer;
      if (e >= dsub) return;
      if constexpr (sizeof(scalar_t) == 4)
        store4(reinterpret_cast<float*>(p) + e, v);
      else
        store8(reinterpret_cast<__nv_bfloat16*>(p) + e, v);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = e0 + lane + 32 * j;
        if (e < dsub) store1(p + e, v[j]);
      }
    }
  }
};

// The narrow layout: a group of kG = dsub*esize/16 lanes (2, 4, 8 or 16)
// covers one row, lane v of the group the row's v-th 16-byte vector, kPer
// elements (4 in float32, 8 in bfloat16).  Rows and their pointers are
// 16-byte aligned.
template <typename scalar_t>
struct Group {
  static constexpr int kPer = 16 / static_cast<int>(sizeof(scalar_t));

  // The kPer elements of a 16-byte vector's bits, as float32.
  __device__ static __forceinline__ void unpack(uint4 x, float v[kPer]) {
    if constexpr (sizeof(scalar_t) == 4) {
      v[0] = __uint_as_float(x.x);
      v[1] = __uint_as_float(x.y);
      v[2] = __uint_as_float(x.z);
      v[3] = __uint_as_float(x.w);
    } else {
      unpack_bf16x2(x.x, v);
      unpack_bf16x2(x.y, v + 2);
      unpack_bf16x2(x.z, v + 4);
      unpack_bf16x2(x.w, v + 6);
    }
  }

  // Vector v of the row at p (global memory), as float32.
  __device__ static __forceinline__ void load(const scalar_t* p, int v, float x[kPer]) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p) + v), x);
  }

  __device__ static __forceinline__ void store(scalar_t* p, int v, const float x[kPer]) {
    if constexpr (sizeof(scalar_t) == 4)
      store4(reinterpret_cast<float*>(p) + 4 * v, x);
    else
      store8(reinterpret_cast<__nv_bfloat16*>(p) + 8 * v, x);
  }
};

}  // namespace
