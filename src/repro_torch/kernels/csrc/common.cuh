// Shared device helpers of the port's hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Four consecutive floats row[e..e+3], zero past d.  kAligned: d % 4 == 0
// and the row base is 16-byte aligned, so one float4 load serves (e and d
// are both multiples of 4, hence e < d means the whole slice is in range).
template <bool kAligned>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int e,
                                        int d) {
  if (kAligned) {
    if (e < d) return __ldg(reinterpret_cast<const float4*>(row + e));
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 v;
  v.x = e < d ? __ldg(row + e) : 0.f;
  v.y = e + 1 < d ? __ldg(row + e + 1) : 0.f;
  v.z = e + 2 < d ? __ldg(row + e + 2) : 0.f;
  v.w = e + 3 < d ? __ldg(row + e + 3) : 0.f;
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// A warp's copy of one d-vector: lane l holds the float4 slices
// s*32 + l (s < NS), i.e. elements [4(32s + l), 4(32s + l) + 4), covering
// d <= 128 * NS.  NS == 0 keeps nothing in registers and re-reads the vector
// from memory (L1-resident) for every dot: the path for d > 1024.
template <int NS, bool kAligned>
struct WarpVec {
  float4 v[NS > 0 ? NS : 1];
  const float* base;

  __device__ __forceinline__ void load(const float* __restrict__ p, int d,
                                       int lane) {
    base = p;
#pragma unroll
    for (int s = 0; s < NS; ++s) v[s] = load4<kAligned>(p, (s * 32 + lane) * 4, d);
  }

  // This lane's share of the dot with row (reduce with warp_sum).
  __device__ __forceinline__ float partial_dot(const float* __restrict__ row,
                                               int d, int lane) const {
    float acc = 0.f;
    if (NS > 0) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
        acc += dot4(v[s], load4<kAligned>(row, (s * 32 + lane) * 4, d));
    } else {
      for (int e = lane * 4; e < d; e += 128)
        acc += dot4(load4<kAligned>(base, e, d), load4<kAligned>(row, e, d));
    }
    return acc;
  }
};

// Slices per lane for width d: the smallest of 1, 2, 4, 8 that covers d, or
// 0 (re-read path) above 1024.
inline int slices_for(int d) {
  int need = (d + 127) / 128;
  if (need <= 1) return 1;
  if (need <= 2) return 2;
  if (need <= 4) return 4;
  if (need <= 8) return 8;
  return 0;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace repro_torch
