// Shared device helpers of the port's hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// The largest running top-k list of the scan kernels.
constexpr int kMaxTopk = 1024;

// Insert (v, id) into the sorted list (ld, li) of length k (shared memory);
// the caller has checked v < ld[k-1].  Whole warp, uniform arguments.  The
// insert position is the count of entries <= v, so an equal value never
// displaces an earlier one.
__device__ __forceinline__ void list_insert(float* ld, int* li, int k,
                                            float v, int id, int lane) {
  int cnt = 0;
  for (int j = lane; j < k; j += 32) cnt += ld[j] <= v;
  const int pos = __reduce_add_sync(kFullMask, cnt);
  // shift [pos, k-2] up by one: read everything first, then write
  float tv[kMaxTopk / 32];
  int ti[kMaxTopk / 32];
  const int hi = (k + 31) / 32;
  for (int s = 0; s < hi; ++s) {
    const int j = lane + 32 * s;
    if (j > pos && j < k) { tv[s] = ld[j - 1]; ti[s] = li[j - 1]; }
  }
  __syncwarp();
  for (int s = 0; s < hi; ++s) {
    const int j = lane + 32 * s;
    if (j > pos && j < k) { ld[j] = tv[s]; li[j] = ti[s]; }
    if (j == pos) { ld[j] = v; li[j] = id; }
  }
  __syncwarp();
}

// Merge n candidates (part[c], payload[c]) in index order into the sorted
// list (ld, li) of length k.  Whole warp.  The lanes test 32 candidates at a
// time against the k-th entry, and the ones strictly below it are inserted
// one by one in index order, so among equal values the earlier one stays
// ahead (the reference's old-list-first, first-minimum order).
__device__ __forceinline__ void merge_candidates(float* ld, int* li, int k,
                                                 const float* part,
                                                 const int* payload, int n,
                                                 int lane) {
  float thr = ld[k - 1];
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int c = c0 + lane;
    const float v = c < n ? part[c] : INFINITY;
    unsigned m = __ballot_sync(kFullMask, v < thr);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float cv = __shfl_sync(kFullMask, v, src);
      if (!(cv < thr)) continue;  // uniform
      list_insert(ld, li, k, cv, payload[c0 + src], lane);
      thr = ld[k - 1];
    }
  }
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
