// centroid_assign: nearest centroid (assign) and top-p nearest centroids
// (probe) of every row of X, streaming the centroids past the rows.
//
// Replaces the TPU kernels src/repro/kernels/centroid_assign.py
// ::assign_centroids (Pallas; pl.pallas_call at :200, body _kernel at :26)
// and ::probe_centroids (pl.pallas_call at :118, body _probe_kernel at :74
// with the in-kernel _select_topk at :52).  Same functions: for each row x
// the partial distance part_j = ||c_j||² − 2 x·c_j to every centroid, with
// ||c||² hoisted once per call (the wrapper passes it), and
//   assign: the first minimum (lowest index among equal partials),
//   probe:  the p smallest partials ascending, ties to the lower index,
// then d2 = max(part + ||x||², 0) in that op order.  The reference's order:
// the running list comes before each new centroid tile and a new candidate
// replaces an entry only when strictly smaller (centroid_assign.py:93-98).
//
// Bound on an H100 SXM: the products.  n·k·d FMAs (2·n·k·d flops) against
// (n + k)·d·4 bytes: at n = 10,000, k = 16,384, d = 128 that is 41.9 GFLOP
// (0.63 ms at the 67 TFLOP/s f32 rate) against 14 MB (4 us).  TF32 tensor
// cores would be 7x faster but round the inputs to 10 mantissa bits, and the
// ranking depends on full f32, so this kernel stays on FP32 FMAs.
//
// Design: a classic register-blocked SGEMM.  A CTA of 256 threads owns 128
// rows of X and walks all centroids in tiles of 128, depth 8 at a time; each
// thread accumulates an 8x8 block of dots in registers from float4 reads of
// the two transposed shared-memory tiles, and the next depth slice is loaded
// into registers while the current one is multiplied (two shared buffers).
// After the last depth slice of a centroid tile:
//   assign: each thread folds its 8x8 partials into a running (min, index)
//           per row in registers; at the end the 16 threads of a row reduce
//           by (value, index) with shuffles.
//   probe:  the 128x128 partials are staged in shared memory and each warp
//           merges its 16 rows into their sorted top-p lists (shared memory):
//           the lanes test 32 candidates at a time against the row's p-th
//           entry, and the ones that pass are inserted one by one in column
//           order (insert position = count of entries <= the candidate, so
//           equal partials keep the lower index first).  After the first
//           tiles almost every candidate fails the test, so the merge costs a
//           few percent of the products.  p <= 128 (kMaxP).
// Ragged n, k and d are masked in the loads (zeros) and the epilogue (columns
// >= k are never candidates); no sentinel padding is needed.  Launches on the
// caller's stream, allocates nothing.

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

using repro_torch::kFullMask;

constexpr int BM = 128;           // rows of X per CTA
constexpr int BN = 128;           // centroids per tile
constexpr int BK = 8;             // depth per shared-memory slice
constexpr int kThreads = 256;
constexpr int kMaxP = 128;
constexpr int kStride = BN + 4;   // staging row stride (floats, 16B aligned)

// Thread t holds rows/cols {4*g + i, 64 + 4*g + i : i < 4} of the tile, with
// g = t / 16 for rows and t % 16 for columns.
__device__ __forceinline__ int sub(int g, int i) {
  return i < 4 ? 4 * g + i : 64 + 4 * g + (i - 4);
}

// Thread t loads row r0 + t/2, depth e0 + 4*(t%2) .. +3 of M (rows x d),
// zeros outside.  kVec: d % 4 == 0 and M 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ float4 load_slice(const float* __restrict__ M,
                                             int rows, int d, int r0,
                                             int e0) {
  const int r = r0 + (threadIdx.x >> 1);
  const int e = e0 + (threadIdx.x & 1) * 4;
  if (r >= rows) return make_float4(0.f, 0.f, 0.f, 0.f);
  return repro_torch::load4<kVec>(M + (size_t)r * d, e, d);
}

__device__ __forceinline__ void store_slice(float (*S)[BM], float4 v) {
  const int r = threadIdx.x >> 1, e = (threadIdx.x & 1) * 4;
  S[e + 0][r] = v.x;
  S[e + 1][r] = v.y;
  S[e + 2][r] = v.z;
  S[e + 3][r] = v.w;
}

// Insert (v, id) into the sorted list (ld, li) of length p; the caller has
// checked v < ld[p-1].  Whole warp, uniform arguments.
__device__ __forceinline__ void list_insert(float* ld, int* li, int p,
                                            float v, int id, int lane) {
  int cnt = 0;
  for (int j = lane; j < p; j += 32) cnt += ld[j] <= v;
  const int pos = __reduce_add_sync(kFullMask, cnt);
  float tv[kMaxP / 32];
  int ti[kMaxP / 32];
#pragma unroll
  for (int s = 0; s < kMaxP / 32; ++s) {
    const int j = lane + 32 * s;
    if (j > pos && j < p) { tv[s] = ld[j - 1]; ti[s] = li[j - 1]; }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kMaxP / 32; ++s) {
    const int j = lane + 32 * s;
    if (j > pos && j < p) { ld[j] = tv[s]; li[j] = ti[s]; }
    if (j == pos) { ld[j] = v; li[j] = id; }
  }
  __syncwarp();
}

template <bool kTopP, bool kVec>
__global__ void __launch_bounds__(kThreads, kTopP ? 1 : 2)
centroid_kernel(const float* __restrict__ X, const float* __restrict__ C,
                const float* __restrict__ csq, const float* __restrict__ xsq,
                int* __restrict__ out_i, float* __restrict__ out_d, int n,
                int k, int d, int p) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  extern __shared__ __align__(16) float dyn[];  // probe: staging + lists
  float* Ps = dyn;                               // [BM][kStride]
  float* Ld = dyn + BM * kStride;                // [BM][p]
  int* Li = reinterpret_cast<int*>(Ld + BM * p); // [BM][p]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * BM;
  const int nE = (d + BK - 1) / BK;
  const int steps = nE * ((k + BN - 1) / BN);

  float best[8];
  int bidx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) { best[i] = INFINITY; bidx[i] = INT_MAX; }
  if (kTopP) {
    for (int i = tid; i < BM * p; i += kThreads) { Ld[i] = INFINITY; Li[i] = -1; }
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 pa = load_slice<kVec>(X, n, d, r0, 0);
  float4 pb = load_slice<kVec>(C, k, d, 0, 0);
  store_slice(As[0], pa);
  store_slice(Bs[0], pb);
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    const int jt = s / nE, ec = s - jt * nE;
    const bool more = s + 1 < steps;
    if (more) {
      const int jt1 = (s + 1) / nE, ec1 = (s + 1) - jt1 * nE;
      pa = load_slice<kVec>(X, n, d, r0, ec1 * BK);
      pb = load_slice<kVec>(C, k, d, jt1 * BN, ec1 * BK);
    }
#pragma unroll
    for (int e = 0; e < BK; ++e) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][e][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][e][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][e][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][e][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {  // buf^1 was last read before the barrier ending step s-1
      store_slice(As[buf ^ 1], pa);
      store_slice(Bs[buf ^ 1], pb);
    }
    if (ec == nE - 1) {  // centroid tile jt complete: fold it in
      const int c0 = jt * BN;
      if (!kTopP) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + sub(tx, j);
          if (col < k) {
            const float c2 = csq[col];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float v = c2 - 2.f * acc[i][j];
              if (v < best[i] || (v == best[i] && col < bidx[i])) {
                best[i] = v;
                bidx[i] = col;
              }
            }
          }
        }
      } else {
        float c2[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + sub(tx, j);
          c2[j] = col < k ? csq[col] : INFINITY;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float* prow = Ps + sub(ty, i) * kStride;
          *reinterpret_cast<float4*>(prow + 4 * tx) = make_float4(
              c2[0] - 2.f * acc[i][0], c2[1] - 2.f * acc[i][1],
              c2[2] - 2.f * acc[i][2], c2[3] - 2.f * acc[i][3]);
          *reinterpret_cast<float4*>(prow + 64 + 4 * tx) = make_float4(
              c2[4] - 2.f * acc[i][4], c2[5] - 2.f * acc[i][5],
              c2[6] - 2.f * acc[i][6], c2[7] - 2.f * acc[i][7]);
        }
        __syncthreads();
        for (int rr = 0; rr < BM / 8; ++rr) {
          const int row = warp * (BM / 8) + rr;
          if (r0 + row >= n) break;  // warp-uniform
          float* ld = Ld + row * p;
          int* li = Li + row * p;
          float thr = ld[p - 1];
          for (int s4 = 0; s4 < BN / 32; ++s4) {
            const float v = Ps[row * kStride + s4 * 32 + lane];  // inf past k
            unsigned m = __ballot_sync(kFullMask, v < thr);
            while (m) {
              const int src = __ffs(m) - 1;
              m &= m - 1;
              const float cv = __shfl_sync(kFullMask, v, src);
              if (!(cv < thr)) continue;  // uniform: thr, cv shared
              list_insert(ld, li, p, cv, c0 + s4 * 32 + src, lane);
              thr = ld[p - 1];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    __syncthreads();
  }

  if (!kTopP) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = best[i];
      int b = bidx[i];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {  // the 16 threads sharing the row
        const float ov = __shfl_xor_sync(kFullMask, v, o);
        const int ob = __shfl_xor_sync(kFullMask, b, o);
        if (ov < v || (ov == v && ob < b)) { v = ov; b = ob; }
      }
      const int row = r0 + sub(ty, i);
      if (tx == 0 && row < n) {
        out_i[row] = b == INT_MAX ? -1 : b;
        out_d[row] = b == INT_MAX ? INFINITY : fmaxf(v + xsq[row], 0.f);
      }
    }
  } else {
    for (int rr = 0; rr < BM / 8; ++rr) {
      const int row = warp * (BM / 8) + rr;
      if (r0 + row >= n) break;
      const float x2 = xsq[r0 + row];
      for (int j = lane; j < p; j += 32) {
        const int id = Li[row * p + j];
        out_i[(size_t)(r0 + row) * p + j] = id;
        out_d[(size_t)(r0 + row) * p + j] =
            id < 0 ? INFINITY : fmaxf(Ld[row * p + j] + x2, 0.f);
      }
    }
  }
}

template <bool kTopP>
cudaError_t launch(bool vec, int n, int k, int d, int p, const float* X,
                   const float* C, const float* csq, const float* xsq,
                   int* out_i, float* out_d, cudaStream_t st) {
  auto kern = vec ? centroid_kernel<kTopP, true> : centroid_kernel<kTopP, false>;
  const size_t smem =
      kTopP ? ((size_t)BM * kStride + 2 * (size_t)BM * p) * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n + BM - 1) / BM), block(kThreads);
  kern<<<grid, block, smem, st>>>(X, C, csq, xsq, out_i, out_d, n, k, d, p);
  return cudaGetLastError();
}

bool vec_ok(int d, const void* X, const void* C) {
  return d % 4 == 0 && repro_torch::aligned16(X) && repro_torch::aligned16(C);
}

}  // namespace

// C interface, loaded with ctypes.  Each returns the cudaError_t of its
// launch (0 = success; -1 for p outside [1, min(k, 128)]).  Device pointers
// of contiguous tensors: X (n, d) f32, C (k, d) f32, csq (k,) f32 =
// ||C_j||², xsq (n,) f32 = ||X_i||².
//   assign: out_i (n,) i32 nearest centroid, out_d (n,) f32 its d2.
//   probe:  out_i (n, p) i32 ascending, out_d (n, p) f32.
extern "C" int assign_centroids_launch(const void* X, const void* C,
                                       const void* csq, const void* xsq,
                                       void* out_i, void* out_d, int n,
                                       int k, int d, void* stream) {
  if (n <= 0) return 0;
  cudaGetLastError();  // clear a stale error so the result below is ours
  return static_cast<int>(launch<false>(
      vec_ok(d, X, C), n, k, d, 0, static_cast<const float*>(X),
      static_cast<const float*>(C), static_cast<const float*>(csq),
      static_cast<const float*>(xsq), static_cast<int*>(out_i),
      static_cast<float*>(out_d), static_cast<cudaStream_t>(stream)));
}

extern "C" int probe_centroids_launch(const void* X, const void* C,
                                      const void* csq, const void* xsq,
                                      void* out_i, void* out_d, int n, int k,
                                      int d, int p, void* stream) {
  if (p < 1 || p > kMaxP || p > k) return -1;
  if (n <= 0) return 0;
  cudaGetLastError();
  return static_cast<int>(launch<true>(
      vec_ok(d, X, C), n, k, d, p, static_cast<const float*>(X),
      static_cast<const float*>(C), static_cast<const float*>(csq),
      static_cast<const float*>(xsq), static_cast<int*>(out_i),
      static_cast<float*>(out_d), static_cast<cudaStream_t>(stream)));
}
