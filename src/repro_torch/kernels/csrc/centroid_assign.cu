// centroid_assign: the top-p nearest centroids (probe) of every row of X.
//
// Replaces the TPU kernel src/repro/kernels/centroid_assign.py
// ::probe_centroids (Pallas; pl.pallas_call at :118, body _probe_kernel at
// :74 with the in-kernel _select_topk at :52).  Same function: for each row
// x the partial distance part_j = ||c_j||² − 2 x·c_j to every centroid,
// with ||c||² hoisted once per call (the wrapper passes it), the p smallest
// partials ascending, ties to the lower index, then d2 = max(part + ||x||²,
// 0) in that op order.  The reference's order: the running list comes
// before each new centroid tile and a new candidate replaces an entry only
// when strictly smaller (centroid_assign.py:93-98).  (The nearest centroid
// alone, assign_centroids, is csrc/assign_centroids.cu.)
//
// Bound on an H100 SXM: the products.  n·k·d FMAs (2·n·k·d flops) against
// (n + k)·d·4 bytes: a served batch of 64 rows at k = 16,384, d = 128 is
// 268 MFLOP (4 us at the 67 TFLOP/s f32 rate) against 8.4 MB (2.5 us).
// TF32 tensor cores would be 7x faster but round the inputs to 10 mantissa
// bits, and the ranking depends on full f32, so the products stay on FP32
// FMAs.
//
// probe: split and merge.  A served batch is 64 rows, so a CTA per row tile
// walking all k centroids would put the whole call on one SM of 132.  The
// centroid range is cut into S chunks of K_s centroids instead (the wrapper's
// split plan picks the row tile, S and K_s from n, k, p and the SM count):
//   pass 1 (probe_partial_kernel<TM>): CTA (r, s) of 256 threads owns a
//     row tile of 16·TM rows (TM = 4: 64 rows, for small n; TM = 8: 128)
//     and centroids [s·K_s, (s+1)·K_s) in tiles of 128.  Depth slices of 16
//     of both tiles are staged by cp.async in a 3-stage ring (two slices in
//     flight while one is multiplied), transposed on the way in (4-byte
//     copies, sixteen threads to a row's 64 contiguous bytes) so that thread
//     (ty, tx) reads its TM rows and 8 centroids of one depth as float4s
//     and accumulates a TM x 8 block of FP32 FMAs.  After a tile's last slice its partials go through shared
//     memory half a tile (64 centroids) at a time, and each warp folds its
//     rows into their sorted top-p lists (merge_tile_row: the candidates
//     below the row's p-th entry are ranked against each other and the list
//     in parallel and written at their ranks; the result is what inserting
//     them one by one in column order, at the count of entries <= the
//     candidate, leaves).  At the end the CTA writes its chunk's raw lists
//     (value, id) to the scratch (n, S, p), or, when S = 1, the finished d2
//     and ids.  __launch_bounds__(256, 2): two CTAs share an SM.
//   pass 2 (probe_merge_kernel, only when S > 1): the S lists of each row
//     are merged in chunk order (common.cuh merge_row: whole-list stable
//     merges, the running list first on ties, by one warp per row for a few
//     lists and by a CTA of up to 8 warps in a two-level tree for many),
//     then d2 is finalized once.
// Why the order holds: a chunk's list is its stable top-p (ties in column
// order); any centroid outside it has p entries of its chunk ahead of it, so
// it is outside the global top-p too; merging in chunk order with the
// earlier entry first on ties never lets an equal value displace an earlier
// one.  So the lists equal a single pass's bit for bit, for any S.
// Ragged n, k and d are zero-filled by the copies and masked in the epilogue
// (columns past the chunk or k are never candidates).  p <= 128 (kMaxP).
// Both passes launch on the caller's stream and allocate nothing.

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

using repro_torch::kFullMask;

constexpr int kMaxP = 128;

// Thread t holds rows/cols {4*g + i, 64 + 4*g + i : i < 4} of the tile, with
// g = t / 16 for rows and t % 16 for columns.
__device__ __forceinline__ int sub(int g, int i) {
  return i < 4 ? 4 * g + i : 64 + 4 * g + (i - 4);
}

// ------------------------------------------------------------------- probe

// Pass-1 tiles: 256 threads, thread (ty, tx) = (t / 16, t % 16) holds rows
// sub(ty, i) (i < TM) of a (16·TM)-row tile (TM = 4: 64 rows for small n,
// TM = 8: 128 rows) and centroids sub(tx, j) (j < 8) of a PN = 128 tile,
// (the register-blocked layout of a classic SGEMM); the slices sit in shared memory depth-major
// (transposed), so each thread reads its rows and centroids of one depth as
// float4s.
constexpr int PN = 128;                // centroids per tile
constexpr int PK = 16;                 // depth per pipeline stage
constexpr int kStages = 3;
constexpr int kPThreads = 256;
constexpr int kPsStride = 64 + 4;      // staging row: half a tile, float4s

template <int TM>
__host__ __device__ constexpr int rows_pad() { return 16 * TM + 4; }

// Floats of one ring stage: a PK-deep slice of the row tile and of the
// centroid tile, depth-major, rows padded by 4 (conflict-free async writes).
template <int TM>
__host__ __device__ constexpr int stage_floats() {
  return PK * (rows_pad<TM>() + PN + 4);
}

// Shared memory of a pass-1 CTA: the ring, the partials staging (half a
// tile) and the lists.
template <int TM>
constexpr size_t pass1_smem(int p) {
  return ((size_t)kStages * stage_floats<TM>() + 16 * TM * kPsStride +
          2 * (size_t)16 * TM * p) * sizeof(float);
}

// Merge half a tile's 64 partials of a row (prow, centroids col0 .. col0+63
// in order) into the row's sorted list (ld, li) of length p: the stable top-p
// of the two, the list's entries ahead of equal tile values and equal tile
// values in column order, which is what inserting the candidates one by one
// in column order (at the count of entries <= v, only when strictly below
// the p-th entry) leaves.  Whole warp.  Candidates at or above the p-th
// entry cannot enter and are dropped by ballots; the rest are compacted in
// column order into (sv, si) and every survivor and list entry computes its
// rank in the merged list in parallel (survivors: the earlier survivors
// below or equal to it plus the list entries <= it, by binary search; list
// entries: their index plus the survivors strictly below), then the ranks
// below p are written.  No serial insert chain.
__device__ __forceinline__ void merge_tile_row(const float* prow, int col0,
                                               float* ld, int* li, int p,
                                               float* sv, int* si, int lane) {
  constexpr int Q = 64 / 32;
  const float thr = ld[p - 1];
  float v[Q];
  unsigned m[Q];
  int base[Q + 1];
  base[0] = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    v[q] = prow[32 * q + lane];
    m[q] = __ballot_sync(kFullMask, v[q] < thr);
    base[q + 1] = base[q] + __popc(m[q]);
  }
  const int ns = base[Q];
  if (ns == 0) return;  // warp-uniform
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (v[q] < thr) {
      const int o = base[q] + __popc(m[q] & below);
      sv[o] = v[q];
      si[o] = col0 + 32 * q + lane;
    }
  }
  __syncwarp();
  float cv[Q], lv[kMaxP / 32];
  int ci[Q], cpos[Q], lid[kMaxP / 32], lpos[kMaxP / 32];
#pragma unroll
  for (int t = 0; t < Q; ++t) {
    const int q = lane + 32 * t;
    cpos[t] = p;  // not written
    if (q < ns) {
      const float x = sv[q];
      int r = 0;
      for (int o = 0; o < ns; ++o) {
        const float w = sv[o];
        r += (w < x) || (w == x && o < q);
      }
      int lo = 0, hi = p;  // list entries <= x
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ld[mid] <= x) lo = mid + 1; else hi = mid;
      }
      cv[t] = x;
      ci[t] = si[q];
      cpos[t] = r + lo;
    }
  }
  // an empty list (the chunk's first candidates) keeps its +inf / -1
  // entries where they are: no list entry needs to move
  const bool empty = !(ld[0] < INFINITY);
#pragma unroll
  for (int u = 0; u < kMaxP / 32; ++u) {
    const int i = lane + 32 * u;
    lpos[u] = p;
    if (i < p && !empty) {
      const float w = ld[i];
      int c = 0;
      for (int o = 0; o < ns; ++o) c += sv[o] < w;
      lv[u] = w;
      lid[u] = li[i];
      lpos[u] = i + c;
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < Q; ++t)
    if (cpos[t] < p) { ld[cpos[t]] = cv[t]; li[cpos[t]] = ci[t]; }
#pragma unroll
  for (int u = 0; u < kMaxP / 32; ++u)
    if (lpos[u] < p) { ld[lpos[u]] = lv[u]; li[lpos[u]] = lid[u]; }
  __syncwarp();
}

// Copy depth slice [e0, e0 + PK) of rows [r0, r0 + R) of M (rows x d)
// into dst transposed: dst[e * stride + r], zero-filled past rows and d.
// 4-byte copies, PK threads to a row's slice (64 contiguous bytes).
template <int R>
__device__ __forceinline__ void stage_slice(float* dst, int stride,
                                            const float* __restrict__ M,
                                            int rows, int d, int r0, int e0) {
#pragma unroll
  for (int c = threadIdx.x; c < R * PK; c += kPThreads) {
    const int r = c / PK, e = c % PK;
    const bool ok = r0 + r < rows && e0 + e < d;
    const float* src = ok ? M + (size_t)(r0 + r) * d + e0 + e : M;
    repro_torch::cp_async4(dst + e * stride + r, src, ok ? 4 : 0);
  }
}

template <int TM>
__global__ void __launch_bounds__(kPThreads, 2)
probe_partial_kernel(const float* __restrict__ X, const float* __restrict__ C,
                     const float* __restrict__ csq,
                     const float* __restrict__ xsq, int* __restrict__ out_i,
                     float* __restrict__ out_d, float* __restrict__ part_v,
                     int* __restrict__ part_i, int n, int k, int d, int p,
                     int chunk, int splits) {
  constexpr int PM = 16 * TM;                       // rows of X per CTA
  constexpr int kA = rows_pad<TM>(), kB = PN + 4;   // slice row strides
  constexpr int kStageFloats = stage_floats<TM>();
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                               // [kStages][kStageFloats]
  float* Ps = ring + kStages * kStageFloats;        // [PM][kPsStride]
  float* Ld = Ps + PM * kPsStride;                  // [PM][p]
  int* Li = reinterpret_cast<int*>(Ld + PM * p);    // [PM][p]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * PM;
  const int s = blockIdx.y;
  const int c0 = s * chunk, c1 = min(c0 + chunk, k);
  const int nE = (d + PK - 1) / PK;
  const int steps = nE * ((c1 - c0 + PN - 1) / PN);

  for (int i = tid; i < PM * p; i += kPThreads) {
    Ld[i] = INFINITY;
    Li[i] = -1;
  }

  // step st stages depth slice st % nE of centroid tile st / nE
  auto stage_step = [&](int st) {
    if (st < steps) {
      const int t = st / nE, e0 = (st - t * nE) * PK;
      float* buf = ring + (st % kStages) * kStageFloats;
      stage_slice<PM>(buf, kA, X, n, d, r0, e0);
      stage_slice<PN>(buf + PK * kA, kB, C, c1, d, c0 + t * PN, e0);
    }
    repro_torch::cp_async_commit();   // possibly empty: uniform group count
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) stage_step(st);
  for (int st = 0; st < steps; ++st) {
    repro_torch::cp_async_wait<kStages - 2>();   // step st has landed
    // every thread's copies of step st are visible, and every thread is done
    // with the buffer that step st + kStages - 1 refills
    __syncthreads();
    stage_step(st + kStages - 1);
    const float* As = ring + (st % kStages) * kStageFloats;
    const float* Bs = As + PK * kA;
#pragma unroll
    for (int e = 0; e < PK; ++e) {
      float a[TM];
      const float4 a0 = *reinterpret_cast<const float4*>(As + e * kA + 4 * ty);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      if constexpr (TM == 8) {
        const float4 a1 =
            *reinterpret_cast<const float4*>(As + e * kA + 64 + 4 * ty);
        a[TM - 4] = a1.x; a[TM - 3] = a1.y; a[TM - 2] = a1.z; a[TM - 1] = a1.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + e * kB + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + e * kB + 64 + 4 * tx);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    const int t = st / nE;
    if (st - t * nE == nE - 1) {   // centroid tile t complete: fold it in
      const int t0 = c0 + t * PN;
      // the survivors go to the stage just multiplied: it is refilled only
      // after the next step's barrier, which every warp reaches after this
      float* sv = ring + (st % kStages) * kStageFloats + warp * 128;
      int* si = reinterpret_cast<int*>(sv + 64);
#pragma unroll
      for (int h = 0; h < 2; ++h) {      // tile columns [64h, 64h + 64)
        float c2[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = t0 + 64 * h + 4 * tx + j;
          c2[j] = col < c1 ? csq[col] : INFINITY;
        }
        if (h == 1) __syncthreads();     // the first half's merges are done
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float* ac = acc[i] + 4 * h;
          *reinterpret_cast<float4*>(Ps + sub(ty, i) * kPsStride + 4 * tx) =
              make_float4(c2[0] - 2.f * ac[0], c2[1] - 2.f * ac[1],
                          c2[2] - 2.f * ac[2], c2[3] - 2.f * ac[3]);
        }
        __syncthreads();
        for (int rr = 0; rr < PM / 8; ++rr) {
          const int row = warp * (PM / 8) + rr;
          if (r0 + row >= n) break;  // warp-uniform
          merge_tile_row(Ps + row * kPsStride, t0 + 64 * h, Ld + row * p,
                         Li + row * p, p, sv, si, lane);
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
  }
  repro_torch::cp_async_wait<0>();
  __syncthreads();   // lists initialised by all threads, merged by warps

  for (int rr = 0; rr < PM / 8; ++rr) {
    const int row = warp * (PM / 8) + rr;
    if (r0 + row >= n) break;
    const size_t g = (size_t)(r0 + row);
    const float* ld = Ld + row * p;
    const int* li = Li + row * p;
    if (splits == 1) {
      repro_torch::write_final_row(ld, li, p, xsq[g], false, out_i + g * p,
                                   out_d + g * p, lane);
    } else {
      const size_t o = (g * splits + s) * p;
      for (int j = lane; j < p; j += 32) {
        part_v[o + j] = ld[j];
        part_i[o + j] = li[j];
      }
    }
  }
}

// W warps per row (common.cuh merge_row): with W = 1, four rows a CTA.
__global__ void __launch_bounds__(repro_torch::kMergeMaxWarps * 32)
probe_merge_kernel(const float* __restrict__ part_v,
                   const int* __restrict__ part_i,
                   const float* __restrict__ xsq, int* __restrict__ out_i,
                   float* __restrict__ out_d, int n, int splits, int p,
                   int W) {
  extern __shared__ __align__(16) float smem[];
  const size_t row = (size_t)blockIdx.x * repro_torch::merge_cta_rows(W) +
                     (W == 1 ? threadIdx.x >> 5 : 0);
  if (row >= (size_t)n) return;  // whole warp; W = 1 has no block barrier
  const size_t o = row * splits * p;
  const float* l = repro_torch::merge_row(part_v + o, part_i + o, splits, p,
                                          W, smem);
  if (l == nullptr) return;
  repro_torch::write_final_row(l, reinterpret_cast<const int*>(l + p), p,
                               xsq[row], false, out_i + row * p,
                               out_d + row * p, threadIdx.x & 31);
}

cudaError_t allow_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of its launches
// (0 = success; -1 for invalid arguments).  Device pointers of contiguous
// tensors: X (n, d) f32, C (k, d) f32, csq (k,) f32 = ||C_j||², xsq (n,)
// f32 = ||X_i||²; out_i (n, p) i32 ascending, out_d (n, p) f32; 1 <= p <=
// min(k, 128).  Row tiles of rows = 64 or 128; the centroids are cut into
// splits = ceil(k / chunk) chunks (chunk >= 1); with splits > 1, part_v
// (n, splits, p) f32 and part_i (n, splits, p) i32 are scratch for the
// partial lists and a second launch merges them.
extern "C" int probe_centroids_launch(const void* X, const void* C,
                                      const void* csq, const void* xsq,
                                      void* out_i, void* out_d, void* part_v,
                                      void* part_i, int n, int k, int d,
                                      int p, int rows, int chunk, int splits,
                                      void* stream) {
  if (p < 1 || p > kMaxP || p > k || (rows != 64 && rows != 128) ||
      chunk < 1 || splits > 65535 ||
      splits != (k + chunk - 1) / chunk ||
      (splits > 1 && (part_v == nullptr || part_i == nullptr)))
    return -1;
  if (n <= 0) return 0;
  cudaGetLastError();
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xsqf = static_cast<const float*>(xsq);
  auto* oi = static_cast<int*>(out_i);
  auto* od = static_cast<float*>(out_d);
  auto* pv = static_cast<float*>(part_v);
  auto* pi = static_cast<int*>(part_i);
  auto kern = rows == 64 ? probe_partial_kernel<4> : probe_partial_kernel<8>;
  const size_t smem = rows == 64 ? pass1_smem<4>(p) : pass1_smem<8>(p);
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3((n + rows - 1) / rows, splits), dim3(kPThreads), smem, st>>>(
      static_cast<const float*>(X), static_cast<const float*>(C),
      static_cast<const float*>(csq), xsqf, oi, od, pv, pi, n, k, d, p, chunk,
      splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int W = repro_torch::merge_warps(splits, p);
  const int R = repro_torch::merge_cta_rows(W);
  const size_t smem2 = (size_t)R * W * repro_torch::merge_warp_floats(p) *
                       sizeof(float);
  e = allow_smem(reinterpret_cast<const void*>(probe_merge_kernel), smem2);
  if (e != cudaSuccess) return static_cast<int>(e);
  probe_merge_kernel<<<dim3((n + R - 1) / R), dim3(R * W * 32), smem2, st>>>(
      pv, pi, xsqf, oi, od, n, splits, p, W);
  return static_cast<int>(cudaGetLastError());
}
