// ivf_scan: per-query scan of the probed inverted-list tiles with a running
// top-k, for the IVF index's search.
//
// Replaces the TPU kernel src/repro/kernels/ivf_scan.py::ivf_scan (Pallas;
// pl.pallas_call at :99, body _kernel at :35).  Same function: query q walks
// the T packed tiles named in tile_map[q] (block_rows rows each, in slot
// order), scores each row v as ||v||² − 2 q·v (+inf where pids < 0: holes,
// tombstones, the null tile), and keeps the k smallest with the reference's
// order — the running list before each new tile, rows in row order, a new
// candidate entering only when strictly smaller than the k-th entry
// (ivf_scan.py:52-61).  Out: ids (-1 past the candidate count) and, unless
// raw, d2 = max(part + ||q||², 0) in finalize_d2's op order
// (repro/kernels/ref.py:78-92); raw returns the partials (+inf at -1 slots).
//
// Bound on an H100 SXM: the rows read.  Each live row costs d·4 bytes and 2d
// flops (4d with ||v||²), far below the f32 compute rate.  At nq = 10,000,
// nprobe = 16 on the SIFT1M-shaped index (k = 16,384) a query's probed
// lists hold about 1,000 live rows (measured by chip_smoke.py: the nearest
// cells are larger than the 61-row average), so about 5.1 GB of rows:
// 1.53 ms at 3.35 TB/s if every query's rows came from HBM.
//
// Design: one CTA of 8 warps per query.  The query stays in registers as each
// lane's float4 slices (common.cuh WarpVec); a warp takes one row at a time,
// four rows in flight, each row read coalesced, and reduces q·v and v·v with
// warp shuffles.  A row whose id is -1 is never loaded, so the null tile and
// the holes cost their ids only; a slot that repeats the previous slot's tile
// when that tile had no live row is skipped outright (the null-tile padding
// that `T = nprobe · max_list_tiles` puts after every short list).  After
// each tile the partials sit in shared memory and warp 0 merges them into
// the sorted top-k list (shared memory): 32 candidates at a time are tested
// against the k-th entry and the ones that pass are inserted in row order
// (insert position = count of entries <= the candidate, so an equal partial
// never displaces an earlier one).  topk <= 1024.  A tile index outside
// [0, n_pad / block_rows) contributes nothing.  Launches on the caller's
// stream, allocates nothing.

#include <math.h>

#include "common.cuh"

namespace {

using repro_torch::dot4;
using repro_torch::kMaxTopk;
using repro_torch::load4;
using repro_torch::merge_candidates;
using repro_torch::WarpVec;
using repro_torch::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsInFlight = 4;

// This lane's share of (q·v, v·v) for row v.
template <int NS, bool kAligned>
__device__ __forceinline__ void dot_sq(const WarpVec<NS, kAligned>& qv,
                                       const float* __restrict__ row, int d,
                                       int lane, float& dot, float& sq) {
  dot = 0.f;
  sq = 0.f;
  if (NS > 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float4 r = load4<kAligned>(row, (s * 32 + lane) * 4, d);
      dot += dot4(qv.v[s], r);
      sq += dot4(r, r);
    }
  } else {
    for (int e = lane * 4; e < d; e += 128) {
      const float4 r = load4<kAligned>(row, e, d);
      dot += dot4(load4<kAligned>(qv.base, e, d), r);
      sq += dot4(r, r);
    }
  }
}

template <int NS, bool kAligned>
__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const float* __restrict__ Q, const float* __restrict__ vecs,
                const int* __restrict__ pids,
                const int* __restrict__ tile_map, int* __restrict__ out_i,
                float* __restrict__ out_d, int T, int d, int block_rows,
                int n_tiles, int topk, int raw) {
  extern __shared__ float smem[];
  float* part = smem;                                        // [block_rows]
  int* cid = reinterpret_cast<int*>(part + block_rows);      // [block_rows]
  float* ld = reinterpret_cast<float*>(cid + block_rows);    // [topk]
  int* li = reinterpret_cast<int*>(ld + topk);               // [topk]

  const int q = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* qrow = Q + (size_t)q * d;
  WarpVec<NS, kAligned> qv;
  qv.load(qrow, d, lane);
  for (int j = threadIdx.x; j < topk; j += kThreads) {
    ld[j] = INFINITY;
    li[j] = -1;
  }
  __syncthreads();

  const int* tm = tile_map + (size_t)q * T;
  int prev = -1;
  bool prev_empty = false;
  for (int t = 0; t < T; ++t) {
    const int tile = tm[t];
    if (tile < 0 || tile >= n_tiles || (tile == prev && prev_empty)) continue;
    const size_t base = (size_t)tile * block_rows;
    int any = 0;
    for (int r0 = warp; r0 < block_rows; r0 += kWarps * kRowsInFlight) {
      int id[kRowsInFlight];
      float dot[kRowsInFlight], sq[kRowsInFlight];
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) {
        const int r = r0 + j * kWarps;
        id[j] = r < block_rows ? pids[base + r] : -1;
        if (id[j] >= 0) {
          dot_sq(qv, vecs + (base + r) * d, d, lane, dot[j], sq[j]);
        } else {
          dot[j] = 0.f;
          sq[j] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) {
        dot[j] = warp_sum(dot[j]);
        sq[j] = warp_sum(sq[j]);
      }
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kRowsInFlight; ++j) {
          const int r = r0 + j * kWarps;
          if (r < block_rows) {
            part[r] = id[j] < 0 ? INFINITY : sq[j] - 2.f * dot[j];
            cid[r] = id[j];
            any |= id[j] >= 0;
          }
        }
      }
    }
    const int live = __syncthreads_or(any);  // also publishes part / cid
    prev = tile;
    prev_empty = !live;
    if (!live) continue;
    if (warp == 0) merge_candidates(ld, li, topk, part, cid, block_rows, lane);
    __syncthreads();
  }

  const float qsq = warp_sum(qv.partial_dot(qrow, d, lane));
  for (int j = threadIdx.x; j < topk; j += kThreads) {
    const int id = li[j];
    out_i[(size_t)q * topk + j] = id;
    out_d[(size_t)q * topk + j] =
        id < 0 ? INFINITY : (raw ? ld[j] : fmaxf(ld[j] + qsq, 0.f));
  }
}

template <int NS>
cudaError_t launch(bool aligned, int nq, size_t smem, cudaStream_t st,
                   const float* Q, const float* vecs, const int* pids,
                   const int* tile_map, int* out_i, float* out_d, int T,
                   int d, int block_rows, int n_tiles, int topk, int raw) {
  auto kern = aligned ? ivf_scan_kernel<NS, true> : ivf_scan_kernel<NS, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(nq), dim3(kThreads), smem, st>>>(Q, vecs, pids, tile_map, out_i,
                                               out_d, T, d, block_rows,
                                               n_tiles, topk, raw);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 = success; -1 for topk outside [1, 1024] or block_rows < 1).  Device
// pointers of contiguous tensors: Q (nq, d) f32, vecs (n_tiles*block_rows,
// d) f32, pids (n_tiles*block_rows,) i32, tile_map (nq, T) i32, out_i (nq,
// topk) i32, out_d (nq, topk) f32.
extern "C" int ivf_scan_launch(const void* Q, const void* vecs,
                               const void* pids, const void* tile_map,
                               void* out_i, void* out_d, int nq, int T, int d,
                               int block_rows, int n_tiles, int topk, int raw,
                               void* stream) {
  if (topk < 1 || topk > kMaxTopk || block_rows < 1) return -1;
  if (nq <= 0) return 0;
  cudaGetLastError();  // clear a stale error so the result below is ours
  const size_t smem = (size_t)2 * (block_rows + topk) * sizeof(float);
  const bool aligned = d % 4 == 0 && repro_torch::aligned16(Q) &&
                       repro_torch::aligned16(vecs);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* Qf = static_cast<const float*>(Q);
  const auto* Vf = static_cast<const float*>(vecs);
  const auto* P = static_cast<const int*>(pids);
  const auto* TM = static_cast<const int*>(tile_map);
  auto* oi = static_cast<int*>(out_i);
  auto* od = static_cast<float*>(out_d);
  cudaError_t e;
  switch (repro_torch::slices_for(d)) {
    case 1: e = launch<1>(aligned, nq, smem, st, Qf, Vf, P, TM, oi, od, T, d, block_rows, n_tiles, topk, raw); break;
    case 2: e = launch<2>(aligned, nq, smem, st, Qf, Vf, P, TM, oi, od, T, d, block_rows, n_tiles, topk, raw); break;
    case 4: e = launch<4>(aligned, nq, smem, st, Qf, Vf, P, TM, oi, od, T, d, block_rows, n_tiles, topk, raw); break;
    case 8: e = launch<8>(aligned, nq, smem, st, Qf, Vf, P, TM, oi, od, T, d, block_rows, n_tiles, topk, raw); break;
    default: e = launch<0>(aligned, nq, smem, st, Qf, Vf, P, TM, oi, od, T, d, block_rows, n_tiles, topk, raw); break;
  }
  return static_cast<int>(e);
}
