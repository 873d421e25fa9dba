// ivf_scan: per-query scan of the probed inverted-list tiles with a running
// top-k, for the IVF index's search.
//
// Replaces the TPU kernel src/repro/kernels/ivf_scan.py::ivf_scan (Pallas;
// pl.pallas_call at :99, body _kernel at :35).  Same function: query q walks
// the T packed tiles named in tile_map[q] (block_rows rows each, in slot
// order), scores each row v as ||v||² − 2 q·v (+inf where pids < 0: holes,
// tombstones, the null tile), and keeps the k smallest with the reference's
// order — slot order, then row order, a candidate entering only when
// strictly smaller than the k-th entry (ivf_scan.py:52-61).  Out: ids (-1
// past the candidate count) and, unless raw, d2 = max(part + ||q||², 0) in
// finalize_d2's op order (repro/kernels/ref.py:78-92); raw returns the
// partials (+inf at -1 slots).
//
// Bound on an H100 SXM: the rows read.  Each live row costs d·4 bytes and 2d
// flops (4d with ||v||²), far below the f32 compute rate.  At nq = 10,000,
// nprobe = 16 on the SIFT1M-shaped index (k = 16,384) a query's probed
// lists hold about 1,000 live rows (measured by chip_smoke.py: the nearest
// cells are larger than the 61-row average), so about 5.1 GB of rows:
// 1.53 ms at 3.35 TB/s if every query's rows came from HBM.  A served batch
// of 64 queries reads ~33 MB of rows, ~10 us: there the latency of a
// query's chain of row loads, not bandwidth, sets the time unless the
// query's work is spread over many SMs.
//
// Design: split and merge, as csrc/ivf_scan_grouped.cu.  The wrapper's split
// plan (ivf_scan.py split_plan: nq, T, topk and the SM count, no device
// read) cuts each query's live slots into S contiguous chunks, S = 1 once
// the queries alone fill the card, else as many as keep pass 1 within one
// wave of 8 CTAs per SM (what pass 1 keeps resident: 32 registers a
// thread).
//   live slots: a slot is live when its tile lies in [0, n_tiles) and holds
//     a live row (pids >= 0).  A slot that repeats the previous slot's tile
//     takes that slot's liveness without reading ids (so the null-tile
//     padding that T = nprobe · max_list_tiles puts after every short list
//     costs one id read per run, as the earlier kernel's skip rule did); a
//     repeated live tile is live twice and scanned twice, as in the
//     reference.  Empty tiles give no candidate, so scanning only the live
//     slots changes no result.  The CTA finds them (common.cuh find_live,
//     shared with csrc/ivf_scan_adc.cu) in segments of 1,024
//     map slots (never holding all T: exhaustive_search passes every tile
//     of the slab, ~16,000 at SIFT1M): warps take 32-slot windows, read the
//     window's map entries coalesced, read the ids of each run's first slot
//     (128 ids, coalesced, up to 8 slots' reads in flight per warp) and
//     ballot them, then a CTA prefix sum compacts the segment's live tiles
//     into shared memory in slot order.  With S > 1 a first sweep counts
//     the query's live slots (for T <= 1,024 that one segment is kept, not
//     found again), and CTA (q, s) takes live slots [s·per, (s+1)·per),
//     per = ceil(live / S).
//   pass 1 (ivf_scan_kernel): CTA (q, s) of 8 warps; the query stays in
//     registers as each lane's float4 slices (common.cuh WarpVec).  The
//     chunk's rows are cut into items of 32 rows (tile, row group), item i
//     to warp i mod 8; a warp reads an item's 32 ids coalesced, ballots the
//     live ones and loads 2 live rows at once (across items), never a hole,
//     and reduces q·v and v·v with warp shuffles in dot_sq's order.  Two
//     rows a warp and 8 CTAs an SM (64 warps, 128 rows in flight per SM)
//     measured faster on the H100 than 4 rows at 4 CTAs or 8 rows at 2: the
//     per-row shuffles, ballots and inserts are hidden by more resident
//     warps, not by more loads per warp.  Each
//     warp keeps its own sorted top-k list in shared memory (insert3:
//     strict insert, position = count of entries <= v; the rank placement
//     at the end is common.cuh place_by_rank), so no warp waits on
//     another's merge; each entry carries its candidate position (slot
//     within the chunk · block_rows + row), increasing along a warp's
//     walk.  At the
//     end every entry's rank in the chunk is its count of entries of the
//     other warps' lists below it by (value, position) plus its own index,
//     found by binary search, and it lands in that slot of the chunk's
//     list: the first k by (value, position) are exactly the strict-insert
//     top-k of the chunk's candidates in order.  The CTA writes the chunk's
//     raw list to the scratch (nq, S, topk), and chunk 0 also ||q||²; with
//     S = 1 it writes the finished result.
//   pass 2 (ivf_scan_merge_kernel, only when S > 1): each query's S lists
//     merged in chunk order (common.cuh merge_row: whole-list stable
//     merges, the running list first on ties), finalized once.
// Chunk order is slot order and the merge keeps the earlier chunk's entry
// first among equal values, so equal partials keep slot order, then row
// order; with each row's arithmetic unchanged (dot_sq), the lists equal
// those of one CTA walking all of the query's slots in order, bit for bit,
// for any S.  topk <= 1024, and T·block_rows and n_pad below 2^31.  A tile
// index outside [0, n_pad / block_rows) contributes nothing.  Launches on
// the caller's stream, allocates nothing.

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

using repro_torch::dot4;
using repro_torch::find_live;
using repro_torch::kFullMask;
using repro_torch::kMaxTopk;
using repro_torch::load4;
using repro_torch::place_by_rank;
using repro_torch::WarpVec;
using repro_torch::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPer = 4;              // map slots of a segment per thread
constexpr int kSeg = kPer * kThreads;
constexpr int kRowsInFlight = 2;     // live rows a warp loads at once

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

// Insert (v, id, p) into the warp's sorted list (lv, li, lp) of length k;
// the caller has checked v < lv[k-1].  Whole warp, uniform arguments.  The
// insert position is the count of entries <= v, so an equal value never
// displaces an earlier one.  Blocks of 32 entries shift from the top down,
// each read before it is written.
__device__ __forceinline__ void insert3(float* lv, int* li, int* lp, int k,
                                        float v, int id, int p, int lane) {
  int cnt = 0;
  for (int j = lane; j < k; j += 32) cnt += lv[j] <= v;
  const int at = __reduce_add_sync(kFullMask, cnt);
  for (int s = (k - 1) >> 5; s >= (at >> 5); --s) {
    const int j = lane + 32 * s;
    const bool mv = j > at && j < k;
    float tv = 0.f;
    int ti = 0, tp = 0;
    if (mv) {
      tv = lv[j - 1];
      ti = li[j - 1];
      tp = lp[j - 1];
    }
    __syncwarp();
    if (mv) {
      lv[j] = tv;
      li[j] = ti;
      lp[j] = tp;
    }
    if (j == at) {
      lv[j] = v;
      li[j] = id;
      lp[j] = p;
    }
    __syncwarp();
  }
}

template <int NS, bool kAligned>
__global__ void __launch_bounds__(kThreads, 8)
ivf_scan_kernel(const float* __restrict__ Q, const float* __restrict__ vecs,
                const int* __restrict__ pids,
                const int* __restrict__ tile_map, int* __restrict__ out_i,
                float* __restrict__ out_d, float* __restrict__ part_v,
                int* __restrict__ part_i, float* __restrict__ part_qsq,
                int T, int d, int block_rows, int n_tiles, int topk, int raw,
                int splits) {
  extern __shared__ float4 smem4[];
  __shared__ int wt[kWarps];
  int* seg = reinterpret_cast<int*>(smem4);                  // [kSeg]
  float* wl_v = reinterpret_cast<float*>(seg + kSeg);        // [8][topk]
  int* wl_i = reinterpret_cast<int*>(wl_v + kWarps * topk);  // [8][topk]
  int* wl_p = wl_i + kWarps * topk;                          // [8][topk]
  float* fl_v = reinterpret_cast<float*>(wl_p + kWarps * topk);  // [topk]
  int* fl_i = reinterpret_cast<int*>(fl_v + topk);           // [topk]

  const int q = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qrow = Q + (size_t)q * d;
  WarpVec<NS, kAligned> qv;
  qv.load(qrow, d, lane);
  for (int j = tid; j < kWarps * topk; j += kThreads) {
    wl_v[j] = INFINITY;
    wl_i[j] = -1;
    wl_p[j] = INT_MAX;
  }
  for (int j = tid; j < topk; j += kThreads) {
    fl_v[j] = INFINITY;
    fl_i[j] = -1;
  }
  __syncthreads();

  const int* tm = tile_map + (size_t)q * T;
  const int nseg = (T + kSeg - 1) / kSeg;
  int lo = 0, hi = INT_MAX, kept = -1;   // kept: segment 0's live count
  if (splits > 1) {
    int total = 0;
    for (int sg = 0; sg < nseg; ++sg)
      total += find_live<kWarps, kPer>(tm + sg * kSeg,
                                       min(kSeg, T - sg * kSeg), pids,
                                       block_rows, n_tiles, seg, wt);
    if (nseg == 1) kept = total;
    const int per = (total + splits - 1) / splits;
    lo = min(s * per, total);
    hi = min(lo + per, total);
  }

  float* lv = wl_v + warp * topk;
  int* li = wl_i + warp * topk;
  int* lp = wl_p + warp * topk;
  const int groups = (block_rows + 31) / 32;
  int live_base = 0;
  for (int sg = 0; sg < nseg && live_base < hi; ++sg) {
    const int n = kept >= 0 ? kept
                            : find_live<kWarps, kPer>(
                                  tm + sg * kSeg, min(kSeg, T - sg * kSeg),
                                  pids, block_rows, n_tiles, seg, wt);
    const int a = max(lo - live_base, 0), b = min(hi - live_base, n);
    // the chunk's slots a..b-1 of this segment; positions from the chunk's
    // first slot
    const int pos0 = (live_base + a - lo) * block_rows;
    const int items = max(b - a, 0) * groups;
    int item = warp;
    unsigned mask = 0;
    int cur_row = 0, cur_pos = 0;
    while (true) {
      int row[kRowsInFlight], pos[kRowsInFlight];   // row -1: none
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) {
        while (mask == 0 && item < items) {   // uniform
          const int ti = item / groups, g = item - ti * groups;
          cur_row = seg[a + ti] * block_rows + 32 * g;
          cur_pos = pos0 + ti * block_rows + 32 * g;
          mask = __ballot_sync(kFullMask, 32 * g + lane < block_rows &&
                                              pids[(size_t)cur_row + lane] >= 0);
          item += kWarps;
        }
        row[j] = -1;
        if (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          row[j] = cur_row + src;
          pos[j] = cur_pos + src;
        }
      }
      if (row[0] < 0) break;                  // uniform
      float dot[kRowsInFlight], sq[kRowsInFlight];
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) {
        dot[j] = 0.f;
        sq[j] = 0.f;
        if (row[j] >= 0)
          dot_sq(qv, vecs + (size_t)row[j] * d, d, lane, dot[j], sq[j]);
      }
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) {
        dot[j] = warp_sum(dot[j]);
        sq[j] = warp_sum(sq[j]);
      }
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) {
        const float v = sq[j] - 2.f * dot[j];
        if (row[j] >= 0 && v < lv[topk - 1])
          insert3(lv, li, lp, topk, v, pids[row[j]], pos[j], lane);
      }
    }
    live_base += n;
    __syncthreads();  // seg is found again for the next segment
  }

  // the chunk's list: each warp-list entry at its rank by (value, position)
  __syncthreads();
  place_by_rank<kWarps>(wl_v, wl_i, wl_p, topk, INFINITY, fl_v, fl_i);
  __syncthreads();

  float qsq = 0.f;
  if (!raw && (splits == 1 || s == 0))
    qsq = warp_sum(qv.partial_dot(qrow, d, lane));
  if (splits == 1) {
    for (int j = tid; j < topk; j += kThreads) {
      const int idj = fl_i[j];
      out_i[(size_t)q * topk + j] = idj;
      out_d[(size_t)q * topk + j] =
          idj < 0 ? INFINITY : (raw ? fl_v[j] : fmaxf(fl_v[j] + qsq, 0.f));
    }
  } else {
    const size_t o = ((size_t)q * splits + s) * topk;
    for (int j = tid; j < topk; j += kThreads) {
      part_v[o + j] = fl_v[j];
      part_i[o + j] = fl_i[j];
    }
    if (s == 0 && tid == 0) part_qsq[q] = qsq;
  }
}

// W warps per query (common.cuh merge_row): with W = 1, four queries a CTA.
__global__ void __launch_bounds__(repro_torch::kMergeMaxWarps * 32)
ivf_scan_merge_kernel(const float* __restrict__ part_v,
                      const int* __restrict__ part_i,
                      const float* __restrict__ part_qsq,
                      int* __restrict__ out_i, float* __restrict__ out_d,
                      int rows, int splits, int topk, int raw, int W) {
  extern __shared__ float4 smem4[];
  const size_t row = (size_t)blockIdx.x * repro_torch::merge_cta_rows(W) +
                     (W == 1 ? threadIdx.x >> 5 : 0);
  if (row >= (size_t)rows) return;  // whole warp; W = 1 has no block barrier
  const size_t o = row * splits * topk;
  const float* l = repro_torch::merge_row(part_v + o, part_i + o, splits,
                                          topk, W,
                                          reinterpret_cast<float*>(smem4));
  if (l == nullptr) return;
  repro_torch::write_final_row(l, reinterpret_cast<const int*>(l + topk),
                               topk, part_qsq[row], raw, out_i + row * topk,
                               out_d + row * topk, threadIdx.x & 31);
}

cudaError_t allow_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct Args {
  const float* Q;
  const float* vecs;
  const int* pids;
  const int* tm;
  int* out_i;
  float* out_d;
  float* part_v;
  int* part_i;
  float* part_qsq;
  int T, d, block_rows, n_tiles, topk, raw, splits;
};

template <int NS>
cudaError_t launch(bool aligned, int nq, size_t smem, cudaStream_t st,
                   const Args& a) {
  auto kern = aligned ? ivf_scan_kernel<NS, true> : ivf_scan_kernel<NS, false>;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(nq, a.splits), dim3(kThreads), smem, st>>>(
      a.Q, a.vecs, a.pids, a.tm, a.out_i, a.out_d, a.part_v, a.part_i,
      a.part_qsq, a.T, a.d, a.block_rows, a.n_tiles, a.topk, a.raw,
      a.splits);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launches
// (0 = success; -1 for topk outside [1, 1024], block_rows < 1, d < 1,
// splits outside [1, 65535], T·block_rows or n_tiles·block_rows >= 2^31,
// or missing scratch).
// Device pointers of contiguous tensors: Q (nq, d) f32, vecs
// (n_tiles*block_rows, d) f32, pids (n_tiles*block_rows,) i32, tile_map
// (nq, T) i32, out_i (nq, topk) i32, out_d (nq, topk) f32.  With splits > 1,
// part_v (nq, splits, topk) f32, part_i (nq, splits, topk) i32 and part_qsq
// (nq,) f32 are scratch for the partial lists, and a second launch merges
// them.
extern "C" int ivf_scan_launch(const void* Q, const void* vecs,
                               const void* pids, const void* tile_map,
                               void* out_i, void* out_d, void* part_v,
                               void* part_i, void* part_qsq, int nq, int T,
                               int d, int block_rows, int n_tiles, int topk,
                               int raw, int splits, void* stream) {
  if (topk < 1 || topk > kMaxTopk || block_rows < 1 || d < 1 || T < 0 ||
      splits < 1 || splits > 65535 ||
      (long long)T * block_rows > (long long)INT_MAX ||
      (long long)n_tiles * block_rows > (long long)INT_MAX ||
      (splits > 1 && (!part_v || !part_i || !part_qsq)))
    return -1;
  if (nq <= 0) return 0;
  cudaGetLastError();  // clear a stale error so the result below is ours
  const size_t smem = sizeof(int) * ((size_t)kSeg + 3 * kWarps * topk +
                                     2 * (size_t)topk);
  const bool aligned = d % 4 == 0 && repro_torch::aligned16(Q) &&
                       repro_torch::aligned16(vecs);
  auto st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(Q), static_cast<const float*>(vecs),
               static_cast<const int*>(pids),
               static_cast<const int*>(tile_map), static_cast<int*>(out_i),
               static_cast<float*>(out_d), static_cast<float*>(part_v),
               static_cast<int*>(part_i), static_cast<float*>(part_qsq),
               T, d, block_rows, n_tiles, topk, raw, splits};
  cudaError_t e;
  switch (repro_torch::slices_for(d)) {
    case 1: e = launch<1>(aligned, nq, smem, st, a); break;
    case 2: e = launch<2>(aligned, nq, smem, st, a); break;
    case 4: e = launch<4>(aligned, nq, smem, st, a); break;
    case 8: e = launch<8>(aligned, nq, smem, st, a); break;
    default: e = launch<0>(aligned, nq, smem, st, a); break;
  }
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int W = repro_torch::merge_warps(splits, topk);
  const int R = repro_torch::merge_cta_rows(W);
  const size_t smem2 = (size_t)R * W * repro_torch::merge_warp_floats(topk) *
                       sizeof(float);
  e = allow_smem(reinterpret_cast<const void*>(ivf_scan_merge_kernel), smem2);
  if (e != cudaSuccess) return static_cast<int>(e);
  ivf_scan_merge_kernel<<<dim3((nq + R - 1) / R), dim3(R * W * 32), smem2,
                          st>>>(a.part_v, a.part_i, a.part_qsq, a.out_i,
                                a.out_d, nq, splits, topk, raw, W);
  return static_cast<int>(cudaGetLastError());
}
