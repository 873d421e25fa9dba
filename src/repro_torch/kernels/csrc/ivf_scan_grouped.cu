// ivf_scan_grouped: the query-grouped scan of the IVF index.  G probe-local
// queries walk their group's deduped union of probed tiles together, so a
// list tile that several of them probe is read from memory once per group,
// not once per query.
//
// Replaces the TPU kernel src/repro/kernels/ivf_scan.py::ivf_scan_grouped
// (Pallas; pl.pallas_call at :191, body _grouped_kernel at :109).  Same
// function: group g's queries Qg[g*G .. g*G+G) walk the U union slots
// union_tiles[g] in slot order; query j scores the rows of slot s only when
// qmask[g*G+j, s] != 0, each live row v (pids >= 0) as ||v||² − 2 q·v, and
// keeps the k smallest with the reference's order: union slot order, then
// row order, a candidate entering only when strictly below the k-th entry
// (src/repro/kernels/ref.py:150-205).  Out, in grouped order: ids (-1 past
// the candidate count) and d2 = max(part + ||q||², 0) in finalize_d2's op
// order, or with raw the partials (+inf at -1 slots).
//
// Bound on an H100 SXM: bytes.  Each group reads the live rows of its union
// tiles once (d·4 bytes each) and each query once
// (src/repro/launch/roofline.py:84-93: q·d·4 + (q/G)·union_rows·d·4 plus
// the outputs); the 2d flops per (query, row) pair are far below the f32
// compute rate.
//
// Design: split and merge.  A served batch of 64 queries at G=8 is only 8
// groups, so one CTA per group walking its whole union would leave 124 of
// 132 SMs idle; each group's union is cut into S contiguous slot chunks
// instead (the wrapper's split plan picks S from ngroups, U, topk and the SM
// count; S = 1 once the groups alone fill the card).
//   pass 1 (ivf_scan_grouped_kernel): CTA (g, s) of 8 warps, G <= 8.  The
//     CTA first finds the group's live span: the slots up to the last one
//     any query of the group probed (the null-tile padding sorts last and
//     is never probed, so it is skipped without a slot-by-slot test), and
//     takes chunk s of that span in slot order (ceil(span / S) slots each;
//     ivf_scan_grouped.py slot_chunks computes the same bounds).  The group's queries sit in shared memory
//     (G·d·4 bytes: 4 KB at G=8, d=128), zero-padded to a multiple of 4
//     floats.  Per union slot, G threads read the queries' mask bits; a slot
//     that no query of the group probed is skipped with no row read, as is a
//     slot repeating a tile that had no live row (that skip restarts at the
//     chunk's first slot: one more read of ids, never another result).  A
//     warp takes one row at a time: it reads the id first and never loads a
//     hole, holds the row in registers as each lane's float4 slices (as
//     csrc/ivf_scan.cu holds the query), and reduces ||v||² and the dot with
//     each probing query by warp shuffles.  After each tile warp j merges
//     query j's partials into its own sorted top-k list in shared memory
//     (common.cuh merge_candidates).  At the end the CTA writes each query's
//     raw list (value, id) to the scratch (ngroups·G, S, topk), and chunk 0
//     also ||q||²; with S = 1 it writes the finished result instead.
//   pass 2 (ivf_scan_grouped_merge_kernel, only when S > 1): each grouped
//     row's S lists are merged in chunk order (common.cuh merge_row:
//     whole-list stable merges, the running list first on ties) and
//     finalized once.
// Chunk order is union slot order, and the merge keeps the earlier chunk's
// entry first among equal values (an entry enters only strictly below the
// k-th), so equal partials keep slot order, then row order: the lists equal
// a single pass's bit for bit, for any S.  topk <= 1024 and
// G <= 8; the launch fails (and the wrapper raises) when the lists, queries
// and tile do not fit in shared memory.  Launches on the caller's stream,
// allocates nothing.

#include <math.h>

#include "common.cuh"

namespace {

using repro_torch::dot4;
using repro_torch::kMaxTopk;
using repro_torch::load4;
using repro_torch::merge_candidates;
using repro_torch::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = kWarps;     // one merging warp per query

// Query j's float4 slice at element e (zeros past the padded width dp).
__device__ __forceinline__ float4 query4(const float* qs, int j, int dp,
                                         int e) {
  if (e < dp) return *reinterpret_cast<const float4*>(qs + j * dp + e);
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int NS, bool kAligned>
__global__ void __launch_bounds__(kThreads)
ivf_scan_grouped_kernel(const float* __restrict__ Qg,
                        const float* __restrict__ vecs,
                        const int* __restrict__ pids,
                        const int* __restrict__ union_tiles,
                        const int* __restrict__ qmask,
                        int* __restrict__ out_i, float* __restrict__ out_d,
                        float* __restrict__ part_v, int* __restrict__ part_i,
                        float* __restrict__ part_qsq, int G, int U, int d,
                        int block_rows, int n_tiles, int topk, int raw,
                        int splits) {
  extern __shared__ float4 smem4[];
  const int dp = (d + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem4);               // [G * dp]
  float* part = qs + G * dp;                                 // [G * rows]
  int* cid = reinterpret_cast<int*>(part + G * block_rows);  // [rows]
  float* ld = reinterpret_cast<float*>(cid + block_rows);    // [G * topk]
  int* li = reinterpret_cast<int*>(ld + G * topk);           // [G * topk]
  __shared__ int probed[kMaxGroup];
  __shared__ int span_end;

  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* qg = Qg + (size_t)g * G * d;
  const int* ut = union_tiles + (size_t)g * U;
  const int* qm = qmask + (size_t)g * G * U;
  for (int i = threadIdx.x; i < G * dp; i += kThreads) {
    const int j = i / dp, e = i - j * dp;
    qs[i] = e < d ? qg[(size_t)j * d + e] : 0.f;
  }
  for (int j = threadIdx.x; j < G * topk; j += kThreads) {
    ld[j] = INFINITY;
    li[j] = -1;
  }
  // chunk blockIdx.y of the group's live span: the slots up to the last one
  // any of its queries probed (the null-tile padding after it is skipped
  // without a read)
  if (threadIdx.x == 0) span_end = 0;
  __syncthreads();
  int last = 0;
  for (int j = threadIdx.x; j < G * U; j += kThreads)
    if (qm[j] != 0) last = max(last, j % U + 1);
  last = __reduce_max_sync(repro_torch::kFullMask, last);
  if (lane == 0 && last > 0) atomicMax(&span_end, last);
  __syncthreads();
  const int span = span_end, per = (span + splits - 1) / splits;
  const int s0 = min((int)blockIdx.y * per, span), s1 = min(s0 + per, span);

  int prev = -1;
  bool prev_empty = false;
  for (int s = s0; s < s1; ++s) {
    const int tile = ut[s];
    if (tile < 0 || tile >= n_tiles || (tile == prev && prev_empty)) continue;
    int pm = 0;
    if (threadIdx.x < G) {
      pm = qm[(size_t)threadIdx.x * U + s] != 0;
      probed[threadIdx.x] = pm;
    }
    if (!__syncthreads_or(pm)) continue;     // also publishes probed[]
    const size_t base = (size_t)tile * block_rows;
    int any = 0;
    for (int r = warp; r < block_rows; r += kWarps) {
      const int id = pids[base + r];
      if (id >= 0) {
        const float* row = vecs + (base + r) * d;
        float4 rv[NS > 0 ? NS : 1];
        float sq = 0.f;
        if (NS > 0) {
#pragma unroll
          for (int t = 0; t < NS; ++t) {
            rv[t] = load4<kAligned>(row, (t * 32 + lane) * 4, d);
            sq += dot4(rv[t], rv[t]);
          }
        } else {
          for (int e = lane * 4; e < d; e += 128) {
            const float4 v = load4<kAligned>(row, e, d);
            sq += dot4(v, v);
          }
        }
        sq = warp_sum(sq);
        for (int j = 0; j < G; ++j) {
          float pj = INFINITY;
          if (probed[j]) {                   // uniform across the warp
            float dot = 0.f;
            if (NS > 0) {
#pragma unroll
              for (int t = 0; t < NS; ++t)
                dot += dot4(query4(qs, j, dp, (t * 32 + lane) * 4), rv[t]);
            } else {
              for (int e = lane * 4; e < d; e += 128)
                dot += dot4(query4(qs, j, dp, e), load4<kAligned>(row, e, d));
            }
            pj = sq - 2.f * warp_sum(dot);
          }
          if (lane == 0) part[j * block_rows + r] = pj;
        }
        any = 1;
      } else if (lane == 0) {
        for (int j = 0; j < G; ++j) part[j * block_rows + r] = INFINITY;
      }
      if (lane == 0) cid[r] = id;
    }
    const int live = __syncthreads_or(any);  // also publishes part / cid
    prev = tile;
    prev_empty = !live;
    if (!live) continue;
    if (warp < G && probed[warp])
      merge_candidates(ld + warp * topk, li + warp * topk, topk,
                       part + warp * block_rows, cid, block_rows, lane);
    __syncthreads();
  }

  if (warp < G) {
    const size_t row = (size_t)g * G + warp;
    const float* lw = ld + warp * topk;
    const int* iw = li + warp * topk;
    float qsq = 0.f;
    if (!raw && (splits == 1 || blockIdx.y == 0)) {
      float acc = 0.f;
      for (int e = lane * 4; e < dp; e += 128) {
        const float4 v = query4(qs, warp, dp, e);
        acc += dot4(v, v);
      }
      qsq = warp_sum(acc);
    }
    if (splits == 1) {
      repro_torch::write_final_row(lw, iw, topk, qsq, raw, out_i + row * topk,
                                   out_d + row * topk, lane);
    } else {
      const size_t o = (row * splits + blockIdx.y) * topk;
      for (int j = lane; j < topk; j += 32) {
        part_v[o + j] = lw[j];
        part_i[o + j] = iw[j];
      }
      if (blockIdx.y == 0 && lane == 0) part_qsq[row] = qsq;
    }
  }
}

// W warps per grouped row (common.cuh merge_row): with W = 1, four rows a
// CTA.
__global__ void __launch_bounds__(repro_torch::kMergeMaxWarps * 32)
ivf_scan_grouped_merge_kernel(const float* __restrict__ part_v,
                              const int* __restrict__ part_i,
                              const float* __restrict__ part_qsq,
                              int* __restrict__ out_i,
                              float* __restrict__ out_d, int rows, int splits,
                              int topk, int raw, int W) {
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
  const float* Qg;
  const float* vecs;
  const int* pids;
  const int* ut;
  const int* qmask;
  int* out_i;
  float* out_d;
  float* part_v;
  int* part_i;
  float* part_qsq;
  int G, U, d, block_rows, n_tiles, topk, raw, splits;
};

template <int NS>
cudaError_t launch(bool aligned, int ngroups, size_t smem, cudaStream_t st,
                   const Args& a) {
  auto kern = aligned ? ivf_scan_grouped_kernel<NS, true>
                      : ivf_scan_grouped_kernel<NS, false>;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(ngroups, a.splits), dim3(kThreads), smem, st>>>(
      a.Qg, a.vecs, a.pids, a.ut, a.qmask, a.out_i, a.out_d, a.part_v,
      a.part_i, a.part_qsq, a.G, a.U, a.d, a.block_rows, a.n_tiles, a.topk,
      a.raw, a.splits);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launches
// (0 = success; -1 for topk outside [1, 1024], G outside [1, 8],
// block_rows < 1, d < 1, splits outside [1, 65535], or missing scratch).
// Device pointers of contiguous tensors: Qg (ngroups*G, d) f32, vecs
// (n_tiles*block_rows, d) f32, pids (n_tiles*block_rows,) i32, union_tiles
// (ngroups, U) i32, qmask (ngroups*G, U) i32, out_i (ngroups*G, topk) i32,
// out_d (ngroups*G, topk) f32.  With splits > 1, part_v (ngroups*G, splits,
// topk) f32, part_i (ngroups*G, splits, topk) i32 and part_qsq (ngroups*G,)
// f32 are scratch for the partial lists, and a second launch merges them.
extern "C" int ivf_scan_grouped_launch(const void* Qg, const void* vecs,
                                       const void* pids,
                                       const void* union_tiles,
                                       const void* qmask, void* out_i,
                                       void* out_d, void* part_v,
                                       void* part_i, void* part_qsq,
                                       int ngroups, int G, int U, int d,
                                       int block_rows, int n_tiles, int topk,
                                       int raw, int splits, void* stream) {
  if (topk < 1 || topk > kMaxTopk || G < 1 || G > kMaxGroup ||
      block_rows < 1 || d < 1 || splits < 1 || splits > 65535 ||
      (splits > 1 && (!part_v || !part_i || !part_qsq)))
    return -1;
  if (ngroups <= 0) return 0;
  cudaGetLastError();  // clear a stale error so the result below is ours
  const size_t dp = (size_t)(d + 3) / 4 * 4;
  const size_t smem =
      4 * ((size_t)G * dp + (size_t)G * block_rows + block_rows +
           (size_t)2 * G * topk);
  const bool aligned = d % 4 == 0 && repro_torch::aligned16(vecs);
  auto st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(Qg), static_cast<const float*>(vecs),
               static_cast<const int*>(pids),
               static_cast<const int*>(union_tiles),
               static_cast<const int*>(qmask), static_cast<int*>(out_i),
               static_cast<float*>(out_d), static_cast<float*>(part_v),
               static_cast<int*>(part_i), static_cast<float*>(part_qsq),
               G, U, d, block_rows, n_tiles, topk, raw, splits};
  cudaError_t e;
  switch (repro_torch::slices_for(d)) {
    case 1: e = launch<1>(aligned, ngroups, smem, st, a); break;
    case 2: e = launch<2>(aligned, ngroups, smem, st, a); break;
    case 4: e = launch<4>(aligned, ngroups, smem, st, a); break;
    case 8: e = launch<8>(aligned, ngroups, smem, st, a); break;
    default: e = launch<0>(aligned, ngroups, smem, st, a); break;
  }
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int W = repro_torch::merge_warps(splits, topk);
  const int R = repro_torch::merge_cta_rows(W), rows = ngroups * G;
  const size_t smem2 = (size_t)R * W * repro_torch::merge_warp_floats(topk) *
                       sizeof(float);
  e = allow_smem(reinterpret_cast<const void*>(ivf_scan_grouped_merge_kernel),
                 smem2);
  if (e != cudaSuccess) return static_cast<int>(e);
  ivf_scan_grouped_merge_kernel<<<dim3((rows + R - 1) / R), dim3(R * W * 32),
                                  smem2, st>>>(a.part_v, a.part_i, a.part_qsq,
                                               a.out_i, a.out_d, rows, splits,
                                               topk, raw, W);
  return static_cast<int>(cudaGetLastError());
}
