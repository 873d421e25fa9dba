// ivf_scan_adc: per-query scan of the probed tiles of the compressed (u8
// code) inverted lists through a per-query distance table, with a running
// top-k of packed row positions, for the IVF index's int8/PQ search.
//
// Replaces the TPU kernel src/repro/kernels/ivf_scan_adc.py::ivf_scan_adc
// (Pallas; pl.pallas_call at :115, body _kernel at :38).  Same function:
// query q walks the T packed tiles named in tile_map[q] (block_rows rows
// each, in slot order) and scores each live row (pids >= 0) as
//   part = vnorm[row] + sum_m lut[q, m, code[row, m]]      (W > 1, PQ)
//   part = vnorm[row] + sum_m lut[q, m, 0] * code[row, m]  (W = 1, int8)
// (a code >= W looks up 0, as the reference's one-hot would), +inf at holes,
// and keeps the k smallest with the reference's order: slot order, then row
// order, a candidate entering only when strictly below the k-th entry.  Out:
// the packed row positions (-1 at empty slots), the ids gathered by position
// (-1 there) and the selected partials plus the query constant qconst[q]
// (+inf there), the same single f32 add as the reference's
// od + qconst[:, None] (ivf_scan_adc.py:126-127).
//
// Bound on an H100 SXM: bytes.  Each scanned live row streams its M code
// bytes and its 4-byte vnorm, and each query its M·W·4-byte table once
// (src/repro/launch/roofline.py:73-83, hbm_bytes); a row costs M table
// reads and M adds, far below any compute rate.  The reference's one-hot
// contraction (M·W multiply-adds per row) is a TPU idiom and is not done.
// At nq = 10,000, nprobe 16 on the SIFT1M-shaped index (about 1,000 live
// rows a query) that is 61.7 us for PQ nsub=8, 396.7 us for int8 (M=128)
// and 206.6 us for PQ nsub=32 at 3.35 TB/s; a served batch of 64 queries
// moves under 1 MB (well under 1 us), so there the chain of dependent
// loads of each query's work sets the time unless that work is spread over
// many SMs.
//
// Design: split and merge over each query's live slots, as csrc/ivf_scan.cu
// (the earlier kernel here ran one 128-thread CTA per query,
// walked every slot in order with a thread per row, holes included, and
// ended each tile with two barriers while one warp merged).  The wrapper's
// split plan (ivf_scan.py split_plan, the same plan as the f32 scan: nq, T,
// topk and the SM count, no device read) cuts each query's live slots
// (common.cuh find_live: an in-range tile holding a live row) into S
// contiguous chunks, S = 1 once the queries alone fill the card, else as
// many as keep pass 1 within one wave of 8 CTAs per SM, S · topk <= 32,768.
//   pass 1 (ivf_scan_adc_kernel): CTA (q, s) of 8 warps.  The query's
//     table is copied into shared memory with cp.async while the CTA finds
//     its live slots (segments of 512 map slots); the first segment's walk
//     waits for it.  The chunk's rows are cut into items of 32 rows (tile,
//     row group), item i to warp i mod 8: a lane per row reads its id
//     (coalesced), and only a live row loads its M codes (16-, 8- or
//     4-byte loads, the widest that M and the slab's alignment allow) and
//     vnorm and sums the table entries in m order, the earlier kernel's
//     arithmetic; holes cost their id read alone.  Each warp keeps its own
//     sorted list of (partial, row, candidate position) in shared memory,
//     so no warp waits on another's merge and a tile has no barrier.  An
//     item's candidates are the live rows strictly below the warp's k-th
//     entry and not above the bound the warps publish: the lowest k-th of
//     any warp, or the largest of the warps' c-th entries, c = ceil(k/8)
//     (either way k candidates lie at or below it, so a row above it
//     cannot rank, whatever the positions).  They wait in a buffer of 32
//     in the warp's registers, one a lane, and go into the list together
//     when the next item's would overflow it and at the end (merge_buffer:
//     a bitonic sort of the 32 lanes by (value, lane), then each candidate
//     and list entry moved to its place in the stable merge, found by
//     binary searches, the list's entries first among equal values — what
//     strict inserts one by one in position order give).  On the H100 the
//     list upkeep, not the walk, takes most of pass 1's time at S = 1
//     (PERF.md §6); the buffer and the bound keep it down.  At the end
//     every entry at or below the bound lands at its rank by (value,
//     position) (common.cuh place_by_rank) in a list that reuses the
//     table's space.  With S = 1 the CTA writes the finished row (ids by
//     position, qconst added); else its raw list goes to the scratch
//     (nq, S, topk).
//   pass 2 (ivf_scan_adc_merge_kernel, only when S > 1): each query's S
//     lists merged in chunk order (common.cuh merge_row), then the same
//     finished write.
// Chunk order is slot order and the merge keeps the earlier chunk's entry
// first among equal values, so the lists equal those of one walk over all
// of the query's slots in order, bit for bit, for any S, and equal the
// earlier kernel's.  Shared memory of pass 1: 4·(max(M·W, 2·topk) + 512 +
// 24·topk) bytes, 231,424 at topk = 1,024 with a 32,768-float table (one
// CTA, 8 warps an SM); 14 KB for PQ nsub=8 and 38 KB for nsub=32 at topk 40
// (8 and 5 CTAs an SM).  topk <= 1024, M·W <= 32,768, T·block_rows and
// n_pad below 2^31.  Launches on the caller's stream, allocates nothing.

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

using repro_torch::cp_async4;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::find_live;
using repro_torch::kFullMask;
using repro_torch::kMaxTopk;
using repro_torch::place_by_rank;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPer = 2;               // map slots of a segment per thread
constexpr int kSeg = kPer * kThreads;
constexpr int kMinBlocks = 8;         // pass-1 CTAs an SM (launch bounds)
constexpr int kMaxLut = 32768;        // floats of table in shared memory

// acc + the table term of code c at column m.
template <bool kMul>
__device__ __forceinline__ float adc_term(const float* lut, int m, int W,
                                          unsigned c, float acc) {
  if (kMul) return acc + lut[m] * static_cast<float>(c);
  return acc + (c < static_cast<unsigned>(W) ? lut[m * W + c] : 0.f);
}

// The four codes of a 32-bit word, columns m..m+3 (little endian).
template <bool kMul>
__device__ __forceinline__ float adc_word(const float* lut, int m, int W,
                                          unsigned w, float acc) {
#pragma unroll
  for (int b = 0; b < 4; ++b)
    acc = adc_term<kMul>(lut, m + b, W, (w >> (8 * b)) & 0xffu, acc);
  return acc;
}

// sum_m of the table terms of one row's M codes, in m order.  VW: bytes per
// load (16, 8, 4, or 1); the caller guarantees M % VW == 0 and alignment.
template <int VW, bool kMul>
__device__ __forceinline__ float adc_row(const uint8_t* __restrict__ code,
                                         int M, int W, const float* lut) {
  float acc = 0.f;
  if (VW == 16) {
    for (int m = 0; m < M; m += 16) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(code + m));
      acc = adc_word<kMul>(lut, m, W, w.x, acc);
      acc = adc_word<kMul>(lut, m + 4, W, w.y, acc);
      acc = adc_word<kMul>(lut, m + 8, W, w.z, acc);
      acc = adc_word<kMul>(lut, m + 12, W, w.w, acc);
    }
  } else if (VW == 8) {
    for (int m = 0; m < M; m += 8) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(code + m));
      acc = adc_word<kMul>(lut, m, W, w.x, acc);
      acc = adc_word<kMul>(lut, m + 4, W, w.y, acc);
    }
  } else if (VW == 4) {
    for (int m = 0; m < M; m += 4)
      acc = adc_word<kMul>(lut, m, W,
                           __ldg(reinterpret_cast<const unsigned*>(code + m)),
                           acc);
  } else {
    for (int m = 0; m < M; ++m) acc = adc_term<kMul>(lut, m, W, code[m], acc);
  }
  return acc;
}

// The finished row from a sorted list of (partial, row): positions, ids by
// position and partials plus qc; -1 / -1 / +inf where the row is -1.
// Entries first, first + step, ...
__device__ __forceinline__ void write_row(const float* lv, const int* lrow,
                                          int k, float qc,
                                          const int* __restrict__ pids,
                                          int* __restrict__ out_ids,
                                          int* __restrict__ out_pos,
                                          float* __restrict__ out_part,
                                          int first, int step) {
  for (int j = first; j < k; j += step) {
    const int row = lrow[j];
    out_pos[j] = row;
    out_ids[j] = row < 0 ? -1 : pids[row];
    out_part[j] = row < 0 ? INFINITY : lv[j] + qc;
  }
}

// Merge the warp's buffered candidates (lane l: value v where cand, row r,
// position c; positions rise with the lane) into its sorted list (lv, li,
// lp) of length k, as strict inserts one by one in lane order would (an
// entry goes in after every entry <= its value, and only below the k-th):
// the first k of the stable merge of the list and the candidates sorted by
// (value, lane), the list's entries first among equal values.  Whole warp;
// nb = the number of candidates (>= 1), uniform.
__device__ __forceinline__ void merge_buffer(float* lv, int* li, int* lp,
                                             int k, bool cand, float v, int r,
                                             int c, int nb, int lane) {
  // bitonic sort of (value, lane) across the warp, non-candidates last
  float sv = cand ? v : INFINITY;
  int src = lane;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(kFullMask, sv, stride);
      const int os = __shfl_xor_sync(kFullMask, src, stride);
      const bool less = sv < ov || (sv == ov && src < os);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      if (keep_min != less) {
        sv = ov;
        src = os;
      }
    }
  }
  const int sr = __shfl_sync(kFullMask, r, src);
  const int sc = __shfl_sync(kFullMask, c, src);
  // candidate j lands after j candidates and the entries <= its value
  int at = k;
  if (lane < nb) {
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (lv[mid] <= sv) lo = mid + 1; else hi = mid;
    }
    at = lane + lo;
  }
  // entries from the first one above the smallest candidate move up by the
  // count of candidates below them; blocks of 32 from the top down, each
  // read before it is written
  const int first = __shfl_sync(kFullMask, at, 0);
  for (int s = (k - 1) >> 5; s >= (first >> 5); --s) {
    const int i = 32 * s + lane;
    const bool mv = i >= first && i < k;
    float a = INFINITY;
    int ai = 0, ap = 0;
    if (mv) {
      a = lv[i];
      ai = li[i];
      ap = lp[i];
    }
    // the candidates below a: a binary search over the sorted lanes
    int lo = 0, hi = nb;
#pragma unroll
    for (int step = 0; step < 6; ++step) {   // 6 halvings cover nb <= 32
      const int mid = (lo + hi) >> 1;
      const float vm = __shfl_sync(kFullMask, sv, mid & 31);
      if (lo < hi) {
        if (vm < a) lo = mid + 1; else hi = mid;
      }
    }
    const int to = i + lo;
    __syncwarp();
    if (mv && to < k) {
      lv[to] = a;
      li[to] = ai;
      lp[to] = ap;
    }
    __syncwarp();
  }
  if (at < k) {
    lv[at] = sv;
    li[at] = sr;
    lp[at] = sc;
  }
  __syncwarp();
}

// The index of the n-th (from 0) set bit of m; m has more than n.
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  int base = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (n >= c) {
      n -= c;
      m >>= w;
      base += w;
    }
  }
  return base;
}

template <int VW, bool kMul>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ivf_scan_adc_kernel(const float* __restrict__ lut,
                    const float* __restrict__ vnorm,
                    const uint8_t* __restrict__ codes,
                    const int* __restrict__ pids,
                    const int* __restrict__ tile_map,
                    const float* __restrict__ qconst,
                    int* __restrict__ out_ids, int* __restrict__ out_pos,
                    float* __restrict__ out_part, float* __restrict__ part_v,
                    int* __restrict__ part_i, int T, int M, int W,
                    int block_rows, int n_tiles, int topk, int splits) {
  extern __shared__ float4 smem4[];
  __shared__ int wt[kWarps];
  // what each warp publishes of its list: its k-th entry and its c-th,
  // c = ceil(k / 8) (see the bound below)
  __shared__ float kth_s[kWarps], kc_s[kWarps];
  volatile float* kth = kth_s;
  volatile float* kc = kc_s;
  const int c_th = (topk + kWarps - 1) / kWarps;
  const int mw = M * W;
  const int A = (max(mw, 2 * topk) + 3) & ~3;
  float* slut = reinterpret_cast<float*>(smem4);       // [A]: table, then list
  int* seg = reinterpret_cast<int*>(slut + A);         // [kSeg]
  float* wl_v = reinterpret_cast<float*>(seg + kSeg);  // [8][topk]
  int* wl_i = reinterpret_cast<int*>(wl_v + kWarps * topk);  // rows
  int* wl_p = wl_i + kWarps * topk;                    // candidate positions

  const int q = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the table's copy, in flight while the live slots are found
  const float* qlut = lut + (size_t)q * mw;
  for (int i = tid; i < mw; i += kThreads) cp_async4(slut + i, qlut + i, 4);
  cp_async_commit();
  for (int j = tid; j < kWarps * topk; j += kThreads) {
    wl_v[j] = INFINITY;
    wl_i[j] = -1;
    wl_p[j] = INT_MAX;
  }
  if (tid < kWarps) kth[tid] = kc[tid] = INFINITY;
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
  // the warp's candidates not merged yet: lane j < nbuf holds the j-th, in
  // position order
  float bv = INFINITY;
  int brow = 0, bpos = 0, nbuf = 0;
  bool table = false;
  int live_base = 0;
  for (int sg = 0; sg < nseg && live_base < hi; ++sg) {
    const int n = kept >= 0 ? kept
                            : find_live<kWarps, kPer>(
                                  tm + sg * kSeg, min(kSeg, T - sg * kSeg),
                                  pids, block_rows, n_tiles, seg, wt);
    if (!table) {                    // uniform
      cp_async_wait<0>();
      __syncthreads();               // every thread's table copies landed
      table = true;
    }
    const int a = max(lo - live_base, 0), b = min(hi - live_base, n);
    // the chunk's slots a..b-1 of this segment; positions from the chunk's
    // first slot
    const int pos0 = (live_base + a - lo) * block_rows;
    const int items = max(b - a, 0) * groups;
    for (int item = warp; item < items; item += kWarps) {   // uniform
      const int ti = item / groups, r = 32 * (item - ti * groups) + lane;
      const int row = seg[a + ti] * block_rows + r;
      const int pos = pos0 + ti * block_rows + r;
      const bool live = r < block_rows && pids[row] >= 0;
      float p = INFINITY;
      if (live)
        p = vnorm[row] + adc_row<VW, kMul>(codes + (size_t)row * M, M, W,
                                           slut);
      // a candidate must beat this warp's k-th and must not lie above a
      // value that the lists' entries put k candidates at or below: any
      // warp's k-th, or the largest of the warps' c-th entries (8 · c >= k)
      float lo_k = INFINITY, hi_c = -INFINITY;
      if (lane < kWarps) {
        lo_k = kth[lane];
        hi_c = kc[lane];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        lo_k = fminf(lo_k, __shfl_xor_sync(kFullMask, lo_k, o));
        hi_c = fmaxf(hi_c, __shfl_xor_sync(kFullMask, hi_c, o));
      }
      const float thr = fminf(lo_k, hi_c);
      const unsigned m = __ballot_sync(
          kFullMask, live && p < lv[topk - 1] && p <= thr);
      if (m == 0) continue;
      const int nb = __popc(m);
      if (nbuf + nb > 32) {          // the buffer is full: merge it
        merge_buffer(lv, li, lp, topk, lane < nbuf, bv, brow, bpos, nbuf,
                     lane);
        nbuf = 0;
        if (lane == 0) {
          kth[warp] = lv[topk - 1];
          kc[warp] = lv[c_th - 1];
        }
      }
      // buffer lane nbuf + j takes the item's j-th candidate
      const int j = lane - nbuf;
      const bool take = j >= 0 && j < nb;
      const int src = take ? nth_set_bit(m, j) : lane;
      const float tv = __shfl_sync(kFullMask, p, src);
      const int tr = __shfl_sync(kFullMask, row, src);
      const int tc = __shfl_sync(kFullMask, pos, src);
      if (take) {
        bv = tv;
        brow = tr;
        bpos = tc;
      }
      nbuf += nb;
    }
    live_base += n;
    __syncthreads();  // seg is found again for the next segment
  }

  if (nbuf > 0)
    merge_buffer(lv, li, lp, topk, lane < nbuf, bv, brow, bpos, nbuf, lane);

  // the chunk's list, in the table's space once no copy or read is pending
  cp_async_wait<0>();
  __syncthreads();
  float* fl_v = slut;
  int* fl_i = reinterpret_cast<int*>(slut + topk);
  for (int j = tid; j < topk; j += kThreads) {
    fl_v[j] = INFINITY;
    fl_i[j] = -1;
  }
  float lo_k = INFINITY, hi_c = -INFINITY;  // no entry above them ranks
  for (int w = 0; w < kWarps; ++w) {
    lo_k = fminf(lo_k, wl_v[w * topk + topk - 1]);
    hi_c = fmaxf(hi_c, wl_v[w * topk + c_th - 1]);
  }
  const float bound = fminf(lo_k, hi_c);
  __syncthreads();
  place_by_rank<kWarps>(wl_v, wl_i, wl_p, topk, bound, fl_v, fl_i);
  __syncthreads();

  if (splits == 1) {
    const size_t o = (size_t)q * topk;
    write_row(fl_v, fl_i, topk, qconst[q], pids, out_ids + o, out_pos + o,
              out_part + o, tid, kThreads);
  } else {
    const size_t o = ((size_t)q * splits + s) * topk;
    for (int j = tid; j < topk; j += kThreads) {
      part_v[o + j] = fl_v[j];
      part_i[o + j] = fl_i[j];
    }
  }
}

// W warps per query (common.cuh merge_row): with W = 1, four queries a CTA.
__global__ void __launch_bounds__(repro_torch::kMergeMaxWarps * 32)
ivf_scan_adc_merge_kernel(const float* __restrict__ part_v,
                          const int* __restrict__ part_i,
                          const float* __restrict__ qconst,
                          const int* __restrict__ pids,
                          int* __restrict__ out_ids, int* __restrict__ out_pos,
                          float* __restrict__ out_part, int rows, int splits,
                          int topk, int W) {
  extern __shared__ float4 smem4[];
  const size_t row = (size_t)blockIdx.x * repro_torch::merge_cta_rows(W) +
                     (W == 1 ? threadIdx.x >> 5 : 0);
  if (row >= (size_t)rows) return;  // whole warp; W = 1 has no block barrier
  const size_t o = row * splits * topk;
  const float* l = repro_torch::merge_row(part_v + o, part_i + o, splits,
                                          topk, W,
                                          reinterpret_cast<float*>(smem4));
  if (l == nullptr) return;
  const size_t f = row * topk;
  write_row(l, reinterpret_cast<const int*>(l + topk), topk, qconst[row],
            pids, out_ids + f, out_pos + f, out_part + f, threadIdx.x & 31,
            32);
}

cudaError_t allow_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct Args {
  const float* lut;
  const float* vnorm;
  const uint8_t* codes;
  const int* pids;
  const int* tm;
  const float* qconst;
  int* out_ids;
  int* out_pos;
  float* out_part;
  float* part_v;
  int* part_i;
  int T, M, W, block_rows, n_tiles, topk, splits;
};

template <int VW, bool kMul>
cudaError_t launch(int nq, size_t smem, cudaStream_t st, const Args& a) {
  auto kern = ivf_scan_adc_kernel<VW, kMul>;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(nq, a.splits), dim3(kThreads), smem, st>>>(
      a.lut, a.vnorm, a.codes, a.pids, a.tm, a.qconst, a.out_ids, a.out_pos,
      a.out_part, a.part_v, a.part_i, a.T, a.M, a.W, a.block_rows, a.n_tiles,
      a.topk, a.splits);
  return cudaGetLastError();
}

template <bool kMul>
cudaError_t launch_vw(int vw, int nq, size_t smem, cudaStream_t st,
                      const Args& a) {
  switch (vw) {
    case 16: return launch<16, kMul>(nq, smem, st, a);
    case 8: return launch<8, kMul>(nq, smem, st, a);
    case 4: return launch<4, kMul>(nq, smem, st, a);
    default: return launch<1, kMul>(nq, smem, st, a);
  }
}

bool aligned_to(const void* p, unsigned n) {
  return (reinterpret_cast<uintptr_t>(p) % n) == 0;
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launches
// (0 = success; -1 for topk outside [1, 1024], block_rows < 1, M < 1, W < 1,
// M·W above 32,768, splits outside [1, 65535], T·block_rows or
// n_tiles·block_rows >= 2^31, or missing scratch).  Device pointers of
// contiguous tensors: lut (nq, M, W) f32, vnorm (n_tiles*block_rows,) f32,
// codes (n_tiles*block_rows, M) u8, pids (n_tiles*block_rows,) i32, tile_map
// (nq, T) i32, qconst (nq,) f32; out_ids, out_pos (nq, topk) i32 and
// out_part (nq, topk) f32 (the partials plus qconst, +inf where out_pos is
// -1).  With splits > 1, part_v (nq, splits, topk) f32 and part_i (nq,
// splits, topk) i32 are scratch for the partial lists, and a second launch
// merges them.
extern "C" int ivf_scan_adc_launch(const void* lut, const void* vnorm,
                                   const void* codes, const void* pids,
                                   const void* tile_map, const void* qconst,
                                   void* out_ids, void* out_pos,
                                   void* out_part, void* part_v, void* part_i,
                                   int nq, int T, int M, int W,
                                   int block_rows, int n_tiles, int topk,
                                   int splits, void* stream) {
  if (topk < 1 || topk > kMaxTopk || block_rows < 1 || M < 1 || W < 1 ||
      (long long)M * W > kMaxLut || T < 0 || splits < 1 || splits > 65535 ||
      (long long)T * block_rows > (long long)INT_MAX ||
      (long long)n_tiles * block_rows > (long long)INT_MAX ||
      (splits > 1 && (!part_v || !part_i)))
    return -1;
  if (nq <= 0) return 0;
  cudaGetLastError();  // clear a stale error so the result below is ours
  const size_t A = ((size_t)max(M * W, 2 * topk) + 3) & ~(size_t)3;
  const size_t smem = sizeof(float) * (A + kSeg + 3 * (size_t)kWarps * topk);
  int vw = 1;
  if (M % 16 == 0 && aligned_to(codes, 16)) vw = 16;
  else if (M % 8 == 0 && aligned_to(codes, 8)) vw = 8;
  else if (M % 4 == 0 && aligned_to(codes, 4)) vw = 4;
  auto st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(lut),
               static_cast<const float*>(vnorm),
               static_cast<const uint8_t*>(codes),
               static_cast<const int*>(pids),
               static_cast<const int*>(tile_map),
               static_cast<const float*>(qconst),
               static_cast<int*>(out_ids), static_cast<int*>(out_pos),
               static_cast<float*>(out_part), static_cast<float*>(part_v),
               static_cast<int*>(part_i), T, M, W, block_rows, n_tiles, topk,
               splits};
  cudaError_t e = W == 1 ? launch_vw<true>(vw, nq, smem, st, a)
                         : launch_vw<false>(vw, nq, smem, st, a);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int MW = repro_torch::merge_warps(splits, topk);
  const int R = repro_torch::merge_cta_rows(MW);
  const size_t smem2 = (size_t)R * MW * repro_torch::merge_warp_floats(topk) *
                       sizeof(float);
  e = allow_smem(reinterpret_cast<const void*>(ivf_scan_adc_merge_kernel),
                 smem2);
  if (e != cudaSuccess) return static_cast<int>(e);
  ivf_scan_adc_merge_kernel<<<dim3((nq + R - 1) / R), dim3(R * MW * 32), smem2,
                              st>>>(a.part_v, a.part_i, a.qconst, a.pids,
                                    a.out_ids, a.out_pos, a.out_part, nq,
                                    splits, topk, MW);
  return static_cast<int>(cudaGetLastError());
}
