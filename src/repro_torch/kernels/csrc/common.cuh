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

// Exclusive prefix sum of v over a CTA of kWarps full warps, in thread
// order; *total gets the sum of every thread's v.  Every thread of the CTA
// calls it (two __syncthreads); wt: kWarps ints of shared memory.
template <int kWarps>
__device__ __forceinline__ int block_exclusive_scan(int v, int* wt,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFullMask, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) wt[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? wt[w] : 0;
    all += wt[w];
  }
  __syncthreads();  // wt may be reused once every thread has read it
  *total = all;
  return before + inc - v;
}

// An asynchronous 4-byte global -> shared copy (cp.async, sm_80+); with
// src_bytes == 0 it reads nothing and writes a zero.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The merge pass of the split kernels (probe_centroids, ivf_scan_grouped).
// Pass 1 leaves, for each output row, S sorted partial lists of length k
// (one per chunk of its candidates, chunks in candidate order) in global
// scratch, row-major as (rows, S, k).  The merge keeps merge_candidates'
// strict-insert rule — a candidate enters only strictly below the running
// k-th entry, so among equal values the earlier chunk's entry stays ahead,
// as the lower candidate index does in a single pass — but applies it a
// whole list at a time: inserting a sorted list's entries one by one in
// order leaves exactly the first k of the stable merge (running list first
// on ties) of the running list and the list's entries below the k-th, and
// a warp computes that merge in parallel (merge path: each lane finds where
// its run of outputs starts by binary search, then merges the run).  A few
// lists are merged by one warp per row; for many, a CTA of W warps takes
// one row: warp w merges lists [w·S/W, (w+1)·S/W) in order into its own
// running list, then warp 0 merges the W results in warp order, so the
// chain of dependent merges is about S/W + W long, not S.

constexpr int kMergeSeg = 512;        // candidates staged per segment, at least
constexpr int kMergeMaxWarps = 8;
constexpr int kMergeSmem = 96 * 1024; // shared memory budget of a merge CTA

// Whole lists of length k staged per segment, and the staging buffer's size.
__host__ __device__ constexpr int merge_seg_lists(int k) {
  return k >= kMergeSeg ? 1 : kMergeSeg / k;
}
__host__ __device__ constexpr int merge_seg_floats(int k) {
  return merge_seg_lists(k) * k;
}

// Floats of shared memory one merging warp needs for lists of length k: two
// running lists and two staging buffers, each (values, ids).
__host__ __device__ constexpr int merge_warp_floats(int k) {
  return 4 * k + 4 * merge_seg_floats(k);
}

// Warps that merge one row's S lists of length k: one for a few lists (and
// then kMergeRows rows share a CTA), else up to kMergeMaxWarps within the
// shared-memory budget.
constexpr int kMergeRows = 4;
constexpr int kMergeTreeFrom = 16;    // lists per row from which W > 1
inline int merge_warps(int S, int k) {
  if (S < kMergeTreeFrom) return 1;
  int w = kMergeSmem / (4 * merge_warp_floats(k));
  w = w < kMergeMaxWarps ? w : kMergeMaxWarps;
  w = w < S ? w : S;
  return w > 1 ? w : 1;
}

// Rows of a merge CTA with W warps per row.
__host__ __device__ constexpr int merge_cta_rows(int W) {
  return W == 1 ? kMergeRows : 1;
}

// Count of the sorted a[0, n) strictly below v (binary search; every lane
// the same).
__device__ __forceinline__ int count_below(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// (ov, oi)[0, k) = the first k of the stable merge of the sorted running list
// (av, ai)[0, k) and the sorted (bv, bi)[0, nb), running entries first on
// ties.  Whole warp; lane l writes outputs [l·q, l·q + q), q = ceil(k / 32).
__device__ __forceinline__ void merge_sorted(const float* av, const int* ai,
                                             const float* bv, const int* bi,
                                             int nb, int k, float* ov,
                                             int* oi, int lane) {
  const int q = (k + 31) >> 5;
  const int o0 = min(lane * q, k), o1 = min(o0 + q, k);
  int lo = max(0, o0 - nb), hi = o0;   // running entries among the first o0
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (av[mid] <= bv[o0 - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  int a = lo, b = o0 - lo;
  for (int o = o0; o < o1; ++o) {
    if (b >= nb || av[a] <= bv[b]) {   // a < k: o < k outputs so far
      ov[o] = av[a];
      oi[o] = ai[a++];
    } else {
      ov[o] = bv[b];
      oi[o] = bi[b++];
    }
  }
  __syncwarp();
}

// Merge lists [first, last) of a row (pv, pi: global, list after list, each
// of length k) in order into the warp's running list, which starts empty
// (all +inf / -1).  ws: merge_warp_floats(k) floats of shared memory.
// Segments of whole lists are copied in with cp.async, the next one in
// flight while the current one is merged; a list whose first entry is not
// below the running k-th entry cannot enter and is skipped.  Returns the
// running buffer (0 or 1) that holds the result, at ws + r·2k (values) and
// ws + r·2k + k (ids).
__device__ __forceinline__ int merge_list_range(const float* __restrict__ pv,
                                                const int* __restrict__ pi,
                                                int first, int last, int k,
                                                float* ws, int lane) {
  const int L = merge_seg_lists(k), F = merge_seg_floats(k);
  float* sv = ws + 4 * k;                        // [2][F]
  int* si = reinterpret_cast<int*>(sv + 2 * F);  // [2][F]
  for (int j = lane; j < k; j += 32) {
    ws[j] = INFINITY;
    reinterpret_cast<int*>(ws + k)[j] = -1;
  }
  int cur = 0;
  const int S = max(last - first, 0);
  const int nseg = (S + L - 1) / L;
  auto stage = [&](int seg) {
    if (seg < nseg) {
      const size_t a = (size_t)(first + seg * L) * k;
      const int m = min(L, S - seg * L) * k;
      const int b = (seg & 1) * F;
      for (int j = lane; j < m; j += 32) {
        cp_async4(sv + b + j, pv + a + j, 4);
        cp_async4(si + b + j, pi + a + j, 4);
      }
    }
    cp_async_commit();
  };
  stage(0);
  for (int seg = 0; seg < nseg; ++seg) {
    stage(seg + 1);      // its buffer was last read before the last syncwarp
    cp_async_wait<1>();
    __syncwarp();        // every lane's copies of this segment are visible
    const int nl = min(L, S - seg * L);
    for (int l = 0; l < nl; ++l) {
      const float* bv = sv + (seg & 1) * F + l * k;
      const int* bi = si + (seg & 1) * F + l * k;
      float* av = ws + cur * 2 * k;
      const float thr = av[k - 1];
      if (!(bv[0] < thr)) continue;  // uniform
      float* ov = ws + (cur ^ 1) * 2 * k;
      merge_sorted(av, reinterpret_cast<const int*>(av + k), bv, bi,
                   count_below(bv, k, thr), k, ov,
                   reinterpret_cast<int*>(ov + k), lane);
      cur ^= 1;
    }
    __syncwarp();
  }
  return cur;
}

// A merge CTA's work: with W = 1 (merge_cta_rows) each warp merges its own
// row; else the CTA's W warps share one row: they merge their ranges of its
// S lists, then warp 0 merges their W results in order.  Returns, in the
// warp that holds a row's final list, that list (values; ids k floats
// after), else nullptr.  ws: (blockDim.x / 32) · merge_warp_floats(k)
// floats of shared memory; pv, pi point at the row's lists.
__device__ __forceinline__ const float* merge_row(const float* __restrict__ pv,
                                                  const int* __restrict__ pi,
                                                  int S, int k, int W,
                                                  float* smem) {
  __shared__ int cur[kMergeMaxWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ws = smem + warp * merge_warp_floats(k);
  if (W == 1) {
    const int c = merge_list_range(pv, pi, 0, S, k, ws, lane);
    return ws + c * 2 * k;
  }
  const int per = (S + W - 1) / W;
  const int c = merge_list_range(pv, pi, warp * per, min(S, (warp + 1) * per),
                                 k, ws, lane);
  if (lane == 0) cur[warp] = c;
  __syncthreads();
  if (warp != 0) return nullptr;
  int r = cur[0];
  for (int w = 1; w < W; ++w) {
    const float* bv = smem + w * merge_warp_floats(k) + cur[w] * 2 * k;
    float* av = ws + r * 2 * k;
    const float thr = av[k - 1];
    if (!(bv[0] < thr)) continue;  // uniform
    float* ov = ws + (r ^ 1) * 2 * k;
    merge_sorted(av, reinterpret_cast<const int*>(av + k), bv,
                 reinterpret_cast<const int*>(bv + k), count_below(bv, k, thr),
                 k, ov, reinterpret_cast<int*>(ov + k), lane);
    r ^= 1;
  }
  return ws + r * 2 * k;
}

// Write the warp's final list of length k as the row's result: ids, and
// d2 = max(v + rowsq, 0) in that op order, or with raw the value itself;
// +inf where the id is -1.
__device__ __forceinline__ void write_final_row(const float* ld,
                                                const int* li, int k,
                                                float rowsq, bool raw,
                                                int* __restrict__ out_i,
                                                float* __restrict__ out_d,
                                                int lane) {
  for (int j = lane; j < k; j += 32) {
    const int id = li[j];
    const float v = ld[j];
    out_i[j] = id;
    out_d[j] = id < 0 ? INFINITY : (raw ? v : fmaxf(v + rowsq, 0.f));
  }
}

// ---------------------------------------------------------------------------
// The live-slot walk of the per-query scans (ivf_scan, ivf_scan_adc).  A map
// slot is live when its tile lies in [0, n_tiles) and holds a live row
// (pids >= 0); a slot that repeats the previous slot's tile takes that
// slot's liveness without reading ids.  Pass 1 keeps one sorted list per
// warp and places every entry at its rank by (value, candidate position)
// at the end (place_by_rank).

constexpr int kLiveIdReads = 8;   // slots whose ids a warp reads at once

// Live slots of tm[0, n) (n <= kPer · 32 · kWarps, a segment), in slot
// order, into seg[0, count); returns count.  Whole CTA of kWarps warps:
// warps take 32-slot windows, read the window's map entries coalesced, read
// the ids of each run's first slot (up to kLiveIdReads slots' reads in
// flight a warp) and ballot them, then a CTA prefix sum compacts the
// segment's live tiles in slot order.
template <int kWarps, int kPer>
__device__ int find_live(const int* __restrict__ tm, int n,
                         const int* __restrict__ pids, int block_rows,
                         int n_tiles, int* seg, int* wt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w0 = warp * 32; w0 < n; w0 += kWarps * 32) {
    const int j = w0 + lane;
    const int t = j < n ? tm[j] : -1;
    const bool inr = t >= 0 && t < n_tiles;
    int tp = __shfl_up_sync(kFullMask, t, 1);
    if (lane == 0) tp = -1;          // a window's first slot reads its ids
    const unsigned need = __ballot_sync(kFullMask, inr && t != tp);
    bool my_any = false;
    unsigned todo = need;
    while (todo) {                   // uniform
      int u[kLiveIdReads];
      bool a[kLiveIdReads];
#pragma unroll
      for (int v = 0; v < kLiveIdReads; ++v) {
        u[v] = todo ? __ffs(todo) - 1 : -1;
        if (todo) todo &= todo - 1;
        const int tile = __shfl_sync(kFullMask, t, u[v] < 0 ? 0 : u[v]);
        a[v] = false;
        if (u[v] >= 0) {
          const int* ip = pids + (size_t)tile * block_rows;
          for (int r = lane; r < block_rows; r += 32) a[v] |= ip[r] >= 0;
        }
      }
#pragma unroll
      for (int v = 0; v < kLiveIdReads; ++v) {
        const bool any = __any_sync(kFullMask, a[v]);
        if (lane == u[v]) my_any = any;
      }
    }
    // a repeat takes the liveness of its run's first slot
    const unsigned upto = lane == 31 ? ~0u : (2u << lane) - 1u;
    const unsigned hm = need & upto;
    const int head = hm ? 31 - __clz(hm) : lane;
    const bool live = __shfl_sync(kFullMask, (int)my_any, head) != 0 && inr;
    if (j < n) seg[j] = live ? t : -1;
  }
  __syncthreads();
  int tv[kPer], c = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = kPer * threadIdx.x + u;
    tv[u] = j < n ? seg[j] : -1;
    c += tv[u] >= 0;
  }
  int total;
  int o = block_exclusive_scan<kWarps>(c, wt, &total);
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (tv[u] >= 0) seg[o++] = tv[u];
  __syncthreads();
  return total;
}

// Count of the entries of the sorted list (lv, lp)[0, k) below (v, p) by
// (value, position).  Every lane the same.
__device__ __forceinline__ int count_before(const float* lv, const int* lp,
                                            int k, float v, int p) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lv[mid] < v || (lv[mid] == v && lp[mid] < p)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The chunk's list from the kWarps warp lists (wl_v, wl_i, wl_p), list w at
// offset w·k: each entry lands at its rank by (value, position) — its index
// in its own list plus its count of the other lists' entries below it — in
// (fl_v, fl_i) when that rank is below k.  Positions increase along each
// warp's walk, so the first k by (value, position) are exactly the
// strict-insert top-k of the chunk's candidates in order.  An entry above
// `bound` is not placed: the caller passes a value that some list holds k
// entries at or below (a warp's k-th), or +inf.  Whole CTA; the caller
// presets fl to +inf / -1 and syncs before and after.
template <int kWarps>
__device__ __forceinline__ void place_by_rank(const float* wl_v,
                                              const int* wl_i,
                                              const int* wl_p, int k,
                                              float bound, float* fl_v,
                                              int* fl_i) {
  for (int e = threadIdx.x; e < kWarps * k; e += kWarps * 32) {
    if (wl_i[e] < 0 || wl_v[e] > bound) continue;
    const int w = e / k;
    const float v = wl_v[e];
    const int p = wl_p[e];
    int rank = e - w * k;
    for (int w2 = 0; w2 < kWarps; ++w2)
      if (w2 != w)
        rank += count_before(wl_v + w2 * k, wl_p + w2 * k, k, v, p);
    if (rank < k) {
      fl_v[rank] = v;
      fl_i[rank] = wl_i[e];
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

// A warp's copy of one d-vector, held by each group of LANES lanes (32: the
// whole warp): lane l of a group holds the float4 slices s*LANES + l
// (s < NS), i.e. elements [4(LANES s + l), 4(LANES s + l) + 4), covering
// d <= 4 * LANES * NS.  NS == 0 keeps nothing in registers and re-reads the
// vector from memory (L1-resident) for every dot: the path for wide rows.
template <int NS, bool kAligned, int LANES = 32>
struct WarpVec {
  float4 v[NS > 0 ? NS : 1];
  const float* base;

  __device__ __forceinline__ void load(const float* __restrict__ p, int d,
                                       int lane) {
    base = p;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      v[s] = load4<kAligned>(p, (s * LANES + lane) * 4, d);
  }

  // This lane's share of the dot with row (reduce over the group's lanes).
  __device__ __forceinline__ float partial_dot(const float* __restrict__ row,
                                               int d, int lane) const {
    float acc = 0.f;
    if (NS > 0) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
        acc += dot4(v[s], load4<kAligned>(row, (s * LANES + lane) * 4, d));
    } else {
      for (int e = lane * 4; e < d; e += 4 * LANES)
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
