// assign_centroids: the nearest centroid of every row of X, on Hopper's
// tensor cores in 3xTF32.
//
// Replaces the TPU kernel src/repro/kernels/centroid_assign.py
// ::assign_centroids (Pallas; pl.pallas_call at :200, body _kernel at :26).
// Same function: for each row x the partial part_j = ||c_j||² − 2 x·c_j to
// every centroid (||c||² hoisted once per call: the wrapper passes it), the
// first minimum (lowest index among equal partials), then
// d2 = max(part + ||x||², 0) in that op order (+inf when the minimum is).
//
// Bound on an H100 SXM: the products.  n·k·d multiply-adds against
// (n + k)·d·4 bytes: at n = 10,000, k = 16,384, d = 128 that is 41.9 GFLOP
// (0.63 ms at the 67 TFLOP/s FP32 rate) against 14 MB.  Plain TF32 rounds
// the inputs to 10 mantissa bits, too coarse for a ranking held to f32
// (1e-5 of ||x||² + ||c||² per selected pair), so the products are 3xTF32:
// each f32 operand a is split into hi = tf32(a) and lo = tf32(a − hi)
// (round to nearest, ties away; a − hi is exact in f32) and
//   a·b ≈ lo_a·hi_b + hi_a·lo_b + hi_a·hi_b     (small terms first)
// drops only lo·lo and the bits below lo: about 2^-21 of |a·b| per product
// against TF32's 2^-10.  That is three TF32 products per f32 one: the
// bound becomes 3·2·n·k·d over the 495 TFLOP/s TF32 rate, 0.254 ms at
// n = 10^4 and 25.4 ms at n = 10^6.
//
// Design (one pass, plus a merge pass when the split plan cuts k):
//   * A CTA of two warpgroups (256 threads) owns NR rows of X (NR = 128, or
//     64 when the centroids make at most two tiles: two CTAs an SM) and one
//     chunk of centroids [c0, c1) (split plan: kernels/assign_centroids.py).
//     The rows are the wgmma's N side (m64n128k8 / m64n64k8), read from
//     shared memory through a descriptor; each warpgroup takes 64 centroids
//     of a 128-centroid tile as the M side, from registers.
//   * The row tile stays resident: it is loaded once (per 128-feature panel)
//     and stored as hi and lo, K-major, in the no-swizzle core-matrix layout
//     (8 rows x 16 bytes per core matrix; the NR/8 core matrices of a
//     16-byte K column lie side by side, SBO = 128 B, so a K column of all
//     rows is NR·16 consecutive bytes; LBO = NR·16 B to the next column).
//     Within each k-step the features are permuted (logical k = 4h + q
//     holds feature 2q + h) so that a thread's A fragment (features t and
//     t+4 of a k-step) is one 8-byte load per centroid row.
//   * Centroid tiles stream through a 4-stage cp.async ring of 32-feature
//     slices (16 for 64-row tiles; rows padded to 8 or 24 floats mod 32:
//     conflict-free fragment loads).  Each thread splits its A fragment into hi/lo in registers at
//     the point of use, one k-step at a time: the three products of a k-step
//     are issued (and committed) before the next k-step's fragments are
//     loaded and split, so that work hides under them; the f32 accumulators
//     stay in registers, and the stage ends with one wait.
//   * Epilogue per centroid tile: c² − 2·acc folded into a running (min,
//     index) per row in registers.  A thread meets its centroids in
//     increasing order, so "strictly smaller replaces" keeps the first
//     minimum; centroids past the chunk score +inf and never replace.  At
//     the end the 8 lanes sharing a row and the 8 warps reduce by (value,
//     then index), then d2 is finalized, or the chunk's (min, index) goes
//     to the scratch for the merge pass.
//   * Merge pass (split plan S > 1): each row takes its S pairs in chunk
//     order, earlier chunk first on ties, and finalizes d2 once.  The chunks
//     are whole tiles, every pair's partial is computed by the same
//     instructions whatever S is, and the (value, index) rule is the same
//     everywhere, so the result equals the single pass's bit for bit.
// Budget (the reason for A from registers and one resident tile): at
// d = 128 the resident hi + lo tile is 128 KB and the ring 80 KB (208 KB of
// the 227 KB a CTA may take: one 128-row CTA per SM); registers hold NR/2
// accumulators, NR/4 (min, index) pairs and the stage's fragments (~220 a
// thread at NR = 128; 128 at NR = 64, whose 16-feature stages keep it
// from spilling).  For d > 128 the rows are converted
// one 128-feature panel at a time and re-converted for every centroid tile
// (slower, correct): no path of the system goes there.  Ragged n, k and d
// are zero-filled (K padded to a multiple of 8, so d = 4 or 37 work) and
// masked in the epilogue.  A row whose partials are all +inf or NaN keeps
// its chunk's first centroid with d2 = +inf.  Launches on the caller's
// stream and allocates nothing.

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::kFullMask;

constexpr int kCents = 128;     // centroids per tile (2 warpgroups x M = 64)
constexpr int kThreads = 256;
constexpr int kPanel = 128;     // features of the row tile held at once
// Features per ring stage: 32 for 128-row tiles, 16 for 64-row ones (their
// CTAs share an SM two to one: the fewer fragments a stage holds, the fewer
// registers).
__host__ __device__ constexpr int stage_features(int NR) {
  return NR == 64 ? 16 : 32;
}
constexpr int kStages = 4;

__host__ __device__ constexpr int kpad(int d) {
  return d <= 0 ? 8 : (d + 7) / 8 * 8;
}
__host__ __device__ constexpr int stage_k(int d, int NR) {
  return kpad(d) < stage_features(NR) ? kpad(d) : stage_features(NR);
}
// Ring row stride in floats: 8 or 24 mod 32, so the 8-byte fragment loads of
// a half warp (4 rows x 4 lanes) hit 16 distinct bank pairs.
__host__ __device__ constexpr int ring_stride(int bk) {
  return bk == 8 ? 8 : bk <= 24 ? 24 : 40;
}
__host__ __device__ constexpr int panel_width(int d) {
  return kpad(d) < kPanel ? kpad(d) : kPanel;
}
// The row tile (NR = 128 or 64 rows: the wgmma N) as hi and lo, and the
// ring of centroid slices.
__host__ __device__ constexpr size_t smem_bytes(int d, int NR) {
  return (2 * (size_t)NR * panel_width(d) +
          (size_t)kStages * kCents * ring_stride(stage_k(d, NR))) *
             sizeof(float);
}

__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// hi = tf32(a), lo = tf32(a - hi): a - hi is exact in f32.
__device__ __forceinline__ void split3(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// Shared-memory matrix descriptor, K-major, no swizzle: start address,
// LBO (bytes to the next 16-byte K column: NR rows of 16 bytes), SBO (bytes
// to the next 8 rows).
constexpr int kSBO = 128;
template <int NR>
__device__ __forceinline__ uint64_t kmajor_desc(const float* p) {
  constexpr int kLBO = NR * 16;
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(kLBO >> 4) << 16) |
         (static_cast<uint64_t>(kSBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin the accumulators in place around the asynchronous products (keeps the
// compiler from moving their reads across the wait).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) (+)= A (64 x 8, tf32, registers) · B (128 x 8, tf32,
// shared memory, K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// The same for a 64-row tile: d (64 x 64) (+)= A (64 x 8) · B (64 x 8).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// Load features [f0, f0 + 8) of row r of M (rows x d) as f32, zeros outside.
template <bool kVec>
__device__ __forceinline__ void load8(const float* __restrict__ M, int rows,
                                      int d, int r, int f0, float (&v)[8]) {
  if (r >= rows) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
    return;
  }
  const float* row = M + (size_t)r * d;
  const float4 a = repro_torch::load4<kVec>(row, f0, d);
  const float4 b = repro_torch::load4<kVec>(row, f0 + 4, d);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Convert panel p of the row tile into Xh / Xl (hi and lo, core-matrix
// layout, features permuted within each k-step): row n, K column kc, lane q
// at kc·512 + (n / 8)·32 + (n % 8)·4 + q floats.  Item (n, s): row n, k-step
// s of the panel; consecutive threads take consecutive rows, so a warp
// writes 512 consecutive bytes (no bank conflict).
template <bool kVec, int NR>
__device__ __forceinline__ void convert_panel(float* Xh, float* Xl,
                                              const float* __restrict__ X,
                                              int n, int d, int r0, int p,
                                              int ksteps) {
  const int items = NR * ksteps;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int row = it % NR, s = it / NR;
    float v[8];
    load8<kVec>(X, n, d, r0 + row, p * kPanel + 8 * s, v);
    const int base = (row >> 3) * 32 + (row & 7) * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split3(v[2 * q + h], hi[q], lo[q]);
      const int o = base + (2 * s + h) * (NR * 4);
      *reinterpret_cast<uint4*>(Xh + o) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(Xl + o) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// Stage features [f0, f0 + bk) of centroids [cb, cb + 128) (rows >= c1 and
// features >= d zero-filled) into a ring slot, row stride `stride`.
template <bool kVec>
__device__ __forceinline__ void stage_tile(float* dst, int stride,
                                           const float* __restrict__ C,
                                           int c1, int d, int cb, int f0,
                                           int bk) {
  if constexpr (kVec) {
    const int per = bk / 4;
    for (int c = threadIdx.x; c < kCents * per; c += kThreads) {
      const int r = c / per, e = f0 + 4 * (c % per);
      const bool ok = cb + r < c1 && e < d;
      const float* src = ok ? C + (size_t)(cb + r) * d + e : C;
      const unsigned s = static_cast<unsigned>(
          __cvta_generic_to_shared(dst + r * stride + 4 * (c % per)));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                   "l"(src), "r"(ok ? 16 : 0));
    }
  } else {
    for (int c = threadIdx.x; c < kCents * bk; c += kThreads) {
      const int r = c / bk, e = f0 + c % bk;
      const bool ok = cb + r < c1 && e < d;
      const float* src = ok ? C + (size_t)(cb + r) * d + e : C;
      repro_torch::cp_async4(dst + r * stride + c % bk, src, ok ? 4 : 0);
    }
  }
}

template <bool kVec, int NR>
__global__ void __launch_bounds__(kThreads, NR == 64 ? 2 : 1)
assign_tc_kernel(const float* __restrict__ X, const float* __restrict__ C,
                 const float* __restrict__ csq, const float* __restrict__ xsq,
                 int* __restrict__ out_i, float* __restrict__ out_d,
                 float* __restrict__ part_v, int* __restrict__ part_i, int n,
                 int k, int d, int chunk, int splits) {
  extern __shared__ __align__(128) float smem[];
  constexpr int kBK = stage_features(NR);
  const int Kp = kpad(d), P = panel_width(d), bk = stage_k(d, NR);
  const int stride = ring_stride(bk);
  float* Xh = smem;
  float* Xl = Xh + NR * P;
  float* ring = Xl + NR * P;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;   // warpgroup, warp within it
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = blockIdx.x * NR;
  const int s = blockIdx.y;
  const int c0 = s * chunk, c1 = min(c0 + chunk, k);
  const int ksteps = Kp / 8;                 // of the whole K
  const int npanels = (Kp + kPanel - 1) / kPanel;
  const int nQ = (Kp + kBK - 1) / kBK;       // ring stages per tile
  const int ntiles = (c1 - c0 + kCents - 1) / kCents;
  const int steps = ntiles * nQ;
  const int mrow = 64 * wg + 16 * wq + g;    // this thread's first centroid

  constexpr int kAcc = NR / 2;      // f32 accumulators a thread
  constexpr int kSlots = NR / 4;    // rows a thread holds
  float best[kSlots];
  int bidx[kSlots];
  // the running pair starts at (+inf, this thread's first centroid), and a
  // candidate replaces it only when strictly smaller: the thread sees its
  // centroids in increasing order, so that is the first minimum (a row
  // whose partials are all +inf or NaN keeps the first centroid, as
  // argmin does; d2 is then +inf)
  const int first = c0 + mrow < c1 ? c0 + mrow : INT_MAX;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) { best[i] = INFINITY; bidx[i] = first; }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  auto stage_step = [&](int st) {
    if (st < steps) {
      const int t = st / nQ, q = st - t * nQ;
      stage_tile<kVec>(ring + (st % kStages) * kCents * stride, stride, C, c1,
                       d, c0 + t * kCents, q * kBK, bk);
    }
    repro_torch::cp_async_commit();   // possibly empty: uniform group count
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) stage_step(st);
  if (npanels == 1) {   // the whole row tile, while the ring fills
    convert_panel<kVec, NR>(Xh, Xl, X, n, d, r0, 0, ksteps);
    // generic-proxy stores, read next by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  float c2a = 0.f, c2b = 0.f;
  for (int st = 0; st < steps; ++st) {
    const int t = st / nQ, q = st - t * nQ;
    repro_torch::cp_async_wait<kStages - 2>();  // step st has landed
    // every thread's copies of step st (and the row tile) are visible, and
    // every warpgroup has finished (waited for) its products of step st - 1,
    // whose slot the next copy refills and, at a panel edge, the row tile
    __syncthreads();
    stage_step(st + kStages - 1);
    const int kq0 = q * (kBK / 8);              // first k-step of the stage
    const int panel = kq0 / (kPanel / 8);
    if (npanels > 1 && kq0 % (kPanel / 8) == 0) {
      const int pk = min(kPanel, Kp - panel * kPanel) / 8;
      convert_panel<kVec, NR>(Xh, Xl, X, n, d, r0, panel, pk);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    if (q == 0) {   // a centroid past the chunk scores +inf: never taken
      const int ca = c0 + t * kCents + mrow;
      c2a = ca < c1 ? __ldg(csq + ca) : INFINITY;
      c2b = ca + 8 < c1 ? __ldg(csq + ca + 8) : INFINITY;
    }
    const float* cs = ring + (st % kStages) * kCents * stride;
    const int nks = min(kBK / 8, ksteps - kq0);
    uint32_t ah[kBK / 8][4], al[kBK / 8][4];
    // one k-step at a time: the next k-step's fragments are loaded and
    // split while the products before it run
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) {
      if (i < nks) {
        const float2 u = *reinterpret_cast<const float2*>(
            cs + mrow * stride + 8 * i + 2 * t4);
        const float2 w = *reinterpret_cast<const float2*>(
            cs + (mrow + 8) * stride + 8 * i + 2 * t4);
        split3(u.x, ah[i][0], al[i][0]);   // (row g,     logical k = t4)
        split3(w.x, ah[i][1], al[i][1]);   // (row g + 8, t4)
        split3(u.y, ah[i][2], al[i][2]);   // (row g,     t4 + 4)
        split3(w.y, ah[i][3], al[i][3]);   // (row g + 8, t4 + 4)
        wgmma_fence();
        const int ks = kq0 + i - panel * (kPanel / 8);   // k-step in panel
        const uint64_t bh = kmajor_desc<NR>(Xh + ks * (NR * 8));
        const uint64_t bl = kmajor_desc<NR>(Xl + ks * (NR * 8));
        wgmma_tf32(acc, al[i], bh, (q > 0 || i > 0) ? 1 : 0);
        wgmma_tf32(acc, ah[i], bl, 1);
        wgmma_tf32(acc, ah[i], bh, 1);
        wgmma_commit();
      }
    }
    wgmma_wait0();
    fence_acc(acc);
    if (q == nQ - 1) {   // centroid tile t complete: fold it in
      const int ca = c0 + t * kCents + mrow, cb = ca + 8;
#pragma unroll
      for (int j = 0; j < NR / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rs = 2 * j + e;
          const float pa = fmaf(-2.f, acc[4 * j + e], c2a);
          const float pb = fmaf(-2.f, acc[4 * j + 2 + e], c2b);
          if (pa < best[rs]) { best[rs] = pa; bidx[rs] = ca; }
          if (pb < best[rs]) { best[rs] = pb; bidx[rs] = cb; }
        }
    }
  }
  repro_torch::cp_async_wait<0>();
  __syncthreads();   // the ring is free: it takes the per-warp results

  float* red_v = ring;                                 // [8 warps][NR]
  int* red_i = reinterpret_cast<int*>(ring + 8 * NR);   // [8 warps][NR]
#pragma unroll
  for (int j = 0; j < NR / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int rs = 2 * j + e;
      float v = best[rs];
      int b = bidx[rs];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {   // the 8 lanes sharing the row
        const float ov = __shfl_xor_sync(kFullMask, v, o);
        const int ob = __shfl_xor_sync(kFullMask, b, o);
        if (better(ov, ob, v, b)) { v = ov; b = ob; }
      }
      if (g == 0) {
        red_v[warp * NR + 8 * j + 2 * t4 + e] = v;
        red_i[warp * NR + 8 * j + 2 * t4 + e] = b;
      }
    }
  __syncthreads();
  if (tid < NR && r0 + tid < n) {
    float v = red_v[tid];
    int b = red_i[tid];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) {
      const float ov = red_v[w * NR + tid];
      const int ob = red_i[w * NR + tid];
      if (better(ov, ob, v, b)) { v = ov; b = ob; }
    }
    const size_t row = (size_t)(r0 + tid);
    if (splits == 1) {
      out_i[row] = b == INT_MAX ? -1 : b;
      out_d[row] = v < INFINITY ? fmaxf(v + xsq[row], 0.f) : INFINITY;
    } else {
      part_v[row * splits + s] = v;
      part_i[row * splits + s] = b;
    }
  }
}

// The S chunk results of each row, in chunk order (the earlier chunk first
// on ties), then d2 once.
__global__ void __launch_bounds__(256)
assign_merge_kernel(const float* __restrict__ part_v,
                    const int* __restrict__ part_i,
                    const float* __restrict__ xsq, int* __restrict__ out_i,
                    float* __restrict__ out_d, int n, int splits) {
  const size_t row = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (size_t)n) return;
  float v = INFINITY;
  int b = INT_MAX;
  for (int s = 0; s < splits; ++s) {
    const float ov = part_v[row * splits + s];
    const int ob = part_i[row * splits + s];
    if (better(ov, ob, v, b)) { v = ov; b = ob; }
  }
  out_i[row] = b == INT_MAX ? -1 : b;
  out_d[row] = v < INFINITY ? fmaxf(v + xsq[row], 0.f) : INFINITY;
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of its launches
// (0 = success; -1 for invalid arguments).  Device pointers of contiguous
// tensors: X (n, d) f32, C (k, d) f32, csq (k,) f32 = ||C_j||², xsq (n,)
// f32 = ||X_i||²; out_i (n,) i32 nearest centroid, out_d (n,) f32 its d2.
// The centroids are cut into splits = ceil(k / chunk) chunks, chunk a
// multiple of 128; with splits > 1, part_v (n, splits) f32 and part_i
// (n, splits) i32 are scratch for the chunk results and a second launch
// merges them.
extern "C" int assign_centroids_launch(const void* X, const void* C,
                                       const void* csq, const void* xsq,
                                       void* out_i, void* out_d, void* part_v,
                                       void* part_i, int n, int k, int d,
                                       int rows, int chunk, int splits,
                                       void* stream) {
  if (k < 1 || d < 0 || (rows != 64 && rows != 128) || chunk < 1 ||
      chunk % kCents != 0 || splits > 65535 ||
      splits != (k + chunk - 1) / chunk ||
      (splits > 1 && (part_v == nullptr || part_i == nullptr)))
    return -1;
  if (n <= 0) return 0;
  cudaGetLastError();  // clear a stale error so the result below is ours
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && repro_torch::aligned16(X) &&
                   repro_torch::aligned16(C);
  auto kern = rows == 64 ? (vec ? assign_tc_kernel<true, 64>
                                : assign_tc_kernel<false, 64>)
                         : (vec ? assign_tc_kernel<true, 128>
                                : assign_tc_kernel<false, 128>);
  const size_t smem = smem_bytes(d, rows);
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3((n + rows - 1) / rows, splits), dim3(kThreads), smem, st>>>(
      static_cast<const float*>(X), static_cast<const float*>(C),
      static_cast<const float*>(csq), static_cast<const float*>(xsq),
      static_cast<int*>(out_i), static_cast<float*>(out_d),
      static_cast<float*>(part_v), static_cast<int*>(part_i), n, k, d, chunk,
      splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  assign_merge_kernel<<<dim3((n + 255) / 256), dim3(256), 0, st>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<const float*>(xsq), static_cast<int*>(out_i),
      static_cast<float*>(out_d), n, splits);
  return static_cast<int>(cudaGetLastError());
}
