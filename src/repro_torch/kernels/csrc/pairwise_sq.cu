// pairwise_sq: batched within-cluster squared-L2 distance matrices.
//
// Replaces the TPU kernel src/repro/kernels/pairwise_topk.py::pairwise_sq
// (Pallas; pl.pallas_call at :62, body _kernel at :22).  Same function: for
// Xb (B, m, d) in float32 or bfloat16, cast to f32 on load,
//   D[b,i,j] = max(||x_i||² + ||x_j||² − 2 x_i·x_j, 0),   (B, m, m) float32,
// with the clamp applied once, after the whole d sum.  The reference's
// d_tile=512 feature chunks and bB clusters per grid step are TPU layout
// knobs with no effect on the result.
//
// Bound on an H100 SXM: traffic.  The function needs one triangle of each
// symmetric D[b], diagonal included: B·m(m+1)/2 dots of d multiply-adds,
// against B·m·d input elements read once and B·m² floats written once.  At
// SIFT1M's graph-build shape (B=15,625, m=64, d=128, f32) that is 8.3 GFLOP
// (0.124 ms at the 67 TFLOP/s f32 rate) against 0.77 GB (0.229 ms at
// 3.35 TB/s); bf16 input is bounded by bytes too (tensor-core rate).
//
// Design: one CTA per (cluster, unordered pair of 64-row tiles ti <= tj),
// both on gridDim.x (B reaches 156,250 at VLAD10M, past the y/z limit of
// 65,535); pair_of() maps the linear index to the pair (row-major over the
// upper triangle; kernels/pairwise_sq.py has the same map for the host).
// Every element is computed once and written to (i, j) and (j, i), so each
// D[b] is exactly symmetric by construction; a diagonal pair stages its 64
// rows once and computes only the blocks on or above the diagonal.  (A
// CTA per pair, not a persistent loop: on the H100 the persistent variants
// measured slower.)  Rows
// and features past m and d are zero-filled, rows and columns past m not
// stored, offsets 64-bit: any m >= 1 and d >= 0.
//
// f32 (FP32 FMAs, no TF32: these distances rank neighbours, and 3xTF32
// leaves little margin under 1e-5·(||x_i||² + ||x_j||²) at GIST's d = 960;
// one triangle at the FP32 rate is under the byte bound at every shape).
// A CTA of 160 threads (m <= 64: three CTAs an SM) or 256 (m > 64).
// 64-feature slices of the staged rows (64 for a diagonal pair, 128
// otherwise; 256 bytes a row) come through a 2-stage ring of 16-byte
// cp.async copies (4-byte ones for unaligned rows), row-major with a
// stride of 68 floats.  A thread owns an 8x8 block of the tile (rows and
// columns {4g..4g+3, 32+4g..+3} of block g) and one of four feature
// residues q (4-feature chunks c with c % 4 == q): it reads its 8 rows and
// 8 columns of a chunk as 16 float4s per 256 FMAs (a quarter of a shared
// float per FMA; a quarter warp's loads, two blocks x four residues, hit
// distinct bank groups).  A diagonal pair has the 36 blocks on or above
// the diagonal (144 threads), an off-diagonal one all 64.  The four
// residues of a block sit in neighbouring lanes and are summed by two
// shuffles, ((p0 + p1) + (p2 + p3)) in every lane.  A diagonal pair takes
// each row's norm from its diagonal block (x·x by the same sums, so
// D[i][i] is exactly 0); an off-diagonal pair sums them one thread a row,
// feature by feature in order, from the same slices.  The tile (and its
// mirror) goes through shared memory and out in whole rows.
//
// bf16 (tensor cores): a bf16 x bf16 product is exact in f32, so only the
// order of the f32 sums differs from the plain version.  128 threads (4
// warps); 64-feature slices of the rows, row-major with a 144-byte stride,
// come through a 3-stage ring (16-byte cp.async when rows are 16-byte
// aligned, plain loads otherwise); each warp takes 16x16 blocks of the tile
// (10 on or above the diagonal, or all 16) and runs mma.sync m16n8k16 with
// ldmatrix fragments and f32 accumulators.  A diagonal block writes only
// its entries on or above the diagonal, to both places.
//
// Epilogue: fmaf(-2, dot, ||x_i||² + ||x_j||²), then the clamp (NaN passes
// through, as torch.clamp), then the stores.  Launches on the caller's
// stream, allocates nothing.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::kFullMask;

constexpr int TM = 64;          // rows (and columns) per tile

// The pair (ti <= tj) of linear index p over nt tiles, row-major over the
// upper triangle: p = 0 .. nt(nt+1)/2 - 1.
__device__ __forceinline__ void pair_of(int p, int nt, int& ti, int& tj) {
  ti = 0;
  while (p >= nt - ti) {
    p -= nt - ti;
    ++ti;
  }
  tj = ti + p;
}

// ------------------------------------------------------------------ f32

constexpr int FK = 64;          // features per stage (256 bytes a row)
constexpr int kFStages = 2;
constexpr int kFs = FK + 4;     // staged row stride: 68 floats
constexpr int kOs = TM + 4;     // staged output row stride: 68 floats

__host__ __device__ constexpr int f32_threads(bool pair) {
  return pair ? 256 : 160;
}
constexpr size_t f32_smem(bool pair) {
  return ((size_t)kFStages * (pair ? 2 : 1) * TM * kFs +
          (pair ? 2 : 1) * TM) * sizeof(float);
}

// Rows/columns of block g of a tile: {4g + i, 32 + 4g + i - 4}.
__device__ __forceinline__ int sub(int g, int i) {
  return i < 4 ? 4 * g + i : 32 + 4 * g + (i - 4);
}

// kPair = false: m <= 64, one tile a cluster, 160 threads, three CTAs an
// SM.  kPair = true: m > 64, any tile pair, 256 threads (an off-diagonal
// pair stages both tiles, rows 64..127 of a stage holding tile tj).  kVec:
// 16-byte rows (d % 4 == 0 and an aligned base), else 4-byte copies.
template <bool kVec, bool kPair>
__global__ void __launch_bounds__(f32_threads(kPair), kPair ? 2 : 3)
pairwise_sq_f32_kernel(const float* __restrict__ X, float* __restrict__ out,
                       int m, int d, int nt, int pairs) {
  constexpr int kThreads = f32_threads(kPair);
  constexpr int kRows = (kPair ? 2 : 1) * TM;          // rows a stage holds
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                  // [st][kRows][kFs]
  float* nrm = ring + kFStages * kRows * kFs;          // [kRows]

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x / pairs;
  int ti, tj;
  pair_of(blockIdx.x - static_cast<int>(b) * pairs, nt, ti, tj);
  const bool diag = ti == tj;
  const int R = diag ? TM : 2 * TM;                    // rows staged
  const int i0 = ti * TM, j0 = tj * TM;
  const int jb = diag ? 0 : TM;                        // tile tj's rows
  const float* xb = X + b * m * d;
  const int nE = (d + FK - 1) / FK;

  const int blk = tid >> 2, q = tid & 3;
  const bool active = !diag || blk < 36;   // 36 blocks on or above the
  int a, c;                                // diagonal, or all 64
  if (diag) {
    pair_of(active ? blk : 0, 8, a, c);
  } else {
    a = blk >> 3;
    c = blk & 7;
  }
  // an off-diagonal pair sums its rows' norms, one thread a row
  const bool norm_t = !diag && tid < R;
  float nsum = 0.f;

  auto stage = [&](int s) {
    if (s < nE) {
      float* buf = ring + (s % kFStages) * kRows * kFs;
      const int e0 = s * FK;
      if constexpr (kVec) {
        for (int it = tid; it < R * (FK / 4); it += kThreads) {
          const int r = it / (FK / 4), c4 = it % (FK / 4), e = e0 + 4 * c4;
          const int grow = r < TM ? i0 + r : j0 + (r - TM);
          const bool ok = grow < m && e < d;
          const float* src =
              ok ? xb + static_cast<int64_t>(grow) * d + e : X;
          const unsigned sa = static_cast<unsigned>(
              __cvta_generic_to_shared(buf + r * kFs + 4 * c4));
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                           sa),
                       "l"(src), "r"(ok ? 16 : 0));
        }
      } else {
        for (int it = tid; it < R * FK; it += kThreads) {
          const int r = it / FK, e = e0 + it % FK;
          const int grow = r < TM ? i0 + r : j0 + (r - TM);
          const bool ok = grow < m && e < d;
          const float* src =
              ok ? xb + static_cast<int64_t>(grow) * d + e : X;
          repro_torch::cp_async4(buf + r * kFs + it % FK, src, ok ? 4 : 0);
        }
      }
    }
    repro_torch::cp_async_commit();   // possibly empty: uniform group count
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) stage(s);
  for (int s = 0; s < nE; ++s) {
    repro_torch::cp_async_wait<kFStages - 2>();   // slice s has landed
    // every thread's copies of slice s are visible, and every thread is
    // done with the slot that slice s + kFStages - 1 refills
    __syncthreads();
    stage(s + kFStages - 1);
    const float* T = ring + (s % kFStages) * kRows * kFs;
    if (active) {
#pragma unroll
      for (int h = 0; h < FK / 16; ++h) {   // this residue's chunks
        const int e = 4 * (q + 4 * h);
        float4 ar[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          ar[i] = *reinterpret_cast<const float4*>(T + sub(a, i) * kFs + e);
#pragma unroll
        for (int jh = 0; jh < 4; ++jh) {   // two columns at a time
          float4 br[2];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            br[jj] = *reinterpret_cast<const float4*>(
                T + (jb + sub(c, 2 * jh + jj)) * kFs + e);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              float& t = acc[i][2 * jh + jj];
              t = fmaf(ar[i].x, br[jj].x, t);
              t = fmaf(ar[i].y, br[jj].y, t);
              t = fmaf(ar[i].z, br[jj].z, t);
              t = fmaf(ar[i].w, br[jj].w, t);
            }
        }
      }
    }
    if (norm_t) {
#pragma unroll
      for (int k4 = 0; k4 < FK / 4; ++k4) {
        const float4 v =
            *reinterpret_cast<const float4*>(T + tid * kFs + 4 * k4);
        nsum = fmaf(v.x, v.x, nsum);
        nsum = fmaf(v.y, v.y, nsum);
        nsum = fmaf(v.z, v.z, nsum);
        nsum = fmaf(v.w, v.w, nsum);
      }
    }
  }
  repro_torch::cp_async_wait<0>();
  // the four residues of a block: lanes 4·blk .. 4·blk + 3 (whole warps
  // take part; a block's lanes are all active or all idle)
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float v = acc[i][jj];
      v += __shfl_xor_sync(kFullMask, v, 1);
      v += __shfl_xor_sync(kFullMask, v, 2);
      acc[i][jj] = v;
    }
  // a diagonal pair takes each row's norm from its diagonal block (x·x by
  // the same sums as the other dots, so D[i][i] is exactly 0)
  const bool self = diag && active && a == c;
  if (self && q == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) nrm[sub(a, i)] = acc[i][i];
  }
  if (norm_t) nrm[tid] = nsum;
  __syncthreads();   // the norms, and the ring is free

  // the pair's tile (i, j), and for an off-diagonal pair its mirror (j, i),
  // through shared memory, then out in whole rows: lane q puts rows 2q,
  // 2q+1 of the block, and off the diagonal the mirrored rows (block
  // columns) 2q, 2q+1
  float* O = ring;                                     // [64][kOs]
  float* Om = diag ? O : O + TM * kOs;                 // the mirror
  if (active) {
    float ni[8], nj[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ni[i] = nrm[sub(a, i)];
      nj[i] = nrm[jb + sub(c, i)];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float v = fmaf(-2.f, acc[i][jj], ni[i] + nj[jj]);
        acc[i][jj] = v < 0.f ? 0.f : v;  // NaN passes, as torch.clamp
      }
    if (self) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < i; ++jj) acc[i][jj] = acc[jj][i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if ((i >> 1) != q) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float4*>(O + sub(a, i) * kOs + 32 * h + 4 * c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
        if (!self)
          *reinterpret_cast<float4*>(Om + sub(c, i) * kOs + 32 * h + 4 * a) =
              make_float4(acc[4 * h][i], acc[4 * h + 1][i],
                          acc[4 * h + 2][i], acc[4 * h + 3][i]);
      }
    }
  }
  __syncthreads();
  float* ob = out + b * m * m;
  const int ni = min(TM, m - i0), nj = min(TM, m - j0);  // rows, columns
  for (int t = 0; t < (diag ? 1 : 2); ++t) {
    const float* src = t == 0 ? O : Om;
    const int r0 = t == 0 ? i0 : j0, c0 = t == 0 ? j0 : i0;
    const int nr = t == 0 ? ni : nj, nc = t == 0 ? nj : ni;
    if (m % 4 == 0) {   // 16-byte aligned rows and column groups
      const int per = nc / 4;
      for (int it = tid; it < nr * per; it += kThreads) {
        const int r = it / per, c4 = it - r * per;
        *reinterpret_cast<float4*>(ob + static_cast<int64_t>(r0 + r) * m +
                                   c0 + 4 * c4) =
            *reinterpret_cast<const float4*>(src + r * kOs + 4 * c4);
      }
    } else {
      for (int it = tid; it < nr * nc; it += kThreads) {
        const int r = it / nc, cc = it - r * nc;
        ob[static_cast<int64_t>(r0 + r) * m + c0 + cc] = src[r * kOs + cc];
      }
    }
  }
}

// ----------------------------------------------------------------- bf16

constexpr int kBfThreads = 128;
constexpr int BK16 = 64;        // features per stage
constexpr int kBs = 72;         // row stride in bf16 elements (144 bytes)
constexpr int kBfStages = 3;

constexpr size_t bf16_smem() {
  return (size_t)kBfStages * 2 * TM * kBs * sizeof(uint16_t) +
         2 * TM * sizeof(float);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kVec: rows 16-byte aligned (d % 8 == 0 and an aligned base).
template <bool kVec>
__global__ void __launch_bounds__(kBfThreads)
pairwise_sq_bf16_kernel(const uint16_t* __restrict__ X,
                        float* __restrict__ out, int m, int d, int nt,
                        int pairs) {
  extern __shared__ __align__(16) uint16_t sm16[];
  uint16_t* ring = sm16;                                   // [st][128][kBs]
  float* nrm = reinterpret_cast<float*>(ring + kBfStages * 2 * TM * kBs);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t b = blockIdx.x / pairs;
  int ti, tj;
  pair_of(blockIdx.x - static_cast<int>(b) * pairs, nt, ti, tj);
  const bool diag = ti == tj;
  const int R = diag ? TM : 2 * TM;
  const int i0 = ti * TM, j0 = tj * TM;
  const int jb = diag ? 0 : TM;
  const uint16_t* xb = X + b * m * d;
  const int nE = (d + BK16 - 1) / BK16;
  const int nblk = diag ? 10 : 16;           // 16x16 blocks of the pair

  float acc[4][2][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][h][e] = 0.f;
  float nsum = 0.f;

  auto stage = [&](int s) {
    if (s < nE) {
      uint16_t* buf = ring + (s % kBfStages) * 2 * TM * kBs;
      const int e0 = s * BK16;
      if constexpr (kVec) {
        for (int it = tid; it < R * (BK16 / 8); it += kBfThreads) {
          const int r = it >> 3, e = e0 + 8 * (it & 7);
          const int grow = r < TM ? i0 + r : j0 + (r - TM);
          const bool ok = grow < m && e < d;
          const uint16_t* src =
              ok ? xb + static_cast<int64_t>(grow) * d + e : X;
          const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(
              buf + r * kBs + 8 * (it & 7)));
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                           sa),
                       "l"(src), "r"(ok ? 16 : 0));
        }
      } else {
        for (int it = tid; it < R * BK16; it += kBfThreads) {
          const int r = it / BK16, e = e0 + it % BK16;
          const int grow = r < TM ? i0 + r : j0 + (r - TM);
          const bool ok = grow < m && e < d;
          buf[r * kBs + it % BK16] =
              ok ? xb[static_cast<int64_t>(grow) * d + e] : uint16_t(0);
        }
      }
    }
    repro_torch::cp_async_commit();
  };

  // this warp's blocks u: (ba[u], bc[u]) = 16-row block of tile ti, of tj,
  // and the lane's ldmatrix row offsets into a stage (A, then B)
  int ba[4], bc[4], oa[4], ob4[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int blk = warp + 4 * u;
    if (diag) {
      pair_of(blk < nblk ? blk : 0, 4, ba[u], bc[u]);
    } else {
      ba[u] = blk >> 2;
      bc[u] = blk & 3;
    }
    oa[u] = (16 * ba[u] + (lane & 15)) * kBs + 8 * (lane >> 4);
    ob4[u] = (jb + 16 * bc[u] + (lane & 7) + 8 * (lane >> 4)) * kBs +
             8 * ((lane >> 3) & 1);
  }

#pragma unroll
  for (int s = 0; s < kBfStages - 1; ++s) stage(s);
  for (int s = 0; s < nE; ++s) {
    repro_torch::cp_async_wait<kBfStages - 2>();
    __syncthreads();
    stage(s + kBfStages - 1);
    const uint16_t* T = ring + (s % kBfStages) * 2 * TM * kBs;
#pragma unroll
    for (int kk = 0; kk < BK16 / 16; ++kk) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (warp + 4 * u >= nblk) continue;   // warp-uniform
        uint32_t af[4], bf[4];
        ldmatrix_x4(af, T + oa[u] + 16 * kk);
        ldmatrix_x4(bf, T + ob4[u] + 16 * kk);
        mma_bf16(acc[u][0], af, bf[0], bf[1]);
        mma_bf16(acc[u][1], af, bf[2], bf[3]);
      }
    }
    if (tid < R) {
      const uint16_t* row = T + tid * kBs;
#pragma unroll
      for (int k8 = 0; k8 < BK16 / 8; ++k8) {
        const uint4 w = *reinterpret_cast<const uint4*>(row + 8 * k8);
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {   // little-endian: the low half first
          const float lo = __uint_as_float(ws[h] << 16);
          const float hi = __uint_as_float(ws[h] & 0xffff0000u);
          nsum = fmaf(lo, lo, nsum);
          nsum = fmaf(hi, hi, nsum);
        }
      }
    }
  }
  repro_torch::cp_async_wait<0>();
  if (tid < R) nrm[tid] = nsum;
  __syncthreads();

  float* ob = out + b * m * m;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (warp + 4 * u >= nblk) continue;
    const int a = ba[u], c = bc[u];
    const bool self = diag && a == c;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = 16 * a + g + 8 * (e >> 1);          // row in tile ti
        const int cl = 16 * c + 8 * h + 2 * t4 + (e & 1);  // column in tj
        const int row = i0 + rl, col = j0 + cl;
        if (row >= m || col >= m || (self && rl > cl)) continue;
        const float s = fmaf(-2.f, acc[u][h][e], nrm[rl] + nrm[jb + cl]);
        const float v = s < 0.f ? 0.f : s;
        ob[static_cast<int64_t>(row) * m + col] = v;
        if (row != col) ob[static_cast<int64_t>(col) * m + row] = v;
      }
  }
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 = success; -1 for a negative size or more than INT_MAX CTAs).  Xb:
// device pointer of a contiguous (B, m, d) tensor, float32 (bf16 = 0) or
// bfloat16 (bf16 = 1); out: contiguous, 16-byte aligned (B, m, m) float32.
extern "C" int pairwise_sq_launch(const void* Xb, void* out, int B, int m,
                                  int d, int bf16, void* stream) {
  if (B < 0 || m < 0 || d < 0) return -1;
  if (B == 0 || m == 0) return 0;
  const long long nt = (m + TM - 1) / TM;
  const long long pairs = nt * (nt + 1) / 2;
  const long long blocks = static_cast<long long>(B) * pairs;
  if (blocks > INT_MAX) return -1;
  cudaGetLastError();  // clear a stale error so the result below is ours
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaError_t e;
  if (bf16) {
    const bool vec = repro_torch::aligned16(Xb) && d % 8 == 0;
    auto kern =
        vec ? pairwise_sq_bf16_kernel<true> : pairwise_sq_bf16_kernel<false>;
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bf16_smem());
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, dim3(kBfThreads), bf16_smem(), st>>>(
        static_cast<const uint16_t*>(Xb), o, m, d, static_cast<int>(nt),
        static_cast<int>(pairs));
  } else {
    const bool vec = repro_torch::aligned16(Xb) && d % 4 == 0;
    const bool pair = nt > 1;
    auto kern = pair ? (vec ? pairwise_sq_f32_kernel<true, true>
                            : pairwise_sq_f32_kernel<false, true>)
                     : (vec ? pairwise_sq_f32_kernel<true, false>
                            : pairwise_sq_f32_kernel<false, false>);
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)f32_smem(pair));
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, dim3(f32_threads(pair)), f32_smem(pair), st>>>(
        static_cast<const float*>(Xb), o, m, d, static_cast<int>(nt),
        static_cast<int>(pairs));
  }
  return static_cast<int>(cudaGetLastError());
}
