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
// symmetric D[b], diagonal included: B·m(m+1)/2 dots of d FMAs, against
// B·m·d input elements read once and B·m² floats written once.  At SIFT1M's
// graph-build shape (B=15,625, m=64, d=128, f32) that is 8.3 GFLOP
// (0.124 ms at the 67 TFLOP/s f32 rate) against 0.77 GB (0.229 ms at
// 3.35 TB/s); bf16 input is bounded by bytes too (tensor-core rate).  Full
// FP32 FMAs, no TF32: these distances rank neighbours.
//
// Design: one CTA of 256 threads per (cluster, 64x64 output tile), cluster
// and tile both on gridDim.x (B reaches 156,250 at VLAD10M, past the y/z
// limit of 65,535).  The tile's 64 i-rows and 64 j-rows are staged in shared
// memory, transposed, in depth slices of 32 (two buffers: the next slice is
// loaded into registers while the current one is multiplied), and each
// thread accumulates a 4x4 block of dots from float4 reads of the two
// slices.  A thread loads 8 consecutive features of one row per slice (one
// 32-byte sector in f32; 16 bytes in bf16, widened to f32 on load) and sums
// their squares as it stores them, so the row norms come out of the same d
// loop; a row's four partial norms are added in a fixed order at the end.
// Epilogue: fmaf(-2, dot, ||x_i||² + ||x_j||²), then the clamp, then the
// store.  Rows >= m and features >= d load as zeros, and rows or columns
// >= m are not stored, so any m >= 1 and d >= 0 work.  Offsets are 64-bit
// (B·m·d passes 2^31 at VLAD10M).  The i- and j-sides run the same
// arithmetic in the same order, so every D[b] comes out exactly symmetric;
// the kernel still computes both halves (using the symmetry, wgmma and TMA
// belong to a later redesign).  Launches on the caller's stream, allocates
// nothing.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TM = 64;                  // rows (and columns) per output tile
constexpr int BK = 32;                  // depth per shared-memory slice
constexpr int kThreads = 256;
constexpr int kParts = kThreads / TM;   // loaders per row
constexpr int kPer = BK / kParts;       // features each loader moves (8)

// Features e..e+7 of one row as f32, zeros past d.  T is float or the raw
// 16-bit bfloat16 word.  kVec: 16-byte aligned rows, and d % 4 == 0 (f32)
// or d % 8 == 0 (bf16), so e < d puts each whole vector in range.
template <typename T, bool kVec>
__device__ __forceinline__ void load8(const T* __restrict__ row, int e, int d,
                                      float (&v)[kPer]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (kVec) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 a =
          e < d ? __ldg(reinterpret_cast<const float4*>(row + e)) : z;
      const float4 b =
          e + 4 < d ? __ldg(reinterpret_cast<const float4*>(row + e + 4)) : z;
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) v[k] = e + k < d ? __ldg(row + e + k) : 0.f;
    }
  } else {
    if constexpr (kVec) {
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (e < d) w = __ldg(reinterpret_cast<const uint4*>(row + e));
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // little-endian: element 2k is the low half
        v[2 * k] = __uint_as_float(ws[k] << 16);
        v[2 * k + 1] = __uint_as_float(ws[k] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        v[k] = e + k < d
                   ? __uint_as_float(static_cast<uint32_t>(__ldg(row + e + k))
                                     << 16)
                   : 0.f;
    }
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void fetch(const T* __restrict__ row, bool live,
                                      int e, int d, float (&v)[kPer]) {
  if (live) {
    load8<T, kVec>(row, e, d, v);
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = 0.f;
  }
}

// Store a loader's 8 features into column lr of the transposed slice and
// add their squares to its running norm.
__device__ __forceinline__ void stash(float (*S)[TM], const float (&v)[kPer],
                                      float& nrm, int lr, int part) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    S[part * kPer + k][lr] = v[k];
    nrm = fmaf(v[k], v[k], nrm);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
pairwise_sq_kernel(const T* __restrict__ X, float* __restrict__ out, int m,
                   int d, int nt) {
  __shared__ __align__(16) float As[2][BK][TM];
  __shared__ __align__(16) float Bs[2][BK][TM];
  __shared__ float Ns[2][kParts][TM];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tiles = nt * nt;
  const int64_t b = blockIdx.x / tiles;
  const int t = blockIdx.x - static_cast<int>(b) * tiles;
  const int i0 = (t / nt) * TM, j0 = (t % nt) * TM;
  const int lr = tid & (TM - 1), part = tid / TM;  // loader: row, feature part
  const T* xb = X + b * m * d;
  const bool live_a = i0 + lr < m, live_b = j0 + lr < m;
  const T* arow = xb + static_cast<int64_t>(i0 + lr) * d;
  const T* brow = xb + static_cast<int64_t>(j0 + lr) * d;
  const int nE = (d + BK - 1) / BK;

  float va[kPer], vb[kPer];
  float na = 0.f, nb = 0.f;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  fetch<T, kVec>(arow, live_a, part * kPer, d, va);
  fetch<T, kVec>(brow, live_b, part * kPer, d, vb);
  stash(As[0], va, na, lr, part);
  stash(Bs[0], vb, nb, lr, part);
  __syncthreads();

  for (int c = 0; c < nE; ++c) {
    const int buf = c & 1;
    const bool more = c + 1 < nE;
    if (more) {
      const int e = (c + 1) * BK + part * kPer;
      fetch<T, kVec>(arow, live_a, e, d, va);
      fetch<T, kVec>(brow, live_b, e, d, vb);
    }
#pragma unroll
    for (int e = 0; e < BK; ++e) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[buf][e][4 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[buf][e][4 * tx]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    if (more) {  // buf^1 was last read before the barrier ending slice c-1
      stash(As[buf ^ 1], va, na, lr, part);
      stash(Bs[buf ^ 1], vb, nb, lr, part);
    }
    __syncthreads();
  }

  Ns[0][part][lr] = na;
  Ns[1][part][lr] = nb;
  __syncthreads();
  float si[4], sj[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 4 * ty + k, q = 4 * tx + k;
    si[k] = ((Ns[0][0][r] + Ns[0][1][r]) + Ns[0][2][r]) + Ns[0][3][r];
    sj[k] = ((Ns[1][0][q] + Ns[1][1][q]) + Ns[1][2][q]) + Ns[1][3][q];
  }
  float* ob = out + b * m * m;
  const int col = j0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + 4 * ty + i;
    if (row >= m) break;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s = fmaf(-2.f, acc[i][j], si[i] + sj[j]);
      v[j] = s < 0.f ? 0.f : s;  // NaN passes through, as torch.clamp
    }
    float* orow = ob + static_cast<int64_t>(row) * m;
    // m % 4 == 0 keeps every row and col 16-byte aligned in the wrapper's
    // freshly allocated output
    if (m % 4 == 0 && col + 3 < m) {
      *reinterpret_cast<float4*>(orow + col) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < m) orow[col + j] = v[j];
    }
  }
}

template <typename T>
cudaError_t launch(const void* Xb, float* out, unsigned blocks, int m, int d,
                   int nt, cudaStream_t st) {
  const T* x = static_cast<const T*>(Xb);
  const bool vec = repro_torch::aligned16(Xb) &&
                   d % (sizeof(T) == 4 ? 4 : 8) == 0;
  const dim3 grid(blocks), block(kThreads);
  if (vec)
    pairwise_sq_kernel<T, true><<<grid, block, 0, st>>>(x, out, m, d, nt);
  else
    pairwise_sq_kernel<T, false><<<grid, block, 0, st>>>(x, out, m, d, nt);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 = success; -1 for a negative size or more than INT_MAX tiles).  Xb:
// device pointer of a contiguous (B, m, d) tensor, float32 (bf16 = 0) or
// bfloat16 (bf16 = 1); out: contiguous, 16-byte aligned (B, m, m) float32.
extern "C" int pairwise_sq_launch(const void* Xb, void* out, int B, int m,
                                  int d, int bf16, void* stream) {
  if (B < 0 || m < 0 || d < 0) return -1;
  if (B == 0 || m == 0) return 0;
  const long long nt = (m + TM - 1) / TM;
  const long long blocks = static_cast<long long>(B) * nt * nt;
  if (blocks > INT_MAX) return -1;
  cudaGetLastError();  // clear a stale error so the result below is ours
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch<uint16_t>(Xb, o, static_cast<unsigned>(blocks), m, d,
                              static_cast<int>(nt), st)
           : launch<float>(Xb, o, static_cast<unsigned>(blocks), m, d,
                           static_cast<int>(nt), st);
  return static_cast<int>(e);
}
