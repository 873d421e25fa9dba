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
// and keeps the k smallest with the reference's order: the running list
// before each new tile, rows in row order, a candidate entering only when
// strictly below the k-th entry.  The payload is the packed row position
// (-1 at empty slots); the wrapper gathers ids by position and adds the
// query constant qconst to the selected partials (ivf_scan_adc.py:126-127).
//
// Bound on an H100 SXM: bytes.  Each scanned live row streams its M code
// bytes and its 4-byte vnorm, and each query its M·W·4-byte table once
// (src/repro/launch/roofline.py:73-83, hbm_bytes); a row costs M table
// reads and M adds, far below any compute rate.  The reference's one-hot
// contraction (M·W multiply-adds per row) is a TPU idiom and is not done.
//
// Design: one CTA of 128 threads per query.  The CTA copies its query's
// table (M·W floats: 8 KB at PQ nsub=8, 32 KB at nsub=32, 512 B for int8
// at d=128) into shared memory once, then walks its tiles as csrc/ivf_scan.cu
// does: a thread per row reads the row's id first and never loads a hole;
// a live row's M codes come in 16-, 8- or 4-byte loads (the widest that M
// and the slab's alignment allow), and the thread sums the table entries in
// m order.  A slot that repeats the previous slot's tile when that tile had
// no live row is skipped outright (null-tile padding).  After each tile warp
// 0 merges the partials into the sorted top-k in shared memory
// (common.cuh merge_candidates).  topk <= 1024, M·W <= 32,768 floats.
// Launches on the caller's stream, allocates nothing.

#include <math.h>

#include "common.cuh"

namespace {

using repro_torch::kMaxTopk;
using repro_torch::merge_candidates;

constexpr int kThreads = 128;
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

template <int VW, bool kMul>
__global__ void __launch_bounds__(kThreads)
ivf_scan_adc_kernel(const float* __restrict__ lut,
                    const float* __restrict__ vnorm,
                    const uint8_t* __restrict__ codes,
                    const int* __restrict__ pids,
                    const int* __restrict__ tile_map,
                    int* __restrict__ out_pos, float* __restrict__ out_d,
                    int T, int M, int W, int block_rows, int n_tiles,
                    int topk) {
  extern __shared__ float4 smem4[];
  float* slut = reinterpret_cast<float*>(smem4);             // [M * W]
  const int mw = M * W;
  float* part = slut + mw;                                    // [block_rows]
  int* cpos = reinterpret_cast<int*>(part + block_rows);      // [block_rows]
  float* ld = reinterpret_cast<float*>(cpos + block_rows);    // [topk]
  int* li = reinterpret_cast<int*>(ld + topk);                // [topk]

  const int q = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* qlut = lut + (size_t)q * mw;
  for (int i = threadIdx.x; i < mw; i += kThreads) slut[i] = __ldg(qlut + i);
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
    const int base = tile * block_rows;
    int any = 0;
    for (int r = threadIdx.x; r < block_rows; r += kThreads) {
      const int row = base + r;
      const int id = pids[row];
      float p = INFINITY;
      int ps = -1;
      if (id >= 0) {
        const float acc =
            adc_row<VW, kMul>(codes + (size_t)row * M, M, W, slut);
        p = vnorm[row] + acc;
        ps = row;
        any = 1;
      }
      part[r] = p;
      cpos[r] = ps;
    }
    const int live = __syncthreads_or(any);  // also publishes part / cpos
    prev = tile;
    prev_empty = !live;
    if (!live) continue;
    if (warp == 0) merge_candidates(ld, li, topk, part, cpos, block_rows, lane);
    __syncthreads();
  }

  for (int j = threadIdx.x; j < topk; j += kThreads) {
    const int ps = li[j];
    out_pos[(size_t)q * topk + j] = ps;
    out_d[(size_t)q * topk + j] = ps < 0 ? INFINITY : ld[j];
  }
}

template <int VW, bool kMul>
cudaError_t launch(int nq, size_t smem, cudaStream_t st, const float* lut,
                   const float* vnorm, const uint8_t* codes, const int* pids,
                   const int* tile_map, int* out_pos, float* out_d, int T,
                   int M, int W, int block_rows, int n_tiles, int topk) {
  auto kern = ivf_scan_adc_kernel<VW, kMul>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(nq), dim3(kThreads), smem, st>>>(lut, vnorm, codes, pids,
                                               tile_map, out_pos, out_d, T, M,
                                               W, block_rows, n_tiles, topk);
  return cudaGetLastError();
}

template <bool kMul>
cudaError_t launch_vw(int vw, int nq, size_t smem, cudaStream_t st,
                      const float* lut, const float* vnorm,
                      const uint8_t* codes, const int* pids,
                      const int* tile_map, int* out_pos, float* out_d, int T,
                      int M, int W, int block_rows, int n_tiles, int topk) {
  switch (vw) {
    case 16: return launch<16, kMul>(nq, smem, st, lut, vnorm, codes, pids, tile_map, out_pos, out_d, T, M, W, block_rows, n_tiles, topk);
    case 8: return launch<8, kMul>(nq, smem, st, lut, vnorm, codes, pids, tile_map, out_pos, out_d, T, M, W, block_rows, n_tiles, topk);
    case 4: return launch<4, kMul>(nq, smem, st, lut, vnorm, codes, pids, tile_map, out_pos, out_d, T, M, W, block_rows, n_tiles, topk);
    default: return launch<1, kMul>(nq, smem, st, lut, vnorm, codes, pids, tile_map, out_pos, out_d, T, M, W, block_rows, n_tiles, topk);
  }
}

bool aligned_to(const void* p, unsigned n) {
  return (reinterpret_cast<uintptr_t>(p) % n) == 0;
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 = success; -1 for topk outside [1, 1024], block_rows < 1, M < 1, W < 1
// or M·W above 32,768).  Device pointers of contiguous tensors: lut (nq, M,
// W) f32, vnorm (n_tiles*block_rows,) f32, codes (n_tiles*block_rows, M) u8,
// pids (n_tiles*block_rows,) i32, tile_map (nq, T) i32, out_pos (nq, topk)
// i32, out_d (nq, topk) f32 (the partials without qconst, +inf where
// out_pos is -1).
extern "C" int ivf_scan_adc_launch(const void* lut, const void* vnorm,
                                   const void* codes, const void* pids,
                                   const void* tile_map, void* out_pos,
                                   void* out_d, int nq, int T, int M, int W,
                                   int block_rows, int n_tiles, int topk,
                                   void* stream) {
  if (topk < 1 || topk > kMaxTopk || block_rows < 1 || M < 1 || W < 1 ||
      (long long)M * W > kMaxLut)
    return -1;
  if (nq <= 0) return 0;
  cudaGetLastError();  // clear a stale error so the result below is ours
  const size_t smem =
      (size_t)M * W * sizeof(float) + (size_t)2 * (block_rows + topk) * 4;
  int vw = 1;
  if (M % 16 == 0 && aligned_to(codes, 16)) vw = 16;
  else if (M % 8 == 0 && aligned_to(codes, 8)) vw = 8;
  else if (M % 4 == 0 && aligned_to(codes, 4)) vw = 4;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* L = static_cast<const float*>(lut);
  const auto* V = static_cast<const float*>(vnorm);
  const auto* C = static_cast<const uint8_t*>(codes);
  const auto* P = static_cast<const int*>(pids);
  const auto* TM = static_cast<const int*>(tile_map);
  auto* op = static_cast<int*>(out_pos);
  auto* od = static_cast<float*>(out_d);
  const cudaError_t e =
      W == 1 ? launch_vw<true>(vw, nq, smem, st, L, V, C, P, TM, op, od, T, M,
                               W, block_rows, n_tiles, topk)
             : launch_vw<false>(vw, nq, smem, st, L, V, C, P, TM, op, od, T,
                                M, W, block_rows, n_tiles, topk);
  return static_cast<int>(e);
}
