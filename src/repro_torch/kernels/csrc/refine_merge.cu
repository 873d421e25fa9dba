// refine_merge: candidate distances + top-κ merge for the KNN-graph build.
//
// Replaces the TPU kernel src/repro/kernels/refine_merge.py::refine_merge
// (Pallas; pl.pallas_call at :133, body _kernel at :37).  Same function: for
// each row x (row b), the squared L2 to its C candidate rows of Xsrc as
// max(||y||² + ||x||² − 2x·y, 0) with ||y||² hoisted (refine_merge.py:89-90),
// merged into the row's sorted κ list exactly as
// repro/kernels/ref.py::merge_lists does: κ passes, each a first-minimum
// over the concatenated [old, cand] entries (ties to the lowest position)
// that then retires every entry carrying the selected id.  Ids < 0 count as
// +inf; exhausted slots come out -1/+inf.
//
// Bound on an H100 SXM: the candidate gather.  Xsrc is (N, d) f32 — 512 MB at
// SIFT1M scale (N = 1,048,576, d = 128) — so the rows come from HBM: at the
// main path's shape (B=1024, C=136, d=128) that is B·C·d·4 = 71.3 MB, 21.3 us
// at 3.35 TB/s.  The distances are 2 flops per gathered float and the merge
// is κ·(κ+C) compares per row, both far below the card's compute rates.
//
// Design: one warp per row.  x stays in registers as float4 slices (as in
// gather_score); each valid candidate row is loaded coalesced and reduced
// with warp shuffles, four rows in flight per lane.  Invalid candidates
// (id < 0, or a row index outside [0, N)) are not loaded at all.  The κ+C
// (distance, id) entries live in the warp's slice of shared memory (8 bytes
// an entry: 1.5 KB at κ=50, C=136).  Each merge pass is a lane-strided scan
// for the lane's first minimum, a warp arg-min by (distance, position), and
// a lane-parallel retire of every entry with the winning id.  Launches on the
// caller's stream, allocates nothing.

#include <math.h>

#include "common.cuh"

namespace {

using repro_torch::kFullMask;
using repro_torch::WarpVec;
using repro_torch::warp_sum;

constexpr int kWarps = 4;  // rows per block
constexpr int kRowsInFlight = 4;

template <int NS, bool kAligned>
__global__ void __launch_bounds__(kWarps * 32)
refine_merge_kernel(const float* __restrict__ x, const int* __restrict__ rows,
                    const int* __restrict__ cand_ids,
                    const int* __restrict__ old_ids,
                    const float* __restrict__ old_d,
                    const float* __restrict__ Xsrc,
                    const float* __restrict__ ysq, int* __restrict__ out_ids,
                    float* __restrict__ out_d, int B, int C, int kappa, int d,
                    long long N) {
  extern __shared__ float smem[];
  const int L = kappa + C;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warp leaves; no block-wide barrier follows
  float* ent_d = smem + (size_t)warp * L;
  int* ent_i = reinterpret_cast<int*>(smem + (size_t)kWarps * L) +
               (size_t)warp * L;

  WarpVec<NS, kAligned> xv;
  xv.load(x + (size_t)b * d, d, lane);
  const float xsq = warp_sum(xv.partial_dot(x + (size_t)b * d, d, lane));

  for (int j = lane; j < kappa; j += 32) {
    const int id = old_ids[(size_t)b * kappa + j];
    ent_i[j] = id;
    ent_d[j] = id < 0 ? INFINITY : old_d[(size_t)b * kappa + j];
  }

  const int* rb = rows + (size_t)b * C;
  const int* cb = cand_ids + (size_t)b * C;
  for (int c0 = 0; c0 < C; c0 += kRowsInFlight) {
    int r[kRowsInFlight], id[kRowsInFlight];
    float acc[kRowsInFlight];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j) {
      const bool in = c0 + j < C;
      id[j] = in ? cb[c0 + j] : -1;
      r[j] = in ? rb[c0 + j] : -1;
      const bool ok = id[j] >= 0 && r[j] >= 0 && r[j] < N;
      if (!ok) id[j] = -1;
      acc[j] = ok ? xv.partial_dot(Xsrc + (size_t)r[j] * d, d, lane) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j) acc[j] = warp_sum(acc[j]);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) {
        if (c0 + j >= C) break;
        ent_i[kappa + c0 + j] = id[j];
        ent_d[kappa + c0 + j] =
            id[j] < 0 ? INFINITY : fmaxf(ysq[r[j]] + xsq - 2.f * acc[j], 0.f);
      }
    }
  }
  __syncwarp();

  int* oi = out_ids + (size_t)b * kappa;
  float* od = out_d + (size_t)b * kappa;
  int t = 0;
  for (; t < kappa; ++t) {
    // this lane's first minimum (positions ascend per lane, so a strict <
    // keeps the lowest position among equal distances)
    float best = INFINITY;
    int pos = L;
    for (int j = lane; j < L; j += 32) {
      const float v = ent_d[j];
      if (v < best) { best = v; pos = j; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(kFullMask, best, o);
      const int op = __shfl_xor_sync(kFullMask, pos, o);
      if (ob < best || (ob == best && op < pos)) { best = ob; pos = op; }
    }
    if (!(best < INFINITY)) break;  // warp-uniform: every entry retired
    const int sid = ent_i[pos];
    if (lane == 0) { oi[t] = sid; od[t] = best; }
    __syncwarp();
    for (int j = lane; j < L; j += 32)
      if (j == pos || ent_i[j] == sid) ent_d[j] = INFINITY;
    __syncwarp();
  }
  for (int j = t + lane; j < kappa; j += 32) { oi[j] = -1; od[j] = INFINITY; }
}

template <int NS>
cudaError_t launch(bool aligned, dim3 grid, dim3 block, size_t smem,
                   cudaStream_t st, const float* x, const int* rows,
                   const int* cand_ids, const int* old_ids,
                   const float* old_d, const float* Xsrc, const float* ysq,
                   int* out_ids, float* out_d, int B, int C, int kappa, int d,
                   long long N) {
  auto kern = aligned ? refine_merge_kernel<NS, true>
                      : refine_merge_kernel<NS, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, block, smem, st>>>(x, rows, cand_ids, old_ids, old_d, Xsrc,
                                  ysq, out_ids, out_d, B, C, kappa, d, N);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 = success).  Device pointers of contiguous tensors: x (B, d) f32,
// rows (B, C) i32, cand_ids (B, C) i32, old_ids (B, κ) i32, old_d (B, κ)
// f32, Xsrc (N, d) f32, ysq (N,) f32 = ||Xsrc||² per row, out_ids (B, κ)
// i32, out_d (B, κ) f32.
extern "C" int refine_merge_launch(const void* x, const void* rows,
                                   const void* cand_ids, const void* old_ids,
                                   const void* old_d, const void* Xsrc,
                                   const void* ysq, void* out_ids,
                                   void* out_d, int B, int C, int kappa,
                                   int d, long long N, void* stream) {
  if (B <= 0 || kappa <= 0) return 0;
  cudaGetLastError();  // clear a stale error so the result below is ours
  const size_t smem = (size_t)kWarps * (kappa + C) * (sizeof(float) + sizeof(int));
  const bool aligned = d % 4 == 0 && repro_torch::aligned16(x) &&
                       repro_torch::aligned16(Xsrc);
  const dim3 grid((B + kWarps - 1) / kWarps), block(kWarps * 32);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* ri = static_cast<const int*>(rows);
  const auto* ci = static_cast<const int*>(cand_ids);
  const auto* oi = static_cast<const int*>(old_ids);
  const auto* odf = static_cast<const float*>(old_d);
  const auto* Xf = static_cast<const float*>(Xsrc);
  const auto* yf = static_cast<const float*>(ysq);
  auto* outi = static_cast<int*>(out_ids);
  auto* outd = static_cast<float*>(out_d);
  cudaError_t e;
  switch (repro_torch::slices_for(d)) {
    case 1: e = launch<1>(aligned, grid, block, smem, st, xf, ri, ci, oi, odf, Xf, yf, outi, outd, B, C, kappa, d, N); break;
    case 2: e = launch<2>(aligned, grid, block, smem, st, xf, ri, ci, oi, odf, Xf, yf, outi, outd, B, C, kappa, d, N); break;
    case 4: e = launch<4>(aligned, grid, block, smem, st, xf, ri, ci, oi, odf, Xf, yf, outi, outd, B, C, kappa, d, N); break;
    case 8: e = launch<8>(aligned, grid, block, smem, st, xf, ri, ci, oi, odf, Xf, yf, outi, outd, B, C, kappa, d, N); break;
    default: e = launch<0>(aligned, grid, block, smem, st, xf, ri, ci, oi, odf, Xf, yf, outi, outd, B, C, kappa, d, N); break;
  }
  return static_cast<int>(e);
}
