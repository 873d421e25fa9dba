// gather_score: candidate-row gather + move scoring for the clustering engine.
//
// Replaces the TPU kernel src/repro/kernels/gather_score.py::gather_score
// (Pallas; pl.pallas_call at :125, body _kernel at :40).  Same function: for
// each sample x (row b) with source cluster u[b] and C candidate clusters
// cand[b, :], take x·D[row] for the C+1 rows (u first) and apply the
// arithmetic of repro/kernels/ref.py::scores_from_dots.  mode 0 ('bkm')
// gives ΔI (paper Eqn. 3, self-moves not masked); mode 1 ('lloyd') gives the
// candidate-centroid distance minus ||x||², +inf for an empty cluster.
// ||D_k||² (dsq) and cnt are (k,) vectors hoisted outside the kernel, as the
// JAX wrapper hoists them (gather_score.py:90-110).
//
// Bound on an H100 SXM: a gather-bound batched GEMV (2 flops per gathered
// float), far below the tensor cores' line.  At the main path's shape
// (B=1024, C=50, d=128, k=16384) the gathered row traffic is
// B·(C+1)·d·4 = 26.7 MB, i.e. 8.0 us at the 3.35 TB/s HBM rate; but D is
// only k·d·4 = 8.4 MB, which stays in the 50 MB L2 across the engine's
// batches, so the repeated rows are L2 hits and the HBM bound is the unique
// bytes (x, ids, D once, out): about 9 MB, 2.7 us.
//
// Design: one warp per sample, no shared memory.  The warp holds x in
// registers as float4 slices over d (lane l owns slices l, l+32, ...); for
// each of the C+1 rows it loads D[row] coalesced (16 bytes a lane), reduces
// the dot with warp shuffles, and lane 0 applies the scores arithmetic in
// registers.  Rows are taken four at a time so each lane has four
// independent loads in flight.  A d % 4 tail (or an unaligned base) is
// masked element by element; d > 1024 re-reads x from L1 instead of
// registers.  Launches on the caller's stream, allocates nothing.

#include <math.h>

#include "common.cuh"

namespace {

using repro_torch::WarpVec;
using repro_torch::warp_sum;

constexpr int kWarps = 4;   // samples per block
constexpr int kRowsInFlight = 4;

template <int NS, bool kAligned>
__global__ void __launch_bounds__(kWarps * 32)
gather_score_kernel(const float* __restrict__ x, const int* __restrict__ u,
                    const int* __restrict__ cand, const float* __restrict__ D,
                    const float* __restrict__ cnt,
                    const float* __restrict__ dsq, float* __restrict__ out,
                    int B, int C, int d, int k, int lloyd) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;

  WarpVec<NS, kAligned> xv;
  xv.load(x + (size_t)b * d, d, lane);
  const float xsq = warp_sum(xv.partial_dot(x + (size_t)b * d, d, lane));

  // source-cluster terms (slot 0): only the bkm score uses them
  float loss_u = 0.f;
  if (!lloyd) {
    const int ub = u[b];
    const bool ok = ub >= 0 && ub < k;
    const float xd_u = warp_sum(
        ok ? xv.partial_dot(D + (size_t)(ok ? ub : 0) * d, d, lane) : 0.f);
    const float nu = ok ? cnt[ub] : 0.f;
    const float dsq_u = ok ? dsq[ub] : 0.f;
    const float num_u = dsq_u - 2.0f * xd_u + xsq;
    const float resid = nu > 1.f ? num_u / fmaxf(nu - 1.f, 1.f) : 0.f;
    loss_u = ok ? resid - dsq_u / fmaxf(nu, 1.f) : NAN;
  }

  const int* cb = cand + (size_t)b * C;
  float* ob = out + (size_t)b * C;
  for (int c0 = 0; c0 < C; c0 += kRowsInFlight) {
    int v[kRowsInFlight];
    float acc[kRowsInFlight];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j) {
      v[j] = c0 + j < C ? cb[c0 + j] : -1;
      const bool ok = v[j] >= 0 && v[j] < k;
      acc[j] = ok ? xv.partial_dot(D + (size_t)v[j] * d, d, lane) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j) acc[j] = warp_sum(acc[j]);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) {
        if (c0 + j >= C) break;
        if (v[j] < 0 || v[j] >= k) {  // out-of-range candidate id
          ob[c0 + j] = NAN;
          continue;
        }
        const float nv = cnt[v[j]];
        const float dv = dsq[v[j]];
        const float xd = acc[j];
        float s;
        if (lloyd) {
          const float inv = 1.f / fmaxf(nv, 1.f);
          s = nv > 0.f ? dv * (inv * inv) - 2.f * (xd * inv) : INFINITY;
        } else {
          const float gain = (dv + 2.f * xd + xsq) / (nv + 1.f) -
                             (nv > 0.f ? dv / fmaxf(nv, 1.f) : 0.f);
          s = gain + loss_u;
        }
        ob[c0 + j] = s;
      }
    }
  }
}

template <int NS>
void launch(bool aligned, dim3 grid, dim3 block, cudaStream_t st,
            const float* x, const int* u, const int* cand, const float* D,
            const float* cnt, const float* dsq, float* out, int B, int C,
            int d, int k, int lloyd) {
  if (aligned)
    gather_score_kernel<NS, true><<<grid, block, 0, st>>>(
        x, u, cand, D, cnt, dsq, out, B, C, d, k, lloyd);
  else
    gather_score_kernel<NS, false><<<grid, block, 0, st>>>(
        x, u, cand, D, cnt, dsq, out, B, C, d, k, lloyd);
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 = success).  All pointers are device pointers of contiguous tensors:
// x (B, d) f32, u (B,) i32, cand (B, C) i32, D (k, d) f32, cnt (k,) f32,
// dsq (k,) f32, out (B, C) f32.  mode: 0 = bkm, 1 = lloyd.
extern "C" int gather_score_launch(const void* x, const void* u,
                                   const void* cand, const void* D,
                                   const void* cnt, const void* dsq,
                                   void* out, int B, int C, int d, int k,
                                   int mode, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  cudaGetLastError();  // clear a stale error so the check below is ours
  const bool aligned = d % 4 == 0 && repro_torch::aligned16(x) &&
                       repro_torch::aligned16(D);
  const dim3 grid((B + kWarps - 1) / kWarps), block(kWarps * 32);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* ui = static_cast<const int*>(u);
  const auto* ci = static_cast<const int*>(cand);
  const auto* Df = static_cast<const float*>(D);
  const auto* nf = static_cast<const float*>(cnt);
  const auto* sf = static_cast<const float*>(dsq);
  auto* of = static_cast<float*>(out);
  switch (repro_torch::slices_for(d)) {
    case 1: launch<1>(aligned, grid, block, st, xf, ui, ci, Df, nf, sf, of, B, C, d, k, mode); break;
    case 2: launch<2>(aligned, grid, block, st, xf, ui, ci, Df, nf, sf, of, B, C, d, k, mode); break;
    case 4: launch<4>(aligned, grid, block, st, xf, ui, ci, Df, nf, sf, of, B, C, d, k, mode); break;
    case 8: launch<8>(aligned, grid, block, st, xf, ui, ci, Df, nf, sf, of, B, C, d, k, mode); break;
    default: launch<0>(aligned, grid, block, st, xf, ui, ci, Df, nf, sf, of, B, C, d, k, mode); break;
  }
  return static_cast<int>(cudaGetLastError());
}
