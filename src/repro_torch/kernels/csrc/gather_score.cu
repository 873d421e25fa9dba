// gather_score: candidate-row gather + move scoring for the clustering engine.
//
// Replaces the TPU kernel src/repro/kernels/gather_score.py::gather_score
// (Pallas; pl.pallas_call at :125, body _kernel at :40; the wrapper at :64).
// Same function: for each sample x (row b) with source cluster u[b] and C
// candidate clusters cand[b, :], take x·D[row] and ||D[row]||² for the C+1
// rows (u first) and apply the arithmetic of repro/kernels/ref.py::
// scores_from_dots.  mode 0 ('bkm') gives ΔI (paper Eqn. 3, self-moves not
// masked); mode 1 ('lloyd') gives the candidate-centroid distance minus
// ||x||², +inf for an empty cluster; an id outside [0, k) scores NaN (a bad
// u makes the sample's whole row NaN in bkm).  ||D_v||² is summed from the
// gathered row itself (v·v beside x·v, in the same pass), not hoisted over
// all k rows as the JAX wrapper does (gather_score.py:90-110): its last ulp
// differs from the plain version's (D*D).sum(-1), an error of the size of
// the dot's own rounding, which the kernel-vs-plain limit (1e-5 of
// ref.score_scale, whose terms include |D_v|²) already covers.
//
// Bound on an H100 SXM: a gather-bound batched GEMV (4 flops per gathered
// float), far below the tensor cores' line.  At the main path's shape
// (B=1024, C=50, d=128, k=16384) D is k·d·4 = 8.4 MB, which stays in the
// 50 MB L2 across the engine's batches, so the HBM bound is the unique bytes
// (x, ids, D once, cnt, out): about 9.4 MB, 2.8 us.  The gathered rows,
// B·(C+1)·d·4 = 26.7 MB, come from L2; at the L2 rate chip_smoke.py
// measures (a 16 MiB copy_, about 4.7 TB/s read + write on an NVIDIA H100
// 80GB HBM3 at 700 W) they take 5.7 us, the practical floor.  The times
// of this kernel and of the earlier one (a warp per sample, 4 rows in
// flight, cnt and ||D_v||² loaded after each row's reduction, norms hoisted
// by the wrapper) stand in PERF.md §6.
//
// Design: spread each sample's rows over many lanes.  A CTA of 8 warps
// takes 2 samples, 4 warps each (4,096 warps at B=1024, against 1,024 when
// a warp held a whole sample; 512 CTAs fit one wave at 4 CTAs an SM).  A
// row goes to a group of `lanes` lanes (8 for d <= 128, 16 for d <= 256, 32
// above: kernels/gather_score.py layout), each lane taking float4 slices
// sub, sub + lanes, ... of the row, so one load instruction of a warp
// reads 32/lanes whole rows of 128 contiguous bytes each; x stays in the
// group's registers the same way (common.cuh WarpVec over `lanes` lanes;
// past 8 slices a lane, d > 1024, it is re-read from L1).  Per chunk of up
// to 256 rows a sample:
//   1. the CTA reads the chunk's ids (u, then cand[b, :]) coalesced into
//      shared memory, in one round trip with x's slices;
//   2. each group takes every R-th row of its sample (R = 4 warps · 32 /
//      lanes: 16 at d=128), two at once for d <= 512 (8 float4 loads in
//      flight a lane at d=128), loads the
//      row's cnt beside it, sums x·v and v·v per lane and reduces them over
//      the group with xor shuffles; the group's first lane stores
//      (x·v, v·v, cnt) in shared memory;
//   3. after a barrier, a thread per candidate applies the scores
//      arithmetic (the same expression as scores_from_dots, with the source
//      cluster's terms from row 0) and the CTA writes the chunk's scores
//      coalesced.
// No load waits on a reduction: the ids are read first, and cnt and the rows
// after them together.  The wrapper makes this one launch and runs nothing
// else.  An unaligned base or d % 4 != 0 masks element by element.
// Launches on the caller's stream, allocates nothing.

#include <math.h>

#include "common.cuh"

namespace {

using repro_torch::dot4;
using repro_torch::kFullMask;
using repro_torch::load4;
using repro_torch::WarpVec;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpsPerSample = 4;
constexpr int kSamples = kWarps / kWarpsPerSample;  // samples a CTA
constexpr int kChunk = 256;                         // rows a sample a round

// Sum of v over the `lanes` lanes of a row group (xor butterfly).
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// This lane's share of (x·row, row·row): from the row's slices r, loaded
// beforehand (NS > 0), or read here with x (NS == 0).
template <int LANES, int NS, bool kAligned>
__device__ __forceinline__ void dot_sq(const WarpVec<NS, kAligned, LANES>& xv,
                                       const float4* r,
                                       const float* __restrict__ row, int d,
                                       int sub, float& dot, float& sq) {
  dot = 0.f;
  sq = 0.f;
  if (NS > 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      dot += dot4(xv.v[s], r[s]);
      sq += dot4(r[s], r[s]);
    }
  } else {
    for (int e = sub * 4; e < d; e += 4 * LANES) {
      const float4 rv = load4<kAligned>(row, e, d);
      dot += dot4(load4<kAligned>(xv.base, e, d), rv);
      sq += dot4(rv, rv);
    }
  }
}

// LANES lanes a row, NS float4 slices of x a lane, RIF rows in flight a
// group.
template <int LANES, int NS, int RIF, bool kAligned>
__global__ void __launch_bounds__(kThreads, NS == 8 ? 3 : 4)
gather_score_kernel(const float* __restrict__ x, const int* __restrict__ u,
                    const int* __restrict__ cand, const float* __restrict__ D,
                    const float* __restrict__ cnt, float* __restrict__ out,
                    int B, int C, int d, int k, int lloyd) {
  constexpr int kRowsPerWarp = 32 / LANES;
  constexpr int kRowsPerStep = kWarpsPerSample * kRowsPerWarp;
  __shared__ int s_id[kSamples * kChunk];
  __shared__ float s_dot[kSamples * kChunk], s_sq[kSamples * kChunk],
      s_cnt[kSamples * kChunk];
  __shared__ float s_xsq[kSamples], s_udot[kSamples], s_usq[kSamples],
      s_ucnt[kSamples];
  __shared__ int s_uid[kSamples];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sl = warp / kWarpsPerSample, wi = warp % kWarpsPerSample;
  const int g = lane / LANES, sub = lane % LANES;
  const int b0 = blockIdx.x * kSamples;
  const int b = b0 + sl;
  const bool has_b = b < B;

  WarpVec<NS, kAligned, LANES> xv;
  float xsq = 0.f;
  if (has_b) {
    xv.load(x + (size_t)b * d, d, sub);
    xsq = xv.partial_dot(x + (size_t)b * d, d, sub);
  }
  xsq = group_sum<LANES>(xsq);
  if (wi == 0 && lane == 0) s_xsq[sl] = xsq;

  const int R = C + 1;                      // rows a sample: u, then cand
  for (int base = 0; base < R; base += kChunk) {
    const int nrow = min(kChunk, R - base);
    // 1. the chunk's ids, coalesced (lloyd reads no u)
    for (int t = tid; t < kSamples * nrow; t += kThreads) {
      const int s2 = t / nrow, i = t - s2 * nrow, bb = b0 + s2;
      const int gi = base + i;
      int v = -1;
      if (bb < B && !(gi == 0 && lloyd))
        v = gi == 0 ? u[bb] : cand[(size_t)bb * C + gi - 1];
      s_id[s2 * kChunk + i] = v;
    }
    __syncthreads();
    // 2. the rows: x·v, v·v and cnt of each
    for (int w0 = wi * kRowsPerWarp; w0 < nrow; w0 += RIF * kRowsPerStep) {
      float dot[RIF], sq[RIF], nv[RIF];
      float4 r[RIF][NS > 0 ? NS : 1];
      const float* rp[RIF];
      bool ok[RIF];
#pragma unroll
      for (int j = 0; j < RIF; ++j) {       // every load of the step first
        const int i = w0 + g + j * kRowsPerStep;
        const int v = i < nrow ? s_id[sl * kChunk + i] : -1;
        ok[j] = has_b && v >= 0 && v < k;
        rp[j] = D + (size_t)(ok[j] ? v : 0) * d;
        nv[j] = ok[j] && sub == 0 ? __ldg(cnt + v) : 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s)
          r[j][s] = ok[j] ? load4<kAligned>(rp[j], (s * LANES + sub) * 4, d)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < RIF; ++j) {
        dot[j] = 0.f;
        sq[j] = 0.f;
        if (ok[j]) dot_sq(xv, r[j], rp[j], d, sub, dot[j], sq[j]);
      }
#pragma unroll
      for (int j = 0; j < RIF; ++j) {
        dot[j] = group_sum<LANES>(dot[j]);
        sq[j] = group_sum<LANES>(sq[j]);
      }
#pragma unroll
      for (int j = 0; j < RIF; ++j) {
        const int i = w0 + g + j * kRowsPerStep;
        if (sub != 0 || i >= nrow) continue;
        s_dot[sl * kChunk + i] = dot[j];
        s_sq[sl * kChunk + i] = sq[j];
        s_cnt[sl * kChunk + i] = nv[j];
        if (base + i == 0) {                // the source cluster's row
          s_uid[sl] = s_id[sl * kChunk];
          s_udot[sl] = dot[j];
          s_usq[sl] = sq[j];
          s_ucnt[sl] = nv[j];
        }
      }
    }
    __syncthreads();
    // 3. the chunk's scores, a thread a candidate, written coalesced
    for (int t = tid; t < kSamples * nrow; t += kThreads) {
      const int s2 = t / nrow, i = t - s2 * nrow, bb = b0 + s2;
      const int gi = base + i;
      if (gi == 0 || bb >= B) continue;
      const int at = s2 * kChunk + i;
      const int v = s_id[at];
      float s;
      if (v < 0 || v >= k) {                // out-of-range candidate id
        s = NAN;
      } else if (lloyd) {
        const float nv = s_cnt[at], dv = s_sq[at], xd = s_dot[at];
        const float inv = 1.f / fmaxf(nv, 1.f);
        s = nv > 0.f ? dv * (inv * inv) - 2.f * (xd * inv) : INFINITY;
      } else {
        const float nv = s_cnt[at], dv = s_sq[at], xd = s_dot[at];
        const float xq = s_xsq[s2];
        const int ub = s_uid[s2];
        const bool uok = ub >= 0 && ub < k;
        const float nu = s_ucnt[s2], dsq_u = s_usq[s2];
        const float num_u = dsq_u - 2.0f * s_udot[s2] + xq;
        const float resid = nu > 1.f ? num_u / fmaxf(nu - 1.f, 1.f) : 0.f;
        const float loss_u = uok ? resid - dsq_u / fmaxf(nu, 1.f) : NAN;
        const float gain = (dv + 2.f * xd + xq) / (nv + 1.f) -
                           (nv > 0.f ? dv / fmaxf(nv, 1.f) : 0.f);
        s = gain + loss_u;
      }
      out[(size_t)bb * C + gi - 1] = s;
    }
    __syncthreads();                        // before the next chunk's ids
  }
}

struct Args {
  const float* x;
  const int* u;
  const int* cand;
  const float* D;
  const float* cnt;
  float* out;
  int B, C, d, k, lloyd;
};

template <int LANES, int NS, int RIF>
void launch(bool aligned, cudaStream_t st, const Args& a) {
  const dim3 grid((a.B + kSamples - 1) / kSamples);
  auto kern = aligned ? gather_score_kernel<LANES, NS, RIF, true>
                      : gather_score_kernel<LANES, NS, RIF, false>;
  kern<<<grid, kThreads, 0, st>>>(a.x, a.u, a.cand, a.D, a.cnt, a.out, a.B,
                                  a.C, a.d, a.k, a.lloyd);
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 = success; -1 for a (lanes, slices) pair that kernels/gather_score.py
// layout never gives).  All pointers are device pointers of contiguous
// tensors: x (B, d) f32, u (B,) i32, cand (B, C) i32, D (k, d) f32, cnt (k,)
// f32, out (B, C) f32.  mode: 0 = bkm, 1 = lloyd.  lanes: lanes a row (8,
// 16 or 32); slices: float4 slices of x a lane (1, 2, 4, 8, or 0 to re-read
// x), the smallest that covers ceil(ceil(d / 4) / lanes).
extern "C" int gather_score_launch(const void* x, const void* u,
                                   const void* cand, const void* D,
                                   const void* cnt, void* out, int B, int C,
                                   int d, int k, int mode, int lanes,
                                   int slices, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  cudaGetLastError();  // clear a stale error so the check below is ours
  const bool aligned = d % 4 == 0 && repro_torch::aligned16(x) &&
                       repro_torch::aligned16(D);
  auto st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(x), static_cast<const int*>(u),
               static_cast<const int*>(cand), static_cast<const float*>(D),
               static_cast<const float*>(cnt), static_cast<float*>(out),
               B, C, d, k, mode};
  switch (lanes * 100 + slices) {
    case 801: launch<8, 1, 2>(aligned, st, a); break;
    case 802: launch<8, 2, 2>(aligned, st, a); break;
    case 804: launch<8, 4, 2>(aligned, st, a); break;
    case 1604: launch<16, 4, 2>(aligned, st, a); break;
    case 3204: launch<32, 4, 2>(aligned, st, a); break;
    case 3208: launch<32, 8, 1>(aligned, st, a); break;
    case 3200: launch<32, 0, 1>(aligned, st, a); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
