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
// Bound on an H100 SXM: bytes.  A build round's candidates are its rows'
// co-members, so the B·C gathered rows (B·C·d·4 = 71.3 MB at the main
// path's B=1024, C=136, d=128) are mostly repeats that hit the 50 MB L2;
// what must come from HBM is each unique valid row of Xsrc once (d·4 bytes
// and its ||y||²) plus the inputs and outputs: chip_smoke.py counts them on
// a build round's chunk, about 32.7 MB, 9.765 us at 3.35 TB/s.  The
// distances are 2 flops per gathered float and the merge a few hundred
// compares per row, both far below the card's compute rates.  The gather
// through L2 (71.3 MB) is the practical floor.
//
// Design: one CTA of 4 warps per row, so a batch of B rows is B CTAs (all
// resident at once on 132 SMs at B=1024), rows of neighbouring b side by
// side.
//   stage: the row's C (rows, cand_ids) pairs and the candidates' ||y||²
//     are read once into shared memory by all 128 threads (coalesced, the
//     ||y||² gathers all in flight together), so no index load sits in the
//     dependent chain of a row load.  A candidate with id < 0 or a row
//     outside [0, N) is invalid: never loaded, scored +inf.
//   gather: x stays in every warp's registers as float4 slices (common.cuh
//     WarpVec); each warp loads 8 candidate rows at once (one coalesced
//     512 B row per load at d=128), then reduces them, so a warp keeps 8
//     rows in flight and the CTA 32.  The dot keeps the order of the
//     earlier one-warp-per-row kernel (each lane's partial over its float4
//     slices, then warp_sum) and the distance its expression, so the
//     distances equal that kernel's bit for bit.
//   merge, without κ sequential passes: the κ-pass rule equals
//     1. sort the L = κ + C entries stably by (distance, position);
//     2. keep an entry only if no earlier entry in that order has its id;
//     3. stop at the first +inf; 4. take the first κ (-1/+inf past them).
//     Why: pass t takes the smallest remaining (distance, position) entry;
//     what the passes before it removed are exactly the entries whose id an
//     earlier pass took, so walking the sorted order, pass t takes the t-th
//     entry whose id has not appeared before it, and every pass after the
//     first +inf minimum yields -1/+inf.  The CTA does this with 64-bit
//     keys (order-preserving bits of the distance, position) padded to
//     P = a power of two >= max(L, 128): a bitonic sort held in registers
//     (P/128 keys a thread; passes within a warp by shuffle, only the few
//     wider ones through shared memory); a hash table in shared memory
//     (2P slots, open addressing) that takes each finite entry's id and
//     keeps its lowest sorted rank (atomicMin, so the result does not
//     depend on the order the threads arrive in), an entry being a first
//     occurrence when its rank is its id's lowest; and a CTA prefix sum
//     over the first-occurrence flags in rank order that gives each kept
//     entry its output slot.  On the H100 the same sort in shared memory
//     with a barrier a pass, or a second sort by (id, rank) in place of
//     the table, made the kernel 1.3-1.8× slower.
//     Registers are capped at 64 (8 CTAs an SM, all 1,024 of a batch
//     resident), so the sorts of large P spill some keys to local memory.
//     -0 is keyed as +0 (the reference compares with ==); NaN distances
//     are outside the contract.
// L = κ + C <= 4096 (P·25 + L·8 + C·8 bytes of shared memory, 164 KB at
// the cap); the launch refuses more and the wrapper raises first.  The
// graph build gives L = κ + cap_factor·ξ + spill, 186 at SIFT1M's shape.
// Launches on the caller's stream, allocates nothing.

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::WarpVec;
using repro_torch::warp_sum;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsInFlight = 8;  // candidate rows a warp loads at once
constexpr int kMaxL = 4096;       // κ + C, at most
constexpr uint64_t kPad = ~0ull;  // sorts after every real key

// Order-preserving bits of a distance: a < b as floats iff key(a) < key(b)
// as unsigned, -0 keyed as +0.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = v == 0.f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Ascending bitonic sort of key[0, P), P = kThreads·M, in registers: thread
// t holds keys [t·M, t·M + M).  A pass of distance j < M stays in the
// thread, one of M <= j < 32·M exchanges with lane (lane ^ j/M) by shuffle,
// and a wider one goes through shared memory (key) between two CTA
// barriers.  The whole CTA; key holds the sorted keys on return.
template <int M>
__device__ __noinline__ void bitonic_sort(uint64_t* key) {
  constexpr int P = kThreads * M;
  const int t = threadIdx.x;
  uint64_t v[M];
#pragma unroll
  for (int s = 0; s < M; ++s) v[s] = key[t * M + s];
  for (int k = 2; k <= P; k <<= 1) {
    int j = k >> 1;
    for (; j >= 32 * M; j >>= 1) {             // across warps
      __syncthreads();
#pragma unroll
      for (int s = 0; s < M; ++s) key[t * M + s] = v[s];
      __syncthreads();
#pragma unroll
      for (int s = 0; s < M; ++s) {
        const int i = t * M + s;
        const uint64_t o = key[i ^ j];
        v[s] = ((i & j) == 0) == ((i & k) == 0) ? min(v[s], o) : max(v[s], o);
      }
    }
    for (; j >= M; j >>= 1) {                  // across the warp's lanes
#pragma unroll
      for (int s = 0; s < M; ++s) {
        const int i = t * M + s;
        const uint64_t o = __shfl_xor_sync(repro_torch::kFullMask, v[s],
                                           j / M);
        v[s] = ((i & j) == 0) == ((i & k) == 0) ? min(v[s], o) : max(v[s], o);
      }
    }
#pragma unroll
    for (int jj = M / 2; jj > 0; jj >>= 1) {   // within the thread
      if (jj >= k) continue;
#pragma unroll
      for (int s = 0; s < M; ++s) {
        const int p = s ^ jj;
        if (p > s) {
          const uint64_t a = v[s], b = v[p];
          if ((a > b) == (((t * M + s) & k) == 0)) {
            v[s] = b;
            v[p] = a;
          }
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < M; ++s) key[t * M + s] = v[s];
  __syncthreads();
}

// Home slot of id in a hash table of H slots, H a power of two (the top
// bits of a Fibonacci hash).
__device__ __forceinline__ int slot_of(int id, int H) {
  return (int)(((uint32_t)id * 2654435761u) >> (33 - __ffs(H)));
}

// bitonic_sort at P = kThreads·2^m keys, 128 <= P <= 4096.
__device__ __forceinline__ void sort_keys(uint64_t* key, int P) {
  switch (P / kThreads) {
    case 1: bitonic_sort<1>(key); break;
    case 2: bitonic_sort<2>(key); break;
    case 4: bitonic_sort<4>(key); break;
    case 8: bitonic_sort<8>(key); break;
    case 16: bitonic_sort<16>(key); break;
    default: bitonic_sort<32>(key); break;
  }
}

template <int NS, bool kAligned>
__global__ void __launch_bounds__(kThreads, 8)
refine_merge_kernel(const float* __restrict__ x, const int* __restrict__ rows,
                    const int* __restrict__ cand_ids,
                    const int* __restrict__ old_ids,
                    const float* __restrict__ old_d,
                    const float* __restrict__ Xsrc,
                    const float* __restrict__ ysq, int* __restrict__ out_ids,
                    float* __restrict__ out_d, int C, int kappa, int d,
                    long long N, int P) {
  extern __shared__ uint64_t smem8[];
  __shared__ int wt[kWarps];
  const int L = kappa + C;
  uint64_t* key = smem8;                                  // [P]
  int* hk = reinterpret_cast<int*>(key + P);              // [2P] ids
  int* hv = hk + 2 * P;                                   // [2P] ranks
  float* ent_d = reinterpret_cast<float*>(hv + 2 * P);    // [L]
  int* ent_i = reinterpret_cast<int*>(ent_d + L);         // [L]
  int* c_row = ent_i + L;                                 // [C]
  float* c_ysq = reinterpret_cast<float*>(c_row + C);     // [C]
  unsigned char* keep = reinterpret_cast<unsigned char*>(c_ysq + C);  // [P]

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* rb = rows + (size_t)b * C;
  const int* cb = cand_ids + (size_t)b * C;
  for (int c = tid; c < C; c += kThreads) {
    const int id = cb[c], r = rb[c];
    const bool ok = id >= 0 && r >= 0 && r < N;
    c_row[c] = ok ? r : -1;
    c_ysq[c] = ok ? ysq[r] : 0.f;
    ent_i[kappa + c] = ok ? id : -1;
  }
  for (int j = tid; j < kappa; j += kThreads) {
    const int id = old_ids[(size_t)b * kappa + j];
    ent_i[j] = id;
    ent_d[j] = id < 0 ? INFINITY : old_d[(size_t)b * kappa + j];
  }
  const float* xr = x + (size_t)b * d;
  WarpVec<NS, kAligned> xv;
  xv.load(xr, d, lane);
  const float xsq = warp_sum(xv.partial_dot(xr, d, lane));
  __syncthreads();

  for (int c0 = warp * kRowsInFlight; c0 < C;
       c0 += kWarps * kRowsInFlight) {
    int r[kRowsInFlight];
    float acc[kRowsInFlight];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j) {
      r[j] = c0 + j < C ? c_row[c0 + j] : -1;
      acc[j] = r[j] >= 0 ? xv.partial_dot(Xsrc + (size_t)r[j] * d, d, lane)
                         : 0.f;
    }
    float mine = 0.f;
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j) {
      const float s = warp_sum(acc[j]);
      if (lane == j) mine = s;
    }
    const int c = c0 + lane;
    if (lane < kRowsInFlight && c < C)
      ent_d[kappa + c] = c_row[c] < 0
                             ? INFINITY
                             : fmaxf(c_ysq[c] + xsq - 2.f * mine, 0.f);
  }
  __syncthreads();

  // 1. stable order: (distance, position)
  for (int j = tid; j < P; j += kThreads)
    key[j] = j < L ? (uint64_t)order_key(ent_d[j]) << 32 | (uint32_t)j
                   : kPad;
  __syncthreads();
  sort_keys(key, P);
  // 2. first occurrences: each id's lowest sorted rank, in a hash table
  // of 2P slots (open addressing; at most L <= P ids, so it never fills)
  const uint32_t inf_key = order_key(INFINITY);
  const int H = 2 * P;
  for (int j = tid; j < H; j += kThreads) {
    hk[j] = -1;
    hv[j] = INT_MAX;
  }
  __syncthreads();
  for (int j = tid; j < P; j += kThreads) {
    const uint64_t k1 = key[j];
    if ((uint32_t)(k1 >> 32) >= inf_key) continue;   // +inf, and the pads
    const int id = ent_i[(uint32_t)k1];
    for (int h = slot_of(id, H);; h = (h + 1) & (H - 1)) {
      const int prev = atomicCAS(&hk[h], -1, id);
      if (prev == -1 || prev == id) {
        atomicMin(&hv[h], j);
        break;
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < P; j += kThreads) {
    const uint64_t k1 = key[j];
    bool first = false;
    if ((uint32_t)(k1 >> 32) < inf_key) {
      const int id = ent_i[(uint32_t)k1];
      int h = slot_of(id, H);
      while (hk[h] != id) h = (h + 1) & (H - 1);
      first = hv[h] == j;
    }
    keep[j] = first;
  }
  __syncthreads();
  // 3-4. each kept entry's slot: the kept entries before it in rank order
  const int m = P / kThreads;  // ranks per thread, contiguous
  int cnt = 0;
  for (int u = 0; u < m; ++u) cnt += keep[tid * m + u];
  int total;
  int o = repro_torch::block_exclusive_scan<kWarps>(cnt, wt, &total);
  int* oi = out_ids + (size_t)b * kappa;
  float* od = out_d + (size_t)b * kappa;
  for (int u = 0; u < m && o < kappa; ++u) {
    const int j = tid * m + u;
    if (keep[j]) {
      const uint32_t pos = (uint32_t)key[j];
      oi[o] = ent_i[pos];
      od[o] = ent_d[pos];
      ++o;
    }
  }
  for (int j = total + tid; j < kappa; j += kThreads) {
    oi[j] = -1;
    od[j] = INFINITY;
  }
}

template <int NS>
cudaError_t launch(bool aligned, int B, size_t smem, cudaStream_t st,
                   const float* x, const int* rows, const int* cand_ids,
                   const int* old_ids, const float* old_d, const float* Xsrc,
                   const float* ysq, int* out_ids, float* out_d, int C,
                   int kappa, int d, long long N, int P) {
  auto kern = aligned ? refine_merge_kernel<NS, true>
                      : refine_merge_kernel<NS, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(B), dim3(kThreads), smem, st>>>(x, rows, cand_ids, old_ids,
                                              old_d, Xsrc, ysq, out_ids,
                                              out_d, C, kappa, d, N, P);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 = success; -1 for κ + C above 4096 or C < 0).  Device pointers of
// contiguous tensors: x (B, d) f32, rows (B, C) i32, cand_ids (B, C) i32,
// old_ids (B, κ) i32, old_d (B, κ) f32, Xsrc (N, d) f32, ysq (N,) f32 =
// ||Xsrc||² per row, out_ids (B, κ) i32, out_d (B, κ) f32.
extern "C" int refine_merge_launch(const void* x, const void* rows,
                                   const void* cand_ids, const void* old_ids,
                                   const void* old_d, const void* Xsrc,
                                   const void* ysq, void* out_ids,
                                   void* out_d, int B, int C, int kappa,
                                   int d, long long N, void* stream) {
  if (C < 0 || kappa + C > kMaxL) return -1;
  if (B <= 0 || kappa <= 0) return 0;
  cudaGetLastError();  // clear a stale error so the result below is ours
  const int L = kappa + C;
  int P = kThreads;
  while (P < L) P <<= 1;
  const size_t smem = (size_t)P * (sizeof(uint64_t) + 4 * sizeof(int) + 1) +
                      (size_t)L * (sizeof(float) + sizeof(int)) +
                      (size_t)C * (sizeof(int) + sizeof(float));
  const bool aligned = d % 4 == 0 && repro_torch::aligned16(x) &&
                       repro_torch::aligned16(Xsrc);
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
    case 1: e = launch<1>(aligned, B, smem, st, xf, ri, ci, oi, odf, Xf, yf, outi, outd, C, kappa, d, N, P); break;
    case 2: e = launch<2>(aligned, B, smem, st, xf, ri, ci, oi, odf, Xf, yf, outi, outd, C, kappa, d, N, P); break;
    case 4: e = launch<4>(aligned, B, smem, st, xf, ri, ci, oi, odf, Xf, yf, outi, outd, C, kappa, d, N, P); break;
    case 8: e = launch<8>(aligned, B, smem, st, xf, ri, ci, oi, odf, Xf, yf, outi, outd, C, kappa, d, N, P); break;
    default: e = launch<0>(aligned, B, smem, st, xf, ri, ci, oi, odf, Xf, yf, outi, outd, C, kappa, d, N, P); break;
  }
  return static_cast<int>(e);
}
