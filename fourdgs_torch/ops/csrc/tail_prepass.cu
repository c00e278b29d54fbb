// Per-chunk prepass of the banded tail: kernel K6 of the port.
//
// Replaces fourdgs/ops/tail_pallas.py `_prepass_kernel` (called through
// `tail_prepass`, tail_pallas.py:246-288). One thread block reads one chunk
// of `chunk` entries of the (6, Np) int32 meta matrix [tx0, tx1, ty0, ty1,
// dbits, span] and writes one row of the (S, 6) int32 output:
//
//   [band, txw, tyw, nwx, nwy, slot_mask]
//
// over the entries live in the stream's span window (budget_lo, budget]:
//   * the window rect: txw = min tx0, tyw = (min ty0 / 8) * 8, nwx = (max tx1
//     - txw) / 2 + 1, nwy = (max ty1 - tyw) / 16 + 1 (all 0 / 1 for a chunk
//     with nothing live);
//   * the depth band: how many of the n_cuts ascending cuts c satisfy
//     -mean >= c, mean the floor of the chunk's dbits sum over its live
//     count (at least 1);
//   * the slot mask: bit s * nsub + j (s < budget, (s + 1) * nsub <= 30) is
//     set iff the max live span of the j-th 512-wide sub-block exceeds
//     max(s, budget_lo); later slots stay live by convention.
//
// The depth sum is the reference's int32 sum: it wraps past 2^31 (from
// about 8,000 live entries of real depth bits up), and the mean is a FLOOR
// division of the wrapped value. The sum is taken in uint32 (defined
// wrap-around) and reinterpreted; C's division truncates toward zero, so a
// negative wrapped sum is corrected to the floor. This reproduces a fault
// of the reference (ROADMAP C-R8) on purpose: the bands must agree.
//
// Bound on the H100: one read of the meta matrix (~240 MB at the 10M-splat
// frame) and 611 block reductions. Design: 256 threads stride over each
// 512-wide sub-block, keep private min / max / sum / count, reduce by warp
// shuffles and then one shared atomic per warp; thread 0 writes the row.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaskBits = 30;
constexpr int kSubMax = 512;

__device__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

__global__ void __launch_bounds__(kThreads)
tail_prepass_kernel(const int* __restrict__ meta, const int* __restrict__ cuts,
                    int* __restrict__ out, int npts, int chunk, int budget,
                    int budget_lo, int n_cuts) {
  __shared__ int s_min_tx0, s_min_ty0, s_max_tx1, s_max_ty1;
  __shared__ unsigned s_sum, s_cnt;
  __shared__ int s_sub[kMaskBits];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    s_min_tx0 = INT_MAX;
    s_min_ty0 = INT_MAX;
    s_max_tx1 = -1;
    s_max_ty1 = -1;
    s_sum = 0u;
    s_cnt = 0u;
  }
  if (tid < kMaskBits) s_sub[tid] = 0;
  __syncthreads();

  const long long np = npts;
  const long long base = static_cast<long long>(blockIdx.x) * chunk;
  const int sub = chunk < kSubMax ? chunk : kSubMax;
  const int nsub = chunk / sub;
  int min_tx0 = INT_MAX, min_ty0 = INT_MAX, max_tx1 = -1, max_ty1 = -1;
  unsigned sum = 0u, cnt = 0u;
  for (int j = 0; j < nsub; ++j) {
    int sub_max = 0;
    for (int k = tid; k < sub; k += kThreads) {
      const long long p = base + static_cast<long long>(j) * sub + k;
      const int span = meta[5 * np + p];
      if (span > budget_lo && span <= budget) {
        min_tx0 = min(min_tx0, meta[p]);
        max_tx1 = max(max_tx1, meta[np + p]);
        min_ty0 = min(min_ty0, meta[2 * np + p]);
        max_ty1 = max(max_ty1, meta[3 * np + p]);
        sum += static_cast<unsigned>(meta[4 * np + p]);
        cnt += 1u;
        sub_max = max(sub_max, span);
      }
    }
    if (j < kMaskBits) {  // uniform across the block
      sub_max = warp_max(sub_max);
      if (lane == 0 && sub_max > 0) atomicMax(&s_sub[j], sub_max);
    }
  }
  min_tx0 = warp_min(min_tx0);
  min_ty0 = warp_min(min_ty0);
  max_tx1 = warp_max(max_tx1);
  max_ty1 = warp_max(max_ty1);
  sum = warp_sum(sum);
  cnt = warp_sum(cnt);
  if (lane == 0 && cnt > 0u) {
    atomicMin(&s_min_tx0, min_tx0);
    atomicMin(&s_min_ty0, min_ty0);
    atomicMax(&s_max_tx1, max_tx1);
    atomicMax(&s_max_ty1, max_ty1);
    atomicAdd(&s_sum, sum);
    atomicAdd(&s_cnt, cnt);
  }
  __syncthreads();
  if (tid != 0) return;

  const bool any_live = s_cnt > 0u;
  const int mtx0 = any_live ? s_min_tx0 : 0;
  const int mty0 = any_live ? s_min_ty0 : 0;
  const int mtx1 = any_live ? s_max_tx1 : 0;
  const int mty1 = any_live ? s_max_ty1 : 0;
  const int tyw = (mty0 / 8) * 8;           // mty0 >= 0
  const int nwx = (mtx1 - mtx0) / 2 + 1;    // operands >= 0
  const int nwy = (mty1 - tyw) / 16 + 1;
  const int d_sum = static_cast<int>(s_sum);   // the int32 wrap (C-R8)
  const int d_cnt = any_live ? static_cast<int>(s_cnt) : 1;
  const int neg_mean = -floor_div(d_sum, d_cnt);
  int band = 0;
  for (int c = 0; c < n_cuts; ++c) band += neg_mean >= cuts[c] ? 1 : 0;
  int mask = 0;
  for (int s = 0; s < budget; ++s) {
    if ((s + 1) * nsub > kMaskBits) break;
    const int thresh = s > budget_lo ? s : budget_lo;
    for (int j = 0; j < nsub; ++j) {
      if (s_sub[j] > thresh) mask |= 1 << (s * nsub + j);
    }
  }
  int* row = out + 6 * static_cast<long long>(blockIdx.x);
  row[0] = band;
  row[1] = mtx0;
  row[2] = tyw;
  row[3] = nwx;
  row[4] = nwy;
  row[5] = mask;
}

}  // namespace

extern "C" int fourdgs_tail_prepass(const void* meta, const void* cuts,
                                    void* out, int npts, int chunk,
                                    int budget, int budget_lo, int n_cuts,
                                    int steps, void* stream) {
  if (chunk <= 0 || steps <= 0 || static_cast<long long>(steps) * chunk != npts
      || (chunk > kSubMax && chunk % kSubMax != 0) || n_cuts < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tail_prepass_kernel<<<steps, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(meta), static_cast<const int*>(cuts),
      static_cast<int*>(out), npts, chunk, budget, budget_lo, n_cuts);
  return static_cast<int>(cudaGetLastError());
}
