// The tail prepass's first design, K6 as ops/csrc/tail_prepass.cu had it
// before it read the meta in 16-byte vectors, kept as a measuring
// instrument for fourdgs_torch/tools/prepass_split.py and as the earlier form
// that chip_smoke.py holds the present kernel to bit for bit: it is not part
// of the port's path. One block of 256 threads a chunk; a thread strides over
// each 512-wide sub-block one entry at a time, loads the entry's span, tests
// it, and loads the other five rows only for a live entry; every sub-block's
// maximum is reduced (warp max, one shared atomic a warp) whatever nsub is.
// Built as it is, or with
//   -DPREPASS_UNCONDITIONAL  all six rows loaded before the live test;
//   -DPREPASS_SKIP_SUBMAX    no sub-block maxima when nsub > 30, where no
//                            slot-mask bit can be set;
//   -DPREPASS_THREADS=1024   1,024 threads a block;
// the differences between their times split the kernel's time into the
// dependent loads, the sub-block reductions and the block's width.
//
// Output and arguments as ops/csrc/tail_prepass.cu's entry: one row [band,
// txw, tyw, nwx, nwy, slot_mask] a chunk.

#include <cuda_runtime.h>

#include <climits>

namespace {

#ifndef PREPASS_THREADS
#define PREPASS_THREADS 256
#endif

constexpr int kThreads = PREPASS_THREADS;
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
tail_prepass_block_chunk_kernel(const int* __restrict__ meta,
                                const int* __restrict__ cuts,
                                int* __restrict__ out, int npts, int chunk,
                                int budget, int budget_lo, int n_cuts) {
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
#ifdef PREPASS_UNCONDITIONAL
      const int span = meta[5 * np + p];
      const int tx0 = meta[p];
      const int tx1 = meta[np + p];
      const int ty0 = meta[2 * np + p];
      const int ty1 = meta[3 * np + p];
      const int d = meta[4 * np + p];
      if (span > budget_lo && span <= budget) {
        min_tx0 = min(min_tx0, tx0);
        max_tx1 = max(max_tx1, tx1);
        min_ty0 = min(min_ty0, ty0);
        max_ty1 = max(max_ty1, ty1);
        sum += static_cast<unsigned>(d);
        cnt += 1u;
        sub_max = max(sub_max, span);
      }
#else
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
#endif
    }
#ifdef PREPASS_SKIP_SUBMAX
    if (j < kMaskBits && nsub <= kMaskBits) {  // uniform across the block
#else
    if (j < kMaskBits) {  // uniform across the block
#endif
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

extern "C" int fourdgs_tail_prepass_block_chunk(
    const void* meta, const void* cuts, void* out, int npts, int chunk,
    int budget, int budget_lo, int n_cuts, int steps, void* stream) {
  if (chunk <= 0 || steps <= 0 || static_cast<long long>(steps) * chunk != npts
      || (chunk > kSubMax && chunk % kSubMax != 0) || n_cuts < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tail_prepass_block_chunk_kernel<<<steps, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(meta), static_cast<const int*>(cuts),
      static_cast<int*>(out), npts, chunk, budget, budget_lo, n_cuts);
  return static_cast<int>(cudaGetLastError());
}
