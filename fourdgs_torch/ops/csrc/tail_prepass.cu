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
//     max(s, budget_lo); later slots stay live by convention. With nsub >
//     30 (chunks above 15,360, the shipped 16,384 among them) no bit can be
//     set: the sub-block maxima are then not taken at all.
//
// The depth sum is the reference's int32 sum: it wraps past 2^31 (from
// about 8,000 live entries of real depth bits up), and the mean is a FLOOR
// division of the wrapped value. The sum is taken in uint32 (defined
// wrap-around, in any order) and reinterpreted; C's division truncates
// toward zero, so a negative wrapped sum is corrected to the floor. This
// reproduces a fault of the reference (ROADMAP C-R8) on purpose: the bands
// must agree.
//
// Bound on the H100: one read of the span row and of the 32-byte sectors of
// the other five rows that hold an entry in the window (at the 10M-splat
// 1080p frame every sector: 240 MB, 0.072 ms at 3.35 TB/s; a 4K band's clip
// leaves a third of its chunks without a live entry); the reductions are a
// few integer operations an entry. Design:
//   * one block of 256 threads a chunk; a thread keeps private min / max /
//     sum / count, reduced by warp shuffles and then one shared atomic a
//     warp; warp 0 builds the slot mask with a ballot a slot and thread 0
//     writes the row;
//   * loads: a thread reads kVecs 16-byte vectors (int4) of each row a
//     round, with the streaming (evict-first) hint, as the pass is read once
//     and is larger than the 50 MB L2. The span vectors of a round are
//     loaded first, all at once; then the other five rows' vectors of every
//     span vector with an entry in the window, all at once; so a round is
//     two round trips with 6 * kVecs loads in flight at most, and a vector
//     without a live entry costs only its span. A predicate on the vector's
//     index guards a load past the chunk. A chunk whose rows are not 16-byte
//     aligned (a base off 16 bytes, as a view at a storage offset gives, or
//     chunk % 4 != 0) takes the scalar path in the same kernel: 4 * kVecs
//     words of each row a thread a round, loaded the same way.
// A warp's 32 vectors (128 entries) or 32 words lie in one 512-wide
// sub-block, so a sub-block's maximum is reduced a warp at a time. Why this
// form: PERF.md (K6 and K3), measured by fourdgs_torch/tools/prepass_split.py
// against the earlier form (tools/csrc/tail_prepass_block_chunk.cu) and the
// trial forms (tools/csrc/tail_prepass_trials.cu).
//
// `tail_cuda.prepass_walk` writes the walk out in plain PyTorch;
// tests/test_torch_tail_prepass_split.py holds it on the CPU.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;
constexpr int kMaskBits = 30;
constexpr int kSubMax = 512;

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

__device__ __forceinline__ bool in_window(int span, int budget,
                                          int budget_lo) {
  return span > budget_lo && span <= budget;
}

// A thread's running reduction over the entries it has read.
struct Acc {
  int min_tx0 = INT_MAX, min_ty0 = INT_MAX, max_tx1 = -1, max_ty1 = -1;
  unsigned sum = 0u, cnt = 0u;

  // Takes one entry; returns its span if it is live, else 0.
  __device__ __forceinline__ int take(int tx0, int tx1, int ty0, int ty1,
                                      int d, int span, int budget,
                                      int budget_lo) {
    const bool live = in_window(span, budget, budget_lo);
    min_tx0 = live ? min(min_tx0, tx0) : min_tx0;
    max_tx1 = live ? max(max_tx1, tx1) : max_tx1;
    min_ty0 = live ? min(min_ty0, ty0) : min_ty0;
    max_ty1 = live ? max(max_ty1, ty1) : max_ty1;
    sum += live ? static_cast<unsigned>(d) : 0u;
    cnt += live ? 1u : 0u;
    return live ? span : 0;
  }
};

// Adds a warp's maximum live span of sub-block j into s_sub.
__device__ __forceinline__ void sub_max(int* s_sub, int j, int nsub, int m) {
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0 && m > 0 && j < nsub) atomicMax(&s_sub[j], m);
}

// Grid (steps): block k reduces chunk k. `vec`: every row of the meta and
// every chunk start 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
tail_prepass_kernel(const int* __restrict__ meta, const int* __restrict__ cuts,
                    int* __restrict__ out, long long npts, int chunk,
                    int budget, int budget_lo, int n_cuts, int vec) {
  __shared__ int s_min_tx0, s_min_ty0, s_max_tx1, s_max_ty1;
  __shared__ unsigned s_sum, s_cnt;
  __shared__ int s_sub[kMaskBits];
  const long long step = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
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

  const int sub = chunk < kSubMax ? chunk : kSubMax;
  const int nsub = chunk / sub;
  const bool masks = nsub <= kMaskBits;   // uniform: can a bit be set?
  const int* row = meta + step * chunk;
  Acc acc;
  if (vec) {
    constexpr int kRound = kThreads * kVecs;          // vectors a round
    const int nv = chunk / 4;
    for (int v0 = 0; v0 < nv; v0 += kRound) {
      int4 r[6][kVecs];
      // Past the chunk: a span no window holds.
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int i = v0 + u * kThreads + tid;
        r[5][u] = i < nv ? __ldcs(reinterpret_cast<const int4*>(
                               row + 5 * npts + 4 * i))
                         : make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
      }
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int i = v0 + u * kThreads + tid;
        const int4 sp = r[5][u];
        const bool any = in_window(sp.x, budget, budget_lo)
                         || in_window(sp.y, budget, budget_lo)
                         || in_window(sp.z, budget, budget_lo)
                         || in_window(sp.w, budget, budget_lo);
#pragma unroll
        for (int f = 0; f < 5; ++f) {
          r[f][u] = any ? __ldcs(reinterpret_cast<const int4*>(
                              row + f * npts + 4 * i))
                        : make_int4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        int m = acc.take(r[0][u].x, r[1][u].x, r[2][u].x, r[3][u].x,
                         r[4][u].x, r[5][u].x, budget, budget_lo);
        m = max(m, acc.take(r[0][u].y, r[1][u].y, r[2][u].y, r[3][u].y,
                            r[4][u].y, r[5][u].y, budget, budget_lo));
        m = max(m, acc.take(r[0][u].z, r[1][u].z, r[2][u].z, r[3][u].z,
                            r[4][u].z, r[5][u].z, budget, budget_lo));
        m = max(m, acc.take(r[0][u].w, r[1][u].w, r[2][u].w, r[3][u].w,
                            r[4][u].w, r[5][u].w, budget, budget_lo));
        if (masks) {
          const int e = 4 * (v0 + u * kThreads + 32 * warp);
          sub_max(s_sub, nsub == 1 ? 0 : e / sub, nsub, m);
        }
      }
    }
  } else {
    constexpr int kWords = 4 * kVecs;
    constexpr int kRound = kThreads * kWords;         // words a round
    for (int w0 = 0; w0 < chunk; w0 += kRound) {
      int r[6][kWords];
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const int i = w0 + k * kThreads + tid;
        r[5][k] = i < chunk ? __ldcs(row + 5 * npts + i) : INT_MIN;
      }
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const int i = w0 + k * kThreads + tid;
        const bool live = in_window(r[5][k], budget, budget_lo);
#pragma unroll
        for (int f = 0; f < 5; ++f) {
          r[f][k] = live ? __ldcs(row + f * npts + i) : 0;
        }
      }
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const int m = acc.take(r[0][k], r[1][k], r[2][k], r[3][k], r[4][k],
                               r[5][k], budget, budget_lo);
        if (masks) {
          const int e = w0 + k * kThreads + 32 * warp;
          sub_max(s_sub, nsub == 1 ? 0 : e / sub, nsub, m);
        }
      }
    }
  }
  const int min_tx0 = warp_min(acc.min_tx0);
  const int min_ty0 = warp_min(acc.min_ty0);
  const int max_tx1 = warp_max(acc.max_tx1);
  const int max_ty1 = warp_max(acc.max_ty1);
  const unsigned sum = warp_sum(acc.sum);
  const unsigned cnt = warp_sum(acc.cnt);
  if ((tid & 31) == 0 && cnt > 0u) {
    atomicMin(&s_min_tx0, min_tx0);
    atomicMin(&s_min_ty0, min_ty0);
    atomicMax(&s_max_tx1, max_tx1);
    atomicMax(&s_max_ty1, max_ty1);
    atomicAdd(&s_sum, sum);
    atomicAdd(&s_cnt, cnt);
  }
  __syncthreads();
  if (warp != 0) return;
  const int lane = tid;
  int mask = 0;
  if (masks) {
    const int msub = lane < nsub ? s_sub[lane] : 0;
    for (int s = 0; s < budget; ++s) {
      if ((s + 1) * nsub > kMaskBits) break;
      const int thresh = s > budget_lo ? s : budget_lo;
      const unsigned bits = __ballot_sync(0xffffffffu,
                                          lane < nsub && msub > thresh);
      mask |= static_cast<int>(bits << (s * nsub));
    }
  }
  if (lane == 0) {
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
    int* o = out + 6 * step;
    o[0] = band;
    o[1] = mtx0;
    o[2] = tyw;
    o[3] = nwx;
    o[4] = nwy;
    o[5] = mask;
  }
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
  const int vec = (reinterpret_cast<uintptr_t>(meta) & 15) == 0
                  && chunk % 4 == 0;
  tail_prepass_kernel<<<steps, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(meta), static_cast<const int*>(cuts),
      static_cast<int*>(out), static_cast<long long>(npts), chunk, budget,
      budget_lo, n_cuts, vec);
  return static_cast<int>(cudaGetLastError());
}
