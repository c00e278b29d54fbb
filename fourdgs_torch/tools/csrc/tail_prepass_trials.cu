// Trial forms of the tail prepass (K6, ops/csrc/tail_prepass.cu), a
// measuring instrument for fourdgs_torch/tools/prepass_split.py: not part of
// the port's path. What K6 computes and what bounds it: ops/csrc/
// tail_prepass.cu. Here its kernel is a template over the block width
// (kThreads), the 16-byte vectors of each row a thread reads a round
// (kVecs), the load hint (kStream: streaming, evict-first) and the load
// order (kSpanFirst: a round loads the span vectors first and the other
// five rows only of a vector with an entry in the window; else all 6 *
// kVecs loads are issued before the first test), and every form takes a
// cluster size: `pieces` blocks (1-8, launched with cudaLaunchKernelEx and
// the cluster-dimension attribute) reduce one chunk, block rank r its
// entries [r * piece, (r + 1) * piece), piece = chunk / pieces a multiple
// of 512 so that no sub-block straddles two blocks. Each block reduces its
// piece into shared memory; after a cluster barrier, warp 0 of block rank 0
// reads the partials of every block of the cluster through distributed
// shared memory (`map_shared_rank`), combines them and writes the row; a
// second barrier keeps the other blocks' shared memory alive until it has.
// Every reduction is over integers and the sum wraps mod 2^32 in any order,
// so every form computes the same bits as the port's. Variant 0 at a
// cluster of one block is the port's form.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace tail_prepass_trials {

namespace cg = cooperative_groups;

constexpr int kMaskBits = 30;
constexpr int kSubMax = 512;
constexpr int kMaxPieces = 8;

// One block's reduction of its piece.
struct Partial {
  int min_tx0, min_ty0, max_tx1, max_ty1;
  unsigned sum, cnt;
  int sub[kMaskBits];
};

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

template <bool kStream>
__device__ __forceinline__ int4 load4(const int* p) {
  const int4* q = reinterpret_cast<const int4*>(p);
  if constexpr (kStream) {
    return __ldcs(q);
  } else {
    return *q;
  }
}

template <bool kStream>
__device__ __forceinline__ int load1(const int* p) {
  if constexpr (kStream) {
    return __ldcs(p);
  } else {
    return *p;
  }
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

// Adds a warp's maximum live span of sub-block j into the block's partial.
__device__ __forceinline__ void sub_max(Partial& part, int j, int nsub,
                                        int m) {
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0 && m > 0 && j < nsub) atomicMax(&part.sub[j], m);
}

// Grid (steps * pieces): the cluster of blocks [k * pieces, (k + 1) *
// pieces) reduces chunk k, block rank r its entries [r * piece, (r + 1) *
// piece). `vec`: every row of the meta and the piece start 16-byte aligned.
// kSpanFirst: a round loads the span first and the other five rows only of
// a vector (or word) with an entry in the window.
template <int kThreads, int kVecs, bool kStream, bool kSpanFirst>
__global__ void __launch_bounds__(kThreads)
prepass_kernel(const int* __restrict__ meta, const int* __restrict__ cuts,
               int* __restrict__ out, long long npts, int chunk, int piece,
               int budget, int budget_lo, int n_cuts, int vec) {
  __shared__ Partial part;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int pieces = static_cast<int>(cluster.num_blocks());
  const long long step = blockIdx.x / pieces;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  if (tid == 0) {
    part.min_tx0 = INT_MAX;
    part.min_ty0 = INT_MAX;
    part.max_tx1 = -1;
    part.max_ty1 = -1;
    part.sum = 0u;
    part.cnt = 0u;
  }
  if (tid < kMaskBits) part.sub[tid] = 0;
  __syncthreads();

  const int sub = chunk < kSubMax ? chunk : kSubMax;
  const int nsub = chunk / sub;
  const bool masks = nsub <= kMaskBits;   // uniform: can a bit be set?
  const int first = rank * piece;        // the piece's offset in the chunk
  const int* row = meta + step * chunk + first;
  Acc acc;
  if (vec) {
    constexpr int kRound = kThreads * kVecs;          // vectors a round
    const int nv = piece / 4;
    for (int v0 = 0; v0 < nv; v0 += kRound) {
      int4 r[6][kVecs];
      // Past the piece: a span no window holds.
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int i = v0 + u * kThreads + tid;
        r[5][u] = i < nv ? load4<kStream>(row + 5 * npts + 4 * i)
                         : make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
        if constexpr (!kSpanFirst) {
#pragma unroll
          for (int f = 0; f < 5; ++f) {
            r[f][u] = i < nv ? load4<kStream>(row + f * npts + 4 * i)
                             : make_int4(0, 0, 0, 0);
          }
        }
      }
      if constexpr (kSpanFirst) {
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
            r[f][u] = any ? load4<kStream>(row + f * npts + 4 * i)
                          : make_int4(0, 0, 0, 0);
          }
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
          const int e = first + 4 * (v0 + u * kThreads + 32 * warp);
          sub_max(part, nsub == 1 ? 0 : e / sub, nsub, m);
        }
      }
    }
  } else {
    constexpr int kWords = 4 * kVecs;
    constexpr int kRound = kThreads * kWords;         // words a round
    for (int w0 = 0; w0 < piece; w0 += kRound) {
      int r[6][kWords];
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const int i = w0 + k * kThreads + tid;
        r[5][k] = i < piece ? load1<kStream>(row + 5 * npts + i) : INT_MIN;
        if constexpr (!kSpanFirst) {
#pragma unroll
          for (int f = 0; f < 5; ++f) {
            r[f][k] = i < piece ? load1<kStream>(row + f * npts + i) : 0;
          }
        }
      }
      if constexpr (kSpanFirst) {
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          const int i = w0 + k * kThreads + tid;
          const bool live = in_window(r[5][k], budget, budget_lo);
#pragma unroll
          for (int f = 0; f < 5; ++f) {
            r[f][k] = live ? load1<kStream>(row + f * npts + i) : 0;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const int m = acc.take(r[0][k], r[1][k], r[2][k], r[3][k], r[4][k],
                               r[5][k], budget, budget_lo);
        if (masks) {
          const int e = first + w0 + k * kThreads + 32 * warp;
          sub_max(part, nsub == 1 ? 0 : e / sub, nsub, m);
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
    atomicMin(&part.min_tx0, min_tx0);
    atomicMin(&part.min_ty0, min_ty0);
    atomicMax(&part.max_tx1, max_tx1);
    atomicMax(&part.max_ty1, max_ty1);
    atomicAdd(&part.sum, sum);
    atomicAdd(&part.cnt, cnt);
  }
  // Every block's partial is complete and visible to the cluster (a block
  // alone: to its own threads, and read in place).
  if (pieces == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
  auto partial_of = [&](int b) -> const Partial* {
    return pieces == 1 ? &part : cluster.map_shared_rank(&part, b);
  };
  if (rank == 0 && warp == 0) {
    const int lane = tid;
    int p_tx0 = INT_MAX, p_ty0 = INT_MAX, p_tx1 = -1, p_ty1 = -1;
    unsigned p_sum = 0u, p_cnt = 0u;
    if (lane < pieces) {
      const Partial* q = partial_of(lane);
      p_tx0 = q->min_tx0;
      p_ty0 = q->min_ty0;
      p_tx1 = q->max_tx1;
      p_ty1 = q->max_ty1;
      p_sum = q->sum;
      p_cnt = q->cnt;
    }
    p_tx0 = warp_min(p_tx0);
    p_ty0 = warp_min(p_ty0);
    p_tx1 = warp_max(p_tx1);
    p_ty1 = warp_max(p_ty1);
    p_sum = warp_sum(p_sum);
    p_cnt = warp_sum(p_cnt);
    // Lane j < nsub combines sub-block j over the cluster's blocks.
    int msub = 0;
    if (masks && lane < nsub) {
      for (int b = 0; b < pieces; ++b) {
        msub = max(msub, partial_of(b)->sub[lane]);
      }
    }
    int mask = 0;
    if (masks) {
      for (int s = 0; s < budget; ++s) {
        if ((s + 1) * nsub > kMaskBits) break;
        const int thresh = s > budget_lo ? s : budget_lo;
        const unsigned bits = __ballot_sync(0xffffffffu,
                                            lane < nsub && msub > thresh);
        mask |= static_cast<int>(bits << (s * nsub));
      }
    }
    if (lane == 0) {
      const bool any_live = p_cnt > 0u;
      const int mtx0 = any_live ? p_tx0 : 0;
      const int mty0 = any_live ? p_ty0 : 0;
      const int mtx1 = any_live ? p_tx1 : 0;
      const int mty1 = any_live ? p_ty1 : 0;
      const int tyw = (mty0 / 8) * 8;           // mty0 >= 0
      const int nwx = (mtx1 - mtx0) / 2 + 1;    // operands >= 0
      const int nwy = (mty1 - tyw) / 16 + 1;
      const int d_sum = static_cast<int>(p_sum);   // the int32 wrap (C-R8)
      const int d_cnt = any_live ? static_cast<int>(p_cnt) : 1;
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
  // The other blocks' shared memory stays alive until rank 0 has read it.
  if (pieces > 1) cluster.sync();
}

// Checks the arguments and launches one cluster of `pieces` blocks a chunk.
template <int kThreads, int kVecs, bool kStream, bool kSpanFirst>
int launch(const void* meta, const void* cuts, void* out, int npts, int chunk,
           int budget, int budget_lo, int n_cuts, int steps, int pieces,
           cudaStream_t stream) {
  if (chunk <= 0 || steps <= 0 || static_cast<long long>(steps) * chunk != npts
      || (chunk > kSubMax && chunk % kSubMax != 0) || n_cuts < 0
      || pieces < 1 || pieces > kMaxPieces || chunk % pieces != 0
      || (chunk > kSubMax && (chunk / pieces) % kSubMax != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int piece = chunk / pieces;
  const int vec = (reinterpret_cast<uintptr_t>(meta) & 15) == 0
                  && chunk % 4 == 0 && piece % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(steps) * pieces);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pieces;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, prepass_kernel<kThreads, kVecs, kStream, kSpanFirst>,
      static_cast<const int*>(meta), static_cast<const int*>(cuts),
      static_cast<int*>(out), static_cast<long long>(npts), chunk, piece,
      budget, budget_lo, n_cuts, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tail_prepass_trials

extern "C" int fourdgs_tail_prepass_trial(int variant, const void* meta,
                                          const void* cuts, void* out,
                                          int npts, int chunk, int budget,
                                          int budget_lo, int n_cuts,
                                          int steps, int pieces,
                                          void* stream) {
  using tail_prepass_trials::launch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRIAL(T, V, STREAM, SPAN)                                           \
  return launch<T, V, STREAM, SPAN>(meta, cuts, out, npts, chunk, budget,   \
                                    budget_lo, n_cuts, steps, pieces, s)
  switch (variant) {
    case 0:  // 256 threads, 2 vectors a row, streaming, span first (the port's)
      TRIAL(256, 2, true, true);
    case 1:  // 256 threads, 2 vectors a row, streaming, all six loads first
      TRIAL(256, 2, true, false);
    case 2:  // 256 threads, 2 vectors a row, plain loads, span first
      TRIAL(256, 2, false, true);
    case 3:  // 256 threads, 2 vectors a row, plain loads, all six loads first
      TRIAL(256, 2, false, false);
    case 4:  // 256 threads, 1 vector a row, streaming, span first
      TRIAL(256, 1, true, true);
    case 5:  // 256 threads, 4 vectors a row, streaming, span first
      TRIAL(256, 4, true, true);
    case 6:  // 128 threads, 2 vectors a row, streaming, span first
      TRIAL(128, 2, true, true);
    case 7:  // 512 threads, 2 vectors a row, streaming, span first
      TRIAL(512, 2, true, true);
    case 8:  // 128 threads, 2 vectors a row, streaming, all six loads first
      TRIAL(128, 2, true, false);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRIAL
}
