// Bitonic merge of sorted rows into one sorted (key, value) array: kernels
// K11, K12 and K13 of the port.
//
// They replace the three kernels of fourdgs/ops/sort_pallas.py
// `merge_sorted_rows` (sort_pallas.py:465-511): `_tree_level_kernel`
// (K11), `_cross_stage_kernel` (K12) and `_finish_level_kernel` (K13). The
// input is a flat array of `total` = R * C int32 (key, value) pairs, total
// and C powers of two, in which every run of C elements (a row) is sorted,
// DEAD keys (INT32_MAX) last in sort order; values ride along, ties are
// unordered. Runs are merged pairwise, level by level, as bitonic
// sequences: at a level that makes runs of `run_out` elements, run m comes
// out descending iff m is odd, except that the run of the final size
// (run_out == total) is ascending, so two neighbouring runs always form a
// bitonic sequence and nothing is ever reversed between levels. A level is
// the stages d = run_out/2 ... 1; a stage compare-exchanges (i, i + d) for
// every i with (i & d) == 0, strictly (equal keys never move).
//
//   K11 fourdgs_merge_tree: a block loads a tile of 16,384 consecutive
//     elements (whole rows, whole runs of B) straight into registers,
//     reading every odd row back to front when the caller's rows are all
//     ascending, runs every level from runs of C up to runs of B there and
//     writes the tile once. One launch where the TPU version pays one call
//     per level.
//   K12 fourdgs_merge_cross_stages: up to four consecutive stages at
//     distances d_hi, d_hi / 2 ... d_lo >= B of one level in one pass over
//     the array in device memory, in place. A thread loads the 2^s elements
//     whose indices differ only in the s bits log2(d_lo) ... log2(d_hi),
//     runs the s stages on them in registers and stores them: it owns every
//     element it touches, so no two threads meet within a pass, and since
//     2 * d_hi <= run_out all its elements lie in one run, whose direction
//     it takes once. Neighbouring threads take neighbouring low-bit indices:
//     every load and store is a full line. s = 1 is the single stage.
//   K13 fourdgs_merge_finish: a block loads a tile of 16,384 contiguous
//     elements into registers and runs the stages d = B/2 ... 1 of one
//     level there, in place.
//
//   fourdgs_merge_levels: every launch after K11 (K12's passes and K13's
//     finishes, in the order the caller's schedule lists them) enqueued on
//     the caller's stream by one host call.
//
// Bound on the H100: the arrays are small (16.8 MB at the 2^21 pairs of the
// 10M-splat frame, one read and one write in 0.010 ms) and stay in the
// 50 MB L2 between launches, so neither device memory nor arithmetic binds:
// the cost is the number of launches and, inside K11 and K13, how the
// stages reach their pairs. The TPU kernels keep 262,144 elements resident
// in fast memory; a Hopper block has 227 KB of shared memory, so B is
// 16,384 pairs (128 KB) and the levels above it go through K12. Design: a
// level with k stages above B takes ceil(k / 4) passes of K12 instead of k,
// so the 28 cross stages of 2^21 pairs are 10 launches and 10 passes over
// the array, and the whole schedule is enqueued from C, which takes the
// per-launch cost of a foreign-function call out. K11 and K13 run their
// stages on pairs held in registers, 16 a thread, four consecutive stages a
// round, with one bank-conflict-free transpose through shared memory
// between rounds (merge_rounds.cuh), and load and store with every access
// of a warp on consecutive words and all of a thread's loads in flight at
// once. K13's 14 stages take 2 block-wide and 2 warp barriers, where its
// earlier form took 14 shared-memory passes with a block-wide barrier each
// and a load loop that waited on every load; K11's 60 stages take 10
// block-wide and 7 warp barriers. That earlier form is kept as a measuring
// instrument in fourdgs_torch/tools/csrc/merge_shared_stages.cu.

#include <cuda_runtime.h>

#include "merge_rounds.cuh"

namespace {

namespace mr = merge_rounds;

constexpr int kCrossThreads = 256;    // K12

__device__ __forceinline__ int log2_of(long long x) {
  return 63 - __clzll(x);
}

// A level of K11 on a tile held in its first layout (`fresh`, just
// loaded) or in layout 0 (left so by the level before).
template <int M>
__device__ __forceinline__ void tree_level(int2* s, int (&k)[mr::kElems],
                                           int (&v)[mr::kElems], int t,
                                           bool fresh, mr::Direction dir) {
  if (fresh) {
    mr::run_level<M, mr::first_layout(M)>(s, k, v, t, dir);
  } else {
    mr::run_level<M, 0>(s, k, v, t, dir);
  }
}

// K11: one tile of mr::kTile pairs a block (B = block <= kTile pairs a run,
// so a tile holds kTile / B whole blocks, or the whole array when it is
// smaller). The tile is loaded straight into the first level's layout,
// every odd row back to front when flip_odd_rows (a tile holds whole rows,
// so a row is reversed inside it, tile-relative indices in 32 bits); the
// levels from runs of c to runs of B then run as register rounds
// (merge_rounds.cuh), and the tile is stored once.
__global__ void __launch_bounds__(mr::kThreads)
merge_tree_kernel(const int* __restrict__ key, const int* __restrict__ val,
                  int* __restrict__ out_key, int* __restrict__ out_val,
                  long long total, int c, int block, int flip_odd_rows) {
  extern __shared__ int2 smem[];
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * mr::kTile;
  const int limit = mr::tile_limit(blockIdx.x, total);
  const int c_shift = log2_of(c);
  const int m_last = log2_of(block) - 1;
  // A row of a whole tile has the parity of its tile number.
  const int odd_rows =
      c_shift >= mr::kTileBits ? (blockIdx.x >> (c_shift - mr::kTileBits)) & 1
                               : 0;
  int k[mr::kElems];
  int v[mr::kElems];
#define MERGE_LOAD(L)                                                    \
  mr::load<((L) < mr::kMaxLo ? (L) : mr::kMaxLo)>(                       \
      key + base, val + base, k, v, t, limit, flip_odd_rows != 0, c_shift, \
      odd_rows)
  MERGE_ROUNDS_SWITCH14(c_shift <= m_last ? mr::first_layout(c_shift) : 0,
                        MERGE_LOAD)
#undef MERGE_LOAD
  for (int m = c_shift; m <= m_last; ++m) {
    const mr::Direction dir =
        mr::level_direction(blockIdx.x, m + 1, (2LL << m) < total);
    const bool fresh = m == c_shift;
#define MERGE_LEVEL(M) tree_level<M>(smem, k, v, t, fresh, dir)
    MERGE_ROUNDS_SWITCH14(m, MERGE_LEVEL)
#undef MERGE_LEVEL
  }
  mr::store(smem, out_key + base, out_val + base, k, v, t, limit);
}

// S stages at distances d_lo << (S - 1) ... d_lo, one thread 2^S elements.
template <int S>
__global__ void __launch_bounds__(kCrossThreads)
merge_cross_stages_kernel(int* __restrict__ key, int* __restrict__ val,
                          long long groups, int lo_shift, int run_shift,
                          int alternate) {
  constexpr int kElems = 1 << S;
  const long long t =
      static_cast<long long>(blockIdx.x) * kCrossThreads + threadIdx.x;
  if (t >= groups) return;
  const long long d_lo = 1LL << lo_shift;
  const long long base =
      ((t >> lo_shift) << (lo_shift + S)) | (t & (d_lo - 1));
  const bool desc = alternate && ((base >> run_shift) & 1);
  int k[kElems];
  int v[kElems];
#pragma unroll
  for (int j = 0; j < kElems; ++j) {
    k[j] = key[base + j * d_lo];
    v[j] = val[base + j * d_lo];
  }
#pragma unroll
  for (int h = kElems >> 1; h > 0; h >>= 1) {
#pragma unroll
    for (int j = 0; j < kElems; ++j) {
      if ((j & h) == 0) {
        const int ka = k[j];
        const int kb = k[j | h];
        if (desc ? (ka < kb) : (kb < ka)) {      // strict: ties never move
          k[j] = kb;
          k[j | h] = ka;
          const int va = v[j];
          v[j] = v[j | h];
          v[j | h] = va;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kElems; ++j) {
    key[base + j * d_lo] = k[j];
    val[base + j * d_lo] = v[j];
  }
}

// K13's level m = M on one tile, loaded in its first layout.
template <int M>
__device__ __forceinline__ void finish_level(int2* s, const int* tk,
                                             const int* tv,
                                             int (&k)[mr::kElems],
                                             int (&v)[mr::kElems], int t,
                                             int limit, mr::Direction dir) {
  mr::load<mr::first_layout(M)>(tk, tv, k, v, t, limit, false, 0, 0);
  mr::run_level<M, mr::first_layout(M)>(s, k, v, t, dir);
}

// K13: the stages B/2 ... 1 of the level that makes runs of 2^run_shift
// pairs, on one tile of mr::kTile pairs a block: loaded from device memory
// in the level's first layout (at B = kTile register j of thread t holds
// pair j * 1,024 + t: coalesced), run as register rounds, stored once,
// coalesced, in place.
__global__ void __launch_bounds__(mr::kThreads)
merge_finish_kernel(int* __restrict__ key, int* __restrict__ val,
                    long long total, int block, int run_shift,
                    int alternate) {
  extern __shared__ int2 smem[];
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * mr::kTile;
  const int limit = mr::tile_limit(blockIdx.x, total);
  const mr::Direction dir =
      mr::level_direction(blockIdx.x, run_shift, alternate != 0);
  int k[mr::kElems];
  int v[mr::kElems];
#define MERGE_FINISH(M) \
  finish_level<M>(smem, key + base, val + base, k, v, t, limit, dir)
  MERGE_ROUNDS_SWITCH14(log2_of(block) - 1, MERGE_FINISH)
#undef MERGE_FINISH
  mr::store(smem, key + base, val + base, k, v, t, limit);
}

bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

int host_log2(long long x) {
  int s = 0;
  while ((1LL << s) < x) ++s;
  return s;
}

// Shared memory of K11's and K13's blocks: one tile of (key, value) pairs.
constexpr size_t kTileSmem = sizeof(int2) * mr::kTile;

unsigned tiles(long long total) {
  return static_cast<unsigned>((total + mr::kTile - 1) / mr::kTile);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

}  // namespace

// key, val -> out_key, out_val: (total,) int32, rows of c elements sorted
// (ascending, or odd rows descending with rows_alternating); afterwards
// every run of `block` elements is sorted, odd runs descending unless
// block == total. total, c, block powers of two, c <= block <= total.
extern "C" int fourdgs_merge_tree(const void* key, const void* val,
                                  void* out_key, void* out_val,
                                  long long total, int c, int block,
                                  int rows_alternating, void* stream) {
  if (!pow2(total) || !pow2(c) || !pow2(block) || block > mr::kTile ||
      c > block || block > total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(merge_tree_kernel, kTileSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_tree_kernel<<<tiles(total), mr::kThreads, kTileSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(key), static_cast<const int*>(val),
      static_cast<int*>(out_key), static_cast<int*>(out_val), total, c, block,
      rows_alternating ? 0 : 1);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <int S>
cudaError_t launch_cross(int* key, int* val, long long total, long long d_hi,
                         long long run_out, cudaStream_t stream) {
  const long long groups = total >> S;
  const long long blocks = (groups + kCrossThreads - 1) / kCrossThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  merge_cross_stages_kernel<S>
      <<<static_cast<unsigned>(blocks), kCrossThreads, 0, stream>>>(
          key, val, groups, host_log2(d_hi) - (S - 1), host_log2(run_out),
          run_out < total ? 1 : 0);
  return cudaGetLastError();
}

cudaError_t cross_stages(int* key, int* val, long long total, long long d_hi,
                         int n_stages, long long run_out,
                         cudaStream_t stream) {
  if (!pow2(total) || !pow2(d_hi) || !pow2(run_out) || 2 * d_hi > run_out ||
      run_out > total || n_stages < 1 || n_stages > 4 ||
      (d_hi >> (n_stages - 1)) < 1) {
    return cudaErrorInvalidValue;
  }
  switch (n_stages) {
    case 1: return launch_cross<1>(key, val, total, d_hi, run_out, stream);
    case 2: return launch_cross<2>(key, val, total, d_hi, run_out, stream);
    case 3: return launch_cross<3>(key, val, total, d_hi, run_out, stream);
    default: return launch_cross<4>(key, val, total, d_hi, run_out, stream);
  }
}

cudaError_t finish(int* key, int* val, long long total, int block,
                   long long run_out, cudaStream_t stream) {
  if (!pow2(total) || !pow2(run_out) || !pow2(block) || block < 2 ||
      block > mr::kTile || block > run_out || run_out > total) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem(merge_finish_kernel, kTileSmem);
  if (err != cudaSuccess) return err;
  merge_finish_kernel<<<tiles(total), mr::kThreads, kTileSmem, stream>>>(
      key, val, total, block,
                                        host_log2(run_out),
                                        run_out < total ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// n_stages (1 to 4) stages at distances d_hi, d_hi / 2 ... of the level that
// makes runs of run_out elements, in place. total, d_hi, run_out powers of
// two, 2 * d_hi <= run_out <= total, d_hi >= 2^(n_stages - 1).
extern "C" int fourdgs_merge_cross_stages(void* key, void* val,
                                          long long total, long long d_hi,
                                          int n_stages, long long run_out,
                                          void* stream) {
  return static_cast<int>(cross_stages(
      static_cast<int*>(key), static_cast<int*>(val), total, d_hi, n_stages,
      run_out, static_cast<cudaStream_t>(stream)));
}

// The stages d = block/2 ... 1 of the level that makes runs of run_out
// elements, in place. Powers of two, block <= run_out <= total.
extern "C" int fourdgs_merge_finish(void* key, void* val, long long total,
                                    int block, long long run_out,
                                    void* stream) {
  return static_cast<int>(finish(static_cast<int*>(key),
                                 static_cast<int*>(val), total, block,
                                 run_out,
                                 static_cast<cudaStream_t>(stream)));
}

// The launches after K11, in place: steps is n_steps triples (d_hi,
// n_stages, run_out) in launch order, a pass of K12 where n_stages >= 1 and
// a K13 for run_out (d_hi unread) where n_stages == 0. launched[0] and
// launched[1] (host memory) receive the numbers of K12 and K13 launches
// made. Stops at the first launch that is refused and returns its error.
extern "C" int fourdgs_merge_levels(void* key, void* val, long long total,
                                    int block, const long long* steps,
                                    int n_steps, int* launched,
                                    void* stream) {
  int* k = static_cast<int*>(key);
  int* v = static_cast<int*>(val);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launched[0] = launched[1] = 0;
  for (int i = 0; i < n_steps; ++i) {
    const long long d_hi = steps[3 * i];
    const int n_stages = static_cast<int>(steps[3 * i + 1]);
    const long long run_out = steps[3 * i + 2];
    const cudaError_t err =
        n_stages == 0 ? finish(k, v, total, block, run_out, st)
                      : cross_stages(k, v, total, d_hi, n_stages, run_out, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++launched[n_stages == 0 ? 1 : 0];
  }
  return static_cast<int>(cudaSuccess);
}
