// Strided-row sort with fused prune cut and keep: kernel K2 of the port.
//
// Replaces fourdgs/ops/sort_pallas.py `_rowsort_kernel` (called through
// `rowsort_compact`, sort_pallas.py:299-454). The flat (S,) key/value slot
// arrays are viewed as (row_len, rows): logical row r is key[r::rows], with
// slots at index >= S read as DEAD keys (the reference pads the same way, so
// every row holds the same slots on both sides). Per row:
//   1. optional prune cut: key > cut[clamp(key >> key_shift, 0, 2047)]
//      -> DEAD, with the cut table in shared memory padded with DEAD;
//   2. count the live (non-DEAD) slots -> live[r];
//   3. sort the live slots ascending by (key, position in the row): the
//      result is that of a stable sort and does not depend on the order in
//      which threads meet the slots, so the kernel repeats itself bit for
//      bit;
//   4. write the first `keep` to the TRANSPOSED (keep, rows) outputs, DEAD
//      keys and 0 values past the row's live slots, and add the live slots
//      the keep cap loses, max(live - keep, 0), into `dropped`.
//
// Bound on the H100: the one read of the keys (160 MB at the 10M-splat
// frame, 0.05 ms at 3.35 TB/s), the kept slots' values, one 32-byte sector
// each, and the outputs: ~0.06 ms in all. After the cut a row of 512 slots
// holds a dozen live keys and only `keep` (32-48) leave it, so a sorting
// network over the whole row is nearly all wasted. Design (the list kernel,
// keep <= 128):
//   * a block owns 32 adjacent rows, so the strided load of slot i reads 32
//     consecutive words, one full 128-byte line a warp-load, eight loads in
//     flight a lane; rows are not staged. Only keys are streamed: a value
//     is fetched at the end, and only for a slot that is kept;
//   * a slot that survives the cut is appended, as (key, position), to its
//     row's list of CAP entries in shared memory, its place taken from the
//     row's live counter;
//   * a warp takes a row's list into registers (one, two or four entries a
//     lane by the row's count) and sorts it with a bitonic network of
//     `__shfl_xor_sync` exchanges, no block barrier;
//   * a row with more than CAP live slots (rare after the cut; every row
//     without one) takes the full network: the block reads such rows again,
//     a few at a time, into scratch shared memory, sorts them there behind
//     block barriers and copies their first `keep` into their lists;
//   * the block writes its keep x 32 outputs as full lines.
// keep > 128 (no path of the port) runs the full network on every row: the
// wide kernel, a block owning as many adjacent rows as fit 64 KB.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kDead = 0x7fffffff;
constexpr int kTable = 2048;
constexpr int kBlockRows = 32;        // list kernel: rows of a block
constexpr int kThreads = 256;         // list kernel
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;            // loads in flight a lane
constexpr int kScratchEntries = 4 * 513;   // overflow rows' scratch (16 KB)
constexpr int kWideThreads = 512;     // wide kernel
constexpr unsigned kFull = 0xffffffffu;
// An empty list place: a DEAD key at the last position, above every entry.
constexpr long long kPad = LLONG_MAX;

// A live slot as one signed 64-bit word ordered by (key, position).
__device__ __forceinline__ long long entry(int key, int pos) {
  return (static_cast<long long>(key) << 32) | static_cast<unsigned>(pos);
}
__device__ __forceinline__ int entry_key(long long e) {
  return static_cast<int>(e >> 32);
}
__device__ __forceinline__ int entry_pos(long long e) {
  return static_cast<int>(e & 0xffffffffLL);
}

__device__ __forceinline__ void load_cut(int* scut, const int* cut,
                                         int n_cut) {
  if (cut == nullptr) return;
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) {
    scut[i] = i < n_cut ? cut[i] : kDead;
  }
}

__device__ __forceinline__ int apply_cut(int k, const int* scut, bool has_cut,
                                         int key_shift) {
  if (!has_cut) return k;
  int t = k >> key_shift;
  t = t < 0 ? 0 : (t > kTable - 1 ? kTable - 1 : t);
  return k > scut[t] ? kDead : k;
}

// Bitonic sort, ascending, of g rows of row_len entries (row j at
// se + j * rs) in shared memory by every thread of the block; the caller
// has synchronised, and the last stage ends with a barrier.
__device__ void bitonic_rows(long long* se, int g, int row_len, int rs) {
  const int half_row = row_len >> 1;
  const int half_shift = 31 - __clz(half_row);
  const int pairs = g * half_row;
  for (int size = 2; size <= row_len; size <<= 1) {
    for (int d = size >> 1; d > 0; d >>= 1) {
      for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
        const int j = q >> half_shift;
        const int w = q & (half_row - 1);
        const int lo = ((w & ~(d - 1)) << 1) | (w & (d - 1));
        const int hi = lo + d;
        const bool asc = (lo & size) == 0;
        long long* row = se + j * rs;
        const long long a = row[lo];
        const long long b = row[hi];
        if (asc ? (a > b) : (a < b)) {
          row[lo] = b;
          row[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// A warp sorts the n <= 32 * ITEMS entries of one list: entry e lives in
// lane e % 32, register e / 32, so distances below 32 are shuffles and the
// others exchanges within a lane.
template <int ITEMS>
__device__ __forceinline__ void warp_sort(long long* list, int n, int lane) {
  long long x[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = it * 32 + lane;
    x[it] = e < n ? list[e] : kPad;
  }
#pragma unroll
  for (int size = 2; size <= 32 * ITEMS; size <<= 1) {
#pragma unroll
    for (int d = size >> 1; d > 0; d >>= 1) {
      if (d >= 32) {
        const int h = d >> 5;
#pragma unroll
        for (int it = 0; it < ITEMS; ++it) {
          if ((it & h) == 0) {
            const bool up = ((it * 32) & size) == 0;
            const long long a = x[it];
            const long long b = x[it | h];
            const long long mn = a < b ? a : b;
            const long long mx = a < b ? b : a;
            x[it] = up ? mn : mx;
            x[it | h] = up ? mx : mn;
          }
        }
      } else {
#pragma unroll
        for (int it = 0; it < ITEMS; ++it) {
          const long long other = __shfl_xor_sync(kFull, x[it], d);
          const bool up = ((it * 32 + lane) & size) == 0;
          const bool lower = (lane & d) == 0;
          const bool take_min = lower == up;
          x[it] = (other < x[it]) == take_min ? other : x[it];
        }
      }
    }
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = it * 32 + lane;
    if (e < n) list[e] = x[it];
  }
}

// The first `keep` entries of the block's g sorted lists (list j at
// lists + j * stride, count[j] live entries) -> the transposed outputs, the
// value of a kept slot fetched from its place in the row; live and dropped.
__device__ __forceinline__ void write_rows(
    const long long* lists, int stride, const int* count, int g, int r0,
    int rows, int keep, const int* __restrict__ val,
    int* __restrict__ out_key, int* __restrict__ out_val,
    int* __restrict__ live, int* __restrict__ dropped) {
  const int kept = keep * g;
  for (int e = threadIdx.x; e < kept; e += blockDim.x) {
    const int c = e / g;
    const int j = e - c * g;
    int k = kDead;
    int v = 0;
    if (c < count[j]) {
      const long long x = lists[j * stride + c];
      k = entry_key(x);
      v = val[static_cast<long long>(entry_pos(x)) * rows + r0 + j];
    }
    const long long o = static_cast<long long>(c) * rows + r0 + j;
    out_key[o] = k;
    out_val[o] = v;
  }
  if (threadIdx.x < 32) {
    int over = 0;
    for (int j = threadIdx.x; j < g; j += 32) {
      const int n = count[j];
      live[r0 + j] = n;
      over += n > keep ? n - keep : 0;
    }
    for (int d = 16; d > 0; d >>= 1) over += __shfl_xor_sync(kFull, over, d);
    if (threadIdx.x == 0 && over > 0) atomicAdd(dropped, over);
  }
}

template <int CAP>
__global__ void __launch_bounds__(kThreads)
rowsort_lists_kernel(const int* __restrict__ key, const int* __restrict__ val,
                     long long s, int rows, int row_len, int keep,
                     const int* __restrict__ cut, int n_cut, int key_shift,
                     int scratch_rows, int* __restrict__ out_key,
                     int* __restrict__ out_val, int* __restrict__ live,
                     int* __restrict__ dropped) {
  extern __shared__ long long smem[];
  constexpr int kStride = CAP + 1;            // spreads the lists over banks
  const int rs = row_len + 1;
  long long* lists = smem;
  long long* scratch = lists + kBlockRows * kStride;
  int* scut = reinterpret_cast<int*>(scratch + scratch_rows * rs);
  int* scount = scut + kTable;
  __shared__ unsigned s_overflow;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * kBlockRows;
  const bool has_cut = cut != nullptr;

  load_cut(scut, cut, n_cut);
  if (tid < kBlockRows) scount[tid] = 0;
  __syncthreads();

  // Stream, cut, append: lane = row, a warp-load = one 128-byte line.
  for (int i0 = warp; i0 < row_len; i0 += kWarps * kUnroll) {
    int k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kWarps;
      const long long gi = static_cast<long long>(i) * rows + r0 + lane;
      k[u] = (i < row_len && gi < s) ? __ldcs(key + gi) : kDead;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kk = apply_cut(k[u], scut, has_cut, key_shift);
      if (kk != kDead) {
        const int pos = atomicAdd(&scount[lane], 1);
        if (pos < CAP) lists[lane * kStride + pos] = entry(kk, i0 + u * kWarps);
      }
    }
  }
  __syncthreads();

  // A warp sorts a list in registers.
  for (int j = warp; j < kBlockRows; j += kWarps) {
    const int n = scount[j];
    if (n < 2 || n > CAP) continue;
    long long* list = lists + j * kStride;
    if (n <= 32) {
      warp_sort<1>(list, n, lane);
    } else if (CAP == 64 || n <= 64) {
      warp_sort<2>(list, n, lane);
    } else {
      warp_sort<CAP / 32>(list, n, lane);
    }
  }
  if (tid < kBlockRows) {
    const unsigned m = __ballot_sync(kFull, scount[tid] > CAP);
    if (tid == 0) s_overflow = m;
  }
  __syncthreads();

  // Rows whose live slots outnumber the list: the full network, on
  // scratch_rows rows at a time, read again with the cut applied.
  unsigned todo = s_overflow;
  while (todo != 0) {
    int sel[8];
    int cnt = 0;
    while (todo != 0 && cnt < scratch_rows) {
      sel[cnt] = __ffs(todo) - 1;
      todo &= todo - 1;
      ++cnt;
    }
    const int total = cnt * row_len;
    for (int e = tid; e < total; e += kThreads) {
      const int i = e / cnt;
      const int jj = e - i * cnt;
      int row = sel[0];
#pragma unroll
      for (int q = 1; q < 8; ++q) row = jj == q ? sel[q] : row;
      const long long gi = static_cast<long long>(i) * rows + r0 + row;
      int k = gi < s ? key[gi] : kDead;
      k = apply_cut(k, scut, has_cut, key_shift);
      scratch[jj * rs + i] = k == kDead ? kPad : entry(k, i);
    }
    __syncthreads();
    bitonic_rows(scratch, cnt, row_len, rs);
    for (int e = tid; e < cnt * keep; e += kThreads) {
      const int jj = e / keep;
      const int c = e - jj * keep;
      int row = sel[0];
#pragma unroll
      for (int q = 1; q < 8; ++q) row = jj == q ? sel[q] : row;
      lists[row * kStride + c] = scratch[jj * rs + c];
    }
    __syncthreads();
  }

  write_rows(lists, kStride, scount, kBlockRows, r0, rows, keep, val, out_key,
             out_val, live, dropped);
}

// Every row through the full network: g adjacent rows a block, staged in
// shared memory with a padded stride.
__global__ void __launch_bounds__(kWideThreads)
rowsort_wide_kernel(const int* __restrict__ key, const int* __restrict__ val,
                    long long s, int rows, int row_len, int g, int keep,
                    const int* __restrict__ cut, int n_cut, int key_shift,
                    int* __restrict__ out_key, int* __restrict__ out_val,
                    int* __restrict__ live, int* __restrict__ dropped) {
  extern __shared__ long long smem[];
  const int rs = row_len + 1;
  long long* se = smem;
  int* scut = reinterpret_cast<int*>(se + g * rs);
  int* scount = scut + kTable;
  const int r0 = blockIdx.x * g;
  const int tid = threadIdx.x;
  const bool has_cut = cut != nullptr;

  load_cut(scut, cut, n_cut);
  for (int i = tid; i < g; i += kWideThreads) scount[i] = 0;
  __syncthreads();

  const int total = g * row_len;
  for (int e = tid; e < total; e += kWideThreads) {
    const int i = e / g;
    const int j = e - i * g;
    const long long gi = static_cast<long long>(i) * rows + r0 + j;
    int k = gi < s ? key[gi] : kDead;
    k = apply_cut(k, scut, has_cut, key_shift);
    se[j * rs + i] = k == kDead ? kPad : entry(k, i);
    if (k != kDead) atomicAdd(&scount[j], 1);
  }
  __syncthreads();
  bitonic_rows(se, g, row_len, rs);
  write_rows(se, rs, scount, g, r0, rows, keep, val, out_key, out_val, live,
             dropped);
}

template <int CAP>
cudaError_t launch_lists(const int* key, const int* val, long long s,
                         int rows, int row_len, int keep, const int* cut,
                         int n_cut, int key_shift, int* out_key, int* out_val,
                         int* live, int* dropped, cudaStream_t stream) {
  int scratch_rows = kScratchEntries / (row_len + 1);
  scratch_rows = scratch_rows < 1 ? 1 : (scratch_rows > 8 ? 8 : scratch_rows);
  const size_t smem =
      (static_cast<size_t>(kBlockRows) * (CAP + 1) +
       static_cast<size_t>(scratch_rows) * (row_len + 1)) * sizeof(long long) +
      (kTable + kBlockRows) * sizeof(int);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rowsort_lists_kernel<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rowsort_lists_kernel<CAP><<<rows / kBlockRows, kThreads, smem, stream>>>(
      key, val, s, rows, row_len, keep, cut, n_cut, key_shift, scratch_rows,
      out_key, out_val, live, dropped);
  return cudaGetLastError();
}

}  // namespace

// key, val: (S,) int32; cut: (n_cut,) int32 or null; out_key, out_val:
// (keep, rows) int32; live: (rows,) int32; dropped: one int32 the caller has
// set to 0. row_len must be a power of two and rows a multiple of 32 (the
// rows of a block of the list kernel; the wide kernel's 16 divides it).
extern "C" int fourdgs_rowsort_compact(const void* key, const void* val,
                                       long long s, int rows, int row_len,
                                       int keep, const void* cut, int n_cut,
                                       int key_shift, void* out_key,
                                       void* out_val, void* live,
                                       void* dropped, void* stream) {
  if (row_len < 2 || (row_len & (row_len - 1)) != 0 || keep < 1 ||
      keep > row_len || rows % kBlockRows != 0 || n_cut > kTable) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* k = static_cast<const int*>(key);
  const int* v = static_cast<const int*>(val);
  const int* c = static_cast<const int*>(cut);
  int* ok = static_cast<int*>(out_key);
  int* ov = static_cast<int*>(out_val);
  int* lv = static_cast<int*>(live);
  int* dr = static_cast<int*>(dropped);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (keep <= 64) {
    return static_cast<int>(launch_lists<64>(
        k, v, s, rows, row_len, keep, c, n_cut, key_shift, ok, ov, lv, dr,
        st));
  }
  if (keep <= 128) {
    return static_cast<int>(launch_lists<128>(
        k, v, s, rows, row_len, keep, c, n_cut, key_shift, ok, ov, lv, dr,
        st));
  }
  // Rows per block: as many as fit 64 KB of staged rows, at most 16.
  int g = 16;
  while (g > 1 && 8LL * g * (row_len + 1) > 64 * 1024) g >>= 1;
  const size_t smem = static_cast<size_t>(g) * (row_len + 1) *
                          sizeof(long long) +
                      (kTable + g) * sizeof(int);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      rowsort_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rowsort_wide_kernel<<<rows / g, kWideThreads, smem, st>>>(
      k, v, s, rows, row_len, g, keep, c, n_cut, key_shift, ok, ov, lv, dr);
  return static_cast<int>(cudaGetLastError());
}
