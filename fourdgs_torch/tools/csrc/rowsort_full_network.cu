// The full-network form of the strided-row sort (the port's first K2), kept
// as a measuring instrument for fourdgs_torch/tools/sort_split.py: it is not
// part of the port's path. A block stages g adjacent logical rows of the
// (row_len, rows) view in shared memory, applies the prune cut, counts the
// live slots with one shared atomic each, runs the whole bitonic network of
// log2(row_len) * (log2(row_len) + 1) / 2 barrier-separated stages over every
// row (45 at row_len 512) and writes each row's first `keep` slots to the
// transposed (keep, rows) outputs. Ties are unordered. Built as it is (g =
// as many rows as fit 64 KB, at most 16: 8 at row_len 512), or with
//   -DROWSORT_G=16|32      that many rows a block (wider loads, fewer blocks
//                          an SM);
//   -DROWSORT_COUNT_ONLY   load, cut and count only: no network, no kept
//                          slots written (live is);
// the differences between their times split its time into the one read of
// the slot arrays, the network, and the rows a block owns.

#include <cuda_runtime.h>

namespace {

constexpr int kDead = 0x7fffffff;
constexpr int kTable = 2048;
constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
rowsort_kernel(const int* __restrict__ key, const int* __restrict__ val,
               long long s, int rows, int row_len, int g, int keep,
               const int* __restrict__ cut, int n_cut, int key_shift,
               int* __restrict__ out_key, int* __restrict__ out_val,
               int* __restrict__ live) {
  extern __shared__ int smem[];
  const int rs = row_len + 1;                 // padded row stride
  int* sk = smem;
  int* sv = sk + g * rs;
  int* scut = sv + g * rs;
  int* slive = scut + kTable;
  const int r0 = blockIdx.x * g;
  const int tid = threadIdx.x;

  if (cut != nullptr) {
    for (int i = tid; i < kTable; i += kThreads) {
      scut[i] = i < n_cut ? cut[i] : kDead;
    }
  }
  for (int i = tid; i < g; i += kThreads) slive[i] = 0;
  __syncthreads();

  const int total = g * row_len;
  for (int e = tid; e < total; e += kThreads) {
    const int i = e / g;
    const int j = e - i * g;
    const long long gi = static_cast<long long>(i) * rows + r0 + j;
    int k = kDead;
    int v = 0;
    if (gi < s) {
      k = key[gi];
      v = val[gi];
    }
    if (cut != nullptr) {
      int t = k >> key_shift;
      t = t < 0 ? 0 : (t > kTable - 1 ? kTable - 1 : t);
      if (k > scut[t]) k = kDead;
    }
    sk[j * rs + i] = k;
    sv[j * rs + i] = v;
    if (k != kDead) atomicAdd(&slive[j], 1);
  }
  __syncthreads();
#ifdef ROWSORT_COUNT_ONLY
  if (tid < g) live[r0 + tid] = slive[tid];
  return;
#endif

  // Bitonic sort of every row, ascending.
  const int half_row = row_len >> 1;
  const int pairs = g * half_row;
  for (int size = 2; size <= row_len; size <<= 1) {
    for (int d = size >> 1; d > 0; d >>= 1) {
      for (int q = tid; q < pairs; q += kThreads) {
        const int j = q / half_row;
        const int w = q - j * half_row;
        const int lo = ((w & ~(d - 1)) << 1) | (w & (d - 1));
        const int hi = lo + d;
        const bool asc = (lo & size) == 0;
        int* rk = sk + j * rs;
        int* rv = sv + j * rs;
        const int ka = rk[lo];
        const int kb = rk[hi];
        if (asc ? (ka > kb) : (ka < kb)) {
          rk[lo] = kb;
          rk[hi] = ka;
          const int va = rv[lo];
          rv[lo] = rv[hi];
          rv[hi] = va;
        }
      }
      __syncthreads();
    }
  }

  const int kept = keep * g;
  for (int e = tid; e < kept; e += kThreads) {
    const int c = e / g;
    const int j = e - c * g;
    const long long o = static_cast<long long>(c) * rows + r0 + j;
    out_key[o] = sk[j * rs + c];
    out_val[o] = sv[j * rs + c];
  }
  if (tid < g) live[r0 + tid] = slive[tid];
}

}  // namespace

// key, val: (S,) int32; cut: (n_cut,) int32 or null; out_key, out_val:
// (keep, rows) int32; live: (rows,) int32. rows must be a multiple of 16 and
// row_len a power of two.
extern "C" int fourdgs_rowsort_full_network(const void* key, const void* val,
                                       long long s, int rows, int row_len,
                                       int keep, const void* cut, int n_cut,
                                       int key_shift, void* out_key,
                                       void* out_val, void* live,
                                       void* stream) {
  if (row_len < 2 || (row_len & (row_len - 1)) != 0 || keep < 1 ||
      keep > row_len || rows % 16 != 0 || n_cut > kTable) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#ifdef ROWSORT_G
  const int g = ROWSORT_G;
  if (rows % g != 0) return static_cast<int>(cudaErrorInvalidValue);
#else
  // Rows per block: as many as fit 64 KB of (key, value) rows, at most 16.
  int g = 16;
  while (g > 1 && 2LL * g * (row_len + 1) * 4 > 64 * 1024) g >>= 1;
#endif
  const size_t smem = (2ull * g * (row_len + 1) + kTable + g) * sizeof(int);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      rowsort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rowsort_kernel<<<rows / g, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(key), static_cast<const int*>(val), s, rows,
      row_len, g, keep, static_cast<const int*>(cut), n_cut, key_shift,
      static_cast<int*>(out_key), static_cast<int*>(out_val),
      static_cast<int*>(live));
  return static_cast<int>(cudaGetLastError());
}
