// The shared-memory form of the merge kernels K11 (merge tree) and K13
// (merge finish), the port's first design, kept as a measuring instrument
// for fourdgs_torch/tools/sort_split.py and as the earlier form that
// chip_smoke.py holds the present kernels to bit for bit: it is not part of
// the port's path. A block of 1,024 threads loads B = `block` consecutive
// (key, value) pairs into shared memory and runs every compare-exchange
// stage of its levels as one pass over shared memory, closed by a block-wide
// barrier: 60 stages in K11 (runs of 512 merged up to runs of 16,384), 14 in
// each K13. Built as it is, or with
//   -DMERGE_LOAD_STORE_ONLY   the load and the store only, no stage;
//   -DMERGE_NO_BARRIER        every stage without its barrier (a time
//                             only: the result is not a sorted run);
//   -DMERGE_MIN_DISTANCE=32   only the stages at distances >= 32 (a time
//                             only), which leaves out the distances whose
//                             index map has 2-way bank conflicts;
// the differences between their times split the kernels' time into the
// load and store, the stages' shared-memory traffic, the barriers, and the
// bank-conflicted small distances.

#include <cuda_runtime.h>

#ifndef MERGE_MIN_DISTANCE
#define MERGE_MIN_DISTANCE 1
#endif

namespace {

constexpr int kBlockThreads = 1024;

__device__ __forceinline__ void shared_stage(int* sk, int* sv, int n, int d,
                                             long long base, int run_shift,
                                             bool alternate) {
#ifdef MERGE_LOAD_STORE_ONLY
  return;
#endif
  if (d < MERGE_MIN_DISTANCE) return;
  for (int q = threadIdx.x; q < (n >> 1); q += kBlockThreads) {
    const int lo = ((q & ~(d - 1)) << 1) | (q & (d - 1));
    const int hi = lo + d;
    const bool desc = alternate && (((base + lo) >> run_shift) & 1);
    const int ka = sk[lo];
    const int kb = sk[hi];
    if (desc ? (ka < kb) : (kb < ka)) {
      sk[lo] = kb;
      sk[hi] = ka;
      const int va = sv[lo];
      sv[lo] = sv[hi];
      sv[hi] = va;
    }
  }
#ifndef MERGE_NO_BARRIER
  __syncthreads();
#endif
}

__device__ __forceinline__ int log2_of(long long x) {
  return 63 - __clzll(x);
}

__global__ void __launch_bounds__(kBlockThreads)
merge_tree_kernel(const int* __restrict__ key, const int* __restrict__ val,
                  int* __restrict__ out_key, int* __restrict__ out_val,
                  long long total, int c, int block, int flip_odd_rows) {
  extern __shared__ int smem[];
  int* sk = smem;
  int* sv = smem + block;
  const long long base = static_cast<long long>(blockIdx.x) * block;
  const int c_shift = log2_of(c);
  for (int e = threadIdx.x; e < block; e += kBlockThreads) {
    long long src = base + e;
    if (flip_odd_rows && ((src >> c_shift) & 1)) {
      const long long col = src & (c - 1);
      src = src - col + (c - 1 - col);
    }
    sk[e] = key[src];
    sv[e] = val[src];
  }
  __syncthreads();
  for (int half = c; half < block; half <<= 1) {
    const long long run_out = 2LL * half;
    const int run_shift = log2_of(run_out);
    const bool alternate = run_out < total;
    for (int d = half; d > 0; d >>= 1) {
      shared_stage(sk, sv, block, d, base, run_shift, alternate);
    }
  }
#if defined(MERGE_NO_BARRIER) || defined(MERGE_LOAD_STORE_ONLY)
  __syncthreads();      // as it is, the last stage's barrier stands here
#endif
  for (int e = threadIdx.x; e < block; e += kBlockThreads) {
    out_key[base + e] = sk[e];
    out_val[base + e] = sv[e];
  }
}

__global__ void __launch_bounds__(kBlockThreads)
merge_finish_kernel(int* __restrict__ key, int* __restrict__ val,
                    long long total, int block, int run_shift,
                    int alternate) {
  extern __shared__ int smem[];
  int* sk = smem;
  int* sv = smem + block;
  const long long base = static_cast<long long>(blockIdx.x) * block;
  for (int e = threadIdx.x; e < block; e += kBlockThreads) {
    sk[e] = key[base + e];
    sv[e] = val[base + e];
  }
  __syncthreads();
  for (int d = block >> 1; d > 0; d >>= 1) {
    shared_stage(sk, sv, block, d, base, run_shift, alternate != 0);
  }
#if defined(MERGE_NO_BARRIER) || defined(MERGE_LOAD_STORE_ONLY)
  __syncthreads();
#endif
  for (int e = threadIdx.x; e < block; e += kBlockThreads) {
    key[base + e] = sk[e];
    val[base + e] = sv[e];
  }
}

bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

int host_log2(long long x) {
  int s = 0;
  while ((1LL << s) < x) ++s;
  return s;
}

size_t block_smem(int block) {
  const size_t bytes = 2ull * block * sizeof(int);
  return bytes <= 227 * 1024 ? bytes : 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

}  // namespace

// As fourdgs_merge_tree of ops/csrc/merge.cu.
extern "C" int fourdgs_merge_tree_shared(const void* key, const void* val,
                                         void* out_key, void* out_val,
                                         long long total, int c, int block,
                                         int rows_alternating, void* stream) {
  const size_t smem = pow2(block) ? block_smem(block) : 0;
  if (!pow2(total) || !pow2(c) || smem == 0 || c > block || block > total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(merge_tree_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_tree_kernel<<<static_cast<unsigned>(total / block), kBlockThreads,
                      smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(key), static_cast<const int*>(val),
      static_cast<int*>(out_key), static_cast<int*>(out_val), total, c, block,
      rows_alternating ? 0 : 1);
  return static_cast<int>(cudaGetLastError());
}

// As fourdgs_merge_finish of ops/csrc/merge.cu.
extern "C" int fourdgs_merge_finish_shared(void* key, void* val,
                                           long long total, int block,
                                           long long run_out, void* stream) {
  const size_t smem = pow2(block) ? block_smem(block) : 0;
  if (!pow2(total) || !pow2(run_out) || smem == 0 || block < 2 ||
      block > run_out || run_out > total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(merge_finish_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_finish_kernel<<<static_cast<unsigned>(total / block), kBlockThreads,
                        smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(key), static_cast<int*>(val), total, block,
      host_log2(run_out), run_out < total ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
