// Standalone depth-prune cut: kernel K10 of the port.
//
// Replaces fourdgs/ops/lookup_pallas.py `_kernel` (called through
// `apply_cutkeys`, lookup_pallas.py:105-142). Over the (S,) int32 pair keys
// ((tile << 20) | depth bits, DEAD = INT32_MAX for an empty slot):
//
//   out[i] = key[i] <= table[clamp(key[i] >> 20, 0, 2047)] ? key[i] : DEAD,
//
// where table is the (n_cut <= 2048,) per-tile cut padded with DEAD. A DEAD
// key selects entry 2047, which is always padding or a cut no larger than
// DEAD, and stays DEAD.
//
// Bound on the H100: memory bandwidth, one read and one write of the key
// array (8 bytes a key; 321 MB at the 40M slots of the 10M-splat frame).
// The TPU kernel spends its body on sixteen lane shuffles per key because
// its vector unit has no gather; here the 8 KB table sits in shared memory
// and each thread indexes it. Design: a thread loads four keys as one
// 16-byte word, looks each up and stores 16 bytes; a grid-stride loop covers
// the vector part and the same threads finish the ragged tail (S % 4) one
// key each, so any S is taken in one launch.

#include <cuda_runtime.h>

namespace {

constexpr int kDead = 0x7fffffff;
constexpr int kTable = 2048;
constexpr int kThreads = 256;
constexpr int kShift = 20;

__device__ __forceinline__ int cut_one(int k, const int* table) {
  int t = k >> kShift;
  t = t < 0 ? 0 : (t > kTable - 1 ? kTable - 1 : t);
  return k <= table[t] ? k : kDead;
}

__global__ void __launch_bounds__(kThreads)
apply_cutkeys_kernel(const int* __restrict__ key, long long s,
                     const int* __restrict__ cut, int n_cut,
                     int* __restrict__ out) {
  __shared__ int table[kTable];
  for (int i = threadIdx.x; i < kTable; i += kThreads) {
    table[i] = i < n_cut ? cut[i] : kDead;
  }
  __syncthreads();
  const long long n4 = s >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int4* key4 = reinterpret_cast<const int4*>(key);
  int4* out4 = reinterpret_cast<int4*>(out);
  for (long long i = first; i < n4; i += stride) {
    int4 k = key4[i];
    k.x = cut_one(k.x, table);
    k.y = cut_one(k.y, table);
    k.z = cut_one(k.z, table);
    k.w = cut_one(k.w, table);
    out4[i] = k;
  }
  const long long tail = (n4 << 2) + first;
  if (tail < s) out[tail] = cut_one(key[tail], table);
}

}  // namespace

// key, out: (S,) int32, 16-byte aligned; cut: (n_cut <= 2048,) int32.
extern "C" int fourdgs_apply_cutkeys(const void* key, long long s,
                                     const void* cut, int n_cut, void* out,
                                     void* stream) {
  if (s < 0 || n_cut < 0 || n_cut > kTable) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (s == 0) return 0;
  if ((reinterpret_cast<size_t>(key) | reinterpret_cast<size_t>(out)) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  // 16 resident blocks of 256 threads fill an SM's 2048 thread slots; the
  // grid-stride loop amortises the table load over many keys a block.
  const long long want = ((s >> 2) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      want < 1 ? 1 : (want > 132 * 16 ? 132 * 16 : want));
  apply_cutkeys_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(key), s, static_cast<const int*>(cut), n_cut,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
