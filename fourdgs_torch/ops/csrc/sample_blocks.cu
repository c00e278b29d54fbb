// Evenly spaced block sampler: kernel K3 of the port.
//
// Replaces fourdgs/ops/lookup_pallas.py `_sample_kernel` (called through
// `sample_blocks`, lookup_pallas.py:55-102). The input is an (N,) array of
// 32-bit words viewed as rows of 128; sample block g copies take_rows rows
// starting at row (g * stride_rows / 8) * 8. The floor to 8-row granules is
// the reference's (its BlockSpec index map counts 8-row blocks) and is kept:
// it decides which keys the depth-prune cut estimator sees.
//
// Bound on the H100: a few thousand blocks of 1 KB each (2,342 blocks of
// 256 words at the 10M-splat frame), so launch latency and the scattered
// read of one row window per block bound it, not bandwidth. Design: one
// thread block per sample block, one 32-bit word per thread, coalesced
// 512-byte row reads and writes.

#include <cuda_runtime.h>

namespace {

__global__ void sample_blocks_kernel(const unsigned int* __restrict__ in,
                                     unsigned int* __restrict__ out,
                                     int stride_rows, int take_rows) {
  const long long g = blockIdx.x;
  const long long src_row = (g * stride_rows / 8) * 8;
  const int words = take_rows * 128;
  const unsigned int* src = in + src_row * 128;
  unsigned int* dst = out + g * words;
  for (int j = threadIdx.x; j < words; j += blockDim.x) dst[j] = src[j];
}

}  // namespace

extern "C" int fourdgs_sample_blocks(const void* in, void* out, int nblocks,
                                     int stride_rows, int take_rows,
                                     void* stream) {
  if (nblocks <= 0 || take_rows < 1 || take_rows > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sample_blocks_kernel<<<nblocks, 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned int*>(in), static_cast<unsigned int*>(out),
      stride_rows, take_rows);
  return static_cast<int>(cudaGetLastError());
}
