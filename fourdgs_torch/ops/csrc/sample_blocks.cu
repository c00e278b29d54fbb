// Evenly spaced block sampler: kernel K3 of the port.
//
// Replaces fourdgs/ops/lookup_pallas.py `_sample_kernel` (called through
// `sample_blocks`, lookup_pallas.py:55-102). The input is an (N,) array of
// 32-bit words viewed as rows of 128; sample block g copies take_rows rows
// starting at row (g * stride_rows / 8) * 8. The floor to 8-row granules is
// the reference's (its BlockSpec index map counts 8-row blocks) and is kept:
// it decides which keys the depth-prune cut estimator sees (ROADMAP C-R3).
//
// Bound on the H100: a few MB read from scattered 512-byte rows and written
// once (2,335 blocks of 1 KB at the 10M-splat frame's prune sample), a few
// microseconds of bandwidth, so launch latency and one DRAM round trip bound
// it. Design: one thread per 16-byte vector of the output, over every sample
// block of the call (take_rows * 32 threads a block's rows; 149K threads in
// 584 blocks of 256 at the prune sample, one wave), each issuing its load
// before its store: the whole copy is one wave of independent 16-byte
// round trips. A sample's rows start 512 bytes apart from the base, so they
// are 16-byte aligned when the base is; a base that is not (a view at a
// storage offset) takes a scalar path in the same kernel: the thread moves
// its vector's four words one by one, all four loads before the first store.
//
// `lookup_cuda.sample_plan` writes this partition out in plain PyTorch;
// tests/test_torch_tail_prepass_split.py holds it on the CPU.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sample_blocks_kernel(const unsigned int* __restrict__ in,
                     unsigned int* __restrict__ out, int stride_rows,
                     int take_rows, int vectors, int vec) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= vectors) return;
  const int per_block = take_rows * 32;           // vectors a sample block
  const long long g = i / per_block;
  const int w = 4 * (i - static_cast<int>(g) * per_block);
  const long long src = (g * stride_rows / 8) * 8 * 128 + w;
  const long long dst = g * per_block * 4 + w;
  if (vec) {
    const uint4 v = *reinterpret_cast<const uint4*>(in + src);
    *reinterpret_cast<uint4*>(out + dst) = v;
  } else {
    const unsigned int a = in[src], b = in[src + 1], c = in[src + 2],
                       d = in[src + 3];
    out[dst] = a;
    out[dst + 1] = b;
    out[dst + 2] = c;
    out[dst + 3] = d;
  }
}

}  // namespace

extern "C" int fourdgs_sample_blocks(const void* in, void* out, int nblocks,
                                     int stride_rows, int take_rows,
                                     void* stream) {
  const long long vectors = static_cast<long long>(nblocks) * take_rows * 32;
  if (nblocks <= 0 || take_rows < 1 || take_rows > 8 || vectors > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = ((reinterpret_cast<uintptr_t>(in)
                    | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int grid = static_cast<int>((vectors + kThreads - 1) / kThreads);
  sample_blocks_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned int*>(in), static_cast<unsigned int*>(out),
      stride_rows, take_rows, static_cast<int>(vectors), vec);
  return static_cast<int>(cudaGetLastError());
}
