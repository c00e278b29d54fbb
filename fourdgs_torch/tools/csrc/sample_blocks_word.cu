// The block sampler's first design, K3 as ops/csrc/sample_blocks.cu had it
// before it copied one 16-byte vector a thread over all sample blocks, kept
// as a measuring instrument for fourdgs_torch/tools/prepass_split.py and as
// the earlier form that chip_smoke.py holds the present kernel to bit for
// bit: it is not part of the port's path. One block of 256 threads a sample
// block, one 32-bit word a thread. Built as it is, or with
//   -DSAMPLE_VEC4   one thread per 16-byte vector of the sample block
//                   (take_rows * 32 threads a block; needs a 16-byte aligned
//                   input, else the entry refuses), nothing else changed.
//
// Beside it, for the same instrument:
//   * `fourdgs_sample_blocks_word_loop` enqueues `reps` launches of the
//     kernel from one C loop, so that the host's cost per launch (the
//     wrapper's checks, the ctypes call) is not in their time;
//   * `fourdgs_empty_launch` launches an empty kernel of `blocks` x
//     `threads`, `reps` times from one C loop: the floor that any launch
//     has on the card.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void sample_blocks_word_kernel(const unsigned int* __restrict__ in,
                                          unsigned int* __restrict__ out,
                                          int stride_rows, int take_rows) {
  const long long g = blockIdx.x;
  const long long src_row = (g * stride_rows / 8) * 8;
  const int words = take_rows * 128;
  const unsigned int* src = in + src_row * 128;
  unsigned int* dst = out + g * words;
#ifdef SAMPLE_VEC4
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int j = threadIdx.x; j < words / 4; j += blockDim.x) d4[j] = s4[j];
#else
  for (int j = threadIdx.x; j < words; j += blockDim.x) dst[j] = src[j];
#endif
}

__global__ void empty_kernel() {}

int launch(const void* in, void* out, int nblocks, int stride_rows,
           int take_rows, cudaStream_t stream) {
#ifdef SAMPLE_VEC4
  const int threads = take_rows * 32;
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out))
      & 15) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#else
  const int threads = 256;
#endif
  sample_blocks_word_kernel<<<nblocks, threads, 0, stream>>>(
      static_cast<const unsigned int*>(in), static_cast<unsigned int*>(out),
      stride_rows, take_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fourdgs_sample_blocks_word(const void* in, void* out,
                                          int nblocks, int stride_rows,
                                          int take_rows, void* stream) {
  if (nblocks <= 0 || take_rows < 1 || take_rows > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(in, out, nblocks, stride_rows, take_rows,
                static_cast<cudaStream_t>(stream));
}

extern "C" int fourdgs_sample_blocks_word_loop(const void* in, void* out,
                                               int nblocks, int stride_rows,
                                               int take_rows, int reps,
                                               void* stream) {
  if (nblocks <= 0 || take_rows < 1 || take_rows > 8 || reps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int r = 0; r < reps; ++r) {
    const int err = launch(in, out, nblocks, stride_rows, take_rows,
                           static_cast<cudaStream_t>(stream));
    if (err != 0) return err;
  }
  return 0;
}

extern "C" int fourdgs_empty_launch(int blocks, int threads, int reps,
                                    void* stream) {
  if (blocks <= 0 || threads <= 0 || reps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int r = 0; r < reps; ++r) {
    empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  }
  return static_cast<int>(cudaGetLastError());
}
