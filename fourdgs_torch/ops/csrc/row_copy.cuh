// The row copy that K5's general form (`fourdgs_pack_rows`) and K14
// (`fourdgs_unpack_rows`) of pack.cu share: R <= 16 rows, each `valid`
// 4-byte words read from `src[f]` and `len` >= `valid` words written to
// `dst[f]`, the words past `valid` zero. The pack reads R separate arrays and
// writes the rows of an (R, pad_to) matrix (len = pad_to); the unpack reads
// the matrix's rows and writes R separate arrays (len = valid = n).
//
// Bound on the H100: memory bandwidth, every word read once and written
// once. Design: a block of kThreads threads owns one span of kSpan = 4 *
// kVec * kThreads words of one row. A row whose two bases are both 16-byte
// aligned takes the vector path: thread t moves the kVec vectors (int4) v *
// kThreads + t of the span and issues all their loads before its first
// store, so every load of a warp is in flight at once and each access is a
// full 512-byte line a warp. The vector that holds word `valid` or word
// `len` (when either is not a multiple of four) loads or stores word by word
// in the same place. A row that is not aligned (pad_to % 4 != 0 puts every
// other packed row off 16 bytes; a view may start at any word) takes the
// scalar path: thread t moves the words i * kThreads + t of the span, i <
// 4 * kVec, all loads before the first store. Either way each word of
// [0, len) is written once, by the block of its span. With kStream the
// vector path's loads and stores carry the streaming (evict-first) hint:
// the 800 MB of a 10M-splat pack pass through the 50 MB L2 once.
//
// `pack_cuda.row_copy_plan` writes this partition out in plain PyTorch;
// tests/test_torch_pack_rows.py holds it on the CPU.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace row_copy {

constexpr int kMaxRows = 16;

// Row f reads src[f] and writes dst[f]; only rows f < R are used. Passed by
// value as a __grid_constant__ parameter, so a row's pointers are read from
// the parameter space by its index, with no local copy of the table.
struct Rows {
  const int* src[kMaxRows];
  int* dst[kMaxRows];
};

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
__device__ __forceinline__ void store4(int* p, int4 v) {
  int4* q = reinterpret_cast<int4*>(p);
  if constexpr (kStream) {
    __stcs(q, v);
  } else {
    *q = v;
  }
}

__device__ __forceinline__ int word_or_zero(const int* src, int j,
                                            int valid) {
  return j < valid ? src[j] : 0;
}

__device__ __forceinline__ int clamp_to_span(long long words, int span) {
  return static_cast<int>(words < 0 ? 0 : (words > span ? span : words));
}

// Span `span` of one row, moved by the calling block: kVec vectors (or 4 *
// kVec words) a thread. Past the span's first word every index is 32-bit:
// `valid` and `len` are cut to the span.
template <int kThreads, int kVec, bool kStream>
__device__ __forceinline__ void copy_span(const int* __restrict__ src,
                                          int* __restrict__ dst,
                                          long long valid, long long len,
                                          long long span) {
  constexpr int kSpan = 4 * kVec * kThreads;
  const int t = threadIdx.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(src)
                     | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  src += span * kSpan;
  dst += span * kSpan;
  const int in = clamp_to_span(valid - span * kSpan, kSpan);
  const int out = clamp_to_span(len - span * kSpan, kSpan);
  if (vec) {
    int4 w[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int j = 4 * (v * kThreads + t);
      if (j + 4 <= in) {
        w[v] = load4<kStream>(src + j);
      } else {
        w[v] = make_int4(word_or_zero(src, j, in),
                         word_or_zero(src, j + 1, in),
                         word_or_zero(src, j + 2, in),
                         word_or_zero(src, j + 3, in));
      }
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int j = 4 * (v * kThreads + t);
      if (j + 4 <= out) {
        store4<kStream>(dst + j, w[v]);
      } else {
        if (j < out) dst[j] = w[v].x;
        if (j + 1 < out) dst[j + 1] = w[v].y;
        if (j + 2 < out) dst[j + 2] = w[v].z;
      }
    }
  } else {
    int w[4 * kVec];
#pragma unroll
    for (int i = 0; i < 4 * kVec; ++i) {
      w[i] = word_or_zero(src, i * kThreads + t, in);
    }
#pragma unroll
    for (int i = 0; i < 4 * kVec; ++i) {
      const int j = i * kThreads + t;
      if (j < out) dst[j] = w[i];
    }
  }
}

template <int kThreads, int kVec>
constexpr long long spans_for(long long len) {
  return (len + 4 * kVec * kThreads - 1) / (4 * kVec * kThreads);
}

// Grid (spans_for(len), R): block (x, y) moves span x of row y.
template <int kThreads, int kVec, bool kStream>
__global__ void __launch_bounds__(kThreads)
copy_rows_kernel(const __grid_constant__ Rows rows, long long valid,
                 long long len) {
  copy_span<kThreads, kVec, kStream>(rows.src[blockIdx.y],
                                     rows.dst[blockIdx.y], valid, len,
                                     blockIdx.x);
}

template <int kThreads, int kVec, bool kStream>
int launch_copy_rows(const Rows& rows, int r, long long valid, long long len,
                     cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(spans_for<kThreads, kVec>(len)), r);
  copy_rows_kernel<kThreads, kVec, kStream><<<grid, kThreads, 0, stream>>>(
      rows, valid, len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace row_copy
