// The row pack's first design, K5's general form (`fourdgs_pack_rows`) and
// K14 (`fourdgs_unpack_rows`) as ops/csrc/pack.cu had them before they
// shared one vectorised row copy, kept as a measuring instrument for
// fourdgs_torch/tools/pack_split.py and as the earlier form that
// chip_smoke.py holds the present kernels to bit for bit: it is not part of
// the port's path. One thread per column: K5's thread stores each row's
// word before it loads the next row's, from plain `int*` pointers held in a
// by-value table, the load behind `i < n`; K14's thread reads the R words a
// stride of pad_to apart through `const int* __restrict__` and writes one
// word to each of the R outputs. Built as it is, or with
//   -DPACK_RESTRICT      K5 reads through `const int* __restrict__`;
//   -DPACK_LOADS_FIRST   K5 issues a thread's R loads into registers before
//                        its first store;
//   -DUNPACK_VEC4        K14 moves four columns a thread with 16-byte loads
//                        and stores (needs n % 4 == 0 and pad_to % 4 == 0,
//                        else the entry refuses), nothing else changed;
// the differences between their times split the kernels' time into the
// load issue order, the access width and the rest.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;

#ifdef PACK_RESTRICT
#define PACK_ROW_PTR const int* __restrict__
#else
#define PACK_ROW_PTR int*
#endif

struct InRows {
  PACK_ROW_PTR rows[kMaxRows];
};

struct OutRows {
  int* rows[kMaxRows];
};

__global__ void __launch_bounds__(kThreads)
pack_rows_kernel(InRows in, int r, int* __restrict__ out, int n,
                 int pad_to) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= pad_to) return;
  const bool valid = i < n;
#ifdef PACK_LOADS_FIRST
  int v[kMaxRows];
#pragma unroll
  for (int f = 0; f < kMaxRows; ++f) {
    v[f] = (f < r && valid) ? in.rows[f][i] : 0;
  }
#pragma unroll
  for (int f = 0; f < kMaxRows; ++f) {
    if (f < r) out[static_cast<long long>(f) * pad_to + i] = v[f];
  }
#else
  // Unrolled over the most rows, so that every pointer is read from the
  // kernel's parameters by a constant index (no local copy of the table).
#pragma unroll
  for (int f = 0; f < kMaxRows; ++f) {
    if (f < r) {
      out[static_cast<long long>(f) * pad_to + i] = valid ? in.rows[f][i] : 0;
    }
  }
#endif
}

#ifdef UNPACK_VEC4
__global__ void __launch_bounds__(kThreads)
unpack_rows_kernel(const int* __restrict__ d_out, int r, int n, int pad_to,
                   OutRows out) {
  const int q = blockIdx.x * kThreads + threadIdx.x;   // a group of 4 words
  if (q >= n / 4) return;
#pragma unroll
  for (int f = 0; f < kMaxRows; ++f) {
    if (f < r) {
      reinterpret_cast<int4*>(out.rows[f])[q] = reinterpret_cast<const int4*>(
          d_out + static_cast<long long>(f) * pad_to)[q];
    }
  }
}
#else
__global__ void __launch_bounds__(kThreads)
unpack_rows_kernel(const int* __restrict__ d_out, int r, int n, int pad_to,
                   OutRows out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
#pragma unroll
  for (int f = 0; f < kMaxRows; ++f) {
    if (f < r) out.rows[f][i] = d_out[static_cast<long long>(f) * pad_to + i];
  }
}
#endif

int blocks_for(int columns) { return (columns + kThreads - 1) / kThreads; }

}  // namespace

// rows: r <= 16 pointers to (n,) arrays of 4-byte words (the others null);
// out: (r, pad_to) words.
extern "C" int fourdgs_pack_rows_scalar(
    const void* r0, const void* r1, const void* r2, const void* r3,
    const void* r4, const void* r5, const void* r6, const void* r7,
    const void* r8, const void* r9, const void* r10, const void* r11,
    const void* r12, const void* r13, const void* r14, const void* r15,
    int r, void* out, int n, int pad_to, void* stream) {
  if (r < 1 || r > kMaxRows || n < 0 || pad_to < n || pad_to <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* rows[kMaxRows] = {r0, r1, r2,  r3,  r4,  r5,  r6,  r7,
                                r8, r9, r10, r11, r12, r13, r14, r15};
  InRows in;
  for (int f = 0; f < kMaxRows; ++f) {
    in.rows[f] = static_cast<int*>(const_cast<void*>(rows[f]));
  }
  pack_rows_kernel<<<blocks_for(pad_to), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      in, r, static_cast<int*>(out), n, pad_to);
  return static_cast<int>(cudaGetLastError());
}

// d_out: (r, pad_to) words; outputs: r <= 16 pointers to (n,) arrays.
extern "C" int fourdgs_unpack_rows_scalar(
    const void* d_out, int r, int n, int pad_to, void* o0, void* o1,
    void* o2, void* o3, void* o4, void* o5, void* o6, void* o7, void* o8,
    void* o9, void* o10, void* o11, void* o12, void* o13, void* o14,
    void* o15, void* stream) {
  if (r < 1 || r > kMaxRows || n < 0 || pad_to < n || pad_to <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#ifdef UNPACK_VEC4
  if (n % 4 != 0 || pad_to % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int columns = n / 4;
#else
  const int columns = n;
#endif
  if (n == 0) return 0;
  void* rows[kMaxRows] = {o0, o1, o2,  o3,  o4,  o5,  o6,  o7,
                          o8, o9, o10, o11, o12, o13, o14, o15};
  OutRows out;
  for (int f = 0; f < kMaxRows; ++f) out.rows[f] = static_cast<int*>(rows[f]);
  unpack_rows_kernel<<<blocks_for(columns), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(d_out), r, n, pad_to, out);
  return static_cast<int>(cudaGetLastError());
}
