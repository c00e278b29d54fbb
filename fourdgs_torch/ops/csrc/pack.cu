// Operand packing for the converged frame: kernels K4, K5 and K14 of the
// port.
//
// K4 `fourdgs_pack_record_fields` replaces fourdgs/ops/pack_pallas.py
// `_pack_rec_kernel` (called through `pack_record_fields`,
// pack_pallas.py:174-192). It builds the (10, pad_to) f32 record matrix
// that the head gather and the tail kernel share:
//
//   [mx * (1/p00), my * (1/p11), v0x, v0y, il0, il1, r, g, b, a_eff],
//   il = (l != 0) ? 1/l : 0, and every column past n zero.
//
// The reciprocals 1/p00 and 1/p11 come from device memory (no host sync);
// centers are scaled by multiplying with them, as the reference does, not
// by dividing by p00.
//
// K5 `fourdgs_pack_meta_rows` replaces pack_pallas.py `_pack_kernel` (called
// through `pack_rows` from tail_pallas.py `tail_meta`). It writes the (6,
// pad_to) int32 tail meta matrix [tx0, tx1, ty0, ty1, dbits, span] with
// span = alive ? (tx1 - tx0 + 1) * (ty1 - ty0 + 1) : 0 computed here, and
// every column past n zero (a dead entry: span 0).
//
// `fourdgs_pack_rows` is K5's general form, the forward of the public
// `pack_rows` (pack_pallas.py:195-210): R <= 16 rows of n 4-byte words of
// one type stacked into (R, pad_to), every column past n zero.
//
// K14 `fourdgs_unpack_rows` replaces pack_pallas.py `_unpack_kernel` (the
// VJP of `pack_rows`, called through `_pack_core_bwd`, pack_pallas.py:75-93):
// row i of the (R, pad_to) cotangent, first n entries, becomes the i-th
// row's cotangent, all R rows in one launch.
//
// K5's general form and K14 are one row copy in opposite directions
// (row_copy.cuh): R separate arrays to the matrix's rows, or back. Each
// block moves one span of one row with 16-byte loads and stores, a thread's
// loads all issued before its first store; a row whose bases are not both
// 16-byte aligned, and the words past the last full vector, move word by
// word in the same kernel. Their earlier form, one thread per column, is in
// git at commit 044916e (PERF.md §6).
//
// Bound on the H100: memory bandwidth; each reads and writes every word
// once (K4 ~0.8 GB at the 10M-splat frame, K5 ~0.5 GB, its general form
// and K14 0.8 GB for ten rows of 10M words). K4 and K5's meta form: one
// thread per column, each row read and written coalesced. Built with
// -fmad=false like K1 (there is nothing to contract here; the flag keeps
// every kernel of the tail's operands rounding alike).

#include <cuda_runtime.h>

#include "row_copy.cuh"

namespace {

constexpr int kThreads = 256;

struct RecordRows {
  const float* rows[10];
};

__global__ void __launch_bounds__(kThreads)
pack_record_fields_kernel(RecordRows in, const float* __restrict__ inv_p,
                          float* __restrict__ out, int n, int pad_to) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= pad_to) return;
  const bool valid = i < n;
  const float inv00 = inv_p[0];
  const float inv11 = inv_p[1];
#pragma unroll
  for (int f = 0; f < 10; ++f) {
    float x = valid ? in.rows[f][i] : 0.0f;
    if (f == 0) {
      x = x * inv00;
    } else if (f == 1) {
      x = x * inv11;
    } else if (f == 4 || f == 5) {
      x = x != 0.0f ? 1.0f / x : 0.0f;
    }
    out[static_cast<long long>(f) * pad_to + i] = x;
  }
}

__global__ void __launch_bounds__(kThreads)
pack_meta_rows_kernel(const unsigned char* __restrict__ alive,
                      const int* __restrict__ tx0, const int* __restrict__ tx1,
                      const int* __restrict__ ty0, const int* __restrict__ ty1,
                      const int* __restrict__ dbits, int* __restrict__ out,
                      int n, int pad_to) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= pad_to) return;
  int a = 0, b = 0, c = 0, d = 0, e = 0, span = 0;
  if (i < n) {
    a = tx0[i];
    b = tx1[i];
    c = ty0[i];
    d = ty1[i];
    e = dbits[i];
    span = alive[i] ? (b - a + 1) * (d - c + 1) : 0;
  }
  const long long p = pad_to;
  out[i] = a;
  out[p + i] = b;
  out[2 * p + i] = c;
  out[3 * p + i] = d;
  out[4 * p + i] = e;
  out[5 * p + i] = span;
}

int blocks_for(int pad_to) { return (pad_to + kThreads - 1) / kThreads; }

constexpr int kMaxRows = row_copy::kMaxRows;
// The row copy's launch: 256 threads, two 16-byte vectors a thread a span
// (8 KB a block, 28 registers: eight blocks and 64 KB in flight an SM),
// streaming hints, the rows one after the other. On the H100 four or eight
// vectors a thread (80-128 KB in flight an SM) ran 0.3-4% slower, the rows
// interleaved 2-5%, persistent blocks and the bulk asynchronous copy
// through shared memory 5-7% (PERF.md §6; the trial forms are in git at
// commit 044916e).
constexpr int kCopyThreads = 256;
constexpr int kCopyVec = 2;
constexpr bool kCopyStream = true;

int copy_rows(const row_copy::Rows& rows, int r, int valid, int len,
              void* stream) {
  return row_copy::launch_copy_rows<kCopyThreads, kCopyVec, kCopyStream>(
      rows, r, valid, len, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int fourdgs_pack_record_fields(
    const void* mx, const void* my, const void* v0x, const void* v0y,
    const void* l0, const void* l1, const void* r, const void* g,
    const void* b, const void* a_eff, const void* inv_p, void* out, int n,
    int pad_to, void* stream) {
  if (n < 0 || pad_to < n || pad_to <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RecordRows in;
  const void* rows[10] = {mx, my, v0x, v0y, l0, l1, r, g, b, a_eff};
  for (int f = 0; f < 10; ++f) in.rows[f] = static_cast<const float*>(rows[f]);
  pack_record_fields_kernel<<<blocks_for(pad_to), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const float*>(inv_p), static_cast<float*>(out), n,
      pad_to);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fourdgs_pack_meta_rows(const void* alive, const void* tx0,
                                      const void* tx1, const void* ty0,
                                      const void* ty1, const void* dbits,
                                      void* out, int n, int pad_to,
                                      void* stream) {
  if (n < 0 || pad_to < n || pad_to <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pack_meta_rows_kernel<<<blocks_for(pad_to), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(alive),
      static_cast<const int*>(tx0), static_cast<const int*>(tx1),
      static_cast<const int*>(ty0), static_cast<const int*>(ty1),
      static_cast<const int*>(dbits), static_cast<int*>(out), n, pad_to);
  return static_cast<int>(cudaGetLastError());
}

// rows: r <= 16 pointers to (n,) arrays of 4-byte words (the others null);
// out: (r, pad_to) words.
extern "C" int fourdgs_pack_rows(
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
  row_copy::Rows copy = {};
  for (int f = 0; f < r; ++f) {
    copy.src[f] = static_cast<const int*>(rows[f]);
    copy.dst[f] = static_cast<int*>(out) + static_cast<long long>(f) * pad_to;
  }
  return copy_rows(copy, r, n, pad_to, stream);
}

// d_out: (r, pad_to) words; outputs: r <= 16 pointers to (n,) arrays.
extern "C" int fourdgs_unpack_rows(
    const void* d_out, int r, int n, int pad_to, void* o0, void* o1,
    void* o2, void* o3, void* o4, void* o5, void* o6, void* o7, void* o8,
    void* o9, void* o10, void* o11, void* o12, void* o13, void* o14,
    void* o15, void* stream) {
  if (r < 1 || r > kMaxRows || n < 0 || pad_to < n || pad_to <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  void* rows[kMaxRows] = {o0, o1, o2,  o3,  o4,  o5,  o6,  o7,
                          o8, o9, o10, o11, o12, o13, o14, o15};
  row_copy::Rows copy = {};
  for (int f = 0; f < r; ++f) {
    copy.src[f] = static_cast<const int*>(d_out)
                  + static_cast<long long>(f) * pad_to;
    copy.dst[f] = static_cast<int*>(rows[f]);
  }
  return copy_rows(copy, r, n, n, stream);
}
