// Trial forms of the row copy that K5's general form and K14 share
// (ops/csrc/row_copy.cuh), kept as a measuring instrument for
// fourdgs_torch/tools/pack_split.py: not part of the port's path. Each entry
// takes the port's arguments (`fourdgs_pack_rows`, `fourdgs_unpack_rows` of
// ops/csrc/pack.cu) after a `variant`:
//   0  the 2D grid of row_copy.cuh, 256 threads, 4 vectors a thread, plain
//      loads and stores;
//   1  the same with streaming (evict-first) loads and stores;
//   2  as 1 with 2 vectors a thread (the port's launch, ops/csrc/pack.cu);
//   3  as 1 with 8 vectors a thread;
//   4  as 1 in persistent blocks: as many as fit on the card at once, each
//      walking the (row, span) items by a grid stride;
//   5  Hopper's bulk asynchronous copy (no tensor map): one thread a block
//      keeps kBulkStages - 1 loads of kBulkChunk bytes in flight into a
//      shared-memory ring (cp.async.bulk ... mbarrier::complete_tx) and
//      writes each stage back with cp.async.bulk ... bulk_group, persistent
//      blocks. It moves whole 16-byte-aligned rows only: the entry refuses
//      (cudaErrorInvalidValue) a row that is not aligned, a length that is
//      not a multiple of four words, or a pack whose n < pad_to (no zero
//      fill), and a wait that outlasts ~2 s traps rather than hangs;
//   6  as 0 with 8 vectors a thread;
//   7  as 3 with 128 threads a block;
//   8  as 1 with 512 threads a block;
//   9  as 0 with 2 vectors a thread;
//  10  as 2 with the rows interleaved: a 1D grid whose block b moves span
//      b / R of row b % R, so that all R rows stream at once (as
//      torch.stack's kernel does) rather than one after the other;
//  11  as 10 with plain loads and stores.

#include <cuda_runtime.h>

#include <cstdint>

#include "../../ops/csrc/row_copy.cuh"

namespace {

using row_copy::kMaxRows;
using row_copy::Rows;

constexpr int kThreads = 256;
constexpr int kBulkStages = 4;
constexpr int kBulkChunk = 8192;                 // bytes a stage
constexpr int kBulkWords = kBulkChunk / 4;

template <int kVec, bool kStream>
__global__ void __launch_bounds__(kThreads)
copy_rows_persistent(const __grid_constant__ Rows rows, int r,
                     long long valid, long long len, long long spans) {
  const long long items = r * spans;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int f = static_cast<int>(item / spans);
    row_copy::copy_span<kThreads, kVec, kStream>(
        rows.src[f], rows.dst[f], valid, len, item - f * spans);
  }
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 32)) __trap();
  }
}

__global__ void __launch_bounds__(32)
copy_rows_bulk(const __grid_constant__ Rows rows, int r, long long len,
               long long chunks) {
  __shared__ alignas(128) unsigned char ring[kBulkStages][kBulkChunk];
  __shared__ alignas(8) unsigned long long bar[kBulkStages];
  if (threadIdx.x != 0) return;
  const long long items = r * chunks;
  const long long mine =
      blockIdx.x < items ? (items - blockIdx.x + gridDim.x - 1) / gridDim.x
                         : 0;
  for (int s = 0; s < kBulkStages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(shared_addr(&bar[s])) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");

  auto where = [&](long long i, int* f, long long* w0, uint32_t* bytes) {
    const long long item = blockIdx.x + i * gridDim.x;
    *f = static_cast<int>(item / chunks);
    *w0 = (item - *f * chunks) * kBulkWords;
    const long long words = len - *w0 < kBulkWords ? len - *w0 : kBulkWords;
    *bytes = static_cast<uint32_t>(words * 4);
  };
  auto issue_load = [&](long long i) {
    int f;
    long long w0;
    uint32_t bytes;
    where(i, &f, &w0, &bytes);
    const int s = static_cast<int>(i % kBulkStages);
    const uint32_t b = shared_addr(&bar[s]);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
        :: "r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(shared_addr(ring[s])), "l"(rows.src[f] + w0), "r"(bytes),
           "r"(b)
        : "memory");
  };

  for (long long i = 0; i < kBulkStages && i < mine; ++i) issue_load(i);
  for (long long i = 0; i < mine; ++i) {
    const int s = static_cast<int>(i % kBulkStages);
    wait_parity(shared_addr(&bar[s]),
                static_cast<uint32_t>((i / kBulkStages) & 1));
    int f;
    long long w0;
    uint32_t bytes;
    where(i, &f, &w0, &bytes);
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
        :: "l"(rows.dst[f] + w0), "r"(shared_addr(ring[s])), "r"(bytes)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // Refill the previous item's stage once its store has read it.
    if (i >= 1 && i - 1 + kBulkStages < mine) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      issue_load(i - 1 + kBulkStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int kVec, bool kStream>
__global__ void __launch_bounds__(kThreads)
copy_rows_interleaved(const __grid_constant__ Rows rows, int r,
                      long long valid, long long len) {
  const int f = blockIdx.x % r;
  row_copy::copy_span<kThreads, kVec, kStream>(
      rows.src[f], rows.dst[f], valid, len, blockIdx.x / r);
}

template <typename Kernel>
int resident_blocks(Kernel kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

int copy_rows_trial(int variant, const Rows& rows, int r, long long valid,
                    long long len, void* stream_arg) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_arg);
  switch (variant) {
    case 0:
      return row_copy::launch_copy_rows<kThreads, 4, false>(rows, r, valid,
                                                            len, stream);
    case 1:
      return row_copy::launch_copy_rows<kThreads, 4, true>(rows, r, valid,
                                                           len, stream);
    case 2:
      return row_copy::launch_copy_rows<kThreads, 2, true>(rows, r, valid,
                                                           len, stream);
    case 3:
      return row_copy::launch_copy_rows<kThreads, 8, true>(rows, r, valid,
                                                           len, stream);
    case 4: {
      const long long spans = row_copy::spans_for<kThreads, 4>(len);
      const long long items = r * spans;
      const int blocks = resident_blocks(copy_rows_persistent<4, true>,
                                         kThreads);
      copy_rows_persistent<4, true>
          <<<static_cast<unsigned>(items < blocks ? items : blocks),
             kThreads, 0, stream>>>(rows, r, valid, len, spans);
      return static_cast<int>(cudaGetLastError());
    }
    case 5: {
      if (valid != len || len % 4 != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      for (int f = 0; f < r; ++f) {
        if (((reinterpret_cast<uintptr_t>(rows.src[f])
              | reinterpret_cast<uintptr_t>(rows.dst[f])) & 15) != 0) {
          return static_cast<int>(cudaErrorInvalidValue);
        }
      }
      const long long chunks = (len + kBulkWords - 1) / kBulkWords;
      const long long items = r * chunks;
      const int blocks = resident_blocks(copy_rows_bulk, 32);
      copy_rows_bulk<<<static_cast<unsigned>(items < blocks ? items : blocks),
                       32, 0, stream>>>(rows, r, len, chunks);
      return static_cast<int>(cudaGetLastError());
    }
    case 6:
      return row_copy::launch_copy_rows<kThreads, 8, false>(rows, r, valid,
                                                            len, stream);
    case 7:
      return row_copy::launch_copy_rows<128, 8, true>(rows, r, valid, len,
                                                      stream);
    case 8:
      return row_copy::launch_copy_rows<512, 4, true>(rows, r, valid, len,
                                                      stream);
    case 9:
      return row_copy::launch_copy_rows<kThreads, 2, false>(rows, r, valid,
                                                            len, stream);
    case 10:
    case 11: {
      const long long blocks = r * row_copy::spans_for<kThreads, 2>(len);
      if (variant == 10) {
        copy_rows_interleaved<2, true><<<static_cast<unsigned>(blocks),
                                         kThreads, 0, stream>>>(rows, r,
                                                                valid, len);
      } else {
        copy_rows_interleaved<2, false><<<static_cast<unsigned>(blocks),
                                          kThreads, 0, stream>>>(rows, r,
                                                                 valid, len);
      }
      return static_cast<int>(cudaGetLastError());
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int fourdgs_pack_rows_trial(
    int variant, const void* r0, const void* r1, const void* r2,
    const void* r3, const void* r4, const void* r5, const void* r6,
    const void* r7, const void* r8, const void* r9, const void* r10,
    const void* r11, const void* r12, const void* r13, const void* r14,
    const void* r15, int r, void* out, int n, int pad_to, void* stream) {
  if (r < 1 || r > kMaxRows || n < 0 || pad_to < n || pad_to <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* in[kMaxRows] = {r0, r1, r2,  r3,  r4,  r5,  r6,  r7,
                              r8, r9, r10, r11, r12, r13, r14, r15};
  Rows rows = {};
  for (int f = 0; f < r; ++f) {
    rows.src[f] = static_cast<const int*>(in[f]);
    rows.dst[f] = static_cast<int*>(out) + static_cast<long long>(f) * pad_to;
  }
  return copy_rows_trial(variant, rows, r, n, pad_to, stream);
}

extern "C" int fourdgs_unpack_rows_trial(
    int variant, const void* d_out, int r, int n, int pad_to, void* o0,
    void* o1, void* o2, void* o3, void* o4, void* o5, void* o6, void* o7,
    void* o8, void* o9, void* o10, void* o11, void* o12, void* o13,
    void* o14, void* o15, void* stream) {
  if (r < 1 || r > kMaxRows || n < 0 || pad_to < n || pad_to <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  void* outs[kMaxRows] = {o0, o1, o2,  o3,  o4,  o5,  o6,  o7,
                          o8, o9, o10, o11, o12, o13, o14, o15};
  Rows rows = {};
  for (int f = 0; f < r; ++f) {
    rows.src[f] = static_cast<const int*>(d_out)
                  + static_cast<long long>(f) * pad_to;
    rows.dst[f] = static_cast<int*>(outs[f]);
  }
  return copy_rows_trial(variant, rows, r, n, n, stream);
}
