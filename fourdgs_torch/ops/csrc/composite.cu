// Per-tile ordered front-to-back alpha compositing: kernel K1 of the port.
//
// Replaces fourdgs/ops/composite_pallas.py `_composite_kernel`, reached
// through `_composite_pallas_raw` (composite_pallas.py:283-325, batched by
// `_squeeze_kernel`) and `_composite_pallas_at_raw` (:614-663, the in-place
// deepening pass). One thread block composites one tile of P pixels:
//
//   records (Tb, F, M) f32, rows sx, sy, v0x, v0y, il0, il1, r, g, b, a_eff
//   counts (Tb,) i32; kx, ky (T, P) pixel coords in k units;
//   carry / out (T, 8, P): rows r, g, b, a (sum alpha^2 T), T, 0, 0, 0.
//
// With `sel` (Tb,) i32, item i composites records[i] into tile sel[i]; the
// carry may alias the output (each thread reads its pixels' carry before it
// writes them), which is the reference's in-place deepening pass. `sel`
// entries are distinct; fillers have count 0 and write the carry back.
// Block b takes item order[b] (`order` (Tb,) i64, a permutation; the wrapper
// passes the items by descending count, so the deepest tiles start first),
// or item b without it; the result does not depend on the order.
//
// Semantics kept exactly from the reference:
//   * alpha = min(cover ? a_eff * w : 0, 1 - 1e-6), cover = |n0| <= 0.5 and
//     |n1| <= 0.5 and w >= 1e-4, w = exp(-0.5 * 64 (n0^2 + n1^2));
//   * row 3 accumulates alpha * wgt = alpha^2 T;
//   * early exit is tile-wide and per 128-record chunk: chunk c runs only
//     if c < ceil(n / 128) and the tile's max T is above 1e-6. The deepening
//     selection reads that T, so a per-pixel exit would change it.
// The blend walks each chunk sequentially (GL's arithmetic): the exclusive
// transmittance is T_chunk_start * prod_{j<i}(1 - alpha_j), with the running
// product restarted at 1 per chunk, as the reference's per-chunk scan does;
// the per-chunk sums are added to the carry at the chunk's end. The file is
// built with -fmad=false so every operation rounds as the plain PyTorch
// version's does: a contracted multiply-add can flip the w >= 1e-4 or
// |n| <= 0.5 coverage tests at their boundaries. Records past the count in
// the last chunk are not walked: the pack gives them a_eff = 0, so each
// would add exact zeros and multiply T by 1.
//
// Bound on the H100: not the card's rates (at the 10M-splat frames the
// function moves ~0.15 GB and tests ~0.16 G (record, pixel) pairs, 0.05 ms
// at HBM rate) but the latency of each warp's walk through a deep tile's
// records, one after another, and the shared-memory reads of that walk (the
// earlier K1 read six fields a pair; its coverage test alone took 0.18 of
// its 0.38 ms, PERF.md §6). Design (the record walk of
// composite_walk.cuh, shared with K8): records outside, pixels inside, so a
// record's ten fields are read once a warp and not once a pixel; a warp owns
// 32 columns x 4 rows and skips, by a warp-uniform ballot list, every record
// whose cull box misses them (the per-pixel test would reject each such
// pair, so the skip changes no bit); each pixel of a walked record takes the
// same operations, with selects where the earlier K1 branched, so the
// pixels' chains interleave; the tile's accumulators stay in shared memory
// (touched once a chunk), which holds the kernel to 64 registers, two blocks
// of 512 threads an SM; the next chunk is staged by cp.async while this one
// is walked. Each pixel's operations and their order are the earlier K1's,
// so its output is the same bit for bit. A tile cannot be split (the early
// exit is tile-wide), so the grid stays one block a tile, but the blocks take
// the tiles deepest first: the work a tile holds varies far more than its
// chunk count, and in tile order the last deep tiles start late (PERF.md
// §6; the earlier form and the tool that timed both orders are in git at
// commit 044916e).

#include <cuda_runtime.h>

#include <cstdint>

#include "composite_walk.cuh"

namespace {

using composite_walk::kChunk;
using composite_walk::kFields;
using composite_walk::kHitWords;
// At most 4 pixels a thread at <= 64 registers: at P = 2048, two blocks of
// 512 threads an SM.
template <int P>
using Shape = composite_walk::Shape<P, 4, 64>;

template <int P>
__global__ void __launch_bounds__(Shape<P>::kThreads, Shape<P>::kMinBlocks)
composite_kernel(const float* __restrict__ rec, const int* __restrict__ counts,
                 const int* __restrict__ sel,
                 const long long* __restrict__ order,
                 const float* __restrict__ kx, const float* __restrict__ ky,
                 const float* carry, float* out, int f_stride, int m,
                 bool vec) {
  constexpr int THREADS = Shape<P>::kThreads;
  constexpr int PPT = Shape<P>::kPpt;
  // Dynamic shared memory: the staged chunks [2][kFields][kChunk], the
  // boxes [kChunk], and the accumulators r, g, b, a of the tile [4][P]
  // (touched once a chunk, so they stay out of the registers).
  extern __shared__ __align__(16) float smem[];
  float* s_rec = smem;
  float4* s_box = reinterpret_cast<float4*>(smem + 2 * kFields * kChunk);
  float* s_acc = reinterpret_cast<float*>(s_box + kChunk);
  __shared__ int s_first;
  const int b = order != nullptr ? static_cast<int>(order[blockIdx.x])
                                 : static_cast<int>(blockIdx.x);
  const int tile = sel != nullptr ? sel[b] : b;
  const int n = counts[b];
  int n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > m / kChunk) n_chunks = m / kChunk;
  const float alpha_max = static_cast<float>(1.0 - 1e-6);

  const float* rec_b = rec + static_cast<long long>(b) * f_stride * m;
  const float* kx_t = kx + static_cast<long long>(tile) * P;
  const float* ky_t = ky + static_cast<long long>(tile) * P;
  const float* carry_t = carry + static_cast<long long>(tile) * 8 * P;
  float* out_t = out + static_cast<long long>(tile) * 8 * P;

  if (n_chunks > 0) {
    composite_walk::stage_chunk<THREADS>(s_rec, rec_b, 0, m, vec);
  }
  const int tw = composite_walk::walk_tile_width<P, THREADS>(ky_t, &s_first);
  float px[PPT], py[PPT], trans[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = composite_walk::walk_pixel<PPT, THREADS>(threadIdx.x, j, tw);
    px[j] = kx_t[p];
    py[j] = ky_t[p];
#pragma unroll
    for (int f = 0; f < 4; ++f) s_acc[f * P + p] = carry_t[f * P + p];
    trans[j] = carry_t[4 * P + p];
  }
  const composite_walk::Patch patch =
      composite_walk::warp_patch<PPT>(px, py);

  for (int c = 0;; ++c) {
    int open = 0;
#pragma unroll
    for (int j = 0; j < PPT; ++j) open |= trans[j] > 1e-6f;
    // Block-uniform exit test (every thread reaches the barrier).
    if (!__syncthreads_or(open) || c >= n_chunks) break;
    // Chunk c has landed; every thread is past chunk c - 1, whose buffer
    // takes chunk c + 1.
    const float* sr_c = s_rec + (c & 1) * kFields * kChunk;
    composite_walk::cp_async_wait_all();
    __syncthreads();
    if (c + 1 < n_chunks) {
      composite_walk::stage_chunk<THREADS>(
          s_rec + ((c + 1) & 1) * kFields * kChunk, rec_b, c + 1, m, vec);
    }
    composite_walk::chunk_boxes(sr_c, s_box);
    __syncthreads();
    unsigned hits[kHitWords];
    composite_walk::warp_hits(s_box, patch, min(kChunk, n - c * kChunk),
                              hits);

    float cp[PPT], sr[PPT], sg[PPT], sb[PPT], sa[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      cp[j] = 1.0f;
      sr[j] = sg[j] = sb[j] = sa[j] = 0.0f;
    }
    int base = 0, k;
    while (composite_walk::next_hit(hits, base, k)) {
      const float sx = sr_c[0 * kChunk + k], sy = sr_c[1 * kChunk + k];
      const float v0x = sr_c[2 * kChunk + k], v0y = sr_c[3 * kChunk + k];
      const float il0 = sr_c[4 * kChunk + k], il1 = sr_c[5 * kChunk + k];
      const float cr = sr_c[6 * kChunk + k], cg = sr_c[7 * kChunk + k];
      const float cb = sr_c[8 * kChunk + k], a_eff = sr_c[9 * kChunk + k];
      // Every pixel takes the same operations, a pixel outside the cover
      // keeps its sums by a select: the pixels' chains interleave.
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const float dx = px[j] - sx;
        const float dy = py[j] - sy;
        const float n0 = (v0x * dx + v0y * dy) * il0;
        const float n1 = (v0y * dx - v0x * dy) * il1;
        const float q = 64.0f * (n0 * n0 + n1 * n1);
        const float wq = expf(-0.5f * q);
        const bool cover = fabsf(n0) <= 0.5f && fabsf(n1) <= 0.5f
            && wq >= 1e-4f;
        const float alpha = fminf(a_eff * wq, alpha_max);
        const float wgt = alpha * (trans[j] * cp[j]);
        sr[j] = cover ? sr[j] + wgt * cr : sr[j];
        sg[j] = cover ? sg[j] + wgt * cg : sg[j];
        sb[j] = cover ? sb[j] + wgt * cb : sb[j];
        sa[j] = cover ? sa[j] + alpha * wgt : sa[j];
        cp[j] = cover ? cp[j] * (1.0f - alpha) : cp[j];
      }
    }
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = composite_walk::walk_pixel<PPT, THREADS>(threadIdx.x, j, tw);
      s_acc[0 * P + p] += sr[j];
      s_acc[1 * P + p] += sg[j];
      s_acc[2 * P + p] += sb[j];
      s_acc[3 * P + p] += sa[j];
      trans[j] = trans[j] * cp[j];
    }
  }
  composite_walk::cp_async_wait_all();   // a chunk staged past the exit

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = composite_walk::walk_pixel<PPT, THREADS>(threadIdx.x, j, tw);
#pragma unroll
    for (int f = 0; f < 4; ++f) out_t[f * P + p] = s_acc[f * P + p];
    out_t[4 * P + p] = trans[j];
    out_t[5 * P + p] = 0.0f;
    out_t[6 * P + p] = 0.0f;
    out_t[7 * P + p] = 0.0f;
  }
}

template <int P>
int launch(const float* rec, const int* counts, const int* sel,
           const long long* order, const float* kx, const float* ky,
           const float* carry, float* out, int n_blocks, int f_stride, int m,
           bool vec, cudaStream_t stream) {
  constexpr int kSmem = (2 * kFields * kChunk + 4 * kChunk + 4 * P)
      * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      composite_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_kernel<P><<<n_blocks, Shape<P>::kThreads, kSmem, stream>>>(
      rec, counts, sel, order, kx, ky, carry, out, f_stride, m, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rec: (n_blocks, f_stride, m) f32, f_stride >= 10, m a multiple of 128;
// counts, sel: (n_blocks,) i32 (sel may be null: item i is tile i); order:
// (n_blocks,) i64, a permutation of 0 .. n_blocks - 1 (may be null);
// kx, ky: (T, p) f32; carry, out: (T, 8, p) f32, may alias. p is one of
// 256, 512, 1024, 2048, 4096.
extern "C" int fourdgs_composite(const void* rec, const void* counts,
                                 const void* sel, const void* order,
                                 const void* kx, const void* ky,
                                 const void* carry, void* out, int n_blocks,
                                 int f_stride, int m, int p, void* stream) {
  if (n_blocks < 0 || f_stride < kFields || m % kChunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks == 0) return 0;
  const auto* r = static_cast<const float*>(rec);
  const auto* cn = static_cast<const int*>(counts);
  const auto* sl = static_cast<const int*>(sel);
  const auto* od = static_cast<const long long*>(order);
  const auto* x = static_cast<const float*>(kx);
  const auto* y = static_cast<const float*>(ky);
  const auto* ci = static_cast<const float*>(carry);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // Rows start at multiples of m floats: 16-byte copies need the base
  // aligned.
  const bool vec = (reinterpret_cast<std::uintptr_t>(rec) & 15u) == 0;
  switch (p) {
    case 256: return launch<256>(r, cn, sl, od, x, y, ci, o, n_blocks, f_stride, m, vec, st);
    case 512: return launch<512>(r, cn, sl, od, x, y, ci, o, n_blocks, f_stride, m, vec, st);
    case 1024: return launch<1024>(r, cn, sl, od, x, y, ci, o, n_blocks, f_stride, m, vec, st);
    case 2048: return launch<2048>(r, cn, sl, od, x, y, ci, o, n_blocks, f_stride, m, vec, st);
    case 4096: return launch<4096>(r, cn, sl, od, x, y, ci, o, n_blocks, f_stride, m, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
