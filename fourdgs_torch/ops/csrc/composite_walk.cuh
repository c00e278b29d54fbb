// The record walk shared by the composite (K1, composite.cu) and its
// backward (K8, composite_bwd.cu). Both kernels take a tile the same way:
//
//   * the tile's P pixels are dealt to the block's threads by `walk_pixel`:
//     where the tile is row-major with a width of 32 to 32 x warps pixels
//     (found from ky by `walk_tile_width`), a warp owns 32 adjacent columns
//     of PPT adjacent rows; otherwise thread t owns pixels t + THREADS j;
//   * each warp keeps the axis-aligned box of its own pixels (`Patch`);
//   * a chunk of 128 records (10 field rows) is staged in shared memory with
//     16-byte cp.async copies into a two-stage ring, the next chunk's rows
//     arriving while this one is walked (`stage_chunk`);
//   * each staged record gets its cull box once (`record_box`), the
//     axis-aligned box, inflated, of the region |n0| <= 0.5, |n1| <= 0.5;
//   * each warp lists, with four ballots, the records whose box meets its
//     patch (`warp_hits`), and walks only those, record outside and pixels
//     inside.
// The per-pixel test of the kernels rejects every (record, pixel) pair whose
// pixel lies outside the record's box, so a warp that skips a record changes
// no bit of its pixels. The per-pixel arithmetic and its order stay the
// kernels' own; the files are built with -fmad=false.
//
// The plain PyTorch model of this walk is in ops/composite_cuda.py
// (`composite_cull_boxes`, `walk_tile_width`, `walk_pixel_map`,
// `composite_walk_keep`); tests/test_torch_composite_walk.py holds the box
// against the coverage test.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cfloat>

namespace composite_walk {

constexpr int kChunk = 128;
constexpr int kFields = 10;
constexpr int kHitWords = kChunk / 32;
// The box's margins: relative to its half-widths' sum (the per-pixel test's
// rounding moves its edge by a few float32 ulps of that), and absolute, in
// k units, per unit of the centre's magnitude (the rounding of px - sx and
// of the box's own edges).
constexpr float kBoxRel = 1e-3f;
constexpr float kBoxAbs = 1e-6f;

// The block shape of a kernel at P pixels a tile: at most kMaxPpt pixels a
// thread (256 threads at least, 1,024 at most), and as many resident blocks
// an SM as registers allow at kRegs a thread (the launch bound's cap).
template <int P, int kMaxPpt, int kRegs>
struct Shape {
  static constexpr int kThreads = P / kMaxPpt < 256 ? 256 : P / kMaxPpt;
  static constexpr int kPpt = P / kThreads;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kMinBlocks =
      65536 / (kThreads * kRegs) < 1 ? 1 : 65536 / (kThreads * kRegs);
  static_assert(kPpt * kThreads == P && kPpt >= 1 && kThreads <= 1024,
                "tile size");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The cull box (x_lo, x_hi, y_lo, y_hi) of one record. With s = |v0|^2 and
// h_i = 0.5 / |il_i|, the region |n0| <= 0.5, |n1| <= 0.5 lies in
// |dx| <= (|v0x| h0 + |v0y| h1) / s, |dy| <= (|v0y| h0 + |v0x| h1) / s. It is
// unbounded (no cull: an infinite box) where il0 or il1 is 0, s is 0 or not
// a normal float, or a field is NaN. A NaN centre gives NaN edges, which
// meet every patch. The w >= 1e-4 disc is left out: the box stays larger.
__device__ __forceinline__ float4 record_box(float sx, float sy, float v0x,
                                             float v0y, float il0,
                                             float il1) {
  const float a0 = fabsf(il0), a1 = fabsf(il1);
  const float s = v0x * v0x + v0y * v0y;
  if (!(a0 > 0.0f && a1 > 0.0f && s >= FLT_MIN && s <= FLT_MAX)) {
    return make_float4(-CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F,
                       CUDART_INF_F);
  }
  const float ax = fabsf(v0x), ay = fabsf(v0y);
  const float h0 = 0.5f / a0, h1 = 0.5f / a1;
  const float hx = (ax * h0 + ay * h1) / s;
  const float hy = (ay * h0 + ax * h1) / s;
  const float rel = kBoxRel * (hx + hy);
  const float mx = hx + rel + kBoxAbs * (1.0f + fabsf(sx));
  const float my = hy + rel + kBoxAbs * (1.0f + fabsf(sy));
  return make_float4(sx - mx, sx + mx, sy - my, sy + my);
}

// The box of a warp's pixels.
struct Patch {
  float x_lo, x_hi, y_lo, y_hi;
};

// Whether a record's box misses the patch (NaN edges never miss).
__device__ __forceinline__ bool box_misses(const float4& b, const Patch& q) {
  return b.x > q.x_hi || b.y < q.x_lo || b.z > q.y_hi || b.w < q.y_lo;
}

template <int PPT>
__device__ __forceinline__ Patch warp_patch(const float* px,
                                            const float* py) {
  Patch q{px[0], px[0], py[0], py[0]};
#pragma unroll
  for (int j = 1; j < PPT; ++j) {
    q.x_lo = fminf(q.x_lo, px[j]);
    q.x_hi = fmaxf(q.x_hi, px[j]);
    q.y_lo = fminf(q.y_lo, py[j]);
    q.y_hi = fmaxf(q.y_hi, py[j]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    q.x_lo = fminf(q.x_lo, __shfl_xor_sync(0xffffffffu, q.x_lo, o));
    q.x_hi = fmaxf(q.x_hi, __shfl_xor_sync(0xffffffffu, q.x_hi, o));
    q.y_lo = fminf(q.y_lo, __shfl_xor_sync(0xffffffffu, q.y_lo, o));
    q.y_hi = fmaxf(q.y_hi, __shfl_xor_sync(0xffffffffu, q.y_hi, o));
  }
  return q;
}

// The tile's row width for the compact pixel map, or 0 for the strided map:
// the first pixel whose ky differs from pixel 0's, if that is 32 x a divisor
// of the warps (a power of two from 32 to THREADS). Every thread of the block
// calls it (two barriers); `s_first` is one shared int.
template <int P, int THREADS>
__device__ __forceinline__ int walk_tile_width(const float* ky_t,
                                               int* s_first) {
  if (threadIdx.x == 0) *s_first = P;
  __syncthreads();
  const int p = threadIdx.x + 1;
  if (p < P && ky_t[p] != ky_t[0]) atomicMin(s_first, p);
  __syncthreads();
  const int tw = *s_first;
  const int strips = tw >> 5;
  const bool ok = (tw & 31) == 0 && strips >= 1
      && (THREADS / 32) % strips == 0 && P % tw == 0;
  return ok ? tw : 0;
}

// Pixel of slot j of thread t. Compact map (tw > 0): warp w owns columns
// 32 (w % strips) .. + 31 of rows (w / strips) PPT .. + PPT - 1, lane l the
// column 32 (w % strips) + l; both maps are permutations of 0 .. P - 1.
template <int PPT, int THREADS>
__device__ __forceinline__ int walk_pixel(int t, int j, int tw) {
  if (tw > 0) {
    const int strips = tw >> 5;
    const int w = t >> 5;
    return ((w / strips) * PPT + j) * tw + ((w % strips) << 5) + (t & 31);
  }
  return t + j * THREADS;
}

// Start the copies of chunk c's 10 field rows (128 entries each) into `dst`
// ([kFields][kChunk]) and commit them as one group. `vec`: the rows are
// 16-byte aligned (else plain loads, complete on return).
template <int THREADS>
__device__ __forceinline__ void stage_chunk(float* dst, const float* rec_b,
                                            int c, int m, bool vec) {
  const float* src = rec_b + c * kChunk;
  if (vec) {
    constexpr int kQ = kChunk / 4;
    for (int e = threadIdx.x; e < kFields * kQ; e += THREADS) {
      const int f = e / kQ;
      const int k = (e - f * kQ) << 2;
      cp_async16(dst + f * kChunk + k,
                 src + static_cast<long long>(f) * m + k);
    }
  } else {
    for (int e = threadIdx.x; e < kFields * kChunk; e += THREADS) {
      const int f = e / kChunk;
      const int k = e - f * kChunk;
      dst[f * kChunk + k] = src[static_cast<long long>(f) * m + k];
    }
  }
  cp_async_commit();
}

// The boxes of a staged chunk, one record a thread (threads 0 .. 127).
__device__ __forceinline__ void chunk_boxes(const float* s_rec,
                                            float4* s_box) {
  const int k = threadIdx.x;
  if (k < kChunk) {
    s_box[k] = record_box(s_rec[0 * kChunk + k], s_rec[1 * kChunk + k],
                          s_rec[2 * kChunk + k], s_rec[3 * kChunk + k],
                          s_rec[4 * kChunk + k], s_rec[5 * kChunk + k]);
  }
}

// The records k < k_end of the chunk whose box meets the warp's patch, as
// four 32-bit masks (bit l of word q: record 32 q + l). Warp-uniform.
__device__ __forceinline__ void warp_hits(const float4* s_box,
                                          const Patch& q, int k_end,
                                          unsigned* hits) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w < kHitWords; ++w) {
    const int k = w * 32 + lane;
    const bool hit = k < k_end && !box_misses(s_box[k], q);
    hits[w] = __ballot_sync(0xffffffffu, hit);
  }
}

// The next record of a warp's list, in order: pops the lowest set bit of
// hits[0] into k, moving to the next word when one is empty; false when the
// list is spent. `base` starts at 0. Constant indices only, so the words
// stay in registers.
__device__ __forceinline__ bool next_hit(unsigned* hits, int& base, int& k) {
  while (hits[0] == 0u) {
    if (base == kChunk - 32) return false;
#pragma unroll
    for (int w = 0; w + 1 < kHitWords; ++w) hits[w] = hits[w + 1];
    hits[kHitWords - 1] = 0u;
    base += 32;
  }
  k = base + __ffs(hits[0]) - 1;
  hits[0] &= hits[0] - 1u;
  return true;
}

}  // namespace composite_walk
