// Backward of the per-tile ordered composite: kernel K8 of the port.
//
// Replaces fourdgs/ops/composite_pallas.py `_composite_bwd_kernel` (:363),
// reached through `_composite_bwd_pallas` (:486-531) from both custom VJPs,
// `_composite_bwd` (pass 1) and `_composite_at_bwd` (the deepening pass).
// One thread block takes one tile of P pixels:
//
//   records (Tb, F, M) f32, rows sx, sy, v0x, v0y, il0, il1, r, g, b, a_eff
//   counts (Tb,) i32; kx, ky (T, P); g (T, 8, P) upstream cotangent;
//   carry, fout (Tb, 8, P): the forward's input carry and saved output;
//   drec (Tb, F, M) out: d of the 10 field rows (rows 10-15 untouched).
//
// With `sel` (Tb,) i32, item i reads kx, ky and g at tile sel[i] and the
// residuals carry, fout at i (they are gathered for the selected tiles only).
// Block b takes item order[b] (`order` (Tb,) i64, a permutation: the items
// by descending count, deepest first, as K1 takes them), or item b without
// it; the result does not depend on the order.
//
// Per pixel, with records front to back (C = sum alpha c T, A = sum alpha^2
// T, T_i = T_chunk_start * prod_{j<i, same chunk}(1 - alpha_j)):
//   d alpha_i = (g_C . c_i) T_i + g_A 2 alpha_i T_i - num_i / (1 - alpha_i),
//   num_i = g_C . (C_tot - C_incl_i) + g_A (A_tot - A_incl_i) + g_T T_fin,
// the suffix sums taken as the saved totals minus the inclusive prefix
// (started at the carry), as the reference does. Here the suffix is kept
// contracted with g: rem = num_i is one running float per pixel, lowered by
// each record's contribution within a chunk and set anew at each chunk's
// start to g . (fout - pref) + g_T T_fin, where pref (rows r, g, b, a, in
// shared memory) is the forward's accumulator rebuilt as K1 builds it: the
// carry, plus each chunk's sums taken in K1's order and added at the
// chunk's end. fout holds K1's rounding of those sums, so the suffix that
// fout - pref leaves is the forward's own; a remainder run down from
// g . (fout - carry) over the whole tile instead drifts from it by the
// forward's rounding, which 1 / (1 - alpha) (up to 1e6) magnifies at the
// records of a deep tile, where alpha is near 1 and the true suffix near
// 0. d alpha is gated by cover & (a_eff w < 1 - 1e-6) (the alpha clamp),
// then chained through w = exp(-32 (n0^2 + n1^2)) to the record fields,
// exactly the reference's expressions.
//
// The early exit must fall on the same chunk as the forward's (K1), so the
// transmittance is recomputed with K1's sequential product in K1's order:
// per pixel, cp = cp * (1 - alpha) over the covered records of a chunk,
// restarted at 1 per chunk, T = T * cp at the chunk's end; the file is built
// with -fmad=false, as K1 is, so cover, alpha and T round as the forward's.
// Every record of a chunk that runs gets its cotangents, the padding past
// the count too (the reference writes them; the pack's VJP drops them).
//
// Bound on the H100: like K1, not the card's rates but the latency of each
// warp's walk through a deep tile's records, here with ~40 more operations
// and a division for each covered pair, and the reduction: each record's 10
// cotangents are sums over the tile's P pixels, so each record ends in a
// warp-wide vote and reduction at which the warp's lanes meet, and the lane
// with the most covered pixels sets the pace (trial builds without that
// meeting point, which are not correct kernels, ran far faster; PERF.md).
// Design: the record walk of composite_walk.cuh, shared with K1: records
// outside, pixels inside; a warp owns 32 columns x 8 rows and skips, by a
// warp-uniform ballot list, each record whose cull box misses them (it
// contributes exact zeros there and issues no shuffle); the covered path
// stays a branch (computing it for every pixel, as K1 does, was
// slower); the cotangent rows and the rebuilt prefix of the tile stay in
// shared memory, out of the registers. A thread sums its own pixels in
// registers; a warp with a covered pixel then reduces the 10 sums
// by a reduce-scatter of xor shuffles (12 shuffles, each field's sum ending
// in two lanes; a tree of 50 did it before), added in the same pairs as a
// shfl_down tree. Each warp writes one partial per (field, record) to shared
// memory; at the chunk's end the warps' partials of each (field, record) are
// added in warp order and written once. No global atomics: the result
// repeats bit for bit from launch to launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "composite_walk.cuh"

namespace {

using composite_walk::kChunk;
using composite_walk::kFields;
using composite_walk::kHitWords;
// At most 8 pixels a thread, at <= 128 registers, except at P = 2048: there
// the shared memory (116 KB with the prefix rows) admits one block of 256
// threads an SM, which may then take the registers of two. (At P = 4096,
// 512 threads of 8 pixels, 128 is the most a thread can have.)
template <int P>
using Shape = composite_walk::Shape<P, 8, P == 2048 ? 255 : 128>;
constexpr unsigned kFull = 0xffffffffu;

// The warp's sums of the ten per-lane values d[0..9], scattered: returns
// the sum of field *field (valid when *field >= 0), held by two adjacent
// lanes. Halving steps over lane bits 4, 3, 2, 1 each keep half the fields
// (padded with zeros), then bit 0 completes the sum.
__device__ __forceinline__ float warp_sum_scatter(const float* d, int lane,
                                                  int* field) {
  const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4, u2 = lane & 2;
  float a[6];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float keep = u16 ? d[i + 5] : d[i];
    const float send = u16 ? d[i] : d[i + 5];
    a[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  a[5] = 0.0f;
  float b[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float hi = a[i + 3];
    b[i] = (u8 ? hi : a[i]) + __shfl_xor_sync(kFull, u8 ? a[i] : hi, 8);
  }
  b[3] = 0.0f;
  float c[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float hi = b[i + 2];
    c[i] = (u4 ? hi : b[i]) + __shfl_xor_sync(kFull, u4 ? b[i] : hi, 4);
  }
  float e = (u2 ? c[1] : c[0]) + __shfl_xor_sync(kFull, u2 ? c[0] : c[1], 2);
  e += __shfl_xor_sync(kFull, e, 1);
  const int bi = (u4 ? 2 : 0) + (u2 ? 1 : 0);
  const int ai = (u8 ? 3 : 0) + bi;
  *field = bi < 3 && ai < 5 ? (u16 ? 5 : 0) + ai : -1;
  return e;
}

template <int P>
__global__ void __launch_bounds__(Shape<P>::kThreads, Shape<P>::kMinBlocks)
composite_bwd_kernel(const float* __restrict__ rec,
                     const int* __restrict__ counts,
                     const int* __restrict__ sel,
                     const long long* __restrict__ order,
                     const float* __restrict__ kx,
                     const float* __restrict__ ky,
                     const float* __restrict__ carry,
                     const float* __restrict__ fout,
                     const float* __restrict__ g, float* __restrict__ drec,
                     int f_stride, int m, bool vec) {
  constexpr int THREADS = Shape<P>::kThreads;
  constexpr int PPT = Shape<P>::kPpt;
  constexpr int WARPS = Shape<P>::kWarps;
  // Dynamic shared memory: the staged chunks [2][kFields][kChunk], the
  // boxes [kChunk], the warps' partials [WARPS][kFields][kChunk], the
  // cotangent rows r, g, b, a of the tile [4][P] (read by covered pixels
  // only, so they stay out of the registers), and the forward's prefix
  // rows r, g, b, a [4][P] (each pixel's read and written by its thread).
  extern __shared__ __align__(16) float smem[];
  float* s_rec = smem;
  float4* s_box = reinterpret_cast<float4*>(smem + 2 * kFields * kChunk);
  float* s_part = reinterpret_cast<float*>(s_box + kChunk);
  float* s_g = s_part + WARPS * kFields * kChunk;
  float* s_pref = s_g + 4 * P;
  __shared__ int s_first;
  const int b = order != nullptr ? static_cast<int>(order[blockIdx.x])
                                 : static_cast<int>(blockIdx.x);
  const int tile = sel != nullptr ? sel[b] : b;
  const int n = counts[b];
  int n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > m / kChunk) n_chunks = m / kChunk;
  const float alpha_max = static_cast<float>(1.0 - 1e-6);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* part_w = s_part + warp * kFields * kChunk;

  const float* rec_b = rec + static_cast<long long>(b) * f_stride * m;
  float* drec_b = drec + static_cast<long long>(b) * f_stride * m;
  const float* carry_b = carry + static_cast<long long>(b) * 8 * P;
  const float* fout_b = fout + static_cast<long long>(b) * 8 * P;
  const float* g_t = g + static_cast<long long>(tile) * 8 * P;
  const float* kx_t = kx + static_cast<long long>(tile) * P;
  const float* ky_t = ky + static_cast<long long>(tile) * P;

  if (n_chunks > 0) {
    composite_walk::stage_chunk<THREADS>(s_rec, rec_b, 0, m, vec);
  }
  const int tw = composite_walk::walk_tile_width<P, THREADS>(ky_t, &s_first);
  // Pixel j of this thread is p0 + j * pstep (both maps).
  const int p0 = composite_walk::walk_pixel<PPT, THREADS>(threadIdx.x, 0, tw);
  const int pstep = tw > 0 ? tw : THREADS;
  float px[PPT], py[PPT], rem[PPT], trans[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = p0 + j * pstep;
    px[j] = kx_t[p];
    py[j] = ky_t[p];
    const float gr = g_t[0 * P + p], gg = g_t[1 * P + p];
    const float gb = g_t[2 * P + p], ga = g_t[3 * P + p];
    s_g[0 * P + p] = gr;
    s_g[1 * P + p] = gg;
    s_g[2 * P + p] = gb;
    s_g[3 * P + p] = ga;
#pragma unroll
    for (int f = 0; f < 4; ++f) s_pref[f * P + p] = carry_b[f * P + p];
    trans[j] = carry_b[4 * P + p];
  }
  const composite_walk::Patch patch =
      composite_walk::warp_patch<PPT>(px, py);

  for (int c = 0;; ++c) {
    int open = 0;
#pragma unroll
    for (int j = 0; j < PPT; ++j) open |= trans[j] > 1e-6f;
    // Block-uniform exit test, the forward's (every thread reaches it).
    if (!__syncthreads_or(open) || c >= n_chunks) break;
    const float* sr_c = s_rec + (c & 1) * kFields * kChunk;
    composite_walk::cp_async_wait_all();
    __syncthreads();
    if (c + 1 < n_chunks) {
      composite_walk::stage_chunk<THREADS>(
          s_rec + ((c + 1) & 1) * kFields * kChunk, rec_b, c + 1, m, vec);
    }
    composite_walk::chunk_boxes(sr_c, s_box);
    // The suffix at the chunk's start, from the forward's totals and its
    // prefix so far (both K1's roundings).
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = p0 + j * pstep;
      rem[j] = s_g[0 * P + p] * (fout_b[0 * P + p] - s_pref[0 * P + p])
          + s_g[1 * P + p] * (fout_b[1 * P + p] - s_pref[1 * P + p])
          + s_g[2 * P + p] * (fout_b[2 * P + p] - s_pref[2 * P + p])
          + s_g[3 * P + p] * (fout_b[3 * P + p] - s_pref[3 * P + p])
          + g_t[4 * P + p] * fout_b[4 * P + p];
    }
    __syncthreads();
    unsigned hits[kHitWords];
    composite_walk::warp_hits(s_box, patch, kChunk, hits);
    // A record the warp skips contributes exact zeros.
#pragma unroll
    for (int w = 0; w < kHitWords; ++w) {
      if (!((hits[w] >> lane) & 1u)) {
#pragma unroll
        for (int f = 0; f < kFields; ++f) {
          part_w[f * kChunk + w * 32 + lane] = 0.0f;
        }
      }
    }

    // cp and the chunk's sums sr, sg, sb, sa as K1 takes them.
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
      float d[kFields];
#pragma unroll
      for (int f = 0; f < kFields; ++f) d[f] = 0.0f;
      bool any = false;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const float dx = px[j] - sx;
        const float dy = py[j] - sy;
        const float e0 = v0x * dx + v0y * dy;
        const float e1 = v0y * dx - v0x * dy;
        const float n0 = e0 * il0;
        const float n1 = e1 * il1;
        if (!(fabsf(n0) <= 0.5f && fabsf(n1) <= 0.5f)) continue;
        const float q = 64.0f * (n0 * n0 + n1 * n1);
        const float wq = expf(-0.5f * q);
        if (!(wq >= 1e-4f)) continue;
        any = true;
        const int p = p0 + j * pstep;
        const float gr = s_g[0 * P + p], gg = s_g[1 * P + p];
        const float gb = s_g[2 * P + p], ga = s_g[3 * P + p];
        const float aw = a_eff * wq;
        const float alpha = fminf(aw, alpha_max);
        const float t_i = trans[j] * cp[j];
        const float wgt = alpha * t_i;
        const float gc = gr * cr + gg * cg + gb * cb;
        rem[j] = rem[j] - (wgt * gc + ga * (alpha * wgt));
        sr[j] = sr[j] + wgt * cr;
        sg[j] = sg[j] + wgt * cg;
        sb[j] = sb[j] + wgt * cb;
        sa[j] = sa[j] + alpha * wgt;
        const float one_m = 1.0f - alpha;
        d[6] += gr * wgt;
        d[7] += gg * wgt;
        d[8] += gb * wgt;
        if (aw < alpha_max) {
          const float d_alpha = gc * t_i + ga * 2.0f * alpha * t_i
              - rem[j] / one_m;
          d[9] += d_alpha * wq;
          const float d_q = d_alpha * a_eff * wq * (-0.5f);
          const float dn0 = 128.0f * n0 * d_q;
          const float dn1 = 128.0f * n1 * d_q;
          d[0] += -dn0 * v0x * il0 - dn1 * v0y * il1;
          d[1] += -dn0 * v0y * il0 + dn1 * v0x * il1;
          d[2] += dn0 * dx * il0 - dn1 * dy * il1;
          d[3] += dn0 * dy * il0 + dn1 * dx * il1;
          d[4] += dn0 * e0;
          d[5] += dn1 * e1;
        }
        cp[j] = cp[j] * one_m;
      }
      if (__any_sync(kFull, any)) {
        int f;
        const float v = warp_sum_scatter(d, lane, &f);
        if (f >= 0 && !(lane & 1)) part_w[f * kChunk + k] = v;
      } else if (lane < kFields) {
        part_w[lane * kChunk + k] = 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = p0 + j * pstep;
      s_pref[0 * P + p] += sr[j];
      s_pref[1 * P + p] += sg[j];
      s_pref[2 * P + p] += sb[j];
      s_pref[3 * P + p] += sa[j];
      trans[j] = trans[j] * cp[j];
    }
    __syncthreads();

    for (int i = threadIdx.x; i < kFields * kChunk; i += THREADS) {
      const int f = i / kChunk;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += s_part[w * kFields * kChunk + i];
      drec_b[static_cast<long long>(f) * m + c * kChunk + (i - f * kChunk)] =
          v;
    }
    // The next chunk's walk rewrites s_part after the exit test's barrier.
  }
  composite_walk::cp_async_wait_all();   // a chunk staged past the exit
}

template <int P>
int launch(const float* rec, const int* counts, const int* sel,
           const long long* order, const float* kx, const float* ky,
           const float* carry, const float* fout, const float* g, float* drec,
           int n_blocks, int f_stride, int m, bool vec, cudaStream_t stream) {
  constexpr int kSmem = (2 * kFields * kChunk + 4 * kChunk
                         + Shape<P>::kWarps * kFields * kChunk + 8 * P)
      * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_bwd_kernel<P><<<n_blocks, Shape<P>::kThreads, kSmem, stream>>>(
      rec, counts, sel, order, kx, ky, carry, fout, g, drec, f_stride, m,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rec, drec: (n_blocks, f_stride, m) f32, f_stride >= 10, m a multiple of
// 128, drec zeroed by the caller (chunks past the early exit stay 0);
// counts, sel: (n_blocks,) i32 (sel may be null: item i is tile i); order:
// (n_blocks,) i64, a permutation of 0 .. n_blocks - 1 (may be null);
// kx, ky: (T, p) f32; g: (T, 8, p) f32; carry, fout: (n_blocks, 8, p) f32.
// p is one of 256, 512, 1024, 2048, 4096.
extern "C" int fourdgs_composite_bwd(const void* rec, const void* counts,
                                     const void* sel, const void* order,
                                     const void* kx, const void* ky,
                                     const void* carry, const void* fout,
                                     const void* g, void* drec, int n_blocks,
                                     int f_stride, int m, int p,
                                     void* stream) {
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
  const auto* fo = static_cast<const float*>(fout);
  const auto* gi = static_cast<const float*>(g);
  auto* o = static_cast<float*>(drec);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = (reinterpret_cast<std::uintptr_t>(rec) & 15u) == 0;
  switch (p) {
    case 256: return launch<256>(r, cn, sl, od, x, y, ci, fo, gi, o, n_blocks, f_stride, m, vec, st);
    case 512: return launch<512>(r, cn, sl, od, x, y, ci, fo, gi, o, n_blocks, f_stride, m, vec, st);
    case 1024: return launch<1024>(r, cn, sl, od, x, y, ci, fo, gi, o, n_blocks, f_stride, m, vec, st);
    case 2048: return launch<2048>(r, cn, sl, od, x, y, ci, fo, gi, o, n_blocks, f_stride, m, vec, st);
    case 4096: return launch<4096>(r, cn, sl, od, x, y, ci, fo, gi, o, n_blocks, f_stride, m, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
