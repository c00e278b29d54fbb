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
// With `sel` (Tb,) i32, block b reads kx, ky and g at tile sel[b] and the
// residuals carry, fout at b (they are gathered for the selected tiles only).
//
// Per pixel, with records front to back (C = sum alpha c T, A = sum alpha^2
// T, T_i = T_chunk_start * prod_{j<i, same chunk}(1 - alpha_j)):
//   d alpha_i = (g_C . c_i) T_i + g_A 2 alpha_i T_i - num_i / (1 - alpha_i),
//   num_i = g_C . (C_tot - C_incl_i) + g_A (A_tot - A_incl_i) + g_T T_fin,
// the suffix sums taken as the saved totals minus the inclusive prefix
// (started at the carry), as the reference does. Here the prefix is kept
// already contracted with g: rem = num_i is one running float per pixel,
// started at g . (fout - carry) + g_T T_fin and lowered by each record's
// contribution. d alpha is gated by cover & (a_eff w < 1 - 1e-6) (the
// alpha clamp), then chained through w = exp(-32 (n0^2 + n1^2)) to the
// record fields, exactly the reference's expressions.
//
// The early exit must fall on the same chunk as the forward's (K1), so the
// transmittance is recomputed with K1's sequential product in K1's order:
// per pixel, cp = cp * (1 - alpha) over the covered records of a chunk,
// restarted at 1 per chunk, T = T * cp at the chunk's end; the file is built
// with -fmad=false, as K1 is, so cover, alpha and T round as the forward's.
//
// Bound on the H100: like K1, the arithmetic of every (record, pixel) pair
// (the quad test for all, ~40 more flops for the covered ones), plus the
// reduction: each record's 10 cotangents are sums over the tile's P pixels.
// Design: 256 threads own P / 256 pixels each, as in K1, and walk a chunk
// record by record (record outer, pixel inner), so a thread first sums its
// own pixels in registers; each warp then reduces the 10 sums with shuffles
// (skipped when no lane of the warp covers the record) and writes one
// partial per (warp, field, record) to shared memory; at the chunk's end
// the 8 warp partials of each (field, record) are added and written once.
// No global atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;
constexpr int kFields = 10;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const float* __restrict__ rec,
                     const int* __restrict__ counts,
                     const int* __restrict__ sel, const float* __restrict__ kx,
                     const float* __restrict__ ky,
                     const float* __restrict__ carry,
                     const float* __restrict__ fout,
                     const float* __restrict__ g, float* __restrict__ drec,
                     int f_stride, int m) {
  constexpr int P = PPT * kThreads;
  __shared__ float s_rec[kFields][kChunk];
  __shared__ float s_part[kWarps][kFields][kChunk];
  const int b = blockIdx.x;
  const int tile = sel != nullptr ? sel[b] : b;
  const int n = counts[b];
  int n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > m / kChunk) n_chunks = m / kChunk;
  const float alpha_max = static_cast<float>(1.0 - 1e-6);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* rec_b = rec + static_cast<long long>(b) * f_stride * m;
  float* drec_b = drec + static_cast<long long>(b) * f_stride * m;
  const float* carry_b = carry + static_cast<long long>(b) * 8 * P;
  const float* fout_b = fout + static_cast<long long>(b) * 8 * P;
  const float* g_t = g + static_cast<long long>(tile) * 8 * P;

  float px[PPT], py[PPT], gr[PPT], gg[PPT], gb[PPT], ga[PPT], rem[PPT],
      trans[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = threadIdx.x + j * kThreads;
    px[j] = kx[static_cast<long long>(tile) * P + p];
    py[j] = ky[static_cast<long long>(tile) * P + p];
    gr[j] = g_t[0 * P + p];
    gg[j] = g_t[1 * P + p];
    gb[j] = g_t[2 * P + p];
    ga[j] = g_t[3 * P + p];
    rem[j] = gr[j] * (fout_b[0 * P + p] - carry_b[0 * P + p])
        + gg[j] * (fout_b[1 * P + p] - carry_b[1 * P + p])
        + gb[j] * (fout_b[2 * P + p] - carry_b[2 * P + p])
        + ga[j] * (fout_b[3 * P + p] - carry_b[3 * P + p])
        + g_t[4 * P + p] * fout_b[4 * P + p];
    trans[j] = carry_b[4 * P + p];
  }

  for (int c = 0;; ++c) {
    int open = 0;
#pragma unroll
    for (int j = 0; j < PPT; ++j) open |= trans[j] > 1e-6f;
    // Block-uniform exit test, the forward's (every thread reaches it).
    if (!__syncthreads_or(open) || c >= n_chunks) break;

    for (int i = threadIdx.x; i < kFields * kChunk; i += kThreads) {
      const int f = i / kChunk;
      const int k = i - f * kChunk;
      s_rec[f][k] = rec_b[static_cast<long long>(f) * m + c * kChunk + k];
    }
    __syncthreads();

    float cp[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) cp[j] = 1.0f;

    for (int k = 0; k < kChunk; ++k) {
      const float sx = s_rec[0][k], sy = s_rec[1][k];
      const float v0x = s_rec[2][k], v0y = s_rec[3][k];
      const float il0 = s_rec[4][k], il1 = s_rec[5][k];
      const float cr = s_rec[6][k], cg = s_rec[7][k], cb = s_rec[8][k];
      const float a_eff = s_rec[9][k];
      float d[kFields];
#pragma unroll
      for (int f = 0; f < kFields; ++f) d[f] = 0.0f;
      int any = 0;
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
        const float w = expf(-0.5f * q);
        if (!(w >= 1e-4f)) continue;
        any = 1;
        const float aw = a_eff * w;
        const float alpha = fminf(aw, alpha_max);
        const float t_i = trans[j] * cp[j];
        const float wgt = alpha * t_i;
        const float gc = gr[j] * cr + gg[j] * cg + gb[j] * cb;
        rem[j] = rem[j] - (wgt * gc + ga[j] * (alpha * wgt));
        const float one_m = 1.0f - alpha;
        d[6] += gr[j] * wgt;
        d[7] += gg[j] * wgt;
        d[8] += gb[j] * wgt;
        if (aw < alpha_max) {
          const float d_alpha = gc * t_i + ga[j] * 2.0f * alpha * t_i
              - rem[j] / one_m;
          d[9] += d_alpha * w;
          const float d_q = d_alpha * a_eff * w * (-0.5f);
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
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int f = 0; f < kFields; ++f) {
          float v = d[f];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v += __shfl_down_sync(0xffffffffu, v, off);
          }
          d[f] = v;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kFields; ++f) s_part[warp][f][k] = d[f];
      }
    }
#pragma unroll
    for (int j = 0; j < PPT; ++j) trans[j] = trans[j] * cp[j];
    __syncthreads();

    for (int i = threadIdx.x; i < kFields * kChunk; i += kThreads) {
      const int f = i / kChunk;
      const int k = i - f * kChunk;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += s_part[w][f][k];
      drec_b[static_cast<long long>(f) * m + c * kChunk + k] = v;
    }
    __syncthreads();   // the next chunk overwrites s_rec and s_part
  }
}

template <int PPT>
int launch(const float* rec, const int* counts, const int* sel,
           const float* kx, const float* ky, const float* carry,
           const float* fout, const float* g, float* drec, int n_blocks,
           int f_stride, int m, cudaStream_t stream) {
  composite_bwd_kernel<PPT><<<n_blocks, kThreads, 0, stream>>>(
      rec, counts, sel, kx, ky, carry, fout, g, drec, f_stride, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rec, drec: (n_blocks, f_stride, m) f32, f_stride >= 10, m a multiple of
// 128, drec zeroed by the caller (chunks past the early exit stay 0);
// counts, sel: (n_blocks,) i32 (sel may be null: block b is tile b);
// kx, ky: (T, p) f32; g: (T, 8, p) f32; carry, fout: (n_blocks, 8, p) f32.
// p is one of 256, 512, 1024, 2048, 4096.
extern "C" int fourdgs_composite_bwd(const void* rec, const void* counts,
                                     const void* sel, const void* kx,
                                     const void* ky, const void* carry,
                                     const void* fout, const void* g,
                                     void* drec, int n_blocks, int f_stride,
                                     int m, int p, void* stream) {
  if (n_blocks < 0 || f_stride < kFields || m % kChunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks == 0) return 0;
  const auto* r = static_cast<const float*>(rec);
  const auto* cn = static_cast<const int*>(counts);
  const auto* sl = static_cast<const int*>(sel);
  const auto* x = static_cast<const float*>(kx);
  const auto* y = static_cast<const float*>(ky);
  const auto* ci = static_cast<const float*>(carry);
  const auto* fo = static_cast<const float*>(fout);
  const auto* gi = static_cast<const float*>(g);
  auto* o = static_cast<float*>(drec);
  auto st = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 256: return launch<1>(r, cn, sl, x, y, ci, fo, gi, o, n_blocks, f_stride, m, st);
    case 512: return launch<2>(r, cn, sl, x, y, ci, fo, gi, o, n_blocks, f_stride, m, st);
    case 1024: return launch<4>(r, cn, sl, x, y, ci, fo, gi, o, n_blocks, f_stride, m, st);
    case 2048: return launch<8>(r, cn, sl, x, y, ci, fo, gi, o, n_blocks, f_stride, m, st);
    case 4096: return launch<16>(r, cn, sl, x, y, ci, fo, gi, o, n_blocks, f_stride, m, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
