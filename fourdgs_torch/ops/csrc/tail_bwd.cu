// Backward of the streaming banded-OIT tail accumulate: kernel K9 of the
// port.
//
// Replaces fourdgs/ops/tail_pallas.py `_tail_bwd_kernel` (:904), called
// through `_tail_bwd` (:1162-1223) from the custom VJP `_tail_core_bwd`,
// without the within-band weighting knobs (wd_ab, alpha_pow: not ported).
// It computes d_fields (10, Np) of K7's acc under the cotangent d_acc (the
// shape of acc).
//
// One thread block takes one chunk of `chunk` splats (grid step g), with
// the slot walk, live test, cut lookup and slot-mask skip of K7
// (csrc/tail.cu). K7's thread mapping is kept: consecutive threads take
// consecutive samples j of one pair i (item = i * n_samp + j), and a thread
// keeps its item across the budget slots. Per item it walks the slots s <
// span of its pair, and for each live (slot, sample) with coverage it
//   * reads the six plane cotangents d_acc[row, plane * n_samp + j], row =
//     band * nx * ny_pad + tx * ny_pad + ty (the transposed one-hot of the
//     reference: a gather, no scatter);
//   * chains them through alpha = min(gate w, 1 - 1e-6) (gated by the
//     clamp), w = exp(-(n0^2 + n1^2)), n = e il m sqrt(32), into ten sums
//     in registers: d gate, d sx, d sy, d(il0 m0), d(il1 m1) (before the
//     sqrt(32)), the direct d v0x and d v0y, and d r, g, b.
// A shuffle sum over the n_samp lanes of the pair then gives the pair's
// sums, and its first lane chains them through the widening (m = 1/sqrt(1 +
// c il^2), il_w = il m sqrt(32), gate = a_eff m0 m1) and writes the pair's
// 10 cotangents once. Every column of the chunk is written (0 for a pair
// with no live slot), so the caller needs no zeroing. No atomics.
//
// Every forward quantity is recomputed in K7's order of operations, and the
// file is built with -fmad=false, so coverage and alpha round as the
// forward's did.
//
// Bound on the H100: the per-sample arithmetic (one exp, one division and
// ~60 flops per live, covered sample) and the d_acc gather, ~2 MB at the
// 10M-splat 1920x1088 frame, which stays in L2. n_samp must be a power of
// two up to 32 (the pair's lanes are then an aligned part of one warp).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kCutEntries = 2048;
constexpr int kPlanes = 6;
constexpr int kMaskBits = 30;
constexpr int kDepthBits = 20;
constexpr float kAlphaMax = static_cast<float>(1.0 - 1e-6);
constexpr float kQScale = static_cast<float>(5.656854249492381);   // sqrt 32
constexpr float kClip = static_cast<float>(0.5 * 5.656854249492381);

__global__ void __launch_bounds__(kThreads)
tail_bwd_kernel(const float* __restrict__ fields, const int* __restrict__ meta,
                const int* __restrict__ band,
                const int* __restrict__ slot_mask,
                const int* __restrict__ cut, const float* __restrict__ params,
                const float* __restrict__ d_acc, float* __restrict__ d_fields,
                int npts, int chunk, int budget, int budget_lo, int nx,
                int ny_pad, int s_cx, int n_samp, int k_bands, int exact_clip,
                int sub) {
  __shared__ int s_cut[kCutEntries];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int bnd = band[g];
  const bool band_ok = bnd >= 0 && bnd < k_bands;   // K7 adds nothing else
  const int cols = kPlanes * n_samp;
  const float* dacc_band =
      d_acc + static_cast<long long>(band_ok ? bnd : 0) * nx * ny_pad * cols;
  for (int i = tid; i < kCutEntries; i += kThreads) s_cut[i] = cut[i];
  __syncthreads();

  const float kx_t = params[0], kx_j = params[1], kx_0 = params[2];
  const float ky_t = params[3], ky_j = params[4], ky_0 = params[5];
  const float bx2 = params[6], by2 = params[7];
  const int nsub = chunk / sub;
  const int mask = slot_mask != nullptr ? slot_mask[g] : -1;
  const long long np = npts;
  const long long base = static_cast<long long>(g) * chunk;
  const int items = chunk * n_samp;

  // items is a multiple of n_samp and kThreads of n_samp, so a pair's
  // lanes are always in one pass of this loop (the bound is uniform).
  for (int item0 = 0; item0 < items; item0 += kThreads) {
    const int item = item0 + tid;
    const int i = item / n_samp;
    const int j = item - i * n_samp;
    const long long p = base + i;
    // d gate, d sx, d sy, d(il0 m0)/sqrt32, d(il1 m1)/sqrt32, d v0x, d v0y,
    // d r, d g, d b, summed over this item's live slots.
    float acc[10];
#pragma unroll
    for (int f = 0; f < 10; ++f) acc[f] = 0.0f;
    int span = 0;
    float sx = 0.0f, sy = 0.0f, v0x = 0.0f, v0y = 0.0f, il0 = 0.0f,
          il1 = 0.0f, a_eff = 0.0f;
    if (item < items && band_ok) span = meta[5 * np + p];
    if (span > budget_lo && span <= budget) {
      const int tx0 = meta[p];
      const int tx1 = meta[np + p];
      const int ty0 = meta[2 * np + p];
      const int ty1 = meta[3 * np + p];
      const int dbits = meta[4 * np + p];
      sx = fields[p];
      sy = fields[np + p];
      v0x = fields[2 * np + p];
      v0y = fields[3 * np + p];
      il0 = fields[4 * np + p];
      il1 = fields[5 * np + p];
      const float cr = fields[6 * np + p];
      const float cg = fields[7 * np + p];
      const float cb = fields[8 * np + p];
      a_eff = fields[9 * np + p];
      const float m0 = 1.0f / sqrtf(1.0f + (bx2 * (v0x * v0x)
                                            + by2 * (v0y * v0y)) * (il0 * il0));
      const float m1 = 1.0f / sqrtf(1.0f + (bx2 * (v0y * v0y)
                                            + by2 * (v0x * v0x)) * (il1 * il1));
      const float il0w = il0 * m0 * kQScale;
      const float il1w = il1 * m1 * kQScale;
      const float gate = a_eff * (m0 * m1);
      const float jy = static_cast<float>(j / s_cx);
      const float jx = static_cast<float>(j % s_cx);
      const int nxs = max(tx1 - tx0 + 1, 1);
      for (int s = 0; s < span; ++s) {
        if (slot_mask != nullptr && (s + 1) * nsub <= kMaskBits) {
          const int mask_s = (mask >> (s * nsub)) & ((1 << nsub) - 1);
          if (((mask_s >> (i / sub)) & 1) == 0) continue;
        }
        const int oy = s / nxs;
        const int ox = s - oy * nxs;
        if (oy > ty1 - ty0) continue;
        const int tx = tx0 + ox;
        const int ty = ty0 + oy;
        const int t_id = ty * nx + tx;
        const int key = (t_id << kDepthBits) | dbits;
        if (!(key > s_cut[min(max(t_id, 0), kCutEntries - 1)])) continue;

        const float kxs = kx_t * static_cast<float>(tx) + kx_j * jx + kx_0;
        const float kys = ky_t * static_cast<float>(ty) + ky_j * jy + ky_0;
        const float dx = kxs - sx;
        const float dy = kys - sy;
        const float e0 = v0x * dx + v0y * dy;
        const float e1 = v0y * dx - v0x * dy;
        const float n0 = e0 * il0w;
        const float n1 = e1 * il1w;
        const float w = expf(-(n0 * n0 + n1 * n1));
        bool cover = w >= 1e-4f;
        if (exact_clip) {
          cover = cover && fabsf(n0) <= kClip * m0 && fabsf(n1) <= kClip * m1;
        }
        if (!cover) continue;          // alpha 0: every term is 0
        const float aw = gate * w;
        const float alpha = fminf(aw, kAlphaMax);
        const float* dp = dacc_band
            + (static_cast<long long>(tx) * ny_pad + ty) * cols + j;
        const float dA = dp[0], dAr = dp[n_samp], dAg = dp[2 * n_samp];
        const float dAb = dp[3 * n_samp], dA2 = dp[4 * n_samp];
        const float dL = dp[5 * n_samp];
        acc[7] += dAr * alpha;
        acc[8] += dAg * alpha;
        acc[9] += dAb * alpha;
        if (!(aw < kAlphaMax)) continue;   // the clamp holds alpha
        const float d_alpha = dA + dAr * cr + dAg * cg + dAb * cb
            + 2.0f * alpha * dA2 - dL / (1.0f - alpha);
        acc[0] += d_alpha * w;
        const float dqn = d_alpha * gate * w * (-2.0f);
        const float dn0 = n0 * dqn;
        const float dn1 = n1 * dqn;
        acc[1] -= dn0 * v0x * il0w + dn1 * v0y * il1w;
        acc[2] -= dn0 * v0y * il0w - dn1 * v0x * il1w;
        acc[3] += dn0 * e0;
        acc[4] += dn1 * e1;
        acc[5] += dn0 * dx * il0w - dn1 * dy * il1w;
        acc[6] += dn0 * dy * il0w + dn1 * dx * il1w;
      }
    }
    // Sum the pair's n_samp lanes (an aligned group of one warp).
    for (int off = n_samp >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int f = 0; f < 10; ++f) {
        acc[f] += __shfl_xor_sync(0xffffffffu, acc[f], off);
      }
    }
    if (item >= items || j != 0) continue;
    float out[10];
#pragma unroll
    for (int f = 0; f < 10; ++f) out[f] = 0.0f;
    if (span > budget_lo && span <= budget) {
      const float c0 = bx2 * (v0x * v0x) + by2 * (v0y * v0y);
      const float c1 = bx2 * (v0y * v0y) + by2 * (v0x * v0x);
      const float m0 = 1.0f / sqrtf(1.0f + c0 * (il0 * il0));
      const float m1 = 1.0f / sqrtf(1.0f + c1 * (il1 * il1));
      const float d_gate = acc[0];
      const float d_il0w = kQScale * acc[3];
      const float d_il1w = kQScale * acc[4];
      const float d_m0 = d_il0w * il0 + d_gate * a_eff * m1;
      const float d_m1 = d_il1w * il1 + d_gate * a_eff * m0;
      const float d_u0 = d_m0 * (-0.5f) * m0 * m0 * m0;
      const float d_u1 = d_m1 * (-0.5f) * m1 * m1 * m1;
      const float d_c0 = d_u0 * il0 * il0;
      const float d_c1 = d_u1 * il1 * il1;
      out[0] = acc[1];
      out[1] = acc[2];
      out[2] = acc[5] + 2.0f * v0x * (d_c0 * bx2 + d_c1 * by2);
      out[3] = acc[6] + 2.0f * v0y * (d_c0 * by2 + d_c1 * bx2);
      out[4] = d_il0w * m0 + d_u0 * 2.0f * c0 * il0;
      out[5] = d_il1w * m1 + d_u1 * 2.0f * c1 * il1;
      out[6] = acc[7];
      out[7] = acc[8];
      out[8] = acc[9];
      out[9] = d_gate * m0 * m1;
    }
#pragma unroll
    for (int f = 0; f < 10; ++f) d_fields[f * np + p] = out[f];
  }
}

}  // namespace

// fields, d_fields: (10, npts) f32; meta: (6, npts) i32; band, slot_mask:
// (steps,) i32 (slot_mask may be null); cut: (2048,) i32; params: (8,) f32;
// d_acc: (k_bands * nx * ny_pad, 6 * n_samp) f32. n_samp a power of two
// up to 32.
extern "C" int fourdgs_tail_accumulate_bwd(
    const void* fields, const void* meta, const void* band,
    const void* slot_mask, const void* cut, const void* params,
    const void* d_acc, void* d_fields, int npts, int steps, int chunk,
    int budget, int budget_lo, int nx, int ny_pad, int s_cx, int n_samp,
    int k_bands, int exact_clip, void* stream) {
  const int sub = chunk < 512 ? chunk : 512;
  if (chunk <= 0 || steps <= 0 || static_cast<long long>(steps) * chunk != npts
      || n_samp <= 0 || n_samp > 32 || (n_samp & (n_samp - 1)) != 0
      || s_cx <= 0 || n_samp % s_cx != 0 || chunk % sub != 0 || budget <= 0
      || nx <= 0 || ny_pad <= 0
      || static_cast<long long>(chunk) * n_samp > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tail_bwd_kernel<<<steps, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fields), static_cast<const int*>(meta),
      static_cast<const int*>(band), static_cast<const int*>(slot_mask),
      static_cast<const int*>(cut), static_cast<const float*>(params),
      static_cast<const float*>(d_acc), static_cast<float*>(d_fields), npts,
      chunk, budget, budget_lo, nx, ny_pad, s_cx, n_samp, k_bands, exact_clip,
      sub);
  return static_cast<int>(cudaGetLastError());
}
