// Streaming banded-OIT tail accumulate: kernel K7 of the port.
//
// Replaces fourdgs/ops/tail_pallas.py `_tail_kernel` (called through
// `_tail_fwd_raw`, tail_pallas.py:749-808) and computes what the
// reference's f32 twin `tail_accumulate_xla` (:811-890) computes, in f32,
// without the within-band weighting knobs (wd_ab, alpha_pow: not ported).
//
// One thread block takes one chunk of `chunk` splats (grid step g):
//   * for every bbox slot s < budget of every splat i of the chunk:
//     oy = s / nxs, ox = s - oy * nxs (nxs = max(tx1 - tx0 + 1, 1)); the
//     pair (tile tx0 + ox, ty0 + oy) is live iff s < span, budget_lo < span
//     <= budget, oy <= ty1 - ty0 and key = (tid << 20 | dbits) > cut[tid]
//     (the cut table padded to 2048 entries with INT32_MAX);
//   * at each of the n_samp coarse samples (jy, jx) of the tile: the
//     footprint widened by the coarse block's box filter at preserved mass,
//     m = 1/sqrt(1 + c il^2), il_w = il m sqrt(32), gate = a_eff m0 m1;
//     w = exp(-(n0^2 + n1^2)); coverage w >= 1e-4 (and, with exact_clip,
//     |n| <= 0.5 sqrt(32) m per axis); alpha = min(cover ? gate w : 0,
//     1 - 1e-6);
//   * it adds the six planes [alpha, alpha r, alpha g, alpha b, alpha^2,
//     log1p(-alpha)] to acc[band * nx * ny_pad + tx * ny_pad + ty,
//     plane * n_samp + sample], the layout fold_upsample_tail reads.
// Every operation is written in the twin's order, and the file is built
// with -fmad=false, so a sample's planes round as the plain PyTorch
// version's do; only the order of the sums differs. Planes stay f32 (the
// reference's kernel rounds them to bf16 before its one-hot matmul).
//
// Bound on the H100: the accumulation. At the 10M-splat 1920x1088 frame
// about 16M tail pairs x 8 samples each add 6 planes, and the adds of one
// chunk pile onto the few tiles its Morton-local splats cover, so atomics
// to one address collide. The reference keeps the whole accumulator in
// VMEM; here it is ~2 MB, far more than one SM's shared memory. Design:
//   * the block stages its chunk's window rect (from the prepass, K6:
//     2 nwx tile columns x 16 nwy tile rows from (txw, tyw)) x 6 n_samp
//     floats in shared memory when it fits (40 KB), adds there with shared
//     atomics, and flushes the nonzero entries with one global atomicAdd
//     each; a pair outside the staged rect (or a rect too large to stage)
//     adds to global memory directly;
//   * consecutive threads take consecutive samples of one pair, so the
//     lanes of a warp add to distinct addresses for n_samp >= 32 and to at
//     most 32 / n_samp pairs' tiles otherwise;
//   * a pair with alpha == 0 adds nothing (its planes are all zero);
//   * the slot mask (K6) skips (slot, 512-pair sub-block) passes that hold
//     no live pair; it is a superset of the live test, so skipping is exact.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kCutEntries = 2048;
constexpr int kPlanes = 6;
constexpr int kStageFloats = 10240;     // 40 KB; with the cut table 48 KB
constexpr int kMaskBits = 30;
constexpr int kWinTx = 2;
constexpr int kWinTy = 16;
constexpr int kDepthBits = 20;
constexpr float kAlphaMax = static_cast<float>(1.0 - 1e-6);
constexpr float kQScale = static_cast<float>(5.656854249492381);   // sqrt 32
constexpr float kClip = static_cast<float>(0.5 * 5.656854249492381);

__global__ void __launch_bounds__(kThreads)
tail_kernel(const float* __restrict__ fields, const int* __restrict__ meta,
            const int* __restrict__ band, const int* __restrict__ rect,
            const int* __restrict__ slot_mask, const int* __restrict__ cut,
            const float* __restrict__ params, float* __restrict__ acc,
            int npts, int chunk, int budget, int budget_lo, int nx,
            int ny_pad, int s_cx, int n_samp, int k_bands, int exact_clip,
            int sub) {
  __shared__ int s_cut[kCutEntries];
  __shared__ float s_acc[kStageFloats];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int bnd = band[g];
  if (bnd < 0 || bnd >= k_bands) return;   // uniform; the prepass never does
  const int cols = kPlanes * n_samp;
  float* acc_band = acc + static_cast<long long>(bnd) * nx * ny_pad * cols;

  const int txw = rect[4 * g];
  const int tyw = rect[4 * g + 1];
  const int wx = min(kWinTx * rect[4 * g + 2], nx - txw);
  const int wy = min(kWinTy * rect[4 * g + 3], ny_pad - tyw);
  const long long need = static_cast<long long>(wx) * wy * cols;
  const bool staged = wx > 0 && wy > 0 && txw >= 0 && tyw >= 0
      && need <= kStageFloats;
  for (int i = tid; i < kCutEntries; i += kThreads) s_cut[i] = cut[i];
  if (staged) {
    for (int e = tid; e < need; e += kThreads) s_acc[e] = 0.0f;
  }
  __syncthreads();

  const float kx_t = params[0], kx_j = params[1], kx_0 = params[2];
  const float ky_t = params[3], ky_j = params[4], ky_0 = params[5];
  const float bx2 = params[6], by2 = params[7];
  const int nsub = chunk / sub;
  const int mask = slot_mask != nullptr ? slot_mask[g] : -1;
  const long long np = npts;
  const long long base = static_cast<long long>(g) * chunk;
  const int items = chunk * n_samp;

  for (int s = 0; s < budget; ++s) {
    // Mask bits of slot s, one per sub-block; -1 = every sub-block live.
    int mask_s = -1;
    if (slot_mask != nullptr && (s + 1) * nsub <= kMaskBits) {
      mask_s = (mask >> (s * nsub)) & ((1 << nsub) - 1);
      if (mask_s == 0) continue;             // uniform across the block
    }
    for (int item = tid; item < items; item += kThreads) {
      const int i = item / n_samp;
      const int j = item - i * n_samp;
      if (mask_s != -1 && ((mask_s >> (i / sub)) & 1) == 0) continue;
      const long long p = base + i;
      const int span = meta[5 * np + p];
      if (!(s < span && span > budget_lo && span <= budget)) continue;
      const int tx0 = meta[p];
      const int tx1 = meta[np + p];
      const int ty0 = meta[2 * np + p];
      const int ty1 = meta[3 * np + p];
      const int nxs = max(tx1 - tx0 + 1, 1);
      const int oy = s / nxs;
      const int ox = s - oy * nxs;
      if (oy > ty1 - ty0) continue;
      const int tx = tx0 + ox;
      const int ty = ty0 + oy;
      const int t_id = ty * nx + tx;
      const int key = (t_id << kDepthBits) | meta[4 * np + p];
      if (!(key > s_cut[min(max(t_id, 0), kCutEntries - 1)])) continue;

      const float sx = fields[p];
      const float sy = fields[np + p];
      const float v0x = fields[2 * np + p];
      const float v0y = fields[3 * np + p];
      const float il0 = fields[4 * np + p];
      const float il1 = fields[5 * np + p];
      const float a_eff = fields[9 * np + p];
      const float m0 = 1.0f / sqrtf(1.0f + (bx2 * (v0x * v0x)
                                            + by2 * (v0y * v0y)) * (il0 * il0));
      const float m1 = 1.0f / sqrtf(1.0f + (bx2 * (v0y * v0y)
                                            + by2 * (v0x * v0x)) * (il1 * il1));
      const float il0w = il0 * m0 * kQScale;
      const float il1w = il1 * m1 * kQScale;
      const float gate = a_eff * (m0 * m1);
      const float jy = static_cast<float>(j / s_cx);
      const float jx = static_cast<float>(j % s_cx);
      const float kxs = kx_t * static_cast<float>(tx) + kx_j * jx + kx_0;
      const float kys = ky_t * static_cast<float>(ty) + ky_j * jy + ky_0;
      const float dx = kxs - sx;
      const float dy = kys - sy;
      const float n0 = (v0x * dx + v0y * dy) * il0w;
      const float n1 = (v0y * dx - v0x * dy) * il1w;
      const float w = expf(-(n0 * n0 + n1 * n1));
      bool cover = w >= 1e-4f;
      if (exact_clip) {
        cover = cover && fabsf(n0) <= kClip * m0 && fabsf(n1) <= kClip * m1;
      }
      const float alpha = fminf(cover ? gate * w : 0.0f, kAlphaMax);
      if (alpha == 0.0f) continue;
      const float vals[kPlanes] = {
          alpha, alpha * fields[6 * np + p], alpha * fields[7 * np + p],
          alpha * fields[8 * np + p], alpha * alpha, log1pf(-alpha)};
      const int lx = tx - txw;
      const int ly = ty - tyw;
      if (staged && lx >= 0 && lx < wx && ly >= 0 && ly < wy) {
        float* dst = s_acc + (lx * wy + ly) * cols + j;
#pragma unroll
        for (int q = 0; q < kPlanes; ++q) atomicAdd(dst + q * n_samp, vals[q]);
      } else {
        float* dst = acc_band
            + (static_cast<long long>(tx) * ny_pad + ty) * cols + j;
#pragma unroll
        for (int q = 0; q < kPlanes; ++q) atomicAdd(dst + q * n_samp, vals[q]);
      }
    }
  }

  if (!staged) return;
  __syncthreads();
  for (int e = tid; e < need; e += kThreads) {
    const float v = s_acc[e];
    if (v == 0.0f) continue;
    const int cell = e / cols;
    const int c = e - cell * cols;
    const int lx = cell / wy;
    const int ly = cell - lx * wy;
    atomicAdd(acc_band + (static_cast<long long>(txw + lx) * ny_pad
                          + (tyw + ly)) * cols + c, v);
  }
}

}  // namespace

extern "C" int fourdgs_tail_accumulate(
    const void* fields, const void* meta, const void* band, const void* rect,
    const void* slot_mask, const void* cut, const void* params, void* acc,
    int npts, int steps, int chunk, int budget, int budget_lo, int nx,
    int ny_pad, int s_cx, int n_samp, int k_bands, int exact_clip, int sub,
    void* stream) {
  const int sub_eff = chunk < sub ? chunk : sub;
  if (chunk <= 0 || steps <= 0 || static_cast<long long>(steps) * chunk != npts
      || n_samp <= 0 || s_cx <= 0 || n_samp % s_cx != 0 || sub <= 0
      || chunk % sub_eff != 0 || budget <= 0 || nx <= 0 || ny_pad <= 0
      || static_cast<long long>(chunk) * n_samp > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tail_kernel<<<steps, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fields), static_cast<const int*>(meta),
      static_cast<const int*>(band), static_cast<const int*>(rect),
      static_cast<const int*>(slot_mask), static_cast<const int*>(cut),
      static_cast<const float*>(params), static_cast<float*>(acc), npts,
      chunk, budget, budget_lo, nx, ny_pad, s_cx, n_samp, k_bands,
      exact_clip, sub_eff);
  return static_cast<int>(cudaGetLastError());
}
