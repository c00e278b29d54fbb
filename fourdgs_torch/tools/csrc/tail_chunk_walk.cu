// The chunk-walk form of the tail accumulate (the port's first K7), kept as
// a measuring instrument for fourdgs_torch/tools/tail_split.py: it is not
// part of the port's path. One block takes one chunk of `chunk` splats and
// walks chunk * n_samp * budget items, live or not; each live covered sample
// adds its six planes with shared atomics into the chunk's staged window
// rect (global atomics outside it). Built as it is, or with one of
//   -DWALK_NO_ATOMICS  the adds replaced by one guarded store per thread
//                      (the arithmetic stays alive, the atomics go);
//   -DWALK_ONLY        a live item stops after its live test (the walk, the
//                      span / bbox / cut loads and the division stay, the
//                      per-sample arithmetic and the adds go);
//   -DWALK_UNIT_GRID   launched as steps * (chunk / sub) blocks, each
//                      walking one `sub`-splat sub-block of its chunk;
// the differences between their times split the chunk walk's time into its
// atomics, its per-sample arithmetic, its walk and its grid shape.

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
  const int nsub = chunk / sub;
#ifdef WALK_UNIT_GRID
  const int g = blockIdx.x / nsub;
  const int i_lo = (blockIdx.x - g * nsub) * sub;
  const int i_hi = i_lo + sub;
#else
  const int g = blockIdx.x;
  const int i_lo = 0;
  const int i_hi = chunk;
#endif
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
  const int mask = slot_mask != nullptr ? slot_mask[g] : -1;
  const long long np = npts;
  const long long base = static_cast<long long>(g) * chunk;
  const int item_lo = i_lo * n_samp;
  const int item_hi = i_hi * n_samp;
  float sink = 0.0f;

  for (int s = 0; s < budget; ++s) {
    // Mask bits of slot s, one per sub-block; -1 = every sub-block live.
    int mask_s = -1;
    if (slot_mask != nullptr && (s + 1) * nsub <= kMaskBits) {
      mask_s = (mask >> (s * nsub)) & ((1 << nsub) - 1);
      if (mask_s == 0) continue;             // uniform across the block
    }
    for (int item = item_lo + tid; item < item_hi; item += kThreads) {
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
#ifdef WALK_ONLY
      sink += static_cast<float>(key);
      continue;
#endif

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
#ifdef WALK_NO_ATOMICS
      sink += ((vals[0] + vals[1]) + (vals[2] + vals[3])) + (vals[4] + vals[5]);
      continue;
#endif
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

  // Never true for finite sums of this size: keeps `sink` alive.
  if (sink == 1.2345e38f) acc[tid] = sink;
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

extern "C" int fourdgs_tail_chunk_walk(
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
#ifdef WALK_UNIT_GRID
  const int blocks = steps * (chunk / sub_eff);
#else
  const int blocks = steps;
#endif
  tail_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fields), static_cast<const int*>(meta),
      static_cast<const int*>(band), static_cast<const int*>(rect),
      static_cast<const int*>(slot_mask), static_cast<const int*>(cut),
      static_cast<const float*>(params), static_cast<float*>(acc), npts,
      chunk, budget, budget_lo, nx, ny_pad, s_cx, n_samp, k_bands,
      exact_clip, sub_eff);
  return static_cast<int>(cudaGetLastError());
}
