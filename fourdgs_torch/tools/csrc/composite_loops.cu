// The composite (K1) and its backward (K8) as they were before the shared
// record walk (ops/csrc/composite_walk.cuh), kept as a measuring instrument
// for `python3 -m fourdgs_torch.tools.composite_split`; no path of the port
// launches it. Only the 16x128 tile's instance (P = 2048, 256 threads, 8
// pixels a thread) is built.
//
// Build switches, each a variant the split times beside the unswitched form:
//   LOOPS_COVER_ONLY  the coverage test of every (record, pixel) pair and a
//                     count of the covered ones: no exp, no blend, no
//                     reduction;
//   LOOPS_INTERCHANGE K1 walks records outside and pixels inside (K8 already
//                     does);
//   LOOPS_CULL        a warp skips a record whose cull box misses the box of
//                     its pixels (the box of composite_walk.cuh);
//   LOOPS_COMPACT     with LOOPS_CULL: a warp owns 32 columns x 8 adjacent
//                     rows of the tile instead of 32 columns x every other
//                     row;
//   LOOPS_NO_REDUCE   K8 writes lane 0's own sums instead of the warp's.
// Without switches both kernels are the earlier K1 and K8 bit for bit.

#include <cuda_runtime.h>

#include "../../ops/csrc/composite_walk.cuh"

namespace {

using composite_walk::Patch;
constexpr int kChunk = 128;
constexpr int kFields = 10;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPpt = 8;
constexpr int kP = kPpt * kThreads;

__device__ __forceinline__ int pixel_of(int j, int tw) {
#if defined(LOOPS_COMPACT)
  return composite_walk::walk_pixel<kPpt, kThreads>(threadIdx.x, j, tw);
#else
  (void)tw;
  return threadIdx.x + j * kThreads;
#endif
}

__device__ __forceinline__ int tile_width(const float* ky_t, int* s_first) {
#if defined(LOOPS_COMPACT)
  return composite_walk::walk_tile_width<kP, kThreads>(ky_t, s_first);
#else
  (void)ky_t;
  (void)s_first;
  return 0;
#endif
}

// Stage chunk c (and, with LOOPS_CULL, its boxes); a barrier follows.
__device__ __forceinline__ void stage(float (*s_rec)[kChunk], float4* s_box,
                                      const float* rec_b, int c, int m) {
  for (int i = threadIdx.x; i < kFields * kChunk; i += kThreads) {
    const int f = i / kChunk;
    const int k = i - f * kChunk;
    s_rec[f][k] = rec_b[static_cast<long long>(f) * m + c * kChunk + k];
  }
#if defined(LOOPS_CULL)
  __syncthreads();
  composite_walk::chunk_boxes(&s_rec[0][0], s_box);
#else
  (void)s_box;
#endif
  __syncthreads();
}

__device__ __forceinline__ bool culled(const float4* s_box, int k,
                                       const Patch& q) {
#if defined(LOOPS_CULL)
  return composite_walk::box_misses(s_box[k], q);
#else
  (void)s_box;
  (void)k;
  (void)q;
  return false;
#endif
}

__global__ void __launch_bounds__(kThreads)
composite_loops_kernel(const float* __restrict__ rec,
                       const int* __restrict__ counts,
                       const int* __restrict__ sel,
                       const float* __restrict__ kx,
                       const float* __restrict__ ky, const float* carry,
                       float* out, int f_stride, int m) {
  constexpr int P = kP;
  constexpr int PPT = kPpt;
  __shared__ float s_rec[kFields][kChunk];
  __shared__ float4 s_box[kChunk];
  __shared__ int s_first;
  const int b = blockIdx.x;
  const int tile = sel != nullptr ? sel[b] : b;
  const int n = counts[b];
  int n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > m / kChunk) n_chunks = m / kChunk;
  const float alpha_max = static_cast<float>(1.0 - 1e-6);

  const float* rec_b = rec + static_cast<long long>(b) * f_stride * m;
  const float* carry_t = carry + static_cast<long long>(tile) * 8 * P;
  float* out_t = out + static_cast<long long>(tile) * 8 * P;
  const int tw = tile_width(ky + static_cast<long long>(tile) * P, &s_first);

  float px[PPT], py[PPT], acc_r[PPT], acc_g[PPT], acc_b[PPT], acc_a[PPT],
      trans[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = pixel_of(j, tw);
    px[j] = kx[static_cast<long long>(tile) * P + p];
    py[j] = ky[static_cast<long long>(tile) * P + p];
    acc_r[j] = carry_t[0 * P + p];
    acc_g[j] = carry_t[1 * P + p];
    acc_b[j] = carry_t[2 * P + p];
    acc_a[j] = carry_t[3 * P + p];
    trans[j] = carry_t[4 * P + p];
  }
  const Patch patch = composite_walk::warp_patch<PPT>(px, py);

  for (int c = 0;; ++c) {
    int open = 0;
#pragma unroll
    for (int j = 0; j < PPT; ++j) open |= trans[j] > 1e-6f;
    if (!__syncthreads_or(open) || c >= n_chunks) break;
    stage(s_rec, s_box, rec_b, c, m);

#if defined(LOOPS_INTERCHANGE)
    float cp[PPT], sr[PPT], sg[PPT], sb[PPT], sa[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      cp[j] = 1.0f;
      sr[j] = sg[j] = sb[j] = sa[j] = 0.0f;
    }
    for (int k = 0; k < kChunk; ++k) {
      if (culled(s_box, k, patch)) continue;
      const float sx = s_rec[0][k], sy = s_rec[1][k];
      const float v0x = s_rec[2][k], v0y = s_rec[3][k];
      const float il0 = s_rec[4][k], il1 = s_rec[5][k];
      const float cr = s_rec[6][k], cg = s_rec[7][k], cb = s_rec[8][k];
      const float a_eff = s_rec[9][k];
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const float dx = px[j] - sx;
        const float dy = py[j] - sy;
        const float n0 = (v0x * dx + v0y * dy) * il0;
        const float n1 = (v0y * dx - v0x * dy) * il1;
        if (!(fabsf(n0) <= 0.5f && fabsf(n1) <= 0.5f)) continue;
        const float q = 64.0f * (n0 * n0 + n1 * n1);
        const float w = expf(-0.5f * q);
        if (!(w >= 1e-4f)) continue;
        float alpha = a_eff * w;
        alpha = fminf(alpha, alpha_max);
        const float wgt = alpha * (trans[j] * cp[j]);
        sr[j] += wgt * cr;
        sg[j] += wgt * cg;
        sb[j] += wgt * cb;
        sa[j] += alpha * wgt;
        cp[j] = cp[j] * (1.0f - alpha);
      }
    }
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      acc_r[j] += sr[j];
      acc_g[j] += sg[j];
      acc_b[j] += sb[j];
      acc_a[j] += sa[j];
      trans[j] = trans[j] * cp[j];
    }
#else
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      float cp = 1.0f;
      float sr = 0.0f, sg = 0.0f, sb = 0.0f, sa = 0.0f;
      for (int k = 0; k < kChunk; ++k) {
        if (culled(s_box, k, patch)) continue;
        const float dx = px[j] - s_rec[0][k];
        const float dy = py[j] - s_rec[1][k];
        const float v0x = s_rec[2][k];
        const float v0y = s_rec[3][k];
        const float n0 = (v0x * dx + v0y * dy) * s_rec[4][k];
        const float n1 = (v0y * dx - v0x * dy) * s_rec[5][k];
        if (!(fabsf(n0) <= 0.5f && fabsf(n1) <= 0.5f)) continue;
#if defined(LOOPS_COVER_ONLY)
        sa += 1.0f;
        continue;
#endif
        const float q = 64.0f * (n0 * n0 + n1 * n1);
        const float w = expf(-0.5f * q);
        if (!(w >= 1e-4f)) continue;
        float alpha = s_rec[9][k] * w;
        alpha = fminf(alpha, alpha_max);
        const float wgt = alpha * (trans[j] * cp);
        sr += wgt * s_rec[6][k];
        sg += wgt * s_rec[7][k];
        sb += wgt * s_rec[8][k];
        sa += alpha * wgt;
        cp = cp * (1.0f - alpha);
      }
      acc_r[j] += sr;
      acc_g[j] += sg;
      acc_b[j] += sb;
      acc_a[j] += sa;
      trans[j] = trans[j] * cp;
    }
#endif
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = pixel_of(j, tw);
    out_t[0 * P + p] = acc_r[j];
    out_t[1 * P + p] = acc_g[j];
    out_t[2 * P + p] = acc_b[j];
    out_t[3 * P + p] = acc_a[j];
    out_t[4 * P + p] = trans[j];
    out_t[5 * P + p] = 0.0f;
    out_t[6 * P + p] = 0.0f;
    out_t[7 * P + p] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
composite_bwd_loops_kernel(const float* __restrict__ rec,
                           const int* __restrict__ counts,
                           const int* __restrict__ sel,
                           const float* __restrict__ kx,
                           const float* __restrict__ ky,
                           const float* __restrict__ carry,
                           const float* __restrict__ fout,
                           const float* __restrict__ g,
                           float* __restrict__ drec, int f_stride, int m) {
  constexpr int P = kP;
  constexpr int PPT = kPpt;
  __shared__ float s_rec[kFields][kChunk];
  __shared__ float s_part[kWarps][kFields][kChunk];
  __shared__ float4 s_box[kChunk];
  __shared__ int s_first;
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
  const int tw = tile_width(ky + static_cast<long long>(tile) * P, &s_first);

  float px[PPT], py[PPT], gr[PPT], gg[PPT], gb[PPT], ga[PPT], rem[PPT],
      trans[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = pixel_of(j, tw);
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
  const Patch patch = composite_walk::warp_patch<PPT>(px, py);

  for (int c = 0;; ++c) {
    int open = 0;
#pragma unroll
    for (int j = 0; j < PPT; ++j) open |= trans[j] > 1e-6f;
    if (!__syncthreads_or(open) || c >= n_chunks) break;
    stage(s_rec, s_box, rec_b, c, m);

    float cp[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) cp[j] = 1.0f;

    for (int k = 0; k < kChunk; ++k) {
      if (culled(s_box, k, patch)) {
        if (lane == 0) {
#pragma unroll
          for (int f = 0; f < kFields; ++f) s_part[warp][f][k] = 0.0f;
        }
        continue;
      }
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
#if defined(LOOPS_COVER_ONLY)
        d[9] += 1.0f;
        continue;
#endif
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
#if !defined(LOOPS_NO_REDUCE) && !defined(LOOPS_COVER_ONLY)
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
#else
      (void)any;
#endif
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
    __syncthreads();
  }
}

}  // namespace

// The entries take the production kernels' arguments (ops/csrc/composite.cu
// and composite_bwd.cu) and refuse any p but 2048.
extern "C" int fourdgs_composite_loops(const void* rec, const void* counts,
                                       const void* sel, const void* kx,
                                       const void* ky, const void* carry,
                                       void* out, int n_blocks, int f_stride,
                                       int m, int p, void* stream) {
  if (n_blocks < 0 || f_stride < kFields || m % kChunk != 0 || p != kP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks == 0) return 0;
  composite_loops_kernel<<<n_blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rec), static_cast<const int*>(counts),
      static_cast<const int*>(sel), static_cast<const float*>(kx),
      static_cast<const float*>(ky), static_cast<const float*>(carry),
      static_cast<float*>(out), f_stride, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fourdgs_composite_bwd_loops(
    const void* rec, const void* counts, const void* sel, const void* kx,
    const void* ky, const void* carry, const void* fout, const void* g,
    void* drec, int n_blocks, int f_stride, int m, int p, void* stream) {
  if (n_blocks < 0 || f_stride < kFields || m % kChunk != 0 || p != kP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks == 0) return 0;
  composite_bwd_loops_kernel<<<n_blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rec), static_cast<const int*>(counts),
      static_cast<const int*>(sel), static_cast<const float*>(kx),
      static_cast<const float*>(ky), static_cast<const float*>(carry),
      static_cast<const float*>(fout), static_cast<const float*>(g),
      static_cast<float*>(drec), f_stride, m);
  return static_cast<int>(cudaGetLastError());
}
