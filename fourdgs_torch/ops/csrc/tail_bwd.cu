// Backward of the streaming banded-OIT tail accumulate: kernel K9 of the
// port.
//
// Replaces fourdgs/ops/tail_pallas.py `_tail_bwd_kernel` (:904), called
// through `_tail_bwd` (:1162-1223) from the custom VJP `_tail_core_bwd`,
// without the within-band weighting knobs (wd_ab, alpha_pow: not ported).
// It computes d_fields (10, Np) of K7's acc under the cotangent d_acc (the
// shape of acc). Per live (pair, sample) with coverage it
//   * reads the six plane cotangents d_acc[row, plane * n_samp + j], row =
//     band * nx * ny_pad + tx * ny_pad + ty (the transposed one-hot of the
//     reference: a gather, no scatter);
//   * chains them through alpha = min(gate w, 1 - 1e-6) (gated by the
//     clamp), w = exp(-(n0^2 + n1^2)), n = e il m sqrt(32), into ten sums:
//     d gate, d sx, d sy, d(il0 m0), d(il1 m1) (before the sqrt(32)), the
//     direct d v0x and d v0y, and d r, g, b;
// and the splat's sums are chained through the widening (m = 1/sqrt(1 + c
// il^2), il_w = il m sqrt(32), gate = a_eff m0 m1) into its 10 cotangents.
// Every forward quantity is recomputed in K7's order of operations, and the
// file is built with -fmad=false, so coverage and alpha round as the
// forward's did.
//
// Bound on the H100: as K7, the coverage test of every live (pair, sample);
// one sample in fifty is covered, so the d_acc gather (from L2, ~2 MB at
// the 10M-splat 1920x1088 frame) and the chain are rare. The walk is K7's
// (tail_unit.cuh): persistent blocks stride over 512-splat units, stage a
// unit's 16 rows with cp.async into a two-stage ring, and prepare each
// splat once. Then one thread takes one splat: it walks the splat's slots
// (no division a slot, the live test once a pair), evaluates the pair's
// samples with the sample loops unrolled for the shipped grids, and keeps
// the ten sums in registers over all its slots and samples, so a splat's
// cotangents are summed in a fixed order by one thread: no shuffles, no
// atomics, any n_samp. The thread writes its splat's 10 results over the
// splat's own column of the staged rows, and the unit leaves through
// coalesced 16-byte stores. Every column is written: zeros for a splat
// outside the span window, and for the whole of a unit whose band or slot
// mask rules it out (written without loading it), so the caller needs no
// zeroing.

#include "tail_unit.cuh"

namespace {

using namespace tail_unit;

constexpr int kSharedWords = kCutEntries + 2 * kStageWords;

// Ten rows x unit entries from p0, zeroed (`src` null) or copied from the
// staged rows.
__device__ __forceinline__ void store_unit(float* d_fields, const Stream& st,
                                           int u, const unsigned* src) {
  const long long p0 = static_cast<long long>(u) * st.unit;
  if (st.vec) {
    const int q = st.unit >> 2;
    for (int e = threadIdx.x; e < kFieldRows * q; e += kThreads) {
      const int r = e / q;
      const int c = (e - r * q) << 2;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (src != nullptr) {
        v = *reinterpret_cast<const uint4*>(src + r * kUnit + c);
      }
      *reinterpret_cast<uint4*>(d_fields + r * st.np + p0 + c) = v;
    }
  } else {
    for (int e = threadIdx.x; e < kFieldRows * st.unit; e += kThreads) {
      const int r = e / st.unit;
      const int c = e - r * st.unit;
      d_fields[r * st.np + p0 + c] =
          src != nullptr ? __uint_as_float(src[r * kUnit + c]) : 0.0f;
    }
  }
}

// The first unit from u on (in this block's stride) that may hold a live
// pair; the units passed over get their zeros.
__device__ __forceinline__ int next_live_unit(const Stream& st, int u,
                                              float* d_fields) {
  while (u < st.n_units && !unit_may_be_live(st, u)) {
    store_unit(d_fields, st, u, nullptr);
    u += gridDim.x;
  }
  return u;
}

template <int SCY, int SCX>
__global__ void __launch_bounds__(kThreads, 2)
tail_bwd_kernel(Stream st, const int* __restrict__ cut, int n_cut,
                const float* __restrict__ params,
                const float* __restrict__ d_acc, float* __restrict__ d_fields,
                int s_cy_rt, int s_cx_rt, int exact_clip) {
  extern __shared__ __align__(16) unsigned smem[];
  int* s_cut = reinterpret_cast<int*>(smem);
  unsigned* s_stage = smem + kCutEntries;
  __shared__ float s_prm[8];

  const int tid = threadIdx.x;
  load_cut_table(s_cut, cut, n_cut);
  if (tid < 8) s_prm[tid] = params[tid];
  const int s_cy = SCY > 0 ? SCY : s_cy_rt;
  const int s_cx = SCX > 0 ? SCX : s_cx_rt;
  const int n_samp = s_cy * s_cx;
  const int cols = kPlanes * n_samp;

  int u = next_live_unit(st, blockIdx.x, d_fields);
  int buf = 0;
  if (u < st.n_units) stage_unit(s_stage, st, u);

  while (u < st.n_units) {
    unsigned* sm = s_stage + buf * kStageWords;
    cp_async_wait_all();
    // The staged rows are visible, and the last unit's stores have read the
    // other stage before the next copies land in it.
    __syncthreads();
    const int u_next = next_live_unit(st, u + gridDim.x, d_fields);
    if (u_next < st.n_units) {
      stage_unit(s_stage + (buf ^ 1) * kStageWords, st, u_next);
    }
    const float bx2 = s_prm[6], by2 = s_prm[7];
    prepare_unit<false>(sm, st, bx2, by2);
    const float* dacc_band = d_acc
        + static_cast<long long>(st.band[u / st.nsub * st.band_stride]) * st.nx * st.ny_pad
        * cols;

    // Thread i takes splat i: only it reads or writes the splat's column.
    if (tid < st.unit) {
      const int i = tid;
      float out[10];
#pragma unroll
      for (int f = 0; f < 10; ++f) out[f] = 0.0f;
      const int span = static_cast<int>(sm[rSpan * kUnit + i]);
      if (span > 0) {
        const float sx = __uint_as_float(sm[rSx * kUnit + i]);
        const float sy = __uint_as_float(sm[rSy * kUnit + i]);
        const float v0x = __uint_as_float(sm[rV0x * kUnit + i]);
        const float v0y = __uint_as_float(sm[rV0y * kUnit + i]);
        const float il0 = __uint_as_float(sm[rIl0 * kUnit + i]);
        const float il1 = __uint_as_float(sm[rIl1 * kUnit + i]);
        const float cr = __uint_as_float(sm[rCr * kUnit + i]);
        const float cg = __uint_as_float(sm[rCg * kUnit + i]);
        const float cb = __uint_as_float(sm[rCb * kUnit + i]);
        const float a_eff = __uint_as_float(sm[rAeff * kUnit + i]);
        const float m0 = __uint_as_float(sm[rM0 * kUnit + i]);
        const float m1 = __uint_as_float(sm[rM1 * kUnit + i]);
        const float il0w = il0 * m0 * kQScale;
        const float il1w = il1 * m1 * kQScale;
        const float gate = a_eff * (m0 * m1);
        const float clip0 = kClip * m0;
        const float clip1 = kClip * m1;
        // d gate, d sx, d sy, d(il0 m0)/sqrt32, d(il1 m1)/sqrt32, d v0x,
        // d v0y, d r, d g, d b, summed over the splat's live slots and
        // their samples.
        float acc[10];
#pragma unroll
        for (int f = 0; f < 10; ++f) acc[f] = 0.0f;
        SlotWalk walk;
        walk.start(sm, i, 0);
        for (int s = 0; s < span && walk.in_rows(); ++s, walk.next()) {
          if (!walk.live(s_cut, st.nx)) continue;
          const int tx = walk.tx();
          const int ty = walk.ty();
          const float kx_tile = s_prm[0] * static_cast<float>(tx);
          const float ky_tile = s_prm[3] * static_cast<float>(ty);
          const float* dp = dacc_band
              + (static_cast<long long>(tx) * st.ny_pad + ty) * cols;
#pragma unroll
          for (int jy = 0; jy < s_cy; ++jy) {
            const float kys =
                ky_tile + s_prm[4] * static_cast<float>(jy) + s_prm[5];
#pragma unroll 8
            for (int jx = 0; jx < s_cx; ++jx) {
              const float kxs =
                  kx_tile + s_prm[1] * static_cast<float>(jx) + s_prm[2];
              Sample sp;
              if (!sp.eval(kxs, kys, sx, sy, v0x, v0y, il0w, il1w, clip0,
                           clip1, exact_clip)) {
                continue;              // alpha 0: every term is 0
              }
              const float aw = gate * sp.w;
              const float alpha = fminf(aw, kAlphaMax);
              const float* d = dp + jy * s_cx + jx;
              const float dA = d[0], dAr = d[n_samp], dAg = d[2 * n_samp];
              const float dAb = d[3 * n_samp], dA2 = d[4 * n_samp];
              const float dL = d[5 * n_samp];
              acc[7] += dAr * alpha;
              acc[8] += dAg * alpha;
              acc[9] += dAb * alpha;
              if (!(aw < kAlphaMax)) continue;   // the clamp holds alpha
              const float d_alpha = dA + dAr * cr + dAg * cg + dAb * cb
                  + 2.0f * alpha * dA2 - dL / (1.0f - alpha);
              acc[0] += d_alpha * sp.w;
              const float dqn = d_alpha * gate * sp.w * (-2.0f);
              const float dn0 = sp.n0 * dqn;
              const float dn1 = sp.n1 * dqn;
              acc[1] -= dn0 * v0x * il0w + dn1 * v0y * il1w;
              acc[2] -= dn0 * v0y * il0w - dn1 * v0x * il1w;
              acc[3] += dn0 * sp.e0;
              acc[4] += dn1 * sp.e1;
              acc[5] += dn0 * sp.dx * il0w - dn1 * sp.dy * il1w;
              acc[6] += dn0 * sp.dy * il0w + dn1 * sp.dx * il1w;
            }
          }
        }
        const float c0 = bx2 * (v0x * v0x) + by2 * (v0y * v0y);
        const float c1 = bx2 * (v0y * v0y) + by2 * (v0x * v0x);
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
      for (int f = 0; f < 10; ++f) {
        sm[f * kUnit + i] = __float_as_uint(out[f]);
      }
    }
    __syncthreads();
    store_unit(d_fields, st, u, sm);
    u = u_next;
    buf ^= 1;
  }
}

template <int SCY, int SCX>
int launch(const Stream& st, const void* cut, int n_cut, const void* params,
           const void* d_acc, void* d_fields, int s_cy, int s_cx,
           int exact_clip, cudaStream_t stream) {
  // Blocks resident on the card at this kernel's shared memory and
  // registers: asked once.
  static int resident = 0;
  const int bytes = kSharedWords * 4;
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        tail_bwd_kernel<SCY, SCX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tail_bwd_kernel<SCY, SCX>, kThreads, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (sms <= 0 || per_sm <= 0) {
      return static_cast<int>(cudaErrorLaunchOutOfResources);
    }
    resident = sms * per_sm;
  }
  const int blocks = st.n_units < resident ? st.n_units : resident;
  tail_bwd_kernel<SCY, SCX><<<blocks, kThreads, bytes, stream>>>(
      st, static_cast<const int*>(cut), n_cut,
      static_cast<const float*>(params), static_cast<const float*>(d_acc),
      static_cast<float*>(d_fields), s_cy, s_cx, exact_clip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fields, d_fields: (10, npts) f32; meta: (6, npts) i32; band, slot_mask:
// (steps,) i32 with strides in elements (slot_mask may be null); cut:
// (n_cut <= 2048,) i32; params: (8,) f32;
// d_acc: (k_bands * nx * ny_pad, 6 * n_samp) f32. Any n_samp that is a
// multiple of s_cx.
extern "C" int fourdgs_tail_accumulate_bwd(
    const void* fields, const void* meta, const void* band,
    const void* slot_mask, const void* cut, const void* params,
    const void* d_acc, void* d_fields, int npts, int steps, int chunk,
    int budget, int budget_lo, int nx, int ny_pad, int s_cx, int n_samp,
    int k_bands, int exact_clip, int band_stride, int mask_stride, int n_cut,
    void* stream) {
  Stream st;
  if (n_cut < 0 || n_cut > kCutEntries
      || !fill_stream(&st, fields, meta, band, slot_mask, band_stride,
                      mask_stride, npts, steps, chunk, budget, budget_lo, nx,
                      ny_pad, s_cx, n_samp, k_bands)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  st.vec = st.vec && reinterpret_cast<unsigned long long>(d_fields) % 16 == 0;
  const int s_cy = n_samp / s_cx;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (s_cy == 1 && s_cx == 8) {
    return launch<1, 8>(st, cut, n_cut, params, d_acc, d_fields, s_cy, s_cx,
                        exact_clip, cs);
  }
  if (s_cy == 2 && s_cx == 16) {
    return launch<2, 16>(st, cut, n_cut, params, d_acc, d_fields, s_cy, s_cx,
                         exact_clip, cs);
  }
  return launch<0, 0>(st, cut, n_cut, params, d_acc, d_fields, s_cy, s_cx,
                      exact_clip, cs);
}
