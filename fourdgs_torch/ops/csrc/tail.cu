// Streaming banded-OIT tail accumulate: kernel K7 of the port.
//
// Replaces fourdgs/ops/tail_pallas.py `_tail_kernel` (called through
// `_tail_fwd_raw`, tail_pallas.py:749-808) and computes what the
// reference's f32 twin `tail_accumulate_xla` (:811-890) computes, in f32,
// without the within-band weighting knobs (wd_ab, alpha_pow: not ported):
//   * for every bbox slot s < budget of every splat i: oy = s / nxs, ox = s
//     - oy * nxs (nxs = max(tx1 - tx0 + 1, 1)); the pair (tile tx0 + ox, ty0
//     + oy) is live iff s < span, budget_lo < span <= budget, oy <= ty1 - ty0
//     and key = (tid << 20 | dbits) > cut[tid] (the cut table padded to 2048
//     entries with INT32_MAX);
//   * at each of the n_samp coarse samples (jy, jx) of the tile: the
//     footprint widened by the coarse block's box filter at preserved mass,
//     m = 1/sqrt(1 + c il^2), il_w = il m sqrt(32), gate = a_eff m0 m1;
//     w = exp(-(n0^2 + n1^2)); coverage w >= 1e-4 (and, with exact_clip,
//     |n| <= 0.5 sqrt(32) m per axis); alpha = min(cover ? gate w : 0,
//     1 - 1e-6);
//   * the six planes [alpha, alpha r, alpha g, alpha b, alpha^2,
//     log1p(-alpha)] are added to acc[band * nx * ny_pad + tx * ny_pad + ty,
//     plane * n_samp + sample], the layout fold_upsample_tail reads.
// Every operation is written in the twin's order, and the file is built
// with -fmad=false, so a sample's planes round as the plain PyTorch
// version's do; only the order of the sums differs. Planes stay f32 (the
// reference's kernel rounds them to bf16 before its one-hot matmul).
//
// Bound on the H100: the coverage test of every live (pair, sample), about
// 16.6M pairs x 8 samples at the 10M-splat 1920x1088 frame, of which one
// in fifty is covered and adds anything; and latency, when few long blocks
// walk dead items in series. The reference keeps the whole ~2 MB
// accumulator resident and scatters with a one-hot matmul; here the walk
// is (tail_unit.cuh has the pieces it shares with the backward, K9):
//   * work unit = one 512-splat sub-block of one chunk; a few persistent
//     blocks an SM stride over the units, so no block is long and there is
//     no second wave; a unit whose slot-mask bits are all 0 is skipped
//     before any load;
//   * the unit's 16 rows are staged once with 16-byte cp.async copies into a
//     two-stage ring, and each splat's m0, m1, il_w, gate and packed bbox
//     are computed once: the inner loop reads no global memory;
//   * a live-pair worklist a warp: a lane walks the slots of its own splat
//     (no division a slot), applies the whole live test once a pair, and a
//     warp scan compacts the live pairs of the warp's 32 splats into the
//     warp's list in shared memory, 8 slots a round so the list fits
//     whatever the budget; no block barrier and no atomic in it;
//   * one lane a listed pair evaluates the pair's samples from shared
//     memory: no dead items, no divergence on liveness, lanes balanced
//     within the warp whatever the splats' spans, the pair's values loaded
//     once for all its samples, the sample loops unrolled for the shipped
//     sample grids (1 x 8 and 2 x 16; any other runs the same code with
//     run-time bounds);
//   * a covered sample is not added where it is found (one lane in 32
//     would run the ~70 instructions of log1p, colors and six adds while
//     the others wait: measured, half the kernel's time) but queued, two
//     words, in the warp's hit queue; after the pairs the warp adds the
//     queued samples one lane each, with global atomics (`red`), which
//     measured no slower than adding into a tile window in shared memory
//     first and flushing it once a unit. A full queue adds at once. The
//     prepass's window rect is not needed any more.
// A unit costs one block barrier. Covered samples are so rare that ordering
// the list by tile and summing runs in registers would save nothing.

#include "tail_unit.cuh"

namespace {

using namespace tail_unit;

constexpr int kRoundSlots = 8;        // slots a warp lists in one round
constexpr int kWarpList = 32 * kRoundSlots;
constexpr int kWarpHits = 64;         // covered samples a warp queues
// Words of dynamic shared memory: the cut table, the two-stage ring, the
// warps' worklists, their hit queues (two words a hit) and hit counts.
constexpr int kSharedWords = kCutEntries + 2 * kStageWords
    + kWarps * kWarpList + kWarps * kWarpHits * 2 + kWarps;

// The six planes of one covered sample, added to the accumulator.
__device__ __forceinline__ void add_planes(const unsigned* sm, int entry,
                                           int j, float alpha, int n_samp,
                                           int ny_pad, float* acc_band) {
  const int i = entry & (kUnit - 1);
  const int tx = (entry >> 9) & 0x7ff;
  const int ty = entry >> 20;
  float* d = acc_band
      + (static_cast<long long>(tx) * ny_pad + ty) * (kPlanes * n_samp) + j;
  atomicAdd(d, alpha);
  atomicAdd(d + n_samp, alpha * __uint_as_float(sm[rCr * kUnit + i]));
  atomicAdd(d + 2 * n_samp, alpha * __uint_as_float(sm[rCg * kUnit + i]));
  atomicAdd(d + 3 * n_samp, alpha * __uint_as_float(sm[rCb * kUnit + i]));
  atomicAdd(d + 4 * n_samp, alpha * alpha);
  atomicAdd(d + 5 * n_samp, log1pf(-alpha));
}

// One listed pair (entry k of the warp's list) under one lane: its samples
// against the prepared splat. A covered sample goes to the warp's hit queue
// (or, the queue full, to the accumulator at once).
template <int SCY, int SCX>
__device__ __forceinline__ void pair_samples(
    const unsigned* sm, const int* w_list, int k, const float* prm,
    int s_cy_rt, int s_cx_rt, int exact_clip, int* w_count, int2* w_hits,
    int ny_pad, float* acc_band) {
  const int s_cy = SCY > 0 ? SCY : s_cy_rt;
  const int s_cx = SCX > 0 ? SCX : s_cx_rt;
  const int entry = w_list[k];
  const int i = entry & (kUnit - 1);
  const int tx = (entry >> 9) & 0x7ff;
  const int ty = entry >> 20;
  const float sx = __uint_as_float(sm[rSx * kUnit + i]);
  const float sy = __uint_as_float(sm[rSy * kUnit + i]);
  const float v0x = __uint_as_float(sm[rV0x * kUnit + i]);
  const float v0y = __uint_as_float(sm[rV0y * kUnit + i]);
  const float il0w = __uint_as_float(sm[rIl0 * kUnit + i]);
  const float il1w = __uint_as_float(sm[rIl1 * kUnit + i]);
  const float gate = __uint_as_float(sm[rAeff * kUnit + i]);
  const float clip0 = kClip * __uint_as_float(sm[rM0 * kUnit + i]);
  const float clip1 = kClip * __uint_as_float(sm[rM1 * kUnit + i]);
  const float kx_tile = prm[0] * static_cast<float>(tx);
  const float ky_tile = prm[3] * static_cast<float>(ty);
#pragma unroll
  for (int jy = 0; jy < s_cy; ++jy) {
    const float kys = ky_tile + prm[4] * static_cast<float>(jy) + prm[5];
#pragma unroll 8
    for (int jx = 0; jx < s_cx; ++jx) {
      const float kxs = kx_tile + prm[1] * static_cast<float>(jx) + prm[2];
      Sample sp;
      if (!sp.eval(kxs, kys, sx, sy, v0x, v0y, il0w, il1w, clip0, clip1,
                   exact_clip)) {
        continue;
      }
      const float alpha = fminf(gate * sp.w, kAlphaMax);
      if (alpha == 0.0f) continue;
      const int j = jy * s_cx + jx;
      const int pos = atomicAdd(w_count, 1);
      if (pos < kWarpHits) {
        w_hits[pos] = make_int2(k | (j << 8), __float_as_int(alpha));
      } else {
        add_planes(sm, entry, j, alpha, s_cy * s_cx, ny_pad, acc_band);
      }
    }
  }
}

template <int SCY, int SCX>
__global__ void __launch_bounds__(kThreads, 2)
tail_kernel(Stream st, const int* __restrict__ cut, int n_cut,
            const float* __restrict__ params, float* __restrict__ acc,
            int s_cy, int s_cx, int exact_clip) {
  extern __shared__ __align__(16) unsigned smem[];
  int* s_cut = reinterpret_cast<int*>(smem);
  unsigned* s_stage = smem + kCutEntries;
  int* s_list = reinterpret_cast<int*>(s_stage + 2 * kStageWords);
  int2* s_hits = reinterpret_cast<int2*>(s_list + kWarps * kWarpList);
  int* s_count = reinterpret_cast<int*>(s_hits + kWarps * kWarpHits);
  __shared__ float s_prm[8];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* w_list = s_list + warp * kWarpList;
  int2* w_hits = s_hits + warp * kWarpHits;
  int* w_count = s_count + warp;
  load_cut_table(s_cut, cut, n_cut);
  if (tid < 8) s_prm[tid] = params[tid];
  if (lane == 0) *w_count = 0;
  const int n_samp = (SCY > 0 ? SCY : s_cy) * (SCX > 0 ? SCX : s_cx);
  const int cols = kPlanes * n_samp;

  // The first unit of this block that may hold a live pair.
  int u = blockIdx.x;
  while (u < st.n_units && !unit_may_be_live(st, u)) u += gridDim.x;
  int buf = 0;
  if (u < st.n_units) stage_unit(s_stage, st, u);

  while (u < st.n_units) {
    unsigned* sm = s_stage + buf * kStageWords;
    cp_async_wait_all();
    // The one block barrier a unit: the staged rows are visible, and every
    // warp has left the other stage, which the next copies overwrite.
    __syncthreads();
    int u_next = u + gridDim.x;
    while (u_next < st.n_units && !unit_may_be_live(st, u_next)) {
      u_next += gridDim.x;
    }
    if (u_next < st.n_units) {
      stage_unit(s_stage + (buf ^ 1) * kStageWords, st, u_next);
    }
    // Lane l of warp w owns splat 32 w + l: it prepares it, and the warp
    // lists and evaluates the live pairs of its own 32 splats only, so
    // nothing below waits for another warp.
    prepare_unit<true>(sm, st, s_prm[6], s_prm[7]);
    __syncwarp();
    float* acc_band = acc + static_cast<long long>(st.band[u / st.nsub * st.band_stride])
        * st.nx * st.ny_pad * cols;
    const int span = tid < st.unit
        ? static_cast<int>(sm[rSpan * kUnit + tid]) : 0;
    const int max_span = warp_max(span);
    for (int s0 = 0; s0 < max_span; s0 += kRoundSlots) {
      // List: each lane walks its splat's slots [s0, s0 + 8), and a warp
      // scan places the live ones.
      unsigned bits = 0u;
      SlotWalk walk;
      const int s_end = min(span, s0 + kRoundSlots);
      if (s0 < s_end) {
        walk.start(sm, tid, s0);
        for (int s = s0; s < s_end && walk.in_rows(); ++s, walk.next()) {
          if (walk.live(s_cut, st.nx)) bits |= 1u << (s - s0);
        }
      }
      const int cnt = __popc(bits);
      int incl = cnt;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int n_live = __shfl_sync(0xffffffffu, incl, 31);
      if (bits != 0u) {
        int pos = incl - cnt;
        walk.start(sm, tid, s0);
        for (; bits != 0u; bits >>= 1, walk.next()) {
          if (bits & 1u) {
            w_list[pos++] = tid | (walk.tx() << 9) | (walk.ty() << 20);
          }
        }
      }
      __syncwarp();
      // Evaluate: one lane a listed pair.
      for (int k = lane; k < n_live; k += 32) {
        pair_samples<SCY, SCX>(sm, w_list, k, s_prm, s_cy, s_cx, exact_clip,
                               w_count, w_hits, st.ny_pad, acc_band);
      }
      __syncwarp();
      // Add: one lane a queued covered sample.
      const int n_hits = min(*w_count, kWarpHits);
      __syncwarp();
      if (lane == 0) *w_count = 0;
      for (int h = lane; h < n_hits; h += 32) {
        const int2 hit = w_hits[h];
        add_planes(sm, w_list[hit.x & 0xff], hit.x >> 8,
                   __int_as_float(hit.y), n_samp, st.ny_pad, acc_band);
      }
      __syncwarp();
    }
    u = u_next;
    buf ^= 1;
  }
}

template <int SCY, int SCX>
int launch(const Stream& st, const void* cut, int n_cut, const void* params,
           void* acc, int s_cy, int s_cx, int exact_clip,
           cudaStream_t stream) {
  // Blocks resident on the card at this kernel's shared memory and
  // registers: asked once.
  static int resident = 0;
  const int bytes = kSharedWords * 4;
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        tail_kernel<SCY, SCX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tail_kernel<SCY, SCX>, kThreads, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (sms <= 0 || per_sm <= 0) {
      return static_cast<int>(cudaErrorLaunchOutOfResources);
    }
    resident = sms * per_sm;
  }
  const int blocks = st.n_units < resident ? st.n_units : resident;
  tail_kernel<SCY, SCX><<<blocks, kThreads, bytes, stream>>>(
      st, static_cast<const int*>(cut), n_cut,
      static_cast<const float*>(params), static_cast<float*>(acc), s_cy, s_cx,
      exact_clip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fields (10, npts) f32; meta (6, npts) i32; band, slot_mask (steps,) i32
// with strides in elements (slot_mask may be null); cut (n_cut <= 2048,)
// i32; params (8,) f32; acc (k_bands * nx * ny_pad, 6 * n_samp) f32, added
// into.
extern "C" int fourdgs_tail_accumulate(
    const void* fields, const void* meta, const void* band,
    const void* slot_mask, const void* cut, const void* params, void* acc,
    int npts, int steps, int chunk, int budget, int budget_lo, int nx,
    int ny_pad, int s_cx, int n_samp, int k_bands, int exact_clip,
    int band_stride, int mask_stride, int n_cut, void* stream) {
  Stream st;
  if (n_cut < 0 || n_cut > kCutEntries
      || !fill_stream(&st, fields, meta, band, slot_mask, band_stride,
                      mask_stride, npts, steps, chunk, budget, budget_lo, nx,
                      ny_pad, s_cx, n_samp, k_bands)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int s_cy = n_samp / s_cx;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (s_cy == 1 && s_cx == 8) {
    return launch<1, 8>(st, cut, n_cut, params, acc, s_cy, s_cx, exact_clip,
                        cs);
  }
  if (s_cy == 2 && s_cx == 16) {
    return launch<2, 16>(st, cut, n_cut, params, acc, s_cy, s_cx, exact_clip,
                         cs);
  }
  return launch<0, 0>(st, cut, n_cut, params, acc, s_cy, s_cx, exact_clip,
                      cs);
}
