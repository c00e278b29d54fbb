// The unit walk shared by the tail accumulate (K7, tail.cu) and its backward
// (K9, tail_bwd.cu): both kernels take the stream apart the same way, so
// the pieces live here once.
//
// A unit is one 512-splat sub-block of one chunk (the slot mask's
// granularity; a chunk below 512 is one unit of its own size). Band and
// slot mask stay per chunk, g = unit / nsub. Persistent blocks stride over
// the units; per unit a block
//   * stages the unit's 16 rows (10 field rows, 6 meta rows) x 512 entries
//     in shared memory with 16-byte cp.async copies, into a two-stage ring:
//     the next unit's rows arrive while this one computes (`stage_unit`);
//   * prepares each splat once, in place (`prepare_unit`): the widening m0,
//     m1 = 1/sqrt(1 + c il^2) and, for the forward, il_w = il m sqrt(32) and
//     gate = a_eff m0 m1; the bbox packed into two words; a splat outside
//     the stream's span window (budget_lo, budget] gets span 0;
//   * walks a splat's slots without a division (`SlotWalk`): ox, oy step
//     with the slot, the row test ends the walk, the cut lookup reads the
//     2,048-entry table in shared memory.
// Every float operation is written in the plain PyTorch version's order and
// the files are built with -fmad=false, so m0, m1, il_w and gate carry the
// bits the plain version's do.

#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace tail_unit {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnit = 512;            // splats a unit holds at most
static_assert(kThreads == kUnit, "thread t owns splat t of its unit");
constexpr int kFieldRows = 10;
constexpr int kRows = 16;             // 10 field rows + 6 meta rows
constexpr int kStageWords = kRows * kUnit;
constexpr int kCutEntries = 2048;
constexpr int kPlanes = 6;
constexpr int kMaskBits = 30;
constexpr int kDepthBits = 20;
constexpr float kAlphaMax = static_cast<float>(1.0 - 1e-6);
constexpr float kQScale = static_cast<float>(5.656854249492381);   // sqrt 32
constexpr float kClip = static_cast<float>(0.5 * 5.656854249492381);

// Rows of a staged unit after prepare_unit. Rows 4, 5 and 9 hold il0w,
// il1w and gate when prepared for the forward (kFold), else the raw il0,
// il1 and a_eff.
constexpr int rSx = 0, rSy = 1, rV0x = 2, rV0y = 3, rIl0 = 4, rIl1 = 5;
constexpr int rCr = 6, rCg = 7, rCb = 8, rAeff = 9;
constexpr int rTxTy = 10;             // tx0 | ty0 << 16   (was tx0)
constexpr int rNxNy = 11;             // nxs | nrows << 16 (was tx1)
constexpr int rM0 = 12, rM1 = 13;     // float bits        (were ty0, ty1)
constexpr int rDbits = 14, rSpan = 15;

struct Stream {
  const float* fields;
  const int* meta;
  const int* band;        // band of chunk g at band[g * band_stride]
  const int* slot_mask;   // may be null; chunk g at [g * mask_stride]
  int band_stride, mask_stride;
  long long np;
  int unit;               // splats a unit, min(512, chunk)
  int nsub;               // units a chunk
  int n_units;
  int budget, budget_lo, nx, ny_pad, k_bands;
  int vec;                // rows are 16-byte aligned: cp.async, float4 stores
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

// The tile cuts into the 2,048-entry table in shared memory, padded with
// INT32_MAX (no pair of a tile past the table is live). Every thread of the
// block calls it; a barrier must follow before the table is read.
__device__ __forceinline__ void load_cut_table(int* s_cut, const int* cut,
                                               int n_cut) {
  for (int i = threadIdx.x; i < kCutEntries; i += kThreads) {
    s_cut[i] = i < n_cut ? cut[i] : INT_MAX;
  }
}

// Whether unit u can hold a live pair, by its chunk's band and slot mask
// (a superset of the live test: skipping on it is exact). Slots past the
// mask's 30 bits stay live.
__device__ __forceinline__ bool unit_may_be_live(const Stream& st, int u) {
  const int g = u / st.nsub;
  const int bnd = st.band[g * st.band_stride];
  if (bnd < 0 || bnd >= st.k_bands) return false;
  if (st.slot_mask == nullptr) return true;
  const int mask = st.slot_mask[g * st.mask_stride];
  const int j = u - g * st.nsub;
  for (int s = 0; s < st.budget; ++s) {
    if ((s + 1) * st.nsub > kMaskBits) return true;
    if ((mask >> (s * st.nsub + j)) & 1) return true;
  }
  return false;
}

// Start the copies of unit u's 16 rows into `dst` (row stride kUnit words)
// and commit them as one cp.async group.
__device__ __forceinline__ void stage_unit(unsigned* dst, const Stream& st,
                                           int u) {
  const long long p0 = static_cast<long long>(u) * st.unit;
  if (st.vec) {
    const int q = st.unit >> 2;               // 16-byte pieces a row
    for (int e = threadIdx.x; e < kRows * q; e += kThreads) {
      const int r = e / q;
      const int c = (e - r * q) << 2;
      const void* src = r < kFieldRows
          ? static_cast<const void*>(st.fields + r * st.np + p0 + c)
          : static_cast<const void*>(st.meta + (r - kFieldRows) * st.np
                                     + p0 + c);
      cp_async16(dst + r * kUnit + c, src);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * st.unit; e += kThreads) {
      const int r = e / st.unit;
      const int c = e - r * st.unit;
      dst[r * kUnit + c] = r < kFieldRows
          ? __float_as_uint(st.fields[r * st.np + p0 + c])
          : static_cast<unsigned>(st.meta[(r - kFieldRows) * st.np + p0 + c]);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) {
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// Prepare the staged unit in place, one splat a thread (thread t takes
// splat t: only it touches the splat's column here).
template <bool kFold>
__device__ __forceinline__ void prepare_unit(unsigned* sm, const Stream& st,
                                             float bx2, float by2) {
  const int i = threadIdx.x;
  if (i >= st.unit) return;
  const int span = static_cast<int>(sm[rSpan * kUnit + i]);
  if (!(span > st.budget_lo && span <= st.budget)) {
    sm[rSpan * kUnit + i] = 0u;
    return;
  }
  const int tx0 = static_cast<int>(sm[10 * kUnit + i]);
  const int tx1 = static_cast<int>(sm[11 * kUnit + i]);
  const int ty0 = static_cast<int>(sm[12 * kUnit + i]);
  const int ty1 = static_cast<int>(sm[13 * kUnit + i]);
  const float v0x = __uint_as_float(sm[rV0x * kUnit + i]);
  const float v0y = __uint_as_float(sm[rV0y * kUnit + i]);
  const float il0 = __uint_as_float(sm[rIl0 * kUnit + i]);
  const float il1 = __uint_as_float(sm[rIl1 * kUnit + i]);
  const float m0 = 1.0f / sqrtf(1.0f + (bx2 * (v0x * v0x)
                                        + by2 * (v0y * v0y)) * (il0 * il0));
  const float m1 = 1.0f / sqrtf(1.0f + (bx2 * (v0y * v0y)
                                        + by2 * (v0x * v0x)) * (il1 * il1));
  if (kFold) {
    const float a_eff = __uint_as_float(sm[rAeff * kUnit + i]);
    sm[rIl0 * kUnit + i] = __float_as_uint(il0 * m0 * kQScale);
    sm[rIl1 * kUnit + i] = __float_as_uint(il1 * m1 * kQScale);
    sm[rAeff * kUnit + i] = __float_as_uint(a_eff * (m0 * m1));
  }
  const int nxs = max(tx1 - tx0 + 1, 1);
  const int nrows = max(ty1 - ty0 + 1, 0);     // slot rows inside the bbox
  sm[rTxTy * kUnit + i] = static_cast<unsigned>(tx0 & 0xffff)
      | (static_cast<unsigned>(ty0 & 0xffff) << 16);
  sm[rNxNy * kUnit + i] = static_cast<unsigned>(min(nxs, 0xffff))
      | (static_cast<unsigned>(min(nrows, 0xffff)) << 16);
  sm[rM0 * kUnit + i] = __float_as_uint(m0);
  sm[rM1 * kUnit + i] = __float_as_uint(m1);
}

// The slots of one prepared splat, walked in order without a division per
// slot: slot s lies at tile (tx0 + ox, ty0 + oy), oy = s / nxs.
struct SlotWalk {
  int tx0, ty0, nxs, nrows, dbits, ox, oy;

  __device__ __forceinline__ void start(const unsigned* sm, int i, int s0) {
    const unsigned a = sm[rTxTy * kUnit + i];
    const unsigned b = sm[rNxNy * kUnit + i];
    tx0 = static_cast<int>(a & 0xffffu);
    ty0 = static_cast<int>(a >> 16);
    nxs = static_cast<int>(b & 0xffffu);
    nrows = static_cast<int>(b >> 16);
    dbits = static_cast<int>(sm[rDbits * kUnit + i]);
    oy = s0 == 0 ? 0 : s0 / nxs;
    ox = s0 - oy * nxs;
  }
  // False once the walk has left the bbox's rows: no later slot is live.
  __device__ __forceinline__ bool in_rows() const { return oy < nrows; }
  __device__ __forceinline__ int tx() const { return tx0 + ox; }
  __device__ __forceinline__ int ty() const { return ty0 + oy; }
  // The pair's key against its tile's cut.
  __device__ __forceinline__ bool live(const int* s_cut, int nx) const {
    const int t_id = ty() * nx + tx();
    const int key = (t_id << kDepthBits) | dbits;
    return key > s_cut[min(max(t_id, 0), kCutEntries - 1)];
  }
  __device__ __forceinline__ void next() {
    if (++ox == nxs) {
      ox = 0;
      ++oy;
    }
  }
};

// alpha of one coarse sample at k coordinates (kxs, kys) under a prepared
// splat: w = exp(-(n0^2 + n1^2)), coverage w >= 1e-4 and, with exact_clip,
// |n| <= 0.5 sqrt(32) m per axis. Returns false when the sample is not
// covered (alpha 0).
struct Sample {
  float dx, dy, e0, e1, n0, n1, w;

  __device__ __forceinline__ bool eval(float kxs, float kys, float sx,
                                       float sy, float v0x, float v0y,
                                       float il0w, float il1w, float clip0,
                                       float clip1, int exact_clip) {
    dx = kxs - sx;
    dy = kys - sy;
    e0 = v0x * dx + v0y * dy;
    e1 = v0y * dx - v0x * dy;
    n0 = e0 * il0w;
    n1 = e1 * il1w;
    w = expf(-(n0 * n0 + n1 * n1));
    bool cover = w >= 1e-4f;
    if (exact_clip) {
      cover = cover && fabsf(n0) <= clip0 && fabsf(n1) <= clip1;
    }
    return cover;
  }
};

// Validates what both entry points take and fills the stream's shape.
inline bool fill_stream(Stream* st, const void* fields, const void* meta,
                        const void* band, const void* slot_mask,
                        int band_stride, int mask_stride, int npts,
                        int steps, int chunk, int budget, int budget_lo,
                        int nx, int ny_pad, int s_cx, int n_samp,
                        int k_bands) {
  if (chunk <= 0 || steps <= 0
      || static_cast<long long>(steps) * chunk != npts || n_samp <= 0
      || s_cx <= 0 || n_samp % s_cx != 0 || budget <= 0 || nx <= 0
      || ny_pad <= 0 || nx > 0xffff || ny_pad > 0xffff || band_stride <= 0
      || mask_stride <= 0) {
    return false;
  }
  const int unit = chunk < kUnit ? chunk : kUnit;
  if (chunk % unit != 0) return false;
  st->fields = static_cast<const float*>(fields);
  st->meta = static_cast<const int*>(meta);
  st->band = static_cast<const int*>(band);
  st->slot_mask = static_cast<const int*>(slot_mask);
  st->band_stride = band_stride;
  st->mask_stride = mask_stride;
  st->np = npts;
  st->unit = unit;
  st->nsub = chunk / unit;
  st->n_units = steps * (chunk / unit);
  st->budget = budget;
  st->budget_lo = budget_lo;
  st->nx = nx;
  st->ny_pad = ny_pad;
  st->k_bands = k_bands;
  st->vec = unit % 4 == 0 && npts % 4 == 0
      && reinterpret_cast<unsigned long long>(fields) % 16 == 0
      && reinterpret_cast<unsigned long long>(meta) % 16 == 0;
  return true;
}

}  // namespace tail_unit
