// Per-tile ordered front-to-back alpha compositing: kernel K1 of the port.
//
// Replaces fourdgs/ops/composite_pallas.py `_composite_kernel`, reached
// through `_composite_pallas_raw` (composite_pallas.py:283-325, batched by
// `_squeeze_kernel`) and `_composite_pallas_at_raw` (:614-663, the in-place
// deepening pass). One thread block composites one tile of P pixels:
//
//   records (Tb, F, M) f32, rows sx, sy, v0x, v0y, il0, il1, r, g, b, a_eff
//   counts (Tb,) i32; kx, ky (T, P) pixel coords in k units;
//   carry / out (T, 8, P): rows r, g, b, a (sum alpha^2 T), T, 0, 0, 0.
//
// With `sel` (Tb,) i32, block b composites records[b] into tile sel[b]; the
// carry may alias the output (each thread reads its pixels' carry before it
// writes them), which is the reference's in-place deepening pass. `sel`
// entries are distinct; fillers have count 0 and write the carry back.
//
// Semantics kept exactly from the reference:
//   * alpha = min(cover ? a_eff * w : 0, 1 - 1e-6), cover = |n0| <= 0.5 and
//     |n1| <= 0.5 and w >= 1e-4, w = exp(-0.5 * 64 (n0^2 + n1^2));
//   * row 3 accumulates alpha * wgt = alpha^2 T;
//   * early exit is tile-wide and per 128-record chunk: chunk c runs only
//     if c < ceil(n / 128) and the tile's max T is above 1e-6. The deepening
//     selection reads that T, so a per-pixel exit would change it.
// The blend walks each chunk sequentially (GL's arithmetic): the exclusive
// transmittance is T_chunk_start * prod_{j<i}(1 - alpha_j), with the running
// product restarted at 1 per chunk, as the reference's per-chunk scan does;
// the per-chunk sums are added to the carry at the chunk's end. The file is
// built with -fmad=false so every operation rounds as the plain PyTorch
// version's does: a contracted multiply-add can flip the w >= 1e-4 or
// |n| <= 0.5 coverage tests at their boundaries.
//
// Bound on the H100: arithmetic and the exp of each covered (record,
// pixel) pair — at the 10M-splat frame ~0.8 G pairs in the first pass, of
// which most fail the quad test before the exp. Design: 256 threads own
// P / 256 pixels each in registers; a chunk of records is staged once in
// shared memory (10 x 128 x 4 B) and read as warp-wide broadcasts; the quad
// test precedes the exp. Work per block follows the tile's depth, so the
// grid is left unbalanced; splitting deep tiles is left to later changes.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;
constexpr int kFields = 10;
constexpr int kThreads = 256;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
composite_kernel(const float* __restrict__ rec, const int* __restrict__ counts,
                 const int* __restrict__ sel, const float* __restrict__ kx,
                 const float* __restrict__ ky, const float* carry, float* out,
                 int f_stride, int m) {
  constexpr int P = PPT * kThreads;
  __shared__ float s_rec[kFields][kChunk];
  const int b = blockIdx.x;
  const int tile = sel != nullptr ? sel[b] : b;
  const int n = counts[b];
  int n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > m / kChunk) n_chunks = m / kChunk;
  const float alpha_max = static_cast<float>(1.0 - 1e-6);

  const float* rec_b = rec + static_cast<long long>(b) * f_stride * m;
  const float* carry_t = carry + static_cast<long long>(tile) * 8 * P;
  float* out_t = out + static_cast<long long>(tile) * 8 * P;

  float px[PPT], py[PPT], acc_r[PPT], acc_g[PPT], acc_b[PPT], acc_a[PPT],
      trans[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = threadIdx.x + j * kThreads;
    px[j] = kx[static_cast<long long>(tile) * P + p];
    py[j] = ky[static_cast<long long>(tile) * P + p];
    acc_r[j] = carry_t[0 * P + p];
    acc_g[j] = carry_t[1 * P + p];
    acc_b[j] = carry_t[2 * P + p];
    acc_a[j] = carry_t[3 * P + p];
    trans[j] = carry_t[4 * P + p];
  }

  for (int c = 0;; ++c) {
    int open = 0;
#pragma unroll
    for (int j = 0; j < PPT; ++j) open |= trans[j] > 1e-6f;
    // Block-uniform exit test (every thread reaches the barrier).
    if (!__syncthreads_or(open) || c >= n_chunks) break;

    for (int i = threadIdx.x; i < kFields * kChunk; i += kThreads) {
      const int f = i / kChunk;
      const int k = i - f * kChunk;
      s_rec[f][k] = rec_b[static_cast<long long>(f) * m + c * kChunk + k];
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      float cp = 1.0f;
      float sr = 0.0f, sg = 0.0f, sb = 0.0f, sa = 0.0f;
      for (int k = 0; k < kChunk; ++k) {
        const float dx = px[j] - s_rec[0][k];
        const float dy = py[j] - s_rec[1][k];
        const float v0x = s_rec[2][k];
        const float v0y = s_rec[3][k];
        const float n0 = (v0x * dx + v0y * dy) * s_rec[4][k];
        const float n1 = (v0y * dx - v0x * dy) * s_rec[5][k];
        if (!(fabsf(n0) <= 0.5f && fabsf(n1) <= 0.5f)) continue;
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
    __syncthreads();   // the next chunk overwrites s_rec
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = threadIdx.x + j * kThreads;
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

template <int PPT>
int launch(const float* rec, const int* counts, const int* sel,
           const float* kx, const float* ky, const float* carry, float* out,
           int n_blocks, int f_stride, int m, cudaStream_t stream) {
  composite_kernel<PPT><<<n_blocks, kThreads, 0, stream>>>(
      rec, counts, sel, kx, ky, carry, out, f_stride, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rec: (n_blocks, f_stride, m) f32, f_stride >= 10, m a multiple of 128;
// counts, sel: (n_blocks,) i32 (sel may be null: block b is tile b);
// kx, ky: (T, p) f32; carry, out: (T, 8, p) f32, may alias. p is one of
// 256, 512, 1024, 2048, 4096.
extern "C" int fourdgs_composite(const void* rec, const void* counts,
                                 const void* sel, const void* kx,
                                 const void* ky, const void* carry, void* out,
                                 int n_blocks, int f_stride, int m, int p,
                                 void* stream) {
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
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 256: return launch<1>(r, cn, sl, x, y, ci, o, n_blocks, f_stride, m, st);
    case 512: return launch<2>(r, cn, sl, x, y, ci, o, n_blocks, f_stride, m, st);
    case 1024: return launch<4>(r, cn, sl, x, y, ci, o, n_blocks, f_stride, m, st);
    case 2048: return launch<8>(r, cn, sl, x, y, ci, o, n_blocks, f_stride, m, st);
    case 4096: return launch<16>(r, cn, sl, x, y, ci, o, n_blocks, f_stride, m, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
