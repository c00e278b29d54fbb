// The quantized binning's pair-slot emission: kernel K16 of the port.
//
// K16 `fourdgs_emit_pair_keys` replaces no Pallas kernel. The reference
// leaves this pass to XLA, which fuses the tile bbox, the band clip, the
// slot walk and the depth keys of its quantized binning into elementwise
// passes (fourdgs/render/tiles.py:184-252, :345-400). The port's plain
// version of the same composition (fourdgs_torch/render/tiles.py,
// `quantized_pair_keys_plain`: splat_tile_bbox, clip_to_tile_row_band,
// _emit_pair_slots, quantized_depth_bits, _pair_keys and the big tier's
// gather and concatenations) runs as some 480 PyTorch launches a band at
// 1920x1088, about 13 a pair slot, each reading and writing (N,)
// intermediates in device memory.
//
// One launch covers one tier of one band. The main launch takes every
// splat: it reads the 7 float32 fields the bbox and the depth bits need (mx
// my depth v0x v0y l0 l1) and `valid`, and writes the splat's `budget` pair
// slots, slot-major (slot s of splat i at s * n + i: the layout K2's strided
// rows and K3's 8-row granules read), a key and a splat index each, and with
// the big tier its is-big byte: 29 + 8 * budget + 1 bytes a splat, 0.62 GB
// at the 10,010,624-splat frame at budget 4, 0.185 ms at 3.35 TB/s. Bound
// on the H100: memory bandwidth. The big-tier launch takes the big tier's
// ids (a few thousand) and writes their slots after the main tier's, in the
// same arrays. A thread takes 4 consecutive entries; in the main launch every
// field is read and every slot written with one 16-byte access (a warp moves
// 512 contiguous bytes a slot), unless a base is off 16 bytes or n % 4 != 0,
// where the same thread moves word by word. The overflow count is reduced in
// the block and added with one atomic a block. p00 and p11 are read from
// device memory where they are tensors there, so nothing is copied from the
// host.
//
// Every operation is the plain version's on the card, in its order, in
// float32: IEEE division and square root, a clamp that passes NaN through,
// a division by a host number as PyTorch's CUDA kernels take it (the
// product with its float32 reciprocal). Built with -fmad=false (no product
// is contracted into a fused multiply-add), so every key, splat index, flag
// and count equals the plain version's on the card bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;            // entries a thread
constexpr int kFields = 7;           // float32 fields read
constexpr int kDepthBits = 20;       // render.tiles.QUANT_DEPTH_BITS
constexpr int kDead = 0x7fffffff;    // ops.sort_cuda.DEAD

// The plain version's Python constants, rounded to float32 as PyTorch
// rounds a host number for a float32 operation (from the double).
constexpr float kRCover = static_cast<float>(0.5371);  // R_COVER
constexpr float kMinDepth = static_cast<float>(1e-30);

struct Fields {
  const float* f[kFields];
  const unsigned char* valid;   // null in the big-tier launch
  const int* ids;               // the big tier's ids; null in the main one
};

struct Grid {
  float width, height;          // the image, pixels
  float inv_tile_w, inv_tile_h; // float32 reciprocals of the tile size
  int nx, ny;                   // the image's tile grid
  int ty_base, band_rows;       // the band of tile rows binned
  int lo, n_local;              // the window of band tile ids kept
  int budget;                   // slots an entry
};

struct Out {
  int* key;                     // slot s of entry e at s * m + e
  int* splat_idx;
  unsigned char* is_big;        // the main launch with the big tier, or null
  int* overflowed;              // added to, or null
};

// torch.clamp(v, min=lo): NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.clamp(v, lo, hi) of a float tensor with host numbers.
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.minimum: NaN if either is.
__device__ __forceinline__ float minimum(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// splat_tile_bbox's tile_of: clamp(floor(v / size), 0, hi).to(int32).
__device__ __forceinline__ int tile_of(float v, float inv_size, int hi) {
  return static_cast<int>(clamp(floorf(v * inv_size), 0.0f,
                                static_cast<float>(hi)));
}

struct Box {
  bool alive;
  int tx0, ty0, nx_span, ny_span, span, dbits;
};

// One splat: render.project.Projected.half_extent_ndc, splat_tile_bbox,
// clip_to_tile_row_band and quantized_depth_bits, op for op.
__device__ __forceinline__ Box splat_box(const float (&f)[kFields],
                                         bool valid, float p00, float p11,
                                         const Grid& g) {
  const float mx = f[0], my = f[1], depth = f[2];
  const float v0x = f[3], v0y = f[4], l0 = f[5], l1 = f[6];
  // half_extent_ndc.
  const float ax = fabsf(v0x), ay = fabsf(v0y);
  const float qx = 0.5f * (ax * l0 + ay * l1);
  const float qy = 0.5f * (ay * l0 + ax * l1);
  const float a = v0x * l0, b = v0y * l1, c = v0y * l0, d = v0x * l1;
  const float ex = kRCover * sqrtf(a * a + b * b);
  const float ey = kRCover * sqrtf(c * c + d * d);
  const float hx_ndc = minimum(qx, ex) * p00;
  const float hy_ndc = minimum(qy, ey) * p11;
  // splat_tile_bbox.
  const float cx = (mx + 1.0f) * 0.5f * g.width;
  const float cy = (1.0f - my) * 0.5f * g.height;
  const float hx = hx_ndc * 0.5f * g.width;
  const float hy = hy_ndc * 0.5f * g.height;
  const int tx0 = tile_of(cx - hx, g.inv_tile_w, g.nx - 1);
  const int tx1 = tile_of(cx + hx, g.inv_tile_w, g.nx - 1);
  int ty0 = tile_of(cy - hy, g.inv_tile_h, g.ny - 1);
  int ty1 = tile_of(cy + hy, g.inv_tile_h, g.ny - 1);
  const bool on_screen = (cx + hx >= 0.0f) & (cx - hx <= g.width)
                         & (cy + hy >= 0.0f) & (cy - hy <= g.height);
  // clip_to_tile_row_band; without a band the band is the whole grid,
  // where the clip changes nothing.
  const bool in_band =
      (ty1 >= g.ty_base) & (ty0 < g.ty_base + g.band_rows);
  ty0 = min(max(ty0 - g.ty_base, 0), g.band_rows - 1);
  ty1 = min(max(ty1 - g.ty_base, 0), g.band_rows - 1);
  // quantized_depth_bits: the top 20 bits of 1 / depth's float32 pattern.
  const float dist = 1.0f / clamp_min(depth, kMinDepth);
  const int dbits =
      min(max(__float_as_int(dist) >> (32 - kDepthBits), 0),
          (1 << kDepthBits) - 1);
  Box box;
  box.alive = valid & on_screen & in_band;
  box.tx0 = tx0;
  box.ty0 = ty0;
  box.nx_span = tx1 - tx0 + 1;
  box.ny_span = ty1 - ty0 + 1;
  box.span = box.nx_span * box.ny_span;
  box.dbits = dbits;
  return box;
}

// _emit_pair_slots' walk and _pair_keys for one entry: slot s's key (DEAD
// where the slot is dead), then the walk's step to slot s + 1 (sx, sy).
// Without a window the window is every tile of the band, where no live
// slot lies outside it.
__device__ __forceinline__ int slot_key(const Box& box, bool live, int s,
                                        int& sx, int& sy, const Grid& g) {
  const int tid = (box.ty0 + sy) * g.nx + (box.tx0 + sx);
  const bool on = live & (s < box.span) & (sy < box.ny_span)
                  & (tid >= g.lo) & (tid < g.lo + g.n_local);
  sx = sx + 1;
  if (sx >= box.nx_span) {
    sx = 0;
    sy = sy + 1;
  }
  return on ? (tid << kDepthBits) | box.dbits : kDead;
}

// One warp's partial count reduced, then one atomic a block.
__device__ __forceinline__ void add_count(int count, int* total) {
  __shared__ int warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, off);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += warp_sums[w];
    if (sum != 0) atomicAdd(total, sum);
  }
}

__global__ void __launch_bounds__(kThreads)
emit_pair_keys_kernel(Fields in, const float* __restrict__ p00_ptr,
                      const float* __restrict__ p11_ptr, float p00_value,
                      float p11_value, Grid g, int n, int m, bool vector,
                      Out out) {
  const float p00 = p00_ptr != nullptr ? *p00_ptr : p00_value;
  const float p11 = p11_ptr != nullptr ? *p11_ptr : p11_value;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const long long e0 = t * kGroup;
  const bool big_tier = in.ids != nullptr;
  int count = 0;
  if (e0 < m) {
    const bool full = vector && e0 + kGroup <= m;
    float f[kGroup][kFields];
    bool live[kGroup];
    int sid[kGroup];
    if (big_tier) {
      // The big tier: entry e is the id ids[e], DEAD where the capacity
      // slot is empty; its fields come from splat min(id, n - 1).
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int id = e0 + j < m ? in.ids[e0 + j] : kDead;
        live[j] = id != kDead;
        sid[j] = min(id, n - 1);
#pragma unroll
        for (int k = 0; k < kFields; ++k) f[j][k] = in.f[k][sid[j]];
      }
    } else if (full) {
#pragma unroll
      for (int k = 0; k < kFields; ++k) {
        const float4 v = reinterpret_cast<const float4*>(in.f[k])[t];
        f[0][k] = v.x;
        f[1][k] = v.y;
        f[2][k] = v.z;
        f[3][k] = v.w;
      }
      const uchar4 v = reinterpret_cast<const uchar4*>(in.valid)[t];
      live[0] = v.x != 0;
      live[1] = v.y != 0;
      live[2] = v.z != 0;
      live[3] = v.w != 0;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) sid[j] = static_cast<int>(e0) + j;
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const bool in_range = e0 + j < m;
#pragma unroll
        for (int k = 0; k < kFields; ++k) {
          f[j][k] = in_range ? in.f[k][e0 + j] : 1.0f;
        }
        live[j] = in_range && in.valid[e0 + j] != 0;
        sid[j] = static_cast<int>(e0) + j;
      }
    }

    Box box[kGroup];
    bool slots_live[kGroup];
    unsigned char big[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      box[j] = splat_box(f[j], live[j], p00, p11, g);
      // The main tier: a live splat whose span passes the budget goes to
      // the big tier where there is one, and overflows where there is not.
      // The big tier: an entry is live where its id is.
      const bool alive = big_tier ? live[j] : box[j].alive;
      const bool over = alive & (box[j].span > g.budget);
      big[j] = !big_tier & (out.is_big != nullptr) & over;
      slots_live[j] = alive & !big[j];
      count += slots_live[j] & over;
    }

    int sx[kGroup] = {0, 0, 0, 0}, sy[kGroup] = {0, 0, 0, 0};
    for (int s = 0; s < g.budget; ++s) {
      int key[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        key[j] = slot_key(box[j], slots_live[j], s, sx[j], sy[j], g);
      }
      const long long row = static_cast<long long>(s) * m;
      if (full) {
        reinterpret_cast<int4*>(out.key + row)[t] =
            make_int4(key[0], key[1], key[2], key[3]);
        reinterpret_cast<int4*>(out.splat_idx + row)[t] =
            make_int4(sid[0], sid[1], sid[2], sid[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (e0 + j < m) {
            out.key[row + e0 + j] = key[j];
            out.splat_idx[row + e0 + j] = sid[j];
          }
        }
      }
    }
    if (out.is_big != nullptr) {
      if (full) {
        reinterpret_cast<uchar4*>(out.is_big)[t] =
            make_uchar4(big[0], big[1], big[2], big[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (e0 + j < m) out.is_big[e0 + j] = big[j];
        }
      }
    }
  }
  if (out.overflowed != nullptr) add_count(count, out.overflowed);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Inputs: the 7 (n,) float32 fields in the order above; valid, (n,) bytes
// (0 or 1), in the main launch (ids null); the big tier's (m,) int32 ids in
// the big-tier launch (valid unread); p00 and p11 at p00_ptr / p11_ptr (a
// float32 on the device each) or, where a pointer is null, the value; the
// image (width, height), the tile (tile_h, tile_w), its grid (nx, ny), the
// band (ty_base, band_rows) and the window of band tile ids (lo, n_local).
// Outputs: key and splat_idx, (budget * m,) int32 each, slot-major; is_big,
// (n,) bytes, written by a main launch where it is not null (the big tier
// takes the splats whose span passes the budget); overflowed, one int32
// that the launch's overflowing entries are added to where it is not null.
extern "C" int fourdgs_emit_pair_keys(
    const void* mx, const void* my, const void* depth, const void* v0x,
    const void* v0y, const void* l0, const void* l1, const void* valid,
    const void* ids, const void* p00_ptr, const void* p11_ptr, float p00,
    float p11, int width, int height, int tile_h, int tile_w, int nx, int ny,
    int ty_base, int band_rows, int lo, int n_local, int budget, int n,
    int m, void* key, void* splat_idx, void* is_big, void* overflowed,
    void* stream) {
  if (m < 0 || budget < 0 || tile_h <= 0 || tile_w <= 0
      || (ids == nullptr && m != n) || (ids != nullptr && is_big != nullptr)
      || (ids != nullptr && m > 0 && n <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  const void* f[kFields] = {mx, my, depth, v0x, v0y, l0, l1};
  Fields in;
  bool vector = m % kGroup == 0 && aligned16(key) && aligned16(splat_idx);
  for (int k = 0; k < kFields; ++k) {
    in.f[k] = static_cast<const float*>(f[k]);
    vector = vector && (ids != nullptr || aligned16(f[k]));
  }
  in.valid = static_cast<const unsigned char*>(valid);
  in.ids = static_cast<const int*>(ids);
  vector = vector && (ids != nullptr
                      || reinterpret_cast<std::uintptr_t>(valid) % 4 == 0)
           && reinterpret_cast<std::uintptr_t>(is_big) % 4 == 0;
  Grid g;
  g.width = static_cast<float>(width);
  g.height = static_cast<float>(height);
  g.inv_tile_w = 1.0f / static_cast<float>(tile_w);
  g.inv_tile_h = 1.0f / static_cast<float>(tile_h);
  g.nx = nx;
  g.ny = ny;
  g.ty_base = ty_base;
  g.band_rows = band_rows;
  g.lo = lo;
  g.n_local = n_local;
  g.budget = budget;
  Out out;
  out.key = static_cast<int*>(key);
  out.splat_idx = static_cast<int*>(splat_idx);
  out.is_big = static_cast<unsigned char*>(is_big);
  out.overflowed = static_cast<int*>(overflowed);
  const long long groups = (static_cast<long long>(m) + kGroup - 1) / kGroup;
  const int blocks = static_cast<int>((groups + kThreads - 1) / kThreads);
  emit_pair_keys_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const float*>(p00_ptr),
      static_cast<const float*>(p11_ptr), p00, p11, g, n, m, vector, out);
  return static_cast<int>(cudaGetLastError());
}
