// Register rounds of the bitonic merge, shared by K11 (fourdgs_merge_tree)
// and K13 (fourdgs_merge_finish) in merge.cu.
//
// A block of kThreads threads owns a tile of kTile consecutive (key, value)
// pairs; each thread holds kElems of them in registers. A layout LO
// (0 <= LO <= kMaxLo) puts the tile's index bits LO .. LO + 3 on the
// register index j and the other ten on the thread index t:
//
//   i(t, j) = ((t >> LO) << (LO + 4)) | (j << LO) | (t & (2^LO - 1)).
//
// A compare-exchange stage at distance 2^s with LO <= s <= LO + 3 pairs
// registers j and j | 2^(s - LO) of one thread, so a round of up to four
// consecutive stages runs in registers with no barrier. Between rounds a
// transpose through shared memory (one 8-byte store and one 8-byte load a
// pair) moves the tile to the next round's layout. Shared memory holds pair
// i at swizzle(i) = i ^ ((i >> 4) & 15): in every layout the 16 lanes of a
// half-warp then hit 16 distinct 8-byte bank pairs, so no transpose has a
// bank conflict.
//
// A transpose needs one barrier, between its stores and its loads: a
// thread stores its pairs to the places it loaded them from in the last
// transpose, which no other thread reads. In the layouts LO <= kWarpLo a
// warp holds 512 consecutive pairs (its lanes and registers cover the index
// bits 0-8), so a transpose between two of them stays inside the warp and
// its barrier is __syncwarp.
//
// The stage order is the network's own: a level of distances 2^m ... 1 takes
// rounds from the top, LO = m - 3, m - 7, ... and a last round at LO = 0
// for the bits left; every layout is a template argument, so a level is
// straight-line code. Every compare-exchange is strict, so equal keys never
// move and the result equals the stage-by-stage network bit for bit. The
// direction of a pair's run is folded into its key: for a level whose run
// is descending the keys are complemented (~k reverses the int32 order
// exactly) before its first stage and restored after its last, so every
// stage swaps iff the upper key is less.

#pragma once

#include <cuda_runtime.h>

namespace merge_rounds {

constexpr int kThreads = 1024;
constexpr int kRegBits = 4;
constexpr int kElems = 1 << kRegBits;             // pairs a thread holds
constexpr int kTileBits = 14;
constexpr int kTile = 1 << kTileBits;             // pairs a block holds
constexpr int kMaxLo = kTileBits - kRegBits;      // the highest layout
constexpr int kWarpLo = 5;                        // the highest warp-private
constexpr int kDead = 0x7fffffff;

__host__ __device__ constexpr int swizzle(int i) {
  return i ^ ((i >> 4) & 15);
}

// Index in the tile of thread t's register 0 in layout LO.
template <int LO>
__device__ __forceinline__ int layout_base(int t) {
  return ((t >> LO) << (LO + kRegBits)) | (t & ((1 << LO) - 1));
}

// The layout a level of distances 2^m ... 1 starts in.
__host__ __device__ constexpr int first_layout(int m) {
  return m > kRegBits - 1 ? m - (kRegBits - 1) : 0;
}

// Since swizzle is linear over XOR and the two parts of i(t, j) share no
// bit, a pair's place is swizzle(layout_base) ^ swizzle(j << LO), the
// second a constant.
template <int LO>
__device__ __forceinline__ void put(int2* s, const int (&k)[kElems],
                                    const int (&v)[kElems], int t) {
  const int p = swizzle(layout_base<LO>(t));
#pragma unroll
  for (int j = 0; j < kElems; ++j) {
    s[p ^ swizzle(j << LO)] = make_int2(k[j], v[j]);
  }
}

template <int LO>
__device__ __forceinline__ void get(const int2* s, int (&k)[kElems],
                                    int (&v)[kElems], int t) {
  const int p = swizzle(layout_base<LO>(t));
#pragma unroll
  for (int j = 0; j < kElems; ++j) {
    const int2 kv = s[p ^ swizzle(j << LO)];
    k[j] = kv.x;
    v[j] = kv.y;
  }
}

// The tile from layout FROM to layout TO through shared memory.
template <int FROM, int TO>
__device__ __forceinline__ void transpose(int2* s, int (&k)[kElems],
                                          int (&v)[kElems], int t) {
  put<FROM>(s, k, v, t);
  if constexpr (FROM <= kWarpLo && TO <= kWarpLo) {
    __syncwarp();
  } else {
    __syncthreads();
  }
  get<TO>(s, k, v, t);
}

// One stage on the register bit H: registers j and j | H, ascending.
template <int H>
__device__ __forceinline__ void reg_stage(int (&k)[kElems],
                                          int (&v)[kElems]) {
#pragma unroll
  for (int j = 0; j < kElems; ++j) {
    if ((j & H) == 0) {
      const int ka = k[j], kb = k[j | H];
      const int va = v[j], vb = v[j | H];
      const bool swap = kb < ka;              // strict: ties never move
      k[j] = swap ? kb : ka;
      k[j | H] = swap ? ka : kb;
      v[j] = swap ? vb : va;
      v[j | H] = swap ? va : vb;
    }
  }
}

// The stages on register bits N - 1 ... 0, in that order.
template <int N>
__device__ __forceinline__ void run_round(int (&k)[kElems],
                                          int (&v)[kElems]) {
  if constexpr (N > 3) reg_stage<8>(k, v);
  if constexpr (N > 2) reg_stage<4>(k, v);
  if constexpr (N > 1) reg_stage<2>(k, v);
  reg_stage<1>(k, v);
}

// The stages 2^TOP ... 1 of a level on the tile held in layout LO.
template <int TOP, int LO>
__device__ __forceinline__ void rounds_from(int2* s, int (&k)[kElems],
                                            int (&v)[kElems], int t) {
  constexpr int kWant = first_layout(TOP);
  if constexpr (kWant != LO) transpose<LO, kWant>(s, k, v, t);
  run_round<TOP - kWant + 1>(k, v);
  if constexpr (kWant > 0) rounds_from<kWant - 1, kWant>(s, k, v, t);
}

// Which runs of a level are descending: none (shift < 0, uniform 0), all of
// the tile's (shift < 0, uniform -1), or those whose tile index has bit
// `shift` set.
struct Direction {
  int shift;
  int uniform;
};

// Level with runs of 2^run_shift pairs, in tile number `tile`; odd runs
// descend when `alternate`.
__device__ __forceinline__ Direction level_direction(unsigned tile,
                                                     int run_shift,
                                                     bool alternate) {
  if (!alternate) return {-1, 0};
  if (run_shift >= kTileBits) {
    return {-1, -static_cast<int>((tile >> (run_shift - kTileBits)) & 1)};
  }
  return {run_shift, 0};
}

// Complement the keys of the pairs whose run descends (self-inverse).
template <int LO>
__device__ __forceinline__ void flip_descending(int (&k)[kElems], int t,
                                                Direction d) {
  if (d.shift < 0) {
#pragma unroll
    for (int j = 0; j < kElems; ++j) k[j] ^= d.uniform;
    return;
  }
  const int i0 = layout_base<LO>(t);
#pragma unroll
  for (int j = 0; j < kElems; ++j) {
    k[j] ^= -(((i0 | (j << LO)) >> d.shift) & 1);
  }
}

// The stages 2^M ... 1 of one level on the tile held in layout FROM; the
// tile ends in layout 0.
template <int M, int FROM>
__device__ __forceinline__ void run_level(int2* s, int (&k)[kElems],
                                          int (&v)[kElems], int t,
                                          Direction dir) {
  flip_descending<FROM>(k, t, dir);
  rounds_from<M, FROM>(s, k, v, t);
  flip_descending<0>(k, t, dir);
}

// Load the tile's pairs in layout LO from the tile's arrays, of which the
// first `limit` pairs lie inside the array (DEAD past them). With
// `flip_rows`, a row of 2^c_shift pairs is read back to front where
// odd_rows | the index's bit c_shift (the row's parity) is 1.
template <int LO>
__device__ __forceinline__ void load(const int* tk, const int* tv,
                                     int (&k)[kElems], int (&v)[kElems],
                                     int t, int limit, bool flip_rows,
                                     int c_shift, int odd_rows) {
  const int i0 = layout_base<LO>(t);
#pragma unroll
  for (int j = 0; j < kElems; ++j) {
    int i = i0 | (j << LO);
    if (flip_rows && (odd_rows | ((i >> c_shift) & 1))) {
      i ^= (1 << c_shift) - 1;
    }
    const bool in = i < limit;
    k[j] = in ? tk[i] : kDead;
    v[j] = in ? tv[i] : 0;
  }
}

// Store the tile from layout 0: a warp-private transpose to layout
// kWarpLo, whose lanes take consecutive pairs, then one coalesced store a
// register of the keys and of the values (of the first `limit` pairs).
__device__ __forceinline__ void store(int2* s, int* tk, int* tv,
                                      int (&k)[kElems], int (&v)[kElems],
                                      int t, int limit) {
  transpose<0, kWarpLo>(s, k, v, t);
  const int i0 = layout_base<kWarpLo>(t);
#pragma unroll
  for (int j = 0; j < kElems; ++j) {
    const int i = i0 | (j << kWarpLo);
    if (i < limit) {
      tk[i] = k[j];
      tv[i] = v[j];
    }
  }
}

// Pairs of tile number `tile` that lie inside an array of `total` pairs.
__device__ __forceinline__ int tile_limit(unsigned tile, long long total) {
  const long long left = total - static_cast<long long>(tile) * kTile;
  return left < kTile ? static_cast<int>(left) : kTile;
}

}  // namespace merge_rounds

// A switch over a run-time value 0 ... 13 (a level's m, or a layout) that
// calls CALL(constant).
#define MERGE_ROUNDS_SWITCH14(x, CALL) \
  switch (x) {                         \
    case 0: CALL(0); break;            \
    case 1: CALL(1); break;            \
    case 2: CALL(2); break;            \
    case 3: CALL(3); break;            \
    case 4: CALL(4); break;            \
    case 5: CALL(5); break;            \
    case 6: CALL(6); break;            \
    case 7: CALL(7); break;            \
    case 8: CALL(8); break;            \
    case 9: CALL(9); break;            \
    case 10: CALL(10); break;          \
    case 11: CALL(11); break;          \
    case 12: CALL(12); break;          \
    default: CALL(13); break;          \
  }
