"""Tile binning (port of fourdgs/render/tiles.py).

Each projected splat's footprint selects a rectangle of image tiles; every
splat emits a fixed budget of (tile, splat) pair slots. Two orderings:

* exact (the default, `quantized_depth=False`): `proj` is already in
  front-to-back order (render/sort.front_to_back_order), so one sort of the
  pairs by (tile id, splat index) leaves every tile's list depth-ordered;
* quantized (`quantized_depth=True`, the 10M+ fast path): a pair's sort key
  packs (tile_id << 20) | top-20-bits-of-float(distance), so one sort of the
  keys yields tile-major, front-to-back order. Images of 2047 tiles or more
  are binned one band of tile rows at a time (`tile_row_band`, driven by
  render/pipeline.py), each band with band-relative tile ids. With
  `pallas_sort` the compacted rows are stitched by the bitonic merge kernels
  (K11-K13) instead of one global sort, and a depth prune that is not fused
  into the rowsort kernel runs as its own pass (K10).

Either way the per-tile ranges (CSR offsets) come from a left bisect of the
sorted pairs. A sharded render bins only its rank's window of tiles
(`tile_range`, parallel/distributed.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from fourdgs_torch import resolve_device
from fourdgs_torch.ops.lookup_cuda import apply_cutkeys, sample_blocks
from fourdgs_torch.ops.sort_cuda import (DEAD, merge_sorted_rows,
                                         rowsort_compact)
from fourdgs_torch.render.project import Projected

TILE_H = 32
TILE_W = 32
QUANT_DEPTH_BITS = 20
COMPACT_ROW_LEN = 8192      # row width of the plain compaction sort
TILE_LIMIT = (1 << 11) - 1  # the quantized key's 11-bit tile-id budget


def tile_grid(width: int, height: int, tile_h: int = TILE_H,
              tile_w: int = TILE_W):
    """Number of tiles (ny, nx) covering a width x height image."""
    return (-(-height // tile_h), -(-width // tile_w))


@dataclasses.dataclass(frozen=True)
class TileBinning:
    """Sorted (tile, splat) pair lists + CSR offsets (the reference's field
    names; all int32 tensors).

    pair_splat:  (P,) splat index per pair, sorted by (tile, depth)
    pair_tile:   (P,) tile id per pair (num_tiles for dead slots)
    tile_start:  (T+1,) CSR offsets into the pair arrays
    overflowed:  () splats whose bbox exceeded the pair budget
    compact_dropped: () live pairs lost to the compaction cap (or None)
    prune_underkeep: () pruned tiles left with fewer pairs than the cap
    tile_pruned: (T,) bool, tiles whose list the depth prune cut
    prune_cut:   (T,) per-tile prune cut keys; with head_cap, the head/tail
                 boundary (the tail takes exactly the pairs with key > cut)
    head_counts: (T,) head pairs per tile under the post-sort re-cut (only
                 with head_cap)
    big_ids:     kept big-tier splat ids (DEAD for empty capacity slots)
    """
    pair_splat: torch.Tensor
    pair_tile: torch.Tensor
    tile_start: torch.Tensor
    overflowed: torch.Tensor
    compact_dropped: Optional[torch.Tensor] = None
    prune_underkeep: Optional[torch.Tensor] = None
    tile_pruned: Optional[torch.Tensor] = None
    prune_cut: Optional[torch.Tensor] = None
    head_counts: Optional[torch.Tensor] = None
    big_ids: Optional[torch.Tensor] = None


def _sort_kv(key: torch.Tensor, val: torch.Tensor, dim: int = -1):
    """Unstable ascending sort of key, carrying val (the reference's
    `lax.sort((key, val), num_keys=1, is_stable=False)`)."""
    ks, order = torch.sort(key, dim=dim)
    return ks, torch.gather(val, dim, order)


def compact_pairs(key: torch.Tensor, val: torch.Tensor, dead: int,
                  keep_cols: int, rows: Optional[int] = None,
                  alternating: bool = False, flat: bool = True):
    """Shrink a mostly-dead pair array: sort `rows` strided logical rows
    (element i of row r is key[i * rows + r]) and keep each row's first
    keep_cols. Returns (key_kept, val_kept, dropped), rows-major and flat,
    or (rows, keep_cols) with flat=False; dropped counts live pairs lost to
    the cap. With `alternating`, odd rows come out reversed (descending),
    the layout merge_sorted_rows takes without reading rows back to
    front."""
    s = key.shape[0]
    if rows is None:
        rows = -(-s // COMPACT_ROW_LEN)
    row_len = -(-s // rows)
    pad = rows * row_len - s
    if pad:
        key = torch.cat([key, key.new_full((pad,), dead)])
        val = torch.cat([val, val.new_zeros((pad,))])
    ks, vs = _sort_kv(key.reshape(row_len, rows).T,
                      val.reshape(row_len, rows).T, dim=1)
    if keep_cols >= row_len:
        cpad = keep_cols - row_len
        dropped = torch.zeros((), dtype=torch.int32, device=key.device)
        ks = torch.cat([ks, ks.new_full((rows, cpad), dead)], dim=1)
        vs = torch.cat([vs, vs.new_zeros((rows, cpad))], dim=1)
    else:
        dropped = (ks[:, keep_cols:] != dead).sum(dtype=torch.int32)
        ks = ks[:, :keep_cols]
        vs = vs[:, :keep_cols]
    if alternating and rows > 1:
        def alt(x):
            x3 = x.reshape(rows // 2, 2, keep_cols)
            return torch.stack([x3[:, 0], x3[:, 1].flip(1)],
                               dim=1).reshape(rows, keep_cols)
        ks, vs = alt(ks), alt(vs)
    if flat:
        return ks.reshape(-1), vs.reshape(-1), dropped
    return ks, vs, dropped


def compact_flag_ids(flag: torch.Tensor, blk: int = 1024,
                     hot_cap: int = 1024, keep: int = 24):
    """Indices of a SPARSE bool flag by hot-block two-level extraction: find
    the flagged `blk`-blocks, gather at most hot_cap of them, compact those.
    Returns (ids, dropped): ids holds (hot_cap * blk // COMPACT_ROW_LEN *
    keep) int32 slots (DEAD where empty); flagged ids beyond capacity count
    in `dropped`. Requires flag.shape[0] % blk == 0."""
    n = flag.shape[0]
    if n % blk:
        raise ValueError(f"flag length {n} is not a multiple of {blk}")
    dev = flag.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    fkey = torch.where(flag, iota, DEAD)
    nb = n // blk
    hot = flag.reshape(nb, blk).any(dim=1)
    hot_cap = min(nb, hot_cap)
    hkey = torch.where(hot, torch.arange(nb, dtype=torch.int32, device=dev),
                       DEAD)
    sel = torch.sort(hkey).values[:hot_cap]
    miss = sel == DEAD
    starts = torch.clamp(sel, max=nb - 1).long() * blk
    seg = fkey[starts[:, None] + torch.arange(blk, device=dev)]
    seg = torch.where(miss[:, None], DEAD, seg).reshape(-1)
    ids, _, dropped = compact_pairs(seg, seg, DEAD, keep)
    # Flagged ids in blocks past hot_cap were never gathered: loud.
    dropped = dropped + (flag.sum(dtype=torch.int32)
                         - (seg != DEAD).sum(dtype=torch.int32))
    return ids, dropped


def clip_to_tile_row_band(alive, ty0, ty1, tile_row_band):
    """Restrict per-splat tile bboxes to the tile rows [ty_base, ty_base +
    ny) of a band and re-express them in band coordinates. Returns (alive,
    ty0, ty1, ny); the binning and the tail share it, so the tail's tile
    ids match the band-relative cut table."""
    ty_base, ny = tile_row_band
    alive = alive & (ty1 >= ty_base) & (ty0 < ty_base + ny)
    ty0 = torch.clamp(ty0 - ty_base, 0, ny - 1)
    ty1 = torch.clamp(ty1 - ty_base, 0, ny - 1)
    return alive, ty0, ty1, ny


def splat_tile_bbox(proj: Projected, p00, p11, width: int, height: int,
                    tile_h: int, tile_w: int):
    """Per-splat tile-space bbox + liveness: (alive, tx0, tx1, ty0, ty1)."""
    ny, nx = tile_grid(width, height, tile_h, tile_w)
    hx_ndc, hy_ndc = proj.half_extent_ndc(p00, p11)
    cx = (proj.mx + 1.0) * 0.5 * width       # pixels
    cy = (1.0 - proj.my) * 0.5 * height      # row 0 = top
    hx = hx_ndc * 0.5 * width
    hy = hy_ndc * 0.5 * height

    def tile_of(v, size, hi):
        return torch.clamp(torch.floor(v / size), 0, hi).to(torch.int32)

    tx0 = tile_of(cx - hx, tile_w, nx - 1)
    tx1 = tile_of(cx + hx, tile_w, nx - 1)
    ty0 = tile_of(cy - hy, tile_h, ny - 1)
    ty1 = tile_of(cy + hy, tile_h, ny - 1)
    on_screen = ((cx + hx >= 0) & (cx - hx <= width) &
                 (cy + hy >= 0) & (cy - hy <= height))
    return proj.valid & on_screen, tx0, tx1, ty0, ty1


def _emit_pair_slots(alive, tx0, tx1, ty0, ty1, nx: int, num_tiles: int,
                     max_tiles_per_splat: int, splat_ids=None,
                     tile_range: Optional[Tuple[int, int]] = None):
    """Fixed-budget (tile, splat) pair emission, slot-major.

    Returns (tids, lives, splat_idx, overflowed): per-slot lists of (N,)
    tile ids (num_tiles for dead) and live masks, the concatenated (S*N,)
    splat index array, and the count of splats whose bbox exceeded the
    budget. `splat_ids` overrides the emitted splat indices. With
    tile_range = (lo, n_local) a slot is live only on a tile of the window
    lo <= tid < lo + n_local."""
    n = alive.shape[0]
    nx_span = tx1 - tx0 + 1
    ny_span = ty1 - ty0 + 1
    span = nx_span * ny_span
    overflowed = ((span > max_tiles_per_splat) & alive).sum(
        dtype=torch.int32)
    idx1 = (torch.arange(n, dtype=torch.int32, device=alive.device)
            if splat_ids is None else splat_ids.to(torch.int32))
    sx = torch.zeros_like(tx0)
    sy = torch.zeros_like(ty0)
    tids, lives = [], []
    for s in range(max_tiles_per_splat):
        live_s = alive & (s < span) & (sy < ny_span)
        tid_s = (ty0 + sy) * nx + (tx0 + sx)
        if tile_range is not None:
            lo, n_local = tile_range
            live_s = live_s & (tid_s >= lo) & (tid_s < lo + n_local)
        tids.append(torch.where(live_s, tid_s, num_tiles))
        lives.append(live_s)
        if s + 1 < max_tiles_per_splat:
            sx = sx + 1
            wrap = sx >= nx_span
            sx = torch.where(wrap, 0, sx)
            sy = torch.where(wrap, sy + 1, sy)
    splat_idx = idx1.repeat(max_tiles_per_splat)
    return tids, lives, splat_idx, overflowed


def quantized_depth_bits(depth: torch.Tensor) -> torch.Tensor:
    """Top QUANT_DEPTH_BITS of the positive-float distance (= 1/depth key):
    positive-float bit patterns are integer-monotone."""
    dist = 1.0 / torch.clamp(depth, min=1e-30)
    dbits = dist.view(torch.int32) >> (32 - QUANT_DEPTH_BITS)
    return torch.clamp(dbits, 0, (1 << QUANT_DEPTH_BITS) - 1)


def _pair_keys(tids, lives, dbits):
    return torch.cat([torch.where(live_s, (tid_s << QUANT_DEPTH_BITS) | dbits,
                                  DEAD)
                      for tid_s, live_s in zip(tids, lives)])


def quantized_pair_keys(proj: Projected, p00, p11, width: int, height: int,
                        tile_h: int, tile_w: int, max_tiles_per_splat: int,
                        big_splat_budget: int = 0,
                        big_splat_keep_cols: int = 128,
                        tile_row_band: Optional[Tuple[int, int]] = None,
                        tile_range: Optional[Tuple[int, int]] = None):
    """Emit the quantized pair-slot keys, before pruning and sorting.

    Returns (key, splat_idx, overflowed, big_ids): (S,) int32 keys (DEAD for
    empty slots) and splat indices, the pair-budget overflow count, and the
    kept big-tier ids (None without the two-tier emission). With
    big_splat_budget, splats whose bbox spans more than max_tiles_per_splat
    tiles are compacted into a fixed-capacity id list and re-emitted with
    big_splat_budget slots; spans beyond even that, and big splats past the
    capacity, count into `overflowed`. With tile_row_band = (ty_base, ny),
    only tile rows [ty_base, ty_base + ny) are binned, with tile ids
    relative to the band; with tile_range = (lo, n_local) only pairs on the
    tiles of that window are live (_emit_pair_slots)."""
    ny, nx = tile_grid(width, height, tile_h, tile_w)
    alive, tx0, tx1, ty0, ty1 = splat_tile_bbox(proj, p00, p11, width,
                                                height, tile_h, tile_w)
    if tile_row_band is not None:
        alive, ty0, ty1, ny = clip_to_tile_row_band(alive, ty0, ty1,
                                                    tile_row_band)
    num_tiles = ny * nx
    if num_tiles >= TILE_LIMIT:
        raise ValueError(
            f"{num_tiles} tiles in one binning: the quantized key holds "
            f"fewer than {TILE_LIMIT}; bin the image in tile-row bands "
            "(tile_row_band, as render_projected does)")
    two_tier = bool(big_splat_budget)
    if two_tier:
        if big_splat_budget <= max_tiles_per_splat:
            raise ValueError("big_splat_budget must exceed "
                             "max_tiles_per_splat")
        span = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
        is_big = alive & (span > max_tiles_per_splat)
        alive1 = alive & ~is_big
    else:
        alive1 = alive
    tids, lives, splat_idx, overflowed = _emit_pair_slots(
        alive1, tx0, tx1, ty0, ty1, nx, num_tiles, max_tiles_per_splat,
        tile_range=tile_range)
    dbits = quantized_depth_bits(proj.depth)
    key = _pair_keys(tids, lives, dbits)
    if not two_tier:
        return key, splat_idx, overflowed, None

    n = alive.shape[0]
    if n % 1024 == 0 and n >= 128 * 1024:
        ids, big_dropped = compact_flag_ids(is_big)
    else:
        bk0 = torch.where(is_big, torch.arange(n, dtype=torch.int32,
                                               device=alive.device), DEAD)
        ids, _, big_dropped = compact_pairs(bk0, bk0, DEAD,
                                            big_splat_keep_cols)
        ids, _, big_dropped2 = compact_pairs(ids, ids, DEAD,
                                             4 * big_splat_keep_cols)
        big_dropped = big_dropped + big_dropped2
    blive = ids != DEAD
    safe = torch.clamp(ids, max=n - 1).long()
    bfields = torch.stack([tx0, tx1, ty0, ty1, dbits, span])[:, safe]
    btx0, btx1, bty0, bty1, dbits_b, span_b = bfields
    tidsb, livesb, sidxb, _ = _emit_pair_slots(
        blive, btx0, btx1, bty0, bty1, nx, num_tiles, big_splat_budget,
        splat_ids=safe, tile_range=tile_range)
    key = torch.cat([key, _pair_keys(tidsb, livesb, dbits_b)])
    splat_idx = torch.cat([splat_idx, sidxb])
    # Span overflow counted only among KEPT big splats: one dropped by the
    # capacity cap is already in big_dropped.
    overflowed = ((blive & (span_b > big_splat_budget)).sum(dtype=torch.int32)
                  + big_dropped)
    return key, splat_idx, overflowed, ids


def exact_pairs(proj: Projected, p00, p11, width: int, height: int,
                tile_h: int, tile_w: int, max_tiles_per_splat: int,
                tile_row_band: Optional[Tuple[int, int]] = None,
                tile_range: Optional[Tuple[int, int]] = None):
    """The exact branch's sorted pairs: (pair_tile, pair_splat, overflowed);
    with tile_range only the window's pairs are live.

    The reference sorts the pairs on two keys, (tile id, splat index); here
    they are one int64 key, tile id << 32 | splat index, under one
    torch.sort. Dead slots carry tile id num_tiles and sort last. Every
    (tile, splat) pair is unique, so the order has no ties and equals the
    reference's exactly."""
    ny, nx = tile_grid(width, height, tile_h, tile_w)
    alive, tx0, tx1, ty0, ty1 = splat_tile_bbox(proj, p00, p11, width,
                                                height, tile_h, tile_w)
    if tile_row_band is not None:
        alive, ty0, ty1, ny = clip_to_tile_row_band(alive, ty0, ty1,
                                                    tile_row_band)
    with record_function("fourdgs::emit"):
        tids, _, splat_idx, overflowed = _emit_pair_slots(
            alive, tx0, tx1, ty0, ty1, nx, ny * nx, max_tiles_per_splat,
            tile_range=tile_range)
        key = (torch.cat(tids).to(torch.int64) << 32) | splat_idx.to(
            torch.int64)
    with record_function("fourdgs::global_sort"):
        key_s = torch.sort(key).values
    return ((key_s >> 32).to(torch.int32),
            (key_s & 0xFFFFFFFF).to(torch.int32), overflowed)


def bin_splats(proj: Projected, p00, p11, width: int, height: int,
               tile_h: int = TILE_H, tile_w: int = TILE_W,
               max_tiles_per_splat: int = 16,
               quantized_depth: bool = False,
               compact_keep_cols: int = 0,
               big_splat_budget: int = 0,
               big_splat_keep_cols: int = 128,
               pallas_sort: bool = False,
               pallas_compact: bool = False,
               compact_row_len: int = 8192,
               depth_prune_cap: int = 0,
               depth_prune_safety: float = 2.0,
               head_cap: int = 0,
               tile_row_band: Optional[Tuple[int, int]] = None,
               tile_range: Optional[Tuple[int, int]] = None
               ) -> TileBinning:
    """Build sorted (tile, splat) pairs.

    Exact (quantized_depth=False): `proj` must already be in front-to-back
    order; the pairs sort by (tile id, splat index) (exact_pairs), so a
    tile's list is depth-ordered. The quantized branch's options (prune,
    compaction, big tier, sort backend, head_cap) do not apply, and its
    fields of the result are None, as in the reference.

    Quantized: emit pair keys (quantized_pair_keys); estimate the per-tile
    depth-prune cut (depth_prune_cutkeys) and apply it, fused into the
    rowsort kernel (pallas_compact without pallas_sort) or as its own pass
    (apply_cutkeys, K10); compact the mostly-dead slot array; sort, with
    one unstable global sort or, with pallas_sort, by merging the compacted
    rows (merge_sorted_rows, K11-K13; needs a power-of-two
    compact_keep_cols >= 256); CSR offsets by bisection; with head_cap
    (tail mode), the post-sort head re-cut.
    tile_row_band = (ty_base, ny) bins only that band of tile rows, with
    band-relative tile ids and tile_start of ny * nx + 1 entries; a single
    binning holds fewer than 2047 tiles.
    tile_range = (lo, n_local), lo a Python int: bin only the window of
    tiles [lo, lo + n_local) (a sharded rank's), pairs elsewhere dead;
    tile_start has n_local + 1 entries, tile lo at index 0, and bounds past
    the image's last tile are clipped to it. Under a window there is no
    depth prune (and so no head re-cut), as in the reference.
    Ties within a (tile, 20-bit depth) bucket order arbitrarily, as in the
    reference.
    """
    ny, nx = tile_grid(width, height, tile_h, tile_w)
    if tile_row_band is not None:
        ny = tile_row_band[1]
    num_tiles = ny * nx
    if not quantized_depth:
        tid_s, splat_s, overflowed = exact_pairs(
            proj, p00, p11, width, height, tile_h, tile_w,
            max_tiles_per_splat, tile_row_band, tile_range)
        return TileBinning(pair_splat=splat_s, pair_tile=tid_s,
                           tile_start=searchsorted_i32(
                               tid_s, _csr_tiles(num_tiles, tile_range,
                                                 tid_s.device)),
                           overflowed=overflowed)
    if tile_range is not None:
        depth_prune_cap = 0
    fuse_cut = bool(depth_prune_cap and compact_keep_cols and pallas_compact
                    and not pallas_sort)
    with record_function("fourdgs::emit"):
        key, splat_idx, overflowed, big_ids = quantized_pair_keys(
            proj, p00, p11, width, height, tile_h, tile_w,
            max_tiles_per_splat, big_splat_budget, big_splat_keep_cols,
            tile_row_band, tile_range)
    dev = key.device

    prune_cut = None
    if depth_prune_cap:
        with record_function("fourdgs::depth_prune"):
            prune_cut = depth_prune_cutkeys(key, num_tiles, depth_prune_cap,
                                            safety=depth_prune_safety)
        if not fuse_cut:
            with record_function("fourdgs::apply_cutkeys"):
                key = apply_cutkeys(key, prune_cut)
    compact_dropped = None
    if compact_keep_cols and pallas_sort:
        # Compact into a power-of-two (rows x keep_cols) grid of
        # alternating rows, which the merge kernels stitch with no padding
        # beyond the reference's.
        if compact_keep_cols & (compact_keep_cols - 1):
            raise ValueError(f"pallas_sort needs a power-of-two "
                             f"compact_keep_cols, got {compact_keep_cols}")
        rows = 1 << max(0, int(round(math.log2(
            max(1.0, key.shape[0] / COMPACT_ROW_LEN)))))
        with record_function("fourdgs::compact_pairs"):
            k2, v2, compact_dropped = compact_pairs(
                key, splat_idx, DEAD, compact_keep_cols, rows=rows,
                alternating=True, flat=False)
        with record_function("fourdgs::merge_sorted_rows"):
            key_s, splat_s = merge_sorted_rows(k2, v2, rows_alternating=True)
    else:
        if compact_keep_cols and pallas_compact:
            with record_function("fourdgs::rowsort_compact"):
                ck, cv, compact_dropped = rowsort_compact(
                    key, splat_idx, compact_keep_cols,
                    row_len=compact_row_len,
                    cut=prune_cut if fuse_cut else None,
                    key_shift=QUANT_DEPTH_BITS)
            key, splat_idx = ck.reshape(-1), cv.reshape(-1)
        elif compact_keep_cols:
            with record_function("fourdgs::compact_pairs"):
                key, splat_idx, compact_dropped = compact_pairs(
                    key, splat_idx, DEAD, compact_keep_cols)
        with record_function("fourdgs::global_sort"):
            key_s, splat_s = _sort_kv(key, splat_idx)
    tid_s = torch.where(key_s == DEAD, num_tiles, key_s >> QUANT_DEPTH_BITS)
    tile_ids = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev)
    tile_start = searchsorted_i32(
        key_s, _csr_tiles(num_tiles, tile_range, dev) << QUANT_DEPTH_BITS)
    prune_underkeep = tile_pruned = head_counts = None
    if prune_cut is not None:
        # The prune's statistical guarantee, verified: every tile that was
        # actually pruned must still hold >= the composite cap.
        counts = tile_start[1:] - tile_start[:-1]
        t_max = ((tile_ids[:-1] + 1) << QUANT_DEPTH_BITS) - 1
        tile_pruned = prune_cut < t_max
        prune_underkeep = (tile_pruned & (counts < depth_prune_cap)).sum(
            dtype=torch.int32)
        if head_cap:
            # Post-sort re-cut (tail mode): the head keeps at most head_cap
            # nearest pairs per tile. In an overfull tile the cut is one
            # below the head_cap-th key, which pushes that key's whole tie
            # block to the tail; every pair beyond the cut, kept or pruned,
            # has key > prune_cut and belongs to the tail.
            starts = tile_start[:-1]
            last = starts + torch.clamp(counts, max=head_cap) - 1
            kcut = key_s[torch.clamp(last, min=0).long()]
            head_cut = torch.where(counts > head_cap, kcut - 1, kcut)
            head_cut = torch.where(counts > 0, head_cut, t_max)
            head_counts = searchsorted_i32(key_s, head_cut + 1) - starts
            prune_cut = head_cut
            tile_pruned = head_counts < counts
    return TileBinning(pair_splat=splat_s, pair_tile=tid_s,
                       tile_start=tile_start, overflowed=overflowed,
                       compact_dropped=compact_dropped,
                       prune_underkeep=prune_underkeep,
                       tile_pruned=tile_pruned, prune_cut=prune_cut,
                       head_counts=head_counts, big_ids=big_ids)


def _csr_tiles(num_tiles: int, tile_range, device) -> torch.Tensor:
    """The tile ids whose first pairs bound the CSR: 0 ... num_tiles, or
    lo ... lo + n_local under a window, clipped to num_tiles (dead keys
    sort last, so a bound past the image lands at the dead block)."""
    if tile_range is None:
        return torch.arange(num_tiles + 1, dtype=torch.int32, device=device)
    lo, n_local = tile_range
    return torch.clamp(lo + torch.arange(n_local + 1, dtype=torch.int32,
                                         device=device), max=num_tiles)


def depth_prune_cutkeys(key: torch.Tensor, num_tiles: int, cap: int,
                        stride: int = 67, safety: float = 2.0) -> torch.Tensor:
    """Per-tile depth cut keys: keep pair iff key <= cut[key >> 20].

    Estimates, per tile, the key of about the (cap * safety)-th nearest pair
    from a 1/stride sample of the keys: contiguous 256-slot blocks spread
    evenly over the array (sample_blocks, kernel K3) for large arrays, a
    plain strided slice for small ones. The stride is prime so the sample
    walks every residue class of the slot-major layout. Tiles with fewer
    sampled pairs than the rank keep everything (cut = the tile's maximal
    key). Returns (T,) int32."""
    blk = 256
    take_rows = blk // 128
    if key.shape[0] < stride * blk * 128 or key.shape[0] % 128:
        sample = key[::stride]
    else:
        sample, = sample_blocks([key], stride_rows=stride * take_rows,
                                take_rows=take_rows)
    ss = torch.sort(sample).values
    tile_ids = torch.arange(num_tiles + 1, dtype=torch.int32,
                            device=key.device)
    start = searchsorted_i32(ss, tile_ids << QUANT_DEPTH_BITS)   # (T+1,)
    r = start[:-1] + int(-(-cap * safety // stride))
    val = ss[torch.clamp(r, max=ss.shape[0] - 1).long()]
    keep_all = r >= start[1:]          # fewer sampled than the rank
    tile_max = (tile_ids[1:] << QUANT_DEPTH_BITS) - 1
    return torch.where(keep_all, tile_max, torch.minimum(val, tile_max))


def searchsorted_i32(sorted_arr: torch.Tensor,
                     queries: torch.Tensor) -> torch.Tensor:
    """Left-bisect positions of `queries` in 1-D `sorted_arr`, int32."""
    return torch.searchsorted(sorted_arr, queries, out_int32=True)


def tile_pixel_ndc(width: int, height: int, tile_h: int = TILE_H,
                   tile_w: int = TILE_W, device=None, dtype=torch.float32):
    """NDC coords of pixel centers for every tile: (px, py) of shape
    (T, tile_h * tile_w) with T = ny * nx, plus the (ny, nx) grid, on
    `device`, by default the card (fourdgs_torch.default_device). Padding
    tiles on the bottom/right get coordinates too; callers crop."""
    device = resolve_device(device)
    ny, nx = tile_grid(width, height, tile_h, tile_w)

    def ar(k):
        return torch.arange(k, dtype=torch.int32, device=device)
    gy = (ar(ny)[:, None, None, None] * tile_h
          + ar(tile_h)[None, None, :, None]).to(dtype)
    gx = (ar(nx)[None, :, None, None] * tile_w
          + ar(tile_w)[None, None, None, :]).to(dtype)
    px = (gx + 0.5) / width * 2.0 - 1.0
    py = 1.0 - (gy + 0.5) / height * 2.0
    shape = (ny, nx, tile_h, tile_w)
    px = torch.broadcast_to(px, shape).reshape(ny * nx, tile_h * tile_w)
    py = torch.broadcast_to(py, shape).reshape(ny * nx, tile_h * tile_w)
    return px, py, (ny, nx)


def assemble_image(tiles_rgba: torch.Tensor, width: int, height: int,
                   tile_h: int = TILE_H, tile_w: int = TILE_W) -> torch.Tensor:
    """(T, tile_h*tile_w, 4) tile buffers -> (H, W, 4) image (cropped)."""
    ny, nx = tile_grid(width, height, tile_h, tile_w)
    img = tiles_rgba.reshape(ny, nx, tile_h, tile_w, 4)
    img = img.permute(0, 2, 1, 3, 4).reshape(ny * tile_h, nx * tile_w, 4)
    return img[:height, :width]
