"""The tiled render pipeline: project -> bin -> sort -> composite (port of
fourdgs/render/pipeline.py).

Two orderings, as in the reference:
* exact (`quantized_depth_sort=False`, the default): the splats are put in
  front-to-back order and the pairs sorted by (tile, splat index); the
  composite takes each tile's nearest `max_splats_per_tile` pairs, and with
  `backend="pallas"` progressive deepening may take more;
* quantized (the 10M+ fast path): the exact head with progressive deepening
  (`tail_mode="off"`) or, converged, one head pass plus the streaming
  banded-OIT tail over every other pair (`tail_mode="banded"`). An image of
  2047 tiles or more (4K at 16x128 tiles) renders as bands of tile rows,
  each band through the whole path with band-relative tile ids.
  `sort_backend="pallas"` sorts the pairs with the merge kernels (K11-K13)
  and applies the depth prune as its own pass (K10).

Two composite backends: `backend="pallas"` names the hand-written kernels
(here CUDA: K1, K8); `backend="xla"` is the reference's plain-array
compositor (`_composite_tiles_xla`), which here is plain PyTorch on whatever
device the splats are on. `RenderConfig` keeps every field name and default
of the reference, so a reference config converts with
`RenderConfig(**dataclasses.asdict(cfg))`.

The entry points are `render_splats4d`, `render_splats3d`, `render_splats2d`
(the dataclass splats of splats/gaussians.py) and `render_params4d_packed`
(the packed scalar-SoA parameters of splats/packed.py). Every one is
differentiable with respect to its splats: the composite (K1/K8), the tail
(K7/K9) and the record pack (K4) are autograd Functions with the
reference's VJPs, the xla backend is plain autograd, and the binning, meta
and bands are integers that carry no gradient, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from fourdgs_torch.core.camera import Camera
from fourdgs_torch.ops import tail_cuda as TL
from fourdgs_torch.ops.composite_cuda import (_F, N_FIELDS,
                                              composite_records,
                                              composite_records_at,
                                              identity_carry, pack_records,
                                              record_fields)
from fourdgs_torch.ops.lookup_cuda import sample_blocks
from fourdgs_torch.ops.sort_cuda import DEAD
from fourdgs_torch.render.project import (Projected, project_components,
                                          project_splats)
from fourdgs_torch.render.sort import front_to_back_order
from fourdgs_torch.render.tiles import (TILE_H, TILE_LIMIT, TILE_W,
                                        assemble_image, bin_splats,
                                        clip_to_tile_row_band,
                                        quantized_depth_bits,
                                        splat_tile_bbox, tile_grid,
                                        tile_pixel_ndc)
from fourdgs_torch.splats import packed as PK
from fourdgs_torch.splats.gaussians import (Splats2D, Splats3D, Splats4D,
                                            mean_in_time_sortkey)

ALPHA_MAX = 1.0 - 1e-6
# The range around each public render call: one a frame, never nested.
FRAME = "fourdgs::frame"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static pipeline configuration; field names and defaults are the
    reference's (fourdgs/render/pipeline.py documents each knob)."""
    tile_h: int = TILE_H
    tile_w: int = TILE_W
    max_tiles_per_splat: int = 16
    max_splats_per_tile: int = 1024
    splat_chunk: int = 64
    backend: str = "xla"
    background: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    quantized_depth_sort: bool = False
    sort_compact_keep_cols: int = 0
    big_splat_budget: int = 0
    big_splat_keep_cols: int = 128
    deepening_passes: int = 1
    deepening_fraction: float = 0.25
    deepening_schedule: Tuple[int, ...] = ()
    sort_backend: str = "xla"
    compact_backend: str = "xla"
    compact_row_len: int = 8192
    depth_prune_cap: int = 0
    depth_prune_safety: float = 2.0
    tail_mode: str = "off"
    tail_bands: int = 8
    tail_block: Tuple[int, int] = (8, 8)
    tail_chunk: int = 2048
    tail_depth_beta: float = 0.0
    tail_alpha_power: int = 0
    tail_exact_clip: bool = False


def _pad_pairs(pair_splat: torch.Tensor, m: int) -> torch.Tensor:
    """Append m dead entries so every window [start, start + m) is in range
    (tile_start <= P always)."""
    return torch.cat([pair_splat, pair_splat.new_zeros((m,))])


def _gather_pair_rows(pair_padded: torch.Tensor, starts: torch.Tensor,
                      m: int) -> torch.Tensor:
    """(T,) starts -> (T, m) contiguous windows of the sorted pair array."""
    idx = starts.long()[:, None] + torch.arange(m, device=starts.device)
    return pair_padded[idx]


def _gather_tile_lists(binning, cfg: RenderConfig):
    """Fixed-capacity per-tile splat lists from the CSR pair arrays:
    (tile_splat (T, M) int32, tile_live (T, M) bool), M =
    max_splats_per_tile. A tile of more than M pairs keeps its M nearest,
    the right direction of truncation for a front-to-back composite."""
    m = cfg.max_splats_per_tile
    starts = binning.tile_start[:-1]
    counts = binning.tile_start[1:] - starts
    tile_splat = _gather_pair_rows(_pad_pairs(binning.pair_splat, m),
                                   starts, m)
    live = torch.arange(m, device=starts.device)[None, :] < counts[:, None]
    return tile_splat, live


def _color_sum(wgt: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """sum_c wgt[t, c, p] rgb[t, c, :] -> (T, P, 3), as the reference's
    einsum: a batched matmul, float32 on the card while the caller leaves
    TF32 off for matmuls (PyTorch's default)."""
    return torch.einsum("tcp,tcd->tpd", wgt, rgb)


def _composite_tiles_xla(proj: Projected, tile_splat: torch.Tensor,
                         tile_live: torch.Tensor, px: torch.Tensor,
                         py: torch.Tensor, p00, p11,
                         background: torch.Tensor, chunk: int,
                         return_resid: bool = False):
    """The reference's plain-array per-tile ordered composite (its
    `backend="xla"`), in plain PyTorch: no kernel, on any device.

    tile_splat (T, M) indexes the proj fields; px, py (T, P) are the NDC
    pixel coordinates. A loop over M in chunks carries each pixel's running
    log-transmittance; within a chunk the ordered blend is an exclusive
    cumsum. Each chunk makes (T, chunk, P) temporaries, which autograd keeps
    for the backward. Returns the (T, P, 4) tiles, and with return_resid
    also the final transmittance (T, P)."""
    t_tiles, m = tile_splat.shape
    p = px.shape[1]
    dtype = px.dtype
    n_chunks = -(-m // chunk)
    pad = n_chunks * chunk - m
    if pad:
        tile_splat = torch.cat([tile_splat,
                                tile_splat.new_zeros((t_tiles, pad))], dim=1)
        tile_live = torch.cat([tile_live,
                               tile_live.new_zeros((t_tiles, pad))], dim=1)
    a_eff = proj.opacity * proj.a * proj.valid.to(dtype)
    rgb_acc = px.new_zeros((t_tiles, p, 3))
    a_acc = px.new_zeros((t_tiles, p))
    log_t = px.new_zeros((t_tiles, p))
    for c in range(n_chunks):
        sidx = tile_splat[:, c * chunk:(c + 1) * chunk].long()   # (T, C)
        live = tile_live[:, c * chunk:(c + 1) * chunk]

        def take(f):
            return f[sidx][..., None]                            # (T, C, 1)
        dx = (px[:, None, :] - take(proj.mx)) / p00              # (T, C, P)
        dy = (py[:, None, :] - take(proj.my)) / p11
        v0x, v0y = take(proj.v0x), take(proj.v0y)
        k0 = v0x * dx + v0y * dy
        k1 = v0y * dx - v0x * dy
        n0 = k0 / take(proj.l0)
        n1 = k1 / take(proj.l1)
        q = 64.0 * (n0 * n0 + n1 * n1)
        w = torch.exp(-0.5 * q)
        cover = (torch.abs(n0) <= 0.5) & (torch.abs(n1) <= 0.5) & (w >= 1e-4)
        gate = (cover & live[..., None]).to(dtype)
        alpha = torch.clamp(take(a_eff) * w * gate, 0.0, ALPHA_MAX)
        log1m = torch.log1p(-alpha)
        t_excl = torch.exp(log_t[:, None, :] + torch.cumsum(log1m, dim=1)
                           - log1m)
        wgt = alpha * t_excl
        rgb = torch.stack([proj.r[sidx], proj.g[sidx], proj.b[sidx]],
                          dim=-1)                                # (T, C, 3)
        rgb_acc = rgb_acc + _color_sum(wgt, rgb)
        a_acc = a_acc + (alpha * wgt).sum(dim=1)
        log_t = log_t + log1m.sum(dim=1)
    t_fin = torch.exp(log_t)
    rgb_acc = rgb_acc + t_fin[..., None] * background[:3]
    a_acc = a_acc + t_fin * background[3]
    tiles = torch.cat([rgb_acc, a_acc[..., None]], dim=-1)
    if return_resid:
        return tiles, t_fin
    return tiles


def render_projected(proj: Projected, camera: Camera,
                     cfg: RenderConfig = RenderConfig(),
                     p00=None, p11=None, return_aux: bool = False):
    """Tile-binned render of already-projected splats. Returns the (H, W, 4)
    image, or (image, aux) with return_aux: aux holds the binning health
    counters (pair-budget overflow, compaction drops, prune under-keep, live
    pairs, deepest tile) and the truncation residual, as 0-d tensors.

    p00 / p11 override the projection diagonal for a path whose pixel -> k
    mapping is not the camera's (the 2D screen-space scene)."""
    if cfg.backend not in ("xla", "pallas"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    if cfg.tail_mode not in ("off", "banded"):
        raise ValueError(f"unknown tail_mode {cfg.tail_mode!r}")
    # The projection matrix and the background are copied from host numbers
    # (the copy waits for the stream): each has a range, so the device's
    # idle while the host waits has a name.
    if p00 is None:
        with record_function("fourdgs::proj_matrix"):
            pmat = camera.proj_matrix()
            p00, p11 = pmat[0, 0], pmat[1, 1]
    w, h = camera.width, camera.height
    use_quant = cfg.quantized_depth_sort
    if not use_quant:
        with record_function("fourdgs::depth_order"):
            order = front_to_back_order(proj.depth)
            proj = proj.map(lambda a: a[order])
    # Tile-row banding: the quantized key packs an 11-bit tile id, so an
    # image of 2047 tiles or more renders as ceil-split bands of tile rows.
    ny0, nx0 = tile_grid(w, h, cfg.tile_h, cfg.tile_w)
    if use_quant and ny0 * nx0 >= TILE_LIMIT:
        rows_per_band = max(1, TILE_LIMIT // nx0)
        n_bands = -(-ny0 // rows_per_band)
    else:
        rows_per_band, n_bands = ny0, 1
    px, py, _ = tile_pixel_ndc(w, h, cfg.tile_h, cfg.tile_w,
                               device=proj.mx.device)
    with record_function("fourdgs::background"):
        bg = torch.tensor(cfg.background, dtype=proj.mx.dtype,
                          device=proj.mx.device)
    band_tiles, band_resid, binnings, band_max_pairs = [], [], [], []
    for b in range(n_bands):
        lo_row = b * rows_per_band
        nb = min(rows_per_band, ny0 - lo_row)
        band = None if n_bands == 1 else (lo_row, nb)
        # record_function ranges segment torch.profiler traces by stage.
        with record_function("fourdgs::bin_sort"):
            binning = bin_splats(
                proj, p00, p11, w, h, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                max_tiles_per_splat=cfg.max_tiles_per_splat,
                quantized_depth=use_quant,
                compact_keep_cols=cfg.sort_compact_keep_cols,
                big_splat_budget=cfg.big_splat_budget,
                big_splat_keep_cols=cfg.big_splat_keep_cols,
                pallas_sort=(cfg.sort_backend == "pallas"),
                pallas_compact=(cfg.compact_backend == "pallas"),
                compact_row_len=cfg.compact_row_len,
                depth_prune_cap=cfg.depth_prune_cap,
                depth_prune_safety=cfg.depth_prune_safety,
                head_cap=(cfg.max_splats_per_tile
                          if cfg.tail_mode == "banded" else 0),
                tile_row_band=band)
        px_b = px[lo_row * nx0:(lo_row + nb) * nx0]
        py_b = py[lo_row * nx0:(lo_row + nb) * nx0]
        counts = binning.tile_start[1:] - binning.tile_start[:-1]
        with record_function("fourdgs::composite"):
            if cfg.backend == "pallas":
                tiles, resid = _composite_pallas_progressive(
                    proj, binning, px_b, py_b, p00, p11, bg, cfg,
                    image_size=(w, h), tile_row_band=band)
            else:
                tile_splat, tile_live = _gather_tile_lists(binning, cfg)
                tiles, t_fin = _composite_tiles_xla(
                    proj, tile_splat, tile_live, px_b, py_b, p00, p11, bg,
                    cfg.splat_chunk, return_resid=True)
                truncated = counts > cfg.max_splats_per_tile
                if binning.tile_pruned is not None:
                    # Pairs dropped by the depth prune are truncation error
                    # too, even where the kept list fits the capacity.
                    truncated = truncated | binning.tile_pruned
                resid = t_fin.detach() * truncated[:, None]
        band_tiles.append(tiles)
        band_resid.append(resid.max())
        binnings.append(binning)
        band_max_pairs.append(counts.max())
    tiles = band_tiles[0] if n_bands == 1 else torch.cat(band_tiles)
    img = assemble_image(tiles, w, h, cfg.tile_h, cfg.tile_w)
    if not return_aux:
        return img
    aux: Dict[str, torch.Tensor] = {
        "overflowed": sum(b.overflowed for b in binnings),
        "live_pairs": sum(b.tile_start[-1] for b in binnings),
        "max_tile_pairs": torch.stack(band_max_pairs).max(),
        # Per-pixel bound on truncation error: the remaining transmittance
        # of any tile whose pair list was truncated (0 == exact w.r.t. the
        # per-tile capacity).
        "resid_transmittance": torch.stack(band_resid).max(),
    }
    if binnings[0].compact_dropped is not None:
        aux["compact_dropped"] = sum(b.compact_dropped for b in binnings)
    if binnings[0].prune_underkeep is not None:
        aux["prune_underkeep"] = sum(b.prune_underkeep for b in binnings)
    return img, aux


def _composite_pallas_progressive(proj: Projected, binning, px, py, p00, p11,
                                  background, cfg: RenderConfig,
                                  image_size=None, tile_row_band=None):
    """Progressive-deepening composite, or head plus banded tail.

    Pass 1 composites every tile's nearest `max_splats_per_tile` pairs. Each
    further pass selects up to round(deepening_fraction * T) (at least 128)
    tiles that are still unsaturated (max transmittance above 1e-6) and
    have pairs left, gathers their next depth slab and composites it into
    their carry in place. In tail mode (`tail_mode="banded"` with a prune
    cut) the head owns exactly binning.head_counts pairs per tile, which
    pass 1 composites whole; the banded tail (`_apply_banded_tail`, needs
    image_size = (w, h)) composites every other pair and there is no
    deepening. `binning`, `px` and `py` may be those of one band of tile
    rows (tile_row_band, handed on to the tail). Returns (tiles (T, P, 4),
    resid (T, P))."""
    m = cfg.max_splats_per_tile
    t_tiles, p = px.shape
    dev = px.device
    starts = binning.tile_start[:-1]
    counts_full = binning.tile_start[1:] - starts
    use_tail = cfg.tail_mode == "banded" and binning.prune_cut is not None
    if use_tail and binning.head_counts is not None:
        # The post-sort re-cut: the head owns exactly these nearest pairs.
        counts_full = binning.head_counts
    pair_pad = _pad_pairs(binning.pair_splat, m)
    kx = (px / p00).reshape(t_tiles, 1, p)
    ky = (py / p11).reshape(t_tiles, 1, p)
    if use_tail:
        # One record matrix serves the head gather and the tail's field
        # stream, padded to the tail-chunk multiple by the pack kernel (K4)
        # where the reference uses its pack kernel.
        npts = -(-proj.mx.shape[0] // cfg.tail_chunk) * cfg.tail_chunk
        rec_all = record_fields(proj, p00, p11,
                                pad_to=npts if npts % 1024 == 0 else None)
    else:
        rec_all = record_fields(proj, p00, p11)

    with record_function("fourdgs::pass1_pack"):
        rows0 = _gather_pair_rows(pair_pad, starts, m)
        live0 = torch.arange(m, device=dev)[None, :] < counts_full[:, None]
        rec0 = pack_records(proj, rows0, live0, p00, p11, rec=rec_all)
        pairs_done = torch.clamp(counts_full, max=m)
    with record_function("fourdgs::pass1_kernel"):
        out = composite_records(rec0, pairs_done.to(torch.int32), kx, ky,
                                identity_carry(t_tiles, p, device=dev))

    t_cap = min(t_tiles, max(128, int(round(t_tiles * cfg.deepening_fraction))))
    if use_tail:
        # The re-cut keeps head_counts <= max_splats_per_tile, so pass 1
        # composited the whole head (any violation shows in resid).
        if image_size is None:
            raise ValueError("tail mode needs image_size=(w, h)")
        with record_function("fourdgs::tail"):
            out = _apply_banded_tail(out, proj, binning, p00, p11, cfg,
                                     *image_size, rec_all, tile_row_band)
        schedule = ()
    else:
        schedule = cfg.deepening_schedule or (m,) * (cfg.deepening_passes - 1)
        if len(schedule) != cfg.deepening_passes - 1 or any(
                mi % 128 for mi in schedule):
            raise ValueError(f"bad deepening schedule {schedule} for "
                             f"{cfg.deepening_passes} passes")
    if schedule and max(schedule) > m:
        pair_pad = _pad_pairs(binning.pair_splat, max(schedule))
    if schedule and out.requires_grad:
        # composite_records saved `out` for its backward; the deepening
        # passes update the carry in place, so they get their own copy.
        out = out.clone()
    for mi in schedule:
        with record_function("fourdgs::deepen_select_pack"):
            remaining = counts_full - pairs_done
            unsat = out.detach()[:, 4, :].amax(dim=1) > 1e-6
            active = unsat & (remaining > 0)
            # Deterministic top-t_cap active tiles (inactive fillers are
            # no-ops: their live mask is empty and their counter does not
            # advance).
            order = torch.argsort(-active.to(torch.int32), stable=True)
            sel = order[:t_cap]
            act = active[sel]
            done_sel = pairs_done[sel]
            rows = _gather_pair_rows(pair_pad, starts[sel] + done_sel, mi)
            off = done_sel[:, None] + torch.arange(mi, device=dev)[None, :]
            live = act[:, None] & (off < counts_full[sel][:, None])
            rec = pack_records(proj, rows, live, p00, p11, rec=rec_all)
            cnt = torch.where(act,
                              torch.clamp(counts_full[sel] - done_sel, 0, mi),
                              0).to(torch.int32)
        with record_function("fourdgs::deepen_kernel"):
            out = composite_records_at(rec, cnt, sel, kx, ky, out)
        pairs_done = pairs_done.index_add(0, sel, cnt.to(pairs_done.dtype))

    rgb = out[:, 0:3, :] + out[:, 4:5, :] * background[:3, None]
    a = out[:, 3, :] + out[:, 4, :] * background[3]
    tiles = torch.cat([rgb, a[:, None, :]], dim=1).permute(0, 2, 1)
    truncated = (counts_full - pairs_done) > 0
    if binning.tile_pruned is not None and not use_tail:
        # Pairs dropped by the depth prune are truncation error too; with
        # the tail, pruned pairs are composited, not dropped.
        truncated = truncated | binning.tile_pruned
    return tiles, out.detach()[:, 4, :] * truncated[:, None]


def _apply_banded_tail(out, proj: Projected, binning, p00, p11,
                       cfg: RenderConfig, w: int, h: int, fields,
                       tile_row_band=None):
    """Composite every pair beyond the per-tile head cut into the (T, 8, P)
    head carry (before the background); `fields` is the (10, >=N) record
    matrix the head gathered from. Global depth-band cuts from a
    sample of the live depth bits, then the per-chunk prepass (K6) and the
    tail accumulate (K7) over the main stream and then over the big-tier
    ids, then fold the bands, upsample and blend under the head's
    transmittance. With tile_row_band = (ty_base, ny) the carry, the cut
    table and the tail grid are those of one band of tile rows. Returns the
    updated carry."""
    # The plain set-up: everything the tail computes before its kernels.
    with record_function("fourdgs::tail_setup"):
        ny, nx = tile_grid(w, h, cfg.tile_h, cfg.tile_w)
        alive, tx0, tx1, ty0, ty1 = splat_tile_bbox(proj, p00, p11, w, h,
                                                    cfg.tile_h, cfg.tile_w)
        ty_base = 0
        if tile_row_band is not None:
            # The binning's clip, so the tail's tile ids match the
            # band-relative cut table.
            ty_base = tile_row_band[0]
            alive, ty0, ty1, ny = clip_to_tile_row_band(alive, ty0, ty1,
                                                        tile_row_band)
        dbits = quantized_depth_bits(proj.depth)
        cut = binning.prune_cut
        k_bands = cfg.tail_bands

        # Band cuts from a block subsample (K3) at scale; the full array
        # below 16384 splats. The switch changes the sample and so the cuts.
        n = dbits.shape[0]
        db_live = torch.where(alive, dbits, DEAD)
        if n >= 16384 and n % 128 == 0:
            db_live, = sample_blocks([db_live], stride_rows=64, take_rows=1)
        band_cuts = TL.global_band_cuts(db_live, k_bands)

        by, bx = cfg.tail_block
        s_cy, s_cx = cfg.tile_h // by, cfg.tile_w // bx
        if s_cy * by != cfg.tile_h or s_cx * bx != cfg.tile_w:
            raise ValueError(f"tail_block {cfg.tail_block} does not divide "
                             f"the {cfg.tile_h}x{cfg.tile_w} tile")
        # The kernels' constants, copied from host numbers one by one: each
        # copy waits for the stream.
        with record_function("fourdgs::tail_params"):
            params_row = TL.tail_params_row(cfg.tile_h, cfg.tile_w,
                                            cfg.tail_block, w, h, p00, p11,
                                            ty_base)
    wd = dict(alpha_pow=cfg.tail_alpha_power, exact_clip=cfg.tail_exact_clip)
    chunk = cfg.tail_chunk
    budget = cfg.max_tiles_per_splat
    with record_function("fourdgs::tail_prepass"):
        meta = TL.tail_meta(alive, tx0, tx1, ty0, ty1, dbits, chunk)
        band, rect, slot_mask = TL.tail_prepass(meta, band_cuts, chunk,
                                                budget, k_bands=k_bands)
        coeffs = None
        if cfg.tail_depth_beta:
            # The within-band depth weight: per-band coefficients from the
            # band cuts and the sample's live depth extremes, gathered by
            # each chunk's band.
            d_lo, d_hi = TL.global_band_extremes(db_live)
            coeffs = TL.band_weight_coeffs(band_cuts, d_lo, d_hi, k_bands,
                                           cfg.tail_depth_beta)
    with record_function("fourdgs::tail_main"):
        acc = TL.tail_accumulate(fields, meta, band, rect, cut, params_row,
                                 k_bands=k_bands, nx=nx, ny=ny, chunk=chunk,
                                 budget=budget, s_cy=s_cy, s_cx=s_cx,
                                 slot_mask=slot_mask,
                                 wd_ab=_band_rows(coeffs, band), **wd)

    if binning.big_ids is not None:
        # The big tier: the kept wide-span splat ids re-walked with the big
        # budget window, exactly the head's big tier.
        with record_function("fourdgs::tail_big"):
            ids = binning.big_ids
            safe = torch.clamp(ids, max=n - 1).long()
            bfields = fields[:, safe]
            meta_b = torch.where((ids == DEAD)[None, :], 0, meta[:, safe])
            chunk_b = min(512, -(-ids.shape[0] // 8) * 8)
            npad = -(-ids.shape[0] // chunk_b) * chunk_b
            meta_b = F.pad(meta_b, (0, npad - ids.shape[0]))
            band_b, rect_b, mask_b = TL.tail_prepass(
                meta_b, band_cuts, chunk_b, cfg.big_splat_budget,
                budget_lo=budget, k_bands=k_bands)
            acc = acc + TL.tail_accumulate(
                bfields, meta_b, band_b, rect_b, cut, params_row,
                k_bands=k_bands, nx=nx, ny=ny, chunk=chunk_b,
                budget=cfg.big_splat_budget, s_cy=s_cy, s_cx=s_cx,
                budget_lo=budget, slot_mask=mask_b,
                wd_ab=_band_rows(coeffs, band_b), **wd)

    with record_function("fourdgs::tail_combine"):
        upt = TL.fold_upsample_tail(acc, k_bands, nx, ny, cfg.tile_h,
                                    cfg.tile_w, s_cy, s_cx)
        return torch.cat([TL.blend_tail_under_head(out, upt), out[:, 5:8]],
                         dim=1)


def _composite_pairrec_progressive(rec_pairs: torch.Tensor,
                                   tile_start: torch.Tensor, px, py, p00, p11,
                                   background, cfg: RenderConfig,
                                   head_counts=None,
                                   return_carry: bool = False):
    """Progressive slab composite straight from a tile-major sorted
    pair-record array rec_pairs (P, 10): a tile's records are contiguous,
    so every slab is a row slice and nothing is gathered by splat. The
    compositor of the all_to_all sharded path, whose exchange delivers
    records in pair order.

    Pass 1 composites every tile's first `max_splats_per_tile` records (K1);
    each of the deepening_passes - 1 further passes selects up to
    round(deepening_fraction * T) (at least 128) tiles still unsaturated
    with records left and composites their next slab into their carry in
    place (K1's `sel` form). head_counts (T,), the distributed tail mode's
    re-cut, replaces the CSR counts: the head owns exactly those records.
    Returns the (T, P, 4) tiles over `background`, or with return_carry the
    (T, 8, P) carry before it. Differentiable in rec_pairs (K8)."""
    m = cfg.max_splats_per_tile
    t_tiles, p = px.shape
    dev = px.device
    starts = tile_start[:-1]
    counts_full = tile_start[1:] - starts
    if head_counts is not None:
        counts_full = head_counts
    rec_pad = torch.cat([rec_pairs, rec_pairs.new_zeros((m, N_FIELDS))])
    kx = (px / p00).reshape(t_tiles, 1, p)
    ky = (py / p11).reshape(t_tiles, 1, p)
    arange_m = torch.arange(m, device=dev)

    def slab_recs(base, live):
        """(T_sel,) row starts -> (T_sel, 16, m) kernel records; `live`
        masks the bleed of the contiguous array into the next tile. A start
        past the array (an inactive filler tile's) is clamped, as the
        reference's dynamic_slice clamps it; its rows are all masked."""
        base = torch.clamp(base.long(), max=rec_pad.shape[0] - m)
        rows = rec_pad[base[:, None] + arange_m]                 # (T, m, NF)
        rows = rows * live[..., None].to(rows.dtype)
        rec = rows.permute(0, 2, 1)
        return F.pad(rec, (0, 0, 0, _F - N_FIELDS))

    live0 = arange_m[None, :] < counts_full[:, None]
    out = composite_records(slab_recs(starts, live0),
                            torch.clamp(counts_full, max=m).to(torch.int32),
                            kx, ky, identity_carry(t_tiles, p, device=dev))
    slab_done = torch.ones((t_tiles,), dtype=torch.int32, device=dev)
    t_cap = min(t_tiles, max(128, int(round(t_tiles * cfg.deepening_fraction))))
    if cfg.deepening_passes > 1 and out.requires_grad:
        # composite_records saved `out` for its backward; the deepening
        # passes update the carry in place, so they get their own copy.
        out = out.clone()
    for _ in range(1, cfg.deepening_passes):
        done = slab_done * m
        remaining = counts_full - done
        unsat = out.detach()[:, 4, :].amax(dim=1) > 1e-6
        active = unsat & (remaining > 0)
        order = torch.argsort(-active.to(torch.int32), stable=True)
        sel = order[:t_cap]
        act = active[sel]
        base = starts[sel] + done[sel]
        off = done[sel][:, None] + arange_m[None, :]
        live = act[:, None] & (off < counts_full[sel][:, None])
        cnt = torch.where(act, torch.clamp(counts_full[sel] - done[sel], 0, m),
                          0).to(torch.int32)
        out = composite_records_at(slab_recs(base, live), cnt, sel, kx, ky,
                                   out)
        slab_done = slab_done.index_add(0, sel, act.to(slab_done.dtype))
    if return_carry:
        return out
    rgb = out[:, 0:3, :] + out[:, 4:5, :] * background[:3, None]
    a = out[:, 3, :] + out[:, 4, :] * background[3]
    return torch.cat([rgb, a[:, None, :]], dim=1).permute(0, 2, 1)


def _band_rows(coeffs, band):
    """The chunks' rows (S, 2) of the per-band weight coefficients, or None
    without the depth weight."""
    return None if coeffs is None else coeffs[band.long()]


def project_params4d(params: Dict[str, torch.Tensor], camera: Camera,
                     t, min_opacity: float = 0.0) -> Projected:
    """Covariance construction, temporal slice and EWA projection of the
    packed parameter dict at time t (a Python float or a 0-d tensor)."""
    cov4 = PK.cov4_motion(params)
    mx, my, mz, cov3, opacity, sort_mean = PK.slice4d(params, cov4, t,
                                                      min_opacity)
    colors = (params["cr"], params["cg"], params["cb"], params["ca"])
    return project_components(mx, my, mz, cov3, colors, opacity, camera,
                              sort_mean=sort_mean)


def render_params4d_packed(params: Dict[str, torch.Tensor], camera: Camera,
                           t, min_opacity: float = 0.0,
                           cfg: RenderConfig = RenderConfig(),
                           return_aux: bool = False):
    """The flagship path on the packed scalar-SoA parameterization: `params`
    is a dict of (N,) float32 tensors (PARAM4D_FIELDS) on the camera's
    device."""
    with record_function(FRAME):
        with record_function("fourdgs::project"):
            proj = project_params4d(params, camera, t, min_opacity)
        return render_projected(proj, camera, cfg, return_aux=return_aux)


# ---------------------------------------------------------------------------
# entry points of the dataclass splats (render/dense.py's signatures)
# ---------------------------------------------------------------------------

def _render_splats3d(splats: Splats3D, camera: Camera, opacity, sort_mean3,
                     cfg: RenderConfig, return_aux: bool):
    op = (torch.ones((splats.count,), dtype=splats.position.dtype,
                     device=splats.position.device)
          if opacity is None else opacity)
    with record_function("fourdgs::project"):
        proj = project_splats(splats.position, splats.cov, splats.color, op,
                              camera, sort_mean3=sort_mean3)
    return render_projected(proj, camera, cfg, return_aux=return_aux)


def render_splats3d(splats: Splats3D, camera: Camera,
                    opacity: Optional[torch.Tensor] = None,
                    sort_mean3: Optional[torch.Tensor] = None,
                    cfg: RenderConfig = RenderConfig(),
                    return_aux: bool = False):
    """Tiled render of 3D splats, with an optional per-splat opacity (a
    sliced 4D scene) and sorting position."""
    with record_function(FRAME):
        return _render_splats3d(splats, camera, opacity, sort_mean3, cfg,
                                return_aux)


def render_splats2d(splats: Splats2D, camera: Camera,
                    cfg: RenderConfig = RenderConfig(),
                    return_aux: bool = False):
    """Tiled render of the 2D screen-space workload. The 2D scene draws its
    splats unsorted, in index order; that order is expressed as depth keys
    (the index), so the pipeline's front-to-back reversal applies
    unchanged."""
    from fourdgs_torch.render.dense import project_splats2d
    with record_function(FRAME):
        proj, p00e, p11e = project_splats2d(splats, camera)
        proj = dataclasses.replace(
            proj, depth=torch.arange(proj.count, dtype=proj.mx.dtype,
                                     device=proj.mx.device))
        return render_projected(proj, camera, cfg, p00=p00e, p11=p11e,
                                return_aux=return_aux)


def render_splats4d(splats: Splats4D, camera: Camera, t,
                    min_opacity=0.0, cfg: RenderConfig = RenderConfig(),
                    return_aux: bool = False):
    """4D slice at time t (a Python float or a 0-d tensor), EWA and the
    tiled ordered composite, sorted by the reference's quirky sorting mean
    (splats.gaussians.mean_in_time_sortkey). For 10M+ splats use
    render_params4d_packed: it never builds (N, 4, 4) covariances."""
    with record_function(FRAME):
        sliced, top = splats.at_time(t, min_opacity)
        sort_mean = mean_in_time_sortkey(splats.position, splats.cov, t)
        return _render_splats3d(sliced, camera, top, sort_mean, cfg,
                                return_aux)
