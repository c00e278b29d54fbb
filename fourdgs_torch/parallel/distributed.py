"""Sharded rendering and training over a ("data", "tile") device mesh (port
of fourdgs/parallel/distributed.py).

One process drives one device and holds its LOCAL shard of the splats; the
collectives are explicit `torch.distributed` calls over the mesh's groups
(NCCL on the card, gloo on the CPU), each with its backward rule where a
gradient flows through it:

  * all_gather over "data" (records, the all_gather layout) -> the backward
    reduce-scatters (sums) the cotangent to the shards;
  * all_to_all over the whole mesh (the pair exchange) -> the backward is
    the reverse exchange;
  * all_reduce (sum) of the converged tail's accumulator -> the backward
    all-reduces (sums) the cotangent.

Two exchanges, as in the reference:

  * all_gather (`render_splats4d_sharded`): splats are sharded over "data"
    and replicated over "tile"; each rank projects its shard, all-gathers
    the projected records over "data", and bins and composites only its own
    window of tiles (every rank a disjoint window of the flattened mesh);
  * all_to_all (`render_splats4d_sharded_alltoall`): splats are sharded
    over the FLATTENED mesh; each rank emits and sorts only its own shard's
    pairs, sends every window's run of (at most send_budget) pair records
    to its owner in one all_to_all, and composites the received runs
    straight from the contiguous records (K1). Drops past the budget are
    counted in aux["pairs_dropped"], never silent; `required_send_budget`
    measures the budget a scene needs. In converged mode (tail_mode=
    "banded") the head is composited from the exchanged pairs and every
    other pair goes through the banded tail: every rank all-gathers the
    depth samples and head cuts, so the band cuts and the cut table are the
    same everywhere, runs the tail accumulate (K7) over its own chunks, and
    the accumulators are all-reduced; every rank folds and upsamples the
    global accumulator and blends its own window.

Training: every rank's loss covers only its own window of tiles, and the
reported loss is their sum (`make_sharded_loss`: its value is the sum, its
gradient the rank's own share, so that a backward on every rank gives each
shard exactly its gradient). In the all_gather layout a "data" shard is
replicated over "tile", so its gradient is all-reduced over "tile" and every
replica steps Adam identically. Every render returns the whole image on
every rank (all_gather of the windows), as the reference returns a global
array.

The trainer's parameter dict and the splats it stands for
(`materialize_splats`, `splats_to_params`) live here too, as in the
reference.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fourdgs_torch import as_tensors
from fourdgs_torch.core.camera import Camera
from fourdgs_torch.ops import tail_cuda as TL
from fourdgs_torch.ops.composite_cuda import N_FIELDS, record_fields
from fourdgs_torch.ops.sort_cuda import DEAD
from fourdgs_torch.parallel.mesh import (DATA_AXIS, TILE_AXIS, linear_index,
                                         mesh_size)
from fourdgs_torch.render.pipeline import (RenderConfig,
                                           _composite_pairrec_progressive,
                                           _composite_pallas_progressive,
                                           _composite_tiles_xla,
                                           _gather_tile_lists)
from fourdgs_torch.render.project import Projected, project_splats
from fourdgs_torch.render.sort import front_to_back_order
from fourdgs_torch.render.tiles import (QUANT_DEPTH_BITS, TILE_LIMIT,
                                        _emit_pair_slots, _pair_keys,
                                        _sort_kv, assemble_image, bin_splats,
                                        quantized_depth_bits,
                                        searchsorted_i32, splat_tile_bbox,
                                        tile_grid, tile_pixel_ndc)
from fourdgs_torch.splats.gaussians import Splats4D, mean_in_time_sortkey

PARAM_FIELDS = ("position4", "quat", "scale3", "lifetime", "fade",
                "velocity", "color")


# ---------------------------------------------------------------------------
# collectives with their backward rules
# ---------------------------------------------------------------------------

def _mesh_group(mesh: DeviceMesh):
    """The process group of the whole mesh: the world, whose rank order is
    the mesh's flattened order (make_mesh and host_mesh lay it out so)."""
    world = dist.get_world_size()
    if mesh.mesh.flatten().tolist() != list(range(world)):
        raise ValueError("the mesh must cover the world's ranks in order")
    return dist.group.WORLD


def _gather_parts(x: torch.Tensor, group) -> torch.Tensor:
    """all_gather along axis 0 (tiled) with no gradient; bool travels as
    uint8."""
    as_bool = x.dtype == torch.bool
    src = (x.to(torch.uint8) if as_bool else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return out.bool() if as_bool else out


class _AllGather(torch.autograd.Function):
    """all_gather along axis 0; backward: the summed cotangent of this
    rank's slice (a reduce-scatter; all_reduce and a slice where the
    backend has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.n = x.shape[0]
        return _gather_parts(x, group)

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.group, ctx.n
        g = g.contiguous()
        if g.is_cuda and "nccl" in str(dist.get_backend(group)):
            out = g.new_empty((n,) + tuple(g.shape[1:]))
            dist.reduce_scatter_tensor(out, g, group=group)
            return out, None
        g = g.clone()
        dist.all_reduce(g, group=group)
        r = dist.get_rank(group)
        return g[r * n:(r + 1) * n], None


def _all_to_all_plain(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """all_to_all of equal blocks along axis 0 (block i to rank i);
    backward: the reverse exchange, which is the same operation."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all_plain(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_plain(g, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    """all_reduce (sum); backward: all_reduce (sum) of the cotangent (every
    rank's output is the same sum, and every rank's loss reads it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReportedSum(torch.autograd.Function):
    """The sum over ranks of a per-rank loss, whose backward is the identity:
    every rank backpropagates its own copy, so rank r's share gets gradient
    1 exactly once (an all-reduced backward would multiply every gradient
    by the world size)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradAllReduce(torch.autograd.Function):
    """Identity forward; backward all-reduces (sums) the cotangent over
    `group`: the gradient of a shard replicated over the group's ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _gather_projected(proj: Projected, group) -> Projected:
    return proj.map(lambda a: _AllGather.apply(a, group)
                    if a.is_floating_point() else _gather_parts(a, group))


def _window(a: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """Rows [lo, lo + n) of a, zero-padded past its end (the last window of
    a tile grid that does not divide evenly)."""
    short = lo + n - a.shape[0]
    if short > 0:
        a = torch.cat([a, a.new_zeros((short,) + tuple(a.shape[1:]))])
    return a[lo:lo + n]


def _tiles_per_device(camera: Camera, cfg: RenderConfig, n_dev: int) -> int:
    ny, nx = tile_grid(camera.width, camera.height, cfg.tile_h, cfg.tile_w)
    return -(-ny * nx // n_dev)


def _assemble(tiles: torch.Tensor, mesh: DeviceMesh, camera: Camera,
              cfg: RenderConfig) -> torch.Tensor:
    """Every rank's window (tiles_per_device, P, 4) -> the (H, W, 4) image
    on every rank."""
    ny, nx = tile_grid(camera.width, camera.height, cfg.tile_h, cfg.tile_w)
    all_tiles = _AllGather.apply(tiles, _mesh_group(mesh))
    return assemble_image(all_tiles[:ny * nx], camera.width, camera.height,
                          cfg.tile_h, cfg.tile_w)


def _projection(splats: Splats4D, t, camera: Camera, min_opacity):
    sliced, top = splats.at_time(t, min_opacity)
    sort_mean = mean_in_time_sortkey(splats.position, splats.cov, t)
    proj = project_splats(sliced.position, sliced.cov, sliced.color, top,
                          camera, sort_mean3=sort_mean)
    pmat = camera.proj_matrix()
    return proj, pmat[0, 0], pmat[1, 1]


# ---------------------------------------------------------------------------
# the all_gather exchange
# ---------------------------------------------------------------------------

def _render_my_tiles(splats: Splats4D, t, camera: Camera, cfg: RenderConfig,
                     mesh: DeviceMesh, min_opacity,
                     tiles_per_device: int) -> torch.Tensor:
    """Rank-local body: project my "data" shard, all_gather the records over
    "data", bin (exact order) and composite my window of tiles. Returns
    (tiles_per_device, P, 4)."""
    proj_local, p00, p11 = _projection(splats, t, camera, min_opacity)
    proj = _gather_projected(proj_local, mesh.get_group(DATA_AXIS))
    w, h = camera.width, camera.height
    order = front_to_back_order(proj.depth)
    proj = proj.map(lambda a: a[order])
    # Bin only this rank's window: pairs outside it die before the sort.
    my = linear_index(mesh) * tiles_per_device
    binning = bin_splats(proj, p00, p11, w, h, tile_h=cfg.tile_h,
                         tile_w=cfg.tile_w,
                         max_tiles_per_splat=cfg.max_tiles_per_splat,
                         tile_range=(my, tiles_per_device))
    px, py, _ = tile_pixel_ndc(w, h, cfg.tile_h, cfg.tile_w,
                               device=proj.mx.device)
    px = _window(px, my, tiles_per_device)
    py = _window(py, my, tiles_per_device)
    bg = torch.tensor(cfg.background, dtype=proj.mx.dtype,
                      device=proj.mx.device)
    if cfg.backend == "pallas":
        tiles, _ = _composite_pallas_progressive(proj, binning, px, py, p00,
                                                 p11, bg, cfg)
        return tiles
    tile_splat, tile_live = _gather_tile_lists(binning, cfg)
    return _composite_tiles_xla(proj, tile_splat, tile_live, px, py, p00,
                                p11, bg, cfg.splat_chunk)


def render_splats4d_sharded(splats: Splats4D, camera: Camera, t,
                            mesh: DeviceMesh, min_opacity=0.0,
                            cfg: RenderConfig = RenderConfig()
                            ) -> torch.Tensor:
    """Sharded forward render through the all_gather exchange. `splats` is
    this rank's "data" shard (mesh.splat_shard of the splats padded with
    pad_to_multiple to a multiple of the "data" length); returns the whole
    (H, W, 4) image on every rank."""
    tpd = _tiles_per_device(camera, cfg, mesh_size(mesh))
    tiles = _render_my_tiles(splats, t, camera, cfg, mesh, min_opacity, tpd)
    return _assemble(tiles, mesh, camera, cfg)


# ---------------------------------------------------------------------------
# the all_to_all exchange
# ---------------------------------------------------------------------------

def _render_my_tiles_alltoall(splats: Splats4D, t, camera: Camera,
                              cfg: RenderConfig, mesh: DeviceMesh,
                              min_opacity, tiles_per_device: int,
                              send_budget: int,
                              converged_parts: bool = False):
    """Rank-local body with splats sharded over the flattened mesh: emit and
    sort my shard's pairs, send each window's run (at most send_budget
    pairs) to its owner, merge what I receive and composite my window
    straight from the contiguous records. Returns ((tiles_per_device, P,
    4) tiles, aux).

    converged_parts=True (tail mode): stop after the exact head and return
    (head carry (tiles_per_device, 8, P), head cut of my window, the 2,048-
    entry depth-bit sample of my shard, my tail fields (10, n) and meta (6,
    Np), aux) for _converged_alltoall_local. The cut adapts to what the
    head received (the last received key per tile), so pairs dropped by the
    budget beyond it are walked by the tail from the raw shard."""
    group = _mesh_group(mesh)
    n_dev = mesh_size(mesh)
    me = linear_index(mesh)
    w, h = camera.width, camera.height
    ny, nx = tile_grid(w, h, cfg.tile_h, cfg.tile_w)
    t_total = ny * nx
    if t_total >= TILE_LIMIT:
        raise ValueError(f"{t_total} tiles: the exchange's keys hold fewer "
                         f"than {TILE_LIMIT}")
    proj, p00, p11 = _projection(splats, t, camera, min_opacity)
    dev, dtype = proj.mx.device, proj.mx.dtype

    # 1. my shard's pairs for every window, sorted (tile-major, depth).
    alive, tx0, tx1, ty0, ty1 = splat_tile_bbox(proj, p00, p11, w, h,
                                                cfg.tile_h, cfg.tile_w)
    tids, lives, sidx, overflowed = _emit_pair_slots(
        alive, tx0, tx1, ty0, ty1, nx, t_total, cfg.max_tiles_per_splat)
    dbits = quantized_depth_bits(proj.depth)
    key_s, sidx_s = _sort_kv(_pair_keys(tids, lives, dbits), sidx)
    fields = record_fields(proj, p00, p11)                 # (10, n)
    recp = fields[:, sidx_s.long()].T                      # (P_loc, 10)

    # 2. each window's run -> a fixed block of send_budget pairs.
    b = send_budget
    wlo = torch.clamp(torch.arange(n_dev + 1, dtype=torch.int32, device=dev)
                      * tiles_per_device, max=t_total)
    bounds = searchsorted_i32(key_s, wlo << QUANT_DEPTH_BITS)
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    sent = torch.clamp(counts, max=b)
    dropped = (counts - sent).sum(dtype=torch.int32)
    key_pad = torch.cat([key_s, key_s.new_full((b,), DEAD)])
    rec_pad = torch.cat([recp, recp.new_zeros((b, N_FIELDS))])
    ar = torch.arange(b, device=dev)
    at = starts.long()[:, None] + ar                       # (n_dev, b)
    live = ar[None, :] < sent[:, None]
    key_send = torch.where(live, key_pad[at], DEAD)
    rec_send = rec_pad[at] * live[..., None].to(dtype)

    # 3. the exchange: rank i receives block i from every rank.
    key_recv = _all_to_all_plain(key_send, group)
    rec_recv = _AllToAll.apply(rec_send, group)

    # 4. merge the received runs (one small sort) and my window's CSR. The
    # sort is stable: tied pairs keep the order in which they arrive, so
    # one rank alone keeps its local sort's order, the single-chip one.
    key_f, pidx = torch.sort(key_recv.reshape(-1), stable=True)
    rec_f = rec_recv.reshape(-1, N_FIELDS)[pidx]
    my_lo = me * tiles_per_device
    tb = torch.clamp(my_lo + torch.arange(tiles_per_device + 1,
                                          dtype=torch.int32, device=dev),
                     max=t_total)
    tile_start = searchsorted_i32(key_f, tb << QUANT_DEPTH_BITS)

    # 5. the slab composite of my window's contiguous records.
    px, py, _ = tile_pixel_ndc(w, h, cfg.tile_h, cfg.tile_w, device=dev)
    px = _window(px, my_lo, tiles_per_device)
    py = _window(py, my_lo, tiles_per_device)
    bg = torch.tensor(cfg.background, dtype=dtype, device=dev)
    sorted_pairs = (key_f != DEAD).sum(dtype=torch.int32)
    aux = {"overflowed": _all_reduce(overflowed, group),
           "pairs_dropped": _all_reduce(dropped, group)}
    if cfg.tail_mode != "banded":
        tiles = _composite_pairrec_progressive(rec_f, tile_start, px, py,
                                               p00, p11, bg, cfg)
        aux["my_sorted_pairs"] = sorted_pairs
        return tiles, aux
    if not converged_parts:
        raise ValueError("tail_mode='banded' runs through the converged path "
                         "(_converged_alltoall_local); call this body with "
                         "converged_parts=True")
    # The exact head of the exchanged pairs, with the post-sort re-cut.
    head_cap = cfg.max_splats_per_tile
    starts_w = tile_start[:-1]
    counts_w = tile_start[1:] - starts_w
    gl_ids = my_lo + torch.arange(tiles_per_device, dtype=torch.int32,
                                  device=dev)
    t_max_w = (torch.clamp(gl_ids + 1, max=t_total) << QUANT_DEPTH_BITS) - 1
    last = starts_w + torch.clamp(counts_w, max=head_cap) - 1
    kcut = key_f[torch.clamp(last, min=0).long()]
    head_cut = torch.where(counts_w > head_cap, kcut - 1, kcut)
    head_cut = torch.where(counts_w > 0, head_cut, t_max_w)
    head_counts = searchsorted_i32(key_f, head_cut + 1) - starts_w
    carry = _composite_pairrec_progressive(
        rec_f, tile_start, px, py, p00, p11, bg, cfg,
        head_counts=head_counts, return_carry=True)
    # My shard's tail operands. The band cuts need GLOBAL depth quantiles
    # (a Morton-ordered shard is spatially biased): sample here, cut from
    # every rank's sample.
    n_loc = dbits.shape[0]
    stride = max(1, n_loc // 2048)
    samp = torch.where(alive[::stride][:2048], dbits[::stride][:2048], DEAD)
    meta = TL.tail_meta(alive, tx0, tx1, ty0, ty1, dbits, cfg.tail_chunk)
    aux["my_sorted_pairs"] = _all_reduce(sorted_pairs, group,
                                         dist.ReduceOp.MAX)
    return carry, head_cut, samp, fields, meta, aux


def _converged_alltoall_local(splats, t, camera: Camera, mesh: DeviceMesh,
                              cfg: RenderConfig, min_opacity,
                              tiles_per_device: int, send_budget: int,
                              materialize: bool = False):
    """Converged sharded render (tail_mode='banded'), one rank's part: the
    exact head of my window from the exchange; the depth samples and head
    cuts all-gathered, so the band cuts (and, with tail_depth_beta, the
    weight coefficients) and the full cut table are the same on every rank;
    the banded tail (K7) over my own chunks only (their bands, rects and
    slot masks from the plain step_bands_rects / step_slot_masks, as the
    reference computes them here); the accumulators all-reduced; the fold
    and the GLOBAL upsample of the summed accumulator, of which I blend my
    window under my head's transmittance. `splats` is my flattened-mesh
    shard (the raw parameter dict with materialize=True). Returns my
    window's tiles (tiles_per_device, P, 4) and aux; differentiable end to
    end."""
    if materialize:
        splats = materialize_splats(splats)
    group = _mesh_group(mesh)
    w, h = camera.width, camera.height
    ny, nx = tile_grid(w, h, cfg.tile_h, cfg.tile_w)
    t_total = ny * nx
    by, bx = cfg.tail_block
    s_cy, s_cx = cfg.tile_h // by, cfg.tile_w // bx
    k_bands = cfg.tail_bands
    carry, head_cut, samp, fields, meta, aux = _render_my_tiles_alltoall(
        splats, t, camera, cfg, mesh, min_opacity, tiles_per_device,
        send_budget, converged_parts=True)
    cut_full = _gather_parts(head_cut, group)[:t_total]
    samp_all = _gather_parts(samp, group)
    band_cuts = TL.global_band_cuts(samp_all, k_bands)
    band, rect = TL.step_bands_rects(meta, cfg.tail_chunk, band_cuts, 0,
                                     cfg.max_tiles_per_splat)
    slot_mask = TL.step_slot_masks(meta, cfg.tail_chunk,
                                   cfg.max_tiles_per_splat)
    wd_ab = None
    if cfg.tail_depth_beta:
        d_lo, d_hi = TL.global_band_extremes(samp_all)
        coeffs = TL.band_weight_coeffs(band_cuts, d_lo, d_hi, k_bands,
                                       cfg.tail_depth_beta)
        wd_ab = coeffs[band.long()]
    pmat = camera.proj_matrix()
    params_row = TL.tail_params_row(cfg.tile_h, cfg.tile_w, cfg.tail_block,
                                    w, h, pmat[0, 0], pmat[1, 1])
    acc_local = TL.tail_accumulate(
        fields, meta, band, rect, cut_full, params_row, k_bands=k_bands,
        nx=nx, ny=ny, chunk=cfg.tail_chunk, budget=cfg.max_tiles_per_splat,
        s_cy=s_cy, s_cx=s_cx, slot_mask=slot_mask, wd_ab=wd_ab,
        alpha_pow=cfg.tail_alpha_power, exact_clip=cfg.tail_exact_clip)
    acc = _AllReduceSum.apply(acc_local, group)
    upt = TL.fold_upsample_tail(acc, k_bands, nx, ny, cfg.tile_h, cfg.tile_w,
                                s_cy, s_cx)
    my_lo = linear_index(mesh) * tiles_per_device
    out = TL.blend_tail_under_head(
        carry, _window(upt, my_lo, tiles_per_device))
    bg = torch.tensor(cfg.background, dtype=out.dtype, device=out.device)
    rgb = out[:, 0:3, :] + out[:, 4:5, :] * bg[:3, None]
    a = out[:, 3, :] + out[:, 4, :] * bg[3]
    return torch.cat([rgb, a[:, None, :]], dim=1).permute(0, 2, 1), aux


def required_send_budget(splats: Splats4D, camera: Camera, mesh: DeviceMesh,
                         cfg: RenderConfig, t=0.0, min_opacity=0.0,
                         headroom: float = 1.15) -> int:
    """The MEASURED send budget of the all_to_all exchange: the largest
    (source shard -> destination window) pair count across the mesh, from
    one counting pass over my flattened-mesh shard (no sort, no exchange of
    pairs; the maximum is all-reduced), times `headroom`, at least 128. The
    same on every rank. Call it at scene / camera set-up, or whenever
    aux["pairs_dropped"] is not 0, and pass it as send_budget."""
    group = _mesh_group(mesh)
    n_dev = mesh_size(mesh)
    ny, nx = tile_grid(camera.width, camera.height, cfg.tile_h, cfg.tile_w)
    t_total = ny * nx
    tpd = -(-t_total // n_dev)
    proj, p00, p11 = _projection(splats, t, camera, min_opacity)
    alive, tx0, tx1, ty0, ty1 = splat_tile_bbox(
        proj, p00, p11, camera.width, camera.height, cfg.tile_h, cfg.tile_w)
    tids, lives, _, _ = _emit_pair_slots(alive, tx0, tx1, ty0, ty1, nx,
                                         t_total, cfg.max_tiles_per_splat)
    per_win = torch.zeros(n_dev, dtype=torch.int64, device=alive.device)
    for ti, live in zip(tids, lives):
        per_win += torch.bincount(torch.div(ti[live], tpd,
                                            rounding_mode="floor").long(),
                                  minlength=n_dev)[:n_dev]
    worst = _all_reduce(per_win.max(), group, dist.ReduceOp.MAX)
    return max(128, int(int(worst) * headroom))


def default_send_budget(n_total_splats: int, n_dev: int,
                        max_tiles_per_splat: int = 4,
                        headroom: float = 2.0) -> int:
    """Pairs a (source, destination) block holds: `headroom` times the
    uniform share of a shard's pair slots. Receive memory a rank = n_dev *
    B * 40 bytes, O(P_total / n_dev). A window receiving more than B from
    one source is counted in aux, never silent."""
    per_shard = -(-n_total_splats // n_dev) * max_tiles_per_splat
    return max(128, int(per_shard * headroom / n_dev))


def _data_shard_of_flat(splats: Splats4D, mesh: DeviceMesh) -> Splats4D:
    """My "data" row's shard, assembled from the flattened-mesh shards of
    the row's "tile" ranks (contiguous in the flattened order)."""
    group = mesh.get_group(TILE_AXIS)
    return Splats4D(position=_AllGather.apply(splats.position, group),
                    color=_AllGather.apply(splats.color, group),
                    cov=_AllGather.apply(splats.cov, group))


def render_splats4d_sharded_alltoall(
        splats: Splats4D, camera: Camera, t, mesh: DeviceMesh,
        min_opacity=0.0, cfg: RenderConfig = RenderConfig(),
        send_budget: Optional[int] = None, return_aux: bool = False):
    """Sharded forward render through the all_to_all exchange. `splats` is
    this rank's shard over the FLATTENED mesh (mesh.splat_shard_flat of the
    splats padded to a multiple of the mesh size). Returns the (H, W, 4)
    image on every rank, with return_aux also the counters (overflowed,
    pairs_dropped, my_sorted_pairs: the most pairs a rank sorted), all
    reduced over the mesh.

    At 2,047 tiles or more (the exchange keys' 11-bit tile id) this falls
    back to the all_gather exchange: the same image, a rank's sort then
    O(P_total)."""
    n_dev = mesh_size(mesh)
    ny, nx = tile_grid(camera.width, camera.height, cfg.tile_h, cfg.tile_w)
    if ny * nx >= TILE_LIMIT:
        img = render_splats4d_sharded(_data_shard_of_flat(splats, mesh),
                                      camera, t, mesh,
                                      min_opacity=min_opacity, cfg=cfg)
        if return_aux:
            return img, {"exchange_fallback": torch.ones(
                (), dtype=torch.int32, device=img.device)}
        return img
    tpd = -(-ny * nx // n_dev)
    if send_budget is None:
        send_budget = default_send_budget(splats.count * n_dev, n_dev,
                                          cfg.max_tiles_per_splat)
    if cfg.tail_mode == "banded":
        tiles, aux = _converged_alltoall_local(
            splats, t, camera, mesh, cfg, min_opacity, tpd, send_budget)
    else:
        tiles, aux = _render_my_tiles_alltoall(
            splats, t, camera, cfg, mesh, min_opacity, tpd, send_budget)
        aux["my_sorted_pairs"] = _all_reduce(
            aux["my_sorted_pairs"], _mesh_group(mesh), dist.ReduceOp.MAX)
    img = _assemble(tiles, mesh, camera, cfg)
    return (img, aux) if return_aux else img


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _abs(x: torch.Tensor) -> torch.Tensor:
    # jnp.abs's gradient at 0 is 1; torch.abs's is 0.
    return torch.where(x >= 0, x, -x)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    # jnp.clip's gradient at a bound is 0.5 (the tie of maximum / minimum);
    # torch.clamp's is 1. Tensor bounds in x's dtype make the same ties.
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def materialize_splats(params: Dict[str, torch.Tensor]) -> Splats4D:
    """Raw trainable parameter dict -> Splats4D (motion parameterization).
    Scales and lifetime are kept positive by abs + eps, fade and color are
    clipped, with the reference's gradients at the clip bounds and at 0."""
    scale = _abs(params["scale3"]) + 1e-4
    lifetime = _abs(params["lifetime"]) + 1e-4
    fade = _clip(params["fade"], 1e-3, 1.0 - 1e-3)
    color = _clip(params["color"], 0.0, 1.0)
    return Splats4D.from_motion(params["position4"], params["quat"], scale,
                                lifetime, fade, params["velocity"], color)


def splats_to_params(position4, quat, scale3, lifetime, fade, velocity,
                     color, device=None) -> Dict[str, torch.Tensor]:
    """The trainer's parameter dict (PARAM_FIELDS) from arrays or tensors:
    numpy arrays (the reference's trainer parameters) become float32
    tensors; with `device` (None: tensors stay where they are and arrays go
    beside them or to the card, fourdgs_torch.as_tensors) all go there."""
    return dict(zip(PARAM_FIELDS, as_tensors(
        position4, quat, scale3, lifetime, fade, velocity, color,
        device=device)))


def make_sharded_loss(camera: Camera, mesh: DeviceMesh,
                      cfg: RenderConfig = RenderConfig(), min_opacity=0.0,
                      exchange: str = "allgather",
                      send_budget: Optional[int] = None):
    """Photometric L2 between the sharded render and a target image.

    Returns loss_fn(params, target_hw4, t): `params` is this rank's shard of
    the trainer's dict (over "data" for exchange="allgather", over the
    flattened mesh for "alltoall"), target the whole image on every rank.
    The returned scalar's value is the loss of the whole image, the same on
    every rank; its gradient is this rank's share (the L2 over its own
    window of tiles), so a backward on every rank leaves each rank's shard
    with its full gradient (all_gather layout: summed over the "tile"
    replicas).

    exchange="allgather": records all-gathered over "data" (a rank's sort is
    O(P_total)); "alltoall": the pair exchange (O(P_total / n_dev)), with
    converged mode when cfg.tail_mode == "banded". Beyond 2,046 tiles the
    all_to_all exchange falls back to all_gather."""
    if exchange not in ("allgather", "alltoall"):
        raise ValueError(f"unknown exchange {exchange!r}")
    n_total = mesh_size(mesh)
    ny, nx = tile_grid(camera.width, camera.height, cfg.tile_h, cfg.tile_w)
    tpd = -(-ny * nx // n_total)
    h, w = camera.height, camera.width
    th, tw = cfg.tile_h, cfg.tile_w
    flat_fallback = exchange == "alltoall" and ny * nx >= TILE_LIMIT

    def my_target(target):
        """(H, W, 4) -> my window of the (tiles, P, 4) tile view."""
        img = torch.nn.functional.pad(
            target, (0, 0, 0, nx * tw - w, 0, ny * th - h))
        tl = img.reshape(ny, th, nx, tw, 4).permute(0, 2, 1, 3, 4)
        tl = tl.reshape(ny * nx, th * tw, 4)
        return _window(tl, linear_index(mesh) * tpd, tpd)

    def loss_fn(params, target, t):
        group = _mesh_group(mesh)
        tgt = my_target(target)
        if exchange == "alltoall" and cfg.tail_mode == "banded" \
                and not flat_fallback:
            budget = (send_budget if send_budget is not None
                      else default_send_budget(
                          params["position4"].shape[0] * n_total, n_total,
                          cfg.max_tiles_per_splat))
            tiles, _ = _converged_alltoall_local(
                params, t, camera, mesh, cfg, min_opacity, tpd, budget,
                materialize=True)
            # Only the image's tiles (the reference crops to ny * nx).
            real = max(0, min(tpd, ny * nx - linear_index(mesh) * tpd))
            local = ((tiles[:real, :, :3] - tgt[:real, :, :3]) ** 2).sum()
        else:
            splats = materialize_splats(params)
            if exchange == "allgather":
                tile_group = mesh.get_group(TILE_AXIS)
                splats = Splats4D(**{
                    f: _GradAllReduce.apply(getattr(splats, f), tile_group)
                    for f in ("position", "color", "cov")})
                my_tiles = _render_my_tiles(splats, t, camera, cfg, mesh,
                                            min_opacity, tpd)
            elif flat_fallback:
                my_tiles = _render_my_tiles(
                    _data_shard_of_flat(splats, mesh), t, camera, cfg, mesh,
                    min_opacity, tpd)
            else:
                budget = (send_budget if send_budget is not None
                          else default_send_budget(splats.count * n_total,
                                                   n_total,
                                                   cfg.max_tiles_per_splat))
                my_tiles, _ = _render_my_tiles_alltoall(
                    splats, t, camera, cfg, mesh, min_opacity, tpd, budget)
            local = ((my_tiles[..., :3] - tgt[..., :3]) ** 2).sum()
        return _ReportedSum.apply(local / (h * w * 3), group)

    return loss_fn


def make_sharded_train_step(camera: Camera, mesh: DeviceMesh, optimizer,
                            cfg: RenderConfig = RenderConfig(),
                            min_opacity=0.0, exchange: str = "allgather",
                            send_budget: Optional[int] = None):
    """One differentiable-rendering training step: render -> L2 -> backward
    (the collectives' backward rules deliver each shard its gradient) ->
    the optimizer's step. `optimizer` is a torch optimizer over this rank's
    shard tensors (`adam(params, lr)`, as trainer.fit's); the step updates
    them in place: step(params, target, t) -> the loss (replicated, 0-d,
    detached)."""
    loss_fn = make_sharded_loss(camera, mesh, cfg, min_opacity,
                                exchange=exchange, send_budget=send_budget)

    def train_step(params, target, t):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, target, t)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def adam(params: Dict[str, torch.Tensor], learning_rate: float):
    """Adam over a parameter dict's tensors: b1 0.9, b2 0.999, eps 1e-8, as
    optax.adam."""
    return torch.optim.Adam(list(params.values()), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def fit_sharded(params: Dict[str, torch.Tensor], camera: Camera,
                mesh: DeviceMesh, target, steps: int = 50, t=0.0,
                cfg: RenderConfig = RenderConfig(),
                exchange: str = "alltoall", learning_rate: float = 1e-2,
                min_opacity=0.0, send_budget: Optional[int] = None,
                check_every: int = 10, budget_headroom: float = 1.15,
                log=None):
    """Sharded training loop (Adam) with a SKEW-ADAPTIVE send budget.
    `params` is this rank's shard (not changed: copies train). Every
    `check_every` steps one aux-reporting frame is rendered; on
    pairs_dropped > 0 (the same on every rank) the budget is re-measured
    with required_send_budget and, where it grew, the step is rebuilt with
    it. Returns (params, losses, final send_budget)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    opt = adam(params, learning_rate)
    n_dev = mesh_size(mesh)
    if send_budget is None:
        send_budget = default_send_budget(
            params["position4"].shape[0] * n_dev, n_dev,
            cfg.max_tiles_per_splat)

    def build(budget):
        return make_sharded_train_step(camera, mesh, opt, cfg,
                                       min_opacity=min_opacity,
                                       exchange=exchange, send_budget=budget)

    step = build(send_budget)
    losses = []
    for i in range(steps):
        if exchange == "alltoall" and check_every and i % check_every == 0:
            with torch.no_grad():
                splats = materialize_splats(params)
                _, aux = render_splats4d_sharded_alltoall(
                    splats, camera, t, mesh, min_opacity=min_opacity,
                    cfg=cfg, send_budget=send_budget, return_aux=True)
                dropped = int(aux.get("pairs_dropped", 0))
                if dropped > 0:
                    new_budget = required_send_budget(
                        splats, camera, mesh, cfg, t=t,
                        min_opacity=min_opacity, headroom=budget_headroom)
                    if new_budget > send_budget:
                        if log:
                            log(f"fit_sharded: pairs_dropped={dropped}, "
                                f"send_budget {send_budget} -> {new_budget} "
                                "(re-measured; step rebuilt)")
                        send_budget = new_budget
                        step = build(send_budget)
        losses.append(float(step(params, target, t)))
    return ({k: v.detach() for k, v in params.items()}, losses, send_budget)
