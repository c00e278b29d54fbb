"""Plain reference of the converged 4D frame: the cube scene's image at one
camera pose and time, computed with plain PyTorch operations only.

It is a frozen copy of the arithmetic of the program's converged frame as
its CPU path runs it (scene build: Morton order and dead padding; the 4D
slice and EWA projection; quantized binning with the depth prune, the
row-sort compaction, one global sort and the head re-cut; the head
composite; the banded order-independent tail: band cuts, per-chunk bands,
the tail accumulate, the fold, the upsample and the blend under the head),
with the knob values of the frame's automatic configuration. Nothing here
imports the program: the image is worked out again from the scene's raw
parameters, the pose and the time, in blocks of tiles and of splats.

`render(params, pose, t, width, height)` returns (image (H, W, 4), counters)
with the counters of the frame's guarantees: overflowed, compact_dropped,
resid_transmittance. `records_dtype=torch.bfloat16` rounds the splats'
record matrix (centers, footprint axes, colours, opacity) to bfloat16 before
the composite and the tail: the precision control.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

DEAD = 2 ** 31 - 1
INT32_MAX = 2 ** 31 - 1
QUANT_DEPTH_BITS = 20
TILE_LIMIT = (1 << 11) - 1
COMPACT_ROW_LEN = 8192
CUT_TABLE = 2048
ROWSORT_COLS = 256
GRANULE_ROWS = 8
ALPHA_MAX = 1.0 - 1e-6
LAMBDA_EPS = 1e-6
CULL_BOUND = 1.2
R_COVER = 0.5371
CHUNK = 128
N_FIELDS, F_ROWS = 10, 16
N_PLANES = 6
P_A, P_AR, P_AG, P_AB, P_A2, P_L = range(N_PLANES)
WIN_TY = 16
CUT_ENTRIES = 2048
QSCALE = math.sqrt(32.0)
PAD_FILL = dict(qw=1.0, sx=1e-6, sy=1e-6, sz=1e-6, lifetime=1e-6, fade=0.5,
                ca=0.0)
# Tiles a block of the head composite, splats a block of the tail.
HEAD_BLOCK_TILES = 256
TAIL_BLOCK_SPLATS = 1 << 20


# A configuration's render overrides (the program's knob names) and the
# knob of this reference that each sets.
OVERRIDABLE = {"sort_compact_keep_cols": "compact_keep_cols"}


def frame_config(n_splats: int, width: int, height: int,
                 overrides: Optional[dict] = None) -> dict:
    """The knobs of the converged frame at this scene and image size: the
    automatic configuration's arithmetic, frozen, with a configuration's
    `overrides` applied (a knob not in OVERRIDABLE is refused)."""
    res_scale = max(width / 1920.0, height / 1088.0, 1.0)
    cfg = dict(tile_h=16, tile_w=128, max_splats_per_tile=256,
               max_tiles_per_splat=math.ceil(4 * res_scale),
               compact_keep_cols=32 if n_splats >= 2_000_000 else 192,
               big_splat_budget=16, compact_row_len=512,
               depth_prune_cap=256, depth_prune_safety=1.2, tail_bands=8,
               tail_block=(16, 16), tail_chunk=16384, tail_exact_clip=True,
               background=(0.0, 0.0, 0.0, 1.0))
    for knob, value in (overrides or {}).items():
        if knob not in OVERRIDABLE:
            raise KeyError(f"the reference has no knob for {knob!r}")
        cfg[OVERRIDABLE[knob]] = value
    return cfg


# --------------------------------------------------------------------------
# scene build: Morton order and dead padding
# --------------------------------------------------------------------------

def morton_pad(params: Dict[str, torch.Tensor], multiple: int,
               bits: int = 10) -> Dict[str, torch.Tensor]:
    """Reorder by the stable 3D Morton code of the position, then pad with
    dead splats (opacity 0) to a multiple of `multiple`."""
    def q(x):
        lo = x.min()
        span = torch.clamp(x.max() - lo, min=1e-12)
        return torch.clamp((x - lo) / span * (1 << bits), 0,
                           (1 << bits) - 1).to(torch.int64)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v
    code = (spread(q(params["px"])) | (spread(q(params["py"])) << 1)
            | (spread(q(params["pz"])) << 2)) & 0xFFFFFFFF
    order = torch.argsort(code, stable=True)
    n = params["px"].shape[0]
    pad = -(-n // multiple) * multiple - n
    out = {}
    for k, v in params.items():
        v = v[order]
        if pad:
            v = torch.cat([v, v.new_full((pad,), PAD_FILL.get(k, 0.0))])
        out[k] = v
    return out


# --------------------------------------------------------------------------
# camera, 4D slice, projection
# --------------------------------------------------------------------------

def _normalize(v, eps=1e-12):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


def camera_matrices(position, orientation, width: int, height: int,
                    device, fov_deg=60.0, near=0.1, far=5000.0):
    """(view (4, 4), proj (4, 4), eye (3,)): glm's lookAt and perspective."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    eye, up = f32(position), f32((0.0, 1.0, 0.0))
    center = eye + f32(orientation)
    f = _normalize(center - eye)
    s = _normalize(torch.linalg.cross(f, up))
    u = torch.linalg.cross(s, f)
    rot = torch.stack([s, u, -f])
    view = torch.eye(4, dtype=eye.dtype, device=device)
    view[:3, :3] = rot
    view[:3, 3] = -rot @ eye
    t = torch.tan(torch.deg2rad(f32(fov_deg)) * 0.5)
    aspect = torch.tensor(float(width) / float(height), dtype=torch.float32,
                          device=device)
    n_, f_ = f32(near), f32(far)
    p = torch.zeros((4, 4), dtype=t.dtype, device=device)
    p[0, 0] = 1.0 / (aspect * t)
    p[1, 1] = 1.0 / t
    p[2, 2] = -(f_ + n_) / (f_ - n_)
    p[2, 3] = -(2.0 * f_ * n_) / (f_ - n_)
    p[3, 2] = -1.0
    return view, p, eye


def _cov3(qw, qx, qy, qz, sx, sy, sz):
    inv = torch.rsqrt(qw * qw + qx * qx + qy * qy + qz * qz + 1e-30)
    w, x, y, z = qw * inv, qx * inv, qy * inv, qz * inv
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r00, r01, r02 = 1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)
    r10, r11, r12 = 2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)
    r20, r21, r22 = 2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)
    s0, s1, s2 = sx * sx, sy * sy, sz * sz
    return (r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2,
            r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2,
            r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2,
            r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2,
            r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2,
            r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2)


def _slice(params, t: float):
    """The 4D slice at time t: world means, 3D covariance, temporal
    opacity (the motion parameterization)."""
    st = (params["lifetime"] * params["lifetime"]) / (
        -2.0 * torch.log(params["fade"]))
    tx, ty, tz = params["vx"] * st, params["vy"] * st, params["vz"] * st
    c00, c01, c02, c11, c12, c22 = _cov3(
        params["qw"], params["qx"], params["qy"], params["qz"],
        params["sx"], params["sy"], params["sz"])
    inv_st = 1.0 / st
    c00, c01, c02 = (c00 + tx * tx * inv_st, c01 + tx * ty * inv_st,
                     c02 + tx * tz * inv_st)
    c11, c12, c22 = (c11 + ty * ty * inv_st, c12 + ty * tz * inv_st,
                     c22 + tz * tz * inv_st)
    c03, c13, c23, c33 = tx, ty, tz, st
    dt = float(t) - params["pt"]
    inv_st = 1.0 / c33
    mx = params["px"] + c03 * inv_st * dt
    my = params["py"] + c13 * inv_st * dt
    mz = params["pz"] + c23 * inv_st * dt
    cov = (c00 - c03 * c03 * inv_st, c01 - c03 * c13 * inv_st,
           c02 - c03 * c23 * inv_st, c11 - c13 * c13 * inv_st,
           c12 - c13 * c23 * inv_st, c22 - c23 * c23 * inv_st)
    opacity = torch.clamp(torch.exp(-0.5 * dt * dt * inv_st), min=0.0)
    sort_mean = (params["px"] + c03 * dt, params["py"] + c13 * dt,
                 params["pz"] + c23 * dt)
    return mx, my, mz, cov, opacity, sort_mean


def _eigen2x2(a, b, c):
    m = 0.5 * (a + c)
    p = a * c - b * b
    d = torch.sqrt(torch.clamp(m * m - p, min=1e-24))
    lmin = torch.clamp(m - d, min=LAMBDA_EPS)
    lmax = torch.clamp(m + d, min=LAMBDA_EPS)
    vx, vy = b, lmin - a
    norm = torch.sqrt(vx * vx + vy * vy)
    ok = norm > 1e-12
    inv = 1.0 / torch.clamp(norm, min=1e-30)
    fx = (a <= c).to(a.dtype)
    fy = 1.0 - fx
    return lmin, lmax, torch.where(ok, vx * inv, fx), torch.where(ok, vy * inv,
                                                                   fy)


def project(params, view, proj, eye, t: float) -> dict:
    """EWA projection of the sliced splats: the screen-space fields."""
    mx, my, mz, cov, opacity, sort_mean = _slice(params, t)
    c00, c01, c02, c11, c12, c22 = cov
    v = [[view[i, j] for j in range(3)] for i in range(3)]
    t0, t1, t2 = view[0, 3], view[1, 3], view[2, 3]
    xc = v[0][0] * mx + v[0][1] * my + v[0][2] * mz + t0
    yc = v[1][0] * mx + v[1][1] * my + v[1][2] * mz + t1
    zc = v[2][0] * mx + v[2][1] * my + v[2][2] * mz + t2
    w_clip = -zc
    tiny = torch.where(w_clip < 0, -1e-9, 1e-9)
    inv_w = 1.0 / torch.where(torch.abs(w_clip) > 1e-9, w_clip, tiny)
    sx = proj[0, 0] * xc * inv_w
    sy = proj[1, 1] * yc * inv_w
    z_ndc = (proj[2, 2] * zc + proj[2, 3]) * inv_w
    valid = ((z_ndc >= 0.0) & (z_ndc <= 1.0)
             & (torch.abs(sx) <= CULL_BOUND) & (torch.abs(sy) <= CULL_BOUND))
    zs = torch.where(torch.abs(zc) > 1e-6, zc,
                     torch.where(zc < 0, -1e-6, 1e-6))
    f = 1.0 / zs
    gx, gy = xc * f, yc * f
    a00 = f * (v[0][0] - gx * v[2][0])
    a01 = f * (v[0][1] - gx * v[2][1])
    a02 = f * (v[0][2] - gx * v[2][2])
    a10 = f * (v[1][0] - gy * v[2][0])
    a11 = f * (v[1][1] - gy * v[2][1])
    a12 = f * (v[1][2] - gy * v[2][2])
    u0x = a00 * c00 + a01 * c01 + a02 * c02
    u0y = a00 * c01 + a01 * c11 + a02 * c12
    u0z = a00 * c02 + a01 * c12 + a02 * c22
    q00 = u0x * a00 + u0y * a01 + u0z * a02
    q01 = u0x * a10 + u0y * a11 + u0z * a12
    u1x = a10 * c00 + a11 * c01 + a12 * c02
    u1y = a10 * c01 + a11 * c11 + a12 * c12
    u1z = a10 * c02 + a11 * c12 + a12 * c22
    q11 = u1x * a10 + u1y * a11 + u1z * a12
    lmin, lmax, v0x, v0y = _eigen2x2(q00, q01, q11)
    dx = sort_mean[0] - eye[0]
    dy = sort_mean[1] - eye[1]
    dz = sort_mean[2] - eye[2]
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    return dict(mx=sx, my=sy, depth=1.0 / torch.clamp(dist, min=1e-12),
                v0x=v0x, v0y=v0y, l0=torch.sqrt(lmin), l1=torch.sqrt(lmax),
                r=params["cr"], g=params["cg"], b=params["cb"],
                a=params["ca"], opacity=opacity, valid=valid)


# --------------------------------------------------------------------------
# binning
# --------------------------------------------------------------------------

def tile_grid(width, height, tile_h, tile_w):
    return -(-height // tile_h), -(-width // tile_w)


def tile_bbox(pr, p00, p11, width, height, tile_h, tile_w):
    ny, nx = tile_grid(width, height, tile_h, tile_w)
    ax, ay = torch.abs(pr["v0x"]), torch.abs(pr["v0y"])
    l0, l1 = pr["l0"], pr["l1"]
    qx = 0.5 * (ax * l0 + ay * l1)
    qy = 0.5 * (ay * l0 + ax * l1)
    ex = R_COVER * torch.sqrt((pr["v0x"] * l0) ** 2 + (pr["v0y"] * l1) ** 2)
    ey = R_COVER * torch.sqrt((pr["v0y"] * l0) ** 2 + (pr["v0x"] * l1) ** 2)
    hx_ndc, hy_ndc = torch.minimum(qx, ex) * p00, torch.minimum(qy, ey) * p11
    cx = (pr["mx"] + 1.0) * 0.5 * width
    cy = (1.0 - pr["my"]) * 0.5 * height
    hx = hx_ndc * 0.5 * width
    hy = hy_ndc * 0.5 * height

    def tile_of(v, size, hi):
        return torch.clamp(torch.floor(v / size), 0, hi).to(torch.int32)
    tx0, tx1 = tile_of(cx - hx, tile_w, nx - 1), tile_of(cx + hx, tile_w,
                                                          nx - 1)
    ty0, ty1 = tile_of(cy - hy, tile_h, ny - 1), tile_of(cy + hy, tile_h,
                                                          ny - 1)
    on_screen = ((cx + hx >= 0) & (cx - hx <= width) &
                 (cy + hy >= 0) & (cy - hy <= height))
    return pr["valid"] & on_screen, tx0, tx1, ty0, ty1


def clip_to_band(alive, ty0, ty1, band):
    ty_base, ny = band
    alive = alive & (ty1 >= ty_base) & (ty0 < ty_base + ny)
    return (alive, torch.clamp(ty0 - ty_base, 0, ny - 1),
            torch.clamp(ty1 - ty_base, 0, ny - 1), ny)


def depth_bits(depth):
    dist = 1.0 / torch.clamp(depth, min=1e-30)
    dbits = dist.view(torch.int32) >> (32 - QUANT_DEPTH_BITS)
    return torch.clamp(dbits, 0, (1 << QUANT_DEPTH_BITS) - 1)


def _emit(alive, tx0, tx1, ty0, ty1, nx, num_tiles, budget, splat_ids=None):
    n = alive.shape[0]
    nx_span, ny_span = tx1 - tx0 + 1, ty1 - ty0 + 1
    span = nx_span * ny_span
    overflowed = ((span > budget) & alive).sum(dtype=torch.int32)
    idx1 = (torch.arange(n, dtype=torch.int32, device=alive.device)
            if splat_ids is None else splat_ids.to(torch.int32))
    sx, sy = torch.zeros_like(tx0), torch.zeros_like(ty0)
    tids, lives = [], []
    for s in range(budget):
        live_s = alive & (s < span) & (sy < ny_span)
        tid_s = (ty0 + sy) * nx + (tx0 + sx)
        tids.append(torch.where(live_s, tid_s, num_tiles))
        lives.append(live_s)
        if s + 1 < budget:
            sx = sx + 1
            wrap = sx >= nx_span
            sx = torch.where(wrap, 0, sx)
            sy = torch.where(wrap, sy + 1, sy)
    return tids, lives, idx1.repeat(budget), overflowed


def _keys(tids, lives, dbits):
    return torch.cat([torch.where(live, (tid << QUANT_DEPTH_BITS) | dbits,
                                  DEAD) for tid, live in zip(tids, lives)])


def _sort_kv(key, val, dim=-1):
    ks, order = torch.sort(key, dim=dim)
    return ks, torch.gather(val, dim, order)


def _compact(key, val, keep_cols):
    s = key.shape[0]
    rows = -(-s // COMPACT_ROW_LEN)
    row_len = -(-s // rows)
    pad = rows * row_len - s
    if pad:
        key = torch.cat([key, key.new_full((pad,), DEAD)])
        val = torch.cat([val, val.new_zeros((pad,))])
    ks, vs = _sort_kv(key.reshape(row_len, rows).T,
                      val.reshape(row_len, rows).T, dim=1)
    if keep_cols >= row_len:
        cpad = keep_cols - row_len
        dropped = torch.zeros((), dtype=torch.int32, device=key.device)
        ks = torch.cat([ks, ks.new_full((rows, cpad), DEAD)], dim=1)
        vs = torch.cat([vs, vs.new_zeros((rows, cpad))], dim=1)
    else:
        dropped = (ks[:, keep_cols:] != DEAD).sum(dtype=torch.int32)
        ks, vs = ks[:, :keep_cols], vs[:, :keep_cols]
    return ks.reshape(-1), vs.reshape(-1), dropped


def _flag_ids(flag, blk=1024, hot_cap=1024, keep=24):
    n = flag.shape[0]
    dev = flag.device
    fkey = torch.where(flag, torch.arange(n, dtype=torch.int32, device=dev),
                       DEAD)
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
    ids, _, dropped = _compact(seg, seg, keep)
    dropped = dropped + (flag.sum(dtype=torch.int32)
                         - (seg != DEAD).sum(dtype=torch.int32))
    return ids, dropped


def pair_keys(pr, p00, p11, cfg, width, height, band):
    """The quantized pair-slot keys of one band of tile rows, the main
    stream and the big tier: (key, splat_idx, overflowed, big_ids)."""
    th, tw = cfg["tile_h"], cfg["tile_w"]
    budget, big_budget = cfg["max_tiles_per_splat"], cfg["big_splat_budget"]
    ny, nx = tile_grid(width, height, th, tw)
    alive, tx0, tx1, ty0, ty1 = tile_bbox(pr, p00, p11, width, height, th,
                                          tw)
    if band is not None:
        alive, ty0, ty1, ny = clip_to_band(alive, ty0, ty1, band)
    num_tiles = ny * nx
    span = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
    is_big = alive & (span > budget)
    tids, lives, splat_idx, overflowed = _emit(
        alive & ~is_big, tx0, tx1, ty0, ty1, nx, num_tiles, budget)
    dbits = depth_bits(pr["depth"])
    key = _keys(tids, lives, dbits)
    n = alive.shape[0]
    if n % 1024 == 0 and n >= 128 * 1024:
        ids, big_dropped = _flag_ids(is_big)
    else:
        bk0 = torch.where(is_big, torch.arange(n, dtype=torch.int32,
                                               device=alive.device), DEAD)
        ids, _, big_dropped = _compact(bk0, bk0, 128)
        ids, _, big_dropped2 = _compact(ids, ids, 4 * 128)
        big_dropped = big_dropped + big_dropped2
    blive = ids != DEAD
    safe = torch.clamp(ids, max=n - 1).long()
    btx0, btx1, bty0, bty1, dbits_b, span_b = torch.stack(
        [tx0, tx1, ty0, ty1, dbits, span])[:, safe]
    tidsb, livesb, sidxb, _ = _emit(blive, btx0, btx1, bty0, bty1, nx,
                                    num_tiles, big_budget, splat_ids=safe)
    key = torch.cat([key, _keys(tidsb, livesb, dbits_b)])
    splat_idx = torch.cat([splat_idx, sidxb])
    overflowed = overflowed + ((blive & (span_b > big_budget)).sum(
        dtype=torch.int32) + big_dropped)
    return key, splat_idx, overflowed, ids


def sample_blocks(x, stride_rows, take_rows):
    rows = x.shape[0] // 128
    nblocks = max(1, (rows - GRANULE_ROWS) // stride_rows + 1)
    g = torch.arange(nblocks, device=x.device, dtype=torch.int64)
    start = (g * stride_rows // GRANULE_ROWS) * GRANULE_ROWS * 128
    idx = start[:, None] + torch.arange(take_rows * 128, device=x.device)
    return x[idx.reshape(-1)]


def _searchsorted(sorted_arr, queries):
    return torch.searchsorted(sorted_arr, queries, out_int32=True)


def prune_cuts(key, num_tiles, cap, safety, stride=67):
    blk, take_rows = 256, 2
    if key.shape[0] < stride * blk * 128 or key.shape[0] % 128:
        sample = key[::stride]
    else:
        sample = sample_blocks(key, stride * take_rows, take_rows)
    ss = torch.sort(sample).values
    tile_ids = torch.arange(num_tiles + 1, dtype=torch.int32,
                            device=key.device)
    start = _searchsorted(ss, tile_ids << QUANT_DEPTH_BITS)
    r = start[:-1] + int(-(-cap * safety // stride))
    val = ss[torch.clamp(r, max=ss.shape[0] - 1).long()]
    keep_all = r >= start[1:]
    tile_max = (tile_ids[1:] << QUANT_DEPTH_BITS) - 1
    return torch.where(keep_all, tile_max, torch.minimum(val, tile_max))


def rowsort_keep(key, val, keep_cols, row_len, cut):
    """Stable sort of each strided row, the prune cut applied, its first
    keep_cols kept: ((keep, rows) key, (keep, rows) val, dropped)."""
    s = key.shape[0]
    rows = -(-(-(-s // row_len)) // ROWSORT_COLS) * ROWSORT_COLS
    pad = rows * row_len - s
    if pad:
        key = torch.cat([key, key.new_full((pad,), DEAD)])
        val = torch.cat([val, val.new_zeros((pad,))])
    k2, v2 = key.reshape(row_len, rows), val.reshape(row_len, rows)
    tbl = torch.cat([cut.to(torch.int32),
                     cut.new_full((CUT_TABLE - cut.shape[0],), DEAD,
                                  dtype=torch.int32)])
    tid = torch.clamp(k2 >> QUANT_DEPTH_BITS, 0, CUT_TABLE - 1)
    k2 = torch.where(k2 > tbl[tid.long()], DEAD, k2)
    live = (k2 != DEAD).sum(0, dtype=torch.int32)
    ks, order = torch.sort(k2, dim=0, stable=True)
    ks = ks[:keep_cols].contiguous()
    vs = torch.where(ks == DEAD, 0, torch.gather(v2, 0, order[:keep_cols]))
    dropped = torch.clamp(live - keep_cols, min=0).sum(dtype=torch.int32)
    return ks, vs, dropped


def bin_band(pr, p00, p11, cfg, width, height, band):
    """Sorted pairs of one band: dict(pair_splat, tile_start, head_counts,
    prune_cut, big_ids, overflowed, compact_dropped)."""
    th, tw = cfg["tile_h"], cfg["tile_w"]
    ny, nx = tile_grid(width, height, th, tw)
    if band is not None:
        ny = band[1]
    num_tiles = ny * nx
    key, splat_idx, overflowed, big_ids = pair_keys(pr, p00, p11, cfg, width,
                                                    height, band)
    dev = key.device
    cut = prune_cuts(key, num_tiles, cfg["depth_prune_cap"],
                     cfg["depth_prune_safety"])
    ck, cv, compact_dropped = rowsort_keep(key, splat_idx,
                                           cfg["compact_keep_cols"],
                                           cfg["compact_row_len"], cut)
    key_s, splat_s = _sort_kv(ck.reshape(-1), cv.reshape(-1))
    tile_ids = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev)
    tile_start = _searchsorted(key_s, tile_ids << QUANT_DEPTH_BITS)
    counts = tile_start[1:] - tile_start[:-1]
    t_max = ((tile_ids[:-1] + 1) << QUANT_DEPTH_BITS) - 1
    head_cap = cfg["max_splats_per_tile"]
    starts = tile_start[:-1]
    last = starts + torch.clamp(counts, max=head_cap) - 1
    kcut = key_s[torch.clamp(last, min=0).long()]
    head_cut = torch.where(counts > head_cap, kcut - 1, kcut)
    head_cut = torch.where(counts > 0, head_cut, t_max)
    head_counts = _searchsorted(key_s, head_cut + 1) - starts
    return dict(pair_splat=splat_s, tile_start=tile_start,
                head_counts=head_counts, prune_cut=head_cut, big_ids=big_ids,
                overflowed=overflowed, compact_dropped=compact_dropped)


def tile_pixels(width, height, tile_h, tile_w, device):
    ny, nx = tile_grid(width, height, tile_h, tile_w)

    def ar(k):
        return torch.arange(k, dtype=torch.int32, device=device)
    gy = (ar(ny)[:, None, None, None] * tile_h
          + ar(tile_h)[None, None, :, None]).to(torch.float32)
    gx = (ar(nx)[None, :, None, None] * tile_w
          + ar(tile_w)[None, None, None, :]).to(torch.float32)
    px = (gx + 0.5) / width * 2.0 - 1.0
    py = 1.0 - (gy + 0.5) / height * 2.0
    shape = (ny, nx, tile_h, tile_w)
    return (torch.broadcast_to(px, shape).reshape(ny * nx, tile_h * tile_w),
            torch.broadcast_to(py, shape).reshape(ny * nx, tile_h * tile_w))


# --------------------------------------------------------------------------
# head composite
# --------------------------------------------------------------------------

def record_matrix(pr, p00, p11, pad_to, dtype):
    """(10, pad_to) records [mx/p00, my/p11, v0x, v0y, 1/l0, 1/l1, r, g, b,
    a_eff], zero past the splats; rounded through `dtype`."""
    a_eff = pr["opacity"] * pr["a"] * pr["valid"].to(pr["mx"].dtype)
    inv_p = 1.0 / torch.stack([torch.as_tensor(p00), torch.as_tensor(p11)]
                              ).to(device=pr["mx"].device,
                                   dtype=pr["mx"].dtype)

    def recip(x):
        return torch.where(x != 0.0, 1.0 / x, 0.0)
    n = pr["mx"].shape[0]
    out = pr["mx"].new_zeros((N_FIELDS, pad_to))
    out[:, :n] = torch.stack([pr["mx"] * inv_p[0], pr["my"] * inv_p[1],
                              pr["v0x"], pr["v0y"], recip(pr["l0"]),
                              recip(pr["l1"]), pr["r"], pr["g"], pr["b"],
                              a_eff])
    if dtype != torch.float32:
        out = out.to(dtype).to(torch.float32)
    return out


def composite_head(rec, counts, kx, ky):
    """Front-to-back composite of each tile's records rec (T, 16, M), the
    first counts[t] live: (T, 8, P) [r, g, b, a, transmittance, 0...]."""
    t_tiles, _, m = rec.shape
    p = kx.shape[2]
    acc = rec.new_zeros((t_tiles, 5, p))
    acc[:, 4] = 1.0
    n_chunks = (counts.to(torch.int64) + CHUNK - 1) // CHUNK
    for c in range(m // CHUNK):
        go = (c < n_chunks) & (acc[:, 4].amax(dim=1) > 1e-6)
        idx = go.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        r = rec[idx, :, c * CHUNK:(c + 1) * CHUNK]

        def field(f):
            return r[:, f, :, None]
        dx = kx[idx] - field(0)
        dy = ky[idx] - field(1)
        v0x, v0y = field(2), field(3)
        n0 = (v0x * dx + v0y * dy) * field(4)
        n1 = (v0y * dx - v0x * dy) * field(5)
        w = torch.exp(-0.5 * (64.0 * (n0 * n0 + n1 * n1)))
        cover = (torch.abs(n0) <= 0.5) & (torch.abs(n1) <= 0.5) & (w >= 1e-4)
        alpha = torch.clamp(torch.where(cover, field(9) * w, 0.0),
                            max=ALPHA_MAX)
        cp = torch.cumprod(1.0 - alpha, dim=1)
        excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        a = acc[idx]
        trans = a[:, 4:5]
        wgt = alpha * (trans * excl)
        a[:, 0] += (wgt * r[:, 6, :, None]).sum(dim=1)
        a[:, 1] += (wgt * r[:, 7, :, None]).sum(dim=1)
        a[:, 2] += (wgt * r[:, 8, :, None]).sum(dim=1)
        a[:, 3] += (alpha * wgt).sum(dim=1)
        a[:, 4] = trans[:, 0] * cp[:, -1]
        acc[idx] = a
    out = rec.new_zeros((t_tiles, 8, p))
    out[:, 0:5] = acc
    return out


def head_carry(rec_all, binning, kx, ky, m):
    """The head composite over every tile, HEAD_BLOCK_TILES at a time."""
    counts = binning["head_counts"]
    starts = binning["tile_start"][:-1]
    pair_pad = torch.cat([binning["pair_splat"],
                          binning["pair_splat"].new_zeros((m,))])
    dev = kx.device
    outs = []
    for lo in range(0, counts.shape[0], HEAD_BLOCK_TILES):
        hi = min(counts.shape[0], lo + HEAD_BLOCK_TILES)
        idx = starts[lo:hi].long()[:, None] + torch.arange(m, device=dev)
        rows = pair_pad[idx]
        live = (torch.arange(m, device=dev)[None, :]
                < counts[lo:hi, None])
        rec = rec_all.new_zeros((hi - lo, F_ROWS, m))
        rec[:, :N_FIELDS] = rec_all[:, rows].permute(1, 0, 2)
        rec[:, 9] *= live.to(rec_all.dtype)
        outs.append(composite_head(rec, torch.clamp(counts[lo:hi], max=m),
                                   kx[lo:hi], ky[lo:hi]))
    return torch.cat(outs)


# --------------------------------------------------------------------------
# banded tail
# --------------------------------------------------------------------------

def ny_padded(ny):
    return -(-(ny + WIN_TY) // 8) * 8


def band_cuts(sample_keys, k_bands):
    dead_d = -(1 << QUANT_DEPTH_BITS)
    d = torch.where(sample_keys == INT32_MAX, dead_d,
                    -(sample_keys & ((1 << QUANT_DEPTH_BITS) - 1)))
    ds = torch.sort(d).values
    m = (ds > dead_d).sum(dtype=torch.int32)
    start = ds.shape[0] - m
    qs = start + torch.div(
        torch.arange(1, k_bands, dtype=torch.int32, device=ds.device) * m,
        k_bands, rounding_mode="floor")
    return ds[torch.clamp(qs, max=ds.shape[0] - 1).long()]


def chunk_bands(meta, chunk, cuts, budget_lo, budget_hi):
    """Each chunk's band: its live entries' mean depth bits (an int32 sum
    that wraps, a floor division) against the band cuts."""
    dbits, span = meta[4].reshape(-1, chunk), meta[5].reshape(-1, chunk)
    live = (span > budget_lo) & (span <= budget_hi)
    d_sum = torch.where(live, dbits, 0).sum(dim=1, dtype=torch.int32)
    d_cnt = torch.clamp(live.sum(dim=1, dtype=torch.int32), min=1)
    d_mean = torch.div(d_sum, d_cnt, rounding_mode="floor")
    return ((-d_mean)[:, None] >= cuts[None, :].to(torch.int32)).sum(
        dim=1, dtype=torch.int32)


def tail_params(tile_h, tile_w, block, w, h, p00, p11, ty_base):
    by, bx = block
    p00 = torch.as_tensor(p00, dtype=torch.float32)
    p11 = torch.as_tensor(p11, dtype=torch.float32, device=p00.device)

    def c(x):
        return p00.new_tensor(x)
    return torch.stack([
        c(tile_w * 2.0 / w) / p00, c(bx * 2.0 / w) / p00,
        c((bx * 0.5) * 2.0 / w - 1.0) / p00,
        c(-(tile_h * 2.0 / h)) / p11, c(-(by * 2.0 / h)) / p11,
        c(1.0 - (ty_base * tile_h + by * 0.5) * 2.0 / h) / p11,
        (c(bx * 2.0 / w) / p00) ** 2 / c(12.0),
        (c(by * 2.0 / h) / p11) ** 2 / c(12.0)])


def tail_accumulate(fields, meta, band, cut, prow, k_bands, nx, ny, chunk,
                    budget, s_cy, s_cx, budget_lo, exact_clip):
    """The six tail planes of every live (splat, slot) of a stream, summed
    per (band, tile column, tile row) and coarse sample; TAIL_BLOCK_SPLATS
    splats at a time."""
    n_samp = s_cy * s_cx
    npts = meta.shape[1]
    ny_pad = ny_padded(ny)
    dev, dtype = meta.device, fields.dtype
    acc = torch.zeros((k_bands * nx * ny_pad, N_PLANES * n_samp),
                      dtype=dtype, device=dev)
    jidx = torch.arange(n_samp, device=dev)
    jx = (jidx % s_cx).to(dtype)
    jy = torch.div(jidx, s_cx, rounding_mode="floor").to(dtype)
    cut_pad = F.pad(cut.to(torch.int32), (0, CUT_ENTRIES - cut.shape[0]),
                    value=INT32_MAX)
    kx_t, kx_j, kx_0, ky_t, ky_j, ky_0, bx2, by2 = prow.unbind()
    step = max(chunk, TAIL_BLOCK_SPLATS // chunk * chunk)
    for p0 in range(0, npts, step):
        p1 = min(npts, p0 + step)
        tx0, tx1, ty0, ty1, dbits, span = meta[:, p0:p1]
        band_b = torch.repeat_interleave(band[p0 // chunk:p1 // chunk], chunk)
        nxs = torch.clamp(tx1 - tx0 + 1, min=1)
        for s in range(budget):
            oy = s // nxs
            ox = s - oy * nxs
            live = ((s < span) & (span > budget_lo) & (span <= budget)
                    & (oy <= ty1 - ty0))
            tx, ty = tx0 + ox, ty0 + oy
            tid = ty * nx + tx
            key = (tid << QUANT_DEPTH_BITS) | dbits
            live &= key > cut_pad[torch.clamp(tid, 0, CUT_ENTRIES - 1).long()]
            idx = live.nonzero().squeeze(1)
            if idx.numel() == 0:
                continue
            f = fields[:, p0 + idx]
            sx, sy, v0x, v0y, il0, il1 = f[:6]
            c0 = bx2 * (v0x * v0x) + by2 * (v0y * v0y)
            c1 = bx2 * (v0y * v0y) + by2 * (v0x * v0x)
            m0 = 1.0 / torch.sqrt(1.0 + c0 * (il0 * il0))
            m1 = 1.0 / torch.sqrt(1.0 + c1 * (il1 * il1))
            il0w, il1w = il0 * m0 * QSCALE, il1 * m1 * QSCALE
            gate = f[9] * (m0 * m1)
            kxs = kx_t * tx[idx].to(dtype)[:, None] + kx_j * jx[None, :] + kx_0
            kys = ky_t * ty[idx].to(dtype)[:, None] + ky_j * jy[None, :] + ky_0
            dx, dy = kxs - sx[:, None], kys - sy[:, None]
            n0 = (v0x[:, None] * dx + v0y[:, None] * dy) * il0w[:, None]
            n1 = (v0y[:, None] * dx - v0x[:, None] * dy) * il1w[:, None]
            w = torch.exp(-(n0 * n0 + n1 * n1))
            cov = w >= 1e-4
            if exact_clip:
                cov &= ((torch.abs(n0) <= (0.5 * QSCALE) * m0[:, None])
                        & (torch.abs(n1) <= (0.5 * QSCALE) * m1[:, None]))
            alpha = torch.clamp(torch.where(cov, gate[:, None] * w, 0.0),
                                max=ALPHA_MAX)
            cr, cg, cb = f[6:9]
            planes = torch.cat([alpha, alpha * cr[:, None],
                                alpha * cg[:, None], alpha * cb[:, None],
                                alpha * alpha, torch.log1p(-alpha)], dim=1)
            row = band_b[idx] * (nx * ny_pad) + tx[idx] * ny_pad + ty[idx]
            acc.index_add_(0, row.long(), planes)
    return acc


def fold_upsample(acc, k_bands, nx, ny, tile_h, tile_w, s_cy, s_cx):
    """Fold the bands front to back per coarse sample, then upsample the
    coarse image bilinearly: (ny * nx, 5, tile_h * tile_w)."""
    n_samp = s_cy * s_cx
    a = acc.reshape(k_bands, nx, ny_padded(ny), N_PLANES, n_samp)[:, :, :ny]
    a = a.permute(2, 1, 0, 3, 4).reshape(ny * nx, k_bands, N_PLANES, n_samp)
    has = a[:, :, P_A] > 0.0
    a_safe = torch.where(has, a[:, :, P_A], 1.0)
    tau = torch.exp(a[:, :, P_L])
    t_run = torch.cumprod(tau, dim=1)
    t_excl = torch.cat([torch.ones_like(t_run[:, :1]), t_run[:, :-1]], dim=1)
    wgt = torch.where(has, t_excl * (1.0 - tau) / a_safe, 0.0)
    rgb = torch.einsum("tks,tcks->tcs", wgt,
                       a[:, :, P_AR:P_AB + 1].permute(0, 2, 1, 3))
    alpha = (wgt * a[:, :, P_A2]).sum(dim=1)
    coarse = torch.cat([rgb, alpha[:, None], t_run[:, -1][:, None]], dim=1)
    img_c = coarse.reshape(ny, nx, 5, s_cy, s_cx).permute(2, 0, 3, 1, 4) \
        .reshape(1, 5, ny * s_cy, nx * s_cx)
    up = F.interpolate(img_c, size=(ny * tile_h, nx * tile_w),
                       mode="bilinear", align_corners=False)[0]
    return up.reshape(5, ny, tile_h, nx, tile_w).permute(1, 3, 0, 2, 4) \
        .reshape(ny * nx, 5, tile_h * tile_w)


def apply_tail(out, pr, binning, p00, p11, cfg, w, h, fields, band):
    th, tw = cfg["tile_h"], cfg["tile_w"]
    ny, nx = tile_grid(w, h, th, tw)
    alive, tx0, tx1, ty0, ty1 = tile_bbox(pr, p00, p11, w, h, th, tw)
    ty_base = 0
    if band is not None:
        ty_base = band[0]
        alive, ty0, ty1, ny = clip_to_band(alive, ty0, ty1, band)
    dbits = depth_bits(pr["depth"])
    cut = binning["prune_cut"]
    k_bands = cfg["tail_bands"]
    n = dbits.shape[0]
    db_live = torch.where(alive, dbits, DEAD)
    if n >= 16384 and n % 128 == 0:
        db_live = sample_blocks(db_live, 64, 1)
    cuts = band_cuts(db_live, k_bands)
    by, bx = cfg["tail_block"]
    s_cy, s_cx = th // by, tw // bx
    prow = tail_params(th, tw, cfg["tail_block"], w, h, p00, p11, ty_base)
    chunk = cfg["tail_chunk"]
    budget = cfg["max_tiles_per_splat"]
    npad = -(-n // chunk) * chunk
    span = torch.where(alive, (tx1 - tx0 + 1) * (ty1 - ty0 + 1), 0)
    meta = tx0.new_zeros((6, npad))
    meta[:, :n] = torch.stack([tx0, tx1, ty0, ty1, dbits, span])
    clip = cfg["tail_exact_clip"]
    acc = tail_accumulate(fields, meta, chunk_bands(meta, chunk, cuts, 0,
                                                    budget),
                          cut, prow, k_bands, nx, ny, chunk, budget, s_cy,
                          s_cx, 0, clip)
    ids = binning["big_ids"]
    safe = torch.clamp(ids, max=n - 1).long()
    bfields = fields[:, safe]
    meta_b = torch.where((ids == DEAD)[None, :], 0, meta[:, safe])
    chunk_b = min(512, -(-ids.shape[0] // 8) * 8)
    npad_b = -(-ids.shape[0] // chunk_b) * chunk_b
    meta_b = F.pad(meta_b, (0, npad_b - ids.shape[0]))
    big = cfg["big_splat_budget"]
    bfields = F.pad(bfields, (0, npad_b - bfields.shape[1]))
    acc = acc + tail_accumulate(bfields, meta_b,
                                chunk_bands(meta_b, chunk_b, cuts, budget,
                                            big),
                                cut, prow, k_bands, nx, ny, chunk_b, big,
                                s_cy, s_cx, budget, clip)
    upt = fold_upsample(acc, k_bands, nx, ny, th, tw, s_cy, s_cx)
    t_head = out[:, 4:5]
    return torch.cat([out[:, 0:4] + t_head * upt[:, 0:4],
                      t_head * upt[:, 4:5], out[:, 5:8]], dim=1)


# --------------------------------------------------------------------------
# the frame
# --------------------------------------------------------------------------

def render(params: Dict[str, torch.Tensor], position, orientation, t: float,
           width: int, height: int, far: float = 5000.0,
           cfg: Optional[dict] = None, records_dtype=torch.float32):
    """The converged frame of the padded, Morton-ordered scene `params` at
    the camera pose (fov 60 degrees, near 0.1, `far`) and time t: (image
    (H, W, 4), counters dict). `cfg` defaults to frame_config(n, width,
    height) with n the padded splat count."""
    dev = params["px"].device
    if cfg is None:
        cfg = frame_config(params["px"].shape[0], width, height)
    view, proj, eye = camera_matrices(position, orientation, width, height,
                                      dev, far=far)
    p00, p11 = proj[0, 0], proj[1, 1]
    pr = project(params, view, proj, eye, t)
    th, tw, m = cfg["tile_h"], cfg["tile_w"], cfg["max_splats_per_tile"]
    ny0, nx0 = tile_grid(width, height, th, tw)
    if ny0 * nx0 >= TILE_LIMIT:
        rows_per_band = max(1, TILE_LIMIT // nx0)
        n_bands = -(-ny0 // rows_per_band)
    else:
        rows_per_band, n_bands = ny0, 1
    px, py = tile_pixels(width, height, th, tw, dev)
    bg = torch.tensor(cfg["background"], dtype=torch.float32, device=dev)
    n = pr["mx"].shape[0]
    npts = -(-n // cfg["tail_chunk"]) * cfg["tail_chunk"]
    rec_all = record_matrix(pr, p00, p11, npts, records_dtype)
    tiles, counters = [], dict(overflowed=0, compact_dropped=0,
                               resid_transmittance=0.0)
    for b in range(n_bands):
        lo_row = b * rows_per_band
        nb = min(rows_per_band, ny0 - lo_row)
        band = None if n_bands == 1 else (lo_row, nb)
        binning = bin_band(pr, p00, p11, cfg, width, height, band)
        px_b = px[lo_row * nx0:(lo_row + nb) * nx0]
        py_b = py[lo_row * nx0:(lo_row + nb) * nx0]
        t_tiles, p = px_b.shape
        kx = (px_b / p00).reshape(t_tiles, 1, p)
        ky = (py_b / p11).reshape(t_tiles, 1, p)
        out = head_carry(rec_all, binning, kx, ky, m)
        out = apply_tail(out, pr, binning, p00, p11, cfg, width, height,
                         rec_all, band)
        rgb = out[:, 0:3, :] + out[:, 4:5, :] * bg[:3, None]
        a = out[:, 3, :] + out[:, 4, :] * bg[3]
        tiles.append(torch.cat([rgb, a[:, None, :]], dim=1).permute(0, 2, 1))
        counts = binning["head_counts"]
        truncated = (counts - torch.clamp(counts, max=m)) > 0
        resid = (out[:, 4, :] * truncated[:, None]).max()
        counters["overflowed"] += int(binning["overflowed"])
        counters["compact_dropped"] += int(binning["compact_dropped"])
        counters["resid_transmittance"] = max(
            counters["resid_transmittance"], float(resid))
        del binning, out
    img = torch.cat(tiles).reshape(ny0, nx0, th, tw, 4)
    img = img.permute(0, 2, 1, 3, 4).reshape(ny0 * th, nx0 * tw, 4)
    return img[:height, :width], counters
