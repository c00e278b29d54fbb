"""Per-tile ordered alpha compositing over packed splat records (port of
fourdgs/ops/composite_pallas.py: `record_fields` (with `pad_to`, through the
pack kernel K4), `pack_records` without pack8, `identity_carry`,
`composite_records`, `composite_records_at`, their custom VJPs, and
`composite_tiles_pallas`, the tile-list form of the composite).

Kernels K1 (`csrc/composite.cu`, the forward) and K8
(`csrc/composite_bwd.cu`, the backward), each with its plain PyTorch
version. A CPU tensor runs the plain versions; a CUDA tensor launches the
kernels. Both walk a tile's records the same way (`csrc/composite_walk.cuh`:
records outside, pixels inside, a warp skipping each record whose cull box
misses its pixels); `composite_cull_boxes`, `walk_tile_width`,
`walk_pixel_map` and `composite_walk_keep` model that walk in plain PyTorch,
and the plain versions take its mask (`keep=`) to show that it changes no
bit. `composite_records` and `composite_records_at` are autograd
Functions: they differentiate the records and the carry, as the reference's
`jax.custom_vjp`s do.

Layouts are the reference's: records (T, F=16, M) with the 10 field rows
first; pixel coordinates kx, ky (T, 1, P) in k units; carry and output
(T, 8, P) with rows r, g, b, a (sum alpha^2 T), transmittance, 0, 0, 0.
The plain versions also take float64 CPU tensors (for gradcheck); the
kernels take float32 only.
"""

from __future__ import annotations

import ctypes

import torch
from torch.profiler import record_function

from fourdgs_torch import resolve_device
from fourdgs_torch.ops import pack_cuda
from fourdgs_torch.ops._build import CudaKernel

CHUNK = 128      # records per early-exit step
_F = 16          # record rows (10 fields + zero padding)
N_FIELDS = 10
_C_SX, _C_SY, _C_V0X, _C_V0Y = 0, 1, 2, 3
_C_IL0, _C_IL1 = 4, 5
_C_R, _C_G, _C_B, _C_AEFF = 6, 7, 8, 9

ALPHA_MAX = 1.0 - 1e-6
# Margins of the cull box (csrc/composite_walk.cuh `kBoxRel`, `kBoxAbs`).
BOX_REL, BOX_ABS = 1e-3, 1e-6
# Pixels a thread at most, K1 and K8 (their `Shape`s in csrc/composite.cu
# and csrc/composite_bwd.cu).
K1_PPT, K8_PPT = 4, 8
# Tiles per batch of the plain backward: bounds its (tiles, 128, P)
# temporaries on the card at the 10M-splat frame.
PLAIN_BATCH_TILES = 64

# Every multiply and add rounds on its own, as in the plain version: a
# contracted multiply-add can flip the coverage tests at their edges.
_FLAGS = ("-fmad=false",)
COMPOSITE = CudaKernel(
    "composite.cu", "fourdgs_composite",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4, extra_flags=_FLAGS)
COMPOSITE_BWD = CudaKernel(
    "composite_bwd.cu", "fourdgs_composite_bwd",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4, extra_flags=_FLAGS)


def record_fields(proj, p00, p11, pad_to: int | None = None) -> torch.Tensor:
    """(10, N) record field matrix for every projected splat. a_eff
    premultiplies color alpha, temporal opacity and the cull flag; centers
    are in k units (NDC offset over the projection diagonal).

    With pad_to, the matrix is (10, pad_to) with zero columns past N, built
    by the pack kernel K4 (ops/pack_cuda.py) exactly as the reference's
    pack kernel builds it: centers times 1/p00 and 1/p11, and l == 0 maps
    to il == 0."""
    a_eff = proj.opacity * proj.a * proj.valid.to(proj.mx.dtype)
    if pad_to is not None:
        return pack_cuda.pack_record_fields(
            proj.mx, proj.my, proj.v0x, proj.v0y, proj.l0, proj.l1, proj.r,
            proj.g, proj.b, a_eff, p00, p11, pad_to)
    return torch.stack([
        proj.mx / p00,
        proj.my / p11,
        proj.v0x, proj.v0y,
        1.0 / proj.l0, 1.0 / proj.l1,
        proj.r, proj.g, proj.b,
        a_eff,
    ], dim=0)


def pack_records(proj, tile_splat: torch.Tensor, tile_live: torch.Tensor,
                 p00, p11, rec: torch.Tensor | None = None) -> torch.Tensor:
    """Gather per-tile splat records into the kernel layout (T, 16, M);
    tile_live zeroes a_eff of dead list entries."""
    if rec is None:
        rec = record_fields(proj, p00, p11)
    t, m = tile_splat.shape
    out = rec.new_zeros((t, _F, m))
    out[:, :N_FIELDS] = rec[:, tile_splat].permute(1, 0, 2)
    out[:, _C_AEFF] *= tile_live.to(rec.dtype)
    return out


def identity_carry(t_tiles: int, p: int, device=None,
                   dtype=torch.float32) -> torch.Tensor:
    """(T, 8, P) carry for the first depth slab: empty accumulators, full
    transmittance; on `device` (None: the card, default_device())."""
    c = torch.zeros((t_tiles, 8, p), dtype=dtype,
                    device=resolve_device(device))
    c[:, 4] = 1.0
    return c


def walk_shape(p: int, max_ppt: int) -> tuple[int, int]:
    """(threads, pixels a thread) of a block of K1 (max_ppt = K1_PPT) or K8
    (K8_PPT) at p pixels a tile, as `Shape` of csrc/composite_walk.cuh."""
    threads = max(256, p // max_ppt)
    return threads, p // threads


def composite_cull_boxes(records: torch.Tensor) -> torch.Tensor:
    """(T, 4, M) cull boxes (x_lo, x_hi, y_lo, y_hi) of records (T, F, M),
    in k units, as `record_box` of csrc/composite_walk.cuh computes them
    (same operations, same order): the axis-aligned box of the region
    |n0| <= 0.5, |n1| <= 0.5, widened by BOX_REL of its half-widths' sum and
    BOX_ABS per unit of the centre's magnitude; infinite (no cull) where il0
    or il1 is 0, |v0|^2 is 0 or not a normal float, or a field is NaN."""
    sx, sy, v0x, v0y, il0, il1 = records[:, :6].unbind(1)
    fin = torch.finfo(records.dtype)
    a0, a1 = il0.abs(), il1.abs()
    s = v0x * v0x + v0y * v0y
    bounded = (a0 > 0) & (a1 > 0) & (s >= fin.tiny) & (s <= fin.max)
    ax, ay = v0x.abs(), v0y.abs()
    h0, h1 = 0.5 / a0, 0.5 / a1
    hx = (ax * h0 + ay * h1) / s
    hy = (ay * h0 + ax * h1) / s
    rel = BOX_REL * (hx + hy)
    mx = hx + rel + BOX_ABS * (1.0 + sx.abs())
    my = hy + rel + BOX_ABS * (1.0 + sy.abs())
    box = torch.stack([sx - mx, sx + mx, sy - my, sy + my], dim=1)
    unbounded = torch.tensor([-1.0, 1.0, -1.0, 1.0], dtype=records.dtype,
                             device=records.device)[None, :, None] * torch.inf
    return torch.where(bounded[:, None], box, unbounded)


def walk_tile_width(ky: torch.Tensor, threads: int) -> torch.Tensor:
    """(T,) row width each block of `threads` finds from ky (T, 1, P), as
    `walk_tile_width` of csrc/composite_walk.cuh: the first pixel among 1 ..
    threads whose ky differs from pixel 0's, kept if it is 32 x a divisor of
    the warps (the compact map), else 0 (the strided map)."""
    p = ky.shape[-1]
    row = ky[:, 0, 1:min(threads + 1, p)] != ky[:, 0, :1]
    first = torch.where(row.any(dim=1), row.to(torch.int8).argmax(dim=1) + 1,
                        p)
    strips = first // 32
    ok = ((first % 32 == 0) & (strips >= 1)
          & ((threads // 32) % strips.clamp(min=1) == 0) & (p % first == 0))
    return torch.where(ok, first, 0)


def walk_pixel_map(p: int, tw: int, max_ppt: int) -> torch.Tensor:
    """(warps, 32 x PPT) pixels each warp owns in a tile of p pixels and row
    width tw (0: the strided map), for the kernel of `max_ppt`, as
    `walk_pixel` of csrc/composite_walk.cuh: compact, warp w owns columns
    32 (w % strips) .. + 31 of rows (w / strips) PPT .. + PPT - 1; strided,
    thread t owns pixels t + threads j."""
    threads, ppt = walk_shape(p, max_ppt)
    t = torch.arange(threads)[:, None]
    j = torch.arange(ppt)[None, :]
    if tw > 0:
        strips, w = tw // 32, t // 32
        pix = ((w // strips) * ppt + j) * tw + (w % strips) * 32 + t % 32
    else:
        pix = t + j * threads
    return pix.reshape(threads // 32, 32 * ppt)


def walk_warp_hits(boxes, kx, ky, pix) -> torch.Tensor:
    """(T, M, W) whether each record's box (boxes (T, 4, M)) meets the box
    of the pixels warp w owns, pix (W, L) the pixels of each warp (a
    `walk_pixel_map`). A NaN edge meets every patch."""
    pix = pix.to(kx.device)
    x, y = kx[:, 0][:, pix], ky[:, 0][:, pix]                 # (T, W, L)
    x_lo, x_hi = x.amin(-1)[:, None], x.amax(-1)[:, None]      # (T, 1, W)
    y_lo, y_hi = y.amin(-1)[:, None], y.amax(-1)[:, None]
    b = boxes[..., None]                                       # (T, 4, M, 1)
    miss = ((b[:, 0] > x_hi) | (b[:, 1] < x_lo) | (b[:, 2] > y_hi)
            | (b[:, 3] < y_lo))
    return ~miss


def composite_walk_keep(records, kx, ky, max_ppt: int,
                        counts=None) -> torch.Tensor:
    """(T, M, P) the (record, pixel) pairs the walk of K1 (max_ppt = K1_PPT,
    with `counts`) or K8 (K8_PPT, without) visits: the record's box meets
    the box of the pixels of the warp that owns the pixel; with `counts`,
    also the record comes before counts[t] (K8 visits the padding too).
    Every pair outside is one the coverage test rejects (or, past the count,
    one whose a_eff is 0), so the plain versions given this mask (`keep=`)
    return the same bits."""
    t, _, m = records.shape
    p = kx.shape[-1]
    boxes = composite_cull_boxes(records)
    tw = walk_tile_width(ky, walk_shape(p, max_ppt)[0])
    keep = torch.zeros((t, m, p), dtype=torch.bool, device=records.device)
    for width in torch.unique(tw).tolist():
        idx = (tw == width).nonzero().squeeze(1)
        pix = walk_pixel_map(p, width, max_ppt)
        warp_of = torch.arange(pix.shape[0]).repeat_interleave(pix.shape[1])
        owner = torch.empty(p, dtype=torch.long)
        owner[pix.reshape(-1)] = warp_of
        hits = walk_warp_hits(boxes[idx], kx[idx], ky[idx], pix)
        keep[idx] = hits[:, :, owner.to(records.device)]
    if counts is not None:
        keep &= (torch.arange(m, device=records.device)[None, :, None]
                 < counts.to(records.device)[:, None, None])
    return keep


def _chunk_alpha(rec, kx, ky, keep=None):
    """Coverage and alpha of one chunk of records rec (A, F, C) at the
    pixels kx, ky (A, 1, P): (dx, dy, e0, e1, n0, n1, w, cover, aw, alpha),
    each (A, C, P), in the kernels' order of operations; `keep` (A, C, P),
    where given, drops the pairs outside it from the cover."""
    def field(f):
        return rec[:, f, :, None]                          # (A, C, 1)
    dx = kx - field(_C_SX)
    dy = ky - field(_C_SY)
    v0x, v0y = field(_C_V0X), field(_C_V0Y)
    e0 = v0x * dx + v0y * dy
    e1 = v0y * dx - v0x * dy
    n0 = e0 * field(_C_IL0)
    n1 = e1 * field(_C_IL1)
    q = 64.0 * (n0 * n0 + n1 * n1)
    w = torch.exp(-0.5 * q)
    cover = (torch.abs(n0) <= 0.5) & (torch.abs(n1) <= 0.5) & (w >= 1e-4)
    if keep is not None:
        cover = cover & keep
    aw = field(_C_AEFF) * w
    alpha = torch.clamp(torch.where(cover, aw, 0.0), max=ALPHA_MAX)
    return dx, dy, e0, e1, n0, n1, w, cover, aw, alpha


def composite_plain(records, counts, kx, ky, carry, keep=None
                    ) -> torch.Tensor:
    """The kernel's function on tile-aligned inputs: records (T, F, M),
    counts (T,), kx/ky (T, 1, P), carry (T, 8, P) -> new (T, 8, P).

    Chunk c of tile t runs only if c < ceil(counts[t] / 128) and the tile's
    max transmittance is above 1e-6 (the tile-wide early exit); within a
    chunk the exclusive transmittance is a sequential product. `keep`
    (T, M, P), where given, composites only those (record, pixel) pairs
    (`composite_walk_keep` with K1_PPT and counts: the pairs K1 visits).
    Not autograd-safe (it updates its accumulators in place);
    composite_records differentiates it."""
    t_tiles, _, m = records.shape
    acc = carry[:, 0:5].clone()                      # (T, 5, P)
    n_chunks = (counts.to(torch.int64) + CHUNK - 1) // CHUNK
    for c in range(m // CHUNK):
        go = (c < n_chunks) & (acc[:, 4].amax(dim=1) > 1e-6)
        idx = go.nonzero().squeeze(1)
        if idx.numel() == 0:
            break       # T only falls, so no tile reopens in later chunks
        cols = slice(c * CHUNK, (c + 1) * CHUNK)
        rec = records[idx, :, cols]                        # (A, F, C)
        alpha = _chunk_alpha(rec, kx[idx], ky[idx],
                             None if keep is None else keep[idx, cols])[-1]
        cp = torch.cumprod(1.0 - alpha, dim=1)
        excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        a = acc[idx]
        trans = a[:, 4:5]                                  # (A, 1, P)
        wgt = alpha * (trans * excl)
        a[:, 0] += (wgt * rec[:, _C_R, :, None]).sum(dim=1)
        a[:, 1] += (wgt * rec[:, _C_G, :, None]).sum(dim=1)
        a[:, 2] += (wgt * rec[:, _C_B, :, None]).sum(dim=1)
        a[:, 3] += (alpha * wgt).sum(dim=1)
        a[:, 4] = trans[:, 0] * cp[:, -1]
        acc[idx] = a
    out = torch.zeros_like(carry)
    out[:, 0:5] = acc
    return out


def _composite_bwd_tiles(records, counts, kx, ky, carry, fwd_out, g,
                         keep=None):
    """composite_bwd_plain on one batch of tiles."""
    m = records.shape[2]
    d_rec = torch.zeros_like(records)
    gr, gg, gb, ga, gt = (g[:, i:i + 1] for i in range(5))   # (T, 1, P)
    tot = fwd_out[:, 0:4]
    gt_tfin = gt * fwd_out[:, 4:5]
    pref = carry[:, 0:4].clone()                             # (T, 4, P)
    trans = carry[:, 4:5].clone()                            # (T, 1, P)
    n_chunks = (counts.to(torch.int64) + CHUNK - 1) // CHUNK
    for c in range(m // CHUNK):
        go = (c < n_chunks) & (trans.amax(dim=(1, 2)) > 1e-6)
        idx = go.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        cols = slice(c * CHUNK, (c + 1) * CHUNK)
        rec = records[idx, :, cols]                          # (A, F, C)
        dx, dy, e0, e1, n0, n1, w, cover, aw, alpha = _chunk_alpha(
            rec, kx[idx], ky[idx], None if keep is None else keep[idx, cols])
        one_m = 1.0 - alpha
        cp = torch.cumprod(one_m, dim=1)
        excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        tr = trans[idx]
        t_i = tr * excl                                      # (A, C, P)
        wgt = alpha * t_i
        cr, cg, cb = (rec[:, f, :, None] for f in (_C_R, _C_G, _C_B))
        incl = pref[idx][:, :, None] + torch.cumsum(
            torch.stack([wgt * cr, wgt * cg, wgt * cb, alpha * wgt], dim=1),
            dim=2)                                           # (A, 4, C, P)
        gi = [x[idx] for x in (gr, gg, gb, ga)]
        suffix = tot[idx][:, :, None] - incl
        num = (gi[0] * suffix[:, 0] + gi[1] * suffix[:, 1]
               + gi[2] * suffix[:, 2] + gi[3] * suffix[:, 3] + gt_tfin[idx])
        d_alpha = ((gi[0] * cr + gi[1] * cg + gi[2] * cb) * t_i
                   + gi[3] * 2.0 * alpha * t_i - num / one_m)
        d_aw = torch.where(cover & (aw < ALPHA_MAX), d_alpha, 0.0)
        v0x, v0y, il0, il1, a_eff = (rec[:, f, :, None] for f in (
            _C_V0X, _C_V0Y, _C_IL0, _C_IL1, _C_AEFF))
        d_q = d_aw * a_eff * w * (-0.5)
        dn0 = 128.0 * n0 * d_q
        dn1 = 128.0 * n1 * d_q
        d_rec[idx, :N_FIELDS, cols] = torch.stack([
            -dn0 * v0x * il0 - dn1 * v0y * il1,
            -dn0 * v0y * il0 + dn1 * v0x * il1,
            dn0 * dx * il0 - dn1 * dy * il1,
            dn0 * dy * il0 + dn1 * dx * il1,
            dn0 * e0, dn1 * e1,
            gi[0] * wgt, gi[1] * wgt, gi[2] * wgt,
            d_aw * w], dim=1).sum(dim=3)
        pref[idx] = incl[:, :, -1]
        trans[idx] = tr * cp[:, -1:]
    return d_rec


def composite_bwd_plain(records, counts, kx, ky, carry, fwd_out, g,
                        keep=None):
    """The backward kernel's function (the reference's
    `_composite_bwd_kernel`): d_records (T, 16, M) of the forward
    records (T, 16, M), counts, kx/ky (T, 1, P), carry -> fwd_out (T, 8, P)
    under the upstream cotangent g (T, 8, P). It re-runs the forward walk
    with its early exit, takes the suffix sums as the saved totals minus
    the inclusive prefix, and fills the ten field rows (rows 10-15 stay 0).
    `keep` (T, M, P), where given, takes only those (record, pixel) pairs
    (`composite_walk_keep` with K8_PPT, without counts: the pairs K8
    visits). Tiles are
    processed PLAIN_BATCH_TILES at a time."""
    d_rec = torch.zeros_like(records)
    for t0 in range(0, records.shape[0], PLAIN_BATCH_TILES):
        sl = slice(t0, t0 + PLAIN_BATCH_TILES)
        d_rec[sl] = _composite_bwd_tiles(
            records[sl], counts[sl], kx[sl], ky[sl], carry[sl], fwd_out[sl],
            g[sl], None if keep is None else keep[sl])
    return d_rec


def carry_cotangent(carry, fwd_out, g) -> torch.Tensor:
    """The closed-form cotangent of the incoming carry (the reference's
    `_composite_bwd`): the accumulators pass through, d = g; every
    contribution and the outgoing T scale with the incoming T, so
    d T_in = [g . (out - carry) over rows 0-3 + g_T T_out] / T_in (0 where
    T_in is 0)."""
    trans_in = carry[:, 4:5]
    num = ((g[:, 0:4] * (fwd_out[:, 0:4] - carry[:, 0:4])).sum(
        dim=1, keepdim=True) + g[:, 4:5] * fwd_out[:, 4:5])
    d_trans = torch.where(trans_in > 0.0,
                          num / torch.clamp(trans_in, min=1e-30), 0.0)
    return torch.cat([g[:, 0:4], d_trans, torch.zeros_like(g[:, 5:8])], dim=1)


def _check(records, counts, kx, ky, carry, n_sel=None):
    t, f, m = records.shape
    if f != _F or m % CHUNK:
        raise ValueError(f"records must be (T, {_F}, M), M % {CHUNK} == 0; "
                         f"got {tuple(records.shape)}")
    tiles, _, p = carry.shape
    if carry.shape != (tiles, 8, p) or kx.shape != (tiles, 1, p) \
            or ky.shape != (tiles, 1, p):
        raise ValueError("carry must be (T, 8, P) and kx, ky (T, 1, P)")
    if counts.shape != (t,) or (n_sel is None and t != tiles):
        raise ValueError("counts must be (T,) and match the records")
    for x in (counts, kx, ky, carry):
        if x.device != records.device:
            raise ValueError("all composite inputs must share a device")
    if records.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {records.device}")
    # float64 only for the plain versions (CPU), e.g. under gradcheck.
    ok = (torch.float32,) if records.device.type == "cuda" else (
        torch.float32, torch.float64)
    for x in (kx, ky, carry):
        if records.dtype not in ok or x.dtype != records.dtype:
            raise ValueError("records, kx, ky and carry must be float32 "
                             "(float64 only on the CPU)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def deepest_first(counts: torch.Tensor) -> torch.Tensor:
    """The order in which K1 and K8 take their items: by descending count,
    ties in index order (int64). It decides only which tiles start first;
    the results do not depend on it."""
    return torch.argsort(counts, descending=True, stable=True)


def _launch(records, counts, sel, kx, ky, carry, out):
    records = records.contiguous()
    counts = counts.to(torch.int32).contiguous()
    kx, ky = kx.contiguous(), ky.contiguous()
    p = carry.shape[-1]
    COMPOSITE(records, counts,
              sel, deepest_first(counts), kx,
              ky, carry, out,
              records.shape[0], _F, records.shape[2], p,
              stream=_stream(records))


def composite_records_bwd(records, counts, sel, kx, ky, carry, fwd_out, g):
    """d_records (Tb, 16, M) of a composite (sel None: kx, ky, g are (Tb,
    ...) like the records) or of a deepening pass (kx, ky, g are the full
    (T, ...) tensors and block b is tile sel[b]); carry and fwd_out are the
    residuals (Tb, 8, P) of the forward. A CPU tensor runs
    composite_bwd_plain, a CUDA tensor launches K8."""
    if records.device.type == "cpu":
        if sel is not None:
            sel = sel.long()
            kx, ky, g = kx[sel], ky[sel], g[sel]
        return composite_bwd_plain(records, counts, kx, ky, carry, fwd_out, g)
    d_rec = torch.zeros_like(records)
    records = records.contiguous()
    counts = counts.to(torch.int32).contiguous()
    if sel is not None:
        sel = sel.to(torch.int32).contiguous()
    kx, ky = kx.contiguous(), ky.contiguous()
    carry, fwd_out = carry.contiguous(), fwd_out.contiguous()
    g = g.contiguous()
    COMPOSITE_BWD(records, counts,
                  sel, deepest_first(counts), kx,
                  ky, carry, fwd_out,
                  g, d_rec, records.shape[0], _F,
                  records.shape[2], kx.shape[-1], stream=_stream(records))
    return d_rec


class _Composite(torch.autograd.Function):
    """composite_records with the reference's VJP (`_composite_fwd`,
    `_composite_bwd`): K8 (or its plain version) for the records, the
    closed form for the carry."""

    @staticmethod
    def forward(ctx, records, counts, kx, ky, carry):
        if records.device.type == "cpu":
            out = composite_plain(records, counts, kx, ky, carry)
        else:
            carry = carry.contiguous()
            out = torch.empty_like(carry)
            _launch(records, counts, None, kx, ky, carry, out)
        ctx.save_for_backward(records, counts, kx, ky, carry, out)
        return out

    @staticmethod
    def backward(ctx, g):
        with record_function("fourdgs::composite_bwd"):
            records, counts, kx, ky, carry, out = ctx.saved_tensors
            g = g.contiguous()
            d_rec = d_carry = None
            if ctx.needs_input_grad[0]:
                d_rec = composite_records_bwd(records, counts, None, kx, ky,
                                              carry, out, g)
            if ctx.needs_input_grad[4]:
                d_carry = carry_cotangent(carry, out, g)
            return d_rec, None, None, None, d_carry


def composite_records(records: torch.Tensor, counts: torch.Tensor,
                      kx: torch.Tensor, ky: torch.Tensor,
                      carry: torch.Tensor) -> torch.Tensor:
    """(T, 16, M) records + (T, 8, P) carry -> new (T, 8, P): rows r, g, b,
    a, transmittance. carry holds the accumulators of an earlier (nearer)
    depth slab; use identity_carry() for the first slab. Differentiable in
    records and carry; the output is saved for the backward, so it must not
    be updated in place while a graph holds it."""
    _check(records, counts, kx, ky, carry)
    return _Composite.apply(records, counts, kx, ky, carry)


class _CompositeAt(torch.autograd.Function):
    """composite_records_at with the reference's VJP (`_composite_at_fwd`,
    `_composite_at_bwd`). Under grad the selected tiles' carry is gathered
    before the pass and their output after it (paid only then); the carry
    is updated in place and marked dirty."""

    @staticmethod
    def forward(ctx, records_sel, counts_sel, sel, kx_full, ky_full,
                carry_full):
        grad = ctx.needs_input_grad[0] or ctx.needs_input_grad[5]
        sel_l = sel.long()
        carry_sel = carry_full[sel_l] if grad else None
        if records_sel.device.type == "cpu":
            carry_full[sel_l] = composite_plain(
                records_sel, counts_sel, kx_full[sel_l], ky_full[sel_l],
                carry_full[sel_l])
        else:
            _launch(records_sel, counts_sel, sel.to(torch.int32).contiguous(),
                    kx_full, ky_full, carry_full, carry_full)
        ctx.mark_dirty(carry_full)
        if grad:
            ctx.save_for_backward(records_sel, counts_sel, sel, kx_full,
                                  ky_full, carry_sel, carry_full[sel_l])
        return carry_full

    @staticmethod
    def backward(ctx, g_full):
        with record_function("fourdgs::composite_bwd"):
            records_sel, counts_sel, sel, kx, ky, carry_sel, out_sel = \
                ctx.saved_tensors
            g_full = g_full.contiguous()
            sel_l = sel.long()
            d_rec = d_carry = None
            if ctx.needs_input_grad[0]:
                d_rec = composite_records_bwd(records_sel, counts_sel, sel, kx,
                                              ky, carry_sel, out_sel, g_full)
            if ctx.needs_input_grad[5]:
                # Unselected tiles pass the carry through: d_carry = g there.
                d_carry = g_full.clone()
                d_carry[sel_l] = carry_cotangent(carry_sel, out_sel,
                                                 g_full[sel_l])
            return d_rec, None, None, None, None, d_carry


def composite_records_at(records_sel: torch.Tensor, counts_sel: torch.Tensor,
                         sel: torch.Tensor, kx_full: torch.Tensor,
                         ky_full: torch.Tensor,
                         carry_full: torch.Tensor) -> torch.Tensor:
    """One deepening pass: composite records_sel[i] into carry tile sel[i].

    Unlike the reference, which returns a new array, this updates
    `carry_full` IN PLACE (saving a (T, 8, P) copy per pass) and returns
    it. `sel` entries must be distinct; fillers with count 0 leave their
    tile unchanged. Differentiable in records_sel and carry_full."""
    _check(records_sel, counts_sel, kx_full, ky_full, carry_full,
           n_sel=sel.shape[0])
    if sel.shape != counts_sel.shape or sel.device != records_sel.device:
        raise ValueError("sel must match counts_sel in shape and device")
    if not carry_full.is_contiguous():
        raise ValueError("carry_full must be contiguous (updated in place)")
    return _CompositeAt.apply(records_sel, counts_sel, sel, kx_full, ky_full,
                              carry_full)


def composite_tiles_pallas(proj, tile_splat: torch.Tensor,
                           tile_live: torch.Tensor, px: torch.Tensor,
                           py: torch.Tensor, p00, p11,
                           background: torch.Tensor, cfg) -> torch.Tensor:
    """Drop-in for the plain-array tiled compositor
    (render.pipeline._composite_tiles_xla) through K1: per-tile splat lists
    tile_splat / tile_live (T, M), pixel coordinates px, py (T, P) with P =
    cfg.tile_h * cfg.tile_w a multiple of 128 -> (T, P, 4) over
    `background`. Differentiable through K8."""
    t_tiles, p = px.shape
    if p != cfg.tile_h * cfg.tile_w or p % 128:
        raise ValueError(f"the composite kernel needs tile_h * tile_w = P, a "
                         f"multiple of 128; got P = {p} for "
                         f"{cfg.tile_h}x{cfg.tile_w}")
    records = pack_records(proj, tile_splat, tile_live, p00, p11)
    counts = tile_live.sum(dim=1, dtype=torch.int32)
    kx = (px / p00).reshape(t_tiles, 1, p)
    ky = (py / p11).reshape(t_tiles, 1, p)
    out = composite_records(records, counts, kx, ky,
                            identity_carry(t_tiles, p, device=px.device,
                                           dtype=px.dtype))
    rgb = out[:, 0:3, :] + out[:, 4:5, :] * background[:3, None]
    a = out[:, 3, :] + out[:, 4, :] * background[3]
    return torch.cat([rgb, a[:, None, :]], dim=1).permute(0, 2, 1)
