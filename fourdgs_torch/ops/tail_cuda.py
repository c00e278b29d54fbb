"""Streaming banded-OIT tail compositor (port of fourdgs/ops/tail_pallas.py).

The tail composites every (tile, splat) pair beyond the head's per-tile cut
(key > cut) with no sort and no gather: splats stream in chunks (in Morton
order, so a chunk is local on screen); each chunk gets one of K global depth
bands by its mean quantized depth; per (band, tile, coarse sample) the
kernel accumulates six order-independent planes

    A = sum(alpha), Ar/Ag/Ab = sum(alpha * rgb), A2 = sum(alpha^2),
    L = sum(log1p(-alpha)).

Two knobs weight the mix within a band (the reference's `use_wd` and
`alpha_pow` forms): with wd_ab (S, 2), the chunk's depth-weight
coefficients (a, b) from `band_weight_coeffs`, a pair weighs w_d =
exp(clip(a dbits + b, 0, 25)); with alpha_pow p, alpha^p more. The A, Ar,
Ag, Ab and A2 planes then carry w_d alpha^(1+p) where they carried alpha;
the L plane stays unweighted, so the band's transmittance is exact.

`fold_upsample_tail` composites the bands front to back, upsamples the
coarse field bilinearly and `blend_tail_under_head` puts it under the
head's per-pixel transmittance. The reference's module docstring gives the
design in full.

Kernels K6 (`csrc/tail_prepass.cu`, per-chunk band, window rect and slot
mask), K7 (`csrc/tail.cu`, the accumulate) and K9 (`csrc/tail_bwd.cu`, the
accumulate's backward), each with its plain PyTorch version:
`step_bands_rects` + `step_slot_masks` for K6, `tail_accumulate_plain` (the
reference's `tail_accumulate_xla`, batched) for K7,
`tail_accumulate_bwd_plain` (the chain rule of the reference's
`_tail_bwd_kernel`) for K9. A CPU tensor runs the plain version; a CUDA
tensor launches the kernel. `tail_accumulate` is an autograd Function that
differentiates `fields`; the plain versions also take float64 CPU tensors.
K7 and K9 walk the stream in units of SUB splats (`csrc/tail_unit.cuh`);
`unit_worklists`, `tail_accumulate_units` and `tail_accumulate_bwd_units`
write that walk out in plain PyTorch for the CPU tests, and `prepass_walk`
writes out K6's walk of a chunk (one block a chunk, 16-byte loads or a
scalar path).

The reference's band assignment sums a chunk's depth bits in int32, which
wraps past 2^31 for chunks with more than about 8,000 live entries (ROADMAP
C-R8); both versions here wrap the same way, so the bands agree with it.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from fourdgs_torch.ops import pack_cuda
from fourdgs_torch.ops._build import CudaKernel
from fourdgs_torch.render.tiles import QUANT_DEPTH_BITS

ALPHA_MAX = 1.0 - 1e-6
_QSCALE = math.sqrt(32.0)       # folds exp(-0.5 * 64 q) into the prescale
N_PLANES = 6                      # A, Ar, Ag, Ab, A2, L
_P_A, _P_AR, _P_AG, _P_AB, _P_A2, _P_L = range(N_PLANES)
WIN_TX = 2                        # window rect unit: 2 tile columns
WIN_TY = 16                       # x 16 tile rows, rows 8-aligned
CUT_ENTRIES = 2048                # cut table, padded with INT32_MAX
MASK_BITS = 30                    # slot-mask bits; later slots stay live
SUB = 512                         # pairs per slot-mask sub-block
INT32_MAX = 2 ** 31 - 1
_WD_CAP = 25.0                  # exponent clip of the depth weight: e^25
# Pairs per batch of the plain accumulate: bounds its (pairs, samples)
# temporaries on the card at the 10M-splat frame.
PLAIN_BATCH_PAIRS = 1 << 20

_FLAGS = ("-fmad=false",)
TAIL_PREPASS = CudaKernel(
    "tail_prepass.cu", "fourdgs_tail_prepass",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6, extra_flags=_FLAGS)
# K6: threads a block (one block a chunk).
PREPASS_THREADS = 256
TAIL_ACCUMULATE = CudaKernel(
    "tail.cu", "fourdgs_tail_accumulate",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int], extra_flags=_FLAGS)
TAIL_ACCUMULATE_BWD = CudaKernel(
    "tail_bwd.cu", "fourdgs_tail_accumulate_bwd",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 14
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int], extra_flags=_FLAGS)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def ny_padded(ny: int) -> int:
    """Accumulator rows per tile column: a window starting at an 8-aligned
    row below ny never runs past them."""
    return _ceil_to(ny + WIN_TY, 8)


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# host functions (plain PyTorch in the port, as they are XLA in the reference)
# ---------------------------------------------------------------------------

def tail_meta(alive, tx0, tx1, ty0, ty1, dbits, chunk: int) -> torch.Tensor:
    """(6, Np) int32 meta operand [tx0, tx1, ty0, ty1, dbits, span], span
    the raw bbox tile count (0 for dead splats), padded with dead entries
    to a `chunk` multiple. Which spans a stream owns is applied in the
    kernel, so one meta array serves the main and the big-tier stream."""
    return pack_cuda.pack_meta_rows(alive, tx0, tx1, ty0, ty1, dbits,
                                    _ceil_to(tx0.shape[0], chunk))


def _live_window(span, budget_lo: int, budget_hi: int):
    return (span > budget_lo) & (span <= budget_hi)


def step_bands_rects(meta, chunk: int, band_cuts, budget_lo: int = 0,
                     budget_hi: int = 1 << 30):
    """Per chunk of `chunk` splats: (band (S,), rect (S, 4) = [txw, tyw, nwx,
    nwy]); the windows (txw + 2 i, tyw + 16 j), tyw 8-aligned, cover every
    live tile of the chunk. (budget_lo, budget_hi] is the stream's span
    window. The mean depth is an int32 sum with wrap-around and a floor
    division, exactly the reference's arithmetic (C-R8)."""
    tx0, tx1, ty0, ty1, dbits, span = [m.reshape(-1, chunk) for m in meta]
    live = _live_window(span, budget_lo, budget_hi)
    any_live = live.any(dim=1)

    def red(x, fill, fn):
        v = fn(torch.where(live, x, fill), dim=1)
        return torch.where(any_live, v, 0)
    mtx0 = red(tx0, INT32_MAX, torch.amin)
    mty0 = red(ty0, INT32_MAX, torch.amin)
    mtx1 = red(tx1, -1, torch.amax)
    mty1 = red(ty1, -1, torch.amax)
    tyw = torch.div(mty0, 8, rounding_mode="floor") * 8
    nwx = torch.div(mtx1 - mtx0, WIN_TX, rounding_mode="floor") + 1
    nwy = torch.div(mty1 - tyw, WIN_TY, rounding_mode="floor") + 1
    d_sum = torch.where(live, dbits, 0).sum(dim=1, dtype=torch.int32)
    d_cnt = torch.clamp(live.sum(dim=1, dtype=torch.int32), min=1)
    d_mean = torch.div(d_sum, d_cnt, rounding_mode="floor")
    # band_cuts are ascending quantiles of NEGATED dbits: band 0 is nearest.
    band = ((-d_mean)[:, None] >= band_cuts[None, :].to(torch.int32)).sum(
        dim=1, dtype=torch.int32)
    rect = torch.stack([mtx0, tyw, nwx, nwy], dim=1).to(torch.int32)
    return band, rect


def step_slot_masks(meta, chunk: int, budget: int, budget_lo: int = 0,
                    sub: int = SUB) -> torch.Tensor:
    """(S,) int32 per-(slot, sub-block) liveness bits: bit s * nsub + j is
    set iff some pair of the chunk's j-th `sub`-wide block has span >
    max(s, budget_lo) (and span <= budget), a superset of the kernel's live
    condition. Only the first 30 bits are written; slots past them stay
    live."""
    span = meta[5]
    nsub = max(1, chunk // sub)
    sp = torch.where(_live_window(span, budget_lo, budget), span, 0)
    m = sp.reshape(-1, nsub, min(sub, chunk)).amax(dim=2)      # (S, nsub)
    mask = torch.zeros(m.shape[0], dtype=torch.int32, device=span.device)
    for s in range(budget):
        if (s + 1) * nsub > MASK_BITS:
            break
        bits = (m > max(s, budget_lo)).to(torch.int32)
        for j in range(nsub):
            mask = mask | (bits[:, j] << (s * nsub + j))
    return mask


def global_band_cuts(sample_keys, k_bands: int) -> torch.Tensor:
    """(K-1,) ascending cuts on NEGATED depth bits: the depth quantiles of
    the live keys of a sample (dead = INT32_MAX). Band 0 is the nearest."""
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


def global_band_extremes(sample_keys):
    """(d_lo, d_hi) 0-d int32: the least and the greatest live depth bits of
    a key sample (dead = INT32_MAX), the open ends of the first and last
    band for band_weight_coeffs."""
    d = sample_keys & ((1 << QUANT_DEPTH_BITS) - 1)
    live = sample_keys != INT32_MAX
    d_lo = torch.where(live, d, (1 << QUANT_DEPTH_BITS) - 1).amin()
    d_hi = torch.where(live, d, 0).amax()
    return d_lo.to(torch.int32), d_hi.to(torch.int32)


def band_weight_coeffs(band_cuts, d_lo, d_hi, k_bands: int, beta: float):
    """(K, 2) float32 rows [a, b] of the within-band depth weight: a pair of
    band k weighs w_d = exp(clip(a[k] dbits + b[k], 0, 25)), 1 at the band's
    far edge and e^beta at its near edge. band_cuts are global_band_cuts'
    ascending negated quantiles, (d_lo, d_hi) global_band_extremes'."""
    del k_bands                  # the rows follow from the cuts
    cuts = band_cuts.to(torch.int32)
    lo_edges = torch.cat([-cuts, torch.as_tensor(d_lo).to(cuts).reshape(1)])
    hi_edges = torch.cat([torch.as_tensor(d_hi).to(cuts).reshape(1), -cuts])
    lo = torch.minimum(lo_edges, hi_edges).to(torch.float32)
    hi = torch.maximum(lo_edges, hi_edges).to(torch.float32)
    # A float32 numerator, so the quotient is a true division.
    a = lo.new_tensor(beta) / torch.clamp(hi - lo, min=1.0)
    b = -a * lo
    return torch.stack([a, b], dim=1)


def tail_params_row(tile_h: int, tile_w: int, block, w: int, h: int, p00, p11,
                    ty_base: int = 0) -> torch.Tensor:
    """(8,) float32 kernel constants [kx_t, kx_j, kx_0, ky_t, ky_j, ky_0,
    bx2, by2]: sample coordinates in k units are affine in the tile and
    sample index; bx2, by2 are the box-filter variances of a coarse block
    (by, bx) in k units squared."""
    by, bx = block
    p00 = torch.as_tensor(p00, dtype=torch.float32)
    p11 = torch.as_tensor(p11, dtype=torch.float32, device=p00.device)

    def c(x):
        # A float32 constant on the device, so every quotient is a true
        # float32 division (a Python number divided by a tensor, or a CUDA
        # tensor by a Python number, multiplies by a reciprocal instead).
        return p00.new_tensor(x)
    kx_t = c(tile_w * 2.0 / w) / p00
    kx_j = c(bx * 2.0 / w) / p00
    kx_0 = c((bx * 0.5) * 2.0 / w - 1.0) / p00
    ky_t = c(-(tile_h * 2.0 / h)) / p11
    ky_j = c(-(by * 2.0 / h)) / p11
    ky_0 = c(1.0 - (ty_base * tile_h + by * 0.5) * 2.0 / h) / p11
    bx2 = (c(bx * 2.0 / w) / p00) ** 2 / c(12.0)
    by2 = (c(by * 2.0 / h) / p11) ** 2 / c(12.0)
    return torch.stack([kx_t, kx_j, kx_0, ky_t, ky_j, ky_0, bx2, by2])


def combine_bands(acc):
    """Fold per-band OIT sums front to back: acc (T, K, 6, S) -> (rgb (T, 3,
    S), alpha (T, S), trans (T, S)). Band k absorbs 1 - exp(L_k) (exact:
    products commute) with color (Ar..)/A and alpha A2/A, under the
    exclusive running transmittance of the nearer bands."""
    has = acc[:, :, _P_A] > 0.0
    a_safe = torch.where(has, acc[:, :, _P_A], 1.0)
    tau = torch.exp(acc[:, :, _P_L])
    t_run = torch.cumprod(tau, dim=1)
    t_excl = torch.cat([torch.ones_like(t_run[:, :1]), t_run[:, :-1]], dim=1)
    wgt = torch.where(has, t_excl * (1.0 - tau) / a_safe, 0.0)
    rgb = torch.einsum("tks,tcks->tcs", wgt,
                       acc[:, :, _P_AR:_P_AB + 1].permute(0, 2, 1, 3))
    alpha = (wgt * acc[:, :, _P_A2]).sum(dim=1)
    return rgb, alpha, t_run[:, -1]


def fold_upsample_tail(acc, k_bands: int, nx: int, ny: int, tile_h: int,
                       tile_w: int, s_cy: int, s_cx: int) -> torch.Tensor:
    """The (rows, cols) band accumulator -> the full-resolution tail field
    (ny * nx, 5, tile_h * tile_w) [r, g, b, a, trans]. The bilinear upsample
    (half-pixel centers, edges clamped, as jax.image.resize does when it
    upsamples) runs on the whole coarse image, so the field is smooth
    across tile borders."""
    n_samp = s_cy * s_cx
    acc_r = acc.reshape(k_bands, nx, ny_padded(ny), N_PLANES, n_samp)[:, :, :ny]
    acc_t = acc_r.permute(2, 1, 0, 3, 4).reshape(ny * nx, k_bands, N_PLANES,
                                                 n_samp)
    rgb_c, alpha_c, trans_c = combine_bands(acc_t)
    coarse = torch.cat([rgb_c, alpha_c[:, None], trans_c[:, None]], dim=1)
    img_c = coarse.reshape(ny, nx, 5, s_cy, s_cx).permute(2, 0, 3, 1, 4) \
        .reshape(1, 5, ny * s_cy, nx * s_cx)
    up = F.interpolate(img_c, size=(ny * tile_h, nx * tile_w),
                       mode="bilinear", align_corners=False)[0]
    return up.reshape(5, ny, tile_h, nx, tile_w).permute(1, 3, 0, 2, 4) \
        .reshape(ny * nx, 5, tile_h * tile_w)


def blend_tail_under_head(carry, upt):
    """Blend the tail field under the head carry's per-pixel transmittance:
    carry (T, >=5, P) [r, g, b, a, trans, ...], upt (T, 5, P) -> (T, 5, P)."""
    t_head = carry[:, 4:5]
    return torch.cat([carry[:, 0:4] + t_head * upt[:, 0:4],
                      t_head * upt[:, 4:5]], dim=1)


# ---------------------------------------------------------------------------
# K6: tail prepass
# ---------------------------------------------------------------------------

def tail_prepass(meta, band_cuts, chunk: int, budget: int,
                 budget_lo: int = 0, k_bands: int = 8):
    """Per-chunk (band (S,), rect (S, 4), slot_mask (S,)) in one pass over
    the (6, Np) meta matrix: what step_bands_rects and step_slot_masks
    compute, for the stream with span window (budget_lo, budget]."""
    npts = meta.shape[1]
    if meta.dtype != torch.int32 or meta.shape[0] != 6 or npts % chunk:
        raise ValueError(f"meta must be (6, Np) int32 with Np % {chunk} == 0,"
                         f" got {tuple(meta.shape)} {meta.dtype}")
    if band_cuts.shape != (k_bands - 1,) or band_cuts.device != meta.device:
        raise ValueError(f"band_cuts must be ({k_bands - 1},) on the meta's "
                         "device")
    if _device(meta) == "cpu":
        band, rect = step_bands_rects(meta, chunk, band_cuts, budget_lo,
                                      budget)
        return band, rect, step_slot_masks(meta, chunk, budget, budget_lo)
    steps = npts // chunk
    if not meta.is_contiguous():
        meta = meta.contiguous()
    cuts = band_cuts
    if cuts.dtype != torch.int32 or not cuts.is_contiguous():
        cuts = cuts.to(torch.int32).contiguous()
    out = torch.empty((steps, 6), dtype=torch.int32, device=meta.device)
    TAIL_PREPASS(meta, cuts, out, npts,
                 chunk, budget, budget_lo, k_bands - 1, steps,
                 stream=_stream(meta))
    return out[:, 0], out[:, 1:5], out[:, 5]


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32: the kernel's uint32 sum, reinterpreted."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def prepass_walk(meta, band_cuts, chunk: int, budget: int,
                 budget_lo: int = 0):
    """K6's walk of a chunk (`csrc/tail_prepass.cu`) in plain PyTorch: one
    block of PREPASS_THREADS threads a chunk, reading 16-byte vectors when
    the meta's base is 16-byte aligned and chunk % 4 == 0 (the vector path),
    else single words (the scalar path); a load's entries go to thread
    `load % PREPASS_THREADS`, whose partials (min tx0 / ty0, max tx1 / ty1,
    the depth sum modulo 2^32, the live count) are combined into the
    chunk's row; a warp's load (32 vectors or words) puts its maximum live
    span into the sub-block of its first entry, and only where the chunk has
    at most MASK_BITS sub-blocks. Returns ((band (S,), rect (S, 4),
    slot_mask (S,)), vec): what tail_prepass returns, and which path ran."""
    npts = meta.shape[1]
    steps = npts // chunk
    vec = meta.data_ptr() % 16 == 0 and chunk % 4 == 0
    words = 4 if vec else 1                       # entries a load
    load = torch.arange(chunk, device=meta.device) // words
    thread = (load % PREPASS_THREADS).expand(steps, chunk)
    tx0, tx1, ty0, ty1, dbits, span = meta.reshape(6, steps, chunk)
    live = _live_window(span, budget_lo, budget)

    def reduce(x, fill, how):
        """(steps, threads) partials: each thread's reduction of its
        entries."""
        src = torch.where(live, x, fill).to(torch.int64)
        part = torch.full((steps, PREPASS_THREADS), fill, dtype=torch.int64,
                          device=meta.device)
        return part.scatter_reduce(1, thread, src, how)
    cnt = reduce(live.to(torch.int32), 0, "sum").sum(dim=1)
    any_live = cnt > 0

    def comb(x, fill, how):
        p = reduce(x, fill, how)
        p = p.amin(dim=1) if how == "amin" else p.amax(dim=1)
        return torch.where(any_live, p, 0).to(torch.int32)
    mtx0, mty0 = comb(tx0, INT32_MAX, "amin"), comb(ty0, INT32_MAX, "amin")
    mtx1, mty1 = comb(tx1, -1, "amax"), comb(ty1, -1, "amax")
    tyw = torch.div(mty0, 8, rounding_mode="floor") * 8
    nwx = torch.div(mtx1 - mtx0, WIN_TX, rounding_mode="floor") + 1
    nwy = torch.div(mty1 - tyw, WIN_TY, rounding_mode="floor") + 1
    d_sum = _wrap_int32(_wrap_int32(reduce(dbits, 0, "sum")).to(
        torch.int64).sum(dim=1))
    d_cnt = torch.clamp(cnt, min=1).to(torch.int32)
    d_mean = torch.div(d_sum, d_cnt, rounding_mode="floor")
    band = ((-d_mean)[:, None] >= band_cuts[None, :].to(torch.int32)).sum(
        dim=1, dtype=torch.int32)
    mask = torch.zeros(steps, dtype=torch.int32, device=meta.device)
    sub = min(SUB, chunk)
    nsub = chunk // sub
    if nsub <= MASK_BITS:
        group = (load // 32).expand(steps, chunk)      # a warp's load
        ngroups = int(load[-1]) // 32 + 1
        gmax = torch.zeros((steps, ngroups), dtype=torch.int32,
                           device=meta.device).scatter_reduce(
            1, group, torch.where(live, span, 0), "amax")
        first = torch.arange(ngroups, device=meta.device) * 32 * words
        j = (first // sub).expand(steps, ngroups)
        m = torch.zeros((steps, nsub), dtype=torch.int32,
                        device=meta.device).scatter_reduce(1, j, gmax, "amax")
        for s in range(budget):
            if (s + 1) * nsub > MASK_BITS:
                break
            bits = (m > max(s, budget_lo)).to(torch.int32)
            for jj in range(nsub):
                mask = mask | (bits[:, jj] << (s * nsub + jj))
    return (band, torch.stack([mtx0, tyw, nwx, nwy], dim=1), mask), vec


# ---------------------------------------------------------------------------
# K7: tail accumulate
# ---------------------------------------------------------------------------

def _cut_table(cut: torch.Tensor) -> torch.Tensor:
    """The cut table the plain versions index: padded to CUT_ENTRIES with
    INT32_MAX (K7 and K9 pad it themselves, in shared memory)."""
    _check_cut(cut)
    return F.pad(cut.to(torch.int32), (0, CUT_ENTRIES - cut.shape[0]),
                 value=INT32_MAX)


def _check_cut(cut: torch.Tensor) -> None:
    if cut.dim() != 1 or cut.shape[0] > CUT_ENTRIES:
        raise ValueError(f"cut table of shape {tuple(cut.shape)} exceeds "
                         f"({CUT_ENTRIES},)")


def _strided_arg(x):
    """A per-chunk int32 vector for K7 / K9 as (tensor or None, stride in
    elements): the prepass hands columns of its (S, 6) output, which the
    kernels read in place."""
    if x is None:
        return None, 1
    if x.dtype != torch.int32 or x.dim() != 1 or x.stride(0) <= 0:
        x = x.to(torch.int32).contiguous()
    return x, x.stride(0)


def tail_accumulate_plain(fields, meta, band, cut, params_row, k_bands: int,
                          nx: int, ny: int, chunk: int, budget: int,
                          s_cy: int, s_cx: int, budget_lo: int = 0,
                          exact_clip: bool = False, wd_ab=None,
                          alpha_pow: int = 0):
    """The reference's `tail_accumulate_xla` (f32, scatter-add), evaluated
    for the live pairs of PLAIN_BATCH_PAIRS splats at a time."""
    n_samp = s_cy * s_cx
    npts = meta.shape[1]
    ny_pad = ny_padded(ny)
    rows_per_band = nx * ny_pad
    dev = meta.device
    acc = torch.zeros((k_bands * rows_per_band, N_PLANES * n_samp),
                      dtype=fields.dtype, device=dev)
    for idx, row, f, pair in _live_pairs(fields, meta, band, cut, params_row,
                                         nx, ny, chunk, budget, s_cy, s_cx,
                                         budget_lo, exact_clip):
        alpha = pair[-1]
        wd = pair_depth_weights(wd_ab, meta[4, idx], idx // chunk,
                                fields.dtype)
        aw = _weighted_alpha(alpha, wd, alpha_pow)
        cr, cg, cb = f[6:9]
        planes = torch.cat([aw, aw * cr[:, None],
                            aw * cg[:, None], aw * cb[:, None],
                            aw * alpha, torch.log1p(-alpha)], dim=1)
        acc.index_add_(0, row, planes)
    return acc


def pair_depth_weights(wd_ab, dbits, chunk_of, dtype):
    """w_d = exp(clip(a dbits + b, 0, 25)) of pairs whose splats have depth
    bits `dbits` and lie in chunks `chunk_of` (rows of wd_ab); None without
    wd_ab."""
    if wd_ab is None:
        return None
    ab = wd_ab.to(dtype)[chunk_of]
    return torch.exp(torch.clamp(ab[:, 0] * dbits.to(dtype) + ab[:, 1], 0.0,
                                 _WD_CAP))


def _weighted_alpha(alpha, wd, alpha_pow: int):
    """w_d alpha^(1+p), the weight of a sample in the A..A2 planes: alpha
    itself without the knobs. alpha (L, n_samp), wd (L,) or None."""
    aw = alpha if wd is None else alpha * wd[:, None]
    for _ in range(alpha_pow):
        aw = aw * alpha
    return aw


def _widening(f, bx2, by2):
    """Per pair: the footprint widened by the coarse block's box filter at
    preserved mass: (c0, c1, m0, m1) with m = 1/sqrt(1 + c il^2)."""
    v0x, v0y, il0, il1 = f[2], f[3], f[4], f[5]
    c0 = bx2 * (v0x * v0x) + by2 * (v0y * v0y)
    c1 = bx2 * (v0y * v0y) + by2 * (v0x * v0x)
    m0 = 1.0 / torch.sqrt(1.0 + c0 * (il0 * il0))
    m1 = 1.0 / torch.sqrt(1.0 + c1 * (il1 * il1))
    return c0, c1, m0, m1


def _sample_grid(s_cy: int, s_cx: int, dev, dtype):
    """(jx, jy) of the s_cy * s_cx coarse samples of a tile, row-major."""
    jidx = torch.arange(s_cy * s_cx, device=dev)
    return ((jidx % s_cx).to(dtype),
            torch.div(jidx, s_cx, rounding_mode="floor").to(dtype))


def _pair_samples(f, tx, ty, params_row, jx, jy, exact_clip: bool):
    """The per-sample quantities (L, n_samp) of L pairs, f (10, L) their
    splats' fields and (tx, ty) their tiles, in the kernels' order of
    operations: (dx, dy, e0, e1, n0, n1, w, cov, aw, alpha)."""
    dtype = f.dtype
    kx_t, kx_j, kx_0, ky_t, ky_j, ky_0, bx2, by2 = params_row.unbind()
    sx, sy, v0x, v0y, il0, il1 = f[:6]
    _, _, m0, m1 = _widening(f, bx2, by2)
    il0w = il0 * m0 * _QSCALE
    il1w = il1 * m1 * _QSCALE
    gate = f[9] * (m0 * m1)
    txf = tx.to(dtype)[:, None]
    tyf = ty.to(dtype)[:, None]
    kxs = kx_t * txf + kx_j * jx[None, :] + kx_0
    kys = ky_t * tyf + ky_j * jy[None, :] + ky_0
    dx = kxs - sx[:, None]
    dy = kys - sy[:, None]
    e0 = v0x[:, None] * dx + v0y[:, None] * dy
    e1 = v0y[:, None] * dx - v0x[:, None] * dy
    n0 = e0 * il0w[:, None]
    n1 = e1 * il1w[:, None]
    w = torch.exp(-(n0 * n0 + n1 * n1))
    cov = w >= 1e-4
    if exact_clip:
        cov &= ((torch.abs(n0) <= (0.5 * _QSCALE) * m0[:, None])
                & (torch.abs(n1) <= (0.5 * _QSCALE) * m1[:, None]))
    aw = gate[:, None] * w
    alpha = torch.clamp(torch.where(cov, aw, 0.0), max=ALPHA_MAX)
    return dx, dy, e0, e1, n0, n1, w, cov, aw, alpha


def _live_pairs(fields, meta, band, cut, params_row, nx: int, ny: int,
                chunk: int, budget: int, s_cy: int, s_cx: int, budget_lo: int,
                exact_clip: bool):
    """The live (pair, slot)s of the stream, PLAIN_BATCH_PAIRS splats and
    one slot at a time: yields (idx, row, f, (dx, dy, e0, e1, n0, n1, w,
    cov, aw, alpha)) with idx the splat indices (int64, global), row their
    accumulator rows, f = fields[:, idx] (10, L) and the per-sample
    quantities (L, n_samp) in the kernels' order of operations."""
    npts = meta.shape[1]
    ny_pad = ny_padded(ny)
    rows_per_band = nx * ny_pad
    dev, dtype = meta.device, fields.dtype
    jx, jy = _sample_grid(s_cy, s_cx, dev, dtype)
    cut_pad = _cut_table(cut)
    step = max(chunk, PLAIN_BATCH_PAIRS // chunk * chunk)
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
            tx = tx0 + ox
            ty = ty0 + oy
            tid = ty * nx + tx
            key = (tid << QUANT_DEPTH_BITS) | dbits
            live &= key > cut_pad[torch.clamp(tid, 0, CUT_ENTRIES - 1).long()]
            idx = live.nonzero().squeeze(1)
            if idx.numel() == 0:
                continue
            f = fields[:, p0 + idx]
            pair = _pair_samples(f, tx[idx], ty[idx], params_row, jx, jy,
                                 exact_clip)
            row = (band_b[idx] * rows_per_band + tx[idx] * ny_pad + ty[idx])
            yield p0 + idx, row.long(), f, pair


def tail_accumulate_bwd_plain(fields, meta, band, cut, params_row, d_acc,
                              k_bands: int, nx: int, ny: int, chunk: int,
                              budget: int, s_cy: int, s_cx: int,
                              budget_lo: int = 0, exact_clip: bool = False,
                              wd_ab=None, alpha_pow: int = 0):
    """d_fields (10, Np) of tail_accumulate under the cotangent d_acc (its
    shape): the chain rule of the reference's `_tail_bwd_kernel`. Each live
    pair reads its samples' plane cotangents d_acc[row, plane * n_samp +
    sample] (the transposed one-hot), chains them through the planes
    (w_d alpha^(1+p) with the weighting knobs), alpha = min(gate w,
    1 - 1e-6), w = exp(-(n0^2 + n1^2)), n = e il m sqrt(32) to the fields,
    sums over samples and slots, and then through the widening m = 1/sqrt(1
    + c il^2), gate = a_eff m0 m1. exact_clip gates coverage and carries no
    gradient, and wd_ab none (it comes from integer depth bits)."""
    n_samp = s_cy * s_cx
    d_planes = d_acc.reshape(-1, N_PLANES, n_samp)
    bx2, by2 = params_row[6], params_row[7]
    # Per-pair sums over (slot, sample): d gate, d sx, d sy, d(il0 m0) and
    # d(il1 m1) before the sqrt(32), the direct d v0x and d v0y, d r, g, b.
    sums = fields.new_zeros((10, fields.shape[1]))
    for idx, row, f, pair in _live_pairs(fields, meta, band, cut, params_row,
                                         nx, ny, chunk, budget, s_cy, s_cx,
                                         budget_lo, exact_clip):
        wd = pair_depth_weights(wd_ab, meta[4, idx], idx // chunk,
                                fields.dtype)
        sums.index_add_(1, idx, _pair_cotangent_sums(
            f, pair, d_planes[row], bx2, by2, wd, alpha_pow))
    return _widening_bwd(fields, sums, bx2, by2)


def _pair_cotangent_sums(f, pair, d_rows, bx2, by2, wd=None,
                         alpha_pow: int = 0):
    """(10, L): each live pair's cotangents summed over its samples, from
    its samples' plane cotangents d_rows (L, 6, n_samp): d gate, d sx, d sy,
    d(il0 m0) and d(il1 m1) before the sqrt(32), the direct d v0x and d v0y,
    d r, g, b. With the weighting knobs (wd (L,) the pairs' depth weights,
    alpha_pow p) the planes' d/d alpha is (1 + p) alpha^p w_d (dA + dAr r +
    dAg g + dAb b) + (2 + p) alpha^(1+p) w_d dA2, as the reference's
    `_tail_bwd_kernel` chains it."""
    dx, dy, e0, e1, n0, n1, w, cov, aw, alpha = pair
    v0x, v0y, il0, il1 = (x[:, None] for x in f[2:6])
    _, _, m0, m1 = _widening(f, bx2, by2)
    il0w = il0 * m0[:, None] * _QSCALE
    il1w = il1 * m1[:, None] * _QSCALE
    gate = (f[9] * (m0 * m1))[:, None]
    dA, dAr, dAg, dAb, dA2, dL = d_rows.unbind(1)
    cr, cg, cb = (x[:, None] for x in f[6:9])
    if wd is None and not alpha_pow:
        d_alpha = (dA + dAr * cr + dAg * cg + dAb * cb + 2.0 * alpha * dA2
                   - dL / (1.0 - alpha))
        alpha_w = alpha
    else:
        s1 = torch.ones_like(alpha)
        for _ in range(alpha_pow):
            s1 = s1 * alpha
        core = ((1.0 + alpha_pow) * s1 * (dA + dAr * cr + dAg * cg + dAb * cb)
                + (2.0 + alpha_pow) * s1 * alpha * dA2)
        alpha_w = alpha * s1
        if wd is not None:
            core = core * wd[:, None]
            alpha_w = alpha_w * wd[:, None]
        d_alpha = core - dL / (1.0 - alpha)
    d_aw = torch.where(cov & (aw < ALPHA_MAX), d_alpha, 0.0)
    dqn = d_aw * gate * w * (-2.0)       # d w / d n_i = -2 n_i w
    dn0 = n0 * dqn
    dn1 = n1 * dqn
    return torch.stack([
        d_aw * w,
        -(dn0 * v0x * il0w + dn1 * v0y * il1w),
        -(dn0 * v0y * il0w - dn1 * v0x * il1w),
        dn0 * e0, dn1 * e1,
        dn0 * dx * il0w - dn1 * dy * il1w,
        dn0 * dy * il0w + dn1 * dx * il1w,
        dAr * alpha_w, dAg * alpha_w, dAb * alpha_w]).sum(dim=2)


def _widening_bwd(fields, sums, bx2, by2):
    """Per pair: the summed cotangents -> d fields (10, Np), through il_w =
    il m sqrt(32), gate = a_eff m0 m1 and m = 1/sqrt(1 + c il^2)."""
    d_gate, d_sx, d_sy, d_e0, d_e1, d_v0x_e, d_v0y_e, d_cr, d_cg, d_cb = sums
    v0x, v0y, il0, il1, a_eff = fields[2], fields[3], fields[4], fields[5], \
        fields[9]
    c0, c1, m0, m1 = _widening(fields, bx2, by2)
    d_il0w = _QSCALE * d_e0
    d_il1w = _QSCALE * d_e1
    d_m0 = d_il0w * il0 + d_gate * a_eff * m1
    d_m1 = d_il1w * il1 + d_gate * a_eff * m0
    d_u0 = d_m0 * (-0.5) * m0 * m0 * m0
    d_u1 = d_m1 * (-0.5) * m1 * m1 * m1
    d_c0 = d_u0 * il0 * il0
    d_c1 = d_u1 * il1 * il1
    return torch.stack([
        d_sx, d_sy,
        d_v0x_e + 2.0 * v0x * (d_c0 * bx2 + d_c1 * by2),
        d_v0y_e + 2.0 * v0y * (d_c0 * by2 + d_c1 * bx2),
        d_il0w * m0 + d_u0 * 2.0 * c0 * il0,
        d_il1w * m1 + d_u1 * 2.0 * c1 * il1,
        d_cr, d_cg, d_cb, d_gate * m0 * m1])


# ---------------------------------------------------------------------------
# The unit walk of K7 and K9, in plain PyTorch
# ---------------------------------------------------------------------------
#
# No compiler runs where the CPU tests do, so the walk the CUDA sources take
# (csrc/tail_unit.cuh) is written out here once more and held against the
# plain versions: units of SUB splats, the unit-level band and mask skip,
# the packed bbox, the slot walk without a division, the live-pair worklist.

def unit_may_be_live(band_g: int, mask_g, j: int, nsub: int, budget: int,
                     k_bands: int) -> bool:
    """Whether sub-block j of a chunk with band band_g and slot mask mask_g
    (None: no mask) can hold a live pair: the kernels skip the unit before
    any load otherwise. Slots past the mask's 30 bits stay live."""
    if band_g < 0 or band_g >= k_bands:
        return False
    if mask_g is None:
        return True
    for s in range(budget):
        if (s + 1) * nsub > MASK_BITS:
            return True
        if (mask_g >> (s * nsub + j)) & 1:
            return True
    return False


def unit_worklists(meta, band, cut, slot_mask, k_bands: int, nx: int,
                   chunk: int, budget: int, budget_lo: int = 0):
    """The kernels' live-pair worklists: yields (u, idx, slot, tx, ty) for
    every unit u that is not skipped, idx the listed pairs' splat indices
    (int64, global, in slot-major order), slot their slots and (tx, ty)
    their tiles. A unit is SUB splats of one chunk, or the whole chunk below
    SUB. Per splat the walk keeps (ox, oy) and steps them with the slot
    (`SlotWalk`): a splat outside the span window has span 0, a slot past
    the bbox's rows ends the splat's walk, and the pair's key is held
    against its tile's cut."""
    npts = meta.shape[1]
    unit = min(SUB, chunk)
    nsub = chunk // unit
    if chunk % unit or npts % chunk:
        raise ValueError(f"chunk {chunk} is not a multiple of its unit, or "
                         f"Np {npts} not of the chunk")
    cut_pad = _cut_table(cut)
    bands = band.tolist()
    masks = None if slot_mask is None else slot_mask.tolist()
    for u in range(npts // unit):
        g, j = divmod(u, nsub)
        if not unit_may_be_live(bands[g], None if masks is None else masks[g],
                                j, nsub, budget, k_bands):
            continue
        tx0, tx1, ty0, ty1, dbits, span = meta[:, u * unit:(u + 1) * unit]
        span = torch.where(_live_window(span, budget_lo, budget), span, 0)
        # The packed bbox words: 16 bits each.
        nxs = torch.clamp(tx1 - tx0 + 1, min=1, max=0xffff)
        nrows = torch.clamp(ty1 - ty0 + 1, min=0, max=0xffff)
        ox = torch.zeros_like(span)
        oy = torch.zeros_like(span)
        found = []
        for s in range(int(span.max())):
            tx = tx0 + ox
            ty = ty0 + oy
            tid = ty * nx + tx
            key = (tid << QUANT_DEPTH_BITS) | dbits
            live = ((s < span) & (oy < nrows)
                    & (key > cut_pad[torch.clamp(tid, 0, CUT_ENTRIES - 1)
                                     .long()]))
            i = live.nonzero().squeeze(1)
            found.append((u * unit + i, torch.full_like(i, s), tx[i], ty[i]))
            ox = ox + 1
            wrap = ox == nxs
            ox = torch.where(wrap, 0, ox)
            oy = oy + wrap.to(oy.dtype)
        if found:
            yield (u,) + tuple(torch.cat(x) for x in zip(*found))
        else:
            e = torch.zeros(0, dtype=torch.int64, device=meta.device)
            yield u, e, e, e.to(torch.int32), e.to(torch.int32)


def tail_accumulate_units(fields, meta, band, cut, params_row, k_bands: int,
                          nx: int, ny: int, chunk: int, budget: int,
                          s_cy: int, s_cx: int, budget_lo: int = 0,
                          slot_mask=None, exact_clip: bool = False,
                          wd_ab=None, alpha_pow: int = 0):
    """tail_accumulate composed the way K7 composes it: unit by unit, the
    samples of the unit's listed pairs evaluated, and the covered ones
    (alpha > 0) alone added to the accumulator, weighted there (the depth
    weight from the splat's staged depth bits and its chunk's (a, b))."""
    n_samp = s_cy * s_cx
    ny_pad = ny_padded(ny)
    rows_per_band = nx * ny_pad
    unit = min(SUB, chunk)
    acc = torch.zeros((k_bands * rows_per_band, N_PLANES * n_samp),
                      dtype=fields.dtype, device=meta.device)
    flat = acc.view(-1)
    jx, jy = _sample_grid(s_cy, s_cx, meta.device, fields.dtype)
    for u, idx, _, tx, ty in unit_worklists(meta, band, cut, slot_mask,
                                            k_bands, nx, chunk, budget,
                                            budget_lo):
        f = fields[:, idx]
        alpha = _pair_samples(f, tx, ty, params_row, jx, jy, exact_clip)[-1]
        k, j = (alpha > 0).nonzero(as_tuple=True)       # the hit queue
        a = alpha[k, j]
        row = (int(band[u * unit // chunk]) * rows_per_band
               + tx[k].long() * ny_pad + ty[k].long())
        base = row * (N_PLANES * n_samp) + j
        wd = pair_depth_weights(wd_ab, meta[4, idx[k]], idx[k] // chunk,
                                fields.dtype)
        aw = _weighted_alpha(a[:, None], wd, alpha_pow)[:, 0]
        planes = [aw, aw * f[6, k], aw * f[7, k], aw * f[8, k], aw * a,
                  torch.log1p(-a)]
        for q, v in enumerate(planes):
            flat.index_add_(0, base + q * n_samp, v)
    return acc


def tail_accumulate_bwd_units(fields, meta, band, cut, params_row, d_acc,
                              k_bands: int, nx: int, ny: int, chunk: int,
                              budget: int, s_cy: int, s_cx: int,
                              budget_lo: int = 0, slot_mask=None,
                              exact_clip: bool = False, wd_ab=None,
                              alpha_pow: int = 0):
    """tail_accumulate_bwd composed the way K9 composes it: unit by unit,
    each splat's ten sums taken slot after slot over its own listed pairs,
    then chained through the widening; zeros for a splat with no listed
    pair and for every splat of a skipped unit."""
    n_samp = s_cy * s_cx
    ny_pad = ny_padded(ny)
    rows_per_band = nx * ny_pad
    unit = min(SUB, chunk)
    d_planes = d_acc.reshape(-1, N_PLANES, n_samp)
    bx2, by2 = params_row[6], params_row[7]
    jx, jy = _sample_grid(s_cy, s_cx, meta.device, fields.dtype)
    sums = fields.new_zeros((10, fields.shape[1]))
    listed = torch.zeros(fields.shape[1], dtype=torch.bool,
                         device=meta.device)
    for u, idx, slot, tx, ty in unit_worklists(meta, band, cut, slot_mask,
                                               k_bands, nx, chunk, budget,
                                               budget_lo):
        listed[u * unit:(u + 1) * unit] = True
        row = (int(band[u * unit // chunk]) * rows_per_band
               + tx.long() * ny_pad + ty.long())
        for s in slot.unique().tolist():         # a thread's slots, in order
            at = (slot == s).nonzero().squeeze(1)
            f = fields[:, idx[at]]
            pair = _pair_samples(f, tx[at], ty[at], params_row, jx, jy,
                                 exact_clip)
            wd = pair_depth_weights(wd_ab, meta[4, idx[at]],
                                    idx[at] // chunk, fields.dtype)
            sums[:, idx[at]] += _pair_cotangent_sums(f, pair,
                                                     d_planes[row[at]], bx2,
                                                     by2, wd, alpha_pow)
    out = _widening_bwd(fields, sums, bx2, by2)
    window = _live_window(meta[5], budget_lo, budget) & listed
    return torch.where(window[None, :], out, 0.0)


def _wd_arg(wd_ab):
    """The (S, 2) depth-weight coefficients for K7 / K9 as (tensor or None,
    row stride in elements): a at [g * stride], b at [g * stride + 1]."""
    if wd_ab is None:
        return None, 2
    if wd_ab.dtype != torch.float32 or wd_ab.stride(1) != 1:
        wd_ab = wd_ab.to(torch.float32).contiguous()
    return wd_ab, wd_ab.stride(0)


def _accumulate_fwd(fields, meta, band, rect, cut, params_row, slot_mask,
                    wd_ab, st):
    if _device(meta) == "cpu":
        return tail_accumulate_plain(
            fields, meta, band, cut, params_row, st["k_bands"], st["nx"],
            st["ny"], st["chunk"], st["budget"], st["s_cy"], st["s_cx"],
            st["budget_lo"], st["exact_clip"], wd_ab, st["alpha_pow"])
    n_samp = st["s_cy"] * st["s_cx"]
    npts = meta.shape[1]
    ny_pad = ny_padded(st["ny"])
    acc = torch.zeros((st["k_bands"] * st["nx"] * ny_pad, N_PLANES * n_samp),
                      dtype=torch.float32, device=meta.device)
    band, band_stride = _strided_arg(band)
    mask, mask_stride = _strided_arg(slot_mask)
    wd, wd_stride = _wd_arg(wd_ab)
    _check_cut(cut)
    # K7 adds straight to the accumulator and stages no window: the
    # prepass's rect is not passed on.
    TAIL_ACCUMULATE(fields.contiguous(),
                    meta.contiguous(),
                    band,
                    mask,
                    cut.to(torch.int32).contiguous(),
                    params_row.to(torch.float32).contiguous(),
                    acc, npts, npts // st["chunk"], st["chunk"],
                    st["budget"], st["budget_lo"], st["nx"], ny_pad,
                    st["s_cx"], n_samp, st["k_bands"], int(st["exact_clip"]),
                    band_stride, mask_stride, cut.shape[0], wd, wd_stride,
                    st["alpha_pow"], stream=_stream(meta))
    return acc


def tail_accumulate_bwd(fields, meta, band, cut, params_row, d_acc,
                        slot_mask=None, *, k_bands: int, nx: int, ny: int,
                        chunk: int, budget: int, s_cy: int, s_cx: int,
                        budget_lo: int = 0, exact_clip: bool = False,
                        wd_ab=None, alpha_pow: int = 0):
    """d_fields (10, Np) of tail_accumulate: a CPU tensor runs
    tail_accumulate_bwd_plain, a CUDA tensor launches K9 (any sample grid
    K7 takes)."""
    if _device(meta) == "cpu":
        return tail_accumulate_bwd_plain(fields, meta, band, cut, params_row,
                                         d_acc, k_bands, nx, ny, chunk,
                                         budget, s_cy, s_cx, budget_lo,
                                         exact_clip, wd_ab, alpha_pow)
    n_samp = s_cy * s_cx
    npts = meta.shape[1]
    ny_pad = ny_padded(ny)
    if d_acc.shape != (k_bands * nx * ny_pad, N_PLANES * n_samp):
        raise ValueError(f"d_acc has shape {tuple(d_acc.shape)}")
    d_fields = torch.empty((10, npts), dtype=torch.float32,
                           device=meta.device)
    band, band_stride = _strided_arg(band)
    mask, mask_stride = _strided_arg(slot_mask)
    wd, wd_stride = _wd_arg(wd_ab)
    _check_cut(cut)
    TAIL_ACCUMULATE_BWD(fields.contiguous(),
                        meta.contiguous(),
                        band,
                        mask,
                        cut.to(torch.int32).contiguous(),
                        params_row.to(torch.float32).contiguous(),
                        d_acc.to(torch.float32).contiguous(),
                        d_fields, npts, npts // chunk, chunk,
                        budget, budget_lo, nx, ny_pad, s_cx, n_samp, k_bands,
                        int(exact_clip), band_stride, mask_stride,
                        cut.shape[0], wd, wd_stride, alpha_pow,
                        stream=_stream(meta))
    return d_fields


class _TailAccumulate(torch.autograd.Function):
    """tail_accumulate with the reference's VJP (`_tail_core_fwd`,
    `_tail_core_bwd`): the fields get K9's (or its plain version's)
    cotangent; meta, band, rect, cut and slot_mask are integers, params_row
    a camera constant and wd_ab a function of integer depth bits, so they
    get none."""

    @staticmethod
    def forward(ctx, fields, meta, band, rect, cut, params_row, slot_mask,
                wd_ab, st):
        ctx.st = st
        ctx.save_for_backward(fields, meta, band, cut, params_row, slot_mask,
                              wd_ab)
        return _accumulate_fwd(fields, meta, band, rect, cut, params_row,
                               slot_mask, wd_ab, st)

    @staticmethod
    def backward(ctx, d_acc):
        with record_function("fourdgs::tail_bwd"):
            (fields, meta, band, cut, params_row, slot_mask,
             wd_ab) = ctx.saved_tensors
            d_fields = tail_accumulate_bwd(fields, meta, band, cut, params_row,
                                           d_acc, slot_mask, wd_ab=wd_ab,
                                           **ctx.st)
            return (d_fields,) + (None,) * 8


def tail_accumulate(fields, meta, band, rect, cut, params_row, k_bands: int,
                    nx: int, ny: int, chunk: int, budget: int, s_cy: int,
                    s_cx: int, budget_lo: int = 0, slot_mask=None,
                    wd_ab=None, alpha_pow: int = 0,
                    exact_clip: bool = False) -> torch.Tensor:
    """Accumulate the tail's six planes for every live pair of the stream.

    fields (10, <=Np) f32 (zero-padded to Np here when shorter); meta (6,
    Np) i32, Np a multiple of chunk; band (S,) i32; rect (S, 4) i32 from the
    prepass (checked for its shape; the kernel no longer reads it); cut (T,)
    i32;
    params_row (8,) f32; slot_mask (S,) i32 or None (no skipping). A pair of
    slot s is live iff s < span, budget_lo < span <= budget, the slot's row
    lies in the bbox, and its key exceeds cut[tile].
    Returns acc (k_bands * nx * ny_pad, 6 * s_cy * s_cx) f32, row band *
    nx * ny_pad + tx * ny_pad + ty, column plane * n_samp + sample.
    wd_ab (S, 2) f32, the chunks' depth-weight coefficients (a, b)
    (band_weight_coeffs gathered by the chunks' bands), or None; alpha_pow
    p >= 0: the A..A2 planes carry w_d alpha^(1+p) (module docstring).
    Differentiable in fields (K9 on the card). float64 fields are taken on
    the CPU only."""
    npts = meta.shape[1]
    steps = npts // chunk
    if meta.shape[0] != 6 or meta.dtype != torch.int32 or steps * chunk != npts:
        raise ValueError(f"meta must be (6, Np) int32 with Np % {chunk} == 0")
    dtypes = (torch.float32,) if meta.device.type == "cuda" else (
        torch.float32, torch.float64)
    if fields.shape[0] != 10 or fields.shape[1] > npts \
            or fields.dtype not in dtypes:
        raise ValueError(f"fields must be (10, <= {npts}) float32 (float64 "
                         f"only on the CPU)")
    if band.shape != (steps,) or rect.shape != (steps, 4):
        raise ValueError("band must be (S,) and rect (S, 4)")
    if wd_ab is not None and (wd_ab.shape != (steps, 2)
                              or not wd_ab.is_floating_point()):
        raise ValueError(f"wd_ab must be ({steps}, 2) float, got "
                         f"{tuple(wd_ab.shape)} {wd_ab.dtype}")
    if alpha_pow < 0:
        raise ValueError(f"alpha_pow must be >= 0, got {alpha_pow}")
    for t in (fields, band, rect, cut, params_row) + tuple(
            x for x in (slot_mask, wd_ab) if x is not None):
        if t.device != meta.device:
            raise ValueError("all tail inputs must share a device")
    _device(meta)
    if fields.shape[1] != npts:
        fields = F.pad(fields, (0, npts - fields.shape[1]))
    st = dict(k_bands=k_bands, nx=nx, ny=ny, chunk=chunk, budget=budget,
              s_cy=s_cy, s_cx=s_cx, budget_lo=budget_lo,
              exact_clip=exact_clip, alpha_pow=int(alpha_pow))
    if wd_ab is not None:
        wd_ab = wd_ab.detach()
    if not (torch.is_grad_enabled() and fields.requires_grad):
        return _accumulate_fwd(fields, meta, band, rect, cut, params_row,
                               slot_mask, wd_ab, st)
    return _TailAccumulate.apply(fields, meta, band, rect, cut, params_row,
                                 slot_mask, wd_ab, st)
