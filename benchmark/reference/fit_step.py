"""Plain reference of one step of the multi-view 4D fit: the loss of the
converged frame against a target image, the gradients of the trainer's
seven parameter fields, and Adam's update, in plain PyTorch and float32.

It imports nothing of the program. Its forward is the sibling reference of
the converged frame (`converged_frame`: the motion slice, the EWA
projection, the quantized binning, the record matrix and the banded tail),
under the same knobs, so that what the two references share is written
once; this file adds what a step needs around it:

1. the materialization of the trainer's raw fields: scale3 and lifetime
   through |x| + 1e-4 with the gradient 1 at 0 (jnp.abs's, not torch.abs's
   0), fade clipped to [1e-3, 1 - 1e-3] and color to [0, 1] through a
   maximum and a minimum, so that half the gradient passes at a bound
   (the tie of jnp.clip);
2. the mapping of the materialized fields to the packed fields that
   `converged_frame` reads (px ... ca);
3. the converged frame with autograd through it: the head composite is
   written here again as a function without in-place updates (the
   sibling's updates its accumulators in place, which autograd cannot
   take), one chunk of 128 records at a time with the same early exit,
   and on the card is recomputed block by block in the backward
   (`torch.utils.checkpoint`) so that its graph fits; the tail is the
   sibling's;
4. the objective 0.8 L1 + 0.2 (1 - SSIM) over RGB;
5. the gradients of the seven fields by `torch.autograd`;
6. Adam written out in full, as `torch.optim.Adam` computes it (b1 0.9,
   b2 0.999, eps 1e-8, no weight decay): m and v, their bias corrections
   from the step count, and the update.

Departure from the published recipe (3D Gaussian Splatting, Kerbl et al.
2023, `train.py`): its D-SSIM takes an 11x11 Gaussian window (sigma 1.5)
with zero padding; this reference, like the program, takes a uniform 7x7
window over the valid pixels only, with c1 = 0.01^2 and c2 = 0.03^2.

Departure from the sibling: its footprint eigenvector
(`converged_frame._eigen2x2`) is used here with a guard on its gradient
(`_eigen2x2`, the same values): where the vector (b, lmin - a) vanishes,
an exactly round footprint, the eigenvector is a constant axis and its
gradient 0, where the sibling's square root of 0 gives 0 / 0.

TF32 is switched off when this module is imported, so that no matrix
product of the reference runs below float32 on the card.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference import converged_frame as R

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FIELDS = ("position4", "quat", "scale3", "lifetime", "fade", "velocity",
          "color")
SSIM_WINDOW = 7
SSIM_C1, SSIM_C2 = 0.01 ** 2, 0.03 ** 2
BETAS, EPS = (0.9, 0.999), 1e-8


# --------------------------------------------------------------------------
# materialization and the packed fields
# --------------------------------------------------------------------------

def _abs(x):
    return torch.where(x >= 0, x, -x)


def _clip(x, lo: float, hi: float):
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def packed_fields(params: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The materialized splats of the trainer's raw fields, as the packed
    fields px ... ca of `converged_frame`."""
    pos, quat, vel = params["position4"], params["quat"], params["velocity"]
    scale = _abs(params["scale3"]) + 1e-4
    color = _clip(params["color"], 0.0, 1.0)
    return dict(
        px=pos[:, 0], py=pos[:, 1], pz=pos[:, 2], pt=pos[:, 3],
        qw=quat[:, 0], qx=quat[:, 1], qy=quat[:, 2], qz=quat[:, 3],
        sx=scale[:, 0], sy=scale[:, 1], sz=scale[:, 2],
        lifetime=_abs(params["lifetime"]) + 1e-4,
        fade=_clip(params["fade"], 1e-3, 1.0 - 1e-3),
        vx=vel[:, 0], vy=vel[:, 1], vz=vel[:, 2],
        cr=color[:, 0], cg=color[:, 1], cb=color[:, 2], ca=color[:, 3])


# --------------------------------------------------------------------------
# the footprint's eigenvector, with its gradient guarded
# --------------------------------------------------------------------------

def _eigen2x2(a, b, c):
    """`converged_frame._eigen2x2`'s values; where (b, lmin - a) vanishes
    the fallback axis carries a gradient of 0, not 0 / 0."""
    m = 0.5 * (a + c)
    p = a * c - b * b
    d = torch.sqrt(torch.clamp(m * m - p, min=1e-24))
    lmin = torch.clamp(m - d, min=R.LAMBDA_EPS)
    lmax = torch.clamp(m + d, min=R.LAMBDA_EPS)
    vx, vy = b, lmin - a
    norm2 = vx * vx + vy * vy
    ok = torch.sqrt(norm2.detach()) > 1e-12
    inv = 1.0 / torch.sqrt(torch.where(ok, norm2, 1.0))
    fx = (a <= c).to(a.dtype)
    fy = 1.0 - fx
    return lmin, lmax, torch.where(ok, vx * inv, fx), torch.where(ok, vy * inv,
                                                                   fy)


@contextlib.contextmanager
def _footprints(store: Optional[dict] = None):
    """Within the block `converged_frame.project` takes `_eigen2x2`; with
    `store`, its inputs (a, b, c) are kept there."""
    sibling = R._eigen2x2

    def eigen(a, b, c):
        if store is not None:
            store.update(a=a, b=b, c=c)
        return _eigen2x2(a, b, c)
    R._eigen2x2 = eigen
    try:
        yield store
    finally:
        R._eigen2x2 = sibling


# --------------------------------------------------------------------------
# the head composite, differentiable
# --------------------------------------------------------------------------

def composite_head(rec, counts, kx, ky):
    """`converged_frame.composite_head`'s arithmetic without in-place
    updates: rec (T, 16, M), the first counts[t] records of tile t live ->
    (T, 5, P) [r, g, b, a, transmittance]. A chunk of a tile runs while it
    holds live records and the tile's largest transmittance is above 1e-6;
    a tile that does not run keeps its accumulators (its alpha is 0)."""
    t_tiles, _, m = rec.shape
    p = kx.shape[2]
    rgba = rec.new_zeros((t_tiles, 4, p))
    trans = rec.new_ones((t_tiles, 1, p))
    n_chunks = (counts.to(torch.int64) + R.CHUNK - 1) // R.CHUNK
    for c in range(m // R.CHUNK):
        go = (c < n_chunks) & (trans.detach()[:, 0].amax(dim=1) > 1e-6)
        if not bool(go.any()):
            break
        r = rec[:, :, c * R.CHUNK:(c + 1) * R.CHUNK]

        def field(f):
            return r[:, f, :, None]
        dx = kx - field(0)
        dy = ky - field(1)
        v0x, v0y = field(2), field(3)
        n0 = (v0x * dx + v0y * dy) * field(4)
        n1 = (v0y * dx - v0x * dy) * field(5)
        w = torch.exp(-0.5 * (64.0 * (n0 * n0 + n1 * n1)))
        cover = ((torch.abs(n0) <= 0.5) & (torch.abs(n1) <= 0.5)
                 & (w >= 1e-4) & go[:, None, None])
        alpha = torch.clamp(torch.where(cover, field(9) * w, 0.0),
                            max=R.ALPHA_MAX)
        cp = torch.cumprod(1.0 - alpha, dim=1)
        excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        wgt = alpha * (trans * excl)
        rgba = rgba + torch.stack([
            (wgt * r[:, 6, :, None]).sum(dim=1),
            (wgt * r[:, 7, :, None]).sum(dim=1),
            (wgt * r[:, 8, :, None]).sum(dim=1),
            (alpha * wgt).sum(dim=1)], dim=1)
        trans = trans * cp[:, -1:]
    return torch.cat([rgba, trans], dim=1)


def _head_block(rec_all, rows, live, counts, kx, ky):
    rec = rec_all[:, rows].permute(1, 0, 2)
    a_eff = rec[:, 9] * live.to(rec.dtype)
    rec = torch.cat([rec[:, :9], a_eff[:, None],
                     rec.new_zeros((rec.shape[0], R.F_ROWS - R.N_FIELDS,
                                    rec.shape[2]))], dim=1)
    return composite_head(rec, counts, kx, ky)


def head_carry(rec_all, binning, kx, ky, m: int):
    """The head composite over every tile, R.HEAD_BLOCK_TILES at a time,
    each block recomputed in the backward on the card (on the CPU, at the
    tests' sizes, the whole graph is kept): the (T, 8, P) carry."""
    counts = binning["head_counts"]
    starts = binning["tile_start"][:-1]
    pair_pad = torch.cat([binning["pair_splat"],
                          binning["pair_splat"].new_zeros((m,))])
    dev = kx.device
    outs = []
    for lo in range(0, counts.shape[0], R.HEAD_BLOCK_TILES):
        hi = min(counts.shape[0], lo + R.HEAD_BLOCK_TILES)
        idx = starts[lo:hi].long()[:, None] + torch.arange(m, device=dev)
        rows = pair_pad[idx].long()
        live = torch.arange(m, device=dev)[None, :] < counts[lo:hi, None]
        args = (rec_all, rows, live, torch.clamp(counts[lo:hi], max=m),
                kx[lo:hi], ky[lo:hi])
        if rec_all.requires_grad and rec_all.is_cuda:
            outs.append(checkpoint(_head_block, *args, use_reentrant=False))
        else:
            outs.append(_head_block(*args))
    carry = torch.cat(outs)
    return torch.cat([carry, carry.new_zeros((carry.shape[0], 3,
                                              carry.shape[2]))], dim=1)


# --------------------------------------------------------------------------
# the frame, the loss and the gradients
# --------------------------------------------------------------------------

def render(packed: Dict[str, torch.Tensor], position, orientation, t: float,
           width: int, height: int, far: float, cfg: dict,
           records_dtype=torch.float32):
    """`converged_frame.render` with autograd through it: (image (H, W, 4),
    counters dict). The binning carries no gradient."""
    dev = packed["px"].device
    view, proj, eye = R.camera_matrices(position, orientation, width, height,
                                        dev, far=far)
    p00, p11 = proj[0, 0], proj[1, 1]
    with _footprints():
        pr = R.project(packed, view, proj, eye, t)
    pr_int = {k: v.detach() for k, v in pr.items()}
    th, tw, m = cfg["tile_h"], cfg["tile_w"], cfg["max_splats_per_tile"]
    ny0, nx0 = R.tile_grid(width, height, th, tw)
    if ny0 * nx0 >= R.TILE_LIMIT:
        rows_per_band = max(1, R.TILE_LIMIT // nx0)
        n_bands = -(-ny0 // rows_per_band)
    else:
        rows_per_band, n_bands = ny0, 1
    px, py = R.tile_pixels(width, height, th, tw, dev)
    bg = torch.tensor(cfg["background"], dtype=torch.float32, device=dev)
    n = pr["mx"].shape[0]
    npts = -(-n // cfg["tail_chunk"]) * cfg["tail_chunk"]
    rec_all = R.record_matrix(pr, p00, p11, npts, records_dtype)
    tiles, counters = [], dict(overflowed=0, compact_dropped=0,
                               resid_transmittance=0.0)
    for b in range(n_bands):
        lo_row = b * rows_per_band
        nb = min(rows_per_band, ny0 - lo_row)
        band = None if n_bands == 1 else (lo_row, nb)
        with torch.no_grad():
            binning = R.bin_band(pr_int, p00, p11, cfg, width, height, band)
        px_b = px[lo_row * nx0:(lo_row + nb) * nx0]
        py_b = py[lo_row * nx0:(lo_row + nb) * nx0]
        t_tiles, p = px_b.shape
        kx = (px_b / p00).reshape(t_tiles, 1, p)
        ky = (py_b / p11).reshape(t_tiles, 1, p)
        out = head_carry(rec_all, binning, kx, ky, m)
        out = R.apply_tail(out, pr, binning, p00, p11, cfg, width, height,
                           rec_all, band)
        rgb = out[:, 0:3, :] + out[:, 4:5, :] * bg[:3, None]
        a = out[:, 3, :] + out[:, 4, :] * bg[3]
        tiles.append(torch.cat([rgb, a[:, None, :]], dim=1).permute(0, 2, 1))
        counts = binning["head_counts"]
        truncated = (counts - torch.clamp(counts, max=m)) > 0
        resid = (out[:, 4, :].detach() * truncated[:, None]).max()
        counters["overflowed"] += int(binning["overflowed"])
        counters["compact_dropped"] += int(binning["compact_dropped"])
        counters["resid_transmittance"] = max(
            counters["resid_transmittance"], float(resid))
        del binning, out
    img = torch.cat(tiles).reshape(ny0, nx0, th, tw, 4)
    img = img.permute(0, 2, 1, 3, 4).reshape(ny0 * th, nx0 * tw, 4)
    return img[:height, :width], counters


def _mean_pool(x):
    """The uniform SSIM_WINDOW x SSIM_WINDOW mean over the valid pixels of
    (H, W, C): (H - 6, W - 6, C)."""
    return F.avg_pool2d(x.permute(2, 0, 1)[None], SSIM_WINDOW,
                        stride=1)[0].permute(1, 2, 0)


def ssim(x, y):
    """Mean SSIM of two (H, W, 3) images."""
    mu_x, mu_y = _mean_pool(x), _mean_pool(y)
    var_x = _mean_pool(x * x) - mu_x * mu_x
    var_y = _mean_pool(y * y) - mu_y * mu_y
    cov = _mean_pool(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + SSIM_C1) * (2 * cov + SSIM_C2)
    den = (mu_x ** 2 + mu_y ** 2 + SSIM_C1) * (var_x + var_y + SSIM_C2)
    return torch.mean(num / den)


def objective(img, target, ssim_weight: float = 0.2):
    """(1 - w) L1 + w (1 - SSIM) over the RGB channels."""
    x, y = img[..., :3], target[..., :3]
    l1 = torch.mean(torch.abs(x - y))
    return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - ssim(x, y))


def loss_and_grads(params: Dict[str, torch.Tensor], target, position,
                   orientation, t: float, width: int, height: int,
                   far: float, cfg: dict, ssim_weight: float = 0.2,
                   records_dtype=torch.float32
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], dict]:
    """The loss of the trainer's raw fields `params` (FIELDS) at the camera
    pose (fov 60 degrees, near 0.1, `far`) and time t against `target`,
    the gradient of every field, and the frame's counters."""
    leaves = {k: params[k].detach().clone().requires_grad_(True)
              for k in FIELDS}
    img, counters = render(packed_fields(leaves), position, orientation, t,
                           width, height, far, cfg, records_dtype)
    loss = objective(img, target, ssim_weight)
    del img
    grads = torch.autograd.grad(loss, [leaves[k] for k in FIELDS])
    return loss.detach(), dict(zip(FIELDS, grads)), counters


# --------------------------------------------------------------------------
# Adam
# --------------------------------------------------------------------------

def adam_step(param, grad, exp_avg, exp_avg_sq, step: int, lr: float,
              betas=BETAS, eps: float = EPS, dtype=torch.float32):
    """One Adam update of one tensor from its moments before the step and
    the count of steps before it: (param, exp_avg, exp_avg_sq) after,
    computed in `dtype` (bfloat16: the precision control) and returned in
    float32."""
    if dtype != torch.float32:
        return tuple(x.float() for x in adam_step(
            *(x.to(dtype) for x in (param, grad, exp_avg, exp_avg_sq)),
            step, lr, betas, eps))
    b1, b2 = betas
    step = step + 1
    m = b1 * exp_avg + (1.0 - b1) * grad
    v = b2 * exp_avg_sq + (1.0 - b2) * grad * grad
    bias1 = 1.0 - b1 ** step
    bias2 = 1.0 - b2 ** step
    denom = torch.sqrt(v) / (bias2 ** 0.5) + eps
    return param - (lr / bias1) * (m / denom), m, v


def adam_update(params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor],
                state: Dict[str, Tuple[torch.Tensor, torch.Tensor, int]],
                lr: float, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Every field's parameters after Adam's step: state[field] holds its
    (exp_avg, exp_avg_sq, steps before) before the step; missing moments
    are zero."""
    out = {}
    for k in FIELDS:
        m, v, step = state.get(k, (None, None, 0))
        p = params[k]
        m = torch.zeros_like(p) if m is None else m
        v = torch.zeros_like(p) if v is None else v
        out[k] = adam_step(p, grads[k], m, v, step, lr, dtype=dtype)[0]
    return out


# --------------------------------------------------------------------------
# the conditioning rule of the footprint's eigenvector
# --------------------------------------------------------------------------

U32 = 2.0 ** -24                # float32 unit roundoff
# A footprint whose eigenvector holds fewer float32 rounding errors than
# this has gradients that two float32 implementations of the step round
# apart: every gradient of the splat passes through d v0 / d cov, which
# grows as the footprint rounds. The program's rule for the direction
# itself (tools/eigen_condition.py) is 64; the gradients need more: over a
# million cube splats at 1080p the rotation gradients of the splats above
# 64 still differed by 1.4-13.6% in norm, above 1024 by at most 0.21%, and
# 1024 leaves out 0.4% of the splats (the fit cell on the card, PR 22).
EIGVEC_MIN_CONDITION = 1024


def eigvec_condition(a, b, c):
    """(N,) float64: the norm of the projection's unnormalized eigenvector
    (b, lmin - a) of the footprint [[a, b], [b, c]], worked out in float64
    from the float32 inputs, over the rounding error float32 arithmetic
    leaves in it: u (|a| + |c|) in b and in lmin - a, and u m^2 / d in
    lmin, where the discriminant cancels to d^2 (u the float32 unit
    roundoff)."""
    a, b, c = (x.double() for x in (a, b, c))
    m = 0.5 * (a + c)
    d = torch.sqrt(torch.clamp(m * m - (a * c - b * b), min=1e-24))
    lmin = torch.clamp(m - d, min=R.LAMBDA_EPS)
    return torch.hypot(b, lmin - a) / (U32 * (a.abs() + c.abs() + m * m / d))


def well_conditioned(params: Dict[str, torch.Tensor], position, orientation,
                     t: float, width: int, height: int, far: float):
    """(N,) bool: the splats of the trainer's raw fields whose footprint at
    this pose and time has an eigenvector of EIGVEC_MIN_CONDITION rounding
    errors or more (the footprint as `converged_frame.project` forms it)."""
    dev = params["position4"].device
    view, proj, eye = R.camera_matrices(position, orientation, width, height,
                                        dev, far=far)
    with _footprints({}) as store, torch.no_grad():
        R.project(packed_fields(params), view, proj, eye, t)
    return eigvec_condition(store["a"], store["b"],
                            store["c"]) >= EIGVEC_MIN_CONDITION
