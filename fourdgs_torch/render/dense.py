"""Dense (all splats against all pixels) renderer, the golden model (port of
fourdgs/render/dense.py).

It reproduces the reference's fixed-function pipeline: the fragment weight
and discard (render/project.pixel_weight), painter's-algorithm blending with
straight alpha under GL_SRC_ALPHA / GL_ONE_MINUS_SRC_ALPHA,

    C <- a * src.rgb + (1 - a) * C,   A <- a * src.a + (1 - a) * A,
    a = opacity * w * src.a,

in back-to-front order of ascending 1/distance keys, ties in splat-index
order (the reference's sort is stable). The composite runs front to back
over chunks of splats with a running per-pixel log-transmittance; inside a
chunk the ordered blend is an exclusive cumsum of log(1 - alpha). Plain
PyTorch on any device, differentiable.

`composite_dense_blend` is the blend-function explorer: any glBlendFunc
pair, one splat at a time, for small scenes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fourdgs_torch.core.camera import Camera, pixel_centers_ndc
from fourdgs_torch.render.project import (Projected, eigen2x2, pixel_weight,
                                          project_splats)
from fourdgs_torch.render.sort import front_to_back_order
from fourdgs_torch.splats.gaussians import (Splats2D, Splats3D, Splats4D,
                                            mean_in_time_sortkey)

# Keep log(1 - alpha) finite: alpha == 1 only occurs for a fully saturating
# splat, where the difference is invisible but the gradient would be NaN.
ALPHA_MAX = 1.0 - 1e-6


def painter_to_front_to_back(depth_key: torch.Tensor) -> torch.Tensor:
    """Permutation into front-to-back order: the reference's painter order
    (stable ascending 1/distance) reversed, ties included."""
    return front_to_back_order(depth_key)


def sort_front_to_back(proj: Projected) -> Projected:
    order = painter_to_front_to_back(proj.depth)
    return proj.map(lambda a: a[order])


def _reversed(proj: Projected) -> Projected:
    return proj.map(lambda a: a.flip(0))


def _background(background, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(background, dtype=like.dtype, device=like.device)


def composite_dense(proj: Projected, px: torch.Tensor, py: torch.Tensor,
                    p00, p11, background: torch.Tensor, chunk: int = 256,
                    premultiplied: bool = False) -> torch.Tensor:
    """Alpha-composite front-to-back-ordered splats over a pixel grid.

    proj fields (N,), px / py (H, W) NDC pixel centers, background (4,)
    rgba. Returns (H, W, 4). The splats are padded to a multiple of `chunk`.

    premultiplied reproduces the 3D fragment shader's output (color = c *
    RGBA before the fixed GL_SRC_ALPHA blend): the blended rgb is scaled by
    the Gaussian weight once more. The 2D and 4D shaders emit straight color
    (the default). The color sum over a chunk is the reference's einsum, a
    matmul: float32 on the card while the caller leaves TF32 off for
    matmuls (PyTorch's default)."""
    h, w = px.shape
    dtype = px.dtype
    n_pad = -proj.count % chunk
    if n_pad:
        proj = proj.map(lambda a: torch.cat([a, a.new_zeros((n_pad,))]))
    pxf = px.reshape(-1)
    pyf = py.reshape(-1)
    npix = pxf.shape[0]
    rgb_acc = px.new_zeros((npix, 3))
    a_acc = px.new_zeros((npix,))
    log_t = px.new_zeros((npix,))
    for c0 in range(0, proj.count, chunk):
        cp = proj.map(lambda a: a[c0:c0 + chunk])
        weight, cover = pixel_weight(cp, pxf, pyf, p00, p11)     # (C, P)
        gate = (cover & cp.valid[:, None]).to(dtype)
        # Zero-padding splats have l = 0 and give 0/0 = NaN weights at
        # k = 0; coverage is False there, so gating the weight (not just
        # alpha) keeps the premultiplied path and the gradient NaN-free.
        weight = torch.where(cover, weight, 0.0)
        alpha = cp.opacity[:, None] * weight * cp.a[:, None] * gate
        alpha = torch.clamp(alpha, 0.0, ALPHA_MAX)
        log1m = torch.log1p(-alpha)
        # Transmittance in front of each splat of the chunk.
        t_excl = torch.exp(log_t[None, :] + torch.cumsum(log1m, dim=0)
                           - log1m)
        wgt = alpha * t_excl                                     # (C, P)
        cw = wgt * weight if premultiplied else wgt
        rgb = torch.stack([cp.r, cp.g, cp.b], dim=-1)            # (C, 3)
        rgb_acc = rgb_acc + torch.einsum("cp,cd->pd", cw, rgb)
        # GL alpha channel: out.a = a * src.a + (1 - a) * dst.a, src.a = a.
        a_acc = a_acc + (alpha * wgt).sum(dim=0)
        log_t = log_t + log1m.sum(dim=0)
    t_final = torch.exp(log_t)
    rgb_acc = rgb_acc + t_final[:, None] * background[:3]
    a_acc = a_acc + t_final * background[3]
    return torch.cat([rgb_acc, a_acc[:, None]], dim=-1).reshape(h, w, 4)


# ---------------------------------------------------------------------------
# generic GL blend explorer
# ---------------------------------------------------------------------------

# The blend factors of the reference's explorer (glBlendFunc enums).
BLEND_FACTORS = ("zero", "one", "src_alpha", "one_minus_src_alpha",
                 "dst_alpha", "one_minus_dst_alpha",
                 "src_color", "one_minus_src_color",
                 "dst_color", "one_minus_dst_color")


def _blend_factor(name: str, src_rgba: torch.Tensor,
                  dst_rgba: torch.Tensor) -> torch.Tensor:
    """Per-channel GL blend factor for (..., 4) rgba tensors: *_color
    factors take the matching channel, alpha factors broadcast."""
    if name not in BLEND_FACTORS:
        raise ValueError(f"unknown blend factor {name!r}; "
                         f"choose from {BLEND_FACTORS}")
    sa = src_rgba[..., 3:4].expand_as(src_rgba)
    da = dst_rgba[..., 3:4].expand_as(src_rgba)
    return {
        "zero": lambda: torch.zeros_like(src_rgba),
        "one": lambda: torch.ones_like(src_rgba),
        "src_alpha": lambda: sa,
        "one_minus_src_alpha": lambda: 1.0 - sa,
        "dst_alpha": lambda: da,
        "one_minus_dst_alpha": lambda: 1.0 - da,
        "src_color": lambda: src_rgba,
        "one_minus_src_color": lambda: 1.0 - src_rgba,
        "dst_color": lambda: dst_rgba,
        "one_minus_dst_color": lambda: 1.0 - dst_rgba,
    }[name]()


def composite_dense_blend(proj: Projected, px: torch.Tensor,
                          py: torch.Tensor, p00, p11,
                          background: torch.Tensor,
                          src_factor: str = "src_alpha",
                          dst_factor: str = "one_minus_src_alpha",
                          premultiplied: bool = False) -> torch.Tensor:
    """Back-to-front composite under any glBlendFunc pair, the analog of the
    reference's blend-function explorer.

    `proj` is in front-to-back order (as for composite_dense); the loop
    walks it back to front applying dst = src * F_src + dst * F_dst, and a
    discarded fragment leaves dst untouched. One step per splat, so it is
    for small scenes: the production compositor's SRC_ALPHA /
    ONE_MINUS_SRC_ALPHA case has the closed transmittance form."""
    h, w = px.shape
    dtype = px.dtype
    pxf = px.reshape(-1)
    pyf = py.reshape(-1)
    npix = pxf.shape[0]
    # Validate both names before the loop, which an empty scene skips.
    for name in (src_factor, dst_factor):
        _blend_factor(name, background[None], background[None])
    dst = torch.broadcast_to(background.to(dtype), (npix, 4))
    for i in range(proj.count - 1, -1, -1):
        sp = proj.map(lambda a: a[i:i + 1])
        weight, cover = pixel_weight(sp, pxf, pyf, p00, p11)     # (1, P)
        weight = torch.where(cover, weight, 0.0)[0]
        cover = (cover[0] & sp.valid).to(dtype)
        alpha = torch.clamp(sp.opacity * weight * sp.a, 0.0, 1.0)
        rgb = torch.broadcast_to(torch.cat([sp.r, sp.g, sp.b]), (npix, 3))
        if premultiplied:
            rgb = rgb * weight[:, None]
        src = torch.cat([rgb, alpha[:, None]], dim=-1)           # (P, 4)
        blended = (src * _blend_factor(src_factor, src, dst)
                   + dst * _blend_factor(dst_factor, src, dst))
        # Fragment discard: below-threshold fragments don't touch dst.
        live = (cover * (weight >= 1e-4))[:, None]
        dst = dst + live * (blended - dst)
    return dst.reshape(h, w, 4)


# ---------------------------------------------------------------------------
# full-scene entry points
# ---------------------------------------------------------------------------

def _pixels(camera: Camera, like: torch.Tensor):
    return pixel_centers_ndc(camera.width, camera.height, device=like.device,
                             dtype=like.dtype)


def render_splats3d(splats: Splats3D, camera: Camera,
                    opacity: Optional[torch.Tensor] = None,
                    sort_mean3: Optional[torch.Tensor] = None,
                    background=(0.0, 0.0, 0.0, 1.0),
                    sort: bool = True, chunk: int = 256,
                    premultiplied: bool = False) -> torch.Tensor:
    """Render 3D splats (optionally with a per-splat extra opacity, i.e. a
    sliced 4D scene) through the dense golden path. Returns (H, W, 4).
    premultiplied=True is the reference's dedicated 3D path; the 4D scenes
    use straight color (the default)."""
    pos = splats.position
    op = (torch.ones((splats.count,), dtype=pos.dtype, device=pos.device)
          if opacity is None else opacity)
    proj = project_splats(pos, splats.cov, splats.color, op, camera,
                          sort_mean3=sort_mean3)
    # Unsorted, the painter draws index 0 first: front to back is reversed
    # index order.
    proj = sort_front_to_back(proj) if sort else _reversed(proj)
    pmat = camera.proj_matrix().to(pos.dtype)
    px, py = _pixels(camera, pos)
    return composite_dense(proj, px, py, pmat[0, 0], pmat[1, 1],
                           _background(background, pos), chunk=chunk,
                           premultiplied=premultiplied)


def render_splats4d(splats: Splats4D, camera: Camera, t,
                    min_opacity=0.0, background=(0.0, 0.0, 0.0, 1.0),
                    sort: bool = True, chunk: int = 256) -> torch.Tensor:
    """Render a 4D scene at time t: temporal slice and opacity, EWA, the
    distance sort by the reference's quirky sorting mean, the ordered
    composite."""
    sliced, top = splats.at_time(t, min_opacity)
    sort_mean = mean_in_time_sortkey(splats.position, splats.cov, t)
    return render_splats3d(sliced, camera, opacity=top, sort_mean3=sort_mean,
                           background=background, sort=sort, chunk=chunk)


def project_splats2d(splats: Splats2D, camera: Camera
                     ) -> Tuple[Projected, torch.Tensor, torch.Tensor]:
    """Screen-space projection of 2D splats (the reference's shader in its
    shipped SCREEN_SPACE_POS configuration).

    A splat at world xy lands at center_ndc = (P00 x, P11 y) * (P00, P11) /
    (5 - ssz), with ssz the z of uProj (x, y, -1, 1); an NDC offset delta
    is k = delta (5 - ssz) / (P00, P11).

    Two reference quirks are kept: the eigenvalues are doubled (l =
    sqrt(2 lambda)), and the larger length goes with the lambda_min
    eigenvector, so the rendered ellipse is the stored covariance doubled
    and turned 90 degrees. The swapped lengths are stored in the record.

    Returns (proj, p00_eff, p11_eff): the effective projection diagonal
    absorbs the (5 - ssz) divisor, so pixel_weight() works unchanged."""
    pos = splats.position
    dtype = pos.dtype
    pmat = camera.proj_matrix().to(dtype)
    p00, p11 = pmat[0, 0], pmat[1, 1]
    ssz = -pmat[2, 2] + pmat[2, 3]  # z of uProj * (x, y, -1, 1), w_clip = 1
    denom = 5.0 - ssz               # w_clip of the quad vertices

    lmin, lmax, v0 = eigen2x2(splats.cov)
    l0 = torch.sqrt(2.0 * lmin)
    l1 = torch.sqrt(2.0 * lmax)

    n = splats.count

    def full(v):
        return torch.full((n,), v, dtype=dtype, device=pos.device)
    proj = Projected(
        mx=pos[:, 0] * p00 * p00 / denom,
        my=pos[:, 1] * p11 * p11 / denom,
        depth=full(0.0),                   # the 2D scene does not sort
        view_z=full(5.0),
        v0x=v0[:, 0], v0y=v0[:, 1],
        l0=l1,                             # the swap quirk
        l1=l0,
        r=splats.color[:, 0], g=splats.color[:, 1], b=splats.color[:, 2],
        a=splats.color[:, 3],
        opacity=full(1.0),
        valid=torch.ones((n,), dtype=torch.bool, device=pos.device),
    )
    return proj, p00 / denom, p11 / denom


def render_splats2d(splats: Splats2D, camera: Camera,
                    background=(0.0, 0.0, 0.0, 1.0),
                    chunk: int = 256) -> torch.Tensor:
    """Render the 2D-Gaussians workload: unsorted painter order over the
    splat list (reversed, it is front to back)."""
    pos = splats.position
    proj, p00e, p11e = project_splats2d(splats, camera)
    px, py = _pixels(camera, pos)
    return composite_dense(_reversed(proj), px, py, p00e, p11e,
                           _background(background, pos), chunk=chunk)

