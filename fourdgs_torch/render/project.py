"""EWA projection: world-space 3D covariance -> screen-space footprint
(port of fourdgs/render/project.py; the reference module documents the
derivation from the shader it re-implements).

Every per-splat quantity is a separate (N,) float32 tensor ("scalar SoA").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from fourdgs_torch.core.camera import Camera

LAMBDA_EPS = 1e-6          # eigenvalue clamp
CULL_BOUND = 1.2           # NDC xy cull bound
ALPHA_DISCARD = 1e-4       # fragment discard threshold
FOOTPRINT_SCALE = 8.0      # fragment-coordinate scale
# Radius of the w >= 1e-4 discard threshold in normalized quad coords:
# exp(-32 r^2) = 1e-4  =>  r = sqrt(ln(1e4)/32) = 0.536492; +0.1% slack.
R_COVER = 0.5371


def eigen2x2_scalar(a, b, c):
    """Closed-form symmetric 2x2 eigendecomposition on component tensors,
    with the reference's 1e-24 discriminant and 1e-6 eigenvalue clamps.
    Input [[a, b], [b, c]]; returns (lmin, lmax, v0x, v0y), (v0x, v0y) the
    unit lambda_min eigenvector. Where (b, lmin - a) vanishes (b == 0) the
    eigenvector falls back to the axis of the smaller diagonal entry, and
    its gradient is 0: the norm's square root and reciprocal are taken of
    1 there, so that no 0 / 0 (the square root's gradient at 0, or an
    overflowed 1 / norm^2) reaches the splat's parameters. The values are
    the reference's bit for bit."""
    m = 0.5 * (a + c)
    p = a * c - b * b
    d = torch.sqrt(torch.clamp(m * m - p, min=1e-24))
    lmin = torch.clamp(m - d, min=LAMBDA_EPS)
    lmax = torch.clamp(m + d, min=LAMBDA_EPS)
    vx, vy = b, lmin - a
    norm2 = vx * vx + vy * vy
    ok = torch.sqrt(norm2.detach()) > 1e-12
    inv = 1.0 / torch.sqrt(torch.where(ok, norm2, 1.0))
    fx = (a <= c).to(a.dtype)
    fy = 1.0 - fx
    v0x = torch.where(ok, vx * inv, fx)
    v0y = torch.where(ok, vy * inv, fy)
    return lmin, lmax, v0x, v0y


def eigen2x2(cov2: torch.Tensor):
    """Matrix-shaped wrapper over eigen2x2_scalar: cov2 (..., 2, 2) ->
    (lmin, lmax, v0 (..., 2))."""
    lmin, lmax, v0x, v0y = eigen2x2_scalar(
        cov2[..., 0, 0], cov2[..., 0, 1], cov2[..., 1, 1])
    return lmin, lmax, torch.stack([v0x, v0y], dim=-1)


@dataclasses.dataclass(frozen=True)
class Projected:
    """Screen-space splats, every field an (N,) tensor. Lengths l are in k
    units (NDC offset over the projection diagonal)."""
    mx: torch.Tensor        # splat center NDC x
    my: torch.Tensor        # splat center NDC y
    depth: torch.Tensor     # sort key: 1 / |mu(t) - cam|
    view_z: torch.Tensor    # camera-space -z (positive in front)
    v0x: torch.Tensor       # unit eigenvector (lambda_min) x
    v0y: torch.Tensor
    l0: torch.Tensor        # sqrt(lambda_min)
    l1: torch.Tensor        # sqrt(lambda_max)
    r: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    a: torch.Tensor         # color alpha
    opacity: torch.Tensor   # temporal opacity multiplier
    valid: torch.Tensor     # bool: survived frustum cull

    @property
    def count(self) -> int:
        return self.mx.shape[0]

    def map(self, fn) -> "Projected":
        """Projected with fn applied to every field (a permutation, a
        reversal, a move)."""
        return Projected(**{f.name: fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)})

    def to(self, device) -> "Projected":
        return self.map(lambda a: a.to(device))

    def half_extent_ndc(self, p00: torch.Tensor, p11: torch.Tensor):
        """Half extents (hx, hy) in NDC of the visible footprint (quad
        intersect discard ellipse), for tile binning."""
        ax, ay = torch.abs(self.v0x), torch.abs(self.v0y)
        qx = 0.5 * (ax * self.l0 + ay * self.l1)
        qy = 0.5 * (ay * self.l0 + ax * self.l1)
        ex = R_COVER * torch.sqrt((self.v0x * self.l0) ** 2
                                  + (self.v0y * self.l1) ** 2)
        ey = R_COVER * torch.sqrt((self.v0y * self.l0) ** 2
                                  + (self.v0x * self.l1) ** 2)
        return torch.minimum(qx, ex) * p00, torch.minimum(qy, ey) * p11


def project_components(mx, my, mz, cov3, colors, opacity, camera: Camera,
                       sort_mean: Optional[Tuple] = None) -> Projected:
    """Project N world-space Gaussians given as component tensors.

    mx/my/mz: (N,) world mean; cov3: 6-tuple (c00, c01, c02, c11, c12, c22);
    colors: 4-tuple (r, g, b, a); opacity: (N,) temporal term; sort_mean
    optionally overrides the distance-sort position.
    """
    view = camera.view_matrix()
    proj = camera.proj_matrix()
    c00, c01, c02, c11, c12, c22 = cov3
    cr, cg, cb, ca = colors

    v = [[view[0, 0], view[0, 1], view[0, 2]],
         [view[1, 0], view[1, 1], view[1, 2]],
         [view[2, 0], view[2, 1], view[2, 2]]]
    t0, t1, t2 = view[0, 3], view[1, 3], view[2, 3]

    # Camera space.
    xc = v[0][0] * mx + v[0][1] * my + v[0][2] * mz + t0
    yc = v[1][0] * mx + v[1][1] * my + v[1][2] * mz + t1
    zc = v[2][0] * mx + v[2][1] * my + v[2][2] * mz + t2

    # Clip -> NDC (proj row 3 = (0, 0, -1, 0)).
    w_clip = -zc
    tiny = torch.where(w_clip < 0, -1e-9, 1e-9)
    inv_w = 1.0 / torch.where(torch.abs(w_clip) > 1e-9, w_clip, tiny)
    sx = proj[0, 0] * xc * inv_w
    sy = proj[1, 1] * yc * inv_w
    z_ndc = (proj[2, 2] * zc + proj[2, 3]) * inv_w

    # Frustum cull (the reference's asymmetric z test included).
    valid = ((z_ndc >= 0.0) & (z_ndc <= 1.0)
             & (torch.abs(sx) <= CULL_BOUND) & (torch.abs(sy) <= CULL_BOUND))

    # A = J_std V3 (2x3), J rows = d(x/z, y/z)/d cam.
    zs = torch.where(torch.abs(zc) > 1e-6, zc,
                     torch.where(zc < 0, -1e-6, 1e-6))
    f = 1.0 / zs
    gx = xc * f
    gy = yc * f
    a00 = f * (v[0][0] - gx * v[2][0])
    a01 = f * (v[0][1] - gx * v[2][1])
    a02 = f * (v[0][2] - gx * v[2][2])
    a10 = f * (v[1][0] - gy * v[2][0])
    a11 = f * (v[1][1] - gy * v[2][1])
    a12 = f * (v[1][2] - gy * v[2][2])

    # cov2 = A Sigma A^T, Sigma symmetric.
    u0x = a00 * c00 + a01 * c01 + a02 * c02
    u0y = a00 * c01 + a01 * c11 + a02 * c12
    u0z = a00 * c02 + a01 * c12 + a02 * c22
    q00 = u0x * a00 + u0y * a01 + u0z * a02
    q01 = u0x * a10 + u0y * a11 + u0z * a12
    u1x = a10 * c00 + a11 * c01 + a12 * c02
    u1y = a10 * c01 + a11 * c11 + a12 * c12
    u1z = a10 * c02 + a11 * c12 + a12 * c22
    q11 = u1x * a10 + u1y * a11 + u1z * a12

    lmin, lmax, v0x, v0y = eigen2x2_scalar(q00, q01, q11)

    # Depth sort key: 1 / euclidean distance.
    smx, smy, smz = (mx, my, mz) if sort_mean is None else sort_mean
    cam_p = camera.position
    dx = smx - cam_p[0]
    dy = smy - cam_p[1]
    dz = smz - cam_p[2]
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    depth = 1.0 / torch.clamp(dist, min=1e-12)

    n = mx.shape[0]
    return Projected(
        mx=sx, my=sy, depth=depth, view_z=-zc,
        v0x=v0x, v0y=v0y, l0=torch.sqrt(lmin), l1=torch.sqrt(lmax),
        r=torch.broadcast_to(cr, (n,)), g=torch.broadcast_to(cg, (n,)),
        b=torch.broadcast_to(cb, (n,)), a=torch.broadcast_to(ca, (n,)),
        opacity=torch.broadcast_to(torch.as_tensor(opacity, dtype=mx.dtype,
                                                   device=mx.device), (n,)),
        valid=valid,
    )


def project_splats(mean3: torch.Tensor, cov3: torch.Tensor,
                   color: torch.Tensor, opacity, camera: Camera,
                   sort_mean3: Optional[torch.Tensor] = None) -> Projected:
    """Matrix-shaped wrapper over project_components: mean3 (N, 3), cov3
    (N, 3, 3), color (N, 4), opacity (N,) or a scalar."""
    cov = (cov3[:, 0, 0], cov3[:, 0, 1], cov3[:, 0, 2],
           cov3[:, 1, 1], cov3[:, 1, 2], cov3[:, 2, 2])
    colors = (color[:, 0], color[:, 1], color[:, 2], color[:, 3])
    sm = None if sort_mean3 is None else (sort_mean3[:, 0], sort_mean3[:, 1],
                                          sort_mean3[:, 2])
    return project_components(mean3[:, 0], mean3[:, 1], mean3[:, 2], cov,
                              colors, opacity, camera, sort_mean=sm)


def pixel_weight(proj2d: Projected, px: torch.Tensor, py: torch.Tensor,
                 p00, p11):
    """Gaussian weight of every (splat, pixel) pair and the quad-coverage
    mask, the fragment shader's math. px, py: pixel NDC coordinates of any
    shape P; splat fields (N,). Returns (weight, coverage), each (N,) + P:

        weight = exp(-0.5 * 64 * ((k_eig0 / l0)^2 + (k_eig1 / l1)^2))

    with k = NDC offset / (p00, p11) in the splat's eigenframe; coverage is
    the quad clip |k_eig,i| <= 0.5 l_i and weight >= ALPHA_DISCARD."""
    pshape = px.shape
    px = px.reshape((1,) + pshape)
    py = py.reshape((1,) + pshape)
    expand = (slice(None),) + (None,) * len(pshape)

    dx = (px - proj2d.mx[expand]) / p00
    dy = (py - proj2d.my[expand]) / p11
    v0x = proj2d.v0x[expand]
    v0y = proj2d.v0y[expand]
    k0 = v0x * dx + v0y * dy        # along v0 (the lambda_min axis)
    k1 = v0y * dx - v0x * dy        # along v1 = (v0y, -v0x)
    n0 = k0 / proj2d.l0[expand]
    n1 = k1 / proj2d.l1[expand]
    q = (FOOTPRINT_SCALE * FOOTPRINT_SCALE) * (n0 * n0 + n1 * n1)
    weight = torch.exp(-0.5 * q)
    coverage = ((torch.abs(n0) <= 0.5) & (torch.abs(n1) <= 0.5)
                & (weight >= ALPHA_DISCARD))
    return weight, coverage
