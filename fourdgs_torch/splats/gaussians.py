"""Gaussian splat parameterizations: covariance builders and 4D time slicing
(port of fourdgs/splats/gaussians.py).

Splats are structure-of-arrays dataclasses of tensors; every builder is a
batched, differentiable PyTorch function. Matrices are row-major math
matrices (see core/camera.py).

`splats2d_from_numpy`, `splats3d_from_numpy` and `splats4d_from_numpy` hand
the reference's splat arrays (numpy) over to the port, as
`splats.packed.params4d_from_numpy` does for the packed parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fourdgs_torch import as_tensors, resolve_device
from fourdgs_torch.core.transforms import quat_normalize, quat_to_mat3
from fourdgs_torch.splats.packed import time_like

# -2 ln(0.5), the constant the reference's scenes use at fade == 0.5.
STD_LOWER = 1.3862943611198906


# ---------------------------------------------------------------------------
# covariance builders
# ---------------------------------------------------------------------------

def build_cov2d(v0: torch.Tensor, l0: torch.Tensor,
                l1: torch.Tensor) -> torch.Tensor:
    """2D covariance R diag(l0, l1) R^T with R = [v0 | perp(v0)] (columns).
    v0: (..., 2), l0/l1: (...,). Returns (..., 2, 2)."""
    v0 = v0 / torch.clamp(torch.linalg.vector_norm(v0, dim=-1, keepdim=True),
                          min=1e-12)
    v1 = torch.stack([v0[..., 1], -v0[..., 0]], dim=-1)
    r = torch.stack([v0, v1], dim=-1)                 # columns
    s2 = torch.stack([l0, l1], dim=-1)
    return torch.einsum("...ik,...k,...jk->...ij", r, s2, r)


def build_cov3d(quat: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """3D covariance R S S R^T; quat (..., 4) wxyz (normalized here), scale
    (..., 3) standard deviations."""
    r = quat_to_mat3(quat_normalize(quat))
    return torch.einsum("...ik,...k,...jk->...ij", r, scale * scale, r)


def isoclinic_left(q: torch.Tensor) -> torch.Tensor:
    """Left-isoclinic 4x4 rotation of a unit quaternion."""
    a, b, c, d = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([a, b, c, d], dim=-1),
        torch.stack([-b, a, d, -c], dim=-1),
        torch.stack([-c, -d, a, b], dim=-1),
        torch.stack([-d, c, -b, a], dim=-1),
    ], dim=-2)


def isoclinic_right(q: torch.Tensor) -> torch.Tensor:
    """Right-isoclinic 4x4 rotation of a unit quaternion."""
    p, q_, r, s = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([p, q_, r, s], dim=-1),
        torch.stack([-q_, p, -s, r], dim=-1),
        torch.stack([-r, s, p, -q_], dim=-1),
        torch.stack([-s, -r, q_, p], dim=-1),
    ], dim=-2)


def build_cov4d_isoclinic(rot0: torch.Tensor, rot1: torch.Tensor,
                          scale4: torch.Tensor) -> torch.Tensor:
    """4D covariance (Ml Mr) S S^T (Ml Mr)^T from two unit quaternions
    (SO(4) = left x right isoclinic) and four scales."""
    rot = isoclinic_left(quat_normalize(rot0)) @ isoclinic_right(
        quat_normalize(rot1))
    return torch.einsum("...ik,...k,...jk->...ij", rot, scale4 * scale4, rot)


def motion_sigma_t(lifetime: torch.Tensor, fade: torch.Tensor
                   ) -> torch.Tensor:
    """Temporal variance lifetime^2 / (-2 ln fade); fade in (0, 1)."""
    return (lifetime * lifetime) / (-2.0 * torch.log(fade))


def build_cov4d_motion(quat, scale3, lifetime, fade, velocity
                       ) -> torch.Tensor:
    """4D covariance of the motion parameterization:

        sigma_t = lifetime^2 / (-2 ln fade),  tvec = velocity * sigma_t
        Sigma4  = [[R S S R^T + tvec tvec^T / sigma_t, tvec],
                   [tvec^T,                            sigma_t]]

    so the conditional spatial covariance at any t is R S S R^T and the
    conditional mean moves with `velocity`."""
    st = motion_sigma_t(lifetime, fade)
    tvec = velocity * st[..., None]
    sig3 = build_cov3d(quat, scale3)
    upper = sig3 + tvec[..., :, None] * tvec[..., None, :] / st[..., None, None]
    top = torch.cat([upper, tvec[..., :, None]], dim=-1)
    bottom = torch.cat([tvec, st[..., None]], dim=-1)[..., None, :]
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# 4D -> 3D conditional slice + temporal opacity
# ---------------------------------------------------------------------------

def slice_cov4d(pos4: torch.Tensor, cov4: torch.Tensor, t):
    """Condition a 4D Gaussian on time t:

        mu(t)      = mu_xyz + Sigma_{1:3,4} / Sigma_44 * (t - mu_t)
        Sigma3 | t = Sigma_{1:3,1:3} - Sigma_{1:3,4} Sigma_{4,1:3} / Sigma_44

    pos4 (..., 4) = (x, y, z, mu_t); cov4 (..., 4, 4); t scalar or (...,).
    Returns (mean3 (..., 3), cov3 (..., 3, 3))."""
    t = time_like(t, pos4)
    sig_t = cov4[..., 3, 3]
    sig34 = cov4[..., :3, 3]
    inv_st = 1.0 / sig_t
    mean3 = pos4[..., :3] + sig34 * (inv_st * (t - pos4[..., 3]))[..., None]
    cov3 = cov4[..., :3, :3] - sig34[..., :, None] * (
        sig34 * inv_st[..., None])[..., None, :]
    return mean3, cov3


def temporal_opacity(pos4: torch.Tensor, cov4: torch.Tensor, t,
                     min_opacity=0.0) -> torch.Tensor:
    """max(exp(-1/2 (t - mu_t)^2 / Sigma_44), min_opacity)."""
    dt = time_like(t, pos4) - pos4[..., 3]
    p = torch.exp(-0.5 * dt * dt / cov4[..., 3, 3])
    return torch.clamp(p, min=min_opacity)


def mean_in_time_sortkey(pos4: torch.Tensor, cov4: torch.Tensor, t
                         ) -> torch.Tensor:
    """The sorting mean of the reference's 4D scenes:

        mu_sort(t) = mu_xyz + Sigma_{4,1:3} * (t - mu_t)

    It advances the mean by the raw covariance row Sigma_{4,1:3} = velocity *
    sigma_t, not by the conditional velocity Sigma_{4,1:3} / Sigma_44 the
    renderer uses, so depth order is taken at a slightly different position
    than the rendered splat. The quirk is kept: the blend order, and so the
    image, depends on it."""
    dt = time_like(t, pos4) - pos4[..., 3]
    return pos4[..., :3] + cov4[..., 3, :3] * dt[..., None]


# ---------------------------------------------------------------------------
# splat batches (structure-of-arrays)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Splats:
    position: torch.Tensor
    color: torch.Tensor
    cov: torch.Tensor

    @property
    def count(self) -> int:
        return self.position.shape[0]

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class Splats2D(_Splats):
    """N two-dimensional Gaussians: position (N, 2) screen/world xy, color
    (N, 4) rgba, cov (N, 2, 2)."""


@dataclasses.dataclass(frozen=True)
class Splats3D(_Splats):
    """N static 3D Gaussians: position (N, 3), color (N, 4) rgba, cov
    (N, 3, 3)."""

    @staticmethod
    def from_params(position, quat, scale, color, device=None
                    ) -> "Splats3D":
        """From means, rotations and scales, on `device` (as_tensors)."""
        position, quat, scale, color = as_tensors(position, quat, scale,
                                                  color, device=device)
        return Splats3D(position=position, color=color,
                        cov=build_cov3d(quat, scale))


@dataclasses.dataclass(frozen=True)
class Splats4D(_Splats):
    """N space-time Gaussians: position (N, 4) = (xyz, mu_t), color (N, 4)
    rgba, cov (N, 4, 4)."""

    @staticmethod
    def from_motion(position4, quat, scale3, lifetime, fade, velocity,
                    color, device=None) -> "Splats4D":
        """The motion parameterization every demo scene uses, on `device`
        (as_tensors)."""
        position4, quat, scale3, lifetime, fade, velocity, color = (
            as_tensors(position4, quat, scale3, lifetime, fade, velocity,
                       color, device=device))
        return Splats4D(
            position=position4, color=color,
            cov=build_cov4d_motion(quat, scale3, lifetime, fade, velocity))

    @staticmethod
    def from_isoclinic(position4, rot0, rot1, scale4, color, device=None
                       ) -> "Splats4D":
        """The isoclinic (two-quaternion) parameterization, on `device`
        (as_tensors)."""
        position4, rot0, rot1, scale4, color = as_tensors(
            position4, rot0, rot1, scale4, color, device=device)
        return Splats4D(
            position=position4, color=color,
            cov=build_cov4d_isoclinic(rot0, rot1, scale4))

    def at_time(self, t, min_opacity=0.0):
        """Slice to (Splats3D, temporal opacity (N,)) at time t."""
        mean3, cov3 = slice_cov4d(self.position, self.cov, t)
        top = temporal_opacity(self.position, self.cov, t, min_opacity)
        return Splats3D(position=mean3, color=self.color, cov=cov3), top


def concatenate_splats4d(parts) -> Splats4D:
    return Splats4D(position=torch.cat([p.position for p in parts]),
                    color=torch.cat([p.color for p in parts]),
                    cov=torch.cat([p.cov for p in parts]))


# ---------------------------------------------------------------------------
# numpy hand-over
# ---------------------------------------------------------------------------

def _splats_from_numpy(cls, dim: int, position, color, cov, device):
    """The reference's splat arrays (numpy float32: position (N, dim), color
    (N, 4), cov (N, dim, dim)) as a `cls` on `device`, by default the card
    (fourdgs_torch.default_device). Raises ValueError on a dtype or shape
    mismatch."""
    arrays = dict(position=np.asarray(position), color=np.asarray(color),
                  cov=np.asarray(cov))
    n = arrays["position"].shape[0] if arrays["position"].ndim else None
    want = dict(position=(n, dim), color=(n, 4), cov=(n, dim, dim))
    for k, a in arrays.items():
        if a.dtype != np.float32:
            raise ValueError(f"{k} has dtype {a.dtype}, want float32")
        if n is None or a.shape != want[k]:
            raise ValueError(f"{k} has shape {a.shape}, want "
                             f"{('N',) + want[k][1:]}")
    device = resolve_device(device)
    return cls(**{k: torch.tensor(a, device=device)
                  for k, a in arrays.items()})


def splats2d_from_numpy(position, color, cov, device=None) -> Splats2D:
    """Splats2D from numpy arrays (N, 2), (N, 4), (N, 2, 2)."""
    return _splats_from_numpy(Splats2D, 2, position, color, cov, device)


def splats3d_from_numpy(position, color, cov, device=None) -> Splats3D:
    """Splats3D from numpy arrays (N, 3), (N, 4), (N, 3, 3)."""
    return _splats_from_numpy(Splats3D, 3, position, color, cov, device)


def splats4d_from_numpy(position, color, cov, device=None) -> Splats4D:
    """Splats4D from numpy arrays (N, 4), (N, 4), (N, 4, 4)."""
    return _splats_from_numpy(Splats4D, 4, position, color, cov, device)
