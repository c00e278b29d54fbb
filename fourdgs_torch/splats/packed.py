"""Scalar structure-of-arrays 4D splat math (port of fourdgs/splats/packed.py).

A scene is a dict of (N,) float32 component tensors (`PARAM4D_FIELDS`).
Symmetric matrices are carried as their upper triangles:

    cov3: (c00, c01, c02, c11, c12, c22)
    cov4: cov3 + (c03, c13, c23, c33)
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from fourdgs_torch import as_tensors, resolve_device

PARAM4D_FIELDS = ("px", "py", "pz", "pt", "qw", "qx", "qy", "qz",
                  "sx", "sy", "sz", "lifetime", "fade", "vx", "vy", "vz",
                  "cr", "cg", "cb", "ca")


def params4d_from_arrays(position4, quat, scale3, lifetime, fade, velocity,
                         color, device=None) -> Dict[str, torch.Tensor]:
    """Split (N, k) parameters into the packed (N,) component dict, on
    `device` (fourdgs_torch.as_tensors: without one, tensors stay where
    they are and arrays go beside them, or to the card); lifetime and fade
    may be scalars, broadcast to (N,) in position4's dtype and device."""
    position4, quat, scale3, lifetime, fade, velocity, color = as_tensors(
        position4, quat, scale3, lifetime, fade, velocity, color,
        device=device)
    n = position4.shape[0]

    def per_splat(x):
        x = torch.as_tensor(x, dtype=position4.dtype, device=position4.device)
        return torch.broadcast_to(x, (n,)).contiguous()
    return dict(
        px=position4[:, 0], py=position4[:, 1], pz=position4[:, 2],
        pt=position4[:, 3],
        qw=quat[:, 0], qx=quat[:, 1], qy=quat[:, 2], qz=quat[:, 3],
        sx=scale3[:, 0], sy=scale3[:, 1], sz=scale3[:, 2],
        lifetime=per_splat(lifetime), fade=per_splat(fade),
        vx=velocity[:, 0], vy=velocity[:, 1], vz=velocity[:, 2],
        cr=color[:, 0], cg=color[:, 1], cb=color[:, 2], ca=color[:, 3],
    )


def time_like(t, like: torch.Tensor):
    """A frame time for arithmetic with `like`: a tensor (0-d, or per
    splat) in like's dtype, left on its device, or a Python float. Neither
    reads a tensor back to the host, so a time on the card costs no sync."""
    if isinstance(t, torch.Tensor):
        return t.to(like.dtype)
    return float(t)


def params4d_from_numpy(params_np: Mapping[str, np.ndarray],
                        device=None) -> Dict[str, torch.Tensor]:
    """The reference's packed parameter dict (numpy arrays) -> the port's
    tensors on `device`, by default the card
    (fourdgs_torch.default_device). Checks the field set, dtype float32, 1-D
    and equal lengths, and raises ValueError on any mismatch."""
    fields = set(params_np)
    if fields != set(PARAM4D_FIELDS):
        missing = sorted(set(PARAM4D_FIELDS) - fields)
        extra = sorted(fields - set(PARAM4D_FIELDS))
        raise ValueError(f"param fields differ: missing {missing}, "
                         f"unexpected {extra}")
    device = resolve_device(device)
    n = None
    out = {}
    for k in PARAM4D_FIELDS:
        a = np.asarray(params_np[k])
        if a.dtype != np.float32:
            raise ValueError(f"field {k!r} has dtype {a.dtype}, want float32")
        if a.ndim != 1:
            raise ValueError(f"field {k!r} has shape {a.shape}, want (N,)")
        if n is None:
            n = a.shape[0]
        elif a.shape[0] != n:
            raise ValueError(f"field {k!r} has length {a.shape[0]}, want {n}")
        out[k] = torch.tensor(a, device=device)
    return out


def grads4d_to_numpy(params: Mapping[str, torch.Tensor]
                     ) -> Dict[str, np.ndarray]:
    """The inverse of params4d_from_numpy for gradients: the `.grad` of
    every PARAM4D_FIELDS tensor as a numpy array under the reference's key
    (what `jax.grad` of a loss of the packed dict returns). A field that
    got no gradient raises ValueError."""
    out = {}
    for k in PARAM4D_FIELDS:
        g = params[k].grad
        if g is None:
            raise ValueError(f"field {k!r} has no gradient")
        out[k] = g.detach().cpu().numpy()
    return out


def rot_from_quat(qw, qx, qy, qz):
    """Component form of glm::toMat3; normalizes internally. Returns the 9
    rotation components r00..r22."""
    inv = torch.rsqrt(qw * qw + qx * qx + qy * qy + qz * qz + 1e-30)
    w, x, y, z = qw * inv, qx * inv, qy * inv, qz * inv
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))


def cov3_from_quat_scale(qw, qx, qy, qz, sx, sy, sz):
    """Sigma3 = R diag(s^2) R^T in components."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rot_from_quat(qw, qx, qy, qz)
    s0, s1, s2 = sx * sx, sy * sy, sz * sz
    c00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    c01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    c02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    c11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    c12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    c22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return c00, c01, c02, c11, c12, c22


def cov4_motion(params: Dict[str, torch.Tensor]):
    """Sigma4 of the motion parameterization in components. Returns the
    10-tuple (c00, c01, c02, c11, c12, c22, c03, c13, c23, c33)."""
    st = (params["lifetime"] * params["lifetime"]) / (
        -2.0 * torch.log(params["fade"]))
    tx, ty, tz = params["vx"] * st, params["vy"] * st, params["vz"] * st
    c00, c01, c02, c11, c12, c22 = cov3_from_quat_scale(
        params["qw"], params["qx"], params["qy"], params["qz"],
        params["sx"], params["sy"], params["sz"])
    inv_st = 1.0 / st
    return (c00 + tx * tx * inv_st, c01 + tx * ty * inv_st,
            c02 + tx * tz * inv_st, c11 + ty * ty * inv_st,
            c12 + ty * tz * inv_st, c22 + tz * tz * inv_st,
            tx, ty, tz, st)


def slice4d(params: Dict[str, torch.Tensor], cov4, t,
            min_opacity: float = 0.0):
    """Conditional slice at time t (a Python float or a 0-d tensor, see
    time_like) plus temporal opacity, in components. Returns (mx, my, mz,
    cov3_6tuple, opacity, (sort_mx, sort_my, sort_mz)).

    The sort mean reproduces the reference's quirky sorting position,
    advanced by Sigma_{4,1:3} itself rather than the conditional velocity.
    """
    (c00, c01, c02, c11, c12, c22, c03, c13, c23, c33) = cov4
    dt = time_like(t, c33) - params["pt"]
    inv_st = 1.0 / c33
    mx = params["px"] + c03 * inv_st * dt
    my = params["py"] + c13 * inv_st * dt
    mz = params["pz"] + c23 * inv_st * dt
    s00 = c00 - c03 * c03 * inv_st
    s01 = c01 - c03 * c13 * inv_st
    s02 = c02 - c03 * c23 * inv_st
    s11 = c11 - c13 * c13 * inv_st
    s12 = c12 - c13 * c23 * inv_st
    s22 = c22 - c23 * c23 * inv_st
    opacity = torch.clamp(torch.exp(-0.5 * dt * dt * inv_st),
                          min=float(min_opacity))
    sort_mx = params["px"] + c03 * dt
    sort_my = params["py"] + c13 * dt
    sort_mz = params["pz"] + c23 * dt
    return (mx, my, mz, (s00, s01, s02, s11, s12, s22), opacity,
            (sort_mx, sort_my, sort_mz))


def morton_order(params: Dict[str, torch.Tensor],
                 bits: int = 10) -> Dict[str, torch.Tensor]:
    """Reorder the parameter dict by the 3D Morton (Z-order) code of splat
    position, a one-time scene-build step. Spatially adjacent splats become
    adjacent in memory, which gives each chunk of the banded tail screen-tile
    locality for any camera. Values are unchanged; only the order moves.
    The sort is stable (ties keep their input order), as the reference's."""
    def q(x):
        lo = x.min()
        span = torch.clamp(x.max() - lo, min=1e-12)
        return torch.clamp((x - lo) / span * (1 << bits), 0,
                           (1 << bits) - 1).to(torch.int64)

    def spread(v):
        # Interleave: two zero bits between each of the 10 bits (the
        # reference's uint32 arithmetic, held in int64 and masked).
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    code = (spread(q(params["px"])) | (spread(q(params["py"])) << 1)
            | (spread(q(params["pz"])) << 2)) & 0xFFFFFFFF
    order = torch.argsort(code, stable=True)
    return {k: v[order] for k, v in params.items()}


# Pad splats: unit quaternion, epsilon scales and lifetime, zero opacity.
_PAD_FILL = dict(qw=1.0, sx=1e-6, sy=1e-6, sz=1e-6, lifetime=1e-6, fade=0.5,
                 ca=0.0)


def pad_packed_params(params: Dict[str, torch.Tensor],
                      multiple: int = 2048) -> Dict[str, torch.Tensor]:
    """Pad the parameter dict with dead splats (opacity 0) to a length
    multiple, a one-time scene-build step that makes every per-splat array
    of the frame already tail-chunk aligned."""
    n = params["px"].shape[0]
    pad = -(-n // multiple) * multiple - n
    if pad == 0:
        return params
    return {k: torch.cat([v, v.new_full((pad,), _PAD_FILL.get(k, 0.0))])
            for k, v in params.items()}
