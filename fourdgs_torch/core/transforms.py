"""Quaternion / rotation helpers shared by the covariance builders (port of
fourdgs/core/transforms.py).

Quaternions are stored (w, x, y, z). Every function takes a leading `...`
batch shape and is differentiable.
"""

from __future__ import annotations

import torch


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return normalize(q)


def quat_to_mat3(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix of a (w, x, y, z) quaternion, as glm::toMat3; assumes
    q is normalized."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


def mat3_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> (w, x, y, z) quaternion, branch-free: all four of
    glm::quat_cast's branches, the one of the largest diagonal combination
    selected."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    sw = safe_sqrt(tw) * 0.5
    qw = torch.stack([sw,
                      (m[..., 2, 1] - m[..., 1, 2]) / (4 * sw),
                      (m[..., 0, 2] - m[..., 2, 0]) / (4 * sw),
                      (m[..., 1, 0] - m[..., 0, 1]) / (4 * sw)], dim=-1)
    sx = safe_sqrt(tx) * 0.5
    qx = torch.stack([(m[..., 2, 1] - m[..., 1, 2]) / (4 * sx),
                      sx,
                      (m[..., 0, 1] + m[..., 1, 0]) / (4 * sx),
                      (m[..., 0, 2] + m[..., 2, 0]) / (4 * sx)], dim=-1)
    sy = safe_sqrt(ty) * 0.5
    qy = torch.stack([(m[..., 0, 2] - m[..., 2, 0]) / (4 * sy),
                      (m[..., 0, 1] + m[..., 1, 0]) / (4 * sy),
                      sy,
                      (m[..., 1, 2] + m[..., 2, 1]) / (4 * sy)], dim=-1)
    sz = safe_sqrt(tz) * 0.5
    qz = torch.stack([(m[..., 1, 0] - m[..., 0, 1]) / (4 * sz),
                      (m[..., 0, 2] + m[..., 2, 0]) / (4 * sz),
                      (m[..., 1, 2] + m[..., 2, 1]) / (4 * sz),
                      sz], dim=-1)

    best = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)
    out = torch.where((best == 0)[..., None], qw,
                      torch.where((best == 1)[..., None], qx,
                                  torch.where((best == 2)[..., None], qy, qz)))
    return quat_normalize(out)


def quat_look_at(direction: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """glm::quatLookAt for a right-handed system: the rotation whose -Z axis
    is `direction`."""
    return mat3_to_quat(look_rotation(direction, up))


def look_rotation(direction: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Rotation matrix with columns (right, up', -direction), the matrix form
    of glm::quatLookAt(direction, up)."""
    col2 = -normalize(direction)
    col0 = normalize(torch.linalg.cross(torch.broadcast_to(up, col2.shape),
                                        col2))
    col1 = torch.linalg.cross(col2, col0)
    return torch.stack([col0, col1, col2], dim=-1)


def rotate_about_axis(v: torch.Tensor, angle_rad: torch.Tensor,
                      axis: torch.Tensor) -> torch.Tensor:
    """glm::rotate(vec, angle, axis): the Rodrigues rotation."""
    k = normalize(axis)
    c = torch.cos(angle_rad)[..., None]
    s = torch.sin(angle_rad)[..., None]
    k, v = torch.broadcast_tensors(k, v)
    return (v * c + torch.linalg.cross(k, v) * s
            + k * torch.sum(k * v, dim=-1, keepdim=True) * (1.0 - c))


def rotation_2d(angle_rad: torch.Tensor) -> torch.Tensor:
    """2x2 rotation matrix of the 2D scene construction
    `glm::mat2 R{cos, -sin, sin, cos}`; GLM fills columns, so the math matrix
    is [[c, s], [-s, c]]."""
    c, s = torch.cos(angle_rad), torch.sin(angle_rad)
    row0 = torch.stack([c, s], dim=-1)
    row1 = torch.stack([-s, c], dim=-1)
    return torch.stack([row0, row1], dim=-2)
