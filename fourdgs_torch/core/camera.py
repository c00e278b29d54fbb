"""Camera producing view/projection matrices (port of fourdgs/core/camera.py).

Conventions are the reference's (GLM, right-handed, OpenGL clip z in
[-1, 1]); matrices are row-major math matrices: `M[i, j]` is row i, column j
and points transform as `M @ v`. Everything is float32 on the camera's
device, in the reference's order of operations.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch.profiler import record_function

from fourdgs_torch import resolve_device
from fourdgs_torch.core.transforms import rotate_about_axis


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


def look_at(eye: torch.Tensor, center: torch.Tensor,
            up: torch.Tensor) -> torch.Tensor:
    """Right-handed lookAt, identical to glm::lookAt."""
    f = _normalize(center - eye)
    s = _normalize(torch.linalg.cross(f, up))
    u = torch.linalg.cross(s, f)
    rot = torch.stack([s, u, -f])                     # rows
    view = torch.eye(4, dtype=eye.dtype, device=eye.device)
    view[:3, :3] = rot
    view[:3, 3] = -rot @ eye
    return view


def perspective(fov_y_rad: torch.Tensor, aspect: torch.Tensor,
                near: torch.Tensor, far: torch.Tensor) -> torch.Tensor:
    """Right-handed perspective with z in [-1, 1], identical to
    glm::perspective."""
    t = torch.tan(fov_y_rad * 0.5)
    p = torch.zeros((4, 4), dtype=t.dtype, device=t.device)
    p[0, 0] = 1.0 / (aspect * t)
    p[1, 1] = 1.0 / t
    p[2, 2] = -(far + near) / (far - near)
    p[2, 3] = -(2.0 * far * near) / (far - near)
    p[3, 2] = -1.0
    return p


@dataclasses.dataclass(frozen=True)
class Camera:
    """Immutable camera: 0-d/(3,) float32 tensors on one device, plus the
    image size in pixels."""

    position: torch.Tensor      # (3,)
    orientation: torch.Tensor   # (3,) viewing direction (not necessarily unit)
    up: torch.Tensor            # (3,)
    fov_deg: torch.Tensor       # () vertical field of view, degrees
    near: torch.Tensor          # ()
    far: torch.Tensor           # ()
    width: int = 800
    height: int = 800

    @staticmethod
    def create(position=(0.0, 0.0, 0.0), orientation=(0.0, 0.0, -1.0),
               up=(0.0, 1.0, 0.0), fov_deg=60.0, near=0.1, far=5000.0,
               width=800, height=800, device=None) -> "Camera":
        """Reference defaults (fov 60 deg, near 0.1, far 5000); on
        `device`, by default the card (fourdgs_torch.default_device)."""
        # A range around the camera's copies to the device, which a viewer
        # makes each frame.
        with record_function("fourdgs::camera"):
            device = resolve_device(device)

            def f32(x):
                return torch.as_tensor(x, dtype=torch.float32, device=device)
            return Camera(position=f32(position),
                          orientation=f32(orientation), up=f32(up),
                          fov_deg=f32(fov_deg), near=f32(near),
                          far=f32(far), width=int(width), height=int(height))

    @property
    def device(self) -> torch.device:
        return self.position.device

    @property
    def aspect(self) -> float:
        return float(self.width) / float(self.height)

    def view_matrix(self) -> torch.Tensor:
        return look_at(self.position, self.position + self.orientation,
                       self.up)

    def proj_matrix(self) -> torch.Tensor:
        fov = torch.deg2rad(self.fov_deg)
        aspect = torch.tensor(self.aspect, dtype=torch.float32,
                              device=self.device)
        return perspective(fov, aspect, self.near, self.far)

    def view_proj_matrix(self) -> torch.Tensor:
        return self.proj_matrix() @ self.view_matrix()

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.position.dtype,
                               device=self.device)

    def viewport(self) -> torch.Tensor:
        """normalize(vec2(w, h))."""
        v = self._f32([self.width, self.height])
        return v / torch.linalg.vector_norm(v)

    def focal(self) -> torch.Tensor:
        """(w, h) / (2 tan(fov / 2)), fov in radians (the mathematically
        intended value; the reference's shaders never read it)."""
        d = 2.0 * torch.tan(torch.deg2rad(self.fov_deg) * 0.5)
        return self._f32([self.width, self.height]) / d

    def with_pose(self, position=None, orientation=None,
                  up=None) -> "Camera":
        return dataclasses.replace(
            self,
            position=self.position if position is None
            else self._f32(position),
            orientation=self.orientation if orientation is None
            else self._f32(orientation),
            up=self.up if up is None else self._f32(up))

    def moved(self, delta) -> "Camera":
        """Translate along world axes."""
        return dataclasses.replace(self,
                                   position=self.position + self._f32(delta))

    def orbit(self, angle_rad, axis=(0.0, 1.0, 0.0),
              center=(0.0, 0.0, 0.0)) -> "Camera":
        """Rotate the camera position about `axis` through `center`, looking
        at `center` (the fixed-view-point mode)."""
        c = self._f32(center)
        p = rotate_about_axis(self.position - c, self._f32(angle_rad),
                              self._f32(axis)) + c
        return dataclasses.replace(self, position=p,
                                   orientation=_normalize(c - p))


def pixel_centers_ndc(width: int, height: int, device=None,
                      dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """NDC coordinates of pixel centers for an image with row 0 at the top:
    (px, py), each (H, W), on `device` (None: the card,
    fourdgs_torch.default_device)."""
    device = resolve_device(device)
    xs = (torch.arange(width, dtype=dtype, device=device) + 0.5) \
        / width * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, dtype=dtype, device=device) + 0.5) \
        / height * 2.0
    px = torch.broadcast_to(xs[None, :], (height, width))
    py = torch.broadcast_to(ys[:, None], (height, width))
    return px, py
