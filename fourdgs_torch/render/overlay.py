"""Debug overlays: world-space lines, grid and axis cross (port of
fourdgs/render/overlay.py).

The analog of the reference Renderer's immediate-mode helpers, DrawLine
(Renderer.cpp:41-77), DrawGrid (:113-162) and DrawAxis (:206-215): each
segment is rasterized analytically (project the endpoints, clip at the
near plane, alpha-blend the pixels within half the line width of the 2D
segment), one segment after another over the image, as the reference's
`lax.scan` does.
"""

from __future__ import annotations

import numpy as np
import torch

from fourdgs_torch.core.camera import Camera


def _project_points(pts: torch.Tensor, camera: Camera):
    """World (N, 3) -> (ndc_xy (N, 2), w_clip (N,)). Points behind the
    camera get w <= 0."""
    dtype = pts.dtype
    view = camera.view_matrix().to(dtype)
    proj = camera.proj_matrix().to(dtype)
    cam = pts @ view[:3, :3].T + view[:3, 3]
    w = -cam[:, 2]
    x = proj[0, 0] * cam[:, 0]
    y = proj[1, 1] * cam[:, 1]
    return torch.stack([x, y], -1), w


def draw_lines(image: torch.Tensor, camera: Camera,
               p0: torch.Tensor, p1: torch.Tensor, colors: torch.Tensor,
               width_px: float = 2.0) -> torch.Tensor:
    """Blend N world-space segments over `image` (H, W, 4), in order.

    p0/p1 (N, 3) endpoints, colors (N, 4) rgba (alpha scales blending, like
    the reference's translucent grid color {1,1,1,0.15}, Scenes.h:303).
    """
    h, w = image.shape[:2]
    dtype, dev = image.dtype, image.device
    eps = 1e-4

    a_ndc, wa = _project_points(p0, camera)
    b_ndc, wb = _project_points(p1, camera)

    # Clip segments crossing the near plane (w = eps): move the behind
    # endpoint to the intersection.
    both_behind = (wa <= eps) & (wb <= eps)
    t_clip = torch.clamp((eps - wa) / torch.where(torch.abs(wb - wa) > 1e-12,
                                                  wb - wa, 1e-12), 0.0, 1.0)
    clip_pt = a_ndc + (b_ndc - a_ndc) * t_clip[:, None]
    clip_w = wa + (wb - wa) * t_clip
    a_ndc2 = torch.where((wa <= eps)[:, None], clip_pt, a_ndc)
    wa2 = torch.where(wa <= eps, clip_w, wa)
    b_ndc2 = torch.where((wb <= eps)[:, None], clip_pt, b_ndc)
    wb2 = torch.where(wb <= eps, clip_w, wb)

    # Perspective divide -> pixel coordinates.
    def to_px(ndc, ww):
        sx = ndc[:, 0] / ww
        sy = ndc[:, 1] / ww
        return torch.stack([(sx + 1.0) * 0.5 * w, (1.0 - sy) * 0.5 * h], -1)

    pa = to_px(a_ndc2, torch.clamp(wa2, min=eps))
    pb = to_px(b_ndc2, torch.clamp(wb2, min=eps))

    ys = torch.arange(h, dtype=dtype, device=dev) + 0.5
    xs = torch.arange(w, dtype=dtype, device=dev) + 0.5
    pyg, pxg = torch.meshgrid(ys, xs, indexing="ij")      # (H, W)

    d = pb - pa                                            # (N, 2)
    len2 = torch.clamp(torch.sum(d * d, -1), min=1e-12)
    colors = colors.to(dtype)
    img = image
    for i in range(p0.shape[0]):
        relx = pxg - pa[i, 0]
        rely = pyg - pa[i, 1]
        t = torch.clamp((relx * d[i, 0] + rely * d[i, 1]) / len2[i], 0.0, 1.0)
        dx = relx - t * d[i, 0]
        dy = rely - t * d[i, 1]
        dist = torch.sqrt(dx * dx + dy * dy)
        # Smooth 1px falloff at the edge.
        cov = torch.clamp(0.5 * width_px + 0.5 - dist, 0.0, 1.0)
        alpha = torch.where(both_behind[i], 0.0, cov * colors[i, 3])[..., None]
        rgb = img[..., :3] * (1 - alpha) + colors[i, :3] * alpha
        a = img[..., 3:] * (1 - alpha) + alpha
        img = torch.cat([rgb, a], -1)
    return img


def grid_segments(x_extent: float = 2000.0, z_extent: float = 2000.0,
                  x_count: int = 200, z_count: int = 200,
                  dtype=np.float32):
    """Segment list of DrawGrid(w, h, rows, cols) (Renderer.cpp:113-162):
    x_count+1 lines along z and z_count+1 along x in the y=0 plane, centered
    on the origin. Returns (p0, p1) numpy arrays ((N, 3) each)."""
    xs = np.linspace(-x_extent / 2, x_extent / 2, x_count + 1, dtype=dtype)
    zs = np.linspace(-z_extent / 2, z_extent / 2, z_count + 1, dtype=dtype)
    p0 = []
    p1 = []
    for x in xs:
        p0.append([x, 0.0, zs[0]])
        p1.append([x, 0.0, zs[-1]])
    for z in zs:
        p0.append([xs[0], 0.0, z])
        p1.append([xs[-1], 0.0, z])
    return np.asarray(p0, dtype), np.asarray(p1, dtype)


def axis_segments(length: float = 500.0, dtype=np.float32):
    """DrawAxis (Renderer.cpp:206-215): +-x red, +-y green, +-z blue."""
    p0 = np.array([[-length, 0, 0], [0, -length, 0], [0, 0, -length]], dtype)
    p1 = np.array([[length, 0, 0], [0, length, 0], [0, 0, length]], dtype)
    colors = np.array([[1, 0, 0, 1], [0, 1, 0, 1], [0, 0, 1, 1]], dtype)
    return p0, p1, colors


def _on(image: torch.Tensor, *arrays):
    return [torch.tensor(np.asarray(a, np.float32), device=image.device)
            for a in arrays]


def draw_grid(image: torch.Tensor, camera: Camera,
              color=(1.0, 1.0, 1.0, 0.15), x_count: int = 40,
              z_count: int = 40, extent: float = 2000.0,
              width_px: float = 1.0) -> torch.Tensor:
    p0, p1 = grid_segments(extent, extent, x_count, z_count)
    colors = np.broadcast_to(np.asarray(color, np.float32), (p0.shape[0], 4))
    return draw_lines(image, camera, *_on(image, p0, p1, colors), width_px)


def draw_axis(image: torch.Tensor, camera: Camera, length: float = 500.0,
              width_px: float = 3.0) -> torch.Tensor:
    p0, p1, colors = axis_segments(length)
    return draw_lines(image, camera, *_on(image, p0, p1, colors), width_px)
