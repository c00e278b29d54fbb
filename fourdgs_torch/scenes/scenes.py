"""The demo scenes of the reference (`Scenes.h`), as pure generators (port
of fourdgs/scenes/scenes.py).

Each scene is a function producing (splats, SceneSettings) — the functional
equivalent of the reference's Scene::init() (SURVEY.md section 2.2). All
parameter defaults are the reference's member initializers, cited per scene.
Every 4D scene shares the reference's construction pattern: iterate
steps_in_time x model vertices, building a Splat4D with the motion
parameterization (ctor B, Splat.h:132-159), color from the model-extrema
gradient (Scenes.h:58-68), and oriented by quatLookAt of the vertex normal.

Rendering a scene is then just `pipeline.render_splats4d(splats, camera, t)`.

The construction runs in numpy, in the reference's order and precision
(float64 where it computes in numpy's float64); the look-at quaternions and
covariances are float32 torch on the CPU, and every generator returns the
port's Splats2D/3D/4D on `device` (None: the card,
fourdgs_torch.default_device).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from fourdgs_torch import resolve_device
from fourdgs_torch.core.transforms import quat_look_at as _quat_look_at
from fourdgs_torch.io import vdata as vio
from fourdgs_torch.scenes import models as M
from fourdgs_torch.splats.gaussians import Splats2D, Splats3D, Splats4D

TAU = 2.0 * np.pi
_UP = (0.0, 1.0, 0.0)


def quat_look_at(direction, up=_UP) -> np.ndarray:
    """glm::quatLookAt of float32 directions, computed in float32 on the
    CPU (the reference's jnp call), as a numpy array."""
    return _quat_look_at(torch.tensor(np.asarray(direction, np.float32)),
                         torch.tensor(np.asarray(up, np.float32))).numpy()


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class SceneSettings:
    """Per-scene camera + playback defaults (the reference sets these in
    init()/member initializers)."""
    camera_position: Tuple[float, float, float]
    camera_orientation: Tuple[float, float, float]
    max_time: float = 50.0
    time_speed: float = 0.25
    min_opacity: float = 0.0
    do_sort: bool = True


def _hsl_f(n, h, s, l):
    k = np.mod(n + h / 30.0, 12.0)
    return l - s * np.minimum(l, 1 - l) * np.clip(np.minimum(k - 3.0, 9.0 - k), -1.0, 1.0)


def hsl_color(h, s, l):
    """HSL -> RGB, Scenes.h:47-56."""
    return np.stack([_hsl_f(0.0, h, s, l), _hsl_f(8.0, h, s, l), _hsl_f(4.0, h, s, l)], axis=-1)


def model_gradient_color(pos: np.ndarray, extrema, normal: np.ndarray,
                         mina=0.65, maxa=1.0, lower=0.0) -> np.ndarray:
    """Color gradient over the model bounding box — Scenes.h:58-68."""
    minp, maxp = extrema
    down = np.array([0.0, -1.0, 0.0])
    ndot = -(normal @ down)
    max_bright = (ndot - (-1.0)) / 2.0 * (maxa - mina) + mina  # mapf(-1,1 -> mina,maxa)
    frac = (pos - minp) / np.maximum(maxp - minp, 1e-9)
    rgb = lower + (max_bright[:, None] - lower) * frac
    rgba = np.concatenate([rgb, np.ones((pos.shape[0], 1))], axis=1)
    return np.clip(rgba, 0.0, 1.0)


def _sweep_model(model: vio.VModel, steps: int, offset_fn, velocity_fn,
                 normal_fn=None, object_scale=5.0,
                 splat_scale=(4.0, 4.0, 1.0), lifetime=1.0, fade=0.5,
                 color_kwargs=None, device=None) -> Splats4D:
    """Shared 4D-scene construction loop (Scenes.h:258-280 et al.), fully
    vectorized: every (time step, vertex) pair becomes one 4D splat.

    offset_fn(dt) -> either a world-space offset (3,) added to the scaled
    vertex, or a per-vertex position override; velocity_fn(dt, pos_v) -> the
    motion direction fed to Splat4D ctor B; normal_fn(dt, normals) lets
    rotation scenes co-rotate normals (Scenes.h:783-795).
    """
    n_v = model.count
    extrema = model.extrema()
    colors_base = model_gradient_color(model.position, extrema, model.normal,
                                       **(color_kwargs or {}))
    pos_list, quat_list, vel_list, col_list, t_list = [], [], [], [], []
    for dt in range(steps):
        normals = model.normal if normal_fn is None else normal_fn(dt, model.normal)
        pos = offset_fn(dt, model.position * object_scale)
        vel = velocity_fn(dt, pos)
        pos_list.append(pos)
        quat_list.append(normals)
        vel_list.append(np.broadcast_to(vel, (n_v, 3)) if vel.ndim == 1 else vel)
        col_list.append(colors_base)
        t_list.append(np.full((n_v, 1), float(dt), np.float32))

    pos = np.concatenate(pos_list).astype(np.float32)
    normals = np.concatenate(quat_list).astype(np.float32)
    vel = np.concatenate(vel_list).astype(np.float32)
    col = np.concatenate(col_list).astype(np.float32)
    ts = np.concatenate(t_list).astype(np.float32)

    nrm = normals / np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-9)
    quats = quat_look_at(nrm)

    n = pos.shape[0]
    return Splats4D.from_motion(
        position4=np.concatenate([pos, ts], axis=1),
        quat=quats,
        scale3=np.broadcast_to(np.asarray(splat_scale, np.float32), (n, 3)),
        lifetime=np.full((n,), lifetime, np.float32),
        fade=np.full((n,), fade, np.float32),
        velocity=vel,
        color=col,
        device=resolve_device(device),
    )


def _rot_y(v: np.ndarray, angle_deg: float) -> np.ndarray:
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return v @ r.T


# ---------------------------------------------------------------------------
# the scenes
# ---------------------------------------------------------------------------

def empty(device=None) -> Tuple[Splats4D, SceneSettings]:
    """Scenes::Empty (Scenes.h:119-157): no splats, just the viewport."""
    device = resolve_device(device)
    splats = Splats4D(position=torch.zeros((0, 4), device=device),
                      color=torch.zeros((0, 4), device=device),
                      cov=torch.zeros((0, 4, 4), device=device))
    return splats, SceneSettings((0.0, 5.0, 20.0), (0.0, -0.2, -1.0))


def linear_motion(model: Optional[vio.VModel] = None, steps: int = 50,
                  splat_speed: float = 1.0, lin_time_multiplier: float = 1.0,
                  device=None):
    """Scenes::LinearMotion (Scenes.h:162-423): the model marches along +x,
    one copy per time step; velocity = (1,0,0) * splat_speed."""
    model = model or M.teapot()
    direction = np.array([1.0, 0.0, 0.0])

    def offset(dt, pos):
        return pos + direction * (dt * lin_time_multiplier)

    def velocity(dt, pos):
        return direction * splat_speed

    splats = _sweep_model(model, steps, offset, velocity, device=device)
    return splats, SceneSettings((60.0, 90.0, 90.0), (0.0, -1.0, -1.0),
                                 max_time=50.0)


def non_linear_motion(model: Optional[vio.VModel] = None, steps: int = 92,
                      splat_speed: float = 20.0, radius: float = 20.0,
                      angle_multiplier: float = 4.0, device=None):
    """Scenes::NonLinearMotion (Scenes.h:428-682): positions offset around a
    circle; velocity = finite difference of consecutive unit path points
    (note: of the *unit* rotation vectors, not the radius-scaled path — a
    reference quirk, Scenes.h:536) times splat_speed."""
    model = model or M.teapot()
    fwd = np.array([1.0, 0.0, 0.0])

    def offset(dt, pos):
        return pos + _rot_y(fwd, dt * angle_multiplier) * radius

    def velocity(dt, pos):
        return (_rot_y(fwd, (dt + 1) * angle_multiplier)
                - _rot_y(fwd, dt * angle_multiplier)) * splat_speed

    splats = _sweep_model(model, steps, offset, velocity, device=device)
    return splats, SceneSettings((0.0, 60.0, 60.0), (0.0, -1.0, -1.0),
                                 max_time=90.0)


def rotation_motion(model: Optional[vio.VModel] = None, steps: int = 92,
                    splat_speed: float = 5.0, angle_multiplier: float = 4.0,
                    device=None):
    """Scenes::RotationMotion (Scenes.h:687-931): the object spins about the
    world y axis; normals co-rotate; lifetime 0.6 (the scene's default)."""
    model = model or M.teapot()

    def offset(dt, pos):
        return _rot_y(pos, dt * angle_multiplier)

    def velocity(dt, pos):
        base = model.position * 5.0
        return (_rot_y(base, (dt + 1) * angle_multiplier)
                - _rot_y(base, dt * angle_multiplier)) * splat_speed

    def normals(dt, nrm):
        return _rot_y(nrm, dt * angle_multiplier)

    splats = _sweep_model(model, steps, offset, velocity, normal_fn=normals,
                          lifetime=0.6, device=device)
    return splats, SceneSettings((0.0, 60.0, 60.0), (0.0, -1.0, -1.0),
                                 max_time=90.0)


def combined_motion(model: Optional[vio.VModel] = None, steps: int = 65,
                    splat_speed: float = 1.0, angle_multiplier: float = 8.0,
                    lin_multiplier: float = 8.0, amplitude: float = 1.0,
                    frequency: float = 0.15, device=None):
    """Scenes::CombinedMotion (Scenes.h:936-1209): rotation about y plus a
    sinusoidal translation (freq*dt, amp*sin(freq*dt), 0)*lin_multiplier.
    Splat z-scale is 0 in the reference defaults (flat splats)."""
    model = model or M.teapot()

    def path(dt):
        return lin_multiplier * np.array([frequency * dt,
                                          amplitude * np.sin(frequency * dt), 0.0])

    def offset(dt, pos):
        return _rot_y(pos, dt * angle_multiplier) + path(dt)

    def velocity(dt, pos):
        base = model.position * 5.0
        p0 = _rot_y(base, dt * angle_multiplier) + path(dt)
        p1 = _rot_y(base, (dt + 1) * angle_multiplier) + path(dt + 1)
        return (p1 - p0) * splat_speed

    def normals(dt, nrm):
        return _rot_y(nrm, dt * angle_multiplier)

    # z-scale 0 would make the covariance singular under our sqrt-free
    # parameterization; the GL pipeline tolerates it because the eigenvalue
    # clamp (1e-6) rescues the projection. We keep a tiny epsilon.
    splats = _sweep_model(model, steps, offset, velocity, normal_fn=normals,
                          splat_scale=(4.0, 4.0, 1e-3), device=device)
    return splats, SceneSettings((0.0, 60.0, 60.0), (0.0, -1.0, -1.0),
                                 max_time=65.0)


def clouds(n_splats: int = 150, seed: int = 0,
           center=(0.0, 0.0, 0.0), extent=(50.0, 10.0, 50.0), device=None):
    """Scenes::Clouds (Scenes.h:1214-1438): random stretched splats in a box,
    greyscale from a gaussian density estimate, lifetime 50."""
    rng = np.random.default_rng(seed)
    c = np.asarray(center)
    ext = np.asarray(extent)
    r = rng.random((n_splats, 7)).astype(np.float32)
    pos = r[:, 0:3] * ext

    def p(x, mu, sig):
        e = (x - mu) / sig
        return np.exp(-0.5 * e * e)

    avr = 0.5 * (p(pos[:, 0], c[0], ext[0] * ext[0]) + p(pos[:, 1], c[1], ext[1] * ext[1]))
    col = np.clip(1.0 - avr * r[:, 3], 0.2, 1.0)
    alpha = np.clip(r[:, 4] + 0.1, 0.0, 1.0)
    scale = np.stack([np.clip(r[:, 5] * ext[0], 10.0, ext[0]),
                      np.full(n_splats, 10.0, np.float32),
                      np.clip(r[:, 6] * ext[2], 10.0, ext[2])], axis=1)
    n = n_splats
    quat = quat_look_at([1.0, 0.0, 0.0])
    splats = Splats4D.from_motion(
        position4=np.concatenate([c + pos, np.zeros((n, 1), np.float32)], axis=1).astype(np.float32),
        quat=np.broadcast_to(quat, (n, 4)),
        scale3=scale,
        lifetime=np.full((n,), 50.0, np.float32),
        fade=np.full((n,), 0.5, np.float32),
        velocity=np.broadcast_to(np.array([1.0, 0.0, 0.0], np.float32), (n, 3)),
        color=np.stack([col, col, col, alpha], axis=1),
        device=resolve_device(device),
    )
    return splats, SceneSettings((50.0, 90.0, 90.0), (0.0, -1.0, -1.0),
                                 max_time=90.0)


def gaussians_2d(n: int = 20, seed: int = 0, device=None):
    """Scenes::Gaussians2D (Scenes.h:1443-1610): random 2D Gaussians,
    positions in [-5,5]^2, scales 1..6, Sigma = R S S R^T."""
    rng = np.random.default_rng(seed)
    ang = np.deg2rad(rng.random(n) * 360.0)
    c, s = np.cos(ang), np.sin(ang)
    # GLM mat2{c,-s,s,c} is column-major: math R = [[c, s], [-s, c]].
    r = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], axis=-2)
    sc = 1.0 + 5.0 * rng.random((n, 2))
    cov = np.einsum("nik,nk,njk->nij", r, sc * sc, r)
    device = resolve_device(device)
    splats = Splats2D(
        position=_tensor(10.0 * (rng.random((n, 2)) - 0.5), device),
        color=_tensor(np.concatenate([rng.random((n, 3)), np.ones((n, 1))],
                                     axis=1), device),
        cov=_tensor(cov, device),
    )
    return splats, SceneSettings((-10.0, 10.0, 0.0), (1.0, -1.0, 0.0),
                                 do_sort=False)


def gaussians_3d(position=(0.0, 0.0, 0.0), quat=(1.0, 0.0, 0.0, 0.0),
                 scale=(5.0, 10.0, 5.0), color=(1.0, 1.0, 1.0, 1.0),
                 device=None):
    """Scenes::Gaussians3D (Scenes.h:1615-1723): one interactive 3D Gaussian.
    The keyword parameters are the live-editor analog (DebugMenus.h:121-164:
    position/quaternion/scale/color sliders) — pass overrides to 'edit' the
    splat; defaults are the menu defaults scaled for visibility."""
    splats = Splats3D.from_params(
        position=np.asarray([position], np.float32),
        quat=np.asarray([quat], np.float32),
        scale=np.asarray([scale], np.float32),
        color=np.asarray([color], np.float32),
        device=resolve_device(device),
    )
    return splats, SceneSettings((0.0, 10.0, 50.0), (0.0, 0.0, -1.0))


def gaussians_4d(position=(0.0, 0.0, 0.0, 0.0), look=(1.0, 0.0, 1.0),
                 quat=None, scale3=(10.0, 20.0, 10.0), lifetime=1.0,
                 fade=0.5, velocity=(5.0, 5.0, 5.0),
                 color=(1.0, 1.0, 1.0, 1.0), device=None):
    """Scenes::Gaussians4D (Scenes.h:1729-1873): a single 4D Gaussian built
    with the motion ctor: lookAt(1,0,1), scale (10,20,10), lifetime 1,
    fade 0.5, velocity (5,5,5); time slider -2..2. The keyword parameters
    are the 4D editor analog (DebugMenus.h:167-208: position/orientation/
    scale/lifetime/fade/velocity/color); `quat` overrides `look` when
    given."""
    if quat is None:
        quat = quat_look_at(look)
    splats = Splats4D.from_motion(
        position4=np.asarray([position], np.float32),
        quat=np.asarray([quat], np.float32),
        scale3=np.asarray([scale3], np.float32),
        lifetime=np.asarray([lifetime], np.float32),
        fade=np.asarray([fade], np.float32),
        velocity=np.asarray([velocity], np.float32),
        color=np.asarray([color], np.float32),
        device=resolve_device(device),
    )
    return splats, SceneSettings((30.0, 30.0, 30.0), (-1.0, -1.0, -1.0),
                                 max_time=2.0)


def broken_motion(model: Optional[vio.VModel] = None, steps: int = 92,
                  splat_speed: float = 5.0, device=None):
    """Scenes::BrokenMotion (Scenes.h:1879-2124): sawtooth path
    (1+dt, (1+dt) mod 20, 0) — the discontinuous-motion stress test."""
    model = model or M.teapot()

    def path(dt):
        return np.array([1.0 + dt, np.mod(1.0 + dt, 20.0), 0.0])

    def offset(dt, pos):
        return pos + path(dt)

    def velocity(dt, pos):
        return (path(dt + 1) - path(dt)) * splat_speed

    splats = _sweep_model(model, steps, offset, velocity, device=device)
    return splats, SceneSettings((0.0, 60.0, 60.0), (0.0, -1.0, -1.0),
                                 max_time=90.0)


def square_motion(model: Optional[vio.VModel] = None, steps: int = 92,
                  splat_speed: float = 5.0, square_size: float = 40.0,
                  device=None):
    """Scenes::SquareMotion (Scenes.h:2129-2395): piecewise-linear square
    path with per-side direction switching — C0-but-not-C1 motion."""
    model = model or M.teapot()
    steps_per_side = steps // 4
    delta = square_size / steps_per_side
    dirs = [np.array([-1.0, 0.0, 0.0]), np.array([0.0, 0.0, -1.0]),
            np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0])]

    # Precompute the path exactly as the reference's stateful loop does.
    path = []
    posdt = np.array([square_size / 2.0, 0.0, square_size / 2.0])
    side = 0
    for dt in range(steps + 1):
        if dt > 0 and dt % steps_per_side == 0:
            side += 1
        posdt = posdt + delta * dirs[min(side, 3)]
        path.append(posdt.copy())
    path = np.asarray(path)

    def offset(dt, pos):
        return pos + path[dt]

    def velocity(dt, pos):
        return (path[dt + 1] - path[dt]) * splat_speed

    splats = _sweep_model(model, steps, offset, velocity, device=device)
    return splats, SceneSettings((0.0, 60.0, 60.0), (0.0, -1.0, -1.0),
                                 max_time=90.0)


def object_display(model: Optional[vio.SplatModel] = None, device=None):
    """Scenes::ObjectDisplay (Scenes.h:2401-2618): a precomputed-covariance
    .sd model shown statically (one time step), sorting on by default."""
    if model is None:
        path = vio.find_reference_object("Mage.sd")
        model = vio.load_sd(path) if path else M.synthetic_sd_model()
    device = resolve_device(device)
    splats = Splats4D(position=_tensor(np.concatenate(
                          [model.position, np.zeros((model.count, 1), np.float32)], axis=1),
                          device),
                      color=_tensor(model.color, device),
                      cov=_tensor(model.cov, device))
    return splats, SceneSettings((0.0, 2.0, 8.0), (0.0, -0.10, -1.4),
                                 max_time=1.0, do_sort=True)


SCENES: Dict[str, Callable] = {
    "empty": empty,
    "linear": linear_motion,
    "nonlinear": non_linear_motion,
    "rotation": rotation_motion,
    "combined": combined_motion,
    "clouds": clouds,
    "gaussians2d": gaussians_2d,
    "gaussians3d": gaussians_3d,
    "gaussians4d": gaussians_4d,
    "broken": broken_motion,
    "square": square_motion,
    "objectdisplay": object_display,
}
