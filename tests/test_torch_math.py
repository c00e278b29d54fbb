"""Parity of the port's small math with the JAX reference on the CPU: the
rotation helpers (core/transforms.py), the camera's getters, the covariance
builders, 4D slice and splat dataclasses (splats/gaussians.py),
`eigen2x2`, `project_splats`, `pixel_weight`, `params4d_from_arrays`, the
numpy hand-over of splats, and the signatures the port shares with the
reference (ROADMAP C-P6).

Inputs are made with numpy from a seed and fed to both packages. Both
compute in float32 with the same order of operations, so results agree to
a few float32 ulps: the tolerance is 2e-6 relative to the largest value
(1e-5 where a value is an eigenvector or went through a sqrt, log or exp).
"""

import inspect

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fourdgs.core import camera as RC  # noqa: E402
from fourdgs.core import transforms as RTF  # noqa: E402
from fourdgs.render import project as RPJ  # noqa: E402
from fourdgs.splats import gaussians as RG  # noqa: E402
from fourdgs.splats import packed as RPK  # noqa: E402
from fourdgs_torch.core import camera as TC  # noqa: E402
from fourdgs_torch.core import transforms as TTF  # noqa: E402
from fourdgs_torch.render import project as TPJ  # noqa: E402
from fourdgs_torch.splats import gaussians as TG  # noqa: E402
from fourdgs_torch.splats import packed as TPK  # noqa: E402

TOL = 2e-6      # relative to the largest |value|: same f32 operations
TOL_FN = 1e-5   # through sqrt / log / exp, or an eigenvector


def close(got, want, tol=TOL):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"max |d| {err:.3e} > {tol:g} x {scale:.3g}"


def rng_arrays(seed, *shapes, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, s).astype(np.float32) for s in shapes]


def both(fn_ref, fn_port, *arrays):
    """fn_ref on jnp arrays, fn_port on torch tensors, of the same numpy
    inputs."""
    return (fn_ref(*map(jnp.asarray, arrays)),
            fn_port(*(torch.tensor(a) for a in arrays)))


# --------------------------------------------------------------------------
# core/transforms.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["normalize", "quat_normalize",
                                  "quat_to_mat3"])
def test_quaternion_helpers(name):
    q, = rng_arrays(0, (64, 4))
    q = q if name != "quat_to_mat3" else q / np.linalg.norm(
        q, axis=-1, keepdims=True)
    ref, port = both(getattr(RTF, name), getattr(TTF, name), q)
    close(port, ref)


def test_mat3_to_quat_every_branch():
    """Rotations whose largest diagonal combination is each of w, x, y, z
    (quarter and half turns about each axis), and random ones."""
    q, = rng_arrays(1, (60, 4))
    special = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0],
                        [0, 0, 0, 1], [0.1, 0.99, 0.05, 0],
                        [0.1, 0, 0.99, 0.05], [0.1, 0.05, 0, 0.99]],
                       np.float32)
    q = np.concatenate([q, special])
    m = np.asarray(RTF.quat_to_mat3(RTF.quat_normalize(jnp.asarray(q))))
    ref, port = both(RTF.mat3_to_quat, TTF.mat3_to_quat, m)
    close(port, ref, TOL_FN)


def test_look_rotation_and_quat_look_at():
    d, = rng_arrays(2, (32, 3))
    up = np.array([0.0, 1.0, 0.0], np.float32)
    for name in ("look_rotation", "quat_look_at"):
        ref, port = both(getattr(RTF, name), getattr(TTF, name), d, up)
        close(port, ref, TOL_FN)


def test_rotate_about_axis_and_rotation_2d():
    v, axis = rng_arrays(3, (16, 3), (16, 3))
    ang, = rng_arrays(4, (16,), lo=-3.0, hi=3.0)
    ref, port = both(RTF.rotate_about_axis, TTF.rotate_about_axis, v, ang,
                     axis)
    close(port, ref, TOL_FN)
    ref, port = both(RTF.rotation_2d, TTF.rotation_2d, ang)
    close(port, ref, TOL_FN)


# --------------------------------------------------------------------------
# core/camera.py
# --------------------------------------------------------------------------

CAM_KW = dict(position=(3.0, -2.0, 40.0), orientation=(0.1, 0.2, -1.0),
              up=(0.0, 1.0, 0.0), fov_deg=50.0, near=0.5, far=900.0,
              width=96, height=64)


def _cams():
    return RC.Camera.create(**CAM_KW), TC.Camera.create(**CAM_KW,
                                                        device="cpu")


@pytest.mark.parametrize("getter", ["view_matrix", "proj_matrix",
                                    "view_proj_matrix", "viewport", "focal"])
def test_camera_getters(getter):
    rc, tc = _cams()
    close(getattr(tc, getter)(), getattr(rc, getter)(), TOL_FN)


def test_camera_moves():
    rc, tc = _cams()
    pairs = [(rc.with_pose(position=(1.0, 2.0, 3.0), up=(0.0, 0.0, 1.0)),
              tc.with_pose(position=(1.0, 2.0, 3.0), up=(0.0, 0.0, 1.0))),
             (rc.moved((0.5, -1.0, 2.0)), tc.moved((0.5, -1.0, 2.0))),
             (rc.orbit(0.7, center=(1.0, 0.0, -3.0)),
              tc.orbit(0.7, center=(1.0, 0.0, -3.0)))]
    for r, t in pairs:
        for f in ("position", "orientation", "up"):
            close(getattr(t, f), getattr(r, f), TOL_FN)
        assert (t.width, t.height) == (r.width, r.height)
        close(t.view_matrix(), r.view_matrix(), TOL_FN)


def test_pixel_centers_ndc():
    ref = RC.pixel_centers_ndc(96, 64)
    port = TC.pixel_centers_ndc(96, 64, device="cpu")
    for r, t in zip(ref, port):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))


# --------------------------------------------------------------------------
# splats/gaussians.py
# --------------------------------------------------------------------------

N = 48


def _motion_arrays(seed=5):
    pos4, quat, scale3, vel, color = rng_arrays(
        seed, (N, 4), (N, 4), (N, 3), (N, 3), (N, 4))
    scale3 = np.abs(scale3) + 0.3
    color = np.abs(color)
    life, = rng_arrays(seed + 1, (N,), lo=0.5, hi=3.0)
    fade, = rng_arrays(seed + 2, (N,), lo=0.2, hi=0.8)
    return pos4, quat, scale3, life, fade, vel, color


def test_covariance_builders():
    pos4, quat, scale3, life, fade, vel, _ = _motion_arrays()
    v0, = rng_arrays(6, (N, 2))
    l0, l1 = np.abs(scale3[:, 0]), np.abs(scale3[:, 1])
    rot1, = rng_arrays(7, (N, 4))
    cases = [("build_cov2d", (v0, l0, l1)), ("build_cov3d", (quat, scale3)),
             ("isoclinic_left", (quat,)), ("isoclinic_right", (rot1,)),
             ("build_cov4d_isoclinic", (quat, rot1, pos4)),
             ("motion_sigma_t", (life, fade)),
             ("build_cov4d_motion", (quat, scale3, life, fade, vel))]
    for name, args in cases:
        ref, port = both(getattr(RG, name), getattr(TG, name), *args)
        close(port, ref, TOL_FN)
    assert TG.STD_LOWER == RG.STD_LOWER


@pytest.mark.parametrize("t", [0.0, 0.37, 2.5])
def test_slice_opacity_and_sortkey(t):
    pos4, quat, scale3, life, fade, vel, _ = _motion_arrays()
    cov4 = np.array(RG.build_cov4d_motion(*map(jnp.asarray, (
        quat, scale3, life, fade, vel))))
    for tt in (t, torch.tensor(t)):          # a Python float or a 0-d tensor
        r = RG.slice_cov4d(jnp.asarray(pos4), jnp.asarray(cov4), t)
        p = TG.slice_cov4d(torch.from_numpy(pos4), torch.from_numpy(cov4), tt)
        close(p[0], r[0])
        close(p[1], r[1])
        for mo in (0.0, 0.3):
            close(TG.temporal_opacity(torch.from_numpy(pos4),
                                      torch.from_numpy(cov4), tt, mo),
                  RG.temporal_opacity(jnp.asarray(pos4), jnp.asarray(cov4),
                                      t, mo), TOL_FN)
        close(TG.mean_in_time_sortkey(torch.from_numpy(pos4),
                                      torch.from_numpy(cov4), tt),
              RG.mean_in_time_sortkey(jnp.asarray(pos4), jnp.asarray(cov4),
                                      t))


def test_sortkey_keeps_the_quirk():
    """The sorting mean advances by Sigma_{4,1:3}, not the conditional
    velocity Sigma_{4,1:3} / Sigma_44 (the two differ where Sigma_44 != 1)."""
    pos4, quat, scale3, life, fade, vel, _ = _motion_arrays()
    s = TG.Splats4D.from_motion(*map(torch.from_numpy, (
        pos4, quat, scale3, life, fade, vel, _motion_arrays()[-1])))
    key = TG.mean_in_time_sortkey(s.position, s.cov, 1.5)
    mean, _ = TG.slice_cov4d(s.position, s.cov, 1.5)
    dt = (1.5 - s.position[:, 3])[:, None]
    torch.testing.assert_close(key, s.position[:, :3] + s.cov[:, 3, :3] * dt)
    assert float((key - mean).abs().max()) > 1e-2


def test_splat_dataclasses():
    pos4, quat, scale3, life, fade, vel, color = _motion_arrays()
    rot1, = rng_arrays(8, (N, 4))
    r3 = RG.Splats3D.from_params(pos4[:, :3], quat, scale3, color)
    t3 = TG.Splats3D.from_params(*map(torch.from_numpy, (
        pos4[:, :3], quat, scale3, color)))
    close(t3.cov, r3.cov, TOL_FN)
    r4 = RG.Splats4D.from_motion(pos4, quat, scale3, life, fade, vel, color)
    t4 = TG.Splats4D.from_motion(*map(torch.from_numpy, (
        pos4, quat, scale3, life, fade, vel, color)))
    close(t4.cov, r4.cov, TOL_FN)
    ri = RG.Splats4D.from_isoclinic(pos4, quat, rot1, scale3[:, [0, 1, 2, 0]],
                                    color)
    ti = TG.Splats4D.from_isoclinic(*map(torch.from_numpy, (
        pos4, quat, rot1, scale3[:, [0, 1, 2, 0]], color)))
    close(ti.cov, ri.cov, TOL_FN)
    rs, rop = r4.at_time(0.8, 0.05)
    ts, top = t4.at_time(0.8, 0.05)
    close(ts.position, rs.position, TOL_FN)
    close(ts.cov, rs.cov, TOL_FN)
    close(top, rop, TOL_FN)
    assert ts.count == rs.count == N
    rc = RG.concatenate_splats4d([r4, ri])
    tcat = TG.concatenate_splats4d([t4, ti])
    for f in ("position", "color", "cov"):
        close(getattr(tcat, f), getattr(rc, f), TOL_FN)


# --------------------------------------------------------------------------
# render/project.py
# --------------------------------------------------------------------------

def test_eigen2x2():
    a, b = rng_arrays(9, (200,), (200,))
    a = np.abs(a) + 0.05
    c = a + np.linspace(-0.04, 0.04, 200, dtype=np.float32)
    b[:20] = 0.0                                # the b == 0 fallback
    cov2 = np.stack([np.stack([a, b], -1), np.stack([b, c], -1)], -2)
    r = RPJ.eigen2x2(jnp.asarray(cov2))
    t = TPJ.eigen2x2(torch.from_numpy(cov2))
    close(t[0], r[0], TOL_FN)
    close(t[1], r[1], TOL_FN)
    # The eigenvector is ill-conditioned near l0 == l1 (ROADMAP C-R7):
    # hold the quadratic form it spans instead of v0 itself.
    vt, vr = t[2].numpy(), np.asarray(r[2])
    close(np.einsum("ni,nij,nj->n", vt, cov2, vt),
          np.einsum("ni,nij,nj->n", vr, cov2, vr), TOL_FN)
    np.testing.assert_array_equal(vt[:20], np.asarray(vr)[:20])


def _projection_inputs(seed=10, n=64):
    pos, quat, scale, color = rng_arrays(seed, (n, 3), (n, 4), (n, 3),
                                         (n, 4))
    pos = pos * 8.0
    pos[:, 2] -= 30.0
    cov = np.array(RG.build_cov3d(jnp.asarray(quat),
                                    jnp.asarray(np.abs(scale) + 0.4)))
    return pos, cov, np.abs(color)


def test_project_splats_and_pixel_weight():
    pos, cov, color = _projection_inputs()
    opacity = np.linspace(0.2, 1.0, pos.shape[0], dtype=np.float32)
    sort_mean = pos + 0.25
    rc, tc = _cams()
    r = RPJ.project_splats(jnp.asarray(pos), jnp.asarray(cov),
                           jnp.asarray(color), jnp.asarray(opacity), rc,
                           sort_mean3=jnp.asarray(sort_mean))
    t = TPJ.project_splats(torch.from_numpy(pos), torch.from_numpy(cov),
                           torch.from_numpy(color), torch.from_numpy(opacity),
                           tc, sort_mean3=torch.from_numpy(sort_mean))
    for f in ("mx", "my", "depth", "view_z", "l0", "l1", "r", "a",
              "opacity"):
        close(getattr(t, f), getattr(r, f), TOL_FN)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(r.valid))
    # pixel_weight on the reference's projection, so both see one footprint.
    proj = TPJ.Projected(**{f: torch.tensor(np.asarray(getattr(r, f)))
                            for f in TPJ.Projected.__dataclass_fields__})
    px, py = RC.pixel_centers_ndc(96, 64)
    pm = np.asarray(rc.proj_matrix())
    wr, cr = RPJ.pixel_weight(r, px, py, pm[0, 0], pm[1, 1])
    wt, ct = TPJ.pixel_weight(proj, torch.tensor(np.asarray(px)),
                              torch.tensor(np.asarray(py)),
                              torch.tensor(pm[0, 0]), torch.tensor(pm[1, 1]))
    close(wt, wr, TOL_FN)
    ct, cr = ct.numpy(), np.asarray(cr)
    assert ct.shape == (pos.shape[0], 64, 96)
    # Coverage flips only where the weight sits on the discard threshold.
    flip = ct != cr
    assert flip.mean() < 1e-4
    assert np.all(np.abs(np.asarray(wr)[flip] - TPJ.ALPHA_DISCARD) < 1e-8)
    assert (TPJ.ALPHA_DISCARD, TPJ.FOOTPRINT_SCALE) == (
        RPJ.ALPHA_DISCARD, RPJ.FOOTPRINT_SCALE)


# --------------------------------------------------------------------------
# splats/packed.py
# --------------------------------------------------------------------------

def test_params4d_from_arrays():
    pos4, quat, scale3, life, fade, vel, color = _motion_arrays()
    for lt, fd in ((life, fade), (2.0, 0.5)):
        r = RPK.params4d_from_arrays(pos4, quat, scale3, lt, fd, vel, color)
        t = TPK.params4d_from_arrays(*map(torch.from_numpy, (
            pos4, quat, scale3)), torch.as_tensor(lt), torch.as_tensor(fd),
            torch.from_numpy(vel), torch.from_numpy(color))
        assert list(t) == list(TPK.PARAM4D_FIELDS) == list(r)
        for k in r:
            assert t[k].shape == (N,) and t[k].dtype == torch.float32, k
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(r[k]),
                                          err_msg=k)


def test_slice4d_takes_a_tensor_time_without_reading_it(monkeypatch):
    """C-P6: slice4d(t) with a 0-d tensor equals slice4d(float(t)) bit for
    bit, and never reads the tensor back to the host (on the card that
    would be a sync every frame)."""
    pos4, quat, scale3, life, fade, vel, color = _motion_arrays()
    params = TPK.params4d_from_arrays(*map(torch.from_numpy, (
        pos4, quat, scale3, life, fade, vel, color)))
    cov4 = TPK.cov4_motion(params)
    want = TPK.slice4d(params, cov4, 0.37, 0.1)
    t = torch.tensor(0.37)

    def no_host_read(*_):
        raise AssertionError("slice4d read its time back to the host")
    for name in ("__float__", "item", "tolist", "__index__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, no_host_read)
    got = TPK.slice4d(params, cov4, t, 0.1)
    monkeypatch.undo()
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(g, w)
    r = RPK.slice4d({k: jnp.asarray(v.numpy()) for k, v in params.items()},
                    RPK.cov4_motion({k: jnp.asarray(v.numpy())
                                     for k, v in params.items()}), 0.37, 0.1)
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    jax.tree_util.tree_leaves(r)):
        close(g, w, TOL_FN)


# --------------------------------------------------------------------------
# numpy hand-over of splats
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [2, 3, 4])
def test_splats_from_numpy_round_trip(dim):
    pos, color, cov = rng_arrays(11, (7, dim), (7, 4), (7, dim, dim))
    fn = getattr(TG, f"splats{dim}d_from_numpy")
    s = fn(pos, color, cov, device="cpu")
    assert type(s).__name__ == f"Splats{dim}D" and s.count == 7
    for k, a in (("position", pos), ("color", color), ("cov", cov)):
        np.testing.assert_array_equal(getattr(s, k).numpy(), a)
        assert getattr(s, k).device.type == "cpu"


@pytest.mark.parametrize("fault", ["dtype", "position_shape", "color_shape",
                                   "cov_shape", "length", "scalar"])
def test_splats_from_numpy_rejects(fault):
    pos, color, cov = rng_arrays(12, (5, 3), (5, 4), (5, 3, 3))
    if fault == "dtype":
        cov = cov.astype(np.float64)
    elif fault == "position_shape":
        pos = pos[:, :2]
    elif fault == "color_shape":
        color = color[:, :3]
    elif fault == "cov_shape":
        cov = cov[:, :2, :2]
    elif fault == "length":
        color = color[:-1]
    else:
        pos = np.float32(1.0)
    with pytest.raises(ValueError):
        TG.splats3d_from_numpy(pos, color, cov, device="cpu")


# --------------------------------------------------------------------------
# signatures shared with the reference (ROADMAP C-P6)
# --------------------------------------------------------------------------

def _defaults(fn):
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


@pytest.mark.parametrize("name", [
    "render.tiles.bin_splats", "render.tiles.tile_grid",
    "render.pipeline.render_projected", "render.pipeline.render_splats3d",
    "render.pipeline.render_splats4d", "render.pipeline.render_splats2d",
    "render.dense.composite_dense", "render.dense.render_splats3d",
    "render.dense.render_splats4d", "render.dense.render_splats2d",
    "render.dense.composite_dense_blend"])
def test_defaults_match_the_reference(name):
    """Every default the reference gives a parameter, the port gives the same
    one (the port has no `tile_range` yet: the sharded window is A6's)."""
    import importlib
    mod, fn = name.rsplit(".", 1)
    ref = _defaults(getattr(importlib.import_module(f"fourdgs.{mod}"), fn))
    port = _defaults(getattr(importlib.import_module(f"fourdgs_torch.{mod}"),
                             fn))
    ref.pop("tile_range", None)
    for k, v in ref.items():
        if k == "cfg":
            assert port[k] == type(port[k])(**__import__(
                "dataclasses").asdict(v)), name
        else:
            assert port.get(k, "missing") == v, (name, k, port.get(k), v)
    from fourdgs.render import tiles as RT
    from fourdgs_torch.render import tiles as TT
    assert (TT.TILE_H, TT.TILE_W) == (RT.TILE_H, RT.TILE_W) == (32, 32)
