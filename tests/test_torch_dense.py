"""Parity of the port's dense golden renderer (render/dense.py) with the JAX
reference on the CPU, and the tiled exact path held to it:

  * `composite_dense`, straight and premultiplied, from one projection:
    max |d| 1e-5 (the same float32 operations, summed in another order);
  * the blend explorer `composite_dense_blend` under every pair of
    BLEND_FACTORS: max |d| 1e-5;
  * `project_splats2d` with both 2D quirks (doubled eigenvalues, swapped
    lengths) and `render_splats2d/3d/4d`: 1e-5 relative / 1e-5;
  * gradients of the dense render against `jax.grad`, finite through the
    padded chunk: within 1e-4 of each field's max |g|;
  * the tiled exact path, both backends, against the dense model at a
    capacity that truncates nothing (tests/test_parity.py's case): mean
    |d| < 5e-4 and max |d| < 0.02, its tolerances;
  * the golden PNGs of tests/test_golden.py's fast tier (all but `empty`,
    whose grid and axis overlay is not ported): each scene built with the
    reference's generator, carried over with the numpy converters,
    rendered by the port's dense renderer, held with test_golden's own
    tolerances.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_golden as GOLD  # noqa: E402
from fourdgs.core.camera import Camera as RCamera  # noqa: E402
from fourdgs.core.camera import pixel_centers_ndc  # noqa: E402
from fourdgs.render import dense as RD  # noqa: E402
from fourdgs.render.project import project_splats  # noqa: E402
from fourdgs.splats import gaussians as RG  # noqa: E402
from fourdgs_torch.core.camera import Camera as TCamera  # noqa: E402
from fourdgs_torch.render import dense as TD  # noqa: E402
from fourdgs_torch.render import pipeline as TP  # noqa: E402
from fourdgs_torch.render.project import Projected, eigen2x2  # noqa: E402
from fourdgs_torch.render.project import \
    project_splats as project_splats_t  # noqa: E402
from fourdgs_torch.splats import gaussians as TG  # noqa: E402
from fourdgs_torch.splats.packed import params4d_from_numpy  # noqa: E402

TOL = 1e-5
GRAD_TOL = 1e-4
W, H = 64, 48


def _scene(n=40, seed=0, spread=4.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    pos[:, 2] -= 20.0
    cov = np.asarray(RG.build_cov3d(
        jnp.asarray(rng.normal(size=(n, 4)).astype(np.float32)),
        jnp.asarray(rng.uniform(0.4, 2.0, (n, 3)).astype(np.float32))))
    color = rng.uniform(0.1, 1.0, (n, 4)).astype(np.float32)
    return dict(position=pos, color=color, cov=cov)


def _cams(w=W, h=H, **kw):
    return (RCamera.create(width=w, height=h, **kw),
            TCamera.create(width=w, height=h, device="cpu", **kw))


def _ref_projection(sc, cam):
    """The reference's projection in front-to-back order, as numpy."""
    proj = jax.jit(lambda p, c, k: RD.sort_front_to_back(project_splats(
        p, c, k, jnp.ones(p.shape[0]), cam)))(
            *(jnp.asarray(sc[k]) for k in ("position", "cov", "color")))
    return {k: np.asarray(v) for k, v in proj.__dict__.items()}


def _tproj(pnp):
    return Projected(**{k: torch.tensor(v) for k, v in pnp.items()})


def _close(got, want, tol=TOL):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol, f"max |d| {err:.3e} > {tol:g}"


@pytest.mark.parametrize("premultiplied", [False, True])
def test_composite_dense(premultiplied):
    rc, _ = _cams()
    pnp = _ref_projection(_scene(n=300, spread=6.0), rc)
    px, py = pixel_centers_ndc(W, H)
    pm = np.asarray(rc.proj_matrix())
    bg = np.array([0.1, 0.2, 0.3, 1.0], np.float32)
    want = jax.jit(lambda p: RD.composite_dense(
        p, px, py, pm[0, 0], pm[1, 1], jnp.asarray(bg), chunk=64,
        premultiplied=premultiplied))(RD.Projected(**{
            k: jnp.asarray(v) for k, v in pnp.items()}))
    got = TD.composite_dense(_tproj(pnp), torch.tensor(np.asarray(px)),
                             torch.tensor(np.asarray(py)),
                             torch.tensor(pm[0, 0]), torch.tensor(pm[1, 1]),
                             torch.tensor(bg), chunk=64,
                             premultiplied=premultiplied)
    _close(got, want)
    assert float(np.asarray(want)[..., :3].max()) > 0.3


@pytest.mark.parametrize("src", TD.BLEND_FACTORS)
def test_blend_explorer_every_factor_pair(src):
    """composite_dense_blend under (src, every dst factor), from one
    projection of a few overlapping splats."""
    assert TD.BLEND_FACTORS == RD.BLEND_FACTORS
    rc, _ = _cams(24, 16)
    sc = _scene(n=4, seed=3, spread=1.5)
    pnp = _ref_projection(sc, rc)
    rproj = RD.Projected(**{k: jnp.asarray(v) for k, v in pnp.items()})
    px, py = pixel_centers_ndc(24, 16)
    pm = np.asarray(rc.proj_matrix())
    bg = np.array([0.1, 0.2, 0.3, 0.5], np.float32)
    tpx, tpy = torch.tensor(np.asarray(px)), torch.tensor(np.asarray(py))
    for dst in TD.BLEND_FACTORS:
        with jax.disable_jit():      # a scan of 4 steps: faster op by op
            want = RD.composite_dense_blend(rproj, px, py, pm[0, 0],
                                            pm[1, 1], jnp.asarray(bg), src,
                                            dst, premultiplied=dst == src)
        got = TD.composite_dense_blend(_tproj(pnp), tpx, tpy,
                                       torch.tensor(pm[0, 0]),
                                       torch.tensor(pm[1, 1]),
                                       torch.tensor(bg), src, dst,
                                       premultiplied=dst == src)
        _close(got, want)
    with pytest.raises(ValueError, match="unknown blend factor"):
        TD.composite_dense_blend(_tproj(pnp), tpx, tpy, 1.0, 1.0,
                                 torch.tensor(bg), src, "one_plus")


def test_src_alpha_blend_equals_composite_dense():
    _, tc = _cams(24, 16)
    sc = _scene(n=5)
    proj = TD.sort_front_to_back(project_splats_t(
        *(torch.tensor(sc[k]) for k in ("position", "cov", "color")),
        torch.ones(5), tc))
    px, py = TD.pixel_centers_ndc(24, 16, device="cpu")
    pm = tc.proj_matrix()
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0])
    a = TD.composite_dense(proj, px, py, pm[0, 0], pm[1, 1], bg)
    b = TD.composite_dense_blend(proj, px, py, pm[0, 0], pm[1, 1], bg)
    assert float((a - b)[..., :3].abs().max()) < 1e-5


def test_project_splats2d_quirks():
    from fourdgs.scenes import scenes as S
    rs, _ = S.gaussians_2d(n=20, seed=3)
    arrays = {k: np.asarray(getattr(rs, k), np.float32)
              for k in ("position", "color", "cov")}
    rc, tc = _cams(96, 64)
    rproj, rp00, rp11 = RD.project_splats2d(RG.Splats2D(**{
        k: jnp.asarray(v) for k, v in arrays.items()}), rc)
    ts = TG.splats2d_from_numpy(**arrays, device="cpu")
    tproj, tp00, tp11 = TD.project_splats2d(ts, tc)
    for k in ("mx", "my", "depth", "view_z", "l0", "l1", "r", "a",
              "opacity"):
        want = np.asarray(getattr(rproj, k))
        got = getattr(tproj, k).numpy()
        assert float(np.abs(got - want).max()) <= TOL * max(
            1.0, float(np.abs(want).max())), k
    np.testing.assert_array_equal(tproj.valid.numpy(), np.asarray(rproj.valid))
    _close(tp00, rp00)
    _close(tp11, rp11)
    # The quirks: l = sqrt(2 lambda), the larger length on the lambda_min
    # eigenvector.
    lmin, lmax, _ = eigen2x2(ts.cov)
    torch.testing.assert_close(tproj.l0, torch.sqrt(2.0 * lmax))
    torch.testing.assert_close(tproj.l1, torch.sqrt(2.0 * lmin))
    assert bool((tproj.l0 >= tproj.l1).all())
    want = jax.jit(lambda s: RD.render_splats2d(s, rc))(RG.Splats2D(**{
        k: jnp.asarray(v) for k, v in arrays.items()}))
    _close(TD.render_splats2d(ts, tc), want)


@pytest.mark.parametrize("kind", ["3d", "3d-premultiplied", "3d-unsorted",
                                  "4d"])
def test_render_entry_points(kind):
    rc, tc = _cams()
    sc = _scene(n=60, seed=7)
    if kind == "4d":
        rng = np.random.default_rng(8)
        n = 60
        pos4 = np.concatenate([sc["position"], rng.uniform(
            0.0, 2.0, (n, 1)).astype(np.float32)], -1)
        rs = RG.Splats4D.from_motion(
            pos4, rng.normal(size=(n, 4)).astype(np.float32),
            rng.uniform(0.4, 2.0, (n, 3)).astype(np.float32),
            np.full((n,), 1.5, np.float32), np.full((n,), 0.5, np.float32),
            rng.normal(size=(n, 3)).astype(np.float32), sc["color"])
        ts = TG.splats4d_from_numpy(*(np.asarray(getattr(rs, k)) for k in (
            "position", "color", "cov")), device="cpu")
        want = jax.jit(lambda s, t: RD.render_splats4d(s, rc, t, 0.05))(
            rs, 0.9)
        got = TD.render_splats4d(ts, tc, torch.tensor(0.9), 0.05)
    else:
        rs = RG.Splats3D(**{k: jnp.asarray(v) for k, v in sc.items()})
        ts = TG.splats3d_from_numpy(**sc, device="cpu")
        kw = dict(premultiplied=kind == "3d-premultiplied",
                  sort=kind != "3d-unsorted", chunk=32)
        want = jax.jit(lambda s: RD.render_splats3d(s, rc, **kw))(rs)
        got = TD.render_splats3d(ts, tc, **kw)
    _close(got, want)
    assert float(np.asarray(want)[..., :3].max()) > 0.2


def test_dense_gradients_match_jax_grad():
    """Through the zero-padded chunk (8 splats in a chunk of 256) the
    gradient stays finite and equals jax.grad's."""
    rc, tc = _cams()
    sc = _scene(n=8, seed=2, spread=2.0)

    def loss_ref(pos, cov, color):
        img = RD.render_splats3d(RG.Splats3D(position=pos, color=color,
                                             cov=cov), rc, premultiplied=True)
        return jnp.mean(img[..., :3] ** 2)
    want = jax.jit(jax.grad(loss_ref, argnums=(0, 1, 2)))(
        *(jnp.asarray(sc[k]) for k in ("position", "cov", "color")))
    leaves = [torch.tensor(sc[k], requires_grad=True)
              for k in ("position", "cov", "color")]
    img = TD.render_splats3d(TG.Splats3D(position=leaves[0], cov=leaves[1],
                                         color=leaves[2]), tc,
                             premultiplied=True)
    (img[..., :3] ** 2).mean().backward()
    for name, leaf, w in zip(("position", "cov", "color"), leaves, want):
        g, w = leaf.grad.numpy(), np.asarray(w)
        assert np.isfinite(g).all(), name
        scale = float(np.abs(w).max())
        assert scale > 0 and float(np.abs(g - w).max()) <= GRAD_TOL * scale, \
            name


@pytest.fixture(scope="module")
def cube():
    """tests/test_parity.py::test_exact_path_matches_dense's scene on the
    port: the cube of 6,000 splats (the reference's build_cube_scene, handed
    over through numpy) at 256x128, and the port's dense image of it."""
    from bench import build_cube_scene
    params = params4d_from_numpy({k: np.asarray(v) for k, v in
                                  build_cube_scene(6000, seed=3).items()},
                                 "cpu")
    _, cam = _cams(256, 128, position=(420.0, 300.0, 420.0),
                   orientation=(-1.0, -0.7, -1.0), far=5000.0)
    p = params
    splats = TG.Splats4D.from_motion(
        position4=torch.stack([p["px"], p["py"], p["pz"], p["pt"]], -1),
        quat=torch.stack([p["qw"], p["qx"], p["qy"], p["qz"]], -1),
        scale3=torch.stack([p["sx"], p["sy"], p["sz"]], -1),
        lifetime=p["lifetime"], fade=p["fade"],
        velocity=torch.stack([p["vx"], p["vy"], p["vz"]], -1),
        color=torch.stack([p["cr"], p["cg"], p["cb"], p["ca"]], -1))
    return params, cam, TD.render_splats4d(splats, cam, 0.0, 0.0)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_tiled_exact_path_matches_dense(cube, backend):
    """The tiled exact path at a capacity that truncates nothing (the
    deepest tile holds 1,303 pairs) against the dense model."""
    params, cam, want = cube
    cfg = TP.RenderConfig(max_splats_per_tile=2048, splat_chunk=64,
                          max_tiles_per_splat=16, backend=backend)
    img, aux = TP.render_params4d_packed(params, cam, 0.0, cfg=cfg,
                                         return_aux=True)
    assert int(aux["overflowed"]) == 0
    assert float(aux["resid_transmittance"]) < 1e-3
    diff = (img - want).abs()
    assert float(diff.mean()) < 5e-4, f"mean|diff|={float(diff.mean()):.5f}"
    assert float(diff.max()) < 0.02, f"max|diff|={float(diff.max()):.4f}"
    assert float(want[..., :3].max()) > 0.1


@pytest.mark.parametrize("name", ["clouds", "gaussians2d", "gaussians3d",
                                  "gaussians4d", "objectdisplay"])
def test_scene_matches_golden(name):
    """tests/test_golden.py::test_scene_matches_golden's fast tier, rendered
    by the port: the reference's scene generator, the numpy converters, the
    port's dense renderer, test_golden's camera, time and tolerances."""
    from fourdgs.io.png import read_png
    from fourdgs.scenes.scenes import SCENES
    assert name not in GOLD.HEAVY
    path = os.path.join(GOLD.GOLDEN_DIR, f"{name}.png")
    want = read_png(path).astype(np.float32) / 255.0
    splats, st = SCENES[name]()
    arrays = {k: np.asarray(getattr(splats, k), np.float32)
              for k in ("position", "color", "cov")}
    pos, ori = GOLD.CAM_OVERRIDE.get(name, (st.camera_position,
                                            st.camera_orientation))
    cam = TCamera.create(position=pos, orientation=ori, width=GOLD.SIZE,
                         height=GOLD.SIZE, device="cpu")
    t = GOLD.TIMES.get(name, 0.0)
    kind = type(splats).__name__
    if kind == "Splats2D":
        img = TD.render_splats2d(TG.splats2d_from_numpy(**arrays,
                                                        device="cpu"), cam)
    elif kind == "Splats3D":
        img = TD.render_splats3d(TG.splats3d_from_numpy(**arrays,
                                                        device="cpu"), cam,
                                 premultiplied=True)
    else:
        assert splats.count > 0
        img = TD.render_splats4d(TG.splats4d_from_numpy(**arrays,
                                                        device="cpu"), cam, t,
                                 st.min_opacity)
    got = np.clip(img.numpy(), 0.0, 1.0)
    diff = np.abs(got - want)
    frac_off = float((diff > 3.0 / 255.0).mean())
    assert diff.mean() < 0.004, f"{name}: mean|diff|={diff.mean():.5f}"
    assert frac_off < 0.01, f"{name}: {frac_off:.2%} of pixels drifted"
    assert float(got[..., :3].max()) > 0.1
