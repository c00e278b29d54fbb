"""Parity of the port's IO, models, scene generators, simplex noise and
overlays with the JAX reference on the CPU: `io.png`, `io.vdata`,
`io.native`, `scenes.models`, every entry of `scenes.scenes.SCENES`,
`utils.simplex`, `utils.misc` and `render.overlay`.

Inputs are made from a seed with numpy (or are the generators' own).
Tolerances:
  * PNG files byte-equal; IO round trips, models (numpy on both sides) and
    the scenes' positions and colors bit-equal;
  * the scenes' covariances (float32 look-at quaternions and covariance
    builders, torch against XLA) within 1e-6 of the field's max;
  * simplex values bit-equal to the reference's run op by op, gradients
    within 1e-6 of the max |g|;
  * overlays within 1e-5: the two sides' camera matrices and their (N, 3)
    x (3, 3) products round in other orders (camera-space coordinates of
    ~1,000 differ by one or two float32 ulps, 1.2e-4), which moves an
    antialiased line's edge coverage by a few 1e-6.

The sweep scenes run on a small torus at 6 time steps, so that the
reference builds one shape of splats for all five (each new shape costs it
seconds of compilation here); tests/test_torch_exact.py holds `linear` on
the viewer's full model.
"""

import inspect

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fourdgs.core.camera import Camera as RCamera  # noqa: E402
from fourdgs.io import native as RN  # noqa: E402
from fourdgs.io import png as RPNG  # noqa: E402
from fourdgs.io import vdata as RV  # noqa: E402
from fourdgs.render import overlay as RO  # noqa: E402
from fourdgs.scenes import models as RM  # noqa: E402
from fourdgs.scenes import scenes as RS  # noqa: E402
from fourdgs.utils import simplex as RX  # noqa: E402
from fourdgs_torch.core.camera import Camera as TCamera  # noqa: E402
from fourdgs_torch.io import native as TN  # noqa: E402
from fourdgs_torch.io import png as TPNG  # noqa: E402
from fourdgs_torch.io import vdata as TV  # noqa: E402
from fourdgs_torch.render import overlay as TO  # noqa: E402
from fourdgs_torch.scenes import models as TM  # noqa: E402
from fourdgs_torch.scenes import scenes as TS  # noqa: E402
from fourdgs_torch.utils import simplex as TX  # noqa: E402

COV_TOL, GRAD_TOL, OVERLAY_TOL = 1e-6, 1e-6, 1e-5
SWEEPS = ("linear", "nonlinear", "rotation", "combined", "broken", "square")


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [3, 4])
def test_png_bytes_equal(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.uniform(-0.1, 1.1, (17, 23, channels)).astype(np.float32)
    RPNG.write_png(str(tmp_path / "r.png"), img)
    TPNG.write_png(str(tmp_path / "t.png"), img)
    data = (tmp_path / "t.png").read_bytes()
    assert data == (tmp_path / "r.png").read_bytes()
    got = TPNG.read_png(str(tmp_path / "r.png"))
    np.testing.assert_array_equal(got, RPNG.read_png(str(tmp_path / "t.png")))
    np.testing.assert_array_equal(got, TPNG.to_uint8(img))
    gray = (img[..., 0] * 255).astype(np.uint8)          # (H, W) uint8
    TPNG.write_png(str(tmp_path / "g.png"), gray)
    RPNG.write_png(str(tmp_path / "rg.png"), gray)
    assert (tmp_path / "g.png").read_bytes() == (
        tmp_path / "rg.png").read_bytes()


# ---------------------------------------------------------------------------
# vdata / sd / native
# ---------------------------------------------------------------------------

def _vmodel(mod, n=37, seed=0):
    rng = np.random.default_rng(seed)
    return mod.VModel(position=rng.normal(size=(n, 3)).astype(np.float32),
                      normal=rng.normal(size=(n, 3)).astype(np.float32))


def _smodel(mod, n=29, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 4, 4)).astype(np.float32)
    return mod.SplatModel(position=rng.normal(size=(n, 3)).astype(np.float32),
                          color=rng.random((n, 4)).astype(np.float32),
                          cov=(a + a.transpose(0, 2, 1)).astype(np.float32))


def _same_model(a, b, ulp=False):
    """Equal field by field; with `ulp`, within one float32 ulp: the text
    formats keep 8 significant digits (`%.8g`), one short of a float32's
    round trip."""
    assert type(a).__name__ == type(b).__name__ and a.count == b.count
    for f in ("position", "normal", "color", "cov"):
        if hasattr(a, f):
            if ulp:
                np.testing.assert_array_max_ulp(getattr(a, f), getattr(b, f),
                                                maxulp=1)
            else:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                              err_msg=f)


def test_vdata_round_trips_both_ways(tmp_path):
    m = _vmodel(TV)
    TV.save_vdata(str(tmp_path / "t.vdata"), m)
    RV.save_vdata(str(tmp_path / "r.vdata"), _vmodel(RV))
    assert (tmp_path / "t.vdata").read_bytes() == (
        tmp_path / "r.vdata").read_bytes()
    _same_model(RV.load_vdata(str(tmp_path / "t.vdata")),
                TV.load_vdata(str(tmp_path / "r.vdata")))
    _same_model(TV.load_vdata(str(tmp_path / "t.vdata")), m, ulp=True)
    assert m.extrema()[0].tolist() == RV.VModel(
        m.position, m.normal).extrema()[0].tolist()


def test_sd_round_trips_both_ways(tmp_path):
    m = _smodel(TV)
    TV.save_sd(str(tmp_path / "t.sd"), m)
    RV.save_sd(str(tmp_path / "r.sd"), _smodel(RV))
    assert (tmp_path / "t.sd").read_bytes() == (tmp_path / "r.sd").read_bytes()
    _same_model(RV.load_sd(str(tmp_path / "t.sd")),
                TV.load_sd(str(tmp_path / "r.sd")))
    _same_model(TV.load_sd(str(tmp_path / "t.sd")), m, ulp=True)


def test_partial_record_dropped(tmp_path):
    path = tmp_path / "p.vdata"
    path.write_text("1 2 3 4 5 6\n7 8 9\n")
    _same_model(TV.load_vdata(str(path)), RV.load_vdata(str(path)))
    assert TV.load_vdata(str(path)).count == 1


def test_native_matches_python_reader(tmp_path):
    """The native reader (where it loads) against the Python parse, on
    both sides, and the binary cache between the two packages."""
    rng = np.random.default_rng(2)
    vals = rng.normal(size=600).astype(np.float32)
    path = tmp_path / "f.txt"
    path.write_text("\n".join(" ".join(f"{v:.8g}" for v in row)
                              for row in vals.reshape(100, 6)))
    python = np.array(path.read_text().split(), dtype=np.float32)
    assert TN.available() == RN.available()
    if not TN.available():
        assert TN.read_floats(str(path)) is None
        assert TN.write_cache(str(tmp_path / "c.bin"), vals[:, None]) is False
        return
    got = TN.read_floats(str(path))
    np.testing.assert_array_equal(got, python)
    np.testing.assert_array_equal(got, RN.read_floats(str(path)))
    rec = vals.reshape(100, 6)
    assert TN.write_cache(str(tmp_path / "c.bin"), rec)
    np.testing.assert_array_equal(RN.read_cache(str(tmp_path / "c.bin")), rec)
    np.testing.assert_array_equal(TN.read_cache(str(tmp_path / "c.bin")), rec)


def test_find_reference_object(tmp_path, monkeypatch):
    (tmp_path / "teapot.vdata").write_text("0 0 0 0 1 0\n")
    monkeypatch.setenv("FOURDGS_OBJECTS_DIR", str(tmp_path))
    assert TV.find_reference_object("teapot.vdata") == \
        RV.find_reference_object("teapot.vdata") == str(tmp_path /
                                                         "teapot.vdata")
    assert TV.find_reference_object("Mage.sd") is None
    _same_model(TM.teapot(), RM.teapot())
    assert TM.teapot().count == 1


# ---------------------------------------------------------------------------
# models and scenes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("icosphere", ()), ("icosphere", (2, 3.0)), ("uv_sphere", ()),
    ("torus", ()), ("torus", (76, 48)), ("teapot", ()), ("suzanne", ()),
    ("synthetic_sd_model", ()), ("synthetic_sd_model", (300, 3))])
def test_models_equal(name, args):
    _same_model(getattr(TM, name)(*args), getattr(RM, name)(*args))


def test_hsl_and_gradient_color_equal():
    rng = np.random.default_rng(3)
    h, s, l_ = rng.random(50) * 360, rng.random(50), rng.random(50)
    np.testing.assert_array_equal(TS.hsl_color(h, s, l_),
                                  RS.hsl_color(h, s, l_))
    m = TM.torus(9, 7)
    np.testing.assert_array_equal(
        TS.model_gradient_color(m.position, m.extrema(), m.normal),
        RS.model_gradient_color(m.position, m.extrema(), m.normal))


def _scene_kwargs(name):
    if name in SWEEPS:
        return dict(model=RM.torus(12, 8), steps=6)
    return {}


@pytest.mark.parametrize("name", list(RS.SCENES))
def test_scene_equals_reference(name):
    assert list(TS.SCENES) == list(RS.SCENES)
    kw = _scene_kwargs(name)
    want, wst = RS.SCENES[name](**kw)
    got, gst = TS.SCENES[name](**kw, device="cpu")
    assert type(got).__name__ == type(want).__name__
    assert gst == TS.SceneSettings(**wst.__dict__)
    assert got.count == want.count
    for f in ("position", "color", "cov"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == torch.float32 and g.device.type == "cpu", f
        assert tuple(g.shape) == w.shape, f
        if f == "cov" and w.size:
            assert _rel(g.numpy(), w) <= COV_TOL, f
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f)


def test_scene_generators_take_the_device(monkeypatch):
    """Every generator makes its splats on default_device() unless given a
    device (the meta device stands in for the card here)."""
    import fourdgs_torch
    monkeypatch.setattr(fourdgs_torch, "default_device",
                        lambda: torch.device("meta"))
    for name, fn in TS.SCENES.items():
        assert inspect.signature(fn).parameters["device"].default is None
        splats, _ = fn(**_scene_kwargs(name))
        assert splats.position.device.type == "meta", name
        assert splats.cov.device.type == "meta", name


# ---------------------------------------------------------------------------
# simplex
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,nargs", [
    ("snoise1", 1), ("snoise2", 2), ("snoise3", 3), ("fractal1", 1),
    ("fractal2", 2), ("fractal3", 3)])
def test_simplex_values_and_grads(name, nargs):
    rng = np.random.default_rng(nargs)
    xs = [rng.uniform(-60, 60, 3000).astype(np.float32) for _ in range(nargs)]
    xs[0][:4] = [0.0, -1.0, 1e6, -3.5]     # lattice points, far and negative
    fn = getattr(RX, name)

    # Values of the reference run op by op (its jit contracts products and
    # sums into FMAs, one ulp off); its gradients jitted.
    want = np.asarray(fn(*map(jnp.asarray, xs)))
    grads = jax.jit(jax.grad(lambda *b: jnp.sum(fn(*b) * jnp.arange(3000.0)),
                             argnums=tuple(range(nargs))))(
                                 *map(jnp.asarray, xs))
    leaves = [torch.tensor(x, requires_grad=True) for x in xs]
    got = getattr(TX, name)(*leaves)
    (got * torch.arange(3000.0)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    for leaf, g in zip(leaves, grads):
        assert _rel(leaf.grad.numpy(), np.asarray(g)) <= GRAD_TOL


# ---------------------------------------------------------------------------
# overlays
# ---------------------------------------------------------------------------

CAMS = [((0.0, 5.0, 20.0), (0.0, -0.2, -1.0)),
        ((60.0, 90.0, 90.0), (0.0, -1.0, -1.0)),
        ((30.0, 30.0, 30.0), (-1.0, -1.0, -1.0))]


def _cams(pos, ori, w=64, h=48):
    return (RCamera.create(position=pos, orientation=ori, width=w, height=h),
            TCamera.create(position=pos, orientation=ori, width=w, height=h,
                           device="cpu"))


def test_segments_equal():
    for got, want in ((TO.grid_segments(), RO.grid_segments()),
                      (TO.grid_segments(10.0, 30.0, 3, 5),
                       RO.grid_segments(10.0, 30.0, 3, 5)),
                      (TO.axis_segments(7.0), RO.axis_segments(7.0))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cam", range(len(CAMS)))
def test_grid_and_axis_overlays(cam):
    rc, tc = _cams(*CAMS[cam])
    img = np.random.default_rng(cam).random((48, 64, 4)).astype(np.float32)
    for name, kw in (("draw_grid", {}), ("draw_axis", {}),
                     ("draw_grid", dict(x_count=5, z_count=3, extent=50.0,
                                        color=(1.0, 0.0, 0.5, 0.7)))):
        want = np.asarray(getattr(RO, name)(jnp.asarray(img), rc, **kw))
        got = getattr(TO, name)(torch.tensor(img), tc, **kw).numpy()
        assert np.abs(got - want).max() <= OVERLAY_TOL, name
        assert np.abs(want - img).max() > 0.1, name      # lines were drawn


def test_draw_lines_clips_at_the_near_plane():
    """Segments wholly behind the camera draw nothing; a segment crossing
    the near plane is clipped there, as in the reference. The clipped
    endpoint lands at w = 1e-4, thousands of image widths away, so the
    one-ulp difference of the two sides' projection matrices turns the
    drawn line by ~1e-4 rad: its pixels are held as a set (coverage above
    0.5, up to a few edge pixels), the other segments to OVERLAY_TOL."""
    rc, tc = _cams((0.0, 0.0, 0.0), (0.0, 0.0, -1.0))
    p0 = np.array([[0, 0, 5], [1, 2, -40], [-3, -1, 5]], np.float32)
    p1 = np.array([[1, 1, 8], [-4, -2, -35], [2, 1, -30]], np.float32)
    cols = np.array([[1, 0, 0, 1], [0, 0, 1, 0.5], [0, 1, 0, 0.8]],
                    np.float32)
    img = np.zeros((48, 64, 4), np.float32)

    def both(k):
        want = np.asarray(jax.jit(lambda *a: RO.draw_lines(*a[:1], rc, *a[1:],
                                                           2.5))(
            jnp.asarray(img), jnp.asarray(p0[k]), jnp.asarray(p1[k]),
            jnp.asarray(cols[k])))
        got = TO.draw_lines(torch.tensor(img), tc, torch.tensor(p0[k]),
                            torch.tensor(p1[k]), torch.tensor(cols[k]),
                            2.5).numpy()
        return got, want
    got, want = both(slice(0, 2))
    assert np.abs(got - want).max() <= OVERLAY_TOL
    assert not got[..., 0].any() and got[..., 2].max() > 0.1
    got, want = both(slice(2, 3))
    drawn_g, drawn_w = got[..., 1] > 0.5, want[..., 1] > 0.5
    assert drawn_w.sum() > 50
    assert (drawn_g != drawn_w).sum() <= 0.05 * drawn_w.sum()


def test_misc_helpers_match_reference():
    from fourdgs.utils import misc as RMISC
    from fourdgs_torch.utils import misc as TMISC
    a, b = np.float32(2.0), np.arange(4, dtype=np.float32)
    np.testing.assert_array_equal(TMISC.lerp(a, b, 0.25),
                                  RMISC.lerp(a, b, 0.25))
    assert TMISC.mapf(3.0, 1.0, 5.0, -1.0, 1.0) == RMISC.mapf(
        3.0, 1.0, 5.0, -1.0, 1.0) == 0.0
    m = np.arange(6, dtype=np.float32).reshape(2, 3) - 2.5
    assert TMISC.format_mat(torch.tensor(m), "m") == RMISC.format_mat(m, "m")
    tree = {"a": torch.zeros(3, 4), "b": [np.zeros(5, np.float64),
                                          (torch.zeros(2, dtype=torch.int16),
                                           "x")]}
    assert TMISC.tree_bytes(tree) == 48 + 40 + 4
