"""Parity of the port's exact-order render paths with the JAX reference on
the CPU: `bin_splats`' exact branch, `front_to_back_order`, both composite
backends of `render_projected` (`backend="xla"`, the reference's
plain-array compositor, and `backend="pallas"`, K1's plain version against
the reference's kernel in interpret mode), the entry points
`render_splats2d/3d/4d` and `render_params4d_packed` under exact configs,
the truncation residual, and gradients against `jax.grad`.

The scene: 240 random 3D splats and 60 copies of the first 60 (the same
position and covariance, another color), so that depths repeat and the
order of tied splats shows in the image.

Tolerances:
  * integers (the front-to-back permutation, the exact binning) equal;
  * composites from one projection and one binning: max |d| 1e-5;
  * frames from the splats: each package projects for itself, so a
    coverage test at a footprint's edge (|n| = 0.5 or w = 1e-4) may fall
    the other way for a (pixel, splat) pair, moving that pixel by at most
    the edge weight exp(-8) = 3.4e-4 times the splat's alpha: max |d|
    4e-4, mean |d| 1e-6, and aux counters equal;
  * gradients: within 1e-4 of each field's max |g| (other summation
    orders over pixels and splats).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fourdgs.core.camera import Camera as RCamera  # noqa: E402
from fourdgs.render import pipeline as RP  # noqa: E402
from fourdgs.render import sort as RS  # noqa: E402
from fourdgs.render import tiles as RT  # noqa: E402
from fourdgs.render.project import project_splats  # noqa: E402
from fourdgs.splats import gaussians as RG  # noqa: E402
from fourdgs.splats import packed as RPK  # noqa: E402
from fourdgs_torch.core.camera import Camera as TCamera  # noqa: E402
from fourdgs_torch.ops import composite_cuda as TCC  # noqa: E402
from fourdgs_torch.render import pipeline as TP  # noqa: E402
from fourdgs_torch.render import sort as TS  # noqa: E402
from fourdgs_torch.render import tiles as TT  # noqa: E402
from fourdgs_torch.render.project import Projected  # noqa: E402
from fourdgs_torch.splats import gaussians as TG  # noqa: E402
from fourdgs_torch.splats import packed as TPK  # noqa: E402

W, H = 96, 64
# The exact binnings held: (tile_h, tile_w, tile_row_band).
BINNINGS = {"32x32": (32, 32, None), "8x128": (8, 128, None),
            "8x128-band": (8, 128, (2, 3))}
COMP_TOL = 1e-5
EDGE_TOL, MEAN_TOL = 4e-4, 1e-6
GRAD_TOL = 1e-4
# The configurations of the slice: the default (xla backend, 32x32 tiles),
# the viewer's pallas config, and the pallas backend with deepening.
CFGS = {"xla": {},
        "viewer": dict(tile_h=8, tile_w=128, backend="pallas"),
        "deepening": dict(backend="pallas", max_splats_per_tile=128,
                          deepening_passes=3, deepening_fraction=1.0)}


def _scene3d(n=240, dup=60, seed=0, spread=6.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    pos[:, 2] -= 30.0
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    scale = rng.uniform(0.5, 3.0, (n, 3)).astype(np.float32)
    color = rng.uniform(0.1, 1.0, (n + dup, 4)).astype(np.float32)
    cov = np.asarray(RG.build_cov3d(jnp.asarray(quat), jnp.asarray(scale)))
    return dict(position=np.concatenate([pos, pos[:dup]]),
                color=color, cov=np.concatenate([cov, cov[:dup]]))


def _scene4d(n=120, seed=3):
    rng = np.random.default_rng(seed)
    pos4 = np.concatenate([rng.uniform(-8, 8, (n, 3)),
                           rng.uniform(0.0, 4.0, (n, 1))], -1)
    pos4[:, 2] -= 30.0
    s = RG.Splats4D.from_motion(
        position4=pos4.astype(np.float32),
        quat=rng.normal(size=(n, 4)).astype(np.float32),
        scale3=rng.uniform(0.5, 2.5, (n, 3)).astype(np.float32),
        lifetime=np.full((n,), 2.0, np.float32),
        fade=np.full((n,), 0.5, np.float32),
        velocity=(rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
        color=rng.uniform(0.1, 1.0, (n, 4)).astype(np.float32))
    return {k: np.asarray(getattr(s, k)) for k in ("position", "color", "cov")}


def _scene2d():
    from fourdgs.scenes import scenes as S
    s, _ = S.gaussians_2d(n=20, seed=3)
    return {k: np.asarray(getattr(s, k), np.float32)
            for k in ("position", "color", "cov")}


def _packed(n=400, seed=5):
    """A packed motion scene (the cube's distributions, shrunk into view)."""
    rng = np.random.default_rng(seed)
    pos4 = np.concatenate([rng.uniform(-9, 9, (n, 3)),
                           rng.uniform(-1.0, 1.0, (n, 1))], -1)
    pos4[:, 2] -= 32.0
    p = RPK.params4d_from_arrays(
        pos4.astype(np.float32), rng.normal(size=(n, 4)).astype(np.float32),
        rng.uniform(0.3, 1.5, (n, 3)).astype(np.float32), 1.5, 0.5,
        rng.normal(size=(n, 3)).astype(np.float32) * 0.5,
        rng.uniform(0.1, 1.0, (n, 4)).astype(np.float32))
    return {k: np.asarray(v) for k, v in p.items()}


def _rcam():
    return RCamera.create(width=W, height=H)


def _tcam():
    return TCamera.create(width=W, height=H, device="cpu")


def _tproj(proj_np):
    return Projected(**{k: torch.tensor(v) for k, v in proj_np.items()})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """The reference's projection of the 3D scene (in front-to-back order)
    and its exact binnings, as numpy."""
    sc = _scene3d()
    cam = _rcam()
    pm = np.asarray(cam.proj_matrix())

    @jax.jit
    def stages(pos, cov, color):
        proj = project_splats(pos, cov, color, jnp.ones(pos.shape[0]), cam)
        order = RS.front_to_back_order(proj.depth)
        proj = jax.tree_util.tree_map(lambda a: a[order], proj)
        bins = {name: RT.bin_splats(proj, pm[0, 0], pm[1, 1], W, H,
                                    tile_h=th, tile_w=tw, tile_row_band=band)
                for name, (th, tw, band) in BINNINGS.items()}
        return proj, order, bins

    proj, order, bins = _np(stages(*map(jnp.asarray, (
        sc["position"], sc["cov"], sc["color"]))))
    return dict(scene=sc, pm=pm, order=order, bins=bins,
                proj={f.name: getattr(proj, f.name)
                      for f in dataclasses.fields(proj)})


# --------------------------------------------------------------------------
# ordering and binning
# --------------------------------------------------------------------------

def test_front_to_back_order_on_repeated_depths():
    rng = np.random.default_rng(1)
    depth = rng.integers(0, 12, 500).astype(np.float32)     # many ties
    want = np.asarray(RS.front_to_back_order(jnp.asarray(depth)))
    got = TS.front_to_back_order(torch.from_numpy(depth)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TS.front_to_back_rank(torch.from_numpy(depth)).numpy(),
        np.asarray(RS.front_to_back_rank(jnp.asarray(depth))))
    np.testing.assert_array_equal(
        TS.painter_order(torch.from_numpy(depth)).numpy(),
        np.asarray(RS.painter_order(jnp.asarray(depth))))
    inv = TS.inverse_permutation(torch.tensor([2, 0, 3, 1], dtype=torch.int32))
    np.testing.assert_array_equal(inv.numpy(), [1, 3, 0, 2])


def test_scene_permutation_matches_reference(ref):
    """The scene's front-to-back permutation (its duplicated splats tie in
    depth) equals the reference's."""
    sc = ref["scene"]
    tproj = TP.project_splats(*(torch.from_numpy(sc[k]) for k in (
        "position", "cov", "color")), torch.ones(300), _tcam())
    order = TS.front_to_back_order(tproj.depth).numpy()
    # The projections differ in the last bits; the duplicates' depths are
    # bit-equal to each other on both sides, so the ties fall alike.
    np.testing.assert_array_equal(order, ref["order"])
    depth = ref["proj"]["depth"]
    assert len(np.unique(depth)) < len(depth)


@pytest.mark.parametrize("case", list(BINNINGS))
def test_exact_binning_matches_reference(ref, case):
    th, tw, band = BINNINGS[case]
    rb = ref["bins"][case]
    tb = TT.bin_splats(_tproj(ref["proj"]), torch.tensor(ref["pm"][0, 0]),
                       torch.tensor(ref["pm"][1, 1]), W, H, tile_h=th,
                       tile_w=tw, tile_row_band=band)
    for name in ("pair_splat", "pair_tile", "tile_start", "overflowed"):
        got, want = getattr(tb, name).numpy(), np.asarray(getattr(rb, name))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("compact_dropped", "prune_underkeep", "tile_pruned",
                 "prune_cut", "head_counts", "big_ids"):
        assert getattr(tb, name) is None and getattr(rb, name) is None
    assert int(rb.tile_start[-1]) > 200


def test_bin_splats_defaults_to_the_exact_branch(ref):
    """C-P6: bin_splats with no ordering or tile size given is the exact
    branch at 32x32 tiles, as in the reference."""
    tb = TT.bin_splats(_tproj(ref["proj"]), torch.tensor(ref["pm"][0, 0]),
                       torch.tensor(ref["pm"][1, 1]), W, H)
    rb = ref["bins"]["32x32"]
    np.testing.assert_array_equal(tb.pair_splat.numpy(), rb.pair_splat)
    np.testing.assert_array_equal(tb.tile_start.numpy(), rb.tile_start)


# --------------------------------------------------------------------------
# the composite of one binning
# --------------------------------------------------------------------------

def _binning(rb):
    return TT.TileBinning(**{
        f.name: None if getattr(rb, f.name) is None
        else torch.tensor(np.asarray(getattr(rb, f.name)))
        for f in dataclasses.fields(TT.TileBinning)})


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_composite_of_one_binning(ref, backend):
    """render_projected's composite of the reference's binning: the xla
    backend's plain-array compositor and, with pallas, K1's plain version
    (against the reference's kernel in interpret mode) with deepening."""
    if backend == "xla":
        key, kw = "32x32", dict(max_splats_per_tile=256,
                                       splat_chunk=32)
    else:
        key, kw = "8x128", dict(tile_h=8, tile_w=128,
                                       backend="pallas",
                                       max_splats_per_tile=128,
                                       deepening_passes=3,
                                       deepening_fraction=1.0)
    rcfg, tcfg = RP.RenderConfig(**kw), TP.RenderConfig(**kw)
    rb = ref["bins"][key]
    counts = np.diff(rb.tile_start)
    if backend == "pallas":
        assert counts.max() > 128              # the deepening passes run
    pm = ref["pm"]
    rproj = RP.Projected(**{k: jnp.asarray(v) for k, v in ref["proj"].items()})
    px, py, _ = RT.tile_pixel_ndc(W, H, tcfg.tile_h, tcfg.tile_w)
    bg = jnp.asarray(rcfg.background, jnp.float32)

    @jax.jit
    def reference(rproj, rb):
        if backend == "xla":
            ts, live = RP._gather_tile_lists(rproj, rb, rcfg, len(counts))
            return RP._composite_tiles_xla(rproj, ts, live, px, py, pm[0, 0],
                                           pm[1, 1], bg, rcfg.splat_chunk,
                                           return_resid=True)
        return RP._composite_pallas_progressive(
            rproj, rb, px, py, pm[0, 0], pm[1, 1], bg, rcfg,
            return_resid=True)
    want, want_r = _np(reference(rproj, rb))

    tproj, tb = _tproj(ref["proj"]), _binning(rb)
    tpx, tpy = torch.tensor(np.asarray(px)), torch.tensor(np.asarray(py))
    p00, p11 = torch.tensor(pm[0, 0]), torch.tensor(pm[1, 1])
    tbg = torch.tensor(tcfg.background)
    if backend == "xla":
        ts, live = TP._gather_tile_lists(tb, tcfg)
        got, got_r = TP._composite_tiles_xla(tproj, ts, live, tpx, tpy, p00,
                                             p11, tbg, tcfg.splat_chunk,
                                             return_resid=True)
    else:
        got, got_r = TP._composite_pallas_progressive(tproj, tb, tpx, tpy,
                                                      p00, p11, tbg, tcfg)
        # The tile-list form through the same kernel's plain version.
        ts, live = TP._gather_tile_lists(tb, tcfg)
        tiles = TCC.composite_tiles_pallas(tproj, ts, live, tpx, tpy, p00,
                                           p11, tbg, tcfg)
        assert tiles.shape == want.shape
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= COMP_TOL
    assert float(np.abs(got_r.numpy() - want_r).max()) <= COMP_TOL
    if backend == "pallas":
        # Pass 1 alone (composite_tiles_pallas) equals the deepened image
        # wherever a tile fits in one slab.
        one = counts <= 128
        assert float((tiles - got).abs()[torch.from_numpy(one)].max()) \
            <= COMP_TOL


def test_composite_tiles_pallas_refuses_bad_tiles():
    cfg = TP.RenderConfig(tile_h=8, tile_w=8)
    px = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="multiple of 128"):
        TCC.composite_tiles_pallas(None, None, None, px, px, 1.0, 1.0, None,
                                   cfg)


# --------------------------------------------------------------------------
# the entry points, from the splats
# --------------------------------------------------------------------------

def _frame_close(got, want, aux_t=None, aux_r=None):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape == (H, W, 4)
    d = np.abs(got - want)
    assert float(d.max()) <= EDGE_TOL, f"max |d| {d.max():.3e}"
    assert float(d.mean()) <= MEAN_TOL, f"mean |d| {d.mean():.3e}"
    assert float(want[..., :3].max()) > 0.1             # something drew
    if aux_t is not None:
        for k in ("overflowed", "live_pairs", "max_tile_pairs"):
            assert int(aux_t[k]) == int(aux_r[k]), k
        assert abs(float(aux_t["resid_transmittance"])
                   - float(aux_r["resid_transmittance"])) <= COMP_TOL
        assert set(aux_t) == set(aux_r)


def _splats(kind, arrays):
    rcls = {"2d": RG.Splats2D, "3d": RG.Splats3D, "4d": RG.Splats4D}[kind]
    tfn = getattr(TG, f"splats{kind}_from_numpy")
    return (rcls(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            tfn(**arrays, device="cpu"))


@pytest.mark.parametrize("cfg", list(CFGS))
def test_render_splats3d(ref, cfg):
    rs, ts = _splats("3d", ref["scene"])
    kw = CFGS[cfg]
    want, aux_r = jax.jit(lambda s: RP.render_splats3d(
        s, _rcam(), cfg=RP.RenderConfig(**kw), return_aux=True))(rs)
    got, aux_t = TP.render_splats3d(ts, _tcam(), cfg=TP.RenderConfig(**kw),
                                    return_aux=True)
    _frame_close(got, want, aux_t, aux_r)
    if cfg == "deepening":
        assert int(aux_t["max_tile_pairs"]) > 128    # a deepening pass ran


@pytest.mark.parametrize("cfg", ["xla", "viewer"])
def test_render_splats4d(cfg):
    rs, ts = _splats("4d", _scene4d())
    kw = CFGS[cfg]
    ref_fn = jax.jit(lambda s, t: RP.render_splats4d(
        s, _rcam(), t, cfg=RP.RenderConfig(**kw)))
    for t in (0.0, 1.7):
        want = ref_fn(rs, t)
        got = TP.render_splats4d(ts, _tcam(), torch.tensor(t),
                                 cfg=TP.RenderConfig(**kw))
        _frame_close(got, want)


@pytest.mark.parametrize("cfg", ["xla", "viewer"])
def test_render_splats2d(cfg):
    """The 2D scene: depth = index and the effective p00 / p11 of
    project_splats2d, through render_projected's override."""
    kw = dict(CFGS[cfg], max_tiles_per_splat=64)
    rs, ts = _splats("2d", _scene2d())
    want = jax.jit(lambda s: RP.render_splats2d(
        s, _rcam(), cfg=RP.RenderConfig(**kw)))(rs)
    got = TP.render_splats2d(ts, _tcam(), cfg=TP.RenderConfig(**kw))
    _frame_close(got, want)


@pytest.mark.parametrize("cfg", ["xla", "deepening"])
def test_render_params4d_packed_exact(cfg):
    p = _packed()
    kw = CFGS[cfg]
    want, aux_r = jax.jit(lambda q: RP.render_params4d_packed(
        q, _rcam(), 0.4, cfg=RP.RenderConfig(**kw), return_aux=True))(p)
    got, aux_t = TP.render_params4d_packed(
        TPK.params4d_from_numpy(p, "cpu"), _tcam(), 0.4,
        cfg=TP.RenderConfig(**kw), return_aux=True)
    _frame_close(got, want, aux_t, aux_r)


def test_render_projected_p00_p11_override(ref):
    """C-P6: render_projected takes the projection diagonal from its caller
    when given (the 2D scene's path), else from the camera."""
    rproj = RP.Projected(**{k: jnp.asarray(v) for k, v in ref["proj"].items()})
    p00, p11 = 0.8 * ref["pm"][0, 0], 1.3 * ref["pm"][1, 1]
    kw = dict(max_splats_per_tile=256)
    want = jax.jit(lambda q: RP.render_projected(
        q, _rcam(), RP.RenderConfig(**kw), p00=p00, p11=p11))(rproj)
    got = TP.render_projected(_tproj(ref["proj"]), _tcam(),
                              TP.RenderConfig(**kw), p00=torch.tensor(p00),
                              p11=torch.tensor(p11))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= COMP_TOL
    plain = TP.render_projected(_tproj(ref["proj"]), _tcam(),
                                TP.RenderConfig(**kw))
    assert float((plain - got).abs().max()) > 0.05


def test_truncation_residual():
    """A per-tile capacity of 8 (tests/test_tiled.py's case): the nearest
    splats win, the residual transmittance reports the truncation, and
    both equal the reference's."""
    rng = np.random.default_rng(5)
    n = 100
    pos = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    pos[:, 2] -= 30.0
    cov = np.asarray(RG.build_cov3d(
        jnp.asarray(rng.normal(size=(n, 4)).astype(np.float32)),
        jnp.asarray(rng.uniform(0.5, 3.0, (n, 3)).astype(np.float32))))
    arrays = dict(position=pos, cov=cov,
                  color=rng.uniform(0.1, 1.0, (n, 4)).astype(np.float32))
    rs, ts = _splats("3d", arrays)
    small = dict(max_splats_per_tile=8, splat_chunk=8)
    want, aux_r = jax.jit(lambda s: RP.render_splats3d(
        s, _rcam(), cfg=RP.RenderConfig(**small), return_aux=True))(rs)
    got, aux_t = TP.render_splats3d(ts, _tcam(), cfg=TP.RenderConfig(**small),
                                    return_aux=True)
    _frame_close(got, want, aux_t, aux_r)
    assert float(aux_t["resid_transmittance"]) > 0.01
    full = TP.render_splats3d(ts, _tcam(), cfg=TP.RenderConfig(
        max_splats_per_tile=256, splat_chunk=32))
    empty = full[..., :3].sum(-1) == 0
    assert bool((got[..., :3].sum(-1)[empty] == 0).all())


# --------------------------------------------------------------------------
# gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", ["xla", "viewer"])
def test_gradients_match_jax_grad(cfg):
    """d mean(img[..., :3]^2) / d (position, cov, color) of render_splats3d,
    against jax.grad of the reference."""
    sc = _scene3d(n=50, dup=10, seed=4)
    kw = CFGS[cfg]
    tgt = np.random.default_rng(2).uniform(0, 1, (H, W, 3)).astype(np.float32)

    def loss_ref(pos, cov, color):
        img = RP.render_splats3d(RG.Splats3D(position=pos, color=color,
                                             cov=cov), _rcam(),
                                 cfg=RP.RenderConfig(**kw))
        return jnp.mean((img[..., :3] - tgt) ** 2)
    want = _np(jax.jit(jax.grad(loss_ref, argnums=(0, 1, 2)))(
        *(jnp.asarray(sc[k]) for k in ("position", "cov", "color"))))

    leaves = [torch.tensor(sc[k], requires_grad=True)
              for k in ("position", "cov", "color")]
    img = TP.render_splats3d(TG.Splats3D(position=leaves[0], cov=leaves[1],
                                         color=leaves[2]), _tcam(),
                             cfg=TP.RenderConfig(**kw))
    ((img[..., :3] - torch.from_numpy(tgt)) ** 2).mean().backward()
    for name, leaf, w in zip(("position", "cov", "color"), leaves, want):
        g = leaf.grad.numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, name
        err = float(np.abs(g - w).max()) / scale
        assert err <= GRAD_TOL, f"{name}: {err:.3e} of the field's max"


def test_xla_backend_gradcheck_float64():
    """torch.autograd.gradcheck of the xla backend's compositor in float64
    over every differentiable field, on two tiles of 4x4 pixels with lists of
    6 splats in chunks of 4 (a padded chunk)."""
    rng = np.random.default_rng(9)
    n, t, p = 5, 2, 16
    ys, xs = np.meshgrid(np.linspace(-0.3, 0.3, 4), np.linspace(-0.3, 0.3, 4),
                         indexing="ij")
    px = torch.tensor(np.stack([xs.ravel(), xs.ravel() + 0.05]))
    py = torch.tensor(np.stack([ys.ravel(), ys.ravel() - 0.05]))
    ang = rng.uniform(0, np.pi, n)
    fields = dict(
        mx=rng.uniform(-0.2, 0.2, n), my=rng.uniform(-0.2, 0.2, n),
        v0x=np.cos(ang), v0y=np.sin(ang),
        l0=rng.uniform(0.15, 0.25, n), l1=rng.uniform(0.25, 0.4, n),
        r=rng.uniform(0, 1, n), g=rng.uniform(0, 1, n), b=rng.uniform(0, 1, n),
        a=rng.uniform(0.3, 0.8, n), opacity=rng.uniform(0.5, 1.0, n))
    names = list(fields)
    tile_splat = torch.tensor([[0, 1, 2, 3, 4, 0], [4, 3, 2, 1, 0, 0]],
                              dtype=torch.int32)
    tile_live = torch.tensor([[1, 1, 1, 1, 1, 0], [1, 1, 1, 0, 1, 1]],
                             dtype=torch.bool)
    bg = torch.tensor([0.1, 0.2, 0.3, 1.0], dtype=torch.float64)

    def fn(*vals):
        proj = Projected(**dict(zip(names, vals)),
                         depth=torch.zeros(n, dtype=torch.float64),
                         view_z=torch.ones(n, dtype=torch.float64),
                         valid=torch.ones(n, dtype=torch.bool))
        return TP._composite_tiles_xla(proj, tile_splat, tile_live, px, py,
                                       1.2, 1.7, bg, 4)
    inputs = [torch.tensor(fields[k], requires_grad=True) for k in names]
    out = fn(*inputs)
    assert out.shape == (t, p, 4) and float(out[..., 3].detach().min()) < 0.99
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-7)


def test_chip_smoke_linear_scene_is_the_references():
    """chip_smoke.py's full-width scene is the port's `linear` scene on the
    reference's fallback model (`linear_motion(torus(76, 48))`), held here
    against the reference's at 3 of its 50 steps: positions and time
    centres equal, colors within 1e-6, covariances within 1e-5 of their
    largest entry (the rotations are float32 on both sides, through other
    operations)."""
    import inspect

    import chip_smoke
    from fourdgs.scenes import models as RM
    from fourdgs.scenes import scenes as RSC
    from fourdgs_torch.scenes import models as TM
    from fourdgs_torch.scenes import scenes as TSC
    ref, settings = RSC.linear_motion(RM.torus(76, 48), steps=3)
    got, got_settings = TSC.linear_motion(TM.torus(*chip_smoke.LINEAR_GRID),
                                          steps=3, device="cpu")
    assert got.count == 3 * 76 * 48 == ref.count
    np.testing.assert_array_equal(got.position.numpy(),
                                  np.asarray(ref.position))
    np.testing.assert_allclose(got.color.numpy(), np.asarray(ref.color),
                               rtol=0, atol=1e-6)
    cov = np.asarray(ref.cov)
    np.testing.assert_allclose(got.cov.numpy(), cov, rtol=0,
                               atol=1e-5 * np.abs(cov).max())
    assert chip_smoke.LINEAR_CAMERA == dict(
        position=settings.camera_position,
        orientation=settings.camera_orientation)
    assert got_settings == TSC.SceneSettings(**settings.__dict__)
    # chip_smoke builds (s)'s scene with that generator, not a copy of it.
    assert not hasattr(chip_smoke, "linear_scene")
    src = inspect.getsource(chip_smoke.phase_exact_full)
    assert "linear_motion(" in src and "torus(*LINEAR_GRID)" in src