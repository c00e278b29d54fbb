"""Parity of the port's render slice with the JAX reference on the CPU:
`render_params4d_packed` under `auto_render_config(..., converged=False)`.

The scene is the reference's own `bench.build_cube_scene` (4,000 splats,
positions scaled by 0.15 so the 256x128 view is densely covered and
tiles deepen past the 384-pair slab), handed over through numpy. The
reference runs as its own tests run it (Pallas interpret mode); the port
runs its kernels' plain PyTorch versions.

Stage by stage, on shared inputs:
  * projection fields within 2e-5 relative (float32, other exp/rsqrt);
    for the eigenvector, the footprint's quadratic form within 1e-3;
  * binning from the reference's projection: integers exact, the pairs of
    each tile equal as multisets (ties in a (tile, 20-bit depth) bucket
    sort in arbitrary order on both sides);
  * composite from the reference's binning: image within 1e-5.
End to end, from params: aux counters equal; the image differs only where
tied pairs were blended in another order, bounded below by fraction and
mean (see test_render_params4d_packed_matches_reference).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fourdgs_torch.core.camera import Camera as TCamera  # noqa: E402
from fourdgs_torch.render import pipeline as TP  # noqa: E402
from fourdgs_torch.render import tiles as TT  # noqa: E402
from fourdgs_torch.render.autoconfig import \
    auto_render_config as t_auto  # noqa: E402
from fourdgs_torch.render.project import Projected as TProj  # noqa: E402
from fourdgs_torch.splats.packed import params4d_from_numpy  # noqa: E402

N, W, H, SCALE = 4000, 256, 128, 0.15
CAM = dict(position=(420.0 * SCALE, 300.0 * SCALE, 420.0 * SCALE),
           orientation=(-1.0, -0.7, -1.0), far=5000.0, width=W, height=H)
TCAM = dict(CAM, device="cpu")      # the port's camera, on the CPU
DEAD = np.iinfo(np.int32).max
BIN_FIELDS = ("pair_splat", "pair_tile", "tile_start", "overflowed",
              "compact_dropped", "prune_underkeep", "tile_pruned",
              "prune_cut", "head_counts", "big_ids")


def _np(x):
    return np.array(x)


def reference_stages(cfg, n=N, w=W, h=H, cam_kw=None, scale=SCALE, seed=0,
                     bands=(None,), composite=True):
    """The reference's projection, binning and image for `cfg`, computed
    stage by stage exactly as its render_params4d_packed composes them, as
    numpy arrays: the hand-over of parameters and of integer state (pair
    keys' order, cut tables, CSR offsets) to the port. `bands` lists the
    tile_row_band of each binning wanted (None: the whole image); the
    composite is of the first."""
    from bench import build_cube_scene
    from fourdgs.core.camera import Camera
    from fourdgs.render import pipeline as RP
    from fourdgs.render import tiles as RT

    params = build_cube_scene(n, seed=seed)
    params = {k: v * scale if k in ("px", "py", "pz") else v
              for k, v in params.items()}
    cam = Camera.create(**(cam_kw or CAM))
    pm = _np(cam.proj_matrix())
    p00, p11 = pm[0, 0], pm[1, 1]

    def project(p):
        from fourdgs.render.project import project_components
        from fourdgs.splats import packed as PK
        cov4 = PK.cov4_motion(p)
        mx, my, mz, cov3, op, sm = PK.slice4d(p, cov4, 0.0, 0.0)
        return project_components(mx, my, mz, cov3,
                                  (p["cr"], p["cg"], p["cb"], p["ca"]), op,
                                  cam, sort_mean=sm)

    bin_kw = dict(
        tile_h=cfg.tile_h, tile_w=cfg.tile_w,
        max_tiles_per_splat=cfg.max_tiles_per_splat, quantized_depth=True,
        compact_keep_cols=cfg.sort_compact_keep_cols,
        big_splat_budget=cfg.big_splat_budget,
        big_splat_keep_cols=cfg.big_splat_keep_cols,
        pallas_sort=cfg.sort_backend == "pallas",
        pallas_compact=cfg.compact_backend == "pallas",
        compact_row_len=cfg.compact_row_len,
        depth_prune_cap=cfg.depth_prune_cap,
        depth_prune_safety=cfg.depth_prune_safety,
        head_cap=cfg.max_splats_per_tile if cfg.tail_mode == "banded" else 0)

    @jax.jit
    def stages(p):
        proj = project(p)
        binnings = [RT.bin_splats(proj, p00, p11, w, h, tile_row_band=band,
                                  **bin_kw) for band in bands]
        if not composite:
            return proj, binnings, jnp.zeros(()), jnp.zeros(())
        px, py, _ = RT.tile_pixel_ndc(w, h, cfg.tile_h, cfg.tile_w)
        tiles, resid = RP._composite_pallas_progressive(
            proj, binnings[0], px, py, p00, p11,
            jnp.asarray(cfg.background, jnp.float32), cfg,
            return_resid=True, image_size=(w, h))
        img = RT.assemble_image(tiles, w, h, cfg.tile_h, cfg.tile_w)
        return proj, binnings, img, jnp.max(resid)

    proj, binnings, img, resid = stages(params)
    binnings = [{k: None if getattr(b, k) is None else _np(getattr(b, k))
                 for k in BIN_FIELDS} for b in binnings]
    return dict(params={k: _np(v) for k, v in params.items()}, cfg=cfg,
                p00=p00, p11=p11, bin_kw=bin_kw,
                proj={f.name: _np(getattr(proj, f.name))
                      for f in dataclasses.fields(proj)},
                binning=binnings[0], binnings=binnings,
                img=_np(img), resid=float(resid))


@pytest.fixture(scope="module")
def ref():
    from fourdgs.render.autoconfig import auto_render_config
    return reference_stages(auto_render_config(N, W, H, converged=False))


def assert_binning_matches(tb, rb, min_live=1000):
    """The port's TileBinning against the reference's (numpy) one: integers
    exact, sorted keys over the live prefix (as tile ids) exact, the pairs
    of each tile equal as multisets."""
    for name in ("tile_start", "overflowed", "compact_dropped",
                 "prune_underkeep", "tile_pruned", "prune_cut",
                 "head_counts", "big_ids"):
        want = rb[name]
        got = getattr(tb, name)
        assert (got is None) == (want is None), name
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    live = int(rb["tile_start"][-1])
    assert live > min_live
    np.testing.assert_array_equal(tb.pair_tile.numpy()[:live],
                                  rb["pair_tile"][:live])
    got = _pair_multiset(tb.pair_tile.numpy(), tb.pair_splat.numpy(), live)
    want = _pair_multiset(rb["pair_tile"], rb["pair_splat"], live)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _tproj(ref):
    return TProj(**{k: torch.from_numpy(v) for k, v in ref["proj"].items()})


def _pair_multiset(tile, splat, live):
    t, s = tile[:live], splat[:live]
    order = np.lexsort((s, t))
    return t[order], s[order]


def test_camera_matches_reference():
    from fourdgs.core.camera import Camera
    rc, tc = Camera.create(**CAM), TCamera.create(**TCAM)
    np.testing.assert_allclose(tc.view_matrix().numpy(),
                               _np(rc.view_matrix()), rtol=0, atol=2e-6)
    np.testing.assert_allclose(tc.proj_matrix().numpy(),
                               _np(rc.proj_matrix()), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n,w,h", [(4000, 256, 128), (10_000_000, 1920, 1088),
                                   (200_000, 3840, 2160)])
@pytest.mark.parametrize("converged", [False, True])
def test_render_config_matches_reference(n, w, h, converged):
    from fourdgs.render.autoconfig import auto_render_config
    want = auto_render_config(n, w, h, converged=converged)
    got = t_auto(n, w, h, converged=converged)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert TP.RenderConfig(**dataclasses.asdict(want)) == got


def _conic(v0x, v0y, l0, l1):
    """The footprint's quadratic form v0 v0^T / l0^2 + v1 v1^T / l1^2."""
    a, b = 1.0 / l0.astype(np.float64) ** 2, 1.0 / l1.astype(np.float64) ** 2
    x, y = v0x.astype(np.float64), v0y.astype(np.float64)
    return np.stack([x * x * a + y * y * b, x * y * (a - b),
                     y * y * a + x * x * b])


def test_projection_matches_reference(ref):
    tparams = params4d_from_numpy(ref["params"], "cpu")
    proj = TP.project_params4d(tparams, TCamera.create(**TCAM), 0.0)
    for name, want in ref["proj"].items():
        got = getattr(proj, name).numpy()
        if want.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name not in ("v0x", "v0y"):
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6,
                                       err_msg=name)
    # The eigenvector of a nearly isotropic footprint is ill-conditioned
    # (last-bit differences of the covariance turn it by up to ~1e-2 where
    # l0 ~ l1); the footprint's quadratic form moves by that angle times
    # the small eigenvalue gap: measured 3.5e-4 of its scale.
    got = _conic(*(getattr(proj, k).numpy() for k in ("v0x", "v0y", "l0",
                                                      "l1")))
    want = _conic(*(ref["proj"][k] for k in ("v0x", "v0y", "l0", "l1")))
    scale = np.abs(want).max(axis=0)
    assert float((np.abs(got - want) / scale).max()) < 1e-3


def test_bin_splats_matches_reference(ref):
    rb = ref["binning"]
    tb = TT.bin_splats(_tproj(ref), torch.tensor(ref["p00"]),
                       torch.tensor(ref["p11"]), W, H, **ref["bin_kw"])
    assert_binning_matches(tb, rb)
    assert int(rb["tile_pruned"].sum()) > 0


def test_composite_from_reference_binning(ref):
    cfg = TP.RenderConfig(**dataclasses.asdict(ref["cfg"]))
    binning = TT.TileBinning(**{k: None if v is None else torch.from_numpy(v)
                                for k, v in ref["binning"].items()})
    px, py, _ = TT.tile_pixel_ndc(W, H, cfg.tile_h, cfg.tile_w,
                                  device="cpu")
    p00, p11 = torch.tensor(ref["p00"]), torch.tensor(ref["p11"])
    tiles, resid = TP._composite_pallas_progressive(
        _tproj(ref), binning, px, py, p00, p11,
        torch.tensor(cfg.background), cfg)
    img = TT.assemble_image(tiles, W, H, cfg.tile_h, cfg.tile_w).numpy()
    np.testing.assert_allclose(img, ref["img"], rtol=0, atol=1e-5)
    assert float(resid.max()) == ref["resid"]
    # Deep tiles really went through the deepening passes.
    counts = np.diff(ref["binning"]["tile_start"])
    assert counts.max() > cfg.max_splats_per_tile


def test_render_params4d_packed_matches_reference(ref):
    cfg = TP.RenderConfig(**dataclasses.asdict(ref["cfg"]))
    img, aux = TP.render_params4d_packed(
        params4d_from_numpy(ref["params"], "cpu"), TCamera.create(**TCAM),
        0.0, cfg=cfg, return_aux=True)
    rb = ref["binning"]
    assert int(aux["overflowed"]) == int(rb["overflowed"]) == 0
    assert int(aux["compact_dropped"]) == int(rb["compact_dropped"]) == 0
    assert int(aux["prune_underkeep"]) == int(rb["prune_underkeep"]) == 0
    assert int(aux["live_pairs"]) == int(rb["tile_start"][-1])
    assert int(aux["max_tile_pairs"]) == int(np.diff(rb["tile_start"]).max())
    assert float(aux["resid_transmittance"]) == ref["resid"]
    img = img.numpy()
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
    # Pairs tied on (tile, 20-bit depth) blend in sort order, which is
    # arbitrary on both sides: the pixels they touch may differ by up to the
    # pair's contribution. Everything else agrees to float rounding.
    err = np.abs(img - ref["img"]).max(axis=-1)
    assert float(err.mean()) < 1e-4
    assert float((err > 1e-3).mean()) < 0.01
    assert float(np.abs(img[..., :3].mean() - ref["img"][..., :3].mean())) \
        < 1e-4
    assert (ref["img"][..., :3].sum(-1) > 0.01).mean() > 0.15   # covered


# ---------------------------------------------------------------------------
# Plain compaction helpers of the binning (plain XLA in the reference)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keep", [40, 9000])
def test_compact_pairs_matches_reference(keep):
    from fourdgs.render.tiles import compact_pairs
    rng = np.random.default_rng(keep)
    s = 3 * 8192 + 501
    key = rng.choice(1 << 30, s, replace=False).astype(np.int32)
    key[rng.random(s) < 0.9] = DEAD
    wk, wv, wd = compact_pairs(jnp.asarray(key), jnp.asarray(key), DEAD,
                               keep)
    gk, gv, gd = TT.compact_pairs(torch.from_numpy(key),
                                  torch.from_numpy(key), DEAD, keep)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert int(gd) == int(wd) and (int(gd) > 0) == (keep == 40)


@pytest.mark.parametrize("hot_cap", [1024, 4])
def test_compact_flag_ids_matches_reference(hot_cap):
    from fourdgs.render.tiles import compact_flag_ids
    rng = np.random.default_rng(hot_cap)
    n = 128 * 1024
    flag = np.zeros(n, bool)
    flag[rng.choice(n, 150, replace=False)] = True
    wi, wd = compact_flag_ids(jnp.asarray(flag), hot_cap=hot_cap)
    gi, gd = TT.compact_flag_ids(torch.from_numpy(flag), hot_cap=hot_cap)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert int(gd) == int(wd) and (int(gd) > 0) == (hot_cap == 4)
