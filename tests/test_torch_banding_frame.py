"""Whole banded frames of the port on the CPU (the scene, image and
configurations of tests/test_torch_banding.py): the exact-head frame of
4,224 tiles against the JAX reference's, the rows at the band seams, and a
small image rendered in two bands against its unbanded frame.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from fourdgs_torch.core.camera import Camera as TCamera  # noqa: E402
from fourdgs_torch.render import pipeline as TP  # noqa: E402
from fourdgs_torch.render import tiles as TT  # noqa: E402
from test_torch_banding import (  # noqa: E402
    BANDS, CAM, H, MODES, N, SCALE, SEED, TILE_H, TILE_W,
    _assert_counters_close, _assert_frames_close, _cfg, _port_frame, _tcfg)


@pytest.fixture(scope="module")
def ref_frame():
    """The reference's whole banded frame (exact head, one pass)."""
    from bench import build_cube_scene
    from fourdgs.core.camera import Camera
    from fourdgs.render.pipeline import render_params4d_packed
    params = build_cube_scene(N, seed=SEED)
    params = {k: v * SCALE if k in ("px", "py", "pz") else v
              for k, v in params.items()}
    cfg = _cfg("off")
    img, aux = render_params4d_packed(params, Camera.create(**CAM), 0.0,
                                      cfg=cfg, return_aux=True)
    return dict(params={k: np.array(v) for k, v in params.items()}, cfg=cfg,
                img=np.array(img), aux={k: float(v) for k, v in aux.items()})


def test_banded_frame_matches_reference(ref_frame):
    img, aux = _port_frame(ref_frame["params"], ref_frame["cfg"])
    _assert_counters_close(aux, {k: int(v)
                                 for k, v in ref_frame["aux"].items()})
    assert float(aux["resid_transmittance"]) == pytest.approx(
        ref_frame["aux"]["resid_transmittance"], abs=1e-5)
    assert ref_frame["aux"]["live_pairs"] > 50_000
    _assert_frames_close(img.numpy(), ref_frame["img"])


@pytest.mark.parametrize("mode", list(MODES))
def test_band_seams_consistent(mode):
    """tests/test_tiled.py's seam criterion on the port's banded frame: the
    rows around a band seam (image rows 744 and 1488) are not systematically
    darker or brighter than their neighbours."""
    from fourdgs_torch.scenes.cube import build_cube_scene
    params = build_cube_scene(N, seed=SEED, device="cpu")
    params = {k: v * SCALE if k in ("px", "py", "pz") else v
              for k, v in params.items()}
    img = TP.render_params4d_packed(
        params, TCamera.create(**CAM, device="cpu"), 0.0,
        cfg=_tcfg(_cfg(mode))).numpy()
    assert np.isfinite(img).all()
    rows = img[..., :3].mean(axis=(1, 2))
    interior = rows[1:-1]
    neighbors = 0.5 * (rows[:-2] + rows[2:])
    assert np.all(np.abs(interior - neighbors) < 0.05 + 0.5 * neighbors)
    # And no more at the band seams than at the other tile-row boundaries
    # (each tile has its own prune cut, so every boundary shows a step).
    jump = np.abs(interior - neighbors)
    at = {lo: jump[lo * TILE_H - 2:lo * TILE_H + 1].max()
          for lo in range(1, H // TILE_H)}
    seams = [lo for lo, _ in BANDS[1:]]
    assert max(at[lo] for lo in seams) <= max(
        v for lo, v in at.items() if lo not in seams)
    assert rows.max() > 0.05                                   # covered


def test_banding_adds_nothing_below_the_limit():
    """A 256x128 frame binned and composited as two bands of eight tile
    rows equals the unbanded frame (no prune: the cut's sample would differ
    between a band and the whole image)."""
    from fourdgs_torch.scenes.cube import build_cube_scene
    w, h, scale = 256, 128, 0.15
    params = build_cube_scene(4000, seed=3, device="cpu")
    params = {k: v * scale if k in ("px", "py", "pz") else v
              for k, v in params.items()}
    cam = TCamera.create(**dict(
        CAM, position=tuple(420.0 * scale * x for x in (1.0, 300 / 420, 1.0)),
        width=w, height=h), device="cpu")
    cfg = _tcfg(_cfg("off", depth_prune_cap=0, sort_compact_keep_cols=512,
                     max_splats_per_tile=1024))
    proj = TP.project_params4d(params, cam, 0.0)
    whole = TP.render_projected(proj, cam, cfg)
    pm = cam.proj_matrix()
    px, py, (ny, nx) = TT.tile_pixel_ndc(w, h, TILE_H, TILE_W, device="cpu")
    tiles = []
    for band in ((0, 8), (8, ny - 8)):
        lo, nb = band
        binning = TT.bin_splats(
            proj, pm[0, 0], pm[1, 1], w, h, tile_h=TILE_H, tile_w=TILE_W,
            max_tiles_per_splat=cfg.max_tiles_per_splat, quantized_depth=True,
            compact_keep_cols=cfg.sort_compact_keep_cols,
            big_splat_budget=cfg.big_splat_budget, pallas_compact=True,
            compact_row_len=cfg.compact_row_len, tile_row_band=band)
        assert int(binning.compact_dropped) == 0
        tiles.append(TP._composite_pallas_progressive(
            proj, binning, px[lo * nx:(lo + nb) * nx],
            py[lo * nx:(lo + nb) * nx], pm[0, 0], pm[1, 1],
            torch.tensor(cfg.background), cfg, image_size=(w, h),
            tile_row_band=band)[0])
    banded = TT.assemble_image(torch.cat(tiles), w, h, TILE_H, TILE_W)
    err = (banded - whole).abs().amax(dim=-1)
    # Tied pairs blend in sort order, and a band's sort is another sort.
    assert float(err.mean()) < 1e-4 and float((err > 1e-3).float().mean()) \
        < 0.01
    assert float(whole[..., :3].mean()) > 0.05
