"""Tile-row banding of the port against the JAX reference on the CPU: images
of 2047 tiles or more are binned and composited one band of tile rows at a
time, with band-relative tile ids.

The image is tests/test_tiled.py's banding case, 1408x1536 at 8x64 tiles
(192 x 22 = 4,224 tiles, bands of 93, 93 and 6 tile rows); the scene is the
reference's cube (12,000 splats scaled by 0.3, a prune cap of 16 so that the
cut really cuts and the tail has pairs to composite), handed over through
numpy. Binnings are compared from the reference's projection, integers
exact and pairs as per-tile multisets; frames within the tie tolerance of
tests/test_torch_render.py. The reference's converged banded frame takes
minutes in interpret mode, so the port's converged frame is held against
the port's own head and tail composed band by band from the reference's
binnings. The whole frames against the reference, the seams and the
banding of a small image are in tests/test_torch_banding_frame.py (a file of
its own, so that the two run side by side).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from fourdgs_torch.core.camera import Camera as TCamera  # noqa: E402
from fourdgs_torch.render import pipeline as TP  # noqa: E402
from fourdgs_torch.render import tiles as TT  # noqa: E402
from fourdgs_torch.splats.packed import params4d_from_numpy  # noqa: E402
from test_torch_render import (  # noqa: E402
    _tproj, assert_binning_matches, reference_stages)

N, W, H, SCALE, SEED = 12_000, 1408, 1536, 0.3, 5
TILE_H, TILE_W = 8, 64
CAM = dict(position=(420.0 * SCALE, 300.0 * SCALE, 420.0 * SCALE),
           orientation=(-1.0, -0.7, -1.0), far=5000.0, width=W, height=H)
BANDS = ((0, 93), (93, 93), (186, 6))
MODES = {
    "off": {},
    "banded": dict(tail_mode="banded", tail_bands=8, tail_block=(8, 8),
                   tail_chunk=256, tail_exact_clip=True,
                   depth_prune_safety=1.2),
}


def _cfg(mode, **overrides):
    from fourdgs.render.pipeline import RenderConfig
    kw = dict(tile_h=TILE_H, tile_w=TILE_W, backend="pallas",
              max_splats_per_tile=128, max_tiles_per_splat=16,
              quantized_depth_sort=True, sort_compact_keep_cols=256,
              compact_backend="pallas", compact_row_len=512,
              big_splat_budget=64, big_splat_keep_cols=128,
              depth_prune_cap=16, depth_prune_safety=2.0,
              deepening_passes=1)
    kw.update(MODES[mode])
    kw.update(overrides)
    return RenderConfig(**kw)


def _tcfg(cfg):
    return TP.RenderConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=list(MODES))
def ref_bands(request):
    """The reference's projection and its binning of each band."""
    return reference_stages(_cfg(request.param), n=N, w=W, h=H, cam_kw=CAM,
                            scale=SCALE, seed=SEED, bands=BANDS,
                            composite=False)


def test_band_split_matches_reference():
    ny, nx = TT.tile_grid(W, H, TILE_H, TILE_W)
    assert ny * nx >= TT.TILE_LIMIT                 # the banding regime
    rows = max(1, TT.TILE_LIMIT // nx)
    assert tuple((lo, min(rows, ny - lo)) for lo in range(0, ny, rows)) \
        == BANDS


@pytest.mark.parametrize("band", range(len(BANDS)))
def test_bin_splats_band_matches_reference(ref_bands, band):
    rb = ref_bands["binnings"][band]
    tb = TT.bin_splats(_tproj(ref_bands), torch.tensor(ref_bands["p00"]),
                       torch.tensor(ref_bands["p11"]), W, H,
                       tile_row_band=BANDS[band], **ref_bands["bin_kw"])
    assert_binning_matches(tb, rb, min_live=5000 if band < 2 else 10)
    nx = TT.tile_grid(W, H, TILE_H, TILE_W)[1]
    assert tb.tile_start.shape == (BANDS[band][1] * nx + 1,)
    if band < 2:
        assert int(rb["tile_pruned"].sum()) > 0    # the cut really cut


def test_unbanded_binning_past_the_limit_raises(ref_bands):
    with pytest.raises(ValueError, match="tile-row bands"):
        TT.bin_splats(_tproj(ref_bands), torch.tensor(ref_bands["p00"]),
                      torch.tensor(ref_bands["p11"]), W, H,
                      **ref_bands["bin_kw"])


def _port_frame(params, cfg):
    return TP.render_params4d_packed(
        params4d_from_numpy(params, "cpu"),
        TCamera.create(**CAM, device="cpu"), 0.0, cfg=_tcfg(cfg),
        return_aux=True)


def _assert_counters_close(aux, want):
    """Counters of a frame from params: the port's own float32 projection
    rounds a few bbox edges of this scene's ~105,000 pairs to the other
    side of a tile boundary (measured: 2 pairs), so the pair counters agree
    within 5 where the binning from one projection is exact."""
    assert int(aux["compact_dropped"]) == want["compact_dropped"] == 0
    for k in ("overflowed", "prune_underkeep", "live_pairs",
              "max_tile_pairs"):
        assert abs(int(aux[k]) - want[k]) <= 5, (k, int(aux[k]), want[k])


def _assert_frames_close(img, want):
    assert img.shape == want.shape == (H, W, 4) and np.isfinite(img).all()
    err = np.abs(img - want).max(axis=-1)
    assert float(err.mean()) < 1e-4
    assert float((err > 1e-3).mean()) < 0.01
    assert float(np.abs(img[..., :3].mean() - want[..., :3].mean())) < 1e-4
    assert (want[..., :3].sum(-1) > 0.01).mean() > 0.15        # covered


def _compose_bands(ref, cfg):
    """Head (and tail) of every band from the reference's projection and
    binnings, composed as render_projected composes them."""
    proj = _tproj(ref)
    p00, p11 = torch.tensor(ref["p00"]), torch.tensor(ref["p11"])
    px, py, (_, nx) = TT.tile_pixel_ndc(W, H, TILE_H, TILE_W, device="cpu")
    tiles, resid = [], []
    for band, rb in zip(BANDS, ref["binnings"]):
        binning = TT.TileBinning(**{
            k: None if v is None else torch.from_numpy(v)
            for k, v in rb.items()})
        lo, nb = band
        t, r = TP._composite_pallas_progressive(
            proj, binning, px[lo * nx:(lo + nb) * nx],
            py[lo * nx:(lo + nb) * nx], p00, p11,
            torch.tensor(cfg.background), cfg, image_size=(W, H),
            tile_row_band=band)
        tiles.append(t)
        resid.append(float(r.max()))
    return TT.assemble_image(torch.cat(tiles), W, H, TILE_H, TILE_W), \
        max(resid)


def test_frame_composes_from_reference_binnings(ref_bands):
    """The port's frame from params (its own projection, binning and band
    loop) against its head and tail of the reference's band binnings; in
    converged mode the tail composites what the prune cut."""
    cfg = _tcfg(ref_bands["cfg"])
    want, resid = _compose_bands(ref_bands, cfg)
    img, aux = _port_frame(ref_bands["params"], ref_bands["cfg"])
    rbs = ref_bands["binnings"]
    want_aux = {k: sum(int(rb[k]) for rb in rbs)
                for k in ("overflowed", "compact_dropped", "prune_underkeep")}
    want_aux["live_pairs"] = sum(int(rb["tile_start"][-1]) for rb in rbs)
    want_aux["max_tile_pairs"] = max(int(np.diff(rb["tile_start"]).max())
                                     for rb in rbs)
    _assert_counters_close(aux, want_aux)
    assert float(aux["resid_transmittance"]) == pytest.approx(resid, abs=1e-5)
    if cfg.tail_mode == "banded":
        # With the tail, pruned pairs are composited, not dropped.
        assert resid == 0.0
        head_only, _ = _compose_bands(
            ref_bands, dataclasses.replace(cfg, tail_mode="off"))
        assert float((want - head_only)[..., :3].mean()) > 1e-3
    _assert_frames_close(img.numpy(), want.numpy())
