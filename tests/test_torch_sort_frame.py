"""Parity of the port's kernel-sorted binning and frame with the JAX
reference on the CPU: `bin_splats` under `pallas_sort` (the alternating
compaction and the merge, K11-K13) and under an unfused prune (K10), from
the reference's projection, and `render_params4d_packed` under
`sort_backend="pallas"`.

The reference's Pallas kernels run in interpret mode, as its own tests run
them (tests/test_sortpallas.py); the port runs its kernels' plain PyTorch
versions, chained by the launch schedule the card runs. Integers are
compared exactly, pairs as per-tile multisets; frames within the tie
tolerance of tests/test_torch_render.py.
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

# tests/test_sortpallas.py's scene and camera (the cube of seed 11 at 256x128;
# 8,000 splats, as its depth-prune test takes).
N, W, H = 8000, 256, 128
CAM = dict(position=(420.0, 300.0, 420.0), orientation=(-1.0, -0.7, -1.0),
           far=5000.0, width=W, height=H)


def _cfg(sort_backend="pallas", compact_backend="xla", prune_cap=0,
         keep=8192):
    """tests/test_sortpallas.py's configuration, with a keep that loses no
    pair at 8,000 splats."""
    from fourdgs.render.pipeline import RenderConfig
    return RenderConfig(tile_h=8, tile_w=128, backend="pallas",
                        max_splats_per_tile=256, max_tiles_per_splat=4,
                        splat_chunk=128, quantized_depth_sort=True,
                        sort_compact_keep_cols=keep,
                        big_splat_budget=16, big_splat_keep_cols=128,
                        deepening_passes=3, deepening_fraction=1.0,
                        sort_backend=sort_backend,
                        compact_backend=compact_backend,
                        depth_prune_cap=prune_cap)


BIN_CASES = {
    "merge": dict(sort_backend="pallas"),
    "merge+prune": dict(sort_backend="pallas", prune_cap=384),
    "merge+prune+rowsort-backend": dict(sort_backend="pallas",
                                        compact_backend="pallas",
                                        prune_cap=384),
    "standalone-cut": dict(sort_backend="xla", compact_backend="xla",
                           prune_cap=384),
}


@pytest.fixture(scope="module", params=list(BIN_CASES))
def ref_case(request):
    """The reference's stages for one configuration; the scene is scaled
    (as tests/test_torch_render.py scales it) so that tiles hold more pairs
    than the prune's rank of 2 * 384 and the cut really cuts."""
    cfg = _cfg(**BIN_CASES[request.param])
    cam = dict(CAM, position=tuple(0.15 * x for x in CAM["position"]))
    return request.param, reference_stages(cfg, n=N, w=W, h=H, cam_kw=cam,
                                           scale=0.15, seed=11)


def test_bin_splats_kernel_sorted_matches_reference(ref_case):
    name, ref = ref_case
    tb = TT.bin_splats(_tproj(ref), torch.tensor(ref["p00"]),
                       torch.tensor(ref["p11"]), W, H, **ref["bin_kw"])
    assert_binning_matches(tb, ref["binning"])
    rb = ref["binning"]
    if "prune" in name or "cut" in name:
        assert int(rb["tile_pruned"].sum()) > 0       # the cut really cut
        assert int(rb["compact_dropped"]) == 0
    if name.startswith("merge"):
        # The merged arrays keep the reference's padded length.
        assert tb.pair_splat.shape == rb["pair_splat"].shape
        assert tb.pair_splat.shape[0] >= 1 << 18


def test_composite_from_kernel_sorted_binning(ref_case):
    """The port's composite of the reference's kernel-sorted binning."""
    _, ref = ref_case
    cfg = TP.RenderConfig(**dataclasses.asdict(ref["cfg"]))
    binning = TT.TileBinning(**{k: None if v is None else torch.from_numpy(v)
                                for k, v in ref["binning"].items()})
    px, py, _ = TT.tile_pixel_ndc(W, H, cfg.tile_h, cfg.tile_w, device="cpu")
    tiles, resid = TP._composite_pallas_progressive(
        _tproj(ref), binning, px, py, torch.tensor(ref["p00"]),
        torch.tensor(ref["p11"]), torch.tensor(cfg.background), cfg)
    img = TT.assemble_image(tiles, W, H, cfg.tile_h, cfg.tile_w).numpy()
    np.testing.assert_allclose(img, ref["img"], rtol=0, atol=1e-5)
    assert float(resid.max()) == ref["resid"]


def test_frame_kernel_sorted_matches_reference(ref_case):
    """The slice as a whole: render_params4d_packed from params under each
    configuration against the reference's frame."""
    name, ref = ref_case
    cfg = TP.RenderConfig(**dataclasses.asdict(ref["cfg"]))
    cam = dict(CAM, position=tuple(0.15 * x for x in CAM["position"]),
               device="cpu")
    img, aux = TP.render_params4d_packed(
        params4d_from_numpy(ref["params"], "cpu"), TCamera.create(**cam),
        0.0, cfg=cfg, return_aux=True)
    rb = ref["binning"]
    assert int(aux["overflowed"]) == int(rb["overflowed"])
    assert int(aux["compact_dropped"]) == int(rb["compact_dropped"]) == 0
    assert int(aux["live_pairs"]) == int(rb["tile_start"][-1])
    assert int(aux["max_tile_pairs"]) == int(np.diff(rb["tile_start"]).max())
    if rb["prune_underkeep"] is not None:
        assert int(aux["prune_underkeep"]) == int(rb["prune_underkeep"])
    assert float(aux["resid_transmittance"]) == pytest.approx(ref["resid"],
                                                              abs=1e-5)
    img = img.numpy()
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
    err = np.abs(img - ref["img"]).max(axis=-1)
    assert float(err.mean()) < 1e-4
    assert float((err > 1e-3).mean()) < 0.01
    assert (ref["img"][..., :3].sum(-1) > 0.01).mean() > 0.15   # covered


def test_kernel_sorted_frame_matches_default_sort():
    """The port against itself: the merge-sorted frame and the globally
    sorted one bin the same pairs (tests/test_sortpallas.py's criterion)."""
    from fourdgs_torch.scenes.cube import build_cube_scene
    params = build_cube_scene(N, seed=11, device="cpu")
    cam = TCamera.create(**CAM, device="cpu")
    out = {}
    for backend in ("xla", "pallas"):
        cfg = TP.RenderConfig(**dataclasses.asdict(
            _cfg(sort_backend=backend, compact_backend="pallas")))
        out[backend] = TP.render_params4d_packed(params, cam, 0.0, cfg=cfg,
                                                 return_aux=True)
    (img_x, aux_x), (img_p, aux_p) = out["xla"], out["pallas"]
    for k in aux_x:
        assert float(aux_x[k]) == float(aux_p[k]), k
    assert int(aux_p["compact_dropped"]) == 0 and int(aux_p["live_pairs"]) > 0
    np.testing.assert_allclose(img_p.numpy(), img_x.numpy(), atol=1e-3)


def test_pallas_sort_refuses_other_keeps():
    ref_proj = TP.project_params4d(
        {k: torch.zeros(8) + (1.0 if k in ("qw", "sx", "sy", "sz", "lifetime")
                              else 0.0)
         for k in ("px", "py", "pz", "pt", "qw", "qx", "qy", "qz", "sx",
                   "sy", "sz", "lifetime", "fade", "vx", "vy", "vz", "cr",
                   "cg", "cb", "ca")},
        TCamera.create(width=64, height=64, device="cpu"), 0.0)
    with pytest.raises(ValueError, match="power-of-two"):
        TT.bin_splats(ref_proj, torch.tensor(1.0), torch.tensor(1.0), 64, 64,
                      tile_h=16, tile_w=64, quantized_depth=True,
                      compact_keep_cols=300, pallas_sort=True)
