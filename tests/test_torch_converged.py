"""Parity of the port's converged render slice with the JAX reference on the
CPU: `render_params4d_packed` under `auto_render_config(n, w, h)` (the
converged default: exact head plus the streaming banded-OIT tail).

The scene is the reference's `bench.build_cube_scene` (4,000 splats,
positions scaled by 0.15), Morton-ordered and dead-padded to 4,096 with the
reference's own scene-build functions, at 256x128 with `tail_chunk=1024` on
both sides, so the tail streams four chunks over several depth bands.

The reference runs as its own tests run it (Pallas interpret mode), with two
test-side substitutions, each scoped to the module fixture:
  * its converged head gathers through `pack_records(pack8=True)`, which
    cannot trace here (ROADMAP C-R1) and rounds head colors to bf16 (C-R2):
    `pack_records` is forced to pack8=False, the f32 gather the port has;
  * its tail kernel rounds the accumulated planes to bf16 (C-R5), an error
    of up to 7.9e-4 per pixel on this frame: the reference frame is computed
    twice, with its kernel and with its f32 twin `tail_accumulate_xla`.
The port runs its kernels' plain PyTorch versions (CPU tensors).

Stage by stage, on shared inputs:
  * morton_order + pad_packed_params: exact;
  * binning from the reference's projection, with the post-sort head re-cut:
    integers exact (head_counts and the re-cut prune_cut included), pairs of
    each tile equal as multisets (tied pairs sort in arbitrary order);
  * head + tail from the reference's binning: within 1e-4 of the f32-twin
    frame (measured 2.4e-7), within 2e-3 of the kernel frame (bf16 planes;
    measured 7.9e-4).
End to end, from params: counters equal, resid_transmittance 0 on both
sides, and the image differs only where tied head pairs blend in another
order (see test_converged_slice_matches_reference).
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
from fourdgs_torch.splats import packed as TPK  # noqa: E402

N, W, H, SCALE, CHUNK = 4000, 256, 128, 0.15, 1024
CAM = dict(position=(420.0 * SCALE, 300.0 * SCALE, 420.0 * SCALE),
           orientation=(-1.0, -0.7, -1.0), far=5000.0, width=W, height=H)
TCAM = dict(CAM, device="cpu")      # the port's camera, on the CPU
BIN_FIELDS = ("pair_splat", "pair_tile", "tile_start", "overflowed",
              "compact_dropped", "prune_underkeep", "tile_pruned",
              "prune_cut", "head_counts", "big_ids")


def _np(x):
    return np.array(x)


def _raw_params():
    from bench import build_cube_scene
    params = build_cube_scene(N)
    return {k: _np(v * SCALE if k in ("px", "py", "pz") else v)
            for k, v in params.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's projection, binning and converged frame, stage by
    stage as its render_params4d_packed composes them; the frame once with
    its tail kernel and once with its f32 twin."""
    from fourdgs.core.camera import Camera
    from fourdgs.ops import composite_pallas as CP
    from fourdgs.ops import tail_pallas as RTL
    from fourdgs.render import pipeline as RP
    from fourdgs.render import tiles as RT
    from fourdgs.render.autoconfig import auto_render_config
    from fourdgs.render.project import project_components
    from fourdgs.splats import packed as PK

    params = {k: jnp.asarray(v) for k, v in _raw_params().items()}
    params = PK.pad_packed_params(PK.morton_order(params), CHUNK)
    n = int(params["px"].shape[0])
    cam = Camera.create(**CAM)
    cfg = auto_render_config(n, W, H, tail_chunk=CHUNK)
    pm = _np(cam.proj_matrix())
    p00, p11 = pm[0, 0], pm[1, 1]
    bin_kw = dict(
        tile_h=cfg.tile_h, tile_w=cfg.tile_w,
        max_tiles_per_splat=cfg.max_tiles_per_splat, quantized_depth=True,
        compact_keep_cols=cfg.sort_compact_keep_cols,
        big_splat_budget=cfg.big_splat_budget,
        big_splat_keep_cols=cfg.big_splat_keep_cols, pallas_compact=True,
        compact_row_len=cfg.compact_row_len,
        depth_prune_cap=cfg.depth_prune_cap,
        depth_prune_safety=cfg.depth_prune_safety,
        head_cap=cfg.max_splats_per_tile)

    def stages(p):
        cov4 = PK.cov4_motion(p)
        mx, my, mz, cov3, op, sm = PK.slice4d(p, cov4, 0.0, 0.0)
        proj = project_components(mx, my, mz, cov3,
                                  (p["cr"], p["cg"], p["cb"], p["ca"]), op,
                                  cam, sort_mean=sm)
        binning = RT.bin_splats(proj, p00, p11, W, H, **bin_kw)
        px, py, _ = RT.tile_pixel_ndc(W, H, cfg.tile_h, cfg.tile_w)
        tiles, resid = RP._composite_pallas_progressive(
            proj, binning, px, py, p00, p11,
            jnp.asarray(cfg.background, jnp.float32), cfg,
            return_resid=True, image_size=(W, H))
        img = RT.assemble_image(tiles, W, H, cfg.tile_h, cfg.tile_w)
        return proj, binning, img, jnp.max(resid)

    pack_records = CP.pack_records
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CP, "pack_records",
                   lambda *a, pack8=False, **k: pack_records(*a, **k))
        # A fresh function per trace: jit caches by function identity.
        proj, binning, img, resid = jax.jit(lambda p: stages(p))(params)
        mp.setattr(RTL, "tail_accumulate",
                   lambda *a, slot_mask=None, interpret=None, **k:
                   RTL.tail_accumulate_xla(*a, **k))
        _, _, img_f32, resid_f32 = jax.jit(lambda p: stages(p))(params)
    return dict(params={k: _np(v) for k, v in params.items()}, cfg=cfg,
                p00=p00, p11=p11, bin_kw=bin_kw,
                proj={f.name: _np(getattr(proj, f.name))
                      for f in dataclasses.fields(proj)},
                binning={k: None if getattr(binning, k) is None
                         else _np(getattr(binning, k)) for k in BIN_FIELDS},
                img=_np(img), resid=float(resid), img_f32=_np(img_f32),
                resid_f32=float(resid_f32))


def _tproj(ref):
    return TProj(**{k: torch.from_numpy(v) for k, v in ref["proj"].items()})


def _pair_multiset(tile, splat, live):
    t, s = tile[:live], splat[:live]
    order = np.lexsort((s, t))
    return t[order], s[order]


def test_morton_order_and_pad_match_reference():
    from fourdgs.splats import packed as PK
    raw = _raw_params()
    want = PK.pad_packed_params(
        PK.morton_order({k: jnp.asarray(v) for k, v in raw.items()}), CHUNK)
    got = TPK.pad_packed_params(
        TPK.morton_order({k: torch.from_numpy(v) for k, v in raw.items()}),
        CHUNK)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]), err_msg=k)
    assert got["px"].shape == (4096,) and np.all(got["ca"].numpy()[N:] == 0)
    # The order really moved, and a second pad is a no-op.
    assert not np.array_equal(got["px"].numpy()[:N], raw["px"])
    assert TPK.pad_packed_params(got, CHUNK) is got


def test_morton_order_is_stable_on_ties():
    """Splats with one Morton code keep their input order (jnp.argsort is
    stable, and so is the port's)."""
    from fourdgs.splats import packed as PK
    rng = np.random.default_rng(0)
    raw = {k: rng.integers(0, 3, 600).astype(np.float32)
           for k in TPK.PARAM4D_FIELDS}
    raw["pt"] = np.arange(600, dtype=np.float32)          # input position
    want = PK.morton_order({k: jnp.asarray(v) for k, v in raw.items()})
    got = TPK.morton_order({k: torch.from_numpy(v) for k, v in raw.items()})
    np.testing.assert_array_equal(got["pt"].numpy(), _np(want["pt"]))


def test_converged_config_matches_reference():
    from fourdgs.render.autoconfig import auto_render_config
    want = auto_render_config(4096, W, H, tail_chunk=CHUNK)
    assert dataclasses.asdict(t_auto(4096, W, H, tail_chunk=CHUNK)) == \
        dataclasses.asdict(want)
    assert want.tail_mode == "banded" and want.tail_exact_clip


def test_bin_splats_head_recut_matches_reference(ref):
    rb = ref["binning"]
    tb = TT.bin_splats(_tproj(ref), torch.tensor(ref["p00"]),
                       torch.tensor(ref["p11"]), W, H, **ref["bin_kw"])
    for name in ("tile_start", "overflowed", "compact_dropped",
                 "prune_underkeep", "tile_pruned", "prune_cut",
                 "head_counts", "big_ids"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), rb[name],
                                      err_msg=name)
    live = int(rb["tile_start"][-1])
    got = _pair_multiset(tb.pair_tile.numpy(), tb.pair_splat.numpy(), live)
    want = _pair_multiset(rb["pair_tile"], rb["pair_splat"], live)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # The re-cut bounds the head and moved pairs to the tail.
    counts = np.diff(rb["tile_start"])
    head = rb["head_counts"]
    assert head.max() <= ref["cfg"].max_splats_per_tile < counts.max()
    assert int((head < counts).sum()) > 0


def test_composite_and_tail_from_reference_binning(ref):
    cfg = TP.RenderConfig(**dataclasses.asdict(ref["cfg"]))
    binning = TT.TileBinning(**{k: None if v is None else torch.from_numpy(v)
                                for k, v in ref["binning"].items()})
    px, py, _ = TT.tile_pixel_ndc(W, H, cfg.tile_h, cfg.tile_w,
                                  device="cpu")
    tiles, resid = TP._composite_pallas_progressive(
        _tproj(ref), binning, px, py, torch.tensor(ref["p00"]),
        torch.tensor(ref["p11"]), torch.tensor(cfg.background), cfg,
        image_size=(W, H))
    img = TT.assemble_image(tiles, W, H, cfg.tile_h, cfg.tile_w).numpy()
    np.testing.assert_allclose(img, ref["img_f32"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(img, ref["img"], rtol=0, atol=2e-3)
    assert float(resid.max()) == ref["resid"] == 0.0
    # The tail accumulated something: its planes' rounding shows.
    assert float(np.abs(ref["img_f32"] - ref["img"]).max()) > 1e-4


def test_converged_slice_matches_reference(ref):
    cfg = TP.RenderConfig(**dataclasses.asdict(ref["cfg"]))
    params = TPK.params4d_from_numpy(ref["params"], "cpu")
    img, aux = TP.render_params4d_packed(params, TCamera.create(**TCAM), 0.0,
                                         cfg=cfg, return_aux=True)
    rb = ref["binning"]
    for k in ("overflowed", "compact_dropped", "prune_underkeep"):
        assert int(aux[k]) == int(rb[k]), k
    assert int(aux["overflowed"]) == int(aux["compact_dropped"]) == 0
    assert int(aux["live_pairs"]) == int(rb["tile_start"][-1])
    assert int(aux["max_tile_pairs"]) == int(np.diff(rb["tile_start"]).max())
    assert float(aux["resid_transmittance"]) == ref["resid"] == 0.0
    img = img.numpy()
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
    # Pairs tied on (tile, 20-bit depth) blend in sort order, arbitrary on
    # both sides (C-R4); against the f32-twin frame the measured mean is
    # 5.4e-5 and 0.26% of pixels differ by more than 1e-3. The kernel frame
    # adds its bf16 planes (mean 4.2e-5 more, measured).
    for want, mean_tol in ((ref["img_f32"], 1e-4), (ref["img"], 2e-4)):
        err = np.abs(img - want).max(axis=-1)
        assert float(err.mean()) < mean_tol
        assert float((err > 1e-3).mean()) < 0.01
        assert float(np.abs(img[..., :3].mean() - want[..., :3].mean())) \
            < 1e-4
    assert (ref["img"][..., :3].sum(-1) > 0.01).mean() > 0.15   # covered
