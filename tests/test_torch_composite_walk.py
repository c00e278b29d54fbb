"""The record walk shared by the composite kernels K1 and K8
(fourdgs_torch/ops/csrc/composite_walk.cuh), in its plain PyTorch model
(fourdgs_torch/ops/composite_cuda.py), on the CPU.

  * The cull box is conservative: every (record, pixel) pair the coverage
    test (`_chunk_alpha`) covers lies inside the record's box, for
    adversarial records made with numpy from a seed (il = 0, v0 = 0,
    non-unit v0, 45-degree turns, footprints larger than the tile, centres on
    pixel centres and on the region's edges, NaN and inf fields) and for the
    records of a 20K-splat pass-1 frame binned from the reference's
    projection.
  * The culled walk changes no bit: `composite_plain` and
    `composite_bwd_plain` given the walk's mask (`composite_walk_keep`)
    equal the unmasked ones exactly.
  * The pixel maps are permutations of the tile, compact where the tile is
    row-major with a width of 32 x a divisor of the warps.
The kernels themselves run on the card (chip_smoke.py); their parity with the
reference is held by tests/test_torch_ops.py and tests/test_torch_grad.py.
"""

import numpy as np
import pytest
import torch

from fourdgs_torch.ops import composite_cuda as C
from fourdgs_torch.render import tiles as TT

SHAPES = [(256, 16), (512, 64), (1024, 64), (2048, 128), (4096, 128)]


def _tile_coords(p, tile_w, p00=1.4, p11=2.3, tiles=1):
    """kx, ky (tiles, 1, p) of the first tiles of a 512-wide image whose
    tiles are p / tile_w rows by tile_w columns, in k units."""
    tile_h = p // tile_w
    px, py, _ = TT.tile_pixel_ndc(512, 8 * tile_h, tile_h, tile_w,
                                  device="cpu")
    return ((px[:tiles] / p00)[:, None].contiguous(),
            (py[:tiles] / p11)[:, None].contiguous())


@pytest.mark.parametrize("max_ppt", [C.K1_PPT, C.K8_PPT])
@pytest.mark.parametrize("p,tile_w", SHAPES)
def test_pixel_maps_are_permutations(p, tile_w, max_ppt):
    threads, ppt = C.walk_shape(p, max_ppt)
    assert threads * ppt == p and ppt <= max_ppt and threads <= 1024
    _, ky = _tile_coords(p, tile_w)
    tw = int(C.walk_tile_width(ky, threads)[0])
    compact = tile_w % 32 == 0 and (threads // 32) % (tile_w // 32) == 0
    assert tw == (tile_w if compact else 0)
    pix = C.walk_pixel_map(p, tw, max_ppt)
    assert pix.shape == (threads // 32, 32 * ppt)
    assert torch.equal(torch.sort(pix.reshape(-1)).values, torch.arange(p))
    if compact:
        # A warp owns 32 adjacent columns of PPT adjacent rows.
        rows, cols = pix // tile_w, pix % tile_w
        assert bool(((cols.amax(1) - cols.amin(1)) == 31).all())
        assert bool(((rows.amax(1) - rows.amin(1)) == ppt - 1).all())


def test_tile_width_falls_back_to_the_strided_map():
    """A tile that is not row-major (or too narrow) takes the strided map,
    which is still a permutation: the walk stays exact, only the cull is
    weaker."""
    rng = np.random.default_rng(3)
    ky = torch.from_numpy(rng.standard_normal((2, 1, 2048)).astype(
        np.float32))
    assert C.walk_tile_width(ky, 512).tolist() == [0, 0]
    _, ky16 = _tile_coords(256, 16)
    assert int(C.walk_tile_width(ky16, 256)[0]) == 0


def _adversarial_records(rng, kx, ky, m):
    """(1, 16, m) records aimed at the pixels kx, ky (1, 1, P): random
    footprints of every size, non-unit and axis-aligned v0, 45-degree turns,
    centres on pixel centres and on the region's edges, il = 0, v0 = 0, tiny
    and huge values, NaN and inf fields."""
    x, y = kx.reshape(-1).numpy(), ky.reshape(-1).numpy()
    lo_x, hi_x, lo_y, hi_y = x.min(), x.max(), y.min(), y.max()
    span = max(hi_x - lo_x, hi_y - lo_y)
    f = np.zeros((16, m), np.float32)
    f[0] = rng.uniform(lo_x - 0.3 * span, hi_x + 0.3 * span, m)
    f[1] = rng.uniform(lo_y - 0.3 * span, hi_y + 0.3 * span, m)
    ang = rng.uniform(0, 2 * np.pi, m)
    f[2], f[3] = np.cos(ang), np.sin(ang)
    scale = 10.0 ** rng.uniform(-4.5, 0.5, (2, m))       # footprint, k units
    f[4], f[5] = 1.0 / scale
    f[6:9] = rng.uniform(0, 1, (3, m))
    f[9] = rng.uniform(0.1, 1.0, m)
    q = m // 8
    # Non-unit v0 (the kernels never normalise it).
    s = 10.0 ** rng.uniform(-3, 3, q)
    f[2, :q] *= s
    f[3, :q] *= s
    # 45-degree turns, centres on pixel centres.
    at = rng.integers(0, x.size, q)
    f[0, q:2 * q], f[1, q:2 * q] = x[at], y[at]
    turn = np.pi / 4 + np.pi / 2 * rng.integers(0, 4, q)
    f[2, q:2 * q], f[3, q:2 * q] = np.cos(turn), np.sin(turn)
    # Axis-aligned, a pixel on the edge |n0| = 0.5 (and |n1| = 0.5).
    at = rng.integers(0, x.size, q)
    l0 = (10.0 ** rng.uniform(-3.5, -1, q)).astype(np.float32)
    sign = rng.choice([-1.0, 1.0], q).astype(np.float32)
    f[2, 2 * q:3 * q], f[3, 2 * q:3 * q] = sign, 0.0
    f[4, 2 * q:3 * q] = 1.0 / l0
    f[0, 2 * q:3 * q] = x[at] - np.float32(0.5) * l0 * rng.choice([-1, 1], q)
    f[1, 2 * q:3 * q] = y[at] + np.float32(0.5) * f[5, 2 * q:3 * q] ** -1 \
        * rng.choice([-1, 1, 0], q)
    # Footprints larger than the tile.
    f[4:6, 3 * q:4 * q] = 1.0 / rng.uniform(span, 4 * span, (2, q))
    # il = 0 (l == 0 in the pack) on one or both axes: unbounded.
    f[4, 4 * q:4 * q + q // 2] = 0.0
    f[5, 4 * q + q // 4:5 * q] = 0.0
    # v0 = 0: every pixel covered.
    f[2:4, 5 * q:5 * q + q // 2] = 0.0
    # Tiny and huge values.
    f[2:4, 5 * q + q // 2:6 * q] *= 1e-19
    f[4, 6 * q:6 * q + q // 2] = 1e30
    f[4:6, 6 * q + q // 2:7 * q] = 1e-30
    # NaN and inf, one field at a time.
    for i, k in enumerate(range(7 * q, m)):
        field = i % 6
        f[field, k] = [np.nan, np.inf, -np.inf][(i // 6) % 3]
    return torch.from_numpy(f)[None]


def _uncovered_misses(records, kx, ky):
    """Pairs the coverage test covers whose pixel lies outside the record's
    box (each pixel taken as a patch of its own), and the covered count."""
    boxes = C.composite_cull_boxes(records)
    inside = C.walk_warp_hits(boxes, kx, ky,
                              torch.arange(kx.shape[-1])[:, None])
    bad = covered = 0
    for c0 in range(0, records.shape[2], C.CHUNK):
        cols = slice(c0, c0 + C.CHUNK)
        cover = C._chunk_alpha(records[:, :, cols], kx, ky)[7]
        bad += int((cover & ~inside[:, cols]).sum())
        covered += int(cover.sum())
    return bad, covered


@pytest.mark.parametrize("p,tile_w", [(512, 64), (2048, 128)])
def test_cull_box_is_conservative_on_adversarial_records(p, tile_w):
    rng = np.random.default_rng(p)
    kx, ky = _tile_coords(p, tile_w)
    rec = _adversarial_records(rng, kx, ky, 1024)
    bad, covered = _uncovered_misses(rec, kx, ky)
    assert bad == 0
    assert covered > 10_000
    boxes = C.composite_cull_boxes(rec)
    # The unbounded cases are unbounded; most records are bounded.
    assert bool(torch.isinf(boxes[0, :, 4 * 128:4 * 128 + 128]).all())
    assert float(torch.isfinite(boxes).all(1).float().mean()) > 0.6


def _synthetic_tiles(rng, t_tiles, m, p, tile_w):
    """Records of many small footprints over the tiles, counts below M with
    a_eff = 0 past the count (as the pack makes them), a carry with T in
    (0.3, 1] and a cotangent."""
    kx, ky = _tile_coords(p, tile_w, tiles=t_tiles)
    f = np.zeros((t_tiles, 16, m), np.float32)
    x, y = kx[:, 0].numpy(), ky[:, 0].numpy()
    f[:, 0] = rng.uniform(x.min(1, keepdims=True) - 0.01,
                          x.max(1, keepdims=True) + 0.01, (t_tiles, m))
    f[:, 1] = rng.uniform(y.min(1, keepdims=True) - 0.01,
                          y.max(1, keepdims=True) + 0.01, (t_tiles, m))
    ang = rng.uniform(0, 2 * np.pi, (t_tiles, m))
    f[:, 2], f[:, 3] = np.cos(ang), np.sin(ang)
    f[:, 4:6] = 1.0 / (10.0 ** rng.uniform(-2.3, -1.3, (t_tiles, 2, m)))
    f[:, 6:9] = rng.uniform(0, 1, (t_tiles, 3, m))
    counts = rng.integers(m // 3, m + 1, t_tiles).astype(np.int32)
    counts[0] = m
    f[:, 9] = rng.uniform(0.2, 0.95, (t_tiles, m)) * (
        np.arange(m)[None] < counts[:, None])
    carry = C.identity_carry(t_tiles, p, device="cpu")
    carry[:, 0:4] = torch.from_numpy(
        rng.uniform(0, 0.2, (t_tiles, 4, p)).astype(np.float32))
    carry[:, 4] = torch.from_numpy(
        rng.uniform(0.3, 1.0, (t_tiles, p)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((t_tiles, 8, p)).astype(
        np.float32))
    return torch.from_numpy(f), torch.from_numpy(counts), kx, ky, carry, g


@pytest.mark.parametrize("p,tile_w", [(512, 64), (2048, 128)])
def test_culled_walk_equals_plain_exactly(p, tile_w):
    rng = np.random.default_rng(p + 1)
    rec, counts, kx, ky, carry, g = _synthetic_tiles(rng, 4, 256, p, tile_w)
    keep1 = C.composite_walk_keep(rec, kx, ky, C.K1_PPT, counts)
    keep8 = C.composite_walk_keep(rec, kx, ky, C.K8_PPT)
    # The walk skips most pairs, and the covered ones are all kept.
    assert float(keep1.float().mean()) < 0.5
    assert float(keep8.float().mean()) < 0.5
    out = C.composite_plain(rec, counts, kx, ky, carry)
    assert torch.equal(C.composite_plain(rec, counts, kx, ky, carry,
                                         keep=keep1), out)
    assert float(out[:, 3].max()) > 0.05                  # real coverage
    d = C.composite_bwd_plain(rec, counts, kx, ky, carry, out, g)
    assert torch.equal(C.composite_bwd_plain(rec, counts, kx, ky, carry, out,
                                             g, keep=keep8), d)
    assert float(d[:, 9].abs().max()) > 0


def test_deepest_first_is_a_stable_descending_order():
    """K1 and K8 take their items by descending count, ties in index order;
    the order decides only which tiles start first."""
    counts = torch.tensor([3, 384, 0, 128, 384, 7, 0], dtype=torch.int32)
    order = C.deepest_first(counts)
    assert order.dtype == torch.int64
    assert order.tolist() == [1, 4, 3, 5, 0, 2, 6]


class _Captured(Exception):
    pass


def test_cull_box_is_conservative_on_a_frame():
    """The records a 20K-splat non-converged frame hands K1 in pass 1, from
    the reference's projection binned by the port: every covered pair lies
    in its record's box, and the walk's mask changes no bit of pass 1."""
    jax = pytest.importorskip("jax")
    from bench import build_cube_scene
    from fourdgs.core.camera import Camera
    from fourdgs.render.project import project_components
    from fourdgs.splats import packed as PK

    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.render.project import Projected

    n, w, h = 20_000, 256, 128
    cam_kw = dict(position=(63.0, 45.0, 63.0), orientation=(-1.0, -0.7, -1.0),
                  far=5000.0, width=w, height=h)
    params = {k: v * 0.15 if k in ("px", "py", "pz") else v
              for k, v in build_cube_scene(n, seed=0).items()}
    cam = Camera.create(**cam_kw)

    @jax.jit
    def project(p):
        cov4 = PK.cov4_motion(p)
        mx, my, mz, cov3, op, sm = PK.slice4d(p, cov4, 0.0, 0.0)
        return project_components(mx, my, mz, cov3,
                                  (p["cr"], p["cg"], p["cb"], p["ca"]), op,
                                  cam, sort_mean=sm)
    ref = project(params)
    proj = Projected(**{k: torch.from_numpy(np.array(getattr(ref, k)))
                        for k in Projected.__dataclass_fields__})
    pm = np.array(cam.proj_matrix())
    p00, p11 = torch.tensor(pm[0, 0]), torch.tensor(pm[1, 1])
    cfg = auto_render_config(n, w, h, converged=False)
    binning = TT.bin_splats(
        proj, p00, p11, w, h, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
        max_tiles_per_splat=cfg.max_tiles_per_splat, quantized_depth=True,
        compact_keep_cols=cfg.sort_compact_keep_cols,
        big_splat_budget=cfg.big_splat_budget,
        big_splat_keep_cols=cfg.big_splat_keep_cols, pallas_compact=True,
        compact_row_len=cfg.compact_row_len,
        depth_prune_cap=cfg.depth_prune_cap,
        depth_prune_safety=cfg.depth_prune_safety)
    px, py, _ = TT.tile_pixel_ndc(w, h, cfg.tile_h, cfg.tile_w, device="cpu")
    seen = []

    def record(*args):
        seen.append(args)
        raise _Captured
    original, TP.composite_records = TP.composite_records, record
    try:
        with pytest.raises(_Captured):
            TP._composite_pallas_progressive(
                proj, binning, px, py, p00, p11,
                torch.tensor(cfg.background), cfg, image_size=(w, h))
    finally:
        TP.composite_records = original
    rec, counts, kx, ky, carry = seen[0]
    assert int(counts.max()) > C.CHUNK                  # deep tiles
    bad, covered = _uncovered_misses(rec, kx, ky)
    assert bad == 0 and covered > 50_000
    keep = C.composite_walk_keep(rec, kx, ky, C.K1_PPT, counts)
    assert float(keep.float().mean()) < 0.2
    assert torch.equal(C.composite_plain(rec, counts, kx, ky, carry,
                                         keep=keep),
                       C.composite_plain(rec, counts, kx, ky, carry))
