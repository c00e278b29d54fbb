"""The quantized binning's pair-slot emission kernel (K16, `ops/emit_cuda`).

CPU: quantized_pair_keys on CPU tensors, and its plain version, equal the
composition the binning used before K16 (splat_tile_bbox,
clip_to_tile_row_band, _emit_pair_slots, quantized_depth_bits, _pair_keys,
the big tier's id compaction, gather and concatenations) bit for bit, at a
1080p-like grid and at both bands of a two-band grid, with and without the
big tier and a tile window, on both id compactions; K16's two launches
written out in plain PyTorch (the band and the window of a launch without
them, the slot-major arrays with the big tier's slots after the main tier's,
the overflow count) give the same; big_tier_slots is the length of the ids
big_tier_ids keeps; the wrappers raise on what the kernel does not take;
their ctypes signature matches the kernel's C entry.

Card (tests marked `card`, skipped without a CUDA device; this file imports
no JAX, so on the card run `python -m pytest --noconftest -q
tests/test_torch_emit_kernel.py`): K16 against the plain version on the
card at 1M splats over 8 orbit poses at 1920x1088 and at both bands of
3840x2160, keys, splat indices, the is-big flag, the big tier's ids and the
overflow count bit-equal; odd lengths and fields off 16 bytes; a tile
window; tile sizes that are not powers of two; one tier alone; one main and
one big-tier launch a band of a frame.
"""

import ctypes
import math
import re
from pathlib import Path

import pytest
import torch

from fourdgs_torch.core.camera import Camera
from fourdgs_torch.ops import emit_cuda as EC
from fourdgs_torch.ops.sort_cuda import DEAD
from fourdgs_torch.render import pipeline as TP
from fourdgs_torch.render import tiles as T
from fourdgs_torch.scenes.cube import CUBE_CAMERA, build_cube_scene


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K16 has no CPU form")
    return torch.device("cuda", 0)


def orbit_camera(i, n_poses, device, width, height):
    """Pose i of n_poses about the vertical axis, the benchmark's camera."""
    a = 2.0 * math.pi * i / n_poses
    c, s = math.cos(a), math.sin(a)

    def turn(v):
        return (v[0] * c + v[2] * s, v[1], -v[0] * s + v[2] * c)
    return Camera.create(position=turn(CUBE_CAMERA["position"]),
                         orientation=turn(CUBE_CAMERA["orientation"]),
                         far=CUBE_CAMERA["far"], width=width, height=height,
                         device=device)


def projected(n, seed, camera, t=0.3):
    """The cube scene of n splats, projected (K15 on the card)."""
    params = build_cube_scene(n, seed=seed, device=camera.device)
    proj = TP.project_params4d(params, camera, t)
    pmat = camera.proj_matrix()
    return proj, pmat[0, 0], pmat[1, 1]


def composition(proj, p00, p11, width, height, tile_h, tile_w, budget,
                big_budget=0, keep=128, band=None, window=None):
    """quantized_pair_keys as the binning composed it before K16."""
    ny, nx = T.tile_grid(width, height, tile_h, tile_w)
    alive, tx0, tx1, ty0, ty1 = T.splat_tile_bbox(proj, p00, p11, width,
                                                  height, tile_h, tile_w)
    if band is not None:
        alive, ty0, ty1, ny = T.clip_to_tile_row_band(alive, ty0, ty1, band)
    num_tiles = ny * nx
    if big_budget:
        span = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
        is_big = alive & (span > budget)
        alive1 = alive & ~is_big
    else:
        alive1 = alive
    tids, lives, splat_idx, overflowed = T._emit_pair_slots(
        alive1, tx0, tx1, ty0, ty1, nx, num_tiles, budget, tile_range=window)
    dbits = T.quantized_depth_bits(proj.depth)
    key = T._pair_keys(tids, lives, dbits)
    if not big_budget:
        return key, splat_idx, overflowed, None
    n = alive.shape[0]
    if n % 1024 == 0 and n >= 128 * 1024:
        ids, big_dropped = T.compact_flag_ids(is_big)
    else:
        bk0 = torch.where(is_big, torch.arange(n, dtype=torch.int32), DEAD)
        ids, _, big_dropped = T.compact_pairs(bk0, bk0, DEAD, keep)
        ids, _, big_dropped2 = T.compact_pairs(ids, ids, DEAD, 4 * keep)
        big_dropped = big_dropped + big_dropped2
    blive = ids != DEAD
    safe = torch.clamp(ids, max=n - 1).long()
    btx0, btx1, bty0, bty1, dbits_b, span_b = torch.stack(
        [tx0, tx1, ty0, ty1, dbits, span])[:, safe]
    tidsb, livesb, sidxb, _ = T._emit_pair_slots(
        blive, btx0, btx1, bty0, bty1, nx, num_tiles, big_budget,
        splat_ids=safe, tile_range=window)
    key = torch.cat([key, T._pair_keys(tidsb, livesb, dbits_b)])
    splat_idx = torch.cat([splat_idx, sidxb])
    overflowed = ((blive & (span_b > big_budget)).sum(dtype=torch.int32)
                  + big_dropped)
    return key, splat_idx, overflowed, ids


def k16_walk(proj, p00, p11, width, height, tile_h, tile_w, budget,
             big_budget=0, keep=128, band=None, window=None):
    """K16's two launches written out in plain PyTorch (`csrc/emit.cu`): the
    band clip and the window applied always, with the whole grid and every
    band tile where none is given; each launch writes its `nslots` slots an
    entry slot-major into preallocated arrays, the big tier's after the
    main tier's; an entry overflows where it is live and its span passes
    its launch's budget, and the main launch's live splats that overflow
    with a big tier are big instead. Returns (key, splat_idx, overflowed,
    ids, is_big)."""
    ny, nx = T.tile_grid(width, height, tile_h, tile_w)
    ty_base, rows = band if band is not None else (0, ny)
    lo, n_local = window if window is not None else (0, rows * nx)
    n = proj.count
    big_slots = T.big_tier_slots(n, keep) if big_budget else 0
    key = torch.full((budget * n + big_budget * big_slots,), -7,
                     dtype=torch.int32)
    splat_idx = key.clone()
    alive, tx0, tx1, ty0, ty1 = T.splat_tile_bbox(proj, p00, p11, width,
                                                  height, tile_h, tile_w)
    alive = alive & (ty1 >= ty_base) & (ty0 < ty_base + rows)
    ty0 = torch.clamp(ty0 - ty_base, 0, rows - 1)
    ty1 = torch.clamp(ty1 - ty_base, 0, rows - 1)
    nx_span, ny_span = tx1 - tx0 + 1, ty1 - ty0 + 1
    span = nx_span * ny_span
    dbits = T.quantized_depth_bits(proj.depth)

    def launch(sid, live, nslots, first):
        m = sid.shape[0]
        sx = torch.zeros(m, dtype=torch.int32)
        sy = torch.zeros(m, dtype=torch.int32)
        for s in range(nslots):
            tid = (ty0[sid] + sy) * nx + (tx0[sid] + sx)
            on = (live & (s < span[sid]) & (sy < ny_span[sid])
                  & (tid >= lo) & (tid < lo + n_local))
            at = slice(first + s * m, first + (s + 1) * m)
            key[at] = torch.where(on, (tid << T.QUANT_DEPTH_BITS)
                                  | dbits[sid], DEAD)
            splat_idx[at] = sid.to(torch.int32)
            sx = sx + 1
            wrap = sx >= nx_span[sid]
            sx = torch.where(wrap, 0, sx)
            sy = torch.where(wrap, sy + 1, sy)
        return (live & (span[sid] > nslots)).sum(dtype=torch.int32)

    over = alive & (span > budget)
    is_big = over if big_budget else torch.zeros_like(over)
    count = launch(torch.arange(n), alive & ~is_big, budget, 0)
    if not big_budget:
        return key, splat_idx, count, None, is_big
    ids, dropped = T.big_tier_ids(is_big, keep)
    count = launch(torch.clamp(ids, max=n - 1).long(), ids != DEAD,
                   big_budget, budget * n)
    return key, splat_idx, dropped + count, ids, is_big


def assert_same(got, want, what=""):
    names = ("key", "splat_idx", "overflowed", "ids")
    for name, g, w in zip(names, got, want):
        assert (g is None) == (w is None), (what, name)
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
            assert torch.equal(g.cpu(), w.cpu()), (what, name)


# (name, n, width, height, tile_h, tile_w, budget, big_budget, band, window):
# small tiles and budgets, so that the cube's splats at these sizes fill both
# tiers and overflow both.
CPU_CASES = [
    ("1080p-like", 131_072, 960, 544, 8, 32, 2, 4, None, None),
    ("1080p-like small", 5_000, 960, 544, 8, 32, 2, 4, None, None),
    ("one tier", 5_000, 960, 544, 8, 32, 2, 0, None, None),
    ("band 0", 131_072, 1920, 1088, 8, 32, 2, 4, (0, 34), None),
    ("band 1", 131_072, 1920, 1088, 8, 32, 2, 4, (34, 34), None),
    ("window", 5_000, 960, 544, 8, 32, 2, 4, None, (300, 500)),
    ("band 1 window one tier", 5_000, 1920, 1088, 8, 32, 2, 0, (34, 34),
     (200, 900)),
]


def cpu_case(case):
    _, n, w, h, th, tw, budget, big, band, window = case
    cam = orbit_camera(3, 8, "cpu", w, h)
    proj, p00, p11 = projected(n, seed=5, camera=cam)
    return (proj, p00, p11, w, h, th, tw, budget, big, 128, band, window)


@pytest.mark.parametrize("case", CPU_CASES, ids=[c[0] for c in CPU_CASES])
def test_plain_equals_the_composition(case):
    args = cpu_case(case)
    want = composition(*args)
    for got in (T.quantized_pair_keys(*args),
                T.quantized_pair_keys_plain(*args)):
        assert_same(got, want, case[0])
    # Both tiers emit pairs, and the count has splats to count.
    key, _, overflowed, ids = want
    assert int((key[:case[1] * case[6]] != DEAD).sum()) > 0
    assert ids is None or int((key[case[1] * case[6]:] != DEAD).sum()) > 0
    assert int(overflowed) > 0


@pytest.mark.parametrize("case", CPU_CASES, ids=[c[0] for c in CPU_CASES])
def test_kernel_walk_equals_plain(case):
    args = cpu_case(case)
    key, splat_idx, overflowed, ids, is_big = k16_walk(*args)
    assert_same((key, splat_idx, overflowed, ids),
                T.quantized_pair_keys_plain(*args), case[0])
    assert int((key == -7).sum()) == 0          # every slot written once
    if case[7]:
        proj, p00, p11, w, h, th, tw, budget = args[:8]
        alive, tx0, tx1, ty0, ty1 = T.splat_tile_bbox(proj, p00, p11, w, h,
                                                      th, tw)
        if case[8] is not None:
            alive, ty0, ty1, _ = T.clip_to_tile_row_band(alive, ty0, ty1,
                                                         case[8])
        span = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
        assert torch.equal(is_big, alive & (span > budget))


@pytest.mark.parametrize("n", [1, 1_000, 8_193, 100_000, 131_072, 131_073,
                               10_010_624])
@pytest.mark.parametrize("keep", [128, 64])
def test_big_tier_slots_is_the_ids_length(n, keep):
    is_big = torch.zeros(n, dtype=torch.bool, device="meta")
    if n % 1024 == 0 and n >= 128 * 1024:
        is_big = torch.zeros(n, dtype=torch.bool)
        is_big[::977] = True
    ids, _ = T.big_tier_ids(is_big, keep)
    assert ids.shape == (T.big_tier_slots(n, keep),)


def _meta_proj(n=64):
    proj, _, _ = projected(n, seed=1, camera=orbit_camera(0, 8, "cpu",
                                                          256, 128))
    return proj.map(lambda a: torch.empty_like(a, device="meta"))


def test_wrappers_raise_on_what_the_kernel_does_not_take():
    proj = _meta_proj()
    p = torch.ones((), device="meta")
    grid = (256, 128, 16, 64, 4)

    def main(pr, p00=p, p11=p):
        return EC.emit_pair_keys(pr, p00, p11, *grid)
    with pytest.raises(ValueError, match="dtype"):
        main(proj.map(lambda a: a.double() if a.dtype == torch.float32
                      else a))
    with pytest.raises(ValueError, match="contiguous"):
        main(proj.map(lambda a: torch.empty(128, dtype=a.dtype,
                                            device="meta")[::2]))
    with pytest.raises(ValueError, match="shape"):
        main(proj.map(lambda a: a[:10] if a.dtype == torch.bool else a))
    with pytest.raises(ValueError, match="valid"):
        main(proj.map(lambda a: a.to(torch.uint8) if a.dtype == torch.bool
                      else a))
    mixed = proj.map(lambda a: a)
    object.__setattr__(mixed, "l1", torch.ones(64))
    with pytest.raises(ValueError, match="devices"):
        main(mixed)
    with pytest.raises(ValueError, match="one element"):
        main(proj, p00=torch.ones(2, device="meta"))
    with pytest.raises(ValueError, match="p11"):
        main(proj, p11=torch.ones((), dtype=torch.float64, device="meta"))
    # Everything else right, on a device that is not the card: no fallback,
    # from the wrappers or from quantized_pair_keys.
    with pytest.raises(ValueError, match="unsupported device"):
        main(proj)
    with pytest.raises(ValueError, match="unsupported device"):
        main(proj, p00=0.5, p11=torch.tensor(0.25))
    with pytest.raises(ValueError, match="unsupported device"):
        T.quantized_pair_keys(proj, p, p, *grid, big_splat_budget=16)
    key = torch.empty(4 * 64 + 16 * 8, dtype=torch.int32, device="meta")
    ids = torch.empty(8, dtype=torch.int32, device="meta")
    count = torch.zeros((), dtype=torch.int32, device="meta")

    def big(ids=ids, key=key, count=count):
        return EC.emit_big_pair_keys(proj, p, p, *grid[:4], 16, ids, key,
                                     key.clone(), count)
    with pytest.raises(ValueError, match="ids"):
        big(ids=ids.long())
    with pytest.raises(ValueError, match="room"):
        big(key=key[:100])
    with pytest.raises(ValueError, match="overflowed"):
        big(count=count.reshape(1))
    with pytest.raises(ValueError, match="unsupported device"):
        big()


def test_ctypes_signature_matches_the_c_entry():
    src = (Path(EC.__file__).parent / "csrc" / "emit.cu").read_text()
    sig = re.search(r'extern "C" int fourdgs_emit_pair_keys\((.*?)\)\s*\{',
                    src, re.S).group(1)
    kinds = {"void*": ctypes.c_void_p, "float": ctypes.c_float,
             "int": ctypes.c_int}
    want = [kinds[arg.replace("const ", "").split()[0]] for arg in
            sig.split(",")]
    assert EC.EMIT.symbol == "fourdgs_emit_pair_keys"
    assert EC.EMIT.argtypes == want
    assert EC.EMIT.extra_flags == ("-fmad=false",)
    # The fields and valid, ids, p00's and p11's pointers and values, the
    # 13 grid and size numbers, the four outputs and the stream.
    assert len(want) == len(EC.FIELDS) + 1 + 1 + 4 + 13 + 4 + 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def held_to_plain(proj, p00, p11, w, h, th, tw, budget, big_budget=16,
                  keep=128, band=None, window=None, what=""):
    """K16 (quantized_pair_keys on the card) against the plain version on
    the card; with the big tier also the main launch's is-big flag."""
    args = (proj, p00, p11, w, h, th, tw, budget, big_budget, keep, band,
            window)
    got = T.quantized_pair_keys(*args)
    want = T.quantized_pair_keys_plain(*args)
    torch.cuda.synchronize()
    assert_same(got, want, what)
    if big_budget:
        slots = T.big_tier_slots(proj.count, keep)
        _, _, _, is_big = EC.emit_pair_keys(proj, p00, p11, w, h, th, tw,
                                            budget, big_budget, slots, band,
                                            window)
        alive, tx0, tx1, ty0, ty1 = T.splat_tile_bbox(proj, p00, p11, w, h,
                                                      th, tw)
        if band is not None:
            alive, ty0, ty1, _ = T.clip_to_tile_row_band(alive, ty0, ty1,
                                                         band)
        span = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
        assert torch.equal(is_big, alive & (span > budget)), what
    return want


# (width, height, tile_h, tile_w, budget, big_budget, bands): the cells'
# 1080p and 4K binnings (auto_render_config's tiles and budgets, every
# band), and 1080p at 8x32 tiles and budgets 2 and 4, where the cube's splats
# at 1M fill the big tier and overflow both tiers (two of its four bands).
CARD_GRIDS = [
    (1920, 1088, 16, 128, 4, 16, [None]),
    (3840, 2160, 16, 128, 8, 16, [(0, 68), (68, 67)]),
    (1920, 1088, 8, 32, 2, 4, [(0, 34), (102, 34)]),
]


@pytest.mark.card
def test_k16_bit_equal_at_1m_splats(card):
    n_poses = 8
    params = build_cube_scene(1_048_576, seed=11, device=card)
    for i in range(n_poses):
        for w, h, th, tw, budget, big, bands in CARD_GRIDS:
            cam = orbit_camera(i, n_poses, card, w, h)
            proj = TP.project_params4d(params, cam, (i + 0.5) / n_poses)
            pmat = cam.proj_matrix()
            for band in bands:
                key, _, overflowed, ids = held_to_plain(
                    proj, pmat[0, 0], pmat[1, 1], w, h, th, tw, budget, big,
                    band=band, what=(i, w, th, band))
                assert int((key != DEAD).sum()) > 0
                if tw == 32:
                    assert int((ids != DEAD).sum()) > 0
                    assert int(overflowed) > 0


@pytest.mark.card
def test_k16_odd_lengths_offsets_windows_and_tiles(card):
    """The word-by-word path (lengths not a multiple of 4, fields 1-3 words
    off 16 bytes), the id compaction of small N, a tile window, tile sizes
    that are not powers of two, p00 and p11 as numbers, and one tier."""
    cam = orbit_camera(2, 8, card, 1920, 1088)
    full, p00, p11 = projected(20_011, seed=3, camera=cam)
    for off, n in ((0, 20_011), (1, 9_999), (2, 4_001), (3, 1), (0, 3)):
        proj = full.map(lambda a: a[off:off + n])
        held_to_plain(proj, p00, p11, 1920, 1088, 16, 128, 4,
                      what=(off, n))
        held_to_plain(proj, p00, p11, 1920, 1088, 16, 128, 4, big_budget=0,
                      what=(off, n, "one tier"))
    for window in ((0, 500), (300, 211), (1000, 1000)):
        held_to_plain(full, p00, p11, 1920, 1088, 16, 128, 4, window=window,
                      what=window)
    for th, tw in ((24, 40), (12, 100), (8, 64)):
        ny, nx = T.tile_grid(1920, 1088, th, tw)
        band = (ny // 3, min(ny - ny // 3, (T.TILE_LIMIT - 1) // nx))
        held_to_plain(full, p00, p11, 1920, 1088, th, tw, 4, band=band,
                      what=(th, tw))
    held_to_plain(full, float(p00), float(p11), 1920, 1088, 16, 128, 4,
                  what="numbers")


@pytest.mark.card
def test_a_frame_launches_k16_twice_a_band(card):
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import converged_cube_scene
    params = converged_cube_scene(build_cube_scene(20_000, seed=2,
                                                   device=card))
    for (w, h), bands in (((512, 256), 1), ((3840, 2160), 2)):
        cam = Camera.create(**CUBE_CAMERA, width=w, height=h, device=card)
        EC.EMIT.launches = 0
        TP.render_params4d_packed(params, cam, 0.0,
                                  cfg=auto_render_config(20_000, w, h))
        torch.cuda.synchronize()
        assert EC.EMIT.launches == 2 * bands
