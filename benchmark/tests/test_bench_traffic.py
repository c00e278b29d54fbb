"""The traffic kinds yield their seeded inputs: the orbit's poses, times
and compared frames, and the cube scene, all from the seed."""

import math

import pytest
import torch

from harness.scene import cube_params
from harness.spec import Cell, load_module

CELLS = ("cube-10m-keep64.orbit-1080p", "cube-10m.orbit-4k")
BIG_SEED = 2 ** 31 + 12345


def orbit():
    cell = Cell(CELLS[0])
    return cell, cell.traffic_module()


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_found_by_name(name):
    cell = Cell(name)
    assert cell.kind == "orbit"
    assert cell.config["name"] == cell.entry["config"]
    assert {m["name"] for m in cell.end_to_end()} == {
        "frame_ms", "frame_p95_ms", "setup_s"}
    assert len(cell.per_layer()) == 7
    for m in cell.per_layer():
        assert hasattr(cell.metric_reader(m["name"]), "read")


def test_orbit_keeps_distance_elevation_and_aim():
    cell, mod = orbit()
    cam, mix = cell.config["camera"], cell.mix
    p0 = cam["position"]
    d0 = math.dist(p0, (0, 0, 0))
    for i in (0, 1, 77, 239, 240, 1000):
        pos, ori, t = mod.pose(cam, mix, BIG_SEED, i)
        assert math.dist(pos, (0, 0, 0)) == pytest.approx(d0, rel=1e-12)
        assert pos[1] == p0[1] and ori[1] == cam["orientation"][1]
        # The direction to the centre turns with the camera.
        assert math.hypot(ori[0], ori[2]) == pytest.approx(
            math.hypot(cam["orientation"][0], cam["orientation"][2]))
        assert 0.0 <= t < 1.0


def test_orbit_advances_one_and_a_half_degrees_a_frame():
    cell, mod = orbit()
    cam, mix = cell.config["camera"], cell.mix
    a = [math.degrees(math.atan2(p[0], p[2])) for p, _, _ in
         (mod.pose(cam, mix, 7, i) for i in (0, 1))]
    assert (a[0] - a[1]) % 360.0 == pytest.approx(1.5) or \
        (a[1] - a[0]) % 360.0 == pytest.approx(1.5)
    _, _, t240 = mod.pose(cam, mix, 7, 240)
    assert t240 == pytest.approx(0.0, abs=1e-9)
    # One turn later the pose repeats.
    p0, _, _ = mod.pose(cam, mix, 7, 3)
    p1, _, _ = mod.pose(cam, mix, 7, 3 + 240)
    assert p0 == pytest.approx(p1)


def test_orbit_start_and_checked_frames_come_from_the_seed():
    _, mod = orbit()
    assert mod.start_azimuth(BIG_SEED) == mod.start_azimuth(BIG_SEED)
    assert mod.start_azimuth(1) != mod.start_azimuth(2)
    f = mod.check_fractions(BIG_SEED, 3)
    assert f == mod.check_fractions(BIG_SEED, 3) == sorted(f)
    assert all(0.0 <= x < 1.0 for x in f)
    assert f != mod.check_fractions(BIG_SEED + 1, 3)


def test_percentile_is_nearest_rank():
    _, mod = orbit()
    v = list(range(1, 101))
    assert mod.percentile(v, 95.0) == 95
    assert mod.percentile([3.0], 95.0) == 3.0


def test_cube_scene_from_the_seed():
    scene = dict(Cell(CELLS[0]).config["scene"], n_splats=4096)
    a = cube_params(scene, BIG_SEED, "cpu")
    b = cube_params(scene, BIG_SEED, "cpu")
    c = cube_params(scene, BIG_SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["px"], c["px"])
    assert len(a) == 20 and all(v.shape == (4096,) for v in a.values())
    assert float(a["px"].abs().max()) <= 200.0
    assert 3.0 <= float(a["sx"].min()) and float(a["sx"].max()) <= 8.0
    assert torch.equal(a["lifetime"], torch.full((4096,), 50.0))


def test_traffic_mixes_are_data_read_by_one_generator():
    for name in CELLS:
        cell = Cell(name)
        mod = load_module(cell.root / "benchmark" / "traffic" /
                          f"{cell.kind}.py", "orbit_again")
        assert hasattr(mod, "Run") and hasattr(mod, "pose")
        assert set(cell.mix) >= {"kind", "width", "height", "deg_per_frame",
                                 "t_per_frame", "checked_frames"}


@pytest.mark.parametrize("name", CELLS)
def test_program_and_reference_take_the_same_render_overrides(name):
    from reference import converged_frame as R
    cell = Cell(name)
    run = cell.traffic_module().Run(cell, 1, torch.device("cpu"))
    over = run.overrides()
    n = int(cell.config["scene"]["n_splats"])
    cfg = R.frame_config(n, run.w, run.h, over)
    want = over.get("sort_compact_keep_cols", 32 if n >= 2_000_000 else 192)
    assert cfg["compact_keep_cols"] == want
    with pytest.raises(KeyError):
        R.frame_config(n, run.w, run.h, {"tail_bands": 4})
