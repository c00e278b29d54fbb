"""The kernels' bounds, one file a kernel under benchmark/bounds/: each of
K1-K7 gives the bytes and operations that its entry gave before the move
into its own file (recorded from that earlier form on the same arguments),
K15 gives 101 B a splat, and the recorder takes every file's entries in
name order."""

import pytest
import torch

from harness import roofline
from harness.scene import cube_params
from harness.spec import BENCH, ROOT, Cell, load_module


def f32(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def tail_meta():
    meta = i32(6, 40)
    meta[5] = torch.arange(40, dtype=torch.int32) % 11
    return meta


# kernel: (args, kwargs, out, (bytes, operations) the earlier entry gave).
CASES = {
    "K3": (([i32(64, 8)],), dict(stride_rows=64, take_rows=1),
           [i32(1, 8), i32(3)], (88, 0)),
    "K2": ((i32(5, 256), i32(5, 256), 16), dict(row_len=256, cut=i32(5, 2)),
           (i32(16, 5), i32(16, 5), i32(5)), (6140, 92160)),
    "K2-positional": ((i32(5, 256), i32(5, 256), 16, 128, i32(7)), {},
                      (i32(16, 6), i32(16, 6), i32(5)), (6324, 43008)),
    "K2-defaults": ((i32(5, 256), i32(5, 256), 16), {},
                    (i32(16, 6), i32(16, 6), i32(5)), (6296, 8945664)),
    "K1": ((f32(4, 12, 9), torch.tensor([3, 0, 7, 2], dtype=torch.int32),
            f32(4, 2, 128)), {}, f32(4, 128, 4), (37456, 18432)),
    "K4": (tuple(f32(10 + i) for i in range(10)) + (f32(3),), {},
           f32(10, 40), (2180, 0)),
    "K5": (tuple(i32(20 + i) for i in range(6)) + (f32(2),), {},
           i32(6, 30), (1260, 0)),
    "K6": ((i32(6, 33), i32(4, 8)), {}, (i32(33), f32(9)), (428, 0)),
    "K7": ((f32(9, 40), tail_meta(), i32(40), i32(40, 4), i32(5, 3),
            f32(12)), dict(budget=8, budget_lo=2,
                           slot_mask=torch.zeros(40, dtype=torch.bool),
                           s_cy=4, s_cx=8), f32(5, 16, 4), (4628, 41856)),
    "K7-no-floor": ((f32(9, 40), tail_meta(), i32(40), i32(40, 4),
                     i32(5, 3), f32(12)), dict(budget=4, s_cy=2, s_cx=16),
                    f32(5, 16, 4), (4588, 46080)),
}
# (module, attribute, kernel) of every entry before the move, and K15's.
ENTRIES = [
    ("fourdgs_torch.render.pipeline", "composite_records", "K1"),
    ("fourdgs_torch.render.pipeline", "project_params4d", "K15"),
    ("fourdgs_torch.render.tiles", "rowsort_compact", "K2"),
    ("fourdgs_torch.render.tiles", "sample_blocks", "K3"),
    ("fourdgs_torch.render.pipeline", "sample_blocks", "K3"),
    ("fourdgs_torch.ops.pack_cuda", "pack_record_fields", "K4"),
    ("fourdgs_torch.ops.pack_cuda", "pack_meta_rows", "K5"),
    ("fourdgs_torch.ops.tail_cuda", "tail_prepass", "K6"),
    ("fourdgs_torch.ops.tail_cuda", "tail_accumulate", "K7"),
]


def bound_fn(kernel):
    mod = load_module(BENCH / "bounds" / f"{kernel}.py",
                      f"bench_bounds_test_{kernel}")
    (fn,) = {e[3] for e in mod.WRAPPERS}
    assert {e[2] for e in mod.WRAPPERS} == {kernel}
    return fn


@pytest.mark.parametrize("case", sorted(CASES))
def test_moved_bound_gives_what_it_gave(case):
    args, kw, out, want = CASES[case]
    assert bound_fn(case.split("-")[0])(args, kw, out) == want


def test_the_recorder_takes_every_bound_file_in_name_order():
    assert [e[:3] for e in roofline.wrappers(ROOT)] == ENTRIES


def small_frame(n):
    from fourdgs_torch.core.camera import Camera
    cell = Cell("cube-10m.orbit-4k")
    params = cube_params(dict(cell.config["scene"], n_splats=n), 3, "cpu")
    cam = cell.config["camera"]
    camera = Camera.create(position=cam["position"],
                           orientation=cam["orientation"], far=cam["far"],
                           width=64, height=32, device="cpu")
    return params, camera


@pytest.mark.parametrize("n", [1, 37, 4096])
def test_k15_moves_101_bytes_a_splat(n):
    from fourdgs_torch.render import pipeline
    params, camera = small_frame(n)
    out = pipeline.project_params4d(params, camera, 0.25)
    assert bound_fn("K15")((params, camera, 0.25), {}, out) == (101 * n, 0)


def test_recorder_records_k15_where_the_frame_calls_it():
    from fourdgs_torch.render import pipeline
    params, camera = small_frame(1000)
    with roofline.Recorder(ROOT) as rec:
        pipeline.project_params4d(params, camera, 0.5)
        pipeline.project_params4d(params, camera, 0.75)
    assert rec.calls == {"K15": 2}
    assert rec.bounds["K15"] == 2 * roofline.bound_s(101_000, 0)
    assert pipeline.project_params4d.__name__ == "project_params4d"


def test_k15_bound_at_the_cells_size():
    # 10,010,624 splats after the padding: 1.011 GB, 0.302 ms at 3.35 TB/s.
    n = 10_010_624
    assert roofline.bound_s(101 * n, 0) == pytest.approx(0.30182e-3,
                                                         rel=1e-4)
