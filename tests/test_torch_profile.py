"""The stage profiler of the port (fourdgs_torch/tools/profile_frame.py):
its attribution of device operations to `fourdgs::*` ranges on a synthetic
trace, and one profiled render on the CPU (host ranges only); where the
render calls open their ranges (every call inside one, one
`fourdgs::frame` a call, none inside the projection, the tail's set-up
before its prepass)."""

import functools

import pytest
import torch

from fourdgs_torch.tools import profile_frame as PF


def _range(name, ts, dur):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur)


def _launch(corr, ts):
    return dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=ts,
                dur=1.0, args=dict(correlation=corr))


def _device(corr, ts, dur, cat="kernel"):
    return dict(ph="X", cat=cat, name=f"k{corr}", ts=ts, dur=dur,
                args=dict(correlation=corr))


def test_attribute_trace_maps_launches_to_innermost_range():
    events = [
        # Two frames of 10 ms; stage a holds stage b.
        _range(PF.FRAME, 0.0, 10_000.0), _range(PF.FRAME, 20_000.0, 10_000.0),
        _range("fourdgs::a", 100.0, 5_000.0),
        _range("fourdgs::b", 1_000.0, 1_000.0),
        _range("fourdgs::a", 20_100.0, 3_000.0),
        _range("other::x", 3_000.0, 100.0),       # not a fourdgs range
        _launch(1, 200.0), _device(1, 300.0, 2_000.0),      # a
        _launch(2, 1_500.0), _device(2, 1_000.0, 2_000.0),  # b, overlaps 1
        _launch(3, 3_050.0), _device(3, 6_000.0, 500.0, "gpu_memset"),  # a
        _launch(4, 8_000.0), _device(4, 8_100.0, 1_000.0),  # outside stages
        _launch(5, 20_200.0), _device(5, 20_300.0, 4_000.0),  # a, frame 2
        _launch(6, 40_000.0), _device(6, 40_000.0, 9_000.0),  # no frame
        _device(7, 1_000.0, 50.0),                # launch not traced
    ]
    res = PF.attribute_trace(events)
    assert res["frames"] == 2
    assert res["frame_ms"] == pytest.approx(10.0)
    st = res["stages"]
    assert set(st) == {"fourdgs::a", "fourdgs::b", PF.OUTSIDE}
    assert st["fourdgs::a"]["device_ms"] == pytest.approx((2.0 + 0.5 + 4.0) / 2)
    assert st["fourdgs::a"]["ops"] == pytest.approx(1.5)
    assert st["fourdgs::a"]["host_ms"] == pytest.approx((5.0 + 3.0) / 2)
    assert st["fourdgs::b"]["device_ms"] == pytest.approx(1.0)
    assert st[PF.OUTSIDE]["device_ms"] == pytest.approx(0.5)
    assert res["ops"] == pytest.approx(2.5)
    # Frame 1: union of [300, 2300], [1000, 3000], [6000, 6500], [8100,
    # 9100] = 4.2 ms; frame 2: 4 ms.
    assert res["busy_ms"] == pytest.approx((4.2 + 4.0) / 2)
    assert res["idle_traced"] == pytest.approx(1.0 - 4.1 / 10.0)
    assert list(st)[0] == "fourdgs::a"       # sorted by device time


def test_attribute_trace_splits_the_kernel_sorted_binning():
    """The ranges of the kernel-sorted binning (`sort_backend="pallas"`):
    the standalone cut (K10), the row compaction and the merge (K11-K13)
    nest in `fourdgs::bin_sort` and keep their own device time."""
    cut, compact, merge = ("fourdgs::apply_cutkeys", "fourdgs::compact_pairs",
                           "fourdgs::merge_sorted_rows")
    events = [
        _range(PF.FRAME, 0.0, 10_000.0),
        _range("fourdgs::bin_sort", 100.0, 8_000.0),
        _range(cut, 200.0, 100.0), _range(compact, 400.0, 600.0),
        _range(merge, 1_100.0, 400.0),
        _launch(1, 150.0), _device(1, 160.0, 300.0),        # bin_sort itself
        _launch(2, 250.0), _device(2, 500.0, 100.0),        # K10
        _launch(3, 450.0), _device(3, 700.0, 9_000.0),      # the row sort
        _launch(4, 1_150.0), _device(4, 9_800.0, 50.0),     # K11
        _launch(5, 1_200.0), _device(5, 9_900.0, 10.0),     # K12
        _launch(6, 1_300.0), _device(6, 9_950.0, 40.0),     # K13
    ]
    st = PF.attribute_trace(events)["stages"]
    assert st[cut]["device_ms"] == pytest.approx(0.1) and st[cut]["ops"] == 1
    assert st[compact]["device_ms"] == pytest.approx(9.0)
    assert st[merge]["device_ms"] == pytest.approx(0.1)
    assert st[merge]["ops"] == 3
    assert st["fourdgs::bin_sort"]["device_ms"] == pytest.approx(0.3)
    assert st["fourdgs::bin_sort"]["host_ms"] == pytest.approx(8.0)
    assert list(st)[0] == compact


def test_attribute_trace_needs_a_frame_range():
    with pytest.raises(ValueError, match=f"no {PF.FRAME}"):
        PF.attribute_trace([_range("fourdgs::a", 0.0, 1.0)])
    # The program's own range around a render call is a stage, not a frame.
    with pytest.raises(ValueError, match=f"no {PF.FRAME}"):
        PF.attribute_trace([_range("fourdgs::frame", 0.0, 1.0)])


def test_profile_path_on_the_cpu_finds_every_stage():
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import (CUBE_CAMERA, build_cube_scene,
                                           converged_cube_scene)
    n, w, h = 2048, 256, 128
    params = converged_cube_scene(build_cube_scene(n, seed=3, device="cpu"))
    cam = Camera.create(**CUBE_CAMERA, width=w, height=h,
                        device="cpu")
    res = PF.profile_path(params, cam, auto_render_config(n, w, h),
                          warmup=0, timed=1, profiled=1)
    assert res["frames"] == 1 and res["ops"] == 0 and res["busy_ms"] == 0.0
    want = {"fourdgs::frame", "fourdgs::project", "fourdgs::bin_sort",
            "fourdgs::emit", "fourdgs::composite", "fourdgs::pass1_kernel",
            "fourdgs::tail", "fourdgs::tail_setup", "fourdgs::tail_prepass",
            "fourdgs::tail_main", "fourdgs::tail_combine"}
    assert want <= set(res["stages"])
    assert all(st["host_ms"] > 0 for st in res["stages"].values())
    assert res["median_ms"] > 0 and len(res["frames_ms"]) == 1
    assert torch.isfinite(torch.tensor(res["frame_ms"]))
    # The kernel-sorted binning opens its own ranges.
    res = PF.profile_path(
        params, cam, auto_render_config(n, w, h, sort_backend="pallas",
                                        sort_compact_keep_cols=512),
        warmup=0, timed=1, profiled=1)
    assert {"fourdgs::apply_cutkeys", "fourdgs::compact_pairs",
            "fourdgs::merge_sorted_rows"} <= set(res["stages"])
    assert "fourdgs::rowsort_compact" not in res["stages"]


def test_profile_path_grad_step_finds_the_backward_stages():
    """With grad, each traced frame is a grad step; the backward and each
    autograd Function's backward have their own ranges."""
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import (CUBE_CAMERA, build_cube_scene,
                                           converged_cube_scene)
    n, w, h = 2048, 256, 128
    params = converged_cube_scene(build_cube_scene(n, seed=3, device="cpu"))
    cam = Camera.create(**CUBE_CAMERA, width=w, height=h,
                        device="cpu")
    res = PF.profile_path(params, cam, auto_render_config(n, w, h),
                          warmup=0, timed=1, profiled=1, grad=True)
    want = {PF.BACKWARD, "fourdgs::composite_bwd", "fourdgs::tail_bwd",
            "fourdgs::pack_bwd", "fourdgs::project", "fourdgs::tail_main"}
    assert want <= set(res["stages"])
    assert all(res["stages"][k]["host_ms"] > 0 for k in want)
    assert params["px"].grad is None         # the caller's params untouched


# The public render calls, each profiled once on the CPU with the camera it
# renders from (`_profiled_call`).
ENTRIES = ("render_params4d_packed", "render_splats4d", "render_splats3d",
           "render_splats2d")
PROJECT, TAIL = "fourdgs::project", "fourdgs::tail"
SETUP, PREPASS = "fourdgs::tail_setup", "fourdgs::tail_prepass"


@functools.lru_cache(maxsize=None)
def _profiled_call(entry):
    """The profiler's events of `Camera.create` and one call of `entry` on
    the CPU at a tiny size, and the number of tail bands the call renders:
    the packed entry renders a converged frame in two bands of tile rows
    (2,048 tiles of 8x8), the others the exact default configuration."""
    from torch.profiler import ProfilerActivity, profile

    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.render import pipeline as P
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes import scenes as S
    from fourdgs_torch.scenes.cube import (CUBE_CAMERA, build_cube_scene,
                                           converged_cube_scene)
    if entry == "render_params4d_packed":
        n, w, h = 2048, 512, 256
        params = converged_cube_scene(build_cube_scene(n, seed=3,
                                                       device="cpu"))
        cfg = auto_render_config(n, w, h, tile_h=8, tile_w=8,
                                 tail_block=(8, 8))
        pose, bands = CUBE_CAMERA, 2

        def call(cam):
            return P.render_params4d_packed(params, cam, 0.0, cfg=cfg,
                                            return_aux=True)
    else:
        w, h, bands = 128, 64, 0
        if entry == "render_splats2d":
            splats, st = S.gaussians_2d(n=20, seed=3, device="cpu")
        else:
            splats, st = S.clouds(n_splats=64, seed=3, device="cpu")
            if entry == "render_splats3d":
                splats = splats.at_time(0.3)[0]
        pose = dict(position=st.camera_position,
                    orientation=st.camera_orientation)
        render = getattr(P, entry)

        def call(cam):
            if entry == "render_splats4d":
                return render(splats, cam, 0.3, return_aux=True)
            return render(splats, cam, return_aux=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cam = Camera.create(**pose, width=w, height=h, device="cpu")
        img, _ = call(cam)
    assert img.shape == (h, w, 4)
    return prof.events(), bands


def _ancestors(event):
    p = event.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


def _ranges(events):
    return [e for e in events if e.name.startswith(PF.PREFIX)]


@pytest.mark.parametrize("entry", ENTRIES)
def test_every_call_of_a_frame_runs_inside_a_range(entry):
    """Every top-level aten call of the camera's creation and of the render
    call runs inside a `fourdgs::*` range; the camera opens one
    `fourdgs::camera`, the call exactly one `fourdgs::frame`, never
    nested."""
    from fourdgs_torch.render.pipeline import FRAME
    events, _ = _profiled_call(entry)
    top = [e for e in events if e.name.startswith("aten::")
           and not any(a.name.startswith("aten::") for a in _ancestors(e))]
    assert len(top) > 10
    outside = [e.name for e in top
               if not any(a.name.startswith(PF.PREFIX) for a in _ancestors(e))]
    assert not outside, outside
    ranges = _ranges(events)
    frames = [e for e in ranges if e.name == FRAME]
    cameras = [e for e in ranges if e.name == "fourdgs::camera"]
    assert len(frames) == 1 and len(cameras) == 1
    assert frames[0].cpu_parent is None and cameras[0].cpu_parent is None
    assert cameras[0].time_range.end <= frames[0].time_range.start
    # The frame's copies from host numbers, each in a range of its own (the
    # 2D scene's projection diagonal is its caller's).
    own = {"fourdgs::background": 1,
           "fourdgs::proj_matrix": int(entry != "render_splats2d")}
    for name, count in own.items():
        found = [e for e in ranges if e.name == name]
        assert len(found) == count
        assert all(e.cpu_parent is frames[0] for e in found)


@pytest.mark.parametrize("entry", ENTRIES)
def test_no_range_opens_inside_the_projection(entry):
    """`project_ms.view` reads the operations whose innermost range is
    `fourdgs::project`: no range may open inside it."""
    ranges = _ranges(_profiled_call(entry)[0])
    assert [e for e in ranges if e.name == PROJECT] or (
        entry == "render_splats2d")
    inside = [e.name for e in ranges
              if any(a.name == PROJECT for a in _ancestors(e))]
    assert not inside, inside


@pytest.mark.parametrize("entry", ENTRIES)
def test_tail_setup_opens_in_the_tail_before_its_prepass(entry):
    """One `fourdgs::tail_setup` a band, inside `fourdgs::tail`, ended
    before the band's `fourdgs::tail_prepass` starts, with the kernels'
    constants in a `fourdgs::tail_params` of their own; none without a
    tail."""
    events, bands = _profiled_call(entry)
    ranges = _ranges(events)
    setups = [e for e in ranges if e.name == SETUP]
    assert len(setups) == bands == len([e for e in ranges if e.name == TAIL])
    params = [e for e in ranges if e.name == "fourdgs::tail_params"]
    assert len(params) == bands
    assert all(e.cpu_parent.name == SETUP for e in params)
    for s in setups:
        assert s.cpu_parent.name == TAIL
        prepass = [c for c in s.cpu_parent.cpu_children if c.name == PREPASS]
        assert len(prepass) == 1
        assert s.time_range.end <= prepass[0].time_range.start
        assert not [c for c in s.cpu_parent.cpu_children
                    if c.name.startswith(PF.PREFIX)
                    and c.time_range.start < s.time_range.start]
