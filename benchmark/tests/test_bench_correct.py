"""What decides `correct`, driven on the CPU at a tiny size: the whole run
but the harness's look for a chip (run.run_cell), with the program's plain
versions in place of its kernels.

A sound program comes out correct. Each fault the view cells can have,
planted underneath the timed path, comes out not correct: a frame that
returns its state unchanged (the last image again), half of the splats
left out, an image altered where it is made. (The exchange between chips
does not exist on one chip.) So does the precision control: the plain
reference with its records in bfloat16 in the program's place. On a card,
the control runs at the cell's own size (`test_control_on_the_card`)."""

import time

import pytest
import torch

from harness.spec import BENCH, Cell, load_module

RUN = load_module(BENCH / "run.py", "bench_run_for_correct")
CELL = "cube-10m-keep64.orbit-1080p"
SEED = 2 ** 31 + 99


def tiny(name=CELL, n=20000, width=512, height=256):
    cell = Cell(name)
    cell.config = dict(cell.config,
                       scene=dict(cell.config["scene"], n_splats=n))
    cell.mix = dict(cell.mix, width=width, height=height)
    return cell


def run_tiny(seconds=1.0):
    return RUN.run_cell(tiny(), SEED, seconds, False, torch.device("cpu"),
                        time.perf_counter())


@pytest.fixture
def pipeline():
    from fourdgs_torch.render import pipeline as TP
    return TP


def test_sound_program_is_correct():
    res = run_tiny(seconds=8.0)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] >= 3
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["checks"]["image_gap"]["value"] == 0.0
    assert res["checks"]["counter_gap"]["value"] == 0


def stale(render):
    first = {}

    def broken(params, cam, t, **kw):
        img, aux = render(params, cam, t, **kw)
        return first.setdefault("img", img), aux
    return broken


def half_splats(render):
    def broken(params, cam, t, **kw):
        half = {k: v[: v.shape[0] // 2] for k, v in params.items()}
        return render(half, cam, t, **kw)
    return broken


def altered(render):
    def broken(params, cam, t, **kw):
        img, aux = render(params, cam, t, **kw)
        img = img.clone()
        h, w = img.shape[:2]
        img[h // 2: h // 2 + h // 8, w // 2: w // 2 + w // 8, :3] += 0.05
        return img, aux
    return broken


@pytest.mark.parametrize("fault", [stale, half_splats, altered],
                         ids=["state_unchanged", "half_splats",
                              "image_altered"])
def test_fault_underneath_is_not_correct(pipeline, monkeypatch, fault):
    monkeypatch.setattr(pipeline, "render_params4d_packed",
                        fault(pipeline.render_params4d_packed))
    res = run_tiny()
    assert res["correct"] is False
    assert res["checks"]["image_gap"]["value"] > \
        res["checks"]["image_gap"]["limit"]


def control_gap(cell, seed, seconds, device):
    run = cell.traffic_module().Run(cell, seed, device)
    run.setup()
    run.window(seconds)
    run.failed()
    run.release()
    return run.control(torch.bfloat16)


def test_control_is_not_correct():
    got = control_gap(tiny(), SEED, 1.0, torch.device("cpu"))
    limit = RUN.limits_for(tiny())["image_gap"]
    assert got["image_gap"] > 3 * limit


@pytest.mark.card
@pytest.mark.parametrize("name", ["cube-10m-keep64.orbit-1080p",
                                  "cube-10m.orbit-4k"])
def test_control_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    cell = Cell(name)
    limit = RUN.limits_for(cell)["image_gap"]
    for seed in (101, 2 ** 31 + 7, 4_000_000_000):
        got = control_gap(cell, seed, 2.0, torch.device("cuda", 0))
        assert got["image_gap"] > limit


def test_a_window_shorter_than_a_frame_keeps_its_frame():
    cell = tiny(n=4096, width=256, height=128)
    run = cell.traffic_module().Run(cell, SEED, torch.device("cpu"))
    run.setup()
    assert run.window(0.0)["attempted"] == 1
    assert [i for i, _ in run.kept] == [0]
