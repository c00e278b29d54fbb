"""The port's fit step (`train.trainer.Fitter.step`) against the plain
reference of the grad step that the benchmark's fit cell holds it to
(`benchmark/reference/fit_step.py`, loaded by path), on the CPU at a tiny
size; `fit` over frames that carry their own camera; and the step's
ranges.

The scene: 2,048 seeded random motion splats (velocities, time centres,
lifetimes and fades drawn, so the temporal fields carry gradient), padded
with `densify.pad_params` to 4,096 slots, seen by the cube's camera at
256x128 under `auto_render_config(4096, 256, 128)` (converged), the splats
drawn in a 120-unit cube with scales of 6-16 so that their footprints
cover pixels. The target is the program's render of a second such scene at
t = 0.37, the loss L1 + 0.2 D-SSIM, lr 5e-3. The fits over frames that
carry a camera run on 512 such splats in 1,024 slots at 128x64.

Tolerances, with their reasons:
  * loss: 1e-6 relative. Both sides compute the same float32 forward on
    the CPU; only sums run in another order.
  * gradients: 1e-3 of each field's largest, for quat and scale3 at the
    footprints the conditioning rule keeps (`fit_step.well_conditioned`:
    at a nearly round footprint the eigenvector, and every rotation and
    scale gradient through it, is rounding noise, ROADMAP C-R7). The
    program's composite backward takes each pixel's suffix sums as the
    total minus the inclusive prefix, where autograd differentiates the
    running product: the two round apart by about 1e-4 of a field's
    largest gradient here.
  * Adam's update: 2e-3 of each field's largest update. The reference's
    Adam takes the program's gradients, so only the last rounding of
    p - update may differ, by one unit in the last place of p: at |p| of
    about 60, 4e-6 against an update of 5e-3.
"""

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fourdgs_torch.core.camera import Camera
from fourdgs_torch.ops import tail_cuda
from fourdgs_torch.parallel.distributed import materialize_splats
from fourdgs_torch.render.autoconfig import auto_render_config
from fourdgs_torch.render.pipeline import render_splats4d
from fourdgs_torch.train import densify as D
from fourdgs_torch.train import trainer as TR

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
N, CAP, W, H = 2048, 4096, 256, 128
T, LR, SSIM_WEIGHT = 0.37, 5e-3, 0.2
POSITION, ORIENTATION, FAR = (420.0, 300.0, 420.0), (-1.0, -0.7, -1.0), 5e3
LOSS_RTOL, GRAD_TOL, UPDATE_TOL = 1e-6, 1e-3, 2e-3
SHAPE_FIELDS = ("quat", "scale3")
LAYERS = ("fourdgs::forward", "fourdgs::backward", "fourdgs::optimizer",
          "fourdgs::densify")


def _params(seed, n=N, cap=CAP):
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g)
    pos = torch.cat([u(n, 3) * 120.0 - 60.0, u(n, 1) * 0.6 - 0.3], dim=1)
    return D.pad_params(dict(
        position4=pos, quat=torch.randn(n, 4, generator=g),
        scale3=u(n, 3) * 10.0 + 6.0, lifetime=u(n) * 1.5 + 0.8,
        fade=u(n) * 0.5 + 0.25,
        velocity=torch.randn(n, 3, generator=g) * 5.0,
        color=u(n, 4) * 0.8 + 0.2), cap)


def _camera(position=POSITION, width=W, height=H):
    return Camera.create(position=position, orientation=ORIENTATION,
                         far=FAR, width=width, height=height, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes on the
    machine's cores, where a step's many small CPU operations spend more
    time waiting on each other's threads than working."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def RF():
    sys.path.insert(0, str(BENCH))
    try:
        from reference import fit_step
    finally:
        sys.path.remove(str(BENCH))
    return fit_step


@pytest.fixture(scope="module")
def setting():
    cfg = auto_render_config(CAP, W, H, converged=True)
    cam = _camera()
    with torch.no_grad():
        target = render_splats4d(materialize_splats(_params(2)), cam,
                                 torch.tensor(T), cfg=cfg)[..., :3]
    return dict(cfg=cfg, cam=cam, target=target, params=_params(1))


def _program_step(setting):
    f = TR.Fitter(setting["params"], setting["cam"], LR, setting["cfg"],
                  SSIM_WEIGHT)
    loss = f.step(setting["target"], torch.tensor(T))
    return (float(loss), {k: p.grad.clone() for k, p in f.params.items()},
            {k: p.detach().clone() for k, p in f.params.items()}, f)


@pytest.fixture(scope="module")
def reference(RF, setting):
    cfg = RF.R.frame_config(CAP, W, H)
    loss, grads, counters = RF.loss_and_grads(
        setting["params"], setting["target"], POSITION, ORIENTATION, T, W, H,
        FAR, cfg, SSIM_WEIGHT)
    rows = RF.well_conditioned(setting["params"], POSITION, ORIENTATION, T,
                               W, H, FAR)
    return dict(loss=float(loss), grads=grads, counters=counters, rows=rows)


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _grad_gaps(grads, reference):
    rows = reference["rows"]
    return {k: (_gap(g[rows], reference["grads"][k][rows])
                if k in SHAPE_FIELDS else _gap(g, reference["grads"][k]))
            for k, g in grads.items()}


def test_step_matches_the_reference(RF, setting, reference):
    loss, grads, after, f = _program_step(setting)
    assert reference["counters"] == dict(overflowed=0, compact_dropped=0,
                                         resid_transmittance=0.0)
    assert int(f.lossy) == 0 and f.steps_done == 1
    assert abs(loss - reference["loss"]) <= LOSS_RTOL * reference["loss"]
    # The rule leaves most footprints in.
    assert int(reference["rows"][:N].sum()) > 0.9 * N
    gaps = _grad_gaps(grads, reference)
    assert set(gaps) == set(RF.FIELDS)
    assert max(gaps.values()) <= GRAD_TOL, gaps
    before = setting["params"]
    want = RF.adam_update(before, grads, {}, LR)
    for k in RF.FIELDS:
        assert _gap(after[k] - before[k], want[k] - before[k]) <= UPDATE_TOL
        # Adam's first step moves every entry with a gradient well above
        # eps by lr.
        moved = (after[k] - before[k]).abs()
        assert float(moved.max()) == pytest.approx(LR, rel=1e-3)


def test_a_fault_in_the_tail_backward_fails_the_gradient_check(
        setting, reference, monkeypatch):
    plain = tail_cuda.tail_accumulate_bwd_plain

    def halved(*args, **kw):
        return plain(*args, **kw) * 0.5
    monkeypatch.setattr(tail_cuda, "tail_accumulate_bwd_plain", halved)
    loss, grads, _, _ = _program_step(setting)
    # The forward is untouched, the gradients are not.
    assert abs(loss - reference["loss"]) <= LOSS_RTOL * reference["loss"]
    assert max(_grad_gaps(grads, reference).values()) > 10 * GRAD_TOL


@pytest.fixture
def deterministic():
    """Accumulating index writes in a fixed order: the CPU backward adds a
    splat's gradient from its tiles by atomic adds otherwise, and two equal
    fits round apart by the order the threads add in."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.fixture(scope="module")
def small():
    """The fits' setting: 512 splats in 1,024 slots at 128x64."""
    w, h = W // 2, H // 2
    cfg = auto_render_config(1024, w, h, converged=True)
    cam = _camera(width=w, height=h)
    with torch.no_grad():
        target = render_splats4d(materialize_splats(_params(2, 512, 1024)),
                                 cam, torch.tensor(T), cfg=cfg)[..., :3]
    return dict(cfg=cfg, cam=cam, target=target, w=w, h=h,
                params=_params(1, 512, 1024))


def _fit(setting, frames, steps=2):
    return TR.fit(setting["params"], frames, setting["cam"], steps=steps,
                  learning_rate=LR, cfg=setting["cfg"],
                  ssim_weight=SSIM_WEIGHT, densify_cfg=D.DensifyConfig(),
                  densify_every=1, densify_until=0.7, seed=3)


def test_frames_that_carry_the_fit_camera_fit_bit_equal(small,
                                                        deterministic):
    setting = small
    target, cam = setting["target"], setting["cam"]
    frames = [(target, T), (target.flip(1), 0.8)]
    one = _fit(setting, frames)
    own = _fit(setting, [(img, t, cam) for img, t in frames])
    assert one.losses == own.losses
    for k, p in one.params.items():
        assert torch.equal(p, own.params[k]), k


def test_a_frame_is_rendered_from_its_own_camera(small, deterministic):
    setting = small
    other = _camera((300.0, 360.0, 480.0), small["w"], small["h"])
    got = _fit(setting, [(setting["target"], T, other)], steps=1).losses
    f = TR.Fitter(setting["params"], setting["cam"], LR, setting["cfg"],
                  SSIM_WEIGHT)
    assert got == [float(f.step(setting["target"], torch.tensor(T), other))]
    assert got != _fit(setting, [(setting["target"], T)], steps=1).losses


def _ancestors(event):
    p = event.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


def test_a_steps_operations_fall_in_one_layer_range(setting):
    """Every top-level aten call of a step with a densify event runs inside
    `fourdgs::fit_step` and inside at most one of the four layer ranges,
    which open directly in it; the render's frame and the loss open in
    the forward."""
    f = TR.Fitter(setting["params"], setting["cam"], LR, setting["cfg"],
                  SSIM_WEIGHT, D.DensifyConfig(), densify_every=1)
    t = torch.tensor(T)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f.step(setting["target"], t)
    assert f.last_event is not None
    events = prof.events()
    steps = [e for e in events if e.name == TR.STEP]
    assert len(steps) == 1 and steps[0].cpu_parent is None
    top = [e for e in events if e.name.startswith("aten::")
           and not any(a.name.startswith("aten::") for a in _ancestors(e))]
    assert len(top) > 50
    counts = dict.fromkeys(LAYERS + (TR.STEP,), 0)
    for e in top:
        names = [a.name for a in _ancestors(e)]
        assert TR.STEP in names, e.name
        layers = [n for n in names if n in LAYERS]
        assert len(layers) <= 1, (e.name, names)
        counts[layers[0] if layers else TR.STEP] += 1
    assert all(counts[n] > 0 for n in LAYERS), counts
    for e in events:
        if e.name in LAYERS:
            assert e.cpu_parent is steps[0]
        if e.name in ("fourdgs::frame", "fourdgs::loss"):
            assert e.cpu_parent.name == "fourdgs::forward"


def _eigen_before(a, b, c):
    """eigen2x2_scalar as it was before its gradient guard."""
    m = 0.5 * (a + c)
    d = torch.sqrt(torch.clamp(m * m - (a * c - b * b), min=1e-24))
    lmin = torch.clamp(m - d, min=1e-6)
    lmax = torch.clamp(m + d, min=1e-6)
    vx, vy = b, lmin - a
    norm = torch.sqrt(vx * vx + vy * vy)
    ok = norm > 1e-12
    inv = 1.0 / torch.clamp(norm, min=1e-30)
    fx = (a <= c).to(a.dtype)
    return (lmin, lmax, torch.where(ok, vx * inv, fx),
            torch.where(ok, vy * inv, 1.0 - fx))


def test_an_exactly_round_footprint_has_a_finite_gradient():
    """A splat whose footprint is exactly round in float32 (b == 0, a ==
    c: an isotropic splat at the image centre) has eigenvector (b, lmin -
    a) == 0: its gradient is 0 where the square root's was 0 / 0, and the
    eigen decomposition's values are unchanged."""
    from fourdgs_torch.render.project import eigen2x2_scalar
    g = torch.Generator().manual_seed(5)
    a, c = torch.rand(4096, generator=g), torch.rand(4096, generator=g)
    b = torch.randn(4096, generator=g) * 0.1
    a[:64], b[:64], c[:64] = 2.5e-3, 0.0, 2.5e-3
    for got, want in zip(eigen2x2_scalar(a, b, c), _eigen_before(a, b, c)):
        assert torch.equal(got, want)
    params = _params(7, n=64, cap=128)
    params["position4"][0] = 0.0
    params["quat"][0] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    params["scale3"][0] = 5.0
    params["velocity"][0] = 0.0
    cam = Camera.create(position=(0.0, 0.0, 100.0),
                        orientation=(0.0, 0.0, -1.0), width=W, height=H,
                        device="cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    img = render_splats4d(materialize_splats(leaves), cam, torch.tensor(T),
                          cfg=auto_render_config(128, W, H, converged=True))
    img[..., :3].mean().backward()
    for k, p in leaves.items():
        assert torch.isfinite(p.grad).all(), k
