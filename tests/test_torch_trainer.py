"""Parity of the port's fitting loop with the JAX reference on the CPU:
`train.trainer.fit` (Adam, with and without adaptive density control),
`MetricsLogger` lines and checkpoints both ways.

The scene: 48 motion splats made from a seed with numpy (random rotations,
scales, lifetimes, fades and velocities), fitted for 3 steps to two target
frames the reference renders from another seed, at 64x48 under the
reference trainer tests' config (`tests/test_train.py`: max_splats_per_tile
128, splat_chunk 32, the xla backend). The frames are at t = 0.37 and 0.8,
off every splat's time centre range: Adam's first step is +-lr for any
gradient well above eps, so a gradient that is 0 in exact arithmetic (the
temporal fields at t = pt) would turn rounding noise into a full step. With
densification, every step is a densify event until 0.7 of the steps (so
events after steps 0 and 1), the reference's draws handed over through
numpy (`densify.normal_draws`).

Tolerances: losses within 1e-5 relative; parameters within 1e-4 of each
field's max; densify event counts and MetricsLogger events equal.
"""

import json
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fourdgs.core.camera import Camera as RCamera  # noqa: E402
from fourdgs.parallel.distributed import materialize_splats as r_mat  # noqa: E402
from fourdgs.render.pipeline import RenderConfig as RCfg  # noqa: E402
from fourdgs.render.pipeline import render_splats4d as r_render  # noqa: E402
from fourdgs.train import densify as RD  # noqa: E402
from fourdgs.train import trainer as RT  # noqa: E402
from fourdgs_torch.core.camera import Camera as TCamera  # noqa: E402
from fourdgs_torch.render.pipeline import RenderConfig as TCfg  # noqa: E402
from fourdgs_torch.train import densify as TD  # noqa: E402
from fourdgs_torch.train import trainer as TT  # noqa: E402

N, W, H, STEPS, LR = 48, 64, 48, 3, 5e-3
CFG = dict(max_splats_per_tile=128, splat_chunk=32)
TIMES = (0.37, 0.8)
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-4
FIT = dict(steps=STEPS, learning_rate=LR, densify_every=1, densify_until=0.7,
           seed=0)


def _params(seed, n=N):
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.uniform(-6, 6, (n, 3)),
                          rng.uniform(-0.2, 0.2, (n, 1))], -1)
    pos[:, 2] -= 25.0
    return dict(
        position4=pos.astype(np.float32),
        quat=rng.normal(size=(n, 4)).astype(np.float32),
        scale3=rng.uniform(1.0, 2.5, (n, 3)).astype(np.float32),
        lifetime=rng.uniform(1.5, 3.0, n).astype(np.float32),
        fade=rng.uniform(0.3, 0.7, n).astype(np.float32),
        velocity=rng.normal(size=(n, 3)).astype(np.float32),
        color=rng.uniform(0.2, 1.0, (n, 4)).astype(np.float32))


def _init():
    p = _params(4)
    p["color"][:4, 3] = 1e-3          # pruned at the first densify event
    return p


def _rcam():
    return RCamera.create(position=(0.0, 0.0, 0.0), width=W, height=H)


def _tcam():
    return TCamera.create(position=(0.0, 0.0, 0.0), width=W, height=H,
                          device="cpu")


@pytest.fixture(scope="module")
def targets():
    gt = {k: jnp.asarray(v) for k, v in _params(3).items()}
    cam = _rcam()
    render = jax.jit(lambda p, t: r_render(r_mat(p), cam, t, cfg=RCfg(**CFG)))
    return [(np.array(render(gt, jnp.float32(t))), t) for t in TIMES]


def _ref_draws(seed, n_events):
    """The normal draws of the reference fit's densify events: its key
    split once an event (trainer.py:129, 142)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_events):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(sub, (N, 3), jnp.float32)))
    return out


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def fits(targets, tmp_path_factory):
    """Both fits, without and with densification, each with a
    MetricsLogger."""
    out = {}
    tmp = tmp_path_factory.mktemp("fits")
    for mode in ("plain", "densify"):
        rlog = RT.MetricsLogger(str(tmp / f"{mode}_ref.jsonl"))
        tlog = TT.MetricsLogger(str(tmp / f"{mode}_port.jsonl"))
        dense = mode == "densify"
        want = RT.fit({k: jnp.asarray(v) for k, v in _init().items()},
                      [(jnp.asarray(a), t) for a, t in targets], _rcam(),
                      cfg=RCfg(**CFG), metrics=rlog,
                      densify_cfg=RD.DensifyConfig() if dense else None,
                      **FIT)
        draws = _ref_draws(FIT["seed"], 2)
        init = {k: torch.from_numpy(v) for k, v in _init().items()}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TD, "normal_draws",
                       lambda gen, shape, like: torch.from_numpy(draws.pop(0)))
            got = TT.fit(init, [(torch.from_numpy(a), t) for a, t in targets],
                         _tcam(), cfg=TCfg(**CFG), metrics=tlog,
                         densify_cfg=TD.DensifyConfig() if dense else None,
                         **FIT)
        rlog.close()
        tlog.close()
        assert draws == [] or not dense
        out[mode] = dict(want=want, got=got, init=init,
                         ref_lines=_lines(rlog.path),
                         port_lines=_lines(tlog.path))
    return out


@pytest.mark.parametrize("mode", ["plain", "densify"])
def test_fit_matches_reference(fits, mode):
    f = fits[mode]
    want, got = f["want"], f["got"]
    assert len(got.losses) == STEPS and all(
        isinstance(x, float) for x in got.losses)
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL,
                               atol=0)
    assert got.losses[-1] < got.losses[0]
    for k, v in want.params.items():
        w = np.asarray(v)
        g = got.params[k]
        assert not g.requires_grad and g.dtype == torch.float32
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= PARAM_TOL, (k, err)
    # The caller's tensors are not trained in place.
    np.testing.assert_array_equal(f["init"]["position4"].numpy(),
                                  _init()["position4"])


@pytest.mark.parametrize("mode", ["plain", "densify"])
def test_metrics_logger_lines_match_reference(fits, mode):
    """One JSON object a train step (every step: log_every 0) and a
    densify event, the reference's keys; densify counts equal, losses
    within the fit's tolerance."""
    ref, port = fits[mode]["ref_lines"], fits[mode]["port_lines"]
    assert [r["event"] for r in port] == [r["event"] for r in ref]
    events = [r["event"] for r in ref]
    assert events.count("train_step") == STEPS
    assert events.count("densify") == (2 if mode == "densify" else 0)
    for r, p in zip(ref, port):
        assert list(p) == list(r)
        assert isinstance(p["wall_s"], float)
        for k in r:
            if k == "loss":
                assert p[k] == pytest.approx(r[k], rel=LOSS_RTOL)
            elif k != "wall_s":
                assert p[k] == r[k], (k, p, r)
    if mode == "densify":
        assert ref[0]["event"] == "train_step" and ref[1]["n_pruned"] > 0


def test_metrics_logger_echo(capsys, tmp_path):
    log = TT.MetricsLogger(echo=True)
    log.log("x", a=torch.tensor(2), b=np.float32(0.5), c="s", d=3)
    log.close()
    rec = json.loads(capsys.readouterr().out)
    assert rec["event"] == "x" and rec["a"] == 2.0 and rec["b"] == 0.5
    assert rec["c"] == "s" and rec["d"] == 3.0


def test_checkpoint_port_to_reference(tmp_path):
    """The port's npz, read by the reference's load_checkpoint."""
    p = {k: torch.from_numpy(v) for k, v in _init().items()}
    path = str(tmp_path / "ckpt")
    TT.save_checkpoint(path, p, step=7)
    assert os.path.exists(path + ".npz")
    want = RT.load_checkpoint(path)
    assert set(want) == set(p)
    for k, v in p.items():
        np.testing.assert_array_equal(np.asarray(want[k]), v.numpy())
    assert int(np.load(path + ".npz")["__step__"]) == 7
    back = TT.load_checkpoint(path + ".npz", device="cpu")
    for k, v in p.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())


def test_checkpoint_reference_to_port(tmp_path, monkeypatch):
    """The reference's npz form (its writer where orbax cannot be
    imported), read by the port; and a directory (the reference's orbax
    form) refused with the npz form named."""
    p = {k: jnp.asarray(v) for k, v in _init().items()}
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="npz"):
        TT.load_checkpoint(str(tmp_path / "orbax"), device="cpu")
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    path = str(tmp_path / "ref")
    RT.save_checkpoint(path, p, step=3)
    got = TT.load_checkpoint(path, device="cpu")
    assert set(got) == set(p)
    for k, v in p.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    with pytest.raises(FileNotFoundError):
        TT.load_checkpoint(str(tmp_path / "missing"), device="cpu")
