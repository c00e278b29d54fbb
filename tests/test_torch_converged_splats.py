"""Parity of `render_splats4d` under a converged config (exact head plus the
streaming banded-OIT tail) with the JAX reference on the CPU: the path the
viewer's --converged and a converged fit take, from the trainer's
parameters (`materialize_splats`, `project_splats`) rather than the packed
dict of tests/test_torch_converged.py.

The scene: 192 motion splats made from a seed with numpy, at 64x48, t =
0.37, under the viewer's converged config (`viewer.cli`: 8x128 tiles, tail
block 4x8, tile budget 8) cut to the scene: M = 128 (the composite's
record slab, a multiple of 128 in the reference), prune cap 16, tail chunk
128 (the splats pad to two chunks), and no big-splat tier (no splat can
span more than the 8-tile budget of a 6-tile image; held in
tests/test_torch_converged.py). The depth prune samples one key in 67, so
a tile hands pairs to the tail only beyond ~67 pairs: hence more splats
than the other parity files' 64.

The reference runs with three test-side substitutions, for the reasons of
tests/test_torch_converged.py and for time (its kernels' grads in interpret
mode take minutes here; each kernel's plain version is held against them in
the other test_torch_* files): `pack_records(pack8=False)` (C-R1, C-R2);
its composite and tail through their f32 XLA twins
`_xla_composite_from_records` and `tail_accumulate_xla` (C-R5); and the
plain row-sort compaction (`compact_backend="xla"`, on both sides).

Tolerances: counters equal; the frame within the tie tolerance of PERF.md
section 2 (mean |d| < 1e-4, < 1% of pixels above 1e-3); gradients of a
weighted sum of the frame within 1e-4 of each field's max |g|, but 1e-3 at
splats whose screen footprint is nearly round (axis ratio l1 / l0 < 1.1):
the footprint's eigenvector, and so the rotation's gradient, changes as
1 / (lambda_max - lambda_min), which turns last-bit differences of the two
sides' float32 covariances into up to 3e-4 there (ROADMAP C-R7).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fourdgs.core.camera import Camera as RCamera  # noqa: E402
from fourdgs.parallel.distributed import materialize_splats as r_mat  # noqa: E402
from fourdgs.render import pipeline as RP  # noqa: E402
from fourdgs.render.autoconfig import auto_render_config as r_auto  # noqa: E402
from fourdgs_torch.core.camera import Camera as TCamera  # noqa: E402
from fourdgs_torch.parallel.distributed import materialize_splats as t_mat  # noqa: E402
from fourdgs_torch.render import pipeline as TP  # noqa: E402
from fourdgs_torch.render.autoconfig import auto_render_config as t_auto  # noqa: E402

N, W, H, T = 192, 64, 48, 0.37
CFG = dict(tile_h=8, max_splats_per_tile=128, max_tiles_per_splat=8,
           depth_prune_cap=16, tail_block=(4, 8), tail_chunk=128,
           big_splat_budget=0, compact_backend="xla")
FRAME_MEAN, FRAME_SHARE, GRAD_TOL = 1e-4, 0.01, 1e-4
ROUND_RATIO, ROUND_GRAD_TOL = 1.1, 1e-3


def _params(seed=3):
    """Splats at distances 18 + 0.06 k from the camera (k a permutation of
    0..N-1) in directions inside the view, with velocities small enough
    that the sorting mean moves by < 0.02: the 20-bit depth keys (steps of
    ~0.008 at these distances) are all distinct, so no two pairs of a tile
    tie and the blend order is the same on both sides (C-R4)."""
    rng = np.random.default_rng(seed)
    dirs = np.concatenate([rng.uniform(-0.12, 0.12, (N, 2)),
                           -np.ones((N, 1))], -1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dist = 18.0 + 0.06 * rng.permutation(N)
    pos = np.concatenate([dirs * dist[:, None],
                          rng.uniform(-0.5, 0.5, (N, 1))], -1)
    return dict(
        position4=pos.astype(np.float32),
        quat=rng.normal(size=(N, 4)).astype(np.float32),
        scale3=rng.uniform(0.8, 2.0, (N, 3)).astype(np.float32),
        lifetime=rng.uniform(1.5, 3.0, N).astype(np.float32),
        fade=rng.uniform(0.3, 0.7, N).astype(np.float32),
        velocity=(rng.normal(size=(N, 3)) * 4e-3).astype(np.float32),
        color=rng.uniform(0.2, 1.0, (N, 4)).astype(np.float32))


def _wts():
    return np.linspace(0.5, 1.5, H * W * 4, dtype=np.float32).reshape(H, W, 4)


@pytest.fixture(scope="module")
def ref():
    from fourdgs.ops import composite_pallas as CP
    from fourdgs.ops import tail_pallas as RTL
    cam = RCamera.create(position=(0.0, 0.0, 0.0), width=W, height=H)
    cfg = r_auto(400_000, W, H, **CFG)
    wts = jnp.asarray(_wts())

    def loss(p):
        img, aux = RP.render_splats4d(r_mat(p), cam, jnp.float32(T), cfg=cfg,
                                      return_aux=True)
        return jnp.sum(img * wts), (img, aux)
    pack_records = CP.pack_records
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CP, "pack_records",
                   lambda *a, pack8=False, **k: pack_records(*a, **k))
        mp.setattr(CP, "composite_records", CP._xla_composite_from_records)
        mp.setattr(RTL, "tail_accumulate",
                   lambda *a, slot_mask=None, interpret=None, **k:
                   RTL.tail_accumulate_xla(*a, **k))
        (_, (img, aux)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))({k: jnp.asarray(v)
                                  for k, v in _params().items()})
    return dict(img=np.asarray(img), aux={k: float(v) for k, v in aux.items()},
                grads={k: np.asarray(v) for k, v in grads.items()})


def _tcam():
    return TCamera.create(position=(0.0, 0.0, 0.0), width=W, height=H,
                          device="cpu")


def _port(cfg_over=None):
    cam = _tcam()
    cfg = t_auto(400_000, W, H, **dict(CFG, **(cfg_over or {})))
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in _params().items()}
    img, aux = TP.render_splats4d(t_mat(leaves), cam, torch.tensor(T),
                                  cfg=cfg, return_aux=True)
    (img * torch.from_numpy(_wts())).sum().backward()
    return img.detach().numpy(), {k: float(v) for k, v in aux.items()}, {
        k: v.grad.numpy() for k, v in leaves.items()}


@pytest.fixture(scope="module")
def port():
    return _port()


def test_converged_config_is_the_viewers():
    from fourdgs.viewer.cli import build_argparser
    from fourdgs_torch.viewer import cli as TV
    args = build_argparser().parse_args(["--converged", "--width", "64",
                                         "--height", "48"])
    got = TV.viewer_config(args, (0.0, 0.0, 0.0, 1.0))
    assert got.tail_mode == "banded" and got.backend == "pallas"
    want = r_auto(400_000, 64, 48, background=(0.0, 0.0, 0.0, 1.0),
                  tile_h=8, max_splats_per_tile=256, max_tiles_per_splat=8,
                  depth_prune_cap=256, tail_block=(4, 8), tail_chunk=1024)
    import dataclasses
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_converged_frame_matches_reference(ref, port):
    img, aux, _ = port
    assert aux == ref["aux"]
    assert aux["resid_transmittance"] == 0 and aux["overflowed"] == 0
    d = np.abs(img - ref["img"])
    assert d.mean() < FRAME_MEAN and (d > 1e-3).mean() < FRAME_SHARE, (
        d.mean(), d.max())
    assert img[..., :3].max() > 0.1            # lit


def test_converged_frame_has_a_tail(port):
    """The prune cap hands the deep tiles' farther pairs to the tail: the
    head alone (no tail, one pass) loses them, and says so in its
    residual."""
    img, aux, _ = port
    head, aux, _ = _port(dict(tail_mode="off", deepening_passes=1))
    assert aux["resid_transmittance"] > 0
    assert np.abs(img - head).max() > 1e-3


def test_converged_grads_match_reference(ref, port):
    from fourdgs_torch.render.project import project_splats
    _, _, grads = port
    s = t_mat({k: torch.from_numpy(v) for k, v in _params().items()})
    sliced, top = s.at_time(torch.tensor(T))
    proj = project_splats(sliced.position, sliced.cov, sliced.color, top,
                          _tcam())
    round_ = (proj.l1 / proj.l0).numpy() < ROUND_RATIO
    tol = np.where(round_, ROUND_GRAD_TOL, GRAD_TOL)
    for k, want in ref["grads"].items():
        scale = np.abs(want).max()
        assert scale > 0, k
        err = np.abs(grads[k] - want).reshape(N, -1).max(1) / scale
        assert np.all(err <= tol), (k, err.max(), np.argmax(err / tol))
