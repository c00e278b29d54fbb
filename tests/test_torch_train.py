"""Frame-level gradient parity of the port with the JAX reference on the CPU,
its training losses, and a few training steps through the converged frame.

`render_params4d_packed` is differentiable with respect to the packed params
in both modes; its composite (K1/K8), tail (K7/K9) and record pack (K4) are
autograd Functions, run here through their plain PyTorch versions (CPU
tensors). The loss is sum(img[..., :3] * wts), wts from a numpy seed, so the
image cotangent is the same on both sides.

Scenes and the reference's run:
  * the converged frame is tests/test_torch_converged.py's scene (4,096
    splats at 256x128, `tail_chunk=1024`), at t = 0.37 (at t = pt the
    temporal fields get exactly zero gradient). The reference runs in one
    jit, `jax.grad` with respect to the params and to a zero offset of its
    projection (the latter is the cotangent of the projected fields from its
    own binning), with `pack8` forced off (C-R1/C-R2) and its f32 tail twin
    `tail_accumulate_xla` in place of the bf16-plane kernel (C-R5);
  * the non-converged frame is tests/test_gradcheck.py's six-splat scene
    with `quantized_depth_sort=True` on both sides (the port has no exact
    sort), in float32, with 1 and 3 deepening passes (with six splats no
    tile has pairs left, so further passes run fillers only), and the
    4,096-splat scene under `auto_render_config(..., converged=False)`.

Tolerances, per field, relative to that field's max |g| floored at 1e-4 of
the largest max |g| over all fields (the fields' scales differ by up to
1e6 here; without the floor a field like `lifetime` is compared at noise):
  * head + tail from the reference's binning: 1e-4;
  * the six-splat frames (no tied pairs): 1e-4;
  * whole frames from params: pairs tied on (tile, 20-bit depth) blend in
    sort order, arbitrary on both sides (C-R4), and that order reaches the
    gradients of the tied splats and of the splats in front of them in their
    tiles (through the suffix sums). Measured on the converged frame: mean
    error up to 1.2e-4 (cg), up to 0.88% of the splats beyond 1e-3 (sz), max
    0.15; held at a mean below 3e-4 and fewer than 2% beyond 1e-3. With the
    reference's binning handed over (no ties in play) the same frame is
    within 1e-4.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fourdgs_torch.core.camera import Camera as TCamera  # noqa: E402
from fourdgs_torch.ops import composite_cuda as TC  # noqa: E402
from fourdgs_torch.render import pipeline as TP  # noqa: E402
from fourdgs_torch.render import tiles as TT  # noqa: E402
from fourdgs_torch.render.autoconfig import \
    auto_render_config as t_auto  # noqa: E402
from fourdgs_torch.render.project import Projected as TProj  # noqa: E402
from fourdgs_torch.scenes.cube import build_cube_scene  # noqa: E402
from fourdgs_torch.splats import packed as TPK  # noqa: E402
from fourdgs_torch.train import loss as TLOSS  # noqa: E402
from test_torch_converged import (  # noqa: E402
    BIN_FIELDS, CAM, CHUNK, H, SCALE, TCAM, W, _raw_params)

T_EVAL = 0.37
# The differentiable fields of the projection (depth enters only through
# the integer depth bits; valid is a flag).
PROJ_GRAD_FIELDS = ("mx", "my", "v0x", "v0y", "l0", "l1", "r", "g", "b", "a",
                    "opacity")


def _wts(h, w):
    return np.random.default_rng(3).uniform(-1.0, 1.0, (h, w, 3)).astype(
        np.float32)


def _scales(grads):
    """Per field: max |g|, floored at 1e-4 of the largest over all fields."""
    top = max(float(np.abs(g).max()) for g in grads.values())
    assert top > 0.0
    return {k: max(float(np.abs(g).max()), 1e-4 * top)
            for k, g in grads.items()}


def _assert_grads_close(got, want, tol):
    for k, s in _scales(want).items():
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol * s,
                                   err_msg=k)


def _assert_grads_tie_close(got, want):
    """Whole frames from params: ties blend in sort order (C-R4)."""
    for k, s in _scales(want).items():
        err = np.abs(got[k] - want[k]) / s
        share = float((err > 1e-3).mean())
        assert float(err.mean()) < 3e-4, (k, float(err.mean()))
        assert share < 0.02, (k, share)


def _port_grads(params_np, camera, t, cfg, wts):
    params = {k: v.requires_grad_(True)
              for k, v in TPK.params4d_from_numpy(params_np, "cpu").items()}
    img = TP.render_params4d_packed(params, camera, t, cfg=cfg)
    (img[..., :3] * torch.from_numpy(wts)).sum().backward()
    return TPK.grads4d_to_numpy(params)


# ---------------------------------------------------------------------------
# The converged frame
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_grad():
    """The reference's gradients of the converged frame at T_EVAL, with
    respect to the params and to its projected fields, in one jit."""
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
    pm = np.array(cam.proj_matrix())
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
    wts = jnp.asarray(_wts(H, W))

    def frame(p, delta):
        cov4 = PK.cov4_motion(p)
        mx, my, mz, cov3, op, sm = PK.slice4d(p, cov4, jnp.float32(T_EVAL),
                                              0.0)
        proj = project_components(mx, my, mz, cov3,
                                  (p["cr"], p["cg"], p["cb"], p["ca"]), op,
                                  cam, sort_mean=sm)
        binning = RT.bin_splats(proj, p00, p11, W, H, **bin_kw)
        # A zero offset of the projected fields: its gradient is their
        # cotangent from this binning.
        proj_d = dataclasses.replace(proj, **{
            k: getattr(proj, k) + delta[k] for k in PROJ_GRAD_FIELDS})
        px, py, _ = RT.tile_pixel_ndc(W, H, cfg.tile_h, cfg.tile_w)
        tiles, _ = RP._composite_pallas_progressive(
            proj_d, binning, px, py, p00, p11,
            jnp.asarray(cfg.background, jnp.float32), cfg,
            return_resid=True, image_size=(W, H))
        img = RT.assemble_image(tiles, W, H, cfg.tile_h, cfg.tile_w)
        return jnp.sum(img[..., :3] * wts), (proj, binning)

    delta = {k: jnp.zeros((n,), jnp.float32) for k in PROJ_GRAD_FIELDS}
    pack_records = CP.pack_records
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CP, "pack_records",
                   lambda *a, pack8=False, **k: pack_records(*a, **k))
        mp.setattr(RTL, "tail_accumulate",
                   lambda *a, slot_mask=None, interpret=None, **k:
                   RTL.tail_accumulate_xla(*a, **k))
        (g_params, g_proj), (proj, binning) = jax.jit(
            jax.grad(frame, argnums=(0, 1), has_aux=True))(params, delta)
    return dict(params={k: np.array(v) for k, v in params.items()}, cfg=cfg,
                p00=p00, p11=p11,
                proj={f.name: np.array(getattr(proj, f.name))
                      for f in dataclasses.fields(proj)},
                binning={k: None if getattr(binning, k) is None
                         else np.array(getattr(binning, k))
                         for k in BIN_FIELDS},
                g_params={k: np.array(v) for k, v in g_params.items()},
                g_proj={k: np.array(v) for k, v in g_proj.items()})


def test_head_and_tail_grads_from_reference_binning(ref_grad, monkeypatch):
    """Gradients with respect to every differentiable projected field, from
    the reference's projection and binning; the head's transmittance row
    gets its cotangent from the tail blend (the g_T term of K8)."""
    cfg = TP.RenderConfig(**dataclasses.asdict(ref_grad["cfg"]))
    proj = TProj(**{k: torch.from_numpy(v).requires_grad_(
        k in PROJ_GRAD_FIELDS) for k, v in ref_grad["proj"].items()})
    binning = TT.TileBinning(**{
        k: None if v is None else torch.from_numpy(v)
        for k, v in ref_grad["binning"].items()})
    seen = []
    bwd = TC.composite_records_bwd

    def record(*args):
        seen.append(args[-1].detach().clone())
        return bwd(*args)
    monkeypatch.setattr(TC, "composite_records_bwd", record)
    px, py, _ = TT.tile_pixel_ndc(W, H, cfg.tile_h, cfg.tile_w,
                                  device="cpu")
    tiles, _ = TP._composite_pallas_progressive(
        proj, binning, px, py, torch.tensor(ref_grad["p00"]),
        torch.tensor(ref_grad["p11"]), torch.tensor(cfg.background), cfg,
        image_size=(W, H))
    img = TT.assemble_image(tiles, W, H, cfg.tile_h, cfg.tile_w)
    (img[..., :3] * torch.from_numpy(_wts(H, W))).sum().backward()
    got = {k: getattr(proj, k).grad.numpy() for k in PROJ_GRAD_FIELDS}
    _assert_grads_close(got, ref_grad["g_proj"], 1e-4)
    # The background's rgb is 0, so only the tail blend reaches the head's
    # transmittance; its cotangent is nonzero.
    g_head, = seen
    assert float(g_head[:, 4].abs().max()) > 0.0


def test_converged_frame_grads_match_reference(ref_grad):
    cfg = TP.RenderConfig(**dataclasses.asdict(ref_grad["cfg"]))
    got = _port_grads(ref_grad["params"], TCamera.create(**TCAM), T_EVAL, cfg,
                      _wts(H, W))
    want = ref_grad["g_params"]
    _assert_grads_tie_close(got, want)
    for k in TPK.PARAM4D_FIELDS:
        assert np.all(np.isfinite(got[k])) and np.abs(got[k]).max() > 0, k


# ---------------------------------------------------------------------------
# The non-converged frame
# ---------------------------------------------------------------------------

SIX_W, SIX_H = 128, 32


def _six_splat_scene():
    """tests/test_gradcheck.py's scene, in float32."""
    rng = np.random.default_rng(7)
    n = 6

    def f(*a):
        return np.asarray(a, np.float32)
    return dict(
        px=f(-3.0, -1.2, 0.4, 1.8, 3.1, -0.3),
        py=f(0.5, -0.6, 0.9, -0.2, 0.1, -0.8),
        pz=f(-9.0, -11.0, -10.0, -12.5, -9.5, -10.5),
        pt=f(0.0, 0.1, -0.2, 0.3, -0.1, 0.2),
        qw=f(*rng.normal(1.0, 0.2, n)), qx=f(*rng.normal(0.0, 0.3, n)),
        qy=f(*rng.normal(0.0, 0.3, n)), qz=f(*rng.normal(0.0, 0.3, n)),
        sx=f(*rng.uniform(0.5, 1.2, n)), sy=f(*rng.uniform(0.5, 1.2, n)),
        sz=f(*rng.uniform(0.5, 1.2, n)),
        lifetime=f(*rng.uniform(2.0, 4.0, n)),
        fade=f(*rng.uniform(0.3, 0.7, n)),
        vx=f(*rng.normal(0.0, 0.4, n)), vy=f(*rng.normal(0.0, 0.4, n)),
        vz=f(*rng.normal(0.0, 0.4, n)),
        cr=f(*rng.uniform(0.2, 0.9, n)), cg=f(*rng.uniform(0.2, 0.9, n)),
        cb=f(*rng.uniform(0.2, 0.9, n)), ca=f(*rng.uniform(0.4, 0.8, n)))


def _ref_frame_grads(params_np, cam_kw, t, cfg, wts):
    from fourdgs.core.camera import Camera
    from fourdgs.render.pipeline import render_params4d_packed
    cam = Camera.create(**cam_kw)

    def loss(p):
        img = render_params4d_packed(p, cam, jnp.float32(t), cfg=cfg)
        return jnp.sum(img[..., :3] * jnp.asarray(wts))
    g = jax.jit(jax.grad(loss))({k: jnp.asarray(v)
                                 for k, v in params_np.items()})
    return {k: np.array(v) for k, v in g.items()}


@pytest.mark.parametrize("passes", [1, 3])
def test_six_splat_frame_grads_match_reference(passes):
    from fourdgs.render.pipeline import RenderConfig
    cfg = RenderConfig(tile_h=8, tile_w=128, backend="pallas",
                       max_splats_per_tile=128, max_tiles_per_splat=16,
                       quantized_depth_sort=True, deepening_passes=passes,
                       deepening_fraction=1.0)
    cam_kw = dict(position=(0.0, 0.0, 0.0), orientation=(0.0, 0.0, -1.0),
                  width=SIX_W, height=SIX_H)
    params = _six_splat_scene()
    wts = _wts(SIX_H, SIX_W)
    want = _ref_frame_grads(params, cam_kw, T_EVAL, cfg, wts)
    got = _port_grads(params, TCamera.create(**cam_kw, device="cpu"), T_EVAL,
                      TP.RenderConfig(**dataclasses.asdict(cfg)), wts)
    _assert_grads_close(got, want, 1e-4)
    for k in TPK.PARAM4D_FIELDS:
        assert np.abs(got[k]).max() > 0, k


def test_non_converged_frame_grads_match_reference():
    """The 4,096-splat scene under auto_render_config(converged=False),
    where the deepening passes composite real pairs (K1/K8 with `sel`)."""
    from fourdgs.render.autoconfig import auto_render_config
    from fourdgs.splats import packed as PK
    params = {k: jnp.asarray(v) for k, v in _raw_params().items()}
    params = {k: np.array(v) for k, v in PK.pad_packed_params(
        PK.morton_order(params), CHUNK).items()}
    cfg = auto_render_config(params["px"].shape[0], W, H, converged=False)
    wts = _wts(H, W)
    want = _ref_frame_grads(params, CAM, T_EVAL, cfg, wts)
    launches = []
    at = TP.composite_records_at

    def count(rec, cnt, *a):
        launches.append(int(cnt.sum()))
        return at(rec, cnt, *a)
    TP.composite_records_at = count
    try:
        got = _port_grads(params, TCamera.create(**TCAM), T_EVAL,
                          TP.RenderConfig(**dataclasses.asdict(cfg)), wts)
    finally:
        TP.composite_records_at = at
    assert sum(launches) > 0            # deepening composited real pairs
    _assert_grads_tie_close(got, want)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["l2", "l1", "ssim", "photometric"])
def test_losses_match_reference(name):
    from fourdgs.train import loss as RL
    rng = np.random.default_rng(11)
    img = rng.uniform(0.0, 1.0, (20, 24, 4)).astype(np.float32)
    target = rng.uniform(0.0, 1.0, (20, 24, 4)).astype(np.float32)
    want, want_g = jax.value_and_grad(getattr(RL, name))(jnp.asarray(img),
                                                         jnp.asarray(target))
    x = torch.from_numpy(img).requires_grad_(True)
    got = getattr(TLOSS, name)(x, torch.from_numpy(target))
    got.backward()
    # Means over the image in another summation order: 1.8e-6 measured.
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _assert_grads_close({"img": x.grad.numpy()}, {"img": np.array(want_g)},
                        1e-5)


def test_avg_pool_is_valid_uniform_window():
    x = torch.arange(5 * 6 * 2, dtype=torch.float32).reshape(5, 6, 2)
    got = TLOSS._avg_pool(x, 3)
    assert got.shape == (3, 4, 2)
    torch.testing.assert_close(got[1, 2], x[1:4, 2:5].mean(dim=(0, 1)))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _cube(seed):
    p = build_cube_scene(4000, seed=seed, device="cpu")
    p = {k: v * SCALE if k in ("px", "py", "pz") else v for k, v in p.items()}
    return TPK.pad_packed_params(TPK.morton_order(p), CHUNK)


def test_training_through_converged_frame():
    """The analogue of tests/test_tail.py::test_training_through_converged_
    stack: four Adam steps through the converged frame toward a target
    rendered from another seed; the loss falls and every gradient is
    finite."""
    cam = TCamera.create(**TCAM)
    cfg = t_auto(4096, W, H, tail_chunk=CHUNK)
    with torch.no_grad():
        target = TP.render_params4d_packed(_cube(8), cam, 0.0, cfg=cfg)
    params = {k: v.requires_grad_(True) for k, v in _cube(7).items()}
    opt = torch.optim.Adam(params.values(), lr=5e-2)
    losses = []
    for _ in range(4):
        opt.zero_grad()
        loss = TLOSS.l2(TP.render_params4d_packed(params, cam, 0.0, cfg=cfg),
                        target)
        loss.backward()
        assert all(bool(torch.isfinite(v.grad).all())
                   for v in params.values())
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0], losses
