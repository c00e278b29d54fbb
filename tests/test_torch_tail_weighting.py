"""The tail's within-band weighting on the CPU: the depth weight (wd_ab, from
`tail_depth_beta`) and the opacity power (alpha_pow) of the port's tail
(fourdgs_torch/ops/tail_cuda.py) against the JAX reference
(fourdgs/ops/tail_pallas.py).

Inputs are the numpy fixture of tests/test_torch_tail.py with the depth
weight coefficients the reference's own `band_weight_coeffs` makes at
beta = 8 from the fixture's band cuts (weights up to e^8). Tolerances:
  * global_band_extremes: exact; band_weight_coeffs: 1e-6 relative;
  * the plain accumulate against the reference's f32 twin
    `tail_accumulate_xla`: 1e-5 of the accumulator's largest magnitude
    (the same per-sample float32 operations, sums in another order; the
    weights make the planes span orders of magnitude, so the tolerance is
    relative to the largest); against the reference's kernel in interpret
    mode: 5e-3 of it (that kernel rounds its planes to bf16, ROADMAP C-R5);
  * the backward against `jax.vjp` of the twin: 3e-6 of each field's
    largest cotangent. The weighted chain is the kernel's closed form,
    (1 + p) alpha^p w_d (dA + ...) + (2 + p) alpha^(1+p) w_d dA2, where jax
    differentiates aw = alpha w_d and aw alpha^p term by term: the two
    orders of float32 operations leave the elements at a field's largest
    magnitude 1.3e-6 to 1.5e-6 of their own value apart (measured); the
    unweighted backward keeps its 1e-6 (tests/test_torch_tail_units.py);
  * the unit-walk models of K7 / K9 against the plain versions: 1e-6;
  * a float64 gradcheck with both knobs;
  * the converged frame at tail_depth_beta = 8 against the reference's
    (its f32 tail twin monkeypatched in, as tests/test_torch_converged.py
    does): from the reference's binning within 1e-4, end to end under the
    tie tolerance (mean < 1e-4, fewer than 1% of pixels above 1e-3).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.autograd import gradcheck  # noqa: E402

from fourdgs.ops import tail_pallas as RT  # noqa: E402
from fourdgs_torch.ops import tail_cuda as TL  # noqa: E402
from test_torch_tail import _fixture, _t  # noqa: E402

NAMES = ("fields", "meta", "band", "rect", "cut", "params_row")
BETA = 8.0


def _close(got, want, rel):
    scale = float(np.abs(want).max())
    assert scale > 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _weights(fx, beta=BETA):
    """(S, 2) coefficients: the reference's band_weight_coeffs from the
    fixture's band cuts and the live depth extremes, gathered by band."""
    meta = fx["meta"]
    keys = np.where(meta[5] > 0, meta[4], np.iinfo(np.int32).max)
    d_lo, d_hi = RT.global_band_extremes(jnp.asarray(keys))
    coeffs = RT.band_weight_coeffs(jnp.asarray(fx["band_cuts"]), d_lo, d_hi,
                                   fx["k_bands"], beta)
    return np.asarray(coeffs)[fx["band"]]


def _case(budget=3, budget_lo=0, chunk=256, n=3000, seed=None):
    fx = _fixture(n=n, chunk=chunk, budget=budget,
                  seed=budget if seed is None else seed)
    kw = dict(k_bands=fx["k_bands"], nx=fx["nx"], ny=fx["ny"], chunk=chunk,
              budget=budget, budget_lo=budget_lo)
    return fx, kw, _weights(fx)


@pytest.mark.parametrize("beta", [1.0, BETA])
def test_band_weight_coeffs_match_reference(beta):
    rng = np.random.default_rng(3)
    keys = ((rng.integers(0, 40, 5000) << 20)
            | rng.integers(1000, 900_000, 5000)).astype(np.int32)
    keys[rng.random(5000) < 0.3] = np.iinfo(np.int32).max
    w_lo, w_hi = RT.global_band_extremes(jnp.asarray(keys))
    g_lo, g_hi = TL.global_band_extremes(_t(keys))
    assert (int(g_lo), int(g_hi)) == (int(w_lo), int(w_hi))
    assert g_lo.dtype == g_hi.dtype == torch.int32
    for k_bands in (4, 8):
        cuts = RT.global_band_cuts(jnp.asarray(keys), k_bands)
        want = np.asarray(RT.band_weight_coeffs(cuts, w_lo, w_hi, k_bands,
                                                beta))
        got = TL.band_weight_coeffs(TL.global_band_cuts(_t(keys), k_bands),
                                    g_lo, g_hi, k_bands, beta)
        assert got.dtype == torch.float32 and got.shape == (k_bands, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # Every live sample of no dead key weighs between 1 and e^beta.
    d = keys[keys != np.iinfo(np.int32).max] & ((1 << 20) - 1)
    assert int(g_lo) == d.min() and int(g_hi) == d.max()


@pytest.mark.parametrize("alpha_pow", [0, 1, 2])
@pytest.mark.parametrize("budget,budget_lo", [(3, 0), (9, 3)])
def test_weighted_tail_matches_twin_and_kernel(budget, budget_lo, alpha_pow):
    fx, kw, wd_ab = _case(budget, budget_lo)
    ref_args = [jnp.asarray(fx[k]) for k in NAMES]
    want = np.asarray(RT.tail_accumulate_xla(
        *ref_args, s_cy=4, s_cx=16, wd_ab=jnp.asarray(wd_ab),
        alpha_pow=alpha_pow, exact_clip=True, **kw))
    got = TL.tail_accumulate(*(_t(fx[k]) for k in NAMES), s_cy=4, s_cx=16,
                             wd_ab=_t(wd_ab), alpha_pow=alpha_pow,
                             exact_clip=True, **kw).numpy()
    _close(got, want, 1e-5)
    # The weights really act: the A plane is no longer the unweighted one.
    plain = TL.tail_accumulate(*(_t(fx[k]) for k in NAMES), s_cy=4, s_cx=16,
                               exact_clip=True, **kw).numpy()
    assert float(np.abs(got[:, :64] - plain[:, :64]).max()) > 1e-3
    np.testing.assert_array_equal(got[:, 5 * 64:], plain[:, 5 * 64:])
    mask = RT.step_slot_masks(ref_args[1], kw["chunk"], budget,
                              budget_lo=budget_lo)
    kern = np.asarray(RT.tail_accumulate(
        *ref_args, s_cy=4, s_cx=16, slot_mask=mask, wd_ab=jnp.asarray(wd_ab),
        alpha_pow=alpha_pow, exact_clip=True, interpret=True, **kw))
    _close(got, kern, 5e-3)


def _d_acc(kw, n_samp, seed):
    rows = kw["k_bands"] * kw["nx"] * TL.ny_padded(kw["ny"])
    return np.random.default_rng(seed).standard_normal(
        (rows, TL.N_PLANES * n_samp)).astype(np.float32)


@pytest.mark.parametrize("alpha_pow", [0, 1, 2])
@pytest.mark.parametrize("budget,budget_lo", [(3, 0), (9, 3)])
def test_weighted_tail_backward_matches_twin_vjp(budget, budget_lo,
                                                 alpha_pow):
    fx, kw, wd_ab = _case(budget, budget_lo)
    d_acc = _d_acc(kw, 16, budget + alpha_pow)
    args = [jnp.asarray(fx[k]) for k in NAMES]
    _, vjp = jax.vjp(lambda x: RT.tail_accumulate_xla(
        x, *args[1:], s_cy=2, s_cx=8, wd_ab=jnp.asarray(wd_ab),
        alpha_pow=alpha_pow, exact_clip=True, **kw), args[0])
    want, = vjp(jnp.asarray(d_acc))
    want = np.asarray(want)
    fields = _t(fx["fields"]).requires_grad_(True)
    acc = TL.tail_accumulate(fields, *(_t(fx[k]) for k in NAMES[1:]),
                             s_cy=2, s_cx=8, wd_ab=_t(wd_ab),
                             alpha_pow=alpha_pow, exact_clip=True, **kw)
    acc.backward(_t(d_acc))
    got = fields.grad.numpy()
    for f in range(10):
        _close(got[f], want[f], 3e-6)
    # wd_ab is a function of integer depth bits: it gets no cotangent.
    wd = _t(wd_ab).requires_grad_(True)
    acc = TL.tail_accumulate(_t(fx["fields"]).requires_grad_(True),
                             *(_t(fx[k]) for k in NAMES[1:]), s_cy=2, s_cx=8,
                             wd_ab=wd, alpha_pow=alpha_pow, **kw)
    acc.sum().backward()
    assert wd.grad is None


@pytest.mark.parametrize("alpha_pow", [0, 2])
def test_weighted_unit_walk_matches_plain(alpha_pow):
    fx, kw, wd_ab = _case(9, 3)
    t = {k: _t(fx[k]) for k in NAMES}
    mask = TL.step_slot_masks(t["meta"], kw["chunk"], 9, 3)
    common = (t["fields"], t["meta"], t["band"], t["cut"], t["params_row"])
    knobs = dict(wd_ab=_t(wd_ab), alpha_pow=alpha_pow, exact_clip=True)
    got = TL.tail_accumulate_units(*common, s_cy=2, s_cx=16, slot_mask=mask,
                                   **knobs, **kw).numpy()
    plain = TL.tail_accumulate_plain(*common, s_cy=2, s_cx=16, **knobs,
                                     **kw).numpy()
    _close(got, plain, 1e-6)
    d_acc = _t(_d_acc(kw, 32, 4))
    got_b = TL.tail_accumulate_bwd_units(*common, d_acc, s_cy=2, s_cx=16,
                                         slot_mask=mask, **knobs,
                                         **kw).numpy()
    plain_b = TL.tail_accumulate_bwd_plain(*common, d_acc, s_cy=2, s_cx=16,
                                           **knobs, **kw).numpy()
    for f in range(10):
        _close(got_b[f], plain_b[f], 1e-6)


def test_weighted_tail_gradcheck_float64():
    fx = _fixture(n=600, nx=4, ny=5, chunk=128, budget=3, seed=7)
    kw = dict(k_bands=fx["k_bands"], nx=4, ny=5, chunk=128, budget=3,
              s_cy=2, s_cx=4, exact_clip=True, alpha_pow=2)
    wd_ab = _t(_weights(fx, beta=2.0)).double()
    rest = [_t(fx[k]) for k in NAMES[1:5]] + [_t(fx["params_row"]).double()]
    mask = TL.step_slot_masks(rest[0], 128, 3)
    fields = _t(fx["fields"]).double().requires_grad_(True)
    acc = TL.tail_accumulate(fields, *rest, slot_mask=mask, wd_ab=wd_ab, **kw)
    assert acc.dtype == torch.float64
    assert float(acc.detach().abs().sum()) > 1.0
    assert gradcheck(lambda x: TL.tail_accumulate(
        x, *rest, slot_mask=mask, wd_ab=wd_ab, **kw), (fields,), eps=1e-6,
        atol=1e-5, rtol=1e-4, fast_mode=True)


def test_tail_rejects_malformed_weights():
    fx, kw, wd_ab = _case()
    args = [_t(fx[k]) for k in NAMES]
    with pytest.raises(ValueError, match="wd_ab"):
        TL.tail_accumulate(*args, s_cy=1, s_cx=8, wd_ab=_t(wd_ab[1:]), **kw)
    with pytest.raises(ValueError, match="alpha_pow"):
        TL.tail_accumulate(*args, s_cy=1, s_cx=8, alpha_pow=-1, **kw)


# ---------------------------------------------------------------------------
# the converged frame at tail_depth_beta = 8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_beta():
    """The reference's converged frame at tail_depth_beta = 8 on the scene
    of tests/test_torch_converged.py, its f32 tail twin in place of its
    kernel and its head gathered without pack8 (ROADMAP C-R1, C-R5)."""
    from fourdgs.core.camera import Camera
    from fourdgs.ops import composite_pallas as CP
    from fourdgs.render import pipeline as RP
    from fourdgs.render import tiles as RTT
    from fourdgs.render.autoconfig import auto_render_config
    from fourdgs.render.project import project_components
    from fourdgs.splats import packed as PK
    from test_torch_converged import BIN_FIELDS, CAM, CHUNK, H, W, \
        _raw_params

    params = {k: jnp.asarray(v) for k, v in _raw_params().items()}
    params = PK.pad_packed_params(PK.morton_order(params), CHUNK)
    n = int(params["px"].shape[0])
    cam = Camera.create(**CAM)
    cfg = dataclasses.replace(auto_render_config(n, W, H, tail_chunk=CHUNK),
                              tail_depth_beta=BETA)
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

    def stages(p):
        cov4 = PK.cov4_motion(p)
        mx, my, mz, cov3, op, sm = PK.slice4d(p, cov4, 0.0, 0.0)
        proj = project_components(mx, my, mz, cov3,
                                  (p["cr"], p["cg"], p["cb"], p["ca"]), op,
                                  cam, sort_mean=sm)
        binning = RTT.bin_splats(proj, p00, p11, W, H, **bin_kw)
        px, py, _ = RTT.tile_pixel_ndc(W, H, cfg.tile_h, cfg.tile_w)
        tiles, resid = RP._composite_pallas_progressive(
            proj, binning, px, py, p00, p11,
            jnp.asarray(cfg.background, jnp.float32), cfg,
            return_resid=True, image_size=(W, H))
        img = RTT.assemble_image(tiles, W, H, cfg.tile_h, cfg.tile_w)
        return proj, binning, img

    pack_records = CP.pack_records
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CP, "pack_records",
                   lambda *a, pack8=False, **k: pack_records(*a, **k))
        mp.setattr(RT, "tail_accumulate",
                   lambda *a, slot_mask=None, interpret=None, **k:
                   RT.tail_accumulate_xla(*a, **k))
        proj, binning, img = jax.jit(lambda p: stages(p))(params)
    return dict(params={k: np.array(v) for k, v in params.items()}, cfg=cfg,
                p00=p00, p11=p11, W=W, H=H, cam=CAM,
                proj={f.name: np.array(getattr(proj, f.name))
                      for f in dataclasses.fields(proj)},
                binning={k: None if getattr(binning, k) is None
                         else np.array(getattr(binning, k))
                         for k in BIN_FIELDS},
                img=np.array(img))


def test_beta_frame_from_reference_binning(ref_beta):
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render import tiles as TT
    from fourdgs_torch.render.project import Projected
    r = ref_beta
    cfg = TP.RenderConfig(**dataclasses.asdict(r["cfg"]))
    binning = TT.TileBinning(**{k: None if v is None else torch.from_numpy(v)
                                for k, v in r["binning"].items()})
    proj = Projected(**{k: torch.from_numpy(v) for k, v in r["proj"].items()})
    px, py, _ = TT.tile_pixel_ndc(r["W"], r["H"], cfg.tile_h, cfg.tile_w,
                                  device="cpu")
    tiles, _ = TP._composite_pallas_progressive(
        proj, binning, px, py, torch.tensor(r["p00"]),
        torch.tensor(r["p11"]), torch.tensor(cfg.background), cfg,
        image_size=(r["W"], r["H"]))
    img = TT.assemble_image(tiles, r["W"], r["H"], cfg.tile_h,
                            cfg.tile_w).numpy()
    np.testing.assert_allclose(img, r["img"], rtol=0, atol=1e-4)
    # The weight moves the frame: beta = 0 renders another one.
    tiles0, _ = TP._composite_pallas_progressive(
        proj, binning, px, py, torch.tensor(r["p00"]),
        torch.tensor(r["p11"]), torch.tensor(cfg.background),
        dataclasses.replace(cfg, tail_depth_beta=0.0),
        image_size=(r["W"], r["H"]))
    assert float((tiles0 - tiles).abs().max()) > 1e-3


def test_beta_frame_matches_reference(ref_beta):
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.splats import packed as TPK
    r = ref_beta
    cfg = TP.RenderConfig(**dataclasses.asdict(r["cfg"]))
    assert cfg.tail_depth_beta == BETA and cfg.tail_mode == "banded"
    params = TPK.params4d_from_numpy(r["params"], "cpu")
    img, aux = TP.render_params4d_packed(
        params, Camera.create(**r["cam"], device="cpu"), 0.0, cfg=cfg,
        return_aux=True)
    assert int(aux["overflowed"]) == int(aux["compact_dropped"]) == 0
    assert float(aux["resid_transmittance"]) == 0.0
    img = img.numpy()
    assert np.isfinite(img).all()
    # Pairs tied on (tile, 20-bit depth) blend in arbitrary order on both
    # sides (ROADMAP C-R4): the tie tolerance of PERF.md.
    err = np.abs(img - r["img"]).max(axis=-1)
    assert float(err.mean()) < 1e-4
    assert float((err > 1e-3).mean()) < 0.01
