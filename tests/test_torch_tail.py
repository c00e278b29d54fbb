"""Parity of the port's tail and pack modules (fourdgs_torch/ops/tail_cuda.py,
pack_cuda.py) with the JAX reference on the CPU.

Inputs are made with numpy from fixed seeds (the shapes of
tests/test_tail.py::_fixture) and handed to both sides. The reference's
Pallas kernels run in interpret mode, as its own tests run them; the port
runs its kernels' plain PyTorch versions (CPU tensors). Tolerances:
  * integer plumbing (meta, band, rect, slot mask, band cuts) and the pack
    kernels: exact;
  * tail_params_row: 1e-7 relative (the same float32 operations);
  * the accumulate against the reference's f32 twin tail_accumulate_xla:
    1e-5 (the same per-sample operations, sums in another order); against
    the reference's kernel: 5e-3, because that kernel rounds its planes to
    bf16 before summing (ROADMAP C-R5);
  * band combine, fold/upsample and blend: 1e-6 (float32 rounding; the
    bilinear upsample is jax.image.resize against F.interpolate).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fourdgs.ops import tail_pallas as RT  # noqa: E402
from fourdgs_torch.ops import pack_cuda as TPK  # noqa: E402
from fourdgs_torch.ops import tail_cuda as TL  # noqa: E402

INT32_MAX = np.iinfo(np.int32).max


def _bbox(n=3000, nx=6, ny=10, seed=0):
    rng = np.random.default_rng(seed)
    tx0 = rng.integers(0, nx, n).astype(np.int32)
    ty0 = rng.integers(0, ny, n).astype(np.int32)
    tx1 = np.minimum(tx0 + rng.integers(0, 3, n), nx - 1).astype(np.int32)
    ty1 = np.minimum(ty0 + rng.integers(0, 3, n), ny - 1).astype(np.int32)
    alive = rng.random(n) > 0.2
    dbits = rng.integers(0, 1 << 20, n).astype(np.int32)
    return alive, tx0, tx1, ty0, ty1, dbits


def _fixture(n=3000, nx=6, ny=10, k_bands=3, chunk=256, budget=3, seed=0):
    """tests/test_tail.py::_fixture in numpy: (inputs as numpy, dict)."""
    rng = np.random.default_rng(seed)
    bbox = _bbox(n, nx, ny, seed)
    fields = np.zeros((10, n), np.float32)
    fields[0] = rng.normal(0, 0.5, n)      # sx (k units)
    fields[1] = rng.normal(0, 0.5, n)
    th = rng.uniform(0, 2 * np.pi, n)
    fields[2] = np.cos(th)
    fields[3] = np.sin(th)
    fields[4] = 1.0 / rng.uniform(0.05, 0.4, n)
    fields[5] = 1.0 / rng.uniform(0.05, 0.4, n)
    fields[6:9] = rng.uniform(0, 1, (3, n))
    fields[9] = rng.uniform(0, 0.95, n)
    cut = ((np.arange(nx * ny, dtype=np.int32) << 20)
           | rng.integers(0, 1 << 20, nx * ny).astype(np.int32))
    params_row = np.array([0.22, 0.028, -0.9, -0.18, -0.04, 0.8, 1e-4, 2e-4],
                          np.float32)
    meta = np.array(RT.tail_meta(*(jnp.asarray(a) for a in bbox), chunk))
    npad = meta.shape[1]
    steps = npad // chunk
    band = rng.integers(0, k_bands, steps).astype(np.int32)
    band_cuts = np.sort(rng.integers(-(1 << 20), 0, k_bands - 1)
                        ).astype(np.int32)
    _, rect = RT.step_bands_rects(jnp.asarray(meta), chunk,
                                  jnp.asarray(band_cuts))
    return dict(fields=np.pad(fields, ((0, 0), (0, npad - n))), meta=meta,
                band=band, rect=np.asarray(rect), cut=cut,
                params_row=params_row, band_cuts=band_cuts, k_bands=k_bands,
                nx=nx, ny=ny, chunk=chunk, budget=budget)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# K4 / K5: pack kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,pad_to", [(3000, 4096), (2048, 2048)])
def test_pack_record_fields_matches_reference(n, pad_to):
    from fourdgs.ops.pack_pallas import pack_record_fields
    rng = np.random.default_rng(n)
    rows = [rng.standard_normal(n).astype(np.float32) for _ in range(10)]
    rows[4][::7] = 0.0                   # l == 0 maps to il == 0
    rows[5][3::11] = 0.0
    p00, p11 = np.float32(1.7320508), np.float32(3.4641016)
    want = np.asarray(pack_record_fields(
        *(jnp.asarray(r) for r in rows), jnp.float32(p00), jnp.float32(p11),
        pad_to, interpret=True))
    got = TPK.pack_record_fields(*(_t(r) for r in rows), torch.tensor(p00),
                                 torch.tensor(p11), pad_to).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got[4, ::7][:-(-n // 7)] == 0.0)
    assert np.all(got[:, n:] == 0.0)


@pytest.mark.parametrize("chunk", [256, 200])
def test_tail_meta_matches_reference(chunk):
    """chunk 256 pads 3000 to 3072 (the reference's pack kernel); chunk 200
    keeps 3000 (its jnp.stack): the same matrix either way."""
    bbox = _bbox()
    want = np.asarray(RT.tail_meta(*(jnp.asarray(a) for a in bbox), chunk))
    got = TL.tail_meta(*(_t(a) for a in bbox), chunk).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (6, -(-3000 // chunk) * chunk)
    assert np.all(got[5, :3000][~bbox[0]] == 0)
    assert np.all(got[:, 3000:] == 0)


# ---------------------------------------------------------------------------
# K6: tail prepass and its plain formulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,budget,budget_lo", [(256, 3, 0), (1024, 4, 0),
                                                   (256, 9, 3), (128, 16, 4)])
def test_tail_prepass_matches_reference(chunk, budget, budget_lo):
    fx = _fixture(n=5000, chunk=chunk, budget=budget, k_bands=8)
    # Depth rising along the array (as Morton order gives), so the chunks
    # fall into several bands; cuts at the quantiles of the negated depth.
    fx["meta"][4] = np.sort(fx["meta"][4])
    cuts = np.quantile(-fx["meta"][4], np.arange(1, 8) / 8).astype(np.int32)
    rows = tuple(jnp.asarray(fx["meta"][i]) for i in range(6))
    band_r, rect_r, mask_r = RT.tail_prepass(
        rows, jnp.asarray(cuts), chunk, budget, budget_lo=budget_lo,
        k_bands=8, interpret=True)
    band_x, rect_x = RT.step_bands_rects(jnp.asarray(fx["meta"]), chunk,
                                         jnp.asarray(cuts), budget_lo, budget)
    mask_x = RT.step_slot_masks(jnp.asarray(fx["meta"]), chunk, budget,
                                budget_lo=budget_lo)
    band, rect, mask = TL.tail_prepass(_t(fx["meta"]), _t(cuts), chunk,
                                       budget, budget_lo=budget_lo, k_bands=8)
    for got, want in ((band, band_r), (rect, rect_r), (mask, mask_r),
                      (band, band_x), (rect, rect_x), (mask, mask_x)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(band.tolist())) > 1 and int(mask.ne(0).sum()) > 0


def test_tail_prepass_reproduces_int32_depth_wrap():
    """C-R8: one 16384-entry chunk, all live at dbits 250000. The int32 sum
    wraps (16384 * 250000 > 2^31), so the reference puts the chunk in band
    7, the farthest; the true mean 250000 would give band 2. The port
    reproduces the reference's band."""
    chunk = 16384
    meta = np.zeros((6, chunk), np.int32)
    meta[1] = meta[3] = 0               # one-tile bboxes at tile 0
    meta[4] = 250000
    meta[5] = 1
    cuts = -np.array([280000, 260000, 240000, 230000, 220000, 210000,
                      200000], np.int32)
    cuts = np.sort(cuts).astype(np.int32)
    true_band = int(np.sum(-250000 >= cuts))
    assert true_band == 2
    wrapped = (np.int64(chunk) * 250000 + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert int(np.sum(-(wrapped // chunk) >= cuts)) == 7
    band_r, _, _ = RT.tail_prepass(tuple(jnp.asarray(r) for r in meta),
                                   jnp.asarray(cuts), chunk, 4, k_bands=8,
                                   interpret=True)
    band_x, _ = RT.step_bands_rects(jnp.asarray(meta), chunk,
                                    jnp.asarray(cuts), 0, 4)
    band, _, _ = TL.tail_prepass(_t(meta), _t(cuts), chunk, 4, k_bands=8)
    assert int(band_r[0]) == int(band_x[0]) == int(band[0]) == 7


def test_rect_covers_all_live_tiles():
    fx = _fixture(seed=3)
    band, rect, _ = TL.tail_prepass(_t(fx["meta"]), _t(fx["band_cuts"]),
                                    fx["chunk"], fx["budget"], k_bands=3)
    tx0, tx1, ty0, ty1, _, span = fx["meta"]
    chunk = fx["chunk"]
    for s, (txw, tyw, nwx, nwy) in enumerate(rect.numpy()):
        sl = slice(s * chunk, (s + 1) * chunk)
        live = (span[sl] > 0) & (span[sl] <= fx["budget"])
        if not live.any():
            continue
        assert tyw % 8 == 0
        assert txw <= tx0[sl][live].min()
        assert tx1[sl][live].max() < txw + nwx * TL.WIN_TX
        assert tyw <= ty0[sl][live].min()
        assert ty1[sl][live].max() < tyw + nwy * TL.WIN_TY


# ---------------------------------------------------------------------------
# host functions
# ---------------------------------------------------------------------------

def test_global_band_cuts_matches_reference():
    rng = np.random.default_rng(0)
    dbits = rng.integers(0, 1 << 20, 5000).astype(np.int32)
    keys = (rng.integers(0, 100, 5000).astype(np.int32) << 20) | dbits
    keys[rng.random(5000) < 0.1] = INT32_MAX          # dead
    for k in (3, 8):
        want = np.asarray(RT.global_band_cuts(jnp.asarray(keys), k))
        got = TL.global_band_cuts(_t(keys), k).numpy()
        np.testing.assert_array_equal(got, want)
        assert np.all(np.diff(got) >= 0)


@pytest.mark.parametrize("w,h,tile,block", [(1920, 1088, (16, 128), (16, 16)),
                                            (256, 128, (16, 128), (16, 16)),
                                            (300, 200, (8, 32), (4, 8))])
def test_tail_params_row_matches_reference(w, h, tile, block):
    p00, p11 = np.float32(1.0391), np.float32(1.8340)
    want = np.asarray(RT.tail_params_row(*tile, block, w, h, jnp.float32(p00),
                                         jnp.float32(p11)))
    got = TL.tail_params_row(*tile, block, w, h, torch.tensor(p00),
                             torch.tensor(p11)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def test_combine_fold_and_blend_match_reference():
    rng = np.random.default_rng(1)
    k, nx, ny, tile_h, tile_w, s_cy, s_cx = 3, 5, 4, 16, 32, 2, 4
    n_samp = s_cy * s_cx
    rows = k * nx * TL.ny_padded(ny)
    acc = np.zeros((rows, TL.N_PLANES * n_samp), np.float32)
    acc[:, :5 * n_samp] = rng.uniform(0, 2, (rows, 5 * n_samp))
    acc[:, 5 * n_samp:] = -rng.uniform(0, 3, (rows, n_samp))
    acc[rng.random(rows) < 0.3] = 0.0                 # empty (band, tile)s
    want = np.asarray(RT.fold_upsample_tail(jnp.asarray(acc), k, nx, ny,
                                            tile_h, tile_w, s_cy, s_cx,
                                            jnp.float32))
    got = TL.fold_upsample_tail(_t(acc), k, nx, ny, tile_h, tile_w, s_cy,
                                s_cx).numpy()
    assert got.shape == (ny * nx, 5, tile_h * tile_w)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    acc_t = rng.uniform(0, 1, (6, k, TL.N_PLANES, n_samp)).astype(np.float32)
    acc_t[..., TL._P_L, :] *= -2.0
    for g, w in zip(TL.combine_bands(_t(acc_t)),
                    RT.combine_bands(jnp.asarray(acc_t))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)

    carry = rng.uniform(0, 1, (ny * nx, 8, tile_h * tile_w)).astype(np.float32)
    want = np.asarray(RT.blend_tail_under_head(jnp.asarray(carry),
                                               jnp.asarray(got)))
    got_b = TL.blend_tail_under_head(_t(carry), _t(got)).numpy()
    np.testing.assert_allclose(got_b, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# K7: tail accumulate
# ---------------------------------------------------------------------------

def _args(fx, s_cy, s_cx, budget_lo=0):
    kw = dict(k_bands=fx["k_bands"], nx=fx["nx"], ny=fx["ny"],
              chunk=fx["chunk"], budget=fx["budget"], s_cy=s_cy, s_cx=s_cx,
              budget_lo=budget_lo)
    names = ("fields", "meta", "band", "rect", "cut", "params_row")
    return names, kw


def _port_acc(fx, s_cy, s_cx, budget_lo=0, exact_clip=False, **extra):
    names, kw = _args(fx, s_cy, s_cx, budget_lo)
    return TL.tail_accumulate(*(_t(fx[k]) for k in names),
                              exact_clip=exact_clip, **kw, **extra).numpy()


# (budget, budget_lo): the main stream, and a big-tier window.
_STREAMS = [(3, 0), (9, 3)]


@pytest.mark.parametrize("exact_clip", [False, True])
@pytest.mark.parametrize("budget,budget_lo", _STREAMS)
@pytest.mark.parametrize("s_cy,s_cx", [(4, 16), (1, 8)])
def test_tail_accumulate_matches_f32_twin(s_cy, s_cx, budget, budget_lo,
                                          exact_clip):
    fx = _fixture(budget=budget, seed=budget)
    names, kw = _args(fx, s_cy, s_cx, budget_lo)
    want = np.asarray(RT.tail_accumulate_xla(
        *(jnp.asarray(fx[k]) for k in names), exact_clip=exact_clip, **kw))
    got = _port_acc(fx, s_cy, s_cx, budget_lo, exact_clip)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert float(np.abs(got).sum()) > 1.0


@pytest.mark.parametrize("exact_clip", [False, True])
@pytest.mark.parametrize("budget,budget_lo", _STREAMS)
def test_tail_accumulate_matches_reference_kernel(budget, budget_lo,
                                                  exact_clip):
    fx = _fixture(budget=budget, seed=budget)
    names, kw = _args(fx, 4, 16, budget_lo)
    mask = RT.step_slot_masks(jnp.asarray(fx["meta"]), fx["chunk"], budget,
                              budget_lo=budget_lo)
    want = np.asarray(RT.tail_accumulate(
        *(jnp.asarray(fx[k]) for k in names), slot_mask=mask,
        exact_clip=exact_clip, interpret=True, **kw))
    got = _port_acc(fx, 4, 16, budget_lo, exact_clip,
                    slot_mask=_t(np.asarray(mask)))
    # The reference kernel's planes are bf16 (C-R5).
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    assert float(np.abs(got).sum()) > 1.0


def test_tail_accumulate_plain_batches_agree(monkeypatch):
    """The plain version's pair batches (which bound its temporaries on the
    card) only change the order of the sums."""
    fx = _fixture(n=5000, chunk=256)
    names, kw = _args(fx, 2, 8)
    args = [_t(fx[k]) for k in names]
    whole = TL.tail_accumulate_plain(args[0], args[1], args[2], args[4],
                                     args[5], exact_clip=True, **kw)
    monkeypatch.setattr(TL, "PLAIN_BATCH_PAIRS", 512)
    batched = TL.tail_accumulate_plain(args[0], args[1], args[2], args[4],
                                       args[5], exact_clip=True, **kw)
    np.testing.assert_allclose(batched.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_tail_accumulate_pads_short_fields():
    """The big-tier stream hands fields gathered to the id count; they are
    zero-padded to the meta's width, as the reference pads them."""
    fx = _fixture(n=3000, chunk=256)
    short = dict(fx, fields=fx["fields"][:, :2900])
    full = dict(fx, fields=np.pad(fx["fields"][:, :2900],
                                  ((0, 0), (0, fx["meta"].shape[1] - 2900))))
    np.testing.assert_array_equal(_port_acc(short, 2, 8),
                                  _port_acc(full, 2, 8))


@pytest.mark.parametrize("knob", ["wd_ab", "alpha_pow"])
def test_tail_weighting_knobs_are_not_ported(knob):
    """The knobs were refused before the within-band weighting was ported;
    now they run. Zero coefficients weigh every pair exp(0) = 1, which
    leaves the accumulator bit-equal to the unweighted one; alpha_pow 1
    changes the A..A2 planes and leaves the L plane as it was
    (tests/test_torch_tail_weighting.py holds both against the
    reference)."""
    fx = _fixture(n=600, chunk=256)
    extra = ({"wd_ab": torch.zeros((fx["band"].shape[0], 2))}
             if knob == "wd_ab" else {"alpha_pow": 1})
    plain = _port_acc(fx, 2, 8)
    got = _port_acc(fx, 2, 8, **extra)
    n_samp = 2 * 8
    if knob == "wd_ab":
        np.testing.assert_array_equal(got, plain)
    else:
        assert not np.array_equal(got[:, :5 * n_samp], plain[:, :5 * n_samp])
        np.testing.assert_array_equal(got[:, 5 * n_samp:],
                                      plain[:, 5 * n_samp:])
