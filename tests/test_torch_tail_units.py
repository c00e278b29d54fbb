"""The unit walk of the tail kernels K7 and K9 (fourdgs_torch/ops/csrc/
tail_unit.cuh, tail.cu, tail_bwd.cu) on the CPU.

No CUDA compiler runs where these tests do, so `ops/tail_cuda.py` writes the
kernels' walk out once more in plain PyTorch (`unit_worklists`,
`tail_accumulate_units`, `tail_accumulate_bwd_units`): units of 512 splats
(the whole chunk below 512), the unit-level band and slot-mask skip, the
slot walk that steps (ox, oy) instead of dividing, the live-pair worklist,
covered samples alone added, a splat's cotangents summed slot after slot.
Here that model is held against
  * the plain versions `tail_accumulate_plain` / `tail_accumulate_bwd_plain`:
    the worklists equal `_live_pairs`'s set of (splat, tile) pairs exactly;
    the accumulator within 1e-6 (the same per-sample float32 operations,
    sums in another order); the cotangents within 1e-6 of each field's
    largest magnitude;
  * the reference's f32 twin `tail_accumulate_xla` (1e-5, the tolerance of
    tests/test_torch_tail.py) and its `jax.vjp` (1e-6 of the cotangent's
    largest magnitude, the tolerance of tests/test_torch_grad.py).
Inputs come from numpy seeds (tests/test_torch_tail.py::_fixture).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fourdgs.ops import tail_pallas as RT  # noqa: E402
from fourdgs_torch.ops import tail_cuda as TL  # noqa: E402
from test_torch_tail import _fixture, _t  # noqa: E402

_GRIDS = [(1, 8), (2, 16), (4, 16)]
# (budget, budget_lo): the main stream, and a big-tier window.
_STREAMS = [(3, 0), (9, 3)]


def _case(budget, budget_lo, chunk=256, masked=True, n=3000, seed=None):
    fx = _fixture(n=n, chunk=chunk, budget=budget,
                  seed=budget if seed is None else seed)
    t = {k: _t(fx[k]) for k in ("fields", "meta", "band", "rect", "cut",
                                "params_row")}
    t["mask"] = TL.step_slot_masks(t["meta"], chunk, budget, budget_lo) \
        if masked else None
    kw = dict(k_bands=fx["k_bands"], nx=fx["nx"], ny=fx["ny"], chunk=chunk,
              budget=budget, budget_lo=budget_lo)
    return fx, t, kw


def _pair_set(idx, row):
    return set(zip(idx.tolist(), row.tolist()))


def _plain_pairs(t, kw):
    got = set()
    for idx, row, _, _ in TL._live_pairs(
            t["fields"], t["meta"], t["band"], t["cut"], t["params_row"],
            kw["nx"], kw["ny"], kw["chunk"], kw["budget"], 1, 8,
            kw["budget_lo"], False):
        got |= _pair_set(idx, row)
    return got


def _unit_pairs(t, kw):
    ny_pad = TL.ny_padded(kw["ny"])
    unit = min(TL.SUB, kw["chunk"])
    got, units = set(), []
    for u, idx, slot, tx, ty in TL.unit_worklists(
            t["meta"], t["band"], t["cut"], t["mask"], kw["k_bands"],
            kw["nx"], kw["chunk"], kw["budget"], kw["budget_lo"]):
        units.append(u)
        assert bool(((idx >= u * unit) & (idx < (u + 1) * unit)).all())
        assert bool((slot < kw["budget"]).all())
        band = int(t["band"][u * unit // kw["chunk"]])
        row = band * kw["nx"] * ny_pad + tx.long() * ny_pad + ty.long()
        pairs = _pair_set(idx, row)
        assert len(pairs) == idx.numel()            # no pair listed twice
        got |= pairs
    return got, units


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [8, 200, 256, 1024, 2048])
@pytest.mark.parametrize("budget,budget_lo", _STREAMS)
def test_unit_worklists_equal_live_pairs(budget, budget_lo, chunk, masked):
    _, t, kw = _case(budget, budget_lo, chunk, masked, n=2500)
    want = _plain_pairs(t, kw)
    got, units = _unit_pairs(t, kw)
    assert got == want and len(want) > 100
    unit = min(TL.SUB, chunk)
    assert len(units) <= t["meta"].shape[1] // unit
    if chunk >= 1024:
        assert chunk // unit > 1                    # several units a chunk


@pytest.mark.parametrize("exact_clip", [False, True])
@pytest.mark.parametrize("budget,budget_lo", _STREAMS)
@pytest.mark.parametrize("s_cy,s_cx", _GRIDS)
def test_units_accumulate_matches_plain_and_twin(s_cy, s_cx, budget,
                                                 budget_lo, exact_clip):
    fx, t, kw = _case(budget, budget_lo)
    got = TL.tail_accumulate_units(
        t["fields"], t["meta"], t["band"], t["cut"], t["params_row"],
        s_cy=s_cy, s_cx=s_cx, slot_mask=t["mask"], exact_clip=exact_clip,
        **kw).numpy()
    plain = TL.tail_accumulate_plain(
        t["fields"], t["meta"], t["band"], t["cut"], t["params_row"],
        s_cy=s_cy, s_cx=s_cx, exact_clip=exact_clip, **kw).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)
    names = ("fields", "meta", "band", "rect", "cut", "params_row")
    twin = np.asarray(RT.tail_accumulate_xla(
        *(jnp.asarray(fx[k]) for k in names), s_cy=s_cy, s_cx=s_cx,
        exact_clip=exact_clip, **kw))
    np.testing.assert_allclose(got, twin, rtol=1e-5, atol=1e-5)
    assert float(np.abs(got).sum()) > 1.0


def _close(got, want, rel):
    scale = float(np.abs(want).max())
    assert scale > 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _d_acc(kw, n_samp, seed):
    rows = kw["k_bands"] * kw["nx"] * TL.ny_padded(kw["ny"])
    return np.random.default_rng(seed).standard_normal(
        (rows, TL.N_PLANES * n_samp)).astype(np.float32)


@pytest.mark.parametrize("exact_clip", [False, True])
@pytest.mark.parametrize("budget,budget_lo", _STREAMS)
@pytest.mark.parametrize("s_cy,s_cx", _GRIDS)
def test_units_backward_matches_plain_and_twin(s_cy, s_cx, budget, budget_lo,
                                               exact_clip):
    fx, t, kw = _case(budget, budget_lo)
    d_acc = _d_acc(kw, s_cy * s_cx, budget)
    got = TL.tail_accumulate_bwd_units(
        t["fields"], t["meta"], t["band"], t["cut"], t["params_row"],
        _t(d_acc), s_cy=s_cy, s_cx=s_cx, slot_mask=t["mask"],
        exact_clip=exact_clip, **kw).numpy()
    plain = TL.tail_accumulate_bwd_plain(
        t["fields"], t["meta"], t["band"], t["cut"], t["params_row"],
        _t(d_acc), s_cy=s_cy, s_cx=s_cx, exact_clip=exact_clip,
        **kw).numpy()
    for f in range(10):
        _close(got[f], plain[f], 1e-6)
    names = ("fields", "meta", "band", "rect", "cut", "params_row")
    args = [jnp.asarray(fx[k]) for k in names]
    _, vjp = jax.vjp(lambda x: RT.tail_accumulate_xla(
        x, *args[1:], s_cy=s_cy, s_cx=s_cx, exact_clip=exact_clip, **kw),
        args[0])
    want, = vjp(jnp.asarray(d_acc))
    _close(got, np.asarray(want), 1e-6)
    assert np.all(np.abs(got).max(axis=1) > 0)


@pytest.mark.parametrize("chunk", [8, 200])
def test_units_ragged_chunk(chunk):
    """A chunk below 512 is one unit of its own size (the big tier's)."""
    _, t, kw = _case(9, 3, chunk, masked=True, n=1000)
    assert t["meta"].shape[1] % chunk == 0 and chunk < TL.SUB
    args = (t["fields"], t["meta"], t["band"], t["cut"], t["params_row"])
    got = TL.tail_accumulate_units(*args, s_cy=1, s_cx=8,
                                   slot_mask=t["mask"], exact_clip=True, **kw)
    want = TL.tail_accumulate_plain(*args, s_cy=1, s_cx=8, exact_clip=True,
                                    **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert float(want.abs().sum()) > 0.1
    d_acc = _t(_d_acc(kw, 8, chunk))
    got_b = TL.tail_accumulate_bwd_units(*args, d_acc, s_cy=1, s_cx=8,
                                         slot_mask=t["mask"],
                                         exact_clip=True, **kw).numpy()
    want_b = TL.tail_accumulate_bwd_plain(*args, d_acc, s_cy=1, s_cx=8,
                                          exact_clip=True, **kw).numpy()
    for f in range(10):
        _close(got_b[f], want_b[f], 1e-6)


def test_units_all_dead_unit():
    """A unit whose splats are all dead (span 0) lists nothing, adds
    nothing and gets zero cotangents; its neighbours are untouched by it."""
    _, t, kw = _case(3, 0, 1024, masked=False, n=3000)
    t["meta"][5, 512:1024] = 0                    # unit 1 of chunk 0
    units = {u: idx for u, idx, *_ in TL.unit_worklists(
        t["meta"], t["band"], t["cut"], None, kw["k_bands"], kw["nx"], 1024,
        3, 0)}
    assert units[1].numel() == 0 and units[0].numel() > 0
    args = (t["fields"], t["meta"], t["band"], t["cut"], t["params_row"])
    got = TL.tail_accumulate_units(*args, s_cy=2, s_cx=16, **kw)
    want = TL.tail_accumulate_plain(*args, s_cy=2, s_cx=16, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    d_acc = _t(_d_acc(kw, 32, 1))
    got_b = TL.tail_accumulate_bwd_units(*args, d_acc, s_cy=2, s_cx=16, **kw)
    assert bool((got_b[:, 512:1024] == 0).all())
    assert float(got_b[:, :512].abs().max()) > 0


def test_units_masked_out_unit():
    """A unit whose slot-mask bits are all 0 is skipped before any load:
    the prepass clears them exactly when no splat of the unit lies in the
    span window, so the result does not change; and a cleared bit does
    silence a unit that has live pairs (the skip is really taken)."""
    _, t, kw = _case(3, 0, 1024, masked=True, n=3000)
    t["meta"][5, 512:1024] = 7                    # unit 1: spans past budget
    mask = TL.step_slot_masks(t["meta"], 1024, 3, 0)
    nsub = 2
    assert all(((int(mask[0]) >> (s * nsub + 1)) & 1) == 0 for s in range(3))
    walked = [u for u, *_ in TL.unit_worklists(
        t["meta"], t["band"], t["cut"], mask, kw["k_bands"], kw["nx"], 1024,
        3, 0)]
    assert 1 not in walked and 0 in walked
    args = (t["fields"], t["meta"], t["band"], t["cut"], t["params_row"])
    got = TL.tail_accumulate_units(*args, s_cy=1, s_cx=8, slot_mask=mask,
                                   **kw)
    want = TL.tail_accumulate_plain(*args, s_cy=1, s_cx=8, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    # Clearing unit 0's bits by hand drops its pairs.
    cleared = mask.clone()
    cleared[0] = int(mask[0]) & ~sum(1 << (s * nsub) for s in range(3))
    less = TL.tail_accumulate_units(*args, s_cy=1, s_cx=8, slot_mask=cleared,
                                    **kw)
    assert float(less.abs().sum()) < float(got.abs().sum())
    # A band outside [0, k_bands) rules the chunk's units out as well.
    assert not TL.unit_may_be_live(kw["k_bands"], None, 0, nsub, 3,
                                   kw["k_bands"])
    # Slots past the mask's 30 bits stay live: nsub 32 masks nothing.
    assert TL.unit_may_be_live(0, 0, 5, 32, 4, kw["k_bands"])


class _FakeKernel:
    """Stands in for a CudaKernel: records the launch it is asked for."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args, stream):
        self.calls.append(args)


@pytest.mark.parametrize("s_cy,s_cx", [(4, 16), (3, 4), (2, 16)])
def test_tail_backward_wrapper_takes_every_sample_grid(monkeypatch, s_cy,
                                                       s_cx):
    """K9 takes what K7 takes: the wrapper's card path passes any sample
    grid on to the kernel (it refused more than 32 samples, and counts that
    are no power of two, before). The launch itself is replaced, so the
    path up to it runs on CPU tensors."""
    _, t, kw = _case(3, 0)
    n_samp = s_cy * s_cx
    d_acc = _t(_d_acc(kw, n_samp, 2))
    fake = _FakeKernel()
    monkeypatch.setattr(TL, "TAIL_ACCUMULATE_BWD", fake)
    monkeypatch.setattr(TL, "_device", lambda x: "cuda")
    monkeypatch.setattr(TL, "_stream", lambda x: 0)
    out = TL.tail_accumulate_bwd(t["fields"], t["meta"], t["band"], t["cut"],
                                 t["params_row"], d_acc, t["mask"],
                                 s_cy=s_cy, s_cx=s_cx, exact_clip=True, **kw)
    assert out.shape == (10, t["meta"].shape[1])
    (args,) = fake.calls
    npts = t["meta"].shape[1]
    assert list(args[8:]) == [npts, npts // kw["chunk"], kw["chunk"],
                              kw["budget"], kw["budget_lo"], kw["nx"],
                              TL.ny_padded(kw["ny"]), s_cx, n_samp,
                              kw["k_bands"], 1, 1, 1, t["cut"].shape[0],
                              None, 2, 0]
    with pytest.raises(ValueError):
        TL.tail_accumulate_bwd(t["fields"], t["meta"], t["band"], t["cut"],
                               t["params_row"], d_acc[:, :-1], t["mask"],
                               s_cy=s_cy, s_cx=s_cx, **kw)


def test_tail_forward_wrapper_reads_prepass_columns_in_place(monkeypatch):
    """The card path hands K7 the prepass's band and mask as they are,
    columns of one (S, 6) matrix, with their stride in elements; a vector
    of another type is converted and travels with stride 1."""
    _, t, kw = _case(3, 0)
    steps = t["band"].shape[0]
    out = torch.zeros((steps, 6), dtype=torch.int32)
    out[:, 0], out[:, 5] = t["band"], t["mask"]
    fake = _FakeKernel()
    monkeypatch.setattr(TL, "TAIL_ACCUMULATE", fake)
    monkeypatch.setattr(TL, "_device", lambda x: "cuda")
    monkeypatch.setattr(TL, "_stream", lambda x: 0)
    acc = TL.tail_accumulate(t["fields"], t["meta"], out[:, 0], t["rect"],
                             t["cut"], t["params_row"], s_cy=1, s_cx=8,
                             slot_mask=out[:, 5], **kw)
    (args,) = fake.calls
    fields, meta, band, mask, cut, prm, acc_arg = args[:7]
    assert band.data_ptr() == out[:, 0].data_ptr()
    assert mask.data_ptr() == out[:, 5].data_ptr()
    assert list(args[-6:-3]) == [6, 6, t["cut"].shape[0]]
    assert list(args[-3:]) == [None, 2, 0]       # no depth weights, p = 0
    assert len(args) == 7 + 14 + 3
    assert cut.data_ptr() == t["cut"].data_ptr() and acc_arg is acc
    assert not bool(acc.any())                    # the fake adds nothing
    TL.tail_accumulate(t["fields"], t["meta"], t["band"].long(), t["rect"],
                       t["cut"], t["params_row"], s_cy=1, s_cx=8, **kw)
    assert fake.calls[1][2].dtype == torch.int32
    assert fake.calls[1][3] is None and list(fake.calls[1][-6:-4]) == [1, 1]
    with pytest.raises(ValueError):
        TL.tail_accumulate(t["fields"], t["meta"], t["band"], t["rect"],
                           torch.zeros(TL.CUT_ENTRIES + 1, dtype=torch.int32),
                           t["params_row"], s_cy=1, s_cx=8, **kw)
