"""Backward parity of the port's kernel modules with the JAX reference on the
CPU: the composite (K1/K8, `fourdgs_torch/ops/composite_cuda.py`), the tail
accumulate (K7/K9, `ops/tail_cuda.py`) and the record pack (K4,
`ops/pack_cuda.py`), each an autograd Function whose backward runs the
plain PyTorch version of its kernel on CPU tensors.

Inputs are made with numpy from fixed seeds and handed to both sides; the
reference runs as its own tests run it (Pallas interpret mode, its custom
VJPs). Tolerances, each relative to the largest magnitude of the compared
cotangent:
  * composite backward (records and carry) against `jax.vjp` of
    `composite_records` and `composite_records_at`: 1e-5 (the same float32
    operations; the suffix sums are totals minus prefixes on both sides);
  * tail backward against `jax.vjp` of the reference's f32 twin
    `tail_accumulate_xla`: 1e-6 (measured 2.6e-7: sums in another order);
    against the reference's `_tail_bwd` kernel, whose plane cotangents are
    float32 too: 3e-5 (that kernel is itself 1.1e-5 from its twin);
  * record-pack backward against `jax.vjp` of `pack_record_fields`: 1e-6.
Each Function also passes `torch.autograd.gradcheck` in float64, on inputs
kept away from the coverage seams (|n| = 0.5, w = 1e-4) and the early-exit
threshold, as tests/test_gradcheck.py keeps its scene.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.autograd import gradcheck  # noqa: E402

from fourdgs.ops import composite_pallas as RC  # noqa: E402
from fourdgs.ops import tail_pallas as RT  # noqa: E402
from fourdgs_torch.ops import composite_cuda as TC  # noqa: E402
from fourdgs_torch.ops import pack_cuda as TPK  # noqa: E402
from fourdgs_torch.ops import tail_cuda as TL  # noqa: E402
from test_torch_tail import _fixture  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


# ---------------------------------------------------------------------------
# K8: composite backward
# ---------------------------------------------------------------------------

def _composite_inputs(rng, t_tiles, m, p):
    """Records over a (2, P/2) pixel tile spanning k in [-1, 1] x [-0.01,
    0.01] (tests/test_torch_ops.py's inputs). Tile 0 opens with a chunk of
    opaque tile-covering records, so it exits early after one chunk; tile 1
    is empty; the other counts end mid-chunk."""
    f = np.zeros((t_tiles, 16, m), np.float32)
    f[:, 0] = rng.uniform(-1.1, 1.1, (t_tiles, m))
    f[:, 1] = rng.uniform(-0.02, 0.02, (t_tiles, m))
    ang = rng.uniform(0, 2 * np.pi, (t_tiles, m))
    f[:, 2], f[:, 3] = np.cos(ang), np.sin(ang)
    f[:, 4] = 1.0 / rng.uniform(0.05, 0.5, (t_tiles, m))
    f[:, 5] = 1.0 / rng.uniform(0.05, 0.5, (t_tiles, m))
    f[:, 6:9] = rng.uniform(0.0, 1.0, (t_tiles, 3, m))
    f[:, 9] = rng.uniform(0.2, 1.0, (t_tiles, m))
    f[0, 0:2, :128] = 0.0
    f[0, 4:6, :128] = 0.1
    f[0, 9, :128] = 0.99
    counts = rng.integers(1, m, t_tiles).astype(np.int32)
    counts[counts % 128 == 0] += 1
    counts[0] = m
    counts[1] = 0
    half = p // 2
    gx = np.tile(np.linspace(-1, 1, half, dtype=np.float32), 2)
    gy = np.repeat(np.array([0.01, -0.01], np.float32), half)
    kx = np.broadcast_to(gx, (t_tiles, 1, p)).copy()
    ky = np.broadcast_to(gy, (t_tiles, 1, p)).copy()
    return f, counts, kx, ky


def _carry(rng, t_tiles, p):
    """An incoming carry with accumulators and T in (0.3, 1]; tile 0 keeps
    T = 1 so its first chunk saturates it."""
    c = np.zeros((t_tiles, 8, p), np.float32)
    c[:, 0:4] = rng.uniform(0.0, 0.3, (t_tiles, 4, p))
    c[:, 4] = rng.uniform(0.3, 1.0, (t_tiles, p))
    c[0, 4] = 1.0
    return c


def test_composite_backward_matches_reference():
    rng = np.random.default_rng(0)
    t_tiles, m, p = 6, 384, 256
    f, counts, kx, ky = _composite_inputs(rng, t_tiles, m, p)
    carry = _carry(rng, t_tiles, p)
    g = rng.standard_normal((t_tiles, 8, p)).astype(np.float32)
    out_r, vjp = jax.vjp(
        lambda r, c: RC.composite_records(r, jnp.asarray(counts),
                                          jnp.asarray(kx), jnp.asarray(ky), c),
        jnp.asarray(f), jnp.asarray(carry))
    d_rec_r, d_carry_r = vjp(jnp.asarray(g))

    rec = _t(f).requires_grad_(True)
    car = _t(carry).requires_grad_(True)
    out = TC.composite_records(rec, _t(counts), _t(kx), _t(ky), car)
    out.backward(_t(g))
    _close(rec.grad.numpy(), d_rec_r, 1e-5)
    _close(car.grad.numpy(), d_carry_r, 1e-5)
    # The plain backward alone gives the same records cotangent.
    d_plain = TC.composite_bwd_plain(_t(f), _t(counts), _t(kx), _t(ky),
                                     _t(carry), out.detach(), _t(g))
    np.testing.assert_array_equal(d_plain.numpy(), rec.grad.numpy())
    # Tile 0 exited after its first chunk; tile 1 is empty; rows 10-15 are
    # zero; the records past each count get nothing.
    d = rec.grad.numpy()
    assert np.asarray(out_r)[0, 4].max() <= 1e-6
    assert np.all(d[0, :, 128:] == 0) and np.abs(d[0, :10, :128]).max() > 0
    assert np.all(d[1] == 0) and np.all(d[:, 10:] == 0)
    for t in range(2, t_tiles):
        # A chunk is composited whole (dead entries carry a_eff 0 on the
        # render path); chunks past ceil(count / 128) are not.
        end = -(-counts[t] // 128) * 128
        assert np.all(d[t, :, end:] == 0)
        assert np.all(np.abs(d[t, :10, :end]).max(axis=1) > 0)


def test_composite_at_backward_matches_reference():
    """The deepening pass: records cotangent through the reference's
    `_composite_bwd_pallas` (interpret) at the selected tiles, and the carry
    cotangent g with the selected tiles' closed form."""
    rng = np.random.default_rng(1)
    t_tiles, m, p = 8, 256, 256
    _, _, kx, ky = _composite_inputs(rng, t_tiles, m, p)
    carry = _carry(rng, t_tiles, p)
    f1, c1, _, _ = _composite_inputs(rng, 5, m, p)
    sel = np.array([3, 0, 6, 5, 2], np.int32)
    c1[4] = 0                                         # a filler tile
    g = rng.standard_normal((t_tiles, 8, p)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda r, c: RC.composite_records_at(r, jnp.asarray(c1),
                                             jnp.asarray(sel),
                                             jnp.asarray(kx), jnp.asarray(ky),
                                             c),
        jnp.asarray(f1), jnp.asarray(carry))
    d_rec_r, d_carry_r = vjp(jnp.asarray(g))

    rec = _t(f1).requires_grad_(True)
    car = _t(carry).requires_grad_(True)
    out = TC.composite_records_at(rec, _t(c1), _t(sel), _t(kx), _t(ky),
                                  car.clone())
    out.backward(_t(g))
    _close(rec.grad.numpy(), d_rec_r, 1e-5)
    _close(car.grad.numpy(), d_carry_r, 1e-5)
    untouched = [1, 4, 7]
    np.testing.assert_array_equal(car.grad.numpy()[untouched], g[untouched])
    assert np.all(rec.grad.numpy()[4] == 0)           # the filler


# ---------------------------------------------------------------------------
# K9: tail backward
# ---------------------------------------------------------------------------

_NAMES = ("fields", "meta", "band", "rect", "cut", "params_row")


def _tail_case(budget, budget_lo, exact_clip, masked, s_cy=2, s_cx=8):
    fx = _fixture(budget=budget, seed=budget + 10)
    kw = dict(k_bands=fx["k_bands"], nx=fx["nx"], ny=fx["ny"],
              chunk=fx["chunk"], budget=budget, s_cy=s_cy, s_cx=s_cx,
              budget_lo=budget_lo)
    mask = None
    if masked:
        mask = np.asarray(RT.step_slot_masks(jnp.asarray(fx["meta"]),
                                             fx["chunk"], budget,
                                             budget_lo=budget_lo))
    rows = kw["k_bands"] * fx["nx"] * TL.ny_padded(fx["ny"])
    rng = np.random.default_rng(budget)
    d_acc = rng.standard_normal((rows, TL.N_PLANES * s_cy * s_cx)
                                ).astype(np.float32)
    return fx, kw, mask, d_acc


# (budget, budget_lo): the main stream, and a big-tier window.
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("exact_clip", [False, True])
@pytest.mark.parametrize("budget,budget_lo", [(3, 0), (9, 3)])
def test_tail_backward_matches_reference(budget, budget_lo, exact_clip,
                                         masked):
    fx, kw, mask, d_acc = _tail_case(budget, budget_lo, exact_clip, masked)
    args = [jnp.asarray(fx[k]) for k in _NAMES]
    want_k = RT._tail_bwd(
        *args, None if mask is None else jnp.asarray(mask), None,
        jnp.asarray(d_acc), kw["k_bands"], kw["nx"], kw["ny"], kw["chunk"],
        budget, budget_lo, kw["s_cy"], kw["s_cx"], 0, exact_clip, True)
    _, vjp = jax.vjp(lambda f: RT.tail_accumulate_xla(
        f, *args[1:], exact_clip=exact_clip, **kw), args[0])
    want_x, = vjp(jnp.asarray(d_acc))

    fields = _t(fx["fields"]).requires_grad_(True)
    acc = TL.tail_accumulate(fields, *(_t(fx[k]) for k in _NAMES[1:]),
                             slot_mask=None if mask is None else _t(mask),
                             exact_clip=exact_clip, **kw)
    acc.backward(_t(d_acc))
    got = fields.grad.numpy()
    _close(got, want_x, 1e-6)
    # The reference's kernel is itself 1.1e-5 (of max |d|) from its twin
    # here (measured); the port sits 2e-7 from the twin.
    _close(got, want_k, 3e-5)
    # Every field row gets a gradient from the live pairs.
    assert np.all(np.abs(got).max(axis=1) > 0)


def test_tail_backward_plain_batches_agree(monkeypatch):
    """The plain backward's pair batches only change the order of sums."""
    fx, kw, _, d_acc = _tail_case(3, 0, True, False)
    args = [_t(fx[k]) for k in _NAMES]
    del kw["budget_lo"]
    whole = TL.tail_accumulate_bwd_plain(args[0], args[1], args[2], args[4],
                                         args[5], _t(d_acc), exact_clip=True,
                                         **kw)
    monkeypatch.setattr(TL, "PLAIN_BATCH_PAIRS", 512)
    batched = TL.tail_accumulate_bwd_plain(args[0], args[1], args[2],
                                           args[4], args[5], _t(d_acc),
                                           exact_clip=True, **kw)
    np.testing.assert_allclose(batched.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_tail_backward_reaches_short_fields():
    """The big-tier stream hands fields gathered to the id count; the
    cotangent of the zero padding is dropped by autograd."""
    fx, kw, _, d_acc = _tail_case(3, 0, False, False)
    short = _t(fx["fields"][:, :2900]).requires_grad_(True)
    acc = TL.tail_accumulate(short, *(_t(fx[k]) for k in _NAMES[1:]), **kw)
    acc.backward(_t(d_acc))
    full = _t(fx["fields"]).requires_grad_(True)
    full_acc = TL.tail_accumulate(full, *(_t(fx[k]) for k in _NAMES[1:]),
                                  **kw)
    full_acc.backward(_t(d_acc))
    assert short.grad.shape == (10, 2900)
    np.testing.assert_array_equal(short.grad.numpy(),
                                  full.grad.numpy()[:, :2900])


# ---------------------------------------------------------------------------
# K4: record-pack backward
# ---------------------------------------------------------------------------

def test_pack_record_fields_backward_matches_reference():
    from fourdgs.ops.pack_pallas import pack_record_fields
    rng = np.random.default_rng(5)
    n, pad_to = 3000, 4096
    rows = [rng.standard_normal(n).astype(np.float32) for _ in range(10)]
    rows[4][::7] = 0.0                   # l == 0: il == 0, no gradient
    rows[5][3::11] = 0.0
    p00, p11 = np.float32(1.7320508), np.float32(3.4641016)
    d_out = rng.standard_normal((10, pad_to)).astype(np.float32)
    _, vjp = jax.vjp(lambda *r: pack_record_fields(
        *r, jnp.float32(p00), jnp.float32(p11), pad_to, interpret=True),
        *(jnp.asarray(r) for r in rows))
    want = vjp(jnp.asarray(d_out))
    got = [_t(r).requires_grad_(True) for r in rows]
    out = TPK.pack_record_fields(*got, torch.tensor(p00), torch.tensor(p11),
                                 pad_to)
    out.backward(_t(d_out))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.grad.numpy(), w, 1e-6)
    assert np.all(got[4].grad.numpy()[::7] == 0.0)


# ---------------------------------------------------------------------------
# float64 gradcheck of the four Functions
# ---------------------------------------------------------------------------

def _seam_free_composite(t_tiles=2, m=128, p=16):
    """Small float64 composite inputs whose (record, pixel) pairs all keep
    a margin from the coverage seams, and whose T stays far above 1e-6."""
    for seed in range(100):
        rng = np.random.default_rng(seed)
        f = np.zeros((t_tiles, 16, m))
        f[:, 0:2] = rng.uniform(-0.3, 0.3, (t_tiles, 2, m))
        ang = rng.uniform(0, 2 * np.pi, (t_tiles, m))
        f[:, 2], f[:, 3] = np.cos(ang), np.sin(ang)
        f[:, 4:6] = 1.0 / rng.uniform(0.3, 0.8, (t_tiles, 2, m))
        f[:, 6:9] = rng.uniform(0, 1, (t_tiles, 3, m))
        f[:, 9] = rng.uniform(0.01, 0.05, (t_tiles, m))
        kx = rng.uniform(-0.3, 0.3, (t_tiles, 1, p))
        ky = rng.uniform(-0.3, 0.3, (t_tiles, 1, p))
        dx, dy = kx - f[:, 0, :, None], ky - f[:, 1, :, None]
        n0 = (f[:, 2, :, None] * dx + f[:, 3, :, None] * dy) * f[:, 4, :, None]
        n1 = (f[:, 3, :, None] * dx - f[:, 2, :, None] * dy) * f[:, 5, :, None]
        q = n0 ** 2 + n1 ** 2
        margin = min(np.abs(np.abs(n0) - 0.5).min(),
                     np.abs(np.abs(n1) - 0.5).min(),
                     np.abs(32.0 * q - np.log(1e4)).min())
        if margin > 1e-4:
            return f, kx, ky
    raise AssertionError("no seam-free seed")


def test_gradcheck_composite_records():
    f, kx, ky = _seam_free_composite()
    counts = torch.tensor([100, 128], dtype=torch.int32)
    carry = TC.identity_carry(2, 16, device="cpu", dtype=torch.float64)
    carry[:, 0:4] = 0.1
    carry[:, 4] = 0.7
    rec = torch.tensor(f, requires_grad=True)
    carry.requires_grad_(True)
    out = TC.composite_records(rec, counts, _t(kx), _t(ky), carry)
    assert float(out.detach()[:, 4].min()) > 1e-3     # far from the exit
    assert gradcheck(lambda r, c: TC.composite_records(r, counts, _t(kx),
                                                       _t(ky), c),
                     (rec, carry), eps=1e-6, atol=1e-6, rtol=1e-5,
                     fast_mode=True)


def test_gradcheck_composite_records_at():
    f, kx, ky = _seam_free_composite()
    counts = torch.tensor([100, 0], dtype=torch.int32)   # one filler
    sel = torch.tensor([2, 0])
    kx4, ky4 = _t(np.concatenate([kx, kx])), _t(np.concatenate([ky, ky]))
    carry = TC.identity_carry(4, 16, device="cpu", dtype=torch.float64)
    carry[:, 0:4] = 0.05
    carry[:, 4] = 0.6
    rec = torch.tensor(f, requires_grad=True)
    carry.requires_grad_(True)
    assert gradcheck(lambda r, c: TC.composite_records_at(
        r, counts, sel, kx4, ky4, c.clone()), (rec, carry), eps=1e-6,
        atol=1e-6, rtol=1e-5, fast_mode=True)


@pytest.mark.parametrize("exact_clip", [False, True])
def test_gradcheck_tail_accumulate(exact_clip):
    fx = _fixture(n=600, nx=4, ny=5, chunk=128, budget=3, seed=7)
    kw = dict(k_bands=fx["k_bands"], nx=4, ny=5, chunk=128, budget=3,
              s_cy=2, s_cx=4, exact_clip=exact_clip)
    rest = [_t(fx[k]) for k in _NAMES[1:5]] + [_t(fx["params_row"]).double()]
    mask = TL.step_slot_masks(rest[0], 128, 3)
    fields = _t(fx["fields"]).double().requires_grad_(True)
    acc = TL.tail_accumulate(fields, *rest, slot_mask=mask, **kw)
    assert acc.dtype == torch.float64
    assert float(acc.detach().abs().sum()) > 1.0
    assert gradcheck(lambda x: TL.tail_accumulate(x, *rest, slot_mask=mask,
                                                  **kw),
                     (fields,), eps=1e-6, atol=1e-5, rtol=1e-4,
                     fast_mode=True)


def test_gradcheck_pack_record_fields():
    rng = np.random.default_rng(2)
    rows = [torch.tensor(rng.uniform(0.5, 1.5, 50) * rng.choice([-1, 1], 50),
                         requires_grad=True) for _ in range(10)]
    assert gradcheck(lambda *r: TPK.pack_record_fields(
        *r, torch.tensor(1.7), torch.tensor(3.1), 1024), rows, eps=1e-6,
        atol=1e-6, rtol=1e-5)

