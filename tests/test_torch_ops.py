"""Parity of the port's kernel modules (fourdgs_torch/ops) with the JAX
reference on the CPU.

Inputs are made with numpy from fixed seeds and handed to both sides. The
reference's Pallas kernels run in interpret mode, as its own tests run them;
the port runs each kernel's plain PyTorch version (CPU tensors).
Tolerances: integer outputs are exact; the composite agrees within 1e-5
(sums are taken in another order, every per-record operation is the same).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fourdgs_torch.ops import composite_cuda as TC  # noqa: E402
from fourdgs_torch.ops import lookup_cuda as TL  # noqa: E402
from fourdgs_torch.ops import sort_cuda as TS  # noqa: E402
from fourdgs_torch.render import tiles as TT  # noqa: E402

DEAD = np.iinfo(np.int32).max


# ---------------------------------------------------------------------------
# K3: sample_blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,stride,take", [(2000, 134, 2), (1024, 64, 1),
                                              (9, 5, 8)])
def test_sample_blocks_matches_reference(rows, stride, take):
    from fourdgs.ops.lookup_pallas import sample_blocks
    rng = np.random.default_rng(rows + stride)
    ki = rng.integers(-2 ** 31, 2 ** 31 - 1, rows * 128, dtype=np.int32)
    kf = rng.standard_normal(rows * 128).astype(np.float32)
    want = sample_blocks([jnp.asarray(ki), jnp.asarray(kf)],
                         stride_rows=stride, take_rows=take, interpret=True)
    got = TL.sample_blocks([torch.from_numpy(ki), torch.from_numpy(kf)],
                           stride_rows=stride, take_rows=take)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sample_blocks_floors_starts_to_granules():
    """Stride 134 spaces the blocks 128/136 rows apart (the reference's
    8-row floor), never 134."""
    rows = 1000
    x = torch.arange(rows * 128, dtype=torch.int32)
    got, = TL.sample_blocks([x], stride_rows=134, take_rows=2)
    starts = got.reshape(-1, 256)[:, 0].numpy() // 128
    assert list(np.diff(starts)[:5]) == [128, 136, 136, 136, 128]


# ---------------------------------------------------------------------------
# K2: rowsort_compact
# ---------------------------------------------------------------------------

def _slot_keys(rng, s, n_tiles, dead_frac, distinct):
    if distinct:
        key = rng.choice(n_tiles << 20, s, replace=False).astype(np.int32)
    else:        # heavy ties: few depth values per tile
        key = ((rng.integers(0, n_tiles, s) << 20)
               | rng.integers(0, 4, s)).astype(np.int32)
    key[rng.random(s) < dead_frac] = DEAD
    val = rng.permutation(s).astype(np.int32)
    return key, val


def _row_multisets(k, v):
    """(keep, rows) outputs -> per-row sorted (key, val) pairs over live
    slots, as one int64 array per row."""
    k, v = np.asarray(k), np.asarray(v)
    pairs = k.astype(np.int64) << 32 | (v.astype(np.int64) & 0xFFFFFFFF)
    return [np.sort(pairs[:, r][k[:, r] != DEAD]) for r in range(k.shape[1])]


@pytest.mark.parametrize("use_cut", [True, False])
@pytest.mark.parametrize("distinct,keep", [(True, 24), (False, 192)])
def test_rowsort_compact_matches_reference(use_cut, distinct, keep):
    from fourdgs.ops.sort_pallas import rowsort_compact
    rng = np.random.default_rng(5 + use_cut + 2 * distinct)
    s, n_tiles = 60_001, 20
    key, val = _slot_keys(rng, s, n_tiles, 0.5, distinct)
    cut = ((np.arange(n_tiles) << 20)
           | rng.integers(0, 1 << 19, n_tiles)).astype(np.int32)
    rcut = jnp.asarray(cut) if use_cut else None
    wk, wv, wd = rowsort_compact(jnp.asarray(key), jnp.asarray(val), keep,
                                 row_len=256, cut=rcut, key_shift=20,
                                 interpret=True)
    gk, gv, gd = TS.rowsort_compact(
        torch.from_numpy(key), torch.from_numpy(val), keep, row_len=256,
        cut=torch.from_numpy(cut) if use_cut else None, key_shift=20)
    assert gk.shape == tuple(wk.shape) == (keep, 256)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    for g, w in zip(_row_multisets(gk, gv), _row_multisets(wk, wv)):
        np.testing.assert_array_equal(g, w)
    assert int(gd) == int(wd)
    if distinct:
        assert int(gd) > 0            # the keep cap really dropped pairs
        live = gk.numpy() != DEAD     # dead slots carry arbitrary values
        np.testing.assert_array_equal(gv.numpy()[live], np.asarray(wv)[live])


# ---------------------------------------------------------------------------
# Depth-prune cut estimate (reaches K3 past 67 * 256 * 128 slots)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [40_000, 2_196_480])
def test_depth_prune_cutkeys_matches_reference(s):
    from fourdgs.render.tiles import depth_prune_cutkeys
    rng = np.random.default_rng(s)
    n_tiles = 60
    key = ((rng.integers(0, n_tiles, s) << 20)
           | rng.integers(0, 1 << 20, s)).astype(np.int32)
    key[rng.random(s) < 0.4] = DEAD
    want = depth_prune_cutkeys(jnp.asarray(key), n_tiles, 384, safety=2.0)
    got = TT.depth_prune_cutkeys(torch.from_numpy(key), n_tiles, 384,
                                 safety=2.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# K1: composite_records / composite_records_at
# ---------------------------------------------------------------------------

def _composite_inputs(rng, t_tiles, m, p):
    """Records over a (2, P/2) pixel tile spanning k in [-1, 1] x
    [-0.01, 0.01]; tile 0 opens with a chunk of opaque tile-covering
    records, so its later chunks take the tile-wide early exit."""
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
    counts = rng.integers(0, m + 1, t_tiles).astype(np.int32)
    counts[0] = m
    counts[1] = 0
    half = p // 2
    gx = np.tile(np.linspace(-1, 1, half, dtype=np.float32), 2)
    gy = np.repeat(np.array([0.01, -0.01], np.float32), half)
    kx = np.broadcast_to(gx, (t_tiles, 1, p)).copy()
    ky = np.broadcast_to(gy, (t_tiles, 1, p)).copy()
    return f, counts, kx, ky


def _assert_carry_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:, 0:4], want[:, 0:4], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-5, atol=1e-12)
    assert np.all(got[:, 5:8] == 0)
    # The deepening selection reads max T > 1e-6 per tile.
    np.testing.assert_array_equal(got[:, 4].max(1) > 1e-6,
                                  want[:, 4].max(1) > 1e-6)


def test_composite_records_matches_reference():
    from fourdgs.ops import composite_pallas as RC
    rng = np.random.default_rng(0)
    t_tiles, m, p = 6, 256, 256
    f, counts, kx, ky = _composite_inputs(rng, t_tiles, m, p)
    carry = np.asarray(RC.identity_carry(t_tiles, jnp.float32, p))
    want = RC.composite_records(jnp.asarray(f), jnp.asarray(counts),
                                jnp.asarray(kx), jnp.asarray(ky),
                                jnp.asarray(carry))
    got = TC.composite_records(torch.from_numpy(f), torch.from_numpy(counts),
                               torch.from_numpy(kx), torch.from_numpy(ky),
                               TC.identity_carry(t_tiles, p, device="cpu"))
    _assert_carry_close(got.numpy(), want)
    assert np.asarray(want)[0, 4].max() <= 1e-6     # tile 0 saturated
    assert np.asarray(want)[:, 3].max() > 0.1       # real coverage


def test_composite_records_at_matches_reference():
    from fourdgs.ops import composite_pallas as RC
    rng = np.random.default_rng(1)
    t_tiles, m, p = 8, 128, 256
    f0, c0, kx, ky = _composite_inputs(rng, t_tiles, m, p)
    carry = RC.composite_records(
        jnp.asarray(f0), jnp.asarray(c0), jnp.asarray(kx), jnp.asarray(ky),
        RC.identity_carry(t_tiles, jnp.float32, p))
    f1, c1, _, _ = _composite_inputs(rng, 5, m, p)
    sel = np.array([3, 0, 6, 5, 2], np.int32)
    c1[4] = 0                                         # a filler tile
    want = RC.composite_records_at(jnp.asarray(f1), jnp.asarray(c1),
                                   jnp.asarray(sel), jnp.asarray(kx),
                                   jnp.asarray(ky), carry)
    got_carry = torch.from_numpy(np.array(carry))
    got = TC.composite_records_at(torch.from_numpy(f1), torch.from_numpy(c1),
                                  torch.from_numpy(sel), torch.from_numpy(kx),
                                  torch.from_numpy(ky), got_carry)
    assert got is got_carry                           # updated in place
    _assert_carry_close(got.numpy(), want)
    untouched = [1, 4, 7]
    np.testing.assert_array_equal(got.numpy()[untouched],
                                  np.asarray(carry)[untouched])


def test_pack_records_matches_reference():
    from fourdgs.ops import composite_pallas as RC
    from fourdgs.render.project import Projected as RProj
    from fourdgs_torch.render.project import Projected as TProj
    rng = np.random.default_rng(3)
    n = 50
    fields = {k: rng.uniform(0.1, 1.0, n).astype(np.float32)
              for k in ("mx", "my", "depth", "view_z", "v0x", "v0y", "l0",
                        "l1", "r", "g", "b", "a", "opacity")}
    fields["valid"] = rng.random(n) < 0.8
    rproj = RProj(**{k: jnp.asarray(v) for k, v in fields.items()})
    tproj = TProj(**{k: torch.from_numpy(v) for k, v in fields.items()})
    idx = rng.integers(0, n, (4, 128)).astype(np.int32)
    live = rng.random((4, 128)) < 0.7
    p00, p11 = np.float32(1.7), np.float32(3.1)
    want = RC.pack_records(rproj, jnp.asarray(idx), jnp.asarray(live),
                           p00, p11)
    got = TC.pack_records(tproj, torch.from_numpy(idx).long(),
                          torch.from_numpy(live), torch.tensor(p00),
                          torch.tensor(p11))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# K5 (general form) and K14: pack_rows and its VJP
# ---------------------------------------------------------------------------

def _pack_views(rows, pad_to):
    return tuple(jnp.pad(jnp.asarray(f), (0, pad_to - f.shape[0]))
                 .reshape(pad_to // 128, 128) for f in rows)


@pytest.mark.parametrize("r,n,pad_to", [(10, 3000, 4096), (3, 2048, 2048),
                                        (16, 1, 1024)])
def test_pack_rows_matches_reference(r, n, pad_to):
    """Forward against the reference's kernel (interpret mode) and against
    jnp.stack; backward against jax.grad through the kernel's custom VJP
    (its unpack kernel)."""
    from fourdgs.ops import pack_pallas as RP
    from fourdgs_torch.ops import pack_cuda as TPK
    rng = np.random.default_rng(r + n)
    rows = [rng.standard_normal(n).astype(np.float32) for _ in range(r)]
    cot = rng.standard_normal((r, pad_to)).astype(np.float32)
    blk = RP._blk_for(pad_to)
    want = RP._pack_core(_pack_views(rows, pad_to), blk, True)
    trows = [torch.from_numpy(f).requires_grad_(True) for f in rows]
    got = TPK.pack_rows(trows, pad_to)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.detach().numpy(),
        np.asarray(RP.pack_rows([jnp.asarray(f) for f in rows], pad_to)))
    assert (got.detach().numpy()[:, n:] == 0).all()

    def loss(views):
        return jnp.sum(RP._pack_core(views, blk, True) * jnp.asarray(cot))
    want_g = jax.grad(loss)(_pack_views(rows, pad_to))
    (got * torch.from_numpy(cot)).sum().backward()
    for f, g in zip(trows, want_g):
        np.testing.assert_allclose(f.grad.numpy(),
                                   np.asarray(g).reshape(-1)[:n], rtol=1e-6,
                                   atol=0)
        assert f.grad.is_contiguous()


def test_pack_rows_gradcheck():
    from fourdgs_torch.ops import pack_cuda as TPK
    gen = torch.Generator().manual_seed(0)
    rows = [torch.randn(37, dtype=torch.float64, generator=gen,
                        requires_grad=True) for _ in range(4)]
    assert torch.autograd.gradcheck(lambda *r: TPK.pack_rows(r, 64), rows)


def test_pack_rows_int32_and_refusals():
    from fourdgs.ops import pack_pallas as RP
    from fourdgs_torch.ops import pack_cuda as TPK
    rng = np.random.default_rng(9)
    rows = [rng.integers(-2 ** 31, 2 ** 31 - 1, 1500, dtype=np.int32)
            for _ in range(6)]
    want = RP._pack_core(_pack_views(rows, 2048), 2048, True)
    got = TPK.pack_rows([torch.from_numpy(f) for f in rows], 2048)
    assert got.dtype == torch.int32 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cot = torch.from_numpy(np.array(want))
    for g, f in zip(TPK.unpack_rows(cot, 1500), rows):
        np.testing.assert_array_equal(g.numpy(), f)
    f = torch.zeros(8)
    with pytest.raises(ValueError, match="rows"):
        TPK.pack_rows([f] * 17, 8)
    with pytest.raises(ValueError, match="pad_to"):
        TPK.pack_rows([f], 4)
    with pytest.raises(ValueError, match="one dtype"):
        TPK.pack_rows([f, f.int()], 8)
    with pytest.raises(ValueError, match="cotangent"):
        TPK.unpack_rows(torch.zeros((2, 8)), 9)
