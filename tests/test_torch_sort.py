"""Parity of the port's pair-sort kernels with the JAX reference on the CPU:
the standalone prune cut (K10), the alternating compaction, the bitonic
merge of sorted rows (K11-K13) and the sort validators. `bin_splats` and the
frame under `sort_backend="pallas"` are in tests/test_torch_sort_frame.py.

Inputs are made with numpy from fixed seeds and handed to both sides. The
reference's Pallas kernels run in interpret mode, as its own tests run them
(tests/test_sortpallas.py); the port runs its kernels' plain PyTorch
versions, chained by the same launch schedule the card runs. Integers are
compared exactly, sorted values as (key, value) multisets (ties within a key
order arbitrarily on both sides).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fourdgs_torch.ops import lookup_cuda as TL  # noqa: E402
from fourdgs_torch.ops import sort_checks as TSC  # noqa: E402
from fourdgs_torch.ops import sort_cuda as TS  # noqa: E402
from fourdgs_torch.render import tiles as TT  # noqa: E402

DEAD = np.iinfo(np.int32).max


def _kv64(k, v):
    return np.sort(np.asarray(k).astype(np.int64) << 32
                   | (np.asarray(v).astype(np.int64) & 0xFFFFFFFF))


# ---------------------------------------------------------------------------
# K10: apply_cutkeys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [2 * 32768 + 777, 20_001])
def test_apply_cutkeys_matches_reference(s):
    """Past 32,768 keys the reference runs its kernel on the whole blocks
    and a gather on the ragged tail; below, the gather alone."""
    from fourdgs.ops.lookup_pallas import apply_cutkeys
    rng = np.random.default_rng(s)
    t = 300
    cut = ((np.arange(t) << 20)
           | rng.integers(0, 1 << 20, t)).astype(np.int32)
    key = ((rng.integers(0, t, s) << 20)
           | rng.integers(0, 1 << 20, s)).astype(np.int32)
    key[rng.choice(s, s // 5, replace=False)] = DEAD
    want = np.asarray(apply_cutkeys(jnp.asarray(key), jnp.asarray(cut),
                                    interpret=True))
    got = TL.apply_cutkeys(torch.from_numpy(key), torch.from_numpy(cut))
    np.testing.assert_array_equal(got.numpy(), want)
    pruned = int(((want == DEAD) & (key != DEAD)).sum())
    assert 0.2 * s < pruned < 0.6 * s          # the cut really cut
    assert (want[key == DEAD] == DEAD).all()


def test_apply_cutkeys_refuses_bad_tables():
    key = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="cut"):
        TL.apply_cutkeys(key, torch.zeros(2049, dtype=torch.int32))
    with pytest.raises(ValueError, match="cut"):
        TL.apply_cutkeys(key, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="key"):
        TL.apply_cutkeys(key.long(), torch.zeros(4, dtype=torch.int32))


# ---------------------------------------------------------------------------
# compact_pairs: rows=, alternating, flat=False
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,keep,alternating", [
    (4, 256, True), (4, 256, False), (8, 8192, True), (1, 512, True)])
def test_compact_pairs_forms_match_reference(rows, keep, alternating):
    from fourdgs.render.tiles import compact_pairs
    rng = np.random.default_rng(rows * 1000 + keep)
    s = 3 * 8192 + 501
    key = rng.choice(1 << 30, s, replace=False).astype(np.int32)
    key[rng.random(s) < 0.9] = DEAD
    val = rng.permutation(s).astype(np.int32)
    wk, wv, wd = compact_pairs(jnp.asarray(key), jnp.asarray(val), DEAD,
                               keep, rows=rows, alternating=alternating,
                               flat=False)
    gk, gv, gd = TT.compact_pairs(torch.from_numpy(key),
                                  torch.from_numpy(val), DEAD, keep,
                                  rows=rows, alternating=alternating,
                                  flat=False)
    assert gk.shape == gv.shape == tuple(wk.shape) == (rows, keep)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    live = gk.numpy() != DEAD                  # keys are distinct
    np.testing.assert_array_equal(gv.numpy()[live], np.asarray(wv)[live])
    assert int(gd) == int(wd) and (int(gd) > 0) == (keep < 8192)
    if alternating and rows > 1:
        k = gk.numpy().astype(np.int64)
        assert (np.diff(k[0::2], axis=1) >= 0).all()
        assert (np.diff(k[1::2], axis=1) <= 0).all()
        if not int(gd):                        # dead slots lead an odd row
            assert (k[1::2, 0] == DEAD).all()
    fk, fv, fd = TT.compact_pairs(torch.from_numpy(key),
                                  torch.from_numpy(val), DEAD, keep,
                                  rows=rows, alternating=alternating)
    assert torch.equal(fk, gk.reshape(-1)) and torch.equal(fv, gv.reshape(-1))


# ---------------------------------------------------------------------------
# K11-K13: merge_sorted_rows
# ---------------------------------------------------------------------------

def _sorted_rows(rng, r, c, alternating, live_frac=0.6, ties=False):
    hi = 64 if ties else (1 << 31) - 2
    keys = rng.integers(0, hi, size=r * c, dtype=np.int32)
    keys[rng.choice(r * c, r * c - int(r * c * live_frac),
                    replace=False)] = DEAD
    vals = rng.integers(0, 1 << 24, size=r * c, dtype=np.int32)
    order = np.argsort(keys.reshape(r, c), axis=1, kind="stable")
    k2 = np.take_along_axis(keys.reshape(r, c), order, axis=1)
    v2 = np.take_along_axis(vals.reshape(r, c), order, axis=1)
    if alternating:
        k2[1::2] = k2[1::2, ::-1].copy()
        v2[1::2] = v2[1::2, ::-1].copy()
    return keys, vals, k2, v2


MERGE_SHAPES = [(4, 256, False), (9, 256, False), (16, 512, True),
                (40, 256, False)]


@pytest.mark.parametrize("r,c,alternating", MERGE_SHAPES)
def test_merge_sorted_rows_matches_reference(r, c, alternating):
    from fourdgs.ops.sort_pallas import merge_sorted_rows
    rng = np.random.default_rng(r * 1000 + c)
    keys, vals, k2, v2 = _sorted_rows(rng, r, c, alternating)
    wk, wv = merge_sorted_rows(jnp.asarray(k2), jnp.asarray(v2),
                               rows_alternating=alternating, interpret=True)
    wk, wv = np.asarray(wk), np.asarray(wv)
    gk, gv = TS.merge_sorted_rows(torch.from_numpy(k2), torch.from_numpy(v2),
                                  rows_alternating=alternating)
    gk, gv = gk.numpy(), gv.numpy()
    assert gk.shape == wk.shape == (TS.merged_rows(r, c) * c,)
    np.testing.assert_array_equal(gk, wk)
    n_live = int((keys != DEAD).sum())
    np.testing.assert_array_equal(gk[:n_live], np.sort(keys)[:n_live])
    assert (gk[n_live:] == DEAD).all()
    np.testing.assert_array_equal(_kv64(gk[:n_live], gv[:n_live]),
                                  _kv64(wk[:n_live], wv[:n_live]))
    np.testing.assert_array_equal(
        _kv64(gk[:n_live], gv[:n_live]),
        _kv64(keys[keys != DEAD], vals[keys != DEAD]))


def _network(k, v, c, block, rows_alternating):
    """The compare-exchange network exactly as csrc/merge.cu walks it, with
    every stage (the shared-memory ones of K11 and K13 too) done by K12's
    plain version: K11's load with the odd rows read back to front, its
    levels from runs of c to runs of block, then the schedule's levels."""
    n = k.shape[0]
    if not rows_alternating:
        k2, v2 = k.reshape(-1, c).clone(), v.reshape(-1, c).clone()
        k2[1::2], v2[1::2] = k2[1::2].flip(1), v2[1::2].flip(1)
        k, v = k2.reshape(-1), v2.reshape(-1)
    half = c
    while half < block:                        # K11
        d = half
        while d >= 1:
            k, v = TS.merge_cross_stage_plain(k, v, d, 2 * half)
            d //= 2
        half *= 2
    tree = (k, v)
    for step in TS.merge_schedule(n, block):
        if step[0] == "cross":                 # K12
            k, v = TS.merge_cross_stage_plain(k, v, step[1], step[2])
        else:                                  # K13
            d = block // 2
            while d >= 1:
                k, v = TS.merge_cross_stage_plain(k, v, d, step[1])
                d //= 2
    return tree, (k, v)


@pytest.mark.parametrize("r,c,alternating,ties", [
    (4, 256, False, False), (9, 256, False, True), (16, 512, True, False),
    (40, 256, False, True), (3, 4096, True, False)])
def test_merge_schedule_of_plain_kernels(r, c, alternating, ties):
    """What proves the launch schedule and the direction rule where no
    kernel can run: K11's, K12's and K13's plain versions chained by the
    wrapper's schedule, and the bare network of single stages that the CUDA
    source walks, both give the keys of the whole function's plain version
    and its (key, value) multiset; K11's plain version equals the network's
    first part."""
    rng = np.random.default_rng(r + c)
    _, _, k2, v2 = _sorted_rows(rng, r, c, alternating, ties=ties)
    tk, tv = torch.from_numpy(k2), torch.from_numpy(v2)
    wk, wv = TS.merge_sorted_rows_plain(tk, tv, alternating)
    gk, gv = TS.merge_sorted_rows(tk, tv, rows_alternating=alternating)
    assert torch.equal(gk, wk)
    np.testing.assert_array_equal(_kv64(gk, gv), _kv64(wk, wv))
    assert bool(TSC.is_sorted(gk)[0])

    flat_k, flat_v = TS._pad_rows(tk, tv)
    (nk1, nv1), (nk, nv) = _network(flat_k, flat_v, c, TS.MERGE_BLOCK,
                                    alternating)
    assert torch.equal(nk, wk)
    np.testing.assert_array_equal(_kv64(nk, nv), _kv64(wk, wv))
    pk1, pv1 = TS.merge_tree_plain(flat_k, flat_v, c, TS.MERGE_BLOCK,
                                   alternating)
    assert torch.equal(nk1, pk1)
    np.testing.assert_array_equal(_kv64(nk1, nv1), _kv64(pk1, pv1))
    # 2^18 elements in blocks of 2^14: four levels of 1 + 2 + 3 + 4 cross
    # stages and one finishing pass each.
    steps = TS.merge_schedule(flat_k.shape[0], TS.MERGE_BLOCK)
    assert [s[0] for s in steps].count("cross") == 10
    assert [s[0] for s in steps].count("finish") == 4


def test_merge_finish_plain_equals_its_stages():
    """K13's plain version (a block sort in the run's direction) against
    the stages it stands for, on the bitonic input K12 leaves."""
    rng = np.random.default_rng(5)
    n, block = 1 << 12, 1 << 9
    k = torch.from_numpy(rng.integers(0, 1 << 30, n, dtype=np.int32))
    v = torch.arange(n, dtype=torch.int32)
    k, v = TS.merge_tree_plain(k, v, 256, block, False)   # runs of block
    k, v = TS.merge_cross_stage_plain(k, v, block, 2 * block)
    wk, wv = TS.merge_finish_plain(k, v, block, 2 * block)
    d = block // 2
    while d >= 1:
        k, v = TS.merge_cross_stage_plain(k, v, d, 2 * block)
        d //= 2
    assert torch.equal(k, wk) and torch.equal(v, wv)      # distinct keys
    runs = wk.reshape(-1, 2 * block).long()
    assert (runs[0::2].diff(dim=1) >= 0).all()
    assert (runs[1::2].diff(dim=1) <= 0).all()


def test_merge_sorted_rows_refuses_bad_shapes():
    k = torch.zeros((4, 300), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        TS.merge_sorted_rows(k, k)
    k = torch.zeros((4, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match=">= 256"):
        TS.merge_sorted_rows(k, k)
    k = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError, match="2 \\* d <= run_out"):
        TS.merge_cross_stage(k, k, 512, 512)
    with pytest.raises(ValueError, match="int32"):
        TS.merge_finish(k.long(), k.long(), 1024)


# ---------------------------------------------------------------------------
# sort_checks
# ---------------------------------------------------------------------------

def test_is_sorted_matches_numpy():
    rng = np.random.default_rng(0)
    a = np.sort(rng.integers(0, 1 << 30, 5000, dtype=np.int32))
    ok, errors = TSC.is_sorted(torch.from_numpy(a))
    assert bool(ok) and int(errors) == 0
    b = a.copy()
    b[[10, 900, 4000]] = DEAD
    ok, errors = TSC.is_sorted(torch.from_numpy(b))
    assert not bool(ok)
    assert int(errors) == int((np.diff(b.astype(np.int64)) < 0).sum()) == 3
    ok, errors = TSC.is_sorted(torch.from_numpy(a[::-1].copy()),
                               ascending=False)
    assert bool(ok) and int(errors) == 0


def test_arrays_equal_matches_numpy():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 100, 3000, dtype=np.int32)
    b = a.copy()
    ok, mask = TSC.arrays_equal(torch.from_numpy(a), torch.from_numpy(b))
    assert bool(ok) and not bool(mask.any())
    b[[3, 77]] += 1
    ok, mask = TSC.arrays_equal(torch.from_numpy(a), torch.from_numpy(b))
    assert not bool(ok)
    np.testing.assert_array_equal(mask.numpy(), a != b)


def test_is_permutation_matches_numpy():
    rng = np.random.default_rng(2)
    n = 4096
    perm = rng.permutation(n).astype(np.int32)
    assert bool(TSC.is_permutation(torch.from_numpy(perm), n))
    dup = perm.copy()
    dup[5] = dup[6]
    assert not bool(TSC.is_permutation(torch.from_numpy(dup), n))
    out = perm.copy()
    out[0] = n
    assert not bool(TSC.is_permutation(torch.from_numpy(out), n))
    assert not bool(TSC.is_permutation(torch.from_numpy(perm[:-1]), n))
