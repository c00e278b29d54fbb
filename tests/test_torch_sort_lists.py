"""The written-out walks of the two redesigned sort kernels on the CPU:
`rowsort_compact_lists` (K2: cut, per-row lists, sort on (key, position),
overflowing rows through the full sort) against the plain version exactly
and the JAX reference's `rowsort_compact` (interpret mode) as per-row key
multisets with equal `dropped`; `merge_cross_stages_plain` (K12: several
stages on the elements one thread holds) against repeated single stages
exactly; the grouped launch schedule against the ungrouped one; and
`merge_sorted_rows` through the grouped schedule against `torch.sort` and
the reference.

Inputs are made with numpy from fixed seeds and handed to both sides.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fourdgs_torch.ops import sort_checks as TSC  # noqa: E402
from fourdgs_torch.ops import sort_cuda as TS  # noqa: E402

DEAD = np.iinfo(np.int32).max
N_TILES, SHIFT = 30, 20
ROWS = 256                       # rowsort pads its rows to a multiple of this


def _branch_rows(seed, row_len, keep, cap, short):
    """Slots whose strided rows hold 0, 1, keep - 1, keep, keep + 1, cap,
    cap + 1 and row_len live keys in turn; the first 64 rows hold one key
    over and over, every other later row has depths above the cut too. The
    last `short` slots are left off (S no multiple of the rows)."""
    rng = np.random.default_rng(seed)
    counts = np.array([min(c, row_len) for c in
                       (0, 1, keep - 1, keep, keep + 1, cap, cap + 1,
                        row_len)])
    per_row = counts[np.arange(ROWS) % len(counts)]
    key2 = np.full((row_len, ROWS), DEAD, dtype=np.int32)
    for r in range(ROWS):
        at = rng.choice(row_len, per_row[r], replace=False)
        if r < 64:
            key2[at, r] = (3 << SHIFT) | 7
        else:
            depth = rng.integers(0, (1 << 19) if r % 2 else (1 << 20),
                                 per_row[r])
            key2[at, r] = (rng.integers(0, N_TILES, per_row[r]) << SHIFT) \
                | depth
    key = key2.reshape(-1)[:row_len * ROWS - short].copy()
    val = rng.permutation(key.shape[0]).astype(np.int32)
    cut = ((np.arange(N_TILES) << SHIFT) | (1 << 19)).astype(np.int32)
    return key, val, cut, per_row


@pytest.mark.parametrize("use_cut", [True, False])
@pytest.mark.parametrize("cap,keep,row_len,short", [
    (32, 24, 256, 0), (64, 48, 256, 300), (128, 100, 256, 0),
    (64, 32, 128, 77), (32, 32, 64, 0)])
def test_rowsort_lists_equal_plain(cap, keep, row_len, short, use_cut):
    key, val, cut, per_row = _branch_rows(cap + keep, row_len, keep, cap,
                                          short)
    k, v = torch.from_numpy(key), torch.from_numpy(val)
    c = torch.from_numpy(cut) if use_cut else None
    want = TS.rowsort_compact_plain(k, v, keep, row_len, c, SHIFT)
    got = TS.rowsort_compact_lists(k, v, keep, row_len, c, SHIFT, cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ok, ov, live = got
    assert ok.shape == ov.shape == (keep, ROWS) and live.shape == (ROWS,)
    if not use_cut and not short:
        np.testing.assert_array_equal(live.numpy(), per_row)
    over = int((live > cap).sum())
    assert over > 0 and int((live <= cap).sum()) > 0     # both paths ran
    if use_cut:
        assert int(live.sum()) < int((key != DEAD).sum())  # the cut cut
    # A stable sort: equal keys in slot order, so their values (a
    # permutation of the slot indices' order) follow the rows' positions.
    dead = ok == TS.DEAD
    assert bool((ov[dead] == 0).all())
    col = ok[:, 5].numpy()                    # row 5: cap live, one key
    n5 = min(int(live[5]), keep)
    assert (col[:n5] == ((3 << SHIFT) | 7)).all()
    pos = np.flatnonzero(key.reshape(-1)[5::ROWS] != DEAD)[:n5]
    np.testing.assert_array_equal(ov[:n5, 5].numpy(), val[5::ROWS][pos])
    # The wrapper's count of what the keep cap lost.
    _, _, dropped = TS.rowsort_compact(k, v, keep, row_len, c, SHIFT)
    assert int(dropped) == int(torch.clamp(live - keep, min=0).sum()) > 0
    _, _, live2, dropped2 = TS._rowsort_compact_live(k, v, keep, row_len, c,
                                                     SHIFT)
    assert torch.equal(live2, live) and int(dropped2) == int(dropped)


def test_rowsort_lists_refuses_a_cap_below_keep():
    k = torch.zeros(4096, dtype=torch.int32)
    with pytest.raises(ValueError, match="below keep"):
        TS.rowsort_compact_lists(k, k, 48, 16, None, SHIFT, 32)
    assert TS._list_cap(32) == 64 and TS._list_cap(64) == 64
    assert TS._list_cap(65) == 128 and TS._list_cap(129) is None


def _row_keys(k, r):
    col = np.asarray(k)[:, r]
    return np.sort(col[col != DEAD])


@pytest.mark.parametrize("use_cut", [True, False])
def test_rowsort_lists_match_reference(use_cut):
    from fourdgs.ops.sort_pallas import rowsort_compact
    keep, row_len, cap = 24, 256, 32
    key, val, cut, _ = _branch_rows(3, row_len, keep, cap, 123)
    wk, wv, wd = rowsort_compact(jnp.asarray(key), jnp.asarray(val), keep,
                                 row_len=row_len,
                                 cut=jnp.asarray(cut) if use_cut else None,
                                 key_shift=SHIFT, interpret=True)
    k, v = torch.from_numpy(key), torch.from_numpy(val)
    gk, gv, live = TS.rowsort_compact_lists(
        k, v, keep, row_len, torch.from_numpy(cut) if use_cut else None,
        SHIFT, cap)
    assert gk.shape == tuple(wk.shape)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    for r in range(ROWS):
        np.testing.assert_array_equal(_row_keys(gk, r), _row_keys(wk, r))
    assert int(torch.clamp(live - keep, min=0).sum()) == int(wd) > 0
    # Values: equal as per-row (key, value) multisets wherever the keep cap
    # cut no run of equal keys (ties order arbitrarily in the reference).
    pairs = lambda a, b, r: np.sort(  # noqa: E731
        (np.asarray(a)[:, r].astype(np.int64) << 32)
        | (np.asarray(b)[:, r].astype(np.int64) & 0xFFFFFFFF))
    for r in range(64, ROWS):                 # rows of (nearly) distinct keys
        if int(live[r]) <= keep:
            live_r = np.asarray(wk)[:, r] != DEAD
            np.testing.assert_array_equal(
                pairs(gk, gv, r)[:live_r.sum()],
                pairs(wk, wv, r)[:live_r.sum()])


@pytest.mark.parametrize("use_cut", [True, False])
@pytest.mark.parametrize("cap,keep,row_len,short", [
    (32, 24, 256, 0), (64, 48, 256, 300), (128, 100, 256, 0)])
def test_rowsort_alternating_lists_equal_plain(cap, keep, row_len, short,
                                               use_cut):
    """K2's alternating form: odd rows descending, their tail kept, i.e.
    the ascending keep reversed; even rows exactly as without it."""
    key, val, cut, _ = _branch_rows(cap + keep + 1, row_len, keep, cap,
                                    short)
    k, v = torch.from_numpy(key), torch.from_numpy(val)
    c = torch.from_numpy(cut) if use_cut else None
    want = TS.rowsort_compact_plain(k, v, keep, row_len, c, SHIFT,
                                    alternating=True)
    got = TS.rowsort_compact_lists(k, v, keep, row_len, c, SHIFT, cap,
                                   alternating=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    asc = TS.rowsort_compact_plain(k, v, keep, row_len, c, SHIFT)
    for a, g in zip(asc[:2], got[:2]):
        assert torch.equal(g[:, 0::2], a[:, 0::2])
        assert torch.equal(g[:, 1::2], a[:, 1::2].flip(0))
    assert torch.equal(got[2], asc[2])
    ok = got[0].numpy().astype(np.int64)
    assert (np.diff(ok[:, 1::2], axis=0) <= 0).all()      # descending
    assert (np.diff(ok[:, 0::2], axis=0) >= 0).all()
    ok_w, _, dropped = TS.rowsort_compact(k, v, keep, row_len, c, SHIFT,
                                          alternating=True)
    assert torch.equal(ok_w, got[0])
    assert int(dropped) == int(torch.clamp(got[2] - keep, min=0).sum())


@pytest.mark.parametrize("use_cut", [True, False])
def test_rowsort_alternating_matches_reference(use_cut):
    """The reference's rowsort_compact(alternating=True) in interpret mode:
    keys exactly, values as per-row (key, value) multisets where the keep
    cap cut no run of equal keys (its bitonic network orders ties
    arbitrarily), `dropped` equal."""
    from fourdgs.ops.sort_pallas import rowsort_compact
    keep, row_len, cap = 24, 256, 32
    key, val, cut, _ = _branch_rows(5, row_len, keep, cap, 123)
    wk, wv, wd = rowsort_compact(jnp.asarray(key), jnp.asarray(val), keep,
                                 row_len=row_len, alternating=True,
                                 cut=jnp.asarray(cut) if use_cut else None,
                                 key_shift=SHIFT, interpret=True)
    k, v = torch.from_numpy(key), torch.from_numpy(val)
    c = torch.from_numpy(cut) if use_cut else None
    pk, pv, _ = TS.rowsort_compact_plain(k, v, keep, row_len, c, SHIFT,
                                         alternating=True)
    gk, gv, live = TS.rowsort_compact_lists(k, v, keep, row_len, c, SHIFT,
                                            cap, alternating=True)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(wk))
    assert int(torch.clamp(live - keep, min=0).sum()) == int(wd) > 0
    def pairs(a, b, r):
        """The row's live (key, value) pairs, sorted (a DEAD key's value is
        0 in the port and arbitrary in the reference)."""
        ka, vb = np.asarray(a)[:, r], np.asarray(b)[:, r]
        at = ka != DEAD
        return np.sort((ka[at].astype(np.int64) << 32)
                       | (vb[at].astype(np.int64) & 0xFFFFFFFF))
    for r in range(64, ROWS):
        if int(live[r]) <= keep:
            np.testing.assert_array_equal(pairs(gk, gv, r), pairs(wk, wv, r))
            np.testing.assert_array_equal(pairs(pk, pv, r), pairs(wk, wv, r))


# ---------------------------------------------------------------------------
# K12: several stages a pass
# ---------------------------------------------------------------------------

def _runs(n, block, seed, ties):
    rng = np.random.default_rng(seed)
    hi = 50 if ties else (1 << 31) - 2
    k = torch.from_numpy(rng.integers(0, hi, n, dtype=np.int32))
    v = torch.arange(n, dtype=torch.int32)
    return TS.merge_tree_plain(k, v, min(256, block), block, False)


@pytest.mark.parametrize("group", [1, 2, 3, 4])
@pytest.mark.parametrize("log_n", [15, 16, 17, 18])
def test_cross_stages_equal_repeated_single_stages(log_n, group):
    """Every pass of the grouped schedule, walked from K11's output, equals
    its single stages run one after the other, keys and values (heavy ties:
    a stage that moved an equal key would show in the values)."""
    n, block = 1 << log_n, 1 << 10
    k, v = _runs(n, block, log_n, ties=True)
    steps = TS.merge_schedule(n, block, group)
    sizes = []
    for st in steps:
        if st[0] == "finish":
            k, v = TS.merge_finish_plain(k, v, block, st[1])
            continue
        d_hi, run_out = st[1], st[2]
        size = st[3] if group > 1 else 1
        sizes.append(size)
        wk, wv = k, v
        for i in range(size):
            wk, wv = TS.merge_cross_stage_plain(wk, wv, d_hi >> i, run_out)
        gk, gv = TS.merge_cross_stages_plain(k, v, d_hi, size, run_out)
        assert torch.equal(gk, wk) and torch.equal(gv, wv), st
        pk, pv = TS.merge_cross_stages(k, v, d_hi, size, run_out)
        assert torch.equal(pk, wk) and torch.equal(pv, wv), st
        k, v = gk, gv
    assert bool(TSC.is_sorted(k)[0])
    assert max(sizes) == min(group, log_n - 10)
    assert torch.equal(torch.sort(v).values,
                       torch.arange(n, dtype=torch.int32))


@pytest.mark.parametrize("d_hi,size,run_out", [
    (4, 3, 8), (8, 4, 1 << 12), (1 << 11, 1, 1 << 12), (64, 2, 256)])
def test_cross_stages_at_small_distances(d_hi, size, run_out):
    """Distances down to 1 and runs down to 2 * d_hi: the group axis is
    then the innermost one."""
    rng = np.random.default_rng(d_hi)
    n = 1 << 12
    k = torch.from_numpy(rng.integers(0, 9, n, dtype=np.int32))
    v = torch.arange(n, dtype=torch.int32)
    wk, wv = k, v
    for i in range(size):
        wk, wv = TS.merge_cross_stage_plain(wk, wv, d_hi >> i, run_out)
    gk, gv = TS.merge_cross_stages_plain(k, v, d_hi, size, run_out)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


def test_cross_stages_refuses_bad_groups():
    k = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError, match="stages"):
        TS.merge_cross_stages(k, k, 256, 5, 1024)
    with pytest.raises(ValueError, match="stages"):
        TS.merge_cross_stages(k, k, 2, 3, 1024)      # below distance 1
    with pytest.raises(ValueError, match="run_out"):
        TS.merge_cross_stages(k, k, 512, 2, 512)
    with pytest.raises(ValueError, match="block"):
        TS.merge_levels(k, k, 2048)


@pytest.mark.parametrize("n,block,group", [
    (1 << 21, 1 << 14, 4), (1 << 18, 1 << 14, 4), (1 << 18, 1 << 10, 4),
    (1 << 18, 1 << 10, 3), (1 << 16, 1 << 10, 2), (1 << 14, 1 << 14, 4),
    (1 << 15, 1 << 14, 4)])
def test_grouped_schedule_flattens_to_the_ungrouped(n, block, group):
    flat = []
    passes = 0
    for st in TS.merge_schedule(n, block, group):
        if st[0] == "finish":
            flat.append(st)
            continue
        assert 1 <= st[3] <= group
        passes += 1
        flat += [("cross", st[1] >> i, st[2]) for i in range(st[3])]
    single = TS.merge_schedule(n, block)
    assert flat == single
    levels = (n // block).bit_length() - 1
    assert passes == sum(-(-k // group) for k in range(1, levels + 1))
    if (n, block, group) == (1 << 21, 1 << 14, 4):
        # The 10M frame's merge: 28 cross stages in 10 passes, 7 finishes.
        assert passes == 10 and len(single) == 35
        assert [st[3] for st in TS.merge_schedule(n, block, group)
                if st[0] == "cross"] == [1, 2, 3, 4, 3, 2, 3, 3, 4, 3]


def _kv64(k, v):
    return np.sort(np.asarray(k).astype(np.int64) << 32
                   | (np.asarray(v).astype(np.int64) & 0xFFFFFFFF))


@pytest.mark.parametrize("block_log,group", [(12, 4), (11, 3)])
def test_merge_sorted_rows_through_grouped_schedule(monkeypatch, block_log,
                                                    group):
    """The whole merge with a smaller block, so that levels of up to seven
    cross stages run in passes of up to `group`, against torch.sort and the
    reference's merge_sorted_rows."""
    from fourdgs.ops.sort_pallas import merge_sorted_rows
    monkeypatch.setattr(TS, "MERGE_BLOCK", 1 << block_log)
    monkeypatch.setattr(TS, "CROSS_GROUP", group)
    rng = np.random.default_rng(block_log)
    r, c = 40, 256
    keys = rng.integers(0, 300, size=r * c, dtype=np.int32)
    keys[rng.random(r * c) < 0.4] = DEAD
    vals = rng.integers(0, 1 << 24, size=r * c, dtype=np.int32)
    order = np.argsort(keys.reshape(r, c), axis=1, kind="stable")
    k2 = np.take_along_axis(keys.reshape(r, c), order, axis=1)
    v2 = np.take_along_axis(vals.reshape(r, c), order, axis=1)
    gk, gv = TS.merge_sorted_rows(torch.from_numpy(k2), torch.from_numpy(v2))
    n = TS.merged_rows(r, c) * c
    steps = TS.merge_schedule(n, 1 << block_log, group)
    assert max(st[3] for st in steps if st[0] == "cross") == group
    wk, wv = TS.merge_sorted_rows_plain(torch.from_numpy(k2),
                                        torch.from_numpy(v2))
    assert torch.equal(gk, wk)
    np.testing.assert_array_equal(_kv64(gk, gv), _kv64(wk, wv))
    rk, rv = merge_sorted_rows(jnp.asarray(k2), jnp.asarray(v2),
                               interpret=True)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
    n_live = int((keys != DEAD).sum())
    np.testing.assert_array_equal(_kv64(gk[:n_live], gv[:n_live]),
                                  _kv64(np.asarray(rk)[:n_live],
                                        np.asarray(rv)[:n_live]))
