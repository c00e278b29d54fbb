"""The register rounds of the merge kernels K11 and K13
(fourdgs_torch/ops/csrc/merge_rounds.cuh), written out in plain PyTorch as
`sort_cuda.merge_tree_rounds` / `merge_finish_rounds`, held exactly (keys and
values) against the stage-by-stage network that the CUDA source walks
(`_network` of tests/test_torch_sort.py, every stage by K12's plain
version). No compiler runs here: what these tests prove is the walk (the
layouts' index maps, the rounds' stages on the register axis, the swizzled
transposes, the direction folded into the keys), at tiles of 1,024 to 4,096
pairs and 4 or 16 pairs a thread; the kernels' own bits are held against
their earlier form on the card by chip_smoke.py (m).

Keys are made with numpy from fixed seeds: wide random keys, few distinct
keys (ties), all keys equal, and rows that are all DEAD; values are the
pairs' positions, so a value that moves differently shows.
"""

import numpy as np
import pytest
import torch

from fourdgs_torch.ops import sort_cuda as TS
from test_torch_sort import _network

DEAD = TS.DEAD


def _keys(kind: str, n: int, c: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, DEAD, n, dtype=np.int32)
    if kind == "ties":
        return rng.integers(0, 7, n, dtype=np.int32)
    if kind == "equal":
        return np.full(n, 5, dtype=np.int32)
    assert kind == "dead"                  # half the rows all DEAD
    k = rng.integers(0, 1 << 20, n, dtype=np.int32).reshape(-1, c)
    k[rng.permutation(k.shape[0])[:k.shape[0] // 2]] = DEAD
    return k.reshape(-1)


def _rows(kind, n, c, alternating, seed):
    """Flat (key, value) arrays of sorted rows of c: ascending, or odd rows
    descending when alternating."""
    k = torch.from_numpy(_keys(kind, n, c, seed))
    v = torch.arange(n, dtype=torch.int32)
    k, v = TS._sort_runs(k, v, c, alternate=False)
    if alternating:
        k2, v2 = k.reshape(-1, c).clone(), v.reshape(-1, c).clone()
        k2[1::2], v2[1::2] = k2[1::2].flip(1), v2[1::2].flip(1)
        k, v = k2.reshape(-1), v2.reshape(-1)
    return k, v


@pytest.mark.parametrize("c,tile_bits,reg_bits,alternating,kind", [
    (256, 10, 2, False, "random"), (256, 10, 4, True, "ties"),
    (256, 11, 4, False, "dead"), (512, 11, 2, True, "equal"),
    (512, 12, 4, False, "random"), (512, 12, 2, True, "dead"),
    (256, 12, 4, True, "ties"), (512, 12, 4, True, "equal")])
def test_merge_tree_rounds_equal_the_network(c, tile_bits, reg_bits,
                                             alternating, kind):
    """K11's levels from rows of c up to runs of the tile, as rounds, equal
    the single stages of the network, keys and values, in both row forms;
    four tiles, so the tiles' runs alternate in direction."""
    block = 1 << tile_bits
    n = 4 * block
    k, v = _rows(kind, n, c, alternating, seed=c + tile_bits + reg_bits)
    (wk, wv), _ = _network(k, v, c, block, alternating)
    gk, gv = TS.merge_tree_rounds(k, v, c, block, alternating, tile_bits,
                                  reg_bits)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    runs = gk.reshape(-1, block).long()
    assert (runs[0::2].diff(dim=1) >= 0).all()
    assert (runs[1::2].diff(dim=1) <= 0).all()


@pytest.mark.parametrize("tile_bits,reg_bits,run_factor,kind", [
    (10, 2, 1, "random"), (10, 4, 2, "ties"), (11, 4, 1, "equal"),
    (11, 2, 4, "dead"), (12, 4, 8, "random"), (12, 2, 2, "ties")])
def test_merge_finish_rounds_equal_the_stages(tile_bits, reg_bits,
                                              run_factor, kind):
    """K13's stages block/2 ... 1 at run_out = block (every other block
    descending), above it, and at the whole array (ascending), as rounds,
    equal the single stages, keys and values, on any input."""
    block = 1 << tile_bits
    n = 8 * block
    run_out = run_factor * block
    k = torch.from_numpy(_keys(kind, n, 256, seed=tile_bits * run_factor))
    v = torch.arange(n, dtype=torch.int32)
    wk, wv = k, v
    d = block // 2
    while d >= 1:
        wk, wv = TS.merge_cross_stage_plain(wk, wv, d, run_out)
        d //= 2
    gk, gv = TS.merge_finish_rounds(k, v, run_out, block, tile_bits,
                                    reg_bits)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.parametrize("c,tile_bits,reg_bits,alternating,kind", [
    (256, 10, 4, False, "ties"), (512, 11, 2, True, "dead"),
    (256, 12, 4, True, "random")])
def test_rounds_chained_by_the_schedule_equal_the_network(
        c, tile_bits, reg_bits, alternating, kind):
    """The whole merge as the card runs it: K11 as rounds, the launch
    schedule's K12 passes (plain), every K13 as rounds; equal to the network
    of single stages, keys and values, and sorted."""
    block = 1 << tile_bits
    n = 8 * block
    k, v = _rows(kind, n, c, alternating, seed=tile_bits)
    _, (wk, wv) = _network(k, v, c, block, alternating)
    gk, gv = TS.merge_tree_rounds(k, v, c, block, alternating, tile_bits,
                                  reg_bits)
    for step in TS.merge_schedule(n, block, TS.CROSS_GROUP):
        if step[0] == "cross":
            gk, gv = TS.merge_cross_stages_plain(gk, gv, step[1], step[3],
                                                 step[2])
        else:
            gk, gv = TS.merge_finish_rounds(gk, gv, step[1], block,
                                            tile_bits, reg_bits)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert (gk.long().diff() >= 0).all()


@pytest.mark.parametrize("kernel", ["tree", "finish"])
def test_rounds_on_an_array_smaller_than_a_tile(kernel):
    """An array of fewer pairs than a tile: the pairs past its end are never
    met by a real one, and the final run comes out ascending."""
    tile_bits, n = 12, 2048
    if kernel == "tree":
        k, v = _rows("ties", n, 256, False, seed=3)
        (wk, wv), _ = _network(k, v, 256, n, False)
        gk, gv = TS.merge_tree_rounds(k, v, 256, n, False, tile_bits)
    else:                        # a bitonic input: two runs, one descending
        k, v = _rows("ties", n, n // 2, True, seed=3)
        wk, wv = k, v
        d = n // 2
        while d >= 1:
            wk, wv = TS.merge_cross_stage_plain(wk, wv, d, n)
            d //= 2
        gk, gv = TS.merge_finish_rounds(k, v, n, n, tile_bits)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert (gk.long().diff() >= 0).all()


def test_layouts_and_swizzle_of_the_kernels():
    """At the kernels' tile (16,384 pairs, 16 a thread, 1,024 threads) every
    layout holds each pair once, the swizzle is a permutation, and in every
    transpose the 16 lanes of each half-warp reach 16 distinct 8-byte bank
    pairs (their places differ mod 16): no bank conflict."""
    tile = 1 << TS.ROUND_TILE_BITS
    assert torch.equal(torch.sort(TS.round_swizzle(torch.arange(tile)))[0],
                       torch.arange(tile))
    for lo in range(TS.ROUND_TILE_BITS - TS.ROUND_REG_BITS + 1):
        idx = TS.round_layout(lo)
        assert idx.shape == (1024, 16)
        assert torch.equal(torch.sort(idx.reshape(-1))[0],
                           torch.arange(tile))
        banks = TS.round_swizzle(idx) % 16            # (threads, registers)
        halves = banks.reshape(-1, 16, 16)            # (half-warp, lane, j)
        for j in range(16):
            assert all(len(set(h[:, j].tolist())) == 16 for h in halves), lo
        # A warp holds 512 consecutive pairs exactly in the warp layouts,
        # and the swizzle keeps their places inside the warp's 512.
        warps = idx.reshape(32, -1)
        own = (warps // 512 == torch.arange(32)[:, None]).all()
        assert bool(own) == (lo <= TS.ROUND_WARP_LO), lo
        if lo <= TS.ROUND_WARP_LO:
            places = TS.round_swizzle(warps)
            assert (places // 512 == torch.arange(32)[:, None]).all()


def _barriers(layouts):
    """(block-wide, warp) barriers of the transposes through `layouts`."""
    moves = [(a, b) for a, b in zip(layouts, layouts[1:]) if a != b]
    warp = sum(a <= TS.ROUND_WARP_LO and b <= TS.ROUND_WARP_LO
               for a, b in moves)
    return len(moves) - warp, warp


def test_rounds_of_the_frames_merge():
    """At the 10M frame's merge (rows of 512 into runs of 16,384): K11's 60
    stages take 17 rounds; from its load to its store it moves the tile 17
    times, 10 behind a block-wide barrier and 7 inside warps. A K13 of
    16,384 pairs takes its 14 stages in 4 rounds, with 2 block-wide and 2
    warp barriers (against 14 and 60 barriers, one a stage, before)."""
    k11 = [r for m in range(9, 14) for r in TS.level_rounds(m)]
    assert sum(s for _, s in k11) == 60 and len(k11) == 17
    assert _barriers([lo for lo, _ in k11] + [TS.ROUND_WARP_LO]) == (10, 7)
    k13 = TS.level_rounds(13)
    assert k13 == [(10, 4), (6, 4), (2, 4), (0, 2)]
    assert _barriers([lo for lo, _ in k13] + [TS.ROUND_WARP_LO]) == (2, 2)
