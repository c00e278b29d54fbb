"""The walks of the tail's setup kernels, written out in plain PyTorch: K6
(fourdgs_torch/ops/csrc/tail_prepass.cu) as `tail_cuda.prepass_walk`, one
block a chunk reading 16-byte vectors or, off 16 bytes, single words, and K3
(fourdgs_torch/ops/csrc/sample_blocks.cu) as `lookup_cuda.sample_plan`, one
thread a 16-byte vector of the output. No compiler runs here: these tests
hold the walks (every chunk's band, rect and slot mask those of the plain
version and the reference's kernel in interpret mode, exactly, on the
vector and the scalar path; every sample word written once, from the word
the plain version takes, on the vector path and, at a base off 16 bytes,
the scalar path); the kernels' own bits are held against their plain
versions and their earlier forms on the card by chip_smoke.py.

Inputs are made with numpy from fixed seeds. Everything is integer: exact.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fourdgs.ops import lookup_pallas as RL  # noqa: E402
from fourdgs.ops import tail_pallas as RT  # noqa: E402
from fourdgs_torch.ops import lookup_cuda as L  # noqa: E402
from fourdgs_torch.ops import tail_cuda as TL  # noqa: E402

K_BANDS = 8
WINDOWS = [(4, 0), (9, 3)]          # (budget, budget_lo)


def _meta(chunk, steps, seed, dead_chunk=None):
    """A (6, steps * chunk) meta matrix: one-to-three-tile bboxes, depth
    rising along the array (so the chunks fall into several bands), spans
    0-11 with about half the entries dead; chunk `dead_chunk` all dead."""
    rng = np.random.default_rng(seed)
    n = chunk * steps
    meta = np.zeros((6, n), np.int32)
    meta[0] = rng.integers(0, 60, n)
    meta[1] = meta[0] + rng.integers(0, 3, n)
    meta[2] = rng.integers(0, 40, n)
    meta[3] = meta[2] + rng.integers(0, 3, n)
    meta[4] = np.sort(rng.integers(0, 1 << 20, n))
    meta[5] = rng.integers(1, 12, n) * (rng.random(n) < 0.5)
    if dead_chunk is not None:
        meta[5, dead_chunk * chunk:(dead_chunk + 1) * chunk] = 0
    cuts = np.quantile(-meta[4], np.arange(1, K_BANDS) / K_BANDS).astype(
        np.int32)
    return meta, cuts


def _at_offset(meta, offset):
    """The meta as a contiguous view `offset` words into a fresh buffer (the
    buffer's start is 16-byte aligned, so offsets 1-3 put it off 16 bytes)."""
    buf = torch.zeros(meta.size + offset, dtype=torch.int32)
    assert buf.data_ptr() % 16 == 0
    view = buf[offset:].view(meta.shape)
    view.copy_(torch.from_numpy(meta))
    return view


def _plain(tm, tc, chunk, budget, budget_lo):
    band, rect = TL.step_bands_rects(tm, chunk, tc, budget_lo, budget)
    return band, rect, TL.step_slot_masks(tm, chunk, budget, budget_lo)


def _reference(meta, cuts, chunk, budget, budget_lo):
    rows = tuple(jnp.asarray(meta[i]) for i in range(6))
    out = RT.tail_prepass(rows, jnp.asarray(cuts), chunk, budget,
                          budget_lo=budget_lo, k_bands=K_BANDS,
                          interpret=True)
    return tuple(np.asarray(r) for r in out)


@functools.lru_cache(maxsize=None)
def _case(chunk, budget, budget_lo):
    """Inputs and the reference kernel's (interpret mode) outputs for one
    chunk size and span window."""
    meta, cuts = _meta(chunk, max(4, 2048 // chunk), seed=chunk + budget_lo,
                       dead_chunk=1)
    return meta, cuts, _reference(meta, cuts, chunk, budget, budget_lo)


def _walk(meta, cuts, chunk, budget, budget_lo, offset):
    """prepass_walk of the meta at `offset`, its path checked, and the plain
    version of the same view."""
    tm, tc = _at_offset(meta, offset), torch.from_numpy(cuts)
    got, vec = TL.prepass_walk(tm, tc, chunk, budget, budget_lo)
    assert vec == (offset == 0 and chunk % 4 == 0)
    return got, _plain(tm, tc, chunk, budget, budget_lo)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("chunk", [128, 512, 1024])
@pytest.mark.parametrize("budget,budget_lo", WINDOWS)
def test_prepass_walk_matches_plain_and_reference(offset, chunk, budget,
                                                  budget_lo):
    """K6's walk, on the vector path (offset 0) and the scalar path (a meta
    1-3 words off 16 bytes), gives the band, rect and slot mask of the plain
    versions and of the reference's kernel, an all-dead chunk among them."""
    meta, cuts, ref = _case(chunk, budget, budget_lo)
    got, plain = _walk(meta, cuts, chunk, budget, budget_lo, offset)
    for g, p, r in zip(got, plain, ref):
        assert torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), r)
    band, rect, mask = got
    assert len(set(band.tolist())) > 1 and int(mask.ne(0).sum()) > 0
    # The all-dead chunk: the empty rect, the band of mean 0.
    assert rect[1].tolist() == [0, 0, 1, 1] and int(mask[1]) == 0
    assert int(band[1]) == int((cuts <= 0).sum())


@pytest.mark.parametrize("offset", [0, 2])
@pytest.mark.parametrize("chunk", [50, 100])
@pytest.mark.parametrize("budget,budget_lo", WINDOWS)
def test_prepass_walk_odd_chunks_match_plain(offset, chunk, budget,
                                             budget_lo):
    """Chunks the reference's kernel does not take (not a multiple of 128):
    chunk 100 (Np = 200) on the vector path at offset 0, chunk 50 and every
    meta 2 words off on the scalar path; the walk equals the plain
    versions."""
    meta, cuts = _meta(chunk, 4, seed=chunk + offset, dead_chunk=1)
    got, plain = _walk(meta, cuts, chunk, budget, budget_lo, offset)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    assert got[1][1].tolist() == [0, 0, 1, 1]


@pytest.mark.parametrize("offset", [0, 1])
def test_prepass_walk_one_chunk_of_16384(offset):
    """The shipped chunk: nsub = 32 > 30, so no slot-mask bit can be set
    although live spans exceed every threshold; the rect and band those of
    the plain versions and the reference's kernel."""
    chunk, budget = 16384, 4
    meta, cuts = _meta(chunk, 1, seed=5)
    assert int(meta[5].max()) > budget
    got, plain = _walk(meta, cuts, chunk, budget, 0, offset)
    ref = _reference(meta, cuts, chunk, budget, 0)
    for g, p, r in zip(got, plain, ref):
        assert torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), r)
    assert int(got[2][0]) == 0


@pytest.mark.parametrize("offset", [0, 1])
def test_prepass_walk_reproduces_int32_depth_wrap(offset):
    """C-R8 (tests/test_torch_tail.py::test_tail_prepass_reproduces_int32_
    depth_wrap): one 16384-entry chunk, all live at dbits 250000. The sum
    wraps past 2^31 across the threads' partials, and the walk gives the
    reference's band 7 on both paths."""
    chunk = 16384
    meta = np.zeros((6, chunk), np.int32)
    meta[4] = 250000
    meta[5] = 1
    cuts = np.sort(-np.array([280000, 260000, 240000, 230000, 220000, 210000,
                              200000], np.int32)).astype(np.int32)
    (band, _, _), (want, _, _) = _walk(meta, cuts, chunk, 4, 0, offset)
    assert torch.equal(band, want) and int(band[0]) == 7


SAMPLE_SHAPES = [  # (n, stride_rows, take_rows)
    (128 * 64, 3, 2), (128 * 100, 7, 1), (128 * 97, 9, 8), (1024, 1, 8),
    (128 * 200, 134, 2), (128 * 4096, 64, 1)]


@pytest.mark.parametrize("n,stride,take", SAMPLE_SHAPES)
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_sample_plan_writes_each_word_once(n, stride, take, offset):
    """Every output word is written once, by the thread of its 16-byte
    vector, from the word the plain version takes; a 16-byte aligned base
    takes the vector path, a base 1-3 words off it the scalar path."""
    rng = np.random.default_rng(n + stride + offset)
    buf = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, n + offset,
                                        dtype=np.int32))
    x = buf[offset:]
    plan = L.sample_plan(n, stride, take, offset)
    want = L.sample_blocks_plain(x, stride, take)
    dst = plan["dst"]
    assert torch.equal(torch.sort(dst).values, torch.arange(want.shape[0]))
    out = torch.empty_like(want)
    out[dst] = x[plan["src"]]
    assert torch.equal(out, want)
    assert torch.equal(plan["thread"], dst // 4)
    assert torch.equal(plan["block"], plan["thread"] // L.SAMPLE_THREADS)
    path = L.SAMPLE_VECTOR if offset == 0 else L.SAMPLE_SCALAR
    assert (plan["path"] == path).all()
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    if offset == 0:
        # A vector's four source words start on a 16-byte boundary.
        assert (plan["src"][::4] % 4 == 0).all()


def test_sample_plan_prune_site_is_one_wave():
    """The prune sample of the 10M converged frame (40,042,496 keys, stride
    134 rows, take 2): 2,335 sample blocks, 149,440 threads in 584 blocks
    of 256, fewer than the 1,056 the card holds at once (132 SMs x 8)."""
    n, stride, take = 40_042_496, 134, 2
    plan = L.sample_plan(n, stride, take)
    assert L.num_sample_blocks(n, stride) == 2335
    assert int(plan["thread"].max()) + 1 == 149_440
    assert int(plan["block"].max()) + 1 == 584 <= 132 * 8


def test_sample_blocks_at_an_offset_matches_reference():
    """sample_blocks of a view 3 words into its buffer (the scalar path's
    shape) against the reference's kernel in interpret mode."""
    rng = np.random.default_rng(3)
    n, stride, take = 128 * 40, 5, 3
    buf = rng.integers(-2 ** 31, 2 ** 31 - 1, n + 3, dtype=np.int32)
    want, = RL.sample_blocks([jnp.asarray(buf[3:])], stride_rows=stride,
                             take_rows=take, interpret=True)
    got, = L.sample_blocks([torch.from_numpy(buf)[3:]], stride, take)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prepass_split_variant_flags_name_switches():
    """Every -D variant of the split tool (fourdgs_torch/tools/
    prepass_split.py) names a switch of the earlier form's source, so no
    variant builds the unchanged kernel under another name."""
    from fourdgs_torch.tools import prepass_split as PS
    for source, variants in ((PS.BLOCK_CHUNK_SOURCE, PS.K6_VARIANTS),
                             (PS.WORD_SOURCE, PS.K3_VARIANTS)):
        text = open(source).read()
        for flags in variants.values():
            for flag in flags:
                name = flag[2:].split("=")[0]
                assert f"#ifdef {name}" in text or f"#ifndef {name}" in text
