"""The row copy that K5's general form (`pack_rows`) and K14 (`unpack_rows`)
share (fourdgs_torch/ops/csrc/row_copy.cuh), written out in plain PyTorch as
`pack_cuda.row_copy_plan` / `pack_rows_walk` / `unpack_rows_walk`: which span
(block) and thread write each word, which words take the 16-byte vector
path, the word-by-word edge of a vector path, or the scalar path of a row
that is not 16-byte aligned. No compiler runs here: these tests hold the
partition (every word written once, from the right source word, the padded
columns zero), at R = 1, 3, 10 and 16, n = 0, n % 4 != 0 and n = pad_to,
pad_to % 4 != 0 and pad_to % 1024 == 0, rows that are views at a storage
offset of 1-3 words, int32 and float32; the kernels' own bits are held
against their plain versions and their earlier form on the card by
chip_smoke.py (q). Then `pack_rows` / `unpack_rows` against the reference's
kernel in interpret mode at a shape tests/test_torch_ops.py does not cover,
and against `torch.stack` where the reference refuses the shape.

Rows are made with numpy from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_torch.ops import pack_cuda as TPK

SPAN = 4 * TPK.COPY_VEC * TPK.COPY_THREADS      # words a block's span


def _words(rng, dtype, size):
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, size,
                                             dtype=np.int32))
    return torch.from_numpy(rng.standard_normal(size).astype(np.float32))


def _rows_at(rng, r, n, offset, dtype):
    """R (n,) rows, each a view at `offset` words into a 64-byte aligned
    buffer of its own."""
    rows = []
    for _ in range(r):
        buf = torch.empty(n + offset, dtype=dtype)
        assert buf.data_ptr() % 64 == 0
        buf.copy_(_words(rng, dtype, n + offset))
        rows.append(buf[offset:])
    return rows


@pytest.mark.parametrize("valid,length", [
    (0, 1024), (0, 5), (3, 3), (1, 4096), (4095, 4096), (4097, 8192),
    (5001, 5003), (8192, 8192), (2 * SPAN + 7, 3 * SPAN + 2),
    (3 * SPAN, 3 * SPAN)])
@pytest.mark.parametrize("aligned", [True, False])
def test_row_copy_plan_writes_each_word_once(valid, length, aligned):
    """Every word of [0, length) is written once, by the block of its span;
    read from the same word below `valid`, else written 0. An aligned row
    moves whole vectors, word by word only in the vector that holds word
    `valid` or `length`; a row that is not aligned moves every word by
    itself, a warp's 32 threads on 32 consecutive words."""
    plan = TPK.row_copy_plan(valid, length, aligned)
    dst = plan["dst"]
    assert torch.equal(torch.sort(dst).values, torch.arange(length))
    assert torch.equal(plan["src"], torch.where(dst < valid, dst, -1))
    assert torch.equal(plan["span"], dst // SPAN)
    assert ((plan["thread"] >= 0) & (plan["thread"] < TPK.COPY_THREADS)).all()
    first = dst - dst % 4
    if aligned:
        assert (plan["path"] != TPK.SCALAR).all()
        edge = ((first < valid) & (valid < first + 4)) | (first + 4 > length)
        assert torch.equal(plan["path"] == TPK.VECTOR_EDGE, edge)
        # A vector's four words belong to one thread: 4 v T + 4 t + word.
        assert torch.equal(plan["thread"],
                           (dst % SPAN) // 4 % TPK.COPY_THREADS)
    else:
        assert (plan["path"] == TPK.SCALAR).all()
        assert torch.equal(plan["thread"], dst % TPK.COPY_THREADS)


@pytest.mark.parametrize("threads,vec", [(32, 1), (8, 2), (64, 8)])
def test_row_copy_plan_other_launches(threads, vec):
    """The same partition under other block sizes and vectors a thread
    (the trial forms of tools/csrc/pack_rows_trials.cu): still one write a
    word."""
    for valid, length in ((0, 37), (37, 37), (100, 131), (512, 515)):
        for aligned in (True, False):
            plan = TPK.row_copy_plan(valid, length, aligned, threads, vec)
            assert torch.equal(torch.sort(plan["dst"]).values,
                               torch.arange(length))
            assert (plan["thread"] < threads).all()
            assert torch.equal(plan["span"], plan["dst"] // (4 * vec
                                                             * threads))


PACK_SHAPES = [  # (R, n, pad_to)
    (1, 0, 1024), (3, 4097, 8192), (10, 5000, 5003), (16, 2051, 2051),
    (10, 6001, 6146), (1, SPAN + 3, 2 * SPAN), (3, 1024, 1024),
    (16, 0, 7)]


@pytest.mark.parametrize("r,n,pad_to", PACK_SHAPES)
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_pack_rows_walk(r, n, pad_to, offset, dtype):
    """K5's general form, block by block: the stacked rows, every word
    written once, the columns past n zero; rows that start off 16 bytes
    (a view's offset, or f * pad_to with pad_to % 4 != 0) take the scalar
    path, the others the vector path."""
    rng = np.random.default_rng(r * 1000 + n + offset)
    rows = _rows_at(rng, r, n, offset, dtype)
    out, writes = TPK.pack_rows_walk(rows, pad_to)
    assert (writes == 1).all()
    assert torch.equal(out, TPK.pack_rows_plain(rows, pad_to))
    assert (out[:, n:] == 0).all()
    want = torch.zeros((r, pad_to), dtype=dtype)
    want[:, :n] = torch.stack(rows)
    assert torch.equal(out, want)
    for f, row in enumerate(out if n else ()):    # an empty view: no base
        aligned = (rows[f].data_ptr() | row.data_ptr()) % 16 == 0
        assert aligned == (offset % 4 == 0 and f * pad_to % 4 == 0)


UNPACK_SHAPES = [  # (R, n, pad_to)
    (1, 0, 1024), (3, 4097, 8192), (10, 5000, 5003), (16, 2051, 2051),
    (1, SPAN + 3, 2 * SPAN + 1), (3, 1024, 1024)]


@pytest.mark.parametrize("r,n,pad_to", UNPACK_SHAPES)
@pytest.mark.parametrize("offset", [0, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_unpack_rows_walk(r, n, pad_to, offset, dtype):
    """K14, block by block: each row's first n words of the (R, pad_to)
    cotangent (a view at `offset` words), every word written once."""
    rng = np.random.default_rng(r * 1000 + n + offset + 7)
    flat = _rows_at(rng, 1, r * pad_to, offset, dtype)[0]
    d_out = flat.view(r, pad_to)
    outs, writes = TPK.unpack_rows_walk(d_out, n)
    assert (writes == 1).all()
    for f, (got, want) in enumerate(zip(outs,
                                        TPK.unpack_rows_plain(d_out, n))):
        assert torch.equal(got, want)
        assert torch.equal(got, d_out[f, :n])


def _pack_views(rows, pad_to):
    return tuple(jnp.pad(jnp.asarray(f), (0, pad_to - f.shape[0]))
                 .reshape(pad_to // 128, 128) for f in rows)


def test_pack_rows_matches_reference_kernel():
    """pack_rows and its backward against the reference's kernel and its
    custom VJP (interpret mode) at one R, n and pad_to % 1024 == 0 that
    tests/test_torch_ops.py does not take: R = 1, n % 4 = 1, three blocks
    of 2,048."""
    from fourdgs.ops import pack_pallas as RP
    r, n, pad_to = 1, 5117, 6144
    rng = np.random.default_rng(11)
    rows = [rng.standard_normal(n).astype(np.float32) for _ in range(r)]
    cot = rng.standard_normal((r, pad_to)).astype(np.float32)
    blk = RP._blk_for(pad_to)
    want = RP._pack_core(_pack_views(rows, pad_to), blk, True)
    trows = [torch.from_numpy(f).requires_grad_(True) for f in rows]
    got = TPK.pack_rows(trows, pad_to)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    walked, _ = TPK.pack_rows_walk([t.detach() for t in trows], pad_to)
    np.testing.assert_array_equal(walked.numpy(), np.asarray(want))

    def loss(views):
        return jnp.sum(RP._pack_core(views, blk, True) * jnp.asarray(cot))
    want_g = jax.grad(loss)(_pack_views(rows, pad_to))
    (got * torch.from_numpy(cot)).sum().backward()
    walked_g, _ = TPK.unpack_rows_walk(torch.from_numpy(cot), n)
    for f, g, w in zip(trows, want_g, walked_g):
        want_row = np.asarray(g).reshape(-1)[:n]
        np.testing.assert_array_equal(f.grad.numpy(), want_row)
        np.testing.assert_array_equal(w.numpy(), want_row)


@pytest.mark.parametrize("r,n,pad_to,offset,dtype", [
    (16, 1001, 1003, 1, torch.int32), (1, 7, 9, 2, torch.float32),
    (10, 4096, 4100, 3, torch.float32), (3, 0, 6, 0, torch.int32)])
def test_pack_rows_refused_shapes_against_stack(r, n, pad_to, offset, dtype):
    """Where the reference refuses pad_to (not a multiple of 1,024),
    pack_rows is torch.stack of the rows with zero columns after them, and
    unpack_rows returns the cotangent's rows, on views at an offset."""
    from fourdgs.ops import pack_pallas as RP
    rng = np.random.default_rng(r + n + pad_to)
    rows = _rows_at(rng, r, n, offset, dtype)
    with pytest.raises(AssertionError):
        RP.pack_rows([jnp.asarray(x.numpy()) for x in rows], pad_to)
    got = TPK.pack_rows(rows, pad_to)
    want = torch.zeros((r, pad_to), dtype=dtype)
    want[:, :n] = torch.stack(rows)
    assert torch.equal(got, want)
    cot = _rows_at(rng, 1, r * pad_to, offset, dtype)[0].view(r, pad_to)
    for f, g in enumerate(TPK.unpack_rows(cot, n)):
        assert torch.equal(g, cot[f, :n]) and g.is_contiguous()


def test_pack_split_forms_match_their_sources():
    """The instrument's forms (fourdgs_torch/tools/pack_split.py) name what
    its sources build: every -D variant is a switch of the earlier form's
    source, every trial a case of the trial source, and the port's launch
    (COPY_THREADS, COPY_VEC) the one pack.cu instantiates. Needs no card."""
    import re

    from fourdgs_torch.ops._build import CSRC
    from fourdgs_torch.tools import pack_split as PS
    opts = PS.parse_args([])
    assert opts.passes == PS.PASSES and opts.json is None
    scalar = open(PS.SCALAR_SOURCE).read()
    for flags in (*PS.PACK_VARIANTS.values(), *PS.UNPACK_VARIANTS.values()):
        for flag in flags:
            assert f"#ifdef {flag[2:]}" in scalar
    trials = open(PS.TRIAL_SOURCE).read()
    cases = {int(c) for c in re.findall(r"case (\d+):", trials)}
    assert cases == set(PS.TRIALS)
    pack = open(CSRC / "pack.cu").read()
    assert f"kCopyThreads = {TPK.COPY_THREADS};" in pack
    assert f"kCopyVec = {TPK.COPY_VEC};" in pack
