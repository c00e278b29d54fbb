"""Operand packing (port of fourdgs/ops/pack_pallas.py): `pack_record_fields`,
`pack_rows` fused with the span of `tail_meta` (`pack_meta_rows`), and the
public, differentiable `pack_rows`.

Kernels K4, K5 (its meta form and its general form) and K14
(`csrc/pack.cu`) plus their plain PyTorch versions. A CPU tensor runs the
plain version; a CUDA tensor launches the kernel. The record pack is
differentiable; its backward is plain PyTorch, as the reference's is plain
XLA. The meta pack holds integers and has none. `pack_rows` is
differentiable for float rows; its backward is K14. K5's general form and
K14 share one row copy (`csrc/row_copy.cuh`), written out for the CPU tests
by `row_copy_plan`, `pack_rows_walk` and `unpack_rows_walk`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
from torch.profiler import record_function

from fourdgs_torch.ops._build import CudaKernel

N_META = 6       # tx0, tx1, ty0, ty1, dbits, span
N_RECORD = 10    # sx, sy, v0x, v0y, il0, il1, r, g, b, a_eff
MAX_ROWS = 16    # rows one pack_rows call stacks
# The row copy of K5's general form and K14 (csrc/pack.cu, row_copy.cuh):
# threads a block, 16-byte vectors a thread a span; how a word is moved.
COPY_THREADS, COPY_VEC = 256, 2
VECTOR, VECTOR_EDGE, SCALAR = 0, 1, 2
_FLAGS = ("-fmad=false",)

PACK_RECORD_FIELDS = CudaKernel(
    "pack.cu", "fourdgs_pack_record_fields",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2, extra_flags=_FLAGS)
PACK_META_ROWS = CudaKernel(
    "pack.cu", "fourdgs_pack_meta_rows",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2, extra_flags=_FLAGS)
PACK_ROWS = CudaKernel(
    "pack.cu", "fourdgs_pack_rows",
    [ctypes.c_void_p] * MAX_ROWS + [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int],
    extra_flags=_FLAGS)
UNPACK_ROWS = CudaKernel(
    "pack.cu", "fourdgs_unpack_rows",
    [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * MAX_ROWS,
    extra_flags=_FLAGS)


def _check_rows(rows: Sequence[torch.Tensor], dtypes, pad_to: int):
    n = rows[0].shape[0]
    if pad_to < n:
        raise ValueError(f"pad_to={pad_to} is below the length {n}")
    for r in rows:
        if r.shape != (n,) or r.dtype not in dtypes \
                or r.dtype != rows[0].dtype:
            raise ValueError(f"want ({n},) rows of one dtype in {dtypes}, "
                             f"got {tuple(r.shape)} {r.dtype}")
        if r.device != rows[0].device:
            raise ValueError("all rows must share a device")
    dev = rows[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return n, dev


def _inv_p(p00, p11, like: torch.Tensor) -> torch.Tensor:
    """[1/p00, 1/p11] in float32 on the rows' device (the reference builds
    the same reciprocals in the rows' dtype)."""
    p = torch.stack([torch.as_tensor(p00), torch.as_tensor(p11)]).to(
        device=like.device, dtype=like.dtype)
    return 1.0 / p


def pack_record_fields_plain(rows: Sequence[torch.Tensor], inv_p: torch.Tensor,
                             pad_to: int) -> torch.Tensor:
    mx, my, v0x, v0y, l0, l1, r, g, b, a_eff = rows
    n = mx.shape[0]

    def recip(l):
        return torch.where(l != 0.0, 1.0 / l, 0.0)
    out = mx.new_zeros((N_RECORD, pad_to))
    out[:, :n] = torch.stack([mx * inv_p[0], my * inv_p[1], v0x, v0y,
                              recip(l0), recip(l1), r, g, b, a_eff])
    return out


def pack_record_fields_bwd(d_out: torch.Tensor, l0: torch.Tensor,
                           l1: torch.Tensor, inv_p: torch.Tensor):
    """The reference's `_pack_rec_core_bwd` (plain XLA there, plain PyTorch
    here): the (10, pad_to) cotangent -> the 10 (N,) row cotangents. Rows 0
    and 1 scale by 1/p00 and 1/p11, the il rows become -d il^2 (il = 0
    where l == 0), the others pass through. p00 and p11 are camera
    constants and get none."""
    n = l0.shape[0]
    d = d_out[:, :n]

    def recip(l):
        return torch.where(l != 0.0, 1.0 / l, 0.0)
    il0, il1 = recip(l0), recip(l1)
    return (d[0] * inv_p[0], d[1] * inv_p[1], d[2], d[3], -d[4] * il0 * il0,
            -d[5] * il1 * il1, d[6], d[7], d[8], d[9])


class _PackRecordFields(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inv_p, pad_to, *rows):
        n = rows[0].shape[0]
        if rows[0].device.type == "cpu":
            out = pack_record_fields_plain(rows, inv_p, pad_to)
        else:
            rows = [x.contiguous() for x in rows]
            out = torch.empty((N_RECORD, pad_to), dtype=torch.float32,
                              device=rows[0].device)
            PACK_RECORD_FIELDS(*rows,
                               inv_p, out, n, pad_to,
                               stream=torch.cuda.current_stream(
                                   rows[0].device).cuda_stream)
        ctx.save_for_backward(inv_p, rows[4], rows[5])
        return out

    @staticmethod
    def backward(ctx, d_out):
        with record_function("fourdgs::pack_bwd"):
            inv_p, l0, l1 = ctx.saved_tensors
            return (None, None) + pack_record_fields_bwd(d_out, l0, l1, inv_p)


def pack_record_fields(mx, my, v0x, v0y, l0, l1, r, g, b, a_eff, p00, p11,
                       pad_to: int) -> torch.Tensor:
    """(10, pad_to) float32 record matrix [mx/p00, my/p11, v0x, v0y, 1/l0,
    1/l1, r, g, b, a_eff] from the projected components, the centers scaled
    by multiplying with 1/p00 and 1/p11; l == 0 maps to il == 0, and the
    columns past N are zero. Differentiable in the ten rows (an autograd
    Function with the reference's VJP, pack_record_fields_bwd); float64
    rows are taken on the CPU only."""
    rows = (mx, my, v0x, v0y, l0, l1, r, g, b, a_eff)
    dtypes = (torch.float32,) if mx.device.type == "cuda" else (
        torch.float32, torch.float64)
    _check_rows(rows, dtypes, pad_to)
    inv_p = _inv_p(p00, p11, mx).detach()
    return _PackRecordFields.apply(inv_p, pad_to, *rows)


def pack_meta_rows_plain(alive, tx0, tx1, ty0, ty1, dbits,
                         pad_to: int) -> torch.Tensor:
    n = tx0.shape[0]
    span = torch.where(alive, (tx1 - tx0 + 1) * (ty1 - ty0 + 1), 0)
    out = tx0.new_zeros((N_META, pad_to))
    out[:, :n] = torch.stack([tx0, tx1, ty0, ty1, dbits, span])
    return out


def pack_meta_rows(alive, tx0, tx1, ty0, ty1, dbits,
                   pad_to: int) -> torch.Tensor:
    """(6, pad_to) int32 tail meta matrix [tx0, tx1, ty0, ty1, dbits, span]
    with span = (tx1 - tx0 + 1) * (ty1 - ty0 + 1) for live splats and 0 for
    dead ones; the columns past N are zero (dead)."""
    rows = (tx0, tx1, ty0, ty1, dbits)
    n, dev = _check_rows(rows, (torch.int32,), pad_to)
    if alive.shape != (n,) or alive.dtype != torch.bool \
            or alive.device != dev:
        raise ValueError("alive must be an (N,) bool tensor on the rows' "
                         "device")
    if dev.type == "cpu":
        return pack_meta_rows_plain(alive, *rows, pad_to)
    alive = alive.contiguous()
    rows = [x.contiguous() for x in rows]
    out = torch.empty((N_META, pad_to), dtype=torch.int32, device=dev)
    PACK_META_ROWS(alive, *rows,
                   out, n, pad_to,
                   stream=torch.cuda.current_stream(dev).cuda_stream)
    return out


def pack_rows_plain(rows: Sequence[torch.Tensor], pad_to: int) -> torch.Tensor:
    n = rows[0].shape[0]
    out = rows[0].new_zeros((len(rows), pad_to))
    out[:, :n] = torch.stack(list(rows))
    return out


def unpack_rows_plain(d_out: torch.Tensor, n: int):
    """The VJP of pack_rows: row i of the cotangent, first n entries."""
    return tuple(d_out[:, :n].unbind(0))


def row_copy_plan(valid: int, length: int, aligned: bool,
                  threads: int = COPY_THREADS, vec: int = COPY_VEC):
    """The partition of one row by the row copy of K5's general form and
    K14 (`csrc/row_copy.cuh`), written out in plain PyTorch: every word the
    row's blocks write, with the block (its span, blockIdx.x) and thread
    that write it, the word it is read from (-1: the kernel writes 0) and
    how: VECTOR (16-byte load and store), VECTOR_EDGE (the vector that holds
    word `valid` or `length`: word loads, or word stores, or both) or SCALAR
    (a row whose bases are not both 16-byte aligned). A dict of (words,)
    int64 tensors, in the kernel's order (span, slot, thread, word)."""
    span_words = 4 * vec * threads
    spans = -(-length // span_words)
    s = torch.arange(spans)[:, None, None, None]
    t = torch.arange(threads)[None, None, :, None]
    if aligned:
        v = torch.arange(vec)[None, :, None, None]
        first = s * span_words + 4 * (v * threads + t)   # a vector's word 0
        dst = first + torch.arange(4)
        full = (first + 4 <= length) & ((first + 4 <= valid)
                                        | (first >= valid))
        path = torch.where(full, VECTOR, VECTOR_EDGE).expand(dst.shape)
    else:
        i = torch.arange(4 * vec)[None, :, None, None]
        dst = s * span_words + i * threads + t
        path = torch.full(dst.shape, SCALAR)
    shape = dst.shape
    written = dst < length
    plan = dict(dst=dst, src=torch.where(dst < valid, dst, -1),
                span=s.expand(shape), thread=t.expand(shape), path=path)
    return {k: x[written] for k, x in plan.items()}


def _row_copy_walk(src_rows, dst_rows, valid: int, length: int,
                   threads: int, vec: int):
    """Run the row copy's partition (row_copy_plan) on R (src, dst) 1-D
    tensor pairs, each row aligned or not as the kernel finds its two
    bases; returns how many times each dst word was written."""
    counts = []
    for src, dst in zip(src_rows, dst_rows):
        aligned = (src.data_ptr() | dst.data_ptr()) % 16 == 0
        plan = row_copy_plan(valid, length, aligned, threads, vec)
        read = plan["src"]
        word = torch.zeros(read.shape, dtype=dst.dtype)
        word[read >= 0] = src[read[read >= 0]]
        dst[plan["dst"]] = word
        counts.append(torch.bincount(plan["dst"], minlength=length))
    return torch.stack(counts)


def pack_rows_walk(rows: Sequence[torch.Tensor], pad_to: int,
                   threads: int = COPY_THREADS, vec: int = COPY_VEC):
    """K5's general form as its blocks run it (row_copy_plan), in plain
    PyTorch: the (R, pad_to) matrix and the number of writes of each of its
    words. Row f is written at word f * pad_to of the matrix."""
    n = rows[0].shape[0]
    out = torch.full((len(rows), pad_to), -1, dtype=rows[0].dtype)
    writes = _row_copy_walk(rows, list(out), n, pad_to, threads, vec)
    return out, writes


def unpack_rows_walk(d_out: torch.Tensor, n: int,
                     threads: int = COPY_THREADS, vec: int = COPY_VEC):
    """K14 as its blocks run it (row_copy_plan), in plain PyTorch: the R
    (n,) row cotangents and the number of writes of each of their words."""
    outs = [torch.full((n,), -1, dtype=d_out.dtype)
            for _ in range(d_out.shape[0])]
    writes = _row_copy_walk(list(d_out), outs, n, n, threads, vec)
    return tuple(outs), writes


def unpack_rows(d_out: torch.Tensor, n: int):
    """K14: the (R, pad_to) cotangent of pack_rows -> the R (n,) row
    cotangents, as new contiguous tensors."""
    if d_out.dim() != 2 or not 1 <= d_out.shape[0] <= MAX_ROWS \
            or not 0 <= n <= d_out.shape[1]:
        raise ValueError(f"want an (R <= {MAX_ROWS}, pad_to >= {n}) "
                         f"cotangent, got {tuple(d_out.shape)}")
    if d_out.device.type == "cpu":
        return tuple(x.clone() for x in unpack_rows_plain(d_out, n))
    if d_out.device.type != "cuda":
        raise ValueError(f"unsupported device {d_out.device}")
    if d_out.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"the kernel copies 4-byte words, got {d_out.dtype}")
    d_out = d_out.contiguous()
    r, pad_to = d_out.shape
    outs = [torch.empty(n, dtype=d_out.dtype, device=d_out.device)
            for _ in range(r)]
    UNPACK_ROWS(d_out, r, n, pad_to, *outs, *([None] * (MAX_ROWS - r)),
                stream=torch.cuda.current_stream(d_out.device).cuda_stream)
    return tuple(outs)


class _PackRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pad_to, *rows):
        ctx.n = rows[0].shape[0]
        if rows[0].device.type == "cpu":
            return pack_rows_plain(rows, pad_to)
        rows = [x.contiguous() for x in rows]
        out = torch.empty((len(rows), pad_to), dtype=rows[0].dtype,
                          device=rows[0].device)
        PACK_ROWS(*rows, *([None] * (MAX_ROWS - len(rows))), len(rows), out,
                  ctx.n, pad_to,
                  stream=torch.cuda.current_stream(
                      rows[0].device).cuda_stream)
        return out

    @staticmethod
    def backward(ctx, d_out):
        with record_function("fourdgs::pack_bwd"):
            return (None,) + unpack_rows(d_out, ctx.n)


def pack_rows(rows: Sequence[torch.Tensor], pad_to: int) -> torch.Tensor:
    """Stack R <= 16 same-dtype (N,) float32 or int32 rows into an (R,
    pad_to) matrix, the columns past N zero. Differentiable in float rows
    (an autograd Function whose backward is K14, unpack_rows); float64 rows
    are taken on the CPU only."""
    rows = tuple(rows)
    if not 1 <= len(rows) <= MAX_ROWS:
        raise ValueError(f"want 1 to {MAX_ROWS} rows, got {len(rows)}")
    dtypes = (torch.float32, torch.int32)
    if rows[0].device.type == "cpu":
        dtypes += (torch.float64,)
    _check_rows(rows, dtypes, pad_to)
    return _PackRows.apply(pad_to, *rows)
