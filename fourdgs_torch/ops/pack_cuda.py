"""Operand packing for the converged frame (port of fourdgs/ops/pack_pallas.py:
`pack_record_fields` and, fused with the span of `tail_meta`, `pack_rows`).

Kernels K4 and K5 (`csrc/pack.cu`) plus their plain PyTorch versions. A CPU
tensor runs the plain version; a CUDA tensor launches the kernel. The record
pack is differentiable; its backward is plain PyTorch, as the reference's is
plain XLA. The meta pack holds integers and has none.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
from torch.profiler import record_function

from fourdgs_torch.ops._build import CudaKernel

N_META = 6       # tx0, tx1, ty0, ty1, dbits, span
N_RECORD = 10    # sx, sy, v0x, v0y, il0, il1, r, g, b, a_eff
_FLAGS = ("-fmad=false",)

PACK_RECORD_FIELDS = CudaKernel(
    "pack.cu", "fourdgs_pack_record_fields",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2, extra_flags=_FLAGS)
PACK_META_ROWS = CudaKernel(
    "pack.cu", "fourdgs_pack_meta_rows",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2, extra_flags=_FLAGS)


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
