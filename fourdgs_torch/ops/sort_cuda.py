"""Strided-row sort + keep with the fused prune cut (port of
fourdgs/ops/sort_pallas.py `rowsort_compact`, ascending rows only).

Kernel K2 (`csrc/rowsort.cu`) plus its plain PyTorch version. A CPU tensor
runs the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fourdgs_torch.ops._build import CudaKernel

DEAD = 2 ** 31 - 1          # key of an empty (or pruned) pair slot
CUT_TABLE = 2048            # cut-table entries (11-bit tile ids)
# Logical rows are padded to a multiple of this, as in the reference, so
# both sides hold the same slots in every row.
ROWSORT_COLS = 256

ROWSORT = CudaKernel(
    "rowsort.cu", "fourdgs_rowsort_compact",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


def rowsort_rows(s: int, row_len: int) -> int:
    rows = -(-s // row_len)
    return -(-rows // ROWSORT_COLS) * ROWSORT_COLS


def rowsort_compact_plain(key, val, keep_cols: int, row_len: int,
                          cut: Optional[torch.Tensor], key_shift: int):
    """Returns ((keep, rows) key, (keep, rows) val, (rows,) live)."""
    s = key.shape[0]
    rows = rowsort_rows(s, row_len)
    pad = rows * row_len - s
    if pad:
        key = torch.cat([key, key.new_full((pad,), DEAD)])
        val = torch.cat([val, val.new_zeros((pad,))])
    k2 = key.reshape(row_len, rows)
    v2 = val.reshape(row_len, rows)
    if cut is not None:
        tbl = torch.cat([cut.to(torch.int32),
                         cut.new_full((CUT_TABLE - cut.shape[0],), DEAD,
                                      dtype=torch.int32)])
        tid = torch.clamp(k2 >> key_shift, 0, CUT_TABLE - 1)
        k2 = torch.where(k2 > tbl[tid.long()], DEAD, k2)
    live = (k2 != DEAD).sum(0, dtype=torch.int32)
    ks, order = torch.sort(k2, dim=0)
    vs = torch.gather(v2, 0, order)
    return (ks[:keep_cols].contiguous(), vs[:keep_cols].contiguous(), live)


def rowsort_compact(key: torch.Tensor, val: torch.Tensor, keep_cols: int,
                    row_len: int = 8192, cut: Optional[torch.Tensor] = None,
                    key_shift: int = 20):
    """Sort the rows = ceil(S / row_len) (rounded up to a multiple of 256)
    strided logical rows of the flat (S,) key/value arrays (row r holds
    key[r::rows]) and keep each row's first keep_cols. Returns ((keep, rows)
    key, (keep, rows) val, dropped) — the TRANSPOSED layout, logical rows on
    the minor axis.

    cut: optional (T <= 2048,) int32 per-tile prune cut keys, applied before
    sorting (key > cut[key >> key_shift] -> DEAD); `dropped` counts the live
    slots (after the cut) lost to the keep cap.
    """
    if row_len & (row_len - 1) or not 1 <= keep_cols <= row_len:
        raise ValueError(f"row_len must be a power of two >= keep_cols "
                         f"(row_len {row_len}, keep {keep_cols})")
    if key.dtype != torch.int32 or val.dtype != torch.int32 \
            or key.shape != val.shape or key.dim() != 1:
        raise ValueError("key and val must be (S,) int32")
    if cut is not None and (cut.dim() != 1 or cut.shape[0] > CUT_TABLE
                            or cut.device != key.device):
        raise ValueError(f"cut must be (T <= {CUT_TABLE},) on the keys' "
                         f"device, got {tuple(cut.shape)} on {cut.device}")
    if val.device != key.device:
        raise ValueError("key and val must share a device")
    if key.device.type == "cpu":
        ok, ov, live = rowsort_compact_plain(key, val, keep_cols, row_len,
                                             cut, key_shift)
    elif key.device.type == "cuda":
        s = key.shape[0]
        rows = rowsort_rows(s, row_len)
        key, val = key.contiguous(), val.contiguous()
        ok = torch.empty((keep_cols, rows), dtype=torch.int32,
                         device=key.device)
        ov = torch.empty_like(ok)
        live = torch.empty(rows, dtype=torch.int32, device=key.device)
        cut_c = None if cut is None else cut.to(torch.int32).contiguous()
        ROWSORT(key, val, s, rows, row_len, keep_cols,
                cut_c,
                0 if cut_c is None else cut_c.shape[0], key_shift,
                ok, ov, live,
                stream=torch.cuda.current_stream(key.device).cuda_stream)
    else:
        raise ValueError(f"unsupported device {key.device}")
    dropped = live.sum(dtype=torch.int32) - (ok != DEAD).sum(
        dtype=torch.int32)
    return ok, ov, dropped
