"""The pair-sort kernels (port of fourdgs/ops/sort_pallas.py): the
strided-row sort + keep with the fused prune cut (`rowsort_compact`,
ascending rows only) and the bitonic merge of sorted rows into one sorted
array (`merge_sorted_rows`).

Kernel K2 (`csrc/rowsort.cu`) and kernels K11-K13 (`csrc/merge.cu`), each
with its plain PyTorch version. A CPU tensor runs the plain versions; a CUDA
tensor launches the kernels.
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
# merge_sorted_rows pads its rows to the reference's length: runs of
# max(8, TREE_MAX // C) rows, their number rounded up to a power of two.
TREE_MAX = 1 << 18
_MIN_ROWS = 8
# Pairs a block of K11 / K13 keeps in shared memory (128 KB of key + value).
MERGE_BLOCK = 1 << 14

ROWSORT = CudaKernel(
    "rowsort.cu", "fourdgs_rowsort_compact",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
MERGE_TREE = CudaKernel(
    "merge.cu", "fourdgs_merge_tree",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int])
MERGE_CROSS_STAGE = CudaKernel(
    "merge.cu", "fourdgs_merge_cross_stage",
    [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3)
MERGE_FINISH = CudaKernel(
    "merge.cu", "fourdgs_merge_finish",
    [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_longlong])


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


# ---------------------------------------------------------------------------
# The bitonic merge of sorted rows (K11, K12, K13)
# ---------------------------------------------------------------------------

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _is_pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def _check_kv(key: torch.Tensor, val: torch.Tensor) -> str:
    """Flat int32 key / value arrays of one power-of-two length on one
    device -> "cpu" or "cuda"."""
    if key.dtype != torch.int32 or val.dtype != torch.int32 \
            or key.dim() != 1 or key.shape != val.shape \
            or not _is_pow2(key.shape[0]):
        raise ValueError(f"key and val must be (N,) int32 with N a power of "
                         f"two, got {tuple(key.shape)} {key.dtype} and "
                         f"{tuple(val.shape)} {val.dtype}")
    if val.device != key.device:
        raise ValueError("key and val must share a device")
    if key.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {key.device}")
    return key.device.type


def _sort_runs(key, val, run: int, alternate: bool):
    """Sort every run of `run` elements ascending by key, carrying val; with
    `alternate`, odd runs then reversed (descending)."""
    ks, order = torch.sort(key.reshape(-1, run), dim=1)
    vs = torch.gather(val.reshape(-1, run), 1, order)
    if alternate and ks.shape[0] > 1:
        ks = torch.stack([ks[0::2], ks[1::2].flip(1)], dim=1)
        vs = torch.stack([vs[0::2], vs[1::2].flip(1)], dim=1)
    return ks.reshape(-1), vs.reshape(-1)


def merge_tree_plain(key, val, c: int, block: int, rows_alternating: bool):
    """K11's plain version: what the merge levels from runs of c to runs of
    block leave is every block sorted, odd blocks descending (unless the
    block is the whole array); equal keys may carry other values."""
    del c, rows_alternating     # a full sort does not read the rows' order
    return _sort_runs(key, val, block, alternate=block < key.shape[0])


def merge_cross_stage_plain(key, val, d: int, run_out: int):
    """K12's plain version: compare-exchange (i, i + d) in the direction of
    the run of run_out elements that holds i."""
    n = key.shape[0]
    k3, v3 = key.reshape(-1, 2, d), val.reshape(-1, 2, d)
    lo_k, hi_k = k3[:, 0], k3[:, 1]
    first = torch.arange(k3.shape[0], device=key.device) * (2 * d)
    desc = ((first // run_out) % 2 == 1) & (run_out < n)
    swap = torch.where(desc[:, None], lo_k < hi_k, hi_k < lo_k)
    out_k = torch.stack([torch.where(swap, hi_k, lo_k),
                         torch.where(swap, lo_k, hi_k)], dim=1)
    out_v = torch.stack([torch.where(swap, v3[:, 1], v3[:, 0]),
                         torch.where(swap, v3[:, 0], v3[:, 1])], dim=1)
    return out_k.reshape(-1), out_v.reshape(-1)


def merge_finish_plain(key, val, block: int, run_out: int):
    """K13's plain version: on its bitonic input, the stages block/2 ... 1
    sort every block in the direction of its run of run_out elements."""
    n = key.shape[0]
    ks, order = torch.sort(key.reshape(-1, block), dim=1)
    vs = torch.gather(val.reshape(-1, block), 1, order)
    first = torch.arange(ks.shape[0], device=key.device) * block
    desc = (((first // run_out) % 2 == 1) & (run_out < n))[:, None]
    ks = torch.where(desc, ks.flip(1), ks)
    vs = torch.where(desc, vs.flip(1), vs)
    return ks.reshape(-1), vs.reshape(-1)


def merge_tree(key, val, c: int, block: int = MERGE_BLOCK,
               rows_alternating: bool = False):
    """K11: merge the sorted rows of c elements of the flat (N,) arrays up
    to sorted runs of `block` elements (odd runs descending unless block ==
    N). Rows are ascending, or odd rows descending with rows_alternating.
    Returns new (key, val)."""
    dev = _check_kv(key, val)
    n = key.shape[0]
    if not (_is_pow2(c) and _is_pow2(block) and c <= block <= n):
        raise ValueError(f"need powers of two c <= block <= N, got c {c}, "
                         f"block {block}, N {n}")
    if dev == "cpu":
        return merge_tree_plain(key, val, c, block, rows_alternating)
    key, val = key.contiguous(), val.contiguous()
    out_k, out_v = torch.empty_like(key), torch.empty_like(val)
    MERGE_TREE(key, val, out_k, out_v, n, c, block, int(rows_alternating),
               stream=_stream(key))
    return out_k, out_v


def merge_cross_stage(key, val, d: int, run_out: int):
    """K12: one compare-exchange stage at distance d of the level that
    makes runs of run_out elements. On the card it works in place on
    contiguous arrays and returns them."""
    dev = _check_kv(key, val)
    n = key.shape[0]
    if not (_is_pow2(d) and _is_pow2(run_out) and 2 * d <= run_out <= n):
        raise ValueError(f"need powers of two 2 * d <= run_out <= N, got d "
                         f"{d}, run_out {run_out}, N {n}")
    if dev == "cpu":
        return merge_cross_stage_plain(key, val, d, run_out)
    if not (key.is_contiguous() and val.is_contiguous()):
        raise ValueError("the in-place stage needs contiguous arrays")
    MERGE_CROSS_STAGE(key, val, n, d, run_out, stream=_stream(key))
    return key, val


def merge_finish(key, val, run_out: int, block: int = MERGE_BLOCK):
    """K13: the stages block/2 ... 1 of the level that makes runs of
    run_out elements, block by block. On the card it works in place on
    contiguous arrays and returns them."""
    dev = _check_kv(key, val)
    n = key.shape[0]
    if not (_is_pow2(block) and _is_pow2(run_out)
            and 2 <= block <= run_out <= n):
        raise ValueError(f"need powers of two 2 <= block <= run_out <= N, "
                         f"got block {block}, run_out {run_out}, N {n}")
    if dev == "cpu":
        return merge_finish_plain(key, val, block, run_out)
    if not (key.is_contiguous() and val.is_contiguous()):
        raise ValueError("the in-place stages need contiguous arrays")
    MERGE_FINISH(key, val, n, block, run_out, stream=_stream(key))
    return key, val


def merged_rows(r: int, c: int) -> int:
    """Rows of merge_sorted_rows' output for (r, c) input: the reference's
    padding."""
    tree_rows = max(_MIN_ROWS, TREE_MAX // c)
    n_runs = -(-r // tree_rows)
    return tree_rows * (1 << max(0, (n_runs - 1).bit_length()))


def _pad_rows(k2d, v2d):
    r, c = k2d.shape
    pad = merged_rows(r, c) - r
    if pad:
        k2d = torch.cat([k2d, k2d.new_full((pad, c), DEAD)])
        v2d = torch.cat([v2d, v2d.new_zeros((pad, c))])
    return k2d.reshape(-1), v2d.reshape(-1)


def merge_schedule(n: int, block: int):
    """The launches after K11 for N elements: [("cross", d, run_out) ...,
    ("finish", run_out)] per level, for runs of block, 2 * block, ... N / 2
    merged into runs of twice the size."""
    steps = []
    run = block
    while run < n:
        d = run
        while d >= block:
            steps.append(("cross", d, 2 * run))
            d //= 2
        steps.append(("finish", 2 * run))
        run *= 2
    return steps


def merge_sorted_rows_plain(k2d, v2d, rows_alternating: bool = False):
    """The whole function's plain version: pad, one sort of the flattened
    keys, gather the values."""
    del rows_alternating        # a full sort does not read the rows' order
    key, val = _pad_rows(k2d, v2d)
    ks, order = torch.sort(key)
    return ks, val[order]


def merge_sorted_rows(k2d: torch.Tensor, v2d: torch.Tensor,
                      rows_alternating: bool = False):
    """(R, C) int32 key / value rows, every row sorted by key -> the flat,
    globally ascending (key, value) arrays of length R_padded * C, DEAD keys
    at the tail; unstable. C must be a power of two >= 256 (and at most
    MERGE_BLOCK on the card); R is padded with DEAD rows to the reference's
    length (merged_rows).

    rows_alternating: row r is ascending iff r is even (what
    `compact_pairs(alternating=True)` makes); otherwise every row is
    ascending and K11 reads the odd rows back to front.

    K11 once, then for every level above MERGE_BLOCK one K12 per distance
    >= MERGE_BLOCK and one K13 (merge_schedule)."""
    if k2d.dim() != 2 or k2d.shape != v2d.shape:
        raise ValueError(f"want (R, C) key and value rows, got "
                         f"{tuple(k2d.shape)} and {tuple(v2d.shape)}")
    r, c = k2d.shape
    if c < 256 or not _is_pow2(c):
        raise ValueError(f"C must be a power of two >= 256, got {c}")
    if k2d.device.type == "cuda" and c > MERGE_BLOCK:
        raise ValueError(f"C = {c} exceeds the {MERGE_BLOCK} pairs a block "
                         f"holds")
    key, val = _pad_rows(k2d, v2d)
    block = min(MERGE_BLOCK, key.shape[0])
    key, val = merge_tree(key, val, c, block, rows_alternating)
    for step in merge_schedule(key.shape[0], block):
        if step[0] == "cross":
            key, val = merge_cross_stage(key, val, step[1], step[2])
        else:
            key, val = merge_finish(key, val, step[1], block)
    return key, val
