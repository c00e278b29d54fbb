"""The pair-sort kernels (port of fourdgs/ops/sort_pallas.py): the
strided-row sort + keep with the fused prune cut (`rowsort_compact`, rows
ascending or, alternating, odd rows descending) and the bitonic merge of
sorted rows into one sorted array (`merge_sorted_rows`).

Kernel K2 (`csrc/rowsort.cu`) and kernels K11-K13 (`csrc/merge.cu`), each
with its plain PyTorch version. A CPU tensor runs the plain versions; a CUDA
tensor launches the kernels.

No compiler runs where the tests do, so the walks of the kernels that
differ most from their plain versions are also written out in plain PyTorch:
`rowsort_compact_lists` (K2: cut, per-row lists of `cap` live slots, the
sort on (key, position), overflowing rows through the full sort),
`merge_cross_stages_plain` (K12: several stages on the 2^s elements a thread
holds) and `merge_tree_rounds` / `merge_finish_rounds` (K11, K13: the
stages in register rounds with swizzled transposes between them). The tests
hold them against the plain versions or the network of single stages
exactly.
"""

from __future__ import annotations

import ctypes
import functools
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
# Pairs a block of K11 / K13 holds: 16 a thread in registers, and 128 KB of
# shared memory for the transposes between its rounds.
MERGE_BLOCK = 1 << 14
# Stages one pass of K12 runs at most: 2^4 keys and values a thread.
CROSS_GROUP = 4

ROWSORT = CudaKernel(
    "rowsort.cu", "fourdgs_rowsort_compact",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int])
MERGE_TREE = CudaKernel(
    "merge.cu", "fourdgs_merge_tree",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int])
MERGE_CROSS_STAGE = CudaKernel(
    "merge.cu", "fourdgs_merge_cross_stages",
    [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_int,
                                                       ctypes.c_longlong])
MERGE_FINISH = CudaKernel(
    "merge.cu", "fourdgs_merge_finish",
    [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_longlong])
# One host call that enqueues every launch after K11. It reports the device
# launches it made, which are counted on MERGE_CROSS_STAGE and MERGE_FINISH.
MERGE_LEVELS = CudaKernel(
    "merge.cu", "fourdgs_merge_levels",
    [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def rowsort_rows(s: int, row_len: int) -> int:
    rows = -(-s // row_len)
    return -(-rows // ROWSORT_COLS) * ROWSORT_COLS


def _list_cap(keep_cols: int) -> Optional[int]:
    """Entries of a row's list in K2 for this keep: a row with more live
    slots takes the full network. None: the keep is too wide for lists and
    every row takes it."""
    return 64 if keep_cols <= 64 else 128 if keep_cols <= 128 else None


def _cut_rows(key, val, row_len: int, cut: Optional[torch.Tensor],
              key_shift: int):
    """The padded (row_len, rows) views of the slots, the cut applied to the
    keys (cut slots DEAD)."""
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
    return k2, v2


def _alternate_rows(x: torch.Tensor) -> torch.Tensor:
    """(keep, rows): the odd logical rows (columns) reversed."""
    out = x.clone()
    out[:, 1::2] = x[:, 1::2].flip(0)
    return out


def rowsort_compact_plain(key, val, keep_cols: int, row_len: int,
                          cut: Optional[torch.Tensor], key_shift: int,
                          alternating: bool = False):
    """Returns ((keep, rows) key, (keep, rows) val, (rows,) live): a stable
    sort of every row, equal keys in the order of their slots; a DEAD key
    carries the value 0. With `alternating` the odd rows come out
    descending: the kept end of a descending row is its tail, the ascending
    keep reversed."""
    k2, v2 = _cut_rows(key, val, row_len, cut, key_shift)
    live = (k2 != DEAD).sum(0, dtype=torch.int32)
    ks, order = torch.sort(k2, dim=0, stable=True)
    ks = ks[:keep_cols].contiguous()
    vs = torch.where(ks == DEAD, 0, torch.gather(v2, 0, order[:keep_cols]))
    if alternating:
        ks, vs = _alternate_rows(ks), _alternate_rows(vs)
    return ks, vs, live


_ENTRY_PAD = 2 ** 63 - 1    # an empty list place: sorts after every entry


def rowsort_compact_lists(key, val, keep_cols: int, row_len: int,
                          cut: Optional[torch.Tensor], key_shift: int,
                          cap: int, alternating: bool = False):
    """K2's walk written out: what `rowsort_compact_plain` returns, computed
    as the kernel computes it. A slot that survives the cut is appended as
    the entry (key << 32 | position in the row) to its row's list of `cap`
    places; a list is sorted as 64-bit entries (the order in which slots
    were appended then does not matter); a row with more than `cap` live
    slots is read again whole and sorted by the same entries; the first
    `keep_cols` entries give the keys, and the values are fetched from the
    entries' positions; with `alternating` an odd row's c-th kept entry is
    written to place keep - 1 - c."""
    if cap < keep_cols:
        raise ValueError(f"cap {cap} is below keep {keep_cols}")
    k2, v2 = _cut_rows(key, val, row_len, cut, key_shift)
    rows = k2.shape[1]
    pos = torch.arange(row_len, device=key.device)[:, None].expand_as(k2)
    is_live = k2 != DEAD
    entries = torch.where(is_live, (k2.long() << 32) | pos, _ENTRY_PAD)
    live = is_live.sum(0, dtype=torch.int32)
    # Append: the j-th live slot a row meets goes to place j while j < cap.
    place = torch.cumsum(is_live, dim=0) - 1
    listed = is_live & (place < cap)
    lists = torch.full((cap, rows), _ENTRY_PAD, dtype=torch.int64,
                       device=key.device)
    col = torch.arange(rows, device=key.device)[None, :].expand_as(k2)
    lists[place[listed], col[listed]] = entries[listed]
    lists = torch.sort(lists, dim=0).values
    # Overflowing rows: the full sort of the row's entries.
    over = live > cap
    if bool(over.any()):
        full = torch.sort(entries[:, over], dim=0).values
        lists[:keep_cols, over] = full[:keep_cols]
    kept = lists[:keep_cols]
    ok = (kept >> 32).to(torch.int32)
    at = (kept & 0xFFFFFFFF).clamp(max=row_len - 1)
    ov = torch.where(ok == DEAD, 0, torch.gather(v2, 0, at))
    if alternating:
        ok, ov = _alternate_rows(ok), _alternate_rows(ov)
    return ok.contiguous(), ov.contiguous(), live


def _rowsort_compact_live(key: torch.Tensor, val: torch.Tensor,
                          keep_cols: int, row_len: int,
                          cut: Optional[torch.Tensor], key_shift: int,
                          alternating: bool = False):
    """`rowsort_compact` with the rows' live counts: ((keep, rows) key,
    (keep, rows) val, (rows,) live slots after the cut, dropped)."""
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
                                             cut, key_shift, alternating)
        dropped = torch.clamp(live - keep_cols, min=0).sum(dtype=torch.int32)
    elif key.device.type == "cuda":
        s = key.shape[0]
        rows = rowsort_rows(s, row_len)
        key, val = key.contiguous(), val.contiguous()
        ok = torch.empty((keep_cols, rows), dtype=torch.int32,
                         device=key.device)
        ov = torch.empty_like(ok)
        live = torch.empty(rows, dtype=torch.int32, device=key.device)
        # The kernel adds every row's max(live - keep, 0) into it.
        dropped = torch.zeros((), dtype=torch.int32, device=key.device)
        cut_c = None if cut is None else cut.to(torch.int32).contiguous()
        ROWSORT(key, val, s, rows, row_len, keep_cols,
                cut_c,
                0 if cut_c is None else cut_c.shape[0], key_shift,
                ok, ov, live, dropped, int(alternating),
                stream=torch.cuda.current_stream(key.device).cuda_stream)
    else:
        raise ValueError(f"unsupported device {key.device}")
    return ok, ov, live, dropped


def rowsort_compact(key: torch.Tensor, val: torch.Tensor, keep_cols: int,
                    row_len: int = 8192, cut: Optional[torch.Tensor] = None,
                    key_shift: int = 20, alternating: bool = False):
    """Sort the rows = ceil(S / row_len) (rounded up to a multiple of 256)
    strided logical rows of the flat (S,) key/value arrays (row r holds
    key[r::rows]) and keep each row's first keep_cols. Returns ((keep, rows)
    key, (keep, rows) val, dropped) — the TRANSPOSED layout, logical rows on
    the minor axis.

    cut: optional (T <= 2048,) int32 per-tile prune cut keys, applied before
    sorting (key > cut[key >> key_shift] -> DEAD); `dropped` counts the live
    slots (after the cut) lost to the keep cap. Equal keys of a row keep
    the order of their slots (a stable sort); a DEAD key carries value 0.
    alternating: odd rows (logical row index r) come out descending, their
    kept end taken from the row's tail: the ascending keep reversed, as the
    reference's `rowsort_compact(alternating=True)` leaves them.
    """
    ok, ov, _, dropped = _rowsort_compact_live(key, val, keep_cols, row_len,
                                               cut, key_shift, alternating)
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


def merge_cross_stages_plain(key, val, d_hi: int, n_stages: int,
                             run_out: int):
    """One pass of K12 as its threads run it: the 2^s elements whose indices
    differ in the s bits log2(d_lo) ... log2(d_hi) form a group (one
    thread's registers), and the stages d_hi, d_hi / 2 ... d_lo =
    d_hi >> (s - 1) run on the group axis. Equals n_stages calls of
    merge_cross_stage_plain."""
    n = key.shape[0]
    size = 1 << n_stages
    d_lo = d_hi >> (n_stages - 1)
    k = key.reshape(-1, size, d_lo)
    v = val.reshape(-1, size, d_lo)
    first = torch.arange(k.shape[0], device=key.device) * (size * d_lo)
    # 2 * d_hi <= run_out: a group lies in one run and has one direction.
    desc = (((first // run_out) % 2 == 1) & (run_out < n))[:, None, None, None]
    h = size // 2
    while h >= 1:
        k4, v4 = k.reshape(-1, size // (2 * h), 2, h * d_lo), \
            v.reshape(-1, size // (2 * h), 2, h * d_lo)
        lo_k, hi_k = k4[:, :, 0], k4[:, :, 1]
        swap = torch.where(desc[..., 0], lo_k < hi_k, hi_k < lo_k)
        k = torch.stack([torch.where(swap, hi_k, lo_k),
                         torch.where(swap, lo_k, hi_k)], dim=2)
        v = torch.stack([torch.where(swap, v4[:, :, 1], v4[:, :, 0]),
                         torch.where(swap, v4[:, :, 0], v4[:, :, 1])], dim=2)
        h //= 2
    return k.reshape(-1), v.reshape(-1)


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


# The register rounds of K11 and K13 (csrc/merge_rounds.cuh) written out:
# a block holds a tile of 2^tile_bits pairs, 2^reg_bits a thread.
ROUND_TILE_BITS = 14
ROUND_REG_BITS = 4
# Layouts up to this one keep a warp's 512 pairs in the warp: a transpose
# between two of them needs no block-wide barrier. The kernels store from it.
ROUND_WARP_LO = 5


def round_layout(lo: int, tile_bits: int = ROUND_TILE_BITS,
                 reg_bits: int = ROUND_REG_BITS) -> torch.Tensor:
    """(threads, 2^reg_bits) tile indices of layout `lo`: register j of
    thread t holds pair ((t >> lo) << (lo + reg_bits)) | (j << lo) |
    (t & (2^lo - 1)), so the index bits lo ... lo + reg_bits - 1 are the
    register's."""
    t = torch.arange(1 << (tile_bits - reg_bits))[:, None]
    j = torch.arange(1 << reg_bits)[None, :]
    return ((t >> lo) << (lo + reg_bits)) | (j << lo) | (t & ((1 << lo) - 1))


def round_swizzle(i: torch.Tensor) -> torch.Tensor:
    """Place of tile pair i in shared memory: bits 4-7 XORed into bits 0-3,
    which keeps every layout's transposes free of bank conflicts."""
    return i ^ ((i >> 4) & 15)


def level_rounds(m: int, reg_bits: int = ROUND_REG_BITS):
    """(layout lo, stages) of the rounds that run the stages 2^m ... 1 of a
    level, from the top: the stages of a round are the register bits
    stages - 1 ... 0 of its layout."""
    rounds, top = [], m
    while top >= 0:
        lo = max(top - (reg_bits - 1), 0)
        rounds.append((lo, top - lo + 1))
        top = lo - 1
    return rounds


def _round_stage(k, v, r: int):
    """The compare-exchange of registers j and j | 2^r, ascending, strict."""
    shape = k.shape
    h = 1 << r
    k4 = k.reshape(*shape[:-1], -1, 2, h)
    v4 = v.reshape(*shape[:-1], -1, 2, h)
    ka, kb = k4[..., 0, :], k4[..., 1, :]
    va, vb = v4[..., 0, :], v4[..., 1, :]
    swap = kb < ka
    k = torch.stack([torch.where(swap, kb, ka), torch.where(swap, ka, kb)], -2)
    v = torch.stack([torch.where(swap, vb, va), torch.where(swap, va, vb)], -2)
    return k.reshape(shape), v.reshape(shape)


def _round_walk(key, val, levels, src_of, tile_bits: int, reg_bits: int):
    """The tiles of the flat arrays loaded into the first level's layout
    (pair i read from src_of(i); past the end, DEAD), every level (m,
    run_shift, alternate) run as register rounds with transposes through
    the swizzled shared memory between them, its descending runs' keys
    complemented around it, then stored from the warp layout ROUND_WARP_LO,
    reached from the last round's layout 0 by one more transpose."""
    n = key.shape[0]
    tile = 1 << tile_bits
    tiles = -(-n // tile)
    first = torch.arange(tiles, device=key.device)[:, None, None] * tile

    def at(layout_lo):
        return first + round_layout(layout_lo, tile_bits,
                                    reg_bits).to(key.device)

    def transpose(k, v, lo_from, lo_to):
        smem = torch.empty((tiles, tile, 2), dtype=key.dtype,
                           device=key.device)
        place = round_swizzle(at(lo_from) - first).reshape(tiles, -1, 1)
        smem.scatter_(1, place.expand(-1, -1, 2),
                      torch.stack([k, v], -1).reshape(tiles, -1, 2))
        place = round_swizzle(at(lo_to) - first).reshape(tiles, -1, 1)
        got = smem.gather(1, place.expand(-1, -1, 2))
        return got[..., 0].reshape(k.shape), got[..., 1].reshape(v.shape)

    def flipped(k, lo, run_shift, alternate):
        desc = ((at(lo) >> run_shift) & 1).to(torch.int32) * int(alternate)
        return k ^ -desc

    lo = level_rounds(levels[0][0], reg_bits)[0][0] if levels else 0
    src = src_of(at(lo))
    inside = src < n
    src = src.clamp(max=n - 1)
    k = torch.where(inside, key[src], DEAD)
    v = torch.where(inside, val[src], 0)
    for m, run_shift, alternate in levels:
        k = flipped(k, lo, run_shift, alternate)
        for round_lo, stages in level_rounds(m, reg_bits):
            if round_lo != lo:
                k, v = transpose(k, v, lo, round_lo)
                lo = round_lo
            for r in reversed(range(stages)):
                k, v = _round_stage(k, v, r)
        k = flipped(k, lo, run_shift, alternate)
    store_lo = min(ROUND_WARP_LO, tile_bits - reg_bits)
    k, v = transpose(k, v, lo, store_lo)
    out_k = torch.empty(tiles * tile, dtype=key.dtype, device=key.device)
    out_v = torch.empty_like(out_k)
    out_k[at(store_lo).reshape(-1)] = k.reshape(-1)
    out_v[at(store_lo).reshape(-1)] = v.reshape(-1)
    return out_k[:n], out_v[:n]


def merge_tree_rounds(key, val, c: int, block: int,
                      rows_alternating: bool,
                      tile_bits: int = ROUND_TILE_BITS,
                      reg_bits: int = ROUND_REG_BITS):
    """K11 as its blocks run it: the levels from runs of c to runs of block
    (block <= 2^tile_bits) as register rounds, the odd rows read back to
    front by the first load unless rows_alternating. Equals the network of
    single stages bit for bit (keys and values)."""
    n = key.shape[0]
    flip = not rows_alternating
    levels = [(m, m + 1, (2 << m) < n)
              for m in range(c.bit_length() - 1, block.bit_length() - 1)]

    def src_of(i):
        if not flip:
            return i
        return torch.where(((i // c) % 2) == 1, i ^ (c - 1), i)
    return _round_walk(key, val, levels, src_of, tile_bits, reg_bits)


def merge_finish_rounds(key, val, run_out: int, block: int,
                        tile_bits: int = ROUND_TILE_BITS,
                        reg_bits: int = ROUND_REG_BITS):
    """K13 as its blocks run it: the stages block/2 ... 1 of the level that
    makes runs of run_out, as register rounds on tiles of 2^tile_bits
    pairs. Equals those single stages bit for bit (keys and values)."""
    n = key.shape[0]
    levels = [(block.bit_length() - 2, run_out.bit_length() - 1,
               run_out < n)]
    return _round_walk(key, val, levels, lambda i: i, tile_bits, reg_bits)


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


def merge_cross_stages(key, val, d_hi: int, n_stages: int, run_out: int):
    """K12: the n_stages (1 to CROSS_GROUP) compare-exchange stages at
    distances d_hi, d_hi / 2 ... of the level that makes runs of run_out
    elements, in one pass. On the card it works in place on contiguous
    arrays and returns them."""
    dev = _check_kv(key, val)
    n = key.shape[0]
    if not (_is_pow2(d_hi) and _is_pow2(run_out) and 2 * d_hi <= run_out <= n
            and 1 <= n_stages <= CROSS_GROUP and d_hi >> (n_stages - 1)):
        raise ValueError(f"need powers of two 2 * d <= run_out <= N and 1 to "
                         f"{CROSS_GROUP} stages down to a distance >= 1, got "
                         f"d {d_hi}, {n_stages} stages, run_out {run_out}, "
                         f"N {n}")
    if dev == "cpu":
        return merge_cross_stages_plain(key, val, d_hi, n_stages, run_out)
    if not (key.is_contiguous() and val.is_contiguous()):
        raise ValueError("the in-place stages need contiguous arrays")
    MERGE_CROSS_STAGE(key, val, n, d_hi, n_stages, run_out,
                      stream=_stream(key))
    return key, val


def merge_cross_stage(key, val, d: int, run_out: int):
    """K12 with one stage: the compare-exchange at distance d of the level
    that makes runs of run_out elements. On the card it works in place on
    contiguous arrays and returns them."""
    return merge_cross_stages(key, val, d, 1, run_out)


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


def merge_schedule(n: int, block: int, group: int = 1):
    """The launches after K11 for N elements, for runs of block, 2 * block,
    ... N / 2 merged into runs of twice the size: per level its cross
    stages d = run, run / 2 ... block, then ("finish", run_out).

    group = 1: one ("cross", d, run_out) per stage. group > 1: a level's k
    cross stages in ceil(k / group) passes of nearly equal size, each
    ("cross", d_hi, run_out, n_stages) for the stages d_hi, d_hi / 2 ...
    d_hi >> (n_stages - 1)."""
    steps = []
    run = block
    while run < n:
        k = (run // block).bit_length()            # stages run ... block
        if group == 1:
            steps += [("cross", run >> i, 2 * run) for i in range(k)]
        else:
            passes = -(-k // group)
            done = 0
            for p in range(passes):
                size = k // passes + (p < k % passes)
                steps.append(("cross", run >> done, 2 * run, size))
                done += size
        steps.append(("finish", 2 * run))
        run *= 2
    return steps


@functools.lru_cache(maxsize=16)
def _levels_array(steps: tuple):
    """Steps in merge_schedule's form as the (d_hi, n_stages, run_out)
    triples `fourdgs_merge_levels` reads (n_stages 0: a finish)."""
    flat = []
    for step in steps:
        flat += [step[1], step[3] if len(step) > 3 else 1, step[2]] \
            if step[0] == "cross" else [0, 0, step[1]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _enqueue_levels(key, val, block: int, steps):
    """One host call that enqueues `steps` (merge_schedule's form) on the
    card, in place; K12 and K13 are counted as the C loop reports its
    launches. Returns (K12 launches, K13 launches)."""
    launched = (ctypes.c_int * 2)()
    try:
        MERGE_LEVELS(key, val, key.shape[0], block,
                     _levels_array(tuple(steps)), len(steps), launched,
                     stream=_stream(key))
    finally:
        MERGE_CROSS_STAGE.launches += launched[0]
        MERGE_FINISH.launches += launched[1]
    return launched[0], launched[1]


def merge_levels(key, val, block: int = MERGE_BLOCK):
    """Every launch after K11, on sorted runs of `block` elements (odd runs
    descending): the passes of K12 and the finishes of K13 that
    merge_schedule(N, block, CROSS_GROUP) lists, in place on the card and
    enqueued by one host call there."""
    dev = _check_kv(key, val)
    n = key.shape[0]
    if not (_is_pow2(block) and 2 <= block <= n):
        raise ValueError(f"need a power of two 2 <= block <= N, got block "
                         f"{block}, N {n}")
    steps = merge_schedule(n, block, CROSS_GROUP)
    if dev == "cpu":
        for step in steps:
            if step[0] == "cross":
                key, val = merge_cross_stages_plain(
                    key, val, step[1], step[3] if len(step) > 3 else 1,
                    step[2])
            else:
                key, val = merge_finish_plain(key, val, block, step[1])
        return key, val
    if not (key.is_contiguous() and val.is_contiguous()):
        raise ValueError("the in-place levels need contiguous arrays")
    if steps:
        _enqueue_levels(key, val, block, steps)
    return key, val


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

    K11 once, then for every level above MERGE_BLOCK its distances >=
    MERGE_BLOCK in passes of K12 of up to CROSS_GROUP stages and one K13
    (merge_levels; merge_schedule lists the launches)."""
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
    return merge_levels(key, val, block)
