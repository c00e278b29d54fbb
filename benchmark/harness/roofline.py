"""The least time a hand-written kernel launch could take on the card: the
larger of the bytes it must move over the memory rate and the operations it
must do over the float32 rate.

A frozen copy of the port's kernel check (`chip_smoke.py`: `site`, `nbytes`,
the peaks, `PAIR_TEST_OPS`, `CMPX_OPS` and each kernel's bytes and
operations at its call sites). Its flaw, kept on purpose so that later
changes of the program are held to one yardstick: it counts the bytes of a
launch's arguments and results, the implementation's operands, not the
quantities the frame itself needs.

`Recorder` wraps the kernel wrappers (module, attribute) of the program for
the duration of a `with` block; each call adds its launch's bound to the
recorder. Wrappers the program does not have are skipped.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Tuple

# NVIDIA's H100 SXM data sheet: HBM3 bandwidth, and the float32 rate outside
# the tensor cores, which also stands for integer compare-exchanges.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The coverage test of one (record or slot, pixel or sample): two
# differences, two rotated and scaled dot products, two compares.
PAIR_TEST_OPS = 12
# One compare-exchange of a (key, value) pair: a compare and three selects.
CMPX_OPS = 4


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None and non-tensors count nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if hasattr(t, "element_size"))


def bound_s(moved: float, ops: float) -> float:
    return max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def _sample_blocks(args, kw, out):
    # The function reads only the sampled words and writes them.
    return 2 * nbytes(*out), 0


def _rowsort_compact(args, kw, out):
    key, val, keep = args[:3]
    row_len = kw.get("row_len", args[3] if len(args) > 3 else 8192)
    cut = kw.get("cut", args[4] if len(args) > 4 else None)
    ok, ov, _ = out
    rows = ok.shape[1]
    stages = row_len.bit_length() * (row_len.bit_length() - 1) // 2
    # Every key and the cut table once, both outputs and the live counts,
    # and the kept slots' values read once.
    moved = nbytes(key, cut) + rows * 4 + 2 * nbytes(ok) + nbytes(ov)
    return moved, rows * (row_len // 2) * stages * CMPX_OPS


def _composite_records(args, kw, out):
    records, counts, kx = args[0], args[1], args[2]
    n_rec = int(counts.sum())
    tiles, pix = records.shape[0], kx.shape[2]
    moved = (n_rec * records.shape[1] * 4 + nbytes(counts)
             + tiles * pix * 4 * (2 + 8 + 8))
    return moved, n_rec * pix * PAIR_TEST_OPS


def _pack_record_fields(args, kw, out):
    return nbytes(*args[:10], out), 0


def _pack_meta_rows(args, kw, out):
    return nbytes(*args[:6], out), 0


def _tail_prepass(args, kw, out):
    meta, cuts = args[0], args[1]
    # The span row, the cut table and the outputs.
    return meta.shape[1] * 4 + nbytes(cuts, *out), 0


def _tail_accumulate(args, kw, out):
    fields, meta, band, rect, cut, params_row = args[:6]
    budget = kw["budget"]
    budget_lo = kw.get("budget_lo", 0)
    slots = int((meta[5].clamp(max=budget) - budget_lo).clamp(min=0).sum())
    moved = nbytes(fields, meta, band, rect, cut, params_row,
                   kw.get("slot_mask"), out)
    return moved, slots * kw["s_cy"] * kw["s_cx"] * PAIR_TEST_OPS


# (module, attribute) of each kernel wrapper a converged frame calls, the
# kernel it launches, and its bytes and operations.
WRAPPERS: List[Tuple[str, str, str, Callable]] = [
    ("fourdgs_torch.render.tiles", "sample_blocks", "K3", _sample_blocks),
    ("fourdgs_torch.render.pipeline", "sample_blocks", "K3", _sample_blocks),
    ("fourdgs_torch.render.tiles", "rowsort_compact", "K2", _rowsort_compact),
    ("fourdgs_torch.render.pipeline", "composite_records", "K1",
     _composite_records),
    ("fourdgs_torch.ops.pack_cuda", "pack_record_fields", "K4",
     _pack_record_fields),
    ("fourdgs_torch.ops.pack_cuda", "pack_meta_rows", "K5", _pack_meta_rows),
    ("fourdgs_torch.ops.tail_cuda", "tail_prepass", "K6", _tail_prepass),
    ("fourdgs_torch.ops.tail_cuda", "tail_accumulate", "K7",
     _tail_accumulate),
]


class Recorder:
    """Within `with Recorder() as rec:`, every call of a wrapper of
    WRAPPERS adds its launch's bound: rec.bounds[kernel] (seconds) and
    rec.calls[kernel]. A wrapper launches its kernel only on CUDA tensors,
    and every launch is counted as one call."""

    def __init__(self):
        self.bounds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self._saved = []

    def __enter__(self):
        for mod_name, attr, kernel, fn in WRAPPERS:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr, None)
            if orig is None:
                continue
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(orig, kernel, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()
        return False

    def _wrap(self, orig, kernel, fn):
        def recorder(*args, **kwargs):
            out = orig(*args, **kwargs)
            moved, ops = fn(args, kwargs, out)
            self.bounds[kernel] = self.bounds.get(kernel, 0.0) + bound_s(
                moved, ops)
            self.calls[kernel] = self.calls.get(kernel, 0) + 1
            return out
        return recorder

    def total_s(self) -> float:
        return sum(self.bounds.values())
