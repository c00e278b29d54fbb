"""The least time a hand-written kernel launch could take on the card: the
larger of the bytes it must move over the memory rate and the operations it
must do over the float32 rate.

A frozen copy of the port's kernel check (`chip_smoke.py`: `site`, `nbytes`,
the peaks, `PAIR_TEST_OPS`, `CMPX_OPS`). Its flaw, kept on purpose so that
later changes of the program are held to one yardstick: it counts the bytes
of a launch's arguments and results, the implementation's operands, not the
quantities the frame itself needs.

Each kernel's bytes and operations at its call sites sit in a file of their
own, `benchmark/bounds/<kernel>.py`, so that a later cell brings its
kernels' bounds as new files. `Recorder` wraps the kernel wrappers (module,
attribute) those files name for the duration of a `with` block; each call
adds its launch's bound to the recorder. Wrappers the program does not have
are skipped.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Callable, Dict, List, Tuple

from harness.spec import load_module

# NVIDIA's H100 SXM data sheet: HBM3 bandwidth, and the float32 rate outside
# the tensor cores, which also stands for integer compare-exchanges.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The coverage test of one (record or slot, pixel or sample): two
# differences, two rotated and scaled dot products, two compares.
PAIR_TEST_OPS = 12
# One compare-exchange of a (key, value) pair: a compare and three selects.
CMPX_OPS = 4


# (module, attribute, kernel, fn(args, kwargs, out) -> (bytes, operations))
Wrapper = Tuple[str, str, str, Callable]


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None and non-tensors count nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if hasattr(t, "element_size"))


def bound_s(moved: float, ops: float) -> float:
    return max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def wrappers(root: Path) -> List[Wrapper]:
    """The entries of every bound file, `benchmark/bounds/<kernel>.py` under
    the checkout `root`, in the files' name order. Each file holds
    `WRAPPERS`: (module, attribute) of a kernel wrapper the program calls,
    the kernel it launches, and its bytes and operations, fn(args, kwargs,
    out) -> (bytes, operations)."""
    found: List[Wrapper] = []
    for path in sorted((root / "benchmark" / "bounds").glob("*.py")):
        found.extend(load_module(path, f"bench_bounds_{path.stem}").WRAPPERS)
    return found


class Recorder:
    """Within `with Recorder(root) as rec:`, every call of a wrapper that
    the bound files under the checkout `root` name adds its launch's bound:
    rec.bounds[kernel] (seconds) and rec.calls[kernel]. A wrapper launches
    its kernel only on CUDA tensors, and every launch is counted as one
    call."""

    def __init__(self, root: Path):
        self.wrappers = wrappers(root)
        self.bounds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self._saved = []

    def __enter__(self):
        for mod_name, attr, kernel, fn in self.wrappers:
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
