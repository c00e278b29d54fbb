"""Small shared helpers (port of fourdgs/utils/misc.py): the analog of the
reference's Utils (Utils.cpp:115-133: lerp, mapf) plus a matrix printer and
a memory count."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def lerp(a, b, t):
    """Utils::lerp (Utils.cpp:125-128)."""
    return a + (b - a) * t


def mapf(x, in_min, in_max, out_min, out_max):
    """Utils::mapf (Utils.cpp:130-133): linear range remap."""
    return (x - in_min) / (in_max - in_min) * (out_max - out_min) + out_min


def format_mat(m, name: str = "mat", precision: int = 5) -> str:
    """Readable matrix dump (Utils::Mat4Print analog); takes a tensor on any
    device or an array."""
    arr = (m.detach().cpu().numpy() if isinstance(m, torch.Tensor)
           else np.asarray(m))
    rows = "\n".join("  [" + ", ".join(f"{v:+.{precision}f}" for v in row) + "]"
                     for row in np.atleast_2d(arr))
    return f"{name} {arr.shape}:\n{rows}"


def tree_bytes(tree) -> int:
    """Total byte size of the tensors and arrays in a nest of dicts, lists,
    tuples and dataclasses (memory accounting helper)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(tree_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0
