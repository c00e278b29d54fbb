"""On-device sort validators (port of fourdgs/ops/sort_checks.py): plain
tensor code that runs on the arrays' device, used by the tests and by
chip_smoke.py around the merge-tree sort.
"""

from __future__ import annotations

from typing import Tuple

import torch


def is_sorted(keys: torch.Tensor,
              ascending: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ok, error_count): monotonicity of a 1-D array, with the number of
    adjacent pairs out of order as a 0-d int32 tensor."""
    bad = keys[1:] < keys[:-1] if ascending else keys[1:] > keys[:-1]
    errors = bad.sum(dtype=torch.int32)
    return errors == 0, errors


def arrays_equal(a: torch.Tensor,
                 b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ok, error_mask): elementwise equality and the mask of mismatches."""
    mask = a != b
    return ~mask.any(), mask


def is_permutation(idx: torch.Tensor, n: int) -> torch.Tensor:
    """True iff the 1-D integer array idx is a permutation of [0, n): every
    value in range and its histogram all ones."""
    if idx.shape[0] != n:
        return torch.zeros((), dtype=torch.bool, device=idx.device)
    in_range = ((idx >= 0) & (idx < n)).all()
    counts = torch.bincount(torch.clamp(idx.long(), 0, max(n - 1, 0)),
                            minlength=n)
    return in_range & (counts == 1).all()
