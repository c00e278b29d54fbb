"""Depth-ordering helpers (port of fourdgs/render/sort.py): the reference's
stable radix sort of per-frame keys as one stable `torch.argsort`.
"""

from __future__ import annotations

import torch


def painter_order(depth_key: torch.Tensor) -> torch.Tensor:
    """Ascending stable order over 1/distance keys: the order the reference
    draws in (back to front; ties keep splat-index order, as its stable
    radix sort does)."""
    return torch.argsort(depth_key, stable=True)


def front_to_back_order(depth_key: torch.Tensor) -> torch.Tensor:
    """painter_order reversed: equal keys come out in descending index
    order."""
    return painter_order(depth_key).flip(0)


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """rank[order[j]] = j."""
    n = order.shape[0]
    rank = torch.empty_like(order)
    rank[order.long()] = torch.arange(n, dtype=order.dtype,
                                      device=order.device)
    return rank


def front_to_back_rank(depth_key: torch.Tensor) -> torch.Tensor:
    """Rank of each splat in front-to-back order (0 = nearest), int32."""
    return inverse_permutation(front_to_back_order(depth_key).to(torch.int32))
