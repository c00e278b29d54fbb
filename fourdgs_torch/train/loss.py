"""Photometric losses for fitting splats (port of fourdgs/train/loss.py):
L2, L1, a uniform-window SSIM and the standard splat-fitting objective
L1 + w (1 - SSIM). Images are (H, W, >=3) tensors, channels last; only RGB
enters."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l2(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((img[..., :3] - target[..., :3]) ** 2)


def l1(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(img[..., :3] - target[..., :3]))


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k mean with stride 1 and no padding (VALID), per channel,
    channels last: (H, W, C) -> (H - k + 1, W - k + 1, C)."""
    return F.avg_pool2d(x.permute(2, 0, 1)[None], k, stride=1)[0] \
        .permute(1, 2, 0)


def ssim(img: torch.Tensor, target: torch.Tensor, k: int = 7,
         c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> torch.Tensor:
    """Mean SSIM over RGB with a k x k uniform window."""
    x = img[..., :3]
    y = target[..., :3]
    mu_x = _avg_pool(x, k)
    mu_y = _avg_pool(y, k)
    xx = _avg_pool(x * x, k) - mu_x * mu_x
    yy = _avg_pool(y * y, k) - mu_y * mu_y
    xy = _avg_pool(x * y, k) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (xx + yy + c2)
    return torch.mean(num / den)


def photometric(img: torch.Tensor, target: torch.Tensor,
                ssim_weight: float = 0.2) -> torch.Tensor:
    """L1 + w * (1 - SSIM): the standard splat-fitting objective."""
    loss = l1(img, target)
    if ssim_weight > 0:
        loss = (1.0 - ssim_weight) * loss + ssim_weight * (
            1.0 - ssim(img, target))
    return loss
