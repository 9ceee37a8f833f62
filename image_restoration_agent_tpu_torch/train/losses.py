"""Restoration training losses (counterpart of
``image_restoration_agent_tpu/train/losses.py``): means over every element
of a batch, in the inputs' dtype."""

from __future__ import annotations

import torch

from ..iqa.metrics import psnr


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-3) -> torch.Tensor:
    """Charbonnier (smooth L1): the standard restoration training loss."""
    return torch.mean(torch.sqrt(torch.square(pred - target) + eps * eps))


def psnr_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Negative PSNR (NAFNet's training objective), through
    :func:`iqa.metrics.psnr` (peak 1, the MSE floored at 1e-12)."""
    return -psnr(pred, target)
