"""Pixel shuffle / unshuffle in NHWC with torch channel ordering
(counterpart of ``image_restoration_agent_tpu/ops/pixel_shuffle.py``):
``nn.PixelShuffle(r)`` on NCHW maps channel ``c*r*r + i*r + j`` to spatial
offset ``(i, j)`` of channel ``c``."""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(..., H, W, C*r*r) -> (..., H*r, W*r, C)."""
    *b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(*b, h, w, c, r, r)
    x = torch.movedim(x, (-3, -2, -1), (-1, -4, -2))  # (..., h, i, w, j, c)
    return x.reshape(*b, h * r, w * r, c)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(..., H*r, W*r, C) -> (..., H, W, C*r*r)."""
    *b, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    x = x.reshape(*b, h, r, w, r, c)
    x = torch.movedim(x, (-4, -2, -1), (-2, -1, -3))  # (..., h, w, c, i, j)
    return x.reshape(*b, h, w, c * r * r)
