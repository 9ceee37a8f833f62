"""LayerNorm over the channel (last) axis with float32 statistics."""

from __future__ import annotations

import torch


def layer_norm_lanes(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``nn.LayerNorm`` over the last axis, two-pass float32 statistics,
    result in ``x``'s dtype (counterpart of
    ``image_restoration_agent_tpu/models/common.py:layer_norm_lanes``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)
