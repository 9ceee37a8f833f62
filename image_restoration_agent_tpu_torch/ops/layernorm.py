"""LayerNorm variants over the channel (last) axis, float32 statistics
(counterpart of ``image_restoration_agent_tpu/ops/layernorm.py`` and of
``layer_norm_lanes`` in its ``models/common.py``).

The zoo's normalizations are not interchangeable:

- ``layer_norm_lanes``: ``nn.LayerNorm`` (SwinIR), eps 1e-5, rsqrt.
- ``layer_norm_2d``: NAFNet's LayerNorm2d, eps 1e-6 inside the sqrt.
- ``layer_norm_with_bias``: Restormer WithBias_LayerNorm, eps 1e-5.
- ``layer_norm_bias_free``: Restormer BiasFree_LayerNorm: divides by the
  std but keeps the mean (``x / sqrt(var + eps) * w``).
"""

from __future__ import annotations

import torch


def _moments(x: torch.Tensor):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return xf, mu, var


def layer_norm_lanes(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``nn.LayerNorm`` over the last axis, two-pass float32 statistics,
    result in ``x``'s dtype."""
    xf, mu, var = _moments(x)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layer_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """NAFNet LayerNorm2d over the channel axis of (..., C)."""
    xf, mu, var = _moments(x)
    y = (xf - mu) / torch.sqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def layer_norm_with_bias(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5
                         ) -> torch.Tensor:
    """Restormer WithBias LayerNorm."""
    xf, mu, var = _moments(x)
    y = (xf - mu) / torch.sqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def layer_norm_bias_free(x: torch.Tensor, weight: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """Restormer BiasFree LayerNorm: divides by the std, keeps the mean."""
    xf, _, var = _moments(x)
    y = xf / torch.sqrt(var + eps)
    return (y * weight.float()).to(x.dtype)
