"""Layers shared by DiffBIR's VAE, UNet and ControlNet, channels-last,
with Flax's numerics and the reference's parameter names.

Flax computes a layer in the promotion of its input's and its parameters'
dtypes. Under the engine's bfloat16 weights that makes most of the
denoiser float32: the sampler's latent is float32, so every layer it
reaches runs float32 arithmetic on bf16-rounded weights, while the stage-1
SwinIR and the condition encoder, fed bf16 images, stay bf16. The port
keeps those cast points: :func:`promote` gives a layer's compute dtype.

- :class:`GroupNorm` and :class:`LayerNorm`: float32 statistics with
  Flax's fast variance (``E[x^2] - E[x]^2``, clipped at 0), ``(x - mean)
  * (rsqrt(var + eps) * scale) + bias`` in float32, one cast of the result.
- :class:`Linear`: ``x @ W^T + b`` in the promoted dtype (float32 without
  TF32 on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...device import exact_f32


def promote(x: torch.Tensor, p: torch.Tensor) -> torch.dtype:
    """The dtype Flax computes a layer in: its input's and its
    parameters' promotion."""
    return torch.promote_types(x.dtype, p.dtype)


def conv(mod: nn.Module, x: torch.Tensor, **kw) -> torch.Tensor:
    """``mod(x)`` (a conv) in the promotion of ``x``'s and the weight's
    dtypes, a residual ``res`` cast with it."""
    dt = promote(x, mod.weight)
    if kw.get("res") is not None:
        kw["res"] = kw["res"].to(dt)
    return mod(x.to(dt), **kw)


def _normalize(x: torch.Tensor, xf: torch.Tensor, mu: torch.Tensor,
               var: torch.Tensor, eps: float, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    mul = torch.rsqrt(var + eps) * weight.float()
    y = (xf - mu) * mul + bias.float()
    return y.to(promote(x, weight))


class GroupNorm(nn.Module):
    """``nn.GroupNorm(num_groups, C, eps)`` over the channel (last) axis of
    (B, ..., C), statistics over everything but the batch."""

    def __init__(self, num_groups: int, c: int, eps: float):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, g = x.shape[0], x.shape[-1], self.num_groups
        xf = x.float().reshape(b, -1, g, c // g)
        mu = xf.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(xf.square().mean(dim=(1, 3), keepdim=True)
                          - mu.square(), min=0.0)
        y = _normalize(x, xf, mu, var, self.eps,
                       self.weight.reshape(g, c // g),
                       self.bias.reshape(g, c // g))
        return y.reshape(x.shape)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` (eps 1e-6 by default) over the last axis."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp(xf.square().mean(dim=-1, keepdim=True)
                          - mu.square(), min=0.0)
        return _normalize(x, xf, mu, var, self.eps, self.weight, self.bias)


class Linear(nn.Linear):
    """``nn.Linear`` in the promotion of the input's and the weight's
    dtypes (Flax ``Dense``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = promote(x, self.weight)
        if x.is_cuda and dt == torch.float32:
            exact_f32()
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)
