"""AutoencoderKL (the Stable-Diffusion VAE) and DiffBIR's condition
encoder, channels-last (counterpart of
``image_restoration_agent_tpu/models/diffbir/vae.py``; reference taming /
LDM ``autoencoder.py``: ch 128, ch_mult (1, 2, 4, 4), 2 res blocks, mid
attention, z 4, scale factor 0.18215), with the reference's state-dict
names: ``encoder.conv_in``, ``encoder.down.{i}.block.{j}``,
``encoder.down.{i}.downsample.conv``, ``encoder.mid.block_1`` /
``attn_1`` / ``block_2``, ``encoder.norm_out`` / ``conv_out``, the
decoder's ``up.{i}.block.{j}`` / ``up.{i}.upsample.conv`` (level ``i``,
built in reverse), ``quant_conv``, ``post_quant_conv``.

GroupNorm(32) uses eps 1e-6 throughout. Every 3x3 stride-1 conv runs
through :class:`models.common.Conv` (K3 on the card), a res block's second
conv with the shortcut as K3's residual; the 1x1 convs are matmuls and
the taming downsample (pad bottom and right by 1, then a VALID stride-2
conv) a library conv, as XLA runs them. The mid-block's single-head
attention is dense below :data:`ops.chunked_attention.DENSE_SCORE_LIMIT`
score entries and chunked above.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.chunked_attention import (DENSE_SCORE_LIMIT, chunked_attention,
                                      dense_attention)
from ..common import Conv, Conv1x1, ConvLib
from ..drbnet import nearest_up2
from .layers import GroupNorm, conv


class VAEResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm(32, cin, 1e-6)
        self.conv1 = Conv(cin, cout)
        self.norm2 = GroupNorm(32, cout, 1e-6)
        self.conv2 = Conv(cout, cout)
        self.nin_shortcut = Conv1x1(cin, cout) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv(self.conv1, F.silu(self.norm1(x)))
        skip = x if self.nin_shortcut is None else conv(self.nin_shortcut, x)
        return conv(self.conv2, F.silu(self.norm2(y)), res=skip)


class MidAttention(nn.Module):
    """Single-head self-attention over the bottleneck grid."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(32, c, 1e-6)
        self.q = Conv1x1(c, c)
        self.k = Conv1x1(c, c)
        self.v = Conv1x1(c, c)
        self.proj_out = Conv1x1(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.norm(x)
        q, k, v = (conv(m, y).reshape(b, h * w, c)
                   for m in (self.q, self.k, self.v))
        n = h * w
        if n * n > DENSE_SCORE_LIMIT:
            out = chunked_attention(q, k, v, c ** -0.5)
        else:
            out = dense_attention(q, k, v, c ** -0.5)
        out = out.reshape(b, h, w, c).to(x.dtype)
        return x + conv(self.proj_out, out)


class _Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = VAEResBlock(c, c)
        self.attn_1 = MidAttention(c)
        self.block_2 = VAEResBlock(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(x)))


class _Downsample(nn.Module):
    """taming's Downsample: pad bottom and right by 1, VALID stride-2 3x3."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = ConvLib(c, c, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return conv(self.conv, x)


class _Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self.conv, nearest_up2(x))


class _Level(nn.Module):
    def __init__(self, blocks: list, sample: nn.Module | None, name: str):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if sample is not None:
            setattr(self, name, sample)


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 double_z: bool = True, in_channels: int = 3):
        super().__init__()
        self.conv_in = Conv(in_channels, ch)
        levels, c = [], ch
        for i, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(VAEResBlock(c, ch * mult))
                c = ch * mult
            last = i == len(ch_mult) - 1
            levels.append(_Level(blocks, None if last else _Downsample(c),
                                 "downsample"))
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(c)
        self.norm_out = GroupNorm(32, c, 1e-6)
        self.conv_out = Conv(c, z_channels * (2 if double_z else 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv(self.conv_in, x)
        for lvl in self.down:
            for blk in lvl.block:
                y = blk(y)
            if hasattr(lvl, "downsample"):
                y = lvl.downsample(y)
        y = self.mid(y)
        return conv(self.conv_out, F.silu(self.norm_out(y)))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 out_ch: int = 3):
        super().__init__()
        c = ch * ch_mult[-1]
        self.conv_in = Conv(z_channels, c)
        self.mid = _Mid(c)
        levels = [None] * len(ch_mult)
        for i in reversed(range(len(ch_mult))):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(VAEResBlock(c, ch * ch_mult[i]))
                c = ch * ch_mult[i]
            levels[i] = _Level(blocks, _Upsample(c) if i > 0 else None,
                               "upsample")
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(32, c, 1e-6)
        self.conv_out = Conv(c, out_ch)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        y = self.mid(conv(self.conv_in, z))
        for lvl in reversed(self.up):
            for blk in lvl.block:
                y = blk(y)
            if hasattr(lvl, "upsample"):
                y = lvl.upsample(y)
        return conv(self.conv_out, F.silu(self.norm_out(y)))


class CondEncoder(nn.Module):
    """DiffBIR's condition encoder (keys ``cond_encoder.*``): a separately
    finetuned copy of the VAE encoder and ``quant_conv``; the hint latent is
    the distribution's mode times the SD scale factor."""

    def __init__(self, embed_dim: int = 4, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, scale_factor: float = 0.18215):
        super().__init__()
        self.embed_dim, self.scale_factor = embed_dim, scale_factor
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, embed_dim)
        self.quant_conv = Conv1x1(2 * embed_dim, 2 * embed_dim)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The deterministic (mode) encode, scaled."""
        h = conv(self.quant_conv, self.encoder(x))
        return h[..., :self.embed_dim] * self.scale_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode(x)


class AutoencoderKL(CondEncoder):
    """The VAE (keys ``first_stage_model.*``): the encoder of
    :class:`CondEncoder` and a decoder. DiffBIR decodes with it."""

    def __init__(self, embed_dim: int = 4, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, scale_factor: float = 0.18215):
        super().__init__(embed_dim, ch, ch_mult, num_res_blocks,
                         scale_factor)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, embed_dim)
        self.post_quant_conv = Conv1x1(embed_dim, embed_dim)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(conv(self.post_quant_conv, z / self.scale_factor))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))
