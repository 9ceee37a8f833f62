"""Restormer, channels-last, with the reference parameter names
(counterpart of ``image_restoration_agent_tpu/models/restormer.py``;
reference ``restormer_arch.py``).

A 4-level U-shape of TransformerBlocks (MDTA transposed channel attention
and the gated-dconv FFN), pixel-unshuffle downs and pixel-shuffle ups, a
refinement stage and a global residual. Each block takes the route the
JAX package gives it: where both its MDTA (3C) and GDFN (2*hidden) widths
pass :func:`ops.restormer_fused.restormer_fused_supported`, the fused
route (on the card K5 ``mdta_front`` then K4 ``gdfn_block``; a failure to
build or launch raises); elsewhere the unfused route, the JAX package's
XLA route written as plain PyTorch. The 3x3 convs run through
:class:`models.common.Conv` (K3 on the card).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.gates import gated_gelu
from ..ops.mdta import mdta_attention
from ..ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from ..ops.restormer_fused import (gdfn_block, gdfn_weights, mdta_block,
                                   mdta_weights, restormer_fused_supported)
from .common import Conv, Conv1x1, DWConv, RestormerLayerNorm, cache_key
from .registry import ModelSpec, register_model


class Attention(nn.Module):
    """MDTA: qkv 1x1, depthwise 3x3, transposed attention, project_out."""

    def __init__(self, dim: int, num_heads: int, bias: bool):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Conv1x1(dim, dim * 3, bias)
        self.qkv_dwconv = DWConv(dim * 3, bias)
        self.project_out = Conv1x1(dim, dim, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=-1)
        out = mdta_attention(q, k, v, self.temperature, self.num_heads)
        return self.project_out(out)


class FeedForward(nn.Module):
    """GDFN: project_in 1x1, depthwise 3x3, gelu gate, project_out."""

    def __init__(self, dim: int, expansion: float, bias: bool):
        super().__init__()
        self.hidden = int(dim * expansion)
        self.project_in = Conv1x1(dim, self.hidden * 2, bias)
        self.dwconv = DWConv(self.hidden * 2, bias)
        self.project_out = Conv1x1(self.hidden, dim, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project_out(gated_gelu(self.dwconv(self.project_in(x))))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, expansion: float,
                 bias: bool, bias_free_ln: bool):
        super().__init__()
        self.norm1 = RestormerLayerNorm(dim, bias_free_ln)
        self.attn = Attention(dim, num_heads, bias)
        self.norm2 = RestormerLayerNorm(dim, bias_free_ln)
        self.ffn = FeedForward(dim, expansion, bias)
        self._prepared: tuple | None = None

    def fused(self, x: torch.Tensor) -> bool:
        """The JAX package's routing (``models/restormer.py:158-159``)."""
        _, h, w, c = x.shape
        return (restormer_fused_supported(h, w, c, 3 * c)
                and restormer_fused_supported(h, w, c, 2 * self.ffn.hidden))

    def mdta_params(self) -> tuple:
        """:func:`ops.restormer_fused.mdta_block_plain`'s (ln, w_qkv, b_qkv,
        w_dw, b_dw, w_proj, b_proj, temperature), views of the parameters."""
        a = self.attn
        return (self.norm1.params(), a.qkv.matrix(), a.qkv.bias,
                a.qkv_dwconv.taps(), a.qkv_dwconv.bias,
                a.project_out.matrix(), a.project_out.bias, a.temperature)

    def gdfn_params(self) -> tuple:
        """:func:`ops.restormer_fused.gdfn_block_plain`'s (ln, w_in, b_in,
        w_dw, b_dw, w_out, b_out), views of the parameters."""
        f = self.ffn
        return (self.norm2.params(), f.project_in.matrix(),
                f.project_in.bias, f.dwconv.taps(), f.dwconv.bias,
                f.project_out.matrix(), f.project_out.bias)

    def kernel_weights(self, x: torch.Tensor):
        """The fused blocks' kernel forms for ``x``'s dtype and device, made
        once and kept while the parameters are unchanged."""
        key = cache_key(x, list(self.parameters()))
        if self._prepared is None or self._prepared[0] != key:
            mw = mdta_weights(*self.mdta_params(), self.attn.num_heads,
                              x.dtype)
            gw = gdfn_weights(*self.gdfn_params(), x.dtype)
            self._prepared = (key, mw, gw)
        return self._prepared[1:]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused(x):
            # the forms are side inputs; the parameters' views are what
            # autograd differentiates (ops/autograd.py)
            mw, gw = self.kernel_weights(x)
            x = mdta_block(x, mw, self.mdta_params())
            return gdfn_block(x, gw, fast=x.dtype == torch.bfloat16,
                              params=self.gdfn_params())
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class Downsample(nn.Module):
    """3x3 conv C -> C/2, then pixel-unshuffle(2): C -> 2C at half size."""

    def __init__(self, c: int):
        super().__init__()
        self.body = nn.ModuleList([Conv(c, c // 2, bias=False)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_unshuffle(self.body[0](x), 2)


class Upsample(nn.Module):
    """3x3 conv C -> 2C, then pixel-shuffle(2): C -> C/2 at double size."""

    def __init__(self, c: int):
        super().__init__()
        self.body = nn.ModuleList([Conv(c, c * 2, bias=False)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(self.body[0](x), 2)


class _PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, bias: bool):
        super().__init__()
        self.proj = Conv(cin, dim, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class Restormer(nn.Module):
    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 bias_free_ln: bool = False, dual_pixel_task: bool = False):
        super().__init__()

        def stage(c, level, count):
            return nn.Sequential(*[TransformerBlock(
                c, heads[level], ffn_expansion_factor, bias, bias_free_ln)
                for _ in range(count)])

        d = dim
        self.dual_pixel_task = dual_pixel_task
        self.patch_embed = _PatchEmbed(inp_channels, d, bias)
        self.encoder_level1 = stage(d, 0, num_blocks[0])
        self.down1_2 = Downsample(d)
        self.encoder_level2 = stage(d * 2, 1, num_blocks[1])
        self.down2_3 = Downsample(d * 2)
        self.encoder_level3 = stage(d * 4, 2, num_blocks[2])
        self.down3_4 = Downsample(d * 4)
        self.latent = stage(d * 8, 3, num_blocks[3])
        self.up4_3 = Upsample(d * 8)
        self.reduce_chan_level3 = Conv1x1(d * 8, d * 4, bias)
        self.decoder_level3 = stage(d * 4, 2, num_blocks[2])
        self.up3_2 = Upsample(d * 4)
        self.reduce_chan_level2 = Conv1x1(d * 4, d * 2, bias)
        self.decoder_level2 = stage(d * 2, 1, num_blocks[1])
        self.up2_1 = Upsample(d * 2)
        self.decoder_level1 = stage(d * 2, 0, num_blocks[0])
        self.refinement = stage(d * 2, 0, num_refinement_blocks)
        if dual_pixel_task:
            self.skip_conv = Conv1x1(d, d * 2, bias)
        self.output = Conv(d * 2, out_channels, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, inp_channels) -> (B, H, W, out_channels); H and W
        multiples of 8. Records a graph where grad is enabled (training);
        the Engine serves under ``torch.no_grad()``."""
        e1_in = self.patch_embed(x)
        e1 = self.encoder_level1(e1_in)
        e2 = self.encoder_level2(self.down1_2(e1))
        e3 = self.encoder_level3(self.down2_3(e2))
        latent = self.latent(self.down3_4(e3))

        y = torch.cat([self.up4_3(latent), e3], dim=-1)
        y = self.decoder_level3(self.reduce_chan_level3(y))
        y = torch.cat([self.up3_2(y), e2], dim=-1)
        y = self.decoder_level2(self.reduce_chan_level2(y))
        y = torch.cat([self.up2_1(y), e1], dim=-1)
        y = self.refinement(self.decoder_level1(y))
        if self.dual_pixel_task:
            return self.output(y + self.skip_conv(e1_in))
        return self.output(y) + x


register_model(ModelSpec(
    name="restormer",
    build=lambda **kw: Restormer(**kw),
    subtasks=("denoising", "motion deblurring", "defocus deblurring",
              "deraining"),
    pad_multiple=8,
    pad_kind="reflect",
    # whole-image forward below max_size (the reference Restormer services
    # default to tile=None); larger canvases fall back to the tile grid
    tile=None, tile_overlap=32,
    max_size=1536, fallback_tile=256,
    # every U-Net level (/1 .. /8) keeps dims divisible by 8: the fused
    # blocks' shape rule
    whole_pad_multiple=64,
    config=dict(),
))

register_model(ModelSpec(
    name="restormer_tiny",  # CPU-testable configuration
    build=lambda **kw: Restormer(**kw),
    subtasks=("denoising",),
    pad_multiple=8,
    pad_kind="reflect",
    tile=None,
    config=dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                heads=(1, 1, 2, 2), ffn_expansion_factor=2.0),
))
