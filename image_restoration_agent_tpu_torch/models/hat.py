"""HAT (Hybrid Attention Transformer), channels-last (counterpart of
``image_restoration_agent_tpu/models/hat.py``; reference hat_arch.py).

conv_first -> patch LayerNorm -> [RHAG x D] -> conv_after_body (fused
LayerNorm) + residual -> SwinIR's pixel-shuffle head. Each RHAG is [HAB x
depth] + one OCAB + a 3x3 conv, with a residual. Module names are the
reference's state-dict names (``layers.0.residual_group.blocks.0.conv_block
.cab.0.weight``, ``...residual_group.overlap_attn.qkv.weight``), so a
reference state dict loads with ``strict=True`` once its
``relative_position_index_SA`` / ``_OCA`` buffers are dropped.

A HAB is ``x + attn(x) + CAB(LN1(x)) * conv_scale``, then the MLP:

- the attention half takes SwinIR's route rule (:func:`swinir.strip_route`):
  on the strip route :func:`ops.swin_block.swin_attn_block` with the roll
  folded into its reads (fast numerics in bf16) and :func:`ops.roll2d.
  roll2d` to undo a shift; on the partition route
  :func:`swinir.partition_attention` (``wmsa_block`` with the full mask);
- the CAB: two 3x3 convs on K3 (C -> C/compress -> C) with erf-GELU
  between them, then RCAN channel attention in plain PyTorch;
- the MLP: ``mlp_block`` (two K1) with erf-GELU, as the JAX package runs
  it through XLA.

The HAB has one ``norm1``; the JAX HAB holds two copies of it (its fused
attention layer's and the CAB branch's), which ``convert.from_jax``
checks are equal. OCAB runs in plain PyTorch, as the JAX package runs it
in XLA: query windows of ws x ws against zero-padded (ws + ws *
overlap_ratio)^2 key/value windows (``F.unfold``), with the reference's
wraparound relative-position indexing (:func:`rpi_oca`), its float32
logits made in chunks of windows.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import exact_f32
from ..ops.layernorm import layer_norm_lanes
from ..ops.roll2d import roll2d
from ..ops.swin_block import mlp_block, swin_attn_block
from ..ops.window_attention import window_partition, window_reverse
from .common import Conv, Conv1x1
from .registry import ModelSpec, register_model
from .swinir import (RGB_MEAN, PixelShuffleHead, SwinBlock, _Mlp,
                     _PatchEmbed, partition_attention)

_LOGITS_BYTES = 1 << 28  # OCAB's float32 logits per chunk of windows


@functools.lru_cache(maxsize=16)
def rpi_oca(ws: int, owin: int) -> np.ndarray:
    """(ws*ws, owin*owin) index into the (ws+owin-1)^2 bias table: the
    reference calculate_rpi_oca (hat_arch.py:896-919) exactly, including
    its negative raw indices (it shifts by ``ws - owin + 1`` and relies on
    torch's negative-index wraparound), reproduced with a modulo."""
    co = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    co = co.reshape(2, -1)
    ce = np.stack(np.meshgrid(np.arange(owin), np.arange(owin),
                              indexing="ij"))
    ce = ce.reshape(2, -1)
    rel = ce[:, None, :] - co[:, :, None]  # (2, ws*ws, owin*owin)
    rel = rel.transpose(1, 2, 0) + (ws - owin + 1)
    rel[:, :, 0] *= ws + owin - 1
    raw = rel.sum(-1)
    return np.mod(raw, (ws + owin - 1) ** 2).astype(np.int32)


class _ChannelAttention(nn.Module):
    """RCAN channel attention: mean over the canvas -> 1x1 -> ReLU -> 1x1
    -> sigmoid, scaling the channels (reference ``attention.1`` /
    ``attention.3``)."""

    def __init__(self, c: int, squeeze_factor: int):
        super().__init__()
        self.attention = nn.ModuleList([
            nn.Identity(), Conv1x1(c, c // squeeze_factor), nn.Identity(),
            Conv1x1(c // squeeze_factor, c)])

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        a = y.mean(dim=(1, 2), keepdim=True)
        a = torch.relu(self.attention[1](a))
        return y * torch.sigmoid(self.attention[3](a))


class CAB(nn.Module):
    """Channel-attention conv branch (reference CAB, ``conv_block.cab``):
    3x3 conv -> erf-GELU -> 3x3 conv -> channel attention. ``ln_pre``
    normalizes the input inside the first conv (K3's LayerNorm prologue:
    the HAB's norm1, zero padding applied to its output)."""

    def __init__(self, c: int, compress_ratio: int, squeeze_factor: int):
        super().__init__()
        self.cab = nn.ModuleList([
            Conv(c, c // compress_ratio), nn.Identity(),
            Conv(c // compress_ratio, c),
            _ChannelAttention(c, squeeze_factor)])

    def forward(self, x: torch.Tensor, ln_pre=None) -> torch.Tensor:
        y = F.gelu(self.cab[0](x, ln_pre=ln_pre))
        return self.cab[3](self.cab[2](y))


class HAB(SwinBlock):
    """Hybrid attention block: a Swin block's attention half (SwinBlock's
    parameters, route rule and weight forms) beside a CAB branch scaled by
    ``conv_scale``, then the MLP."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, compress_ratio: int = 3,
                 squeeze_factor: int = 30, conv_scale: float = 0.01,
                 mlp_ratio: float = 2.0):
        super().__init__(dim, num_heads, window_size, shift_size, mlp_ratio)
        self.conv_block = CAB(dim, compress_ratio, squeeze_factor)
        self.conv_scale = conv_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws = self.window_size
        shift = 0 if min(h, w) <= ws else self.shift_size
        p, ref = self.kernel_params(x), self.reference()
        conv_x = self.conv_block(x, ln_pre=(self.norm1.weight,
                                            self.norm1.bias))
        if self.strip(x):
            bank = self._mask_bank(shift, x.device) if shift > 0 else None
            y = swin_attn_block(x, p, num_heads=self.num_heads, ws=ws,
                                dc=-shift, mask_bank=bank,
                                fast=x.dtype == torch.bfloat16, ref=ref)
            if shift > 0:
                y = roll2d(y, shift, ws)
        else:
            y = partition_attention(x, p, num_heads=self.num_heads, ws=ws,
                                    shift=shift, ref=ref)
        x = torch.add(y, conv_x, alpha=self.conv_scale)
        return mlp_block(x.reshape(-1, c), *p.mlp,
                         params=ref.mlp).reshape(b, h, w, c)


class OCAB(nn.Module):
    """Overlapping cross-attention block (reference OCAB): ws x ws query
    windows attend to (owin x owin) key/value windows, owin = ws +
    int(ws * overlap_ratio), with a (ws + owin - 1)^2 bias table, then
    proj + residual and an erf-GELU MLP + residual."""

    def __init__(self, dim: int, window_size: int, overlap_ratio: float,
                 num_heads: int, mlp_ratio: float = 2.0):
        super().__init__()
        self.ws = window_size
        self.owin = int(window_size * overlap_ratio) + window_size
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((self.ws + self.owin - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def _linear(self, x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
        return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))

    def _norm(self, x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
        """LayerNorm with float32 statistics, output in ``x``'s dtype (one
        library kernel where ``layer_norm_lanes`` takes several passes)."""
        return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype),
                            ln.bias.to(x.dtype), ln.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and x.dtype == torch.float32:
            exact_f32()
        b, h, w, c = x.shape
        ws, owin, heads = self.ws, self.owin, self.num_heads
        hd = c // heads
        nh, nw = h // ws, w // ws
        m = owin * owin
        q, k, v = self._linear(self._norm(x, self.norm1), self.qkv).split(
            c, dim=-1)
        qw = window_partition(q, ws).reshape(-1, ws * ws, c)

        def unfold(t):  # zero-padded owin x owin windows at stride ws
            p = F.unfold(t.permute(0, 3, 1, 2), owin,
                         padding=(owin - ws) // 2, stride=ws)
            return p.reshape(b, c, m, nh * nw).permute(0, 3, 2, 1).reshape(
                b * nh * nw, m, c)

        idx = torch.from_numpy(rpi_oca(ws, owin).reshape(-1).astype(
            np.int64)).to(x.device)
        bias = self.relative_position_bias_table[idx].reshape(
            ws * ws, m, heads).permute(2, 0, 1).float()

        def heads_f32(t):  # (windows, N, C) -> (windows, heads, N, hd)
            return t.reshape(t.shape[0], t.shape[1], heads, hd).transpose(
                1, 2).to(torch.float32, memory_format=torch.contiguous_format)

        qh = heads_f32(qw * hd ** -0.5)
        kh, vh = heads_f32(unfold(k)), heads_f32(unfold(v))
        step = max(1, _LOGITS_BYTES // (heads * ws * ws * m * 4))
        chunks = []
        for i in range(0, qh.shape[0], step):
            s = torch.matmul(qh[i:i + step], kh[i:i + step].transpose(-1, -2))
            chunks.append(torch.matmul(torch.softmax(s.add_(bias), dim=-1),
                                       vh[i:i + step]))
        out = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
        out = out.to(x.dtype).transpose(1, 2).reshape(-1, ws, ws, c)
        out = window_reverse(out, ws, h, w)
        x = self._linear(out, self.proj) + x
        y = F.gelu(self._linear(self._norm(x, self.norm2), self.mlp.fc1))
        return x + self._linear(y, self.mlp.fc2)


class _AttenBlocks(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, overlap_ratio,
                 compress_ratio, squeeze_factor, conv_scale, mlp_ratio):
        super().__init__()
        self.blocks = nn.ModuleList([
            HAB(dim, num_heads, window_size,
                0 if i % 2 == 0 else window_size // 2, compress_ratio,
                squeeze_factor, conv_scale, mlp_ratio)
            for i in range(depth)])
        self.overlap_attn = OCAB(dim, window_size, overlap_ratio, num_heads,
                                 mlp_ratio)


class RHAG(nn.Module):
    """Residual hybrid attention group: HABs, one OCAB, a 3x3 conv and the
    group's residual."""

    def __init__(self, dim, depth, num_heads, window_size,
                 overlap_ratio=0.5, compress_ratio=3, squeeze_factor=30,
                 conv_scale=0.01, mlp_ratio=2.0):
        super().__init__()
        self.residual_group = _AttenBlocks(
            dim, depth, num_heads, window_size, overlap_ratio,
            compress_ratio, squeeze_factor, conv_scale, mlp_ratio)
        self.conv = Conv(dim, dim)

    def forward(self, x):
        res = x
        for blk in self.residual_group.blocks:
            x = blk(x)
        x = self.residual_group.overlap_attn(x)
        return self.conv(x, res=res)


class HAT(PixelShuffleHead, nn.Module):
    """Args mirror the reference constructor (hat_arch.py HAT). Input and
    output are (B, H, W, C) with H and W multiples of the window;
    ``packed_output`` as in :class:`swinir.SwinIR`."""

    def __init__(self, img_channels: int = 3, embed_dim: int = 180,
                 depths: Sequence[int] = (6,) * 6,
                 num_heads: Sequence[int] = (6,) * 6,
                 window_size: int = 16, overlap_ratio: float = 0.5,
                 compress_ratio: int = 3, squeeze_factor: int = 30,
                 conv_scale: float = 0.01, mlp_ratio: float = 2.0,
                 upscale: int = 4, num_feat: int = 64,
                 img_range: float = 1.0, packed_output: bool = False):
        super().__init__()
        self.img_range = img_range
        self.packed_output = packed_output
        self.conv_first = Conv(img_channels, embed_dim)
        self.patch_embed = _PatchEmbed(embed_dim, True)
        self.layers = nn.ModuleList([
            RHAG(embed_dim, d, h, window_size, overlap_ratio,
                 compress_ratio, squeeze_factor, conv_scale, mlp_ratio)
            for d, h in zip(depths, num_heads)])
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = Conv(embed_dim, embed_dim)
        self.init_pixelshuffle_head(embed_dim, num_feat, upscale,
                                    img_channels)

    def forward(self, x: torch.Tensor,
                packed_output: bool | None = None) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H*s, W*s, 3), or packed (B, H*s, W*s*3)."""
        packed = self.packed_output if packed_output is None \
            else packed_output
        if x.is_cuda and x.dtype == torch.float32:
            exact_f32()
        mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device)
        x = (x - mean) * self.img_range
        feat = self.conv_first(x)
        y = layer_norm_lanes(feat, self.patch_embed.norm.weight,
                             self.patch_embed.norm.bias)
        for layer in self.layers:
            y = layer(y)
        y = self.conv_after_body(y, res=feat,
                                 ln_pre=(self.norm.weight, self.norm.bias))
        y = self._pixelshuffle_head(self.conv_before_upsample(y), packed)
        if packed:
            return y / self.img_range + mean.repeat(y.shape[2] // 3)
        return y / self.img_range + mean


def _hat(**kw) -> HAT:
    return HAT(**kw)


# HAT x4 SR at full geometry (embed 180, 6 RHAG x 6 HAB, 6 heads, window
# 16), served in 256 px tiles.
register_model(ModelSpec(
    name="hat_sr_x4", build=_hat, subtasks=("super-resolution",), scale=4,
    pad_multiple=16, pad_mode="extra", pad_kind="symmetric", tile=256,
    tile_overlap=32, config=dict(),
))

# Tiny CPU-testable config.
register_model(ModelSpec(
    name="hat_tiny", build=_hat, subtasks=("super-resolution",), scale=4,
    pad_multiple=8, pad_mode="extra", pad_kind="symmetric", tile=None,
    config=dict(embed_dim=16, depths=(1, 1), num_heads=(2, 2),
                window_size=8, upscale=4, num_feat=16, compress_ratio=2,
                squeeze_factor=8),
))
