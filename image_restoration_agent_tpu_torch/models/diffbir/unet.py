"""The SD2.1-class UNet and ControlNet of DiffBIR, channels-last
(counterpart of ``image_restoration_agent_tpu/models/diffbir/unet.py``;
reference DiffBIR ``model/cldm.py`` over the LDM ``openaimodel`` UNet:
model_channels 320, channel_mult (1, 2, 4, 4), 2 res blocks a level,
spatial transformers (depth 1, head width 64, linear proj in and out) at
downsample factors 1, 2 and 4, context 77 x 1024).

State-dict names are the reference's: ``time_embed.{0,2}``,
``input_blocks.{i}.{j}`` (``.0.op`` the stride-2 downsample),
``middle_block.{0,1,2}``, ``output_blocks.{i}.{j}`` (``.conv`` the
upsample), ``out.{0,2}``; a ResBlock's ``in_layers.{0,2}``,
``emb_layers.1``, ``out_layers.{0,3}``, ``skip_connection``; a
SpatialTransformer's ``norm``, ``proj_in``, ``transformer_blocks.0``
(``attn1`` / ``attn2`` with ``to_q``, ``to_k``, ``to_v``, ``to_out.0``;
``norm1..3``; ``ff.net.0.proj``, ``ff.net.2``), ``proj_out``; the
ControlNet's ``zero_convs.{i}.0`` and ``middle_block_out.0``.

Numerics follow the JAX package, not the original code where they differ:
LayerNorm eps 1e-6 and the tanh GELU in GEGLU (Flax's defaults), ResBlock
GroupNorm eps 1e-5, the transformer's GroupNorm eps 1e-6. The sinusoidal
timestep embedding puts cos first. Self-attention is dense below
:data:`ops.chunked_attention.DENSE_SCORE_LIMIT` score entries (heads * N *
M) and chunked above, float32 logits, softmax and ``p @ v`` either way.

ControlNet concatenates the latent hint with x at its input, and a 1x1
zero conv taps every input block and the middle block; the UNet adds the
taps in reverse order: the middle tap after its middle block, then one
per skip connection. Every stride-1 3x3 conv runs through
:class:`models.common.Conv` (K3 on the card; a res block's second conv
takes the shortcut as K3's residual), the stride-2 downsample through the
library conv, the 1x1 convs as matmuls.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.chunked_attention import (DENSE_SCORE_LIMIT, chunked_attention,
                                      dense_attention)
from ..common import Conv, Conv1x1, ConvLib
from ..drbnet import nearest_up2
from .layers import GroupNorm, LayerNorm, Linear, conv


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """OpenAI-convention sinusoidal embedding, cos first: (B,) -> (B, dim)
    float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm(32, cin, 1e-5), nn.SiLU(),
                                       Conv(cin, cout))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_dim, cout))
        self.out_layers = nn.Sequential(GroupNorm(32, cout, 1e-5),
                                        nn.SiLU(), nn.Identity(),
                                        Conv(cout, cout))
        self.skip_connection = Conv1x1(cin, cout) if cin != cout else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        y = conv(self.in_layers[2], F.silu(self.in_layers[0](x)))
        e = self.emb_layers[1](F.silu(emb))
        y = y + e[:, None, None, :]
        skip = x if self.skip_connection is None \
            else conv(self.skip_connection, x)
        return conv(self.out_layers[3], F.silu(self.out_layers[0](y)),
                    res=skip)


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int,
                 head_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim))

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)

        def split(t):
            b, n, _ = t.shape
            return t.reshape(b, n, self.heads, self.head_dim).permute(
                0, 2, 1, 3)

        qh, kh, vh = split(q), split(k), split(v)
        n, m = qh.shape[-2], kh.shape[-2]
        if self.heads * n * m > DENSE_SCORE_LIMIT:
            out = chunked_attention(qh, kh, vh, self.head_dim ** -0.5)
        else:
            out = dense_attention(qh * self.head_dim ** -0.5, kh, vh)
        b = x.shape[0]
        out = out.permute(0, 2, 1, 3).reshape(b, n, -1).to(x.dtype)
        return self.to_out[0](out)


class _GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate, approximate="tanh")


class _FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.Sequential(_GEGLU(dim, 4 * dim), nn.Identity(),
                                 Linear(4 * dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int,
                 head_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, head_dim)
        self.ff = _FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, head_dim)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, c: int, context_dim: int, head_dim: int):
        super().__init__()
        self.norm = GroupNorm(32, c, 1e-6)
        self.proj_in = Linear(c, c)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(c, context_dim, c // head_dim, head_dim)])
        self.proj_out = Linear(c, c)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.proj_in(self.norm(x).reshape(b, h * w, c))
        for blk in self.transformer_blocks:
            y = blk(y, context)
        y = self.proj_out(y)
        return x + y.reshape(b, h, w, c)


class Downsample(nn.Module):
    """Stride-2 3x3 conv, pad 1 (reference ``op``)."""

    def __init__(self, c: int):
        super().__init__()
        self.op = ConvLib(c, c, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self.op, x)


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self.conv, nearest_up2(x))


def _run_entry(entry: nn.ModuleList, h: torch.Tensor, emb: torch.Tensor,
               context: torch.Tensor) -> torch.Tensor:
    """One ``input_blocks`` / ``output_blocks`` entry: its modules in
    order, each given what it takes."""
    for mod in entry:
        if isinstance(mod, ResBlock):
            h = mod(h, emb)
        elif isinstance(mod, SpatialTransformer):
            h = mod(h, context)
        elif isinstance(mod, Conv):
            h = conv(mod, h)
        else:
            h = mod(h)
    return h


class _UNetCore(nn.Module):
    """The timestep MLP, encoder and middle shared by UNet and ControlNet."""

    def __init__(self, in_channels: int, model_channels: int,
                 channel_mult: Sequence[int], num_res_blocks: int,
                 attention_ds: Sequence[int], num_head_channels: int,
                 context_dim: int):
        super().__init__()
        mc = model_channels
        self.model_channels = mc
        emb = 4 * mc
        self.time_embed = nn.Sequential(Linear(mc, emb), nn.SiLU(),
                                        Linear(emb, emb))
        blocks = [nn.ModuleList([Conv(in_channels, mc)])]
        chans, c, ds = [mc], mc, 1
        for li, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                entry = [ResBlock(c, mc * mult, emb)]
                c = mc * mult
                if ds in attention_ds:
                    entry.append(SpatialTransformer(c, context_dim,
                                                    num_head_channels))
                blocks.append(nn.ModuleList(entry))
                chans.append(c)
            if li < len(channel_mult) - 1:
                blocks.append(nn.ModuleList([Downsample(c)]))
                chans.append(c)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = nn.ModuleList([
            ResBlock(c, c, emb),
            SpatialTransformer(c, context_dim, num_head_channels),
            ResBlock(c, c, emb)])
        self._chans, self._c, self._ds = chans, c, ds

    def embed(self, t: torch.Tensor) -> torch.Tensor:
        temb = timestep_embedding(t, self.model_channels)
        return self.time_embed[2](F.silu(self.time_embed[0](temb)))

    def middle(self, h: torch.Tensor, emb: torch.Tensor,
               context: torch.Tensor) -> torch.Tensor:
        return _run_entry(self.middle_block, h, emb, context)


class UNetModel(_UNetCore):
    """The denoiser (keys ``model.diffusion_model.*``)."""

    def __init__(self, model_channels: int = 320,
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2,
                 attention_ds: Sequence[int] = (1, 2, 4),
                 num_head_channels: int = 64, in_channels: int = 4,
                 out_channels: int = 4, context_dim: int = 1024):
        super().__init__(in_channels, model_channels, channel_mult,
                         num_res_blocks, attention_ds, num_head_channels,
                         context_dim)
        mc, emb = model_channels, 4 * model_channels
        chans, c, ds = list(self._chans), self._c, self._ds
        blocks = []
        for li, mult in reversed(list(enumerate(channel_mult))):
            for bi in range(num_res_blocks + 1):
                entry = [ResBlock(c + chans.pop(), mc * mult, emb)]
                c = mc * mult
                if ds in attention_ds:
                    entry.append(SpatialTransformer(c, context_dim,
                                                    num_head_channels))
                if li > 0 and bi == num_res_blocks:
                    entry.append(Upsample(c))
                blocks.append(nn.ModuleList(entry))
            if li > 0:
                ds //= 2
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.Sequential(GroupNorm(32, c, 1e-5), nn.SiLU(),
                                 Conv(c, out_channels))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor, control=None) -> torch.Tensor:
        emb = self.embed(t)
        h, skips = x, []
        for entry in self.input_blocks:
            h = _run_entry(entry, h, emb, context)
            skips.append(h)
        h = self.middle(h, emb, context)
        control = None if control is None else list(control)
        if control is not None:
            h = h + control.pop()
        for entry in self.output_blocks:
            skip = skips.pop()
            if control is not None:
                skip = skip + control.pop()
            dt = torch.promote_types(h.dtype, skip.dtype)
            h = torch.cat([h.to(dt), skip.to(dt)], dim=-1)
            h = _run_entry(entry, h, emb, context)
        return conv(self.out[2], F.silu(self.out[0](h)))


class ControlNet(_UNetCore):
    """DiffBIR v1's ControlNet (keys ``control_model.*``): the latent hint
    concatenated with x at the input (the first conv takes in_channels +
    hint_channels), a zero conv after every input block and after the
    middle block. Returns the taps in that order."""

    def __init__(self, model_channels: int = 320,
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2,
                 attention_ds: Sequence[int] = (1, 2, 4),
                 num_head_channels: int = 64, in_channels: int = 4,
                 hint_channels: int = 4, context_dim: int = 1024):
        super().__init__(in_channels + hint_channels, model_channels,
                         channel_mult, num_res_blocks, attention_ds,
                         num_head_channels, context_dim)
        self.zero_convs = nn.ModuleList(
            [nn.Sequential(Conv1x1(c, c)) for c in self._chans])
        self.middle_block_out = nn.Sequential(Conv1x1(self._c, self._c))

    def forward(self, x: torch.Tensor, hint: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor) -> list[torch.Tensor]:
        emb = self.embed(t)
        dt = torch.promote_types(x.dtype, hint.dtype)
        h = torch.cat([x.to(dt), hint.to(dt)], dim=-1)
        taps = []
        for entry, zc in zip(self.input_blocks, self.zero_convs):
            h = _run_entry(entry, h, emb, context)
            taps.append(conv(zc[0], h))
        h = self.middle(h, emb, context)
        taps.append(conv(self.middle_block_out[0], h))
        return taps
