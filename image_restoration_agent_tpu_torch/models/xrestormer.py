"""X-Restormer, channels-last, with the reference parameter names
(counterpart of ``image_restoration_agent_tpu/models/xrestormer.py``;
reference ``xrestormer_arch.py``).

Restormer's 4-level U-shape, where each block runs four stages: MDTA
channel attention and a GDFN, then OCAB (overlapping cross-attention over
windows) and a second GDFN. The channel half takes Restormer's routes: where
the block's MDTA (3C) and GDFN (2*hidden) widths pass
:func:`ops.restormer_fused.restormer_fused_supported`, K5 ``mdta_front``
then K4 ``gdfn_block`` on the card, and K4 again after OCAB; elsewhere the
plain MDTA and GDFN of :mod:`models.restormer`. OCAB is plain PyTorch, as
the JAX package computes it outside any Pallas kernel. The 3x3 convs run
through :class:`models.common.Conv` (K3 on the card).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.restormer_fused import (gdfn_block, gdfn_weights, mdta_block,
                                   mdta_weights, restormer_fused_supported)
from .common import Conv, Conv1x1, RestormerLayerNorm, cache_key
from .registry import ModelSpec, register_model
from .restormer import (Attention, Downsample, FeedForward, Upsample,
                        _PatchEmbed)


@functools.lru_cache(maxsize=32)
def _relpos_gather_index(ws: int, owin: int) -> np.ndarray:
    """``idx[q, k] = k - q + owin - 1``: the row of a (2 * owin - 1) table
    for query offset q and key offset k (the reference ``rel_to_abs``)."""
    q = np.arange(ws)[:, None]
    k = np.arange(owin)[None, :]
    return (k - q + owin - 1).astype(np.int64)


class _RelPosEmb(nn.Module):
    """The decomposed relative position tables, (2 * owin - 1, dim_head)
    each (reference ``RelPosEmb``)."""

    def __init__(self, owin: int, dim_head: int):
        super().__init__()
        self.rel_height = nn.Parameter(torch.empty(2 * owin - 1, dim_head))
        self.rel_width = nn.Parameter(torch.empty(2 * owin - 1, dim_head))


class OCAB(nn.Module):
    """Overlapping cross-attention: queries from ws x ws windows, keys and
    values from the zero-padded owin x owin windows at stride ws
    (``F.unfold``), a decomposed relative position bias. Logits, bias,
    softmax and the product with v in float32 (the JAX package's
    ``preferred_element_type``), one cast to ``x``'s dtype at the end."""

    def __init__(self, dim: int, window_size: int, overlap_ratio: float,
                 num_heads: int, dim_head: int, bias: bool = False):
        super().__init__()
        self.ws = window_size
        self.owin = int(window_size * overlap_ratio) + window_size
        self.num_heads, self.dim_head = num_heads, dim_head
        inner = num_heads * dim_head
        self.qkv = Conv1x1(dim, 3 * inner, bias)
        self.project_out = Conv1x1(inner, dim, bias)
        self.rel_pos_emb = _RelPosEmb(self.owin, dim_head)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        ws, owin, hd, d = self.ws, self.owin, self.num_heads, self.dim_head
        inner = hd * d
        nh, nw = h // ws, w // ws
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q = q.reshape(b, nh, ws, nw, ws, inner).permute(0, 1, 3, 2, 4, 5)
        q = q.reshape(-1, ws * ws, inner)

        def unfold(t):  # (c, i, j) feature order, windows row-major
            p = F.unfold(t.permute(0, 3, 1, 2), owin, stride=ws,
                         padding=(owin - ws) // 2)
            return p.reshape(b, inner, owin * owin, nh * nw).permute(
                0, 3, 2, 1).reshape(-1, owin * owin, inner)

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], hd, d).transpose(1, 2)

        qs = heads(q) * d ** -0.5             # in x's dtype, as the JAX
        kh, vh = heads(unfold(k)), heads(unfold(v))   # package scales q
        qf = qs.float()
        attn = qf @ kh.float().transpose(-1, -2)
        idx = torch.from_numpy(_relpos_gather_index(ws, owin)).to(x.device)
        rw = self.rel_pos_emb.rel_width[idx].to(x.dtype).float()
        rh = self.rel_pos_emb.rel_height[idx].to(x.dtype).float()
        q5 = qf.reshape(-1, hd, ws, ws, d)
        bias_w = torch.einsum("whxyd,yjd->whxyj", q5, rw)
        bias_h = torch.einsum("whxyd,xid->whxyi", q5, rh)
        bias = bias_w[:, :, :, :, None, :] + bias_h[:, :, :, :, :, None]
        attn = attn + bias.reshape(-1, hd, ws * ws, owin * owin)
        out = torch.softmax(attn, dim=-1) @ vh.float()
        out = out.to(x.dtype).transpose(1, 2).reshape(b, nh, nw, ws, ws,
                                                      inner)
        out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, inner)
        return self.project_out(out)


class XTransformerBlock(nn.Module):
    """MDTA + GDFN, then OCAB + GDFN (reference ``TransformerBlock``)."""

    def __init__(self, dim: int, window_size: int, overlap_ratio: float,
                 num_channel_heads: int, num_spatial_heads: int,
                 spatial_dim_head: int, expansion: float, bias: bool,
                 bias_free_ln: bool):
        super().__init__()
        self.norm1 = RestormerLayerNorm(dim, bias_free_ln)
        self.channel_attn = Attention(dim, num_channel_heads, bias)
        self.norm2 = RestormerLayerNorm(dim, bias_free_ln)
        self.channel_ffn = FeedForward(dim, expansion, bias)
        self.norm3 = RestormerLayerNorm(dim, bias_free_ln)
        self.spatial_attn = OCAB(dim, window_size, overlap_ratio,
                                 num_spatial_heads, spatial_dim_head, bias)
        self.norm4 = RestormerLayerNorm(dim, bias_free_ln)
        self.spatial_ffn = FeedForward(dim, expansion, bias)
        self._prepared: tuple | None = None

    def fused(self, x: torch.Tensor) -> bool:
        """The JAX package's routing (``models/xrestormer.py:145-147``),
        Restormer's rule."""
        _, h, w, c = x.shape
        return (restormer_fused_supported(h, w, c, 3 * c)
                and restormer_fused_supported(h, w, c,
                                              2 * self.channel_ffn.hidden))

    def mdta_params(self) -> tuple:
        """:func:`ops.restormer_fused.mdta_block_plain`'s (ln, w_qkv, b_qkv,
        w_dw, b_dw, w_proj, b_proj, temperature), views of the parameters."""
        a = self.channel_attn
        return (self.norm1.params(), a.qkv.matrix(), a.qkv.bias,
                a.qkv_dwconv.taps(), a.qkv_dwconv.bias,
                a.project_out.matrix(), a.project_out.bias, a.temperature)

    def gdfn_params(self, spatial: bool) -> tuple:
        """:func:`ops.restormer_fused.gdfn_block_plain`'s (ln, w_in, b_in,
        w_dw, b_dw, w_out, b_out) of the channel (or spatial) GDFN, views of
        the parameters."""
        ln, f = ((self.norm4, self.spatial_ffn) if spatial
                 else (self.norm2, self.channel_ffn))
        return (ln.params(), f.project_in.matrix(), f.project_in.bias,
                f.dwconv.taps(), f.dwconv.bias, f.project_out.matrix(),
                f.project_out.bias)

    def kernel_weights(self, x: torch.Tensor):
        """The fused blocks' kernel forms (MDTA, channel GDFN, spatial
        GDFN) for ``x``'s dtype and device, kept while the parameters are
        unchanged."""
        key = cache_key(x, list(self.parameters()))
        if self._prepared is None or self._prepared[0] != key:
            mw = mdta_weights(*self.mdta_params(),
                              self.channel_attn.num_heads, x.dtype)
            gws = tuple(gdfn_weights(*self.gdfn_params(spatial), x.dtype)
                        for spatial in (False, True))
            self._prepared = (key, mw, *gws)
        return self._prepared[1:]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fast = x.dtype == torch.bfloat16
        fused = self.fused(x)
        if fused:
            # the forms are side inputs; the parameters' views are what
            # autograd differentiates (ops/autograd.py)
            mw, gw1, gw2 = self.kernel_weights(x)
            x = gdfn_block(mdta_block(x, mw, self.mdta_params()), gw1,
                           fast=fast, params=self.gdfn_params(False))
        else:
            x = x + self.channel_attn(self.norm1(x))
            x = x + self.channel_ffn(self.norm2(x))
        x = x + self.spatial_attn(self.norm3(x))
        if fused:
            return gdfn_block(x, gw2, fast=fast,
                              params=self.gdfn_params(True))
        return x + self.spatial_ffn(self.norm4(x))


class XRestormer(nn.Module):
    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 channel_heads: Sequence[int] = (1, 2, 4, 8),
                 spatial_heads: Sequence[int] = (2, 2, 3, 4),
                 overlap_ratio: Sequence[float] = (0.5, 0.5, 0.5, 0.5),
                 window_size: int = 8, spatial_dim_head: int = 16,
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 bias_free_ln: bool = False):
        super().__init__()

        def stage(c, level, count):
            return nn.Sequential(*[XTransformerBlock(
                c, window_size, overlap_ratio[level], channel_heads[level],
                spatial_heads[level], spatial_dim_head,
                ffn_expansion_factor, bias, bias_free_ln)
                for _ in range(count)])

        d = dim
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
        self.output = Conv(d * 2, out_channels, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, inp_channels) -> (B, H, W, out_channels); H and W
        multiples of 8 x the window."""
        e1 = self.encoder_level1(self.patch_embed(x))
        e2 = self.encoder_level2(self.down1_2(e1))
        e3 = self.encoder_level3(self.down2_3(e2))
        latent = self.latent(self.down3_4(e3))

        y = torch.cat([self.up4_3(latent), e3], dim=-1)
        y = self.decoder_level3(self.reduce_chan_level3(y))
        y = torch.cat([self.up3_2(y), e2], dim=-1)
        y = self.decoder_level2(self.reduce_chan_level2(y))
        y = torch.cat([self.up2_1(y), e1], dim=-1)
        y = self.refinement(self.decoder_level1(y))
        return self.output(y) + x


register_model(ModelSpec(
    name="xrestormer",
    build=lambda **kw: XRestormer(**kw),
    subtasks=("super-resolution", "denoising", "dehazing",
              "motion deblurring", "deraining"),
    pad_multiple=64,  # window 8 at the deepest (1/8) level
    pad_kind="reflect",
    tile=256, tile_overlap=32,
    config=dict(),
))

register_model(ModelSpec(
    name="xrestormer_tiny",  # CPU-testable configuration
    build=lambda **kw: XRestormer(**kw),
    subtasks=("denoising",),
    pad_multiple=64, pad_kind="reflect",
    tile=None,
    config=dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                channel_heads=(1, 1, 1, 1), spatial_heads=(1, 1, 1, 1),
                spatial_dim_head=8, ffn_expansion_factor=2.0),
))
