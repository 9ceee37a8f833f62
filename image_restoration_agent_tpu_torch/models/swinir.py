"""SwinIR, channels-last (counterpart of
``image_restoration_agent_tpu/models/swinir.py``; reference
network_swinir.py).

conv_first -> [RSTB x D] (each: [Swin block x d] + conv + residual) ->
conv_after_body (fused LayerNorm) + residual -> task head. Module names
are the reference (KAIR) state-dict names, so a reference state dict loads
with ``load_state_dict(..., strict=True)`` (the ``relative_position_index``
and ``attn_mask`` buffers of reference checkpoints are not parameters here;
drop them first, as the JAX converter does).

A Swin block takes one of two routes, by the JAX package's rule on the
TPU (:func:`strip_route`, ``models/swinir.py:175-186`` there):

- the strip route, :func:`ops.swin_block.swin_block` with the cyclic shift
  folded into its reads: a block's output stays in the rolled frame
  (-shift), the next block reads with ``dc = -shift - in_frame``, and the
  RSTB's closing conv undoes the last frame with ``roll=-frame``. bfloat16
  inputs take the fast numerics, float32 the exact ones;
- the partition route (:func:`partition_attention`, then ``mlp_block``
  with erf-GELU), exact numerics in both dtypes, frames always 0: where
  the canvas is wider than 384 with no strip chunk width (whole-image
  denoising at 1088x1928), and for an odd window (``swinir_jpeg_40``,
  window 7), which the JAX package sends to XLA with the same math.

``unshuffle_scale`` r > 1 (DiffBIR's stage 1) pixel-unshuffles the input by
r before ``conv_first``, which is then the reference's
``Sequential(PixelUnshuffle(r), Conv2d)`` (state-dict name
``conv_first.1``).

On the card that is the kernels; on the CPU, their plain versions.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch import nn

from ..device import exact_f32
from ..ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from ..ops.swin_block import (SwinBlockRef, mlp_block, prepare_swin_params,
                              strip_chunk_width, swin_block, wmsa_block)
from ..ops.window_attention import (shift_attention_mask, window_partition,
                                    window_reverse)
from .common import (Conv, cache_key, conv_plain, fused_pixelshuffle_head,
                     head_weights, layer_norm_lanes, tail_weights,
                     upsample_tail)
from .registry import ModelSpec, register_model

RGB_MEAN = (0.4488, 0.4371, 0.4040)  # DIV2K mean (network_swinir.py:716)


def strip_route(b: int, h: int, w: int, ws: int) -> bool:
    """The JAX package's route rule on the TPU (``pallas_block``): a block
    of a (b, h, w) canvas takes the strip kernel when the window is even,
    the token count a multiple of 8 (``_pallas_supported``), h and w are
    multiples of the window and the width is at most 384 or has a strip
    chunk width; else the partition route. HAT's HAB takes the same rule
    (``models/hat.py:108-111`` there)."""
    return (ws % 2 == 0 and (b * h * w) % 8 == 0 and h % ws == 0
            and w % ws == 0
            and (w <= 384 or strip_chunk_width(w, ws) is not None))


@functools.lru_cache(maxsize=4)
def full_shift_mask(h: int, w: int, ws: int, shift: int,
                    device: torch.device) -> torch.Tensor | None:
    """The (nW, N, N) float32 shift mask of an (h, w) canvas on ``device``
    (None without a shift), made once per shape and shared by the blocks
    (537 MB at 1088x1928, window 8)."""
    m = shift_attention_mask(h, w, ws, shift)
    return None if m is None else torch.from_numpy(m).to(device)


def partition_attention(x: torch.Tensor, p, *, num_heads: int, ws: int,
                        shift: int, ref: SwinBlockRef | None = None
                        ) -> torch.Tensor:
    """The attention half on the partition route (the JAX package's
    ``models/swinir.py:217-229``): roll by -shift, window partition,
    :func:`ops.swin_block.wmsa_block` with the full shift mask (gradients
    reaching ``ref``), window reverse, roll back. Output in frame 0, in
    ``x``'s dtype."""
    _, h, w, c = x.shape
    y = torch.roll(x, (-shift, -shift), dims=(1, 2)) if shift else x
    yw = window_partition(y, ws).reshape(-1, ws * ws, c)
    yw = wmsa_block(yw, p, num_heads=num_heads,
                    mask=full_shift_mask(h, w, ws, shift, x.device), ref=ref)
    y = window_reverse(yw.reshape(-1, ws, ws, c), ws, h, w)
    return torch.roll(y, (shift, shift), dims=(1, 2)) if shift else y


class _WindowAttention(nn.Module):
    def __init__(self, dim: int, ws: int, num_heads: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * ws - 1) ** 2, num_heads))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlock(nn.Module):
    """One Swin transformer block (reference SwinTransformerBlock)."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, mlp_ratio: float = 2.0):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim)
        self.attn = _WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))
        self._prepared: tuple | None = None
        self._bank: tuple | None = None

    def reference(self) -> SwinBlockRef:
        """This block's parameters as the kernels' wrappers take them
        (their ``ref``: what the gradients reach)."""
        a, m = self.attn, self.mlp
        return SwinBlockRef(
            self.norm1.weight, self.norm1.bias, a.qkv.weight, a.qkv.bias,
            a.proj.weight, a.proj.bias, a.relative_position_bias_table,
            self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
            m.fc2.weight, m.fc2.bias)

    def kernel_params(self, x: torch.Tensor):
        """This block's weights in kernel form for ``x``'s dtype/device,
        kept while the parameters are unchanged (a constant side input of
        the wrappers; the gradients go to :meth:`reference`)."""
        tensors = list(self.parameters())
        key = cache_key(x, tensors)
        if self._prepared is None or self._prepared[0] != key:
            p = prepare_swin_params(
                **self.reference()._asdict(), num_heads=self.num_heads,
                ws=self.window_size, dtype=x.dtype)
            self._prepared = (key, p)
        return self._prepared[1]

    def _mask_bank(self, shift: int, device) -> torch.Tensor:
        """The (2, 2, N, N) shift-mask bank, kept on the device."""
        if self._bank is None or self._bank[0] != (shift, device):
            ws = self.window_size
            n = ws * ws
            bank = shift_attention_mask(2 * ws, 2 * ws, ws, shift)
            self._bank = ((shift, device), torch.from_numpy(
                bank.reshape(2, 2, n, n)).to(device))
        return self._bank[1]

    def strip(self, x: torch.Tensor) -> bool:
        """True if this block takes the strip route for ``x``, False for
        the partition route (:func:`strip_route`)."""
        b, h, w, _ = x.shape
        return strip_route(b, h, w, self.window_size)

    def forward(self, x: torch.Tensor, in_frame: int = 0):
        """Returns (y, out_frame): on the strip route y stays in the rolled
        frame -shift; on the partition route frames are 0."""
        b, h, w, c = x.shape
        ws = self.window_size
        # no shift when the canvas is not larger than one window
        # (reference SwinTransformerBlock.__init__)
        shift = 0 if min(h, w) <= ws else self.shift_size
        p, ref = self.kernel_params(x), self.reference()
        if self.strip(x):
            bank = self._mask_bank(shift, x.device) if shift > 0 else None
            y = swin_block(x, p, num_heads=self.num_heads, ws=ws,
                           dc=-shift - in_frame, mask_bank=bank,
                           fast=x.dtype == torch.bfloat16, ref=ref)
            return y, -shift
        if in_frame:
            raise ValueError("frames only flow on the strip route")
        y = partition_attention(x, p, num_heads=self.num_heads, ws=ws,
                                shift=shift, ref=ref)
        y = mlp_block(y.reshape(-1, c), *p.mlp, out_dtype=x.dtype,
                      params=ref.mlp)
        return y.reshape(b, h, w, c), 0


class _BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio)
            for i in range(depth)])


class RSTB(nn.Module):
    """Residual Swin transformer block: the blocks chain their frames and
    the closing conv undoes the last one (fused roll) and adds the
    residual."""

    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio=2.0):
        super().__init__()
        self.residual_group = _BasicLayer(dim, depth, num_heads,
                                          window_size, mlp_ratio)
        self.conv = Conv(dim, dim)

    def forward(self, x):
        res, frame = x, 0
        for blk in self.residual_group.blocks:
            x, frame = blk(x, frame)
        return self.conv(x, res=res, roll=-frame)


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch_norm: bool):
        super().__init__()
        self.norm = nn.LayerNorm(dim) if patch_norm else None


class _Shuffle(nn.Module):
    def __init__(self, r: int):
        super().__init__()
        self.r = r

    def forward(self, x):
        return pixel_shuffle(x, self.r)


class _Unshuffle(nn.Module):
    def __init__(self, r: int):
        super().__init__()
        self.r = r

    def forward(self, x):
        return pixel_unshuffle(x, self.r)


class PixelShuffleHead:
    """The pixel-shuffle SR head of SwinIR and HAT (a mixin of their
    modules): ``conv_before_upsample`` (LeakyReLU), ``upsample`` ([conv,
    shuffle] per factor), ``conv_last``, run as one composed conv plus a
    depth-to-space with the border ring recomputed
    (:func:`models.common.fused_pixelshuffle_head`)."""

    def init_pixelshuffle_head(self, embed_dim: int, num_feat: int,
                               upscale: int, img_channels: int) -> None:
        self.conv_before_upsample = nn.Sequential(
            Conv(embed_dim, num_feat, act="lrelu"))
        s, self.rs = upscale, []
        while s > 1:
            self.rs.append(3 if s % 3 == 0 else 2)
            s //= self.rs[-1]
        mods = []
        for r in self.rs:
            mods += [Conv(num_feat, num_feat * r * r), _Shuffle(r)]
        self.upsample = nn.Sequential(*mods)
        self.conv_last = Conv(num_feat, img_channels)
        self._head: tuple | None = None

    def _pixelshuffle_head(self, y, packed: bool):
        stages = [(self.upsample[2 * i].hwio(), self.upsample[2 * i].bias)
                  for i in range(len(self.rs))]
        wl, bl = self.conv_last.hwio(), self.conv_last.bias
        rs = self.rs
        if not rs:
            return self.conv_last(y)

        tensors = [p for st in stages for p in st] + [wl, bl]
        key = cache_key(y, tensors)
        if self._head is None or self._head[0] != key:
            with torch.no_grad():
                self._head = (key, head_weights(stages, wl, bl, rs),
                              tail_weights(*stages[-1], wl, bl, rs[-1],
                                           y.dtype))
        composed = self._head[1]
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            # the kept form is constant: a gradient takes the live one
            composed = head_weights(stages, wl, bl, rs)

        def seq_head(z):
            for (w, b), r in zip(stages[:-1], rs[:-1]):
                z = pixel_shuffle(conv_plain(z, w, b), r)
            return upsample_tail(z, *stages[-1], wl, bl, rs[-1],
                                 kernel_weights=self._head[2])

        return fused_pixelshuffle_head(y, stages, wl, bl, rs, seq_head,
                                       packed=packed, composed=composed)


class SwinIR(PixelShuffleHead, nn.Module):
    """Args mirror the reference constructor (network_swinir.py:618-705).
    Input and output are (B, H, W, C) with H and W multiples of the window.

    ``packed_output`` (pixelshuffle head only) emits (B, H*s, W*s*3) with
    RGB interleaved into the minor axis, byte-identical to the NHWC image.
    """

    def __init__(self, img_channels: int = 3, embed_dim: int = 96,
                 depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: int = 8, mlp_ratio: float = 2.0,
                 upscale: int = 1, img_range: float = 1.0,
                 upsampler: str = "", patch_norm: bool = True,
                 num_feat: int = 64, packed_output: bool = False,
                 unshuffle_scale: int = 0):
        super().__init__()
        if packed_output and upsampler != "pixelshuffle":
            raise ValueError("packed_output supports the pixelshuffle head "
                             "only")
        self.img_channels = img_channels
        self.img_range = img_range
        self.upsampler = upsampler
        self.upscale = upscale
        self.packed_output = packed_output
        if unshuffle_scale > 1:
            r = unshuffle_scale
            self.conv_first = nn.Sequential(
                _Unshuffle(r), Conv(img_channels * r * r, embed_dim))
        else:
            self.conv_first = Conv(img_channels, embed_dim)
        self.patch_embed = _PatchEmbed(embed_dim, patch_norm)
        self.layers = nn.ModuleList([
            RSTB(embed_dim, d, h, window_size, mlp_ratio)
            for d, h in zip(depths, num_heads)])
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = Conv(embed_dim, embed_dim)

        if upsampler == "pixelshuffle":
            self.init_pixelshuffle_head(embed_dim, num_feat, upscale,
                                        img_channels)
        elif upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(
                Conv(embed_dim, img_channels * upscale ** 2,
                     shuffle=upscale))
        elif upsampler == "nearest+conv":
            self.conv_before_upsample = nn.Sequential(
                Conv(embed_dim, num_feat, act="lrelu"))
            n_up = 0
            while upscale >> (n_up + 1):
                n_up += 1
            for i in range(1, n_up + 1):
                setattr(self, f"conv_up{i}", Conv(num_feat, num_feat,
                                                  act="lrelu2"))
            self.n_up = n_up
            self.conv_hr = Conv(num_feat, num_feat, act="lrelu2")
            self.conv_last = Conv(num_feat, img_channels)
        else:
            self.conv_last = Conv(embed_dim, img_channels)

    def forward(self, x: torch.Tensor,
                packed_output: bool | None = None) -> torch.Tensor:
        """(B, H, W, C) -> (B, H*s, W*s, C); ``packed_output`` overrides
        the constructor's choice for this call (the engine's band path
        packs, its other paths do not)."""
        packed = self.packed_output if packed_output is None \
            else packed_output
        if packed and self.upsampler != "pixelshuffle":
            raise ValueError("packed_output supports the pixelshuffle head "
                             "only")
        if x.is_cuda and x.dtype == torch.float32:
            exact_f32()
        mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device)
        if self.img_channels == 3:
            x = (x - mean) * self.img_range
        feat = self.conv_first(x)
        y = feat
        if self.patch_embed.norm is not None:
            y = layer_norm_lanes(y, self.patch_embed.norm.weight,
                                 self.patch_embed.norm.bias)
        for layer in self.layers:
            y = layer(y)
        y = self.conv_after_body(y, res=feat,
                                 ln_pre=(self.norm.weight, self.norm.bias))

        if self.upsampler == "pixelshuffle":
            y = self.conv_before_upsample(y)
            y = self._pixelshuffle_head(y, packed)
        elif self.upsampler == "pixelshuffledirect":
            y = self.upsample(y)
        elif self.upsampler == "nearest+conv":
            y = self.conv_before_upsample(y)
            for i in range(1, self.n_up + 1):
                y = y.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                y = getattr(self, f"conv_up{i}")(y)
            y = self.conv_hr(y)
            y = self.conv_last(y)
        else:  # denoising / JPEG artifact removal: global residual
            y = self.conv_last(y) + x

        if packed:
            if self.img_channels == 3:
                mean_row = mean.repeat(y.shape[2] // 3)
                y = y / self.img_range + mean_row[None, None, :]
            return y
        if self.img_channels == 3:
            y = y / self.img_range + mean
        return y


def _swinir(**kw) -> SwinIR:
    return SwinIR(**kw)


# Classical 4x SR ("SwinIR-M": embed 180, six 6-deep RSTBs, window 8).
register_model(ModelSpec(
    name="swinir_sr_x4", build=_swinir, subtasks=("super-resolution",),
    scale=4, pad_multiple=8, pad_mode="extra", pad_kind="symmetric",
    tile=None, tile_overlap=32, band_mode=True,
    config=dict(embed_dim=180, depths=(6,) * 6, num_heads=(6,) * 6,
                window_size=8, upscale=4, upsampler="pixelshuffle"),
))

# Lightweight 4x SR.
register_model(ModelSpec(
    name="swinir_lightweight_sr_x4", build=_swinir,
    subtasks=("super-resolution",), scale=4,
    pad_multiple=8, pad_mode="extra", pad_kind="symmetric",
    tile=256, tile_overlap=32,
    config=dict(embed_dim=60, depths=(6,) * 4, num_heads=(6,) * 4,
                window_size=8, upscale=4, upsampler="pixelshuffledirect"),
))

# Color denoising (noise 15/50 share the arch; weights differ).
for _sigma in (15, 50):
    register_model(ModelSpec(
        name=f"swinir_denoise_{_sigma}", build=_swinir,
        subtasks=("denoising",),
        pad_multiple=8, pad_mode="extra", pad_kind="symmetric", tile=None,
        config=dict(embed_dim=180, depths=(6,) * 6, num_heads=(6,) * 6,
                    window_size=8, upsampler=""),
    ))

# JPEG artifact removal (window 7; we serve color).
register_model(ModelSpec(
    name="swinir_jpeg_40", build=_swinir,
    subtasks=("jpeg compression artifact removal",),
    pad_multiple=7, pad_mode="extra", pad_kind="symmetric", tile=None,
    config=dict(embed_dim=180, depths=(6,) * 6, num_heads=(6,) * 6,
                window_size=7, upsampler="", img_range=255.0),
))

# Tiny CPU-testable config.
register_model(ModelSpec(
    name="swinir_tiny", build=_swinir, subtasks=("super-resolution",),
    scale=4, pad_multiple=8, pad_mode="extra", pad_kind="symmetric",
    tile=None,
    config=dict(embed_dim=16, depths=(2, 2), num_heads=(2, 2),
                window_size=8, upscale=4, upsampler="pixelshuffle",
                num_feat=16),
))
