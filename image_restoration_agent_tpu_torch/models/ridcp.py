"""RIDCP VQ-codebook dehazing, channels-last (counterpart of
``image_restoration_agent_tpu/models/ridcp.py``; reference
``dehaze_vq_weight_arch.py``, the single-scale-codebook
``VQWeightDehazeNet``), with the reference's state-dict names:
``multiscale_encoder.in_conv`` / ``.blocks.{i}`` (stride-2 conv and two
ResBlocks, then ``.blocks.{max_depth}.swin_blks.{j}``, SwinIR RSTBs),
``before_quant_group.0``, ``quantize_group.0`` (``embedding.weight``, the
HQ-prior ``weight``), ``after_quant_group.0.conv``,
``decoder_group.{i}.block.{1,2,3}``, ``out_conv``, ``residual_conv``,
``multiscale_decoder.upsampler.{i}.{1,2,3}`` and
``multiscale_decoder.warp.{i}`` (``offset``, ``dcn.conv_offset``,
``dcn.weight``, ``dcn.bias``).

A conv+Swin encoder maps the hazy image to 1/4-res features; a
VectorQuantizer snaps them to the nearest codebook entries (distances in
float32, reweighted by the HQ prior, ``d * exp(alpha * w)``); a conv
decoder reconstructs from the codes, and a residual decoder re-injects the
encoder's detail, aligning the code decoder's features to it at each scale
with DCNv2 (:func:`ops.dcn.modulated_deform_conv`) and the mean-ratio
fusion ``r + warped * (mean(r) / (mean(warped) + 1e-8))``, a mean over the
whole tensor, batch included, as in the JAX package.

Routes, as the JAX package takes them on the TPU: every stride-1 3x3 conv
runs through :class:`Conv` (K3 on the card), the RSTB's closing conv with
its roll and residual included; the RSTBs are
:class:`models.swinir.RSTB` at C 256 (hidden 1024: K1's fc2 at K 1024) on
whatever route :func:`models.swinir.strip_route` picks. ``in_conv``
(kernel 4, padding (1, 1), so H -> H-1), the stride-2 convs and the 1x1
are library calls, as XLA runs them there; GroupNorm (min(32, C) groups,
eps 1e-6) and the nearest x2 upsample are plain PyTorch.

The RSTBs need the 1/4-resolution canvas to be a multiple of the window
(8). The registry's ``fallback_tile`` of 240 gives a 60 x 60 canvas, which
the JAX model cannot partition either (its ``window_partition`` reshape
fails); the port raises a ValueError naming that fault instead of padding
where the reference does not.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import exact_f32
from ..ops.dcn import modulated_deform_conv
from .common import Conv, Conv1x1, ConvLib
from .drbnet import nearest_up2
from .registry import ModelSpec, register_model
from .swinir import RSTB

CHANNEL_BY_RES = {8: 256, 16: 256, 32: 256, 64: 256, 128: 128, 256: 64,
                  512: 32}
WINDOW = 8


# nearest x2 upsample, ``jax.image.resize(..., "nearest")`` at x2
_up2 = nearest_up2


class _Up2(nn.Module):
    """The reference's parameterless ``nn.Upsample(scale_factor=2)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _up2(x)


class _Norm(nn.Module):
    """The reference's NormLayer: ``.norm`` a GroupNorm(min(32, C), C,
    eps 1e-6), applied channels-last with float32 statistics and the
    result in ``x``'s dtype."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = nn.GroupNorm(min(32, c), c, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.norm
        y = F.group_norm(x.permute(0, 3, 1, 2).float(), n.num_groups,
                         n.weight.float(), n.bias.float(), n.eps)
        return y.permute(0, 2, 3, 1).to(x.dtype)


class _Act(nn.Module):
    def __init__(self, act: str):
        super().__init__()
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act == "silu":
            return F.silu(x)
        return F.leaky_relu(x, 0.2)


class GNResBlock(nn.Module):
    """Pre-activation GroupNorm ResBlock (``ridcp_utils.py`` ResBlock):
    ``x + conv(act(norm(conv(act(norm(x))))))`` under ``.conv`` as the
    reference's Sequential [Norm, Act, Conv, Norm, Act, Conv]."""

    def __init__(self, c: int, act: str = "leakyrelu"):
        super().__init__()
        self.conv = nn.Sequential(_Norm(c), _Act(act), Conv(c, c),
                                  _Norm(c), _Act(act), Conv(c, c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(x)


class VectorQuantizer(nn.Module):
    """Nearest-codebook quantization with the optional HQ-prior
    reweighting: distances in float32, ``argmin`` taking the first of
    equal minima (as ``jnp.argmin``)."""

    def __init__(self, n_embed: int, embed_dim: int, use_weight: bool = True,
                 weight_alpha: float = 1.0):
        super().__init__()
        self.embedding = nn.Embedding(n_embed, embed_dim)
        self.weight = nn.Parameter(torch.empty(n_embed)) if use_weight \
            else None
        self.weight_alpha = weight_alpha

    def forward(self, z: torch.Tensor):
        """(B, H, W, D) -> (quantized (B, H, W, D) in ``z``'s dtype,
        indices (B, H, W))."""
        b, h, w, d = z.shape
        if z.is_cuda:
            exact_f32()
        flat = z.reshape(-1, d).float()
        cb = self.embedding.weight.float()
        dist = (flat.square().sum(1, keepdim=True) + cb.square().sum(1)
                - 2.0 * flat @ cb.t())
        if self.weight is not None:
            dist = dist * torch.exp(self.weight_alpha * self.weight.float())
        idx = torch.argmin(dist, dim=1)
        zq = self.embedding.weight[idx].reshape(b, h, w, d)
        return zq.to(z.dtype), idx.reshape(b, h, w)


class _DCNPack(nn.Module):
    """The reference's DCNv2Pack: ``conv_offset`` (3 G 9 channels: o1, o2,
    mask) and the deformable conv's ``weight`` (C, C, 3, 3) and ``bias``."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.conv_offset = Conv(c, 3 * groups * 9)
        self.weight = nn.Parameter(torch.empty(c, c, 3, 3))
        self.bias = nn.Parameter(torch.empty(c))


class WarpBlock(nn.Module):
    """DCNv2 alignment of the code decoder's features to the residual
    stream (``dehaze_vq_weight_arch.py`` WarpBlock)."""

    def __init__(self, c: int, deformable_groups: int = 4):
        super().__init__()
        self.groups = deformable_groups
        self.offset = Conv(2 * c, c)
        self.dcn = _DCNPack(c, deformable_groups)

    def forward(self, x_vq: torch.Tensor, x_residual: torch.Tensor):
        feat = self.offset(torch.cat([x_vq, x_residual], dim=-1))
        o1, o2, m = torch.chunk(self.dcn.conv_offset(feat), 3, dim=-1)
        # DCNv2Pack concatenates (o1, o2) verbatim and the CUDA kernel then
        # reads the result with (group, tap, [dy, dx]) nesting
        # (deform_conv_cuda_kernel.cu:216-225) — so the trained checkpoint's
        # o1 holds BOTH dy and dx for the first half of the groups, not
        # "all dy". Pass the same concatenated layout through.
        off = torch.cat([o1, o2], dim=-1)
        return modulated_deform_conv(
            x_vq, off, torch.sigmoid(m), self.dcn.weight.permute(2, 3, 1, 0),
            self.dcn.bias, kernel=3, deformable_groups=self.groups)


def _up_block(cin: int, cout: int, act: str) -> nn.Sequential:
    """[Upsample, conv, ResBlock, ResBlock] (the reference's decoder
    blocks)."""
    return nn.Sequential(_Up2(), Conv(cin, cout), GNResBlock(cout, act),
                         GNResBlock(cout, act))


class _SwinStage(nn.Module):
    def __init__(self, c: int, blocks: int, depth: int, heads: int):
        super().__init__()
        self.swin_blks = nn.ModuleList(
            [RSTB(c, depth, heads, WINDOW, mlp_ratio=4.0)
             for _ in range(blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        if h % WINDOW or w % WINDOW:
            raise ValueError(
                f"RIDCP's Swin blocks need the 1/4-resolution canvas to be "
                f"a multiple of the window {WINDOW}, got {h}x{w}: the "
                f"reference model's window partition fails here too (e.g. "
                f"at its 240 px fallback tile, a 60x60 canvas)")
        for blk in self.swin_blks:
            x = blk(x)
        return x


class _Encoder(nn.Module):
    def __init__(self, cq, res0, max_depth, act, swin):
        super().__init__()
        self.in_conv = ConvLib(3, cq[res0], 4)
        blocks, res = [], res0
        for _ in range(max_depth):
            out_ch = cq[res // 2]
            blocks.append(nn.Sequential(ConvLib(cq[res], out_ch, 3, stride=2),
                                        GNResBlock(out_ch, act),
                                        GNResBlock(out_ch, act)))
            res //= 2
        blocks.append(_SwinStage(cq[res], *swin))
        self.blocks = nn.ModuleList(blocks)


class _AfterQuant(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv(cin, cout)


class _DecBlock(nn.Module):
    def __init__(self, cin: int, cout: int, act: str):
        super().__init__()
        self.block = _up_block(cin, cout, act)


class _ResidualDecoder(nn.Module):
    def __init__(self, widths, act: str, use_warp: bool):
        super().__init__()
        self.upsampler = nn.ModuleList([_up_block(cin, cout, act)
                                        for cin, cout in widths])
        if use_warp:
            self.warp = nn.ModuleList([WarpBlock(cout) for _, cout in widths])


class RIDCP(nn.Module):
    """Single-scale-codebook configuration (the released RIDCP model):
    codebook at 1/4 res with 1024 x 512 entries, depth 2.

    Trained through the output, the codebook gets its gradient from the
    gather of the chosen codes (``jnp.take`` in the JAX package); the
    quantizer's input conv and HQ prior reach the output only through the
    ``argmin``, and ``out_conv`` not at all, so no derivative reaches them
    (``jax.grad`` gives them zeros): :attr:`gradient_free` names them for
    the train step (``parallel/train_step.py``)."""

    gradient_free = ("before_quant_group.", "quantize_group.0.weight",
                     "out_conv.")

    def __init__(self, n_embed: int = 1024, embed_dim: int = 512,
                 max_depth: int = 2, gt_res: int = 256,
                 use_weight: bool = True, weight_alpha: float = 1.0,
                 use_warp: bool = True, swin_blocks: int = 4,
                 swin_depth: int = 6, swin_heads: int = 8,
                 act: str = "silu", channels: Optional[dict] = None):
        super().__init__()
        cq = channels or CHANNEL_BY_RES
        self.max_depth, self.use_warp = max_depth, use_warp
        self.multiscale_encoder = _Encoder(
            cq, gt_res, max_depth, act, (swin_blocks, swin_depth,
                                         swin_heads))
        res = gt_res // 2 ** max_depth
        self.before_quant_group = nn.ModuleList([Conv1x1(cq[res],
                                                         embed_dim)])
        self.quantize_group = nn.ModuleList([VectorQuantizer(
            n_embed, embed_dim, use_weight, weight_alpha)])
        self.after_quant_group = nn.ModuleList([_AfterQuant(embed_dim,
                                                            cq[res])])
        widths = [(cq[res * 2 ** i], cq[res * 2 ** (i + 1)])
                  for i in range(max_depth)]
        self.decoder_group = nn.ModuleList([_DecBlock(cin, cout, act)
                                            for cin, cout in widths])
        # out_conv is the code decoder's image head: the reference trains
        # it, the served output is residual_conv's
        self.out_conv = Conv(cq[gt_res], 3)
        self.residual_conv = Conv(cq[gt_res], 3)
        self.multiscale_decoder = _ResidualDecoder(widths, act, use_warp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H, W, 3) for H and W multiples of 8 whose
        1/4-resolution canvas is one of the window (8)."""
        enc = self.multiscale_encoder
        y = enc.in_conv(x)
        for blk in enc.blocks:
            y = blk(y)
        feats = y
        zq, _ = self.quantize_group[0](self.before_quant_group[0](y))
        y = self.after_quant_group[0].conv(zq)
        code = []
        for blk in self.decoder_group:
            y = blk.block(y)
            code.append(y)
        dec = self.multiscale_decoder
        r = feats
        for i, up in enumerate(dec.upsampler):
            r = up(r)
            if self.use_warp:
                warped = dec.warp[i](code[i], r)
                # means over the whole tensor, batch included (float32 sums,
                # the JAX package's jnp.mean)
                ratio = r.float().mean().to(r.dtype) / (
                    warped.float().mean().to(warped.dtype) + 1e-8)
                r = r + warped * ratio
            else:
                r = r + code[i]
        return self.residual_conv(r)


register_model(ModelSpec(
    name="ridcp",
    build=lambda **kw: RIDCP(**kw),
    subtasks=("dehazing",),
    pad_multiple=8, pad_kind="reflect",
    tile=None,  # whole image below max_size, engine falls back to tiling
    max_size=1500, fallback_tile=240,  # model_services.yaml:53 / test_tile
    config=dict(weight_alpha=-21.25),
))

register_model(ModelSpec(
    name="ridcp_tiny",
    build=lambda **kw: RIDCP(**kw),
    subtasks=("dehazing",),
    pad_multiple=8, pad_kind="reflect",
    tile=None,
    config=dict(n_embed=32, embed_dim=16, swin_blocks=1, swin_depth=1,
                swin_heads=2,
                channels={256: 8, 128: 12, 64: 16, 32: 16, 16: 16, 8: 16}),
))
