"""MPRNet, channels-last, with the reference parameter names (counterpart
of ``image_restoration_agent_tpu/models/mprnet.py``; reference
``MPRNet.py``).

Three progressive stages: stage 1 runs the four quadrants through a CAB
U-Net (batched, 4B), stage 2 the two halves with cross-stage feature fusion
(batched, 2B), stage 3 the whole image through the original-resolution
ORSNet; supervised attention modules (SAM) bridge the stages. PReLU with one
shared slope per CAB, channel attention GAP -> 1x1 -> ReLU -> 1x1 ->
sigmoid, no conv biases. Every 3x3 conv runs through
:class:`models.common.Conv` (K3 on the card); the 1x1 convs are matmuls and
the bilinear resizes ``F.interpolate`` (``antialias=False``), as the JAX
package runs them through XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, Conv1x1
from .registry import ModelSpec, register_model


def bilinear_resize(x: torch.Tensor, scale: float) -> torch.Tensor:
    """torch ``nn.Upsample(scale, bilinear, align_corners=False)`` on a
    channels-last tensor to ``int(H * scale) x int(W * scale)`` (no
    antialias on a downscale): ``jax.image.resize(..., "bilinear",
    antialias=False)``."""
    h, w = x.shape[1], x.shape[2]
    y = F.interpolate(x.permute(0, 3, 1, 2),
                      size=(int(h * scale), int(w * scale)),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


class _Resize(nn.Module):
    def __init__(self, scale: float):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bilinear_resize(x, self.scale)


class PReLU(nn.Module):
    """torch ``nn.PReLU()``: one learnable negative slope, weight (1,)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class CALayer(nn.Module):
    def __init__(self, c: int, reduction: int):
        super().__init__()
        self.conv_du = nn.Sequential(
            Conv1x1(c, c // reduction, False), nn.ReLU(),
            Conv1x1(c // reduction, c, False), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.conv_du(x.mean(dim=(1, 2), keepdim=True))


class CAB(nn.Module):
    def __init__(self, c: int, reduction: int):
        super().__init__()
        self.body = nn.Sequential(Conv(c, c, bias=False), PReLU(),
                                  Conv(c, c, bias=False))
        self.CA = CALayer(c, reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.CA(self.body(x)) + x


class SAM(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = Conv1x1(c, c, False)
        self.conv2 = Conv1x1(c, 3, False)
        self.conv3 = Conv1x1(3, c, False)

    def forward(self, x, x_img):
        img = self.conv2(x) + x_img
        return self.conv1(x) * torch.sigmoid(self.conv3(img)) + x, img


class DownSample(nn.Module):
    def __init__(self, cin: int, s: int):
        super().__init__()
        self.down = nn.Sequential(_Resize(0.5), Conv1x1(cin, cin + s, False))

    def forward(self, x):
        return self.down(x)


class UpSample(nn.Module):
    def __init__(self, cout: int, s: int):
        super().__init__()
        self.up = nn.Sequential(_Resize(2.0), Conv1x1(cout + s, cout, False))

    def forward(self, x):
        return self.up(x)


def _cabs(c: int, reduction: int, n: int = 2) -> nn.Sequential:
    return nn.Sequential(*[CAB(c, reduction) for _ in range(n)])


class Encoder(nn.Module):
    def __init__(self, f: int, s: int, reduction: int, csff: bool):
        super().__init__()
        dims = (f, f + s, f + 2 * s)
        for lvl, c in enumerate(dims, 1):
            setattr(self, f"encoder_level{lvl}", _cabs(c, reduction))
            if csff:
                setattr(self, f"csff_enc{lvl}", Conv1x1(c, c, False))
                setattr(self, f"csff_dec{lvl}", Conv1x1(c, c, False))
        self.down12 = DownSample(f, s)
        self.down23 = DownSample(f + s, s)
        self.csff = csff

    def forward(self, x, encoder_outs=None, decoder_outs=None):
        outs = []
        for lvl in (1, 2, 3):
            x = getattr(self, f"encoder_level{lvl}")(x)
            if self.csff and encoder_outs is not None:
                x = x + getattr(self, f"csff_enc{lvl}")(
                    encoder_outs[lvl - 1]) + getattr(
                    self, f"csff_dec{lvl}")(decoder_outs[lvl - 1])
            outs.append(x)
            if lvl < 3:
                x = (self.down12 if lvl == 1 else self.down23)(x)
        return outs


class Decoder(nn.Module):
    def __init__(self, f: int, s: int, reduction: int):
        super().__init__()
        self.decoder_level1 = _cabs(f, reduction)
        self.decoder_level2 = _cabs(f + s, reduction)
        self.decoder_level3 = _cabs(f + 2 * s, reduction)
        self.skip_attn1 = CAB(f, reduction)
        self.skip_attn2 = CAB(f + s, reduction)
        self.up21 = UpSample(f, s)
        self.up32 = UpSample(f + s, s)

    def forward(self, outs):
        enc1, enc2, enc3 = outs
        dec3 = self.decoder_level3(enc3)
        dec2 = self.decoder_level2(self.up32(dec3) + self.skip_attn2(enc2))
        dec1 = self.decoder_level1(self.up21(dec2) + self.skip_attn1(enc1))
        return [dec1, dec2, dec3]


class _ORB(nn.Module):
    def __init__(self, c: int, reduction: int, num_cab: int):
        super().__init__()
        self.body = nn.Sequential(*[CAB(c, reduction)
                                    for _ in range(num_cab)],
                                  Conv(c, c, bias=False))

    def forward(self, x):
        return self.body(x) + x


class ORSNet(nn.Module):
    def __init__(self, f: int, so: int, su: int, num_cab: int,
                 reduction: int):
        super().__init__()
        for i in (1, 2, 3):
            setattr(self, f"orb{i}", _ORB(f + so, reduction, num_cab))
        self.up_enc1 = UpSample(f, su)
        self.up_dec1 = UpSample(f, su)
        self.up_enc2 = nn.Sequential(UpSample(f + su, su), UpSample(f, su))
        self.up_dec2 = nn.Sequential(UpSample(f + su, su), UpSample(f, su))
        for name in ("conv_enc1", "conv_enc2", "conv_enc3", "conv_dec1",
                     "conv_dec2", "conv_dec3"):
            setattr(self, name, Conv1x1(f, f + so, False))

    def forward(self, x, encoder_outs, decoder_outs):
        x = self.orb1(x)
        x = x + self.conv_enc1(encoder_outs[0]) \
            + self.conv_dec1(decoder_outs[0])
        x = self.orb2(x)
        x = x + self.conv_enc2(self.up_enc1(encoder_outs[1])) \
            + self.conv_dec2(self.up_dec1(decoder_outs[1]))
        x = self.orb3(x)
        return x + self.conv_enc3(self.up_enc2(encoder_outs[2])) \
            + self.conv_dec3(self.up_dec2(decoder_outs[2]))


class MPRNet(nn.Module):
    def __init__(self, n_feat: int = 80, scale_unetfeats: int = 48,
                 scale_orsnetfeats: int = 32, num_cab: int = 8,
                 reduction: int = 4):
        super().__init__()
        f, su, so = n_feat, scale_unetfeats, scale_orsnetfeats
        for i in (1, 2, 3):
            setattr(self, f"shallow_feat{i}", nn.Sequential(
                Conv(3, f, bias=False), CAB(f, reduction)))
        self.stage1_encoder = Encoder(f, su, reduction, csff=False)
        self.stage1_decoder = Decoder(f, su, reduction)
        self.stage2_encoder = Encoder(f, su, reduction, csff=True)
        self.stage2_decoder = Decoder(f, su, reduction)
        self.stage3_orsnet = ORSNet(f, so, su, num_cab, reduction)
        self.sam12 = SAM(f)
        self.sam23 = SAM(f)
        self.concat12 = Conv(2 * f, f, bias=False)
        self.concat23 = Conv(2 * f, f + so, bias=False)
        self.tail = Conv(f + so, 3, bias=False)

    def forward(self, x3_img: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H, W, 3); H and W multiples of 8."""
        b, h, w, _ = x3_img.shape
        top, bot = x3_img[:, : h // 2], x3_img[:, h // 2:]
        halves = torch.cat([top, bot])                      # (2B, ...)
        # stage 1: the four quadrants batched (4B), then each half's
        # quadrant features stitched side by side and decoded (2B)
        quads = torch.cat([halves[:, :, : w // 2], halves[:, :, w // 2:]])
        enc1 = self.stage1_encoder(self.shallow_feat1(quads))
        feat1 = [torch.cat([e[: 2 * b], e[2 * b:]], dim=2) for e in enc1]
        res1 = self.stage1_decoder(feat1)
        x2_sam, _ = self.sam12(res1[0], halves)

        # stage 2: the two halves batched (2B), stitched top over bottom
        x2 = self.concat12(torch.cat([self.shallow_feat2(halves), x2_sam],
                                     dim=-1))
        feat2 = [torch.cat([e[:b], e[b:]], dim=1)
                 for e in self.stage2_encoder(x2, feat1, res1)]
        res2 = self.stage2_decoder(feat2)
        x3_sam, _ = self.sam23(res2[0], x3_img)

        # stage 3: full resolution
        x3 = self.concat23(torch.cat([self.shallow_feat3(x3_img), x3_sam],
                                     dim=-1))
        x3 = self.stage3_orsnet(x3, feat2, res2)
        return self.tail(x3) + x3_img


register_model(ModelSpec(
    name="mprnet",
    build=lambda **kw: MPRNet(**kw),
    subtasks=("denoising", "motion deblurring", "deraining"),
    pad_multiple=8, pad_kind="reflect",
    tile=None,
    config=dict(),
))

register_model(ModelSpec(
    name="mprnet_tiny",
    build=lambda **kw: MPRNet(**kw),
    subtasks=("denoising",),
    pad_multiple=8, pad_kind="reflect",
    tile=None,
    config=dict(n_feat=8, scale_unetfeats=4, scale_orsnetfeats=4, num_cab=1),
))
