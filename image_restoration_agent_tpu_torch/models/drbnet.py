"""DRBNet (single view), channels-last, with the reference parameter names
(counterpart of ``image_restoration_agent_tpu/models/drbnet.py``;
reference ``DRBNet.py`` ``DRBNet_single``).

Defocus deblurring by per-pixel dynamic filters: a 4-level conv encoder;
at each decoder scale the features and the image estimate's features
predict a per-pixel 7x7 kernel and a residual, refining the estimate from
1/8 resolution up: ``est = up(est) + fac(up(est), kernel) + res``. Works in
[-1, 1]; the output is clipped. The stride-1 3x3 convs run through
:class:`models.common.Conv` (K3 on the card); the stride-2 encoder convs,
the 1x1 heads and the 4x4 stride-2 transposed convs are library work, as
the JAX package sends them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, Conv1x1, ConvLib, ConvTranspose
from .registry import ModelSpec, register_model


class LReLU(nn.Module):
    """LeakyReLU(0.1), the reference's activation."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, 0.1)


def conv_act(cin: int, cout: int, k: int = 3, stride: int = 1
             ) -> nn.Sequential:
    """The reference's ``Sequential(conv, LeakyReLU(0.1))``."""
    if k == 3 and stride == 1:
        return nn.Sequential(Conv(cin, cout), LReLU())
    if k == 1:
        return nn.Sequential(Conv1x1(cin, cout), LReLU())
    return nn.Sequential(ConvLib(cin, cout, k, stride), LReLU())


def fac(img: torch.Tensor, kernel: torch.Tensor, ksize: int = 7
        ) -> torch.Tensor:
    """Filter-adaptive convolution: ``out[p] = sum_t pad(img)[p + t] *
    kernel[p, t]`` over the ksize x ksize taps ``t`` (an edge pad), one
    kernel for all channels; ``kernel`` is (B, H, W, ksize^2). Summed in
    float32, one cast."""
    pad = (ksize - 1) // 2
    b, h, w, _ = img.shape
    xp = F.pad(img.permute(0, 3, 1, 2).float(), (pad,) * 4,
               mode="replicate").permute(0, 2, 3, 1)
    k = kernel.float()
    out = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    for dy in range(ksize):
        for dx in range(ksize):
            out += xp[:, dy:dy + h, dx:dx + w] \
                * k[..., dy * ksize + dx, None]
    return out.to(img.dtype)


def area_down(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``F.interpolate(mode="area")`` downscale: an exact block mean."""
    b, h, w, c = x.shape
    return x.reshape(b, h // factor, factor, w // factor, factor,
                     c).mean(dim=(2, 4))


def nearest_up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class ResBlock(nn.Module):
    """``x + conv(lrelu(conv(x)))`` (reference ResnetBlock, ``stem.0``)."""

    def __init__(self, c: int):
        super().__init__()
        self.stem = nn.ModuleList([nn.Sequential(Conv(c, c), LReLU(),
                                                 Conv(c, c))])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.stem[0](x)


def up_conv(cin: int, cout: int) -> nn.Sequential:
    """ConvTranspose2d(k 4, stride 2, padding 1) and LeakyReLU(0.1)."""
    return nn.Sequential(ConvTranspose(cin, cout, 4, 2, 1), LReLU())


def conv_stack(cin: int, dims, kernels, act_last: bool = True
               ) -> nn.Sequential:
    layers = []
    for i, (c, k) in enumerate(zip(dims, kernels)):
        last = i == len(dims) - 1
        if last and not act_last:
            layers.append(Conv1x1(cin, c) if k == 1 else Conv(cin, c))
        else:
            layers.append(conv_act(cin, c, k))
        cin = c
    return nn.Sequential(*layers)


class DRBNet(nn.Module):
    def __init__(self, ch1: int = 32, kernel_width: int = 7):
        super().__init__()
        ch2, ch3, ch4 = ch1 * 2, ch1 * 4, ch1 * 8
        self.kw = kernel_width
        kd = kernel_width ** 2
        cin = 3
        for i, c in enumerate((ch1, ch2, ch3, ch4), 1):
            setattr(self, f"conv{i}_1", conv_act(cin, c, 3,
                                                 1 if i == 1 else 2))
            setattr(self, f"conv{i}_2", conv_act(c, c))
            setattr(self, f"conv{i}_3", conv_act(c, c))
            cin = c
        self.conv4_4 = nn.Sequential(conv_act(ch4, ch4), ResBlock(ch4),
                                     ResBlock(ch4), conv_act(ch4, ch4))
        for lvl, (cin, c) in zip((3, 2, 1), ((ch4, ch3), (ch3, ch2),
                                            (ch2, ch1))):
            setattr(self, f"upconv{lvl}_u", up_conv(cin, c))
            setattr(self, f"upconv{lvl}_1", ResBlock(c))
            setattr(self, f"upconv{lvl}_2", ResBlock(c))
        # per scale (tag, reference level, features, image-feature widths,
        # kernel-head widths, residual-head widths)
        self.scales = (
            ("d8", 3, ch4, (ch2, ch3, ch4), (ch4, ch3), (ch4, ch2)),
            ("d4", 2, ch3, (ch2, ch3, ch3), (ch3, ch3), (ch3, ch2)),
            ("d2", 1, ch2, (ch2, ch2, ch2), (ch2, ch2), (ch2, ch2)),
            ("d1", 0, ch1, (ch2, ch2, ch1), (ch2, ch2), (ch2, ch2)))
        for tag, lvl, f, imd, kdims, rdims in self.scales:
            setattr(self, f"img_{tag}_feature",
                    conv_stack(3, imd, (3, 3, 3)))
            cat = f + imd[-1]
            setattr(self, f"upconv{lvl}_kernel",
                    conv_stack(cat, (*kdims, kd), (3, 3, 1), False))
            setattr(self, f"upconv{lvl}_res",
                    conv_stack(cat, (*rdims, 3), (3, 3, 1)))

    def refine(self, est, f, tag: str, lvl: int):
        imf = getattr(self, f"img_{tag}_feature")(est)
        feat = torch.cat([f, imf], dim=-1)
        kern = getattr(self, f"upconv{lvl}_kernel")(feat)
        res = getattr(self, f"upconv{lvl}_res")(feat)
        return est + fac(est, kern, self.kw) + res

    def forward(self, x01: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> (B, H, W, 3); H and W multiples of
        8."""
        c = x01 * 2.0 - 1.0
        feats, f = [], c
        for i in (1, 2, 3, 4):
            for j in (1, 2, 3):
                f = getattr(self, f"conv{i}_{j}")(f)
            feats.append(f)
        f = self.conv4_4(f)
        est = self.refine(area_down(c, 8), f, "d8", 3)
        for (tag, lvl, *_), skip in zip(self.scales[1:], feats[2::-1]):
            up = lvl + 1
            f = getattr(self, f"upconv{up}_u")(f) + skip
            f = getattr(self, f"upconv{up}_2")(
                getattr(self, f"upconv{up}_1")(f))
            est = self.refine(nearest_up2(est), f, tag, lvl)
        return (est.clamp(-1.0, 1.0) + 1.0) / 2.0


register_model(ModelSpec(
    name="drbnet",
    build=lambda **kw: DRBNet(**kw),
    subtasks=("defocus deblurring",),
    pad_multiple=8, pad_kind="reflect",
    tile=None,
    config=dict(),
))

register_model(ModelSpec(
    name="drbnet_tiny",
    build=lambda **kw: DRBNet(**kw),
    subtasks=("defocus deblurring",),
    pad_multiple=8, pad_kind="reflect",
    tile=None,
    config=dict(ch1=8),
))
