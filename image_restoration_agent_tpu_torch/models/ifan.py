"""IFAN, channels-last, with the reference parameter names (counterpart
of ``image_restoration_agent_tpu/models/ifan.py``; reference ``IFAN.py``,
``IAC.py``, ``nn_common.py``).

Iterative filter adaptive network for defocus deblurring: a feature
extractor and a filter encoder run side by side; a disparity-map estimator
conditions a filter predictor that emits N per-pixel separable filter pairs
and biases; IAC applies them N times to the 1/8 features; a reconstructor
decodes back up with skips and a global residual. As in the reference:

- ``sac`` applies ``kernel1`` in both passes (``IAC.py:36-37``, the bug the
  released checkpoints were trained with); ``kernel2`` only sets a shape;
- IFAN's ResnetBlock applies its activation after each inner add and wraps
  an outer skip when ``res_num > 1``;
- ``out_res`` is conv + LeakyReLU before the global residual and the clip.

The stride-1 3x3 convs run through :class:`models.common.Conv` (K3 on the
card); the stride-2 convs, the 1x1 filter head and the transposed convs
are library work, as the JAX package sends them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, Conv1x1
from .drbnet import LReLU, conv_act, up_conv
from .registry import ModelSpec, register_model


def sac(feat: torch.Tensor, kernel1: torch.Tensor, kernel2: torch.Tensor,
        ksize: int = 3) -> torch.Tensor:
    """Separable per-pixel filtering: a vertical then a horizontal
    ``ksize``-tap pass with edge padding; ``kernel1`` (B, H, W, C*ksize),
    channel-major, weighs both passes (the reference bug); ``kernel2`` is
    unused, as there. Float32 sums, one cast."""
    b, h, w, c = feat.shape
    pad = (ksize - 1) // 2
    k1 = kernel1.float().reshape(b, h, w, c, ksize)
    fp = F.pad(feat.float().permute(0, 3, 1, 2), (0, 0, pad, pad),
               mode="replicate").permute(0, 2, 3, 1)
    out = sum(fp[:, i:i + h] * k1[..., i] for i in range(ksize))
    fp = F.pad(out.permute(0, 3, 1, 2), (pad, pad, 0, 0),
               mode="replicate").permute(0, 2, 3, 1)
    out = sum(fp[:, :, i:i + w] * k1[..., i] for i in range(ksize))
    return out.to(feat.dtype)


def iac(feat: torch.Tensor, filters: torch.Tensor, n: int, c: int,
        k: int) -> torch.Tensor:
    """N iterations of ``sac``, a per-pixel bias and LeakyReLU(0.1)
    (``IAC.py:4-17``)."""
    pair = c * k * 2
    biases = filters[..., n * pair:]
    out = feat
    for i in range(n):
        fi = filters[..., i * pair:(i + 1) * pair]
        out = sac(out, fi[..., : c * k], fi[..., c * k:], k)
        out = F.leaky_relu(out + biases[..., i * c:(i + 1) * c], 0.1)
    return out


class ResnetBlock(nn.Module):
    """IFAN's ResnetBlock (``nn_common.py:29-54``): per inner iteration
    ``x = lrelu(x + conv(lrelu(conv(x))))``; an outer skip when
    ``res_num > 1``."""

    def __init__(self, c: int, res_num: int):
        super().__init__()
        self.stem = nn.ModuleList([
            nn.Sequential(Conv(c, c), LReLU(), Conv(c, c))
            for _ in range(res_num)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        temp = x
        for blk in self.stem:
            x = F.leaky_relu(x + blk(x), 0.1)
        return x + temp if len(self.stem) > 1 else x


class IFAN(nn.Module):
    def __init__(self, ch: int = 32, res_num: int = 2, filter_size: int = 3,
                 n_iters: int = 17):
        super().__init__()
        ch1, ch2, ch3, ch4 = ch, ch * 2, ch * 4, ch * 4
        self.ch4, self.k, self.n = ch4, filter_size, n_iters
        for pre in ("conv", "kconv"):
            cin = 3
            for i, c in enumerate((ch1, ch2, ch3, ch4), 1):
                setattr(self, f"{pre}{i}_1", conv_act(cin, c, 3,
                                                      1 if i == 1 else 2))
                setattr(self, f"{pre}{i}_2", conv_act(c, c))
                setattr(self, f"{pre}{i}_3", conv_act(c, c))
                cin = c
        self.DME = nn.Sequential(conv_act(ch4, ch4),
                                 ResnetBlock(ch4, res_num),
                                 ResnetBlock(ch4, res_num), Conv(ch4, 1))
        self.conv_DME = conv_act(1, ch4)
        self.conv4_4 = nn.Sequential(conv_act(2 * ch4, ch4),
                                     ResnetBlock(ch4, res_num),
                                     ResnetBlock(ch4, res_num),
                                     conv_act(ch4, ch4))
        kernel_dim = n_iters * (ch4 * filter_size * 2) + n_iters * ch4
        self.F = nn.Sequential(conv_act(ch4, ch4), ResnetBlock(ch4, res_num),
                               ResnetBlock(ch4, res_num),
                               Conv1x1(ch4, kernel_dim))
        self.conv_res = nn.Sequential(conv_act(ch4, ch4),
                                      ResnetBlock(ch4, 3),
                                      conv_act(ch4, ch4))
        for lvl, (cin, c) in zip((3, 2, 1), ((ch4, ch3), (ch3, ch2),
                                            (ch2, ch1))):
            setattr(self, f"upconv{lvl}_u", up_conv(cin, c))
            setattr(self, f"upconv{lvl}_1", ResnetBlock(c, 1))
            setattr(self, f"upconv{lvl}_2", ResnetBlock(c, 1))
        self.out_res = conv_act(ch1, 3)

    def _enc(self, x: torch.Tensor, pre: str) -> list:
        feats = []
        for i in (1, 2, 3, 4):
            for j in (1, 2, 3):
                x = getattr(self, f"{pre}{i}_{j}")(x)
            feats.append(x)
        return feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> (B, H, W, 3); H and W multiples of
        8."""
        f1, f2, f3, f_c = self._enc(x, "conv")
        g = self._enc(x, "kconv")[-1]
        f_dm = self.conv_DME(self.DME(g))
        g = self.conv4_4(torch.cat([g, f_dm], dim=-1))
        y = iac(f_c, self.F(g), self.n, self.ch4, self.k)
        y = self.conv_res(y)
        for lvl, skip in zip((3, 2, 1), (f3, f2, f1)):
            y = getattr(self, f"upconv{lvl}_u")(y) + skip
            y = getattr(self, f"upconv{lvl}_2")(
                getattr(self, f"upconv{lvl}_1")(y))
        return (self.out_res(y) + x).clamp(0.0, 1.0)


register_model(ModelSpec(
    name="ifan",
    build=lambda **kw: IFAN(**kw),
    subtasks=("defocus deblurring",),
    pad_multiple=8, pad_kind="reflect",
    tile=None,
    config=dict(),
))

register_model(ModelSpec(
    name="ifan_tiny",
    build=lambda **kw: IFAN(**kw),
    subtasks=("defocus deblurring",),
    pad_multiple=8, pad_kind="reflect",
    tile=None,
    config=dict(ch=8, res_num=1, n_iters=2),
))
