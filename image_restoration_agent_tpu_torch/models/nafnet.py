"""NAFNet, channels-last (counterpart of
``image_restoration_agent_tpu/models/nafnet.py``), with the reference's
state-dict names (``NAFNet_arch.py``): ``intro``, ``encoders.i.j``,
``downs.i``, ``middle_blks.i``, ``ups.i.0``, ``decoders.i.j``, ``ending``;
``beta`` / ``gamma`` shaped (1, C, 1, 1).

Blocks: LayerNorm2d -> 1x1 expand -> depthwise 3x3 -> SimpleGate ->
simplified channel attention (global mean + 1x1) -> 1x1, and a SimpleGate
FFN, each branch scaled per channel. The two 3x3 convs (``intro``,
``ending``) run through :class:`Conv` (K3 on the card), as the JAX package
sends them to its TPU kernel; the depthwise 3x3, the 1x1s, the 2x2
stride-2 downs and the shuffle ups are library calls there and here.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.resize import resize_bicubic_torch
from ..device import exact_f32
from ..ops.gates import simple_gate
from ..ops.layernorm import layer_norm_2d
from ..ops.pixel_shuffle import pixel_shuffle
from .common import Conv, Conv1x1, DWConv
from .registry import ModelSpec, register_model


class LayerNorm2d(nn.Module):
    """NAFNet's LayerNorm over channels (eps 1e-6)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_2d(x, self.weight, self.bias)


class Conv2x2Down(nn.Module):
    """The reference's ``Conv2d(c, 2c, 2, 2)`` on a channels-last tensor
    (a library conv)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 2, 2))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and x.dtype == torch.float32:
            exact_f32()
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                     self.bias.to(x.dtype), stride=2)
        return y.permute(0, 2, 3, 1)


class NAFBlock(nn.Module):
    def __init__(self, c: int, dw_expand: int = 2, ffn_expand: int = 2):
        super().__init__()
        dw = c * dw_expand
        self.norm1 = LayerNorm2d(c)
        self.conv1 = Conv1x1(c, dw)
        self.conv2 = DWConv(dw)
        # index 0 is the reference's AdaptiveAvgPool2d: the mean is taken
        # in forward
        self.sca = nn.Sequential(nn.Identity(), Conv1x1(dw // 2, dw // 2))
        self.conv3 = Conv1x1(dw // 2, c)
        self.norm2 = LayerNorm2d(c)
        self.conv4 = Conv1x1(c, c * ffn_expand)
        self.conv5 = Conv1x1(c * ffn_expand // 2, c)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = simple_gate(self.conv2(self.conv1(self.norm1(x))))
        y = y * self.sca(y.mean(dim=(1, 2), keepdim=True))
        x = x + self.conv3(y) * self.beta.reshape(-1).to(x.dtype)
        y = self.conv5(simple_gate(self.conv4(self.norm2(x))))
        return x + y * self.gamma.reshape(-1).to(x.dtype)


class NAFNet(nn.Module):
    """Arguments as the reference constructor's (``NAFNet_arch.py``)."""

    def __init__(self, img_channels: int = 3, width: int = 16,
                 middle_blk_num: int = 1, enc_blk_nums: Sequence[int] = (),
                 dec_blk_nums: Sequence[int] = (), scale: int = 1):
        super().__init__()
        self.scale = scale
        self.pad = 2 ** len(enc_blk_nums)
        self.intro = Conv(img_channels, width)
        self.encoders = nn.ModuleList()
        self.downs = nn.ModuleList()
        chan = width
        for num in enc_blk_nums:
            self.encoders.append(nn.Sequential(
                *[NAFBlock(chan) for _ in range(num)]))
            self.downs.append(Conv2x2Down(chan, 2 * chan))
            chan *= 2
        self.middle_blks = nn.Sequential(
            *[NAFBlock(chan) for _ in range(middle_blk_num)])
        self.ups = nn.ModuleList()
        self.decoders = nn.ModuleList()
        for num in dec_blk_nums:
            # ups.i.0 is the reference's Conv2d(chan, 2 chan, 1, bias=False)
            # of Sequential(conv, PixelShuffle(2))
            self.ups.append(nn.ModuleList([Conv1x1(chan, 2 * chan,
                                                   bias=False)]))
            chan //= 2
            self.decoders.append(nn.Sequential(
                *[NAFBlock(chan) for _ in range(num)]))
        self.ending = Conv(width, img_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale > 1:
            x = resize_bicubic_torch(x, float(self.scale))
        h, w = x.shape[1], x.shape[2]
        ph, pw = (-h) % self.pad, (-w) % self.pad
        if ph or pw:  # zero pad bottom/right (reference check_image_size)
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        inp = x
        y = self.intro(x)
        skips = []
        for enc, down in zip(self.encoders, self.downs):
            y = enc(y)
            skips.append(y)
            y = down(y)
        y = self.middle_blks(y)
        for up, dec, skip in zip(self.ups, self.decoders, reversed(skips)):
            y = pixel_shuffle(up[0](y), 2) + skip
            y = dec(y)
        y = self.ending(y, res=inp)
        return y[:, :h, :w, :]


register_model(ModelSpec(
    name="nafnet_small",
    build=lambda **kw: NAFNet(**kw),
    subtasks=("denoising",),
    pad_multiple=1,  # the model pads itself to 2^len(enc)
    tile=None,
    config=dict(width=16, middle_blk_num=1,
                enc_blk_nums=(1, 1, 1), dec_blk_nums=(1, 1, 1)),
))

register_model(ModelSpec(
    name="nafnet",
    build=lambda **kw: NAFNet(**kw),
    subtasks=("denoising", "motion deblurring"),
    pad_multiple=1,
    tile=None,
    config=dict(width=32, middle_blk_num=12,
                enc_blk_nums=(2, 2, 4, 8), dec_blk_nums=(2, 2, 2, 2)),
))
