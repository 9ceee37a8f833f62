"""Plain PyTorch Restormer (Zamir et al., CVPR 2022), ``restormer_arch.py``
of the published code: a 4-level U-shape of transformer blocks, each
``x + MDTA(LN(x))`` then ``x + GDFN(LN(x))``. MDTA: qkv 1x1, 3x3
depthwise, q and k L2-normalised over pixels, per-head channel attention
scaled by a learned temperature, project_out. GDFN: project_in to two
halves, 3x3 depthwise, ``gelu(x1) * x2``, project_out. Pixel-unshuffle
downs and pixel-shuffle ups, 1x1 channel reductions, a refinement stage and
the global residual ``output(y) + input``. LayerNorm ``WithBias`` or
``BiasFree``, eps 1e-5.

NCHW, float32, parameters under the reference's state-dict names; products
through :mod:`.ops`. Independent of the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import ops
from .. import costs


def _w(*shape):
    return nn.Parameter(torch.empty(*shape))


class _Body(nn.Module):
    def __init__(self, c: int, bias_free: bool):
        super().__init__()
        self.weight = _w(c)
        self.bias = None if bias_free else _w(c)


class _LN(nn.Module):
    def __init__(self, c: int, bias_free: bool):
        super().__init__()
        self.body = _Body(c, bias_free)

    def forward(self, x):
        mu = x.mean(1, keepdim=True)
        var = x.var(1, keepdim=True, unbiased=False)
        b = self.body
        if b.bias is None:
            return x / torch.sqrt(var + 1e-5) * b.weight.view(1, -1, 1, 1)
        return ((x - mu) / torch.sqrt(var + 1e-5) * b.weight.view(1, -1, 1, 1)
                + b.bias.view(1, -1, 1, 1))


class _Conv(nn.Module):
    def __init__(self, cin, cout, k, bias, groups=1):
        super().__init__()
        self.weight = _w(cout, cin // groups, k, k)
        self.bias = _w(cout) if bias else None
        self.pad, self.groups = k // 2, groups

    def forward(self, x, prec):
        return ops.conv2d(x, self.weight, self.bias, prec, padding=self.pad,
                          groups=self.groups)


class _Attention(nn.Module):
    def __init__(self, c, heads, bias):
        super().__init__()
        self.heads = heads
        self.temperature = _w(heads, 1, 1)
        self.qkv = _Conv(c, 3 * c, 1, bias)
        self.qkv_dwconv = _Conv(3 * c, 3 * c, 3, bias, groups=3 * c)
        self.project_out = _Conv(c, c, 1, bias)

    def forward(self, x, prec):
        b, c, h, w = x.shape
        q, k, v = self.qkv_dwconv(self.qkv(x, prec), prec).chunk(3, dim=1)
        q, k, v = (t.reshape(b, self.heads, c // self.heads, h * w)
                   for t in (q, k, v))
        q = F.normalize(q, dim=-1)
        k = F.normalize(k, dim=-1)
        att = ops.matmul(q, k.transpose(-2, -1), prec) * self.temperature
        out = ops.matmul(att.softmax(-1), v, prec).reshape(b, c, h, w)
        return self.project_out(out, prec)


class _FFN(nn.Module):
    def __init__(self, c, factor, bias):
        super().__init__()
        hid = int(c * factor)
        self.project_in = _Conv(c, 2 * hid, 1, bias)
        self.dwconv = _Conv(2 * hid, 2 * hid, 3, bias, groups=2 * hid)
        self.project_out = _Conv(hid, c, 1, bias)

    def forward(self, x, prec):
        x1, x2 = self.dwconv(self.project_in(x, prec), prec).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2, prec)


class _Block(nn.Module):
    def __init__(self, c, heads, factor, bias, bias_free):
        super().__init__()
        self.norm1 = _LN(c, bias_free)
        self.attn = _Attention(c, heads, bias)
        self.norm2 = _LN(c, bias_free)
        self.ffn = _FFN(c, factor, bias)

    def forward(self, x, prec):
        x = x + self.attn(self.norm1(x), prec)
        return x + self.ffn(self.norm2(x), prec)


class _Stage(nn.ModuleList):
    def run(self, x, prec):
        for blk in self:
            x = blk(x, prec)
        return x


class _Resample(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.body = nn.ModuleList([_Conv(cin, cout, 3, False)])


class _PatchEmbed(nn.Module):
    def __init__(self, cin, c, bias):
        super().__init__()
        self.proj = _Conv(cin, c, 3, bias)


class Restormer(nn.Module):
    """``arch`` holds the published constructor arguments (``inp_channels``,
    ``out_channels``, ``dim``, ``num_blocks``, ``num_refinement_blocks``,
    ``heads``, ``ffn_expansion_factor``, ``bias``, ``LayerNorm_type``)."""

    def __init__(self, arch: dict):
        super().__init__()
        d, nb, hd = arch["dim"], arch["num_blocks"], arch["heads"]
        f, bias = arch["ffn_expansion_factor"], arch["bias"]
        bf = arch["LayerNorm_type"] == "BiasFree"

        def stage(c, level, n):
            return _Stage([_Block(c, hd[level], f, bias, bf)
                           for _ in range(n)])

        self.patch_embed = _PatchEmbed(arch["inp_channels"], d, bias)
        self.encoder_level1 = stage(d, 0, nb[0])
        self.down1_2 = _Resample(d, d // 2)
        self.encoder_level2 = stage(2 * d, 1, nb[1])
        self.down2_3 = _Resample(2 * d, d)
        self.encoder_level3 = stage(4 * d, 2, nb[2])
        self.down3_4 = _Resample(4 * d, 2 * d)
        self.latent = stage(8 * d, 3, nb[3])
        self.up4_3 = _Resample(8 * d, 16 * d)
        self.reduce_chan_level3 = _Conv(8 * d, 4 * d, 1, bias)
        self.decoder_level3 = stage(4 * d, 2, nb[2])
        self.up3_2 = _Resample(4 * d, 8 * d)
        self.reduce_chan_level2 = _Conv(4 * d, 2 * d, 1, bias)
        self.decoder_level2 = stage(2 * d, 1, nb[1])
        self.up2_1 = _Resample(2 * d, 4 * d)
        self.decoder_level1 = stage(2 * d, 0, nb[0])
        self.refinement = stage(2 * d, 0, arch["num_refinement_blocks"])
        self.output = _Conv(2 * d, arch["out_channels"], 3, bias)

    def forward(self, x: torch.Tensor, prec: str = "float32") -> torch.Tensor:
        """(B, 3, H, W), H and W multiples of 8 -> (B, 3, H, W)."""

        def down(m, t):
            return F.pixel_unshuffle(m.body[0](t, prec), 2)

        def up(m, t):
            return F.pixel_shuffle(m.body[0](t, prec), 2)

        e1 = self.encoder_level1.run(self.patch_embed.proj(x, prec), prec)
        e2 = self.encoder_level2.run(down(self.down1_2, e1), prec)
        e3 = self.encoder_level3.run(down(self.down2_3, e2), prec)
        y = self.latent.run(down(self.down3_4, e3), prec)
        y = torch.cat([up(self.up4_3, y), e3], 1)
        y = self.decoder_level3.run(self.reduce_chan_level3(y, prec), prec)
        y = torch.cat([up(self.up3_2, y), e2], 1)
        y = self.decoder_level2.run(self.reduce_chan_level2(y, prec), prec)
        y = torch.cat([up(self.up2_1, y), e1], 1)
        y = self.refinement.run(self.decoder_level1.run(y, prec), prec)
        return self.output(y, prec) + x


def build(arch: dict) -> Restormer:
    return Restormer(arch)


def flops(arch: dict, h: int, w: int) -> float:
    """The network's FLOP for an ``h`` x ``w`` input, counted at that size
    (each level's pixels a quarter of the one above), products only."""
    p = h * w
    d, nb, hd = arch["dim"], arch["num_blocks"], arch["heads"]
    f = arch["ffn_expansion_factor"]

    def blocks(n, c, level):
        pix = p / 4 ** level
        return n * costs.restormer_block_flop(pix, c, hd[level], int(c * f))

    total = costs.conv3x3_flop(p, arch["inp_channels"], d)
    total += blocks(nb[0], d, 0) + blocks(nb[1], 2 * d, 1)
    total += blocks(nb[2], 4 * d, 2) + blocks(nb[3], 8 * d, 3)
    total += costs.conv3x3_flop(p, d, d // 2)                  # down1_2
    total += costs.conv3x3_flop(p / 4, 2 * d, d)               # down2_3
    total += costs.conv3x3_flop(p / 16, 4 * d, 2 * d)          # down3_4
    total += costs.conv3x3_flop(p / 64, 8 * d, 16 * d)         # up4_3
    total += costs.conv1x1_flop(p / 16, 8 * d, 4 * d)          # reduce 3
    total += blocks(nb[2], 4 * d, 2)
    total += costs.conv3x3_flop(p / 16, 4 * d, 8 * d)          # up3_2
    total += costs.conv1x1_flop(p / 4, 4 * d, 2 * d)           # reduce 2
    total += blocks(nb[1], 2 * d, 1)
    total += costs.conv3x3_flop(p / 4, 2 * d, 4 * d)           # up2_1
    total += blocks(nb[0] + arch["num_refinement_blocks"], 2 * d, 0)
    total += costs.conv3x3_flop(p, 2 * d, arch["out_channels"])
    return float(total)
