"""Plain PyTorch SwinIR (Liang et al., ICCV-W 2021), the classical-SR
network of KAIR's ``network_swinir.py``: conv_first, RSTBs of Swin blocks
(window attention with a relative-position bias, shifted windows masked
at -100, an MLP with erf GELU) each closed by a 3x3 conv and a residual,
LayerNorm, conv_after_body plus residual, and the pixel-shuffle head
(conv + LeakyReLU 0.01, [conv, PixelShuffle(2)] x 2, conv_last).

NCHW, float32, parameters under the reference's state-dict names. No
kernel, cache or batching; products through :mod:`.ops` so that the same
code computes the control in TF32. Written from the paper and the
published code, independent of the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import ops
from .. import costs

MEAN = (0.4488, 0.4371, 0.4040)  # DIV2K RGB mean (network_swinir.py)


class _Linear(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))


class _Conv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))

    def run(self, x, prec):
        return ops.conv2d(x, self.weight, self.bias, prec, padding=1)


class _Attn(nn.Module):
    def __init__(self, dim: int, ws: int, heads: int):
        super().__init__()
        self.qkv = _Linear(dim, 3 * dim)
        self.proj = _Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * ws - 1) ** 2, heads))
        coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                            indexing="ij")).flatten(1)
        rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
        rel = rel + (ws - 1)
        self.register_buffer("index", rel[..., 0] * (2 * ws - 1) + rel[..., 1],
                             persistent=False)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = _Linear(dim, hidden)
        self.fc2 = _Linear(hidden, dim)


class _Block(nn.Module):
    def __init__(self, dim, heads, ws, shift, mlp_ratio):
        super().__init__()
        self.heads, self.ws, self.shift = heads, ws, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = _Attn(dim, ws, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def run(self, x, h, w, prec, masks: dict):
        """x: (B, h*w, C) tokens; ``masks`` keeps each canvas's shift
        mask for the blocks that follow."""
        b, _, c = x.shape
        ws, heads = self.ws, self.heads
        # no shift when the canvas is not larger than one window
        shift = 0 if min(h, w) <= ws else self.shift
        y = self.norm1(x).view(b, h, w, c)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        win = y.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        win = win.reshape(-1, ws * ws, c)
        n = ws * ws
        a = self.attn
        qkv = ops.linear(win, a.qkv.weight, a.qkv.bias, prec)
        qkv = qkv.view(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (c // heads) ** -0.5, qkv[1], qkv[2]
        att = ops.matmul(q, k.transpose(-2, -1), prec)
        bias = a.relative_position_bias_table[a.index.reshape(-1)]
        att = att + bias.view(n, n, heads).permute(2, 0, 1)[None]
        if shift:
            key = (h, w, ws, shift)
            if key not in masks:
                masks[key] = shift_mask(h, w, ws, shift, x.device)
            mask = masks[key]
            nw = mask.shape[0]
            att = att.view(-1, nw, heads, n, n) + mask[None, :, None]
            att = att.view(-1, heads, n, n)
        att = att.softmax(-1)
        out = ops.matmul(att, v, prec).transpose(1, 2).reshape(-1, n, c)
        out = ops.linear(out, a.proj.weight, a.proj.bias, prec)
        out = out.view(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, h, w, c)
        if shift:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        x = x + out.reshape(b, h * w, c)
        m = self.mlp
        z = F.gelu(ops.linear(self.norm2(x), m.fc1.weight, m.fc1.bias, prec))
        return x + ops.linear(z, m.fc2.weight, m.fc2.bias, prec)


def shift_mask(h: int, w: int, ws: int, shift: int, device) -> torch.Tensor:
    """(nW, N, N) additive mask of the shifted windows (calculate_mask)."""
    img = torch.zeros(h, w, device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    m = img.view(h // ws, ws, w // ws, ws).permute(0, 2, 1, 3).reshape(
        -1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


class _Group(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class _RSTB(nn.Module):
    def __init__(self, dim, depth, heads, ws, mlp_ratio):
        super().__init__()
        self.residual_group = _Group([
            _Block(dim, heads, ws, 0 if i % 2 == 0 else ws // 2, mlp_ratio)
            for i in range(depth)])
        self.conv = _Conv(dim, dim)


class _PatchEmbed(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(dim)


class SwinIR(nn.Module):
    """The classical-SR SwinIR with a pixel-shuffle head; ``arch`` holds the
    published constructor arguments (``embed_dim``, ``depths``,
    ``num_heads``, ``window_size``, ``mlp_ratio``, ``upscale``,
    ``img_range``, ``num_feat``, ``in_chans``)."""

    def __init__(self, arch: dict):
        super().__init__()
        a = dict(arch)
        if a.get("upsampler") != "pixelshuffle":
            raise ValueError("the reference holds the pixelshuffle head only")
        dim, nf, cin = a["embed_dim"], a["num_feat"], a["in_chans"]
        self.ws, self.scale = a["window_size"], a["upscale"]
        self.img_range = a["img_range"]
        self.conv_first = _Conv(cin, dim)
        self.patch_embed = _PatchEmbed(dim)
        self.layers = nn.ModuleList([
            _RSTB(dim, d, h, self.ws, a["mlp_ratio"])
            for d, h in zip(a["depths"], a["num_heads"])])
        self.norm = nn.LayerNorm(dim)
        self.conv_after_body = _Conv(dim, dim)
        self.conv_before_upsample = nn.ModuleList([_Conv(dim, nf)])
        self.n_up = int(math.log2(self.scale))
        if 2 ** self.n_up != self.scale:
            raise ValueError("the reference holds power-of-two scales only")
        self.upsample = nn.ModuleDict(
            {str(2 * i): _Conv(nf, 4 * nf) for i in range(self.n_up)})
        self.conv_last = _Conv(nf, cin)

    def forward(self, x: torch.Tensor, prec: str = "float32") -> torch.Tensor:
        """(B, 3, H, W) in [0, 1] -> (B, 3, H*s, W*s)."""
        _, _, h0, w0 = x.shape
        ws = self.ws
        x = F.pad(x, (0, (-w0) % ws, 0, (-h0) % ws), mode="reflect")
        b, _, h, w = x.shape
        mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
        x = (x - mean) * self.img_range
        x = self.conv_first.run(x, prec)
        t = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        masks: dict = {}
        for layer in self.layers:
            r = t
            for blk in layer.residual_group.blocks:
                t = blk.run(t, h, w, prec, masks)
            u = t.transpose(1, 2).reshape(b, -1, h, w)
            t = layer.conv.run(u, prec).flatten(2).transpose(1, 2) + r
        t = self.norm(t).transpose(1, 2).reshape(b, -1, h, w)
        x = self.conv_after_body.run(t, prec) + x
        x = F.leaky_relu(self.conv_before_upsample[0].run(x, prec), 0.01)
        for i in range(self.n_up):
            x = F.pixel_shuffle(self.upsample[str(2 * i)].run(x, prec), 2)
        x = self.conv_last.run(x, prec)
        x = x / self.img_range + mean
        return x[:, :, :h0 * self.scale, :w0 * self.scale]


def build(arch: dict) -> SwinIR:
    return SwinIR(arch)


def flops(arch: dict, h: int, w: int) -> float:
    """The network's FLOP for an ``h`` x ``w`` input, counted at that size
    (no padding), products only (:mod:`portbench.costs`)."""
    p = h * w
    dim, nf, cin = arch["embed_dim"], arch["num_feat"], arch["in_chans"]
    hidden = int(dim * arch["mlp_ratio"])
    ws = arch["window_size"]
    total = costs.conv3x3_flop(p, cin, dim)
    for depth in arch["depths"]:
        total += depth * costs.swin_block_flop(p, dim, hidden, ws)
        total += costs.conv3x3_flop(p, dim, dim)
    total += costs.conv3x3_flop(p, dim, dim)         # conv_after_body
    total += costs.conv3x3_flop(p, dim, nf)          # conv_before_upsample
    for i in range(int(math.log2(arch["upscale"]))):
        total += costs.conv3x3_flop(p * 4 ** i, nf, 4 * nf)
    total += costs.conv3x3_flop(p * arch["upscale"] ** 2, nf, cin)
    return float(total)
