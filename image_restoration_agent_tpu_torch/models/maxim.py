"""MAXIM (multi-axis gated MLP), channels-last (counterpart of
``image_restoration_agent_tpu/models/maxim.py``).

MAXIM's upstream is Flax, with no torch reference, so the port keeps the
JAX package's module names (``stage0_enc0_mab0.grid_gmlp.gate.proj``), a
Flax ``kernel`` becoming ``weight`` in torch layout: Dense (O, I), Conv (O,
I, kh, kw), ConvTranspose (I, O, 2, 2), LayerNorm ``scale`` ``weight``.

``num_stages`` encoder / bottleneck / decoder stages. The spatial mixer is
the multi-axis gMLP (MAB): the channels split in half, a grid gMLP mixes
tokens across a gh x gw grid, a block gMLP inside fh x fw blocks (a Dense
over the token axis). Channel mixing is RCAB / RDCAB squeeze-excitation;
skips and stage fusion go through cross-gating blocks; SAM bridges stages.
The 3x3 convs run through :class:`models.common.Conv` (K3 on the card);
Denses, 1x1 convs, the 4x4 stride-2 downs, the transposed convs and the
skip signals' resizes are library work, as the JAX package sends them to
XLA. The skip resizes are ``jax.image.resize(..., "bilinear")`` with its
default antialias (:func:`core.resize.resize_bilinear_jax`). Flax defaults
kept: LayerNorm eps 1e-6, the tanh GELU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.resize import resize_bilinear_jax
from ..device import exact_f32
from ..ops.layernorm import layer_norm_lanes
from .common import Conv, Conv1x1, ConvLib, ConvTranspose
from .registry import ModelSpec, register_model


def to_blocks(x: torch.Tensor, fh: int, fw: int) -> torch.Tensor:
    """(n, H, W, c) -> (n, gh*gw, fh*fw, c)."""
    n, h, w, c = x.shape
    gh, gw = h // fh, w // fw
    x = x.reshape(n, gh, fh, gw, fw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, gh * gw, fh * fw, c)


def from_blocks(x: torch.Tensor, gh: int, gw: int, fh: int,
                fw: int) -> torch.Tensor:
    n, c = x.shape[0], x.shape[-1]
    x = x.reshape(n, gh, gw, fh, fw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, gh * fh, gw * fw, c)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Flax ``nn.gelu``: the tanh form."""
    return F.gelu(x, approximate="tanh")


class Dense(nn.Module):
    """Flax ``nn.Dense`` over the last axis, weight (O, I)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and x.dtype == torch.float32:
            exact_f32()
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` (eps 1e-6, float32 statistics)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_lanes(x, self.weight, self.bias, eps=1e-6)


class GatingUnit(nn.Module):
    """gMLP spatial gating ``u * (W v + 1)``, W a Dense over the token
    axis ``axis`` (-3: across the grid, -2: within a block)."""

    def __init__(self, c: int, tokens: int, axis: int):
        super().__init__()
        self.axis = axis
        self.norm = LayerNorm(c // 2)
        self.proj = Dense(tokens, tokens)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u, v = x.chunk(2, dim=-1)
        v = self.proj(self.norm(v).transpose(-1, self.axis))
        return u * (v.transpose(-1, self.axis) + 1.0)


class AxisGmlp(nn.Module):
    """One gMLP over the grid axis (global) or the block axis (local)."""

    def __init__(self, c: int, grid: bool, size: tuple, factor: int = 2):
        super().__init__()
        self.grid, self.size = grid, tuple(size)
        self.norm = LayerNorm(c)
        self.in_project = Dense(c, c * factor)
        self.gate = GatingUnit(c * factor, size[0] * size[1],
                               -3 if grid else -2)
        self.out_project = Dense(c * factor // 2, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        if self.grid:
            gh, gw = self.size
            fh, fw = h // gh, w // gw
        else:
            fh, fw = self.size
            gh, gw = h // fh, w // fw
        xb = to_blocks(x, fh, fw)
        y = self.gate(gelu(self.in_project(self.norm(xb))))
        return from_blocks(xb + self.out_project(y), gh, gw, fh, fw)


class MAB(nn.Module):
    """Multi-axis gated MLP block (residual, split heads)."""

    def __init__(self, c: int, block_size: tuple, grid_size: tuple):
        super().__init__()
        self.norm_in = LayerNorm(c)
        self.in_project = Dense(c, 2 * c)
        self.grid_gmlp = AxisGmlp(c, True, grid_size)
        self.block_gmlp = AxisGmlp(c, False, block_size)
        self.out_project = Dense(2 * c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u, v = gelu(self.in_project(self.norm_in(x))).chunk(2, dim=-1)
        y = torch.cat([self.grid_gmlp(u), self.block_gmlp(v)], dim=-1)
        return self.out_project(y) + x


class CALayer(nn.Module):
    def __init__(self, c: int, reduction: int = 4):
        super().__init__()
        self.c1 = Conv1x1(c, c // reduction)
        self.c2 = Conv1x1(c // reduction, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.c1(x.mean(dim=(1, 2), keepdim=True)))
        return x * torch.sigmoid(self.c2(y))


class RCAB(nn.Module):
    def __init__(self, c: int, reduction: int = 4):
        super().__init__()
        self.norm = LayerNorm(c)
        self.conv1 = Conv(c, c)
        self.conv2 = Conv(c, c)
        self.ca = CALayer(c, reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.conv1(self.norm(x)), 0.2)
        return x + self.ca(self.conv2(y))


class RDCAB(nn.Module):
    """Channel MLP and channel attention (the bottleneck's mixer)."""

    def __init__(self, c: int, reduction: int = 4):
        super().__init__()
        self.norm = LayerNorm(c)
        self.fc1 = Dense(c, c)
        self.fc2 = Dense(c, c)
        self.ca = CALayer(c, reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc2(gelu(self.fc1(self.norm(x))))
        return x + self.ca(y)


class SpatialGatingWeights(nn.Module):
    def __init__(self, c: int, block_size: tuple, grid_size: tuple):
        super().__init__()
        self.block_size, self.grid_size = tuple(block_size), tuple(grid_size)
        self.norm_in = LayerNorm(c)
        self.in_project = Dense(c, 2 * c)
        gh, gw = grid_size
        fh, fw = block_size
        self.grid_proj = Dense(gh * gw, gh * gw)
        self.block_proj = Dense(fh * fw, fh * fw)
        self.out_project = Dense(2 * c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        u, v = gelu(self.in_project(self.norm_in(x))).chunk(2, dim=-1)
        gh, gw = self.grid_size
        fh, fw = h // gh, w // gw
        ub = self.grid_proj(to_blocks(u, fh, fw).transpose(-1, -3))
        u = from_blocks(ub.transpose(-1, -3), gh, gw, fh, fw)
        fh, fw = self.block_size
        vb = self.block_proj(to_blocks(v, fh, fw).transpose(-1, -2))
        v = from_blocks(vb.transpose(-1, -2), h // fh, w // fw, fh, fw)
        return self.out_project(torch.cat([u, v], dim=-1))


class CrossGatingBlock(nn.Module):
    """Each side gated by the other's spatial gating weights; with
    ``upsample_y`` y is first doubled by a 2x2 stride-2 transposed conv."""

    def __init__(self, cin_x: int, cin_y: int, features: int,
                 block_size: tuple, grid_size: tuple,
                 upsample_y: bool = True):
        super().__init__()
        f = features
        if upsample_y:
            self.y_up = ConvTranspose(cin_y, f, 2, 2)
            cin_y = f
        self.upsample_y = upsample_y
        self.x_proj = Conv1x1(cin_x, f)
        self.y_proj = Conv1x1(cin_y, f)
        self.norm_x = LayerNorm(f)
        self.in_project_x = Dense(f, f)
        self.gating_x = SpatialGatingWeights(f, block_size, grid_size)
        self.norm_y = LayerNorm(f)
        self.in_project_y = Dense(f, f)
        self.gating_y = SpatialGatingWeights(f, block_size, grid_size)
        self.out_project_y = Dense(f, f)
        self.out_project_x = Dense(f, f)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> tuple:
        if self.upsample_y:
            y = self.y_up(y)
        sx, sy = self.x_proj(x), self.y_proj(y)
        x = gelu(self.in_project_x(self.norm_x(sx)))
        gx = self.gating_x(x)
        y = gelu(self.in_project_y(self.norm_y(sy)))
        gy = self.gating_y(y)
        y = self.out_project_y(y * gx) + sy
        x = self.out_project_x(x * gy) + y + sx
        return x, y


class SAMBridge(nn.Module):
    def __init__(self, features: int, output_channels: int = 3):
        super().__init__()
        self.conv1 = Conv(features, features)
        self.conv_img = Conv(features, output_channels)
        self.conv_gate = Conv(output_channels, features)

    def forward(self, x: torch.Tensor, x_image: torch.Tensor) -> tuple:
        image = self.conv_img(x) + x_image
        gate = torch.sigmoid(self.conv_gate(image))
        return self.conv1(x) * gate + x, image


class MAXIM(nn.Module):
    def __init__(self, features: int = 32, depth: int = 3,
                 num_stages: int = 2, num_groups: int = 2,
                 num_supervision_scales: int = 1, high_res_stages: int = 2,
                 block_size_hr: tuple = (16, 16),
                 block_size_lr: tuple = (8, 8),
                 grid_size_hr: tuple = (16, 16),
                 num_bottleneck_blocks: int = 2,
                 channels_reduction: int = 4, num_outputs: int = 3):
        super().__init__()
        if num_supervision_scales != 1:
            raise ValueError("the port serves one supervision scale (every "
                             "registered MAXIM); got "
                             f"{num_supervision_scales}")
        self.depth, self.num_stages = depth, num_stages
        self.num_groups = num_groups
        self.num_bottleneck_blocks = num_bottleneck_blocks
        red = channels_reduction
        fts = [2 ** i * features for i in range(depth)]
        self.features = fts

        def sizes(level):
            if level < high_res_stages:
                return tuple(block_size_hr), tuple(grid_size_hr)
            return tuple(block_size_lr), tuple(block_size_lr)

        def add(name, mod):
            self.add_module(name, mod)

        for s in range(num_stages):
            p = f"stage{s}_"
            add(p + "input_conv_0", Conv(3, fts[0]))
            if s > 0:
                add(p + "input_fuse_sam_0",
                    CrossGatingBlock(fts[0], fts[0], fts[0], *sizes(0),
                                     upsample_y=False))
            for i, f in enumerate(fts):
                bs, gs = sizes(i)
                add(f"{p}enc{i}_in", Conv1x1(2 * f if i == 0
                                             else fts[i - 1], f))
                for g in range(num_groups):
                    add(f"{p}enc{i}_mab{g}", MAB(f, bs, gs))
                    add(f"{p}enc{i}_rcab{g}", RCAB(f, red))
                if s > 0:
                    add(f"{p}enc{i}_xgate", CrossGatingBlock(
                        f, f, f, bs, gs, upsample_y=False))
                add(f"{p}enc{i}_down", ConvLib(f, f, 4, stride=2))
            fb = fts[-1]
            for i in range(num_bottleneck_blocks):
                add(f"{p}bn{i}_in", Conv1x1(fb, fb))
                for g in range(num_groups):
                    add(f"{p}bn{i}_mab{g}", MAB(fb, block_size_lr,
                                                block_size_lr))
                    add(f"{p}bn{i}_rdcab{g}", RDCAB(fb, red))
            for i in reversed(range(depth)):
                f = fts[i]
                bs, gs = sizes(i)
                below = fts[min(i + 1, depth - 1)]
                for j in range(depth):
                    add(f"{p}sig{i}_from{j}", Conv1x1(fts[j], f))
                    add(f"{p}dsig{i}_from{j}",
                        Conv1x1(fts[depth - 1 - j], f))
                add(f"{p}xgate{i}", CrossGatingBlock(
                    depth * f, below, f, bs, gs, upsample_y=True))
                add(f"{p}dec{i}_up", ConvTranspose(below, f, 2, 2))
                add(f"{p}dec{i}_in", Conv1x1(f + depth * f, f))
                for g in range(num_groups):
                    add(f"{p}dec{i}_mab{g}", MAB(f, bs, gs))
                    add(f"{p}dec{i}_rcab{g}", RCAB(f, red))
            if s < num_stages - 1:
                add(p + "sam_0", SAMBridge(fts[0], num_outputs))
            else:
                add(p + "output_conv_0", Conv(fts[0], num_outputs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H, W, num_outputs); H and W multiples of the
        block size x 2^depth."""
        m = self._modules
        depth = self.depth
        sam = encs_prev = decs_prev = None
        for s in range(self.num_stages):
            p = f"stage{s}_"
            y = m[p + "input_conv_0"](x)
            if s > 0:
                y, _ = m[p + "input_fuse_sam_0"](y, sam)
            # the reference concatenates the scale input at level 0 too
            # (encoder block 0 sees [x, x])
            y = torch.cat([y, y], dim=-1)
            encs = []
            for i in range(depth):
                y = m[f"{p}enc{i}_in"](y)
                shortcut = y
                for g in range(self.num_groups):
                    y = m[f"{p}enc{i}_rcab{g}"](m[f"{p}enc{i}_mab{g}"](y))
                y = y + shortcut
                if s > 0:
                    y, _ = m[f"{p}enc{i}_xgate"](
                        y, encs_prev[i] + decs_prev[depth - 1 - i])
                encs.append(y)
                y = m[f"{p}enc{i}_down"](y)

            for i in range(self.num_bottleneck_blocks):
                y = m[f"{p}bn{i}_in"](y)
                shortcut = y
                for g in range(self.num_groups):
                    y = m[f"{p}bn{i}_rdcab{g}"](m[f"{p}bn{i}_mab{g}"](y))
                y = y + shortcut
            glob = y

            skips = []
            for i in reversed(range(depth)):
                signal = torch.cat([m[f"{p}sig{i}_from{j}"](
                    _resize(enc, 2.0 ** (j - i)))
                    for j, enc in enumerate(encs)], dim=-1)
                sk, glob = m[f"{p}xgate{i}"](signal, glob)
                skips.append(sk)

            decs = []
            for i in reversed(range(depth)):
                bridge = torch.cat([m[f"{p}dsig{i}_from{j}"](
                    _resize(sk, 2.0 ** (depth - j - 1 - i)))
                    for j, sk in enumerate(skips)], dim=-1)
                y = torch.cat([m[f"{p}dec{i}_up"](y), bridge], dim=-1)
                y = m[f"{p}dec{i}_in"](y)
                shortcut = y
                for g in range(self.num_groups):
                    y = m[f"{p}dec{i}_rcab{g}"](m[f"{p}dec{i}_mab{g}"](y))
                y = y + shortcut
                decs.append(y)
            if s < self.num_stages - 1:
                sam, _ = m[p + "sam_0"](y, x)
            else:
                out = m[p + "output_conv_0"](y) + x
            encs_prev, decs_prev = encs, decs
        return out


def _resize(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """The skip signals' ``jax.image.resize`` to ``int(size * ratio)``."""
    return resize_bilinear_jax(x, int(x.shape[1] * ratio),
                               int(x.shape[2] * ratio))


for _name, _cfg, _tasks in (
    ("maxim_s2", dict(features=32, depth=3, num_stages=2, num_groups=2,
                      num_bottleneck_blocks=2),
     ("denoising", "motion deblurring", "deraining", "dehazing")),
    ("maxim_s3", dict(features=32, depth=3, num_stages=3, num_groups=2,
                      num_bottleneck_blocks=2),
     ("deraining",)),
):
    register_model(ModelSpec(
        name=_name,
        build=lambda **kw: MAXIM(**kw),
        subtasks=_tasks,
        pad_multiple=64,  # block 16 x 2^2 downsampling
        pad_kind="symmetric",
        tile=None,
        config=_cfg,
    ))

register_model(ModelSpec(
    name="maxim_tiny",
    build=lambda **kw: MAXIM(**kw),
    subtasks=("dehazing",),
    pad_multiple=32, pad_kind="symmetric",
    tile=None,
    config=dict(features=8, depth=2, num_stages=2, num_groups=1,
                num_supervision_scales=1, high_res_stages=1,
                block_size_hr=(8, 8), block_size_lr=(4, 4),
                grid_size_hr=(4, 4), num_bottleneck_blocks=1),
))
