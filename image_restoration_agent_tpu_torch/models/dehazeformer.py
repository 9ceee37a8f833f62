"""DehazeFormer, channels-last (counterpart of
``image_restoration_agent_tpu/models/dehazeformer.py``; reference
DehazeFormer/models/dehazeformer.py).

A 5-stage U of DehazeFormer blocks at widths (24, 48, 96, 48, 24) for the
t/s/b variants, with the reference's pieces:

- RLN: statistics over the whole sample (H, W, C), and 1x1 meta convs that
  map the std and mean to a per-channel rescale and rebias, applied after
  the block's attention branch;
- attention with a parallel depthwise-conv path: ``proj(conv5x5(V) +
  window_attention(QK, V))``; shifted windows come from reflect-padding
  ``shift`` pixels at the top-left, with no mask;
- a continuous relative-position bias: log-spaced relative coordinates
  through a 2 -> 256 -> heads MLP;
- SKFusion skip merging and the ``K * x - B + x`` head.

Window attention runs :func:`ops.swin_block.wmsa` (K2 with the logit scale
on the card), the function the JAX package runs through ``wmsa_pallas`` on
the TPU: q unscaled, the float32 product scaled by ``head_dim**-0.5``. The
reflect-padded convs (``patch_embed``, ``patch_unembed``, the 5x5
depthwise conv) and the 2x2 stride-2 patch merges are library convs, 1x1
convs are matmuls over channels (:class:`common.Conv1x1`), as the JAX
package runs all of them through XLA.

bf16 cast points, the JAX package's (its engine casts every parameter to
bf16): each conv's output is rounded before its bias is added in bf16;
RLN's statistics and normalization are float32, its output is cast to
bf16, and the std and mean are cast to bf16 before the meta convs; the
bias MLP takes the float32 log coordinates with the bf16-rounded weights
and computes in float32 (flax's promotion), and the bias enters the
attention in float32.

Module names are the reference's state-dict names
(``layer1.blocks.0.attn.QK.weight``, ``...attn.attn.meta.0.weight``,
``...norm1.meta1.weight``, ``fusion1.mlp.0.weight``). A block holds
``norm1`` only where it runs attention, and no ``norm2`` (the reference's
are ``nn.Identity``); the reference's ``relative_positions`` buffers are
recomputed, not held.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import exact_f32
from ..ops.pixel_shuffle import pixel_shuffle
from ..ops.swin_block import wmsa
from ..ops.window_attention import window_partition, window_reverse
from .common import Conv1x1
from .registry import ModelSpec, register_model


@functools.lru_cache(maxsize=16)
def _log_relative_positions(ws: int) -> np.ndarray:
    """(N, N, 2) sign(d) * log(1 + |d|) relative coordinates."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    return (np.sign(rel) * np.log1p(np.abs(rel))).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _reflect_index(n: int, lo: int, hi: int,
                   device: torch.device) -> torch.Tensor:
    """Source rows of a reflect pad, periodic as ``np.pad``'s for pads as
    wide as the side or wider; kept per device, so a request launches
    only the gather."""
    i = np.arange(-lo, n + hi)
    if n == 1:
        i = np.zeros_like(i)
    else:
        i = np.remainder(i, 2 * (n - 1))
        i = np.minimum(i, 2 * (n - 1) - i)
    return torch.from_numpy(i).to(device)


def reflect_pad(x: torch.Tensor, top: int, bottom: int, left: int,
                right: int) -> torch.Tensor:
    """``jnp.pad(..., mode="reflect")`` of a (B, H, W, C) tensor on H and W
    (the edge pixel not repeated), as one gather."""
    if not (top or bottom or left or right):
        return x
    ih = _reflect_index(x.shape[1], top, bottom, x.device)
    iw = _reflect_index(x.shape[2], left, right, x.device)
    return x[:, ih[:, None], iw[None, :]]


class RConv(nn.Module):
    """A conv with reflect padding of ``(k - 1) // 2`` on each side (none
    for the 2x2 stride-2 patch merge), then a VALID library conv; the bias
    is added after the conv's output is rounded to ``x``'s dtype.
    Reference ``Conv2d(cin, cout, k, stride, groups=groups)`` layout."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride = stride
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = (self.weight.shape[-1] - 1) // 2
        x = reflect_pad(x, p, p, p, p)
        if x.is_cuda and x.dtype == torch.float32:
            exact_f32()
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                     stride=self.stride, groups=self.groups)
        return y.permute(0, 2, 3, 1) + self.bias.to(x.dtype)


class RLN(nn.Module):
    """Revised LayerNorm: whole-sample statistics in float32, the affine
    ``weight`` / ``bias`` (reference shape (1, C, 1, 1)), and the meta
    convs' rescale and rebias, returned for use after the branch."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(1, dim, 1, 1))
        self.bias = nn.Parameter(torch.empty(1, dim, 1, 1))
        self.meta1 = Conv1x1(1, dim)
        self.meta2 = Conv1x1(1, dim)

    def forward(self, x: torch.Tensor):
        xf = x.float()
        mean = xf.mean(dim=(1, 2, 3), keepdim=True)
        std = torch.sqrt((xf - mean).square().mean(dim=(1, 2, 3),
                                                   keepdim=True) + self.eps)
        out = ((xf - mean) / std * self.weight.float().reshape(-1)
               + self.bias.float().reshape(-1)).to(x.dtype)
        return out, self.meta1(std.to(x.dtype)), self.meta2(mean.to(x.dtype))


class WindowAttention(nn.Module):
    """Window MHSA over packed (nWB, N, 3C) qkv with the continuous
    relative-position bias (``meta``: Linear 2 -> 256, ReLU, Linear 256 ->
    heads)."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.meta = nn.Sequential(nn.Linear(2, 256), nn.ReLU(),
                                  nn.Linear(256, num_heads))
        self._rel: torch.Tensor | None = None  # float32 whatever the dtype

    def bias(self, device) -> torch.Tensor:
        """The (heads, N, N) float32 bias: the MLP in float32 with the
        parameters as held (bf16-rounded in a bf16 model)."""
        if device.type == "cuda":
            exact_f32()
        if self._rel is None or self._rel.device != device:
            # kept per device: a copy from the host at every call would
            # wait for the stream
            self._rel = torch.from_numpy(
                _log_relative_positions(self.window_size)).to(device)
        fc1, fc2 = self.meta[0], self.meta[2]
        y = torch.relu(F.linear(self._rel, fc1.weight.float(),
                                fc1.bias.float()))
        y = F.linear(y, fc2.weight.float(), fc2.bias.float())
        return y.permute(2, 0, 1).contiguous()

    def forward(self, qkv: torch.Tensor) -> torch.Tensor:
        return wmsa(qkv, self.bias(qkv.device), num_heads=self.num_heads)


class Attention(nn.Module):
    """Window attention with the parallel conv path (the reference's
    ``conv_type`` "DWConv", the one every registered variant runs): a 5x5
    reflect depthwise conv on V."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, use_attn: bool):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.use_attn = use_attn
        self.conv = RConv(dim, dim, 5, groups=dim)
        self.V = Conv1x1(dim, dim)
        self.proj = Conv1x1(dim, dim)
        if use_attn:
            self.QK = Conv1x1(dim, 2 * dim)
            self.attn = WindowAttention(dim, window_size, num_heads)

    def _qkv(self, x: torch.Tensor) -> torch.Tensor:
        """[QK(x) | V(x)] as one matmul (each column the same dot product
        and bias add as the two convs')."""
        w = torch.cat([self.QK.matrix(), self.V.matrix()], 1).to(x.dtype)
        b = torch.cat([self.QK.bias, self.V.bias]).to(x.dtype)
        if x.is_cuda and x.dtype == torch.float32:
            exact_f32()
        return x @ w + b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, c = x.shape
        if not self.use_attn:
            return self.proj(self.conv(self.V(x)))
        ws, ss = self.window_size, self.shift_size
        qkv = self._qkv(x)
        ph, pw = -h % ws, -w % ws
        if ss > 0:
            pads = (ss, (ws - ss + ph) % ws, ss, (ws - ss + pw) % ws)
        else:
            pads = (0, ph, 0, pw)
        shifted = reflect_pad(qkv, *pads)
        ht, wt = shifted.shape[1], shifted.shape[2]
        windows = window_partition(shifted, ws).reshape(-1, ws * ws, 3 * c)
        out = self.attn(windows)
        out = window_reverse(out.reshape(-1, ws, ws, c), ws, ht, wt)
        out = out[:, ss:ss + h, ss:ss + w]
        return self.proj(self.conv(qkv[..., 2 * c:]) + out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.mlp = nn.Sequential(Conv1x1(dim, hidden), nn.ReLU(),
                                 Conv1x1(hidden, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class TransformerBlock(nn.Module):
    """``x + (attn(RLN(x)) * rescale + rebias)`` (no RLN without attention),
    then ``x + mlp(x)``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 window_size: int, shift_size: int, use_attn: bool):
        super().__init__()
        self.use_attn = use_attn
        self.norm1 = RLN(dim) if use_attn else None
        self.attn = Attention(dim, num_heads, window_size, shift_size,
                              use_attn)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_attn:
            y, rescale, rebias = self.norm1(x)
            x = x + (self.attn(y) * rescale + rebias)
        else:
            x = x + self.attn(x)
        return x + self.mlp(x)


class BasicLayer(nn.Module):
    """``depth`` blocks, every other one shifted by ``window_size // 2``;
    the last ``attn_ratio * depth`` of them run attention (the reference's
    ``attn_loc == "last"``, a float comparison)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 mlp_ratio: float, window_size: int, attn_ratio: float):
        super().__init__()
        attn_depth = attn_ratio * depth
        self.blocks = nn.ModuleList([
            TransformerBlock(dim, num_heads, mlp_ratio, window_size,
                             0 if i % 2 == 0 else window_size // 2,
                             use_attn=i >= depth - attn_depth)
            for i in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


class PatchEmbed(nn.Module):
    """``patch_embed`` (3x3 reflect conv) and the 2x2 stride-2 patch
    merges."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.proj = RConv(cin, cout, kernel, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class PatchUnEmbed(nn.Module):
    """A conv (``proj.0``: 1x1 for the patch splits, 3x3 reflect for
    ``patch_unembed``), then ``pixel_shuffle(patch)``."""

    def __init__(self, cin: int, cout: int, kernel: int, patch: int):
        super().__init__()
        conv = Conv1x1(cin, cout * patch * patch) if kernel == 1 \
            else RConv(cin, cout * patch * patch, kernel)
        self.proj = nn.ModuleList([conv])
        self.patch = patch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj[0](x)
        return pixel_shuffle(y, self.patch) if self.patch > 1 else y


class SKFusion(nn.Module):
    """Selective-kernel fusion of ``height`` branches: channel weights from
    the pooled sum through a bias-free 1x1 MLP, softmax over the branch
    axis."""

    def __init__(self, dim: int, height: int = 2, reduction: int = 8):
        super().__init__()
        d = max(dim // reduction, 4)
        self.height = height
        self.mlp = nn.Sequential(Conv1x1(dim, d, bias=False), nn.ReLU(),
                                 Conv1x1(d, dim * height, bias=False))

    def forward(self, feats: list) -> torch.Tensor:
        stacked = torch.stack(feats, dim=1)  # (B, height, H, W, C)
        b, c = stacked.shape[0], stacked.shape[-1]
        pooled = stacked.sum(dim=1).mean(dim=(1, 2), keepdim=True)
        a = self.mlp(pooled).reshape(b, 1, 1, self.height, c)
        a = torch.softmax(a, dim=-2).permute(0, 3, 1, 2, 4)
        return (stacked * a).sum(dim=1)


class DehazeFormer(nn.Module):
    def __init__(self, in_chans: int = 3, out_chans: int = 4,
                 window_size: int = 8,
                 embed_dims: Sequence[int] = (24, 48, 96, 48, 24),
                 mlp_ratios: Sequence[float] = (2.0, 4.0, 4.0, 2.0, 2.0),
                 depths: Sequence[int] = (8, 8, 8, 4, 4),
                 num_heads: Sequence[int] = (2, 4, 6, 1, 1),
                 attn_ratio: Sequence[float] = (0.25, 0.5, 0.75, 0.0, 0.0)):
        super().__init__()
        d = embed_dims

        def layer(i):
            return BasicLayer(d[i], depths[i], num_heads[i], mlp_ratios[i],
                              window_size, attn_ratio[i])

        self.patch_embed = PatchEmbed(in_chans, d[0], 3)
        self.layer1 = layer(0)
        self.patch_merge1 = PatchEmbed(d[0], d[1], 2, stride=2)
        self.skip1 = Conv1x1(d[0], d[0])
        self.layer2 = layer(1)
        self.patch_merge2 = PatchEmbed(d[1], d[2], 2, stride=2)
        self.skip2 = Conv1x1(d[1], d[1])
        self.layer3 = layer(2)
        self.patch_split1 = PatchUnEmbed(d[2], d[3], 1, 2)
        self.fusion1 = SKFusion(d[3])
        self.layer4 = layer(3)
        self.patch_split2 = PatchUnEmbed(d[3], d[4], 1, 2)
        self.fusion2 = SKFusion(d[4])
        self.layer5 = layer(4)
        self.patch_unembed = PatchUnEmbed(d[4], out_chans, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H, W, 3): reflect pad to a multiple of 4,
        the U, ``K * x - B + x``, crop."""
        h, w = x.shape[1], x.shape[2]
        x = reflect_pad(x, 0, -h % 4, 0, -w % 4)
        y = self.layer1(self.patch_embed(x))
        skip1 = y
        y = self.layer2(self.patch_merge1(y))
        skip2 = y
        y = self.layer3(self.patch_merge2(y))
        y = self.patch_split1(y)
        y = self.fusion1([y, self.skip2(skip2)]) + y
        y = self.layer4(y)
        y = self.patch_split2(y)
        y = self.fusion2([y, self.skip1(skip1)]) + y
        feat = self.patch_unembed(self.layer5(y))
        k, bias = feat[..., :1], feat[..., 1:]
        return (k * x - bias + x)[:, :h, :w]


_VARIANTS = {
    "t": dict(depths=(4, 4, 4, 2, 2), attn_ratio=(0, 0.5, 1.0, 0, 0)),
    "s": dict(depths=(8, 8, 8, 4, 4), attn_ratio=(0.25, 0.5, 0.75, 0, 0)),
    "b": dict(depths=(16, 16, 16, 8, 8), attn_ratio=(0.25, 0.5, 0.75, 0, 0)),
}

for _v, _cfg in _VARIANTS.items():
    register_model(ModelSpec(
        name=f"dehazeformer_{_v}",
        build=lambda **kw: DehazeFormer(**kw),
        subtasks=("dehazing",),
        pad_multiple=4, pad_kind="reflect",
        tile=None,
        config=dict(_cfg),
    ))

register_model(ModelSpec(
    name="dehazeformer_tiny",  # CPU-testable
    build=lambda **kw: DehazeFormer(**kw),
    subtasks=("dehazing",),
    pad_multiple=4, pad_kind="reflect",
    tile=None,
    config=dict(embed_dims=(8, 16, 32, 16, 8), depths=(1, 1, 2, 1, 1),
                attn_ratio=(0, 0.5, 1.0, 0, 0), num_heads=(1, 2, 2, 1, 1)),
))
