"""MANIQA no-reference quality metric (counterpart of
``image_restoration_agent_tpu/iqa/maniqa.py``).

The official MANIQA (IIGROUP/MANIQA, CVPRW'22) that pyiqa vendors: a
ViT-B/8 trunk whose blocks 6..9 token features are concatenated, then

    (B, 4*768, 28, 28)
    -> 2x TABlock (transposed channel self-attention over N=784 tokens)
    -> 1x1 conv 3072->768 -> Swin stage (depth 2, heads 4, window 4)
    -> 2x TABlock -> 1x1 conv 768->384 -> Swin stage
    -> per-patch score (ReLU head) x weight (Sigmoid head),
    quality = sum(score*weight)/sum(weight).

Inference as pyiqa's: input normalized with mean and std 0.5, the score
averaged over ``n_crops`` random 224x224 crops. Each Swin stage has the
scaled residual ``scale * stage(x) + x`` (the official swin.py, scale 0.8).

Parameter names are the official checkpoint's (``vit.*`` timm names,
``tablock1.{i}.c_q``, ``conv1``, ``swintransformer1.layers.{l}.blocks.{b}
.attn.qkv``, ``fc_score.0`` / ``.3``...); each Swin block keeps its
``attn.relative_position_index`` as a buffer in the state dict, as the
official one does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.resize import resize_bicubic_jax
from ..device import exact_f32, resolve_device
from ..ops.window_attention import (relative_position_index,
                                    shift_attention_mask, window_partition,
                                    window_reverse)
from .vit import ViT


class TABlock(nn.Module):
    """Transposed attention: tokens attend over the CHANNEL axis. Input
    (B, C, N); q, k, v are linears over N; attention is (B, C, C); a
    residual add."""

    def __init__(self, dim: int):  # dim = N, the token count
        super().__init__()
        self.c_q = nn.Linear(dim, dim)
        self.c_k = nn.Linear(dim, dim)
        self.c_v = nn.Linear(dim, dim)
        self.norm_fact = dim ** -0.5

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, N)
        q, k, v = self.c_q(x), self.c_k(x), self.c_v(x)
        attn = torch.softmax((q @ k.transpose(-1, -2)) * self.norm_fact, -1)
        return attn @ v + x


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size).astype(np.int64)))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None) -> torch.Tensor:  # (nWB, N, C)
        bw, n, c = x.shape
        hd = c // self.num_heads
        q, k, v = self.qkv(x).reshape(bw, n, 3, self.num_heads, hd) \
            .permute(2, 0, 3, 1, 4)
        attn = (q @ k.transpose(-1, -2)) * hd ** -0.5
        rpb = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(n, n, -1)
        attn = attn + rpb.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.view(-1, nw, self.num_heads, n, n)
                    + mask[None, :, None]).view(-1, self.num_heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(bw, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # exact erf form


class ManiqaSwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: int, dim_mlp: int):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, dim_mlp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        b, h, w, c = x.shape
        ws, s = self.window_size, self.shift
        y = self.norm1(x)
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        mask = shift_attention_mask(h, w, ws, s)
        if mask is not None:
            mask = torch.from_numpy(mask).to(x.device)
        o = self.attn(window_partition(y, ws).reshape(-1, ws * ws, c), mask)
        y = window_reverse(o.reshape(-1, ws, ws, c), ws, h, w)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, dim_mlp: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            ManiqaSwinBlock(dim, num_heads, window_size,
                            0 if i % 2 == 0 else window_size // 2, dim_mlp)
            for i in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


class ManiqaSwinTransformer(nn.Module):
    """MANIQA's light Swin: ``len(depths)`` BasicLayers at a constant dim
    (no patch merging), each a stack of shifted-window blocks, with the
    scaled residual ``scale * layer(x) + x`` around every layer."""

    def __init__(self, dim: int, depths: tuple, num_heads: tuple,
                 window_size: int, dim_mlp: int, scale: float = 0.8):
        super().__init__()
        self.scale = scale
        self.layers = nn.ModuleList(
            BasicLayer(dim, d, heads, window_size, dim_mlp)
            for d, heads in zip(depths, num_heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        for layer in self.layers:
            x = self.scale * layer(x) + x
        return x


class MANIQA(nn.Module):
    def __init__(self, embed_dim: int = 768, patch_size: int = 8,
                 img_size: int = 224, depths: tuple = (2, 2),
                 num_heads: tuple = (4, 4), window_size: int = 4,
                 dim_mlp: int = 768, num_tab: int = 2, scale: float = 0.8,
                 vit_depth: int = 12, vit_heads: int = 12,
                 feature_blocks: tuple = (6, 7, 8, 9)):
        super().__init__()
        self.img_size = img_size
        self.res = img_size // patch_size
        n = self.res * self.res
        self.feature_blocks = tuple(feature_blocks)
        self.vit = ViT(patch_size, embed_dim, vit_depth, vit_heads,
                       img_size=img_size)
        self.tablock1 = nn.ModuleList(TABlock(n) for _ in range(num_tab))
        self.conv1 = nn.Conv2d(embed_dim * len(self.feature_blocks),
                               embed_dim, 1)
        self.swintransformer1 = ManiqaSwinTransformer(
            embed_dim, depths, num_heads, window_size, dim_mlp, scale)
        self.tablock2 = nn.ModuleList(TABlock(n) for _ in range(num_tab))
        self.conv2 = nn.Conv2d(embed_dim, embed_dim // 2, 1)
        self.swintransformer2 = ManiqaSwinTransformer(
            embed_dim // 2, depths, num_heads, window_size, dim_mlp, scale)
        half = embed_dim // 2
        self.fc_score = nn.Sequential(nn.Linear(half, half), nn.ReLU(),
                                      nn.Dropout(0.1), nn.Linear(half, 1),
                                      nn.ReLU())
        self.fc_weight = nn.Sequential(nn.Linear(half, half), nn.ReLU(),
                                       nn.Dropout(0.1), nn.Linear(half, 1),
                                       nn.Sigmoid())

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """(B, C, N) tokens -> 1x1 conv -> (B, res, res, C') NHWC."""
        b = x.shape[0]
        x = conv(x.reshape(b, -1, self.res, self.res))
        return x.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 224, 224, 3) normalized -> (B,) quality."""
        if x.is_cuda:
            exact_f32()
        outs = self.vit(x)
        x = torch.cat([outs[i][:, 1:] for i in self.feature_blocks], dim=2)
        x = x.transpose(1, 2)  # (B, C, N)
        for tab in self.tablock1:
            x = tab(x)
        x = self.swintransformer1(self._conv(self.conv1, x))
        x = x.flatten(1, 2).transpose(1, 2)
        for tab in self.tablock2:
            x = tab(x)
        x = self.swintransformer2(self._conv(self.conv2, x))
        x = x.flatten(1, 2)  # (B, N, C/2) token-major
        s, w = self.fc_score(x), self.fc_weight(x)
        return (torch.sum(s * w, dim=1) / torch.sum(w, dim=1))[:, 0]


class ManiqaScorer:
    """pyiqa-style inference: normalize (0.5, 0.5), average over
    ``n_crops`` random 224 crops drawn from ``np.random.default_rng(seed)``
    as the JAX package draws them; an image under 224 px on a side is
    first upscaled with ``jax.image.resize``'s bicubic. ``state`` None keeps
    ``model``'s own weights."""

    def __init__(self, state: dict | None, model: MANIQA | None = None,
                 n_crops: int = 20, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model or MANIQA()
        if state is not None:
            self.model.load_state_dict(state, strict=True)
        self.model = self.model.to(self.device, torch.float32).eval()
        self.n_crops = n_crops
        self.seed = seed

    def crops(self, img: np.ndarray) -> torch.Tensor:
        """The normalized (n_crops, 224, 224, 3) batch on the device."""
        size = self.model.img_size
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)) \
            .to(self.device)
        h, w = x.shape[:2]
        if h < size or w < size:
            sc = size / min(h, w)
            h, w = max(size, round(h * sc)), max(size, round(w * sc))
            x = resize_bicubic_jax(x, h, w)
        rng = np.random.default_rng(self.seed)
        crops = []
        for _ in range(self.n_crops):
            top = int(rng.integers(0, h - size + 1))
            left = int(rng.integers(0, w - size + 1))
            crops.append(x[top:top + size, left:left + size])
        return (torch.stack(crops) - 0.5) / 0.5

    @torch.no_grad()
    def __call__(self, img: np.ndarray) -> float:
        return float(self.model(self.crops(img)).mean())
