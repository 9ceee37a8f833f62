"""Vision Transformer trunk returning every block's tokens (counterpart of
``image_restoration_agent_tpu/iqa/vit.py``).

MANIQA's trunk is timm's ``vit_base_patch8_224`` with forward hooks saving
every block's output; the quality head reads blocks 6..9. This is timm's
graph (pre-norm blocks, a learned position embedding including CLS, an
exact-erf GELU MLP, LayerNorm eps 1e-6) under timm's names
(``patch_embed.proj``, ``cls_token``, ``pos_embed``,
``blocks.{i}.norm1`` / ``attn.qkv`` / ``attn.proj`` / ``norm2`` /
``mlp.fc1`` / ``mlp.fc2``). The final norm and the classifier head are not
read by MANIQA's taps and are not built.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ViTMlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # exact erf form


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, N, C)
        b, n, c = x.shape
        hd = c // self.num_heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, hd) \
            .permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q @ k.transpose(-1, -2)) * hd ** -0.5, -1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = ViTMlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, patch_size)


class ViT(nn.Module):
    """timm-style ViT: ``forward`` of (B, H, W, 3) returns the list of
    every block's tokens (CLS first), post-block and before any final norm:
    the hook contract MANIQA's ``SaveOutput`` uses."""

    def __init__(self, patch_size: int = 8, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, img_size: int = 224):
        super().__init__()
        n = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.randn(1, n + 1, embed_dim) * .02)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio) for _ in range(depth))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # (B, N, C)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], 1)
        x = x + self.pos_embed
        outs = []
        for blk in self.blocks:
            x = blk(x)
            outs.append(x)
        return outs
