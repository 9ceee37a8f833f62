"""MUSIQ no-reference quality metric (counterpart of
``image_restoration_agent_tpu/iqa/musiq.py``).

The Multi-Scale Image Quality Transformer (google-research/musiq): the
image is scored at its own resolution plus aspect-ratio-preserving resizes
with longer side 224 and 384; each scale is cut into 32x32 patches which
are linearly encoded to a 384-d token; tokens get a hash-based 2D spatial
embedding (a 10x10 grid per scale) and a per-scale embedding; a CLS token
leads a 14-layer, 6-head pre-norm transformer (MLP 1152, LayerNorm eps
1e-6); quality = Linear(LN(CLS)).

Caveat kept from the JAX package: the released MUSIQ encodes patches with
a small conv root; this port, like the JAX one, ships the linear ViT-style
encoder (``patch_proj``) until a real checkpoint's shapes can be read.
Inputs are [0, 1] RGB. Parameter names are the JAX converter's flat ones
(``patch_proj``, ``hse_embedding``, ``scale_embedding``, ``cls_token``,
``blocks.{i}.*`` timm names, ``norm``, ``head``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.resize import resize_bilinear_jax
from ..device import exact_f32, resolve_device
from .vit import ViTBlock

PATCH = 32
HSE_GRID = 10


def _scale_sizes(h: int, w: int, longer_sides=(224, 384)) -> list:
    """(h, w) per scale: native first, then the aspect-ratio-preserving
    resizes (the TF musiq order: native, then each longer side)."""
    sizes = [(h, w)]
    for ls in longer_sides:
        r = ls / max(h, w)
        sizes.append((max(1, round(h * r)), max(1, round(w * r))))
    return sizes


def _grid(hp: int, wp: int) -> np.ndarray:
    """Patch-centre hash indices for an (hp x wp) patch grid."""
    rows = np.floor(np.arange(hp) / hp * HSE_GRID).astype(np.int32)
    cols = np.floor(np.arange(wp) / wp * HSE_GRID).astype(np.int32)
    rr, cc = np.meshgrid(rows, cols, indexing="ij")
    return (rr * HSE_GRID + cc).reshape(-1)


class MUSIQ(nn.Module):
    def __init__(self, hidden: int = 384, num_layers: int = 14,
                 num_heads: int = 6, mlp_dim: int = 1152,
                 num_scales: int = 3):
        super().__init__()
        self.patch_proj = nn.Linear(PATCH * PATCH * 3, hidden)
        self.hse_embedding = nn.Parameter(
            torch.randn(HSE_GRID * HSE_GRID, hidden) * 0.02)
        self.scale_embedding = nn.Parameter(
            torch.randn(num_scales, hidden) * 0.02)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.blocks = nn.ModuleList(
            ViTBlock(hidden, num_heads, mlp_ratio=mlp_dim / hidden)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(hidden, eps=1e-6)
        self.head = nn.Linear(hidden, 1)

    def forward(self, scales: list[torch.Tensor], hash_idx: torch.Tensor,
                scale_idx: torch.Tensor) -> torch.Tensor:
        """``scales``: (1, Np_s, 32*32*3) flattened patches per scale;
        ``hash_idx`` / ``scale_idx``: (sum Np,) spatial hash and scale of
        each patch. Returns (1,)."""
        if hash_idx.is_cuda:
            exact_f32()
        tokens = torch.cat([self.patch_proj(s) for s in scales], dim=1)
        tokens = tokens + self.hse_embedding[hash_idx][None] \
            + self.scale_embedding[scale_idx][None]
        x = torch.cat([self.cls_token.expand(tokens.shape[0], -1, -1),
                       tokens], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.norm(x)[:, 0])[:, 0]


def extract_patches(img: torch.Tensor, h: int, w: int):
    """Resize (H, W, 3) to (h, w) with ``jax.image.resize``'s bilinear
    (antialiased on a downscale), zero-pad to multiples of 32, and return
    the flattened 32x32 patches (1, Np, 32*32*3) with their hash indices
    (numpy)."""
    x = resize_bilinear_jax(img, h, w) if img.shape[:2] != (h, w) else img
    hp, wp = -(-h // PATCH), -(-w // PATCH)
    x = F.pad(x, (0, 0, 0, wp * PATCH - w, 0, hp * PATCH - h))
    x = x.reshape(hp, PATCH, wp, PATCH, 3).permute(0, 2, 1, 3, 4)
    return x.reshape(1, hp * wp, PATCH * PATCH * 3), _grid(hp, wp)


class MusiqScorer:
    """Scores a [0, 1] RGB image with the 3-scale MUSIQ protocol. ``state``
    None keeps ``model``'s own weights."""

    def __init__(self, state: dict | None, model: MUSIQ | None = None,
                 longer_sides=(224, 384),
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model or MUSIQ()
        if state is not None:
            self.model.load_state_dict(state, strict=True)
        self.model = self.model.to(self.device, torch.float32).eval()
        self.longer_sides = tuple(longer_sides)

    @torch.no_grad()
    def __call__(self, img: np.ndarray) -> float:
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)) \
            .to(self.device)
        sizes = _scale_sizes(x.shape[0], x.shape[1], self.longer_sides)
        scales, hashes, sids = [], [], []
        for si, (sh, sw) in enumerate(sizes):
            patches, hidx = extract_patches(x, sh, sw)
            scales.append(patches)
            hashes.append(hidx)
            sids.append(np.full(hidx.shape, si, np.int64))
        hash_idx = torch.from_numpy(np.concatenate(hashes).astype(np.int64))
        scale_idx = torch.from_numpy(np.concatenate(sids))
        return float(self.model(scales, hash_idx.to(self.device),
                                scale_idx.to(self.device))[0])
