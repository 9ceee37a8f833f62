"""CLIP ResNet (image + text towers) in PyTorch (counterpart of
``image_restoration_agent_tpu/retrieval/clip.py``).

The retrieval trunk the reference loads with ``clip.load``: a
ModifiedResNet visual tower (anti-aliased strides through average pools, an
attention-pooling head) and a causal text transformer with QuickGELU, both
projecting into the shared space the Combiner fuses. Parameter names are
the published checkpoint's (``visual.layer1.0.conv1.weight``,
``visual.attnpool.q_proj``, ``transformer.resblocks.0.attn.in_proj_weight``,
``token_embedding.weight``, ``text_projection``, ``logit_scale``...), so an
OpenAI CLIP state dict loads with ``strict=True``.

Inference only: the BatchNorms are frozen and computed as the JAX package's
``FrozenBN`` does (``x * inv + (bias - mean * inv)``, ``inv = weight /
sqrt(var + 1e-5)``). The JAX package's numerics are kept where they differ
from the original CLIP: the text tower's LayerNorms use Flax's default eps
1e-6 (CLIP's are 1e-5). The convs are library convs: the JAX package runs
them as XLA convs, not Pallas kernels.

Modules take channels-last input, ``(B, H, W, 3)`` CLIP-normalized, and
compute NCHW inside.

RN50x4 shape card: vision layers (4, 6, 10, 6), vision width 80 (stage
widths 80/160/320/640, final 2560), input 288x288, attnpool heads 40;
text width 640, 12 layers, 10 heads, vocab 49408, context 77; shared
embed dim 640.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.resize import resize_bicubic_jax
from ..device import exact_f32

# CLIP preprocessing constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class FrozenBN(nn.BatchNorm2d):
    """BatchNorm at inference with the running statistics folded as the
    JAX package folds them (its parameters ``scale``, ``bias``, ``mean``,
    ``var`` are this module's ``weight``, ``bias``, ``running_mean``,
    ``running_var``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, H, W)
        inv = self.weight / torch.sqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


class Bottleneck(nn.Module):
    """ModifiedResNet block: every conv has stride 1; the stride is an
    average pool before ``conv3`` and in the downsample branch."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBN(planes)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBN(planes * 4)
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride)),
                ("0", nn.Conv2d(inplanes, planes * 4, 1, bias=False)),
                ("1", FrozenBN(planes * 4))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(self.avgpool(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, c = t.shape
    return t.reshape(b, n, heads, c // heads).transpose(1, 2)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            heads: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-head attention of (B, Nq, C) queries over (B, N, C) keys and
    values: logits scaled by 1/sqrt(head width), softmax, (B, Nq, C)."""
    b, nq, c = q.shape
    qh, kh, vh = _heads(q, heads), _heads(k, heads), _heads(v, heads)
    logits = qh @ kh.transpose(-1, -2) / math.sqrt(c // heads)
    if mask is not None:
        logits = logits + mask
    out = torch.softmax(logits, dim=-1) @ vh
    return out.transpose(1, 2).reshape(b, nq, c)


class AttentionPool2d(nn.Module):
    """Attention pooling with the mean token alone as the query (CLIP's
    ``AttentionPool2d``). ``use_pos_embed=False`` has no positional
    embedding, so the pool takes any grid: CLIP-IQA runs CLIP at the
    image's own resolution."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int, use_pos_embed: bool = True):
        super().__init__()
        if use_pos_embed:
            self.positional_embedding = nn.Parameter(
                torch.randn(spacial_dim ** 2 + 1, embed_dim)
                / embed_dim ** 0.5)
        else:
            self.positional_embedding = None
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)
        self.num_heads = num_heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, H, W)
        tokens = x.flatten(2).transpose(1, 2)  # (B, HW, C)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], 1)
        if self.positional_embedding is not None:
            tokens = tokens + self.positional_embedding[None]
        out = _attend(self.q_proj(tokens[:, :1]), self.k_proj(tokens),
                      self.v_proj(tokens), self.num_heads)
        return self.c_proj(out[:, 0])


class ModifiedResNet(nn.Module):
    def __init__(self, layers: Sequence[int] = (4, 6, 10, 6),
                 output_dim: int = 640, heads: int = 40,
                 input_resolution: int = 288, width: int = 80,
                 attnpool_pos: bool = True):
        super().__init__()
        # 3-conv stem, stride 2 on the first, then an average pool of 2
        self.conv1 = nn.Conv2d(3, width // 2, 3, 2, 1, bias=False)
        self.bn1 = FrozenBN(width // 2)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, 1, 1, bias=False)
        self.bn2 = FrozenBN(width // 2)
        self.conv3 = nn.Conv2d(width // 2, width, 3, 1, 1, bias=False)
        self.bn3 = FrozenBN(width)
        self.avgpool = nn.AvgPool2d(2)
        inplanes = width
        for li, n in enumerate(layers):
            planes = width * 2 ** li
            blocks = []
            for bi in range(n):
                blocks.append(Bottleneck(inplanes, planes,
                                         2 if bi == 0 and li > 0 else 1))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.depth = len(layers)
        self.attnpool = AttentionPool2d(input_resolution // 32, inplanes,
                                        heads, output_dim, attnpool_pos)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, 3)
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = self.avgpool(x)
        for li in range(self.depth):
            x = getattr(self, f"layer{li + 1}")(x)
        return self.attnpool(x)


class MultiheadAttention(nn.Module):
    """Self-attention with ``nn.MultiheadAttention``'s parameter names
    (``in_proj_weight``, ``in_proj_bias``, ``out_proj``), computed as the
    JAX package's block does."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        self.heads = heads
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None) -> torch.Tensor:
        q, k, v = F.linear(x, self.in_proj_weight,
                           self.in_proj_bias).chunk(3, dim=-1)
        return self.out_proj(_attend(q, k, v, self.heads, mask))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.attn = MultiheadAttention(width, heads)
        self.ln_1 = nn.LayerNorm(width, eps=1e-6)  # Flax's default
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width)),
            ("c_proj", nn.Linear(4 * width, width))]))
        self.ln_2 = nn.LayerNorm(width, eps=1e-6)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None) -> torch.Tensor:  # (B, T, C)
        x = x + self.attn(self.ln_1(x), mask)
        y = quick_gelu(self.mlp.c_fc(self.ln_2(x)))
        return x + self.mlp.c_proj(y)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers))

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x, mask)
        return x


class TextTransformer(nn.Module):
    """The causal text tower: token and position embeddings, the
    transformer, ``ln_final``, and the projection of the EOT token's
    feature. Its parameters are the published CLIP's top-level ones, so
    ``CLIPModel`` is this class with the visual tower added."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 640, layers: int = 12, heads: int = 10,
                 embed_dim: int = 640):
        super().__init__()
        self.context_length = context_length
        self.transformer = Transformer(width, layers, heads)
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.randn(context_length, width) * 0.01)
        self.ln_final = nn.LayerNorm(width, eps=1e-6)  # Flax's default
        self.text_projection = nn.Parameter(
            torch.randn(width, embed_dim) * width ** -0.5)

    def encode_text(self, text_ids: torch.Tensor) -> torch.Tensor:
        """(B, T) token ids (int) -> (B, embed_dim)."""
        if text_ids.is_cuda:
            exact_f32()
        t = text_ids.shape[1]
        x = self.token_embedding(text_ids) + self.positional_embedding[:t]
        mask = torch.full((t, t), float("-inf"),
                          device=x.device).triu(1)
        x = self.ln_final(self.transformer(x, mask))
        # the feature at the EOT token, the highest id in CLIP's vocab
        x = x[torch.arange(x.shape[0], device=x.device),
              text_ids.argmax(dim=-1)]
        return x @ self.text_projection

    def forward(self, text_ids: torch.Tensor) -> torch.Tensor:
        return self.encode_text(text_ids)


class CLIPModel(TextTransformer):
    """Both towers: ``encode_image`` on (B, H, W, 3) CLIP-normalized
    images, ``encode_text`` on (B, T) token ids (int)."""

    def __init__(self, embed_dim: int = 640,
                 vision_layers: Sequence[int] = (4, 6, 10, 6),
                 vision_width: int = 80, image_resolution: int = 288,
                 text_width: int = 640, text_layers: int = 12,
                 text_heads: int = 10, vocab_size: int = 49408,
                 context_length: int = 77, attnpool_pos: bool = True):
        super().__init__(vocab_size, context_length, text_width,
                         text_layers, text_heads, embed_dim)
        self.attnpool_pos = attnpool_pos
        self.visual = ModifiedResNet(
            tuple(vision_layers), embed_dim, vision_width * 32 // 64,
            image_resolution, vision_width, attnpool_pos)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        if image.is_cuda:
            exact_f32()
        return self.visual(image)

    def forward(self, image: torch.Tensor, text_ids: torch.Tensor):
        return self.encode_image(image), self.encode_text(text_ids)


def preprocess(img, n_px: int = 288,
               target_ratio: float | None = None) -> torch.Tensor:
    """[0, 1] (H, W, 3) float image (numpy, or a tensor on any device) ->
    CLIP-normalized (n_px, n_px, 3) float32 tensor on the image's device
    (numpy: the CPU).

    ``target_ratio=None``: CLIP's resize of the shorter side and centre
    crop. With a ratio (the reference's 'targetpad', CLIP4CIR data_utils):
    pad symmetrically with zeros to cap the aspect ratio, then resize to
    the square. Resizes are ``jax.image.resize``'s bicubic (antialiased
    on a downscale), as the JAX package's."""
    x = torch.as_tensor(np.asarray(img, np.float32)) if isinstance(
        img, np.ndarray) else img.float()
    h, w = x.shape[:2]
    if target_ratio is not None:
        actual = max(w, h) / min(w, h)
        if actual >= target_ratio:
            scaled = max(w, h) / target_ratio
            hp = max(int((scaled - w) / 2), 0)  # int() truncates
            vp = max(int((scaled - h) / 2), 0)
            x = F.pad(x, (0, 0, hp, hp, vp, vp))
        x = resize_bicubic_jax(x, n_px, n_px)
    else:
        scale = n_px / min(h, w)
        nh, nw = round(h * scale), round(w * scale)
        x = resize_bicubic_jax(x, nh, nw)
        top, left = (nh - n_px) // 2, (nw - n_px) // 2
        x = x[top:top + n_px, left:left + n_px]
    x = x.clamp(0.0, 1.0)
    mean = torch.from_numpy(CLIP_MEAN).to(x.device)
    std = torch.from_numpy(CLIP_STD).to(x.device)
    return (x - mean) / std
