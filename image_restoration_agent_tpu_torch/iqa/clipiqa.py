"""CLIP-IQA: no-reference quality from a CLIP prompt pair (counterpart of
``image_restoration_agent_tpu/iqa/clipiqa.py``).

pyiqa's ``clipiqa``: the image's CLIP embedding is compared with the
antonym prompts ("Good photo.", "Bad photo."); the score is the softmax
weight of the positive prompt at CLIP's logit scale (100). It runs on the
port's CLIP (``retrieval/clip.py``) with CLIP-IQA's published default,
CLIP ResNet-50 (``RN50_CONFIG``); any ``CLIPModel`` can be passed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..retrieval.clip import CLIP_MEAN, CLIP_STD, CLIPModel, preprocess

PROMPTS = ("Good photo.", "Bad photo.")

RN50_CONFIG = dict(embed_dim=1024, vision_layers=(3, 4, 6, 3),
                   vision_width=64, image_resolution=224,
                   text_width=512, text_layers=12, text_heads=8)


class ClipIQA:
    def __init__(self, clip_state: dict | None, tokenizer=None,
                 clip_model: CLIPModel | None = None,
                 text_features: np.ndarray | None = None, n_px: int = 224,
                 native_resolution: bool = True,
                 device: str | torch.device = "cuda"):
        """Either a tokenizer (the prompts' features are computed once) or
        precomputed ``text_features`` of shape (2, embed_dim).
        ``clip_state`` None keeps ``clip_model``'s own weights.

        ``native_resolution=True`` is pyiqa's clipiqa (the reference's
        scorer metric): the image is CLIP-normalized but not resized, and
        the attention pool has no positional embedding, so it takes any
        grid. False resizes and centre-crops to ``n_px`` and keeps the
        embedding. A passed ``clip_model`` decides by its own pool: native
        only where it was built without the embedding."""
        self.device = resolve_device(device)
        if clip_model is not None:
            self.clip = clip_model
            self.native = native_resolution and not clip_model.attnpool_pos
        else:
            self.native = native_resolution
            self.clip = CLIPModel(**RN50_CONFIG, attnpool_pos=not self.native)
        if clip_state is not None:
            self.clip.load_state_dict(clip_state, strict=True)
        self.clip = self.clip.to(self.device, torch.float32).eval()
        self.n_px = n_px
        with torch.no_grad():
            if text_features is None:
                ids = tokenizer.tokenize(
                    list(PROMPTS), context_length=self.clip.context_length)
                tf = self.clip.encode_text(
                    torch.from_numpy(ids).long().to(self.device))
            else:
                tf = torch.from_numpy(np.asarray(text_features, np.float32)
                                      ).to(self.device)
        self._tf = tf / torch.linalg.vector_norm(tf, dim=-1, keepdim=True)

    @torch.no_grad()
    def score(self, img: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) CLIP-normalized images -> (B,) quality in [0, 1]."""
        feat = self.clip.encode_image(img)
        feat = feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
        probs = torch.softmax(100.0 * feat @ self._tf.T, dim=-1)
        return probs[:, 0]

    def __call__(self, img: np.ndarray) -> float:
        """(H, W, 3) float [0, 1] -> quality in [0, 1]."""
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)) \
            .to(self.device)
        if self.native:
            mean = torch.from_numpy(CLIP_MEAN).to(self.device)
            std = torch.from_numpy(CLIP_STD).to(self.device)
            x = (x.clamp(0.0, 1.0) - mean) / std
        else:
            x = preprocess(x, n_px=self.n_px)
        return float(self.score(x[None])[0])
