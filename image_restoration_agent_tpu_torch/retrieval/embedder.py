"""Retrieval embedder: image + fixed caption -> fused 640-d embedding
(counterpart of ``image_restoration_agent_tpu/retrieval/embedder.py``).

The reference fuses a CLIP RN50x4 image feature with the text feature of
the fixed caption "similar degradation" through the trained Combiner
(``CLIPRetrievalEmbedder``). Where those assets are absent, a stand-in
(``RetrievalEmbedder``) runs a degradation-aware conv tower (the classifier
trunk) and a learned caption embedding through the same Combiner.

Store identities. A store records which embedder wrote it and refuses to
load under another. The JAX stand-in records ``"trained_standin"`` also
when it initialises itself from ``PRNGKey(seed)``, which the port cannot
reproduce; so the port's stand-in records ``"trained_standin"`` only when
it is built from carried parameters (whose embeddings equal the JAX
package's) and ``"random_standin_torch_seed<seed>"`` when it initialises
itself, which a store written by the other package then refuses.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..core.io import load_image, to_float
from ..device import exact_f32, resolve_device
from ..iqa.classifier import ConvTrunk, prepare_input
from ..models.registry import init_weights
from .clip import CLIPModel, preprocess
from .combiner import Combiner

WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


class ImageTower(ConvTrunk, nn.Module):
    """Conv trunk -> 640-d image feature (the CLIP RN50x4 stand-in). Flax
    names (``conv{i}``, ``gn{i}``, ``proj``)."""

    def __init__(self, feature_dim: int = 640, width: int = 32):
        super().__init__()
        self._add_trunk((width, width * 2, width * 4, width * 8))
        self.proj = nn.Linear(width * 8, feature_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, 224, 224, 3)
        return self.proj(self._trunk(x))


class RetrievalModel(nn.Module):
    def __init__(self, feature_dim: int = 640):
        super().__init__()
        self.image_tower = ImageTower(feature_dim)
        # learned embedding of the fixed caption "similar degradation"
        self.caption_embedding = nn.Parameter(torch.zeros(feature_dim))
        self.combiner = Combiner(feature_dim)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        if img.is_cuda:
            exact_f32()
        img_feat = self.image_tower(img)
        txt = self.caption_embedding.expand_as(img_feat)
        return self.combiner(img_feat, txt)


def _embed_path(embedder, img_path) -> np.ndarray:
    return embedder.embed_array(to_float(load_image(img_path)))


class RetrievalEmbedder:
    """The stand-in. ``state`` is a ``RetrievalModel`` state dict (carried
    from the JAX package through ``convert.from_jax``); without one the
    model takes random weights from ``seed`` and a distinct identity."""

    def __init__(self, state: dict | None = None, seed: int = 0,
                 feature_dim: int = 640,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = RetrievalModel(feature_dim)
        if state is None:
            init_weights(self.model, seed)
            self.identity = f"random_standin_torch_seed{seed}"
        else:
            self.model.load_state_dict(state, strict=True)
            self.identity = "trained_standin"
        self.model = self.model.to(self.device, torch.float32).eval()

    @torch.no_grad()
    def embed_array(self, img: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        x = prepare_input(x.to(self.device))[None]
        return self.model(x)[0].cpu().numpy()

    def embed_path(self, img_path: str | Path) -> np.ndarray:
        return _embed_path(self, img_path)


class CLIPRetrievalEmbedder:
    """The reference's retrieval embedding: the CLIP RN50x4 image feature
    and the text feature of the fixed caption, fused by the trained
    Combiner and L2-normalized. The caption's feature is computed once, at
    construction.

    ``clip_state`` / ``combiner_state`` are state dicts for ``clip_model``
    / ``combiner_model`` (full-width RN50x4 and Combiner by default); None
    keeps the module's own weights. ``from_npz`` loads the JAX package's
    converted trees."""

    CAPTION = "similar degradation"
    identity = "clip4cir_rn50x4"  # recorded in vector-store metadata

    def __init__(self, clip_state: dict | None, combiner_state: dict | None,
                 tokenizer, caption: str | None = None, n_px: int = 288,
                 target_ratio: float | None = 1.25, feature_dim: int = 640,
                 clip_model: CLIPModel | None = None,
                 combiner_model: Combiner | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.clip = clip_model or CLIPModel(embed_dim=feature_dim)
        self.combiner = combiner_model or Combiner(feature_dim)
        for mod, state in ((self.clip, clip_state),
                           (self.combiner, combiner_state)):
            if state is not None:
                mod.load_state_dict(state, strict=True)
        self.clip = self.clip.to(self.device, torch.float32).eval()
        self.combiner = self.combiner.to(self.device, torch.float32).eval()
        self.n_px = n_px
        self.target_ratio = target_ratio
        ids = tokenizer.tokenize(caption or self.CAPTION,
                                 context_length=self.clip.context_length)
        with torch.no_grad():
            self._text_feat = self.clip.encode_text(
                torch.from_numpy(ids).long().to(self.device))

    @classmethod
    def from_npz(cls, clip_path: str | Path, combiner_path: str | Path,
                 bpe_path: str | Path, **kw) -> "CLIPRetrievalEmbedder":
        """From CLIP and Combiner weight files: the reference-named state
        dicts ``convert-weights`` writes (the counterpart of the JAX
        ``from_dirs``, whose orbax directories need JAX to read)."""
        from ..convert.torch_import import read_state
        from .tokenizer import SimpleTokenizer

        def state(path):
            return {k: torch.as_tensor(v)
                    for k, v in read_state(path).items()}

        return cls(state(clip_path), state(combiner_path),
                   SimpleTokenizer(bpe_path), **kw)

    @torch.no_grad()
    def embed_array(self, img: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        x = preprocess(x.to(self.device), n_px=self.n_px,
                       target_ratio=self.target_ratio)[None]
        out = self.combiner(self.clip.encode_image(x), self._text_feat)
        norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        return (out / norm.clamp_min(1e-12))[0].cpu().numpy()

    def embed_path(self, img_path: str | Path) -> np.ndarray:
        return _embed_path(self, img_path)


def default_embedder(weight_root: str | Path | None = None,
                     device: str | torch.device = "cuda"):
    """The reference's CLIP embedder where its assets exist in
    ``weight_root`` (the port's ``weights/``): ``clip_rn50x4.npz``,
    ``combiner.npz`` (state dicts, :meth:`CLIPRetrievalEmbedder.from_npz`)
    and CLIP's merges file ``bpe_simple_vocab_16e6.txt.gz``; else the
    stand-in with random weights. Assets that exist and do not load raise."""
    root = Path(weight_root) if weight_root else WEIGHTS
    clip_npz = root / "clip_rn50x4.npz"
    comb_npz = root / "combiner.npz"
    bpe = root / "bpe_simple_vocab_16e6.txt.gz"
    if clip_npz.exists() and comb_npz.exists() and bpe.exists():
        return CLIPRetrievalEmbedder.from_npz(clip_npz, comb_npz, bpe,
                                              device=device)
    return RetrievalEmbedder(device=device)
