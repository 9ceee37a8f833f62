"""Model registry: name -> (constructor, default config, serving metadata)
(counterpart of ``image_restoration_agent_tpu/models/registry.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable[..., Any]           # returns an nn.Module
    subtasks: tuple[str, ...]           # which agent subtasks this serves
    scale: int = 1                      # output spatial scale
    pad_multiple: int = 8               # pad H/W to this before forward
    pad_mode: str = "ceil"              # "ceil" | "extra" (SwinIR windows)
    pad_kind: str = "reflect"           # border fill
    tile: int | None = None             # default tile size (None = whole)
    tile_overlap: int = 32
    # images whose longest side exceeds max_size fall back to fallback_tile
    max_size: int | None = None
    fallback_tile: int = 240
    # whole-image forwards pad the canvas to this multiple
    whole_pad_multiple: int = 1
    # geometric self-ensemble over the 8 dihedral flips/rotations
    self_ensemble: bool = False
    # whole-canvas serving as full-width row bands with packed-RGB SR
    # output (engine/engine.py)
    band_mode: bool = False
    config: dict = dataclasses.field(default_factory=dict)


MODEL_REGISTRY: dict[str, ModelSpec] = {}


def register_model(spec: ModelSpec) -> ModelSpec:
    if spec.name in MODEL_REGISTRY:
        raise ValueError(f"duplicate model name: {spec.name}")
    MODEL_REGISTRY[spec.name] = spec
    return spec


def build_model(name: str, *, device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32, seed: int = 0,
                **overrides) -> torch.nn.Module:
    """Build a registered model on ``device`` (default the card; raises
    without one) with deterministic random weights from ``seed``; load real
    weights with ``load_state_dict``."""
    dev = resolve_device(device)
    spec = MODEL_REGISTRY[name]
    model = spec.build(**{**spec.config, **overrides})
    init_weights(model, seed)
    return model.to(device=dev, dtype=dtype).eval()


def init_weights(model: torch.nn.Module, seed: int) -> None:
    """Deterministic fan-in scaled weights from a ``torch.Generator``:
    norm scales and attention temperatures near 1, small biases and bias
    tables."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            n = torch.randn(p.shape, generator=gen, dtype=torch.float32)
            if "relative_position_bias_table" in name:
                v = 0.02 * n
            elif "temperature" in name:
                v = 1.0 + 0.05 * n
            elif name.endswith("bias"):
                v = 0.02 * n
            elif p.ndim == 1:
                v = 1.0 + 0.05 * n
            else:
                v = n / max(p[0].numel(), 1) ** 0.5
            p.copy_(v)


def list_models() -> list[str]:
    return sorted(MODEL_REGISTRY)


def get_spec(name: str) -> ModelSpec:
    return MODEL_REGISTRY[name]
