"""Spatial padding to size multiples, replicating the reference serving
semantics (counterpart of ``image_restoration_agent_tpu/core/pad.py``).

- mode ``"extra"``: SwinIR serving always pads at least one extra window,
  even when already aligned;
- mode ``"ceil"``: pad to the next multiple (Restormer/MPRNet serving).

The border fill follows ``numpy.pad`` exactly: the source index of every
padded row/column is computed by ``numpy.pad`` on an index vector and the
tensor is gathered with it, so ``symmetric`` (edge pixel repeated),
``reflect`` and ``edge`` match the JAX package bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def _pad_amount(size: int, multiple: int, mode: str) -> int:
    if mode == "extra":
        return (size // multiple + 1) * multiple - size
    if mode == "ceil":
        return (-size) % multiple
    raise ValueError(f"unknown pad mode: {mode!r}")


def pad_hw(x: torch.Tensor, ph: int, pw: int,
           kind: str = "symmetric") -> torch.Tensor:
    """Pad the bottom of the H axis by ``ph`` and the right of the W axis by
    ``pw`` of a ``(..., H, W, C)`` tensor, like ``numpy.pad(mode=kind)``."""
    if ph == 0 and pw == 0:
        return x
    h, w = x.shape[-3], x.shape[-2]
    if kind == "constant":
        out = x.new_zeros(*x.shape[:-3], h + ph, w + pw, x.shape[-1])
        out[..., :h, :w, :] = x
        return out
    ih = torch.from_numpy(np.pad(np.arange(h), (0, ph), mode=kind))
    iw = torch.from_numpy(np.pad(np.arange(w), (0, pw), mode=kind))
    x = x.index_select(x.ndim - 3, ih.to(x.device))
    return x.index_select(x.ndim - 2, iw.to(x.device))


def pad_to_multiple(x: torch.Tensor, multiple: int, mode: str = "ceil",
                    pad_mode: str = "symmetric"
                    ) -> tuple[torch.Tensor, tuple[int, int]]:
    """Pad the H and W axes of an NHWC (or HWC) tensor to a size multiple.

    Returns (padded tensor, (orig_H, orig_W)). Symmetric/reflect padding
    cannot exceed the source extent, so small inputs fall back to edge
    replication, as in the JAX package."""
    h, w = x.shape[-3], x.shape[-2]
    ph = _pad_amount(h, multiple, mode)
    pw = _pad_amount(w, multiple, mode)
    if ph == 0 and pw == 0:
        return x, (h, w)
    if ph > h or pw > w:
        pad_mode = "edge"
    return pad_hw(x, ph, pw, pad_mode), (h, w)


def unpad(x: torch.Tensor, hw: tuple[int, int], scale: int = 1
          ) -> torch.Tensor:
    """Crop a padded (and possibly upscaled) result back to ``scale * hw``."""
    h, w = hw
    return x[..., : h * scale, : w * scale, :]
