"""Tiled sliding-window inference with overlap blending (counterpart of
``image_restoration_agent_tpu/core/tiling.py``).

The tile grid is planned on the host with the reference's stride
arithmetic (``range(0, size - tile, stride) + [size - tile]``), tiles are
gathered into one ``(N, th, tw, C)`` batch, and the outputs are blended
with the reference's accumulate-then-divide. The overlap count is
separable (rows x cols), so it is applied as two vectors; the order of
the adds and the two multiplies is the JAX package's, which keeps the
blend bit-identical to it for the same tile outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .pad import pad_hw, pad_to_multiple


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A static tile decomposition of an ``(H, W)`` canvas. Tiles may be
    rectangular: full-width row bands (``tile_w == width``) are the band
    serving mode."""

    height: int
    width: int
    tile_h: int
    tile_w: int
    overlap: int
    h_starts: tuple[int, ...]
    w_starts: tuple[int, ...]

    @property
    def tile(self) -> "int | tuple[int, int]":
        return self.tile_h if self.tile_h == self.tile_w \
            else (self.tile_h, self.tile_w)

    @property
    def num_tiles(self) -> int:
        return len(self.h_starts) * len(self.w_starts)

    @property
    def offsets(self) -> np.ndarray:
        """(N, 2) array of (row, col) tile origins, row-major."""
        return np.array(
            [(h, w) for h in self.h_starts for w in self.w_starts],
            dtype=np.int32)


def plan_tiles(height: int, width: int, tile, overlap: int = 32) -> TilePlan:
    """Plan a tile grid like the reference serving loop: ``tile`` (an int,
    or an ``(th, tw)`` pair) is clamped to the canvas, stride is
    ``tile - overlap``, and the last tile snaps to the bottom/right edge."""
    if isinstance(tile, (tuple, list)):
        th, tw = min(tile[0], height), min(tile[1], width)
    else:
        th = tw = min(tile, height, width)
    if overlap >= th and th < height or overlap >= tw and tw < width:
        raise ValueError(f"overlap {overlap} must be < tile ({th}, {tw})")

    def starts(size, t):
        if t >= size:
            return (0,)
        return tuple(range(0, size - t, t - overlap)) + (size - t,)

    return TilePlan(height, width, th, tw, overlap,
                    starts(height, th), starts(width, tw))


def extract_tiles(img: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """Gather all tiles of an ``(H, W, C)`` image into ``(N, th, tw, C)``."""
    th, tw = plan.tile_h, plan.tile_w
    return torch.stack([img[oh:oh + th, ow:ow + tw]
                        for oh, ow in plan.offsets.tolist()])


def _weight_canvas(plan: TilePlan, scale: int, n_valid: int | None = None,
                   scale_w: int | None = None) -> np.ndarray:
    """Dense overlap-count canvas (used only for truncated grids)."""
    th, tw, s = plan.tile_h, plan.tile_w, scale
    sw = scale if scale_w is None else scale_w
    w = np.zeros((plan.height * s, plan.width * sw, 1), dtype=np.float32)
    for i, (oh, ow) in enumerate(plan.offsets):
        if n_valid is not None and i >= n_valid:
            break
        w[oh * s:(oh + th) * s, ow * sw:(ow + tw) * sw] += 1.0
    return w


def _weight_axes(plan: TilePlan, scale: int, scale_w: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The overlap-count canvas factored into per-axis count vectors."""
    th, tw, s = plan.tile_h, plan.tile_w, scale
    sw = scale if scale_w is None else scale_w
    rows = np.zeros((plan.height * s, 1), dtype=np.float32)
    for oh in plan.h_starts:
        rows[oh * s:(oh + th) * s] += 1.0
    cols = np.zeros((plan.width * sw, 1), dtype=np.float32)
    for ow in plan.w_starts:
        cols[ow * sw:(ow + tw) * sw] += 1.0
    return rows, cols


def blend_tiles(tiles: torch.Tensor, plan: TilePlan, scale: int = 1,
                scale_w: int | None = None) -> torch.Tensor:
    """Overlap-blend ``(N, th*s, tw*s, C)`` tile outputs onto the canvas.
    With ``scale_w`` the tiles are packed ``(N, th*s, tw*scale_w)``
    (channels folded into the column axis) and the blend runs in packed
    space."""
    packed = scale_w is not None
    if packed:
        tiles = tiles[..., None]
    n, ths, tws, c = tiles.shape
    sw = scale if scale_w is None else scale_w
    offsets = (plan.offsets[:n] * np.array([scale, sw], dtype=np.int32))
    canvas = tiles.new_zeros(plan.height * scale, plan.width * sw, c)
    for patch, (oh, ow) in zip(tiles, offsets.tolist()):
        canvas[oh:oh + ths, ow:ow + tws] += patch
    if n == len(plan.offsets):
        rows, cols = _weight_axes(plan, scale, scale_w=scale_w)
        inv_r = torch.from_numpy(1.0 / rows).to(canvas.device)
        inv_c = torch.from_numpy(1.0 / cols).to(canvas.device)
        canvas = canvas * inv_r[:, None]
        canvas = canvas * inv_c[None, :]
    else:
        weight = torch.from_numpy(_weight_canvas(
            plan, scale, n_valid=n, scale_w=scale_w)).to(canvas.device)
        canvas = canvas / weight
    return canvas[..., 0] if packed else canvas


def _batched_apply(fn: Callable[[torch.Tensor], torch.Tensor],
                   tiles: torch.Tensor, batch: int) -> torch.Tensor:
    """Run ``fn`` over tiles in fixed-size batches; the tile count is padded
    to a multiple of ``batch`` (fixed shapes) and the padding dropped."""
    n = tiles.shape[0]
    if batch >= n:
        return fn(tiles)
    n_pad = (-n) % batch
    if n_pad:
        tiles = torch.cat([tiles, tiles[:n_pad]], dim=0)
    outs = [fn(tiles[i:i + batch]) for i in range(0, tiles.shape[0], batch)]
    return torch.cat(outs, dim=0)[:n]


def tiled_apply(fn: Callable[[torch.Tensor], torch.Tensor],
                img: torch.Tensor, tile, overlap: int = 32, scale: int = 1,
                batch: int = 8, pad_multiple: int = 1,
                pad_mode: str = "ceil", pad_kind: str = "symmetric",
                pad_to: tuple[int, int] | None = None,
                packed_c: int = 1) -> torch.Tensor:
    """Pad -> tile -> batched forward -> blend -> crop on one image.

    Args:
        fn: batched forward ``(B, th, tw, C) -> (B, th*s, tw*s, C')`` (or
            packed ``(B, th*s, tw*s*packed_c)``).
        img: ``(H, W, C)`` float image tensor.
        tile: tile size, an ``(th, tw)`` pair, or None for a whole-image
            forward.
        overlap: tile overlap in input pixels.
        scale: model output scale factor.
        batch: tiles per model invocation.
        pad_multiple / pad_mode / pad_kind: see :func:`core.pad.pad_to_multiple`.
        pad_to: explicit padded canvas (H', W') overriding pad_multiple (the
            band path pads W to a strip-chunkable width).
        packed_c: when > 1, ``fn`` emits packed outputs and the return value
            is ``(H*scale, W*scale*packed_c)``, byte-identical row-major to
            the NHWC image.
    """
    if pad_to is not None:
        h0, w0 = img.shape[-3], img.shape[-2]
        ph, pw = pad_to[0] - h0, pad_to[1] - w0
        padded = pad_hw(img, ph, pw,
                        pad_kind if (ph <= h0 and pw <= w0) else "edge")
    else:
        padded, (h0, w0) = pad_to_multiple(img, max(pad_multiple, 1),
                                           pad_mode, pad_kind)
    h, w = padded.shape[-3], padded.shape[-2]

    th, tw = (tile, tile) if tile is None or isinstance(tile, int) else tile
    scale_w = scale * packed_c if packed_c > 1 else None
    if tile is None or (th >= h and tw >= w):
        out = fn(padded[None])[0]
    else:
        plan = plan_tiles(h, w, tile, overlap)
        tiles = extract_tiles(padded, plan)
        outs = _batched_apply(fn, tiles, batch)
        out = blend_tiles(outs, plan, scale, scale_w=scale_w)
    if packed_c > 1:
        return out[: h0 * scale, : w0 * scale * packed_c]
    return out[: h0 * scale, : w0 * scale, :]
