"""Tile-parallel inference: the tile batch of one image spread over the
ranks of a mesh axis (counterpart of
``image_restoration_agent_tpu/parallel/tile_parallel.py``).

The domain's sequence parallelism: a large image decomposes into an
overlap-tile batch; each rank of the ``tile`` axis runs the model on its
contiguous share of the tiles; one all-reduce over the axis merges the
shares (each slot of the output batch is written by one rank, the others
add zeros, so the merge is exact); every rank then blends the whole batch
with the SAME :func:`core.tiling.blend_tiles` the single-process path
uses, in the same tile order.

Parity contract (the JAX module's): the overlap blend is bit-identical to
single-process by construction. The model forward is not bitwise
batch-grouping-invariant (a rank's share is another batch shape than
``tiled_apply``'s ``batch`` chunks, and per-shape kernels sum in other
orders), so model-family checks hold a few-ulp bound; where the shares
are the single-process batches (one rank, ``batch`` = the tile count) the
result is bit-identical.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.pad import pad_to_multiple
from ..core.tiling import blend_tiles, extract_tiles, plan_tiles
from .mesh import Mesh


def tiled_apply_sharded(
    fn: Callable[[torch.Tensor], torch.Tensor],
    img: torch.Tensor,
    mesh: Mesh,
    axis: str = "tile",
    tile: int = 256,
    overlap: int = 32,
    scale: int = 1,
    pad_multiple: int = 8,
    pad_mode: str = "ceil",
    pad_kind: str = "symmetric",
) -> torch.Tensor:
    """Like :func:`core.tiling.tiled_apply` with the tile batch sharded over
    ``mesh``'s ``axis``; every rank of the axis calls it with the same
    ``img`` (H, W, C) and gets the whole (H*scale, W*scale, C') result."""
    padded, (h0, w0) = pad_to_multiple(img, max(pad_multiple, 1), pad_mode,
                                       pad_kind)
    h, w = padded.shape[-3], padded.shape[-2]
    plan = plan_tiles(h, w, tile, overlap)

    n = plan.num_tiles
    d = mesh.shape[axis]
    n_pad = (-n) % d
    tiles = extract_tiles(padded, plan)
    if n_pad:  # round the batch up to the rank count (dropped after)
        tiles = torch.cat([tiles, tiles[:n_pad]], dim=0)
    per = tiles.shape[0] // d
    me = mesh.index(axis)
    mine = fn(tiles[me * per:(me + 1) * per])
    outs = mine.new_zeros((tiles.shape[0], *mine.shape[1:]))
    outs[me * per:(me + 1) * per] = mine
    mesh.all_reduce(outs, axis)

    out = blend_tiles(outs[:n], plan, scale)
    return out[: h0 * scale, : w0 * scale, :]
