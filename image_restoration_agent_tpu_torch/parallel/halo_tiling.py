"""Halo-exchange tile-parallel inference: each rank owns an output strip
(counterpart of ``image_restoration_agent_tpu/parallel/halo_tiling.py``).

``tile_parallel.tiled_apply_sharded`` merges a whole output tile batch
over the axis. Here, as in the JAX design, only strips' edges move:

- the INPUT is row-sharded over the ``tile`` axis: rank ``i`` holds rows
  ``[i * own, (i + 1) * own)`` and gets the ``overlap`` rows it also needs
  from rank ``i + 1`` by one backward send/recv (the last rank takes the
  ``overlap``-row remainder of the image instead);
- each rank runs the model on its own tile rows (one batch per tile row);
- one forward exchange hands the ``overlap * scale``-row output halo that
  a rank's last tile row spills into its lower neighbour: rank ``i + 1``
  starts its canvas from rank ``i``'s partial sums there and adds its own
  tiles after them, so every pixel sums its tiles in the single-process
  order and the blend is bit-identical to :func:`core.tiling.tiled_apply`
  (the halo passes rank to rank, after each rank's model calls);
- the last rank produces the final ``overlap * scale`` output rows.

Traffic: O(D * overlap * W * C) each way for the strips; the returned
canvas is gathered to every rank (one all-gather of the strips).

Constraints (ValueError otherwise): after padding, (H - tile) % stride == 0 and the
tile-row count is divisible by the rank count; :func:`halo_pad_height`
gives the smallest compliant H.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..core.tiling import TilePlan, _weight_axes
from .mesh import Mesh


def halo_pad_height(h: int, tile: int, stride: int, n_dev: int) -> int:
    """Smallest H' >= h with (H'-tile) % stride == 0 and row count % n_dev
    == 0."""
    rows = max(1, -(-(h - tile) // stride) + 1)
    while True:
        if rows % n_dev == 0:
            hp = (rows - 1) * stride + tile
            if hp >= h:
                return hp
        rows += 1


def _exchange(mesh: Mesh, axis: str, send, to, recv_like, frm):
    """Send ``send`` to rank ``to`` and receive a tensor like
    ``recv_like`` from rank ``frm`` (either None: that half is skipped)."""
    g = mesh.group(axis)
    reqs, buf = [], None
    if send is not None and to is not None:
        reqs.append(dist.isend(send.contiguous(), to, group=g))
    if frm is not None:
        buf = torch.empty_like(recv_like)
        reqs.append(dist.irecv(buf, frm, group=g))
    for r in reqs:
        r.wait()
    return buf


def tiled_apply_halo(
    fn: Callable[[torch.Tensor], torch.Tensor],
    img: torch.Tensor,
    mesh: Mesh,
    axis: str = "tile",
    tile: int = 256,
    overlap: int = 32,
    scale: int = 1,
) -> torch.Tensor:
    """Tile-parallel forward over ``mesh``'s ``axis`` with halo exchange.

    ``img`` (H, W, C) must already be padded: (H - tile) % stride == 0
    (use :func:`halo_pad_height`); W is tiled as :func:`core.tiling
    .plan_tiles` tiles it (the last column snapped to the edge). Every rank
    of the axis calls it with the same ``img`` and gets the whole (H*scale,
    W*scale, C') float32 canvas."""
    h, w, cin = img.shape
    stride = tile - overlap
    if (h - tile) % stride:
        raise ValueError(f"height {h} is not tile {tile} plus a multiple "
                         f"of the stride {stride}: pad it to "
                         "halo_pad_height(h, tile, stride, ranks)")
    n_rows = (h - tile) // stride + 1
    d = mesh.shape[axis]
    if n_rows % d:
        raise ValueError(f"{n_rows} tile rows do not divide among {d} ranks")
    rows_per = n_rows // d
    me = mesh.index(axis)
    prev, nxt = mesh.neighbor(axis, -1), mesh.neighbor(axis, 1)

    w_starts = tuple(range(0, w - tile, stride)) + (w - tile,)
    ts = tile * scale
    halo = overlap * scale
    own_rows = rows_per * stride          # input rows owned; output rows
    # owned, / scale; h == d * own_rows + overlap

    # input halo: my strip also needs the next rank's first `overlap` rows
    block = img[me * own_rows:(me + 1) * own_rows]
    head = _exchange(mesh, axis, block[:overlap], prev, block[:overlap],
                     nxt)
    strip = torch.cat([block, img[d * own_rows:] if nxt is None else head])

    outs = []
    for r in range(rows_per):
        patches = torch.stack([strip[r * stride:r * stride + tile,
                                     ws_:ws_ + tile] for ws_ in w_starts])
        outs.append(fn(patches).float())
    cout = outs[0].shape[-1]

    # output halo: start from the previous rank's partial sums over my
    # head rows, add my tiles in order, hand my tail to the next rank
    canvas = torch.zeros(((rows_per - 1) * stride + tile) * scale,
                         w * scale, cout, device=outs[0].device)
    recv = _exchange(mesh, axis, None, None, canvas[:halo], prev)
    if recv is not None:
        canvas[:halo] = recv
    for r, row in enumerate(outs):
        for j, ws_ in enumerate(w_starts):
            oy, ox = r * stride * scale, ws_ * scale
            canvas[oy:oy + ts, ox:ox + ts] += row[j]
    _exchange(mesh, axis, canvas[own_rows * scale:], nxt, None, None)

    # the single-process blend's separable weights, my rows of them
    plan = TilePlan(h, w, tile, tile, overlap,
                    tuple(range(0, h - tile + 1, stride)), w_starts)
    rows, cols = _weight_axes(plan, scale)
    lo = me * own_rows * scale
    inv_r = torch.from_numpy(1.0 / rows[lo:lo + canvas.shape[0]]).to(
        canvas.device)
    inv_c = torch.from_numpy(1.0 / cols).to(canvas.device)
    blended = canvas * inv_r[:, None]
    blended = blended * inv_c[None, :]

    strips = mesh.all_gather(blended[:own_rows * scale], axis)
    tails = mesh.all_gather(blended[own_rows * scale:], axis)
    return torch.cat(strips + [tails[-1]], dim=0)
