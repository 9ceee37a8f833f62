"""The served request, worked out again in plain code: shape bucketing,
border padding, the whole / band / tile plan, the overlap blend, the crop
and the rounding to uint8, from the configuration's ``serving`` section
(the restoration service's published request semantics). Padding is
``numpy.pad``'s, on the host; the network runs through a reference module
of :mod:`portbench.reference`.

``serving`` keys: ``scale``, ``shape_bucket``, ``pad_multiple``,
``pad_mode`` (``"ceil"``, or ``"extra"``: always at least one more
multiple), ``pad_kind`` (``numpy.pad`` mode), ``whole_pad_multiple``,
``tile`` (None: the whole canvas), ``tile_overlap``, ``max_size`` and
``fallback_tile`` / ``fallback_overlap`` (a larger image is tiled), and
``band`` (full-width row bands: ``overlap``, ``max_pixels``,
``min_bands``, ``window``, ``chunk_min``, ``chunk_max``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def bucket(size: int, step: int, multiple: int) -> int:
    """``size`` rounded up to the bucket grid, whose step keeps the pad
    multiple."""
    b = max(step, multiple)
    b -= b % multiple
    return -(-size // b) * b


def pad_amount(size: int, multiple: int, mode: str) -> int:
    if mode == "extra":
        return (size // multiple + 1) * multiple - size
    if mode == "ceil":
        return (-size) % multiple
    raise ValueError(f"unknown pad mode {mode!r}")


def pad(img: np.ndarray, ph: int, pw: int, kind: str) -> np.ndarray:
    """Pad the bottom and right of an (H, W, C) array; symmetric and reflect
    cannot reach past the image, so larger pads replicate the edge."""
    if ph == 0 and pw == 0:
        return img
    h, w = img.shape[:2]
    if kind != "edge" and (ph > h or pw > w):
        kind = "edge"
    return np.pad(img, ((0, ph), (0, pw), (0, 0)), mode=kind)


def band_width(w: int, band: dict) -> int:
    """The smallest width >= w, a multiple of the window, with a divisor in
    [chunk_min, chunk_max] holding an even number of windows."""
    ws = band["window"]
    wp = -(-w // ws) * ws
    while not any(wp % d == 0 for d in range(band["chunk_min"],
                                             band["chunk_max"] + 1, 2 * ws)):
        wp += ws
    return wp


def starts(size: int, t: int, overlap: int) -> list[int]:
    if t >= size:
        return [0]
    return list(range(0, size - t, t - overlap)) + [size - t]


def plan(img_hw: tuple[int, int], s: dict) -> dict:
    """The request's plan: ``mode`` (whole / band / tile), the padded canvas
    and the tile grid."""
    h0, w0 = img_hw
    hb = bucket(h0, s["shape_bucket"], s["pad_multiple"])
    wb = bucket(w0, s["shape_bucket"], s["pad_multiple"])
    tile, overlap = s.get("tile"), s["tile_overlap"]
    if tile is None and s.get("max_size") and max(h0, w0) > s["max_size"]:
        tile, overlap = s["fallback_tile"], s["fallback_overlap"]
    out = {"bucket": (hb, wb)}
    if tile is None and s.get("band"):
        b = s["band"]
        ph = -(-hb // s["pad_multiple"]) * s["pad_multiple"]
        pw = band_width(wb, b)
        n = max(b["min_bands"], -(-(ph * pw) // b["max_pixels"]))
        rows = -(-(ph + (n - 1) * b["overlap"]) // n)
        bh = min(-(-rows // 8) * 8, ph)
        out.update(mode="band", canvas=(ph, pw), tile=(bh, pw),
                   overlap=b["overlap"])
    elif tile is None:
        m = max(s["pad_multiple"], s.get("whole_pad_multiple", 1))
        out.update(mode="whole", canvas=(hb + pad_amount(hb, m, s["pad_mode"]),
                                         wb + pad_amount(wb, m, s["pad_mode"])))
    else:
        m = s["pad_multiple"]
        ch = hb + pad_amount(hb, m, s["pad_mode"])
        cw = wb + pad_amount(wb, m, s["pad_mode"])
        out.update(mode="tile", canvas=(ch, cw),
                   tile=(min(tile, ch, cw),) * 2, overlap=overlap)
    if out["mode"] != "whole":
        th, tw = out["tile"]
        ch, cw = out["canvas"]
        out["origins"] = [(a, b) for a in starts(ch, th, out["overlap"])
                          for b in starts(cw, tw, out["overlap"])]
    return out


def restore(img: np.ndarray, s: dict, net: Callable[[torch.Tensor],
                                                    torch.Tensor],
            device, pixels_per_batch: int = 1 << 21) -> np.ndarray:
    """The reference's answer to one request: a float (H, W, 3) array in
    [0, 1] -> the uint8 (H*scale, W*scale, 3) image. ``net`` maps
    (B, 3, h, w) float32 to (B, 3, h*scale, w*scale); tiles reach it in
    batches of about ``pixels_per_batch`` input pixels."""
    h0, w0 = img.shape[:2]
    sc = s["scale"]
    p = plan((h0, w0), s)
    hb, wb = p["bucket"]
    x = img.astype(np.float32)
    if (hb, wb) != (h0, w0):
        kind = "symmetric" if min(h0, w0) >= max(hb - h0, wb - w0) else "edge"
        x = np.pad(x, ((0, hb - h0), (0, wb - w0), (0, 0)), mode=kind)
    ch, cw = p["canvas"]
    x = pad(x, ch - hb, cw - wb, s["pad_kind"])
    canvas = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    canvas = canvas.permute(2, 0, 1)[None]
    if p["mode"] == "whole":
        y = net(canvas)[0]
    else:
        th, tw = p["tile"]
        batch = max(1, pixels_per_batch // (th * tw))
        y = torch.zeros(3, ch * sc, cw * sc, device=device)
        cnt = torch.zeros(1, ch * sc, cw * sc, device=device)
        origins = p["origins"]
        for i in range(0, len(origins), batch):
            group = origins[i:i + batch]
            tiles = torch.cat([canvas[..., a:a + th, b:b + tw]
                               for a, b in group])
            outs = net(tiles)
            for (a, b), o in zip(group, outs):
                y[:, a * sc:(a + th) * sc, b * sc:(b + tw) * sc] += o
                cnt[:, a * sc:(a + th) * sc, b * sc:(b + tw) * sc] += 1.0
        y = y / cnt
    y = y[:, :h0 * sc, :w0 * sc].permute(1, 2, 0)
    return torch.round(y.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
