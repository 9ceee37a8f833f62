"""The one traffic generator: requests from a mix file's parameters and a
seed.

A mix (``portbench/traffic/<name>.json``) gives:

- ``sizes``: ``[{"h": H, "w": W, "weight": n}, ...]``. Requests come in
  decks that hold each size ``weight`` times, each deck shuffled by the
  seed, so every seed sends the same sizes in the same proportions, in
  another order. A window closes at the end of the deck in which its
  seconds run out, so it always holds whole decks.
- ``pool``: images made per size; requests of a size take them in turn,
  starting at a seeded one.
- ``content``: the image-like input (``grid``: cells of the smooth colour
  field; ``shapes``: flat-coloured rectangles and discs, whose edges are
  the structure; ``texture``: amplitude of band-limited noise).
- ``degrade``: null, or a motion blur (a line kernel of a seeded length in
  ``blur`` = [min, max] pixels and a seeded angle) plus Gaussian noise of
  standard deviation ``noise``: what a deblurring model is given.
- ``arrivals``: ``{"loop": "closed", "clients": 1}`` (the next request
  leaves when the previous returns), or ``{"loop": "open", "rate_per_s":
  r}`` (Poisson arrivals, latency counted from when a request was due).
- ``trace_requests``: how many requests a traced run profiles.
- ``why`` and ``source``: what the mix stands for, and the published
  setting or document its sizes come from (no code reads them).

Images are drawn on the device with a generator from the seed and handed to
the program as float32 host arrays in [0, 1], as the service receives them.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from . import seeds


def _smooth(h, w, cells, gen, device, c=3):
    gh, gw = max(2, -(-h // cells)) + 1, max(2, -(-w // cells)) + 1
    low = torch.rand(1, c, gh, gw, generator=gen, device=device)
    return F.interpolate(low, size=(h, w), mode="bicubic",
                         align_corners=False)[0]


def _shapes(img, n, gen, device):
    _, h, w = img.shape
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    p = torch.rand(n, 8, generator=gen, device=device)
    for i in range(n):
        cy, cx = p[i, 0] * h, p[i, 1] * w
        ry, rx = (0.05 + 0.25 * p[i, 2]) * h, (0.05 + 0.25 * p[i, 3]) * w
        if p[i, 4] < 0.5:
            m = ((ys - cy).abs() < ry) & ((xs - cx).abs() < rx)
        else:
            m = ((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 < 1.0
        img = torch.where(m[None], p[i, 5:8, None, None], img)
    return img


def _line_kernel(length: int, angle: float, device) -> torch.Tensor:
    """A normalised (length, length) motion-blur kernel: a line through
    the centre at ``angle``, drawn with bilinear weights."""
    k = torch.zeros(length, length, device=device)
    c = (length - 1) / 2
    for t in np.linspace(-c, c, 4 * length):
        y, x = c + t * math.sin(angle), c + t * math.cos(angle)
        y0, x0 = int(math.floor(y)), int(math.floor(x))
        for yy, wy in ((y0, 1 - (y - y0)), (y0 + 1, y - y0)):
            for xx, wx in ((x0, 1 - (x - x0)), (x0 + 1, x - x0)):
                if 0 <= yy < length and 0 <= xx < length:
                    k[yy, xx] += wy * wx
    return k / k.sum()


def make_image(h: int, w: int, mix: dict, seed: int, tag: str,
               device) -> np.ndarray:
    """One float32 (h, w, 3) input in [0, 1]."""
    gen = seeds.generator(seed, tag, device)
    c = mix.get("content", {})
    img = 0.15 + 0.7 * _smooth(h, w, c.get("grid", 64), gen, device)
    img = _shapes(img, c.get("shapes", 12), gen, device)
    tex = c.get("texture", 0.0)
    if tex:
        noise = _smooth(h, w, 4, gen, device) - 0.5
        img = img + tex * noise
    deg = mix.get("degrade")
    if deg:
        r = seeds.rng(seed, tag + ".blur")
        length = int(r.integers(deg["blur"][0], deg["blur"][1] + 1)) | 1
        k = _line_kernel(length, float(r.uniform(0, math.pi)), device)
        pad = length // 2
        x = F.pad(img[None], (pad,) * 4, mode="replicate")
        img = F.conv2d(x, k.expand(3, 1, length, length), groups=3)[0]
        img = img + deg["noise"] * torch.randn(img.shape, generator=gen,
                                               device=device)
    img = img.clamp(0.0, 1.0).permute(1, 2, 0).contiguous()
    return img.cpu().numpy()


def sizes(mix: dict) -> list[tuple[int, int]]:
    return [(s["h"], s["w"]) for s in mix["sizes"]]


def make_pool(mix: dict, seed: int, device) -> dict:
    """{(h, w): [image, ...]}: ``pool`` images of every size."""
    return {(h, w): [make_image(h, w, mix, seed, f"image.{h}x{w}.{i}",
                                device) for i in range(mix["pool"])]
            for h, w in sizes(mix)}


def schedule(mix: dict, seed: int
             ) -> Iterator[tuple[tuple[int, int], int, bool]]:
    """Endless ((h, w), pool index, last of its deck) requests in seeded
    decks."""
    r = seeds.rng(seed, "schedule")
    deck = [(s["h"], s["w"]) for s in mix["sizes"]
            for _ in range(s.get("weight", 1))]
    turn = {hw: int(r.integers(mix["pool"])) for hw in sizes(mix)}
    while True:
        order = r.permutation(len(deck))
        for j, i in enumerate(order):
            hw = deck[i]
            yield hw, turn[hw] % mix["pool"], j == len(order) - 1
            turn[hw] += 1


def arrivals(mix: dict, seed: int) -> Iterator[float]:
    """Seconds after the window opens at which each request is due (all
    0.0 in a closed loop: each leaves when the previous returns)."""
    a = mix.get("arrivals", {"loop": "closed"})
    if a["loop"] == "closed":
        while True:
            yield 0.0
    if a["loop"] != "open":
        raise ValueError(f"unknown loop {a['loop']!r}")
    r = seeds.rng(seed, "arrivals")
    t = 0.0
    while True:
        t += float(r.exponential(1.0 / a["rate_per_s"]))
        yield t
