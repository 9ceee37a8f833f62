"""Color-space conversions on tensors (counterpart of
``image_restoration_agent_tpu/core/color.py``; HSV for the brightening
toolbox).

The reference brightening tools operate on the OpenCV HSV V channel
(AgenticIR/executor/brightening/__init__.py:12-66). These conversions follow
the same convention as cv2 on float inputs: H in [0, 360), S,V in [0, 1].
"""

from __future__ import annotations

import torch


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) float RGB in [0,1] -> HSV with H in [0,360)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    safe = torch.where(delta == 0, torch.ones_like(delta), delta)
    s = torch.where(maxc == 0, torch.zeros_like(delta),
                    delta / torch.where(maxc == 0, torch.ones_like(maxc),
                                        maxc))
    # jnp.mod: the sign of the divisor (floor modulo), as torch.remainder
    hr = torch.remainder((g - b) / safe, 6.0)
    hg = (b - r) / safe + 2.0
    hb = (r - g) / safe + 4.0
    h = torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb))
    h = torch.where(delta == 0, torch.zeros_like(h), h * 60.0)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """HSV (H in [0,360), S,V in [0,1]) -> float RGB in [0,1]."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = h / 60.0
    i = torch.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    # sextant i (0..5) -> its (r, g, b), jnp.select's table
    table = ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
             (v, p, q))
    out = [torch.zeros_like(v) for _ in range(3)]
    for k in reversed(range(6)):
        for c in range(3):
            out[c] = torch.where(i == k, table[k][c], out[c])
    return torch.stack(out, dim=-1)
