"""Degradation synthesis: the 8 ops of the reference data pipeline
(counterpart of ``image_restoration_agent_tpu/data/degrade.py``).

Behavioral rebuild of AgenticIR/dataset/add_single_degradation.py (same op
set, same parameter ranges, same uint8 in/out contract) used for test
fixtures and the evaluation suite. The MATLAB-bicubic downscale of
``lowres`` runs on ``device`` through :func:`core.resize.resize_matlab`;
the kernels and filters of the other ops are numpy and OpenCV on the host
(offline data ops, not the serving path). OpenCV is required: an op that
needs it raises naming it, where the JAX package falls back to PIL or
scipy.

All randomness flows through an explicit ``numpy.random.Generator``, drawn
in the JAX package's order, so the same seed gives the same images.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.resize import resize_matlab
from ..device import resolve_device


def _cv2():
    try:
        import cv2
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("degradation synthesis requires cv2 "
                           "(opencv-python)") from e
    return cv2


def _to_float(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 255.0


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def lowres(img: np.ndarray, keep_size: bool = False,
           rng: Optional[np.random.Generator] = None,
           device: str | torch.device = "cuda") -> np.ndarray:
    """Downscale to 1/4 with MATLAB bicubic (reference ``lr``) on
    ``device``; optionally resize back up."""
    x = torch.from_numpy(_to_float(img)).to(resolve_device(device))
    x = resize_matlab(x, scale=0.25)
    if keep_size:
        x = resize_matlab(x, scale=4.0)
    return _to_uint8(x.cpu().numpy())


def add_noise(img: np.ndarray, noise_type: Optional[str] = None, arg=None,
              rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Gaussian (sigma in [20,50]/255) or Poisson (scale in [1,3]) noise."""
    rng = rng or np.random.default_rng()
    x = _to_float(img)
    types = ["Gaussian", "Poisson"]
    if noise_type is None:
        noise_type = rng.choice(types)
    assert noise_type in types
    if noise_type == "Gaussian":
        sigma = (rng.uniform(20, 50) if arg is None else float(arg)) / 255.0
        out = x + rng.normal(0.0, sigma, x.shape).astype(np.float32)
    else:
        scale = rng.uniform(1, 3) if arg is None else float(arg)
        vals = 10 ** (2.0)  # photon count scale
        noisy = rng.poisson(np.clip(x, 0, 1) * vals).astype(np.float32) / vals
        out = x + (noisy - x) * scale
    return _to_uint8(np.clip(out, 0, 1))


def add_jpeg_artifacts(img: np.ndarray, quality_factor: Optional[int] = None,
                       rng: Optional[np.random.Generator] = None
                       ) -> np.ndarray:
    """JPEG round-trip at QF in [10, 30) (reference
    add_jpeg_comp_artifacts), through OpenCV's codec."""
    cv2 = _cv2()
    rng = rng or np.random.default_rng()
    if quality_factor is None:
        quality_factor = int(rng.integers(10, 30))
    ok, enc = cv2.imencode(".jpg", img[..., ::-1],
                           [int(cv2.IMWRITE_JPEG_QUALITY), quality_factor])
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    return cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]


def darken(img: np.ndarray, darken_type: Optional[str] = None, arg=None,
           rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Darken the HSV V channel: constant shift [30,50), gamma [0.5,0.7), or
    linear map to [100,150) (reference darken)."""
    rng = rng or np.random.default_rng()
    types = ["constant shift", "gamma correction", "linear mapping"]
    if darken_type is None:
        darken_type = rng.choice(types)
    assert darken_type in types

    cv2 = _cv2()
    hsv = cv2.cvtColor(img[..., ::-1], cv2.COLOR_BGR2HSV)
    h, s, v = cv2.split(hsv)
    if darken_type == "constant shift":
        shift = int(rng.integers(30, 50)) if arg is None else int(arg)
        v = np.clip(v.astype(np.int16) - shift, 0, 255).astype(np.uint8)
    elif darken_type == "gamma correction":
        gamma = float(rng.uniform(0.5, 0.7)) if arg is None else float(arg)
        v = np.clip(np.round((v / 255.0) ** (1.0 / gamma) * 255), 0,
                    255).astype(np.uint8)
    else:
        dst_max = int(rng.integers(100, 150)) if arg is None else int(arg)
        vmin, vmax = int(v.min()), int(v.max())
        v = np.round((v.astype(np.float32) - vmin) / max(vmax - vmin, 1)
                     * dst_max).astype(np.uint8)
    out = cv2.cvtColor(cv2.merge((h, s, v)), cv2.COLOR_HSV2BGR)
    return out[..., ::-1]


def _pseudo_depth(shape: tuple[int, int],
                  rng: np.random.Generator) -> np.ndarray:
    """Smooth synthetic depth map in [0,1] (the reference reads monocular
    depth predictions from disk; one is synthesized when none is
    supplied)."""
    cv2 = _cv2()
    h, w = shape
    base = np.linspace(0.2, 1.0, h)[:, None] * np.ones((1, w))
    bumps = rng.normal(0, 1, (h // 8 + 1, w // 8 + 1))
    bumps = cv2.resize(bumps, (w, h), interpolation=cv2.INTER_CUBIC)
    bumps = cv2.GaussianBlur(bumps, (0, 0), sigmaX=max(h, w) / 32)
    d = base + 0.25 * (bumps - bumps.min()) / max(np.ptp(bumps), 1e-6)
    return d / d.max()


def add_haze(img: np.ndarray, depth: Optional[np.ndarray] = None,
             A: Optional[float] = None, beta: Optional[float] = None,
             rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Atmospheric scattering I = J t + A(1-t), t = exp(-beta d);
    A ~ U(0.7, 1.0), beta ~ U(0.6, 1.8) (reference add_haze / RESIDE)."""
    rng = rng or np.random.default_rng()
    if depth is None:
        depth = _pseudo_depth(img.shape[:2], rng)
    depth = depth / max(float(depth.max()), 1e-6)
    A = float(rng.uniform(0.7, 1.0)) if A is None else A
    beta = float(rng.uniform(0.6, 1.8)) if beta is None else beta
    t = np.exp(-beta * depth)[..., None]
    out = img.astype(np.float32) * t + A * 255.0 * (1.0 - t)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def _motion_kernel(severity: int, angle: float) -> np.ndarray:
    """Line-shaped Gaussian kernel: radius/sigma per severity
    {0: (10,3), 1: (15,5), 2: (15,8)} (reference add_motion_blur)."""
    radius, sigma = [(10, 3), (15, 5), (15, 8)][severity]
    width = radius * 2 + 1
    taps = np.exp(-np.arange(width) ** 2 / (2 * sigma ** 2))
    taps /= taps.sum()
    dy = width * np.sin(np.deg2rad(angle))
    dx = width * np.cos(np.deg2rad(angle))
    hyp = np.hypot(dx, dy)
    k = np.zeros((2 * width + 1, 2 * width + 1), np.float32)
    c = width
    for i in range(width):
        oy = -int(np.ceil(i * dy / hyp - 0.5))
        ox = -int(np.ceil(i * dx / hyp - 0.5))
        k[c + oy, c + ox] += taps[i]
    return k / k.sum()


def add_motion_blur(img: np.ndarray, severity: Optional[int] = None,
                    angle: Optional[float] = None,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    cv2 = _cv2()
    rng = rng or np.random.default_rng()
    if severity is None:
        severity = int(rng.integers(0, 3))
    if angle is None:
        angle = float(rng.uniform(-90, 90))
    k = _motion_kernel(severity, angle)
    out = cv2.filter2D(img.astype(np.float32), -1, k,
                       borderType=cv2.BORDER_REPLICATE)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def add_defocus_blur(img: np.ndarray, severity: Optional[int] = None,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Antialiased disk kernel; (radius, alias_blur) per severity
    {0: (3,0.1), 1: (4,0.5), 2: (6,0.5)} (reference add_defocus_blur)."""
    cv2 = _cv2()
    rng = rng or np.random.default_rng()
    if severity is None:
        severity = int(rng.integers(0, 3))
    radius, alias_blur = [(3, 0.1), (4, 0.5), (6, 0.5)][severity]
    L = np.arange(-8, 9) if radius <= 8 else np.arange(-radius, radius + 1)
    ksize = (3, 3) if radius <= 8 else (5, 5)
    X, Y = np.meshgrid(L, L)
    disk = ((X ** 2 + Y ** 2) <= radius ** 2).astype(np.float32)
    disk /= disk.sum()
    kernel = cv2.GaussianBlur(disk, ksize=ksize, sigmaX=alias_blur)
    x = _to_float(img)
    out = np.stack([cv2.filter2D(x[..., c], -1, kernel) for c in range(3)],
                   -1)
    return _to_uint8(np.clip(out, 0, 1))


def add_rain(img: np.ndarray, value: Optional[int] = None,
             rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Additive rain streaks: sparse bright noise -> rotated diagonal-line
    blur kernel -> add (reference add_rain, MiOIR-style)."""
    cv2 = _cv2()
    rng = rng or np.random.default_rng()
    length = int(rng.integers(20, 40))
    angle = int(rng.integers(-30, 30))
    if value is None:
        value = int(rng.integers(50, 100))

    noise = rng.uniform(0, 256, img.shape[:2]).astype(np.float32)
    noise[noise < (256 - value * 0.01)] = 0
    pre = np.array([[0, 0.1, 0], [0.1, 8, 0.1], [0, 0.1, 0]], np.float32)
    noise = cv2.filter2D(noise, -1, pre)

    trans = cv2.getRotationMatrix2D(
        (length / 2, length / 2), angle - 45, 1 - length / 100.0)
    streak = cv2.warpAffine(np.diag(np.ones(length, np.float32)), trans,
                            (length, length))
    streak = cv2.GaussianBlur(streak, (3, 3), 0)
    rain = cv2.filter2D(noise, -1, streak)
    rain = cv2.normalize(rain, None, 0, 255, cv2.NORM_MINMAX)
    out = img.astype(np.float32) + rain[..., None]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


DEGRADE_OPS: dict[str, Callable] = {
    "low resolution": lambda img, rng=None, device="cuda": lowres(
        img, keep_size=False, rng=rng, device=device),
    "noise": add_noise,
    "jpeg compression artifact": add_jpeg_artifacts,
    "dark": darken,
    "haze": add_haze,
    "motion blur": add_motion_blur,
    "defocus blur": add_defocus_blur,
    "rain": add_rain,
}


def apply_degradation(img: np.ndarray, name: str,
                      rng: Optional[np.random.Generator] = None,
                      device: str | torch.device = "cuda",
                      **kwargs) -> np.ndarray:
    """One op by name; ``device`` reaches the op that runs on one
    (``low resolution``)."""
    if name == "low resolution":
        kwargs["device"] = device
    return DEGRADE_OPS[name](img, rng=rng, **kwargs)


def synthesize_combo(img: np.ndarray, combo: list[str] | str,
                     rng: Optional[np.random.Generator] = None,
                     device: str | torch.device = "cuda") -> np.ndarray:
    """Apply a '+'-separated or listed combo in order, like the benchmark's
    16 combos (AgenticIR/dataset/degradations.txt, dataset/synthesize.py);
    the resizes run on ``device`` (``cuda`` raises without a card)."""
    device = resolve_device(device)
    rng = rng or np.random.default_rng()
    if isinstance(combo, str):
        combo = [c.strip() for c in combo.split("+")]
    for name in combo:
        img = apply_degradation(img, name, rng=rng, device=device)
    return img
