"""Full-reference quality metrics (counterpart of
``image_restoration_agent_tpu/iqa/metrics.py``).

PSNR and SSIM as pyiqa defines them (SSIM: an 11x11 Gaussian window, sigma
1.5, K1 = 0.01, K2 = 0.03, valid correlation per channel). Both compute in
float32 with TF32 off on the card (``device.exact_f32``): quality numbers
must not move with the matmul unit's defaults. The SSIM window is a
per-channel ``F.conv2d``, as the JAX package's is an XLA conv.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import exact_f32


def _f32(x) -> torch.Tensor:
    """A numpy array (to the CPU) or a tensor, as float32."""
    t = torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) else x
    if t.is_cuda:
        exact_f32()
    return t.float()


def psnr(img, ref, max_val: float = 1.0) -> torch.Tensor:
    """PSNR in dB over all pixels and channels of same-shape images (numpy
    or tensors); a 0-d float32 tensor on the images' device."""
    img, ref = _f32(img), _f32(ref)
    mse = torch.mean(torch.square(img - ref))
    return 10.0 * torch.log10(max_val * max_val / mse.clamp_min(1e-12))


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x * x) / (2 * sigma * sigma))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter2(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid-mode 2D correlation applied per channel of (H, W, C)."""
    x = img.permute(2, 0, 1)[:, None]  # (C, 1, H, W)
    return F.conv2d(x, kernel[None, None])[:, 0].permute(1, 2, 0)


def ssim(img, ref, max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM (Wang et al. 2004) over the channels of (H, W, C) images
    (numpy or tensors); a 0-d float32 tensor on the images' device."""
    img, ref = _f32(img), _f32(ref)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    kern = torch.from_numpy(_gaussian_kernel()).to(img.device)

    mu1 = _filter2(img, kern)
    mu2 = _filter2(ref, kern)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2(img * img, kern) - mu1_sq
    s2 = _filter2(ref * ref, kern) - mu2_sq
    s12 = _filter2(img * ref, kern) - mu12

    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(m)
