"""Separable resizes as two dense matmuls (counterpart of
``image_restoration_agent_tpu/core/resize.py``).

Three conventions:

- MATLAB ``imresize`` (cubic a=-0.5, antialiasing on downscale, reflected
  borders): the degradation classifier's 224 px input
  (``iqa/classifier.py:prepare_input``).
- torch ``F.interpolate(mode="bicubic", align_corners=False)`` (cubic
  a=-0.75, no antialias, clamped borders): NAFNet's input upscale.
- ``jax.image.resize(method="bilinear")`` with its default
  ``antialias=True``: MAXIM's skip signals. On a downscale the triangle
  widens by the inverse ratio and each output's weights are renormalized
  to sum to one, so the border rows weigh only the taps inside the image.
  That is not ``F.interpolate(antialias=False)`` (MPRNet's resize); torch's
  own ``antialias=True`` agrees with it at the sizes the tests hold, but
  the port keeps the JAX package's formula.
- ``jax.image.resize(method="bicubic")``: DiffBIR's x4 upsample before
  stage 1. The Keys cubic with a = -0.5, its taps that fall outside the
  image dropped and each output's weights renormalized; neither
  ``F.interpolate(mode="bicubic")`` (a = -0.75, clamped borders) nor
  MATLAB's (reflected borders) gives it.

The interpolation weights depend only on the shapes, so they are built
once in numpy (float64, normalised per row, then float32) and the resize
is ``W_h @ img @ W_w^T`` in float32 (no TF32 on the card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import exact_f32


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    f = ((a + 2) * ax3 - (a + 3) * ax2 + 1) * (ax <= 1)
    f = f + (a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a) * ((1 < ax) & (ax <= 2))
    return f


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, a: float, antialias: bool,
                   matlab: bool) -> np.ndarray:
    """Dense (out_size, in_size) row-stochastic interpolation matrix."""
    scale = out_size / in_size
    kernel_width = 4.0
    if antialias and scale < 1.0:
        kernel_width /= scale
    # output sample centres in input coordinates (the same formula for
    # MATLAB and torch's align_corners=False)
    u = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    left = np.floor(u - kernel_width / 2).astype(np.int64)
    p = int(np.ceil(kernel_width)) + 2
    idx = left[:, None] + np.arange(p)[None, :]  # (out, p)
    dist = u[:, None] - idx
    if antialias and scale < 1.0:
        w = scale * _cubic(dist * scale, a)
    else:
        w = _cubic(dist, a)
    if matlab:  # MATLAB reflects taps that fall off the edge
        n = in_size
        aux = np.concatenate([np.arange(n), np.arange(n - 1, -1, -1)])
        idx_c = aux[np.mod(idx, 2 * n)]
    else:  # torch clamps them
        idx_c = np.clip(idx, 0, in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for r in range(out_size):
        np.add.at(mat[r], idx_c[r], w[r])
    mat /= mat.sum(axis=1, keepdims=True)
    return mat.astype(np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """``jax._src.image.scale._fill_keys_cubic_kernel`` (a = -0.5) at
    ``x >= 0``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - x)


@functools.lru_cache(maxsize=256)
def _jax_matrix(in_size: int, out_size: int, kernel: str) -> np.ndarray:
    """Dense (out_size, in_size) matrix of ``jax.image.resize``'s weights
    with antialias (``jax._src.image.scale.compute_weight_mat``): the kernel
    (``"triangle"`` or ``"cubic"``) at half-pixel centres, widened by ``in
    / out`` on a downscale, each row divided by its sum."""
    if in_size == out_size:  # jax.image.resize leaves the axis untouched
        return np.eye(out_size, dtype=np.float32)
    inv = in_size / out_size
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv - 0.5
    d = np.abs(sample[:, None] - np.arange(in_size)[None, :]) / max(inv, 1.0)
    w = {"triangle": _triangle, "cubic": _keys_cubic}[kernel](d)
    tot = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(tot) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


def _apply_separable(img: torch.Tensor, mh: np.ndarray,
                     mw: np.ndarray) -> torch.Tensor:
    if img.is_cuda:
        exact_f32()
    x = img.float()
    mh_t = torch.from_numpy(mh).to(x.device)
    mw_t = torch.from_numpy(mw).to(x.device)
    out = torch.einsum("oh,...hwc->...owc", mh_t, x)
    return torch.einsum("pw,...hwc->...hpc", mw_t, out).to(img.dtype)


def resize_matlab(img: torch.Tensor, scale: float | None = None,
                  out_shape: tuple[int, int] | None = None) -> torch.Tensor:
    """MATLAB-imresize-compatible bicubic resize of ``(..., H, W, C)``."""
    h, w = img.shape[-3], img.shape[-2]
    if out_shape is None:
        if scale is None:
            raise ValueError("give scale or out_shape")
        out_shape = (int(np.ceil(h * scale)), int(np.ceil(w * scale)))
    mh = _resize_matrix(h, out_shape[0], -0.5, True, True)
    mw = _resize_matrix(w, out_shape[1], -0.5, True, True)
    return _apply_separable(img, mh, mw)


def resize_bicubic_torch(img: torch.Tensor, scale: float) -> torch.Tensor:
    """``F.interpolate(bicubic, align_corners=False)``-compatible resize of
    ``(..., H, W, C)``."""
    h, w = img.shape[-3], img.shape[-2]
    out_shape = (int(h * scale), int(w * scale))
    mh = _resize_matrix(h, out_shape[0], -0.75, False, False)
    mw = _resize_matrix(w, out_shape[1], -0.75, False, False)
    return _apply_separable(img, mh, mw)


@functools.lru_cache(maxsize=64)
def _jax_matrix_on(in_size: int, out_size: int, kernel: str,
                   device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """:func:`_jax_matrix` rounded to ``dtype``, as float32 on ``device``,
    kept (a request resizes at the same few sizes)."""
    m = torch.from_numpy(_jax_matrix(in_size, out_size, kernel))
    return m.to(dtype).float().to(device)


def _resize_jax(img: torch.Tensor, out_h: int, out_w: int,
                kernel: str) -> torch.Tensor:
    if img.is_cuda:
        exact_f32()
    h, w = img.shape[-3], img.shape[-2]
    mh = _jax_matrix_on(h, out_h, kernel, img.device, img.dtype)
    mw = _jax_matrix_on(w, out_w, kernel, img.device, img.dtype)
    out = torch.einsum("oh,...hwc->...owc", mh, img.float())
    return torch.einsum("pw,...hwc->...hpc", mw, out).to(img.dtype)


def resize_bilinear_jax(img: torch.Tensor, out_h: int,
                        out_w: int) -> torch.Tensor:
    """``jax.image.resize(img, (..., out_h, out_w, C), "bilinear")`` (its
    default antialias) of ``(..., H, W, C)`` in float32, the weights
    rounded to ``img``'s dtype first (the JAX package casts them to the
    image's), one cast of the result."""
    return _resize_jax(img, out_h, out_w, "triangle")


def resize_bicubic_jax(img: torch.Tensor, out_h: int,
                       out_w: int) -> torch.Tensor:
    """``jax.image.resize(img, (..., out_h, out_w, C), "bicubic")`` of
    ``(..., H, W, C)``: the Keys cubic (a = -0.5) with renormalized border
    weights, in float32 with the weights rounded to ``img``'s dtype, one
    cast of the result."""
    return _resize_jax(img, out_h, out_w, "cubic")


# ---------------------------------------------------------------------------
# Pillow's BICUBIC resize of 8-bit images, reproduced in numpy (the card's
# machine has no PIL)

_PIL_BITS = 22  # Pillow's Resample.c PRECISION_BITS (32 - 8 - 2)


def _pil_cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    a = -0.5
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


@functools.lru_cache(maxsize=16)
def _pil_coeffs(in_size: int, out_size: int) -> tuple:
    """Pillow's ``precompute_coeffs`` (support 2 scaled by the downscale
    factor, windows rounded as ``(int)(center -+ support + 0.5)``, weights
    normalized, then ``normalize_coeffs_8bpc``'s fixed point): per output
    pixel the first input index and the int64 weights, (out, ksize)."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _pil_cubic((np.arange(xmax) + xmin - center + 0.5) / fscale)
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        q = w * (1 << _PIL_BITS)
        kk[xx, :xmax] = np.where(q < 0, np.trunc(q - 0.5), np.trunc(q + 0.5))
        first[xx] = xmin
    return first, kk


def _pil_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass along ``axis`` of an int64 (H, W, C) image."""
    first, kk = _pil_coeffs(img.shape[axis], out_size)
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1]),
                     img.shape[axis] - 1)
    src = np.take(img, idx, axis=axis)     # axis -> (out, ksize)
    w = kk.reshape((1,) * axis + kk.shape + (1,) * (img.ndim - axis - 1))
    acc = (src * w).sum(axis=axis + 1) + (1 << (_PIL_BITS - 1))
    return np.clip(acc >> _PIL_BITS, 0, 255)


def resize_pil_bicubic(img: np.ndarray, out_h: int, out_w: int
                       ) -> np.ndarray:
    """``np.asarray(Image.fromarray(img).resize((out_w, out_h),
    Image.BICUBIC))`` for a uint8 (H, W, 3) image, bit for bit: Pillow's
    two-pass 8-bit resampling (horizontal first, each pass rounded and
    clipped to uint8)."""
    x = img.astype(np.int64)
    if out_w != x.shape[1]:
        x = _pil_pass(x, out_w, 1)
    if out_h != x.shape[0]:
        x = _pil_pass(x, out_h, 0)
    return x.astype(np.uint8)
