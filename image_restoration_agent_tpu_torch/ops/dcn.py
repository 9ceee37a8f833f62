"""Modulated deformable convolution v2 (DCNv2), channels-last
(counterpart of ``image_restoration_agent_tpu/ops/dcn.py``).

RIDCP's WarpBlock aligns the code decoder's features to the residual
stream with DCNv2 (the reference's only CUDA op). The JAX package computes
it in plain ``jnp``, outside any Pallas kernel, and so does the port in
plain PyTorch: for each of the K*K taps, sample the input at (base grid +
tap offset + learned offset) by a 4-corner bilinear gather written out by
hand (zero outside the image, as the reference's im2col kernel), scale by
the modulation mask, and fold the K*K sampled planes into ONE matmul with
the (K*K*Cin, Cout) weight in float32.

Layout (torchvision / mmcv DCNv2): offset (B, H, W, 2*G*K*K) ordered
(g, tap, [dy, dx]); mask (B, H, W, G*K*K), already sigmoided; the G
deformable groups split the input channels, each with its own offsets.
Sample coordinates are float32; the sampled planes are float32 (bf16
inputs are promoted as the JAX package promotes them), the product
accumulates in float32 and is cast to the input dtype before the bias.
"""

from __future__ import annotations

import torch

from ..device import exact_f32


def _bilinear_gather(img: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (B, H, W, G, Cg) at float32 coordinates ``ys`` /
    ``xs`` (B, H, W, G), group g from its own channels; corners outside
    the image read zero. Returns (B, H, W, G, Cg) float32."""
    b, h, w, g, cg = img.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    y0i = y0.long()
    x0i = x0.long()
    flat = img.reshape(b, h * w, g, cg)
    bi = torch.arange(b, device=img.device).view(b, 1, 1, 1)
    gi = torch.arange(g, device=img.device).view(1, 1, 1, g)

    def corner(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = flat[bi, idx, gi]  # (B, H, W, G, Cg)
        return (vals * valid[..., None]).float()

    v00 = corner(y0i, x0i)
    v01 = corner(y0i, x0i + 1)
    v10 = corner(y0i + 1, x0i)
    v11 = corner(y0i + 1, x0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor,
                          mask: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor | None = None, kernel: int = 3,
                          deformable_groups: int = 1) -> torch.Tensor:
    """DCNv2 forward, stride 1, padding (kernel-1)//2, dilation 1.

    Args:
        x: (B, H, W, Cin).
        offset: (B, H, W, 2*G*K*K), ordered (g, tap, [dy, dx]).
        mask: (B, H, W, G*K*K) in [0, 1] (already sigmoided).
        weight: (K, K, Cin, Cout), the JAX package's layout (torch's
            (Cout, Cin, K, K) permuted (2, 3, 1, 0)).
        bias: (Cout,) or None.

    Returns:
        (B, H, W, Cout) in ``x``'s dtype.
    """
    b, h, w, cin = x.shape
    k, g = kernel, deformable_groups
    cg = cin // g
    pad = (k - 1) // 2
    dev = x.device
    base_y = torch.arange(h, dtype=torch.float32, device=dev).view(
        1, h, 1, 1)
    base_x = torch.arange(w, dtype=torch.float32, device=dev).view(
        1, 1, w, 1)
    off = offset.reshape(b, h, w, g, k * k, 2).float()
    m = mask.reshape(b, h, w, g, k * k)
    xg = x.reshape(b, h, w, g, cg)

    cols = []
    for tap in range(k * k):
        ky, kx = tap // k, tap % k
        ys = base_y + (ky - pad) + off[..., tap, 0]
        xs = base_x + (kx - pad) + off[..., tap, 1]
        sampled = _bilinear_gather(xg, ys, xs)
        cols.append((sampled * m[..., tap, None].float()).reshape(
            b, h, w, cin))
    col = torch.cat(cols, dim=-1)  # (B, H, W, K*K*Cin), tap-major
    if col.is_cuda:
        exact_f32()
    wmat = weight.reshape(k * k * cin, weight.shape[-1]).float()
    out = (col @ wmat).to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
