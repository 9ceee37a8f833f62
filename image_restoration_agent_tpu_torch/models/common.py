"""Shared layers of the port's model zoo, channels-last (counterpart of
``image_restoration_agent_tpu/models/common.py``).

Modules keep PyTorch's own parameter layout (``Conv2d`` weights
``(O, I, kh, kw)``) so reference state dicts load unchanged; the 3x3 convs
run through :func:`ops.conv3x3.conv3x3` (the K3 kernel on the card).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import exact_f32
from ..ops.conv3x3 import (compose_conv_weights, conv3x3, conv3x3_fits,
                           conv3x3_weights, conv_after_shuffle_weights)
from ..ops.layernorm import (layer_norm_bias_free, layer_norm_lanes,
                             layer_norm_with_bias)
from ..ops.pixel_shuffle import pixel_shuffle

__all__ = ["Conv", "Conv1x1", "ConvLib", "ConvTranspose", "DWConv",
           "RestormerLayerNorm", "layer_norm_lanes", "conv_plain",
           "fused_pixelshuffle_head", "upsample_tail"]


def cache_key(x: torch.Tensor, params) -> tuple:
    """Prepared weights are reused while no parameter changed in place
    (``load_state_dict`` copies in place and bumps ``_version``)."""
    return (x.dtype, x.device, tuple(p._version for p in params))


class Conv(nn.Module):
    """3x3 SAME conv (stride 1) with an optional bias and the fused
    epilogues of :func:`ops.conv3x3.conv3x3`: ``act`` in {None, "lrelu",
    "lrelu2"}, ``shuffle`` r > 1 appends ``pixel_shuffle(y, r)``, and per
    call a residual, a folded roll and an input LayerNorm."""

    def __init__(self, cin: int, cout: int, act: str | None = None,
                 shuffle: int = 1, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.act = act
        self.shuffle = shuffle
        self._prepared: tuple | None = None

    def hwio(self) -> torch.Tensor:
        return self.weight.permute(2, 3, 1, 0)

    def kernel_weights(self, x: torch.Tensor):
        """The kernel form of this conv's weights for ``x``'s dtype and
        device, made once and kept while the parameters are unchanged."""
        key = cache_key(x, [p for p in (self.weight, self.bias)
                            if p is not None])
        if self._prepared is None or self._prepared[0] != key:
            self._prepared = (key, conv3x3_weights(self.hwio(), self.bias,
                                                   x.dtype))
        return self._prepared[1]

    def forward(self, x, res=None, roll: int = 0, ln_pre=None):
        y = conv3x3(x, self.kernel_weights(x), act=self.act, res=res,
                    roll=roll, ln_pre=ln_pre,
                    params=(self.hwio(), self.bias))
        if self.shuffle > 1:
            y = pixel_shuffle(y, self.shuffle)
        return y


class Conv1x1(nn.Module):
    """1x1 conv on a channels-last tensor (a matmul over channels in
    ``x``'s dtype), as the JAX package runs it through XLA; reference
    ``Conv2d(cin, cout, 1)`` parameter layout."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, 1))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def matrix(self) -> torch.Tensor:
        """The (Cin, Cout) matrix."""
        return self.weight[:, :, 0, 0].t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and x.dtype == torch.float32:
            exact_f32()
        y = x @ self.matrix().to(x.dtype)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def _nchw_lib(x: torch.Tensor):
    """``x`` as an NCHW view for a library conv (exact float32 on the
    card)."""
    if x.is_cuda and x.dtype == torch.float32:
        exact_f32()
    return x.permute(0, 3, 1, 2)


class ConvLib(nn.Module):
    """A conv the JAX package runs through XLA (a 1x1 on a small canvas, a
    strided conv): ``k x k``, stride ``stride``, a symmetric zero pad of
    ``padding`` (by default ``(k - 1) // 2``: torch ``Conv2d(cin, cout, k,
    stride, padding=(k - 1) // 2)``), through the library conv in ``x``'s
    dtype on a channels-last tensor; reference layout (O, I, k, k)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = True, padding: int | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride = stride
        self.padding = (k - 1) // 2 if padding is None else padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(_nchw_lib(x), self.weight.to(x.dtype), b,
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """torch ``ConvTranspose2d(cin, cout, k, stride, padding)`` on a
    channels-last tensor through the library op, as the JAX package runs
    its Flax ``ConvTranspose`` (SAME padding) through XLA: k 2, stride 2,
    padding 0 (MAXIM) and k 4, stride 2, padding 1 (DRBNet, IFAN) both
    double the size exactly. Reference layout (I, O, k, k)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 2,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv_transpose2d(_nchw_lib(x), self.weight.to(x.dtype), b,
                               stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class DWConv(nn.Module):
    """Depthwise 3x3 SAME conv (groups == channels) through the library
    conv, on a channels-last tensor; reference ``Conv2d(c, c, 3,
    groups=c)`` layout (C, 1, 3, 3). Only the unfused Restormer route runs
    it, as the JAX package runs it through XLA."""

    def __init__(self, c: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, 1, 3, 3))
        self.bias = nn.Parameter(torch.empty(c)) if bias else None

    def taps(self) -> torch.Tensor:
        """(9, C): row ``3*dy + dx`` holds tap (dy, dx) of every channel."""
        return self.weight.reshape(self.weight.shape[0], 9).t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and x.dtype == torch.float32:
            exact_f32()
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                     padding=1, groups=x.shape[-1])
        return y.permute(0, 2, 3, 1)


class _LNBody(nn.Module):
    def __init__(self, c: int, bias_free: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = None if bias_free else nn.Parameter(torch.empty(c))


class RestormerLayerNorm(nn.Module):
    """Restormer LayerNorm over channels (eps 1e-5), WithBias or BiasFree;
    parameters under ``.body`` as in the reference (``norm1.body.weight``)."""

    def __init__(self, c: int, bias_free: bool = False):
        super().__init__()
        self.body = _LNBody(c, bias_free)

    def params(self) -> tuple:
        """(scale,) BiasFree or (scale, bias): the fused kernels' ``ln``."""
        b = self.body
        return (b.weight,) if b.bias is None else (b.weight, b.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.body
        if b.bias is None:
            return layer_norm_bias_free(x, b.weight)
        return layer_norm_with_bias(x, b.weight, b.bias)


def conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """Plain SAME zero-padded conv + bias (HWIO weights, odd kernel) in
    ``x``'s dtype: the head's library conv, as the JAX package runs it
    through XLA."""
    r = w.shape[0] // 2
    if x.is_cuda and x.dtype == torch.float32:
        exact_f32()
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=r).permute(0, 2, 3, 1)
    return y + b.to(y.dtype)


def _shuffle_chain_perm(cout: int, rs) -> np.ndarray:
    """Channel permutation turning the chained pixel_shuffle(r_0)..(r_k)
    into one depth-to-space."""
    r_tot = int(np.prod(rs))
    x = np.arange(cout * r_tot * r_tot).reshape(1, 1, 1, -1)
    for r in rs:
        _, h, w, crr = x.shape
        c = crr // (r * r)
        x = x.reshape(h, w, c, r, r)
        x = np.moveaxis(x, (-3, -2, -1), (-1, -4, -2))
        x = x.reshape(1, h * r, w * r, c)
    return x[0].reshape(-1)


def head_weights(stages, wl, bl, rs):
    """The composed plane-space weights of the whole linear pixel-shuffle
    head, with the chained-shuffle channel order folded in (float32)."""
    w, b = wl.float(), bl.float()
    for (wi, bi), r in zip(reversed(stages), reversed(rs)):
        w = conv_after_shuffle_weights(w, r)
        b = b.repeat_interleave(r * r)
        w, b = compose_conv_weights(wi, bi, w, b)
    perm = torch.from_numpy(_shuffle_chain_perm(wl.shape[-1], rs)).to(
        w.device)
    return w[..., perm].contiguous(), b[perm].contiguous()


def fused_pixelshuffle_head(x, stages, wl, bl, rs, seq_head,
                            packed: bool = False, composed=None):
    """The whole pixel-shuffle SR head as one composed conv plus one
    depth-to-space, with the border ring recomputed sequentially (the
    composed conv's zero padding differs there), exact everywhere.

    Args:
        x: (B, H, W, C) input (after conv_before_upsample's activation).
        stages: [(w_i, b_i)] per upsample-stage conv (HWIO), one per r.
        wl, bl: conv_last weights (HWIO) and bias.
        rs: pixel-shuffle factor per stage (e.g. [2, 2] for x4).
        seq_head: (B, h, w, C) -> (B, h*R, w*R, Cout), the sequential head.
        packed: emit (B, H*R, W*R*Cout), channels interleaved into the
            minor axis (byte-identical to the NHWC image).
        composed: optional precomputed :func:`head_weights` result.
    """
    w, b = composed if composed is not None else head_weights(
        stages, wl, bl, rs)
    cout = wl.shape[-1]
    r_tot = int(np.prod(rs))
    y = conv_plain(x, w, b.to(x.dtype))
    bsz, hh, ww, _ = y.shape
    if packed:
        y = y.reshape(bsz, hh, ww, r_tot, r_tot * cout)
        y = y.permute(0, 1, 3, 2, 4).reshape(bsz, hh * r_tot,
                                              ww * r_tot * cout)
    else:
        y = y.reshape(bsz, hh, ww, r_tot, r_tot, cout)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(bsz, hh * r_tot,
                                                 ww * r_tot, cout)

    s = r_tot
    ring, ctx = 4, 12  # plane px; ctx >= ring + composite radius
    h, wd = x.shape[1], x.shape[2]

    def pk(z):
        return z.reshape(z.shape[0], z.shape[1], -1) if packed else z

    if h <= ctx or wd <= ctx:
        return pk(seq_head(x)).to(y.dtype)
    ro = ring * s
    rc = ro * cout if packed else ro
    y = y.contiguous()
    y[:, :ro] = pk(seq_head(x[:, :ctx])[:, :ro]).to(y.dtype)
    y[:, -ro:] = pk(seq_head(x[:, -ctx:])[:, -ro:]).to(y.dtype)
    y[:, :, :rc] = pk(seq_head(x[:, :, :ctx])[:, :, :ro]).to(y.dtype)
    y[:, :, -rc:] = pk(seq_head(x[:, :, -ctx:])[:, :, -ro:]).to(y.dtype)
    return y


def tail_weights(w1, b1, wl, bl, r: int, dtype: torch.dtype) -> tuple:
    """Kernel forms of :func:`upsample_tail`'s two convs: the upsample conv,
    and conv_last moved in front of the shuffle (a 3x3 conv over r^2 times
    the channels, :func:`conv_after_shuffle_weights`)."""
    return (conv3x3_weights(w1, b1, dtype),
            conv3x3_weights(conv_after_shuffle_weights(wl, r),
                            bl.repeat_interleave(r * r), dtype))


def upsample_tail(x, w1, b1, wl, bl, r: int, kernel_weights=None):
    """Final pixel-shuffle head stage: upsample conv -> pixel_shuffle(r) ->
    conv_last (HWIO weights).

    Where :func:`conv3x3_fits` takes the shape, both convs run through
    :func:`conv3x3` (K3 on the card) in plane space, as the JAX package runs
    them through its TPU kernel; elsewhere through the plain library conv.
    ``kernel_weights`` is a kept :func:`tail_weights` result."""
    if conv3x3_fits(x.shape[1], x.shape[2]):
        k1, k2 = kernel_weights or tail_weights(w1, b1, wl, bl, r, x.dtype)
        p1 = p2 = None
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (w1, b1, wl, bl)):
            p1 = (w1, b1)
            p2 = (conv_after_shuffle_weights(wl, r),
                  None if bl is None else bl.repeat_interleave(r * r))
        return pixel_shuffle(conv3x3(conv3x3(x, k1, params=p1), k2,
                                     params=p2), r)
    y = pixel_shuffle(conv_plain(x, w1, b1), r)
    return conv_plain(y, wl, bl)
