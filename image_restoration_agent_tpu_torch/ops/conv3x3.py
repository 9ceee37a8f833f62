"""Fused SAME 3x3 convolution (stride 1) with bias, LeakyReLU, residual,
folded cyclic roll and input LayerNorm.

Replaces ``image_restoration_agent_tpu/ops/conv3x3.py:conv3x3_pallas`` (the
TPU row-strip MXU kernel). The CUDA kernel is ``csrc/conv3x3.cu`` (K3):

- What bounds it on the H100: at the serving shape (552x1920, 180->180)
  the conv is 6.1e11 FLOP against 0.76 GB of bf16 input and output, about
  800 FLOP per byte, so the tensor-core rate bounds it (0.62 ms in bf16);
  the f32 exact path is bound by the 67 TFLOP/s FP32 rate (9.2 ms).
- Design: an implicit GEMM with no im2col in device memory. A block owns
  64 output pixels of one row and 64 output channels; it stages a 3-row,
  66-column halo of the input in shared memory, a chunk of input channels
  at a time, with the folded roll resolved in the load addresses (modular
  indices) and SAME zero padding applied at the edges of the rolled
  canvas. With ``ln_pre`` the block first computes each halo pixel's
  LayerNorm statistics, normalizes while staging, and zero-pads the LN
  *output* (LN(0) = bias is not what the reference pads with). In bf16 the
  9 taps run as WMMA 16x16x16 fragments on the tensor cores (float32
  accumulators), with the weight slab copied by 16-byte ``cp.async`` from
  the zero-padded kernel form (:func:`conv3x3_weights`, made once per
  weight by its owner); in f32 they run on FP32 FMA (4x4
  outputs per thread, no TF32). Bias, activation and residual are applied
  in float32 before the single cast on store. What it does not do yet:
  ``wgmma``, TMA, a pipelined halo, reuse of the halo across the output
  channel chunks (it is staged once per 64 output channels).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import exact_f32
from . import kernels
from .layernorm import layer_norm_lanes

_ACTS = {None: 0, "lrelu": 1, "lrelu2": 2}
_SLOPES = {"lrelu": 0.01, "lrelu2": 0.2}


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None = None, *, act: str | None = None,
                  res: torch.Tensor | None = None, roll: int = 0,
                  ln_pre: tuple[torch.Tensor, torch.Tensor] | None = None
                  ) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv3x3`: the same function with the
    same cast points (LN output cast to ``x.dtype``, float32 accumulation,
    one cast of the result)."""
    dt = x.dtype
    if x.is_cuda:  # the float32 reference conv must not run in TF32
        exact_f32()
    if ln_pre is not None:
        x = layer_norm_lanes(x, *ln_pre)
    xf = x.float()
    if roll:
        xf = torch.roll(xf, (roll, roll), dims=(1, 2))
    y = F.conv2d(xf.permute(0, 3, 1, 2),
                 w.to(dt).float().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.float()
    if act is not None:
        y = F.leaky_relu(y, _SLOPES[act])
    if res is not None:
        y = y + res.float()
    return y.to(dt)


class Conv3x3Weights(NamedTuple):
    """K3's weight form, made once per weight (:func:`conv3x3_weights`):
    HWIO in the compute dtype, contiguous, and in bfloat16 zero-padded to
    Cin/32 x Cout/64 for aligned 16-byte copies; the bias in float32.
    ``cin`` and ``cout`` are the true channel counts."""

    w: torch.Tensor
    b: torch.Tensor | None
    cin: int
    cout: int

    @property
    def hwio(self) -> torch.Tensor:
        return self.w[:, :, :self.cin, :self.cout]


def conv3x3_weights(w: torch.Tensor, b: torch.Tensor | None,
                    dtype: torch.dtype) -> Conv3x3Weights:
    """The kernel form of (3, 3, Cin, Cout) weights and a bias."""
    cin, cout = w.shape[2], w.shape[3]
    wk = w.detach().to(dtype)
    if dtype == torch.bfloat16:
        wk = F.pad(wk, (0, -cout % 64, 0, -cin % 32))
    bk = None if b is None else b.detach().float().contiguous()
    return Conv3x3Weights(wk.contiguous(), bk, cin, cout)


def conv3x3_fits(h: int, w: int) -> bool:
    """The shape rule by which the JAX package's heads send a conv to its
    TPU kernel (``conv3x3_supported`` less its TPU memory budget, which the
    serving shapes meet): H and W multiples of 8, W >= 128. The port's
    ``upsample_tail`` follows it, so both run the same convs as kernels."""
    return h % 8 == 0 and w % 8 == 0 and w >= 128


def _conv3x3_cuda(x, k: Conv3x3Weights, act, res, roll, ln_pre):
    bsz, h, wd, cin = x.shape
    cout = k.cout
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3 kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    pad = (-cin % 32, -cout % 64) if x.dtype == torch.bfloat16 else (0, 0)
    if k.cin != cin or k.w.dtype != x.dtype or not k.w.is_contiguous() \
            or k.w.shape != (3, 3, cin + pad[0], cout + pad[1]):
        raise ValueError(f"weight {tuple(k.w.shape)} {k.w.dtype} is not the "
                         f"kernel form for input {tuple(x.shape)} {x.dtype}")
    if k.b is not None and (k.b.dtype != torch.float32
                            or k.b.shape != (cout,)):
        raise ValueError("conv3x3 bias must be float32 (Cout,)")
    x = x.contiguous()
    wk, bk = k.w, k.b
    if res is not None:
        if res.shape != (bsz, h, wd, cout) or res.dtype != x.dtype:
            raise ValueError(f"residual {tuple(res.shape)} {res.dtype} "
                             f"does not fit output {(bsz, h, wd, cout)}")
        res = res.contiguous()
    lg = lb = None
    if ln_pre is not None:
        lg, lb = (p.float().contiguous() for p in ln_pre)
    for t in (wk, bk, res, lg, lb):
        if t is not None and t.device != x.device:
            raise ValueError("conv3x3 operands on different devices")
    out = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = kernels.load("conv3x3")
    fn = lib.conv3x3_f32 if x.dtype == torch.float32 else lib.conv3x3_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(ptr(x), ptr(wk), ptr(bk), ptr(res), ptr(lg), ptr(lb), ptr(out),
             bsz, h, wd, cin, cout, int(roll), _ACTS[act],
             torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "conv3x3")
    conv3x3.launches += 1
    return out


def conv3x3(x: torch.Tensor, w: torch.Tensor | Conv3x3Weights,
            b: torch.Tensor | None = None, *, act: str | None = None,
            res: torch.Tensor | None = None, roll: int = 0,
            ln_pre: tuple[torch.Tensor, torch.Tensor] | None = None
            ) -> torch.Tensor:
    """SAME 3x3 conv, stride 1, channels-last.

    Args:
        x: (B, H, W, Cin), float32 or bfloat16.
        w: (3, 3, Cin, Cout) weights (the JAX package's HWIO layout), or
            their kernel form from :func:`conv3x3_weights` for ``x.dtype``,
            which holds the bias (``b`` is then None). Callers that launch
            a weight more than once keep its kernel form.
        b: optional (Cout,) bias.
        act: None | "lrelu" (slope 0.01) | "lrelu2" (slope 0.2).
        res: optional (B, H, W, Cout) residual, added after ``act``.
        roll: convolve the cyclically rolled canvas
            ``torch.roll(x, (roll, roll), dims=(1, 2))`` (any size), without
            a separate roll pass.
        ln_pre: optional (scale, bias) of a LayerNorm over Cin (eps 1e-5)
            applied before the conv; the zero padding applies to its output.

    A CUDA tensor runs the K3 kernel (``csrc/conv3x3.cu``) or raises; a CPU
    tensor runs :func:`conv3x3_plain`.
    """
    if isinstance(w, Conv3x3Weights):
        if b is not None:
            raise ValueError("the kernel form holds the bias; pass b=None")
    elif x.is_cuda:
        w = conv3x3_weights(w, b, x.dtype)
    if x.is_cuda:
        return _conv3x3_cuda(x, w, act, res, roll, ln_pre)
    if isinstance(w, Conv3x3Weights):
        w, b = w.hwio, w.b
    return conv3x3_plain(x, w, b, act=act, res=res, roll=roll, ln_pre=ln_pre)


conv3x3.launches = 0


def conv_after_shuffle_weights(w: torch.Tensor, r: int) -> torch.Tensor:
    """Weights for running a conv before the pixel-shuffle:
    ``conv(pixel_shuffle(x, r), w) == pixel_shuffle(conv(x, w'), r)``.

    Args:
        w: (k, k, Cin, Cout) weights (k odd) of the conv after the shuffle.
        r: the pixel-shuffle factor.
    Returns:
        (kp, kp, Cin*r^2, Cout*r^2), kp = 2 * ceil((k // 2) / r) + 1. (Bias:
        ``b.repeat_interleave(r * r)``.)
    """
    k, _, cin, cout = w.shape
    if k % 2 != 1:
        raise ValueError(f"odd kernel size required, got {k}")
    rad = k // 2
    radp = -(-rad // r)
    kp = 2 * radp + 1
    wp = w.new_zeros(kp, kp, cin * r * r, cout * r * r)
    for i in range(r):
        for j in range(r):
            for dy in range(-rad, rad + 1):
                for dx in range(-rad, rad + 1):
                    a, dyp = (i + dy) % r, (i + dy) // r
                    bb, dxp = (j + dx) % r, (j + dx) // r
                    wp[dyp + radp, dxp + radp, a * r + bb::r * r,
                       i * r + j::r * r] = w[dy + rad, dx + rad]
    return wp


def compose_conv_weights(wa: torch.Tensor, ba: torch.Tensor,
                         wb: torch.Tensor, bb: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weights and bias of ``conv_b(conv_a(x) + ba) + bb`` as one conv
    (kernel ka + kb - 1), in float32. Exact in the interior; within a
    (ka//2 + kb//2)-pixel border ring the zero padding differs, so callers
    recompute the ring sequentially."""
    ka, _, cin, _ = wa.shape
    kb, _, _, cout = wb.shape
    waf, wbf = wa.float(), wb.float()
    w = waf.new_zeros(ka + kb - 1, ka + kb - 1, cin, cout)
    for dy in range(kb):
        for dx in range(kb):
            w[dy:dy + ka, dx:dx + ka] += torch.einsum("ijcm,mo->ijco", waf,
                                                      wbf[dy, dx])
    b = bb.float() + ba.float() @ wbf.sum(dim=(0, 1))
    return w, b
