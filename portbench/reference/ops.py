"""The products of the plain references, in float32 or, for the control, in
TF32.

Every multiply-accumulate of a reference (linear layers, convolutions, the
attention products) goes through these four functions. ``prec`` is
``"float32"`` (the configuration's precision, TF32 off) or ``"tf32"`` (the
control: the nearest precision below). On the card TF32 is the library's own
switch; the CPU has no TF32, so there the operands are rounded to it (10
mantissa bits, nearest, ties away from zero) and multiplied in float32,
which is what a TF32 tensor-core product computes.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to TF32 (the low 13 mantissa bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -8192).view(torch.float32)


@contextlib.contextmanager
def precision(prec: str):
    """Set the card's float32 product precision for a reference forward and
    restore the previous switches after it."""
    if prec not in PRECISIONS:
        raise ValueError(f"unknown precision {prec!r}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = prec == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _op(x: torch.Tensor, prec: str) -> torch.Tensor:
    return tf32_round(x) if prec == "tf32" and not x.is_cuda else x


def linear(x, w, b, prec: str):
    return F.linear(_op(x, prec), _op(w, prec), b)


def matmul(a, b, prec: str):
    return torch.matmul(_op(a, prec), _op(b, prec))


def conv2d(x, w, b, prec: str, padding: int = 0, groups: int = 1):
    return F.conv2d(_op(x, prec), _op(w, prec), b, padding=padding,
                    groups=groups)
