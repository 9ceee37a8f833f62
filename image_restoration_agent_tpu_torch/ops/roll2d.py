"""The Swin shift as a kernel: a cyclic roll of a (B, H, W, C) canvas by
(shift, shift) on (H, W), |shift| = ws/2.

Replaces ``image_restoration_agent_tpu/ops/pallas_attention.py:
roll2d_pallas`` (HAT undoes every shifted HAB's roll with it). Same
contract and assertions: ``shift`` is +-ws/2, H and W are multiples of ws.

The CUDA kernel is ``csrc/roll2d.cu`` (K6): a gather-copy, so what bounds
it on the H100 is the bytes: the canvas read once and written once (at
HAT's tile batch, 5x256x256x180 bf16, 0.24 GB: 0.070 ms at 3.35 TB/s).
Every thread moves one 16-byte unit (8 bf16) of a pixel row: a row of W*C
elements is rotated by shift*C elements, which at ws 16 and C 180 is a
whole number of 16-byte units, so loads and stores stay 16 bytes wide and
coalesced; narrower units are taken where the sizes do not allow 16.

The plain version is ``torch.roll``.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .autograd import kernel_function


def _check(x: torch.Tensor, shift: int, ws: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"roll2d takes (B, H, W, C), not {tuple(x.shape)}")
    s = ws // 2
    h, w = x.shape[1], x.shape[2]
    if shift not in (s, -s) or h % ws or w % ws:
        raise ValueError(f"roll2d: shift {shift} must be +-{s} and the "
                         f"canvas {h}x{w} a multiple of window {ws}")


def roll2d_plain(x: torch.Tensor, shift: int, ws: int = 8) -> torch.Tensor:
    """Plain version of :func:`roll2d`: ``torch.roll``."""
    _check(x, shift, ws)
    return torch.roll(x, (shift, shift), dims=(1, 2))


def _unit(*sizes: int) -> int:
    """The widest of 16, 8, 4, 2 bytes dividing every size."""
    for u in (16, 8, 4, 2):
        if all(v % u == 0 for v in sizes):
            return u
    return 1


def _roll2d_cuda(x: torch.Tensor, shift: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.contiguous()
    out = torch.empty_like(x)
    es = x.element_size()
    row_bytes = w * c * es
    shift_bytes = (shift % w) * c * es
    unit = _unit(row_bytes, shift_bytes, x.data_ptr(), out.data_ptr())
    if unit < 2:
        raise ValueError(f"roll2d kernel: {x.dtype} rows of {row_bytes} "
                         f"bytes are not 2-byte aligned")
    fn = kernels.load("roll2d").roll2d
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    err = fn(x.data_ptr(), out.data_ptr(), b * h, h, row_bytes, shift_bytes,
             shift % h, unit, torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "roll2d")
    roll2d.launches += 1
    return out


def _roll2d_launch(side, x):
    shift, ws = side
    _check(x, shift, ws)
    return _roll2d_cuda(x, shift)


def _roll2d_plain(side, x):
    return roll2d_plain(x, *side)


_roll2d_function = kernel_function("roll2d", _roll2d_launch, _roll2d_plain)


def roll2d(x: torch.Tensor, shift: int, ws: int = 8) -> torch.Tensor:
    """``torch.roll(x, (shift, shift), dims=(1, 2))`` of a (B, H, W, C)
    canvas, ``shift`` = +-ws/2, H and W multiples of ``ws``.

    A CUDA tensor runs the K6 kernel or raises; a CPU tensor runs
    :func:`roll2d_plain`. Under autograd the backward is
    :func:`roll2d_plain`'s VJP (``ops/autograd.py``): the roll back."""
    return _roll2d_function((shift, ws), x)


roll2d.launches = 0
