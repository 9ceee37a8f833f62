"""``lab_strip``: the Swin strip kernel's unshifted attention half with
its ablation modes, the counterpart of the JAX package's
``scripts/kernel_lab.py:lab_strip``.

The function: LN -> qkv (q unscaled) -> per-window MHSA with logits
``(q.k) * head_dim**-0.5`` in float32 plus the (heads, N, N) bias ``rpb``,
a max-subtracted exact softmax, ``p`` cast to ``x.dtype`` -> proj -> +
residual; unshifted, no mask; bf16 casts where the TPU kernel casts them
(the LN output, q, k, v, p, the attention output).

Modes. ``stacked``, ``paired``, ``paired_staged`` and ``paired_perhead``
are four TPU layouts of this one function (windows stacked, or paired to
fill a 128-row MXU tile, with the logits staged or per head). On the card
they are one form: K1 (LN + window gather -> qkv), K2 exact with the logit
scale, K1 (proj + residual + scatter); three launches, no new kernel.

Cost probes, each a wrong result at the right cost as in the JAX lab:

- ``noattn``: K2 dropped, the attention output is q;
- ``nownd``: as ``noattn``, with identity row maps for the window gather
  and scatter;
- ``base_noln``: as ``noattn`` without the LN prologue;
- ``base_noproj``: as ``noattn`` without the proj launch (q is written
  back to the canvas by a library copy).

``base_noqkv`` (q = k = v = the LN output) and ``paired_nokm`` (the paired
logits without the head-masked key copies) probe the TPU's VMEM and lane
layouts and have no Hopper meaning: ``lab_strip`` raises ValueError for
them.

    python -m image_restoration_agent_tpu_torch.lab.kernel_lab [--device cpu]
        [--size H W]

runs kernel_lab's shape (4, 256, 256, 180) in bf16 and prints each mode's
ms per call, timed over 30 chained calls.
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ops.swin_block import (GATHER, IDENTITY, SCATTER, kernel_matrix,
                              token_linear, token_linear_plain,
                              window_attention, window_attention_plain)
from ..ops.window_attention import window_reverse
from . import time_ms

MODES = ("stacked", "paired", "paired_staged", "paired_perhead")
PROBES = ("noattn", "nownd", "base_noln", "base_noproj")
TPU_ONLY = ("base_noqkv", "paired_nokm")
ITERS = 30
SHAPE = (4, 256, 256, 180)


def _check(x, ws, mode):
    if mode in TPU_ONLY:
        raise ValueError(f"lab_strip mode {mode!r} probes the TPU's VMEM and "
                         "lane layouts and has no Hopper counterpart")
    if mode not in MODES + PROBES:
        raise ValueError(f"unknown lab_strip mode {mode!r}")
    if x.shape[1] % ws or x.shape[2] % ws:
        raise ValueError(f"canvas {tuple(x.shape[1:3])} is not a multiple "
                         f"of window {ws}")


def _lab_strip(linear, attention, x, lnw, lnb, wqkv, bqkv, wproj, bproj,
               rpb, num_heads, ws, mode):
    b, h, w, c = x.shape
    dt = x.dtype
    geom = (b, h, w, ws, 0)
    gather, scatter = (IDENTITY, IDENTITY) if mode == "nownd" else (
        GATHER, SCATTER)
    xt = x.contiguous().reshape(-1, c)
    ln = None if mode == "base_noln" else (lnw.float(), lnb.float())
    qkv = linear(xt, kernel_matrix(wqkv, dt), bqkv.float(), ln=ln,
                 geom=geom, a_map=gather)
    if mode in MODES:
        a = attention(qkv, rpb.float(), None, num_heads=num_heads,
                      nwy=h // ws, nwx=w // ws, fast=False,
                      scale=(c // num_heads) ** -0.5)
    else:
        a = qkv[:, :c].contiguous()
    if mode == "base_noproj":
        return window_reverse(a.reshape(-1, ws, ws, c), ws, h, w)
    out = linear(a, kernel_matrix(wproj, dt), bproj.float(), res=xt,
                 geom=geom, r_map=gather, o_map=scatter, out_dtype=dt)
    return out.reshape(b, h, w, c)


def lab_strip_plain(x, lnw, lnb, wqkv, bqkv, wproj, bproj, rpb, *,
                    num_heads: int = 6, ws: int = 8, mode: str = "stacked"):
    """Plain PyTorch version of :func:`lab_strip`: the same sequence through
    the kernels' plain versions."""
    _check(x, ws, mode)
    return _lab_strip(token_linear_plain, window_attention_plain, x, lnw,
                      lnb, wqkv, bqkv, wproj, bproj, rpb, num_heads, ws,
                      mode)


def lab_strip(x, lnw, lnb, wqkv, bqkv, wproj, bproj, rpb, *,
              num_heads: int = 6, ws: int = 8, mode: str = "stacked"):
    """The unshifted attention half over ``x`` (B, H, W, C), H and W
    multiples of ``ws``: weights in the JAX lab's layout (``wqkv`` (C, 3C)
    and ``wproj`` (C, C) applied as ``x @ w``, q unscaled; ``rpb`` (heads,
    N, N)). ``mode`` is one of :data:`MODES` (one function) or a cost probe
    of :data:`PROBES` (see the module docstring).

    A CUDA tensor runs K1, K2, K1 (two K1 without K2 for the probes, one
    for ``base_noproj``) or raises; a CPU tensor runs
    :func:`lab_strip_plain`."""
    if not x.is_cuda:
        return lab_strip_plain(x, lnw, lnb, wqkv, bqkv, wproj, bproj, rpb,
                               num_heads=num_heads, ws=ws, mode=mode)
    _check(x, ws, mode)
    out = _lab_strip(token_linear, window_attention, x, lnw, lnb, wqkv,
                     bqkv, wproj, bproj, rpb, num_heads, ws, mode)
    lab_strip.launches += 1
    return out


lab_strip.launches = 0


def lab_weights(device, c: int = SHAPE[-1], heads: int = 6, ws: int = 8,
                seed: int = 0) -> tuple:
    """kernel_lab's ``main`` weights: LN 1 and 0, qkv and proj N(0, 1) x
    0.02 with zero biases, rpb N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    n = ws * ws
    ts = (torch.ones(c), torch.zeros(c),
          torch.randn(c, 3 * c, generator=gen) * 0.02, torch.zeros(3 * c),
          torch.randn(c, c, generator=gen) * 0.02, torch.zeros(c),
          torch.randn(heads, n, n, generator=gen))
    return tuple(t.to(device) for t in ts)


def run(device="cuda", shape=SHAPE, iters: int = ITERS) -> dict:
    """Every mode in bf16 on ``device``: ms per call over ``iters``
    chained calls (each output feeds the next call), and each layout
    mode's largest difference from ``stacked``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    wts = lab_weights(dev, c=shape[-1])
    out = {"shape": list(shape), "dtype": "bfloat16", "iters": iters}
    with torch.no_grad():
        ref = lab_strip(x, *wts, mode="stacked")
        for m in MODES[1:]:
            out[f"{m}_max_abs_diff"] = float(
                (lab_strip(x, *wts, mode=m).float() - ref.float()).abs()
                .max())

        def chain(mode):
            y = x
            for _ in range(iters):
                y = lab_strip(y, *wts, mode=mode)
            return y

        for m in MODES + PROBES:
            out[f"{m}_ms"] = time_ms(lambda m=m: chain(m), 1, dev) / iters
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, nargs=2, default=SHAPE[1:3],
                    metavar=("H", "W"))
    args = ap.parse_args(argv)
    r = run(args.device, (SHAPE[0], *args.size, SHAPE[3]),
            iters=ITERS if args.device != "cpu" else 2)
    for m in MODES[1:]:
        print(f"{m} vs stacked max err: {r[m + '_max_abs_diff']:.5f}")
    for m in MODES + PROBES:
        print(f"lab[{m}]: {r[m + '_ms']:.3f} ms")


if __name__ == "__main__":
    main()
