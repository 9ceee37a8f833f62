"""The x4 head's tail as one fused conv pair (K7, ``conv3x3_pair``) against
the two K3 launches that serving runs.

``models/common.py:upsample_tail`` runs the upsample conv (64 -> 256) and
``conv_last`` moved in front of the pixel shuffle (256 -> 12 in plane
space, :func:`tail_weights`) as two ``conv3x3`` launches, with the 256
channel intermediate ``u`` written to device memory between them. Here the
same two convs run both ways on one SwinIR-M band's second-stage shapes:

- the band's whole second stage, (1, 1104, 3840, 64) -> 256 -> 12;
- the head's ring strip, (1, 24, 3840, 64), which the served 2K request
  launches (8 of its 26 K3 launches).

Serving is not re-routed: ``upsample_tail`` keeps the two-conv form.

    python -m image_restoration_agent_tpu_torch.lab.head_pair [--device cpu]
        [--size H W]

prints ms of each form and their largest difference, per shape.
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..models.common import tail_weights
from ..ops.conv3x3 import conv3x3, conv3x3_pair, conv3x3_pair_weights
from . import time_ms

SHAPES = ((1, 1104, 3840, 64), (1, 24, 3840, 64))
CMID, CLAST, R = 256, 3, 2


def head_weights(device, seed: int = 0) -> tuple:
    """The tail's HWIO weights: upsample conv (3, 3, 64, 256), its bias,
    conv_last (3, 3, 64, 3) and its bias, fan-in scaled."""
    gen = torch.Generator().manual_seed(seed)
    cin = SHAPES[0][-1]

    def rnd(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    return (rnd(3, 3, cin, CMID, scale=(9 * cin) ** -0.5),
            rnd(CMID, scale=0.1), rnd(3, 3, cin, CLAST,
                                      scale=(9 * cin) ** -0.5),
            rnd(CLAST, scale=0.1))


def forms(w1, b1, wl, bl, dtype):
    """(two-K3 kernel forms, the pair's kernel form) of the tail."""
    k1, k2 = tail_weights(w1, b1, wl, bl, R, dtype)
    return (k1, k2), conv3x3_pair_weights(k1.hwio, k1.b, k2.hwio, k2.b,
                                          dtype)


def two_k3(x, k1, k2):
    return conv3x3(conv3x3(x, k1), k2)


def run(device="cuda", shapes=SHAPES, reps: int = 5) -> list[dict]:
    dev = resolve_device(device)
    dtype = torch.bfloat16
    (k1, k2), kp = forms(*head_weights(dev), dtype)
    gen = torch.Generator().manual_seed(1)
    rows = []
    with torch.no_grad():
        for shape in shapes:
            x = torch.randn(*shape, generator=gen).to(dev, dtype)
            seq, pair = two_k3(x, k1, k2), conv3x3_pair(x, kp)
            rows.append({
                "shape": list(shape), "dtype": "bfloat16",
                "two_k3_ms": time_ms(lambda: two_k3(x, k1, k2), reps, dev),
                "pair_ms": time_ms(lambda: conv3x3_pair(x, kp), reps, dev),
                "max_abs_diff": float((pair.float() - seq.float()).abs()
                                      .max())})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, nargs=2, metavar=("H", "W"),
                    help="one (1, H, W, 64) shape instead of the band's two")
    args = ap.parse_args(argv)
    shapes = SHAPES if args.size is None else ((1, *args.size, 64),)
    for r in run(args.device, shapes, reps=5 if args.device != "cpu" else 1):
        print(f"{r['shape']}: two K3 {r['two_k3_ms']:.3f} ms, "
              f"conv3x3_pair {r['pair_ms']:.3f} ms, max |diff| "
              f"{r['max_abs_diff']:.5f}")


if __name__ == "__main__":
    main()
