"""The pair-fused Swin block (K8, ``swin_pair_block``) against the
sequential chain, at SwinIR-M's band: the counterpart of the JAX package's
``scripts/lab_r5.py``.

The chain is an RSTB's real frame sequence of ``NBLK`` = 12 blocks at the
band shape (1, 552, 1920, 180) in bf16 (6 heads, window 8, hidden 360):

- ``seq_frames``: 12 ``swin_block`` calls at dc 0, -s, +s, -s, ... (s =
  ws/2; the odd blocks shifted with the mask bank), ending in frame -s;
- ``pair``: 6 ``swin_pair_block`` calls, ``dc1`` 0 for the first pair and
  +s after it, each ending in frame -s.

Both compute the same function (fast numerics). The weights take
``make_blk``'s distributions (LN scales 1 + N(0, 0.02), every other tensor
N(0, 1) x 0.02), drawn from explicit ``torch.Generator`` s, and the input
is uniform in [0, 1).

    python -m image_restoration_agent_tpu_torch.lab.lab_r5 [--device cpu]
        [--size H W] [--nblk N]

prints ms per block of each form and the pair chain's largest difference
from the sequential chain. The JAX script's other variants (``seq_packexp``,
``seq_bf16exp``, ``pair_ur*``, ``pair_w*``) are TPU lab knobs (a packed
softmax layout, a half-precision exp, the pair loop's unroll, the column
chunk width) with no Hopper meaning, and are not carried over.
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ops.swin_block import (kernel_params, swin_block, swin_pair_block)
from ..ops.window_attention import shift_attention_mask
from . import time_ms

NBLK = 12
C, HEADS, WS = 180, 6, 8
BAND = (1, 552, 1920, C)


def make_blocks(nblk: int, dtype: torch.dtype, device, c: int = C,
                heads: int = HEADS, ws: int = WS, seed: int = 0) -> list:
    """``nblk`` blocks' kernel-form weights, block ``i`` from a generator
    seeded ``seed + i`` (the same values in every dtype)."""
    out = []
    n = ws * ws
    for i in range(nblk):
        gen = torch.Generator().manual_seed(seed + i)

        def nrm(*shape):
            return torch.randn(*shape, generator=gen) * 0.02

        ts = (1 + nrm(c), nrm(c), nrm(c, 3 * c), nrm(3 * c), nrm(c, c),
              nrm(c), nrm(heads, n, n), 1 + nrm(c), nrm(c), nrm(c, 2 * c),
              nrm(2 * c), nrm(2 * c, c), nrm(c))
        out.append(kernel_params(*(t.to(device) for t in ts),
                                 num_heads=heads, dtype=dtype))
    return out


def mask_bank(ws: int, device) -> torch.Tensor:
    n = ws * ws
    return torch.from_numpy(shift_attention_mask(
        2 * ws, 2 * ws, ws, ws // 2).reshape(2, 2, n, n)).to(device)


def chain_seq(x, blks, bank, *, heads: int = HEADS, ws: int = WS,
              block=swin_block):
    """The RSTB frame chain, one block at a time: dc 0, -s, +s, -s, ...;
    the output in frame -s."""
    s, frame = ws // 2, 0
    for i, p in enumerate(blks):
        shifted = i % 2 == 1
        req = -s if shifted else 0
        x = block(x, p, num_heads=heads, ws=ws, dc=req - frame,
                  mask_bank=bank if shifted else None, fast=True)
        frame = req
    return x


def chain_pair(x, blks, bank, *, heads: int = HEADS, ws: int = WS,
               pair=swin_pair_block):
    """The same chain as pairs: dc1 0, then +s."""
    for i in range(len(blks) // 2):
        x = pair(x, blks[2 * i], blks[2 * i + 1], bank, num_heads=heads,
                 ws=ws, dc1=0 if i == 0 else ws // 2)
    return x


def band_input(shape, dtype, device, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(*shape, generator=gen).to(device, dtype)


def run(device="cuda", shape=BAND, nblk: int = NBLK, reps: int = 6) -> dict:
    """Both chains in bf16 on ``device``: ms per block (the mean of
    ``reps`` chains after one) and the largest |pair - seq|."""
    dev = resolve_device(device)
    x = band_input(shape, torch.bfloat16, dev)
    blks = make_blocks(nblk, torch.bfloat16, dev, c=shape[-1])
    bank = mask_bank(WS, dev)
    out = {"shape": list(shape), "blocks": nblk, "dtype": "bfloat16"}
    with torch.no_grad():
        seq = chain_seq(x, blks, bank)
        pair = chain_pair(x, blks, bank)
        out["max_abs_diff"] = float((pair.float() - seq.float()).abs().max())
        for name, fn in (("seq_frames", lambda: chain_seq(x, blks, bank)),
                         ("pair", lambda: chain_pair(x, blks, bank))):
            out[f"{name}_ms_per_block"] = time_ms(fn, reps, dev) / nblk
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, nargs=2, default=BAND[1:3],
                    metavar=("H", "W"))
    ap.add_argument("--nblk", type=int, default=NBLK)
    args = ap.parse_args(argv)
    r = run(args.device, (1, *args.size, C), args.nblk,
            reps=6 if args.device != "cpu" else 1)
    for name in ("seq_frames", "pair"):
        print(f"{name:12s} {r[name + '_ms_per_block']:9.3f} ms/block")
    print(f"pair vs seq_frames max |diff| {r['max_abs_diff']:.5f}")


if __name__ == "__main__":
    main()
