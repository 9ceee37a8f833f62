"""Independent streams from one ``--seed``: the weights, the images and the
request order each take their own, so that changing how one is drawn leaves
the others as they were. Any whole number works, above 32 bits too."""

from __future__ import annotations

import numpy as np
import torch


def stream(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed``."""
    words = [ord(ch) for ch in tag]
    ss = np.random.SeedSequence([seed % 2 ** 128, *words])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream(seed, tag))
    return gen


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(stream(seed, tag))
