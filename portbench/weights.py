"""Seeded weights: one state dict, under the reference's names, handed to the
program and, identically, to the reference.

Every parameter is drawn in one ``randn`` call on the device, then scaled by
a per-element vector built from a per-parameter table (a few large calls,
not one per leaf), and copied to the host once. The scales are the usual
initialisation: weights ``N(0, 1) / sqrt(fan_in)`` (times a ``gains``
factor of the configuration, which keeps the output unsaturated), norm
scales and attention temperatures ``1 + 0.05 N``, biases ``0.02 N``,
relative-position bias tables ``0.02 N``.
"""

from __future__ import annotations

import math

import torch

from . import seeds


def _rule(name: str, shape: tuple, gains: dict) -> tuple[float, float]:
    """(scale, shift) of parameter ``name``."""
    if name.endswith("relative_position_bias_table"):
        return 0.02, 0.0
    if name.endswith("temperature"):
        return 0.05, 1.0
    if len(shape) == 1:
        return (0.02, 0.0) if name.endswith("bias") else (0.05, 1.0)
    fan_in = math.prod(shape[1:])
    return gains.get(name, 1.0) / math.sqrt(fan_in), 0.0


def make_state(shapes: dict[str, tuple], gains: dict, seed: int,
               device) -> dict[str, torch.Tensor]:
    """{name: float32 CPU tensor} for the parameter ``shapes`` (in order)."""
    names = list(shapes)
    counts = [math.prod(shapes[n]) for n in names]
    rules = [_rule(n, tuple(shapes[n]), gains) for n in names]
    gen = seeds.generator(seed, "weights", device)
    z = torch.randn(sum(counts), generator=gen, device=device)
    reps = torch.tensor(counts, device=device)
    scale = torch.tensor([r[0] for r in rules], device=device)
    shift = torch.tensor([r[1] for r in rules], device=device)
    z = z * scale.repeat_interleave(reps) + shift.repeat_interleave(reps)
    flat = z.cpu()
    return {n: t.view(shapes[n])
            for n, t in zip(names, flat.split(counts))}
