"""Spaced DDPM sampler (IDDPM respacing), a loop on the device
(counterpart of ``image_restoration_agent_tpu/models/diffbir/sampler.py``;
reference DiffBIR ``model/spaced_sampler.py``).

An evenly spaced subset of the 1000 sqrt-linear-beta timesteps
(:func:`space_timesteps`), the respaced betas recomputed from the
cumulative alphas (:meth:`SpacedSampler.make_schedule`, numpy float64 cast
to float32 as the JAX package casts it), then ancestral sampling with eps
prediction and the fixed-small posterior variance. The JAX package scans
the steps on the device; here the loop is Python over device tensors.

The noise is x_T and then one draw per step from an explicit
``torch.Generator`` on the model's device, or an injected sequence of the
same draws (the tests feed the JAX package's ``PRNGKey`` draws). The two
frameworks' generators give different numbers from the same seed.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


def space_timesteps(num_timesteps: int, section_counts: Sequence[int] | str
                    ) -> list[int]:
    """Evenly spaced timestep subset (IDDPM semantics)."""
    if isinstance(section_counts, str):
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    all_steps: list[int] = []
    start = 0
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if count > size:
            raise ValueError(f"cannot take {count} steps from {size}")
        stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start + round(cur))
            cur += stride
        start += size
    return sorted(set(all_steps))


class SpacedSampler:
    def __init__(self, num_train_steps: int = 1000,
                 linear_start: float = 0.00085,
                 linear_end: float = 0.0120):
        self.num_train_steps = num_train_steps
        # LDM "linear" schedule: betas from sqrt-linear interpolation
        self.betas_full = np.linspace(
            linear_start ** 0.5, linear_end ** 0.5, num_train_steps,
            dtype=np.float64) ** 2
        self.alphas_cumprod_full = np.cumprod(1.0 - self.betas_full)

    def make_schedule(self, num_steps: int) -> dict[str, np.ndarray]:
        used = space_timesteps(self.num_train_steps, [num_steps])
        last_cum = 1.0
        betas = []
        for t in used:
            cum = self.alphas_cumprod_full[t]
            betas.append(1 - cum / last_cum)
            last_cum = cum
        betas = np.asarray(betas, np.float64)
        ac = np.cumprod(1.0 - betas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        return {
            "timesteps": np.asarray(used, np.int32),
            "sqrt_ac": np.sqrt(ac).astype(np.float32),
            "sqrt_1m_ac": np.sqrt(1 - ac).astype(np.float32),
            "sqrt_recip_ac": np.sqrt(1 / ac).astype(np.float32),
            "sqrt_recipm1_ac": np.sqrt(1 / ac - 1).astype(np.float32),
            "post_log_var": np.log(
                np.maximum(post_var, 1e-20)).astype(np.float32),
            "post_mean_c0": (betas * np.sqrt(ac_prev)
                             / (1 - ac)).astype(np.float32),
            "post_mean_ct": ((1 - ac_prev) * np.sqrt(1 - betas)
                             / (1 - ac)).astype(np.float32),
        }

    def sample(self, eps_fn: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor],
               shape: tuple, *, device: torch.device | str = "cpu",
               generator: torch.Generator | None = None,
               num_steps: int = 50,
               noise: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
        """Ancestral sampling from pure noise, float32.

        ``eps_fn(x, t_train)`` returns the predicted noise; ``t_train`` is
        the (B,) int32 ORIGINAL-schedule timestep. ``noise`` (x_T, then one
        draw per step: ``num_steps + 1`` tensors of ``shape``) replaces the
        draws from ``generator``; the last step's draw is multiplied by 0,
        as in the JAX package.
        """
        sched = self.make_schedule(num_steps)
        n = num_steps
        if noise is not None and len(noise) != n + 1:
            raise ValueError(f"noise holds {len(noise)} draws; the sampler "
                             f"takes {n + 1} (x_T and one per step)")

        def draw(i):
            if noise is not None:
                return noise[i].to(device=device, dtype=torch.float32)
            return torch.randn(shape, generator=generator, device=device,
                               dtype=torch.float32)

        def f32(v) -> torch.Tensor:
            return torch.tensor(v, dtype=torch.float32, device=device)

        x = draw(0)
        for i in range(n):
            idx = n - 1 - i  # reversed schedule
            t = torch.full((shape[0],), int(sched["timesteps"][idx]),
                           dtype=torch.int32, device=device)
            eps = eps_fn(x, t).float()
            x0 = (f32(sched["sqrt_recip_ac"][idx]) * x
                  - f32(sched["sqrt_recipm1_ac"][idx]) * eps)
            x0 = torch.clamp(x0, -1.0, 1.0)
            mean = (f32(sched["post_mean_c0"][idx]) * x0
                    + f32(sched["post_mean_ct"][idx]) * x)
            nonzero = f32(1.0 if idx > 0 else 0.0)
            std = torch.exp(0.5 * f32(sched["post_log_var"][idx]))
            x = mean + nonzero * std * draw(i + 1)
        return x

    def sample_tiled(self, eps_fn: Callable[[torch.Tensor, torch.Tensor],
                                            torch.Tensor],
                     shape: tuple, *, device: torch.device | str = "cpu",
                     generator: torch.Generator | None = None,
                     num_steps: int = 50, tile: int = 64, stride: int = 32,
                     noise: Sequence[torch.Tensor] | None = None
                     ) -> torch.Tensor:
        """Mixture-of-diffusers tiling (reference sample_with_mixdiff): per
        step, eps on overlapping (tile x tile) latent tiles at ``stride``,
        summed and divided by each position's tile count."""
        b, h, w, c = shape
        hs = list(range(0, h - tile, stride)) + [h - tile]
        ws_ = list(range(0, w - tile, stride)) + [w - tile]
        offsets = [(y, x) for y in hs for x in ws_]
        count = torch.zeros((1, h, w, 1), dtype=torch.float32, device=device)
        for y, x in offsets:
            count[:, y:y + tile, x:x + tile] += 1.0

        def eps_tiled(x, t):
            eps = torch.zeros_like(x)
            for y, xo in offsets:
                e = eps_fn(x[:, y:y + tile, xo:xo + tile], t).float()
                eps[:, y:y + tile, xo:xo + tile] += e
            return eps / count

        return self.sample(eps_tiled, shape, device=device,
                           generator=generator, num_steps=num_steps,
                           noise=noise)
