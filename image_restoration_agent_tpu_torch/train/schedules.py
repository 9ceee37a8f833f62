"""Learning-rate schedules as plain ``step -> lr`` functions (counterpart
of ``image_restoration_agent_tpu/train/schedules.py``), usable by the
port's update rule (``parallel/train_step.py``) and by
``torch.optim.lr_scheduler.LambdaLR`` (divide by the base rate).

Rebuilds of X-Restormer's ``lr_scheduler.py``:

- MultiStepRestartLR: gamma decay at milestones, weight-scaled restarts;
- CosineAnnealingRestartLR: cosine from ``eta_max * weight`` to
  ``eta_min`` per restart period;
- CosineAnnealingRestartCyclicLR: a per-period ``eta_min`` (Restormer's
  progressive training);
- the gradual warmup wrapper MPRNet's training vendors.

The JAX versions evaluate in float32 on traced steps; these evaluate in
float64 on the host, so the two agree to float32 rounding.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence

import numpy as np


def multi_step_restart_lr(base_lr: float, milestones: Sequence[int],
                          gamma: float = 0.1,
                          restarts: Sequence[int] = (0,),
                          restart_weights: Sequence[float] = (1,)
                          ) -> Callable[[int], float]:
    assert len(restarts) == len(restart_weights)
    ms = sorted(milestones)

    def schedule(step) -> float:
        if any(step == r for r in restarts):
            return float(sum(base_lr * w for r, w in
                             zip(restarts, restart_weights) if step == r))
        return base_lr * gamma ** bisect.bisect_right(ms, step)

    return schedule


def _cosine_core(base_lr, periods, restart_weights, eta_mins):
    cumulative = np.cumsum(periods).tolist()
    last = len(periods) - 1

    def schedule(step) -> float:
        idx = min(bisect.bisect_left(cumulative, int(step)), last)
        nearest = 0.0 if idx == 0 else float(cumulative[idx - 1])
        frac = (float(step) - nearest) / periods[idx]
        eta_min = eta_mins[idx]
        return eta_min + restart_weights[idx] * 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * frac))

    return schedule


def cosine_annealing_restart_lr(base_lr: float, periods: Sequence[int],
                                restart_weights: Sequence[float] = (1,),
                                eta_min: float = 0.0
                                ) -> Callable[[int], float]:
    assert len(periods) == len(restart_weights)
    return _cosine_core(base_lr, list(periods), list(restart_weights),
                        [eta_min] * len(periods))


def cosine_annealing_restart_cyclic_lr(base_lr: float,
                                       periods: Sequence[int],
                                       restart_weights: Sequence[float],
                                       eta_mins: Sequence[float]
                                       ) -> Callable[[int], float]:
    assert len(periods) == len(restart_weights) == len(eta_mins)
    return _cosine_core(base_lr, list(periods), list(restart_weights),
                        list(eta_mins))


def with_gradual_warmup(schedule: Callable[[int], float], warmup_steps: int,
                        multiplier: float = 1.0) -> Callable[[int], float]:
    """Gradual warmup (MPRNet's vendored pytorch-gradual-warmup-lr):
    linearly scale the wrapped schedule from base/multiplier to full over
    ``warmup_steps``."""

    def warmed(step) -> float:
        s = float(step)
        lr = schedule(step)
        if s >= warmup_steps:
            return lr
        frac = min(max(s / max(warmup_steps, 1), 0.0), 1.0)
        return lr * (1.0 + (multiplier - 1.0) * frac) / multiplier

    return warmed


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule``: ``init_value`` times a cosine from
    1 to ``alpha`` over ``decay_steps``, flat after (the classifier
    trainers' schedule)."""

    def schedule(step) -> float:
        frac = min(float(step), decay_steps) / decay_steps
        cosine = 0.5 * (1 + math.cos(math.pi * frac))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule
