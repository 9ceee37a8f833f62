"""Gating nonlinearities: NAFNet SimpleGate and Restormer's gated GELU
(counterpart of ``image_restoration_agent_tpu/ops/gates.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def simple_gate(x: torch.Tensor) -> torch.Tensor:
    """NAFNet SimpleGate: split the channels in half and multiply."""
    x1, x2 = x.chunk(2, dim=-1)
    return x1 * x2


def gated_gelu(x: torch.Tensor) -> torch.Tensor:
    """Restormer GDFN gate: ``gelu(x1) * x2`` with the exact (erf) GELU."""
    x1, x2 = x.chunk(2, dim=-1)
    return F.gelu(x1) * x2
