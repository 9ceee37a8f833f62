"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU (the tests
do). Asking for ``cuda`` on a machine without a card raises: nothing in the
port carries on on the CPU behind the caller's back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is a CUDA
    device and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def exact_f32() -> None:
    """Keep float32 convolutions and matmuls in full float32 on the card.

    cuDNN runs float32 convolutions in TF32 by default (about three
    decimal digits); the f32 paths are held to f32 rounding against the
    reference, so both switches are turned off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
