"""The port's kernel lab: the counterparts of the JAX package's lab
scripts, each an entry point that drives a kernel no served model reaches.

- ``lab_r5``: a 12-block RSTB frame chain at SwinIR-M's band, as 12
  ``swin_block`` launches and as 6 ``swin_pair_block`` launches (K8);
  ``python -m image_restoration_agent_tpu_torch.lab.lab_r5``.
- ``head_pair``: the x4 head's tail (``upsample_tail``'s two convs) as two
  K3 launches and as one ``conv3x3_pair`` (K7);
  ``python -m image_restoration_agent_tpu_torch.lab.head_pair``.
- ``kernel_lab``: ``lab_strip``, the strip kernel's unshifted attention
  half with its ablation modes (K1, K2, K1);
  ``python -m image_restoration_agent_tpu_torch.lab.kernel_lab``.

Each runs on the card unless given ``--device cpu`` (plain versions, for a
small ``--size``).
"""

from __future__ import annotations

import time

import torch


def time_ms(fn, reps: int, device: torch.device, warm: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls after ``warm``
    calls: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warm):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps
