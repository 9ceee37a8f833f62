"""Training (counterpart of ``image_restoration_agent_tpu/train``): the
losses, the schedules, the Trainer over the sharded train step, the
degradation classifier's and the retrieval stand-in's trainers."""

from .losses import charbonnier_loss, l1_loss, psnr_loss
from .schedules import (cosine_annealing_restart_cyclic_lr,
                        cosine_annealing_restart_lr, multi_step_restart_lr,
                        with_gradual_warmup)
from .trainer import TrainConfig, Trainer, paired_crop_stream

__all__ = [
    "multi_step_restart_lr", "cosine_annealing_restart_lr",
    "cosine_annealing_restart_cyclic_lr", "with_gradual_warmup",
    "charbonnier_loss", "l1_loss", "psnr_loss",
    "Trainer", "TrainConfig", "paired_crop_stream",
]
