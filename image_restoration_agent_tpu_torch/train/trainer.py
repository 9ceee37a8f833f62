"""Trainer: the BasicSR-style training loop (counterpart of
``image_restoration_agent_tpu/train/trainer.py``).

One sharded train step over a process-group mesh
(``parallel/train_step.py``), reference-named ``.pth`` checkpoints,
periodic validation by PSNR, and paired-crop data fed by the degradation
synthesizer. The config maps onto the reference YAML's concepts
(total_iter, scheduler periods, val_freq, save_freq, crop size, batch).

The model's parameters at construction are the initial state
(``build_model(name, seed=...)`` gives the registry's initialisation); the
update rule is the JAX ``Trainer``'s optax chain
(``parallel.train_step.UpdateRule``). Checkpoints are the port's one weight
format, a reference-named state dict, where the JAX package writes orbax.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..iqa.metrics import psnr
from ..parallel.mesh import make_mesh
from ..parallel.train_step import (TrainState, UpdateRule,
                                   make_sharded_train_step, make_train_state)
from .losses import charbonnier_loss


@dataclasses.dataclass
class TrainConfig:
    total_iters: int = 1000
    batch_size: int = 8
    crop_size: int = 128
    base_lr: float = 3e-4
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    lr_schedule: Optional[Callable[[int], float]] = None
    loss: Callable = charbonnier_loss
    val_freq: int = 200
    save_freq: int = 500
    log_freq: int = 50
    mesh_axes: Optional[dict] = None       # e.g. {"data": 4, "model": 2}
    seed: int = 0


class Trainer:
    def __init__(self, model: torch.nn.Module, config: TrainConfig,
                 work_dir: str | Path = "train_work",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = config
        self.work_dir = Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.history: list[dict] = []
        self.tx = UpdateRule(config.lr_schedule or config.base_lr,
                             grad_clip=config.grad_clip,
                             weight_decay=config.weight_decay)
        self.mesh = make_mesh(config.mesh_axes or {"data": 1, "model": 1})
        self.step_fn, self._shard_state, self._shard_batch = \
            make_sharded_train_step(self.model, self.tx, self.mesh,
                                    loss_fn=config.loss)

    # ------------- lifecycle -------------

    def init_state(self) -> TrainState:
        """The state of the model's current parameters, sharded."""
        return self._shard_state(make_train_state(self.model, self.tx))

    def _batch(self, a) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a, np.float32)).to(self.device)
        return self._shard_batch(t)

    def fit(self, data: Iterable[tuple[np.ndarray, np.ndarray]],
            state: Optional[TrainState] = None,
            val_pairs: Optional[list] = None) -> TrainState:
        if state is None:
            state = self.init_state()
        t0 = time.time()
        for i, (lq, hq) in enumerate(data):
            if i >= self.cfg.total_iters:
                break
            state, loss = self.step_fn(state, self._batch(lq),
                                       self._batch(hq))
            if (i + 1) % self.cfg.log_freq == 0 or i == 0:
                self.history.append({"step": i + 1, "loss": float(loss),
                                     "seconds": round(time.time() - t0, 2)})
            if val_pairs and (i + 1) % self.cfg.val_freq == 0:
                self.history.append({"step": i + 1,
                                     "val_psnr": self.validate(state,
                                                               val_pairs)})
            if (i + 1) % self.cfg.save_freq == 0:
                self.save_checkpoint(state, i + 1)
        (self.work_dir / "history.json").write_text(
            json.dumps(self.history, indent=2))
        return state

    @torch.no_grad()
    def validate(self, state: TrainState, pairs: list) -> float:
        """Mean PSNR of the model's clamped outputs over (lq, hq) pairs."""
        vals = []
        for lq, hq in pairs:
            pred = self.model(torch.as_tensor(
                np.asarray(lq, np.float32)[None]).to(self.device))
            vals.append(float(psnr(pred[0].clamp(0, 1), torch.as_tensor(
                np.asarray(hq, np.float32)).to(self.device))))
        return float(np.mean(vals))

    # ------------- checkpoints (reference-named state dicts) -------------

    def save_checkpoint(self, state: TrainState, step: int) -> Path:
        """``<work_dir>/ckpt_<step>.pth``: the model's whole state dict
        (the step gathers sharded parameters into the model), written by
        rank 0."""
        path = (self.work_dir / f"ckpt_{step}.pth").resolve()
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_rank() == 0:
            torch.save({k: v.detach().cpu() for k, v in
                        self.model.state_dict().items()}, path)
        return path

    def load_checkpoint(self, path: str | Path) -> dict:
        """Load a checkpoint into the model (``weights_only=True``,
        ``strict=True``) and return its state dict; :meth:`init_state`
        then gives the state to train on from it."""
        sd = torch.load(Path(path), map_location="cpu", weights_only=True)
        self.model.load_state_dict(sd, strict=True)
        return sd


def paired_crop_stream(hq_images: list[np.ndarray], degrade: Callable,
                       batch_size: int, crop: int, seed: int = 0):
    """Infinite stream of (lq, hq) float32 batches in [0, 1]: random crops
    and their degradation, drawn from one ``np.random.default_rng(seed)``
    in the JAX package's order (same seed, same crops)."""
    rng = np.random.default_rng(seed)
    while True:
        lqs, hqs = [], []
        for _ in range(batch_size):
            img = hq_images[rng.integers(len(hq_images))]
            h, w = img.shape[:2]
            y = rng.integers(0, max(h - crop, 1))
            x = rng.integers(0, max(w - crop, 1))
            patch = img[y:y + crop, x:x + crop]
            lq = degrade(patch, rng)
            hqs.append(patch.astype(np.float32) / 255.0)
            lqs.append(lq.astype(np.float32) / 255.0)
        yield np.stack(lqs), np.stack(hqs)
