"""Sharded training step: data parallel over the batch, weights and their
Adam moments sharded over the model axis (counterpart of
``image_restoration_agent_tpu/parallel/train_step.py``).

The JAX step is one jitted function over a ``Mesh`` with the batch on the
``data`` axis, every parameter sharded on the ``model`` axis on the dim
``param_sharding_rule`` picks, and XLA inserting the collectives. Here the
step is written out by hand on the mesh's process groups:

- each data rank runs forward and backward on its slice of the batch, and
  one all-reduce over the ``data`` group turns the gradients (and the loss)
  into their batch means;
- each model rank keeps only its shard of every shardable parameter and of
  its two Adam moments, updates that shard, and one all-gather over the
  ``model`` group writes the whole parameters back into the model for the
  next forward.

Parameters are updated in place (``torch._foreach_*`` under ``no_grad``),
never through ``.data``: the kernels' weight forms are cached on the
parameters' ``_version``, which ``.data`` writes leave unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from .mesh import Mesh


@dataclasses.dataclass
class AdamState:
    """Adam's moments (one per parameter, shaped as the rank's shard) and
    the update count."""

    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: int = 0


@dataclasses.dataclass
class TrainState:
    """``params``: this rank's shard of every parameter, by name (the
    model's own parameter where it is not sharded); ``opt_state`` their
    Adam state; ``step`` the steps taken."""

    params: dict[str, torch.Tensor]
    opt_state: AdamState
    step: int = 0


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax's
    ``global_norm``), float32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float())
                          for t in tensors))


class UpdateRule:
    """The JAX ``Trainer``'s optax chain as one update rule:
    ``clip_by_global_norm(grad_clip)`` (where ``grad_clip > 0``) ->
    ``scale_by_adam(b1, b2, eps)`` -> ``add_decayed_weights(weight_decay)``
    (where > 0) -> ``scale_by_schedule(lambda s: -schedule(s))``.

    As optax computes it: the clip is unguarded (``g / norm * max_norm``
    where ``norm >= max_norm``, no epsilon); the moments are
    ``(1 - b) * g + b * m``; the bias corrections divide by ``1 - b**t`` at
    the count ``t`` after this update; the schedule is read at the count
    before it (0 on the first step). ``optax.adam(lr)`` is the rule with
    neither clip nor decay."""

    def __init__(self, schedule: Callable[[int], float] | float,
                 grad_clip: float = 0.0, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule if callable(schedule) \
            else (lambda step: schedule)
        self.grad_clip, self.weight_decay = grad_clip, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> AdamState:
        return AdamState([torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params], 0)

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: AdamState, norm: torch.Tensor | None = None) -> None:
        """Update ``params`` and ``state`` in place from ``grads``. ``norm``
        is the global gradient norm where ``grads`` are shards of larger
        tensors (default: theirs)."""
        if self.grad_clip > 0:
            if norm is None:
                norm = global_norm(grads)
            if not bool(norm < self.grad_clip):
                grads = torch._foreach_mul(
                    torch._foreach_div(grads, norm), self.grad_clip)
        b1, b2 = self.b1, self.b2
        lr = self.schedule(state.count)
        state.count += 1
        t = state.count
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        # float32 bias corrections, as optax's traced 1 - b**count
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
        den = torch._foreach_sqrt(torch._foreach_div(state.nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(state.mu, bc1), den)
        if self.weight_decay > 0:
            torch._foreach_add_(upd, torch._foreach_mul(
                params, self.weight_decay))
        torch._foreach_add_(params, torch._foreach_mul(upd, -lr))


def param_sharding_rule(shape, size: int) -> int | None:
    """The dim of a leaf of ``shape`` that the model axis of ``size``
    shards: the largest dim divisible by ``size`` (ties to the lower dim),
    or None (replicated). The JAX package's rule, on the JAX leaf's shape."""
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % size == 0 and shape[d] >= size:
            return d
    return None


def reference_layout(module: nn.Module, p: torch.Tensor) -> tuple:
    """The port dims in the order of the JAX leaf's: a conv weight (O, I,
    kh, kw) is the Flax kernel (kh, kw, I, O), a transposed conv's (I, O,
    kh, kw) the Flax (kh, kw, I, O), a linear weight (O, I) the Dense (I,
    O); other leaves keep their order (singleton dims, such as NAFNet's
    (1, C, 1, 1) beta, are never sharded)."""
    from ..models.common import ConvTranspose
    if p.ndim == 4:
        return (2, 3, 0, 1) if isinstance(module, ConvTranspose) \
            else (2, 3, 1, 0)
    if p.ndim == 2:
        return (1, 0)
    return tuple(range(p.ndim))


def shard_dims(model: nn.Module, size: int) -> dict[str, int | None]:
    """Each parameter's shard dim (in the port's layout) on a model axis of
    ``size``: :func:`param_sharding_rule` on the JAX layout's shape."""
    out = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            perm = reference_layout(mod, p)
            d = param_sharding_rule([p.shape[i] for i in perm], size)
            out[f"{mname}.{pname}" if mname else pname] = \
                None if d is None else perm[d]
    return out


def make_train_state(model: nn.Module, tx: UpdateRule) -> TrainState:
    """The whole (unsharded) state of ``model``'s parameters."""
    params = dict(model.named_parameters())
    return TrainState(params, tx.init(list(params.values())), 0)


def _forward_with_graph(model, lq):
    """``model(lq)``, which must record a graph: a forward run under
    ``torch.no_grad()`` (DiffBIR's sampler) cannot be trained."""
    pred = model(lq)
    if not pred.requires_grad:
        raise RuntimeError(
            f"{type(model).__name__}.forward records no autograd graph (it "
            "runs under torch.no_grad()); it cannot be trained")
    return pred


def make_sharded_train_step(model: nn.Module, tx: UpdateRule, mesh: Mesh,
                            data_axis: str = "data",
                            model_axis: str = "model",
                            loss_fn: Callable | None = None):
    """Returns ``(train_step, shard_state, shard_batch)``; ``loss_fn``
    defaults to ``train.losses.charbonnier_loss``.

    ``shard_batch(batch)`` is this rank's slice of the global batch along
    the ``data`` axis; ``shard_state(state)`` keeps this rank's shard of
    every shardable parameter and moment (:func:`shard_dims`);
    ``train_step(state, lq, hq) -> (state, loss)`` takes the data-sharded
    batch, updates ``state`` and the model in place, and returns the
    global batch's mean loss (a 0-d float32 tensor). Every parameter must
    get a gradient, but those whose names start with one of the model's
    ``gradient_free`` prefixes (RIDCP's: no derivative reaches them), which
    take zeros."""
    if loss_fn is None:
        from ..train.losses import charbonnier_loss as loss_fn
    names = [n for n, _ in model.named_parameters()]
    full = dict(model.named_parameters())
    free = tuple(getattr(model, "gradient_free", ()))
    n_data = mesh.shape.get(data_axis, 1)
    n_model = mesh.shape.get(model_axis, 1)
    dims = shard_dims(model, n_model) if n_model > 1 \
        else dict.fromkeys(names)
    me = mesh.index(model_axis) if n_model > 1 else 0

    def piece(name: str, t: torch.Tensor) -> torch.Tensor:
        d = dims[name]
        if d is None:
            return t
        k = t.shape[d] // n_model
        return t.narrow(d, me * k, k)

    def shard_state(state: TrainState) -> TrainState:
        if n_model == 1:
            return state
        params = {n: piece(n, p.detach()).clone() if dims[n] is not None
                  else p for n, p in state.params.items()}
        opt = state.opt_state
        mu = [piece(n, m).clone() for n, m in zip(names, opt.mu)]
        nu = [piece(n, v).clone() for n, v in zip(names, opt.nu)]
        return TrainState(params, AdamState(mu, nu, opt.count), state.step)

    def shard_batch(batch: torch.Tensor) -> torch.Tensor:
        if n_data == 1:
            return batch
        k = batch.shape[0] // n_data
        return batch[mesh.index(data_axis) * k:][:k]

    @torch.no_grad()
    def gather(state: TrainState) -> None:
        sharded = [n for n in names if dims[n] is not None]
        if not sharded:
            return
        flat = torch.cat([state.params[n].reshape(-1) for n in sharded])
        parts = mesh.all_gather(flat, model_axis)
        offset = 0
        for n in sharded:
            shard = state.params[n]
            num = shard.numel()
            pieces = [p[offset:offset + num].reshape(shard.shape)
                      for p in parts]
            full[n].copy_(torch.cat(pieces, dim=dims[n]))
            offset += num

    def train_step(state: TrainState, lq: torch.Tensor, hq: torch.Tensor):
        pred = _forward_with_graph(model, lq)
        loss = loss_fn(pred, hq)
        grads = torch.autograd.grad(loss, [full[n] for n in names],
                                    allow_unused=True)
        # a parameter the model declares out of the loss's reach takes the
        # zero gradient jax.grad gives it; any other without one is a fault
        grads = [torch.zeros_like(full[n]) if g is None and n.startswith(free)
                 else g for n, g in zip(names, grads)]
        missing = [n for n, g in zip(names, grads) if g is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing}")
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().reshape(1)])
        if n_data > 1:  # the batch mean of every gradient and of the loss
            mesh.all_reduce(flat, data_axis)
            flat /= n_data
        grads = list(torch.split(flat[:-1], [g.numel() for g in grads]))
        grads = [g.view(full[n].shape) for n, g in zip(names, grads)]
        norm = global_norm(grads) if tx.grad_clip > 0 else None
        tx.update([state.params[n] for n in names],
                  [piece(n, g) for n, g in zip(names, grads)],
                  state.opt_state, norm)
        if n_model > 1:
            gather(state)
        state.step += 1
        return state, flat[-1]

    return train_step, shard_state, shard_batch
