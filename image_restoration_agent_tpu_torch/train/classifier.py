"""Degradation-classifier training (counterpart of
``image_restoration_agent_tpu/train/classifier.py``; the reference's
DepictQA fine-tune analogue).

The evaluator is the small classifier of ``iqa/classifier.py``; its
training data comes straight from the degradation synthesizer
(``data/degrade.py``) with severity labels from the synthesis parameters:
level l in {0..4} maps to a parameter strength per op (gaussian sigma
10/20/35/50 for "noise"). Every stream draws from one
``np.random.default_rng`` in the JAX package's order, so the same seed
gives the same degraded images and labels.

The trainers take the given model's parameters as the initial state
(without one: the architecture with ``models.registry.init_weights(seed)``)
and return ``(state_dict, losses)``; the update is optax's Adam
(``parallel.train_step.UpdateRule``). ``device_data`` keeps the uint8 set
on the card and samples batches with a ``torch.Generator``, which cannot
reproduce JAX's ``fold_in`` draws.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.resize import resize_pil_bicubic
from ..data import degrade as D
from ..device import resolve_device
from ..iqa.classifier import (DEGRADATIONS, SEVERITY_LEVELS,
                              DegradationClassifier,
                              DegradationClassifierV3,
                              DegradationClassifierV5, prepare_input)
from ..models.registry import init_weights
from ..parallel.train_step import UpdateRule
from .schedules import cosine_decay_schedule

#: severity level -> synthesis args per degradation (index = level 1..4;
#: level 0 = clean).
_LEVEL_ARGS = {
    "noise": [None, 10, 20, 35, 50],                      # gaussian sigma
    "jpeg compression artifact": [None, 60, 35, 20, 10],  # quality factor
    "dark": [None, 20, 35, 45, 60],                       # constant shift
    "motion blur": [None, 0, 1, 2, 2],                    # severity idx
    "defocus blur": [None, 0, 1, 2, 2],
    "haze": [None, (0.75, 0.6), (0.85, 1.0), (0.95, 1.4), (1.0, 1.8)],
    "rain": [None, 55, 70, 85, 99],                       # value
    "low resolution": [None, None, None, None, None],     # handled by size
}
_OPS = [d for d in DEGRADATIONS if d != "low resolution"]


def synthesize_example(img: np.ndarray, rng: np.random.Generator,
                       relabel: bool = False):
    """One random degradation at a random level: (degraded image, labels
    (8,) with the op at its level and the others at 0)."""
    name = rng.choice(_OPS)
    level = int(rng.integers(1, 5))
    return _apply_one(img, name, level, rng, relabel=relabel)


def _input(lq: np.ndarray, size: int, device) -> np.ndarray:
    """The classifier's input: the MATLAB bicubic resize on ``device``."""
    x = torch.from_numpy(lq.astype(np.float32) / 255.0).to(
        resolve_device(device))
    return prepare_input(x, size).cpu().numpy()


def example_stream(hq_images: list[np.ndarray], batch: int, seed: int = 0,
                   size: int = 224, device: str | torch.device = "cuda"):
    rng = np.random.default_rng(seed)
    while True:
        xs, ys = [], []
        for _ in range(batch):
            img = hq_images[rng.integers(len(hq_images))]
            lq, labels = synthesize_example(img, rng)
            xs.append(_input(lq, size, device))
            ys.append(labels)
        yield np.stack(xs), np.stack(ys)


def synthesize_multi(img: np.ndarray, rng: np.random.Generator,
                     max_ops: int = 3, relabel: bool = False):
    """1..max_ops distinct degradations in random order (the agent's real
    inputs carry 2-3); labels carry each applied op's level. ``relabel``
    (v5) caps each label by the op's observable effect."""
    labels = np.zeros(len(DEGRADATIONS), np.int64)
    k = int(rng.integers(1, max_ops + 1))
    names = list(rng.choice(_OPS, size=k, replace=False))
    out = img
    for name in names:
        level = int(rng.integers(1, 5))
        out, one = _apply_one(out, name, level, rng, relabel=relabel)
        labels = np.maximum(labels, one)
    return out, labels


def observable_level(before: np.ndarray, after: np.ndarray,
                     level: int) -> int:
    """Cap a synthesized level by the op's observable effect: mean |delta|
    < 0.4/255 is level 0, < 1.2/255 at most 'low'."""
    d = float(np.mean(np.abs(after.astype(np.float32)
                             - before.astype(np.float32))))
    if d < 0.4:
        return 0
    if d < 1.2:
        return min(level, 1)
    return level


def _apply_one(img: np.ndarray, name: str, level: int,
               rng: np.random.Generator, relabel: bool = False):
    labels = np.zeros(len(DEGRADATIONS), np.int64)
    arg = _LEVEL_ARGS[name][level]
    if name == "noise":
        out = D.add_noise(img, "Gaussian", arg=arg, rng=rng)
    elif name == "jpeg compression artifact":
        out = D.add_jpeg_artifacts(img, quality_factor=arg, rng=rng)
    elif name == "dark":
        out = D.darken(img, "constant shift", arg=arg, rng=rng)
    elif name == "motion blur":
        out = D.add_motion_blur(img, severity=arg, rng=rng)
    elif name == "defocus blur":
        out = D.add_defocus_blur(img, severity=arg, rng=rng)
    elif name == "haze":
        a, beta = arg
        out = D.add_haze(img, A=a, beta=beta, rng=rng)
    elif name == "rain":
        out = D.add_rain(img, value=arg, rng=rng)
    else:
        out = img
    if relabel:
        level = observable_level(img, out, level)
    labels[DEGRADATIONS.index(name)] = level
    return out, labels


def procedural_corpus(n: int = 48, size: int = 288,
                      seed: int = 7, p_flat: float = 0.0) -> list[np.ndarray]:
    """Self-contained HQ corpus (uint8 RGB): multi-octave value-noise
    textures, gradients and shapes; ``p_flat`` (v5) of them texture-free
    (flat colours, linear and radial gradients)."""
    rng = np.random.default_rng(seed)
    out = []
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    n_flat = int(round(n * p_flat))
    for i_flat in range(n_flat):
        kind = i_flat % 3
        c0, c1 = rng.random(3), rng.random(3)
        if kind == 0:        # flat color
            img = np.broadcast_to(c0, (size, size, 3)).copy()
        elif kind == 1:      # linear gradient, random direction
            a = rng.random()
            t = (a * yy + (1 - a) * xx)[..., None]
            img = c0 * (1 - t) + c1 * t
        else:                # radial gradient / vignette
            cy, cx = rng.random(2)
            r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
            t = np.clip(r / max(float(r.max()), 1e-6), 0, 1)[..., None]
            img = c0 * (1 - t) + c1 * t
        out.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    for _ in range(n - n_flat):
        img = np.zeros((size, size, 3), np.float32)
        for octave in (4, 8, 16, 32):  # multi-octave smooth noise
            coarse = rng.random((octave, octave, 3)).astype(np.float32)
            idx = (np.linspace(0, octave - 1, size)).astype(np.int64)
            img += coarse[idx][:, idx] / octave * 8
        img /= img.max()
        a, b = rng.random(2)  # gradient wash
        img = 0.6 * img + 0.4 * (a * yy + (1 - a) * xx)[..., None] \
            * rng.random(3)[None, None]
        for _ in range(int(rng.integers(4, 12))):  # rectangles, circles
            c = rng.random(3)
            x0, y0 = rng.integers(0, size, 2)
            if rng.random() < 0.5:
                w_, h_ = rng.integers(10, size // 2, 2)
                img[y0:y0 + h_, x0:x0 + w_] = \
                    0.3 * img[y0:y0 + h_, x0:x0 + w_] + 0.7 * c
            else:
                r = int(rng.integers(6, size // 4))
                mask = (yy * size - y0) ** 2 + (xx * size - x0) ** 2 < r * r
                img[mask] = 0.3 * img[mask] + 0.7 * c
        for _ in range(int(rng.integers(2, 8))):  # thin lines
            x0 = int(rng.integers(0, size))
            img[:, x0:x0 + 2] = rng.random(3)
        out.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return out


def multi_example_stream(hq_images, batch: int, seed: int = 0,
                         size: int = 224, p_multi: float = 0.5,
                         device: str | torch.device = "cuda"):
    rng = np.random.default_rng(seed)
    while True:
        xs, ys = [], []
        for _ in range(batch):
            img = hq_images[rng.integers(len(hq_images))]
            if rng.random() < p_multi:
                lq, labels = synthesize_multi(img, rng)
            else:
                lq, labels = synthesize_example(img, rng)
            xs.append(_input(lq, size, device))
            ys.append(labels)
        yield np.stack(xs), np.stack(ys)


def build_dataset(hq_images, n_examples: int, seed: int = 0,
                  size: int = 224, p_multi: float = 0.5,
                  fast_resize: bool = True, relabel: bool = False,
                  device: str | torch.device = "cuda"):
    """A fixed pre-synthesized dataset (xs (n, size, size, 3) float32, ys
    (n, 8) int64). ``fast_resize`` resizes the uint8 image on the host with
    Pillow's bicubic (``core.resize.resize_pil_bicubic``, bit-equal to the
    JAX package's PIL call), else with :func:`iqa.classifier
    .prepare_input` on ``device``."""
    rng = np.random.default_rng(seed)
    xs = np.empty((n_examples, size, size, 3), np.float32)
    ys = np.empty((n_examples, len(DEGRADATIONS)), np.int64)
    for i in range(n_examples):
        img = hq_images[rng.integers(len(hq_images))]
        if rng.random() < p_multi:
            lq, labels = synthesize_multi(img, rng, relabel=relabel)
        else:
            lq, labels = synthesize_example(img, rng, relabel=relabel)
        if fast_resize:
            xs[i] = resize_pil_bicubic(np.clip(lq, 0, 255).astype(np.uint8),
                                       size, size).astype(np.float32) / 255.0
        else:
            xs[i] = _input(lq, size, device)
        ys[i] = labels
    return xs, ys


# ---------------------------------------------------------------------------
# losses and the training loop


def cross_entropy_loss(logits: torch.Tensor, y: torch.Tensor
                       ) -> torch.Tensor:
    """Multi-head 5-way cross entropy over (B, 8, 5) logits, the mean over
    every (example, degradation) (optax's
    ``softmax_cross_entropy_with_integer_labels``)."""
    nlev = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, nlev), y.reshape(-1))


def ordinal_targets(ordinal_smooth: float, nlev: int = 5) -> np.ndarray:
    """(nlev, nlev) soft targets: ``1 - s`` on the level, ``s / 2`` on each
    neighbour, rows renormalized (the edge rows have one neighbour)."""
    dist = np.abs(np.arange(nlev)[None, :] - np.arange(nlev)[:, None])
    tgt = np.where(dist == 0, 1.0 - ordinal_smooth,
                   np.where(dist == 1, ordinal_smooth / 2.0, 0.0))
    return tgt / tgt.sum(axis=1, keepdims=True)


def classifier_loss(model, x: torch.Tensor, y: torch.Tensor, *,
                    ordinal_smooth: float = 0.0, coral: bool = False,
                    table: torch.Tensor | None = None) -> torch.Tensor:
    """The v3-v5 recipes' loss: CORAL (binary cross entropy over the 4
    cumulative logits), or soft-target cross entropy with
    :func:`ordinal_targets` (``table``), or integer-label cross entropy."""
    nlev = len(SEVERITY_LEVELS)
    if coral:
        cum = model(x, cumulative=True)                    # (B, nd, L-1)
        tgt = (y[..., None] > torch.arange(nlev - 1, device=y.device)
               ).float()
        return F.binary_cross_entropy_with_logits(cum, tgt)
    logits = model(x)
    if ordinal_smooth > 0.0:
        if table is None:
            table = torch.as_tensor(ordinal_targets(ordinal_smooth, nlev),
                                    dtype=torch.float32, device=x.device)
        flat = logits.reshape(-1, nlev)
        return -(table[y.reshape(-1)] * F.log_softmax(flat, -1)).sum(
            -1).mean()
    return cross_entropy_loss(logits, y)


def _prepare(model, default_cls, seed: int, device):
    if model is None:
        model = default_cls()
        init_weights(model, seed)
    return model.to(resolve_device(device), torch.float32)


def _step_fn(model, rule: UpdateRule, loss_of: Callable):
    params = list(model.parameters())
    state = rule.init(params)

    def step(x, y) -> torch.Tensor:
        loss = loss_of(model, x, y)
        rule.update(params, list(torch.autograd.grad(loss, params)), state)
        return loss.detach()

    return step


def _state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}


def _fit_stream(model, stream, steps: int, rule: UpdateRule,
                log_every: int = 0):
    dev = next(model.parameters()).device
    step = _step_fn(model, rule, lambda m, x, y: cross_entropy_loss(m(x), y))
    losses = []
    for i in range(steps):
        x, y = next(stream)
        losses.append(float(step(torch.from_numpy(x).to(dev),
                                 torch.from_numpy(y).to(dev))))
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}/{steps} loss {np.mean(losses[-50:]):.4f}",
                  flush=True)
    return _state(model), losses


def train_classifier(hq_images: list[np.ndarray], steps: int = 300,
                     batch: int = 8, lr: float = 3e-4, seed: int = 0,
                     size: int = 224, model=None,
                     device: str | torch.device = "cuda"):
    """The v1 recipe: single-degradation examples, Adam at ``lr``. Returns
    (state_dict, losses)."""
    model = _prepare(model, DegradationClassifier, seed, device)
    return _fit_stream(model, example_stream(hq_images, batch, seed, size,
                                             device), steps, UpdateRule(lr))


def train_classifier_v3(hq_images, steps: int = 2000, batch: int = 32,
                        lr: float = 3e-4, seed: int = 0, size: int = 224,
                        p_multi: float = 0.5, model=None,
                        log_every: int = 0,
                        device: str | torch.device = "cuda"):
    """The v3 recipe: priors + CNN model, multi-degradation mixing, Adam on
    a cosine decay to 5%."""
    model = _prepare(model, DegradationClassifierV3, seed, device)
    stream = multi_example_stream(hq_images, batch, seed, size, p_multi,
                                  device)
    return _fit_stream(model, stream, steps,
                       UpdateRule(cosine_decay_schedule(lr, steps, 0.05)),
                       log_every)


@torch.no_grad()
def _logits(model, lq: np.ndarray, size: int) -> np.ndarray:
    dev = next(model.parameters()).device
    x = prepare_input(torch.from_numpy(lq.astype(np.float32) / 255.0)
                      .to(dev), size)[None]
    return model(x)[0].cpu().numpy()


def _eval_model(params, model, default_cls, device):
    model = model or default_cls()
    if params is not None:
        model.load_state_dict(params, strict=True)
    return model.to(resolve_device(device), torch.float32).eval()


def evaluate_classifier(params, hq_images: list[np.ndarray], n: int = 64,
                        seed: int = 1, size: int = 224, model=None,
                        device: str | torch.device = "cuda"):
    """Accuracy of (a) which degradation is dominant and (b) the exact
    severity of the degraded op, over single-degradation examples
    (``params``: a state dict, or None to take ``model`` as it is)."""
    model = _eval_model(params, model, DegradationClassifier, device)
    rng = np.random.default_rng(seed)
    which_ok = level_ok = 0
    for _ in range(n):
        img = hq_images[rng.integers(len(hq_images))]
        lq, labels = synthesize_example(img, rng)
        pred_levels = _logits(model, lq, size).argmax(-1)
        true_idx = int(labels.argmax())
        which_ok += int(pred_levels.argmax() == true_idx)
        level_ok += int(pred_levels[true_idx] == labels[true_idx])
    return {"dominant_acc": which_ok / n, "severity_acc": level_ok / n}


def evaluate_multi(params, hq_images, n: int = 400, size: int = 224,
                   model=None, seed: int = 5, max_ops: int = 3,
                   relabel: bool = False,
                   device: str | torch.device = "cuda"):
    """Multi-degradation eval: tie-aware dominant accuracy (any max-level
    op counts), the strict first-argmax number, and per-op level accuracy
    (exact and within one level)."""
    model = _eval_model(params, model, DegradationClassifierV3, device)
    rng = np.random.default_rng(seed)
    strict = tie = per_op = per_op_exact = per_op_n = 0
    for _ in range(n):
        img = hq_images[rng.integers(len(hq_images))]
        lq, labels = synthesize_multi(img, rng, max_ops=max_ops,
                                      relabel=relabel)
        pred = _logits(model, lq, size).argmax(-1)
        dom = int(pred.argmax())
        strict += int(dom == int(labels.argmax()))
        tie += int(labels[dom] == labels.max())
        for i in range(len(labels)):
            if labels[i] > 0:
                per_op_n += 1
                per_op_exact += int(int(pred[i]) == int(labels[i]))
                per_op += int(abs(int(pred[i]) - int(labels[i])) <= 1)
    return {"dominant": tie / n, "dominant_strict": strict / n,
            "per_op_level1": per_op / max(per_op_n, 1),
            "per_op_exact": per_op_exact / max(per_op_n, 1)}


def train_classifier_v3_dataset(xs, ys, steps: int = 2000, batch: int = 32,
                                lr: float = 3e-4, seed: int = 0,
                                model=None, log_every: int = 0,
                                ordinal_smooth: float = 0.0,
                                snapshot_every: int = 0, snapshot_fn=None,
                                coral: bool = False,
                                device_data: bool = False,
                                device: str | torch.device = "cuda"):
    """The v3 recipe over a pregenerated dataset (``build_dataset``).

    ``ordinal_smooth`` > 0 (v4) spreads that mass onto the neighbouring
    levels; ``coral`` (v5, a ``DegradationClassifierV5``) trains the
    cumulative logits with binary cross entropy. ``snapshot_fn(state_dict,
    step)`` is called every ``snapshot_every`` steps. Batches go up as
    uint8: without ``device_data`` from shuffled epochs of one
    ``default_rng(seed)``; with it the whole set lives on the device and
    each step draws ``batch`` indices with replacement from a
    ``torch.Generator`` seeded ``seed + 1``, the losses read back once a
    chunk of ``log_every or min(500, steps)`` steps."""
    default = DegradationClassifierV5 if coral else DegradationClassifierV3
    model = _prepare(model, default, seed, device)
    dev = next(model.parameters()).device
    table = None
    if ordinal_smooth > 0.0:
        table = torch.as_tensor(ordinal_targets(ordinal_smooth),
                                dtype=torch.float32, device=dev)
    step = _step_fn(model, UpdateRule(cosine_decay_schedule(lr, steps, 0.05)),
                    lambda m, x, y: classifier_loss(
                        m, x, y, ordinal_smooth=ordinal_smooth, coral=coral,
                        table=table))
    xs8 = np.clip(xs * 255.0, 0, 255).astype(np.uint8)
    n = xs.shape[0]
    losses: list[float] = []

    def snapshot(done: int) -> None:
        if snapshot_every and snapshot_fn and done % snapshot_every == 0:
            snapshot_fn(model.state_dict(), done)

    if device_data:
        dx = torch.from_numpy(xs8).to(dev)
        dy = torch.from_numpy(ys.astype(np.int64)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        chunk = log_every or min(500, steps)
        done = 0
        while done < steps:
            c = min(chunk, steps - done)
            cl = []
            for _ in range(c):
                idx = torch.randint(0, n, (batch,), generator=gen,
                                    device=dev)
                cl.append(step(dx[idx].float() / 255.0, dy[idx]))
            losses.extend(torch.stack(cl).tolist())
            done += c
            if log_every:
                print(f"step {done}/{steps} loss "
                      f"{np.mean(losses[-50:]):.4f}", flush=True)
            if done < steps:
                snapshot(done)
        return _state(model), losses

    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    pos = 0
    for i in range(steps):
        if pos + batch > n:
            order = rng.permutation(n)
            pos = 0
        idx = order[pos:pos + batch]
        pos += batch
        x = torch.from_numpy(xs8[idx]).to(dev).float() / 255.0
        losses.append(float(step(x, torch.from_numpy(ys[idx]).to(dev))))
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}/{steps} loss {np.mean(losses[-50:]):.4f}",
                  flush=True)
        snapshot(i + 1)
    return _state(model), losses
