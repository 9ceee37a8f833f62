"""Retrieval training, validation and store population (counterpart of
``image_restoration_agent_tpu/train/retrieval.py``).

- ``train_retrieval_model``: contrastive (InfoNCE) training of the
  stand-in's image tower and Combiner on pairs of views of the same
  degraded content (the reference's ``combiner_train.py``), optax's Adam
  (``parallel.train_step.UpdateRule``).
- ``recall_at_k``: retrieval validation (the reference's ``validate.py``
  recall@K).
- ``insert_solved_runs``: walk agent work dirs (``logs/summary.json``),
  build ``res_seq`` strings from the execution paths, embed each run's
  input image and insert it into a vector store (the reference's
  ``insert_emb_to_postgresql.py``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.registry import init_weights
from ..parallel.train_step import UpdateRule
from ..retrieval.embedder import RetrievalModel
from ..retrieval.store import RetrievalRecord


def info_nce_loss(emb_a: torch.Tensor, emb_b: torch.Tensor,
                  temperature: float = 0.07) -> torch.Tensor:
    """Symmetric InfoNCE between two views of the same items (row i of
    ``emb_a`` and of ``emb_b``)."""
    logits = emb_a @ emb_b.T / temperature
    labels = torch.arange(emb_a.shape[0], device=emb_a.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.T, labels))


def train_retrieval_model(pair_batches, steps: int = 200, lr: float = 1e-4,
                          seed: int = 0, model: RetrievalModel | None = None,
                          device: str | torch.device = "cuda"):
    """Pull two views of the same degraded content together and push the
    batch's other items apart. ``pair_batches`` yields (view_a, view_b)
    float (B, 224, 224, 3) batches; the given model's parameters are the
    initial state (without one: ``RetrievalModel()`` with
    ``init_weights(seed)`` and the caption embedding at zero; at
    ``init_weights``' 1 + noise it dominates the Combiner and every image
    embeds alike). Returns (state_dict, losses)."""
    if model is None:
        model = RetrievalModel()
        init_weights(model, seed)
        with torch.no_grad():  # the caption's learned embedding starts at
            model.caption_embedding.zero_()  # zero, as the Flax one does
    dev = resolve_device(device)
    model = model.to(dev, torch.float32)
    params = list(model.parameters())
    rule = UpdateRule(lr)
    state = rule.init(params)
    losses = []
    it = iter(pair_batches)
    for _ in range(steps):
        a, b = (torch.as_tensor(np.asarray(v, np.float32)).to(dev)
                for v in next(it))
        loss = info_nce_loss(model(a), model(b))
        rule.update(params, list(torch.autograd.grad(loss, params)), state)
        losses.append(loss.item())
    return {k: v.detach().cpu().clone()
            for k, v in model.state_dict().items()}, losses


def recall_at_k(embedder, queries: list, gallery: list, labels_q: list,
                labels_g: list, ks=(1, 5)) -> dict:
    """Recall@K: the share of queries whose top-K gallery hits include the
    query's label."""
    eq = np.stack([embedder.embed_array(q) for q in queries])
    eg = np.stack([embedder.embed_array(g) for g in gallery])
    sims = eq @ eg.T
    order = np.argsort(-sims, axis=1)
    out = {}
    for k in ks:
        hits = 0
        for i in range(len(queries)):
            topk = [labels_g[j] for j in order[i, :k]]
            hits += labels_q[i] in topk
        out[f"recall@{k}"] = hits / max(len(queries), 1)
    return out


def insert_solved_runs(output_dir: Path, store, embedder,
                       min_steps: int = 1) -> int:
    """Walk agent work dirs; for each run whose summary has at least
    ``min_steps`` executed subtasks, each with its tool, insert (input
    embedding, res_seq) under the run directory's name. Returns the number
    inserted."""
    n = 0
    for summary_path in sorted(Path(output_dir).glob("*/logs/summary.json")):
        try:
            summary = json.loads(summary_path.read_text())
        except json.JSONDecodeError:
            continue
        ep = summary.get("execution_path", {})
        subtasks, tools = ep.get("subtasks", []), ep.get("tools", [])
        if len(subtasks) < min_steps or len(subtasks) != len(tools):
            continue
        res_seq = "/".join(f"{s}_{t}" for s, t in zip(subtasks, tools))
        input_png = summary_path.parent.parent / "img_tree" / "0-img" / \
            "input.png"
        if not input_png.exists():
            continue
        emb = embedder.embed_path(input_png)
        store.insert(RetrievalRecord(
            name=summary_path.parent.parent.name, res_seq=res_seq,
            embedding=emb))
        n += 1
    return n
