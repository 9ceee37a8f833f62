"""Retrieval store population and validation (the serving half of
``image_restoration_agent_tpu/train/retrieval.py``).

- ``insert_solved_runs``: walk agent work dirs (``logs/summary.json``),
  build ``res_seq`` strings from the execution paths, embed each run's
  input image and insert it into a vector store (the reference's
  ``insert_emb_to_postgresql.py``).
- ``recall_at_k``: retrieval validation (the reference's ``validate.py``
  recall@K).

The JAX module's training half, ``info_nce_loss`` and
``train_retrieval_model`` (contrastive training of the stand-in with
optax), is not ported yet: it comes with the port's training slice.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..retrieval.store import RetrievalRecord


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
