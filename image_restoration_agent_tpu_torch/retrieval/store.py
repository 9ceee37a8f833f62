"""Experience vector stores: cosine top-k over restoration embeddings
(counterpart of ``image_restoration_agent_tpu/retrieval/store.py``).

The reference stores 640-d embeddings in PostgreSQL+pgvector with the query
``1 - (embedding <=> %s::vector)`` and a ``res_seq`` payload encoding the
winning plan as ``subtask_tool/subtask_tool/...``. Two backends:

- ``NumpyVectorStore``: in-process, persisted to ``.npz``. The file is the
  JAX package's, key for key (``embeddings``, and ``meta``: the JSON of
  names, seqs, dim and the embedder's identity), so a store written by
  either package loads in the other.
- ``PgVectorStore``: the pgvector backend, gated on psycopg2.

Both are numpy and host-side; the embedders (``retrieval/embedder.py``)
run on the card.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class RetrievalRecord:
    name: str
    res_seq: str          # "subtask_tool/subtask_tool/..."
    embedding: np.ndarray  # (D,) L2-normalized


class NumpyVectorStore:
    def __init__(self, dim: int = 640, embedder=None):
        self.dim = dim
        self._names: list[str] = []
        self._seqs: list[str] = []
        self._embs = np.zeros((0, dim), np.float32)
        self._embedder = embedder
        # every embedder is 640-d, so appending with a different one
        # silently corrupts retrieval: record which produced the vectors
        self.embedder_id = getattr(embedder, "identity", None)

    def __len__(self):
        return len(self._names)

    def insert(self, record: RetrievalRecord, on_conflict: str = "replace"):
        emb = np.asarray(record.embedding, np.float32).reshape(-1)
        if emb.shape[0] != self.dim:
            raise ValueError(f"embedding of {emb.shape[0]} values into a "
                             f"{self.dim}-d store")
        emb = emb / max(np.linalg.norm(emb), 1e-12)
        if record.name in self._names:
            i = self._names.index(record.name)
            if on_conflict == "replace":  # the reference's ON CONFLICT
                self._seqs[i] = record.res_seq
                self._embs[i] = emb
            return
        self._names.append(record.name)
        self._seqs.append(record.res_seq)
        self._embs = np.concatenate([self._embs, emb[None]], axis=0)

    def query(self, embedding: np.ndarray, topk: int = 5) -> list[dict]:
        if not self._names:
            return []
        q = np.asarray(embedding, np.float32).reshape(-1)
        q = q / max(np.linalg.norm(q), 1e-12)
        sims = self._embs @ q
        order = np.argsort(-sims)[:topk]
        return [{"name": self._names[i], "res_seq": self._seqs[i],
                 "similarity": float(sims[i])} for i in order]

    def embed(self, img_path) -> np.ndarray:
        if self._embedder is None:
            raise ValueError("store has no embedder")
        return self._embedder.embed_path(img_path)

    # ------------- persistence -------------

    def save(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path, embeddings=self._embs,
            meta=json.dumps({"names": self._names, "seqs": self._seqs,
                             "dim": self.dim,
                             "embedder": self.embedder_id}))

    @classmethod
    def load(cls, path: Path, embedder=None,
             allow_mismatch: bool = False) -> "NumpyVectorStore":
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["meta"]))
            embs = data["embeddings"].astype(np.float32)
        st = cls(dim=meta["dim"], embedder=embedder)
        stored_id = meta.get("embedder")
        new_id = getattr(embedder, "identity", None)
        if (stored_id and new_id and stored_id != new_id
                and not allow_mismatch):
            raise ValueError(
                f"store {path} was built with embedder '{stored_id}' but "
                f"'{new_id}' was passed — mixed-embedder stores corrupt "
                "retrieval (pass allow_mismatch=True to override)")
        st.embedder_id = stored_id or new_id
        st._names = list(meta["names"])
        st._seqs = list(meta["seqs"])
        st._embs = embs
        return st


class PgVectorStore:
    """pgvector-backed store with the reference's schema (table
    imgres_embedding(id, name, res_seq, embedding vector(D)))."""

    def __init__(self, dbname: str = "agenticir_rag", user: str = "postgres",
                 host: str = "/var/run/postgresql", dim: int = 640,
                 embedder=None):
        try:
            import psycopg2
        except ImportError as e:
            raise RuntimeError(
                "PgVectorStore requires psycopg2+pgvector; use "
                "NumpyVectorStore instead") from e
        from pgvector.psycopg2 import register_vector

        self.dim = dim
        self._embedder = embedder
        self.conn = psycopg2.connect(dbname=dbname, user=user, host=host)
        register_vector(self.conn)
        with self.conn.cursor() as cur:
            cur.execute(
                f"CREATE TABLE IF NOT EXISTS imgres_embedding ("
                f"id SERIAL PRIMARY KEY, name TEXT UNIQUE, res_seq TEXT, "
                f"embedding vector({dim}))")
            self.conn.commit()

    def insert(self, record: RetrievalRecord, on_conflict="replace"):
        with self.conn.cursor() as cur:
            cur.execute(
                "INSERT INTO imgres_embedding (name, res_seq, embedding) "
                "VALUES (%s, %s, %s) ON CONFLICT (name) DO UPDATE SET "
                "res_seq = EXCLUDED.res_seq, embedding = EXCLUDED.embedding",
                (record.name, record.res_seq,
                 np.asarray(record.embedding, np.float32)))
            self.conn.commit()

    def query(self, embedding: np.ndarray, topk: int = 5) -> list[dict]:
        with self.conn.cursor() as cur:
            cur.execute(
                "SELECT name, res_seq, 1 - (embedding <=> %s::vector) AS sim "
                "FROM imgres_embedding ORDER BY sim DESC LIMIT %s",
                (np.asarray(embedding, np.float32), topk))
            return [{"name": n, "res_seq": r, "similarity": float(s)}
                    for n, r, s in cur.fetchall()]

    def embed(self, img_path) -> np.ndarray:
        if self._embedder is None:
            raise ValueError("store has no embedder")
        return self._embedder.embed_path(img_path)
