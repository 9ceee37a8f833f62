from .store import NumpyVectorStore, PgVectorStore, RetrievalRecord
from .combiner import Combiner
from .embedder import (CLIPRetrievalEmbedder, RetrievalEmbedder,
                       default_embedder)

__all__ = ["NumpyVectorStore", "PgVectorStore", "RetrievalRecord",
           "Combiner", "RetrievalEmbedder", "CLIPRetrievalEmbedder",
           "default_embedder"]
