"""Training (counterpart of ``image_restoration_agent_tpu/train``). Only
the retrieval store's serving half is ported so far
(``train/retrieval.py``: ``insert_solved_runs``, ``recall_at_k``)."""
