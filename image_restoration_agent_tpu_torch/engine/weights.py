"""Weight residency manager (counterpart of
``image_restoration_agent_tpu/engine/weights.py``).

All models live in one process; what is managed is the device residency of
their parameters. Eviction picks the minimum call count and breaks ties by
the newest load, the reference's kill_least_used_service selection
(AgentApp/utils/GPUServiceManager.py:117-157).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from torch import nn


def params_nbytes(model: nn.Module) -> int:
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


@dataclass
class _Entry:
    model: nn.Module
    nbytes: int
    call_count: int = 0
    loaded_at: float = field(default_factory=time.monotonic)
    last_used: float = field(default_factory=time.monotonic)


class WeightStore:
    """LRU-by-call-count model cache with a device byte budget.

    ``loader(name)`` returns the model with its weights on the device."""

    def __init__(self, loader: Callable[[str], nn.Module],
                 budget_bytes: int = 12 * 1024 ** 3):
        self._loader = loader
        self._budget = budget_bytes
        self._entries: dict[str, _Entry] = {}
        self._lock = threading.Lock()
        self.evictions: list[str] = []

    @property
    def budget_bytes(self) -> int:
        return self._budget

    @property
    def resident(self) -> list[str]:
        return list(self._entries)

    @property
    def resident_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def get(self, name: str) -> nn.Module:
        with self._lock:
            entry = self._entries.get(name)
            if entry is not None:
                entry.call_count += 1
                entry.last_used = time.monotonic()
                return entry.model
        model = self._loader(name)  # outside the lock: may be slow
        nbytes = params_nbytes(model)
        with self._lock:
            self._evict_for(nbytes)
            self._entries[name] = _Entry(model, nbytes, call_count=1)
            return model

    def _evict_for(self, nbytes: int) -> None:
        while self._entries and self.resident_bytes + nbytes > self._budget:
            victim = min(self._entries.items(),
                         key=lambda kv: (kv[1].call_count,
                                         -kv[1].loaded_at))[0]
            del self._entries[victim]
            self.evictions.append(victim)

    def drop(self, name: str) -> None:
        with self._lock:
            self._entries.pop(name, None)

    def stats(self) -> dict:
        with self._lock:
            return {name: {"nbytes": e.nbytes, "calls": e.call_count}
                    for name, e in self._entries.items()}
