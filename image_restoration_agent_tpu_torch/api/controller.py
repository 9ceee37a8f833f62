"""Worker controller: multi-replica dispatch with heartbeats (the port's
copy of ``image_restoration_agent_tpu/api/controller.py``; standard
library only).

Rebuild of the DepictQA serve stack's controller
(DepictQA/src/serve/controller.py:27-50): workers register with a name and
address, send periodic heartbeats carrying their queue length, and the
controller dispatches requests by either LOTTERY (speed-weighted random) or
SHORTEST_QUEUE. Used when running several engine/eval-service replicas
(e.g. one per card) behind one front door.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

LOTTERY = "lottery"
SHORTEST_QUEUE = "shortest_queue"


@dataclass
class WorkerInfo:
    address: str
    speed: float = 1.0
    queue_length: int = 0
    last_heartbeat: float = field(default_factory=time.monotonic)


class Controller:
    def __init__(self, dispatch_method: str = SHORTEST_QUEUE,
                 heartbeat_expiry_s: float = 90.0, seed: int = 0):
        assert dispatch_method in (LOTTERY, SHORTEST_QUEUE)
        self.dispatch_method = dispatch_method
        self.expiry = heartbeat_expiry_s
        self._workers: dict[str, WorkerInfo] = {}
        self._lock = threading.Lock()
        self._rng = random.Random(seed)

    def register_worker(self, name: str, address: str,
                        speed: float = 1.0) -> None:
        with self._lock:
            self._workers[name] = WorkerInfo(address=address, speed=speed)

    def heartbeat(self, name: str, queue_length: int) -> bool:
        with self._lock:
            w = self._workers.get(name)
            if w is None:
                return False  # worker must re-register
            w.queue_length = queue_length
            w.last_heartbeat = time.monotonic()
            return True

    def remove_stale(self) -> list[str]:
        now = time.monotonic()
        with self._lock:
            stale = [n for n, w in self._workers.items()
                     if now - w.last_heartbeat > self.expiry]
            for n in stale:
                del self._workers[n]
            return stale

    def list_workers(self) -> dict[str, dict]:
        with self._lock:
            return {n: {"address": w.address, "queue": w.queue_length,
                        "speed": w.speed}
                    for n, w in self._workers.items()}

    def get_worker_address(self) -> Optional[str]:
        self.remove_stale()
        with self._lock:
            if not self._workers:
                return None
            workers = list(self._workers.values())
            if self.dispatch_method == LOTTERY:
                total = sum(w.speed for w in workers)
                pick = self._rng.uniform(0, total)
                acc = 0.0
                for w in workers:
                    acc += w.speed
                    if pick <= acc:
                        return w.address
                return workers[-1].address
            # shortest queue, normalized by speed
            best = min(workers, key=lambda w: w.queue_length / w.speed)
            best.queue_length += 1  # optimistic: reserved one slot
            return best.address
