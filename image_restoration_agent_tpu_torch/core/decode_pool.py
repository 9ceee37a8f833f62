"""Threaded image-decode pool (counterpart of
``image_restoration_agent_tpu/core/decode_pool.py``).

Decode work fans out over a thread pool through
:func:`core.io.decode_image`: the native PNG codec (:mod:`core.io_native`,
a ctypes call) and OpenCV release the GIL for the whole decode, so threads
overlap. It takes what the JAX package's pool takes (PNG, JPEG, BMP, WebP,
...), OpenCV standing where the JAX package falls back to PIL.

Used by the API server to validate multipart uploads.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from .io import decode_image, load_image, to_float


class DecodePool:
    def __init__(self, workers: int = 4):
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="decode")

    def decode(self, blob: bytes) -> np.ndarray:
        """Synchronous decode of one blob (uint8 HWC)."""
        return decode_image(blob)

    def decode_many(self, blobs: Iterable[bytes],
                    as_float: bool = False) -> list[np.ndarray]:
        outs = list(self._pool.map(decode_image, blobs))
        return [to_float(o) for o in outs] if as_float else outs

    def load_many(self, paths: Iterable[str | Path],
                  as_float: bool = False) -> list[np.ndarray]:
        outs = list(self._pool.map(load_image, paths))
        return [to_float(o) for o in outs] if as_float else outs

    def submit(self, blob: bytes):
        """Async decode; returns a Future."""
        return self._pool.submit(decode_image, blob)


_default: Optional[DecodePool] = None


def default_pool() -> DecodePool:
    global _default
    if _default is None:
        _default = DecodePool()
    return _default
