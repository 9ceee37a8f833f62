"""Threaded image-decode pool over the native codec (counterpart of
``image_restoration_agent_tpu/core/decode_pool.py``).

Decode work fans out over a thread pool: the native PNG codec
(:mod:`core.io_native`) is a ctypes call, so the GIL is released for the
whole inflate + unfilter and threads overlap. Where the native library is
absent, or does not take the bytes, the port's own codec
(:func:`core.io.decode_image`) decodes them, where the JAX package falls
back to PIL.

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

    @staticmethod
    def _decode_bytes(blob: bytes) -> np.ndarray:
        from . import io_native
        out = io_native.decode_png(blob)
        if out is None:
            out = decode_image(blob)
        return out

    def decode(self, blob: bytes) -> np.ndarray:
        """Synchronous decode of one blob (uint8 HWC)."""
        return self._decode_bytes(blob)

    def decode_many(self, blobs: Iterable[bytes],
                    as_float: bool = False) -> list[np.ndarray]:
        outs = list(self._pool.map(self._decode_bytes, blobs))
        return [to_float(o) for o in outs] if as_float else outs

    def load_many(self, paths: Iterable[str | Path],
                  as_float: bool = False) -> list[np.ndarray]:
        outs = list(self._pool.map(load_image, paths))
        return [to_float(o) for o in outs] if as_float else outs

    def submit(self, blob: bytes):
        """Async decode; returns a Future."""
        return self._pool.submit(self._decode_bytes, blob)


_default: Optional[DecodePool] = None


def default_pool() -> DecodePool:
    global _default
    if _default is None:
        _default = DecodePool()
    return _default
