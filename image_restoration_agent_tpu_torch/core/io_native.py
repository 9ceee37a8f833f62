"""ctypes bindings for the repo's native PNG codec (``native/png_codec.cpp``;
counterpart of ``image_restoration_agent_tpu/core/io_native.py``).

Built on demand with the repo Makefile (``make -C native``: g++ and zlib).
Where the library is unavailable every entry point returns None (and
:func:`u8_to_f32_pad` runs in numpy); callers then use the port's own
zlib + numpy codec (:mod:`core.io`). The native codec is host I/O, an
accelerator and never a requirement; :func:`available` says whether it
loaded (``/health`` reports it).
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libpng_codec.so"
_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.png_probe.restype = ctypes.c_int
    lib.png_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                              u32p, u32p, u32p]
    lib.png_decode.restype = ctypes.c_int
    lib.png_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_void_p]
    lib.png_encode.restype = ctypes.c_long
    lib.png_encode.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                               ctypes.c_uint32, ctypes.c_uint32,
                               ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_size_t]
    lib.u8_to_f32_pad.restype = None
    lib.u8_to_f32_pad.argtypes = [ctypes.c_void_p] + [ctypes.c_uint32] * 5 \
        + [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def decode_png(data: bytes) -> Optional[np.ndarray]:
    """Decode PNG bytes to (H, W, C) uint8, or None if unsupported."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    ch = ctypes.c_uint32()
    if lib.png_probe(data, len(data), ctypes.byref(w), ctypes.byref(h),
                     ctypes.byref(ch)) != 0:
        return None
    out = np.empty((h.value, w.value, ch.value), np.uint8)
    if lib.png_decode(data, len(data),
                      out.ctypes.data_as(ctypes.c_void_p)) != 0:
        return None
    return out


def encode_png(img: np.ndarray, level: int = 6) -> Optional[bytes]:
    """Encode (H, W, 1|3|4) uint8 as PNG bytes, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, ch = img.shape
    bound = lib.png_encode(None, w, h, ch, level, None, 0)
    if bound <= 0:
        return None
    buf = (ctypes.c_uint8 * bound)()
    n = lib.png_encode(img.ctypes.data_as(ctypes.c_void_p), w, h, ch,
                       level, buf, bound)
    if n <= 0:
        return None
    return bytes(bytearray(buf)[:n])


def u8_to_f32_pad(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Fused normalize + bottom/right zero pad (falls back to numpy)."""
    lib = _load()
    h, w, ch = img.shape
    if lib is None:
        out = np.zeros((out_h, out_w, ch), np.float32)
        out[:h, :w] = img.astype(np.float32) / 255.0
        return out
    img = np.ascontiguousarray(img)
    out = np.empty((out_h, out_w, ch), np.float32)
    lib.u8_to_f32_pad(img.ctypes.data_as(ctypes.c_void_p), h, w, ch,
                      out_h, out_w, out.ctypes.data_as(ctypes.c_void_p))
    return out
