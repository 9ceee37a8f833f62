"""Host-side image decode/encode (counterpart of
``image_restoration_agent_tpu/core/io.py``).

:func:`decode_image` takes every image the JAX package's takes and returns
its array. A PNG goes to the native codec (:mod:`core.io_native`) first, as
in the JAX package, then to the port's own codec: the standard library's
``zlib`` and numpy, following ``native/png_codec.cpp`` (gather the IDAT
payload, inflate it, undo each row's filter: None, Sub, Up, Average,
Paeth), for the 8-bit non-interlaced PNGs it takes. Everything else (JPEG,
BMP, WebP, 16-bit and interlaced PNG) goes to OpenCV, where the JAX package
goes to PIL: the card's machine has OpenCV and no imaging library.
:func:`save_image` picks the format from the extension, as PIL does for
the JAX package: PNG through the port's encoder, JPEG (PIL's defaults:
quality 75, 4:2:0), BMP and WebP through OpenCV.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth_row(cur: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    # sequential in the left neighbour; plain lists are several times
    # faster than per-element numpy indexing
    c_l, p_l = cur.tolist(), prev.tolist()
    out = [0] * len(c_l)
    for i in range(len(c_l)):
        a = out[i - bpp] if i >= bpp else 0
        b = p_l[i]
        c = p_l[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (c_l[i] + pred) & 0xFF
    return np.asarray(out, np.uint8)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, cur = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            line = cur.copy()
        elif ftype == 1:  # Sub: running sum per channel modulo 256
            line = (np.cumsum(cur.reshape(-1, bpp).astype(np.int64), axis=0)
                    & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            line = ((cur.astype(np.int32) + prev) & 0xFF).astype(np.uint8)
        elif ftype == 3:  # Average of left and up (sequential in left)
            c_l, p_l = cur.tolist(), prev.tolist()
            acc = [0] * stride
            for i in range(stride):
                left = acc[i - bpp] if i >= bpp else 0
                acc[i] = (c_l[i] + ((left + p_l[i]) >> 1)) & 0xFF
            line = np.asarray(acc, np.uint8)
        elif ftype == 4:
            line = _paeth_row(cur, prev, bpp)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = line
        prev = line
    return out


def decode_png(data: bytes) -> np.ndarray:
    """Decode 8-bit non-interlaced PNG bytes to an (H, W, C) uint8 array
    (C = 1, 2, 3 or 4 as stored; palette images are expanded to RGB)."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG stream")
    off = 8
    idat, plte, hdr = [], None, None
    while off + 8 <= len(data):
        n, ctype = struct.unpack(">I4s", data[off:off + 8])
        payload = data[off + 8:off + 8 + n]
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            plte = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype == b"IEND":
            break
        off += 12 + n
    if hdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, comp, filt, interlace = hdr
    if depth != 8 or color not in _CHANNELS or comp or filt or interlace:
        raise ValueError(
            f"unsupported PNG (depth {depth}, color type {color}, "
            f"interlace {interlace}): 8-bit non-interlaced only")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if color == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        img = plte[img[..., 0]]
    return img


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(ctype + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + ctype + payload \
        + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """Encode an (H, W, 3) / (H, W, 4) / (H, W) uint8 array as PNG bytes."""
    arr = np.ascontiguousarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, ch = arr.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * ch)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _cv2():
    import cv2  # the port's image library (data/degrade.py needs it too)
    return cv2


def _rgb(out: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 as RGB: grey repeated, alpha dropped."""
    if out.shape[-1] == 1:
        out = np.repeat(out, 3, axis=-1)
    elif out.shape[-1] == 4:
        out = out[..., :3]
    elif out.shape[-1] == 2:  # gray + alpha
        out = np.repeat(out[..., :1], 3, axis=-1)
    return np.ascontiguousarray(out)


def _decode_cv2(data: bytes) -> np.ndarray | None:
    """OpenCV's decode as PIL's ``convert("RGB")`` gives it, or None. PIL
    applies no EXIF rotation, so neither does this; it clamps 16-bit grey
    to 255 where OpenCV takes the high byte (every other 16-bit PNG: the
    high byte in both)."""
    cv2 = _cv2()
    buf = np.frombuffer(data, np.uint8)
    grey16 = data[:8] == _SIG and data[12:16] == b"IHDR" \
        and data[24] == 16 and data[25] == 0
    try:
        out = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED if grey16 else
                           cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    except cv2.error:  # empty bytes
        return None
    if out is None:
        return None
    if grey16:
        if out.ndim != 2:
            return None
        return _rgb(np.minimum(out, 255).astype(np.uint8)[..., None])
    return np.ascontiguousarray(out[..., ::-1])


def decode_image(data: bytes) -> np.ndarray:
    """Decode encoded image bytes (PNG, JPEG, BMP, WebP, ...) to an RGB
    uint8 (H, W, 3) array: the native PNG codec where it is built, the
    port's PNG codec for the PNGs it takes, else OpenCV. ValueError for
    bytes that none decodes."""
    if data[:8] == _SIG:
        from . import io_native
        out = io_native.decode_png(data)
        if out is not None:
            return _rgb(out)
        try:
            return _rgb(decode_png(data))
        except ValueError:  # 16-bit, interlaced: OpenCV's
            pass
    out = _decode_cv2(data)
    if out is None:
        raise ValueError(
            "not a decodable image (tried "
            + ("the native and zlib PNG codecs, then " if data[:8] == _SIG
               else "") + "OpenCV)")
    return out


def load_image(path: str | Path) -> np.ndarray:
    """Load an image file as RGB uint8 (H, W, 3)."""
    with open(path, "rb") as f:
        return decode_image(f.read())


def _cv2_encoder(ext: str) -> tuple[str, list] | None:
    """OpenCV's encoder and PIL's default settings for an extension that
    is not PNG, or None."""
    cv2 = _cv2()
    if ext in (".jpg", ".jpeg"):
        params = [cv2.IMWRITE_JPEG_QUALITY, 75]
        if hasattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR"):
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
        return ".jpg", params
    if ext == ".bmp":
        return ".bmp", []
    if ext == ".webp":  # lossy, quality 80
        return ".webp", [cv2.IMWRITE_WEBP_QUALITY, 80]
    return None


def save_image(img: np.ndarray, path: str | Path) -> None:
    """Save an image (uint8, or float in [0,1]) in the format its
    extension names, as PIL picks it for the JAX package: ``.png`` through
    :func:`encode_png`; ``.jpg`` / ``.jpeg`` (PIL's defaults: quality 75,
    4:2:0), ``.bmp`` and ``.webp`` through OpenCV. ValueError for any
    other extension (PIL raises for one it does not know)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    ext = Path(path).suffix.lower()
    if ext == ".png":
        data = encode_png(arr)
    else:
        enc = _cv2_encoder(ext)
        if enc is None:
            raise ValueError(f"save_image writes .png, .jpg, .jpeg, .bmp "
                             f"and .webp, not {ext!r} ({path})")
        if arr.ndim == 3 and arr.shape[-1] in (3, 4):  # RGB(A) -> BGR(A)
            arr = arr[..., [2, 1, 0, 3][:arr.shape[-1]]]
        ok, buf = _cv2().imencode(enc[0], np.ascontiguousarray(arr), enc[1])
        if not ok:
            raise ValueError(f"OpenCV could not encode {path}")
        data = buf.tobytes()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(data)


def to_float(img: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [0,1]."""
    return img.astype(np.float32) / 255.0


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8, with the reference's clamp + round."""
    arr = np.asarray(img)
    return np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
