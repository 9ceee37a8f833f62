"""The port's image decode and encode (``image_restoration_agent_tpu_torch/
core/io.py``, ``core/decode_pool.py``) against the JAX package's
(``image_restoration_agent_tpu/core/io.py``: the native PNG codec, then
PIL), on encoded bytes made here from numpy seeds.

Every PNG kind (8-bit RGB, grey, grey + alpha, RGBA, palette; Adam7
interlaced; 16-bit grey, RGB, RGBA, grey + alpha) decodes to the JAX
package's array bit for bit; so do BMP and WebP. JPEG goes through the
port's OpenCV and the JAX package's PIL: two builds of libjpeg, whose
pixels differed by 0 on this host (measured for colour and grey, quality
40 and 90, encoded by OpenCV and by PIL), pinned at that. save_image picks
the format from the extension as PIL does; the port's JPEG (quality 75,
4:2:0) decoded differs from the JAX package's save_image + load_image by
0 on this host (the bytes were the same)."""

import io
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from image_restoration_agent_tpu.core import io as jio
from image_restoration_agent_tpu_torch.core import io as tio
from image_restoration_agent_tpu_torch.core.decode_pool import DecodePool
from image_restoration_agent_tpu_torch.engine import Engine

torch.set_num_threads(1)
jax.config.update("jax_platforms", "cpu")

H, W = 37, 53
# the largest pixel difference between the JAX package's PIL and the
# port's OpenCV on the same JPEG bytes, and after each package's own
# save_image (quality 75) and load_image: measured on this host
JPEG_DECODE_DIFF = 0
JPEG_SAVE_DIFF = 0


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF))


_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def png_bytes(arr: np.ndarray, color: int, depth: int = 8,
              interlace: bool = False, plte: bytes | None = None) -> bytes:
    """A PNG of ``arr`` (H, W[, C]) with filter-0 rows, big-endian samples
    at ``depth`` 8 or 16, Adam7-interlaced where asked."""
    a = arr if arr.ndim == 3 else arr[..., None]
    a = a.astype(">u2") if depth == 16 else a.astype(np.uint8)

    def rows(sub):
        return b"".join(b"\x00" + r.tobytes() for r in sub) \
            if sub.shape[0] and sub.shape[1] else b""

    raw = b"".join(rows(a[y0::dy, x0::dx]) for y0, x0, dy, dx in _ADAM7) \
        if interlace else rows(a)
    h, w = a.shape[:2]
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                          0, int(interlace)))
            + (_chunk(b"PLTE", plte) if plte is not None else b"")
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _png_case(name: str) -> bytes:
    rng = np.random.default_rng(sum(map(ord, name)))
    u8 = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    u16 = rng.integers(0, 65536, (H, W, 4), dtype=np.uint16)
    small16 = rng.integers(0, 400, (H, W), dtype=np.uint16)
    il = name.endswith("_interlaced")
    kind = name.removesuffix("_interlaced")
    if kind == "rgb8":
        return png_bytes(u8[..., :3], 2, interlace=il)
    if kind == "grey8":
        return png_bytes(u8[..., 0], 0, interlace=il)
    if kind == "greya8":
        return png_bytes(u8[..., :2], 4, interlace=il)
    if kind == "rgba8":
        return png_bytes(u8, 6, interlace=il)
    if kind == "palette":
        plte = rng.integers(0, 256, (64, 3), dtype=np.uint8).tobytes()
        return png_bytes(u8[..., 0] % 64, 3, interlace=il, plte=plte)
    if kind == "grey16":  # values past 255 and under it
        return png_bytes(np.where(u16[..., 0] % 2, u16[..., 0], small16),
                         0, 16, interlace=il)
    if kind == "rgb16":
        return png_bytes(u16[..., :3], 2, 16, interlace=il)
    if kind == "rgba16":
        return png_bytes(u16, 6, 16, interlace=il)
    if kind == "greya16":
        return png_bytes(u16[..., :2], 4, 16, interlace=il)
    raise KeyError(name)


_PNG_KINDS = ["rgb8", "grey8", "greya8", "rgba8", "palette", "grey16",
              "rgb16", "rgba16", "greya16", "rgb8_interlaced",
              "grey8_interlaced", "greya8_interlaced", "palette_interlaced",
              "grey16_interlaced", "rgb16_interlaced"]


@pytest.mark.parametrize("kind", _PNG_KINDS)
def test_png_decodes_as_the_jax_package(kind):
    """decode_image and DecodePool.decode give the JAX package's array for
    every PNG kind, bit for bit (16-bit grey clamped to 255 as PIL's
    convert does, every other 16-bit kind its high byte)."""
    data = _png_case(kind)
    want = jio.decode_image(data)
    got = tio.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(DecodePool(workers=1).decode(data), want)


def _smooth(seed: int, h: int = 48, w: int = 64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    small = rng.random((h // 8 + 1, w // 8 + 1, 3)).astype(np.float32)
    return (cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
            .clip(0, 1) * 255).round().astype(np.uint8)


@pytest.mark.parametrize("grey", [False, True])
@pytest.mark.parametrize("quality", [40, 90])
@pytest.mark.parametrize("encoder", ["opencv", "pil"])
def test_jpeg_decodes_within_the_pinned_difference(grey, quality, encoder):
    """JPEG in colour and grey: the JAX package's shape, and pixels within
    JPEG_DECODE_DIFF of its (PIL's libjpeg against OpenCV's)."""
    img = _smooth(quality + grey)
    arr = img[..., 0] if grey else img
    if encoder == "opencv":
        data = cv2.imencode(".jpg", arr if grey else arr[..., ::-1],
                            [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
    else:
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
        data = buf.getvalue()
    want = jio.decode_image(data)
    for got in (tio.decode_image(data), DecodePool(workers=1).decode(data)):
        assert got.shape == want.shape == (48, 64, 3)
        assert int(np.abs(got.astype(int) - want).max()) <= JPEG_DECODE_DIFF


@pytest.mark.parametrize("ext", [".bmp", ".webp"])
def test_bmp_and_webp_decode_as_the_jax_package(ext):
    img = _smooth(len(ext))
    data = cv2.imencode(ext, img[..., ::-1])[1].tobytes()
    np.testing.assert_array_equal(tio.decode_image(data),
                                  jio.decode_image(data))


@pytest.mark.parametrize("data", [
    b"", b"not an image at all", b"\x89PNG\r\n\x1a\nnot an image",
    b"\xff\xd8\xff\xe0" + bytes(64)], ids=["empty", "text", "png_sig",
                                         "jpeg_sig"])
def test_undecodable_bytes_raise_value_error(data):
    with pytest.raises(ValueError, match="not a decodable image"):
        tio.decode_image(data)
    with pytest.raises(ValueError):
        DecodePool(workers=1).decode(data)


_SIGNATURES = {".png": b"\x89PNG\r\n\x1a\n", ".jpg": b"\xff\xd8\xff",
               ".jpeg": b"\xff\xd8\xff", ".bmp": b"BM", ".webp": b"RIFF"}


@pytest.mark.parametrize("ext", sorted(_SIGNATURES))
def test_save_image_writes_the_format_of_its_extension(tmp_path, ext):
    """The written bytes carry the extension's signature and decode to the
    JAX package's save_image + load_image (PNG and BMP exactly; JPEG and
    WebP, both lossy, within the pinned difference)."""
    img = _smooth(7).astype(np.float32) / 255.0
    mine, ref = tmp_path / f"port{ext}", tmp_path / f"jax{ext}"
    tio.save_image(img, mine)
    jio.save_image(img, ref)
    assert mine.read_bytes().startswith(_SIGNATURES[ext])
    got, want = tio.load_image(mine), jio.load_image(ref)
    assert got.shape == want.shape == (48, 64, 3)
    lossy = ext in (".jpg", ".jpeg", ".webp")
    assert int(np.abs(got.astype(int) - want).max()) <= \
        (JPEG_SAVE_DIFF if lossy else 0)
    if not lossy:
        np.testing.assert_array_equal(got, _smooth(7))


@pytest.mark.parametrize("name", ["out.xyz", "out"])
def test_save_image_refuses_an_extension_pil_refuses(tmp_path, name):
    img = _smooth(8)
    with pytest.raises(ValueError):
        jio.save_image(img, tmp_path / f"jax_{name}")
    with pytest.raises(ValueError):
        tio.save_image(img, tmp_path / name)
    assert not (tmp_path / name).exists()


def test_engine_restore_file_reads_and_writes_jpeg(tmp_path):
    """Engine.restore_file on a .jpg input with a .jpg output (a tiny
    NAFNet on the CPU): the output is a JPEG of the restored image, equal
    to the port's own JPEG encode of restore_array on the decoded input."""
    src = tmp_path / "in.jpg"
    src.write_bytes(cv2.imencode(".jpg", _smooth(9)[..., ::-1],
                                 [cv2.IMWRITE_JPEG_QUALITY, 90])[1]
                    .tobytes())
    eng = Engine(device="cpu")
    res = eng.restore_file(src, tmp_path / "out.jpg", "nafnet_small")
    out = (tmp_path / "out.jpg").read_bytes()
    assert out.startswith(b"\xff\xd8\xff")
    direct = eng.restore_array(tio.to_float(tio.load_image(src)),
                               "nafnet_small")
    np.testing.assert_array_equal(res.image, direct.image)
    tio.save_image(direct.image, tmp_path / "direct.jpg")
    assert out == (tmp_path / "direct.jpg").read_bytes()
    assert tio.load_image(tmp_path / "out.jpg").shape == (48, 64, 3)


_BLOCKED = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "PIL", "image_restoration_agent_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
"""


def test_decode_and_encode_import_neither_jax_nor_pil(tmp_path):
    """In a process where jax, PIL and the JAX package cannot be imported,
    the port decodes a JPEG and a 16-bit PNG and writes a JPEG."""
    jpg = tmp_path / "a.jpg"
    jpg.write_bytes(cv2.imencode(".jpg", _smooth(10))[1].tobytes())
    png = tmp_path / "b.png"
    png.write_bytes(_png_case("grey16"))
    code = _BLOCKED + f"""
from image_restoration_agent_tpu_torch.core.io import load_image, save_image
a = load_image({str(jpg)!r}); b = load_image({str(png)!r})
save_image(a, {str(tmp_path / 'c.jpg')!r})
print(a.shape, b.shape)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["(48,", "64,", "3)", f"({H},", f"{W},",
                                  "3)"]
    assert (tmp_path / "c.jpg").read_bytes().startswith(b"\xff\xd8\xff")
