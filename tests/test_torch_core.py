"""Port parity: serving core (pad, tile plan, blend, tiled_apply, PNG codec)
of image_restoration_agent_tpu_torch against the JAX package on the CPU."""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.core import io as jio
from image_restoration_agent_tpu.core import pad as jpad
from image_restoration_agent_tpu.core import tiling as jtil
from image_restoration_agent_tpu_torch.core import io as tio
from image_restoration_agent_tpu_torch.core import pad as tpad
from image_restoration_agent_tpu_torch.core import tiling as ttil
from image_restoration_agent_tpu_torch.offline import GOLDEN_ROOT

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["extra", "ceil"])
@pytest.mark.parametrize("kind", ["symmetric", "reflect", "edge",
                                  "constant"])
@pytest.mark.parametrize("hw", [(75, 100), (5, 3), (16, 24)])
def test_pad_to_multiple_matches(mode, kind, hw):
    x = np.random.default_rng(1).random((*hw, 3), dtype=np.float32)
    want, whw = jpad.pad_to_multiple(jnp.asarray(x), 8, mode, kind)
    got, ghw = tpad.pad_to_multiple(torch.from_numpy(x), 8, mode, kind)
    assert whw == ghw
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hw,tile,ov", [
    ((75, 100), 32, 8), ((552, 1920), (552, 1920), 16),
    ((1080, 1920), (552, 1920), 16), ((40, 60), 128, 32), ((64, 48), 16, 4)])
def test_plan_tiles_offsets_equal(hw, tile, ov):
    a = jtil.plan_tiles(*hw, tile, ov)
    b = ttil.plan_tiles(*hw, tile, ov)
    assert (a.tile_h, a.tile_w, a.h_starts, a.w_starts) == \
        (b.tile_h, b.tile_w, b.h_starts, b.w_starts)
    np.testing.assert_array_equal(a.offsets, b.offsets)


def _times_1_5(t):
    # one IEEE multiply: both frameworks produce the same tile outputs, so
    # any difference would come from the blend
    return t * 1.5


def _packed(xp, s):
    """An elementwise 'model' that upsamples by s and packs RGB."""
    def fn(t):
        if xp is torch:
            t = t.repeat_interleave(s, 1).repeat_interleave(s, 2)
        else:
            t = xp.repeat(xp.repeat(t, s, axis=1), s, axis=2)
        y = t * 1.5
        return y.reshape(y.shape[0], y.shape[1], -1)
    return fn


@pytest.mark.parametrize("case", [
    dict(hw=(75, 100), tile=32, overlap=8, pad_multiple=8, pad_mode="ceil"),
    dict(hw=(75, 100), tile=48, overlap=16, pad_multiple=8,
         pad_mode="extra"),
    dict(hw=(40, 60), tile=128, overlap=32, pad_multiple=8,
         pad_mode="extra"),
    dict(hw=(75, 100), tile=(40, 104), overlap=16, pad_to=(80, 104)),
])
def test_tiled_apply_elementwise_bit_identical(case):
    """The blend of elementwise tile outputs equals the JAX blend bit for
    bit: square tiles, a non-multiple size, a tile larger than the image,
    and full-width band tiles."""
    case = dict(case)
    h, w = case.pop("hw")
    img = np.random.default_rng(2).random((h, w, 3), dtype=np.float32)
    want = jtil.tiled_apply(_times_1_5, jnp.asarray(img), batch=3, **case)
    got = ttil.tiled_apply(_times_1_5, torch.from_numpy(img), batch=3,
                           **case)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hw,pad_to,tile", [
    ((75, 100), (80, 128), (48, 128)),
    ((1080, 48), (1080, 48), (552, 48)),
])
def test_band_blend_packed_bit_identical(hw, pad_to, tile):
    """552xW band tiles with 16 px overlap and packed_c=3 (the x4 band
    serving geometry, at a narrow width)."""
    img = np.random.default_rng(3).random((*hw, 3), dtype=np.float32)
    kw = dict(tile=tile, overlap=16, scale=2, batch=1, pad_to=pad_to,
              packed_c=3)
    want = jtil.tiled_apply(_packed(jnp, 2), jnp.asarray(img), **kw)
    got = ttil.tiled_apply(_packed(torch, 2), torch.from_numpy(img), **kw)
    assert got.shape == (hw[0] * 2, hw[1] * 2 * 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_blend_tiles_bit_identical_random_tiles():
    plan = ttil.plan_tiles(70, 90, 32, 8)
    tiles = np.random.default_rng(4).standard_normal(
        (plan.num_tiles, 64, 64, 3)).astype(np.float32)
    jplan = jtil.plan_tiles(70, 90, 32, 8)
    want = jtil.blend_tiles(jnp.asarray(tiles), jplan, scale=2)
    got = ttil.blend_tiles(torch.from_numpy(tiles), plan, scale=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(17, 23, 3), (9, 5, 4), (6, 7)])
def test_png_round_trip(shape):
    img = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    data = tio.encode_png(img)
    got = tio.decode_png(data)
    np.testing.assert_array_equal(got.reshape(img.shape), img)
    # the JAX package's decoder reads what the port writes
    if img.ndim == 3 and img.shape[-1] == 3:
        np.testing.assert_array_equal(jio.decode_image(data), img)


def test_png_decodes_golden_like_jax():
    path = GOLDEN_ROOT / "swinir_sr_x4_synth" / "input.png"
    np.testing.assert_array_equal(tio.load_image(path),
                                  jio.load_image(path))


def test_png_filters_sub_up_average_paeth():
    """Every PNG row filter decodes to the same pixels (rows written with
    filters 1-4 by hand)."""
    img = np.random.default_rng(6).integers(0, 256, (8, 5, 3),
                                            dtype=np.uint8)
    bpp, raw, prev = 3, [], np.zeros(15, np.int32)
    for y in range(8):
        cur = img[y].reshape(-1).astype(np.int32)
        f = y % 5
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        raw.append(np.concatenate([[f], (cur - pred) % 256]).astype(
            np.uint8))
        prev = cur
    ihdr = struct.pack(">IIBBBBB", 5, 8, 8, 2, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + tio._chunk(b"IHDR", ihdr)
            + tio._chunk(b"IDAT", zlib.compress(b"".join(
                r.tobytes() for r in raw)))
            + tio._chunk(b"IEND", b""))
    np.testing.assert_array_equal(tio.decode_image(data), img)
