"""Port parity: window ops, pixel shuffle, the conv3x3 and Swin block plain
versions of image_restoration_agent_tpu_torch against the JAX package's
CPU paths (XLA, or the Pallas strip kernel in interpret mode)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.models.common import Conv as JConv
from image_restoration_agent_tpu.models.swinir import SwinBlock as JSwinBlock
from image_restoration_agent_tpu.ops.pallas_attention import (
    mlp_block_pallas, swin_strip_pallas)

# the ops packages re-export functions under their modules' names
jconv = importlib.import_module("image_restoration_agent_tpu.ops.conv3x3")
jps = importlib.import_module("image_restoration_agent_tpu.ops.pixel_shuffle")
jwa = importlib.import_module(
    "image_restoration_agent_tpu.ops.window_attention")
tconv = importlib.import_module("image_restoration_agent_tpu_torch.ops.conv3x3")
tps = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.pixel_shuffle")
tsb = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.swin_block")
twa = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.window_attention")

torch.set_num_threads(1)

WS, C, HEADS = 4, 8, 2
S = WS // 2
N = WS * WS


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("ws", [4, 7, 8])
def test_window_index_and_masks_equal(ws):
    np.testing.assert_array_equal(twa.relative_position_index(ws),
                                  jwa.relative_position_index(ws))
    for h, w in ((2 * ws, 2 * ws), (3 * ws, 5 * ws)):
        np.testing.assert_array_equal(
            twa.shift_attention_mask(h, w, ws, ws // 2),
            jwa.shift_attention_mask(h, w, ws, ws // 2))
    x = np.random.default_rng(0).random((2, 2 * ws, 3 * ws, 5), np.float32)
    pw = twa.window_partition(_t(x), ws)
    np.testing.assert_array_equal(pw.numpy(),
                                  np.asarray(jwa.window_partition(x, ws)))
    np.testing.assert_array_equal(
        twa.window_reverse(pw, ws, 2 * ws, 3 * ws).numpy(), x)


def test_window_attention_reference_matches():
    rng = np.random.default_rng(1)
    qkv = rng.standard_normal((6, N, 3 * C)).astype(np.float32)
    table = rng.standard_normal(((2 * WS - 1) ** 2, HEADS)).astype(np.float32)
    mask = jwa.shift_attention_mask(2 * WS, 3 * WS, WS, S)
    want = jwa.window_attention(jnp.asarray(qkv), HEADS, jnp.asarray(table),
                                WS, jnp.asarray(mask))
    got = twa.window_attention(_t(qkv), HEADS, _t(table), WS, _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_and_head_weights(r):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 5, 6, 4 * r * r)).astype(np.float32)
    np.testing.assert_allclose(tps.pixel_shuffle(_t(x), r).numpy(),
                               np.asarray(jps.pixel_shuffle(x, r)),
                               atol=1e-6)
    y = rng.standard_normal((1, 5 * r, 6 * r, 4)).astype(np.float32)
    np.testing.assert_allclose(tps.pixel_unshuffle(_t(y), r).numpy(),
                               np.asarray(jps.pixel_unshuffle(y, r)),
                               atol=1e-6)
    w = rng.standard_normal((3, 3, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tconv.conv_after_shuffle_weights(_t(w), r).numpy(),
        np.asarray(jconv.conv_after_shuffle_weights(jnp.asarray(w), r)),
        atol=1e-6)
    # weights at trained-network scale (fan-in), so atol 1e-6 is f32 noise
    wa = (rng.standard_normal((3, 3, 4, 6)) / 6).astype(np.float32)
    ba = (0.1 * rng.standard_normal(6)).astype(np.float32)
    wb = (rng.standard_normal((5, 5, 6, 3)) / 12).astype(np.float32)
    bb = (0.1 * rng.standard_normal(3)).astype(np.float32)
    jw, jb = jconv.compose_conv_weights(*map(jnp.asarray, (wa, ba, wb, bb)))
    tw, tb = tconv.compose_conv_weights(*map(_t, (wa, ba, wb, bb)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)


_CONV_CASES = {
    "bias": dict(),
    "lrelu": dict(act="lrelu"),
    "lrelu2": dict(act="lrelu2"),
    "res": dict(res=True),
    "roll+1": dict(roll=1, res=True),
    "roll-1": dict(roll=-1),
    "roll+4": dict(roll=4, res=True),
    "roll-4": dict(roll=-4, res=True),
    "roll+7": dict(roll=7),
    "roll-7": dict(roll=-7, act="lrelu"),
    "ln_pre": dict(ln=True),
    "ln_pre+res": dict(ln=True, res=True),
    "ln_pre+roll": dict(ln=True, roll=-4, res=True),
}


@pytest.mark.parametrize("name", list(_CONV_CASES))
def test_conv3x3_plain_matches_jax_conv(name):
    """The port's conv3x3 on the CPU (its plain version) == the JAX
    models.common.Conv XLA path, which the JAX package holds equal to
    conv3x3_pallas."""
    case = _CONV_CASES[name]
    rng = np.random.default_rng(3)
    cin, cout, h, w = 6, 5, 16, 24
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    wk = (rng.standard_normal((3, 3, cin, cout)) / 4).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    res = rng.standard_normal((2, h, w, cout)).astype(np.float32) \
        if case.get("res") else None
    ln = (rng.standard_normal(cin).astype(np.float32) * 0.1 + 1,
          rng.standard_normal(cin).astype(np.float32)) \
        if case.get("ln") else None
    mod = JConv(cout, kernel=3, act=case.get("act"))
    params = {"params": {"Conv_0": {"kernel": jnp.asarray(wk),
                                    "bias": jnp.asarray(b)}}}
    want = mod.apply(params, jnp.asarray(x),
                     res=None if res is None else jnp.asarray(res),
                     roll=case.get("roll", 0),
                     ln_pre=None if ln is None else tuple(map(jnp.asarray,
                                                              ln)))
    got = tconv.conv3x3(_t(x), _t(wk), _t(b), act=case.get("act"),
                        res=None if res is None else _t(res),
                        roll=case.get("roll", 0),
                        ln_pre=None if ln is None else tuple(map(_t, ln)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_kernel_form_equals_raw_weights(dtype):
    """conv3x3 on the kernel form (made once: padded in bf16, f32 bias) ==
    conv3x3 on the raw HWIO weights and bias."""
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((1, 8, 12, 6)).astype(np.float32)).to(dtype)
    wk = _t((rng.standard_normal((3, 3, 6, 5)) / 4).astype(np.float32))
    b = _t(rng.standard_normal(5).astype(np.float32)).to(dtype)
    k = tconv.conv3x3_weights(wk, b, dtype)
    pad = (32, 64) if dtype == torch.bfloat16 else (6, 5)
    assert k.w.shape == (3, 3, *pad) and k.w.dtype == dtype
    assert k.b.dtype == torch.float32 and (k.cin, k.cout) == (6, 5)
    torch.testing.assert_close(tconv.conv3x3(x, k, act="lrelu", roll=-4),
                               tconv.conv3x3(x, wk, b, act="lrelu", roll=-4),
                               atol=0, rtol=0)
    with pytest.raises(ValueError):
        tconv.conv3x3(x, k, b)


@pytest.mark.parametrize("w", [128, 24], ids=["kernel_route", "library"])
def test_upsample_tail_matches_jax(w):
    """The port's upsample_tail == the JAX one (XLA on the CPU): at a shape
    conv3x3_fits takes, both convs run as conv3x3 in plane space; else as
    the plain library conv."""
    from image_restoration_agent_tpu.models.common import (
        upsample_tail as j_tail)
    from image_restoration_agent_tpu_torch.models.common import upsample_tail
    rng = np.random.default_rng(9)
    r, cin, cout = 2, 4, 3
    x = rng.standard_normal((1, 8, w, cin)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, cin, cin * r * r)) / 6).astype(
        np.float32)
    b1 = (0.1 * rng.standard_normal(cin * r * r)).astype(np.float32)
    wl = (rng.standard_normal((3, 3, cin, cout)) / 6).astype(np.float32)
    bl = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    assert tconv.conv3x3_fits(8, w) == (w == 128)
    want = j_tail(*map(jnp.asarray, (x, w1, b1, wl, bl)), r)
    got = upsample_tail(*map(_t, (x, w1, b1, wl, bl)), r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _block_weights(rng, c=C, heads=HEADS, ws=WS):
    """Reference-layout (torch nn.Linear) weights of one block, scaled like
    a trained network (fan-in)."""
    def mat(o, i):
        return (rng.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32)

    def vec(n, s=0.1, base=0.0):
        return (base + s * rng.standard_normal(n)).astype(np.float32)

    return dict(
        norm1_w=vec(c, 0.1, 1.0), norm1_b=vec(c), qkv_w=mat(3 * c, c),
        qkv_b=vec(3 * c), proj_w=mat(c, c), proj_b=vec(c),
        rpb_table=vec(((2 * ws - 1) ** 2, heads), 0.5),
        norm2_w=vec(c, 0.1, 1.0), norm2_b=vec(c), fc1_w=mat(2 * c, c),
        fc1_b=vec(2 * c), fc2_w=mat(c, 2 * c), fc2_b=vec(c))


def _port_params(wts, dtype=torch.float32, heads=HEADS, ws=WS):
    return tsb.prepare_swin_params(**{k: _t(v) for k, v in wts.items()},
                                   num_heads=heads, ws=ws, dtype=dtype)


def _jax_block_params(wts):
    return {"params": {
        "attn": {"relative_position_bias_table": wts["rpb_table"],
                 "norm_scale": wts["norm1_w"], "norm_bias": wts["norm1_b"],
                 "qkv_kernel": wts["qkv_w"].T, "qkv_bias_p": wts["qkv_b"],
                 "proj_kernel": wts["proj_w"].T,
                 "proj_bias_p": wts["proj_b"]},
        "norm2_scale": wts["norm2_w"], "norm2_bias": wts["norm2_b"],
        "fc1_kernel": wts["fc1_w"].T, "fc1_bias": wts["fc1_b"],
        "fc2_kernel": wts["fc2_w"].T, "fc2_bias": wts["fc2_b"]}}


def _bank(ws=WS):
    n = ws * ws
    return _t(twa.shift_attention_mask(2 * ws, 2 * ws, ws, ws // 2)
              .reshape(2, 2, n, n))


@pytest.mark.parametrize("hw", [(16, 16), (8, 12)], ids=["even", "odd"])
def test_swin_block_exact_chained_frames_match_jax(hw):
    """Three blocks (shift 0, 2, 0) chained through folded-roll frames, then
    unrolled once, == the JAX SwinBlock XLA path (explicit rolls, frame 0)
    applied three times; even and odd window counts per row."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, *hw, C)).astype(np.float32)
    wts = [_block_weights(rng) for _ in range(3)]
    want = jnp.asarray(x)
    for i, wt in enumerate(wts):
        blk = JSwinBlock(C, HEADS, WS, shift_size=S if i % 2 else 0,
                         attention_impl="xla")
        want, frame = blk.apply(jax.tree.map(jnp.asarray,
                                             _jax_block_params(wt)), want)
        assert frame == 0
    got, frame = _t(x), 0
    for i, wt in enumerate(wts):
        shift = S if i % 2 else 0
        got = tsb.swin_block(got, _port_params(wt), num_heads=HEADS, ws=WS,
                             dc=-shift - frame,
                             mask_bank=_bank() if shift else None)
        frame = -shift
    got = torch.roll(got, (-frame, -frame), dims=(1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def _strip_args(wts):
    table = jnp.asarray(wts["rpb_table"])
    idx = jnp.asarray(jwa.relative_position_index(WS).reshape(-1))
    rpb = table[idx].reshape(N, N, HEADS).transpose(2, 0, 1)
    ps = (wts["norm1_w"], wts["norm1_b"], wts["qkv_w"].T, wts["qkv_b"],
          wts["proj_w"].T, wts["proj_b"])
    mlp = (wts["norm2_w"], wts["norm2_b"], wts["fc1_w"].T, wts["fc1_b"],
           wts["fc2_w"].T, wts["fc2_b"])
    return (*map(jnp.asarray, ps), rpb), tuple(map(jnp.asarray, mlp))


@pytest.mark.parametrize("dc,banked", [(0, False), (-S, True), (S, True)])
def test_swin_block_fast_matches_strip_kernel(dc, banked):
    """Fast numerics (base-2 clamp softmax, reciprocal normalization,
    tanh-GELU, f32 attention-half output) == swin_strip_pallas paired2r
    fastmath in interpret mode, in float32."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 4 * WS, 4 * WS, C)).astype(np.float32)
    wts = _block_weights(rng)
    ps, mlp = _strip_args(wts)
    bank = jnp.asarray(np.asarray(_bank())) if banked else None
    want = swin_strip_pallas(jnp.asarray(x), *ps, None, num_heads=HEADS,
                             ws=WS, mask_bank=bank, dc=dc, mlp=mlp,
                             attn_mode="paired2r", fastmath=True,
                             interpret=True)
    got = tsb.swin_block(_t(x), _port_params(wts), num_heads=HEADS, ws=WS,
                         dc=dc, mask_bank=_bank() if banked else None,
                         fast=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mlp_block_matches_jax_kernel():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((64, C)).astype(np.float32)
    wts = _block_weights(rng)
    _, mlp = _strip_args(wts)
    want = mlp_block_pallas(jnp.asarray(x), *mlp, interpret=True)
    p = _port_params(wts)
    got = tsb.mlp_block(_t(x), *p.mlp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,dc,banked", [
    ((16, 16), 0, False), ((16, 16), -S, True), ((16, 16), S, True),
    ((8, 12), -S, True), ((8, 12), S, False)])
def test_kernel_sequence_matches_plain_block(fast, dtype, hw, dc, banked):
    """The CUDA path's launch sequence (K1 gather/LN -> K2 -> K1 residual ->
    K1 GELU -> K1 scatter), run here through the kernels' plain versions,
    == the plain block: the row maps, frames, bank selection and cast
    points of the kernel path are checked on the CPU."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, *hw, C)).astype(
        np.float32)).to(dtype)
    p = _port_params(_block_weights(rng), dtype=dtype)
    kw = dict(num_heads=HEADS, ws=WS, dc=dc,
              mask_bank=_bank() if banked else None, fast=fast)
    want = tsb.swin_block_plain(x, p, **kw)
    got = tsb.swin_block_composed(x, p, **kw)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=tol)


def test_strip_width_helpers_match():
    from image_restoration_agent_tpu.ops import pallas_attention as jpa
    for w in (1920, 1280, 2048, 1928, 1923, 264, 60, 480):
        assert tsb.strip_chunk_width(w) == jpa.strip_chunk_width(w)
        assert tsb.pad_width_for_strips(w) == jpa.pad_width_for_strips(w)
