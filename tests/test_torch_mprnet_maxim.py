"""Port parity for MPRNet and MAXIM: the bilinear resizes (MPRNet's equals
``F.interpolate``; MAXIM's skip-signal resize is ``jax.image.resize`` with
its default antialias), MAXIM's GatingUnit, MAB and CrossGatingBlock,
whole mprnet_tiny and maxim_tiny (two and three stages) against the JAX
package in f32 and bf16, the MPRNet weight names (the JAX importer's rule
set) and the in-repo torch transcription of the published MPRNet
(tests/test_convert_mprnet.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_restoration_agent_tpu.convert.torch_import import (
    convert_state_dict, mprnet_rules)
from image_restoration_agent_tpu.models import build_model as jbuild
from image_restoration_agent_tpu.models import maxim as jmaxim
from image_restoration_agent_tpu.models.mprnet import (
    _bilinear_resize as jmpr_resize)
from image_restoration_agent_tpu_torch.convert import from_jax
from image_restoration_agent_tpu_torch.core.resize import resize_bilinear_jax
from image_restoration_agent_tpu_torch.models import maxim as tmaxim
from image_restoration_agent_tpu_torch.models.mprnet import (MPRNet,
                                                             bilinear_resize)
from test_torch_xrestormer import _rms, jax_apply, port_pair, randomize

torch.set_num_threads(1)

HW = (32, 64)


# ---------------------------------------------------------------------------
# resizes


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_mprnet_resize_equals_interpolate(scale):
    """MPRNet's DownSample / UpSample resize is torch's bilinear
    ``F.interpolate(align_corners=False)`` without antialias, and so is
    the JAX package's ``jax.image.resize(antialias=False)``."""
    x = np.random.default_rng(0).standard_normal((2, 12, 20, 5)).astype(
        np.float32)
    got = bilinear_resize(torch.from_numpy(x), scale)
    lib = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                        scale_factor=scale, mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, lib, rtol=0, atol=0)
    want = np.asarray(jmpr_resize(jnp.asarray(x), scale))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("ratio", [0.25, 0.5, 2.0, 4.0])
@pytest.mark.parametrize("hw", [(16, 24), (13, 21)], ids=["even", "odd"])
def test_maxim_resize_matches_jax(hw, ratio):
    """The skip signals' resize against ``jax.image.resize(...,
    "bilinear")`` (antialias on: on a downscale the triangle widens and
    renormalizes at the borders) on even and odd sizes, f32 within 1e-6,
    bf16 weights and input within one bf16 ulp. On a downscale it is not
    ``F.interpolate(antialias=False)``, the form MPRNet's resize takes."""
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(
        np.float32)
    oh, ow = int(hw[0] * ratio), int(hw[1] * ratio)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, oh, ow, 3),
                                       "bilinear"))
    got = resize_bilinear_jax(torch.from_numpy(x), oh, ow).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    want16 = np.asarray(jax.image.resize(
        jnp.asarray(x).astype(jnp.bfloat16), (2, oh, ow, 3),
        "bilinear").astype(jnp.float32))
    got16 = resize_bilinear_jax(torch.from_numpy(x).bfloat16(), oh,
                                ow).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got16, want16, atol=ulp, rtol=0)
    if ratio < 1:
        plain = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                              size=(oh, ow), mode="bilinear",
                              align_corners=False, antialias=False)
        assert not np.allclose(plain.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# MAXIM's modules


def _module_pair(jm, tm, *inputs, seed=0):
    """Random params for the Flax module ``jm``, carried into ``tm`` (the
    port's module) by from_jax's MAXIM rules; both outputs (f32)."""
    params = randomize(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, inputs))), seed)
    from image_restoration_agent_tpu_torch.convert.from_jax import (
        _flatten, _maxim_name)
    sd = {}
    for path, v in _flatten(params["params"]):
        name, fn = _maxim_name(path)
        sd[name] = torch.from_numpy(np.ascontiguousarray(fn(v)))
    tm.load_state_dict(sd, strict=True)
    want = jm.apply(params, *map(jnp.asarray, inputs))
    got = tm(*map(torch.from_numpy, inputs))
    return want, got


def _close(want, got):
    want, got = np.asarray(want), got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


@pytest.mark.parametrize("axis", [-3, -2], ids=["grid", "block"])
def test_gating_unit_matches_jax(axis):
    x = np.random.default_rng(2).standard_normal((2, 16, 9, 12)).astype(
        np.float32)
    tokens = x.shape[axis]
    want, got = _module_pair(jmaxim.GatingUnit(axis), tmaxim.GatingUnit(
        12, tokens, axis), x)
    _close(want, got)


def test_mab_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 16, 16, 8)).astype(
        np.float32)
    want, got = _module_pair(jmaxim.MAB((4, 4), (2, 2)),
                             tmaxim.MAB(8, (4, 4), (2, 2)), x)
    _close(want, got)


@pytest.mark.parametrize("upsample_y", [True, False])
def test_cross_gating_block_matches_jax(upsample_y):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 12)).astype(np.float32)
    y = rng.standard_normal((2, 8, 8, 16) if upsample_y
                            else (2, 16, 16, 8)).astype(np.float32)
    want, got = _module_pair(
        jmaxim.CrossGatingBlock(8, (4, 4), (2, 2), upsample_y=upsample_y),
        tmaxim.CrossGatingBlock(12, y.shape[-1], 8, (4, 4), (2, 2),
                                upsample_y=upsample_y), x, y)
    _close(want[0], got[0])
    _close(want[1], got[1])


# ---------------------------------------------------------------------------
# whole models


def _tiny(name, seed, **cfg):
    """(JAX model, params, input, port models, JAX f32 output)."""
    m = jbuild(name, **cfg)
    shapes = jax.eval_shape(lambda: m.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3))))
    params = randomize(shapes, seed)
    x = np.random.default_rng(seed + 1).random((1, *HW, 3), dtype=np.float32)
    return m, params, x, port_pair(name, params, **cfg), \
        jax_apply(m, params, x, jnp.float32)


@pytest.fixture(scope="module")
def mprnet_tiny():
    return _tiny("mprnet_tiny", 3)


@pytest.fixture(scope="module", params=[2, 3], ids=["s2", "s3"])
def maxim_tiny(request):
    return _tiny("maxim_tiny", 5, num_stages=request.param)


@torch.no_grad()  # a served forward (the model records a graph)
def _check_f32(x, m32, want):
    got = m32(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


@torch.no_grad()  # a served forward (the model records a graph)
def _check_bf16(m, params, x, m32, m16, j32, mult):
    j16 = jax_apply(m, params, x, jnp.bfloat16)
    t32 = m32(torch.from_numpy(x)).numpy()
    t16 = m16(torch.from_numpy(x).bfloat16()).float().numpy()
    assert _rms(t16 - t32) <= mult * _rms(j16 - j32)


def test_mprnet_tiny_matches_jax_f32(mprnet_tiny):
    """f32 within 1e-4 x max|ref| (measured 6e-5 of max|ref| 71: random
    weights grow through the three stages' residuals)."""
    _, _, x, (m32, _), want = mprnet_tiny
    _check_f32(x, m32, want)


def test_mprnet_tiny_matches_jax_bf16(mprnet_tiny):
    """The port's bf16 RMS error against its own f32 at most 1.25x the JAX
    bf16 model's against JAX f32 (measured 1.07x)."""
    m, params, x, (m32, m16), j32 = mprnet_tiny
    _check_bf16(m, params, x, m32, m16, j32, 1.25)


def test_maxim_tiny_matches_jax_f32(maxim_tiny):
    """maxim_tiny with two stages and with three (MAXIM-S3's stage count):
    f32 within 1e-4 x max|ref| (measured 8e-5 of max|ref| 121 with two
    stages, 2e-3 of 1609 with three)."""
    m, _, x, (m32, _), want = maxim_tiny
    assert len([k for k in m32._modules if k.endswith("input_conv_0")]) \
        == m.num_stages
    _check_f32(x, m32, want)


def test_maxim_tiny_matches_jax_bf16(maxim_tiny):
    """The port's bf16 RMS error against its own f32 at most 1.25x the JAX
    bf16 model's (measured 0.96x and 0.95x): the port sums the resizes in
    f32."""
    m, params, x, (m32, m16), j32 = maxim_tiny
    _check_bf16(m, params, x, m32, m16, j32, 1.25)


def test_mprnet_names_round_trip_through_jax_rules(mprnet_tiny):
    """The port's state dict, through the JAX importer's mprnet_rules,
    gives back the JAX tree exactly."""
    _, params, _, (m32, _), _ = mprnet_tiny
    back = convert_state_dict({k: v.numpy() for k, v in
                               m32.state_dict().items()}, mprnet_rules())
    want = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, v in want:
        np.testing.assert_array_equal(np.asarray(got[path]), v,
                                      err_msg=jax.tree_util.keystr(path))


@torch.no_grad()  # a served forward (the model records a graph)
def test_mprnet_matches_torch_transcription():
    """TMPRNet (tests/test_convert_mprnet.py: the published MPRNet in torch,
    one PReLU shared by every CAB) loads into the port's mprnet_tiny
    geometry with strict=True and gives its output (measured max-abs error
    4e-7 of max|ref| 1.4)."""
    from test_convert_mprnet import TMPRNet
    torch.manual_seed(3)
    ref = TMPRNet().eval()
    port = MPRNet(n_feat=8, scale_unetfeats=4, scale_orsnetfeats=4,
                  num_cab=1)
    port.load_state_dict(ref.state_dict(), strict=True)
    x = np.random.default_rng(7).random((1, 16, 16, 3), dtype=np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["mprnet", "maxim_s2", "maxim_s3"])
def test_full_width_matches_jax_f32(name):
    """The registered models (MPRNet n_feat 80; MAXIM-S2 / S3 features 32,
    depth 3, blocks and grids 16 and 8) at 64x64 against the JAX models,
    f32 within 1e-4 x max|ref|."""
    torch.set_num_threads(4)
    m = jbuild(name)
    params = randomize(jax.eval_shape(lambda: m.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))), 13)
    x = np.random.default_rng(14).random((1, 64, 64, 3), dtype=np.float32)
    want = jax_apply(m, params, x, jnp.float32)
    m32, _ = port_pair(name, params)
    got = m32(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)
