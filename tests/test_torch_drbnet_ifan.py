"""Port parity for DRBNet and IFAN: DRBNet's per-pixel filter ``fac``,
IFAN's ``sac`` (with the reference's kernel1 bug) and ``iac``, whole
drbnet_tiny and ifan_tiny against the JAX package in f32 and bf16, and
their weight names (the JAX importer's rule sets)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.convert.torch_import import (
    convert_state_dict, drbnet_rules, ifan_rules)
from image_restoration_agent_tpu.models import drbnet as jdrb
from image_restoration_agent_tpu.models import ifan as jifan
from image_restoration_agent_tpu.models import build_model as jbuild
from image_restoration_agent_tpu_torch.models import drbnet as tdrb
from image_restoration_agent_tpu_torch.models import ifan as tifan
from test_torch_xrestormer import _rms, jax_apply, port_pair, randomize

torch.set_num_threads(1)

HW = (32, 48)


def _r(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fac_matches_jax(dtype):
    """The 49-tap per-pixel filter with its edge pad: f32 within 1e-5 x
    max|ref|; bf16 (the JAX package sums in bf16, the port in f32) within
    the JAX sum's own error against f32 in RMS."""
    rng = np.random.default_rng(0)
    img, ker = _r(rng, 2, 12, 20, 3), 0.2 * _r(rng, 2, 12, 20, 49)
    want = np.asarray(jdrb.fac(jnp.asarray(img), jnp.asarray(ker)))
    if dtype == "float32":
        got = tdrb.fac(torch.from_numpy(img), torch.from_numpy(ker))
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * np.abs(want).max(), rtol=0)
        return
    j16 = np.asarray(jdrb.fac(jnp.asarray(img).astype(jnp.bfloat16),
                              jnp.asarray(ker).astype(jnp.bfloat16))
                     .astype(jnp.float32))
    got = tdrb.fac(torch.from_numpy(img).bfloat16(),
                   torch.from_numpy(ker).bfloat16()).float().numpy()
    assert _rms(got - want) <= _rms(j16 - want)


def test_sac_and_iac_match_jax():
    """``sac`` weighs both passes with kernel1 (the reference bug the
    released checkpoints bake in): kernel2 changes nothing, and the result
    is the JAX package's; ``iac`` (two iterations with biases and
    LeakyReLU(0.1)) too. f32 within 1e-5 x max|ref|."""
    rng = np.random.default_rng(1)
    b, h, w, c, k, n = 2, 10, 14, 4, 3, 2
    feat = _r(rng, b, h, w, c)
    k1, k2 = 0.5 * _r(rng, b, h, w, c * k), 0.5 * _r(rng, b, h, w, c * k)
    want = np.asarray(jifan.sac(*map(jnp.asarray, (feat, k1, k2))))
    got = tifan.sac(*map(torch.from_numpy, (feat, k1, k2))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    other = tifan.sac(*map(torch.from_numpy, (feat, k1, 3 * k2 + 1)))
    np.testing.assert_array_equal(other.numpy(), got)
    filt = 0.5 * _r(rng, b, h, w, n * (c * k * 2) + n * c)
    want = np.asarray(jifan.iac(jnp.asarray(feat), jnp.asarray(filt), n, c,
                                k))
    got = tifan.iac(torch.from_numpy(feat), torch.from_numpy(filt), n, c,
                    k).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


@pytest.fixture(scope="module", params=["drbnet_tiny", "ifan_tiny"])
def tiny(request):
    name = request.param
    m = jbuild(name)
    shapes = jax.eval_shape(lambda: m.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3))))
    params = randomize(shapes, 7)
    x = np.random.default_rng(8).random((1, *HW, 3), dtype=np.float32)
    return name, m, params, x, port_pair(name, params), \
        jax_apply(m, params, x, jnp.float32)


@torch.no_grad()  # a served forward (the model records a graph)
def test_tiny_matches_jax_f32(tiny):
    """f32 within 1e-4 x max|ref| (measured 5e-7 of max|ref| 0.93 for
    DRBNet, 2e-7 of 1.0 for IFAN); both outputs are clipped to their
    range, so the test also holds that most pixels lie inside it."""
    _, _, _, x, (m32, _), want = tiny
    got = m32(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.mean((want > 0) & (want < 1)) > 0.5
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


@torch.no_grad()  # a served forward (the model records a graph)
def test_tiny_matches_jax_bf16(tiny):
    """The port's bf16 RMS error against its own f32 at most 1.25x the JAX
    bf16 model's against JAX f32 (measured 0.67x DRBNet, 0.93x IFAN: the
    port sums fac and sac in f32)."""
    _, m, params, x, (m32, m16), j32 = tiny
    j16 = jax_apply(m, params, x, jnp.bfloat16)
    t32 = m32(torch.from_numpy(x)).numpy()
    t16 = m16(torch.from_numpy(x).bfloat16()).float().numpy()
    assert _rms(t16 - t32) <= 1.25 * _rms(j16 - j32)


def test_names_round_trip_through_jax_rules(tiny):
    """The port's state dict, through the JAX importer's drbnet_rules /
    ifan_rules, gives back the JAX tree exactly: the port's names are the
    reference's (ConvTranspose2d's (I, O, 4, 4) with both taps flipped)."""
    name, _, params, _, (m32, _), _ = tiny
    rules = drbnet_rules() if name == "drbnet_tiny" else ifan_rules(
        res_num=1)
    back = convert_state_dict({k: v.numpy() for k, v in
                               m32.state_dict().items()}, rules)
    want = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, v in want:
        np.testing.assert_array_equal(np.asarray(got[path]), v,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["drbnet", "ifan"])
def test_full_width_matches_jax_f32(name):
    """The registered DRBNet (ch1 32) and IFAN (ch 32, res_num 2, 17 IAC
    iterations) at 64x96 against the JAX models, f32 within 1e-4 x
    max|ref|."""
    torch.set_num_threads(4)
    m = jbuild(name)
    params = randomize(jax.eval_shape(lambda: m.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)))), 15)
    x = np.random.default_rng(16).random((1, 64, 96, 3), dtype=np.float32)
    want = jax_apply(m, params, x, jnp.float32)
    m32, _ = port_pair(name, params)
    got = m32(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)
