"""Port parity for X-Restormer: OCAB alone, whole xrestormer_tiny on both
block routes (the JAX fused kernels in interpret mode and its XLA route),
f32 and bf16, the weight names (the JAX importer's rule set, family
detection in ``from_jax``) and the in-repo torch transcription of the
published architecture (tests/test_convert_xrestormer.py)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.convert.torch_import import (
    convert_state_dict, xrestormer_rules)
from image_restoration_agent_tpu.models import build_model as jbuild
from image_restoration_agent_tpu.models.xrestormer import OCAB as JOCAB
from image_restoration_agent_tpu_torch.convert import from_jax
from image_restoration_agent_tpu_torch.models import build_model
from image_restoration_agent_tpu_torch.models.xrestormer import (OCAB,
                                                                 XRestormer)

jrf = importlib.import_module(
    "image_restoration_agent_tpu.ops.restormer_fused")

torch.set_num_threads(1)

HW = (64, 128)  # level 1 (64x128) on the fused route, levels 2-4 not


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a))))


def randomize(shapes, seed):
    """Fan-in scaled normal weights for a JAX parameter tree; vectors
    (biases, norm scales, temperatures) small around 0."""
    rng = np.random.default_rng(seed)

    def draw(a):
        n = rng.standard_normal(a.shape).astype(np.float32)
        if len(a.shape) <= 1:
            return 0.05 * n
        return (n / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)

    return jax.tree.map(draw, shapes)


def jax_apply(model, params, x, dtype, mode="off"):
    """The JAX model's output in float32, params and input cast to
    ``dtype``, the fused Restormer kernels in ``mode``, under ``jax.jit``
    (op-by-op dispatch compiles every op on its own, several times slower
    on the CPU)."""
    p = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), params)
    jrf.set_fused_mode(mode)
    try:
        out = jax.jit(model.apply)(p, jnp.asarray(x).astype(dtype))
    finally:
        jrf.set_fused_mode("auto")
    return np.asarray(out.astype(jnp.float32))


def port_pair(name, params, **cfg):
    """The port's model ``name`` in f32 and bf16 with ``params`` carried
    across by ``from_jax`` (strict loads)."""
    m32 = build_model(name, device="cpu", **cfg)
    m32.load_state_dict(from_jax(params), strict=True)
    m16 = build_model(name, device="cpu", dtype=torch.bfloat16, **cfg)
    m16.load_state_dict(m32.state_dict(), strict=True)
    return m32, m16


@pytest.fixture(scope="module")
def tiny():
    """(JAX outputs by (mode, dtype name), params, input, port models);
    the JAX outputs made once (interpret mode takes seconds)."""
    m = jbuild("xrestormer_tiny")
    shapes = jax.eval_shape(lambda: m.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3))))
    params = randomize(shapes, 1)
    x = np.random.default_rng(2).random((1, *HW, 3), dtype=np.float32)
    outs = {}

    def want(mode, dtype):
        key = (mode, dtype)
        if key not in outs:
            outs[key] = jax_apply(m, params, x, getattr(jnp, dtype), mode)
        return outs[key]

    return want, params, x, port_pair("xrestormer_tiny", params)


# ---------------------------------------------------------------------------
# OCAB


def _ocab_pair(seed):
    dim, heads, dim_head = 16, 2, 8
    jm = JOCAB(dim, 8, 0.5, heads, dim_head)
    x = np.random.default_rng(seed).standard_normal(
        (2, 16, 32, dim)).astype(np.float32)
    params = randomize(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros(x.shape))), seed)["params"]
    # the reference names of the block's spatial_attn
    state = {"qkv.weight": params["qkv"]["Conv_0"]["kernel"]
             .transpose(3, 2, 0, 1),
             "project_out.weight": params["project_out"]["Conv_0"]["kernel"]
             .transpose(3, 2, 0, 1),
             "rel_pos_emb.rel_height": params["rel_height"] * 4,
             "rel_pos_emb.rel_width": params["rel_width"] * 4}
    params = dict(params, rel_height=state["rel_pos_emb.rel_height"],
                  rel_width=state["rel_pos_emb.rel_width"])
    tm = OCAB(dim, 8, 0.5, heads, dim_head)
    tm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in state.items()}, strict=True)
    return jm, {"params": params}, tm, x


def test_ocab_matches_jax_f32():
    """OCAB (8x8 query windows, 12x12 key windows, two heads, the rel-pos
    bias) in f32: measured max-abs error 7.7e-7 of max|ref| 1.6."""
    jm, params, tm, x = _ocab_pair(3)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


def test_ocab_matches_jax_bf16():
    """bf16 with the JAX package's cast points (q scaled in bf16, logits,
    bias, softmax and the product with v in f32, one cast): the port's RMS
    error against its own f32 at most 1.1x the JAX bf16 OCAB's against
    JAX f32 (measured 1.00x), and the two bf16 outputs within one bf16 ulp
    of the largest magnitude in RMS (measured 0.03 ulp)."""
    jm, params, tm, x = _ocab_pair(4)
    j32 = np.asarray(jm.apply(params, jnp.asarray(x)))
    p16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    j16 = np.asarray(jm.apply(p16, jnp.asarray(x).astype(jnp.bfloat16))
                     .astype(jnp.float32))
    t32 = tm(torch.from_numpy(x)).detach().numpy()
    tm16 = OCAB(16, 8, 0.5, 2, 8).to(torch.bfloat16)
    tm16.load_state_dict(tm.state_dict())
    t16 = tm16(torch.from_numpy(x).bfloat16()).detach().float().numpy()
    assert _rms(t16 - t32) <= 1.1 * _rms(j16 - j32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(j32).max())) - 7)
    assert _rms(t16 - j16) <= ulp


# ---------------------------------------------------------------------------
# the whole model


def test_routes(tiny):
    *_, (m32, _) = tiny
    blocks = [m32.encoder_level1[0], m32.encoder_level2[0],
              m32.encoder_level3[0], m32.latent[0]]
    routes = [blk.fused(torch.zeros(1, HW[0] >> i, HW[1] >> i, 8 << i))
              for i, blk in enumerate(blocks)]
    assert routes == [True, False, False, False]


@torch.no_grad()  # a served forward (the model records a graph)
@pytest.mark.parametrize("mode", ["interpret", "off"])
def test_xrestormer_tiny_matches_jax_f32(tiny, mode):
    """At 64x128 the port's level-1 blocks take the fused route (K5, K4,
    OCAB, K4; on the CPU their plain versions) and levels 2-4 the unfused
    one; the JAX model with its fused kernels in interpret mode takes the
    same routes, with them "off" the unfused one everywhere. f32 within
    1e-4 x max|ref| of either (measured 4e-7 and 6e-7 of max|ref| 2.0)."""
    want, _, x, (m32, _) = tiny
    want = want(mode, "float32")
    got = m32(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


@torch.no_grad()  # a served forward (the model records a graph)
@pytest.mark.parametrize("mode", ["interpret", "off"])
def test_xrestormer_tiny_matches_jax_bf16(tiny, mode):
    """bf16 weights and input: the port's RMS error against its own f32 at
    most 1.25x the JAX bf16 model's against JAX f32 (measured 1.00x on
    both JAX routes), and its distance to the JAX bf16 output at most
    1.5x that control in RMS."""
    want, _, x, (m32, m16) = tiny
    j16, j32 = want(mode, "bfloat16"), want(mode, "float32")
    t32 = m32(torch.from_numpy(x)).numpy()
    t16 = m16(torch.from_numpy(x).bfloat16()).float().numpy()
    ctrl = _rms(j16 - j32)
    assert _rms(t16 - t32) <= 1.25 * ctrl
    assert _rms(t16 - j16) <= 1.5 * ctrl


# ---------------------------------------------------------------------------
# names


def test_names_round_trip_through_jax_rules(tiny):
    """The port's state dict, through the JAX importer's xrestormer_rules,
    gives back the JAX tree exactly: the port's names are the
    reference's."""
    _, params, _, (m32, _) = tiny
    back = convert_state_dict({k: v.numpy() for k, v in
                               m32.state_dict().items()}, xrestormer_rules())
    want = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, v in want:
        np.testing.assert_array_equal(np.asarray(got[path]), v,
                                      err_msg=jax.tree_util.keystr(path))


def test_from_jax_detects_xrestormer_before_restormer(tiny):
    """An X-Restormer tree has Restormer's top-level names; from_jax reads
    it as X-Restormer (its blocks' spatial_attn) and not with Restormer's
    renamer, which has no rule for the spatial half."""
    _, params, _, _ = tiny
    sd = from_jax(params)
    assert "encoder_level1.0.spatial_attn.rel_pos_emb.rel_height" in sd
    assert "encoder_level1.0.norm4.body.weight" in sd
    from image_restoration_agent_tpu_torch.convert.from_jax import (
        _restormer_name)
    with pytest.raises(KeyError):
        _restormer_name("encoder_level1_0/spatial_attn/rel_height")


@torch.no_grad()  # a served forward (the model records a graph)
def test_matches_torch_transcription():
    """TXRestormer (tests/test_convert_xrestormer.py, the published
    architecture in torch with the reference's names; window 4, dim_head
    4, two channel and spatial heads at levels 3-4) loads into the port
    with strict=True and gives its output (measured max-abs error 3e-7 of
    max|ref| 1.4)."""
    from test_convert_xrestormer import (BLOCKS, CH_HEADS, DIM, DIM_HEAD,
                                         EXP, OVER, REFINE, SP_HEADS, WS,
                                         TXRestormer)
    torch.manual_seed(0)
    ref = TXRestormer().eval()
    with torch.no_grad():
        for p in ref.parameters():
            if p.ndim == 1:
                p.add_(torch.randn_like(p) * 0.05)
    port = XRestormer(dim=DIM, num_blocks=BLOCKS,
                      num_refinement_blocks=REFINE, channel_heads=CH_HEADS,
                      spatial_heads=SP_HEADS, overlap_ratio=(OVER,) * 4,
                      window_size=WS, spatial_dim_head=DIM_HEAD,
                      ffn_expansion_factor=EXP)
    port.load_state_dict(ref.state_dict(), strict=True)
    x = np.random.default_rng(5).random((1, 32, 32, 3), dtype=np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


@pytest.mark.slow
def test_xrestormer_full_width_matches_jax_f32():
    """The registered ``xrestormer`` (dim 48, blocks 4/6/6/8, 4 refinement,
    channel heads 1/2/4/8, spatial heads 2/2/3/4) at 64x128, level 1 on
    the fused route, against the JAX model's XLA route: f32 within 1e-4 x
    max|ref|."""
    torch.set_num_threads(4)
    m = jbuild("xrestormer")
    params = randomize(jax.eval_shape(lambda: m.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))), 11)
    x = np.random.default_rng(12).random((1, *HW, 3), dtype=np.float32)
    want = jax_apply(m, params, x, jnp.float32, "off")
    m32, _ = port_pair("xrestormer", params)
    got = m32(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)
