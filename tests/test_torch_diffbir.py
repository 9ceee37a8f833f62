"""Port parity for DiffBIR (image_restoration_agent_tpu_torch.models.diffbir)
against the JAX package on the CPU: the sampler's schedule and loop with
the JAX draws injected, chunked attention on both routes, the JAX bicubic
resize, the stage-1 SwinIR (pixel-unshuffle 8, x8 nearest+conv head),
every UNet / ControlNet / VAE module, the wavelet fix, whole
``diffbir_tiny`` in f32 (JAX ``PRNGKey(231)`` draws injected) and in bf16
beside a JAX control; the ``T*`` torch
transcriptions of tests/test_convert_diffbir.py loaded strictly; state
dicts round-tripped through the JAX importer's ``diffbir_rules``; the
OpenCLIP empty-prompt context; a reference-style checkpoint loaded
strictly; the JAX bf16 pipeline's wavelet-fix fault pinned."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.convert.torch_import import (
    convert_with_drops, diffbir_rules)
from image_restoration_agent_tpu.convert.torch_import import \
    extract_empty_context as jextract
from image_restoration_agent_tpu.models import swinir as jswinir
from image_restoration_agent_tpu.models.diffbir import pipeline as jpipe
from image_restoration_agent_tpu.models.diffbir import sampler as jsampler
from image_restoration_agent_tpu.models.diffbir import unet as junet
from image_restoration_agent_tpu.models.diffbir import vae as jvae
from image_restoration_agent_tpu.ops import chunked_attention as jchunk
from image_restoration_agent_tpu_torch.convert import (
    diffbir_checkpoint_state, extract_empty_context, from_jax)
from image_restoration_agent_tpu_torch.core.resize import resize_bicubic_jax
from image_restoration_agent_tpu_torch.models import build_model
from image_restoration_agent_tpu_torch.models.diffbir import (
    pipeline as tpipe, sampler as tsampler, unet as tunet, vae as tvae)
from image_restoration_agent_tpu_torch.models.swinir import SwinIR
from image_restoration_agent_tpu_torch.ops import chunked_attention as tchunk
from test_convert_diffbir import (ATTN_LV, CM, CTX, HC, MC, NRB, VCH, VCM,
                                  ZC, TControlNet, TUNet, TVAEDecoder,
                                  TVAEEncoder, _nchw, _nhwc)

torch.set_num_threads(1)

TOL = 1e-5  # f32 checks: max |error| <= TOL * max |reference|


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rms(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


def _randomize(tree, seed):
    """Random weights for a JAX parameter tree: fan-in scaled kernels
    (the zero convs and the UNet's ``out_conv`` too, so a wrong tap order
    shows), norm scales near 1, small biases, ``empty_context`` ~ N(0,
    0.02)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        n = rng.standard_normal(a.shape).astype(np.float32)
        if name in ("scale", "norm_scale", "norm2_scale"):
            return 1.0 + 0.1 * n
        if name in ("empty_context", "relative_position_bias_table"):
            return 0.02 * n
        if len(a.shape) <= 1:
            return 0.05 * n
        return (n / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _jinit(module, *args, seed=0, method=None):
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *args, method=method))
    return _randomize(shapes, seed)["params"]


def _carry(tree: dict, prefix: str) -> dict:
    """The port's state dict for the part of a DiffBIR-shaped JAX tree
    under ``prefix`` (``from_jax`` detects DiffBIR by ``control_model``)."""
    full = {"control_model": {}, "diffusion_model": {}, **tree}
    sd = from_jax(full)
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# sampler


@pytest.mark.parametrize("sections", [[1], [2], [5], [50], [10, 15], "3,7"])
def test_space_timesteps_matches_jax(sections):
    assert tsampler.space_timesteps(1000, sections) == \
        jsampler.space_timesteps(1000, sections)


@pytest.mark.parametrize("steps", [2, 5, 50])
def test_make_schedule_matches_jax_exactly(steps):
    want = jsampler.SpacedSampler().make_schedule(steps)
    got = tsampler.SpacedSampler().make_schedule(steps)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _jax_draws(key, shape, n):
    """The sampler's draws from ``key``: x_T, then one per step, split as
    the JAX sampler splits its key."""
    draws = []
    for _ in range(n + 1):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return draws


def test_sample_with_injected_draws_matches_jax():
    shape, n = (1, 6, 10, 4), 5

    def eps(x, t):
        return 0.3 * x + 1e-3 * t.astype(x.dtype)[:, None, None, None]

    want = jsampler.SpacedSampler().sample(eps, shape, jax.random.PRNGKey(3),
                                           num_steps=n)
    draws = [_t(d) for d in _jax_draws(jax.random.PRNGKey(3), shape, n)]
    got = tsampler.SpacedSampler().sample(
        lambda x, t: 0.3 * x + 1e-3 * t.float()[:, None, None, None],
        shape, num_steps=n, noise=draws)
    assert _rel(got, want) <= TOL


def test_sample_tiled_matches_jax():
    shape, n = (1, 12, 16, 4), 3

    def eps(x, t):
        return 0.2 * x + 0.1 * jnp.sin(x)

    want = jsampler.SpacedSampler().sample_tiled(
        eps, shape, jax.random.PRNGKey(4), num_steps=n, tile=8, stride=4)
    draws = [_t(d) for d in _jax_draws(jax.random.PRNGKey(4), shape, n)]
    got = tsampler.SpacedSampler().sample_tiled(
        lambda x, t: 0.2 * x + 0.1 * torch.sin(x), shape, num_steps=n,
        tile=8, stride=4, noise=draws)
    assert _rel(got, want) <= TOL


def test_sampler_generator_is_deterministic():
    s = tsampler.SpacedSampler()
    runs = [s.sample(lambda x, t: 0.1 * x, (1, 4, 4, 4), num_steps=3,
                     generator=torch.Generator().manual_seed(231))
            for _ in range(2)]
    assert torch.equal(*runs) and torch.isfinite(runs[0]).all()


# ---------------------------------------------------------------------------
# chunked attention


@pytest.mark.parametrize("shape,chunk", [((2, 3, 96, 16), 32),
                                         ((1, 100, 24), 48),
                                         ((1, 2, 64, 8), 2048)])
def test_chunked_attention_matches_jax(shape, chunk):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    want = jchunk.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), 0.3, chunk=chunk)
    got = tchunk.chunked_attention(_t(q), _t(k), _t(v), 0.3, chunk=chunk)
    assert _rel(got, want) <= TOL
    assert tchunk._largest_divisor_leq(shape[-2], chunk) == \
        jchunk._largest_divisor_leq(shape[-2], chunk)
    assert tchunk.DENSE_SCORE_LIMIT == jchunk.DENSE_SCORE_LIMIT


def test_chunked_attention_is_bit_identical_to_its_dense_path():
    """Each chunk sees all of K, so a row does not depend on its chunk: one
    chunk (the dense f32 path) and 8 give the same bits."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 4, 256, 32, generator=g) for _ in range(3))
    dense = tchunk.chunked_attention(q, k, v, 32 ** -0.5, chunk=256)
    assert torch.equal(tchunk.chunked_attention(q, k, v, 32 ** -0.5,
                                                chunk=32), dense)


# ---------------------------------------------------------------------------
# resize, stage-1 SwinIR


@pytest.mark.parametrize("hw", [(6, 8), (7, 5)])
def test_resize_bicubic_jax_matches_jax_at_x4(hw):
    h, w = hw
    x = np.random.default_rng(2).random((1, h, w, 3), dtype=np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, 4 * h, 4 * w, 3),
                            method="bicubic")
    got = resize_bicubic_jax(_t(x), 4 * h, 4 * w)
    assert _rel(got, want) <= TOL


def _swinir_pair(cfg, seed, x):
    jm = jswinir.SwinIR(**cfg)
    params = _jinit(jm, jnp.asarray(x), seed=seed)
    tm = _load(SwinIR(**cfg), from_jax(params))
    return jm, params, tm


def test_swinir_unshuffle8_nearest_conv_x8_matches_jax():
    """DiffBIR's stage-1 form at a tiny width: pixel-unshuffle 8 in (192
    channels into ``conv_first.1``), three ``conv_up`` stages out."""
    cfg = dict(embed_dim=16, depths=(2,), num_heads=(2,), window_size=8,
               upscale=8, upsampler="nearest+conv", unshuffle_scale=8,
               img_range=1.0, num_feat=16)
    x = np.random.default_rng(3).random((1, 128, 128, 3), dtype=np.float32)
    jm, params, tm = _swinir_pair(cfg, 3, x)
    assert tm.conv_first[1].weight.shape[1] == 192
    assert [n for n, _ in tm.named_children() if n.startswith("conv_up")] \
        == ["conv_up1", "conv_up2", "conv_up3"]
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_t(x))
    assert got.shape == (1, 128, 128, 3)
    assert _rel(got, want) <= TOL


# ---------------------------------------------------------------------------
# UNet and ControlNet modules (diffbir_tiny widths)


def test_timestep_embedding_matches_jax():
    """cos first. XLA's and torch's float32 exp differ by one ulp on some
    frequencies, and t up to 999 scales that into the argument: the bound
    is t_max times the largest frequency difference, plus one f32 ulp of
    the cos and sin."""
    t = np.array([0, 1, 17, 500, 999], np.int32)
    for dim in (32, 320):
        want = np.asarray(junet.timestep_embedding(jnp.asarray(t), dim))
        got = tunet.timestep_embedding(torch.from_numpy(t), dim).numpy()
        half = dim // 2
        fj = np.asarray(jnp.exp(-np.log(10000.0) * jnp.arange(
            half, dtype=jnp.float32) / half))
        ft = torch.exp(-np.log(10000.0) * torch.arange(
            half, dtype=torch.float32) / half).numpy()
        np.testing.assert_array_max_ulp(ft, fj, maxulp=1)
        bound = 999 * float(np.abs(ft - fj).max()) + 2 ** -23
        assert np.abs(got - want).max() <= bound
        if dim == 32:
            assert _rel(got, want) <= TOL


def _emb(rng, n=128):
    return rng.standard_normal((1, n)).astype(np.float32)


@pytest.mark.parametrize("cin,cout", [(64, 64), (96, 32)])
def test_resblock_matches_jax(cin, cout):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 8, 12, cin)).astype(np.float32)
    e = _emb(rng)
    jm = junet.ResBlock(cout)
    p = _jinit(jm, jnp.asarray(x), jnp.asarray(e), seed=5)
    tm = _load(tunet.ResBlock(cin, cout, 128), _carry(
        {"diffusion_model": {"mid_res1": p}},
        "model.diffusion_model.middle_block.0."))
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(e))
    with torch.no_grad():
        got = tm(_t(x), _t(e))
    assert _rel(got, want) <= TOL


def _attn_tree(p):
    return {"diffusion_model": {"mid_attn": {"block0": p}}}


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("chunked", [False, True])
def test_cross_attention_matches_jax(cross, chunked, monkeypatch):
    """Self and cross attention, on the dense route and (the score limit
    set to 0 in both packages) the chunked one."""
    if chunked:
        monkeypatch.setattr(junet, "DENSE_SCORE_LIMIT", 0)
        monkeypatch.setattr(tunet, "DENSE_SCORE_LIMIT", 0)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 96, 64)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, 48)).astype(np.float32) if cross \
        else None
    jm = junet.CrossAttention(4, 16)
    args = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if cross else ())
    p = _jinit(jm, *args, seed=6)
    tm = _load(tunet.CrossAttention(64, 48 if cross else 64, 4, 16), _carry(
        _attn_tree({"attn1": p}),
        "model.diffusion_model.middle_block.1.transformer_blocks.0.attn1."))
    want = jm.apply({"params": p}, *args)
    with torch.no_grad():
        got = tm(_t(x), None if ctx is None else _t(ctx))
    assert _rel(got, want) <= TOL


def test_transformer_block_matches_jax():
    """LayerNorm eps 1e-6 and the tanh GELU in GEGLU (Flax's defaults)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 40, 64)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, 48)).astype(np.float32)
    jm = junet.TransformerBlock(4, 16)
    p = _jinit(jm, jnp.asarray(x), jnp.asarray(ctx), seed=7)
    tm = _load(tunet.TransformerBlock(64, 48, 4, 16), _carry(
        _attn_tree(p),
        "model.diffusion_model.middle_block.1.transformer_blocks.0."))
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        got = tm(_t(x), _t(ctx))
    assert _rel(got, want) <= TOL


def test_spatial_transformer_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 6, 10, 64)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, 48)).astype(np.float32)
    jm = junet.SpatialTransformer(4, 16)
    p = _jinit(jm, jnp.asarray(x), jnp.asarray(ctx), seed=8)
    tm = _load(tunet.SpatialTransformer(64, 48, 16), _carry(
        {"diffusion_model": {"mid_attn": p}},
        "model.diffusion_model.middle_block.1."))
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        got = tm(_t(x), _t(ctx))
    assert _rel(got, want) <= TOL


_UCFG = dict(model_channels=32, num_head_channels=16)


@functools.lru_cache(maxsize=None)
def _unet_pair(seed=9):
    """JAX UNetModel + ControlNet at diffbir_tiny's widths (channel_mult
    (1, 2, 4, 4), context 64) with random weights, carried to the port."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 16, 24, 4)).astype(np.float32)
    hint = rng.standard_normal((1, 16, 24, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, 64)).astype(np.float32)
    t = np.array([321], np.int32)
    ju, jc = junet.UNetModel(**_UCFG), junet.ControlNet(**_UCFG)
    pc = _jinit(jc, *map(jnp.asarray, (x, hint, t, ctx)), seed=seed)
    taps = jax.jit(jc.apply)({"params": pc},
                             *map(jnp.asarray, (x, hint, t, ctx)))
    pu = _jinit(ju, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                seed=seed + 1)
    tree = {"diffusion_model": pu, "control_model": pc}
    tu = _load(tunet.UNetModel(**_UCFG, context_dim=64),
               _carry(tree, "model.diffusion_model."))
    tc = _load(tunet.ControlNet(**_UCFG, context_dim=64),
               _carry(tree, "control_model."))
    return (ju, pu, jc, pc, tu, tc, (x, hint, t, ctx),
            [np.asarray(a) for a in taps])


def test_controlnet_matches_jax_with_nonzero_zero_convs():
    _, _, jc, pc, _, tc, (x, hint, t, ctx), want = _unet_pair()
    assert all(np.abs(np.asarray(pc[f"zero{i}"]["conv"]["kernel"])).max()
               > 0 for i in range(12))
    with torch.no_grad():
        got = tc(_t(x), _t(hint), torch.from_numpy(t), _t(ctx))
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


def test_unet_with_control_taps_matches_jax():
    """The taps consumed in reverse order (the middle tap first, then one a
    skip), with non-zero zero convs and out_conv."""
    ju, pu, _, _, tu, _, (x, hint, t, ctx), taps = _unet_pair()
    apply = jax.jit(ju.apply)
    want = apply({"params": pu}, jnp.asarray(x), jnp.asarray(t),
                 jnp.asarray(ctx), control=[jnp.asarray(a) for a in taps])
    plain = apply({"params": pu}, jnp.asarray(x), jnp.asarray(t),
                  jnp.asarray(ctx))
    with torch.no_grad():
        got = tu(_t(x), torch.from_numpy(t), _t(ctx),
                 control=[_t(a) for a in taps])
    assert _rel(got, want) <= TOL
    assert _rel(plain, want) > 1e-2  # the taps change the output


# ---------------------------------------------------------------------------
# VAE, condition encoder, wavelet fix


@pytest.mark.parametrize("chunked", [False, True])
def test_vae_encode_decode_matches_jax(chunked, monkeypatch):
    """The encoder (taming pad-then-VALID downsample) and decoder at
    diffbir_tiny's widths, the mid attention dense and chunked."""
    if chunked:
        monkeypatch.setattr(jvae, "DENSE_SCORE_LIMIT", 0)
        monkeypatch.setattr(tvae, "DENSE_SCORE_LIMIT", 0)
    x = np.random.default_rng(10).random((1, 48, 64, 3), dtype=np.float32)
    jm = jvae.AutoencoderKL(ch=32)
    p = _jinit(jm, jnp.asarray(x), seed=10)
    tm = _load(tvae.AutoencoderKL(ch=32),
               _carry({"first_stage_model": p}, "first_stage_model."))
    z = jax.jit(functools.partial(jm.apply, method=jvae.AutoencoderKL.encode))(
        {"params": p}, jnp.asarray(x))
    dec = jax.jit(functools.partial(jm.apply,
                                    method=jvae.AutoencoderKL.decode))(
        {"params": p}, z)
    with torch.no_grad():
        tz = tm.encode(_t(x))
        tdec = tm.decode(_t(z))
    assert tz.shape == (1, 6, 8, 4)
    assert _rel(tz, z) <= TOL
    assert _rel(tdec, dec) <= TOL


def test_cond_encoder_matches_jax():
    x = np.random.default_rng(11).random((1, 32, 48, 3), dtype=np.float32)
    jm = jvae.CondEncoder(ch=32)
    p = _jinit(jm, jnp.asarray(x), seed=11)
    tm = _load(tvae.CondEncoder(ch=32),
               _carry({"cond_encoder": p}, "cond_encoder."))
    want = jm.apply({"params": p}, jnp.asarray(x) * 2.0 - 1.0)
    with torch.no_grad():
        got = tm(_t(x) * 2.0 - 1.0)
    assert _rel(got, want) <= TOL


def test_jax_bf16_wavelet_fault_is_pinned():
    """The reference's fault: under bf16 weights the JAX pipeline's clean
    image (``style``) is bf16 while the decoder's output (``content``) is
    float32, and its wavelet blur's float32 kernel against the bf16 image
    makes ``conv_general_dilated`` refuse the mix (``pipeline.py:40-45``,
    reached from ``:155``). The port runs the fix in float32."""
    rng = np.random.default_rng(18)
    content = jnp.asarray(rng.random((1, 16, 16, 3), dtype=np.float32))
    style = content.astype(jnp.bfloat16)
    with pytest.raises(TypeError, match="same dtypes"):
        jpipe.wavelet_color_fix(content, style)
    got = tpipe.wavelet_color_fix(_t(content), _t(content, torch.bfloat16))
    assert got.dtype == torch.float32


def test_wavelet_color_fix_matches_jax():
    rng = np.random.default_rng(12)
    content = rng.random((1, 40, 48, 3), dtype=np.float32)
    style = rng.random((1, 40, 48, 3), dtype=np.float32)
    want = jpipe.wavelet_color_fix(jnp.asarray(content), jnp.asarray(style))
    got = tpipe.wavelet_color_fix(_t(content), _t(style))
    assert _rel(got, want) <= TOL
    for r in (1, 4):
        assert _rel(tpipe.wavelet_blur(_t(content), r),
                    jpipe.wavelet_blur(jnp.asarray(content), r)) <= TOL


# ---------------------------------------------------------------------------
# reference names: the T* transcriptions, the JAX importer, a checkpoint


_TCFG = dict(model_channels=MC, channel_mult=CM, num_res_blocks=NRB,
             attention_ds=tuple(2 ** lv for lv in ATTN_LV),
             num_head_channels=HC, context_dim=CTX)


def test_port_loads_the_torch_transcriptions_strictly():
    """TUNet / TControlNet / the taming VAE / the cond encoder of
    tests/test_convert_diffbir.py load into the port with ``strict=True``
    and agree at that file's atol (2e-4; 2e-3 for the decoder there). The
    transcriptions use exact GELU and LayerNorm eps 1e-5 where the port
    follows the JAX package (tanh GELU, eps 1e-6)."""
    torch.manual_seed(0)
    tu, tc = TUNet().eval(), TControlNet().eval()
    pu = _load(tunet.UNetModel(**_TCFG), tu.state_dict())
    pc = _load(tunet.ControlNet(**_TCFG), tc.state_dict())
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 8, 8, ZC)).astype(np.float32)
    hint = rng.standard_normal((1, 8, 8, ZC)).astype(np.float32)
    ctx = rng.standard_normal((1, 5, CTX)).astype(np.float32)
    t = torch.tensor([321])
    with torch.no_grad():
        control = tc(_nchw(x), _nchw(hint), t, torch.from_numpy(ctx))
        want = _nhwc(tu(_nchw(x), t, torch.from_numpy(ctx),
                        control=list(control)))
        got = pu(_t(x), t, _t(ctx), control=pc(_t(x), _t(hint), t, _t(ctx)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)

    torch.manual_seed(1)
    enc, dec = TVAEEncoder().eval(), TVAEDecoder().eval()
    quant, post = torch.nn.Conv2d(2 * ZC, 2 * ZC, 1), torch.nn.Conv2d(ZC, ZC,
                                                                      1)
    sd = {**{f"encoder.{k}": v for k, v in enc.state_dict().items()},
          **{f"decoder.{k}": v for k, v in dec.state_dict().items()},
          **{f"quant_conv.{k}": v for k, v in quant.state_dict().items()},
          **{f"post_quant_conv.{k}": v for k, v in
             post.state_dict().items()}}
    vae = _load(tvae.AutoencoderKL(ch=VCH, ch_mult=VCM), sd)
    cond = _load(tvae.CondEncoder(ch=VCH, ch_mult=VCM), {
        k: v for k, v in sd.items() if k.startswith(("encoder.",
                                                      "quant_conv."))})
    xi = np.random.default_rng(2).standard_normal((1, 16, 16, 3)).astype(
        np.float32)
    with torch.no_grad():
        mean = quant(enc(_nchw(xi)))[:, :ZC]
        want_z = _nhwc(mean) * 0.18215
        want_dec = _nhwc(dec(post(mean)))
        got_z = vae.encode(_t(xi))
        got_dec = vae.decode(got_z)
        got_hint = cond(_t(xi))
    np.testing.assert_allclose(got_z.numpy(), want_z, atol=2e-4)
    np.testing.assert_allclose(got_dec.numpy(), want_dec, atol=2e-3)
    np.testing.assert_allclose(got_hint.numpy(), want_z, atol=2e-4)


def test_state_dict_round_trips_through_the_jax_diffbir_rules():
    """The port's diffbir_tiny state dict (the reference checkpoint's
    names) through the JAX importer's ``diffbir_rules`` and back through
    ``from_jax``: every tensor equal. ``empty_context`` has no checkpoint
    name (the importer computes it) and is carried beside."""
    tm = build_model("diffbir_tiny", device="cpu", seed=3)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    ctx = sd.pop("empty_context")
    # the importer's rules as compiled patterns: ``re``'s cache holds 512,
    # fewer than the rules, and recompiling each made this take minutes
    rules = [(re.compile(p), t, f) for p, t, f in diffbir_rules()]
    tree = convert_with_drops(sd, rules)
    tree = jax.tree.map(np.asarray, tree)
    back = from_jax({**tree, "empty_context": ctx})
    assert sorted(back) == sorted(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert torch.equal(back[k], v), k


def _clip_state(width=64, heads=2, layers=3, vocab=60, ctx_len=8, seed=16):
    """A small OpenCLIP text stack's ``cond_stage_model`` weights."""
    rng = np.random.default_rng(seed)
    p = "cond_stage_model.model."

    def r(*s, scale=0.2):
        return (scale * rng.standard_normal(s)).astype(np.float32)

    st = {p + "token_embedding.weight": r(vocab, width),
          p + "positional_embedding": r(ctx_len, width, scale=0.01),
          p + "ln_final.weight": 1 + r(width, scale=0.05),
          p + "ln_final.bias": r(width, scale=0.05)}
    for i in range(layers):
        rb = f"{p}transformer.resblocks.{i}."
        st.update({rb + "ln_1.weight": 1 + r(width, scale=0.05),
                   rb + "ln_1.bias": r(width, scale=0.05),
                   rb + "ln_2.weight": 1 + r(width, scale=0.05),
                   rb + "ln_2.bias": r(width, scale=0.05),
                   rb + "attn.in_proj_weight": r(3 * width, width),
                   rb + "attn.in_proj_bias": r(3 * width),
                   rb + "attn.out_proj.weight": r(width, width),
                   rb + "attn.out_proj.bias": r(width),
                   rb + "mlp.c_fc.weight": r(4 * width, width),
                   rb + "mlp.c_fc.bias": r(4 * width),
                   rb + "mlp.c_proj.weight": r(width, 4 * width),
                   rb + "mlp.c_proj.bias": r(width)})
    return st


def test_extract_empty_context_equals_jax():
    st = _clip_state()
    for pen in (True, False):
        want = jextract(st, context_length=8, sot=58, eot=59,
                        penultimate=pen)
        got = extract_empty_context(st, context_length=8, sot=58, eot=59,
                                    penultimate=pen)
        np.testing.assert_array_equal(got, want)


def test_reference_checkpoint_loads_strictly():
    """A checkpoint holding what the reference's does beside the weights
    (the OpenCLIP ``cond_stage_model``, the LDM schedule buffers, the EMA
    shadows, SwinIR's index and mask buffers) loads into ``diffbir_tiny``
    with ``strict=True`` after ``diffbir_checkpoint_state``, with
    ``empty_context`` computed from its ``cond_stage_model``."""
    tm = build_model("diffbir_tiny", device="cpu", seed=4)
    ckpt = {k: v.numpy() for k, v in tm.state_dict().items()
            if k != "empty_context"}
    clip = _clip_state(width=64, vocab=49408)  # the real SOT / EOT ids
    ckpt.update(clip)
    sched = np.linspace(1e-4, 2e-2, 10, dtype=np.float32)
    for k in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
              "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
              "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
              "posterior_variance", "posterior_log_variance_clipped",
              "posterior_mean_coef1", "lvlb_weights", "logvar"):
        ckpt[k] = sched
    ckpt["scale_factor"] = np.float32(0.18215)
    ckpt["model_ema.decay"] = np.float32(0.9999)
    ckpt["model_ema.diffusion_modelinput_blocks00weight"] = ckpt[
        "model.diffusion_model.input_blocks.0.0.weight"]
    blk = "preprocess_model.layers.0.residual_group.blocks.0."
    ckpt[blk + "attn.relative_position_index"] = np.zeros((64, 64),
                                                          np.int64)
    ckpt[blk + "attn_mask"] = np.zeros((4, 64, 64), np.float32)
    sd = diffbir_checkpoint_state(ckpt, context_length=8)
    fresh = build_model("diffbir_tiny", device="cpu", seed=5)
    fresh.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(
        fresh.empty_context.detach().numpy()[0],
        jextract(clip, context_length=8).astype(np.float32))
    assert torch.equal(fresh.control_model.zero_convs[3][0].weight,
                       tm.control_model.zero_convs[3][0].weight)
