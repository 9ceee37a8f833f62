"""Port parity for RIDCP and its DCNv2: ``modulated_deform_conv`` against
the JAX package's and against the grid_sample transcription ``t_mdcn``,
WarpBlock's verbatim (o1, o2) offset layout, the VectorQuantizer's
indices and tie rule, ``in_conv``, ``_up2``, the GroupNorm ResBlock, whole
``ridcp_tiny`` against the JAX model in f32 and bf16 (batch 2: the
mean-ratio fusion is batch-wide), against the torch transcription
``TRIDCP`` loaded strictly, and the 240 px tile fault pinned in both
packages."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.convert.torch_import import (
    convert_state_dict, ridcp_rules)
from image_restoration_agent_tpu.models import MODEL_REGISTRY as JREG
from image_restoration_agent_tpu.models import build_model as jbuild
from image_restoration_agent_tpu.models import ridcp as jridcp
from image_restoration_agent_tpu.ops.dcn import \
    modulated_deform_conv as jmdcn
from image_restoration_agent_tpu_torch.convert import from_jax
from image_restoration_agent_tpu_torch.engine import Engine
from image_restoration_agent_tpu_torch.models import MODEL_REGISTRY as TREG
from image_restoration_agent_tpu_torch.models import build_model
from image_restoration_agent_tpu_torch.models import ridcp as tridcp
from image_restoration_agent_tpu_torch.ops.dcn import modulated_deform_conv
from test_convert_ridcp import (ALPHA, CQ, E_DIM, MAX_DEPTH, N_E,
                                SWIN_BLOCKS, SWIN_DEPTH, SWIN_HEADS, TRIDCP,
                                TWarp, t_mdcn)
from test_torch_xrestormer import _rms, jax_apply, port_pair, randomize

torch.set_num_threads(1)


def _r(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _dcn_inputs(seed, groups, offset_scale, b=2, h=9, w=11, cin=8, cout=6):
    rng = np.random.default_rng(seed)
    x = _r(rng, b, h, w, cin)
    off = _r(rng, b, h, w, 2 * groups * 9, scale=offset_scale)
    mask = 1 / (1 + np.exp(-_r(rng, b, h, w, groups * 9)))
    wt = _r(rng, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    bias = _r(rng, cout, scale=0.1)
    return x, off, mask.astype(np.float32), wt, bias


# offsets: fractional within a pixel or two, far enough that many corners
# fall outside the image (|offset| ~ 6 on a 9 x 11 canvas), and negative
# integers (every sample on a pixel)
_OFFSETS = {"fractional": 1.5, "out_of_bounds": 6.0, "integer": None}


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("kind", sorted(_OFFSETS))
def test_modulated_deform_conv_matches_jax_and_torch(groups, kind):
    """f32 within 1e-5 x max|ref| of the JAX ``ops/dcn.py`` and of the
    grid_sample transcription ``t_mdcn`` (zero padding, align_corners)."""
    scale = _OFFSETS[kind]
    x, off, mask, wt, bias = _dcn_inputs(3 + groups, groups, scale or 1.0)
    if scale is None:
        off = -np.abs(np.round(off * 2)).astype(np.float32)
    elif kind == "out_of_bounds":
        assert (np.abs(off) > 5).mean() > 0.3
    got = modulated_deform_conv(
        *map(torch.from_numpy, (x, off, mask, wt, bias)),
        deformable_groups=groups).numpy()
    want = np.asarray(jmdcn(*map(jnp.asarray, (x, off, mask, wt, bias)),
                            deformable_groups=groups))
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    ref = t_mdcn(nchw(x), nchw(off), nchw(mask),
                 torch.from_numpy(wt).permute(3, 2, 0, 1),
                 torch.from_numpy(bias), groups)
    np.testing.assert_allclose(got, ref.permute(0, 2, 3, 1).numpy(),
                               atol=tol, rtol=0)


def test_dcn_bf16_input_samples_in_f32():
    """bf16 inputs: coordinates and sampled planes in f32 and the product
    accumulated in f32, as the JAX package promotes them; the result, cast
    to bf16 before the bias, equals the JAX one within one bf16 ulp of
    max|ref|."""
    x, off, mask, wt, bias = _dcn_inputs(9, 4, 1.5)
    bf = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    got = modulated_deform_conv(*map(bf, (x, off, mask, wt, bias)),
                                deformable_groups=4)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jmdcn(*(jnp.asarray(a).astype(jnp.bfloat16)
                              for a in (x, off, mask, wt, bias)),
                            deformable_groups=4).astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, atol=ulp, rtol=0)


def test_warp_block_keeps_the_verbatim_offset_layout():
    """WarpBlock against the torch transcription TWarp (DCNv2Pack's
    cat((o1, o2)) read as (group, tap, [dy, dx])) with per-group offsets
    that differ: within 1e-5 x max|ref|. Reading (o1, o2) as "all dy, all
    dx" instead changes the result."""
    torch.manual_seed(0)
    c = 8
    tw = TWarp(c)
    with torch.no_grad():
        tw.dcn.conv_offset.weight.mul_(8.0)  # offsets of a pixel or more
    port = tridcp.WarpBlock(c)
    port.load_state_dict(tw.state_dict(), strict=True)
    rng = np.random.default_rng(4)
    xv, xr = _r(rng, 1, 12, 16, c), _r(rng, 1, 12, 16, c)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    with torch.no_grad():
        want = tw(nchw(xv), nchw(xr)).permute(0, 2, 3, 1).numpy()
        raw = port.dcn.conv_offset(port.offset(torch.cat(
            [torch.from_numpy(xv), torch.from_numpy(xr)], -1)))
        got = port(torch.from_numpy(xv), torch.from_numpy(xr)).numpy()
    o1, o2, _ = torch.chunk(raw, 3, dim=-1)
    per_group = torch.cat([o1, o2], -1).reshape(1, 12, 16, 4, 18)
    assert (per_group[..., 0, :] - per_group[..., 3, :]).abs().mean() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    dy, dx = torch.cat([o1, o2], -1).reshape(1, 12, 16, 2, 36).unbind(3)
    split = torch.stack([dy, dx], -1).reshape(1, 12, 16, 72)
    m = torch.sigmoid(torch.chunk(raw, 3, dim=-1)[2])
    with torch.no_grad():
        wrong = modulated_deform_conv(
            torch.from_numpy(xv), split, m,
            port.dcn.weight.permute(2, 3, 1, 0), port.dcn.bias,
            deformable_groups=4).numpy()
    assert np.abs(wrong - want).max() > 0.1 * np.abs(want).max()


def _vq_jax(codebook, hq_weight, z):
    vq = jridcp.VectorQuantizer(codebook.shape[0], codebook.shape[1], True,
                                ALPHA)
    zq, idx = vq.apply({"params": {"codebook": jnp.asarray(codebook),
                                   "hq_weight": jnp.asarray(hq_weight)}},
                       jnp.asarray(z))
    return np.asarray(zq), np.asarray(idx)


def _vq_port(codebook, hq_weight, z):
    vq = tridcp.VectorQuantizer(codebook.shape[0], codebook.shape[1], True,
                                ALPHA)
    with torch.no_grad():
        vq.embedding.weight.copy_(torch.from_numpy(codebook))
        vq.weight.copy_(torch.from_numpy(hq_weight))
        zq, idx = vq(torch.from_numpy(z))
    return zq.numpy(), idx.numpy()


def test_vector_quantizer_indices_match_jax():
    """f32 distances reweighted by exp(-21.25 w) with a nonzero HQ prior:
    the same indices as the JAX quantizer, the same codes."""
    rng = np.random.default_rng(5)
    codebook = _r(rng, 64, 16)
    hq = _r(rng, 64, scale=0.02)
    z = codebook[rng.integers(0, 64, (2, 6, 7))] + _r(rng, 2, 6, 7, 16,
                                                       scale=0.7)
    zq, idx = _vq_port(codebook, hq, z)
    jzq, jidx = _vq_jax(codebook, hq, z)
    assert len(np.unique(idx)) > 10
    # the prior decides some of them
    assert (_vq_port(codebook, 0 * hq, z)[1] != idx).any()
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(zq, jzq)


def test_vector_quantizer_ties_take_the_first_index():
    """Codes 3 and 11 equal, with equal priors: a vector on them is a tie,
    and both packages pick 3 (``jnp.argmin`` / ``torch.argmin``)."""
    rng = np.random.default_rng(6)
    codebook = _r(rng, 16, 8)
    codebook[11] = codebook[3]
    hq = np.zeros(16, np.float32)
    z = np.broadcast_to(codebook[3], (1, 2, 3, 8)).copy()
    _, idx = _vq_port(codebook, hq, z)
    _, jidx = _vq_jax(codebook, hq, z)
    assert (idx == 3).all() and (jidx == 3).all()


@pytest.mark.parametrize("hw", [(17, 21), (16, 24)])
def test_in_conv_drops_a_row_and_a_column(hw):
    """Kernel 4 with padding (1, 1), torch semantics: H x W -> (H-1) x
    (W-1) on odd and even sizes, within 1e-5 x max|ref| of Flax's conv."""
    rng = np.random.default_rng(hw[0])
    x = _r(rng, 2, *hw, 3)
    w = _r(rng, 4, 4, 3, 8, scale=0.2)
    b = _r(rng, 8, scale=0.1)
    conv = fnn.Conv(8, (4, 4), padding=[(1, 1), (1, 1)])
    want = np.asarray(conv.apply({"params": {"kernel": jnp.asarray(w),
                                             "bias": jnp.asarray(b)}},
                                 jnp.asarray(x)))
    port = tridcp._Encoder({256: 8, 128: 8, 64: 8}, 256, 0, "silu",
                           (0, 1, 1)).in_conv
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        port.bias.copy_(torch.from_numpy(b))
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, hw[0] - 1, hw[1] - 1, 8) == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


def test_up2_is_jax_nearest():
    x = _r(np.random.default_rng(7), 2, 5, 7, 3)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 14, 3),
                                       method="nearest"))
    np.testing.assert_array_equal(tridcp._up2(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.mark.parametrize("c,act", [(16, "silu"), (64, "leakyrelu")])
def test_gn_resblock_matches_jax(c, act):
    """Pre-activation GroupNorm(min(32, C), eps 1e-6) ResBlock (C 16: 16
    groups of one channel; C 64: 32 of two): f32 within 1e-5 x max|ref|
    of the JAX GNResBlock."""
    rng = np.random.default_rng(c)
    x = _r(rng, 2, 8, 12, c)
    p = {"gn1": {"scale": 1 + _r(rng, c, scale=0.1),
                 "bias": _r(rng, c, scale=0.1)},
         "gn2": {"scale": 1 + _r(rng, c, scale=0.1),
                 "bias": _r(rng, c, scale=0.1)},
         "c1": {"Conv_0": {"kernel": _r(rng, 3, 3, c, c, scale=0.1),
                           "bias": _r(rng, c, scale=0.1)}},
         "c2": {"Conv_0": {"kernel": _r(rng, 3, 3, c, c, scale=0.1),
                           "bias": _r(rng, c, scale=0.1)}}}
    want = np.asarray(jridcp.GNResBlock(c, act=act).apply(
        {"params": jax.tree.map(jnp.asarray, p)}, jnp.asarray(x)))
    port = tridcp.GNResBlock(c, act)
    conv = lambda k: torch.from_numpy(k).permute(3, 2, 0, 1)  # noqa: E731
    port.load_state_dict({
        "conv.0.norm.weight": torch.from_numpy(p["gn1"]["scale"]),
        "conv.0.norm.bias": torch.from_numpy(p["gn1"]["bias"]),
        "conv.3.norm.weight": torch.from_numpy(p["gn2"]["scale"]),
        "conv.3.norm.bias": torch.from_numpy(p["gn2"]["bias"]),
        "conv.2.weight": conv(p["c1"]["Conv_0"]["kernel"]),
        "conv.2.bias": torch.from_numpy(p["c1"]["Conv_0"]["bias"]),
        "conv.5.weight": conv(p["c2"]["Conv_0"]["kernel"]),
        "conv.5.bias": torch.from_numpy(p["c2"]["Conv_0"]["bias"])},
        strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


def test_spec_equals_jax():
    """``ridcp`` and ``ridcp_tiny``: the JAX package's serving specs field
    for field (max_size 1500, fallback tile 240, weight_alpha -21.25)."""
    def fields(spec):
        return {f.name: getattr(spec, f.name)
                for f in dataclasses.fields(spec) if f.name != "build"}
    for name in ("ridcp", "ridcp_tiny"):
        assert fields(TREG[name]) == fields(JREG[name])
    assert TREG["ridcp"].max_size == 1500
    assert TREG["ridcp"].fallback_tile == 240
    assert TREG["ridcp"].config == {"weight_alpha": -21.25}


@pytest.fixture(scope="module")
def tiny():
    """ridcp_tiny's JAX params (GroupNorm scales near 1, so the fusion
    ratio stays moderate), a batch of 2 at 64 x 64, and the port's f32 and
    bf16 models carried across by from_jax."""
    m = jbuild("ridcp_tiny")
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 64, 64, 3))))
    params = randomize(shapes, 3)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 1.0 if "scale" in jax.tree_util.keystr(p) else a,
        params)
    x = np.random.default_rng(8).random((2, 64, 64, 3), dtype=np.float32)
    return m, params, x, port_pair("ridcp_tiny", params)


@torch.no_grad()  # a served forward (the model records a graph)
def test_tiny_matches_jax_f32(tiny):
    """Batch of 2 (the fusion's means run over the batch): f32 within 1e-4
    x max|ref| (measured 1.9e-5 of max|ref| 27: the fusion ratio, about
    1 / mean(warped), magnifies rounding)."""
    m, params, x, (m32, _) = tiny
    want = jax_apply(m, params, x, jnp.float32)
    got = m32(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)
    # each image alone gives other numbers: the mean is batch-wide
    one = m32(torch.from_numpy(x[:1])).numpy()
    assert np.abs(one - got[:1]).max() > 1e-3 * np.abs(want).max()


@torch.no_grad()  # a served forward (the model records a graph)
def test_tiny_matches_jax_bf16(tiny):
    """The port's bf16 RMS error against its own f32 at most 1.5x the JAX
    bf16 model's against JAX f32 (measured 1.13x; the VQ's argmin can
    flip a code on a rounding, and both packages compute its distances in
    f32)."""
    m, params, x, (m32, m16) = tiny
    j32 = jax_apply(m, params, x, jnp.float32)
    j16 = jax_apply(m, params, x, jnp.bfloat16)
    t32 = m32(torch.from_numpy(x)).numpy()
    t16 = m16(torch.from_numpy(x).bfloat16()).float().numpy()
    assert np.isfinite(t16).all()
    assert _rms(t16 - t32) <= 1.5 * _rms(j16 - j32)


def test_names_round_trip_through_jax_rules(tiny):
    """The port's state dict through the JAX importer's ridcp_rules gives
    back the JAX tree exactly: the port's names are the reference's."""
    _, params, _, (m32, _) = tiny
    back = convert_state_dict({k: v.numpy() for k, v in
                               m32.state_dict().items()},
                              ridcp_rules(max_depth=2, swin_blocks=1))
    want = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, v in want:
        np.testing.assert_array_equal(np.asarray(got[path]), v,
                                      err_msg=jax.tree_util.keystr(path))


@torch.no_grad()  # a served forward (the model records a graph)
def test_port_matches_torch_transcription():
    """TRIDCP (``tests/test_convert_ridcp.py``, the published architecture
    in torch) loaded into the port with ``strict=True`` (its
    relative_position_index buffers dropped, as the JAX converter drops
    them): within 1e-4, the JAX conversion test's tolerance."""
    torch.manual_seed(0)
    tm = TRIDCP().eval()
    state = {k: v for k, v in tm.state_dict().items()
             if "relative_position_index" not in k}
    port = tridcp.RIDCP(n_embed=N_E, embed_dim=E_DIM, max_depth=MAX_DEPTH,
                        swin_blocks=SWIN_BLOCKS, swin_depth=SWIN_DEPTH,
                        swin_heads=SWIN_HEADS, weight_alpha=ALPHA,
                        channels=CQ).eval()
    port.load_state_dict(state, strict=True)
    x = np.random.default_rng(9).random((1, 64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_the_240_tile_fault_is_pinned_in_both_packages():
    """The registry's fallback tile (240) reaches the Swin blocks at 60 x
    60, not a multiple of the window 8: the JAX model's window partition
    fails (a TypeError from its reshape), the port raises a ValueError
    that names the fault, directly and through the engine's tile route
    (300 x 500 at tile 240). 256 x 256 works in both."""
    m = jbuild("ridcp_tiny")
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 240, 240, 3))))
    jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 256, 256, 3))))
    port = build_model("ridcp_tiny", device="cpu")
    with pytest.raises(ValueError, match="multiple of the window 8"):
        port(torch.zeros(1, 240, 240, 3))
    img = np.random.default_rng(10).random((300, 500, 3), dtype=np.float32)
    with pytest.raises(ValueError, match="240 px fallback tile"):
        Engine(device="cpu").restore_array(img, "ridcp_tiny", tile=240)
