"""Port parity for slice 4: ``wmsa`` (K2's logit-scale mode; its plain
version against the JAX package's ``wmsa_pallas`` in interpret mode), K2's
scale argument, DehazeFormer's modules (RLN, the window attention's bias
MLP, DFAttention, DFBlock, SKFusion) and whole ``dehazeformer_tiny``
against the JAX package on its XLA and TPU routes, the DehazeFormer weight
carry-over, the engine route and the 1920x1080 ``dehazeformer_b`` plan of
image_restoration_agent_tpu_torch."""

import contextlib
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from image_restoration_agent_tpu.convert.torch_import import (
    convert_with_drops, dehazeformer_rules)
from image_restoration_agent_tpu.models import build_model as jbuild
from image_restoration_agent_tpu_torch.convert import from_jax
from image_restoration_agent_tpu_torch.models import build_model
from test_convert_dehazeformer import _torch_state_from_flax

jpa = importlib.import_module(
    "image_restoration_agent_tpu.ops.pallas_attention")
jdf = importlib.import_module(
    "image_restoration_agent_tpu.models.dehazeformer")
jwa = importlib.import_module(
    "image_restoration_agent_tpu.ops.window_attention")
tdf = importlib.import_module(
    "image_restoration_agent_tpu_torch.models.dehazeformer")
tsb = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.swin_block")

torch.set_num_threads(1)

# a dehazeformer_tiny variant whose attention level has head width 12 (C
# 24, 2 heads); dehazeformer_tiny's has 16 (C 32, 2 heads)
CFG12 = dict(embed_dims=(8, 16, 24, 16, 8), depths=(1, 1, 2, 1, 1),
             attn_ratio=(0, 0.5, 1.0, 0, 0), num_heads=(1, 2, 2, 1, 1))


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def _close_f32(got, want, scale=1e-5):
    """f32: max-abs error within ``scale`` x max|ref| (1e-5 for a kernel or
    a module, 1e-4 for a whole model: float32 sums in another order)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * float(np.abs(want).max()))


def _ulp_bf16(x):
    """One bfloat16 ulp at each element's magnitude."""
    a = np.maximum(np.abs(np.asarray(x, np.float32)),
                   np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


# ---------------------------------------------------------------------------
# wmsa: K2's logit-scale mode against wmsa_pallas


def _wmsa_inputs(seed, hd, heads, masked):
    """qkv of two images of 2x3 windows (N 64), rpb, and the full shift
    mask."""
    rng = _rng(seed)
    c, n, h, w = hd * heads, 64, 16, 24
    nwb = 2 * (h // 8) * (w // 8)
    qkv = (1.5 * rng.standard_normal((nwb, n, 3 * c))).astype(np.float32)
    rpb = (0.5 * rng.standard_normal((heads, n, n))).astype(np.float32)
    mask = jwa.shift_attention_mask(h, w, 8, 4) if masked else None
    return qkv, rpb, mask


def _wmsa_pallas(qkv, rpb, mask, heads, dtype):
    out = jpa.wmsa_pallas(jnp.asarray(qkv).astype(dtype), jnp.asarray(rpb),
                          None if mask is None else jnp.asarray(mask),
                          num_heads=heads, g=2, interpret=True)
    return _np(out)


@pytest.mark.parametrize("hd", [12, 16])
@pytest.mark.parametrize("heads", [1, 2, 4])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wmsa_matches_wmsa_pallas(hd, heads, masked, dtype):
    """wmsa (on a CPU tensor: wmsa_plain) == wmsa_pallas in interpret mode
    at N 64, head widths 12 and 16: f32 within 1e-5 x max|ref|; bf16 within
    one bf16 ulp of the reference's largest value. (Not of each element's:
    a p that rounds to the neighbouring bf16 value, after an exp that
    differs in its last float32 bit, moves an output that cancels to near
    zero by a few of its own ulps.)"""
    qkv, rpb, mask = _wmsa_inputs(hd + heads, hd, heads, masked)
    want = _wmsa_pallas(qkv, rpb, mask, heads, dtype)
    tdt = getattr(torch, dtype)
    n0 = tsb.wmsa.launches
    got = tsb.wmsa(_t(qkv).to(tdt), _t(rpb), _t(mask), num_heads=heads)
    assert tsb.wmsa.launches == n0  # the CPU path launches nothing
    assert got.dtype == tdt and got.shape == want.shape
    torch.testing.assert_close(got, tsb.wmsa_plain(
        _t(qkv).to(tdt), _t(rpb), _t(mask), num_heads=heads), rtol=0, atol=0)
    if dtype == "float32":
        _close_f32(got.numpy(), want)
    else:
        err = np.abs(got.float().numpy() - want)
        assert err.max() <= _ulp_bf16(np.abs(want).max()), float(err.max())


def _old_window_attention_plain(qkv, rpb, bank, *, num_heads, nwy, nwx,
                                fast, mask=None):
    """K2's plain version as it was before the scale argument."""
    t, c3 = qkv.shape
    c = c3 // 3
    n = rpb.shape[-1]
    hd = c // num_heads
    q, k, v = (qkv.reshape(-1, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
               .float())
    s = q @ k.transpose(-1, -2) + rpb[None]
    if bank is not None:
        s = s.reshape(-1, nwy * nwx, num_heads, n, n) \
            + tsb._bank_per_window(bank, nwy, nwx)[None, :, None]
        s = s.reshape(-1, num_heads, n, n)
    elif mask is not None:
        s = s.reshape(-1, mask.shape[0], num_heads, n, n) \
            + mask[None, :, None]
        s = s.reshape(-1, num_heads, n, n)
    if fast:
        s = s * tsb.LOG2E
    p = tsb._softmax(s, fast).to(qkv.dtype).float()
    o = p @ v
    return o.permute(0, 2, 1, 3).reshape(t, c).to(qkv.dtype)


@pytest.mark.parametrize("form", ["none", "bank", "mask"])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_scale_one_is_bit_identical(form, fast, dtype):
    """window_attention_plain(scale=1.0), what every slice 1-3 caller runs,
    gives the same bits as before the argument."""
    qkv, rpb, mask = _wmsa_inputs(3, 12, 2, True)
    n = 64
    bank = _t(jwa.shift_attention_mask(16, 16, 8, 4).reshape(2, 2, n, n))
    kw = dict(num_heads=2, nwy=2, nwx=3, fast=fast,
              mask=_t(mask) if form == "mask" else None)
    bk = bank if form == "bank" else None
    x = _t(qkv).reshape(-1, qkv.shape[-1]).to(dtype)
    got = tsb.window_attention(x, _t(rpb), bk, **kw, scale=1.0)
    assert torch.equal(got, tsb.window_attention(x, _t(rpb), bk, **kw))
    assert torch.equal(got, _old_window_attention_plain(x, _t(rpb), bk, **kw))


@pytest.mark.parametrize("hd", [12, 16])
def test_logit_scale_matches_tpu_kernel_where_prescaled_q_does_not(hd):
    """bf16, DehazeFormer's head widths. q unscaled with the logit scale
    hd**-0.5 (wmsa) gives wmsa_pallas's bits on at least 99.9% of the
    outputs, within one ulp at the largest magnitude. q pre-scaled by
    hd**-0.5 and rounded to bf16 (the Swin block's form, scale 1): at head
    width 12 rounding q moves each logit by up to 2**-9 of its size, and
    about half of the outputs differ (measured: 50% bit-identical, RMS
    error 100x the logit-scale mode's); at 16 the scale 1/4 is a power of
    two, pre-scaling is exact, and the two forms give the same bits."""
    heads = 2
    qkv, rpb, _ = _wmsa_inputs(5, hd, heads, False)
    want = _wmsa_pallas(qkv, rpb, None, heads, jnp.bfloat16)
    c = hd * heads
    kw = dict(num_heads=heads, nwy=1, nwx=1, fast=False)
    rows = _t(qkv).to(torch.bfloat16).reshape(-1, 3 * c)
    scaled = tsb.window_attention(rows, _t(rpb), None, **kw,
                                  scale=hd ** -0.5)
    pre = rows.clone()
    pre[:, :c] = (pre[:, :c].float() * hd ** -0.5).to(torch.bfloat16)
    prescaled = tsb.window_attention(pre, _t(rpb), None, **kw)
    err_scaled = np.abs(scaled.float().numpy().reshape(want.shape) - want)
    err_pre = np.abs(prescaled.float().numpy().reshape(want.shape) - want)
    assert (err_scaled == 0).mean() >= 0.999
    assert err_scaled.max() <= _ulp_bf16(np.abs(want).max())
    if hd == 16:
        assert torch.equal(prescaled, scaled)
        return
    assert (err_pre == 0).mean() < 0.6, (err_pre == 0).mean()
    assert _rms(err_pre) > 20 * _rms(err_scaled)


# ---------------------------------------------------------------------------
# DehazeFormer modules with the JAX modules' own (carried) parameters


def _jax_params(seed=0, **cfg):
    """JAX DehazeFormer params from its own init, moved off their init
    values (zero biases, unit RLN weights)."""
    m = jbuild("dehazeformer_tiny", **cfg)
    p = jax.tree.map(np.asarray, jax.jit(m.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3))))
    noise = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda a: (a + 0.05 * noise.standard_normal(
        a.shape)).astype(np.float32), p)


@functools.lru_cache(maxsize=4)
def _jax_params_cached(seed, cfg_key):
    return _jax_params(seed, **dict(cfg_key))


def _port(params, dtype=torch.float32, name="dehazeformer_tiny", **cfg):
    m = build_model(name, device="cpu", dtype=dtype, **cfg)
    m.load_state_dict(from_jax(params), strict=True)
    return m


@pytest.fixture(scope="module")
def df12():
    params = _jax_params_cached(0, tuple(sorted(CFG12.items())))
    return params, _port(params, **CFG12)


@contextlib.contextmanager
def _route(monkeypatch, route):
    """The JAX package's "xla" route, or its "tpu" route run on the CPU:
    ``jax.default_backend()`` says "tpu" and ``wmsa_pallas`` runs in
    interpret mode, for the forward only (nothing in the package
    changes)."""
    if route == "xla":
        yield
        return
    orig = jpa.wmsa_pallas
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        m.setattr(jpa, "wmsa_pallas", functools.partial(orig, interpret=True))
        yield


def _blk(params, name):
    return {"params": params["params"][name]}


def test_rln_matches_jax(df12):
    """RLN: the normalized output, rescale and rebias (meta convs on the
    whole-sample std and mean), f32 within 1e-5 x max|ref|."""
    params, m = df12
    x = (3.0 + 2.0 * _rng(10).standard_normal((2, 12, 20, 24))).astype(
        np.float32)
    want = jdf.RLN().apply({"params": params["params"]["layer2_blk0"][
        "norm1"]}, jnp.asarray(x))
    got = m.layer3.blocks[0].norm1(_t(x))
    for g, w in zip(got, want):
        _close_f32(g.detach().numpy(), w)


def test_window_attention_bias_mlp_matches_jax(df12):
    """The continuous relative-position bias (log coordinates through the
    2 -> 256 -> heads MLP) and the window attention it feeds, against
    DFWindowAttention (XLA route), f32 within 1e-5 x max|ref|."""
    params, m = df12
    qkv = _rng(11).standard_normal((6, 64, 72)).astype(np.float32)
    out, state = jdf.DFWindowAttention(24, 8, 2).apply(
        {"params": params["params"]["layer2_blk0"]["attn"]["attn"]},
        jnp.asarray(qkv), capture_intermediates=True)
    bias = np.asarray(state["intermediates"]["meta_fc2"]["__call__"][0])
    wa = m.layer3.blocks[0].attn.attn
    _close_f32(wa.bias(torch.device("cpu")).detach().numpy(),
               bias.transpose(2, 0, 1))
    with torch.no_grad():
        _close_f32(wa(_t(qkv)).detach().numpy(), out)


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("route", ["xla", "tpu"])
def test_dfattention_matches_jax(df12, monkeypatch, shift, route):
    """DFAttention on a 13x21 canvas (not a multiple of the window): the
    reflect pad (``shift`` pixels at the top-left when shifted), windows,
    wmsa, reverse and crop, the 5x5 reflect depthwise conv on V, proj;
    f32 within 1e-5 x max|ref| on both JAX routes."""
    params, m = df12
    x = _rng(12).standard_normal((1, 13, 21, 24)).astype(np.float32)
    blk = "layer2_blk1" if shift else "layer2_blk0"
    with _route(monkeypatch, route):
        want = jdf.DFAttention(24, 2, 8, shift, True).apply(
            {"params": params["params"][blk]["attn"]}, jnp.asarray(x))
    with torch.no_grad():
        got = m.layer3.blocks[1 if shift else 0].attn(_t(x))
    _close_f32(got.detach().numpy(), want)


@pytest.mark.parametrize("attn", [False, True])
def test_dfblock_matches_jax(df12, attn):
    """DFBlock with attention (RLN, shifted attention, rescale/rebias, MLP)
    at level 2, and without (no RLN; V -> 5x5 depthwise conv -> proj, MLP)
    at level 0, f32 within 1e-5 x max|ref|."""
    params, m = df12
    c = 24 if attn else 8
    x = _rng(13).standard_normal((1, 13, 21, c)).astype(np.float32)
    if attn:
        jm, pm, tm = (jdf.DFBlock(24, 2, 4.0, 8, 4, True), "layer2_blk1",
                      m.layer3.blocks[1])
    else:
        jm, pm, tm = (jdf.DFBlock(8, 1, 2.0, 8, 0, False), "layer0_blk0",
                      m.layer1.blocks[0])
    assert (tm.norm1 is not None) is attn
    want = jm.apply(_blk(params, pm), jnp.asarray(x))
    with torch.no_grad():
        _close_f32(tm(_t(x)).detach().numpy(), want)


@pytest.mark.parametrize("n, lo, hi", [(13, 2, 2), (4, 4, 0), (2, 7, 5),
                                        (1, 3, 4)])
def test_reflect_pad_matches_jnp_pad(n, lo, hi):
    """``reflect_pad`` (one gather) is ``jnp.pad(mode="reflect")`` on H and
    W, also where a pad is as wide as the side or wider (a 4-pixel shift
    pad on a 4-high level-2 canvas; a 1-pixel side), which
    ``F.pad(mode="reflect")`` refuses."""
    x = _rng(14).standard_normal((2, n, n + 3, 5)).astype(np.float32)
    want = jnp.pad(jnp.asarray(x), ((0, 0), (lo, hi), (hi, lo), (0, 0)),
                   mode="reflect")
    got = tdf.reflect_pad(_t(x), lo, hi, hi, lo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_skfusion_matches_jax(df12):
    """SKFusion: pooled sum -> bias-free 1x1 MLP -> softmax over the two
    branches -> weighted sum, f32 within 1e-5 x max|ref|."""
    params, m = df12
    rng = _rng(16)
    a, b = (rng.standard_normal((2, 10, 14, 16)).astype(np.float32)
            for _ in range(2))
    want = jdf.SKFusion(16).apply(_blk(params, "fusion1"),
                                  [jnp.asarray(a), jnp.asarray(b)])
    _close_f32(m.fusion1([_t(a), _t(b)]).detach().numpy(), want)


# ---------------------------------------------------------------------------
# whole model


_MODELS = {"tiny-hd16": (), "hd12": tuple(sorted(CFG12.items()))}


@pytest.mark.parametrize("cfg", list(_MODELS))
@pytest.mark.parametrize("route", ["xla", "tpu"])
def test_dehazeformer_tiny_matches_jax_f32(monkeypatch, cfg, route):
    """Whole dehazeformer_tiny (head width 16) and its head-width-12
    variant on a 34x50 input (reflect-padded to 36x52; level 2 at 9x13, not
    a multiple of the window), against the JAX model on its XLA route and
    on its TPU route (wmsa_pallas in interpret mode), f32 within 1e-4 x
    max|ref|."""
    params = _jax_params_cached(1, _MODELS[cfg])
    kw = dict(_MODELS[cfg])
    m = _port(params, **kw)
    x = _rng(17).random((1, 34, 50, 3), dtype=np.float32)
    with _route(monkeypatch, route):
        want = jbuild("dehazeformer_tiny", **kw).apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = m(_t(x)).numpy()
    assert got.shape == (1, 34, 50, 3)
    _close_f32(got, want, 1e-4)


def test_dehazeformer_tiny_bf16_matches_jax_tpu_route(monkeypatch):
    """bf16 dehazeformer_tiny against the JAX bf16 model on its TPU route
    (wmsa_pallas in interpret mode), both with every parameter cast to
    bf16 as the engines cast them. The two round the same function at the
    same cast points, but XLA on the CPU may keep elementwise chains in
    float32 where PyTorch rounds each op, so the port is held, as HAT's
    and Restormer's bf16 models, to 1.25x the JAX bf16 model's RMS error
    against JAX f32 (the rounding control), 1.5x that in RMS distance to
    the JAX bf16 output, and 2x the control's largest error."""
    params = _jax_params_cached(1, ())
    x = _rng(18).random((1, 32, 48, 3), dtype=np.float32)
    p16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    with _route(monkeypatch, "tpu"):
        want = _np(jbuild("dehazeformer_tiny").apply(
            p16, jnp.asarray(x).astype(jnp.bfloat16)))
    ref32 = np.asarray(jbuild("dehazeformer_tiny").apply(params,
                                                         jnp.asarray(x)))
    m16 = _port(params, torch.bfloat16)
    with torch.no_grad():
        got = m16(_t(x).bfloat16()).float().numpy()
    ctrl = want - ref32
    assert np.isfinite(got).all()
    assert _rms(got - ref32) <= 1.25 * _rms(ctrl), (_rms(got - ref32),
                                                   _rms(ctrl))
    assert _rms(got - want) <= 1.5 * _rms(ctrl)
    assert np.abs(got - want).max() <= 2 * np.abs(ctrl).max()


def test_dehazeformer_weights_carry_over():
    """A reference-named state dict built from the JAX tree as
    test_convert_dehazeformer builds it loads into the port with
    strict=True and equals from_jax's; through the JAX rules and back
    (with a reference ``relative_positions`` buffer, dropped) it is
    unchanged. The port holds norm1 only in attention blocks and no
    norm2, as the JAX tree."""
    params = _jax_params_cached(1, ())
    state = _torch_state_from_flax(flatten_dict(params["params"], sep="/"))
    m = build_model("dehazeformer_tiny", device="cpu")
    m.load_state_dict({k: _t(np.ascontiguousarray(v))
                       for k, v in state.items()}, strict=True)
    carried = from_jax(params)
    assert sorted(carried) == sorted(state) == sorted(m.state_dict())
    for k, v in state.items():
        np.testing.assert_array_equal(carried[k].numpy(), v, err_msg=k)
    assert not any(".norm2." in k for k in state)
    # dehazeformer_tiny runs attention at level 2 only (layer3's 2 blocks)
    assert {k.split(".norm1.")[0] for k in state if ".norm1." in k} == {
        "layer3.blocks.0", "layer3.blocks.1"}
    full = dict(state, **{"layer3.blocks.0.attn.attn.relative_positions":
                          np.zeros((64, 64, 2), np.float32)})
    jtree = convert_with_drops(full, dehazeformer_rules(), params)
    back = from_jax(jax.tree.map(np.asarray, jtree))
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


# ---------------------------------------------------------------------------
# engine


@pytest.mark.parametrize("bucket", [8, 128])
def test_engine_dehazeformer_matches_jax_engine(bucket):
    """Engine.restore_array with dehazeformer_tiny at 75x102 (the shape
    bucket pads it to 80x104 or 128x128, symmetric, and the result is
    cropped) against the JAX Engine with the same weights: uint8 pixels
    within one step. The engine drops the reference's relative_positions
    buffers."""
    from image_restoration_agent_tpu.engine import Engine as JEngine
    from image_restoration_agent_tpu_torch.engine import Engine
    params = _jax_params_cached(1, ())
    img = _rng(19).random((75, 102, 3), dtype=np.float32)
    jeng = JEngine(hbm_budget_bytes=1 << 30, shape_bucket=bucket)
    jeng.store._loader = lambda name: params
    want = jeng.restore_array(img, "dehazeformer_tiny").image
    eng = Engine(device="cpu", hbm_budget_bytes=1 << 30, shape_bucket=bucket)
    eng.set_weights("dehazeformer_tiny", dict(
        {k: v.numpy() for k, v in from_jax(params).items()},
        **{"layer3.blocks.1.attn.attn.relative_positions":
           np.zeros((64, 64, 2), np.float32)}))
    res = eng.restore_array(img, "dehazeformer_tiny")
    assert next(iter(eng._pipelines))[1:3] == (-(-75 // bucket) * bucket,
                                               -(-102 // bucket) * bucket)
    assert res.image.shape == want.shape == (75, 102, 3)
    assert res.nonfinite == 0 and not res.random_init
    diff = np.abs(res.image.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


# the 1920x1080 request's attention calls: 4, 8 and 12 blocks at levels
# 0-2, unshifted then shifted (shifted canvases are reflect-padded by 4 at
# the top-left and then to the window)
_B_WINDOWS = [32400, 32776] * 2 + [8160, 8228] * 4 + [2040, 2135] * 6


def test_engine_dehazeformer_b_1080p_plan_matches_jax(monkeypatch):
    """dehazeformer_b at 1920x1080 with Engine(shape_bucket=8): both
    engines serve one whole 1080x1920 canvas, and the port's model makes
    the JAX model's window batches per attention call (24 calls: 4 + 8 +
    12). The plan only: the JAX model is traced abstractly (eval_shape),
    the port's runs on the meta device."""
    from image_restoration_agent_tpu.engine import Engine as JEngine
    from image_restoration_agent_tpu_torch.engine import Engine
    img = np.zeros((1080, 1920, 3), np.float32)

    class Stop(Exception):
        pass

    def capture(name, h, w, tile, overlap, batch, ens):
        raise Stop((h, w, tile))

    jeng = JEngine(hbm_budget_bytes=1 << 30, shape_bucket=8)
    jeng.store._loader = lambda name: {}
    monkeypatch.setattr(jeng, "_pipeline", capture)
    with pytest.raises(Stop) as got:
        jeng.restore_array(img, "dehazeformer_b")
    assert got.value.args[0] == (1080, 1920, None)

    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append(tuple(x.shape))
            return x

    eng = Engine(device="cpu", hbm_budget_bytes=1 << 30, shape_bucket=8)
    monkeypatch.setattr(eng.store, "get", lambda name: Probe())
    eng.restore_array(img, "dehazeformer_b")
    assert seen == [(1, 1080, 1920, 3)]

    jwins = []
    orig = jdf.window_partition

    def record(x, ws):
        out = orig(x, ws)
        jwins.append(out.shape[0])
        return out

    monkeypatch.setattr(jdf, "window_partition", record)
    jm = jbuild("dehazeformer_b")
    jax.eval_shape(lambda x: jm.init_with_output(jax.random.PRNGKey(0), x),
                   jax.ShapeDtypeStruct(seen[0], jnp.float32))

    twins = []

    def plain(qkv, rpb, mask=None, *, num_heads):
        twins.append(qkv.shape[0])
        return tsb.wmsa_plain(qkv, rpb, mask, num_heads=num_heads)

    monkeypatch.setattr(tdf, "wmsa", plain)
    m = build_model("dehazeformer_b", device="cpu").to("meta")
    with torch.no_grad():
        out = m(torch.empty(seen[0], device="meta"))
    assert out.shape == seen[0]
    assert twins == jwins == _B_WINDOWS
