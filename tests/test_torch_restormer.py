"""Port parity for Restormer: the LayerNorm variants, gates and MDTA ops,
the fused blocks' plain versions (against the JAX package's Pallas kernels
in interpret mode), the shape rule, whole restormer_tiny, the weight
carry-over and the engine's whole-image route of
image_restoration_agent_tpu_torch."""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.convert.torch_import import (
    convert_state_dict, restormer_rules)
from image_restoration_agent_tpu.models import build_model as jbuild
from image_restoration_agent_tpu_torch.convert import from_jax
from image_restoration_agent_tpu_torch.core.tiling import tiled_apply
from image_restoration_agent_tpu_torch.models import (MODEL_REGISTRY,
                                                      build_model)
from image_restoration_agent_tpu_torch.models.restormer import Restormer
from image_restoration_agent_tpu_torch.offline import (GOLDEN_ROOT,
                                                       fill_tensor,
                                                       load_golden, psnr)

# the ops packages re-export functions under their modules' names
jrf = importlib.import_module(
    "image_restoration_agent_tpu.ops.restormer_fused")
jln = importlib.import_module("image_restoration_agent_tpu.ops.layernorm")
jgates = importlib.import_module("image_restoration_agent_tpu.ops.gates")
jmdta = importlib.import_module("image_restoration_agent_tpu.ops.mdta")
trf = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.restormer_fused")
tln = importlib.import_module("image_restoration_agent_tpu_torch.ops.layernorm")
tgates = importlib.import_module("image_restoration_agent_tpu_torch.ops.gates")
tmdta = importlib.import_module("image_restoration_agent_tpu_torch.ops.mdta")

torch.set_num_threads(1)

B, H, W, C = 1, 16, 128, 24     # the JAX package's fused-block test shape
HID = int(C * 2.66)             # 63: a ragged hidden width


def _rng(seed):
    return np.random.default_rng(seed)


def _r(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _bf16_ulp(ref: np.ndarray) -> float:
    """One bfloat16 ulp at the largest magnitude of ``ref``."""
    return 2.0 ** (np.floor(np.log2(float(np.abs(ref).max()))) - 7)


def _ln(rng, kind, c=C):
    if kind == "none":
        return None
    if kind == "biasfree":
        return (1 + _r(rng, c, scale=0.1),)
    return (1 + _r(rng, c, scale=0.1), _r(rng, c, scale=0.1))


# ---------------------------------------------------------------------------
# ops


@pytest.mark.parametrize("kind", ["with_bias", "bias_free", "2d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norms_match_jax(kind, dtype):
    rng = _rng(0)
    x = _r(rng, 2, 5, 7, C, scale=3.0) + 1.5
    w, b = 1 + _r(rng, C, scale=0.1), _r(rng, C, scale=0.1)
    xj, xt = jnp.asarray(x).astype(dtype), _t(x).to(getattr(torch, dtype))
    if kind == "with_bias":
        want = jln.layer_norm_with_bias(xj, w, b)
        got = tln.layer_norm_with_bias(xt, _t(w), _t(b))
    elif kind == "bias_free":
        want = jln.layer_norm_bias_free(xj, w)
        got = tln.layer_norm_bias_free(xt, _t(w))
    else:
        want = jln.layer_norm_2d(xj, w, b)
        got = tln.layer_norm_2d(xt, _t(w), _t(b))
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == xt.dtype
    # bf16: both round float32 values that differ in the last bits of the
    # statistics, which can move a value across a bf16 rounding boundary
    tol = 1e-5 if dtype == "float32" else _bf16_ulp(want)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_gates_match_jax():
    x = _r(_rng(1), 2, 4, 6, 2 * C, scale=2.0)
    np.testing.assert_allclose(
        tgates.gated_gelu(_t(x)).numpy(),
        np.asarray(jgates.gated_gelu(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(
        tgates.simple_gate(_t(x)).numpy(),
        np.asarray(jgates.simple_gate(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_mdta_attention_matches_jax(heads):
    rng = _rng(2)
    q, k, v = (_r(rng, 2, 6, 10, C) for _ in range(3))
    k[0, ..., :2] = 0.0  # a zero channel: the 1e-12 norm floor
    temp = (rng.random(heads) + 0.5).astype(np.float32)
    want = jmdta.mdta_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(temp), heads)
    got = tmdta.mdta_attention(_t(q), _t(k), _t(v), _t(temp), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# fused blocks: plain versions against the TPU kernels in interpret mode


def _gdfn_inputs(seed, ln_kind, bias):
    rng = _rng(seed)
    x = _r(rng, B, H, W, C)
    ln = _ln(rng, ln_kind)
    w = (_r(rng, C, 2 * HID, scale=C ** -0.5),
         _r(rng, 2 * HID, scale=0.1) if bias else None,
         _r(rng, 9, 2 * HID, scale=1 / 3),
         _r(rng, 2 * HID, scale=0.1) if bias else None,
         _r(rng, HID, C, scale=HID ** -0.5),
         _r(rng, C, scale=0.1) if bias else None)
    return x, ln, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("ln_kind", ["none", "biasfree", "withbias"])
def test_gdfn_block_plain_matches_pallas(ln_kind, bias, dtype):
    """f32 (erf GELU) within 1e-5 x max|ref|; bf16 fast math (tanh GELU)
    within one bf16 ulp at the output's largest magnitude: both round the
    same float32 values at the same points, summed in another order."""
    x, ln, (wi, bi, wd, bd, wo, bo) = _gdfn_inputs(10, ln_kind, bias)
    fast = dtype == "bfloat16"
    want = jrf.gdfn_block_pallas(
        jnp.asarray(x).astype(dtype),
        None if ln is None else tuple(map(jnp.asarray, ln)),
        jnp.asarray(wi).reshape(1, 1, C, 2 * HID).astype(dtype), _j(bi),
        jnp.asarray(wd).reshape(3, 3, 1, 2 * HID), _j(bd),
        jnp.asarray(wo).reshape(1, 1, HID, C).astype(dtype), _j(bo),
        fastmath=fast, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tl = None if ln is None else tuple(map(_t, ln))
    tw = (_t(wi), _t(bi), _t(wd), _t(bd), _t(wo), _t(bo))
    got = trf.gdfn_block_plain(_t(x).to(tdt), tl, *tw, fast=fast)
    assert got.dtype == tdt and got.shape == x.shape
    tol = (1e-5 * np.abs(want).max() if dtype == "float32"
           else _bf16_ulp(want))
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    # the wrapper on a CPU tensor runs the plain version on the weights'
    # kernel form
    form = trf.gdfn_weights(tl, *tw, tdt)
    torch.testing.assert_close(trf.gdfn_block(_t(x).to(tdt), form,
                                              fast=fast), got)


def _mdta_inputs(seed, ln_kind, bias, heads):
    rng = _rng(seed)
    x = _r(rng, B, H, W, C)
    ln = _ln(rng, ln_kind)
    w = (_r(rng, C, 3 * C, scale=C ** -0.5),
         _r(rng, 3 * C, scale=0.1) if bias else None,
         _r(rng, 9, 3 * C, scale=1 / 3),
         _r(rng, 3 * C, scale=0.1) if bias else None,
         _r(rng, C, C, scale=C ** -0.5),
         _r(rng, C, scale=0.1) if bias else None,
         (rng.random(heads) + 0.5).astype(np.float32))
    return x, ln, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("ln_kind", ["none", "biasfree", "withbias"])
@pytest.mark.parametrize("heads", [1, 2])
def test_mdta_block_plain_matches_pallas(heads, ln_kind, bias, dtype):
    """Tolerances as for GDFN."""
    x, ln, (wq, bq, wd, bd, wp, bp, temp) = _mdta_inputs(20, ln_kind, bias,
                                                        heads)
    want = jrf.mdta_block_pallas(
        jnp.asarray(x).astype(dtype),
        None if ln is None else tuple(map(jnp.asarray, ln)),
        jnp.asarray(wq).reshape(1, 1, C, 3 * C).astype(dtype), _j(bq),
        jnp.asarray(wd).reshape(3, 3, 1, 3 * C), _j(bd),
        jnp.asarray(wp).reshape(1, 1, C, C), _j(bp), jnp.asarray(temp),
        num_heads=heads, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tl = None if ln is None else tuple(map(_t, ln))
    tw = (_t(wq), _t(bq), _t(wd), _t(bd))
    got = trf.mdta_block_plain(_t(x).to(tdt), tl, *tw, _t(wp), _t(bp),
                               _t(temp), heads)
    assert got.dtype == tdt and got.shape == x.shape
    tol = (1e-5 * np.abs(want).max() if dtype == "float32"
           else _bf16_ulp(want))
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    form = trf.mdta_weights(tl, *tw, _t(wp), _t(bp), _t(temp), heads, tdt)
    torch.testing.assert_close(trf.mdta_block(_t(x).to(tdt), form), got)


def test_mdta_front_outputs():
    """The front's gram is the per-head diagonal blocks of q^T k over q and k
    cast to the input dtype; ssq the float32 sums of squares."""
    x, ln, (wq, bq, wd, bd, *_rest) = _mdta_inputs(21, "withbias", True, 2)
    xt = _t(x).to(torch.bfloat16)
    v, gram, ssq = trf.mdta_front_plain(xt, tuple(map(_t, ln)), _t(wq),
                                        _t(bq), _t(wd), _t(bd), 2)
    assert v.dtype == torch.bfloat16 and v.shape == x.shape
    assert gram.shape == (B, 2, C // 2, C // 2) and ssq.shape == (B, 2, C)
    assert gram.dtype == ssq.dtype == torch.float32
    y = trf._apply_ln(xt, tuple(map(_t, ln)))
    d = trf._one_by_one_dw(y, _t(wq), _t(bq), _t(wd), _t(bd))
    q, k = d[..., :C].reshape(-1, C), d[..., C:2 * C].reshape(-1, C)
    full = q.bfloat16().float().t() @ k.bfloat16().float()
    h = C // 2
    torch.testing.assert_close(gram[0, 1], full[h:, h:], rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(ssq[0, 0], q.square().sum(0), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("groups", [2, 3])
def test_kernel_forms_interleave_chunks(groups):
    """Column ci*groups*CHUNK + g*CHUNK + j of a kernel form holds channel
    ci*CHUNK + j of group g, zero past the group's width."""
    f = 45
    w = torch.randn(5, groups * f)
    form = trf._interleave(w, groups)
    nch = -(-f // trf.CHUNK)
    assert form.shape == (5, nch * groups * trf.CHUNK)
    for g in range(groups):
        for c in range(nch * trf.CHUNK):
            col = (c // trf.CHUNK * groups + g) * trf.CHUNK + c % trf.CHUNK
            want = w[:, g * f + c] if c < f else torch.zeros(5)
            torch.testing.assert_close(form[:, col], want, rtol=0, atol=0)
    gk = trf.gdfn_weights(None, torch.randn(8, 2 * 21), None,
                          torch.randn(9, 2 * 21), None, torch.randn(21, 8),
                          None, torch.bfloat16)
    assert gk.w_in.dtype == gk.w_out.dtype == torch.bfloat16
    assert gk.w_dw.dtype == torch.float32
    assert gk.w_out.shape == (trf.CHUNK, 8) and not gk.w_out[21:].any()


def test_shape_rule_matches_jax():
    """The port routes blocks by the JAX package's own rule."""
    shapes = [(h, w, c, f) for h, w in [(768, 1280), (384, 640), (192, 320),
                                        (96, 160), (80, 80), (320, 320),
                                        (16, 128), (16, 1024), (720, 1280),
                                        (100, 256), (8, 2048), (64, 120)]
              for c, f in [(48, 144), (48, 254), (96, 510), (384, 2042),
                           (384, 1152), (8, 24)]]
    got = [trf.restormer_fused_supported(*s) for s in shapes]
    assert got == [jrf.restormer_fused_supported(*s) for s in shapes]
    assert trf.restormer_fused_supported(96, 160, 384, 2042)
    assert not trf.restormer_fused_supported(80, 80, 192, 1020)


# ---------------------------------------------------------------------------
# the whole model


@pytest.fixture(scope="module")
def tiny():
    """restormer_tiny params from the JAX package's own init, carried across
    with convert.from_jax into the port (strict load)."""
    x = jnp.zeros((1, 16, 128, 3), jnp.float32)
    m_j = jbuild("restormer_tiny")
    jrf.set_fused_mode("off")
    try:
        params = m_j.init(jax.random.PRNGKey(0), x)
    finally:
        jrf.set_fused_mode("auto")
    m_t = build_model("restormer_tiny", device="cpu")
    m_t.load_state_dict(from_jax(jax.tree.map(np.asarray, params)),
                        strict=True)
    return params, m_t


def _jax_tiny(params, x, mode, dtype):
    m_j = jbuild("restormer_tiny")
    p = jax.tree.map(lambda a: a.astype(dtype), params)
    jrf.set_fused_mode(mode)
    try:
        out = m_j.apply(p, jnp.asarray(x).astype(dtype))
    finally:
        jrf.set_fused_mode("auto")
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("mode", ["interpret", "off"])
@pytest.mark.parametrize("hw", [(64, 1024), (16, 256)],
                         ids=["all-levels-fused", "levels-3-4-unfused"])
def test_restormer_tiny_matches_jax_f32(tiny, hw, mode):
    """64x1024: every level takes the fused route (level 4 is 8x128); at
    16x256 levels 3 and 4 (64 and 32 wide) take the unfused one, in the port
    as in the JAX package. f32 within 1e-4 of either JAX route."""
    params, m_t = tiny
    x = _rng(4).random((1, *hw, 3), dtype=np.float32)
    routes = [blk.fused(torch.zeros(1, hw[0] >> i, hw[1] >> i, 8 << i))
              for i, blk in enumerate([m_t.encoder_level1[0],
                                       m_t.encoder_level2[0],
                                       m_t.encoder_level3[0],
                                       m_t.latent[0]])]
    assert routes == ([True] * 4 if hw == (64, 1024)
                      else [True, True, False, False])
    want = _jax_tiny(params, x, mode, jnp.float32)
    with torch.no_grad():  # a served forward
        got = m_t(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("mode", ["interpret", "off"])
@pytest.mark.parametrize("hw", [(64, 1024), (16, 256)],
                         ids=["all-levels-fused", "levels-3-4-unfused"])
def test_restormer_tiny_matches_jax_bf16(tiny, hw, mode):
    """bf16 weights and input, against the JAX bf16 model on its fused
    route ("interpret", the same cast points) and its unfused XLA route
    ("off", other cast points). bf16 rounding through 10 blocks leaves an
    RMS error against the f32 model of ~0.5% of the output's range, and
    the two JAX routes differ from each other by as much: so the port's
    error against f32 is held to 1.25x the JAX bf16 model's, and its
    distance to the JAX bf16 output to 1.5x (two independent roundings of
    one function differ by ~sqrt(2) x either's error), in RMS, and to 2x
    in the largest element."""
    params, m_t = tiny
    x = _rng(5).random((1, *hw, 3), dtype=np.float32)
    want = _jax_tiny(params, x, mode, jnp.bfloat16)
    ref32 = _jax_tiny(params, x, "off", jnp.float32)
    m16 = build_model("restormer_tiny", device="cpu", dtype=torch.bfloat16)
    m16.load_state_dict(m_t.state_dict(), strict=True)
    with torch.no_grad():  # a served forward
        got = m16(torch.from_numpy(x).bfloat16()).float().numpy()

    def rms(a):
        return float(np.sqrt(np.mean(a ** 2)))

    ctrl = want - ref32
    assert rms(got - ref32) <= 1.25 * rms(ctrl)
    assert rms(got - want) <= 1.5 * rms(ctrl)
    assert np.abs(got - want).max() <= 2 * np.abs(ctrl).max()


def test_restormer_weights_round_trip_through_jax_rules():
    """reference dict -> convert_state_dict(restormer_rules) -> from_jax
    gives back the reference dict, for a model with biases (the golden's
    has none)."""
    names = build_model("restormer_tiny", device="cpu",
                        bias=True).state_dict()
    state = {k: fill_tensor(k, tuple(v.shape), 5, 0.3)
             for k, v in names.items()}
    jtree = convert_state_dict(state, restormer_rules())
    back = from_jax(jax.tree.map(np.asarray, jtree))
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_from_jax_output_matches(tiny):
    """JAX params carried across give the JAX model's output, with biases
    and a BiasFree LayerNorm (the restormer_tiny fixture has neither)."""
    cfg = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
               heads=(1, 1, 2, 2), ffn_expansion_factor=2.0)
    from image_restoration_agent_tpu.models.restormer import (
        Restormer as JRestormer)
    x = _rng(6).random((1, 16, 128, 3), dtype=np.float32)
    m_j = JRestormer(**cfg, use_bias=True, bias_free_ln=True)
    params = m_j.init(jax.random.PRNGKey(3), jnp.asarray(x))
    params = jax.tree.map(
        lambda a: a + 0.05 * np.random.default_rng(7).standard_normal(
            a.shape).astype(np.float32), jax.tree.map(np.asarray, params))
    m_t = Restormer(**cfg, bias=True, bias_free_ln=True)
    m_t.load_state_dict(from_jax(params), strict=True)
    jrf.set_fused_mode("interpret")
    try:
        want = np.asarray(m_j.apply(params, jnp.asarray(x)))
    finally:
        jrf.set_fused_mode("auto")
    with torch.no_grad():  # a served forward
        got = m_t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_golden_spec_names_match_restormer():
    """Restormer's parameter names and shapes are exactly the reference
    state-dict list of the golden (so it loads with strict=True)."""
    spec = json.loads((GOLDEN_ROOT / "restormer_synth" / "spec.json")
                      .read_text())
    with torch.device("meta"):
        model = Restormer(**MODEL_REGISTRY["restormer"].config)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(s) for k, s in spec["state"]}


# ---------------------------------------------------------------------------
# engine


def test_engine_restore_matches_jax_engine(tiny):
    """Engine.restore_array on restormer_tiny at a non-multiple size (shape
    bucket, pad, whole-image forward, crop, uint8) against the JAX Engine
    with the same weights: uint8 pixels within one step."""
    from image_restoration_agent_tpu.engine import Engine as JEngine
    from image_restoration_agent_tpu_torch.engine import Engine
    params, m_t = tiny
    img = _rng(8).random((30, 140, 3), dtype=np.float32)
    jeng = JEngine(hbm_budget_bytes=1 << 30)
    jeng.store._loader = lambda name: params
    want = jeng.restore_array(img, "restormer_tiny").image
    eng = Engine(device="cpu", hbm_budget_bytes=1 << 30)
    eng.set_weights("restormer_tiny", {k: v.numpy()
                                       for k, v in m_t.state_dict().items()})
    res = eng.restore_array(img, "restormer_tiny")
    assert res.image.shape == want.shape == (30, 140, 3)
    assert res.image.dtype == np.uint8 and res.nonfinite == 0
    diff = np.abs(res.image.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("hw,tile", [((720, 1280), (768, 1280)),
                                     ((1000, 1600), (256, 256))],
                         ids=["720p-whole", "over-max-size-tiled"])
def test_engine_restormer_route(monkeypatch, hw, tile):
    """restormer: tile="auto" serves 1280x720 whole on the 768x1280 canvas
    (shape bucket 128, whole_pad_multiple 64) and an image past max_size
    1536 as 256 tiles, as the JAX engine routes them."""
    from image_restoration_agent_tpu_torch.engine import Engine
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append(tuple(x.shape))
            return x

    eng = Engine(device="cpu", hbm_budget_bytes=1 << 30)
    monkeypatch.setattr(eng.store, "get", lambda name: Probe())
    img = _rng(9).random((*hw, 3), dtype=np.float32)
    res = eng.restore_array(img, "restormer")
    assert res.image.shape == (*hw, 3)
    assert seen and all(s[1:] == (*tile, 3) for s in seen)
    if tile == (768, 1280):
        assert seen == [(1, 768, 1280, 3)]
    np.testing.assert_array_equal(
        res.image, np.round(np.clip(img, 0, 1) * 255).astype(np.uint8))


@pytest.mark.slow
def test_golden_restormer_f32_cpu():
    """The port's f32 CPU path on the real-geometry synthetic golden
    (Restormer dim 48, blocks 4/6/6/8, 320x320: levels 1-2 on the fused
    route's plain version, levels 3-4 unfused) reaches the recorded PSNR
    within 0.1 dB against the independent torch reference output."""
    torch.set_num_threads(4)
    g = load_golden(GOLDEN_ROOT / "restormer_synth")
    model = build_model("restormer", device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in g["state"].items()}, strict=True)
    out = tiled_apply(model, torch.from_numpy(g["input"]), tile=None,
                      pad_multiple=8, pad_kind="reflect")
    db = psnr(np.clip(out.numpy(), 0, 1), g["expected"])
    assert db >= g["spec"]["psnr_db"] - 0.1, db
