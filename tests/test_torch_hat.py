"""Port parity for slice 3: K6 roll2d, K2 at N 256 and in full-mask mode,
HAT's half block (swin_attn_block) and the partition route's wmsa_block
(plain versions against the JAX package's Pallas kernels in interpret
mode), rpi_oca, OCAB and CAB, whole hat_tiny through both HAB routes, the
HAT weight carry-over and the HAT engine route of
image_restoration_agent_tpu_torch."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.convert.torch_import import (
    convert_with_drops, hat_rules)
from image_restoration_agent_tpu.models import build_model as jbuild
from image_restoration_agent_tpu_torch.convert import from_jax
from image_restoration_agent_tpu_torch.models import build_model
from image_restoration_agent_tpu_torch.offline import fill_tensor

jpa = importlib.import_module(
    "image_restoration_agent_tpu.ops.pallas_attention")
jsw = importlib.import_module("image_restoration_agent_tpu.models.swinir")
jhat = importlib.import_module("image_restoration_agent_tpu.models.hat")
jwa = importlib.import_module(
    "image_restoration_agent_tpu.ops.window_attention")
thm = importlib.import_module("image_restoration_agent_tpu_torch.models.hat")
troll = importlib.import_module("image_restoration_agent_tpu_torch.ops.roll2d")
tsb = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.swin_block")
twa = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.window_attention")

torch.set_num_threads(1)

C, HEADS = 16, 2


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def _bf16_ulp(ref) -> float:
    """One bfloat16 ulp at the largest magnitude of ``ref``."""
    return 2.0 ** (np.floor(np.log2(float(np.abs(ref).max()))) - 7)


def _close_f32(got, want, scale=1e-5):
    """f32: max-abs error within ``scale`` x max|ref| (1e-5 for a kernel,
    1e-4 for a whole model: float32 sums in another order)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * float(np.abs(want).max()))


def _within_bf16_control(got, want, ref32):
    """bf16, the rule of slices 1-2: the port and the JAX package round the
    same function at their own cast points (the port folds the attention
    scale, and in fast mode log2 e, elsewhere than the TPU kernels), so
    the port's RMS distance to the JAX bf16 output is held to the JAX
    bf16 output's own RMS error against f32 (the rounding control), and
    its largest element to the control's largest plus one bf16 ulp."""
    got, want, ref32 = (np.asarray(a, np.float32) for a in (got, want,
                                                             ref32))
    ctrl = want - ref32
    assert np.isfinite(got).all()
    assert _rms(got - want) <= _rms(ctrl), (_rms(got - want), _rms(ctrl))
    assert np.abs(got - want).max() <= np.abs(ctrl).max() + _bf16_ulp(
        want), (np.abs(got - want).max(), np.abs(ctrl).max())


def _block_weights(rng, c=C, heads=HEADS, ws=16):
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


def _port_params(wts, dtype=torch.float32, ws=16):
    return tsb.prepare_swin_params(**{k: _t(v) for k, v in wts.items()},
                                   num_heads=HEADS, ws=ws, dtype=dtype)


def _jax_args(wts, ws=16):
    """(ln_w, ln_b, wqkv, bqkv, wproj, bproj, rpb) in the TPU kernels'
    layout."""
    n = ws * ws
    idx = jwa.relative_position_index(ws).reshape(-1)
    rpb = wts["rpb_table"][idx].reshape(n, n, HEADS).transpose(2, 0, 1)
    return tuple(map(jnp.asarray, (
        wts["norm1_w"], wts["norm1_b"], wts["qkv_w"].T, wts["qkv_b"],
        wts["proj_w"].T, wts["proj_b"], rpb)))


def _bank(ws):
    n = ws * ws
    return twa.shift_attention_mask(2 * ws, 2 * ws, ws, ws // 2).reshape(
        2, 2, n, n)


# ---------------------------------------------------------------------------
# kernels' plain versions


@pytest.mark.parametrize("ws", [8, 16])
@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roll2d_matches_roll2d_pallas(ws, sign, dtype):
    x = _rng(0).standard_normal((2, 2 * ws, 3 * ws, 5)).astype(np.float32)
    shift = sign * (ws // 2)
    want = jpa.roll2d_pallas(jnp.asarray(x).astype(dtype), shift, ws=ws,
                             interpret=True)
    got = troll.roll2d(_t(x).to(getattr(torch, dtype)), shift, ws=ws)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    with pytest.raises(ValueError):
        troll.roll2d(_t(x), shift + 1, ws=ws)


# HAT's 144 px f32 canvas (exploration's one-box tree) and its training
# canvas, 8 x 32 x 32 at C 180 (the x4 model's LR crop of 128)
@pytest.mark.parametrize("shape", [(1, 144, 144, 180), (8, 32, 32, 180)])
@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roll2d_matches_roll2d_pallas_at_hat_canvases(shape, sign, dtype):
    """K6's plain version bit-equal to roll2d_pallas at HAT's small f32
    canvases (its 96 px tree and its training crop), window 16, shift +-8,
    both dtypes."""
    x = _rng(2).standard_normal(shape).astype(np.float32)
    want = jpa.roll2d_pallas(jnp.asarray(x).astype(dtype), sign * 8, ws=16,
                             interpret=True)
    got = troll.roll2d_plain(_t(x).to(getattr(torch, dtype)), sign * 8, 16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("ws", [8, 16])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_full_mask_matches_wmsa_pallas(ws, masked):
    """K2's plain version in full-mask mode (exact) == wmsa_pallas, the
    TPU's window-MHSA core, at N 64 and 256; f32 within 1e-5 x max|ref|."""
    rng = _rng(1)
    n, h, w = ws * ws, 2 * ws, 3 * ws
    nwb = 2 * (h // ws) * (w // ws)
    qkv = rng.standard_normal((nwb, n, 3 * C)).astype(np.float32)
    rpb = (0.5 * rng.standard_normal((HEADS, n, n))).astype(np.float32)
    mask = jwa.shift_attention_mask(h, w, ws, ws // 2) if masked else None
    want = jpa.wmsa_pallas(jnp.asarray(qkv), jnp.asarray(rpb),
                           None if mask is None else jnp.asarray(mask),
                           num_heads=HEADS, g=2, interpret=True)
    q = qkv.copy()
    q[..., :C] *= (C // HEADS) ** -0.5  # K2 takes q pre-scaled
    got = tsb.window_attention(_t(q).reshape(-1, 3 * C), _t(rpb), None,
                               num_heads=HEADS, nwy=1, nwx=1, fast=False,
                               mask=_t(mask))
    _close_f32(got.numpy().reshape(nwb, n, C), want)


def _strip(x, wts, dc, mode, dtype):
    bank = jnp.asarray(_bank(16)) if dc else None
    return jpa.swin_strip_pallas(
        jnp.asarray(x).astype(dtype), *_jax_args(wts), None,
        num_heads=HEADS, ws=16, dc=dc, mask_bank=bank, mlp=None,
        attn_mode=mode, fastmath=mode == "paired2r", interpret=True)


@pytest.mark.parametrize("dc", [0, -8])
@pytest.mark.parametrize("kind", ["exact", "fast", "bf16"])
def test_swin_attn_block_matches_strip_kernel(dc, kind):
    """HAT's call: swin_strip_pallas at window 16 (N 256) with mlp=None, in
    interpret mode. exact: f32 paired2 against fast=False; fast: the
    paired2r fast math in f32 against fast=True (both within 1e-5 x
    max|ref|); bf16: paired2r in bf16 against the port's bf16, held to the
    rounding control (JAX bf16 against JAX f32 paired2r)."""
    rng = _rng(2)
    x = rng.standard_normal((1, 32, 64, C)).astype(np.float32)
    wts = _block_weights(rng)
    bank = _t(_bank(16)) if dc else None
    kw = dict(num_heads=HEADS, ws=16, dc=dc, mask_bank=bank,
              fast=kind != "exact")
    if kind != "bf16":
        want = _strip(x, wts, dc, "paired2" if kind == "exact"
                      else "paired2r", jnp.float32)
        got = tsb.swin_attn_block(_t(x), _port_params(wts), **kw)
        _close_f32(got.numpy(), want)
        return
    want = _strip(x, wts, dc, "paired2r", jnp.bfloat16).astype(jnp.float32)
    ref32 = _strip(x, wts, dc, "paired2r", jnp.float32)
    got = tsb.swin_attn_block(_t(x).bfloat16(),
                              _port_params(wts, torch.bfloat16), **kw)
    assert got.dtype == torch.bfloat16
    _within_bf16_control(got.float().numpy(), want, ref32)


def test_swin_attn_block_plain_is_its_launch_sequence():
    """The CPU path's swin_attn_block_plain (roll, partition, reverse) ==
    the launch sequence's row maps (K1 gather, K2, K1 scatter) run through
    the kernels' plain versions, at an odd window count per row."""
    rng = _rng(3)
    x = _t(rng.standard_normal((2, 32, 48, C)).astype(np.float32))
    p = _port_params(_block_weights(rng))
    b, h, w, c = x.shape
    geom = (b, h, w, 16, -8)
    xt = x.reshape(-1, c)
    qkv = tsb.token_linear_plain(xt, p.wqkv, p.bqkv, ln=(p.ln1_w, p.ln1_b),
                                 geom=geom, a_map=tsb.GATHER)
    a = tsb.window_attention_plain(qkv, p.rpb, _t(_bank(16)),
                                   num_heads=HEADS, nwy=h // 16,
                                   nwx=w // 16, fast=False)
    seq = tsb.token_linear_plain(a, p.wproj, p.bproj, res=xt, geom=geom,
                                 r_map=tsb.GATHER, o_map=tsb.SCATTER,
                                 out_dtype=x.dtype).reshape(b, h, w, c)
    got = tsb.swin_attn_block_plain(x, p, num_heads=HEADS, ws=16, dc=-8,
                                    mask_bank=_t(_bank(16)), fast=True)
    _close_f32(got.numpy(), seq.numpy())


@pytest.mark.parametrize("ws", [8, 16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wmsa_block_matches_jax_kernel(ws, masked, dtype):
    """wmsa_block (the partition route) == wmsa_block_pallas in interpret
    mode at N 64 and 256, mask on and off: f32 within 1e-5 x max|ref|,
    bf16 held to the rounding control."""
    rng = _rng(4)
    n, h, w = ws * ws, 2 * ws, 3 * ws
    nwb = 2 * (h // ws) * (w // ws)
    x = rng.standard_normal((nwb, n, C)).astype(np.float32)
    wts = _block_weights(rng, ws=ws)
    mask = jwa.shift_attention_mask(h, w, ws, ws // 2) if masked else None

    def jax_block(dt):
        out = jpa.wmsa_block_pallas(
            jnp.asarray(x).astype(dt), *_jax_args(wts, ws),
            None if mask is None else jnp.asarray(mask), num_heads=HEADS,
            g=2, interpret=True)
        return np.asarray(out.astype(jnp.float32))

    tdt = getattr(torch, dtype)
    got = tsb.wmsa_block(_t(x).to(tdt), _port_params(wts, tdt, ws),
                         num_heads=HEADS, mask=_t(mask))
    assert got.dtype == tdt and got.shape == x.shape
    if dtype == "float32":
        _close_f32(got.numpy(), jax_block(jnp.float32))
    else:
        _within_bf16_control(got.float().numpy(), jax_block(jnp.bfloat16),
                             jax_block(jnp.float32))


# ---------------------------------------------------------------------------
# HAT modules


@pytest.mark.parametrize("ws,owin", [(8, 12), (16, 24), (4, 6)])
def test_rpi_oca_matches_jax(ws, owin):
    np.testing.assert_array_equal(thm.rpi_oca(ws, owin),
                                  jhat.rpi_oca(ws, owin))


@functools.lru_cache(maxsize=4)
def _jax_hat_cached(seed, ws):
    return _jax_hat(seed, window_size=ws, depths=(2,), num_heads=(2,))


def _jax_hat(seed=0, **cfg):
    """JAX hat_tiny params from its own init, moved off their init values
    (zero biases, unit norms), with the two norm1 copies of each HAB made
    equal as one reference tensor makes them."""
    m = jbuild("hat_tiny", attention_impl="xla", **cfg)
    x = jnp.zeros((1, 32, 32, 3))
    p = jax.tree.map(np.asarray, jax.jit(m.init)(jax.random.PRNGKey(seed),
                                                 x))
    noise = np.random.default_rng(seed + 100)
    p = jax.tree.map(lambda a: (a + 0.05 * noise.standard_normal(
        a.shape)).astype(np.float32), p)
    for layer in p["params"].values():
        for name, blk in layer.items():
            if name.startswith("hab"):
                blk["norm1"]["scale"] = blk["attn"]["norm_scale"]
                blk["norm1"]["bias"] = blk["attn"]["norm_bias"]
    return p


@pytest.fixture(scope="module")
def tiny():
    params = _jax_hat()
    m_t = build_model("hat_tiny", device="cpu")
    m_t.load_state_dict(from_jax(params), strict=True)
    return params, m_t


def test_ocab_and_cab_match_jax(tiny):
    """OCAB (overlapping windows, wraparound rpi) and the CAB branch, each
    with the JAX module's own params, in f32 within 1e-5 x max|ref|."""
    params, m_t = tiny
    x = _rng(5).standard_normal((2, 16, 24, C)).astype(np.float32)
    p0 = params["params"]["layer0"]
    want = jhat.OCAB(C, 8, 0.5, HEADS).apply({"params": p0["ocab"]},
                                            jnp.asarray(x))
    got = m_t.layers[0].residual_group.overlap_attn(_t(x))
    _close_f32(got.detach().numpy(), want)
    want = jhat.ChannelAttentionConv(C, 2, 8).apply(
        {"params": p0["hab0"]["conv_block"]}, jnp.asarray(x))
    got = m_t.layers[0].residual_group.blocks[0].conv_block(_t(x))
    _close_f32(got.detach().numpy(), want)


# the canvases put HAT's blocks on each route: at most 384 wide (strip),
# or wider with no strip chunk width (partition: 392 = 8 x 49 at window 8,
# 464 = 16 x 29 at window 16)
_ROUTES = [(8, (16, 24), True), (8, (16, 392), False), (16, (32, 48), True),
           (16, (32, 464), False)]


@pytest.mark.parametrize("ws,hw,strip", _ROUTES,
                         ids=["ws8-strip", "ws8-partition", "ws16-strip",
                              "ws16-partition"])
@torch.no_grad()  # a served forward (the model records a graph)
def test_hat_tiny_matches_jax_f32(ws, hw, strip):
    """Whole hat_tiny (one RHAG of depth 2, so a HAB shifts) at window 8
    and 16 through both HAB routes, against the JAX model's XLA path in
    f32 within 1e-4 x max|ref|."""
    cfg = dict(window_size=ws, depths=(2,), num_heads=(2,))
    params = _jax_hat_cached(1, ws)
    m_t = build_model("hat_tiny", device="cpu", **cfg)
    m_t.load_state_dict(from_jax(params), strict=True)
    blk = m_t.layers[0].residual_group.blocks[1]
    assert blk.strip(torch.zeros(1, *hw, C)) is strip
    x = _rng(6).random((1, *hw, 3), dtype=np.float32)
    want = np.asarray(jax.jit(jbuild("hat_tiny", attention_impl="xla",
                                     **cfg).apply)(params, jnp.asarray(x)))
    got = m_t(_t(x)).numpy()
    _close_f32(got, want, 1e-4)


@torch.no_grad()  # a served forward (the model records a graph)
def test_hat_tiny_bf16_matches_jax_strip_kernels(tiny, monkeypatch):
    """bf16 hat_tiny against the JAX bf16 model on its TPU route (strip
    kernel, roll2d_pallas, in interpret mode): held, as Restormer's bf16
    model, to 1.25x the JAX bf16 model's RMS error against f32, 1.5x in
    RMS distance to it, and 2x its largest error."""
    params, m_t = tiny
    for name in ("swin_strip_pallas", "wmsa_block_pallas",
                 "mlp_block_pallas"):
        monkeypatch.setattr(jsw, name, functools.partial(
            getattr(jpa, name), interpret=True))
    monkeypatch.setattr(jpa, "roll2d_pallas", functools.partial(
        jpa.roll2d_pallas, interpret=True))
    x = _rng(7).random((1, 32, 32, 3), dtype=np.float32)
    m_j = jbuild("hat_tiny", attention_impl="pallas_block")
    p16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    want = np.asarray(m_j.apply(p16, jnp.asarray(x).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    ref32 = np.asarray(jbuild("hat_tiny", attention_impl="xla").apply(
        params, jnp.asarray(x)))
    m16 = build_model("hat_tiny", device="cpu", dtype=torch.bfloat16)
    m16.load_state_dict(m_t.state_dict(), strict=True)
    got = m16(_t(x).bfloat16()).float().numpy()
    ctrl = want - ref32
    assert _rms(got - ref32) <= 1.25 * _rms(ctrl)
    assert _rms(got - want) <= 1.5 * _rms(ctrl)
    assert np.abs(got - want).max() <= 2 * np.abs(ctrl).max()


def test_hat_weights_round_trip_through_jax_rules():
    """reference dict (with its index buffers) -> convert_state_dict(
    hat_rules, multi) -> from_jax gives back the reference dict; a tree
    whose two norm1 copies differ is refused."""
    names = build_model("hat_tiny", device="cpu").state_dict()
    state = {k: fill_tensor(k, tuple(v.shape), 6, 0.3)
             for k, v in names.items()}
    full = dict(state, relative_position_index_SA=np.zeros((64, 64)),
                relative_position_index_OCA=np.zeros((64, 144)))
    jtree = convert_with_drops(full, hat_rules(), multi=True)
    back = from_jax(jax.tree.map(np.asarray, jtree))
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    jtree["layer1"]["hab0"]["norm1"]["scale"] = \
        jtree["layer1"]["hab0"]["norm1"]["scale"] + 1.0
    with pytest.raises(ValueError, match="norm1"):
        from_jax(jtree)


# ---------------------------------------------------------------------------
# engine


def test_engine_hat_matches_jax_engine(tiny):
    """Engine.restore_array with hat_tiny in tile mode (48 px tiles, 16 px
    overlap, 16 tiles in a batch of 8) against the JAX Engine with the
    same weights: uint8 pixels within one step."""
    from image_restoration_agent_tpu.engine import Engine as JEngine
    from image_restoration_agent_tpu_torch.engine import Engine
    params, m_t = tiny
    img = _rng(8).random((60, 90, 3), dtype=np.float32)
    jeng = JEngine(hbm_budget_bytes=1 << 30)
    jeng.store._loader = lambda name: params
    want = jeng.restore_array(img, "hat_tiny", tile=48, overlap=16).image
    eng = Engine(device="cpu", hbm_budget_bytes=1 << 30)
    eng.set_weights("hat_tiny", dict(
        {k: v.numpy() for k, v in m_t.state_dict().items()},
        relative_position_index_SA=np.zeros((64, 64))))
    res = eng.restore_array(img, "hat_tiny", tile=48, overlap=16)
    assert res.image.shape == want.shape == (240, 360, 3)
    assert res.nonfinite == 0 and not res.random_init
    diff = np.abs(res.image.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


# both engines choose the batch from the tile count of the bucketed canvas
# before the 'extra' pad (45 tiles at 1088x1920 or 1152x1920), so at the
# default bucket 128 the 54 tiles of 1168x1936 run in 11 batches of 5
@pytest.mark.parametrize("bucket,canvas,tiles,batch", [
    (8, (1104, 1936), 45, 5), (128, (1168, 1936), 54, 5)])
def test_engine_hat_2k_plan_matches_jax(monkeypatch, bucket, canvas, tiles,
                                        batch):
    """hat_sr_x4 at 1920x1080: the port's engine buckets, pads, tiles and
    batches as the JAX engine does (read from both engines' pipeline
    arguments); the port then runs ceil(tiles / batch) forwards of
    (batch, 256, 256, 3)."""
    from image_restoration_agent_tpu.core.pad import _pad_amount as jpad
    from image_restoration_agent_tpu.core.tiling import plan_tiles as jplan
    from image_restoration_agent_tpu.engine import Engine as JEngine
    from image_restoration_agent_tpu_torch.engine import Engine
    img = np.zeros((1080, 1920, 3), np.float32)

    class Stop(Exception):
        pass

    def capture(name, h, w, tile, overlap, batch_, ens):
        raise Stop((h, w, tile, overlap, batch_))

    jeng = JEngine(hbm_budget_bytes=1 << 30, shape_bucket=bucket)
    jeng.store._loader = lambda name: {}
    monkeypatch.setattr(jeng, "_pipeline", capture)
    with pytest.raises(Stop) as got:
        jeng.restore_array(img, "hat_sr_x4")
    hb, wb, tile, overlap, jbatch = got.value.args[0]
    jcanvas = (hb + jpad(hb, 16, "extra"), wb + jpad(wb, 16, "extra"))
    assert (jcanvas, jplan(*jcanvas, tile, overlap).num_tiles, jbatch) == (
        canvas, tiles, batch)

    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append(tuple(x.shape))
            return x.repeat_interleave(4, 1).repeat_interleave(4, 2)

    eng = Engine(device="cpu", hbm_budget_bytes=1 << 30, shape_bucket=bucket)
    monkeypatch.setattr(eng.store, "get", lambda name: Probe())
    res = eng.restore_array(img, "hat_sr_x4")
    key = next(iter(eng._pipelines))
    assert key[1:3] == (hb, wb) and key[5] == jbatch
    assert seen == [(batch, 256, 256, 3)] * -(-tiles // batch)
    assert res.image.shape == (4320, 7680, 3)


@pytest.mark.slow
@torch.no_grad()
def test_hat_sr_x4_real_geometry_matches_jax_f32():
    """hat_sr_x4 at full geometry (embed 180, 6 RHAG x 6 HAB, window 16)
    on a 64x64 canvas in f32, the port's CPU path against the JAX model's
    XLA path with the same (JAX-initialized, perturbed) weights, within
    1e-4 x max|ref|."""
    torch.set_num_threads(4)
    m_j = jbuild("hat_sr_x4", attention_impl="xla")
    x = _rng(9).random((1, 64, 64, 3), dtype=np.float32)
    p = jax.tree.map(np.asarray, jax.jit(m_j.init)(jax.random.PRNGKey(2),
                                                   jnp.asarray(x)))
    noise = np.random.default_rng(3)
    p = jax.tree.map(lambda a: (a + 0.02 * noise.standard_normal(
        a.shape)).astype(np.float32), p)
    for layer in p["params"].values():
        for name, blk in layer.items():
            if name.startswith("hab"):
                blk["norm1"]["scale"] = blk["attn"]["norm_scale"]
                blk["norm1"]["bias"] = blk["attn"]["norm_bias"]
    m_t = build_model("hat_sr_x4", device="cpu")
    m_t.load_state_dict(from_jax(p), strict=True)
    want = np.asarray(m_j.apply(p, jnp.asarray(x)))
    got = m_t(_t(x)).numpy()
    assert got.shape == (1, 256, 256, 3)
    _close_f32(got, want, 1e-4)
