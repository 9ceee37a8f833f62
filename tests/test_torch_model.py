"""Port parity: whole SwinIR, band tiling, weight carry-over, package
separation and device policy of image_restoration_agent_tpu_torch."""

import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.convert.torch_import import (
    convert_state_dict, swinir_rules)
from image_restoration_agent_tpu.core.tiling import tiled_apply as jtiled
from image_restoration_agent_tpu.models import build_model as jbuild
from image_restoration_agent_tpu_torch.convert import from_jax
from image_restoration_agent_tpu_torch.core.tiling import tiled_apply
from image_restoration_agent_tpu_torch.models import (MODEL_REGISTRY,
                                                      build_model)
from image_restoration_agent_tpu_torch.models.swinir import SwinIR
from image_restoration_agent_tpu_torch.offline import (GOLDEN_ROOT,
                                                       fill_tensor,
                                                       load_golden, psnr)
from image_restoration_agent_tpu_torch.ops.swin_block import (
    pad_width_for_strips)

torch.set_num_threads(1)

PKG = Path(__file__).resolve().parents[1] / "image_restoration_agent_tpu_torch"


@pytest.fixture(scope="module")
def tiny():
    """swinir_tiny params from the JAX package's own init, carried across
    with convert.from_jax into the port (strict load)."""
    x = jnp.asarray(np.random.default_rng(0).random((1, 16, 24, 3),
                                                    dtype=np.float32))
    m_j = jbuild("swinir_tiny", attention_impl="xla")
    params = m_j.init(jax.random.PRNGKey(0), x)
    m_t = build_model("swinir_tiny", device="cpu")
    m_t.load_state_dict(from_jax(jax.tree.map(np.asarray, params)),
                        strict=True)
    return params, m_t


@torch.no_grad()  # a served forward (the model records a graph)
@pytest.mark.parametrize("packed", [False, True])
def test_swinir_tiny_matches_jax(tiny, packed):
    params, m_t = tiny
    x = np.random.default_rng(1).random((1, 16, 24, 3), dtype=np.float32)
    m_j = jbuild("swinir_tiny", attention_impl="xla", packed_output=packed)
    want = np.asarray(m_j.apply(params, jnp.asarray(x)))
    got = m_t(torch.from_numpy(x), packed_output=packed).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("cfg", [
    dict(upscale=2, upsampler="pixelshuffledirect"),
    dict(upscale=4, upsampler="nearest+conv", num_feat=16),
    dict(upscale=3, upsampler="pixelshuffle", num_feat=16),
    dict(upsampler="", img_range=255.0),
], ids=["direct", "nearest+conv", "pixelshuffle-x3", "denoise"])
@torch.no_grad()  # a served forward (the model records a graph)
def test_swinir_heads_match_jax(cfg):
    """Every upsampler head, with JAX-initialized weights carried across by
    from_jax (strict load)."""
    from image_restoration_agent_tpu.models.swinir import SwinIR as JSwinIR
    base = dict(embed_dim=16, depths=(2,), num_heads=(2,), window_size=8)
    x = np.random.default_rng(4).random((1, 16, 24, 3), dtype=np.float32)
    m_j = JSwinIR(**base, **cfg, attention_impl="xla")
    params = m_j.init(jax.random.PRNGKey(1), jnp.asarray(x))
    m_t = SwinIR(**base, **cfg)
    m_t.load_state_dict(from_jax(jax.tree.map(np.asarray, params)),
                        strict=True)
    want = np.asarray(m_j.apply(params, jnp.asarray(x)))
    got = m_t(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * max(
        1.0, float(np.abs(want).max())))


@torch.no_grad()  # a served forward (the model records a graph)
def test_band_tiled_apply_matches_jax(tiny):
    """Band mode: pad_to a strip-chunkable width, (bh, pw) row bands with a
    16 px overlap, packed RGB, on both sides."""
    params, m_t = tiny
    h, w = 40, 60
    img = np.random.default_rng(2).random((h, w, 3), dtype=np.float32)
    ph, pw = -(-h // 8) * 8, pad_width_for_strips(w)
    bh = -(-(ph + 16) // 2 // 8) * 8
    kw = dict(tile=(bh, pw), overlap=16, scale=4, batch=1, pad_to=(ph, pw),
              packed_c=3)
    m_j = jbuild("swinir_tiny", attention_impl="xla", packed_output=True)
    want = np.asarray(jtiled(lambda b: m_j.apply(params, b),
                             jnp.asarray(img), **kw))
    got = tiled_apply(lambda b: m_t(b, packed_output=True),
                      torch.from_numpy(img), **kw).numpy()
    assert got.shape == (h * 4, w * 4 * 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_weights_round_trip_through_jax_rules():
    """reference dict -> convert_state_dict(swinir_rules) -> from_jax
    gives back the reference dict."""
    names = build_model("swinir_tiny", device="cpu").state_dict()
    state = {k: fill_tensor(k, tuple(v.shape), 3, 0.3)
             for k, v in names.items()}
    jtree = convert_state_dict(state, swinir_rules())
    back = from_jax(jax.tree.map(np.asarray, jtree))
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_golden_spec_names_match_swinir_m():
    """SwinIR-M's parameter names and shapes are exactly the reference
    state-dict list of the golden (so it loads with strict=True)."""
    spec = json.loads((GOLDEN_ROOT / "swinir_sr_x4_synth" / "spec.json")
                      .read_text())
    with torch.device("meta"):  # names and shapes only, no storage
        model = SwinIR(**MODEL_REGISTRY["swinir_sr_x4"].config)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(s) for k, s in spec["state"]}


def test_port_imports_neither_jax_nor_reference():
    """In a fresh interpreter, importing every port module leaves jax and
    the JAX package out of sys.modules; no port source imports them."""
    mods = sorted(
        "image_restoration_agent_tpu_torch." + ".".join(
            p.relative_to(PKG).with_suffix("").parts).replace(".__init__", "")
        for p in PKG.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m.rstrip('.'))\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'image_restoration_agent_tpu' or "
            "m.startswith('image_restoration_agent_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(PKG.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|"
                     r"image_restoration_agent_tpu)(\s|\.|$)", re.M)
    for src in PKG.rglob("*.py"):
        assert not pat.search(src.read_text()), src


def test_entry_points_raise_without_card(monkeypatch):
    """Entry points default to cuda and raise when there is no card; they
    never carry on on the CPU."""
    from image_restoration_agent_tpu_torch.engine import Engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Engine()
    with pytest.raises(RuntimeError, match="cuda"):
        build_model("swinir_tiny")


def test_engine_restore_matches_jax_engine(tiny):
    """Engine.restore_array (shape bucket, pad, forward, crop, clip, uint8
    on the device) against the JAX Engine with the same weights: uint8
    pixels within one step (f32 sums in another order may round across)."""
    from image_restoration_agent_tpu.engine import Engine as JEngine
    from image_restoration_agent_tpu_torch.engine import Engine
    params, m_t = tiny
    img = np.random.default_rng(3).random((30, 44, 3), dtype=np.float32)
    jeng = JEngine(hbm_budget_bytes=1 << 30)
    jeng.store._loader = lambda name: params
    want = jeng.restore_array(img, "swinir_tiny").image
    eng = Engine(device="cpu", hbm_budget_bytes=1 << 30)
    eng.set_weights("swinir_tiny", {k: v.numpy()
                                    for k, v in m_t.state_dict().items()})
    res = eng.restore_array(img, "swinir_tiny")
    assert res.image.shape == want.shape == (120, 176, 3)
    assert res.image.dtype == np.uint8 and res.nonfinite == 0
    diff = np.abs(res.image.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    # geometric self-ensemble (rotations) through the same pipeline cache
    want_e = jeng.restore_array(img, "swinir_tiny", ensemble=True,
                                ensemble_times=4).image
    got_e = eng.restore_array(img, "swinir_tiny", ensemble=True,
                              ensemble_times=4).image
    diff = np.abs(got_e.astype(int) - want_e.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    st = eng.status()
    assert st["models_resident"] == ["swinir_tiny"]
    assert st["built_pipelines"] == 2 and not st["random_init_models"]
    # the same bucket reuses the built pipeline
    rec = eng.warmup(["swinir_tiny"], [(30, 44)])
    assert rec[0]["built"] is False and not rec[0]["random_init"]


def test_engine_weight_dir_and_restore_file(tiny, tmp_path):
    """Weights from weight_dir/<model>.npz and .pth (reference wrapper
    key), restore_file through the port's PNG codec."""
    from image_restoration_agent_tpu_torch.core.io import (load_image,
                                                          save_image)
    from image_restoration_agent_tpu_torch.engine import Engine
    _, m_t = tiny
    sd = {k: v.numpy() for k, v in m_t.state_dict().items()}
    img = np.random.default_rng(5).random((20, 28, 3), dtype=np.float32)
    save_image(img, tmp_path / "in.png")
    outs = []
    for fmt in ("npz", "pth"):
        d = tmp_path / fmt
        d.mkdir()
        if fmt == "npz":
            np.savez(d / "swinir_tiny.npz", **sd)
        else:
            torch.save({"params": dict(m_t.state_dict())},
                       d / "swinir_tiny.pth")
        eng = Engine(d, device="cpu", hbm_budget_bytes=1 << 30)
        res = eng.restore_file(tmp_path / "in.png", d / "out.png",
                               "swinir_tiny")
        assert not res.random_init
        outs.append(load_image(d / "out.png"))
        np.testing.assert_array_equal(outs[-1], res.image)
    assert outs[0].shape == (80, 112, 3)
    np.testing.assert_array_equal(outs[0], outs[1])
    with pytest.raises(FileNotFoundError):
        Engine(tmp_path, device="cpu").restore_array(img, "swinir_tiny")


@pytest.mark.slow
def test_golden_swinir_sr_x4_f32_cpu():
    """The port's f32 CPU path on the real-geometry synthetic golden (SwinIR-M
    x4, whole image, 'extra' pad to 264) reaches the recorded PSNR within
    0.1 dB against the independent torch reference output."""
    torch.set_num_threads(4)
    g = load_golden(GOLDEN_ROOT / "swinir_sr_x4_synth")
    model = build_model("swinir_sr_x4", device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in g["state"].items()}, strict=True)
    out = tiled_apply(model, torch.from_numpy(g["input"]), tile=None,
                      scale=4, pad_multiple=8, pad_mode="extra",
                      pad_kind="symmetric")
    db = psnr(np.clip(out.numpy(), 0, 1), g["expected"])
    assert db >= g["spec"]["psnr_db"] - 0.1, db


# (B, H, W, window): whole-image denoising at 1088x1928 (8 x 241, no strip
# chunk width), a 464-wide canvas (456-463 px padded), window 7
# (swinir_jpeg_40), the band canvases, HAT's tile, small canvases
_ROUTE_SHAPES = [(1, 1088, 1928, 8), (1, 64, 464, 8), (1, 70, 70, 7),
                 (1, 1080, 1928, 8), (1, 552, 1920, 8), (1, 280, 496, 8),
                 (1, 136, 136, 8), (5, 256, 256, 16), (1, 32, 464, 16),
                 (1, 16, 392, 8), (2, 16, 24, 8), (1, 21, 28, 7)]


@pytest.mark.parametrize("b,h,w,ws", _ROUTE_SHAPES)
def test_swinir_route_rule_matches_jax(b, h, w, ws):
    """The port's route predicate (SwinBlock.strip, strip_route) is the JAX
    package's rule on the TPU (models/swinir.py: _pallas_supported, the
    multiple-of-window test and the strip chunk width)."""
    from image_restoration_agent_tpu.models import swinir as jsw
    from image_restoration_agent_tpu.ops import pallas_attention as jpa
    from image_restoration_agent_tpu_torch.models.swinir import (SwinBlock,
                                                                 strip_route)
    want = (jsw._pallas_supported(ws, b * h * w) and h % ws == 0
            and w % ws == 0
            and (w <= 384 or jpa.strip_chunk_width(w, ws) is not None))
    assert strip_route(b, h, w, ws) == want
    blk = SwinBlock(8, 2, ws, ws // 2)
    assert blk.strip(torch.zeros(b, h, w, 1, device="meta")) == want
    assert strip_route(1, 1088, 1928, 8) is False


def _jax_swinir(cfg, x, params, dtype, interpret):
    """The JAX SwinIR on its TPU route ("pallas_block", the Pallas kernels
    in interpret mode) or its XLA route."""
    import functools

    from image_restoration_agent_tpu.models import swinir as jsw
    from image_restoration_agent_tpu.models.swinir import SwinIR as JSwinIR
    from image_restoration_agent_tpu.ops import pallas_attention as jpa
    names = ("swin_strip_pallas", "wmsa_block_pallas", "mlp_block_pallas")
    orig = [getattr(jsw, n) for n in names]
    try:
        if interpret:
            for n in names:
                setattr(jsw, n, functools.partial(getattr(jpa, n),
                                                  interpret=True))
        m_j = JSwinIR(**cfg, attention_impl="pallas_block" if interpret
                      else "xla")
        p = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), params)
        out = m_j.apply(p, jnp.asarray(x).astype(dtype))
    finally:
        for n, f in zip(names, orig):
            setattr(jsw, n, f)
    return np.asarray(out.astype(jnp.float32))


_TINY = dict(embed_dim=16, depths=(2,), num_heads=(2,), upsampler="",
             img_range=1.0)


@pytest.mark.parametrize("ws,hw", [(8, (16, 392)), (7, (14, 21))],
                         ids=["wide-no-chunk", "window7"])
@torch.no_grad()  # a served forward (the model records a graph)
def test_swinir_partition_route_matches_jax_f32(ws, hw):
    """A canvas that takes the partition route (wider than 384 with no
    strip chunk width; window 7) through wmsa_block + mlp_block (erf-GELU),
    frames 0, against the JAX package's route for it (wmsa_block_pallas +
    mlp_block_pallas in interpret mode at window 8, XLA at window 7), f32
    within 1e-4 x max|ref|."""
    cfg = dict(_TINY, window_size=ws)
    x = np.random.default_rng(10).random((1, *hw, 3), dtype=np.float32)
    from image_restoration_agent_tpu.models.swinir import SwinIR as JSwinIR
    params = JSwinIR(**cfg, attention_impl="xla").init(
        jax.random.PRNGKey(4), jnp.asarray(x))
    params = jax.tree.map(
        lambda a: a + 0.05 * np.random.default_rng(11).standard_normal(
            a.shape).astype(np.float32), jax.tree.map(np.asarray, params))
    m_t = SwinIR(**cfg)
    m_t.load_state_dict(from_jax(params), strict=True)
    assert not m_t.layers[0].residual_group.blocks[1].strip(
        torch.zeros(1, *hw, 16))
    want = _jax_swinir(cfg, x, params, jnp.float32, interpret=ws == 8)
    got = m_t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


@torch.no_grad()  # a served forward (the model records a graph)
def test_swinir_tiny_bf16_partition_route_matches_jax():
    """bf16 swinir_tiny on a partition-route canvas (16x392) against the
    JAX bf16 model on its TPU route (wmsa_block_pallas + mlp_block_pallas
    in interpret mode): exact softmax and erf-GELU in both, where slice 1
    took the fast numerics. Held as Restormer's bf16 model: 1.25x the JAX
    bf16 model's RMS error against f32, 1.5x in RMS distance to it, 2x its
    largest error."""
    params = jbuild("swinir_tiny", attention_impl="xla").init(
        jax.random.PRNGKey(5), jnp.zeros((1, 16, 24, 3)))
    params = jax.tree.map(
        lambda a: a + 0.05 * np.random.default_rng(12).standard_normal(
            a.shape).astype(np.float32), jax.tree.map(np.asarray, params))
    cfg = dict(MODEL_REGISTRY["swinir_tiny"].config)
    x = np.random.default_rng(13).random((1, 16, 392, 3), dtype=np.float32)
    want = _jax_swinir(cfg, x, params, jnp.bfloat16, interpret=True)
    ref32 = _jax_swinir(cfg, x, params, jnp.float32, interpret=False)
    m16 = build_model("swinir_tiny", device="cpu", dtype=torch.bfloat16)
    m16.load_state_dict(from_jax(params), strict=True)
    got = m16(torch.from_numpy(x).bfloat16()).float().numpy()

    def rms(a):
        return float(np.sqrt(np.mean(a ** 2)))

    ctrl = want - ref32
    assert rms(got - ref32) <= 1.25 * rms(ctrl)
    assert rms(got - want) <= 1.5 * rms(ctrl)
    assert np.abs(got - want).max() <= 2 * np.abs(ctrl).max()


@torch.no_grad()  # a served forward (the model records a graph)
def test_swinir_window7_bf16_partition_route_matches_jax():
    """bf16 SwinIR at swinir_jpeg_40's geometry (window 7, embed 180, 6
    heads, img_range 255), cut to one RSTB of two blocks, on a 14x21
    canvas (2x3 windows of 49 tokens: the partition route, one unshifted
    and one shifted block) against the JAX bf16 model on its TPU route
    (XLA at an odd window), held to the bounds of
    test_swinir_tiny_bf16_partition_route_matches_jax: 1.25x the JAX bf16
    model's RMS error against f32, 1.5x in RMS distance to it, 2x its
    largest error."""
    from image_restoration_agent_tpu.models.swinir import SwinIR as JSwinIR
    cfg = dict(MODEL_REGISTRY["swinir_jpeg_40"].config, depths=(2,),
               num_heads=(6,))
    x = np.random.default_rng(16).random((1, 14, 21, 3), dtype=np.float32)
    params = JSwinIR(**cfg, attention_impl="xla").init(
        jax.random.PRNGKey(8), jnp.asarray(x))
    params = jax.tree.map(
        lambda a: a + 0.05 * np.random.default_rng(17).standard_normal(
            a.shape).astype(np.float32), jax.tree.map(np.asarray, params))
    want = _jax_swinir(cfg, x, params, jnp.bfloat16, interpret=True)
    ref32 = _jax_swinir(cfg, x, params, jnp.float32, interpret=False)
    m16 = build_model("swinir_jpeg_40", device="cpu", dtype=torch.bfloat16,
                      depths=(2,), num_heads=(6,))
    m16.load_state_dict(from_jax(params), strict=True)
    assert not m16.layers[0].residual_group.blocks[1].strip(
        torch.zeros(1, 14, 21, 180))
    got = m16(torch.from_numpy(x).bfloat16()).float().numpy()

    def rms(a):
        return float(np.sqrt(np.mean(a ** 2)))

    ctrl = want - ref32
    assert rms(got - ref32) <= 1.25 * rms(ctrl)
    assert rms(got - want) <= 1.5 * rms(ctrl)
    assert np.abs(got - want).max() <= 2 * np.abs(ctrl).max()


@torch.no_grad()  # a served forward (the model records a graph)
def test_slice1_route_fault_is_repaired(monkeypatch):
    """The fault this repairs: slice 1 ran every SwinIR block as the strip
    form, whose bf16 numerics are the fast ones (clamp-exp2 softmax,
    tanh-GELU), where the JAX package takes the partition route and exact
    numerics (a 456-463 px denoise input pads to 464 wide: no strip chunk
    width). Here those numerics are forced in f32 on the old route, at
    16x464: the old form misses the JAX route by more than 1e-4 x
    max|ref|, the repaired one stays within it."""
    import image_restoration_agent_tpu_torch.models.swinir as tsw
    from image_restoration_agent_tpu.models.swinir import SwinIR as JSwinIR
    cfg = dict(_TINY, window_size=8)
    x = np.random.default_rng(14).random((1, 16, 464, 3), dtype=np.float32)
    params = JSwinIR(**cfg, attention_impl="xla").init(
        jax.random.PRNGKey(6), jnp.asarray(x))
    params = jax.tree.map(
        lambda a: a + 0.05 * np.random.default_rng(15).standard_normal(
            a.shape).astype(np.float32), jax.tree.map(np.asarray, params))
    want = _jax_swinir(cfg, x, params, jnp.float32, interpret=False)
    m_t = SwinIR(**cfg)
    m_t.load_state_dict(from_jax(params), strict=True)
    new = np.abs(m_t(torch.from_numpy(x)).numpy() - want).max()
    fast_block = tsw.swin_block
    monkeypatch.setattr(tsw.SwinBlock, "strip", lambda self, x: True)
    monkeypatch.setattr(tsw, "swin_block", lambda *a, **k: fast_block(
        *a, **{**k, "fast": True}))
    old = np.abs(m_t(torch.from_numpy(x)).numpy() - want).max()
    tol = 1e-4 * float(np.abs(want).max())
    assert new <= tol < old, (new, tol, old)
