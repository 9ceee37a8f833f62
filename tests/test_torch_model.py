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
