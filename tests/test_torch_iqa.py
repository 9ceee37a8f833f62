"""Port parity for the quality metrics: PSNR and SSIM, LPIPS-Alex, the ViT
trunk, MANIQA and its 20-crop scorer, MUSIQ and its 3-scale scorer, and
the six-metric ``Scorer``, each held against the JAX package's
``iqa/metrics.py``, ``lpips.py``, ``vit.py``, ``maniqa.py``, ``musiq.py``
and ``scorer.py`` with the weights carried by ``convert.from_jax``, and
against the torch transcriptions of ``tests/test_lpips.py``,
``test_convert_maniqa.py`` and ``test_convert_musiq.py`` loaded with
``strict=True``. Tiny configs; ``-m slow`` adds MANIQA at full width and
full-width CLIP RN50x4 against JAX on one small input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.iqa import lpips as jlp
from image_restoration_agent_tpu.iqa import maniqa as jmq
from image_restoration_agent_tpu.iqa import metrics as jmet
from image_restoration_agent_tpu.iqa import musiq as jmu
from image_restoration_agent_tpu.iqa import scorer as jsc
from image_restoration_agent_tpu.iqa import vit as jvit
from image_restoration_agent_tpu.iqa.clipiqa import ClipIQA as JClipIQA
from image_restoration_agent_tpu.retrieval import clip as jclip
from image_restoration_agent_tpu_torch import iqa as tiqa_pkg
from image_restoration_agent_tpu_torch.convert import from_jax
from image_restoration_agent_tpu_torch.iqa import lpips as tlp
from image_restoration_agent_tpu_torch.iqa import maniqa as tmq
from image_restoration_agent_tpu_torch.iqa import metrics as tmet
from image_restoration_agent_tpu_torch.iqa import musiq as tmu
from image_restoration_agent_tpu_torch.iqa import scorer as tsc
from image_restoration_agent_tpu_torch.iqa import vit as tvit
from image_restoration_agent_tpu_torch.iqa.clipiqa import ClipIQA
from image_restoration_agent_tpu_torch.retrieval import clip as tclip

import test_convert_maniqa as ref_mq
import test_convert_musiq as ref_mu
import test_lpips as ref_lp
from test_torch_clip import CFG, jax_clip, random_tree, rel_err

torch.set_num_threads(1)


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(
        np.float32)
    return a, b


# ---------------------------------------------------------------------------
# PSNR, SSIM

@pytest.mark.parametrize("shape", [(40, 52, 3), (33, 47, 1), (11, 11, 3)])
def test_psnr_ssim_match_jax(shape):
    a, b = _pair(shape, sum(shape))
    for jf, tf in ((jmet.psnr, tmet.psnr), (jmet.ssim, tmet.ssim)):
        want = float(jf(jnp.asarray(a), jnp.asarray(b)))
        got = tf(a, b)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= 1e-5 * abs(want), jf.__name__
        # tensors as well as numpy arrays
        assert float(tf(torch.from_numpy(a), torch.from_numpy(b))) == \
            float(got)
    assert float(tmet.psnr(a, a)) == pytest.approx(120.0)  # mse floor
    assert float(tmet.ssim(a, a)) == pytest.approx(1.0, abs=1e-6)
    assert tiqa_pkg.psnr is tmet.psnr and tiqa_pkg.ssim is tmet.ssim


# ---------------------------------------------------------------------------
# LPIPS

def _lpips_params(seed):
    m = jlp.LPIPS()
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 64, 64, 3)),
                                           jnp.zeros((1, 64, 64, 3))))
    params = random_tree(shapes, seed)
    # the heads are non-negative (the lpips package's clamp)
    params["params"] = {k: (np.abs(v) if k.startswith("lin") else v)
                        for k, v in params["params"].items()}
    return m, params


def test_lpips_matches_jax():
    m, params = _lpips_params(1)
    a, b = _pair((2, 64, 72, 3), 2)
    want = np.asarray(jax.jit(m.apply)(params, a, b))
    pm = tlp.LPIPS().eval()
    pm.load_state_dict(from_jax(params), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        same = pm(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    assert got.shape == want.shape == (2,)
    assert rel_err(got, want) <= 1e-5
    np.testing.assert_allclose(same, 0.0, atol=1e-7)
    assert "net.slice3.6.weight" in pm.state_dict()
    assert pm.state_dict()["lin4.model.1.weight"].shape == (1, 256, 1, 1)


def test_lpips_loads_the_transcription_strictly():
    """tests/test_lpips.py's TLPIPS (a torchvision AlexNet trunk, heads as
    1x1 convs) renamed to the lpips package's layout, loaded strictly."""
    torch.manual_seed(0)
    tm = ref_lp.TLPIPS().eval()
    idx = {0: 1, 3: 2, 6: 3, 8: 4, 10: 5}
    sd = {}
    for k, v in tm.state_dict().items():
        part = k.split(".")
        if part[0] == "trunk":
            sd[f"net.slice{idx[int(part[2])]}.{part[2]}.{part[3]}"] = v
        else:
            sd[f"lin{part[1]}.model.1.weight"] = v
    pm = tlp.LPIPS().eval()
    pm.load_state_dict(sd, strict=True)
    a, b = _pair((2, 64, 64, 3), 4)
    with torch.no_grad():
        want = tm(torch.from_numpy(a).permute(0, 3, 1, 2),
                  torch.from_numpy(b).permute(0, 3, 1, 2)).numpy()
        got = pm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert rel_err(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# ViT, MANIQA

# tiny MANIQA: embed 8, 16 px crops of 4 px patches (16 tokens), a ViT of
# depth 2 (both blocks tapped), window 2
MQ = dict(embed_dim=8, patch_size=4, img_size=16, depths=(2, 2),
          num_heads=(2, 2), window_size=2, dim_mlp=8, num_tab=2, scale=0.8,
          vit_depth=2, vit_heads=2, feature_blocks=(0, 1))


def test_vit_blocks_match_jax():
    m = jvit.ViT(patch_size=4, embed_dim=8, depth=2, num_heads=2,
                 img_size=16)
    x = np.random.default_rng(0).standard_normal(
        (2, 16, 16, 3)).astype(np.float32)
    params = random_tree(jax.eval_shape(
        lambda: m.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))), 2)
    want = [np.asarray(o) for o in jax.jit(m.apply)(params, x)]
    pm = tvit.ViT(4, 8, 2, 2, img_size=16).eval()
    pm.load_state_dict(from_jax(params), strict=True)
    with torch.no_grad():
        got = [o.numpy() for o in pm(torch.from_numpy(x))]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 17, 8)
        assert rel_err(g, w) <= 1e-4
    assert "blocks.1.attn.qkv.weight" in pm.state_dict()


@pytest.fixture(scope="module")
def maniqa_pair():
    m = jmq.MANIQA(**MQ)
    params = random_tree(jax.eval_shape(
        lambda: m.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))), 3)
    pm = tmq.MANIQA(**MQ).eval()
    pm.load_state_dict(from_jax(params), strict=True)
    return m, params, pm


def test_maniqa_matches_jax(maniqa_pair):
    m, params, pm = maniqa_pair
    x = np.random.default_rng(1).standard_normal(
        (3, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jax.jit(m.apply)(params, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3,)
    assert rel_err(got, want) <= 1e-4
    sd = pm.state_dict()
    assert "swintransformer2.layers.1.blocks.1.attn.relative_position_index" \
        in sd and "fc_weight.3.bias" in sd and "tablock2.1.c_v.weight" in sd


def test_maniqa_loads_the_transcription_strictly():
    """tests/test_convert_maniqa.py's TMANIQA (the official graph's names,
    its ``relative_position_index`` buffers included) at its own mini
    config."""
    torch.manual_seed(0)
    tm = ref_mq.TMANIQA().eval()
    pm = tmq.MANIQA(embed_dim=ref_mq.EMBED, patch_size=ref_mq.PATCH,
                    img_size=ref_mq.IMG, depths=ref_mq.DEPTHS,
                    num_heads=ref_mq.HEADS, window_size=ref_mq.WS,
                    dim_mlp=ref_mq.DIM_MLP, scale=ref_mq.SCALE,
                    vit_depth=ref_mq.VIT_DEPTH, vit_heads=ref_mq.VIT_HEADS,
                    feature_blocks=ref_mq.TAPS).eval()
    pm.load_state_dict(tm.state_dict(), strict=True)
    x = np.random.default_rng(0).standard_normal(
        (2, ref_mq.IMG, ref_mq.IMG, 3)).astype(np.float32) * 0.3
    with torch.no_grad():
        want = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        got = pm(torch.from_numpy(x)).numpy()
    assert rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("shape", [(40, 50, 3), (10, 12, 3), (16, 30, 3)],
                         ids=["crops", "upscaled", "one-row"])
def test_maniqa_scorer_matches_jax(maniqa_pair, shape):
    """The crops are the JAX scorer's (the same ``default_rng`` draws); a
    side under 16 is upscaled first."""
    m, params, pm = maniqa_pair
    img = np.random.default_rng(sum(shape)).random(shape, dtype=np.float32)
    js = jmq.ManiqaScorer(params, model=m, n_crops=4, seed=2)
    ts = tmq.ManiqaScorer(None, model=pm, n_crops=4, seed=2, device="cpu")
    want, got = js(img), ts(img)
    assert abs(got - want) <= 1e-4 * max(abs(want), 1e-3)
    assert ts(img) == got  # deterministic


# ---------------------------------------------------------------------------
# MUSIQ

MU = dict(hidden=8, num_layers=2, num_heads=2, mlp_dim=16)


def _musiq_inputs():
    rng = np.random.default_rng(0)
    p1 = rng.standard_normal((1, 6, 32 * 32 * 3)).astype(np.float32)
    p2 = rng.standard_normal((1, 2, 32 * 32 * 3)).astype(np.float32)
    hidx = np.array([0, 5, 11, 23, 47, 99, 3, 88], np.int32)
    sidx = np.array([0] * 6 + [1] * 2, np.int32)
    return [p1, p2], hidx, sidx


@pytest.fixture(scope="module")
def musiq_pair():
    m = jmu.MUSIQ(**MU)
    scales, hidx, sidx = _musiq_inputs()
    params = random_tree(jax.eval_shape(lambda: m.init(
        jax.random.PRNGKey(0), [jnp.asarray(s) for s in scales],
        jnp.asarray(hidx), jnp.asarray(sidx))), 4)
    pm = tmu.MUSIQ(**MU).eval()
    pm.load_state_dict(from_jax(params), strict=True)
    return m, params, pm


def test_musiq_matches_jax(musiq_pair):
    m, params, pm = musiq_pair
    scales, hidx, sidx = _musiq_inputs()
    want = np.asarray(m.apply(params, scales, hidx, sidx))
    with torch.no_grad():
        got = pm([torch.from_numpy(s) for s in scales],
                 torch.from_numpy(hidx).long(),
                 torch.from_numpy(sidx).long()).numpy()
    assert got.shape == want.shape == (1,)
    assert rel_err(got, want) <= 1e-4


def test_musiq_loads_the_transcription_strictly():
    torch.manual_seed(0)
    tm = ref_mu.TMUSIQ().eval()
    pm = tmu.MUSIQ(hidden=ref_mu.HIDDEN, num_layers=ref_mu.LAYERS,
                   num_heads=ref_mu.HEADS, mlp_dim=ref_mu.MLP).eval()
    pm.load_state_dict(tm.state_dict(), strict=True)
    scales, hidx, sidx = _musiq_inputs()
    h, s = torch.from_numpy(hidx).long(), torch.from_numpy(sidx).long()
    with torch.no_grad():
        want = tm(torch.from_numpy(np.concatenate(scales, 1)), h, s).numpy()
        got = pm([torch.from_numpy(a) for a in scales], h, s).numpy()
    assert rel_err(got, want) <= 1e-4


def test_musiq_scales_grid_and_patches_match_jax():
    assert tmu._scale_sizes(80, 120, (48, 64)) == \
        jmu._scale_sizes(80, 120, (48, 64))
    assert tmu._scale_sizes(1080, 1920) == jmu._scale_sizes(1080, 1920)
    np.testing.assert_array_equal(tmu._grid(7, 13), jmu._grid(7, 13))
    img = np.random.default_rng(3).random((80, 120, 3), dtype=np.float32)
    for h, w in ((80, 120), (32, 48), (43, 64), (100, 150)):
        want, whash = jmu.extract_patches(jnp.asarray(img), h, w)
        got, ghash = tmu.extract_patches(torch.from_numpy(img), h, w)
        assert got.shape == want.shape
        assert rel_err(got.numpy(), want) <= 1e-5
        np.testing.assert_array_equal(ghash, whash)


def test_musiq_scorer_matches_jax(musiq_pair):
    m, params, pm = musiq_pair
    img = np.random.default_rng(1).random((80, 120, 3), dtype=np.float32)
    want = jmu.MusiqScorer(params, model=m, longer_sides=(48, 64))(img)
    ts = tmu.MusiqScorer(None, model=pm, longer_sides=(48, 64),
                         device="cpu")
    got = ts(img)
    assert abs(got - want) <= 1e-4 * max(abs(want), 1e-3)


# ---------------------------------------------------------------------------
# Scorer

@pytest.fixture(scope="module")
def scorers(maniqa_pair, musiq_pair):
    """The JAX and port six-metric scorers on shared tiny weights."""
    lm, lparams = _lpips_params(5)
    cm, cparams = jax_clip(attnpool_pos=False, seed=6)
    tf = np.random.default_rng(0).standard_normal(
        (2, CFG["embed_dim"])).astype(np.float32)
    mm, mparams, mpm = maniqa_pair
    um, uparams, upm = musiq_pair
    metrics = ("psnr", "ssim", "lpips", "maniqa", "clipiqa", "musiq")
    js = jsc.Scorer(metrics, lpips_params=lparams,
                    clipiqa=JClipIQA(cparams, clip_model=cm,
                                     text_features=tf),
                    maniqa=jmq.ManiqaScorer(mparams, model=mm, n_crops=3),
                    musiq=jmu.MusiqScorer(uparams, model=um,
                                          longer_sides=(48, 64)))
    ts = tsc.Scorer(metrics, lpips_state=from_jax(lparams),
                    clipiqa=ClipIQA(from_jax(cparams),
                                    clip_model=tclip.CLIPModel(
                                        **CFG, attnpool_pos=False),
                                    text_features=tf, device="cpu"),
                    maniqa=tmq.ManiqaScorer(None, model=mpm, n_crops=3,
                                            device="cpu"),
                    musiq=tmu.MusiqScorer(None, model=upm,
                                          longer_sides=(48, 64),
                                          device="cpu"),
                    device="cpu")
    return js, ts


@pytest.mark.parametrize("sr", [False, True], ids=["same-size", "x4"])
def test_scorer_matches_jax(scorers, sr):
    """Every metric of the six; with an x4 smaller image the MATLAB
    bicubic upsample aligns it first."""
    js, ts = scorers
    ref = np.random.default_rng(7).random((64, 72, 3), dtype=np.float32)
    img = np.clip(ref + 0.05 * np.random.default_rng(8).standard_normal(
        ref.shape), 0, 1).astype(np.float32)
    if sr:
        img = img[::4, ::4]
    want = js.score_arrays(img, ref)
    got = ts.score_arrays(img, ref)
    assert set(got) == set(want) == set(js.metrics)
    for k, w in want.items():
        assert isinstance(got[k], float), k
        assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-3), (k, got[k], w)


def test_scorer_align_and_absent_metrics(tmp_path):
    a = np.random.default_rng(0).random((16, 20, 3), dtype=np.float32)
    b = np.random.default_rng(1).random((64, 80, 3), dtype=np.float32)
    gi, gr = tsc.Scorer._align(a, b)
    wi, wr = jsc.Scorer._align(a, b)
    assert gi.shape == wi.shape == (64, 80, 3) and gr is b
    assert rel_err(gi, wi) <= 1e-5
    gr, gi = tsc.Scorer._align(b, a)
    assert gi.shape == (64, 80, 3)
    with pytest.raises(ValueError, match="unalignable"):
        tsc.Scorer._align(a, b[:, :40])
    # no weights file, no instance: None, as the JAX scorer answers
    sc = tsc.Scorer(("psnr", "lpips", "clipiqa", "maniqa", "musiq",
                     "niqe"), lpips_path=tmp_path / "none.npz",
                    device="cpu")
    out = sc.score_arrays(a, a)
    assert out["psnr"] == pytest.approx(120.0)
    assert all(out[k] is None for k in ("lpips", "clipiqa", "maniqa",
                                        "musiq", "niqe"))
    assert tsc.FR_METRICS == jsc.FR_METRICS
    assert tsc.NR_METRICS == jsc.NR_METRICS


def test_scorer_reads_pngs(tmp_path):
    from image_restoration_agent_tpu_torch.core.io import save_image

    a, b = _pair((24, 24, 3), 9)
    save_image(a, tmp_path / "a.png")
    save_image(b, tmp_path / "b.png")
    got = tsc.Scorer(device="cpu")(tmp_path / "a.png", tmp_path / "b.png")
    want = jsc.Scorer()(tmp_path / "a.png", tmp_path / "b.png")
    for k in ("psnr", "ssim"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k])


# ---------------------------------------------------------------------------
# full width (slow)

def maniqa_reference_tree(shapes, seed):
    """MANIQA's weights drawn as its reference initialises them where it
    matters: the ViT's and the Swin stages' Dense kernels N(0, 0.02) cut
    at two sigma, their biases 0, LayerNorms 1 and 0; ``random_tree``
    elsewhere. With fan-in weights throughout, the activations grow
    through the first Swin stage until the second TABlocks' softmax turns
    on float32's last bits at full width."""
    rng = np.random.default_rng(seed)
    base = random_tree(shapes, seed)

    def draw(path, a, b):
        keys = [str(getattr(k, "key", k)) for k in path]
        if not any(k == "vit" or k.startswith("swin") for k in keys):
            return b
        if keys[-1] == "kernel" and len(a.shape) == 2:
            return np.clip(0.02 * rng.standard_normal(a.shape), -0.04,
                           0.04).astype(np.float32)
        if keys[-2].startswith(("norm", "qkv", "proj", "fc")) \
                or keys[-2] == "mlp":
            return (np.ones if keys[-1] == "scale" else np.zeros)(
                a.shape, np.float32)
        return b

    return jax.tree_util.tree_map_with_path(draw, shapes, base)


@pytest.mark.slow
def test_full_width_maniqa_matches_jax():
    """MANIQA at its published geometry (ViT-B/8 at 224, 4 taps, TABlocks
    over 784 tokens, two Swin stages) on one crop."""
    m = jmq.MANIQA()
    params = maniqa_reference_tree(jax.eval_shape(
        lambda: m.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))),
        11)
    pm = tmq.MANIQA().eval()
    pm.load_state_dict(from_jax(params), strict=True)
    x = np.random.default_rng(0).standard_normal(
        (1, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jax.jit(m.apply)(params, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert rel_err(got, want) <= 1e-4


@pytest.mark.slow
def test_full_width_clip_rn50x4_matches_jax():
    """CLIP RN50x4 (both towers) at one 288 px image and three captions."""
    m = jclip.CLIPModel()
    params = random_tree(jax.eval_shape(lambda: m.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 288, 288, 3)),
        jnp.zeros((1, 77), jnp.int32))), 12)
    pm = tclip.CLIPModel().eval()
    pm.load_state_dict(from_jax(params), strict=True)
    x = np.random.default_rng(0).standard_normal(
        (1, 288, 288, 3)).astype(np.float32)
    ids = np.zeros((2, 77), np.int32)
    ids[:, 0] = 49406
    ids[0, 1:4], ids[0, 4] = [320, 1125, 9023], 49407
    ids[1, 1:2], ids[1, 2] = [4160], 49407
    want_i = np.asarray(jax.jit(lambda p, a: m.apply(
        p, a, method=jclip.CLIPModel.encode_image))(params, x))
    want_t = np.asarray(jax.jit(lambda p, t: m.apply(
        p, t, method=jclip.CLIPModel.encode_text))(params, ids))
    with torch.no_grad():
        got_i = pm.encode_image(torch.from_numpy(x)).numpy()
        got_t = pm.encode_text(torch.from_numpy(ids).long()).numpy()
    assert rel_err(got_i, want_i) <= 1e-4
    assert rel_err(got_t, want_t) <= 1e-4
