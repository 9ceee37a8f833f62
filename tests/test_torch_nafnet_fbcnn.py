"""Port parity for the agent chain's restoration models and resize: the
MATLAB / torch bicubic resizes, NAFNet and FBCNN of
image_restoration_agent_tpu_torch against the JAX package with carried
weights, their strict loads of the golden key lists and the
synthetic-weight materializer (K3 at the shapes these models give it is
held on the card in tests/test_torch_kernels.py)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.core import resize as jresize
from image_restoration_agent_tpu.models import build_model as jbuild
from image_restoration_agent_tpu_torch.convert import from_jax
from image_restoration_agent_tpu_torch.core import resize as tresize
from image_restoration_agent_tpu_torch.core.tiling import tiled_apply
from image_restoration_agent_tpu_torch.models import (MODEL_REGISTRY,
                                                      build_model)
from image_restoration_agent_tpu_torch.offline import (
    GOLDEN_ROOT, load_golden, materialize_synthetic_weights, psnr)

torch.set_num_threads(1)


def _rng(seed):
    return np.random.default_rng(seed)


def randomize(tree, seed: int):
    """Every leaf of a JAX parameter tree (or of its shapes) drawn from a
    numpy seed: kernels fan-in scaled, vectors (norm scales, biases, the
    NAFNet beta/gamma that Flax initialises to zero) N(0, 0.1), so no branch
    of the network is an identity."""
    rng = _rng(seed)

    def draw(a):
        n = rng.standard_normal(a.shape).astype(np.float32)
        if len(a.shape) <= 1:
            return 0.1 * n
        return (n / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)

    return jax.tree.map(draw, tree)


def _carried(name, hw, seed, **call):
    """(JAX params, the port's model with the same weights) of a registered
    model, initialised at ``hw``."""
    m_j = jbuild(name)
    params = jax.eval_shape(lambda: m_j.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3), jnp.float32), **call))
    params = randomize(params, seed)
    m_t = build_model(name, device="cpu")
    m_t.load_state_dict(from_jax(params), strict=True)
    return m_j, params, m_t


def _close(got, want):
    assert got.shape == want.shape
    tol = 1e-4 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


# ---------------------------------------------------------------------------
# resize


@pytest.mark.parametrize("hw,out", [((37, 53), (224, 224)),
                                    ((300, 300), (224, 224))],
                         ids=["up", "down-antialias"])
def test_resize_matlab_matches_jax(hw, out):
    img = _rng(1).random((*hw, 3), dtype=np.float32)
    want = np.asarray(jresize.resize_matlab(jnp.asarray(img),
                                            out_shape=out))
    got = tresize.resize_matlab(torch.from_numpy(img), out_shape=out).numpy()
    assert got.shape == want.shape == (*out, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_resize_bicubic_torch_matches_jax_and_interpolate():
    """The torch-convention resize against the JAX one and against
    ``F.interpolate(mode="bicubic", align_corners=False)`` itself."""
    img = _rng(2).random((2, 13, 17, 3), dtype=np.float32)
    want = np.asarray(jresize.resize_bicubic_torch(jnp.asarray(img), 2.0))
    got = tresize.resize_bicubic_torch(torch.from_numpy(img), 2.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(img).permute(0, 3, 1, 2), scale_factor=2,
        mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# NAFNet and FBCNN against the JAX package


@pytest.mark.parametrize("hw", [(45, 61), (64, 64)],
                         ids=["internal-pad", "multiple"])
def test_nafnet_small_matches_jax(hw):
    m_j, params, m_t = _carried("nafnet_small", hw, seed=3)
    x = _rng(4).random((1, *hw, 3), dtype=np.float32)
    want = np.asarray(jax.jit(m_j.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = m_t(torch.from_numpy(x)).numpy()
    _close(got, want)


@pytest.mark.parametrize("qf", [None, 0.3], ids=["blind", "pinned-qf"])
def test_fbcnn_tiny_matches_jax(qf):
    """Blind and with a pinned quality factor at 30x34 (the edge pad to 8):
    every decoder level passes through a transposed conv, so this pins the
    mapping of its Flax kernel onto torch's (I, O, 2, 2) taps."""
    call = {} if qf is None else {"qf_input": qf}
    m_j, params, m_t = _carried("fbcnn_tiny", (32, 40), seed=5, **call)
    x = _rng(6).random((1, 30, 34, 3), dtype=np.float32)
    want = np.asarray(jax.jit(m_j.apply)(params, jnp.asarray(x), **call))
    with torch.no_grad():
        got = m_t(torch.from_numpy(x), **call).numpy()
    _close(got, want)


def test_fbcnn_pinned_models_keep_the_reference_names():
    """fbcnn_qf5 / fbcnn_qf90 serve the blind checkpoint's names and run
    with their fixed quality factor; the JAX tree of a pinned model (under
    ``inner``) carries across."""
    tiny = MODEL_REGISTRY["fbcnn_tiny"].config
    m_j = jbuild("fbcnn_qf90", **tiny)
    params = randomize(jax.eval_shape(lambda: m_j.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))), seed=7)
    assert set(params["params"]) == {"inner"}
    m_t = build_model("fbcnn_qf90", device="cpu", **tiny)
    m_t.load_state_dict(from_jax(params), strict=True)
    blind = build_model("fbcnn_blind", device="cpu", **tiny)
    assert set(m_t.state_dict()) == set(blind.state_dict())
    x = _rng(8).random((1, 16, 16, 3), dtype=np.float32)
    want = np.asarray(jax.jit(m_j.apply)(params, jnp.asarray(x)))
    blind.load_state_dict(m_t.state_dict())
    with torch.no_grad():
        got = m_t(torch.from_numpy(x)).numpy()
        pinned = blind(torch.from_numpy(x), qf_input=0.9).numpy()
    _close(got, want)
    np.testing.assert_array_equal(got, pinned)


@pytest.mark.parametrize("model,golden", [("nafnet", "nafnet_synth"),
                                          ("fbcnn_blind", "fbcnn_synth")])
def test_golden_key_lists_load_strictly(model, golden):
    """The full-width models' parameter names and shapes are exactly the
    reference state-dict list of the golden (meta device, no forward)."""
    spec = json.loads((GOLDEN_ROOT / golden / "spec.json").read_text())
    reg = MODEL_REGISTRY[model]
    with torch.device("meta"):
        m = reg.build(**reg.config)
    m.load_state_dict({k: torch.empty(s, device="meta")
                       for k, s in spec["state"]}, strict=True, assign=True)
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == \
        {k: tuple(s) for k, s in spec["state"]}


def test_materialize_synthetic_weights_serve_strictly(tmp_path):
    """The materializer writes ``<model>.npz`` the engine loads with no
    random-init fallback; the values are the golden spec's."""
    from image_restoration_agent_tpu_torch.engine import Engine
    from image_restoration_agent_tpu_torch.offline import build_state
    out = materialize_synthetic_weights(tmp_path, names=["nafnet_synth"])
    assert out == {"nafnet": tmp_path / "nafnet.npz"}
    spec = json.loads((GOLDEN_ROOT / "nafnet_synth" / "spec.json")
                      .read_text())
    with np.load(out["nafnet"]) as z:
        state = build_state(spec)
        assert set(z.files) == set(state)
        np.testing.assert_array_equal(z["intro.weight"],
                                      state["intro.weight"])
    eng = Engine(weight_dir=tmp_path, device="cpu", allow_random_init=False)
    m = eng.store.get("nafnet")
    np.testing.assert_array_equal(m.ending.bias.detach().numpy(),
                                  state["ending.bias"])
    with pytest.raises(FileNotFoundError):
        eng.store.get("fbcnn_blind")


# ---------------------------------------------------------------------------
# the real-geometry goldens on the port's CPU path


@pytest.mark.slow
@pytest.mark.parametrize("model,golden", [("nafnet", "nafnet_synth"),
                                          ("fbcnn_blind", "fbcnn_synth")])
def test_golden_f32_cpu(model, golden):
    """NAFNet width 32 (2/2/4/8, 12 middle blocks) and FBCNN 64..512 (nb 4)
    at 256x256 reach the recorded PSNR within 0.1 dB against the
    independent torch reference output."""
    torch.set_num_threads(4)
    g = load_golden(GOLDEN_ROOT / golden)
    m = build_model(model, device="cpu")
    m.load_state_dict({k: torch.from_numpy(v)
                       for k, v in g["state"].items()}, strict=True)
    spec = MODEL_REGISTRY[model]
    with torch.no_grad():
        out = tiled_apply(m, torch.from_numpy(g["input"]), tile=None,
                          pad_multiple=spec.pad_multiple,
                          pad_kind=spec.pad_kind)
    db = psnr(np.clip(out.numpy(), 0, 1), g["expected"])
    assert db >= g["spec"]["psnr_db"] - 0.1, db
