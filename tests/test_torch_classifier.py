"""Port parity for the agent's degradation classifier: the analytic priors
(``degradation_features``), the v4 classifier's logits and severities, and
the committed weights file, held against the JAX package's
``iqa/classifier.py`` and its orbax checkpoint."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.iqa import classifier as jcls
from image_restoration_agent_tpu_torch.convert import (from_jax,
                                                       read_flat_npz,
                                                       write_flat_npz)
from image_restoration_agent_tpu_torch.iqa import classifier as tcls

torch.set_num_threads(1)

FEATURES = ["mean", "q05", "q50", "q95", "var", "lap_mad", "chk", "grad_e",
            "grad_p95", "aniso", "fine_e", "hf_ratio", "blockiness",
            "block_c", "off_c", "block_r", "off_r", "dark", "sat",
            "contrast", "rain", "streak_p99"]


def _images() -> list[np.ndarray]:
    """Four seeded images: uniform noise (odd size), a noisy gradient, one
    with an even pixel count whose left half is flat black (so the
    Laplacian's median falls between two values, which jnp.median
    averages), and 8x8 blocks (JPEG-like).

    The flat half is black, not grey: on a flat grey region the local
    variance ``E[x^2] - E[x]^2`` is a difference of rounding errors, and its
    square root (the contrast prior) then differs between XLA's and
    PyTorch's summation orders by about 3e-4 of the feature (measured at
    0.4 grey), in the reference's formula itself."""
    rng = np.random.default_rng(21)
    noise = rng.random((181, 243, 3), dtype=np.float32)
    yy, xx = np.mgrid[0:200, 0:260] / 260.0
    grad = np.clip(np.stack([yy, xx, 0.5 * (yy + xx)], -1)
                   + 0.05 * rng.standard_normal((200, 260, 3)), 0, 1)
    half = np.zeros((192, 256, 3), np.float32)
    half[:, 128:] = rng.random((192, 128, 3))
    blocks = np.kron(rng.random((25, 30, 3)), np.ones((8, 8, 1)))
    return [a.astype(np.float32) for a in (noise, grad, half, blocks)]


def test_the_median_case_has_a_tie_to_average():
    img = _images()[2]
    lum = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    lap = np.abs(np.asarray(jcls._conv2(jnp.asarray(lum[None]),
                                        [[0, 1, 0], [1, -4, 1],
                                         [0, 1, 0]])))[0].ravel()
    s = np.sort(lap)
    n = s.size
    assert n % 2 == 0 and s[n // 2 - 1] != s[n // 2]


@pytest.mark.parametrize("i", range(4), ids=["noise", "gradient",
                                             "half-flat", "blocks"])
def test_degradation_features_match_jax(i):
    img = _images()[i]
    want = np.asarray(jcls.degradation_features(jnp.asarray(img[None])))[0]
    got = tcls.degradation_features(torch.from_numpy(img[None])).numpy()[0]
    assert got.shape == want.shape == (len(FEATURES),)
    tol = 1e-4 * float(np.abs(want).max())
    bad = {FEATURES[k]: (float(got[k]), float(want[k]))
           for k in range(len(FEATURES)) if abs(got[k] - want[k]) > tol}
    assert not bad, bad


def _half_grey(level: float) -> np.ndarray:
    """The half-flat image with its flat half grey at ``level``."""
    img = _images()[2].copy()
    img[:, :128] = level
    return img


# On flat grey the contrast prior is the square root of a difference of
# rounding errors (see ``_images``): 7.5e-4 apart at 0.4 grey (1.6e-4 of
# the largest feature), so it alone is held to 5e-4 of the largest feature.
CONTRAST_TOL = 5e-4


@pytest.mark.parametrize("level", [0.4, 0.73])
def test_flat_grey_features_and_logits_match_jax(jax_default, port_default,
                                                 level):
    """Flat grey areas: every feature but the contrast prior within the
    usual tolerance, the contrast prior within ``CONTRAST_TOL``, and the
    logits still within 1e-4 of their largest with every severity equal."""
    img = _half_grey(level)
    want = np.asarray(jcls.degradation_features(jnp.asarray(img[None])))[0]
    got = tcls.degradation_features(torch.from_numpy(img[None])).numpy()[0]
    scale = float(np.abs(want).max())
    c = FEATURES.index("contrast")
    bad = {FEATURES[k]: (float(got[k]), float(want[k]))
           for k in range(len(FEATURES))
           if abs(got[k] - want[k]) > (CONTRAST_TOL if k == c else 1e-4)
           * scale}
    assert not bad, bad
    want = jax_default.logits(img)
    got = port_default.logits(img)
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert port_default.evaluate(img) == jax_default.evaluate(img)


@pytest.fixture(scope="module")
def jax_default():
    return jcls.SeverityEvaluator.default()


@pytest.fixture(scope="module")
def port_default():
    return tcls.SeverityEvaluator.default(device="cpu")


def test_weights_file_equals_the_orbax_restore(jax_default):
    """The committed .npz is the JAX default()'s v4 tree, bit for bit."""
    want = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jax_default.params["params"]))[0])
    got = read_flat_npz(tcls.WEIGHTS)
    assert type(jax_default.model).__name__ == "DegradationClassifierV3"
    assert jax_default.input_size == 224
    flat = {jax.tree_util.keystr(k): v for k, v in want.items()}
    assert len(flat) == sum(len(v) for v in got.values())
    n = 0
    for module, leaves in got.items():
        for leaf, arr in leaves.items():
            ref = flat[f"['{module}']['{leaf}']"]
            assert arr.dtype == ref.dtype and arr.shape == ref.shape
            np.testing.assert_array_equal(arr, ref)
            n += arr.size
    assert n == 714792


@pytest.mark.parametrize("i", range(4), ids=["noise", "gradient",
                                             "half-flat", "blocks"])
def test_classifier_logits_match_jax(jax_default, port_default, i):
    img = _images()[i]
    want = jax_default.logits(img)
    got = port_default.logits(img)
    assert got.shape == want.shape == (8, 5)
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert port_default.evaluate(img) == jax_default.evaluate(img)
    for d in tcls.DEGRADATIONS:
        assert port_default.severity_of(img, d) == \
            jax_default.severity_of(img, d)
        lvl, p = port_default.severity_with_confidence(img, d)
        lvl_j, p_j = jax_default.severity_with_confidence(img, d)
        assert lvl == lvl_j and abs(p - p_j) <= 1e-4


def test_logit_cache_keys_on_the_whole_buffer(port_default):
    """A change to one pixel off any sparse grid is a new forward."""
    img = _images()[0].copy()
    a = port_default.logits(img).copy()
    img[101, 77, 1] = 1.0 - img[101, 77, 1]
    b = port_default.logits(img)
    assert not np.array_equal(a, b)


def test_default_is_one_instance_per_device(port_default):
    assert tcls.SeverityEvaluator.default(device="cpu") is port_default
    assert port_default.device.type == "cpu"
    assert tcls.SEVERITY_LEVELS == jcls.SEVERITY_LEVELS
    assert tcls.DEGRADATIONS == jcls.DEGRADATIONS
    assert tcls.EVALUATED_DEGRADATIONS == jcls.EVALUATED_DEGRADATIONS


# ---------------------------------------------------------------------------
# the V1 and V5 architectures, the in-tree checkpoints, default()'s order

JAX_WEIGHTS = Path(jcls.__file__).resolve().parents[1] / "weights"

# every in-tree checkpoint: (directory, JAX architecture, input size); the
# v5 run's .arch marker says softmax, so its head is V3's
CHECKPOINTS = [("degradation_classifier", jcls.DegradationClassifier, 160),
               ("degradation_classifier_v2", jcls.DegradationClassifier, 224),
               ("degradation_classifier_v3", jcls.DegradationClassifierV3,
                224),
               ("degradation_classifier_v5_final",
                jcls.DegradationClassifierV3, 224)]


@pytest.mark.parametrize("name,arch,size", CHECKPOINTS,
                         ids=[c[0] for c in CHECKPOINTS])
def test_in_tree_checkpoints_carry_across(tmp_path, name, arch, size):
    """Restore the orbax checkpoint with the JAX package, write it as the
    port's flat .npz, serve it with ``from_npz`` (the architecture read
    from the tree) and compare logits and severities."""
    if name.endswith("v5_final"):
        marker = JAX_WEIGHTS / f"{name}.arch"
        assert marker.read_text().strip() == "softmax"
    jev = jcls.SeverityEvaluator.from_checkpoint(
        JAX_WEIGHTS / name, input_size=size, model=arch())
    path = tmp_path / f"{name}.npz"
    write_flat_npz(jax.tree.map(np.asarray, jev.params), path)
    tev = tcls.SeverityEvaluator.from_npz(path, input_size=size,
                                          device="cpu")
    assert type(tev.model).__name__ == arch.__name__
    for img in _images()[:2]:
        want, got = jev.logits(img), tev.logits(img)
        assert got.shape == want.shape == (8, 5)
        assert float(np.abs(got - want).max()) <= \
            1e-4 * float(np.abs(want).max())
        assert tev.evaluate(img) == jev.evaluate(img)


def _random_params(model, size, seed):
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))
    rng = np.random.default_rng(seed)

    def draw(a):
        n = rng.standard_normal(a.shape).astype(np.float32)
        return 0.3 * n if len(a.shape) <= 1 else \
            n / np.sqrt(np.prod(a.shape[:-1])).astype(np.float32)

    return jax.tree.map(draw, shapes)


@pytest.mark.parametrize("arch", ["v1", "v5"])
def test_v1_and_v5_architectures_match_jax(arch):
    """V1 and the CORAL head of V5 on random weights (no in-tree CORAL
    checkpoint): logits / level log-probs and the cumulative logits."""
    jm = {"v1": jcls.DegradationClassifier,
          "v5": jcls.DegradationClassifierV5}[arch]()
    params = _random_params(jm, 64, 3)
    pm = {"v1": tcls.DegradationClassifier,
          "v5": tcls.DegradationClassifierV5}[arch]().eval()
    state = from_jax(params)
    assert tcls.architecture_of(state) is type(pm)
    pm.load_state_dict(state, strict=True)
    x = np.stack([im[:64, :64] for im in _images()[:2]])
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8, 5)
    assert float(np.abs(got - want).max()) <= \
        1e-4 * float(np.abs(want).max())
    if arch == "v5":
        want = np.asarray(jm.apply(params, jnp.asarray(x), cumulative=True))
        with torch.no_grad():
            got = pm(torch.from_numpy(x), cumulative=True).numpy()
        assert got.shape == (2, 8, 4)
        assert float(np.abs(got - want).max()) <= \
            1e-4 * float(np.abs(want).max())


def test_prepare_input_matches_jax():
    img = _images()[0]
    want = jcls.prepare_input(img, 160)
    got = tcls.prepare_input(img, 160)
    assert got.shape == want.shape == (160, 160, 3)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5


def test_default_search_order(tmp_path, monkeypatch):
    """The JAX package's order over a weights directory: the v5 slot (its
    .arch marker: coral, the default, or softmax), v4, v3, v2, the 160 px
    v1; random weights where none is there."""
    monkeypatch.setattr(tcls.SeverityEvaluator, "_default", {})
    v1 = _random_params(jcls.DegradationClassifier(), 64, 2)
    v3 = _random_params(jcls.DegradationClassifierV3(), 64, 1)
    v5 = _random_params(jcls.DegradationClassifierV5(), 64, 4)

    def pick(files: dict, marker=None):
        d = tmp_path / f"w{len(list(tmp_path.iterdir()))}"
        d.mkdir()
        for stem, params in files.items():
            write_flat_npz(params, d / f"{stem}.npz")
        if marker is not None:
            (d / "degradation_classifier_v5.arch").write_text(marker + "\n")
        ev = tcls.SeverityEvaluator.default(device="cpu", weights=d)
        return type(ev.model).__name__, ev.input_size

    every = {"degradation_classifier_v4": v3,
             "degradation_classifier_v3": v3,
             "degradation_classifier_v2": v1, "degradation_classifier": v1}
    assert pick({**every, "degradation_classifier_v5": v5}) == \
        ("DegradationClassifierV5", 224)
    assert pick({**every, "degradation_classifier_v5": v3}, "softmax") == \
        ("DegradationClassifierV3", 224)
    assert pick(every) == ("DegradationClassifierV3", 224)
    assert pick({"degradation_classifier_v2": v1,
                 "degradation_classifier": v1}) == \
        ("DegradationClassifier", 224)
    assert pick({"degradation_classifier": v1}) == \
        ("DegradationClassifier", 160)
    assert pick({}) == ("DegradationClassifierV3", 224)  # random init
    # the port's own weights/ holds v4 alone: v4 is what default() serves
    assert sorted(p.name for p in tcls.WEIGHTS.parent.glob("*.npz")) == \
        ["degradation_classifier_v4.npz"]
