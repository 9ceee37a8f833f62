"""The port's degradation synthesis (``image_restoration_agent_tpu_torch
.data``) against the JAX package's on the CPU: the same ``numpy.random
.Generator`` stream gives equal images, except the MATLAB-bicubic
``lowres``, whose float32 sums run in another order (at most one level on
at most 0.1% of the pixels)."""

import numpy as np
import pytest
import torch

from image_restoration_agent_tpu import data as jdata
from image_restoration_agent_tpu.offline import benchmark_suite as jsuite
from image_restoration_agent_tpu_torch import data as tdata
from image_restoration_agent_tpu_torch.offline import (
    benchmark_suite as tsuite)

torch.set_num_threads(1)

# the lowres tolerance: one level on at most 0.1% of the pixels
LOWRES_FRAC = 1e-3


def _clean(size: int = 96) -> np.ndarray:
    return jsuite.synthetic_hq(1, size=size, seed=3)[0]


def _assert_close_images(got: np.ndarray, want: np.ndarray, lowres: bool):
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    if not lowres:
        np.testing.assert_array_equal(got, want)
        return
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1
    assert (d > 0).mean() <= LOWRES_FRAC, (d > 0).mean()


def test_ops_are_the_jax_packages():
    assert list(tdata.DEGRADE_OPS) == list(jdata.DEGRADE_OPS)


@pytest.mark.parametrize("name", list(jdata.DEGRADE_OPS))
def test_each_op_matches_jax(name):
    img = _clean()
    want = jdata.apply_degradation(img, name, rng=np.random.default_rng(7))
    got = tdata.apply_degradation(img, name, rng=np.random.default_rng(7),
                                  device="cpu")
    _assert_close_images(got, want, name == "low resolution")


@pytest.mark.parametrize("keep_size", [False, True])
def test_lowres_both_ways(keep_size):
    img = _clean(128)
    want = jdata.lowres(img, keep_size=keep_size)
    got = tdata.lowres(img, keep_size=keep_size, device="cpu")
    _assert_close_images(got, want, True)


@pytest.mark.parametrize("noise_type", ["Gaussian", "Poisson"])
def test_noise_kinds_match_jax(noise_type):
    img = _clean()
    want = jdata.add_noise(img, noise_type, rng=np.random.default_rng(2))
    got = tdata.add_noise(img, noise_type, rng=np.random.default_rng(2))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("darken_type", ["constant shift",
                                         "gamma correction",
                                         "linear mapping"])
def test_darken_kinds_match_jax(darken_type):
    img = _clean()
    want = jdata.darken(img, darken_type, rng=np.random.default_rng(4))
    got = tdata.darken(img, darken_type, rng=np.random.default_rng(4))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("combo", jsuite.ALL_COMBOS)
def test_synthesize_combo_matches_jax(combo):
    """Each of the 16 combos on one suite image, one generator each side:
    the stream is drawn in the same order, so every later op sees the same
    draws."""
    img = _clean()
    want = jdata.synthesize_combo(img, combo, rng=np.random.default_rng(0))
    got = tdata.synthesize_combo(img, combo, rng=np.random.default_rng(0),
                                 device="cpu")
    _assert_close_images(got, want, "low resolution" in combo)


def test_synthetic_hq_and_combos_equal():
    assert tsuite.ALL_COMBOS == jsuite.ALL_COMBOS
    assert (tsuite.GROUP_A, tsuite.GROUP_B, tsuite.GROUP_C) == (
        jsuite.GROUP_A, jsuite.GROUP_B, jsuite.GROUP_C)
    for a, b in zip(tsuite.synthetic_hq(4, seed=1),
                    jsuite.synthetic_hq(4, seed=1)):
        np.testing.assert_array_equal(a, b)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tdata.synthesize_combo(_clean(), "noise")
    with pytest.raises(RuntimeError, match="cuda"):
        tdata.lowres(_clean())


def test_missing_cv2_is_named(monkeypatch):
    """No PIL fallback: without OpenCV an op raises naming it."""
    import builtins

    real = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError, match="cv2"):
        tdata.add_jpeg_artifacts(_clean(), 20)
