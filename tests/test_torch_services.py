"""The port's host services on the CPU: the DepictQA-contract evaluation
service and the DepictQAClient round trip, the worker controller, the
configuration tree, the playground (``/start`` -> ``/invoke`` ->
``/tree``), ``core/color.py`` against the JAX functions, and the native
codec binding and decode pool against the port's own codec (skipped where
``make -C native`` cannot build the library, as ``tests/test_native_io.py``
skips)."""

import json
import threading
import time
import urllib.parse
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.core import color as jcolor
from image_restoration_agent_tpu.utils import config as jconfig
from image_restoration_agent_tpu_torch.agent import build_default_executor
from image_restoration_agent_tpu_torch.agent.evaluators import (
    DepictQAClient, LocalEvaluator)
from image_restoration_agent_tpu_torch.api.controller import (
    LOTTERY, SHORTEST_QUEUE, Controller)
from image_restoration_agent_tpu_torch.api.eval_service import \
    make_eval_server
from image_restoration_agent_tpu_torch.api.playground import \
    make_playground_server
from image_restoration_agent_tpu_torch.core import (decode_pool, hsv_to_rgb,
                                                    io_native, rgb_to_hsv,
                                                    save_image)
from image_restoration_agent_tpu_torch.core import io as tio
from image_restoration_agent_tpu_torch.iqa import SeverityEvaluator
from image_restoration_agent_tpu_torch.utils import config as tconfig
from image_restoration_agent_tpu_torch.utils import misc

torch.set_num_threads(1)

LEVELS = ("very low", "low", "medium", "high", "very high")


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------------------
# evaluation service


@pytest.fixture(scope="module")
def evaluator():
    return LocalEvaluator(SeverityEvaluator.default(device="cpu"))


@pytest.fixture(scope="module")
def eval_server(evaluator):
    srv = make_eval_server(host="127.0.0.1", port=0, evaluator=evaluator)
    yield _serve(srv)
    srv.shutdown()
    srv.server_close()


def test_evaluate_degradation_contract(eval_server, evaluator, tmp_path):
    """The answer is the in-process evaluator's severity."""
    p = tmp_path / "x.png"
    save_image(np.random.default_rng(0).random((32, 32, 3),
                                               dtype=np.float32), p)
    out = _post(f"{eval_server}/evaluate_degradation",
                {"img_path": str(p), "degradation": "noise"})
    assert out["answer"] in LEVELS
    assert out["answer"] == evaluator.severity_of(p, "noise")


def test_compare_quality_contract(eval_server, evaluator, tmp_path):
    rng = np.random.default_rng(1)
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    save_image(rng.random((32, 32, 3), dtype=np.float32), a)
    save_image(rng.random((32, 32, 3), dtype=np.float32) * 0.3, b)
    out = _post(f"{eval_server}/compare_quality",
                {"img_path_A": str(a), "img_path_B": str(b)})
    want = {"former": "Image A", "latter": "Image B",
            "neither": "similar"}[evaluator.compare(a, b)]
    assert out["answer"] == want


def test_eval_service_errors(eval_server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{eval_server}/elsewhere", {})
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{eval_server}/evaluate_degradation", {"img_path": "/none"})
    assert e.value.code == 500
    with urllib.request.urlopen(f"{eval_server}/health") as r:
        assert json.loads(r.read()) == {"status": "ok"}


def test_depictqa_client_roundtrip(eval_server, evaluator, tmp_path):
    """The port's DepictQAClient interoperates with the port's service."""

    class _Session:  # stdlib adapter: no requests dependency
        def post(self, url, json=None, timeout=None):
            class R:
                def __init__(self, data):
                    self._d = data

                def json(self):
                    return self._d

            return R(_post(url, json))

    client = DepictQAClient(eval_url=eval_server, comp_url=eval_server,
                            session=_Session())
    p = tmp_path / "q.png"
    save_image(np.random.default_rng(2).random((32, 32, 3),
                                               dtype=np.float32), p)
    assert client.severity_of(p, "haze") == evaluator.severity_of(p, "haze")
    ev = client.evaluate(p)
    assert len(ev) == 7 and all(level in LEVELS for _, level in ev)
    assert client.compare(p, p) in ("former", "latter", "neither")


# ---------------------------------------------------------------------------
# controller (a copy of the JAX package's, stdlib only)


def test_controller_dispatch():
    c = Controller(SHORTEST_QUEUE)
    c.register_worker("a", "http://a")
    c.register_worker("b", "http://b")
    c.heartbeat("a", queue_length=5)
    c.heartbeat("b", queue_length=0)
    assert c.get_worker_address() == "http://b"
    c = Controller(SHORTEST_QUEUE)
    c.register_worker("slow", "http://s", speed=1.0)
    c.register_worker("fast", "http://f", speed=10.0)
    c.heartbeat("slow", 1)
    c.heartbeat("fast", 5)  # 5/10 < 1/1
    assert c.get_worker_address() == "http://f"
    c = Controller(LOTTERY, seed=0)
    c.register_worker("a", "http://a", speed=9.0)
    c.register_worker("b", "http://b", speed=1.0)
    picks = [c.get_worker_address() for _ in range(200)]
    assert picks.count("http://a") > 140
    assert Controller().heartbeat("ghost", 0) is False


def test_controller_drops_stale_workers():
    c = Controller(heartbeat_expiry_s=0.0)
    c.register_worker("a", "http://a")
    time.sleep(0.01)
    assert c.get_worker_address() is None
    assert c.list_workers() == {}


# ---------------------------------------------------------------------------
# configuration


def test_config_defaults_and_tree_match_jax():
    cfg = tconfig.load_config(None)
    assert cfg.api.port == 1146
    assert cfg.retrieval.similarity_threshold == 0.9
    assert tconfig.dataclasses.asdict(cfg) == \
        jconfig.dataclasses.asdict(jconfig.load_config(None))


def test_config_yaml_merge_and_overrides(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("engine:\n  hbm_budget_gb: 8\napi:\n  port: 9999\n")
    ov = ["agent.with_rollback=false", "engine.default_batch=16"]
    cfg = tconfig.load_config(p, overrides=ov)
    assert cfg.engine.hbm_budget_gb == 8 and cfg.api.port == 9999
    assert cfg.llm.provider == "mock"  # untouched default
    assert cfg.agent.with_rollback is False
    assert cfg.engine.default_batch == 16
    assert tconfig.dataclasses.asdict(cfg) == \
        jconfig.dataclasses.asdict(jconfig.load_config(p, overrides=ov))


def test_config_rejects_unknown_keys(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("enginee:\n  foo: 1\n")
    with pytest.raises(KeyError):
        tconfig.load_config(p)
    with pytest.raises(KeyError):
        tconfig.load_config(None, overrides=["agent.nonexistent=1"])


def test_misc_helpers(tmp_path):
    for name in ("b.png", "a.png", "c.txt"):
        (tmp_path / name).write_bytes(name.encode())
    assert [p.name for p in misc.sorted_glob(tmp_path, "*.png")] == \
        ["a.png", "b.png"]
    assert misc.encode_image_base64(tmp_path / "a.png") == "YS5wbmc="


# ---------------------------------------------------------------------------
# playground


@pytest.fixture(scope="module")
def playground(tmp_path_factory):
    root = tmp_path_factory.mktemp("pg")
    srv = make_playground_server(
        host="127.0.0.1", port=0, work_root=root / "work",
        executor=build_default_executor(fast=True, device="cpu"))
    yield srv, _serve(srv), root
    srv.shutdown()
    srv.server_close()


def test_playground_start_invoke_tree(playground):
    _, base, root = playground
    src = root / "input.png"
    save_image(np.random.default_rng(3).random((24, 24, 3),
                                               dtype=np.float32), src)
    with urllib.request.urlopen(f"{base}/") as r:
        assert b"playground" in r.read()
    assert _post(f"{base}/start", {"image_path": str(src)})["ok"]
    with urllib.request.urlopen(f"{base}/tree") as r:
        tree = json.loads(r.read())
    assert tree["nodes"] == [{"path": ""}]
    assert "brightening" in tree["toolboxes"]
    out = _post(f"{base}/invoke", {"node": "", "subtask": "brightening",
                                   "tool": "gamma_correction"})
    assert out["ok"]
    out = _post(f"{base}/invoke", {"node": "", "subtask": "denoising",
                                   "tool": "nafnet_small"})
    assert out["ok"]
    with urllib.request.urlopen(f"{base}/tree") as r:
        tree = json.loads(r.read())
    assert len(tree["nodes"]) == 3
    node = tree["nodes"][1]["path"]
    with urllib.request.urlopen(
            f"{base}/image?node={urllib.parse.quote(node)}") as r:
        assert r.read()[:4] == b"\x89PNG"


# ---------------------------------------------------------------------------
# colour


def test_color_round_trip_matches_jax():
    """Random pixels plus grey (delta 0), black, white and the primaries:
    HSV within 1e-5 of the JAX functions (H in degrees within 1e-3), and
    back to RGB within 1e-5."""
    rng = np.random.default_rng(4)
    px = np.concatenate([
        rng.random((200, 3)),
        np.array([[0, 0, 0], [1, 1, 1], [0.4, 0.4, 0.4], [1, 0, 0],
                  [0, 1, 0], [0, 0, 1], [1, 1, 0], [0.2, 0.5, 0.5]]),
    ]).astype(np.float32).reshape(2, 104, 3)
    hsv = rgb_to_hsv(torch.from_numpy(px)).numpy()
    want = np.array(jcolor.rgb_to_hsv(jnp.asarray(px)))
    np.testing.assert_allclose(hsv[..., 0], want[..., 0], atol=1e-3, rtol=0)
    np.testing.assert_allclose(hsv[..., 1:], want[..., 1:], atol=1e-5,
                               rtol=0)
    grey = hsv.reshape(-1, 3)[200:203]
    assert (grey[:, :2] == 0).all()  # black, white and grey: H = S = 0
    back = hsv_to_rgb(torch.from_numpy(want)).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jcolor.hsv_to_rgb(jnp.asarray(want))), atol=1e-5,
        rtol=0)
    np.testing.assert_allclose(back, px, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# native codec and decode pool


@pytest.fixture
def native():
    if not io_native.available():
        pytest.skip("native codec not built (make -C native failed)")
    return io_native


def _blobs():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:40, 0:56]
    grad = np.stack([xx * 4, yy * 6, (xx + yy) * 2], -1).astype(np.uint8)
    return [tio.encode_png((rng.random((33, 47, 3)) * 255).astype(np.uint8)),
            tio.encode_png(grad)]


def test_native_codec_matches_the_port_codec(native):
    """The same bytes decode to the same pixels in both codecs, and the
    native encoder's bytes decode in the port's codec to the image."""
    for blob in _blobs():
        img = tio.decode_image(blob)
        np.testing.assert_array_equal(native.decode_png(blob), img)
        np.testing.assert_array_equal(
            tio.decode_image(native.encode_png(img)), img)
    padded = native.u8_to_f32_pad(img, 48, 64)
    assert padded.shape == (48, 64, 3) and (padded[40:] == 0).all()
    # the native loop multiplies by 1/255 where to_float divides
    np.testing.assert_allclose(padded[:40, :56], tio.to_float(img),
                               atol=1e-7, rtol=0)


def test_decode_pool_matches_the_port_codec(native, tmp_path):
    pool = decode_pool.DecodePool(workers=2)
    blobs = _blobs()
    want = [tio.decode_image(b) for b in blobs]
    for got, w in zip(pool.decode_many(blobs), want):
        np.testing.assert_array_equal(got, w)
    paths = []
    for i, b in enumerate(blobs):
        paths.append(tmp_path / f"{i}.png")
        paths[-1].write_bytes(b)
    for got, w in zip(pool.load_many(paths, as_float=True), want):
        np.testing.assert_array_equal(got, tio.to_float(w))
    np.testing.assert_array_equal(pool.submit(blobs[0]).result(), want[0])
    with pytest.raises(Exception):
        pool.decode(b"not a png")
