"""The port's HTTP API (``image_restoration_agent_tpu_torch/api/server.py``)
on a loopback port, on the CPU: the reference contract of the JAX package's
``tests/test_api.py`` (health with the engine's status and the native
codec, 400 / 403 / 404, byte-exact multipart, a corrupt upload rejected at
the door, JSON and multipart /process with /download), and one /process
request through the port's server and the JAX server on the same input,
the same fast toolboxes and the same tiny weights."""

import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu_torch.agent import build_default_executor
from image_restoration_agent_tpu_torch.api import make_server
from image_restoration_agent_tpu_torch.api.server import _parse_multipart
from image_restoration_agent_tpu_torch.core import io_native, save_image
from image_restoration_agent_tpu_torch.core import io as tio
from image_restoration_agent_tpu_torch.engine import Engine

torch.set_num_threads(1)


def _serve(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("api")
    eng = Engine(device="cpu")
    srv = make_server(host="127.0.0.1", port=0, work_root=root,
                      engine_status=eng.status, device="cpu",
                      executor=build_default_executor(engine=eng, fast=True))
    yield srv, _serve(srv)
    srv.shutdown()
    srv.server_close()


@pytest.fixture
def input_png(server):
    # inside the server work root: image_path references outside it are 403
    p = Path(server[0].app.work_root) / "uploads" / "img.png"
    rng = np.random.default_rng(0)
    save_image(rng.random((32, 40, 3), dtype=np.float32), p)
    return p


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(url, body, ctype):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_json(url, obj):
    return _post(url, json.dumps(obj).encode(), "application/json")


def _multipart(filename, data, boundary="----testboundary42"):
    body = (f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="file"; '
            f'filename="{filename}"\r\n'
            f"Content-Type: image/png\r\n\r\n").encode() + data + \
        f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def test_health_reports_engine_and_codec(server):
    _, base = server
    code, body = _get(f"{base}/health")
    out = json.loads(body)
    assert code == 200 and out["status"] == "ok"
    assert out["device"] == "cpu" and out["device_name"] == "cpu"
    assert out["models_registered"] > 30
    assert out["io_native"] is io_native.available()


def test_process_missing_image_400(server):
    _, base = server
    code, body = _post_json(f"{base}/process",
                            {"image_path": "/nonexistent.png"})
    assert code == 400 and body["status"] == "error"


def test_download_unknown_404(server):
    _, base = server
    assert _get(f"{base}/download/nope")[0] == 404
    assert _get(f"{base}/nothing")[0] == 404
    code, _ = _post_json(f"{base}/elsewhere", {})
    assert code == 404


def test_process_path_outside_roots_403(server, tmp_path):
    _, base = server
    p = tmp_path / "outside.png"
    save_image(np.zeros((16, 16, 3), np.float32), p)
    code, body = _post_json(f"{base}/process", {"image_path": str(p)})
    assert code == 403 and body["status"] == "error"


@pytest.mark.parametrize("tail", [b"-", b"\r", b"\n", b"\r\n", b"--\r\n"])
def test_multipart_trailing_dash_preserved(tail):
    """Uploads whose payload ends in '-', CR or LF round-trip byte-exact
    through the multipart parser (the JAX package's split rule)."""
    from image_restoration_agent_tpu.api.server import \
        _parse_multipart as jparse
    payload = b"\x89PNGdata" + tail
    body, ctype = _multipart("x.bin", payload, boundary="----b7")
    assert _parse_multipart(body, ctype)["file"][1] == payload
    assert _parse_multipart(body, ctype) == jparse(body, ctype)


def test_corrupt_upload_rejected(server):
    """A payload that is not an image is refused at the door (the decode
    pool fails on it): a 500 with the reason, and nothing kept."""
    srv, base = server
    before = set((srv.app.work_root / "uploads").iterdir())
    body, ctype = _multipart("bad.png", b"\x89PNG\r\n\x1a\nnot an image")
    code, out = _post(f"{base}/process", body, ctype)
    assert code == 500 and out["status"] == "error"
    assert "not a decodable image" in out["message"]
    assert set((srv.app.work_root / "uploads").iterdir()) == before


def test_jpeg_upload_is_served(server, input_png):
    """A JPEG upload of the input is accepted at the door, kept as it was
    sent, and served: a 200 with a plan, and /download returns the final
    PNG byte for byte."""
    import cv2

    srv, base = server
    img = tio.load_image(input_png)
    jpg = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]),
                       [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()
    code, out = _post(f"{base}/process", *_multipart("up.jpg", jpg))
    assert code == 200 and out["status"] == "success", out
    assert out["initial_plan"]
    kept = [p for p in (srv.app.work_root / "uploads").iterdir()
            if p.name.endswith("_up.jpg")]
    assert len(kept) == 1 and kept[0].read_bytes() == jpg
    code, png = _get(f"{base}/download/{out['task_id']}")
    assert code == 200 and png == Path(out["output_path"]).read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


def test_process_json_multipart_and_download(server, input_png):
    """JSON image_path, then the same bytes uploaded: both succeed with the
    same plan, and /download returns the final PNG byte for byte."""
    srv, base = server
    code, a = _post_json(f"{base}/process", {"image_path": str(input_png)})
    assert code == 200 and a["status"] == "success", a
    assert a["initial_plan"]
    code, png = _get(f"{base}/download/{a['task_id']}")
    assert code == 200 and png == Path(a["output_path"]).read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    code, b = _post(f"{base}/process", *_multipart(
        "up.png", input_png.read_bytes()))
    assert code == 200 and b["status"] == "success", b
    assert b["initial_plan"] == a["initial_plan"]
    assert b["subtask_success"] == a["subtask_success"]
    assert srv.app.tasks[b["task_id"]] == b


# ---------------------------------------------------------------------------
# the port's server against the JAX server

_FAST_MODELS = ("swinir_tiny", "nafnet_small", "restormer_tiny")


def _randomize(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(a):
        n = rng.standard_normal(a.shape).astype(np.float32)
        if len(a.shape) <= 1:
            return 0.05 * n
        return (0.5 * n / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)

    return jax.tree.map(draw, shapes)


def test_process_matches_the_jax_server(tmp_path):
    """The fast toolboxes (swinir_tiny, nafnet_small, restormer_tiny) with
    the same random weights in both engines, the same noisy 96 x 96 input:
    the port's /process gives the JAX server's initial_plan and
    subtask_success (a five-step plan, super-resolution included), and its
    output pixels lie within 2 levels of 255 of the JAX output's (measured
    1: the tools' float32 results differ by rounding, and each PNG round
    trip rounds to uint8)."""
    from image_restoration_agent_tpu.agent import executor as jexec
    from image_restoration_agent_tpu.api import make_server as jmake
    from image_restoration_agent_tpu.convert.torch_import import \
        save_as_orbax
    from image_restoration_agent_tpu.engine import Engine as JEngine
    from image_restoration_agent_tpu.models import build_model as jbuild
    from image_restoration_agent_tpu_torch.convert import from_jax

    (tmp_path / "port").mkdir()
    for seed, name in enumerate(_FAST_MODELS):
        m = jbuild(name)
        params = _randomize(jax.eval_shape(lambda m=m: m.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))), seed)
        save_as_orbax(params, tmp_path / "jax" / name)
        np.savez(tmp_path / "port" / f"{name}.npz",
                 **{k: v.numpy() for k, v in from_jax(params).items()})
    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:96, 0:96] / 96.0
    clean = np.stack([yy, xx, 0.5 + 0.5 * np.sin(6 * yy * xx)], -1)
    noisy = np.clip(clean + rng.normal(0.0, 25.0 / 255.0, clean.shape),
                    0.0, 1.0).astype(np.float32)

    jeng = JEngine(weight_dir=tmp_path / "jax", allow_random_init=False)
    teng = Engine(weight_dir=tmp_path / "port", device="cpu",
                  allow_random_init=False)
    servers = [
        jmake(host="127.0.0.1", port=0, work_root=tmp_path / "jw",
              executor=jexec.build_default_executor(engine=jeng, fast=True)),
        make_server(host="127.0.0.1", port=0, work_root=tmp_path / "tw",
                    device="cpu", engine_status=teng.status,
                    executor=build_default_executor(engine=teng,
                                                    fast=True))]
    outs = []
    try:
        for srv in servers:
            base = _serve(srv)
            inp = srv.app.work_root / "uploads" / "noisy.png"
            tio.save_image(noisy, inp)
            code, out = _post_json(f"{base}/process",
                                   {"image_path": str(inp)})
            assert code == 200, out
            code, png = _get(f"{base}/download/{out['task_id']}")
            assert code == 200
            outs.append((out, tio.decode_image(png).astype(np.int16)))
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    (jout, jpix), (tout, tpix) = outs
    assert jout["initial_plan"], jout
    assert tout["initial_plan"] == jout["initial_plan"]
    assert tout["subtask_success"] == jout["subtask_success"]
    assert tpix.shape == jpix.shape
    assert np.abs(tpix - jpix).max() <= 2
