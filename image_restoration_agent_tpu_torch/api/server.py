"""HTTP serving API (stdlib http.server; counterpart of
``image_restoration_agent_tpu/api/server.py``).

Honors the reference contract (AgentApp/agentic_api.py:387-458):

- ``GET  /health``                -> {"status": "ok", ...engine status,
                                      "io_native": native codec loaded}
- ``POST /process``               -> run the agent graph on an image
    accepts JSON {"image_path": ...} or multipart/form-data file upload;
    returns {status, task_id, output_path, initial_plan, subtask_success}
- ``GET  /download/<task_id>``    -> the restored PNG

The graph is compiled once and cached (reference get_compiled_graph
:378-384). Single-process: requests are serialized through one lock since
model execution owns the card; the HTTP layer itself is threaded.
"""

from __future__ import annotations

import json
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

from ..agent.graph_app import create_image_analysis_graph
from ..core import io_native


class AgentAPIServer:
    def __init__(self, work_root: Path, graph=None, engine_status=None,
                 allowed_roots=None, **graph_kw):
        self.work_root = Path(work_root)
        (self.work_root / "uploads").mkdir(parents=True, exist_ok=True)
        (self.work_root / "final_output").mkdir(parents=True, exist_ok=True)
        # Paths a client may reference via image_path. Default: only the
        # server's own work root — a network client must upload, not point
        # at arbitrary server-readable files and exfiltrate via /download.
        self.allowed_roots = [self.work_root.resolve()] + [
            Path(p).resolve() for p in (allowed_roots or [])]
        self._graph = graph
        self._graph_kw = graph_kw
        self._graph_lock = threading.Lock()
        self._run_lock = threading.Lock()
        self._engine_status = engine_status or (lambda: {})
        self.tasks: dict[str, dict] = {}

    def get_compiled_graph(self):
        with self._graph_lock:
            if self._graph is None:
                self._graph = create_image_analysis_graph(**self._graph_kw)
            return self._graph

    # ---------------- request handlers ----------------

    def health(self) -> dict:
        return {"status": "ok", **self._engine_status(),
                "io_native": io_native.available()}

    def process(self, image_path: str) -> dict:
        task_id = f"{Path(image_path).stem}_{uuid.uuid4().hex[:8]}"
        work_dir = self.work_root / "tasks" / task_id
        graph = self.get_compiled_graph()
        state = {"image_path": str(image_path), "work_dir": str(work_dir)}
        with self._run_lock:  # model execution owns the accelerator
            t0 = time.perf_counter()
            state = graph.invoke(state)
            dt = time.perf_counter() - t0
        final = self.work_root / "final_output" / f"{task_id}.png"
        final.write_bytes(Path(state["output_path"]).read_bytes())
        result = {
            "status": "success",
            "task_id": task_id,
            "output_path": str(final),
            "initial_plan": [list(p) for p in state.get("initial_plan", [])],
            "subtask_success": state.get("subtask_success", {}),
            "seconds": round(dt, 3),
        }
        self.tasks[task_id] = result
        return result

    def path_allowed(self, image_path: str) -> bool:
        p = Path(image_path).resolve()
        return any(p.is_relative_to(root) for root in self.allowed_roots)

    def download(self, task_id: str) -> Optional[bytes]:
        p = self.work_root / "final_output" / f"{task_id}.png"
        return p.read_bytes() if p.exists() else None

    def save_upload(self, filename: str, data: bytes) -> Path:
        safe = re.sub(r"[^\w.\-]", "_", filename) or "upload.png"
        dst = self.work_root / "uploads" / f"{uuid.uuid4().hex[:8]}_{safe}"
        # validate by decoding on the decode pool (the native codec drops
        # the GIL, so concurrent uploads on the threading server overlap);
        # corrupt uploads are rejected at the door instead of failing
        # mid-agent
        from ..core.decode_pool import default_pool
        try:
            arr = default_pool().decode(data)
            if arr.ndim != 3 or arr.shape[-1] not in (1, 3, 4):
                raise ValueError(f"unsupported image shape {arr.shape}")
        except Exception as e:
            raise ValueError(f"upload is not a decodable image: {e}")
        dst.write_bytes(data)
        return dst


def _parse_multipart(body: bytes, content_type: str):
    """Minimal multipart/form-data parser: returns {name: (filename, data)}.

    Splits on the exact ``\\r\\n--boundary`` delimiter so payloads ending in
    '-', CR, or LF are preserved byte-exact (an rstrip-based parser corrupts
    them).
    """
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        return {}
    delim = b"--" + m.group(1).encode()
    chunks = body.split(b"\r\n" + delim)
    if chunks and chunks[0].startswith(delim):  # first part has no leading CRLF
        chunks[0] = chunks[0][len(delim):]
    out = {}
    for chunk in chunks:
        if chunk.startswith(b"--"):  # closing delimiter
            continue
        if chunk.startswith(b"\r\n"):
            chunk = chunk[2:]
        head, sep, data = chunk.partition(b"\r\n\r\n")
        if not sep:
            continue
        dm = re.search(rb'name="([^"]+)"', head)
        if not dm:
            continue
        fm = re.search(rb'filename="([^"]*)"', head)
        out[dm.group(1).decode()] = (
            fm.group(1).decode() if fm else None, data)
    return out


def make_server(host: str = "127.0.0.1", port: int = 1146,
                app: Optional[AgentAPIServer] = None,
                work_root: Optional[Path] = None, **graph_kw):
    app = app or AgentAPIServer(work_root or Path("./api_work"), **graph_kw)

    class Handler(BaseHTTPRequestHandler):
        def _send_json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/health":
                return self._send_json(app.health())
            m = re.match(r"^/download/([\w.\-]+)$", self.path)
            if m:
                data = app.download(m.group(1))
                if data is None:
                    return self._send_json({"error": "not found"}, 404)
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            self._send_json({"error": "unknown endpoint"}, 404)

        def do_POST(self):
            if self.path != "/process":
                return self._send_json({"error": "unknown endpoint"}, 404)
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            try:
                if ctype.startswith("application/json"):
                    payload = json.loads(body or b"{}")
                    image_path = payload.get("image_path")
                elif ctype.startswith("multipart/form-data"):
                    fields = _parse_multipart(body, ctype)
                    if "file" in fields and fields["file"][0]:
                        image_path = str(app.save_upload(*fields["file"]))
                    else:
                        image_path = (fields.get("image_path",
                                                 (None, b""))[1]
                                      .decode() or None)
                else:  # urlencoded form
                    from urllib.parse import parse_qs

                    image_path = parse_qs(body.decode()).get(
                        "image_path", [None])[0]
                if not image_path or not Path(image_path).exists():
                    return self._send_json(
                        {"status": "error",
                         "message": f"image not found: {image_path}"}, 400)
                if not app.path_allowed(image_path):
                    return self._send_json(
                        {"status": "error",
                         "message": "image_path outside allowed roots; "
                                    "upload the file instead"}, 403)
                return self._send_json(app.process(image_path))
            except Exception as e:
                return self._send_json(
                    {"status": "error", "message": str(e)}, 500)

    server = ThreadingHTTPServer((host, port), Handler)
    server.app = app
    return server
