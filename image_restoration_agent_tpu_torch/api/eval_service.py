"""Degradation-evaluation HTTP service with the DepictQA endpoint contract
(counterpart of ``image_restoration_agent_tpu/api/eval_service.py``).

The reference runs the DepictQA VLM behind two Flask apps
(DepictQA/src/app_eval.py: POST /evaluate_degradation on :6006;
src/app_comp.py: POST /compare_quality on :5002). This service exposes the
same endpoints/payloads backed by the in-process evaluator (the v4
classifier on ``device``, the card unless the caller asks for the CPU),
so external
clients built for the reference (llm/depictqa.py:74-77, 87-94) work
unchanged — and our own DepictQAClient round-trips against it.

Payloads:
- /evaluate_degradation: {"img_path": ..., "degradation": ...}
    -> {"answer": "<severity>"}
- /compare_quality: {"img_path_A": ..., "img_path_B": ...}
    -> {"answer": "Image A" | "Image B" | "similar"}
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..agent.evaluators import LocalEvaluator


def make_eval_server(host: str = "127.0.0.1", port: int = 6006,
                     evaluator: Optional[LocalEvaluator] = None,
                     device: str = "cuda"):
    evaluator = evaluator or LocalEvaluator(device=device)
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                return self._json({"status": "ok"})
            self._json({"error": "unknown"}, 404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/evaluate_degradation":
                    with lock:
                        level = evaluator.severity_of(
                            payload["img_path"], payload["degradation"])
                    return self._json({"answer": level})
                if self.path == "/compare_quality":
                    with lock:
                        choice = evaluator.compare(payload["img_path_A"],
                                                   payload["img_path_B"])
                    answer = {"former": "Image A", "latter": "Image B",
                              "neither": "similar"}[choice]
                    return self._json({"answer": answer})
                return self._json({"error": "unknown endpoint"}, 404)
            except Exception as e:
                return self._json({"error": str(e)}, 500)

    return ThreadingHTTPServer((host, port), Handler)
