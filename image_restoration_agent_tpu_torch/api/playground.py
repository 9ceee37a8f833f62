"""Playground: hand-drive the restoration tool tree from a browser
(counterpart of ``image_restoration_agent_tpu/api/playground.py``).

Rebuild of AgenticIR/exploration/playground.py + playground.html (a Flask UI
for manually invoking tools on any node of the image tree, with resume):
stdlib HTTP, one page. Endpoints:

- GET  /            : HTML UI (tree + toolboxes)
- GET  /tree        : JSON of the current tree (nodes + execution paths)
- GET  /image?node= : PNG of a node's image
- POST /invoke      : {"node": <rel dir>, "subtask": ..., "tool": ...}
                      runs one tool on that node, returns the new node
- POST /start       : {"image_path": ...} seeds a fresh tree (or resume an
                      existing work dir by pointing work_root at it)
"""

from __future__ import annotations

import json
import shutil
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

from ..agent.executor import Executor, build_default_executor

_PAGE = """<!doctype html><html><head><title>IR playground</title><style>
body{font-family:monospace;margin:20px} .node{margin:6px;padding:6px;
border:1px solid #999;display:inline-block;vertical-align:top}
img{display:block;max-width:160px} button{margin:2px}</style></head><body>
<h2>Image-restoration playground</h2>
<div>
<input id="path" size="60" placeholder="/abs/path/to/image.png">
<button onclick="start()">start</button>
</div><div id="tree"></div><script>
async function refresh(){
  const r = await fetch('/tree'); const t = await r.json();
  const el = document.getElementById('tree'); el.innerHTML='';
  for(const n of t.nodes){
    const d = document.createElement('div'); d.className='node';
    d.innerHTML = `<b>${n.path||'input'}</b><img src="/image?node=${
      encodeURIComponent(n.path)}">`;
    for(const st of Object.keys(t.toolboxes)){
      for(const tool of t.toolboxes[st]){
        const b = document.createElement('button');
        b.textContent = st.split(' ')[0]+'/'+tool;
        b.onclick = async ()=>{await fetch('/invoke',{method:'POST',
          body:JSON.stringify({node:n.path,subtask:st,tool:tool})});
          refresh();};
        d.appendChild(b);
      }
    }
    el.appendChild(d);
  }
}
async function start(){
  await fetch('/start',{method:'POST',body:JSON.stringify(
    {image_path:document.getElementById('path').value})});
  refresh();
}
refresh();
</script></body></html>"""


class Playground:
    def __init__(self, work_root: Path, executor: Executor | None = None,
                 device: str = "cuda"):
        self.work_root = Path(work_root)
        self.work_root.mkdir(parents=True, exist_ok=True)
        self.executor = executor or build_default_executor(fast=True,
                                                           device=device)
        self._lock = threading.Lock()

    def start(self, image_path: str):
        root = self.work_root / "0-img"
        if root.exists():
            shutil.rmtree(self.work_root)
        root.mkdir(parents=True)
        shutil.copy(image_path, root / "input.png")
        return {"ok": True}

    def nodes(self) -> list[dict]:
        out = []
        for img in sorted(self.work_root.rglob("0-img/*.png")):
            rel = img.parent.parent.relative_to(self.work_root)
            out.append({"path": "" if str(rel) == "." else str(rel)})
        return out

    def invoke(self, node: str, subtask: str, tool: str) -> dict:
        base = self.work_root / node if node else self.work_root
        out_dir = base / f"subtask-{subtask}" / f"tool-{tool}" / "0-img"
        with self._lock:
            self.executor.invoke_a_tool(subtask, tool, base / "0-img",
                                        out_dir)
        return {"ok": True,
                "node": str(out_dir.parent.relative_to(self.work_root))}

    def image_bytes(self, node: str) -> bytes | None:
        base = self.work_root / node if node else self.work_root
        imgs = sorted((base / "0-img").glob("*.png"))
        return imgs[0].read_bytes() if imgs else None


def make_playground_server(host="127.0.0.1", port=7860,
                           work_root: Path = Path("playground_work"),
                           executor=None, device: str = "cuda"):
    pg = Playground(work_root, executor, device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, ctype="application/json", code=200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                return self._send(_PAGE.encode(), "text/html")
            if url.path == "/tree":
                body = {"nodes": pg.nodes(),
                        "toolboxes": {s: [t.tool_name for t in tools]
                                      for s, tools in
                                      pg.executor.toolbox_router.items()}}
                return self._send(json.dumps(body).encode())
            if url.path == "/image":
                node = parse_qs(url.query).get("node", [""])[0]
                data = pg.image_bytes(node)
                if data is None:
                    return self._send(b'{"error":"no image"}', code=404)
                return self._send(data, "image/png")
            return self._send(b'{"error":"unknown"}', code=404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            try:
                if self.path == "/start":
                    return self._send(json.dumps(
                        pg.start(payload["image_path"])).encode())
                if self.path == "/invoke":
                    return self._send(json.dumps(pg.invoke(
                        payload.get("node", ""), payload["subtask"],
                        payload["tool"])).encode())
            except Exception as e:
                return self._send(json.dumps({"error": str(e)}).encode(),
                                  code=500)
            return self._send(b'{"error":"unknown"}', code=404)

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.playground = pg
    return srv
