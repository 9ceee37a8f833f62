"""On-disk search tree of intermediate images (the port's copy of
``image_restoration_agent_tpu/agent/img_tree.py``).

Rebuild of AgenticIR/utils/img_tree.py: the working directory layout is

    img_tree/
      0-img/input.png
      subtask-<name>/tool-<name>/0-img/output.png
      subtask-<name>/tool-<name>/subtask-.../...

Execution paths reconstruct from path components (img_tree.py:114-129); the
whole tree renders to a nested-list HTML page with inline images
(img_tree.py:131-157).
"""

from __future__ import annotations

import base64
from pathlib import Path


def _name_stem(dirname: str) -> str:
    return dirname[dirname.find("-") + 1:]


class ImgTree:
    def __init__(self, root: Path, html_dir: Path | None = None):
        self.root = Path(root)
        self.html_dir = Path(html_dir) if html_dir else self.root

    def get_execution_path(self, img_path: Path) -> list[tuple[str, str]]:
        """(subtask, tool) pairs from the tree root to this image."""
        # absolute() (not resolve()): replayed outputs are symlinks into a
        # previous run's tree and must keep their logical position here.
        rel = Path(img_path).absolute().relative_to(self.root.absolute())
        parts = rel.parts
        out = []
        i = 0
        while i < len(parts):
            if parts[i].startswith("subtask-"):
                subtask = _name_stem(parts[i])
                tool = _name_stem(parts[i + 1])
                out.append((subtask, tool))
                i += 2
            else:
                i += 1
        return out

    def _render_dir(self, d: Path, lines: list[str]) -> None:
        img_dir = d / "0-img"
        if img_dir.exists():
            for img in sorted(img_dir.glob("*.png")):
                try:
                    b64 = base64.b64encode(img.read_bytes()).decode()
                    lines.append(
                        f'<li><b>{d.name}</b><br>'
                        f'<img src="data:image/png;base64,{b64}" '
                        f'width="160"/></li>')
                except OSError:
                    lines.append(f"<li><b>{d.name}</b> (unreadable)</li>")
        subdirs = sorted(p for p in d.iterdir()
                         if p.is_dir() and p.name.startswith("subtask-"))
        for sd in subdirs:
            lines.append(f"<li>{sd.name}<ul>")
            for tool_dir in sorted(p for p in sd.iterdir() if p.is_dir()):
                lines.append("<ul>")
                self._render_dir(tool_dir, lines)
                lines.append("</ul>")
            lines.append("</ul></li>")

    def to_html(self) -> Path:
        lines = ["<html><body><h2>Image tree</h2><ul>"]
        self._render_dir(self.root, lines)
        lines.append("</ul></body></html>")
        self.html_dir.mkdir(parents=True, exist_ok=True)
        out = self.html_dir / "img_tree.html"
        out.write_text("\n".join(lines))
        return out
