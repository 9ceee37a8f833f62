"""Executor: subtask -> toolbox routing with the reference Tool contract
(counterpart of ``image_restoration_agent_tpu/agent/executor.py``).

Rebuild of AgenticIR/executor/ (tool.py:8-89, __init__.py:24-169): a Tool is
invoked as ``tool(input_dir, output_dir)`` where input_dir holds exactly one
image and output_dir receives ``output.png``. Instead of ``conda run`` child
processes per call (tool.py:72-78 — fresh python + model load every
invocation), tools dispatch to the port's in-process Engine, whose weight
store keeps hot models resident in device memory.

Toolbox composition mirrors the reference's per-subtask rosters
(SURVEY.md §2.2) as the JAX package lists them; a tool whose model is not
registered raises ``KeyError`` at its first call.
Classical brightening tools (CLAHE / gamma / constant shift on the HSV V
channel, executor/brightening/__init__.py:36-66) are implemented directly
with OpenCV, imported when a brightening tool runs.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from ..core.io import load_image, save_image, to_float
from ..engine import Engine


def _single_image_in(input_dir: Path) -> Path:
    files = sorted(p for p in Path(input_dir).iterdir() if p.is_file())
    assert len(files) == 1, f"input_dir must hold exactly one image: {files}"
    return files[0]


class Tool:
    """Callable restoration tool with the reference's directory contract."""

    def __init__(self, tool_name: str, subtask: str,
                 fn: Callable[[np.ndarray], np.ndarray]):
        self.tool_name = tool_name
        self.subtask = subtask
        self._fn = fn
        self.total_seconds = 0.0
        self.invocations = 0

    def __call__(self, input_dir: Path, output_dir: Path,
                 silent: bool = True) -> Path:
        input_path = _single_image_in(input_dir)
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        output_path = output_dir / "output.png"

        t0 = time.perf_counter()
        img = to_float(load_image(input_path))
        out = self._fn(img)
        save_image(out, output_path)
        dt = time.perf_counter() - t0
        self.total_seconds += dt
        self.invocations += 1
        if not silent:
            print(f"[{self.subtask}/{self.tool_name}] {dt:.2f}s")
        return output_path

    def __repr__(self):
        return f"Tool({self.subtask}/{self.tool_name})"


# ---------------- classical brightening tools ----------------

def _on_v_channel(img: np.ndarray, update) -> np.ndarray:
    """Apply ``update`` to the HSV V channel (uint8), like the reference
    BrighteningTool._invoke."""
    import cv2

    u8 = np.clip(np.round(img * 255), 0, 255).astype(np.uint8)
    hsv = cv2.cvtColor(u8[..., ::-1], cv2.COLOR_BGR2HSV)
    h, s, v = cv2.split(hsv)
    v = update(v)
    out = cv2.cvtColor(cv2.merge((h, s, v)), cv2.COLOR_HSV2BGR)[..., ::-1]
    return out.astype(np.float32) / 255.0


def brighten_hist_eq(img: np.ndarray) -> np.ndarray:
    """CLAHE (clip 2.0, 8x8 tiles) on V."""
    import cv2

    clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    return _on_v_channel(img, clahe.apply)


def brighten_gamma(img: np.ndarray) -> np.ndarray:
    """Gamma 1.5 brightening on V."""
    return _on_v_channel(
        img, lambda v: np.clip(np.round(
            (v / 255.0) ** (1 / 1.5) * 255), 0, 255).astype(np.uint8))


def brighten_constant_shift(img: np.ndarray) -> np.ndarray:
    """V + 40."""
    return _on_v_channel(
        img, lambda v: np.clip(v.astype(np.uint16) + 40, 0,
                               255).astype(np.uint8))


# ---------------- executor ----------------

SUBTASKS = (
    "super-resolution", "denoising", "motion deblurring",
    "defocus deblurring", "dehazing", "deraining", "brightening",
    "jpeg compression artifact removal",
)


class Executor:
    """Holds the subtask -> toolbox router and test helpers
    (reference executor/__init__.py:24-169)."""

    def __init__(self, toolbox_router: dict[str, list[Tool]]):
        self.toolbox_router = toolbox_router

    def invoke_a_tool(self, subtask: str, tool_name: str, input_dir: Path,
                      output_dir: Path, silent: bool = True) -> Path:
        for tool in self.toolbox_router[subtask]:
            if tool.tool_name == tool_name:
                return tool(input_dir, output_dir, silent)
        raise KeyError(f"no tool {tool_name!r} for {subtask!r}")

    def test_all_tools(self, fixture_image: np.ndarray, work_dir: Path,
                       silent: bool = True) -> dict:
        """Invoke every tool on a fixture and assert the x1/x4 shape
        invariant (reference executor/__init__.py:113-157)."""
        work_dir = Path(work_dir)
        in_dir = work_dir / "0-img"
        in_dir.mkdir(parents=True, exist_ok=True)
        save_image(fixture_image, in_dir / "input.png")
        h, w = fixture_image.shape[:2]
        report = {}
        for subtask, tools in self.toolbox_router.items():
            for tool in tools:
                out_dir = work_dir / f"subtask-{subtask}" / \
                    f"tool-{tool.tool_name}" / "0-img"
                out_path = tool(in_dir, out_dir, silent=silent)
                out = load_image(out_path)
                ok = out.shape[:2] in ((h, w), (h * 4, w * 4))
                report[f"{subtask}/{tool.tool_name}"] = {
                    "ok": bool(ok), "shape": out.shape[:2],
                    "seconds": tool.total_seconds / tool.invocations,
                }
                assert ok, f"{tool}: bad output shape {out.shape}"
        return report


#: subtask -> [(tool_name, engine model name)]: the full reference rosters
#: (SURVEY.md §2.2 per-subtask toolboxes). The port serves every model of
#: them.
DEFAULT_TOOLBOXES: dict[str, list[tuple[str, str]]] = {
    "super-resolution": [
        ("diffbir", "diffbir"),
        ("xrestormer", "xrestormer"),
        ("swinir_sr", "swinir_sr_x4"),
        ("swinir_lightweight_sr", "swinir_lightweight_sr_x4"),
        ("hat", "hat_sr_x4"),
    ],
    "denoising": [
        ("xrestormer", "xrestormer"),
        ("swinir_denoise_15", "swinir_denoise_15"),
        ("swinir_denoise_50", "swinir_denoise_50"),
        ("mprnet", "mprnet"),
        ("maxim", "maxim_s2"),
        ("restormer", "restormer"),
    ],
    "motion deblurring": [
        ("restormer", "restormer"),
        ("mprnet", "mprnet"),
        ("maxim", "maxim_s2"),
        ("xrestormer", "xrestormer"),
    ],
    "defocus deblurring": [
        ("drbnet", "drbnet"),
        ("restormer", "restormer"),
        # IFAN is registered ("ifan") and servable; the reference keeps it
        # out of the default toolbox (defocus_deblurring/__init__.py).
    ],
    "dehazing": [
        ("xrestormer", "xrestormer"),
        ("ridcp", "ridcp"),
        ("dehazeformer", "dehazeformer_b"),
        ("maxim", "maxim_s2"),
    ],
    "deraining": [
        ("maxim", "maxim_s3"),
        ("xrestormer", "xrestormer"),
        ("restormer", "restormer"),
        ("mprnet", "mprnet"),
    ],
    "jpeg compression artifact removal": [
        ("fbcnn_blind", "fbcnn_blind"),
        ("fbcnn_qf5", "fbcnn_qf5"),
        ("fbcnn_qf90", "fbcnn_qf90"),
        ("swinir_jpeg", "swinir_jpeg_40"),
    ],
}


def build_default_executor(engine: Optional[Engine] = None,
                           toolboxes: Optional[dict] = None,
                           fast: bool = False,
                           device: str = "cuda") -> Executor:
    """Create the executor backed by one shared Engine (``Engine(device=
    device)`` unless one is given).

    ``fast=True`` swaps every NN toolbox for tiny configs (CPU-testable) —
    the hermetic-test analogue of the reference's real-weights smoke runs.
    """
    engine = engine or Engine(device=device)
    router: dict[str, list[Tool]] = {s: [] for s in SUBTASKS}

    if fast:
        nn_boxes = {
            "super-resolution": [("swinir_tiny", "swinir_tiny")],
            "denoising": [("nafnet_small", "nafnet_small"),
                          ("restormer_tiny", "restormer_tiny")],
            "motion deblurring": [("nafnet_small", "nafnet_small")],
            "defocus deblurring": [("restormer_tiny", "restormer_tiny")],
            "dehazing": [("nafnet_small", "nafnet_small")],
            "deraining": [("restormer_tiny", "restormer_tiny")],
            "jpeg compression artifact removal":
                [("nafnet_small", "nafnet_small")],
        }
    else:
        nn_boxes = toolboxes or DEFAULT_TOOLBOXES

    def mk_fn(model_name):
        return lambda img: engine.restore_array(img, model_name).image / 255.0

    for subtask, entries in nn_boxes.items():
        for tool_name, model_name in entries:
            router[subtask].append(Tool(tool_name, subtask, mk_fn(model_name)))

    router["brightening"] = [
        Tool("histogram_equalization", "brightening", brighten_hist_eq),
        Tool("gamma_correction", "brightening", brighten_gamma),
        Tool("constant_shift", "brightening", brighten_constant_shift),
    ]
    return Executor(router)
