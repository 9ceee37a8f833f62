"""Fixtures of the benchmark's own tests (run them from the repository
root: ``python -m pytest portbench/tests``).

``tiny_root`` is a checkout-like directory holding a copy of
``portbench/`` and a ``BENCHMARK.json`` of small cells that run on the CPU
in seconds: SwinIR in band mode, Restormer whole and tiled, at tiny widths
(registered under test names in the program's model registry), with the
real harness, generator, references and readers. ``cuda`` skips a test
where no card is present.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SWIN_TINY = dict(embed_dim=16, depths=[2, 2], num_heads=[2, 2],
                 num_feat=16)
RESTORMER_TINY = dict(dim=8, num_blocks=[1, 1, 1, 1],
                      num_refinement_blocks=1, heads=[1, 1, 2, 2],
                      ffn_expansion_factor=2.0)
LIMITS = {"mismatch_pct": {"limit": 0.5}, "worst_block_pct": {"limit": 5.0}}


def _register():
    """Tiny served models under test names: SwinIR in band mode, and a
    Restormer whose canvases over 100 px are tiled in 64 px tiles."""
    from image_restoration_agent_tpu_torch.models.registry import (
        MODEL_REGISTRY, ModelSpec, register_model)
    from image_restoration_agent_tpu_torch.models.restormer import Restormer
    from image_restoration_agent_tpu_torch.models.swinir import SwinIR

    if "pbtest_swinir_band" in MODEL_REGISTRY:
        return
    register_model(ModelSpec(
        name="pbtest_swinir_band", build=lambda **kw: SwinIR(**kw),
        subtasks=("super-resolution",), scale=4, pad_multiple=8,
        pad_mode="extra", pad_kind="symmetric", tile=None, band_mode=True,
        config=dict(window_size=8, upscale=4, upsampler="pixelshuffle",
                    **{k: tuple(v) if isinstance(v, list) else v
                       for k, v in SWIN_TINY.items()})))
    register_model(ModelSpec(
        name="pbtest_restormer_tiles", build=lambda **kw: Restormer(**kw),
        subtasks=("motion deblurring",), pad_multiple=8, pad_kind="reflect",
        tile=None, tile_overlap=32, max_size=100, fallback_tile=64,
        whole_pad_multiple=16,
        config={k: tuple(v) if isinstance(v, list) else v
                for k, v in RESTORMER_TINY.items()}))


def write_cell(root: Path, name: str, config: str, mix: str, cfg: dict,
               traffic: dict, limits: dict = LIMITS) -> None:
    """Add a configuration, a mix, limits and a workload to ``root``."""
    pb = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (pb / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    (pb / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
    (pb / "checks" / f"{name}.json").write_text(json.dumps(limits))
    if not any(c["name"] == config for c in bench["configs"]):
        bench["configs"].append(dict(
            name=config, source="test", file=f"portbench/configs/{config}.json",
            reduced=[], why="test"))
    bench["workloads"].append(dict(name=name, config=config, traffic=mix,
                                   chips=1, why="test"))
    names = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        m["workloads"] = names
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = names
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def tiny_configs() -> dict:
    pb = REPO / "portbench" / "configs"
    sw = json.loads((pb / "swinir_m_x4.json").read_text())
    sw["registry"] = "pbtest_swinir_band"
    sw["arch"].update(SWIN_TINY)
    rs = json.loads((pb / "restormer_deblur.json").read_text())
    rs["registry"] = "pbtest_restormer_tiles"
    rs["arch"].update(RESTORMER_TINY)
    rs["serving"].update(max_size=100, fallback_tile=64, whole_pad_multiple=16)
    return {"swin": sw, "restormer": rs}


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    _register()
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cfgs = tiny_configs()
    write_cell(root, "tsw.band", "tsw", "t_band", cfgs["swin"],
               dict(sizes=[dict(h=40, w=100, weight=1),
                           dict(h=24, w=48, weight=1)],
                    pool=2, content=dict(grid=16), degrade=None,
                    trace_requests=3))
    write_cell(root, "trs.tiles", "trs", "t_tiles", cfgs["restormer"],
               dict(sizes=[dict(h=60, w=90, weight=1),
                           dict(h=120, w=150, weight=1)],
                    pool=1, content=dict(grid=16),
                    degrade=dict(blur=[3, 7], noise=0.01),
                    trace_requests=3))
    return root


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")
