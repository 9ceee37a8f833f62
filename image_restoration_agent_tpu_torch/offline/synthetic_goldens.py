"""Synthetic real-geometry goldens, the port's own copy of the weight
generator (``image_restoration_agent_tpu/offline/synthetic_goldens.py``).

A golden directory holds ``spec.json`` (registry model, seed, gain, the
reference-named state-dict ``[key, shape]`` list, recorded PSNR),
``input.png`` and ``expected.npz`` (an independent torch reference's output
at real width). The weights are regenerated in pure numpy from
``(seed, name)``, so no checkpoint download is needed;
:func:`materialize_synthetic_weights` writes them as ``<model>.npz`` files
that ``Engine(weight_dir=...)`` serves (the JAX package writes orbax
directories for its engine instead).

The gate (:func:`run_synthetic_golden`, ``cli validate-weights
--synthetic``) rebuilds a golden's reference-named ``.pth``, converts it
through the same ``convert/manifest`` path an operator would use on
downloaded weights, serves it through the tiled path on ``device`` and
asserts PSNR within ``GOLDEN_PSNR_TOL_DB`` (0.1 dB) of the recorded value.
"""

from __future__ import annotations

import hashlib
import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..core.io import load_image, to_float
from ..device import resolve_device
from .validate_weights import (GOLDEN_PSNR_TOL_DB, GOLDEN_ROOT,
                               _run_family, psnr)


def _tensor_rng(seed: int, name: str) -> np.random.Generator:
    """Per-tensor RNG keyed by (seed, blake2(name))."""
    h = hashlib.blake2b(name.encode(), digest_size=8).digest()
    return np.random.default_rng([seed, int.from_bytes(h, "little")])


def fill_tensor(name: str, shape: tuple[int, ...], seed: int,
                gain: float) -> np.ndarray:
    """Deterministic value for one reference-named state-dict tensor: norm
    scales near 1, small biases, fan-in-scaled weights times ``gain``."""
    rng = _tensor_rng(seed, name)
    shape = tuple(int(s) for s in shape)
    n = rng.standard_normal(shape).astype(np.float32)
    if "temperature" in name:
        return (rng.random(shape).astype(np.float32) + 0.5)
    if "relative_position_bias_table" in name:
        return 0.02 * n
    if name.endswith(".bias") or name.endswith("beta"):
        return 0.05 * n
    if len(shape) == 1:
        return 1.0 + 0.1 * n
    if name.endswith("gamma") or name.endswith("beta"):
        return 0.1 * n
    fan_in = int(np.prod(shape[1:])) or 1
    return (gain / np.sqrt(fan_in) * n).astype(np.float32)


def build_state(spec: dict) -> dict[str, np.ndarray]:
    """Rebuild the full reference-named state dict from a golden spec."""
    seed, gain = int(spec["seed"]), float(spec.get("gain", 0.25))
    return {name: fill_tensor(name, tuple(shape), seed, gain)
            for name, shape in spec["state"]}


def load_golden(golden_dir: str | Path) -> dict:
    """{"spec", "state", "input" (float32 HWC in [0,1]), "expected"
    (float32, clipped to [0,1])} of one golden directory."""
    d = Path(golden_dir)
    spec = json.loads((d / "spec.json").read_text())
    with np.load(d / "expected.npz") as z:
        expected = np.clip(z["expected"].astype(np.float32), 0.0, 1.0)
    return {"spec": spec, "state": build_state(spec),
            "input": to_float(load_image(d / "input.png")),
            "expected": expected}


def list_synthetic_goldens(root: Path | None = None) -> list[Path]:
    root = Path(root) if root else GOLDEN_ROOT
    if not root.exists():
        return []
    return sorted(d for d in root.iterdir() if (d / "spec.json").exists())


def materialize_synthetic_weights(weight_root: str | Path,
                                  names: list[str] | None = None
                                  ) -> dict[str, Path]:
    """Write each committed synthetic golden's weights (or those of the
    goldens in ``names``) as ``weight_root/<model>.npz``: a deterministic
    real-geometry model zoo for ``Engine(weight_dir=weight_root,
    allow_random_init=False)``. Returns {model name: written file}."""
    weight_root = Path(weight_root)
    weight_root.mkdir(parents=True, exist_ok=True)
    out: dict[str, Path] = {}
    for d in list_synthetic_goldens():
        if names and d.name not in names:
            continue
        spec = json.loads((d / "spec.json").read_text())
        path = weight_root / f"{spec['model']}.npz"
        np.savez(path, **build_state(spec))
        out[spec["model"]] = path
    return out


def write_pth(state: dict[str, np.ndarray], path: Path,
              wrap_key: str | None = None) -> None:
    """Write a real torch ``.pth`` (the artifact the converter consumes),
    optionally wrapped under a dict key the way reference releases ship
    (SwinIR/Restormer use ``params``)."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in state.items()}
    torch.save({wrap_key: sd} if wrap_key else sd, str(path))


def convert_golden_checkpoint(golden_dir: Path, out_root: Path) -> Path:
    """Rebuild one golden's reference-named ``.pth`` and convert it through
    the manifest path (``convert.manifest.convert_checkpoint``, a strict
    load into the port's module) into ``out_root/<model>.npz``. Returns
    the written file."""
    from ..convert.manifest import convert_checkpoint

    golden_dir = Path(golden_dir)
    spec = json.loads((golden_dir / "spec.json").read_text())
    model = spec["model"]
    out_root = Path(out_root)
    out_root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        pth = Path(td) / spec.get("ckpt_file", f"{model}.pth")
        write_pth(build_state(spec), pth, wrap_key=spec.get("wrap_key"))
        return convert_checkpoint(model, pth, out_root)


def run_synthetic_golden(golden_dir: Path, weight_root: Path | None = None,
                         device: str | torch.device = "cuda") -> dict:
    """Execute one golden gate end-to-end: rebuild the ckpt -> manifest
    convert -> read the written weights -> tiled serve on ``device`` ->
    PSNR vs the committed expectation.

    Returns a record dict with ``status`` in {"pass", "golden_failed"}.
    """
    from ..convert.torch_import import read_state

    golden_dir = Path(golden_dir)
    g = load_golden(golden_dir)
    model = g["spec"]["model"]
    with tempfile.TemporaryDirectory() as td:
        out_root = Path(weight_root) if weight_root else Path(td) / "weights"
        state = read_state(convert_golden_checkpoint(golden_dir, out_root))
    run = _run_family(model, state, g["input"], device)
    db = psnr(run["output"], g["expected"])
    want = float(g["spec"]["psnr_db"])
    ok = run["shape_ok"] and db >= want - GOLDEN_PSNR_TOL_DB
    return {"model": model, "golden": golden_dir.name,
            "golden_psnr_db": round(db, 3), "want_db": want,
            "shape_ok": run["shape_ok"],
            "status": "pass" if ok else "golden_failed"}


def validate_synthetic(weight_root: Path | None = None,
                       names: list[str] | None = None,
                       device: str | torch.device = "cuda") -> dict:
    """Run every committed synthetic golden gate (or those in ``names``) on
    ``device``. CLI: ``python -m image_restoration_agent_tpu_torch.cli
    validate-weights --synthetic``."""
    device = resolve_device(device)
    records = []
    for d in list_synthetic_goldens():
        if names and d.name not in names:
            continue
        records.append(run_synthetic_golden(d, weight_root, device))
    return {"records": records,
            "pass": sum(r["status"] == "pass" for r in records),
            "failed": sum(r["status"] != "pass" for r in records)}
