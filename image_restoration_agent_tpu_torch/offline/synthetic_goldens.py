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
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from ..core.io import load_image, to_float

GOLDEN_PSNR_TOL_DB = 0.1
GOLDEN_ROOT = (Path(__file__).resolve().parents[2]
               / "image_restoration_agent_tpu" / "goldens")


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


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


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
