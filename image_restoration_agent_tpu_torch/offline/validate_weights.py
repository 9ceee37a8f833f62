"""validate-weights: the one-command real-checkpoint parity gate
(counterpart of ``image_restoration_agent_tpu/offline/validate_weights.py``).

Given a directory of downloaded reference checkpoints (the operator runs
the reference's own ``AgentApp/weights/**/download_ckpts`` scripts — this
environment has no egress), this harness turns "weights on disk" into a
pass/fail report:

1. every manifest entry whose checkpoint file is present is converted
   (convert/manifest.convert_checkpoint: the reference-named state dict
   as ``<weight_root>/<model>.npz``, loaded with ``strict=True`` into the
   port's own module),
2. each converted serving family runs on ``device`` on a committed fixture
   through the tiled path (``core.tiling.tiled_apply`` with the model's
   tile, overlap, scale and pad, batch 4: not the engine's shape buckets,
   which would change the canvas),
3. outputs are scored against stored reference goldens where one exists
   (PSNR gate), and always against the reference's own shape invariant
   (output == x1 or x4 input — AgenticIR/executor/__init__.py:113-157),
4. a JSON + markdown report is written.

Shipped golden: the reference's demo pair
``AgentApp/demo_input/input.png`` -> X-Restormer dehaze
``restored_output.png`` (stored under goldens/xrestormer_dehaze; the
reference file is saved rotated 90 degrees, so comparison tries all four
rot90 orientations and keeps the best). Additional goldens drop into
``goldens/<name>/{input,expected}.png`` with ``model.txt`` naming the
registry model. The goldens are the JAX package's files (its
``goldens/`` directory), read as data.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device

GOLDEN_ROOT = (Path(__file__).resolve().parents[2]
               / "image_restoration_agent_tpu" / "goldens")
GOLDEN_PSNR_TOL_DB = 0.1

# registry model per golden dir (extend by adding model.txt to new dirs)
_GOLDEN_MODELS = {"xrestormer_dehaze": "xrestormer"}


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else float(-10.0 * np.log10(mse))


def best_orientation_psnr(out: np.ndarray, ref: np.ndarray) -> float:
    """Max PSNR over the four rot90 orientations of ``ref`` (the shipped
    reference golden is stored rotated)."""
    best = -1.0
    for k in range(4):
        r = np.rot90(ref, k)
        if r.shape == out.shape:
            best = max(best, psnr(out, r))
    return best


def _goldens() -> dict[str, dict]:
    out = {}
    if not GOLDEN_ROOT.exists():
        return out
    for d in sorted(GOLDEN_ROOT.iterdir()):
        if not (d / "input.png").exists():
            continue
        model = _GOLDEN_MODELS.get(d.name)
        mf = d / "model.txt"
        if mf.exists():
            model = mf.read_text().strip()
        out[d.name] = {"dir": d, "model": model}
    return out


@torch.no_grad()
def _run_family(model_name: str, state: dict, img: np.ndarray,
                device: str | torch.device = "cuda") -> dict:
    """Run one serving family with the reference-named ``state`` through
    the tiled path on ``img``, in float32 on ``device``."""
    from ..core.tiling import tiled_apply
    from ..models import build_model
    from ..models.registry import get_spec

    device = resolve_device(device)
    spec = get_spec(model_name)
    model = build_model(model_name, device="cpu")
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in state.items()}, strict=True)
    model = model.to(device)

    out = tiled_apply(
        model, torch.from_numpy(np.ascontiguousarray(img, np.float32))
        .to(device), tile=spec.tile or None,
        overlap=spec.tile_overlap, scale=spec.scale,
        pad_multiple=spec.pad_multiple, pad_mode=spec.pad_mode,
        pad_kind=spec.pad_kind, batch=4)
    out = out.float().cpu().numpy()
    h, w = img.shape[:2]
    shape_ok = out.shape[:2] in ((h, w), (h * spec.scale, w * spec.scale))
    return {"output": np.clip(out, 0.0, 1.0), "shape_ok": bool(shape_ok)}


def validate(ckpt_dir: str | Path, weight_root: str | Path,
             models: Optional[list[str]] = None,
             fixture_size: int = 160,
             report_path: Optional[Path] = None,
             manifest=None, device: str | torch.device = "cuda") -> dict:
    """Convert + run + score every manifest entry found in ``ckpt_dir``;
    the families run on ``device``.

    Returns the report dict; also writes JSON (and a .md table) next to
    ``weight_root`` or at ``report_path``. ``manifest`` overrides the
    entry list (tests inject tiny entries).
    """
    from ..convert.manifest import MANIFEST, convert_checkpoint
    from ..convert.torch_import import read_state
    from ..core.io import load_image, to_float
    from ..models import list_models

    device = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    weight_root = Path(weight_root)
    weight_root.mkdir(parents=True, exist_ok=True)
    goldens = _goldens()
    golden_by_model = {g["model"]: (name, g["dir"])
                       for name, g in goldens.items() if g["model"]}
    registry = set(list_models())

    rng = np.random.default_rng(0)
    fixture = rng.random((fixture_size, fixture_size, 3),
                         dtype=np.float32)

    records = []
    for entry in (manifest if manifest is not None else MANIFEST):
        if models and entry.model not in models:
            continue
        rec: dict = {"model": entry.model, "ckpt_file": entry.ckpt_file}
        # checkpoint present? exact name, else unique stem match
        path = ckpt_dir / entry.ckpt_file
        if not path.exists():
            cands = [p for p in ckpt_dir.glob("*")
                     if p.stem in entry.ckpt_file or
                     entry.ckpt_file.split(".")[0] in p.name]
            path = cands[0] if len(cands) == 1 else None
        if path is None or not path.exists():
            rec["status"] = "missing"
            records.append(rec)
            continue
        try:
            out_file = convert_checkpoint(entry.model, path, weight_root,
                                          entry=entry)
            rec["converted"] = str(out_file)
        except Exception as e:  # noqa: BLE001 — report, don't abort the run
            rec["status"] = "convert_failed"
            rec["error"] = f"{type(e).__name__}: {e}"
            records.append(rec)
            continue

        if entry.model not in registry:
            rec["status"] = "converted"  # aux networks: conversion is the gate
            records.append(rec)
            continue

        state = read_state(out_file)
        gname = golden_by_model.get(entry.model)
        if gname is not None:
            name, gdir = gname
            img = to_float(load_image(gdir / "input.png"))
            ref = to_float(load_image(gdir / "expected.png"))
            run = _run_family(entry.model, state, img, device)
            db = best_orientation_psnr(run["output"], np.asarray(ref))
            rec["golden"] = name
            rec["golden_psnr_db"] = round(db, 3)
            # gate: within tol of the stored expectation if one is
            # recorded, else an absolute floor (a broken conversion lands
            # near the 11 dB input-vs-output base rate; a correct one far
            # above it)
            exp_file = gdir / "expected_psnr_db.txt"
            if exp_file.exists():
                want = float(exp_file.read_text().strip())
                rec["status"] = "pass" if db >= want - GOLDEN_PSNR_TOL_DB \
                    else "golden_failed"
            else:
                rec["status"] = "pass" if db >= 20.0 else "golden_failed"
            rec["shape_ok"] = run["shape_ok"]
        else:
            run = _run_family(entry.model, state, fixture, device)
            rec["shape_ok"] = run["shape_ok"]
            rec["output_mean"] = round(float(run["output"].mean()), 5)
            rec["status"] = "pass" if run["shape_ok"] else "shape_failed"
        records.append(rec)

    n_pass = sum(r["status"] == "pass" for r in records)
    n_conv = sum(r["status"] == "converted" for r in records)
    n_fail = sum(r["status"].endswith("failed") for r in records)
    report = {"records": records, "pass": n_pass, "converted_aux": n_conv,
              "failed": n_fail,
              "missing": sum(r["status"] == "missing" for r in records)}
    report_path = Path(report_path) if report_path else \
        weight_root / "validate_report.json"
    report_path.write_text(json.dumps(report, indent=2))
    md = ["| model | status | golden PSNR (dB) | shape |", "|---|---|---|---|"]
    for r in records:
        md.append(f"| {r['model']} | {r['status']} | "
                  f"{r.get('golden_psnr_db', '-')} | "
                  f"{r.get('shape_ok', '-')} |")
    report_path.with_suffix(".md").write_text("\n".join(md) + "\n")
    return report
