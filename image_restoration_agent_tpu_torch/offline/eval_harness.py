"""Batch evaluation harness (counterpart of
``image_restoration_agent_tpu/offline/eval_harness.py``).

Rebuild of AgenticIR/eval/compute_scores.py (batch metric scoring vs HQ
ground truth) and eval/compare_methods.py (method comparison tables with
win rates and ablation grids), with markdown output. Scoring runs on
``device``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.decode_pool import default_pool
from ..iqa.scorer import Scorer


def compute_scores(result_dir: Path, gt_dir: Path,
                   out_path: Optional[Path] = None,
                   metrics=("psnr", "ssim"),
                   device: str | torch.device = "cuda") -> dict:
    """Score every result image against its same-named ground truth."""
    scorer = Scorer(tuple(metrics), device=device)
    result_dir, gt_dir = Path(result_dir), Path(gt_dir)
    pairs = [(res, gt_dir / res.name)
             for res in sorted(result_dir.glob("*.png"))
             if (gt_dir / res.name).exists()]
    # decode through the native-codec thread pool (GIL-free inflate)
    pool = default_pool()
    res_arrs = pool.load_many([p[0] for p in pairs], as_float=True)
    gt_arrs = pool.load_many([p[1] for p in pairs], as_float=True)
    scores = {}
    for (res, _), ra, ga in zip(pairs, res_arrs, gt_arrs):
        scores[res.name] = scorer.score_arrays(ra, ga)
    summary = {
        m: round(float(np.mean([s[m] for s in scores.values()
                                if s[m] is not None])), 4)
        for m in metrics if scores
    }
    out = {"per_image": scores, "mean": summary, "n": len(scores)}
    if out_path is not None:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(out, indent=2))
    return out


def compare_methods(method_scores: dict[str, dict],
                    metrics=("psnr", "ssim")) -> str:
    """Markdown comparison table + pairwise win rates
    (reference compare_methods.py:308-341)."""
    methods = list(method_scores)
    lines = ["| method | " + " | ".join(metrics) + " | n |",
             "|---" * (len(metrics) + 2) + "|"]
    for m in methods:
        mean = method_scores[m]["mean"]
        cells = " | ".join(f"{mean.get(k, float('nan')):.4f}"
                           for k in metrics)
        lines.append(f"| {m} | {cells} | {method_scores[m]['n']} |")

    # pairwise win rate on the first metric over shared images
    if len(methods) >= 2:
        key = metrics[0]
        lines.append("")
        lines.append(f"Win rates ({key}):")
        for a in methods:
            for b in methods:
                if a >= b:
                    continue
                pa = method_scores[a]["per_image"]
                pb = method_scores[b]["per_image"]
                shared = sorted(set(pa) & set(pb))
                if not shared:
                    continue
                wins = sum(pa[i][key] > pb[i][key] for i in shared)
                lines.append(
                    f"- {a} beats {b} on {wins}/{len(shared)} images")
    return "\n".join(lines)


# ---------------- ablation grids ----------------

#: flag combos under the reference's naming scheme
#: (eval/compare_methods.py:317-341 — 'wo' = without; retr/ref/rb =
#: retrieval / reflection / rollback)
ABLATION_VARIANTS: dict[str, dict] = {
    "default": {},
    "woretr": {"with_retrieval": False},
    "worb": {"with_rollback": False},
    "woref_worb": {"with_reflection": False, "with_rollback": False},
    "woretr_worb": {"with_retrieval": False, "with_rollback": False},
    "woretr_woref_worb": {"with_retrieval": False,
                          "with_reflection": False,
                          "with_rollback": False},
}

#: the reference's paired comparisons, one ablated dimension each
ABLATION_PAIRS = [
    ("rollback", "default", "worb"),
    ("rollback", "woretr", "woretr_worb"),
    ("reflection", "worb", "woref_worb"),
    ("reflection", "woretr_worb", "woretr_woref_worb"),
    ("retrieval", "default", "woretr"),
    ("retrieval", "worb", "woretr_worb"),
    ("retrieval", "woref_worb", "woretr_woref_worb"),
]


def run_ablation_grid(work_dir: Path, combos=None, images_per_combo: int = 1,
                      fast: bool = True, executor=None,
                      variants: Optional[dict] = None,
                      device: str | torch.device = "cuda") -> dict:
    """Run the agent benchmark under every ablation variant and emit the
    reference's headline analysis artifact: a variant grid + per-dimension
    paired comparisons (eval/compare_methods.py:308-341).
    """
    from ..agent import build_default_executor
    from .benchmark_suite import run_suite

    work_dir = Path(work_dir)
    variants = variants if variants is not None else ABLATION_VARIANTS
    executor = executor or build_default_executor(fast=fast, device=device)
    reports: dict[str, dict] = {}
    for name, kwargs in variants.items():
        reports[name] = run_suite(
            work_dir / name, combos=combos,
            images_per_combo=images_per_combo, executor=executor,
            fast=fast, agent_kwargs=kwargs, device=device)

    lines = ["# Ablation grid", "",
             "| variant | retrieval | reflection | rollback | "
             "PSNR out | dPSNR | SSIM out |",
             "|---|---|---|---|---|---|---|"]
    for name in variants:
        kw = variants[name]
        recs = reports[name]["records"]
        dp = float(np.mean([r["output_psnr"] - r["input_psnr"]
                            for r in recs]))
        ss = float(np.mean([r["output_ssim"] for r in recs]))
        lines.append(
            f"| {name} "
            f"| {'x' if kw.get('with_retrieval', True) else '-'} "
            f"| {'x' if kw.get('with_reflection', True) else '-'} "
            f"| {'x' if kw.get('with_rollback', True) else '-'} "
            f"| {reports[name]['mean_output_psnr']:.3f} | {dp:+.3f} "
            f"| {ss:.4f} |")

    lines += ["", "## Paired comparisons (ablated dimension)", ""]
    pair_stats = []
    for dim, a, b in ABLATION_PAIRS:
        if a not in reports or b not in reports:
            continue
        ra = reports[a]["records"]
        rb = reports[b]["records"]
        wins = sum(x["output_psnr"] > y["output_psnr"]
                   for x, y in zip(ra, rb))
        delta = reports[a]["mean_output_psnr"] - \
            reports[b]["mean_output_psnr"]
        pair_stats.append({"dim": dim, "with": a, "without": b,
                           "delta_psnr": round(delta, 3),
                           "wins": wins, "n": len(ra)})
        lines.append(f"- **{dim}**: {a} vs {b}: dPSNR {delta:+.3f}, "
                     f"wins {wins}/{len(ra)}")

    grid = {"variants": {n: {"mean_output_psnr":
                             reports[n]["mean_output_psnr"],
                             "mean_input_psnr":
                             reports[n]["mean_input_psnr"]}
                         for n in reports},
            "pairs": pair_stats}
    work_dir.mkdir(parents=True, exist_ok=True)
    (work_dir / "ablation_grid.md").write_text("\n".join(lines) + "\n")
    (work_dir / "ablation_grid.json").write_text(json.dumps(grid, indent=2))
    return grid
