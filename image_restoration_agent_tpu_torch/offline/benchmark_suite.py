"""End-to-end agent benchmark over the reference's degradation combos
(counterpart of ``image_restoration_agent_tpu/offline/benchmark_suite.py``).

The reference's main experiment (AgenticIR paper / eval/compare_methods.py):
synthesize the 16 mixed-degradation combos (dataset/degradations.txt, in
groups A/B/C), run the agent on each, score results against the clean
ground truth, and tabulate: synthetic HQ images -> combo degradation ->
IRAgent -> PSNR/SSIM vs HQ -> markdown table, plus the input-vs-output
delta. The agent's tools, its classifier, the scorer and the degradations'
resizes run on ``device``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..agent import IRAgent, build_default_executor
from ..core.io import load_image, save_image, to_float
from ..data.degrade import synthesize_combo
from ..device import resolve_device
from ..iqa.scorer import Scorer

#: the 16 reference combos in their three groups
#: (dataset/degradations.txt:1-17; groups per eval/compare_methods.py).
GROUP_A = [
    "rain + haze", "motion blur + low resolution", "dark + noise",
    "defocus blur + jpeg compression artifact",
    "noise + jpeg compression artifact", "rain + low resolution",
    "motion blur + dark", "defocus blur + haze",
]
GROUP_B = [
    "motion blur + jpeg compression artifact", "haze + noise",
    "defocus blur + low resolution", "rain + dark",
]
GROUP_C = [
    "haze + motion blur + low resolution", "rain + noise + low resolution",
    "dark + defocus blur + jpeg compression artifact",
    "motion blur + defocus blur + noise",
]
ALL_COMBOS = GROUP_A + GROUP_B + GROUP_C


def synthetic_hq(n: int, size: int = 96, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        yy, xx = np.mgrid[0:size, 0:size]
        f1, f2 = rng.uniform(0.05, 0.35, 2)
        img = np.stack([
            127 + 120 * np.sin(f1 * xx + rng.uniform(0, 6)),
            127 + 120 * np.cos(f2 * yy + rng.uniform(0, 6)),
            ((xx // rng.integers(4, 14) + yy // rng.integers(4, 14)) % 2)
            * 210 + 22,
        ], -1)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def run_suite(
    work_dir: Path,
    combos: Optional[list[str]] = None,
    images_per_combo: int = 1,
    executor=None,
    fast: bool = True,
    seed: int = 0,
    agent_kwargs: Optional[dict] = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Run the agent across combos; returns scores + plans per task.

    ``agent_kwargs`` forwards IRAgent flags (with_retrieval /
    with_reflection / with_rollback) — the ablation-grid axes. The
    executor (``build_default_executor(fast=fast, device=device)`` unless
    one is given), the agent's evaluator and the scorer run on ``device``.
    """
    device = resolve_device(device)
    work_dir = Path(work_dir)
    combos = combos if combos is not None else ALL_COMBOS
    executor = executor or build_default_executor(fast=fast, device=device)
    scorer = Scorer(device=device)
    rng = np.random.default_rng(seed)
    hqs = synthetic_hq(images_per_combo * len(combos), seed=seed)

    records = []
    idx = 0
    for combo in combos:
        for _ in range(images_per_combo):
            hq = hqs[idx]
            idx += 1
            lq = synthesize_combo(hq, combo, rng=rng, device=device)
            case_dir = work_dir / f"case_{idx:03d}"
            case_dir.mkdir(parents=True, exist_ok=True)
            save_image(hq.astype(np.float32) / 255, case_dir / "hq.png")
            save_image(lq.astype(np.float32) / 255, case_dir / "lq.png")

            agent = IRAgent(case_dir / "lq.png", case_dir / "runs",
                            executor=executor, device=device,
                            **(agent_kwargs or {}))
            result = agent.run()
            out = to_float(load_image(result))
            hq_f = hq.astype(np.float32) / 255
            lq_f = lq.astype(np.float32) / 255
            s_out = scorer.score_arrays(out, hq_f)
            s_in = scorer.score_arrays(lq_f, hq_f)
            summary = json.loads(agent.summary_path.read_text())
            records.append({
                "combo": combo,
                "input_psnr": round(s_in["psnr"], 3),
                "output_psnr": round(s_out["psnr"], 3),
                "input_ssim": round(s_in["ssim"], 4),
                "output_ssim": round(s_out["ssim"], 4),
                "plan": summary["plan"]["initial"],
                "executed": summary["execution_path"]["subtasks"],
                "n_invocations": summary["n_invocations"],
            })

    report = {
        "records": records,
        "mean_input_psnr": round(float(np.mean(
            [r["input_psnr"] for r in records])), 3),
        "mean_output_psnr": round(float(np.mean(
            [r["output_psnr"] for r in records])), 3),
    }
    (work_dir / "report.json").write_text(json.dumps(report, indent=2))
    (work_dir / "report.md").write_text(render_table(records))
    return report


def render_table(records: list[dict]) -> str:
    lines = ["| combo | PSNR in | PSNR out | SSIM in | SSIM out | plan |",
             "|---|---|---|---|---|---|"]
    for r in records:
        lines.append(
            f"| {r['combo']} | {r['input_psnr']} | {r['output_psnr']} | "
            f"{r['input_ssim']} | {r['output_ssim']} | "
            f"{' -> '.join(r['plan'])} |")
    return "\n".join(lines)
