"""Exhaustive plan-order exploration (experience mining; counterpart of
``image_restoration_agent_tpu/offline/exploration.py``).

Rebuild of AgenticIR/exploration/exhaust_seq.py + explore.py: for a set of
degradations, execute every subtask permutation x tool combination as a
directory tree (same subtask-*/tool-*/0-img layout as the agent), then score
every leaf with the degradation evaluator to produce per-plan fail rates
(memory/fail_rate.json). The tools run where the executor's engine runs,
the evaluator where its classifier runs.

Invariants (exhaust_seq.py:23-47): with d subtasks and n_i tools each, the
tree has sum over prefixes of products-of-tool-counts nodes and
d! * prod(n_i) leaves; ``expected_tree_counts`` computes these and the tests
assert the generated tree matches.
"""

from __future__ import annotations

import itertools
import json
import math
from pathlib import Path
from typing import Optional

import numpy as np

from ..agent.executor import Executor
from ..agent.iragent import SUBTASK_DEGRA
from ..core.io import load_image, save_image
from ..iqa.classifier import SEVERITY_LEVELS


def expected_tree_counts(tool_counts: list[int]) -> dict:
    """Node/leaf counts for the full permutation x tool tree."""
    d = len(tool_counts)
    leaves = math.factorial(d) * int(np.prod(tool_counts))
    # internal image nodes: for each ordered prefix of distinct subtasks,
    # product of their tool counts (sum over all ordered prefixes).
    nodes = 0
    for r in range(1, d + 1):
        for perm in itertools.permutations(range(d), r):
            nodes += int(np.prod([tool_counts[i] for i in perm]))
    return {"leaves": leaves, "nodes": nodes}


def exhaust_sequences(
    input_path: Path,
    work_dir: Path,
    subtasks: list[str],
    executor: Executor,
    max_leaves: Optional[int] = None,
) -> list[Path]:
    """Execute every subtask order x tool choice; returns leaf image paths."""
    work_dir = Path(work_dir)
    root = work_dir / "0-img"
    root.mkdir(parents=True, exist_ok=True)
    img = load_image(input_path)
    save_image(img.astype(np.float32) / 255.0, root / "input.png")

    leaves: list[Path] = []

    def expand(cur_dir: Path, remaining: list[str]):
        if max_leaves is not None and len(leaves) >= max_leaves:
            return
        if not remaining:
            leaves.append(next((cur_dir / "0-img").glob("*.png")))
            return
        for subtask in remaining:
            sub_dir = cur_dir / f"subtask-{subtask}"
            for tool in executor.toolbox_router[subtask]:
                out_dir = sub_dir / f"tool-{tool.tool_name}" / "0-img"
                if not (out_dir / "output.png").exists():
                    tool(cur_dir / "0-img", out_dir)
                expand(sub_dir / f"tool-{tool.tool_name}",
                       [s for s in remaining if s != subtask])

    expand(work_dir, list(subtasks))
    return leaves


def _plan_of(leaf: Path, tree_root: Path) -> tuple[str, ...]:
    parts = leaf.relative_to(tree_root).parts
    return tuple(p.split("-", 1)[1] for p in parts if p.startswith("subtask-"))


def explore_fail_rates(
    tree_root: Path,
    evaluator,
    subtasks: list[str],
    fail_threshold: str = "medium",
) -> dict:
    """Score every leaf; a leaf fails a degradation if its residual severity
    is >= ``fail_threshold``. Emits the reference fail_rate.json structure:
    per-plan totals and per-degradation rates."""
    tree_root = Path(tree_root)
    thr = SEVERITY_LEVELS.index(fail_threshold)
    by_plan: dict[tuple, dict] = {}

    leaves = sorted(tree_root.rglob("0-img/output.png"))
    for leaf in leaves:
        plan = _plan_of(leaf, tree_root)
        if len(plan) != len(subtasks):
            continue  # internal node, not a full-plan leaf
        rec = by_plan.setdefault(plan, {
            "n": 0, "fail_total": 0,
            **{SUBTASK_DEGRA[s]: 0 for s in subtasks}})
        rec["n"] += 1
        failed_any = False
        for s in subtasks:
            deg = SUBTASK_DEGRA[s]
            level = evaluator.severity_of(leaf, deg)
            if SEVERITY_LEVELS.index(level) >= thr:
                rec[deg] += 1
                failed_any = True
        rec["fail_total"] += int(failed_any)

    out = {}
    for plan, rec in by_plan.items():
        n = max(rec["n"], 1)
        out[" -> ".join(plan)] = {
            "n": rec["n"],
            "fail_rate_total": round(rec["fail_total"] / n, 4),
            **{f"fail_rate[{deg}]": round(rec[deg] / n, 4)
               for s in subtasks for deg in [SUBTASK_DEGRA[s]]},
        }
    return out


def save_fail_rates(fail_rates: dict, path: Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(fail_rates, indent=2))
