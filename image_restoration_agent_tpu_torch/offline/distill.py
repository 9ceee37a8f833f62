"""Experience distillation (counterpart of
``image_restoration_agent_tpu/offline/distill.py``, the rebuild of
AgenticIR/exploration/distill.py).

Turns raw fail-rate records into a natural-language experience block, asks
the LLM to distill transferable ordering rules, and writes the
schedule_experience.json the planner consumes ({"raw": ..., "distilled": ...},
memory/schedule_experience.json).
"""

from __future__ import annotations

import json
from pathlib import Path

from ..agent import prompts
from ..agent.llm import BaseLLM


def render_experience(fail_rates: dict) -> str:
    lines = []
    for plan, rec in sorted(fail_rates.items(),
                            key=lambda kv: kv[1]["fail_rate_total"]):
        degparts = ", ".join(
            f"{k[10:-1]}: {v:.0%}" for k, v in rec.items()
            if k.startswith("fail_rate["))
        lines.append(
            f"- Plan [{plan}] failed {rec['fail_rate_total']:.0%} of "
            f"{rec['n']} trials ({degparts}).")
    return "\n".join(lines)


def distill_experience(fail_rates: dict, llm: BaseLLM,
                       out_path: Path | None = None) -> dict:
    raw = render_experience(fail_rates)
    distilled = llm(prompts.DISTILL_KNOWLEDGE.format(experience=raw))
    result = {"raw": raw, "distilled": distilled}
    if out_path is not None:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(result, indent=2))
    return result
