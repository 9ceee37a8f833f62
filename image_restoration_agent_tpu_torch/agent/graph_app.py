"""Graph-mode agent: the AgentApp pipeline on the in-repo StateGraph
(counterpart of ``image_restoration_agent_tpu/agent/graph_app.py``).

Keeps the reference's node names, state keys and call sequence
(AgentApp/agentic.py:15-46, 245-299):

    load_image -> evaluate_by_retrieval
      -[similarity >= 0.9]-> propose_plan_retrieval
      -[else]-> first_evaluate_by_depictqa -> propose_plan_depictqa
    -> execute_one_degradation (self-loop while plan non-empty)
    -> get_output

State keys mirror the reference ImageState where used: image_path, plan,
executed, retrieval (similarity/res_seq), evaluation, subtask_success,
best_img_path, output_path.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Optional

from ..iqa.classifier import SEVERITY_LEVELS
from .evaluators import Evaluator, LocalEvaluator
from .executor import Executor, build_default_executor
from .iragent import DEGRA_SUBTASK, SUBTASK_DEGRA
from .graph import END, StateGraph
from .llm import BaseLLM, MockLLM, _loose_json
from . import prompts

RETRIEVAL_THRESHOLD = 0.9  # reference agentic.py:260-264


def create_image_analysis_graph(
    executor: Optional[Executor] = None,
    evaluator: Optional[Evaluator] = None,
    llm: Optional[BaseLLM] = None,
    retrieval_store=None,
    schedule_experience: str = "",
    device: str = "cuda",
):
    executor = executor or build_default_executor(fast=True, device=device)
    evaluator = evaluator or LocalEvaluator(device=device)
    llm = llm or MockLLM()

    def load_image(state):
        p = Path(state["image_path"])
        assert p.exists(), f"missing input image {p}"
        work = Path(state["work_dir"])
        (work / "0-img").mkdir(parents=True, exist_ok=True)
        shutil.copy(p, work / "0-img" / "input.png")
        state["current_img_path"] = str(work / "0-img" / "input.png")
        state["executed"] = []
        state["subtask_success"] = {}
        return state

    def evaluate_by_retrieval(state):
        if retrieval_store is None:
            state["retrieval"] = {"similarity": 0.0, "res_seq": None}
            return state
        emb = retrieval_store.embed(state["current_img_path"])
        hits = retrieval_store.query(emb, topk=1)
        if hits:
            state["retrieval"] = {"similarity": hits[0]["similarity"],
                                  "res_seq": hits[0]["res_seq"]}
        else:
            state["retrieval"] = {"similarity": 0.0, "res_seq": None}
        return state

    def use_retrieval(state) -> str:
        sim = state["retrieval"]["similarity"]
        return "retrieval" if sim >= RETRIEVAL_THRESHOLD else "depictqa"

    def propose_plan_retrieval(state):
        res_seq = state["retrieval"]["res_seq"]
        plan = []
        for step in res_seq.split("/"):
            # "subtask_tool"; subtask names never contain "_", tools may
            subtask, tool = step.split("_", 1)
            plan.append((subtask, tool))
        state["plan"] = plan
        state["initial_plan"] = list(plan)
        return state

    def first_evaluate_by_depictqa(state):
        state["evaluation"] = evaluator.evaluate(state["current_img_path"])
        return state

    def propose_plan_depictqa(state):
        agenda = [DEGRA_SUBTASK[d] for d, s in state["evaluation"]
                  if SEVERITY_LEVELS.index(s) >= 2]
        from ..core.io import load_image as _load

        img = _load(state["current_img_path"])
        if max(img.shape[:2]) < 300:
            agenda.insert(0, "super-resolution")
        if len(agenda) > 1:
            def check(obj):
                assert isinstance(obj, dict) and set(obj) == {"thought",
                                                              "order"}
                assert set(obj["order"]) == set(agenda)

            ans = llm(prompts.SCHEDULE_WITH_EXPERIENCE.format(
                degradations=[SUBTASK_DEGRA[s] for s in agenda],
                agenda=agenda, experience=schedule_experience),
                format_check=check)
            agenda = list(_loose_json(ans)["order"])
        state["plan"] = [(s, None) for s in agenda]
        state["initial_plan"] = list(state["plan"])
        return state

    def execute_one_degradation(state):
        subtask, tool_name = state["plan"].pop(0)
        work = Path(state["work_dir"])
        in_dir = Path(state["current_img_path"]).parent
        toolbox = list(executor.toolbox_router[subtask])
        if tool_name is not None:
            toolbox = [t for t in toolbox if t.tool_name == tool_name]
        assert toolbox, f"no tools for {subtask}"
        degradation = SUBTASK_DEGRA[subtask]

        best_path, best_level = None, None
        for tool in toolbox:
            out_dir = work / f"subtask-{subtask}" / \
                f"tool-{tool.tool_name}" / "0-img"
            try:
                tool(in_dir, out_dir)
            except Exception as e:  # reference swallows per-tool failures
                state.setdefault("tool_errors", []).append(
                    f"{subtask}/{tool.tool_name}: {e}")
                continue
            out_path = out_dir / "output.png"
            level = evaluator.severity_of(out_path, degradation)
            if best_level is None or (SEVERITY_LEVELS.index(level)
                                      < SEVERITY_LEVELS.index(best_level)):
                best_path, best_level = out_path, level
            if level == "very low":
                break

        assert best_path is not None, f"all tools failed for {subtask}"
        success = SEVERITY_LEVELS.index(best_level) <= 1
        state["subtask_success"][subtask] = success
        state["executed"].append(subtask)
        if not success and (subtask, tool_name) not in \
                state.get("retried", []):
            # graph-mode rollback: re-append unless already retried
            # (reference agentic.py:226-233)
            state.setdefault("retried", []).append((subtask, tool_name))
            state["plan"].append((subtask, tool_name))
        state["current_img_path"] = str(best_path)
        return state

    def plan_state(state) -> str:
        return "continue" if state["plan"] else "done"

    def get_output(state):
        out = Path(state["work_dir"]) / "result.png"
        shutil.copy(state["current_img_path"], out)
        state["output_path"] = str(out)
        state["best_img_path"] = state["current_img_path"]
        return state

    g = StateGraph()
    g.add_node("load_image", load_image)
    g.add_node("evaluate_by_retrieval", evaluate_by_retrieval)
    g.add_node("propose_plan_retrieval", propose_plan_retrieval)
    g.add_node("first_evaluate_by_depictqa", first_evaluate_by_depictqa)
    g.add_node("propose_plan_depictqa", propose_plan_depictqa)
    g.add_node("execute_one_degradation", execute_one_degradation)
    g.add_node("get_output", get_output)

    g.set_entry_point("load_image")
    g.add_edge("load_image", "evaluate_by_retrieval")
    g.add_conditional_edges("evaluate_by_retrieval", use_retrieval, {
        "retrieval": "propose_plan_retrieval",
        "depictqa": "first_evaluate_by_depictqa",
    })
    g.add_edge("propose_plan_retrieval", "execute_one_degradation")
    g.add_edge("first_evaluate_by_depictqa", "propose_plan_depictqa")
    g.add_edge("propose_plan_depictqa", "execute_one_degradation")
    g.add_conditional_edges("execute_one_degradation", plan_state, {
        "continue": "execute_one_degradation",
        "done": "get_output",
    })
    g.add_edge("get_output", END)
    return g.compile()


def run_agent(image_path: str | Path, work_dir: str | Path,
              graph=None, device: str = "cuda", **graph_kw) -> dict:
    graph = graph or create_image_analysis_graph(device=device, **graph_kw)
    state = {"image_path": str(image_path), "work_dir": str(work_dir)}
    return graph.invoke(state)
