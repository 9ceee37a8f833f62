"""IRAgent: the research-agent loop (plan, execute, reflect, roll back);
counterpart of ``image_restoration_agent_tpu/agent/iragent.py``, with the
same calls to its ``random.Random(rng_seed)`` in the same order.

Behavioral rebuild of AgenticIR/pipeline/iragent.py:34-941 with the same
public surface and decision semantics:

- ``IRAgent(input_path, output_dir, evaluate_degradation_by=...,
  with_retrieval, with_reflection, reflect_by, with_rollback, silent)`` then
  ``agent.run(plan=None, cache=None)`` (iragent.py:49-82, 197-214).
- working memory dict with the same keys (plan/initial, plan/adjusted,
  execution_path, n_invocations, tree of subtask->tool nodes), streamed to
  ``logs/summary.json`` after every step (iragent.py:86-114, 939-941).
- agenda extraction: images smaller than 300px gain super-resolution;
  severities >= "medium" enter the agenda; order shuffled before scheduling
  (iragent.py:228-243).
- per-subtask execution: shuffled toolbox, severity reflection per tool
  output, early break on "very low", otherwise best-of-level via pairwise
  comparison; success iff residual severity <= "low"
  (iragent.py:474-579, 615-644).
- rollback: backtrack re-inserting the failed subtask; while fully expanded,
  pick best descendant and climb; at the root, compromise-jump to the best
  descendant (iragent.py:674-712).
- reschedule: pick up the failed plan after a compromise; schedule the
  remaining agenda when exactly one subtask is unexplored; otherwise
  re-query the planner with a "don't start with X" postscript and swap if it
  disobeys (iragent.py:750-803).
- cache replay: tool outputs symlinked from a previous run's tree
  (iragent.py:518-522) — keeps agent tests hermetic and fast.

Differences by design: tools run in-process on the port's engine (no conda
subprocesses), and the evaluator/planner are injected so the loop runs fully
offline (LocalEvaluator + MockLLM) or with real LLM/VLM services. The
default evaluator and executor run on ``device`` (the card unless the
caller asks for the CPU).
"""

from __future__ import annotations

import json
import logging
import random
import shutil
import time
from pathlib import Path
from typing import Optional

from ..core.io import load_image
from ..iqa.classifier import SEVERITY_LEVELS
from . import prompts
from .evaluators import Evaluator, GPT4VEvaluator, LocalEvaluator
from .executor import Executor, build_default_executor
from .img_tree import ImgTree
from .llm import BaseLLM, MockLLM, _loose_json
from ..utils.logger import get_logger

DEGRA_SUBTASK = {
    "low resolution": "super-resolution",
    "noise": "denoising",
    "motion blur": "motion deblurring",
    "defocus blur": "defocus deblurring",
    "haze": "dehazing",
    "rain": "deraining",
    "dark": "brightening",
    "jpeg compression artifact": "jpeg compression artifact removal",
}
SUBTASK_DEGRA = {v: k for k, v in DEGRA_SUBTASK.items()}


class IRAgent:
    def __init__(
        self,
        input_path: Path,
        output_dir: Path,
        llm: Optional[BaseLLM] = None,
        evaluator: Optional[Evaluator] = None,
        executor: Optional[Executor] = None,
        evaluate_degradation_by: str = "local",   # local | gpt4v | clip_retrieval
        with_retrieval: bool = True,
        schedule_experience: Optional[str] = None,
        schedule_experience_path: Optional[Path] = None,
        with_reflection: bool = True,
        reflect_by: str = "local",
        with_rollback: bool = True,
        retrieval_store=None,
        silent: bool = True,
        rng_seed: int = 0,
        device: str = "cuda",
    ):
        input_path, output_dir = Path(input_path), Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

        # idempotency: skip inputs already processed (iragent.py:65, 892-895)
        # task dirs are "<parentdir>_<filename>-<timestamp>"
        self._o_name = "_".join(str(input_path).split("/")[-2:])
        self.skip = any(p.name.rsplit("-", 1)[0] == self._o_name
                        for p in output_dir.iterdir())
        self.input_path = input_path

        assert evaluate_degradation_by in {"local", "gpt4v", "depictqa",
                                           "clip_retrieval"}
        self.evaluate_degradation_by = evaluate_degradation_by
        self.with_retrieval = with_retrieval
        self.with_reflection = with_reflection
        self.reflect_by = reflect_by
        self.with_rollback = with_rollback
        self.retrieval_store = retrieval_store
        self._rng = random.Random(rng_seed)

        self._prepare_dirs(input_path, output_dir)

        self.qa_logger = get_logger(
            "IRAgent QA", log_file=self.qa_path,
            console_log_level=logging.WARNING,
            file_format_str="%(message)s", silent=silent)
        self.workflow_logger = get_logger(
            "IRAgent Workflow", log_file=self.workflow_path, silent=silent)

        self.llm = llm or MockLLM(logger=self.qa_logger)
        if evaluator is None:
            evaluator = (GPT4VEvaluator(self.llm)
                         if evaluate_degradation_by == "gpt4v"
                         else LocalEvaluator(device=device))
        self.evaluator = evaluator
        self.executor = executor or build_default_executor(fast=True,
                                                           device=device)

        if schedule_experience is None and schedule_experience_path:
            data = json.loads(Path(schedule_experience_path).read_text())
            schedule_experience = data.get("distilled", "")
        self.schedule_experience = schedule_experience or ""

        self._init_state()

    # ------------- state -------------

    def _init_state(self) -> None:
        self.plan: list = []
        self.work_mem = {
            "plan": {"initial": [], "adjusted": []},
            "execution_path": {"subtasks": [], "tools": []},
            "n_invocations": 0,
            "tree": {
                "img_path": str(self.img_tree_dir / "0-img" / "input.png"),
                "best_descendant": None,
                "children": {},
            },
        }
        self.cur_node = self.work_mem["tree"]

    def _prepare_dirs(self, input_path: Path, output_dir: Path) -> None:
        task_id = f"{self._o_name}-{time.strftime('%y%m%d_%H%M%S')}"
        self.work_dir = output_dir / task_id
        n = 0
        while self.work_dir.exists():  # same-second starts must not collide
            n += 1
            self.work_dir = output_dir / f"{task_id}_{n}"
        self.work_dir.mkdir(parents=True)
        self.img_tree_dir = self.work_dir / "img_tree"
        (self.img_tree_dir / "0-img").mkdir(parents=True)
        self.log_dir = self.work_dir / "logs"
        self.log_dir.mkdir()
        self.qa_path = self.log_dir / "llm_qa.md"
        self.workflow_path = self.log_dir / "workflow.log"
        self.summary_path = self.log_dir / "summary.json"
        shutil.copy(input_path, self.img_tree_dir / "0-img" / "input.png")

    # ------------- main loop -------------

    def run(self, plan: Optional[list] = None,
            cache: Optional[Path] = None) -> Optional[Path]:
        if self.skip:
            return None
        if plan is not None:
            self.plan = list(plan)
        else:
            self.propose()
        retrieval_mode = self.evaluate_degradation_by == "clip_retrieval"
        while self.plan:
            success = self.execute_subtask(cache)
            if (plan is None and not retrieval_mode and self.with_rollback
                    and not success):
                self.roll_back()
                self.reschedule()
        return self._record_res()

    # ------------- propose / schedule -------------

    def propose(self) -> None:
        evaluation = self.evaluate_degradation()
        agenda = self.extract_agenda(evaluation)
        plan = self.schedule(agenda)
        self.work_mem["plan"]["initial"] = list(plan)
        self._dump_summary()
        self.workflow_logger.info(f"Plan: {plan}")
        self.plan = plan

    def evaluate_degradation(self):
        if self.evaluate_degradation_by == "clip_retrieval":
            emb = self.retrieval_store.embed(
                self.cur_node["img_path"])
            hits = self.retrieval_store.query(emb, topk=1)
            assert hits, "retrieval store is empty"
            res_seq = hits[0]["res_seq"]
            evaluation = [(s, None, t) for s, t in
                          (step.split("_", 1) for step in res_seq.split("/"))]
        else:
            evaluation = self.evaluator.evaluate(
                Path(self.cur_node["img_path"]))
        self.workflow_logger.info(f"Evaluation: {evaluation}")
        return evaluation

    def extract_agenda(self, evaluation) -> list:
        if self.evaluate_degradation_by == "clip_retrieval":
            return [(DEGRA_SUBTASK.get(item[0], item[0]), item[2])
                    for item in evaluation]
        agenda = []
        img = load_image(self.cur_node["img_path"])
        if max(img.shape[:2]) < 300:  # size heuristic (iragent.py:230-232)
            agenda.append("super-resolution")
        for degradation, severity in evaluation:
            if SEVERITY_LEVELS.index(severity) >= 2:  # medium and above
                agenda.append(DEGRA_SUBTASK[degradation])
        self._rng.shuffle(agenda)  # presentation-order de-bias
        return agenda

    def schedule(self, agenda: list, ps: str = "") -> list:
        if self.evaluate_degradation_by == "clip_retrieval":
            return list(agenda)
        if len(agenda) <= 1:
            return list(agenda)
        degradations = [SUBTASK_DEGRA[s] for s in agenda]
        if self.with_retrieval and self.schedule_experience:
            return self._schedule_with_experience(degradations, agenda, ps)
        return self._schedule_with_reasoning(degradations, agenda, ps)

    def _schedule_with_experience(self, degradations, agenda, ps) -> list:
        def check(obj):
            assert isinstance(obj, dict) and set(obj) == {"thought", "order"}
            assert set(obj["order"]) == set(agenda), \
                f"{obj['order']} is not a permutation of {agenda}"

        ans = self.llm(
            prompts.SCHEDULE_WITH_EXPERIENCE.format(
                degradations=degradations, agenda=agenda,
                experience=self.schedule_experience) + ps,
            format_check=check)
        obj = _loose_json(ans)
        self.workflow_logger.info(f"Insights: {obj['thought']}")
        return list(obj["order"])

    def _schedule_with_reasoning(self, degradations, agenda, ps) -> list:
        insights = self.llm(prompts.REASON_ABOUT_ORDER.format(
            degradations=degradations, agenda=agenda))

        def check(order):
            assert isinstance(order, list)
            assert set(order) == set(agenda), \
                f"{order} is not a permutation of {agenda}"

        ans = self.llm(
            prompts.SCHEDULE_WITHOUT_EXPERIENCE.format(
                degradations=degradations, agenda=agenda,
                insights=insights) + ps,
            format_check=check)
        return list(_loose_json(ans))

    # ------------- execution -------------

    def execute_subtask(self, cache: Optional[Path] = None) -> bool:
        subtask = self.plan.pop(0)
        retrieval_mode = self.evaluate_degradation_by == "clip_retrieval"
        key = subtask[0] if retrieval_mode else subtask
        degradation = SUBTASK_DEGRA[key]

        subtask_dir = Path(self.cur_node["img_path"]).parents[1] / \
            f"subtask-{key}"
        subtask_dir.mkdir()
        toolbox = list(self.executor.toolbox_router[key])
        if retrieval_mode:
            toolbox = [t for t in toolbox if t.tool_name == subtask[1]]
        else:
            self._rng.shuffle(toolbox)
        assert toolbox, f"empty toolbox for {key}"
        self.workflow_logger.info(f"Executing {key}...")

        by_level: dict[str, list[Path]] = {}
        success = True
        best_img_path: Optional[Path] = None
        res_level = "none"
        best_tool_name = None

        for tool in toolbox:
            self.work_mem["n_invocations"] += 1
            tool_dir = subtask_dir / f"tool-{tool.tool_name}"
            output_dir = tool_dir / "0-img"
            output_dir.mkdir(parents=True)
            if cache is None:
                tool(Path(self.cur_node["img_path"]).parent, output_dir)
                output_path = output_dir / "output.png"
            else:
                output_path = output_dir / "output.png"
                rel = output_path.relative_to(self.img_tree_dir)
                output_path.symlink_to(Path(cache) / rel)

            if self.with_reflection:
                level = self.evaluator.severity_of(output_path, degradation)
                self._record_tool_res(key, tool.tool_name, output_path,
                                      degradation, level)
                by_level.setdefault(level, []).append(output_path)
                if level == "very low":
                    res_level = "very low"
                    best_tool_name = tool.tool_name
                    best_img_path = output_path
                    break
            else:
                self._record_tool_res(key, tool.tool_name, output_path,
                                      degradation, "none")
                best_tool_name = tool.tool_name
                best_img_path = output_path
                break
        else:
            # no "very low" result: best-of-level + success judgement
            for level in SEVERITY_LEVELS[1:]:
                if level in by_level:
                    candidates = by_level[level]
                    best_img_path = self.search_best_by_comp(candidates)
                    best_tool_name = best_img_path.parents[1].name.split(
                        "-", 1)[1]
                    if level != "low":
                        success = False
                    res_level = level
                    break

        node = self.cur_node["children"][key]
        node["best_tool"] = best_tool_name
        self.cur_node = node["tools"][best_tool_name]

        if self.with_rollback and not success:
            self.cur_node["best_descendant"] = str(best_img_path)
            done, _ = self._execution_path(Path(self.cur_node["img_path"]))
            self.work_mem["plan"]["adjusted"].append(
                {"failed": f"{done} + {self.plan}", "new": None})

        self._dump_summary()
        self._render_tree()
        self.workflow_logger.info(
            f"{key} result severity: {res_level}")
        return success

    def search_best_by_comp(self, candidates: list[Path]) -> Path:
        best = candidates[0]
        for cur in candidates[1:]:
            choice = self.evaluator.compare(best, cur)
            if choice == "latter":
                best = cur
        self.workflow_logger.info(f"Best by comparison: {best}")
        return Path(best)

    # ------------- rollback / reschedule -------------

    def roll_back(self) -> None:
        self._backtrack()
        step = 1
        while self._fully_expanded():
            self._set_best_descendant()
            if self.cur_node is not self.work_mem["tree"]:
                step += 1
                self._backtrack()
            else:
                break
        self.workflow_logger.info(f"Rolled back {step} step(s); "
                                  f"agenda {self.plan}")

        if self._fully_expanded():  # at root: compromise
            self._jump_to_best_descendant()
            self.workflow_logger.info(
                f"Compromise: jump to best descendant; agenda {self.plan}")

        done, _ = self._execution_path(Path(self.cur_node["img_path"]))
        assert not (set(done) & set(self.plan)), "plan overlaps done work"
        assert set(done) | set(self.plan) == \
            set(self.work_mem["plan"]["initial"]), "plan lost subtasks"

    def _fully_expanded(self) -> bool:
        return len(self.plan) == len(self.cur_node["children"])

    def _backtrack(self) -> None:
        subtask = DEGRA_SUBTASK[self.cur_node["degradation"]]
        self.plan.insert(0, subtask)
        parent_img = next(
            Path(self.cur_node["img_path"]).parents[3].glob("0-img/*.png"))
        self.cur_node = self._node_for(parent_img)

    def _set_best_descendant(self) -> None:
        candidates = []
        for subtask_res in self.cur_node["children"].values():
            best_tool = subtask_res["best_tool"]
            node = subtask_res["tools"][best_tool]
            candidates.append(Path(node["best_descendant"]
                                   or node["img_path"]))
        best = self.search_best_by_comp(candidates)
        self.cur_node["best_descendant"] = str(best)

    def _jump_to_best_descendant(self) -> None:
        best = Path(self.cur_node["best_descendant"])
        self.cur_node = self._node_for(best)
        done, _ = self._execution_path(best)
        self.plan = [s for s in self.plan if s not in set(done)]

    def _node_for(self, img_path: Path) -> dict:
        node = self.work_mem["tree"]
        for subtask, tool in self._tree().get_execution_path(img_path):
            node = node["children"][subtask]["tools"][tool]
        return node

    def reschedule(self) -> None:
        if not self.plan:
            return
        if not self.cur_node["children"]:
            # after a compromise jump: pick up the failed plan
            done, _ = self._execution_path(Path(self.cur_node["img_path"]))
            for adj in self.work_mem["plan"]["adjusted"]:
                f_done, f_planned = adj["failed"].split(" + ")
                if _loose_json(f_done) == done:
                    self.plan = _loose_json(f_planned)
                    self.workflow_logger.info(
                        f"Picked up failed plan {self.plan}")
                    break
            else:
                raise RuntimeError("no failed plan found to pick up")
        elif len(self.plan) == len(self.cur_node["children"]) + 1:
            explored = list(self.cur_node["children"])
            fresh = [s for s in self.plan if s not in explored]
            assert len(fresh) == 1
            self.plan = fresh + self.schedule(explored)
        else:
            explored = list(self.cur_node["children"])
            failed_str = (explored[0] if len(explored) == 1
                          else "any of " + ", ".join(explored))
            ps = prompts.RESCHEDULE_POSTSCRIPT.format(failed_tries=failed_str)
            self.plan = self.schedule(self.plan, ps=ps)
            if self.plan[0] in explored:
                for i, s in enumerate(self.plan):
                    if s not in explored:
                        self.plan[0], self.plan[i] = self.plan[i], self.plan[0]
                        break
                self.workflow_logger.warning(
                    "Planner restarted with an explored subtask; swapped.")

        done, _ = self._execution_path(Path(self.cur_node["img_path"]))
        assert set(done + self.plan) == set(self.work_mem["plan"]["initial"])
        self.work_mem["plan"]["adjusted"][-1]["new"] = \
            f"{done} + {self.plan}"
        self._dump_summary()
        self.workflow_logger.info(f"Adjusted plan: {self.plan}")

    # ------------- bookkeeping -------------

    def _record_tool_res(self, subtask, tool_name, img_path, degradation,
                         level) -> None:
        children = self.cur_node["children"]
        if subtask not in children:
            children[subtask] = {"best_tool": None, "tools": {}}
        children[subtask]["tools"][tool_name] = {
            "degradation": degradation,
            "severity": level,
            "img_path": str(img_path),
            "best_descendant": None,
            "children": {},
        }
        self.workflow_logger.info(
            f"{subtask}/{tool_name}: {degradation} severity {level}")

    def _record_res(self) -> Path:
        res_path = Path(self.cur_node["img_path"])
        subtasks_tools = self._tree().get_execution_path(res_path)
        if subtasks_tools:
            s, t = zip(*subtasks_tools)
            self.work_mem["execution_path"] = {"subtasks": list(s),
                                               "tools": list(t)}
        self._dump_summary()
        out = self.work_dir / "result.png"
        shutil.copy(res_path, out)
        self.workflow_logger.info(f"Result saved to {out}")
        self.res_path = res_path
        return out

    def _execution_path(self, img_path: Path):
        pairs = self._tree().get_execution_path(img_path)
        if not pairs:
            return [], []
        s, t = zip(*pairs)
        return list(s), list(t)

    def _tree(self) -> ImgTree:
        return ImgTree(self.img_tree_dir, html_dir=self.log_dir)

    def _render_tree(self) -> None:
        self._tree().to_html()

    def _dump_summary(self) -> None:
        self.summary_path.write_text(json.dumps(self.work_mem, indent=2))
