"""Degradation evaluators & pairwise quality comparison (counterpart of
``image_restoration_agent_tpu/agent/evaluators.py``).

Three interchangeable implementations of the reference's evaluation branch
(AgenticIR/pipeline/iragent.py:245-259):

- ``LocalEvaluator``: the in-process classifier (iqa/classifier.py) on
  the card, or on the CPU when asked — the default; no services needed.
- ``DepictQAClient``: HTTP client honoring the reference DepictQA service
  contract (llm/depictqa.py:74-77, 87-94 — POST /evaluate_degradation on
  :6006, /compare_quality on :5002) for drop-in use with an external VLM.
- ``GPT4VEvaluator``: the GPT-4V path via the LLM client with format checks.

All return the same decision types: ``evaluate(img_path)`` ->
``[(degradation, severity)] * 7``; ``severity_of(img_path, degradation)`` ->
level; ``compare(img_a, img_b)`` -> "former" | "latter" | "neither".
"""

from __future__ import annotations

from typing import Optional, Protocol

import numpy as np

from ..core.io import load_image, to_float
from ..iqa.classifier import (EVALUATED_DEGRADATIONS, SEVERITY_LEVELS,
                              SeverityEvaluator)
from . import prompts
from .llm import BaseLLM, _loose_json


class Evaluator(Protocol):
    def evaluate(self, img_path) -> list[tuple[str, str]]: ...
    def severity_of(self, img_path, degradation: str) -> str: ...
    def compare(self, img_a, img_b) -> str: ...


class LocalEvaluator:
    """Classifier-backed evaluator (DepictQA stand-in): the given
    ``SeverityEvaluator``, else the shipped one on ``device``."""

    def __init__(self, severity_evaluator: Optional[SeverityEvaluator] = None,
                 device: str = "cuda"):
        self.ev = severity_evaluator or SeverityEvaluator.default(device)

    def _img(self, img_path) -> np.ndarray:
        return to_float(load_image(img_path))

    def evaluate(self, img_path) -> list[tuple[str, str]]:
        return self.ev.evaluate(self._img(img_path))

    def severity_of(self, img_path, degradation: str) -> str:
        return self.ev.severity_of(self._img(img_path), degradation)

    def compare(self, img_a, img_b) -> str:
        """Lower aggregate expected severity wins; close call -> neither."""
        sa = self._aggregate(self._img(img_a))
        sb = self._aggregate(self._img(img_b))
        if abs(sa - sb) < 0.05:
            return "neither"
        return "former" if sa < sb else "latter"

    def _aggregate(self, img: np.ndarray) -> float:
        lg = self.ev.logits(img)
        probs = np.exp(lg - lg.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        exp_level = (probs * np.arange(len(SEVERITY_LEVELS))).sum(-1)
        return float(exp_level.mean())


class DepictQAClient:
    """HTTP client with the reference DepictQA service contract."""

    def __init__(self, eval_url: str = "http://127.0.0.1:6006",
                 comp_url: str = "http://127.0.0.1:5002", session=None):
        self.eval_url = eval_url.rstrip("/")
        self.comp_url = comp_url.rstrip("/")
        if session is None:
            import requests

            session = requests.Session()
        self._s = session

    def severity_of(self, img_path, degradation: str) -> str:
        r = self._s.post(
            f"{self.eval_url}/evaluate_degradation",
            json={"img_path": str(img_path), "degradation": degradation},
            timeout=300)
        level = r.json()["answer"].strip().lower()
        assert level in SEVERITY_LEVELS, f"bad severity: {level!r}"
        return level

    def evaluate(self, img_path) -> list[tuple[str, str]]:
        return [(d, self.severity_of(img_path, d))
                for d in EVALUATED_DEGRADATIONS]

    def compare(self, img_a, img_b) -> str:
        r = self._s.post(
            f"{self.comp_url}/compare_quality",
            json={"img_path_A": str(img_a), "img_path_B": str(img_b)},
            timeout=300)
        ans = r.json()["answer"].strip().lower()
        # reference maps "Image A"/"Image B" wording to former/latter
        if "a" in ans.split() or ans in {"image a", "a", "former"}:
            return "former"
        if "b" in ans.split() or ans in {"image b", "b", "latter"}:
            return "latter"
        return "neither"


class GPT4VEvaluator:
    """Evaluator over a vision LLM with the reference's format checks
    (iragent.py:262-280, 581-614, 645-673)."""

    def __init__(self, llm: BaseLLM):
        self.llm = llm

    def evaluate(self, img_path) -> list[tuple[str, str]]:
        def check(ev):
            assert isinstance(ev, list), "must be a list"
            seen = set()
            for e in ev:
                assert isinstance(e, dict), "elements must be dicts"
                assert set(e) == {"degradation", "thought", "severity"}, \
                    f"bad keys: {set(e)}"
                assert e["severity"] in SEVERITY_LEVELS, e["severity"]
                seen.add(e["degradation"])
            assert seen == set(EVALUATED_DEGRADATIONS), seen

        ans = self.llm(prompts.EVALUATE_DEGRADATION, img_path=img_path,
                       format_check=check)
        return [(e["degradation"], e["severity"]) for e in _loose_json(ans)]

    def severity_of(self, img_path, degradation: str) -> str:
        def check(ev):
            assert isinstance(ev, dict) and set(ev) == {"thought", "severity"}
            assert ev["severity"] in SEVERITY_LEVELS

        ans = self.llm(
            prompts.EVALUATE_TOOL_RESULT.format(degradation=degradation),
            img_path=img_path, format_check=check)
        return _loose_json(ans)["severity"]

    def compare(self, img_a, img_b) -> str:
        def check(c):
            assert isinstance(c, dict) and set(c) == {"thought", "choice"}
            assert c["choice"] in {"former", "latter", "neither"}

        ans = self.llm(prompts.COMPARE_QUALITY, img_path=[img_a, img_b],
                       format_check=check)
        return _loose_json(ans)["choice"]
