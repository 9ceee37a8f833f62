"""LLM clients: vision-chat planning with format-checked retries
(counterpart of ``image_restoration_agent_tpu/agent/llm.py``).

Behavioral rebuild of AgenticIR/llm/ (base_llm.py, gpt4.py, llama.py):

- ``BaseLLM``: callable that logs every Q/A exchange to a markdown file with
  inline base64 images (base_llm.py:43-83).
- ``GPT4Client``: OpenAI-compatible vision chat with a format-check re-query
  loop (gpt4.py:50-69), exponential backoff with jitter and rate-limit
  "try again in Xs" parsing, max 5 retries (gpt4.py:113-180), and a token /
  cost ledger (gpt4.py:208-214).
- ``LlamaClient``: text-only alternative.
- ``MockLLM``: deterministic offline implementation of the same interface so
  the agent loop and tests run hermetically (the reference has no offline
  path — SURVEY.md §4).

``yaml`` is imported only where a config file is read, so the module
imports on a machine without PyYAML.
"""

from __future__ import annotations

import base64
import json
import random
import re
import time
from pathlib import Path
from typing import Callable, Optional

try:
    import requests

    _HAVE_REQUESTS = True
except ImportError:  # pragma: no cover
    _HAVE_REQUESTS = False


def encode_image_b64(path: str | Path) -> str:
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode()


class FormatCheckError(AssertionError):
    pass


class BaseLLM:
    """Call/log plumbing shared by all clients."""

    def __init__(self, logger=None, silent: bool = False):
        self.logger = logger
        self.silent = silent

    def __call__(self, prompt: str, img_path=None,
                 format_check: Optional[Callable] = None, **kw) -> str:
        answer = self.query(prompt, img_path=img_path,
                            format_check=format_check, **kw)
        self._log_chat(prompt, img_path, answer)
        return answer

    def query(self, prompt, img_path=None, format_check=None, **kw) -> str:
        raise NotImplementedError

    def _log_chat(self, prompt: str, img_path, answer: str) -> None:
        if self.logger is None:
            return
        parts = [f"**Q:** {prompt}\n"]
        paths = ([] if img_path is None
                 else img_path if isinstance(img_path, list) else [img_path])
        for p in paths:
            try:
                parts.append(
                    f'<img src="data:image/png;base64,{encode_image_b64(p)}" '
                    f'width="200"/>\n')
            except OSError:
                parts.append(f"(image: {p})\n")
        parts.append(f"**A:** {answer}\n\n---\n")
        self.logger.info("\n".join(parts))


def _parse_retry_after(message: str) -> Optional[float]:
    """Parse a rate-limit message's recommended delay ("try again in 7s")."""
    m = re.search(r"try again in ([0-9.]+)\s*s", message, re.IGNORECASE)
    return float(m.group(1)) if m else None


class GPT4Client(BaseLLM):
    """OpenAI-compatible chat-completions client with vision support."""

    MAX_RETRIES = 5
    MAX_FORMAT_RETRIES = 3

    def __init__(self, config_path: Optional[Path] = None,
                 system_message: str = "", logger=None, silent=False,
                 api_key: Optional[str] = None, model: str = "gpt-4o",
                 base_url: str = "https://api.openai.com/v1",
                 price_per_1k_prompt: float = 0.0025,
                 price_per_1k_completion: float = 0.01,
                 session=None):
        super().__init__(logger, silent)
        if config_path is not None:
            import yaml

            cfg = yaml.safe_load(Path(config_path).read_text())
            gpt = cfg.get("gpt", cfg)
            api_key = gpt.get("api_key", api_key)
            model = gpt.get("model", model)
            base_url = gpt.get("base_url", base_url)
        self.api_key = api_key
        self.model = model
        self.base_url = base_url.rstrip("/")
        self.system_message = system_message
        self.prices = (price_per_1k_prompt, price_per_1k_completion)
        self.prompt_tokens = 0
        self.completion_tokens = 0
        self._session = session  # injectable for tests

    # -- accounting (reference gpt4.py:208-214) --
    @property
    def cost(self) -> float:
        return (self.prompt_tokens / 1000 * self.prices[0]
                + self.completion_tokens / 1000 * self.prices[1])

    def usage(self) -> dict:
        return {"prompt_tokens": self.prompt_tokens,
                "completion_tokens": self.completion_tokens,
                "cost_usd": round(self.cost, 6)}

    # -- request plumbing --
    def _messages(self, prompt: str, img_path) -> list:
        content: list = [{"type": "text", "text": prompt}]
        paths = ([] if img_path is None
                 else img_path if isinstance(img_path, list) else [img_path])
        for p in paths:
            content.append({
                "type": "image_url",
                "image_url": {
                    "url": f"data:image/png;base64,{encode_image_b64(p)}"},
            })
        msgs = []
        if self.system_message:
            msgs.append({"role": "system", "content": self.system_message})
        msgs.append({"role": "user", "content": content})
        return msgs

    def _send(self, messages: list) -> str:
        if self._session is None:
            if not _HAVE_REQUESTS:  # pragma: no cover
                raise RuntimeError("requests unavailable")
            self._session = requests.Session()
        delay = 1.0
        last_err: Exception | None = None
        for attempt in range(self.MAX_RETRIES):
            try:
                resp = self._session.post(
                    f"{self.base_url}/chat/completions",
                    headers={"Authorization": f"Bearer {self.api_key}"},
                    json={"model": self.model, "messages": messages,
                          "temperature": 0.0},
                    timeout=120,
                )
                body = resp.json()
                if resp.status_code == 200:
                    usage = body.get("usage", {})
                    self.prompt_tokens += usage.get("prompt_tokens", 0)
                    self.completion_tokens += usage.get("completion_tokens", 0)
                    return body["choices"][0]["message"]["content"]
                msg = body.get("error", {}).get("message", resp.text)
                last_err = RuntimeError(f"HTTP {resp.status_code}: {msg}")
                hinted = _parse_retry_after(msg)
                delay = hinted if hinted is not None else delay * 2
            except Exception as e:  # network error
                last_err = e
                delay *= 2
            time.sleep(delay + random.uniform(0, 0.5))
        raise RuntimeError(f"LLM request failed after "
                           f"{self.MAX_RETRIES} retries: {last_err}")

    def query(self, prompt, img_path=None, format_check=None, **kw) -> str:
        messages = self._messages(prompt, img_path)
        answer = self._send(messages)
        if format_check is None:
            return answer
        for _ in range(self.MAX_FORMAT_RETRIES):
            try:
                format_check(_loose_json(answer))
                return answer
            except AssertionError as e:
                messages.append({"role": "assistant", "content": answer})
                messages.append({
                    "role": "user",
                    "content": f"Your answer is invalid: {e}. "
                               f"Answer again in exactly the required format."})
                answer = self._send(messages)
        format_check(_loose_json(answer))  # raise if still bad
        return answer


class LlamaClient(BaseLLM):
    """Text-only client against an OpenAI-compatible endpoint
    (reference llm/llama.py via llama-api)."""

    def __init__(self, config_path: Optional[Path] = None, logger=None,
                 silent=False, api_key=None,
                 model: str = "llama3.1-70b",
                 base_url: str = "https://api.llama-api.com", session=None):
        super().__init__(logger, silent)
        if config_path is not None:
            import yaml

            cfg = yaml.safe_load(Path(config_path).read_text())
            llama = cfg.get("llama", cfg)
            api_key = llama.get("api_key", api_key)
            model = llama.get("model", model)
        self._gpt = GPT4Client(api_key=api_key, model=model,
                               base_url=base_url, session=session)

    def query(self, prompt, img_path=None, format_check=None, **kw) -> str:
        if img_path is not None:
            raise ValueError("Llama client is text-only")
        return self._gpt.query(prompt, None, format_check)


def _loose_json(text: str):
    """Parse the model's structured answer: accept fenced blocks and
    single-quoted pseudo-JSON (the reference uses eval(); we do not)."""
    t = text.strip()
    fence = re.search(r"```(?:json)?\s*(.*?)```", t, re.DOTALL)
    if fence:
        t = fence.group(1).strip()
    start = min([i for i in (t.find("["), t.find("{")) if i >= 0],
                default=0)
    t = t[start:]
    try:
        return json.loads(t)
    except json.JSONDecodeError:
        import ast

        return ast.literal_eval(t)


class MockLLM(BaseLLM):
    """Deterministic offline LLM: answers the agent's structured queries
    with rule-based results so the loop runs hermetically."""

    #: canonical restoration order encoding the distilled experience
    #: (denoise/derain/dehaze/deblur before brighten; SR last; JPEG removal
    #: before SR) — mirrors memory/schedule_experience.json's conclusions.
    CANONICAL_ORDER = [
        "defocus deblurring",
        "motion deblurring",
        "deraining",
        "dehazing",
        "denoising",
        "jpeg compression artifact removal",
        "brightening",
        "super-resolution",
    ]

    def __init__(self, logger=None, silent=True):
        super().__init__(logger, silent)
        self.calls: list[str] = []

    def order_agenda(self, agenda: list[str]) -> list[str]:
        return sorted(agenda, key=self.CANONICAL_ORDER.index)

    def query(self, prompt, img_path=None, format_check=None, **kw) -> str:
        self.calls.append(prompt)
        answer = self._answer(prompt)
        if format_check is not None:
            format_check(_loose_json(answer))
        return answer

    def _answer(self, prompt: str) -> str:
        agenda = self._extract_agenda(prompt)
        if '"order"' in prompt and agenda is not None:
            order = self.order_agenda(agenda)
            if "Do not place" in prompt or "not to arrange" in prompt:
                banned = self._extract_banned(prompt)
                order = [s for s in order if s not in banned] + \
                        [s for s in order if s in banned]
                # keep it a permutation but move banned off the front
                if order and order[0] in banned and len(order) > 1:
                    order = order[1:] + order[:1]
            return json.dumps({"thought": "rule-based canonical order",
                               "order": order})
        if "permutation of" in prompt and agenda is not None:
            return json.dumps(self.order_agenda(agenda))
        if '"severity"' in prompt:
            return json.dumps({"thought": "offline stub", "severity": "low"})
        if '"choice"' in prompt:
            return json.dumps({"thought": "offline stub", "choice": "former"})
        if "Distill" in prompt or "distill" in prompt:
            return ("Remove rain/haze/noise before sharpening; brighten "
                    "late; always super-resolve last.")
        return "ok"

    @staticmethod
    def _extract_agenda(prompt: str) -> Optional[list[str]]:
        m = re.findall(r"\[([^\[\]]*)\]", prompt)
        for grp in m:
            items = [s.strip().strip("'\"") for s in grp.split(",") if s.strip()]
            if items and all(i in MockLLM.CANONICAL_ORDER for i in items):
                return items
        return None

    @staticmethod
    def _extract_banned(prompt: str) -> set[str]:
        return {s for s in MockLLM.CANONICAL_ORDER if s in
                prompt.split("Note:")[-1]}
