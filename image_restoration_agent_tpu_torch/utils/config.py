"""Typed configuration tree (the port's copy of
``image_restoration_agent_tpu/utils/config.py``).

The reference scatters configuration across config.yml (LLM keys),
model_services.yaml (ports + literal curl commands), per-model BasicSR
YAMLs, EasyDict YAMLs and argparse. Here: one dataclass tree, loadable from
a single YAML file with dotted-path overrides.

``load_config("cfg.yaml", overrides=["engine.hbm_budget_gb=8"])``

``yaml`` is imported only where a file or an override is read: the card's
machine has no PyYAML, and a default ``Config()`` needs none.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional


@dataclass
class LLMConfig:
    provider: str = "mock"            # mock | gpt4 | llama
    api_key: str = ""
    model: str = "gpt-4o"
    base_url: str = "https://api.openai.com/v1"


@dataclass
class EvaluatorConfig:
    backend: str = "local"            # local | depictqa | gpt4v
    eval_url: str = "http://127.0.0.1:6006"
    comp_url: str = "http://127.0.0.1:5002"
    classifier_ckpt: Optional[str] = None


@dataclass
class RetrievalConfig:
    enabled: bool = True
    backend: str = "numpy"            # numpy | pgvector
    store_path: str = "retrieval_store.npz"
    dbname: str = "agenticir_rag"
    similarity_threshold: float = 0.9


@dataclass
class EngineConfig:
    weight_dir: Optional[str] = None
    hbm_budget_gb: float = 12.0
    shape_bucket: int = 128
    default_batch: int = 4
    param_dtype: str = "float32"      # float32 | bfloat16


@dataclass
class AgentConfig:
    with_retrieval: bool = True
    with_reflection: bool = True
    with_rollback: bool = True
    fast_models: bool = False
    schedule_experience_path: Optional[str] = None


@dataclass
class APIConfig:
    host: str = "0.0.0.0"
    port: int = 1146
    work_root: str = "api_work"


@dataclass
class Config:
    llm: LLMConfig = field(default_factory=LLMConfig)
    evaluator: EvaluatorConfig = field(default_factory=EvaluatorConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    agent: AgentConfig = field(default_factory=AgentConfig)
    api: APIConfig = field(default_factory=APIConfig)


def _merge(dc, data: dict):
    for f in dataclasses.fields(dc):
        if f.name not in data:
            continue
        value = data[f.name]
        cur = getattr(dc, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(value, dict):
            _merge(cur, value)
        else:
            setattr(dc, f.name, value)
    extra = set(data) - {f.name for f in dataclasses.fields(dc)}
    if extra:
        raise KeyError(f"unknown config keys: {sorted(extra)}")
    return dc


def _apply_override(cfg: Config, dotted: str) -> None:
    import yaml

    path, _, raw = dotted.partition("=")
    value: Any = yaml.safe_load(raw)
    node = cfg
    parts = path.strip().split(".")
    for p in parts[:-1]:
        node = getattr(node, p)
    if not hasattr(node, parts[-1]):
        raise KeyError(f"unknown config path: {path}")
    setattr(node, parts[-1], value)


def load_config(path: Optional[str | Path] = None,
                overrides: Optional[list[str]] = None) -> Config:
    cfg = Config()
    if path is not None and Path(path).exists():
        import yaml

        data = yaml.safe_load(Path(path).read_text()) or {}
        _merge(cfg, data)
    for ov in overrides or []:
        _apply_override(cfg, ov)
    return cfg
