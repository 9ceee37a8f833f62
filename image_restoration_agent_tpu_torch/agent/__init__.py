from .graph import StateGraph, END
from .executor import Tool, Executor, build_default_executor
from .evaluators import LocalEvaluator
from .iragent import IRAgent
from .graph_app import create_image_analysis_graph, run_agent

__all__ = [
    "StateGraph", "END",
    "Tool", "Executor", "build_default_executor",
    "LocalEvaluator",
    "IRAgent",
    "create_image_analysis_graph", "run_agent",
]
