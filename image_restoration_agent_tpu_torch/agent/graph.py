"""Minimal state graph: in-repo replacement for LangGraph's StateGraph
(the port's copy of ``image_restoration_agent_tpu/agent/graph.py``).

The reference AgentApp builds its agent as a LangGraph graph of named nodes
with conditional edges and a self-loop (AgentApp/agentic.py:245-299). This
module provides the same execution model with zero dependencies: nodes are
``fn(state) -> state`` on a plain dict, edges are static or conditional, and
``invoke`` runs to the END sentinel.
"""

from __future__ import annotations

from typing import Callable, Optional

END = "__end__"


class CompiledGraph:
    def __init__(self, nodes, edges, cond_edges, entry):
        self._nodes = nodes
        self._edges = edges
        self._cond = cond_edges
        self._entry = entry

    def invoke(self, state: dict, max_steps: int = 1000) -> dict:
        current = self._entry
        steps = 0
        while current != END:
            if steps >= max_steps:
                raise RuntimeError(f"graph exceeded {max_steps} steps at "
                                   f"node {current!r}")
            fn = self._nodes[current]
            update = fn(state)
            if update is not None and update is not state:
                state.update(update)
            if current in self._cond:
                router, mapping = self._cond[current]
                key = router(state)
                current = mapping[key]
            elif current in self._edges:
                current = self._edges[current]
            else:
                current = END
            steps += 1
        return state


class StateGraph:
    def __init__(self, state_type=dict):
        self._nodes: dict[str, Callable] = {}
        self._edges: dict[str, str] = {}
        self._cond: dict[str, tuple[Callable, dict]] = {}
        self._entry: Optional[str] = None

    def add_node(self, name: str, fn: Callable) -> None:
        if name in self._nodes:
            raise ValueError(f"duplicate node {name!r}")
        self._nodes[name] = fn

    def add_edge(self, src: str, dst: str) -> None:
        self._edges[src] = dst

    def add_conditional_edges(self, src: str, router: Callable,
                              mapping: dict[str, str]) -> None:
        self._cond[src] = (router, mapping)

    def set_entry_point(self, name: str) -> None:
        self._entry = name

    def compile(self) -> CompiledGraph:
        if self._entry is None:
            raise ValueError("entry point not set")
        for src, dst in self._edges.items():
            if dst != END and dst not in self._nodes:
                raise ValueError(f"edge {src}->{dst}: unknown node")
        return CompiledGraph(self._nodes, self._edges, self._cond, self._entry)
