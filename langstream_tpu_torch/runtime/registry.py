"""Agent code registry: agent-type → factory.

The port's own copy of ``langstream_tpu/runtime/registry.py`` (the
reference's ``AgentCodeRegistry.java:32``): the runner resolves the
implementation of each execution-plan node by its ``agentType``. The
port's built-in agents register lazily here (the JAX package keeps the
table in ``agents/__init__.py``); applications may register custom
agents with :func:`register_agent`.

The port carries the agents of the completions and RAG pipelines:
``identity``, ``composite-agent``, the GenAI toolkit (``ai-tools``, every
declarative step type, ``compute-ai-embeddings`` and ``query`` among
them), the text agents (``text-splitter``, ``document-to-json``,
``text-normaliser``, ``language-detector``, ``text-extractor``), the
vector agents (``vector-db-sink``, ``query-vector-db``), ``re-rank`` and
``flare-controller``. Every other built-in type of the JAX package (the
flow agents, python agents, sources and connectors, ``http-request``,
``langserve-invoke``, ...) plans (``compiler/planner.py``) but is refused
here, by name, when the runner builds it.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

from langstream_tpu_torch.api.agent import Agent

AgentFactory = Callable[[], Agent]

_AGENTS: Dict[str, AgentFactory] = {}


def register_agent(agent_type: str, factory: AgentFactory) -> None:
    _AGENTS[agent_type] = factory


def agent_types() -> list:
    return sorted(_AGENTS)


def _lazy(module_name: str, class_name: str) -> AgentFactory:
    def factory() -> Agent:
        return getattr(importlib.import_module(module_name), class_name)()

    return factory


_BUILTIN = {
    "identity": ("langstream_tpu_torch.runtime.runner", "IdentityProcessor"),
    "composite-agent": ("langstream_tpu_torch.runtime.composite", "CompositeAgentProcessor"),
    "ai-tools": ("langstream_tpu_torch.agents.genai", "GenAIToolKitAgent"),
    "text-splitter": ("langstream_tpu_torch.agents.text", "TextSplitterAgent"),
    "document-to-json": ("langstream_tpu_torch.agents.text", "DocumentToJsonAgent"),
    "text-normaliser": ("langstream_tpu_torch.agents.text", "TextNormaliserAgent"),
    "language-detector": ("langstream_tpu_torch.agents.text", "LanguageDetectorAgent"),
    "text-extractor": ("langstream_tpu_torch.agents.text", "TextExtractorAgent"),
    "vector-db-sink": ("langstream_tpu_torch.agents.vector", "VectorDBSinkAgent"),
    "query-vector-db": ("langstream_tpu_torch.agents.vector", "QueryVectorDBAgent"),
    "re-rank": ("langstream_tpu_torch.agents.rerank", "ReRankAgent"),
    "flare-controller": ("langstream_tpu_torch.agents.flare", "FlareControllerAgent"),
}
for _type, (_module, _cls) in _BUILTIN.items():
    register_agent(_type, _lazy(_module, _cls))


def create_agent(agent_type: str) -> Agent:
    """Instantiate the agent for ``agent_type``; a type of the JAX
    package that the port lacks is refused by name."""
    from langstream_tpu_torch.compiler.planner import _KIND

    factory = _AGENTS.get(agent_type)
    if factory is None:
        if agent_type in _KIND:
            raise ValueError(
                f"agent type {agent_type!r} is not yet ported to langstream_tpu_torch; "
                f"ported: {agent_types()}"
            )
        raise ValueError(f"unknown agent type {agent_type!r}; known: {agent_types()}")
    agent = factory()
    agent.agent_type = agent_type
    return agent
