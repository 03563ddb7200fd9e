"""Agent code registry: agent-type → factory.

The port's own copy of ``langstream_tpu/runtime/registry.py`` (the
reference's ``AgentCodeRegistry.java:32``): the runner resolves the
implementation of each execution-plan node by its ``agentType``. The
port's built-in agents register lazily here (the JAX package keeps the
table in ``agents/__init__.py``); applications may register custom
agents with :func:`register_agent`.

The port carries every built-in type of the JAX package's table
(``langstream_tpu/agents/__init__.py``): ``identity``,
``composite-agent``, the GenAI toolkit (``ai-tools``, every declarative
step type), the text agents, the vector agents, ``re-rank``,
``flare-controller``, the flow agents (``dispatch``, ``timer-source``,
``trigger-event``, ``log-event``), the python agents (in-process or
``isolation: process``), ``webcrawler-source``, ``s3-source``,
``file-source``, ``azure-blob-storage-source``, ``http-request``,
``langserve-invoke``, ``exec-source``, ``exec-sink``, ``camel-source``
(its ``pulsar:`` scheme refused by name when the agent starts, ROADMAP
A7.4), ``kafka-connect-source`` and ``kafka-connect-sink``; plugin
packages add theirs (``runtime/plugins.py``).
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
    "python-processor": ("langstream_tpu_torch.agents.python_agents", "PythonProcessorAgent"),
    "python-source": ("langstream_tpu_torch.agents.python_agents", "PythonSourceAgent"),
    "python-sink": ("langstream_tpu_torch.agents.python_agents", "PythonSinkAgent"),
    "python-service": ("langstream_tpu_torch.agents.python_agents", "PythonServiceAgent"),
    "dispatch": ("langstream_tpu_torch.agents.flow", "DispatchAgent"),
    "timer-source": ("langstream_tpu_torch.agents.flow", "TimerSourceAgent"),
    "trigger-event": ("langstream_tpu_torch.agents.flow", "TriggerEventAgent"),
    "log-event": ("langstream_tpu_torch.agents.flow", "LogEventAgent"),
    "webcrawler-source": ("langstream_tpu_torch.agents.webcrawler", "WebCrawlerSource"),
    "s3-source": ("langstream_tpu_torch.agents.storage", "S3Source"),
    "file-source": ("langstream_tpu_torch.agents.storage", "FileSource"),
    "azure-blob-storage-source": ("langstream_tpu_torch.agents.storage", "AzureBlobStorageSource"),
    "http-request": ("langstream_tpu_torch.agents.http_request", "HttpRequestAgent"),
    "langserve-invoke": ("langstream_tpu_torch.agents.http_request", "LangServeInvokeAgent"),
    "exec-source": ("langstream_tpu_torch.agents.connector", "ExecSource"),
    "exec-sink": ("langstream_tpu_torch.agents.connector", "ExecSink"),
    "camel-source": ("langstream_tpu_torch.agents.camel", "CamelSourceAgent"),
    "kafka-connect-source": ("langstream_tpu_torch.agents.kafka_connect", "KafkaConnectSourceAgent"),
    "kafka-connect-sink": ("langstream_tpu_torch.agents.kafka_connect", "KafkaConnectSinkAgent"),
}
for _type, (_module, _cls) in _BUILTIN.items():
    register_agent(_type, _lazy(_module, _cls))


def create_agent(agent_type: str) -> Agent:
    """Instantiate the agent for ``agent_type``."""
    factory = _AGENTS.get(agent_type)
    if factory is None:
        raise ValueError(f"unknown agent type {agent_type!r}; known: {agent_types()}")
    try:
        agent = factory()
    except (ImportError, AttributeError) as error:
        raise ValueError(
            f"agent type {agent_type!r} is registered but its implementation "
            f"failed to load: {error}"
        ) from error
    agent.agent_type = agent_type
    return agent


def load_class(class_name: str) -> type:
    """Load ``module.path.ClassName`` (used by custom python agents)."""
    module_name, _, cls_name = class_name.rpartition(".")
    if not module_name:
        raise ValueError(f"className must be 'module.Class', got {class_name!r}")
    module = importlib.import_module(module_name)
    return getattr(module, cls_name)
