"""The planner: Application → ExecutionPlan.

Equivalent of the reference's generic planner
(``langstream-core/src/main/java/ai/langstream/impl/common/BasicClusterRuntime.java:45``:
buildExecutionPlan 50-66, detectAgents 121-146, buildAgent+merge 158-254)
plus the composable-agent fusion optimiser
(``impl/agents/ComposableAgentExecutionPlanOptimiser.java:34``) and the
GenAI-toolkit step mapping
(``impl/agents/ai/GenAIToolKitFunctionAgentProvider.java:51``, STEP_TYPES
53-74, steps assembly 117-163).

Walk each pipeline in order; each agent either *fuses* with the previous one
(no explicit topic between them, same resources → one node, records passed
in memory) or is separated by a topic (explicit, or an implicit
``create-if-not-exists`` intermediate). Declarative GenAI step types
(``drop-fields``, ``compute``, ``ai-chat-completions``, ...) all compile to
one ``ai-tools`` executable whose config is a ``steps`` list; consecutive
steps merge into the same executable exactly like the reference.

The port's own copy of ``langstream_tpu/compiler/planner.py``. Planning
needs each agent's kind, not its implementation, so the kind table names
every built-in type of the JAX package and the port plans every example
app, also those whose agents it has not ported: :func:`create_agent`
refuses such a type, by name, when the runner starts. The JAX planner's
typed configuration check (``model/docs.py``) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.api.agent import ComponentType
from langstream_tpu_torch.api.errors import ErrorsSpec
from langstream_tpu_torch.api.topics import TopicSpec
from langstream_tpu_torch.model.application import (
    AgentConfiguration,
    Application,
    Pipeline,
    ResourcesSpec,
    TopicDefinition,
)

# Declarative step types that compile onto the single GenAI toolkit executor
# (GenAIToolKitFunctionAgentProvider.java:53-74).
GENAI_STEP_TYPES = {
    "drop-fields",
    "merge-key-value",
    "unwrap-key-value",
    "cast",
    "flatten",
    "drop",
    "compute",
    "compute-ai-embeddings",
    "query",
    "ai-chat-completions",
    "ai-text-completions",
}

# Planner-side kind table for every built-in type, so planning does not
# need to instantiate agents (the reference declares kinds in per-agent
# planning providers under langstream-k8s-runtime/.../agents/).
_KIND: Dict[str, ComponentType] = {
    "identity": ComponentType.PROCESSOR,
    "composite-agent": ComponentType.PROCESSOR,
    "ai-tools": ComponentType.PROCESSOR,
    "python-processor": ComponentType.PROCESSOR,
    "text-splitter": ComponentType.PROCESSOR,
    "document-to-json": ComponentType.PROCESSOR,
    "text-normaliser": ComponentType.PROCESSOR,
    "language-detector": ComponentType.PROCESSOR,
    "text-extractor": ComponentType.PROCESSOR,
    "dispatch": ComponentType.PROCESSOR,
    "trigger-event": ComponentType.PROCESSOR,
    "log-event": ComponentType.PROCESSOR,
    "http-request": ComponentType.PROCESSOR,
    "query-vector-db": ComponentType.PROCESSOR,
    "re-rank": ComponentType.PROCESSOR,
    "flare-controller": ComponentType.PROCESSOR,
    "langserve-invoke": ComponentType.PROCESSOR,
    "camel-source": ComponentType.SOURCE,
    "python-source": ComponentType.SOURCE,
    "timer-source": ComponentType.SOURCE,
    "webcrawler-source": ComponentType.SOURCE,
    "s3-source": ComponentType.SOURCE,
    "file-source": ComponentType.SOURCE,
    "azure-blob-storage-source": ComponentType.SOURCE,
    "exec-source": ComponentType.SOURCE,
    "kafka-connect-source": ComponentType.SOURCE,
    "python-sink": ComponentType.SINK,
    "vector-db-sink": ComponentType.SINK,
    "exec-sink": ComponentType.SINK,
    "kafka-connect-sink": ComponentType.SINK,
    "python-service": ComponentType.SERVICE,
}


def agent_kind(agent_type: str) -> ComponentType:
    if agent_type in GENAI_STEP_TYPES:
        return ComponentType.PROCESSOR
    kind = _KIND.get(agent_type)
    if kind is not None:
        return kind
    # custom types registered with the runtime registry
    from langstream_tpu_torch.runtime.registry import create_agent

    return create_agent(agent_type).component_type()


@dataclasses.dataclass
class AgentSpec:
    """Executable description of one (sub-)agent inside a node."""

    agent_id: str
    agent_type: str
    configuration: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_config(self) -> Dict[str, Any]:
        return {
            "agentId": self.agent_id,
            "agentType": self.agent_type,
            "configuration": self.configuration,
        }


@dataclasses.dataclass
class AgentNode:
    """One execution-plan node = one runner (pod) holding a fused
    source? + processors + sink? chain
    (reference: ``runtime/AgentNode.java:22`` + composite merge)."""

    id: str
    pipeline: str
    module: str
    source: Optional[AgentSpec] = None
    processors: List[AgentSpec] = dataclasses.field(default_factory=list)
    sink: Optional[AgentSpec] = None
    service: Optional[AgentSpec] = None
    input_topic: Optional[str] = None
    output_topic: Optional[str] = None
    errors: ErrorsSpec = dataclasses.field(default_factory=ErrorsSpec)
    resources: ResourcesSpec = dataclasses.field(default_factory=ResourcesSpec)

    def all_agent_ids(self) -> List[str]:
        out = []
        for spec in [self.source, *self.processors, self.sink, self.service]:
            if spec is not None:
                out.append(spec.agent_id)
        return out


@dataclasses.dataclass
class ExecutionPlan:
    """Topics + assets + agent nodes
    (``langstream-api/.../runtime/ExecutionPlan.java:32``, maps 18-20)."""

    application: Application
    topics: Dict[str, TopicSpec] = dataclasses.field(default_factory=dict)
    agents: List[AgentNode] = dataclasses.field(default_factory=list)
    assets: List[Any] = dataclasses.field(default_factory=list)

    def agent(self, node_id: str) -> AgentNode:
        for node in self.agents:
            if node.id == node_id:
                return node
        raise KeyError(node_id)


def _topic_spec(topic: TopicDefinition) -> TopicSpec:
    return TopicSpec(
        name=topic.name,
        partitions=topic.partitions,
        creation_mode=topic.creation_mode,
        deletion_mode=topic.deletion_mode,
        options=topic.options,
        config=topic.config,
        implicit=topic.implicit,
        schema=topic.schema,
    )


def _to_executable(agent: AgentConfiguration) -> AgentSpec:
    """Map a declared agent type to its executable spec; GenAI step types
    compile to the ``ai-tools`` executor with a one-step ``steps`` list."""
    if agent.type in GENAI_STEP_TYPES:
        step = {"type": agent.type, **agent.configuration}
        return AgentSpec(
            agent_id=agent.id or agent.type,
            agent_type="ai-tools",
            configuration={"steps": [step]},
        )
    return AgentSpec(
        agent_id=agent.id or agent.type,
        agent_type=agent.type,
        configuration=dict(agent.configuration),
    )


def _can_fuse(
    previous: AgentConfiguration, current: AgentConfiguration
) -> bool:
    """Fusion rule (``ComposableAgentExecutionPlanOptimiser.canMerge``,
    line 42): no explicit topic between them, identical resources, and
    identical error policy (a fused node has one policy; differing specs
    must keep their own node so each agent's ``errors:`` is honored)."""
    if previous.output is not None or current.input is not None:
        return False
    if previous.resources != current.resources:
        return False
    if previous.errors != current.errors:
        return False
    if agent_kind(current.type) not in (ComponentType.PROCESSOR, ComponentType.SINK):
        return False
    return True


def _build_pipeline_nodes(
    plan: ExecutionPlan, pipeline: Pipeline, application: Application
) -> None:
    module = application.modules[pipeline.module]
    nodes: List[AgentNode] = []
    # open_node: node still accepting fusion; prev_agent: its last agent
    open_node: Optional[AgentNode] = None
    prev_agent: Optional[AgentConfiguration] = None
    # topic the next agent consumes when it declares no input (set when a
    # node was sealed by an explicit `output:`)
    pending_input: Optional[str] = None

    def ensure_topic(name: str, implicit: bool = False) -> None:
        if name in plan.topics:
            return
        definition = module.topics.get(name)
        if definition is None:
            if not implicit:
                raise ValueError(
                    f"pipeline {pipeline.id!r} references undeclared topic {name!r}"
                )
            definition = TopicDefinition(
                name=name, creation_mode="create-if-not-exists", implicit=True
            )
            module.topics[name] = definition
        plan.topics[name] = _topic_spec(definition)

    def new_node(agent: AgentConfiguration, **fields) -> AgentNode:
        node = AgentNode(
            id=agent.id or agent.type,
            pipeline=pipeline.id,
            module=pipeline.module,
            errors=agent.errors,
            resources=agent.resources,
            **fields,
        )
        nodes.append(node)
        return node

    for agent in pipeline.agents:
        kind = agent_kind(agent.type)
        executable = _to_executable(agent)

        if kind is ComponentType.SERVICE:
            new_node(agent, service=executable)
            open_node, prev_agent, pending_input = None, None, None
            continue

        if kind is ComponentType.SOURCE:
            # a source always heads a fresh node; a still-open upstream node
            # stays terminal (no output topic)
            open_node = new_node(agent, source=executable)
            prev_agent = agent
        elif (
            open_node is not None
            and prev_agent is not None
            and _can_fuse(prev_agent, agent)
        ):
            _attach_fused(open_node, kind, executable)
            prev_agent = agent
        else:
            input_topic = agent.input
            if open_node is not None and prev_agent is not None:
                # seal the open node with a boundary topic the new node reads
                boundary = input_topic or f"{pipeline.id}-{agent.id}-input"
                ensure_topic(boundary, implicit=input_topic is None)
                open_node.output_topic = boundary
                input_topic = boundary
            elif input_topic is None:
                input_topic = pending_input
            if input_topic is None:
                raise ValueError(
                    f"agent {agent.id!r} in pipeline {pipeline.id!r} has no "
                    "input topic and no upstream agent"
                )
            ensure_topic(input_topic)
            open_node = new_node(agent, input_topic=input_topic)
            _attach(open_node, kind, executable)
            prev_agent = agent

        pending_input = None
        if agent.output is not None:
            ensure_topic(agent.output)
            open_node.output_topic = agent.output
            pending_input = agent.output
            open_node, prev_agent = None, None
        elif kind is ComponentType.SINK:
            # a custom sink terminates its node
            open_node, prev_agent = None, None

    plan.agents.extend(nodes)


def _attach(node: AgentNode, kind: ComponentType, spec: AgentSpec) -> None:
    if kind is ComponentType.PROCESSOR:
        node.processors.append(spec)
    elif kind is ComponentType.SINK:
        node.sink = spec
    elif kind is ComponentType.SOURCE:
        node.source = spec


def _attach_fused(node: AgentNode, kind: ComponentType, spec: AgentSpec) -> None:
    """Merge into an open node; consecutive ``ai-tools`` merge their step
    lists into one executor (GenAIToolKitFunctionAgentProvider steps
    assembly, 117-163)."""
    if (
        kind is ComponentType.PROCESSOR
        and spec.agent_type == "ai-tools"
        and node.processors
        and node.processors[-1].agent_type == "ai-tools"
    ):
        node.processors[-1].configuration["steps"].extend(
            spec.configuration["steps"]
        )
        return
    _attach(node, kind, spec)


def build_execution_plan(application: Application) -> ExecutionPlan:
    """``ComputeClusterRuntime.buildExecutionPlan`` equivalent
    (``langstream-api/.../runtime/ComputeClusterRuntime.java:32``)."""
    plan = ExecutionPlan(application=application)
    # declared topics first (even if no agent references them: gateways may)
    for module in application.modules.values():
        for topic in module.topics.values():
            plan.topics.setdefault(topic.name, _topic_spec(topic))
        plan.assets.extend(module.assets.values())
        for pipeline in module.pipelines.values():
            _build_pipeline_nodes(plan, pipeline, application)
    _validate(plan)
    return plan


def _validate(plan: ExecutionPlan) -> None:
    seen = set()
    for node in plan.agents:
        if node.id in seen:
            raise ValueError(f"duplicate agent node id {node.id!r}")
        seen.add(node.id)
        if node.service is None and node.source is None and node.input_topic is None:
            raise ValueError(
                f"agent node {node.id!r} has neither an input topic nor a source"
            )
    for gateway in plan.application.gateways:
        for topic_name in _gateway_topics(gateway):
            if topic_name and topic_name not in plan.topics:
                raise ValueError(
                    f"gateway {gateway.id!r} references unknown topic {topic_name!r}"
                )


def _gateway_topics(gateway) -> List[Optional[str]]:
    return [
        gateway.topic,
        gateway.chat_options.get("questions-topic"),
        gateway.chat_options.get("answers-topic"),
    ]
