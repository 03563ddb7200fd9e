"""In-memory model of a parsed application.

The port's own copy of ``langstream_tpu/model/application.py`` (the port imports nothing
of the JAX package).

Equivalent of the reference's model classes
(``langstream-api/src/main/java/ai/langstream/api/model/Application.java:26``,
``Module.java:13-21``, ``Pipeline.java:22``, ``AgentConfiguration.java:8-18``,
``TopicDefinition.java:30``, ``Gateway.java:31``, ``ResourcesSpec.java:22``):
an application is resources + modules (each with pipelines and topics) +
gateways + secrets + the instance (clusters and globals).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.api.errors import ErrorsSpec

DEFAULT_MODULE = "default"


@dataclasses.dataclass
class ResourcesSpec:
    """Replica count + per-replica compute units + disk
    (``ResourcesSpec.java:22``, ``DiskSpec.java``).

    In the TPU build ``parallelism`` remains "data parallelism by
    replication" (consumer-group sharding), while ``size`` maps to TPU
    topology requests (e.g. chips per replica) instead of cpu/mem units.
    """

    parallelism: int = 1
    size: int = 1
    disk: Optional[Dict[str, Any]] = None

    @classmethod
    def from_config(cls, config: Optional[Dict[str, Any]]) -> "ResourcesSpec":
        if not config:
            return cls()
        return cls(
            parallelism=int(config.get("parallelism", 1)),
            size=int(config.get("size", 1)),
            disk=config.get("disk"),
        )


@dataclasses.dataclass
class TopicDefinition:
    name: str
    creation_mode: str = "none"  # "create-if-not-exists" | "none"
    deletion_mode: str = "none"
    partitions: int = 1
    keep_alive: bool = False
    schema: Optional[Dict[str, Any]] = None
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    implicit: bool = False

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "TopicDefinition":
        return cls(
            name=config["name"],
            creation_mode=config.get("creation-mode", "none"),
            deletion_mode=config.get("deletion-mode", "none"),
            partitions=int(config.get("partitions", 1)),
            schema=config.get("schema"),
            options=config.get("options", {}) or {},
            config=config.get("config", {}) or {},
        )


@dataclasses.dataclass
class AgentConfiguration:
    """One step of a pipeline (``AgentConfiguration.java:8-18``)."""

    type: str
    id: Optional[str] = None
    name: Optional[str] = None
    input: Optional[str] = None
    output: Optional[str] = None
    configuration: Dict[str, Any] = dataclasses.field(default_factory=dict)
    resources: ResourcesSpec = dataclasses.field(default_factory=ResourcesSpec)
    errors: ErrorsSpec = dataclasses.field(default_factory=ErrorsSpec)

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "AgentConfiguration":
        if "type" not in config:
            raise ValueError(f"pipeline agent missing 'type': {config}")
        return cls(
            type=config["type"],
            id=config.get("id"),
            name=config.get("name"),
            input=config.get("input"),
            output=config.get("output"),
            configuration=config.get("configuration", {}) or {},
            resources=ResourcesSpec.from_config(config.get("resources")),
            errors=ErrorsSpec.from_config(config.get("errors")),
        )


@dataclasses.dataclass
class Pipeline:
    id: str
    module: str = DEFAULT_MODULE
    name: Optional[str] = None
    agents: List[AgentConfiguration] = dataclasses.field(default_factory=list)
    errors: ErrorsSpec = dataclasses.field(default_factory=ErrorsSpec)


@dataclasses.dataclass
class AssetDefinition:
    """Infrastructure an app needs provisioned before it runs — tables,
    collections, indexes (``langstream-api/.../model/AssetDefinition``;
    managers under ``langstream-core/.../impl/assets/``)."""

    id: str
    name: str
    asset_type: str
    creation_mode: str = "none"        # none | create-if-not-exists
    deletion_mode: str = "none"        # none | delete
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "AssetDefinition":
        return cls(
            id=config.get("id") or config.get("name"),
            name=config.get("name") or config.get("id"),
            asset_type=config.get("asset-type") or config.get("type"),
            creation_mode=config.get("creation-mode", "none"),
            deletion_mode=config.get("deletion-mode", "none"),
            config=config.get("config", {}) or {},
        )


@dataclasses.dataclass
class Module:
    id: str = DEFAULT_MODULE
    pipelines: Dict[str, Pipeline] = dataclasses.field(default_factory=dict)
    topics: Dict[str, TopicDefinition] = dataclasses.field(default_factory=dict)
    assets: Dict[str, AssetDefinition] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Gateway:
    """Gateway endpoint (``Gateway.java:31``; types produce / consume /
    chat / service, lines 39-44)."""

    id: str
    type: str
    topic: Optional[str] = None
    parameters: List[str] = dataclasses.field(default_factory=list)
    authentication: Optional[Dict[str, Any]] = None
    produce_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    consume_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    chat_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    service_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    events_topic: Optional[str] = None

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "Gateway":
        return cls(
            id=config["id"],
            type=config["type"],
            topic=config.get("topic"),
            parameters=config.get("parameters", []) or [],
            authentication=config.get("authentication"),
            produce_options=config.get("produce-options", {}) or {},
            consume_options=config.get("consume-options", {}) or {},
            chat_options=config.get("chat-options", {}) or {},
            service_options=config.get("service-options", {}) or {},
            events_topic=config.get("events-topic"),
        )


@dataclasses.dataclass
class Instance:
    """``instance.yaml``: clusters + globals
    (``examples/instances/kafka-kubernetes.yaml:18-23``)."""

    streaming_cluster: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"type": "memory"}
    )
    compute_cluster: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"type": "local"}
    )
    globals_: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "Instance":
        return cls(
            streaming_cluster=config.get("streamingCluster", {"type": "memory"}),
            compute_cluster=config.get("computeCluster", {"type": "local"}),
            globals_=config.get("globals", {}) or {},
        )


@dataclasses.dataclass
class Secrets:
    secrets: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Application:
    application_id: str = "app"
    tenant: str = "default"
    resources: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    modules: Dict[str, Module] = dataclasses.field(default_factory=dict)
    gateways: List[Gateway] = dataclasses.field(default_factory=list)
    instance: Instance = dataclasses.field(default_factory=Instance)
    secrets: Secrets = dataclasses.field(default_factory=Secrets)
    dependencies: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # path of the app's `python/` dir with user agent code (put on sys.path
    # at run; the reference mounts it into the gRPC runtime's PYTHONPATH)
    python_path: Optional[str] = None

    def module(self, module_id: str = DEFAULT_MODULE) -> Module:
        module = self.modules.get(module_id)
        if module is None:
            module = Module(id=module_id)
            self.modules[module_id] = module
        return module

    def all_topics(self) -> Dict[str, TopicDefinition]:
        out: Dict[str, TopicDefinition] = {}
        for module in self.modules.values():
            out.update(module.topics)
        return out

    @classmethod
    def from_document(
        cls,
        definition: Dict[str, Any],
        instance: Optional[Dict[str, Any]] = None,
        secrets: Optional[Dict[str, Any]] = None,
    ) -> "Application":
        """Rebuild an Application from its ``dataclasses.asdict`` document
        (the form the control plane stores and ships in CRs). Inverse of
        ``asdict`` for the snake_case field names used there."""
        app = cls(
            application_id=definition.get("application_id", "app"),
            tenant=definition.get("tenant", "default"),
            resources=definition.get("resources", {}) or {},
            dependencies=definition.get("dependencies", []) or [],
            python_path=definition.get("python_path"),
        )
        for module_id, module_doc in (definition.get("modules") or {}).items():
            module = Module(id=module_id)
            for name, topic_doc in (module_doc.get("topics") or {}).items():
                module.topics[name] = TopicDefinition(
                    name=topic_doc.get("name", name),
                    creation_mode=topic_doc.get("creation_mode", "none"),
                    deletion_mode=topic_doc.get("deletion_mode", "none"),
                    partitions=topic_doc.get("partitions", 1),
                    keep_alive=topic_doc.get("keep_alive", False),
                    schema=topic_doc.get("schema"),
                    options=topic_doc.get("options", {}) or {},
                    config=topic_doc.get("config", {}) or {},
                    implicit=topic_doc.get("implicit", False),
                )
            for pipeline_id, pipe_doc in (module_doc.get("pipelines") or {}).items():
                pipeline = Pipeline(
                    id=pipeline_id,
                    module=pipe_doc.get("module", module_id),
                    name=pipe_doc.get("name"),
                    errors=ErrorsSpec.from_config(pipe_doc.get("errors")),
                )
                for agent_doc in pipe_doc.get("agents", []) or []:
                    pipeline.agents.append(AgentConfiguration(
                        type=agent_doc["type"],
                        id=agent_doc.get("id"),
                        name=agent_doc.get("name"),
                        input=agent_doc.get("input"),
                        output=agent_doc.get("output"),
                        configuration=agent_doc.get("configuration", {}) or {},
                        resources=ResourcesSpec.from_config(
                            agent_doc.get("resources")
                        ),
                        errors=ErrorsSpec.from_config(agent_doc.get("errors")),
                    ))
                module.pipelines[pipeline_id] = pipeline
            app.modules[module_id] = module
        for gw_doc in definition.get("gateways", []) or []:
            app.gateways.append(Gateway(
                id=gw_doc["id"],
                type=gw_doc["type"],
                topic=gw_doc.get("topic"),
                parameters=gw_doc.get("parameters", []) or [],
                authentication=gw_doc.get("authentication"),
                produce_options=gw_doc.get("produce_options", {}) or {},
                consume_options=gw_doc.get("consume_options", {}) or {},
                chat_options=gw_doc.get("chat_options", {}) or {},
                service_options=gw_doc.get("service_options", {}) or {},
                events_topic=gw_doc.get("events_topic"),
            ))
        if instance is not None:
            app.instance = Instance(
                streaming_cluster=instance.get("streaming_cluster")
                or instance.get("streamingCluster") or {"type": "memory"},
                compute_cluster=instance.get("compute_cluster")
                or instance.get("computeCluster") or {"type": "local"},
                globals_=instance.get("globals_")
                or instance.get("globals") or {},
            )
        if secrets is not None:
            # only the wrapped asdict(Secrets) form — {"secrets": {...}};
            # guessing at unwrapped mappings could silently drop entries
            app.secrets = Secrets(secrets=secrets.get("secrets") or {})
        return app
