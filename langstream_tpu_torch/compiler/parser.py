"""Application directory parser.

Equivalent of the reference's ``ModelBuilder``
(``langstream-core/src/main/java/ai/langstream/impl/parser/ModelBuilder.java:74``;
file dispatch at 410-465, pipelines 659, secrets 812, instance 837): an
application is a directory of YAML files —

- ``configuration.yaml``   — ``configuration.resources`` + ``dependencies``
- ``gateways.yaml``        — gateway endpoint list
- ``instance.yaml``        — clusters + globals (may live outside the dir)
- ``secrets.yaml``         — secret id → data map (env-expanded)
- every other ``*.yaml``   — a pipeline file: ``topics:`` + ``pipeline:``
  (+ optional ``errors:`` defaults, ``module:``, ``name:``, ``id:``)
- ``python/``              — user agent code, put on ``sys.path`` at run
  (the reference mounts it into the gRPC runtime's PYTHONPATH,
  ``PythonGrpcServer.java:54-91``)

The port's own copy of ``langstream_tpu/compiler/parser.py``: the files
are read by the port's own YAML reader (``compiler/yaml_reader.py``),
which returns what ``yaml.safe_load`` returns for them, so the port
needs no PyYAML.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from langstream_tpu_torch.api.errors import ErrorsSpec
from langstream_tpu_torch.model.application import (
    DEFAULT_MODULE,
    AgentConfiguration,
    Application,
    AssetDefinition,
    Gateway,
    Instance,
    Pipeline,
    Secrets,
    TopicDefinition,
)
from langstream_tpu_torch.compiler import yaml_reader
from langstream_tpu_torch.compiler.placeholders import (
    build_context,
    resolve_env,
    resolve_value,
)

_SPECIAL_FILES = {"configuration", "gateways", "instance", "secrets"}


def _load_yaml(path: str) -> Any:
    return yaml_reader.load_file(path)


def parse_pipeline_file(
    application: Application, file_name: str, content: Dict[str, Any]
) -> None:
    """One pipeline file → topics + a Pipeline in its module
    (``ModelBuilder.parsePipelineFile``, line 659)."""
    if content is None:
        return
    module_id = content.get("module", DEFAULT_MODULE)
    module = application.module(module_id)
    pipeline_id = content.get("id") or os.path.splitext(os.path.basename(file_name))[0]
    pipeline = Pipeline(
        id=pipeline_id,
        module=module_id,
        name=content.get("name"),
        errors=ErrorsSpec.from_config(content.get("errors")),
    )
    for topic_config in content.get("topics", []) or []:
        topic = TopicDefinition.from_config(topic_config)
        module.topics[topic.name] = topic
    for asset_config in content.get("assets", []) or []:
        asset = AssetDefinition.from_config(asset_config)
        module.assets[asset.id] = asset
    used_ids = set()
    for index, agent_config in enumerate(content.get("pipeline", []) or []):
        agent = AgentConfiguration.from_config(agent_config)
        if agent.id is None:
            # deterministic auto-id, mirroring the reference's generated ids
            base = (agent.name or agent.type).lower().replace(" ", "-")
            agent.id = base if base not in used_ids else f"{base}-{index}"
        used_ids.add(agent.id)
        agent.errors = agent.errors.with_defaults_from(pipeline.errors)
        pipeline.agents.append(agent)
    module.pipelines[pipeline.id] = pipeline


def parse_configuration_file(application: Application, content: Dict[str, Any]) -> None:
    configuration = (content or {}).get("configuration", {}) or {}
    for resource in configuration.get("resources", []) or []:
        name = resource.get("id") or resource.get("name") or resource.get("type")
        application.resources[name] = resource
    application.dependencies = configuration.get("dependencies", []) or []


def parse_gateways_file(application: Application, content: Dict[str, Any]) -> None:
    for gateway_config in (content or {}).get("gateways", []) or []:
        application.gateways.append(Gateway.from_config(gateway_config))


def parse_secrets(content: Dict[str, Any]) -> Secrets:
    """``secrets.yaml`` (``ModelBuilder.parseSecrets``, line 812); values are
    env-expanded (``${VAR:-default}``)."""
    out: Dict[str, Dict[str, Any]] = {}
    for secret in (content or {}).get("secrets", []) or []:
        data = secret.get("data", {}) or {}
        out[secret["id"]] = {
            key: resolve_env(value) if isinstance(value, str) else value
            for key, value in data.items()
        }
    return Secrets(secrets=out)


def parse_instance(content: Dict[str, Any]) -> Instance:
    return Instance.from_config((content or {}).get("instance", {}) or {})


def parse_application_directory(
    app_dir: str,
    *,
    instance_file: Optional[str] = None,
    secrets_file: Optional[str] = None,
) -> Application:
    """Parse without placeholder resolution (see :func:`build_application`)."""
    application = Application(application_id=os.path.basename(os.path.normpath(app_dir)))
    names = sorted(os.listdir(app_dir))
    for name in names:
        path = os.path.join(app_dir, name)
        if not name.endswith((".yaml", ".yml")) or not os.path.isfile(path):
            continue
        content = _load_yaml(path)
        stem = os.path.splitext(name)[0]
        if stem == "configuration":
            parse_configuration_file(application, content)
        elif stem == "gateways":
            parse_gateways_file(application, content)
        elif stem == "instance":
            application.instance = parse_instance(content)
        elif stem == "secrets":
            application.secrets = parse_secrets(content)
        elif stem == "archetype":
            pass  # archetype manifest (metadata only, not a pipeline)
        else:
            parse_pipeline_file(application, name, content)
    if instance_file:
        application.instance = parse_instance(_load_yaml(instance_file))
    if secrets_file:
        application.secrets = parse_secrets(_load_yaml(secrets_file))
    python_dir = os.path.join(app_dir, "python")
    if os.path.isdir(python_dir):
        application.python_path = python_dir
    return application


def resolve_placeholders(application: Application) -> Application:
    """Interpolate ``${secrets.*}`` / ``${globals.*}`` / ``${cluster.*}``
    across resources, agent configurations, and gateways
    (``ApplicationPlaceholderResolver.java:45``)."""
    context = build_context(
        application.secrets.secrets,
        application.instance.globals_,
        application.instance.streaming_cluster.get("configuration", {}) or {},
    )
    application.resources = resolve_value(application.resources, context)
    for module in application.modules.values():
        for pipeline in module.pipelines.values():
            for agent in pipeline.agents:
                agent.configuration = resolve_value(agent.configuration, context)
    for gateway in application.gateways:
        gateway.authentication = resolve_value(gateway.authentication, context)
        gateway.produce_options = resolve_value(gateway.produce_options, context)
        gateway.consume_options = resolve_value(gateway.consume_options, context)
        gateway.chat_options = resolve_value(gateway.chat_options, context)
    return application


def build_application(
    app_dir: str,
    *,
    instance_file: Optional[str] = None,
    secrets_file: Optional[str] = None,
) -> Application:
    """Parse + resolve: the equivalent of
    ``ModelBuilder.buildApplicationInstance`` (``ModelBuilder.java:370``)."""
    application = parse_application_directory(
        app_dir, instance_file=instance_file, secrets_file=secrets_file
    )
    return resolve_placeholders(application)
