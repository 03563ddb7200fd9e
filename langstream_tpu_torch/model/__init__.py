"""The application model — parsed YAML, pre-planning.

Equivalent of ``langstream-api/src/main/java/ai/langstream/api/model/``;
the port's own copy of ``langstream_tpu/model/``.
"""

from langstream_tpu_torch.model.application import (
    AgentConfiguration,
    Application,
    Gateway,
    Instance,
    Module,
    Pipeline,
    ResourcesSpec,
    Secrets,
    TopicDefinition,
)

__all__ = [
    "AgentConfiguration",
    "Application",
    "Gateway",
    "Instance",
    "Module",
    "Pipeline",
    "ResourcesSpec",
    "Secrets",
    "TopicDefinition",
]
