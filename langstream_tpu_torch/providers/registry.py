"""Provider registry: resource config → completions and embeddings services.

The port's own copy of ``langstream_tpu/providers/registry.py`` (the
reference's ``ServiceProviderRegistry.java:58``): given the app's
``resources:`` entries, find the provider that owns each and build
(cached) completions services. The port has one provider, ``torch-local``
(``providers/torch_local/provider.py``); the registry hands it the
``device`` the app runs on, the card unless the caller asks for the CPU.
Completions services are cached per resource, embeddings services per
resource and model (the ``compute-ai-embeddings`` step's ``model``). A
resource no provider owns (``jax-local``, ``open-ai-configuration``,
...) is refused with its name.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional, Tuple

from langstream_tpu_torch.api.service import CompletionsService, EmbeddingsService, ServiceProvider


class ServiceProviderRegistry:
    """Resolves and caches services per resource entry, on ``device``."""

    def __init__(self, resources: Optional[Dict[str, Dict[str, Any]]] = None,
                 device: Any = "cuda") -> None:
        self.resources = resources or {}
        self.device = device
        self._providers: Optional[List[ServiceProvider]] = None
        self._completions: Dict[str, CompletionsService] = {}
        self._embeddings: Dict[Tuple[str, Optional[str]], EmbeddingsService] = {}

    def _provider_instances(self) -> List[ServiceProvider]:
        if self._providers is None:
            from langstream_tpu_torch.providers.torch_local.provider import TorchLocalServiceProvider

            self._providers = [TorchLocalServiceProvider(device=self.device)]
        return self._providers

    def _find(self, resource_name: Optional[str]) -> Tuple[str, Dict[str, Any], ServiceProvider]:
        if resource_name:
            if resource_name not in self.resources:
                raise ValueError(
                    f"unknown resource {resource_name!r}; declared: {sorted(self.resources)}"
                )
            candidates = [(resource_name, self.resources[resource_name])]
        else:
            candidates = list(self.resources.items())
        for name, resource in candidates:
            for provider in self._provider_instances():
                if provider.supports(resource):
                    return name, resource, provider
        declared = {name: resource.get("type") for name, resource in candidates}
        raise ValueError(
            f"no AI service provider of langstream_tpu_torch owns the resources {declared}; "
            "the port's provider takes `type: torch-local`"
        )

    def completions(self, resource_name: Optional[str] = None) -> CompletionsService:
        name, resource, provider = self._find(resource_name)
        if name not in self._completions:
            self._completions[name] = provider.get_completions_service(
                resource.get("configuration", resource)
            )
        return self._completions[name]

    def embeddings(self, resource_name: Optional[str] = None,
                   model: Optional[str] = None) -> EmbeddingsService:
        name, resource, provider = self._find(resource_name)
        key = (name, model)
        if key not in self._embeddings:
            self._embeddings[key] = provider.get_embeddings_service(
                resource.get("configuration", resource), model=model
            )
        return self._embeddings[key]

    async def close(self) -> None:
        """Close every service; the port's ``close`` is a plain method
        that joins the engine thread, so it runs off the event loop."""
        services = [*self._completions.values(), *self._embeddings.values()]
        self._completions.clear()
        self._embeddings.clear()
        loop = asyncio.get_running_loop()
        for service in services:
            await loop.run_in_executor(None, service.close)
