"""Asset manager SPI: provision tables/collections/indexes at setup.

Equivalent of the reference's AssetManager SPI
(``langstream-api/src/main/java/ai/langstream/api/runner/assets/AssetManager.java``
with providers in ``langstream-core/.../impl/assets/`` — Cassandra, JDBC,
Milvus, OpenSearch, Solr) and its registry
(``AssetManagerRegistry.java``). Assets declare what infrastructure a
pipeline needs; the setup phase creates them according to
``creation-mode`` and tears them down per ``deletion-mode``.

Built-in managers cover the local datasources (SQL tables via the
sqlite datasource, vector collections via the in-process vector store);
external systems (Cassandra/Milvus/...) plug in through
:func:`register_asset_manager`.

The port's own copy of ``langstream_tpu/api/assets.py``. Managers take the
app's device (the card unless the caller asks for the CPU), where a
vector collection lives. :func:`refused_assets` names the declared types
no manager serves, so that the runner refuses such an app before
anything starts; ``opensearch-index`` and ``milvus-collection``, which
the JAX package manages over the network datasources, wait with those
datasources for ROADMAP A7.4.
"""

from __future__ import annotations

import abc
import logging
from typing import Any, Callable, Dict, List

from langstream_tpu_torch.model.application import AssetDefinition

logger = logging.getLogger(__name__)


class AssetManager(abc.ABC):
    """Lifecycle of one asset instance
    (reference: ``AssetManager.java`` — init/assetExists/deployAsset/
    deleteAssetIfExists/close)."""

    async def init(
        self, asset: AssetDefinition, resources: Dict[str, Any], device: Any = "cuda"
    ) -> None:
        self.asset = asset
        self.resources = resources
        self.device = device

    @abc.abstractmethod
    async def asset_exists(self) -> bool: ...

    @abc.abstractmethod
    async def deploy_asset(self) -> None: ...

    async def delete_asset(self) -> bool:
        return False

    async def close(self) -> None:
        pass


_MANAGERS: Dict[str, Callable[[], AssetManager]] = {}


def register_asset_manager(
    asset_type: str, factory: Callable[[], AssetManager]
) -> None:
    _MANAGERS[asset_type] = factory


def asset_manager_types() -> list:
    _ensure_builtin()
    return sorted(_MANAGERS)


def create_asset_manager(asset_type: str) -> AssetManager:
    _ensure_builtin()
    factory = _MANAGERS.get(asset_type)
    if factory is None:
        raise ValueError(
            f"no asset manager for type {asset_type!r} "
            f"(available: {sorted(_MANAGERS)})"
        )
    return factory()


# the JAX package's managers of network datasources the port lacks
NOT_PORTED = ("opensearch-index", "milvus-collection")


def refused_assets(assets) -> List[str]:
    """Why each declared asset has no manager here, by name ([] when every
    one has one). Stricter than the JAX runner, which only looks for a
    manager when an asset is to be created or deleted: the port refuses
    an app that declares a type it cannot manage before anything starts."""
    _ensure_builtin()
    out = []
    for asset in assets:
        if asset.asset_type in _MANAGERS:
            continue
        if asset.asset_type in NOT_PORTED:
            out.append(f"asset type {asset.asset_type!r} ({asset.name!r}) is not yet ported to "
                       "langstream_tpu_torch (ROADMAP A7.4: its network datasource)")
        else:
            out.append(f"asset type {asset.asset_type!r} ({asset.name!r}) is not yet ported to "
                       f"langstream_tpu_torch: no manager in either package (ported: "
                       f"{sorted(_MANAGERS)})")
    return out


_builtin = False


def _ensure_builtin() -> None:
    global _builtin
    if _builtin:
        return
    _builtin = True
    from langstream_tpu_torch.runtime import assets as _impl  # noqa: F401


async def deploy_assets(
    assets, resources: Dict[str, Any], device: Any = "cuda"
) -> None:
    """Setup-phase provisioning (reference:
    ``ApplicationSetupRunner`` asset deployment)."""
    for asset in assets:
        if asset.creation_mode != "create-if-not-exists":
            continue
        manager = create_asset_manager(asset.asset_type)
        await manager.init(asset, resources, device)
        try:
            if await manager.asset_exists():
                logger.info("asset %s already exists", asset.name)
                continue
            await manager.deploy_asset()
            logger.info("created asset %s (%s)", asset.name, asset.asset_type)
        finally:
            await manager.close()


async def cleanup_assets(assets, resources: Dict[str, Any], device: Any = "cuda") -> None:
    for asset in assets:
        if asset.deletion_mode != "delete":
            continue
        manager = create_asset_manager(asset.asset_type)
        await manager.init(asset, resources, device)
        try:
            if await manager.delete_asset():
                logger.info("deleted asset %s", asset.name)
        finally:
            await manager.close()
