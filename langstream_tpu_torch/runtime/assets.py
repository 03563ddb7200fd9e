"""Built-in asset managers: SQL tables and vector collections.

Counterparts of the reference's asset providers
(``langstream-core/src/main/java/ai/langstream/impl/assets/``:
JdbcAssetsProvider, ...). The local build ships managers for its bundled
datasources:

- ``jdbc-table`` / ``table`` — run ``create-statements`` against the
  SQL datasource named by ``datasource`` (sqlite locally; the config
  shape matches the reference's jdbc-table asset).
- ``vector-collection`` — create a named in-process vector store
  collection with the given ``dimensions``, on the app's device.

The port's own copy of the part of ``langstream_tpu/runtime/assets.py``
that serves the port's datasources; its ``opensearch-index`` and
``milvus-collection`` managers wait with their network datasources for
ROADMAP A7.4 (``api/assets.refused_assets`` names them). External systems
register via :func:`langstream_tpu_torch.api.assets.register_asset_manager`.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List

from langstream_tpu_torch.agents.datasource import DataSourceRegistry
from langstream_tpu_torch.api.assets import AssetManager, register_asset_manager

logger = logging.getLogger(__name__)


def _datasource_name(config: Dict[str, Any]) -> str:
    value = config.get("datasource")
    if isinstance(value, dict):
        # the reference injects the full resource here; accept both
        return value.get("name") or value.get("id") or "datasource"
    return value


class JdbcTableAssetManager(AssetManager):
    """``jdbc-table`` (reference: JdbcAssetsProvider — table-name +
    create-statements + optional delete-statements)."""

    async def init(self, asset, resources, device: Any = "cuda") -> None:
        await super().init(asset, resources, device)
        self._registry = DataSourceRegistry(resources, device=device)
        self._source = self._registry.resolve(_datasource_name(asset.config))
        self.table = asset.config.get("table-name") or asset.name

    async def asset_exists(self) -> bool:
        rows = await self._source.query(
            "SELECT name FROM sqlite_master WHERE type='table' AND name=?",
            [self.table],
        )
        return bool(rows)

    async def deploy_asset(self) -> None:
        statements: List[str] = self.asset.config.get("create-statements", [])
        if not statements:
            raise ValueError(
                f"asset {self.asset.name!r}: jdbc-table needs create-statements"
            )
        for statement in statements:
            await self._source.execute(statement, [])

    async def delete_asset(self) -> bool:
        statements = self.asset.config.get("delete-statements") or [
            f"DROP TABLE IF EXISTS {self.table}"
        ]
        for statement in statements:
            await self._source.execute(statement, [])
        return True


class VectorCollectionAssetManager(AssetManager):
    """``vector-collection``: a named collection in the in-process
    vector store on the app's device (role analogue of
    milvus-collection / opensearch-index assets)."""

    async def init(self, asset, resources, device: Any = "cuda") -> None:
        await super().init(asset, resources, device)
        from langstream_tpu_torch.agents import vectorstore

        self._module = vectorstore
        self.collection = asset.config.get("collection-name") or asset.name
        self.dimensions = int(asset.config.get("dimensions", 0) or 0)

    async def asset_exists(self) -> bool:
        return self.collection in self._module._SHARED_STORES

    async def deploy_asset(self) -> None:
        if not self.dimensions:
            raise ValueError(
                f"asset {self.asset.name!r}: vector-collection needs dimensions"
            )
        self._module.shared_store(self.collection, self.dimensions, device=self.device)

    async def delete_asset(self) -> bool:
        return self._module._SHARED_STORES.pop(self.collection, None) is not None


register_asset_manager("jdbc-table", JdbcTableAssetManager)
register_asset_manager("table", JdbcTableAssetManager)
register_asset_manager("vector-collection", VectorCollectionAssetManager)
