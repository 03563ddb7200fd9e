"""The datasource SPI and its built-in implementations.

The port's own copy of ``langstream_tpu/agents/datasource.py`` (the
reference's datasource layer,
``langstream-agents/langstream-ai-agents/.../datasource/impl/{AstraDataSource,JdbcDataSourceProvider}.java``):
``resources:`` entries of type ``datasource`` resolve, through
:class:`DataSourceRegistry`, to a queryable service used by the ``query``
step and the vector agents. A query holds ``?`` placeholders filled from
params in order.

- ``service: sqlite`` — stdlib ``sqlite3`` (the JDBC-equivalent relational
  path: query and execute with ``?`` params).
- ``service: memory`` — in-process tables of dict rows with a small JSON
  filter syntax.
- ``service: vector`` — the vector store on the card
  (:class:`~langstream_tpu_torch.agents.vectorstore.VectorStoreDataSource`),
  on the registry's ``device``: the card unless the caller asks for the
  CPU.

Not yet ported, and refused by name: the JAX package's engines over
network clients (``opensearch``/``elasticsearch``, ``pinecone``, ``solr``,
``astra``, ``milvus``; its ``agents/external_stores.py``) and the services
it gates on client libraries (``cassandra``, ``jdbc``).
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.device import resolve_device

# the JAX package's services that the port does not carry yet: network
# engines (its external_stores.py) and the ones it gates on client libraries
NOT_PORTED_SERVICES = ("opensearch", "elasticsearch", "pinecone", "solr", "astra",
                       "astra-vector", "milvus", "cassandra", "jdbc")


class DataSource:
    async def query(self, query: str, params: List[Any]) -> List[Dict[str, Any]]:
        raise NotImplementedError

    async def execute(self, statement: str, params: List[Any]) -> Dict[str, Any]:
        raise NotImplementedError

    async def close(self) -> None:
        ...


class SqliteDataSource(DataSource):
    """Relational datasource over stdlib sqlite3 (reference analogue:
    ``JdbcDataSourceProvider``)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        import sqlite3

        path = config.get("path") or config.get("url", ":memory:")
        if path.startswith("sqlite:"):
            path = path[len("sqlite:"):] or ":memory:"
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = asyncio.Lock()

    async def query(self, query: str, params: List[Any]) -> List[Dict[str, Any]]:
        async with self._lock:
            cursor = self._conn.execute(query, params)
            return [dict(row) for row in cursor.fetchall()]

    async def execute(self, statement: str, params: List[Any]) -> Dict[str, Any]:
        async with self._lock:
            cursor = self._conn.execute(statement, params)
            self._conn.commit()
            return {"rowcount": cursor.rowcount, "lastrowid": cursor.lastrowid}

    async def close(self) -> None:
        self._conn.close()


class MemoryDataSource(DataSource):
    """Dict-row tables; query syntax: JSON ``{"table": ..., "where":
    {field: value}, "limit": n}`` with ``?`` params substituting values."""

    def __init__(self, config: Dict[str, Any]) -> None:
        self.tables: Dict[str, List[Dict[str, Any]]] = {
            name: list(rows) for name, rows in (config.get("tables") or {}).items()
        }

    async def query(self, query: str, params: List[Any]) -> List[Dict[str, Any]]:
        spec = json.loads(_substitute(query, params))
        rows = self.tables.get(spec.get("table", ""), [])
        where = spec.get("where", {})
        out = [
            row
            for row in rows
            if all(row.get(field) == expected for field, expected in where.items())
        ]
        limit = spec.get("limit")
        return out[:limit] if limit else out

    async def execute(self, statement: str, params: List[Any]) -> Dict[str, Any]:
        spec = json.loads(_substitute(statement, params))
        table = self.tables.setdefault(spec.get("table", "default"), [])
        if "insert" in spec:
            table.append(spec["insert"])
            return {"rowcount": 1}
        if "delete-where" in spec:
            before = len(table)
            table[:] = [
                row
                for row in table
                if not all(row.get(f) == v for f, v in spec["delete-where"].items())
            ]
            return {"rowcount": before - len(table)}
        raise ValueError(f"unsupported memory statement: {spec}")


def _substitute(query: str, params: List[Any]) -> str:
    """Replace ``?`` placeholders with JSON-encoded params. A quoted
    ``"?"`` (as produced by building the query spec with json.dumps) is
    treated as a bare placeholder, so params keep their JSON types.
    With no params the query passes through untouched, so literal ``?``
    characters in zero-param specs are safe."""
    if not params:
        return query
    query = query.replace('"?"', "?")
    parts = query.split("?")
    if len(parts) - 1 != len(params):
        if len(parts) == 1:
            return query
        raise ValueError(
            f"query has {len(parts) - 1} placeholders but {len(params)} params"
        )
    out = [parts[0]]
    for param, tail in zip(params, parts[1:]):
        out.append(json.dumps(param, default=str))
        out.append(tail)
    return "".join(out)


class DataSourceRegistry:
    """Resolve datasource resources to live connections (cached), on
    ``device``: the app's, which reaches the agents through their
    context (``AgentContext.device``). Resolving a ``vector`` service on
    the card raises without CUDA unless the registry was given the CPU."""

    def __init__(self, resources: Optional[Dict[str, Dict[str, Any]]] = None,
                 device: Any = "cuda") -> None:
        self.resources = resources or {}
        self.device = resolve_device(device)
        self._cache: Dict[str, DataSource] = {}

    def resolve(self, resource_name: str) -> DataSource:
        if resource_name in self._cache:
            return self._cache[resource_name]
        resource = self.resources.get(resource_name)
        if resource is None:
            raise ValueError(
                f"unknown datasource {resource_name!r}; declared: "
                f"{sorted(self.resources)}"
            )
        config = resource.get("configuration", resource)
        service = config.get("service", "sqlite")
        if service in ("sqlite", "jdbc-sqlite"):
            source: DataSource = SqliteDataSource(config)
        elif service in ("memory", "in-memory"):
            source = MemoryDataSource(config)
        elif service == "vector":
            from langstream_tpu_torch.agents.vectorstore import VectorStoreDataSource

            source = VectorStoreDataSource(config, device=self.device)
        elif service in NOT_PORTED_SERVICES:
            raise ValueError(
                f"datasource service {service!r} is not yet ported to langstream_tpu_torch "
                "(ROADMAP A7.4); ported: 'sqlite', 'memory', 'vector'"
            )
        else:
            raise ValueError(f"unknown datasource service {service!r}")
        self._cache[resource_name] = source
        return source

    async def close(self) -> None:
        for source in self._cache.values():
            await source.close()
        self._cache.clear()


def context_registry(context) -> DataSourceRegistry:
    """The datasources of an agent's app (its ``resources:``), on the
    app's device (``AgentContext.device``)."""
    return DataSourceRegistry(context.resources, device=context.device)
