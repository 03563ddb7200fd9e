"""The datasource SPI, the port's copy of the base class and the
placeholder substitution of ``langstream_tpu/agents/datasource.py``.

A datasource answers JSON (or SQL) query specs with ``?`` placeholders
filled from params; :class:`~langstream_tpu_torch.agents.vectorstore.VectorStoreDataSource`
is the port's one implementation.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List


class DataSource:
    async def query(self, query: str, params: List[Any]) -> List[Dict[str, Any]]:
        raise NotImplementedError

    async def execute(self, statement: str, params: List[Any]) -> Dict[str, Any]:
        raise NotImplementedError

    async def close(self) -> None:
        ...


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
