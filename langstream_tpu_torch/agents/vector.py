"""Vector DB agents: write embeddings, query for RAG.

The port's own copy of ``langstream_tpu/agents/vector.py``, the
reference's ``langstream-vector-agents`` (``VectorDBSinkAgent.java:28``,
``QueryVectorDBAgent.java:39``): a sink that writes records into a vector
datasource and a processor that queries one. Both speak the datasource
SPI, so they work against the store on the card
(``agents/vectorstore.py``) or any other datasource of the app, resolved
on the app's device (``AgentContext.device``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.api.agent import AgentSink, SingleRecordProcessor
from langstream_tpu_torch.api.records import Record
from langstream_tpu_torch.agents.datasource import DataSourceRegistry, context_registry
from langstream_tpu_torch.agents.el import Expression
from langstream_tpu_torch.agents.transform import TransformContext


class VectorDBSinkAgent(AgentSink):
    """Write each record into a vector datasource.

    Config: ``datasource`` (resource name), plus field expressions
    ``vector.id`` / ``vector.vector`` / ``vector.metadata`` (reference
    config shape for the Astra/Milvus writers).
    """

    agent_type = "vector-db-sink"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.datasource_name = configuration.get("datasource", "datasource")
        self.id_expr = Expression(configuration.get("vector.id", "fn.uuid()"))
        self.vector_expr = Expression(
            configuration.get("vector.vector", "value.embeddings")
        )
        metadata = configuration.get("vector.metadata")
        self.metadata_expr = Expression(metadata) if metadata else None
        self.text_expr = (
            Expression(configuration.get("vector.text"))
            if configuration.get("vector.text")
            else None
        )
        self._registry: Optional[DataSourceRegistry] = None
        self._datasource = None

    async def start(self) -> None:
        self._registry = context_registry(self.context)
        self._datasource = self._registry.resolve(self.datasource_name)

    async def close(self) -> None:
        if self._registry is not None:
            await self._registry.close()

    async def write(self, record: Record) -> None:
        el_ctx = TransformContext(record).el_context()
        doc_id = self.id_expr.evaluate(el_ctx)
        vector = self.vector_expr.evaluate(el_ctx)
        if vector is None:
            raise ValueError(
                "record has no embeddings vector for vector-db-sink "
                "(compute-ai-embeddings upstream?)"
            )
        metadata: Dict[str, Any] = {}
        if self.metadata_expr is not None:
            metadata = dict(self.metadata_expr.evaluate(el_ctx) or {})
        if self.text_expr is not None:
            metadata["text"] = self.text_expr.evaluate(el_ctx)
        statement = json.dumps(
            {"action": "upsert", "id": str(doc_id), "vector": list(vector),
             "metadata": metadata}
        )
        await self._datasource.execute(statement, [])


class QueryVectorDBAgent(SingleRecordProcessor):
    """Query a vector datasource, put results in ``output-field``
    (``QueryVectorDBAgent.java:39``)."""

    agent_type = "query-vector-db"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.datasource_name = configuration.get("datasource", "datasource")
        self.query = configuration["query"]
        self.fields = [Expression(f) for f in configuration.get("fields", [])]
        self.output_field = configuration.get("output-field", "value.query-result")
        self.only_first = bool(configuration.get("only-first", False))
        self._registry: Optional[DataSourceRegistry] = None
        self._datasource = None

    async def start(self) -> None:
        self._registry = context_registry(self.context)
        self._datasource = self._registry.resolve(self.datasource_name)

    async def close(self) -> None:
        if self._registry is not None:
            await self._registry.close()

    async def process_record(self, record: Record) -> List[Record]:
        ctx = TransformContext(record)
        el_ctx = ctx.el_context()
        params = [f.evaluate(el_ctx) for f in self.fields]
        rows = await self._datasource.query(self.query, params)
        result: Any = rows[0] if (self.only_first and rows) else rows
        ctx.set_field(self.output_field, result)
        return [ctx.to_record()]
