"""Re-rank agent: MMR re-ranking of retrieved documents.

The port's own copy of ``langstream_tpu/agents/rerank.py``, the
reference's ``ReRankAgent``
(``langstream-agents/langstream-ai-agents/src/main/java/ai/langstream/agents/ai/rerank/ReRankAgent.java``):
re-orders a candidate list under a context budget using Maximal Marginal
Relevance over the query/document embeddings.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.api.agent import SingleRecordProcessor
from langstream_tpu_torch.api.records import Record
from langstream_tpu_torch.agents.el import Expression
from langstream_tpu_torch.agents.transform import TransformContext


def _cosine(a: List[float], b: List[float]) -> float:
    dot = sum(x * y for x, y in zip(a, b))
    norm_a = math.sqrt(sum(x * x for x in a)) or 1.0
    norm_b = math.sqrt(sum(y * y for y in b)) or 1.0
    return dot / (norm_a * norm_b)


def mmr_rank(
    query_vector: List[float],
    candidates: List[Dict[str, Any]],
    *,
    vector_field: str,
    lambda_param: float = 0.5,
    max_results: int = 10,
) -> List[Dict[str, Any]]:
    """Greedy MMR: balance relevance to the query against redundancy with
    already-selected documents."""
    remaining = [c for c in candidates if c.get(vector_field) is not None]
    selected: List[Dict[str, Any]] = []
    while remaining and len(selected) < max_results:
        best, best_score = None, -math.inf
        for candidate in remaining:
            relevance = _cosine(query_vector, candidate[vector_field])
            redundancy = max(
                (
                    _cosine(candidate[vector_field], chosen[vector_field])
                    for chosen in selected
                ),
                default=0.0,
            )
            score = lambda_param * relevance - (1 - lambda_param) * redundancy
            if score > best_score:
                best, best_score = candidate, score
        selected.append(best)
        remaining.remove(best)
    return selected


class ReRankAgent(SingleRecordProcessor):
    agent_type = "re-rank"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.field = configuration.get("field", "value.query-result")
        self.output_field = configuration.get("output-field", self.field)
        self.algorithm = configuration.get("algorithm", "MMR")
        self.lambda_param = float(configuration.get("lambda", 0.5))
        self.max_results = int(configuration.get("max", 10))
        self.query_embeddings = Expression(
            configuration.get("query-embeddings", "value.question_embeddings")
        )
        # name of the embedding field INSIDE each candidate dict
        self.vector_field = configuration.get("vector-field", "vector")

    async def process_record(self, record: Record) -> List[Record]:
        ctx = TransformContext(record)
        el_ctx = ctx.el_context()
        candidates = ctx.get_field(self.field) or []
        query_vector = self.query_embeddings.evaluate(el_ctx)
        if self.algorithm.upper() != "MMR":
            raise ValueError(f"unknown re-rank algorithm {self.algorithm!r}")
        if query_vector is None:
            ranked = list(candidates)[: self.max_results]
        else:
            ranked = mmr_rank(
                list(query_vector),
                list(candidates),
                vector_field=self.vector_field,
                lambda_param=self.lambda_param,
                max_results=self.max_results,
            )
        ctx.set_field(self.output_field, ranked)
        return [ctx.to_record()]
