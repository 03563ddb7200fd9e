"""FLARE controller: iterative active-retrieval loop.

The port's own copy of ``langstream_tpu/agents/flare.py``, the
reference's ``flare-controller`` agent
(langstream-agents/langstream-ai-agents/src/main/java/ai/langstream/ai/agents/flare/FlareControllerAgent.java:42):
after a text completion that returned per-token log-probabilities, scan
for *low-confidence spans* (tokens whose probability falls below
``min-prob``), merge nearby spans (``min-token-gap``) with padding
(``num-pad-tokens``), and:

- no spans → the answer is confident: pass the record through;
- spans found → write them to ``retrieve-documents-field`` and send the
  record to ``loop-topic`` (incrementing ``num-iterations-field``), so
  the pipeline's retrieval stage fetches more context about exactly the
  uncertain parts and re-generates. ``max-iterations`` bounds the loop.

The ``torch-local`` engine produces the token logprobs from its own
decode loop on the card (no external API), so a FLARE loop makes no
network round trip per iteration.
"""

from __future__ import annotations

import logging
import math
import re
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.api.agent import SingleRecordProcessor
from langstream_tpu_torch.api.records import Record
from langstream_tpu_torch.agents.transform import TransformContext

logger = logging.getLogger(__name__)

_WORD = re.compile(r"\w")


def low_confidence_spans(
    tokens: List[str],
    logprobs: List[float],
    *,
    min_prob: float = 0.2,
    min_token_gap: int = 5,
    num_pad_tokens: int = 2,
) -> List[str]:
    """Spans of consecutive low-confidence word tokens, merged when
    closer than ``min_token_gap`` and padded by ``num_pad_tokens``
    (reference: ``FlareControllerAgent.lowConfidenceSpans``)."""
    low_idx = [
        i
        for i in range(min(len(tokens), len(logprobs)))
        if math.exp(logprobs[i]) < min_prob and _WORD.search(tokens[i] or "")
    ]
    if not low_idx:
        return []
    spans = [[low_idx[0], low_idx[0] + num_pad_tokens + 1]]
    for prev, idx in zip(low_idx, low_idx[1:]):
        end = idx + num_pad_tokens + 1
        if idx - prev < min_token_gap:
            spans[-1][1] = end
        else:
            spans.append([idx, end])
    return [
        "".join(tokens[start:min(end, len(tokens))])
        for start, end in spans
    ]


class FlareControllerAgent(SingleRecordProcessor):
    """``flare-controller`` agent."""

    agent_type = "flare-controller"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.tokens_field = configuration.get("tokens-field", "value.tokens")
        self.logprobs_field = configuration.get(
            "logprobs-field", "value.logprobs"
        )
        self.loop_topic = configuration["loop-topic"]
        self.retrieve_field = configuration.get(
            "retrieve-documents-field", "value.documents_to_retrieve"
        )
        self.min_prob = float(configuration.get("min-prob", 0.2))
        self.min_token_gap = int(configuration.get("min-token-gap", 5))
        self.num_pad_tokens = int(configuration.get("num-pad-tokens", 2))
        self.max_iterations = int(configuration.get("max-iterations", 10))
        self.iterations_field = configuration.get(
            "num-iterations-field", "value.flare_iterations"
        )
        self._producer = None

    async def close(self) -> None:
        if self._producer is not None:
            await self._producer.close()
            self._producer = None

    async def _loop_producer(self):
        if self._producer is None:
            producer = self.context.topic_connections.create_producer(
                self.agent_id, {"topic": self.loop_topic}
            )
            await producer.start()
            self._producer = producer
        return self._producer

    async def process_record(self, record: Record) -> List[Record]:
        ctx = TransformContext(record)
        iterations = ctx.get_field(self.iterations_field) or 0
        if int(iterations) >= self.max_iterations:
            logger.info(
                "flare: record hit max iterations (%s), passing through",
                iterations,
            )
            return [record]
        tokens = ctx.get_field(self.tokens_field) or []
        logprobs = ctx.get_field(self.logprobs_field) or []
        spans = low_confidence_spans(
            list(tokens), [float(p) for p in logprobs],
            min_prob=self.min_prob,
            min_token_gap=self.min_token_gap,
            num_pad_tokens=self.num_pad_tokens,
        )
        if not spans:
            return [record]
        ctx.set_field(self.retrieve_field, spans)
        ctx.set_field(self.iterations_field, int(iterations) + 1)
        producer = await self._loop_producer()
        await producer.write(ctx.to_record())
        logger.info(
            "flare: %d low-confidence spans -> %s", len(spans), self.loop_topic
        )
        return []  # control passed to the loop topic
