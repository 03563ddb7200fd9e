"""Composite (fused) agent execution.

The port's own copy of ``langstream_tpu/runtime/composite.py`` (the port imports nothing
of the JAX package).

Equivalent of the reference's ``CompositeAgentProcessor``
(``langstream-runtime/langstream-runtime-impl/src/main/java/ai/langstream/runtime/agent/CompositeAgentProcessor.java:36``):
when the planner fuses consecutive composable agents into one
``composite-agent`` node, this processor runs the chained pipeline inside a
single runner, passing records in memory between steps — eliminating the
broker hop that would otherwise sit between every agent.

Chaining preserves the emit-as-you-complete contract: each *source* record
flows through the whole chain in its own task, so one slow record (e.g. a
long decode) never barriers its batch-mates.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.api.agent import (
    AgentContext,
    AgentProcessor,
    RecordSink,
    SourceRecordAndResult,
)
from langstream_tpu_torch.api.records import Record
from langstream_tpu_torch.runtime.registry import create_agent


async def process_one(
    processor: AgentProcessor, record: Record
) -> SourceRecordAndResult:
    """Run one record through an emit-style processor and await its result."""
    from langstream_tpu_torch.runtime.runner import process_and_collect

    return (await process_and_collect(processor, [record]))[0]


class CompositeAgentProcessor(AgentProcessor):
    """Chains N processors; configured with the fused agents' configs
    (reference config parse: ``CompositeAgentProcessor.java:52-75``)."""

    agent_type = "composite-agent"

    def __init__(self, processors: Optional[List[AgentProcessor]] = None) -> None:
        self.processors: List[AgentProcessor] = processors or []
        self.agent_id = "composite"

    async def init(self, configuration: Dict[str, Any]) -> None:
        """Build sub-processors from a ``processors: [{agentType, agentId,
        configuration}]`` list when not injected programmatically."""
        for spec in configuration.get("processors", []):
            processor = create_agent(spec["agentType"])
            processor.agent_id = spec.get("agentId", spec["agentType"])
            await processor.init(spec.get("configuration", {}))
            self.processors.append(processor)

    async def set_context(self, context: AgentContext) -> None:
        self.context = context
        for processor in self.processors:
            await processor.set_context(context)

    async def start(self) -> None:
        for processor in self.processors:
            await processor.start()

    async def close(self) -> None:
        for processor in self.processors:
            await processor.close()

    def agent_info(self) -> Dict[str, Any]:
        return {
            "agent-id": self.agent_id,
            "agent-type": self.agent_type,
            "component-type": "processor",
            "processors": [p.agent_info() for p in self.processors],
        }

    def process(self, records: List[Record], sink: RecordSink) -> None:
        loop = asyncio.get_running_loop()
        for record in records:
            loop.create_task(self._run_chain(record, sink))

    async def _run_chain(self, source_record: Record, sink: RecordSink) -> None:
        current = [source_record]
        try:
            for processor in self.processors:
                next_records: List[Record] = []
                for record in current:
                    result = await process_one(processor, record)
                    if result.error is not None:
                        raise result.error
                    next_records.extend(result.result_records)
                current = next_records
                if not current:
                    break
            sink.emit_single(source_record, current)
        except BaseException as error:  # noqa: BLE001 — routed to policy
            sink.emit_error(source_record, error)
