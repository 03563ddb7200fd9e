"""Flow-control agents: dispatch, timer-source, trigger-event, log-event.

Equivalent of the reference's ``langstream-agents-flow-control`` module
(type map ``flow/FlowControlAgentsCodeProvider.java:26-34``).

The port's own copy of ``langstream_tpu/agents/flow.py``: ``dispatch``
and ``trigger-event`` write to their topics through the app's topic
runtime (``context.topic_connections``, the memory broker).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List

from langstream_tpu_torch.api.agent import AgentSource, SingleRecordProcessor
from langstream_tpu_torch.api.records import Record, now_millis
from langstream_tpu_torch.agents.el import Expression
from langstream_tpu_torch.agents.transform import TransformContext

logger = logging.getLogger(__name__)


class DispatchAgent(SingleRecordProcessor):
    """Route records to other topics by condition (``dispatch`` agent).

    Config: ``routes: [{when, destination, action: dispatch|drop}]``.
    A record matching a ``dispatch`` route is written to that topic and
    swallowed; ``drop`` discards it; no match → pass through.
    """

    agent_type = "dispatch"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.routes = []
        for route in configuration.get("routes", []):
            self.routes.append(
                (
                    Expression(route["when"]) if route.get("when") else None,
                    route.get("destination"),
                    route.get("action", "dispatch"),
                )
            )
        self._producers: Dict[str, Any] = {}

    async def close(self) -> None:
        for producer in self._producers.values():
            await producer.close()

    async def _producer(self, topic: str):
        producer = self._producers.get(topic)
        if producer is None:
            producer = self.context.topic_connections.create_producer(
                self.agent_id, {"topic": topic}
            )
            await producer.start()
            self._producers[topic] = producer
        return producer

    async def process_record(self, record: Record) -> List[Record]:
        el_ctx = TransformContext(record).el_context()
        for condition, destination, action in self.routes:
            if condition is None or bool(condition.evaluate(el_ctx)):
                if action == "drop":
                    return []
                if destination:
                    producer = await self._producer(destination)
                    await producer.write(record)
                    return []
        return [record]


class TimerSourceAgent(AgentSource):
    """Emit a record every ``period-seconds`` with computed fields."""

    agent_type = "timer-source"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.period = float(configuration.get("period-seconds", 60))
        self.fields = [
            (field["name"], Expression(str(field["expression"])))
            for field in configuration.get("fields", [])
        ]
        self._next_fire = time.monotonic() + self.period

    async def read(self, max_records: int = 100) -> List[Record]:
        delay = self._next_fire - time.monotonic()
        if delay > 0:
            await asyncio.sleep(min(delay, 0.2))
            if time.monotonic() < self._next_fire:
                return []
        self._next_fire = time.monotonic() + self.period
        value: Dict[str, Any] = {}
        el_ctx = {"value": {}, "key": None, "properties": {}, "timestamp": now_millis()}
        for name, expression in self.fields:
            target = name.split(".", 1)[1] if name.startswith("value.") else name
            value[target] = expression.evaluate(el_ctx)
        return [Record(value=value, timestamp=now_millis())]


class TriggerEventAgent(SingleRecordProcessor):
    """Emit a side event to a topic when a condition holds
    (``trigger-event`` agent)."""

    agent_type = "trigger-event"

    async def init(self, configuration: Dict[str, Any]) -> None:
        when = configuration.get("when")
        self.when = Expression(when) if when else None
        self.destination = configuration.get("destination")
        self.continue_processing = bool(configuration.get("continue-processing", True))
        self.fields = [
            (f["name"], Expression(str(f["expression"])))
            for f in configuration.get("fields", [])
        ]
        self._producer = None

    async def close(self) -> None:
        if self._producer is not None:
            await self._producer.close()

    async def process_record(self, record: Record) -> List[Record]:
        el_ctx = TransformContext(record).el_context()
        if self.when is None or bool(self.when.evaluate(el_ctx)):
            event_value: Dict[str, Any] = {}
            for name, expression in self.fields:
                target = name.split(".", 1)[1] if name.startswith("value.") else name
                event_value[target] = expression.evaluate(el_ctx)
            if self.destination:
                if self._producer is None:
                    self._producer = self.context.topic_connections.create_producer(
                        self.agent_id, {"topic": self.destination}
                    )
                    await self._producer.start()
                await self._producer.write(
                    Record(value=event_value or record.value, key=record.key)
                )
            if not self.continue_processing:
                return []
        return [record]


class LogEventAgent(SingleRecordProcessor):
    """Structured-log records as they pass (``log-event`` agent)."""

    agent_type = "log-event"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.prefix = configuration.get("message", "log-event")
        self.fields = [
            (f["name"], Expression(str(f["expression"])))
            for f in configuration.get("fields", [])
        ]

    async def process_record(self, record: Record) -> List[Record]:
        el_ctx = TransformContext(record).el_context()
        if self.fields:
            payload = {name: expr.evaluate(el_ctx) for name, expr in self.fields}
        else:
            payload = {"value": record.value, "key": record.key}
        logger.info("%s %s", self.prefix, payload)
        return [record]
