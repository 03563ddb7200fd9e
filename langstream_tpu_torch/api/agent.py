"""The agent SPI — the contract every op of the framework implements.

The port's own copy of ``langstream_tpu/api/agent.py`` (the port imports nothing
of the JAX package).

Equivalent of the reference's agent contracts
(``langstream-api/src/main/java/ai/langstream/api/runner/code/AgentCode.java:25``,
``AgentSource.java:22``, ``AgentProcessor.java:23``, ``AgentSink.java:22``,
``AgentService.java:21``, ``AgentContext.java:25``): four agent kinds —
Source, Processor, Sink, Service — plus a shared lifecycle.

TPU-first deviations:

- The whole runtime is **asyncio-native**. The reference runs a single main
  thread with CompletableFuture-based async sinks; here every lifecycle and
  data method is a coroutine and the event loop is shared with the broker and
  gateway. Blocking work (XLA dispatch, file IO) belongs in executors —
  the ``jax_local`` provider runs device work on a dedicated thread.
- ``AgentProcessor.process(records, sink)`` keeps the reference's
  emit-as-you-complete contract (``AgentProcessor.java:23`` +
  ``SourceRecordAndResult`` record, line 41): results for each source record
  are pushed to a :class:`RecordSink` *as they finish*, out of order. This is
  load-bearing for TPU continuous batching — the LLM step completes records
  at different decode lengths and must not barrier the batch.
"""

from __future__ import annotations

import abc
import asyncio
import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional

from langstream_tpu_torch.api.records import Record


class ComponentType(enum.Enum):
    """Mirrors ``langstream-api/.../runtime/ComponentType.java``."""

    SOURCE = "source"
    PROCESSOR = "processor"
    SINK = "sink"
    SERVICE = "service"


@dataclasses.dataclass
class SourceRecordAndResult:
    """Result of processing one source record.

    Mirrors ``AgentProcessor.SourceRecordAndResult``
    (``AgentProcessor.java:41``): the source record, the records it produced
    (0..n), and an error if processing failed.
    """

    source_record: Record
    result_records: List[Record] = dataclasses.field(default_factory=list)
    error: Optional[BaseException] = None


class RecordSink:
    """Callback target for processor results (``RecordSink`` in the SPI).

    The runtime hands one to :meth:`AgentProcessor.process`; implementations
    must be safe to call from any asyncio task on the runner loop.
    """

    def emit(self, result: SourceRecordAndResult) -> None:
        raise NotImplementedError

    def emit_single(
        self, source_record: Record, result_records: List[Record]
    ) -> None:
        self.emit(SourceRecordAndResult(source_record, result_records))

    def emit_error(self, source_record: Record, error: BaseException) -> None:
        self.emit(SourceRecordAndResult(source_record, [], error))


class Agent(abc.ABC):
    """Shared lifecycle for all agent kinds (``AgentCode.java:25``).

    Lifecycle order enforced by the runner:
    ``init(config)`` → ``set_context(ctx)`` → ``start()`` → ... → ``close()``.
    """

    agent_id: str = ""
    agent_type: str = ""

    async def init(self, configuration: Dict[str, Any]) -> None:
        """Receive the agent's configuration map."""

    async def set_context(self, context: "AgentContext") -> None:
        self.context = context

    async def start(self) -> None:
        """Allocate runtime resources (connections, device buffers...)."""

    async def close(self) -> None:
        """Release resources; called on drain/shutdown."""

    def agent_info(self) -> Dict[str, Any]:
        """Introspection payload served at ``/info``
        (reference: ``AgentCode.getAgentStatus`` via
        ``agent/api/AgentAPIController.java``)."""
        return {
            "agent-id": self.agent_id,
            "agent-type": self.agent_type,
            "component-type": self.component_type().value,
        }

    @abc.abstractmethod
    def component_type(self) -> ComponentType:
        ...


class AgentSource(Agent):
    """A source reads records from an external system (``AgentSource.java:22``)."""

    def component_type(self) -> ComponentType:
        return ComponentType.SOURCE

    @abc.abstractmethod
    async def read(self, max_records: int = 100) -> List[Record]:
        """Return the next batch of records (may be empty; must not block
        the loop forever — poll with a timeout). ``max_records`` is the
        runner's remaining pending-record budget; honoring it is what makes
        backpressure exact (custom sources may treat it as advisory)."""

    async def commit(self, records: List[Record]) -> None:
        """All downstream writes for ``records`` are durable; advance offsets."""

    async def permanent_failure(
        self, record: Record, error: BaseException
    ) -> None:
        """A record exhausted its error policy with ``fail``; default:
        re-raise so the runner dies and the supervisor restarts it
        (reference behavior: ``AgentSource.java`` default + AgentRunner
        ``mainErrorHandler``)."""
        raise error


class AgentProcessor(Agent):
    """A processor maps each source record to 0..n result records
    (``AgentProcessor.java:23``)."""

    def component_type(self) -> ComponentType:
        return ComponentType.PROCESSOR

    @abc.abstractmethod
    def process(self, records: List[Record], sink: RecordSink) -> None:
        """Schedule processing of ``records``; emit each record's
        :class:`SourceRecordAndResult` on ``sink`` as it completes.

        Must not await — schedule tasks on the running loop and return.
        """


class SingleRecordProcessor(AgentProcessor):
    """Convenience base: implement per-record async processing
    (reference: ``SingleRecordAgentProcessor.java:24``)."""

    async def process_record(self, record: Record) -> List[Record]:
        raise NotImplementedError

    def process(self, records: List[Record], sink: RecordSink) -> None:
        loop = asyncio.get_running_loop()
        for record in records:
            loop.create_task(self._process_one(record, sink))

    async def _process_one(self, record: Record, sink: RecordSink) -> None:
        try:
            results = await self.process_record(record)
            sink.emit_single(record, list(results))
        except BaseException as error:  # noqa: BLE001 — forwarded to policy
            sink.emit_error(record, error)


class AgentSink(Agent):
    """A sink writes records to an external system (``AgentSink.java:22``)."""

    def component_type(self) -> ComponentType:
        return ComponentType.SINK

    @abc.abstractmethod
    async def write(self, record: Record) -> None:
        """Durably write one record; awaiting it is the reference's
        ``CompletableFuture<Void>`` completion."""

    def handles_commit(self) -> bool:
        """True if the sink commits source offsets itself (reference:
        Kafka Connect sink adapter path, ``AgentRunner.java:716-722``)."""
        return False

    def set_commit_callback(
        self, callback: Callable[[List[Record]], None]
    ) -> None:
        """Used when :meth:`handles_commit` is True."""


class AgentService(Agent):
    """A long-running service with no record loop (``AgentService.java:21``)."""

    def component_type(self) -> ComponentType:
        return ComponentType.SERVICE

    @abc.abstractmethod
    async def join(self) -> None:
        """Run until shutdown."""


class AgentContext:
    """Runtime context handed to every agent (``AgentContext.java:25``).

    Exposes topic access for agents that need side-channels (dispatch,
    stream-to-topic), the persistent state directory, metrics, and the
    bad-record handler.
    """

    def __init__(
        self,
        *,
        agent_id: str = "",
        application_id: str = "",
        tenant: str = "default",
        topic_connections=None,
        persistent_state_directory: Optional[str] = None,
        metrics=None,
        global_agent_id: Optional[str] = None,
        bad_record_handler: Optional[Callable[[Record, BaseException], None]] = None,
        service_provider_registry=None,
        resources: Optional[Dict[str, Dict[str, Any]]] = None,
        device: Any = "cuda",
    ) -> None:
        self.agent_id = agent_id
        self.application_id = application_id
        self.tenant = tenant
        self.topic_connections = topic_connections
        self._persistent_state_directory = persistent_state_directory
        self.metrics = metrics
        self.global_agent_id = global_agent_id or agent_id
        self.bad_record_handler = bad_record_handler
        self.service_provider_registry = service_provider_registry
        # resolved `resources:` section of configuration.yaml (datasources,
        # ai services) so agents can look up shared service configs
        self.resources = resources or {}
        # the app's device (the card unless the caller asked for the CPU):
        # the datasources an agent resolves live on it
        self.device = device

    def persistent_state_directory(self) -> Optional[str]:
        """Per-agent durable scratch dir (reference:
        ``AgentContext.getPersistentStateDirectoryForAgent``,
        ``AgentContext.java:42-44``); None when no disk was requested."""
        return self._persistent_state_directory
