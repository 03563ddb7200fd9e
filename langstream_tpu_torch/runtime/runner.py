"""The agent runner — the data-plane hot loop.

Re-architecture of the reference's ``AgentRunner``
(``langstream-runtime/langstream-runtime-impl/src/main/java/ai/langstream/runtime/agent/AgentRunner.java:86``):
compose Source → Processor → Sink (defaulting to topic-backed source/sink),
then run the loop: ``source.read()`` → ``processor.process(batch, sink)`` →
per-source-record async ``sink.write()`` → ``source.commit()`` once every
sink write for that source record is durable. Per-record error policy
(retry / skip / fail / dead-letter) mirrors ``StandardErrorsHandler`` +
the retry loops at ``AgentRunner.java:765-889``.

Re-design notes:

- **Asyncio, one loop**: the reference runs one Java main thread plus async
  completions; here reads, processing, sink writes, metrics, and drain all
  share the event loop. Heavy compute (device dispatch) lives on
  provider-owned threads, so the loop stays responsive while the card
  crunches.
- **Reads are pipelined**: the loop keeps reading while earlier records are
  still decoding on the device (the reference behaves the same — its sink
  writes are futures). Backpressure is a bounded pending-record budget
  (``max_pending_records``) instead of unbounded growth; this is what lets
  the completions engine continuously batch across Kafka polls.
- **Commit ordering** is delegated to the topic consumer's contiguous
  watermark (see ``topics/memory.py``), so out-of-order record completion
  never commits past an in-flight record (reference:
  ``SourceRecordTracker.java:32`` + ``KafkaConsumerWrapper.java:52-230``).

The port's own copy of ``langstream_tpu/runtime/runner.py``; here the
heavy compute is the ``torch-local`` engine's thread on the card.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.api.agent import (
    AgentContext,
    AgentProcessor,
    AgentSink,
    AgentSource,
    RecordSink,
    SourceRecordAndResult,
)
from langstream_tpu_torch.api.errors import (
    ErrorHandlingDecision,
    ErrorsSpec,
    FatalAgentError,
    StandardErrorsHandler,
)
from langstream_tpu_torch.api.metrics import MetricsReporter
from langstream_tpu_torch.api.records import Record
from langstream_tpu_torch.api.topics import TopicConsumer, TopicProducer
from langstream_tpu_torch.runtime.tracing import TRACE_ID_HEADER

logger = logging.getLogger(__name__)


class TopicConsumerSource(AgentSource):
    """Default source: consume the agent's input topic
    (reference: ``TopicConsumerSource.java:28``)."""

    def __init__(
        self,
        consumer: TopicConsumer,
        deadletter_producer: Optional[TopicProducer] = None,
    ) -> None:
        self.consumer = consumer
        self.deadletter_producer = deadletter_producer
        self.agent_id = "topic-consumer-source"
        self.agent_type = "topic-source"

    async def start(self) -> None:
        await self.consumer.start()
        if self.deadletter_producer is not None:
            await self.deadletter_producer.start()

    async def close(self) -> None:
        await self.consumer.close()
        if self.deadletter_producer is not None:
            await self.deadletter_producer.close()

    async def read(self, max_records: int = 100) -> List[Record]:
        return await self.consumer.read(max_records=max_records, timeout=0.2)

    async def commit(self, records: List[Record]) -> None:
        await self.consumer.commit(records)

    async def permanent_failure(self, record: Record, error: BaseException) -> None:
        """Route to the dead-letter topic when available, else crash the
        runner (reference: ``TopicConsumerSource.permanentFailure``)."""
        if self.deadletter_producer is None:
            raise error
        logger.warning("sending record to dead-letter: %r (%s)", record, error)
        await self.deadletter_producer.write(
            record.with_header("langstream-error", str(error)[:1024])
        )

    def agent_info(self) -> Dict[str, Any]:
        info = super().agent_info()
        info["consumed"] = self.consumer.total_out()
        return info


class TopicProducerSink(AgentSink):
    """Default sink: produce to the agent's output topic
    (reference: ``TopicProducerSink.java``)."""

    def __init__(self, producer: TopicProducer) -> None:
        self.producer = producer
        self.agent_id = "topic-producer-sink"
        self.agent_type = "topic-sink"

    async def start(self) -> None:
        await self.producer.start()

    async def close(self) -> None:
        await self.producer.close()

    async def write(self, record: Record) -> None:
        await self.producer.write(record)

    def agent_info(self) -> Dict[str, Any]:
        info = super().agent_info()
        info["produced"] = self.producer.total_in()
        return info


class NullSink(AgentSink):
    """Sink for pipeline-terminal agents with no output topic."""

    agent_id = "null-sink"
    agent_type = "null-sink"

    async def write(self, record: Record) -> None:
        return None


class IdentityProcessor(AgentProcessor):
    """Pass-through processor for source→sink pipelines
    (reference wires the same implicit identity)."""

    agent_id = "identity"
    agent_type = "identity"

    def process(self, records: List[Record], sink: RecordSink) -> None:
        for record in records:
            sink.emit_single(record, [record])


class _QueueRecordSink(RecordSink):
    """Bridges processor emissions into the runner's result queue."""

    def __init__(self) -> None:
        self.queue: "asyncio.Queue[SourceRecordAndResult]" = asyncio.Queue()

    def emit(self, result: SourceRecordAndResult) -> None:
        self.queue.put_nowait(result)


async def process_and_collect(
    processor: AgentProcessor, records: List[Record]
) -> List[SourceRecordAndResult]:
    """Run a batch through an emit-style processor and await all results.

    Utility used by the composite pipeline and tests; the runner itself
    never barriers a batch this way.
    """
    if not records:
        return []
    sink = _QueueRecordSink()
    processor.process(records, sink)
    out: List[SourceRecordAndResult] = []
    for _ in records:
        out.append(await sink.queue.get())
    return out


class RunnerStats:
    def __init__(self) -> None:
        self.records_in = 0
        self.records_out = 0
        self.errors = 0
        self.skipped = 0
        self.dead_lettered = 0
        self.started_at = time.time()

    def snapshot(self) -> Dict[str, Any]:
        return {
            "records-in": self.records_in,
            "records-out": self.records_out,
            "errors": self.errors,
            "skipped": self.skipped,
            "dead-lettered": self.dead_lettered,
            "uptime-s": round(time.time() - self.started_at, 3),
        }


class AgentRunner:
    """Runs one execution-plan node: source → processor → sink.

    Equivalent of ``AgentRunner.runMainLoop`` (``AgentRunner.java:645-724``)
    plus its error-action plumbing (765-889) and graceful drain
    (``waitForNoPendingRecords``, 556-594).
    """

    def __init__(
        self,
        *,
        agent_id: str,
        source: AgentSource,
        processor: AgentProcessor,
        sink: AgentSink,
        errors: ErrorsSpec = ErrorsSpec(),
        context: Optional[AgentContext] = None,
        metrics: Optional[MetricsReporter] = None,
        max_pending_records: int = 512,
        drain_timeout: float = 60.0,
        tracer=None,
    ) -> None:
        from langstream_tpu_torch.runtime.tracing import NOOP
        self.agent_id = agent_id
        self.source = source
        self.processor = processor
        self.sink = sink
        self.errors_spec = errors
        self.context = context or AgentContext(agent_id=agent_id)
        self.metrics = metrics or MetricsReporter(prefix=f"agent_{agent_id}")
        self.max_pending_records = max_pending_records
        self.drain_timeout = drain_timeout
        self.tracer = tracer or NOOP

        self.stats = RunnerStats()
        self._stop = asyncio.Event()
        self._pending = 0
        self._pending_low = asyncio.Event()
        self._pending_low.set()
        self._attempts: Dict[int, int] = {}
        self._result_sink = _QueueRecordSink()
        self._tasks: List[asyncio.Task] = []
        self._failure: Optional[BaseException] = None

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    _agents_started = False

    async def start_agents(self) -> None:
        """Start source/processor/sink. Idempotent; callable before
        :meth:`run` so an orchestrator can bring all replicas into the
        consumer group before any data flows (avoids rebalance churn)."""
        if self._agents_started:
            return
        self._agents_started = True
        for agent in (self.source, self.processor, self.sink):
            await agent.set_context(self.context)
            await agent.start()

    async def _close_agents(self) -> None:
        for agent in (self.sink, self.processor, self.source):
            try:
                await agent.close()
            except Exception:  # noqa: BLE001
                logger.exception("error closing %s", agent)

    def stop(self) -> None:
        """Request a graceful drain-and-exit."""
        self._stop.set()
        self._pending_low.set()  # wake a loop parked on backpressure

    def info(self) -> Dict[str, Any]:
        """``/info`` payload (reference: ``AgentInfoServlet`` +
        ``AgentAPIController`` aggregation)."""
        return {
            "agent-id": self.agent_id,
            "source": self.source.agent_info(),
            "processor": self.processor.agent_info(),
            "sink": self.sink.agent_info(),
            "stats": self.stats.snapshot(),
            "pending-records": self._pending,
        }

    # ------------------------------------------------------------------ #
    # the hot loop
    # ------------------------------------------------------------------ #
    async def _stats_dump_loop(self, interval: float = 30.0) -> None:
        """Periodic one-line stats dump (reference:
        ``AgentRunner.PendingRecordsCounterSource.dumpStats``,
        AgentRunner.java:598-618 — counts + memory every 30 s)."""
        import resource

        while True:
            await asyncio.sleep(interval)
            rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            snapshot = self.stats.snapshot()
            logger.info(
                "agent %s stats: in=%d out=%d errors=%d pending=%d "
                "rss=%.0fMB",
                self.agent_id, snapshot["records-in"],
                snapshot["records-out"], snapshot["errors"],
                self._pending, rss_kb / 1024,
            )

    async def run(self) -> None:
        await self.start_agents()
        stats_dump = asyncio.get_running_loop().create_task(
            self._stats_dump_loop()
        )
        result_worker = asyncio.get_running_loop().create_task(
            self._result_worker()
        )
        try:
            while not self._stop.is_set():
                if self._failure is not None:
                    raise self._failure
                # backpressure: cap in-flight records so a slow device step
                # doesn't buffer the whole topic in memory
                if self._pending >= self.max_pending_records:
                    self._pending_low.clear()
                    await self._pending_low.wait()
                    continue
                budget = self.max_pending_records - self._pending
                with self.tracer.span("source.read", agent=self.agent_id) as read_span:
                    batch = await self.source.read(max_records=budget)
                    if batch:
                        read_span.attributes["records"] = len(batch)
                if not batch:
                    continue
                self.stats.records_in += len(batch)
                self.metrics.counter("records_in").count(len(batch))
                self._pending += len(batch)
                # trace context: tag the dispatch span with the batch's
                # trace id (single-record batches — the gateway/chat hot
                # path — get exact attribution; bigger batches carry the
                # head's id plus the full list as an attribute)
                batch_ids = [
                    str(r.header(TRACE_ID_HEADER)) for r in batch
                    if r.header(TRACE_ID_HEADER)
                ]
                with self.tracer.span(
                    "processor.dispatch", agent=self.agent_id,
                    trace_id=batch_ids[0] if batch_ids else "",
                    records=len(batch),
                    trace_ids=",".join(batch_ids),
                ):
                    self.processor.process(batch, self._result_sink)
            await self._drain()
            if self._failure is not None:
                raise self._failure
        finally:
            stats_dump.cancel()
            result_worker.cancel()
            for task in (stats_dump, result_worker):
                try:
                    await task
                except asyncio.CancelledError:
                    pass
            # cancel any still-running per-record tasks BEFORE closing the
            # agents they write through
            for task in self._tasks:
                if not task.done():
                    task.cancel()
            for task in self._tasks:
                try:
                    await task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
            await self._close_agents()

    async def _drain(self) -> None:
        """Wait for in-flight records before closing (reference:
        ``waitForNoPendingRecords``, ≤60 s). Aborts immediately on a fatal
        failure — the error must propagate, not wait out the drain."""
        deadline = time.time() + self.drain_timeout
        while self._pending > 0 and time.time() < deadline:
            if self._failure is not None:
                return
            await asyncio.sleep(0.01)
        if self._pending > 0:
            logger.warning(
                "drain timeout with %d records still pending", self._pending
            )

    # ------------------------------------------------------------------ #
    # result handling (async, out-of-order)
    # ------------------------------------------------------------------ #
    async def _result_worker(self) -> None:
        while True:
            result = await self._result_sink.queue.get()
            # handle each result concurrently; per-source-record write order
            # is preserved inside _handle_result
            task = asyncio.get_running_loop().create_task(
                self._handle_result(result)
            )
            self._tasks.append(task)
            self._tasks = [t for t in self._tasks if not t.done()]

    def _record_done(self, source_record: Record) -> None:
        self._pending -= 1
        self._attempts.pop(id(source_record), None)
        if self._pending < self.max_pending_records:
            self._pending_low.set()

    async def _handle_result(self, result: SourceRecordAndResult) -> None:
        try:
            if result.error is not None:
                await self._handle_record_error(result.source_record, result.error)
                return
            trace_id = result.source_record.header(TRACE_ID_HEADER) or ""
            records_out = result.result_records
            if trace_id:
                # re-attach the trace id on emitted records so it
                # survives topic hops into downstream agents (processors
                # that rebuild records from scratch would drop it)
                records_out = [
                    record if record.header(TRACE_ID_HEADER)
                    else record.with_header(TRACE_ID_HEADER, trace_id)
                    for record in records_out
                ]
            try:
                with self.tracer.span(
                    "sink.write", trace_id=trace_id, agent=self.agent_id,
                    records=len(records_out),
                ):
                    for record in records_out:
                        await self.sink.write(record)
                        self.stats.records_out += 1
                        self.metrics.counter("records_out").count()
            except BaseException as error:  # noqa: BLE001
                await self._handle_record_error(result.source_record, error)
                return
            with self.tracer.span(
                "source.commit", trace_id=trace_id, agent=self.agent_id
            ):
                await self.source.commit([result.source_record])
            self._record_done(result.source_record)
        except BaseException as error:  # noqa: BLE001 — fatal
            self._failure = error
            self._stop.set()
            self._pending_low.set()

    async def _handle_record_error(
        self, source_record: Record, error: BaseException
    ) -> None:
        """Apply the error policy to one failed source record
        (reference: ``AgentRunner.java:796-889``)."""
        if isinstance(error, FatalAgentError):
            # the agent is gone (e.g. its isolated child process died):
            # retry would hit the same corpse, skip/dead-letter would
            # silently drop every record after it — fail the pod
            raise error
        self.stats.errors += 1
        self.metrics.counter("errors").count()
        attempts = self._attempts.get(id(source_record), 0) + 1
        self._attempts[id(source_record)] = attempts
        handler = StandardErrorsHandler(self.errors_spec)
        decision = handler.handle_error(attempts_for_record=attempts)
        if decision is ErrorHandlingDecision.RETRY:
            logger.info(
                "retrying record after error (attempt %d): %s", attempts, error
            )
            self.processor.process([source_record], self._result_sink)
            return
        if decision is ErrorHandlingDecision.SKIP:
            self.stats.skipped += 1
            await self.source.commit([source_record])
            self._record_done(source_record)
            return
        if decision is ErrorHandlingDecision.DEAD_LETTER:
            try:
                await self.source.permanent_failure(source_record, error)
            except BaseException:
                # no dead-letter support → fail (reference downgrade path)
                raise error
            self.stats.dead_lettered += 1
            await self.source.commit([source_record])
            self._record_done(source_record)
            return
        raise error
