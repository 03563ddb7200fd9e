"""Single-process application runner.

Equivalent of the reference's runtime-tester "mini cluster"
(``langstream-runtime/langstream-runtime-tester/src/main/java/ai/langstream/runtime/tester/LocalApplicationRunner.java:56``
— deploy 123-143, executeAgentRunners 173) which powers ``langstream docker
run``: deploy an execution plan in one process — create topics, start one
:class:`AgentRunner` task per agent-node replica, share a single in-process
broker — and drain gracefully on stop.

This is also the integration-test harness for everything above it, mirroring
the reference's test strategy (``AbstractApplicationRunner.java:58``).

The port's own copy of ``langstream_tpu/runtime/local.py``. Every agent
of an app shares one service registry on ``device`` (one engine per
``torch-local`` resource), the card unless the caller passes
``device="cpu"``; without CUDA, building the runner raises. The device
reaches every agent in its context (``AgentContext.device``), so the
datasources an agent resolves (the vector store) live on it too. Asset provisioning and plugin directories are not ported: an
app that declares assets is refused before anything starts.
"""

from __future__ import annotations

import asyncio
import logging
import os
import tempfile
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.api.agent import AgentContext
from langstream_tpu_torch.api.errors import FailureAction
from langstream_tpu_torch.api.metrics import MetricsReporter
from langstream_tpu_torch.api.topics import TopicConnectionsRuntime
from langstream_tpu_torch.compiler.planner import AgentNode, ExecutionPlan
from langstream_tpu_torch.device import resolve_device
from langstream_tpu_torch.runtime.composite import CompositeAgentProcessor
from langstream_tpu_torch.runtime.registry import create_agent
from langstream_tpu_torch.runtime.runner import (
    AgentRunner,
    IdentityProcessor,
    NullSink,
    TopicConsumerSource,
    TopicProducerSink,
)
from langstream_tpu_torch.topics import create_topic_runtime

logger = logging.getLogger(__name__)


class LocalApplicationRunner:
    """Deploys and runs an :class:`ExecutionPlan` in-process."""

    def __init__(
        self,
        plan: ExecutionPlan,
        *,
        topic_runtime: Optional[TopicConnectionsRuntime] = None,
        state_directory: Optional[str] = None,
        tracer=None,
        device: Any = "cuda",
    ) -> None:
        from langstream_tpu_torch.runtime.tracing import get_tracer

        self.plan = plan
        # default to the process-wide runner tracer: a NOOP unless
        # LANGSTREAM_TRACE_DIR is set, in which case every pod/apps-run
        # leaves a Chrome-trace dump for `langstream-tpu trace` to merge
        self.tracer = tracer if tracer is not None else get_tracer("runner")
        self.application = plan.application
        self.topic_runtime = topic_runtime or create_topic_runtime(
            plan.application.instance.streaming_cluster
        )
        self.state_directory = state_directory or tempfile.mkdtemp(
            prefix="langstream-state-"
        )
        self.metrics = MetricsReporter()
        self.runners: List[Any] = []
        self._tasks: List[asyncio.Task] = []
        self._started = asyncio.Event()
        if plan.assets:
            raise ValueError(
                "assets (" + ", ".join(sorted(a.asset_type for a in plan.assets))
                + ") are not yet ported to langstream_tpu_torch"
            )
        # one provider registry per app: all agents share the same device
        # engines (one model, one KV cache pool per resource)
        from langstream_tpu_torch.providers.registry import ServiceProviderRegistry

        # the card unless the caller asks for the CPU: raise here, before
        # any topic or agent exists, when CUDA is missing
        self.device = resolve_device(device)
        self._service_provider_registry = ServiceProviderRegistry(
            self.application.resources, device=device
        )

    # ------------------------------------------------------------------ #
    # deploy (reference: ApplicationSetupRunner topics/assets setup)
    # ------------------------------------------------------------------ #
    async def setup(self) -> None:
        admin = self.topic_runtime.create_admin()
        for spec in self.plan.topics.values():
            if spec.creation_mode == "create-if-not-exists":
                await admin.create_topic(spec)
        await admin.close()

    def _make_context(self, node: AgentNode, replica: int) -> AgentContext:
        state_dir = os.path.join(self.state_directory, node.id, str(replica))
        os.makedirs(state_dir, exist_ok=True)
        return AgentContext(
            agent_id=node.id,
            application_id=self.application.application_id,
            tenant=self.application.tenant,
            topic_connections=self.topic_runtime,
            persistent_state_directory=state_dir,
            metrics=self.metrics.with_prefix(f"agent_{node.id.replace('-', '_')}"),
            global_agent_id=f"{self.application.application_id}-{node.id}",
            service_provider_registry=self._service_provider_registry,
            resources=self.application.resources,
            device=self.device,
        )

    async def _build_agent(self, spec, context: AgentContext):
        agent = create_agent(spec.agent_type)
        agent.agent_id = spec.agent_id
        configuration = spec.configuration
        await agent.init(configuration)
        return agent

    async def _build_runner(self, node: AgentNode, replica: int):
        context = self._make_context(node, replica)
        if node.service is not None:
            raise ValueError(
                f"agent {node.id!r} is a service ({node.service.agent_type!r}); service "
                "agents are not yet ported to langstream_tpu_torch"
            )

        # source
        if node.source is not None:
            source = await self._build_agent(node.source, context)
        else:
            assert node.input_topic is not None
            group = f"{self.application.application_id}-{node.id}"
            consumer = self.topic_runtime.create_consumer(
                node.id, {"topic": node.input_topic, "group": group}
            )
            deadletter = None
            if node.errors.resolved_action() is FailureAction.DEAD_LETTER:
                deadletter = self.topic_runtime.create_deadletter_producer(
                    node.id, {"topic": node.input_topic}
                )
            source = TopicConsumerSource(consumer, deadletter)

        # processor chain
        processors = []
        for spec in node.processors:
            processors.append(await self._build_agent(spec, context))
        if not processors:
            processor = IdentityProcessor()
        elif len(processors) == 1:
            processor = processors[0]
        else:
            processor = CompositeAgentProcessor(processors)
            processor.agent_id = node.id

        # sink
        if node.sink is not None:
            sink = await self._build_agent(node.sink, context)
        elif node.output_topic is not None:
            producer_config: Dict[str, Any] = {"topic": node.output_topic}
            topic_spec = self.plan.topics.get(node.output_topic)
            if topic_spec is not None and topic_spec.schema:
                # declared topic schema flows to the producer (avro
                # interop on schema-aware runtimes)
                producer_config["schema"] = topic_spec.schema
            producer = self.topic_runtime.create_producer(
                node.id, producer_config
            )
            sink = TopicProducerSink(producer)
        else:
            sink = NullSink()

        return AgentRunner(
            agent_id=f"{node.id}-{replica}" if node.resources.parallelism > 1 else node.id,
            source=source,
            processor=processor,
            sink=sink,
            errors=node.errors,
            context=context,
            metrics=context.metrics,
            tracer=self.tracer,
        )

    # ------------------------------------------------------------------ #
    # run lifecycle
    # ------------------------------------------------------------------ #
    async def start(self) -> None:
        """Setup topics and launch every node replica
        (reference: ``executeAgentRunners``, LocalApplicationRunner.java:173)."""
        await self.setup()
        loop = asyncio.get_running_loop()
        for node in self.plan.agents:
            for replica in range(max(1, node.resources.parallelism)):
                runner = await self._build_runner(node, replica)
                self.runners.append(runner)
        # bring every replica's agents (and consumer-group membership) up
        # BEFORE any loop runs — and CONCURRENTLY, so all members of a
        # group land in one rebalance generation (a sequential bring-up
        # makes each later member wait out a full rebalance window while
        # the earlier ones aren't polling yet). On any failure, close
        # everything that DID start: a leaked consumer's heartbeat task
        # would hold its group membership (and partitions) alive forever
        results = await asyncio.gather(
            *[
                runner.start_agents()
                for runner in self.runners
                if hasattr(runner, "start_agents")
            ],
            return_exceptions=True,
        )
        failure = next(
            (r for r in results if isinstance(r, BaseException)), None
        )
        if failure is not None:
            for runner in self.runners:
                if not hasattr(runner, "_close_agents"):
                    continue
                try:
                    await runner._close_agents()  # noqa: SLF001
                except Exception:  # noqa: BLE001
                    logger.exception("cleanup after failed start")
            await self._service_provider_registry.close()
            await self.topic_runtime.close()
            raise failure
        for runner in self.runners:
            task = loop.create_task(runner.run())
            # surface a crashed runner the moment it dies: without this
            # the failure sits unretrieved until stop()/join(), and a
            # gateway client whose pipeline just vanished hangs with no
            # log line anywhere (seen: an over-long prompt rejected by
            # the engine under the default fail policy)
            task.add_done_callback(self._log_runner_exit)
            self._tasks.append(task)
        self._started.set()

    @staticmethod
    def _log_runner_exit(task: "asyncio.Task") -> None:
        if task.cancelled():
            return
        error = task.exception()
        if error is not None:
            logger.error(
                "agent runner crashed — records in flight are lost and "
                "gateway consumers of its topics will stall",
                exc_info=error,
            )

    async def stop(self, timeout: float = 30.0) -> None:
        for runner in self.runners:
            runner.stop()
        failure = None
        if self._tasks:
            done, pending = await asyncio.wait(self._tasks, timeout=timeout)
            for task in pending:
                task.cancel()
            for task in done:
                error = task.exception()
                if error is not None and failure is None:
                    failure = error
        # always release engines/brokers, even when a runner died — the
        # engine thread and device HBM must not outlive the app
        await self._service_provider_registry.close()
        await self.topic_runtime.close()
        if failure is not None:
            raise failure

    async def join(self) -> None:
        """Wait until any runner fails (propagates) or all complete."""
        if not self._tasks:
            return
        done, _pending = await asyncio.wait(
            self._tasks, return_when=asyncio.FIRST_EXCEPTION
        )
        for task in done:
            error = task.exception()
            if error is not None:
                raise error

    def info(self) -> Dict[str, Any]:
        return {
            "application-id": self.application.application_id,
            "agents": [
                runner.info() if hasattr(runner, "info") else {"agent-id": runner.agent_id}
                for runner in self.runners
            ],
            "topics": sorted(self.plan.topics),
        }

    # convenience for tests & the gateway
    def producer(self, topic: str):
        return self.topic_runtime.create_producer("external", {"topic": topic})

    def reader(self, topic: str, position=None):
        from langstream_tpu_torch.api.topics import OffsetPosition

        return self.topic_runtime.create_reader(
            {"topic": topic}, position or OffsetPosition.EARLIEST
        )


async def run_application(
    app_dir: str,
    *,
    instance_file: Optional[str] = None,
    secrets_file: Optional[str] = None,
    tracer=None,
    device: Any = "cuda",
) -> LocalApplicationRunner:
    """Parse, plan, and start an application directory (the ``docker run``
    path, ``langstream-cli/.../docker/LocalRunApplicationCmd.java:56``) on
    ``device``: the card unless the caller passes ``device="cpu"``."""
    from langstream_tpu_torch.compiler import build_application, build_execution_plan

    application = build_application(
        app_dir, instance_file=instance_file, secrets_file=secrets_file
    )
    plan = build_execution_plan(application)
    runner = LocalApplicationRunner(plan, tracer=tracer, device=device)
    await runner.start()
    return runner
