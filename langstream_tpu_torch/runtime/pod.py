"""Pod entry points and the agent runner's HTTP surface.

The port's own copy of ``langstream_tpu/runtime/pod.py``:

- ``agent-runner`` (:func:`agent_runner_main`; the reference's
  ``AgentRunnerStarter.java:39``) reads the mounted
  ``pod-configuration.json`` (one execution-plan node, the app's
  resources, its ``streamingCluster`` and globals) and runs that node
  until SIGTERM or SIGINT, on the card unless the caller asks for the CPU,
  serving the HTTP surface below. Its agents reach the other pods through
  the broker the configuration names: a served ``tpulog`` or Kafka.
- ``application-setup`` (:func:`application_setup_main`;
  ``ApplicationSetupRunner.java:40``) creates the app's topics (or, with
  ``delete``, deletes those whose ``deletion-mode`` is ``delete``) and
  deploys its assets, from the Application document in
  ``$LANGSTREAM_APPLICATION``.

The HTTP surface (``AgentRunner.java:99-113``) runs on the port's asyncio
HTTP (the gateway's, ``gateway/server.py``; aiohttp is not among the
card machine's packages). Its routes:

- ``/info``: the runner's agents as JSON;
- ``/metrics``: Prometheus text of the runner's ``MetricsReporter`` (each
  agent node's ``records_in``, ``records_out`` and the rest, prefixed
  ``agent_<node id>_``) and, in a process that runs the engine, its
  gauges and histograms;
- ``/ready`` and ``/ok``: the probes (503 until :attr:`ready`);
- ``/debug/profile?seconds=N``: one ``runtime/tracing.capture`` while the
  agents run (400 on a bad duration, 409 while another capture runs);
- ``/debug/launches`` (the port's own, as the gateway's): the engines'
  model calls and each kernel's launches on the card.

``python -m langstream_tpu_torch apps run --http-port PORT`` serves it
beside an app too. The JAX module's ``code-download`` and ``deployer``
need the control plane's code storage and Kubernetes, and are not ported
(ROADMAP A7).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
import signal
from typing import Any, Callable, Dict, Optional, Set

from langstream_tpu_torch.api.errors import ErrorsSpec
from langstream_tpu_torch.api.metrics import prometheus_text
from langstream_tpu_torch.compiler.planner import AgentNode, AgentSpec, ExecutionPlan
from langstream_tpu_torch.gateway.server import (
    Response,
    json_response,
    launches_response,
    read_request,
    text_response,
    write_response,
)
from langstream_tpu_torch.model.application import Application, Instance, ResourcesSpec
from langstream_tpu_torch.runtime import tracing

logger = logging.getLogger(__name__)

AGENT_HTTP_PORT = 8080


class AgentHttpServer:
    """``/info`` (JSON), ``/metrics`` (Prometheus text), ``/ready`` and
    ``/ok`` (probes), ``/debug/profile``, ``/debug/launches``. ``port`` 0
    picks a free one;
    :attr:`port` holds it after :meth:`start`."""

    def __init__(
        self,
        *,
        info: Callable[[], Dict[str, Any]],
        metrics: Any = None,  # MetricsReporter
        gauges: Optional[Callable[[], Dict[str, float]]] = None,
        histograms: Optional[Callable[[], Dict[str, Any]]] = None,
        port: int = AGENT_HTTP_PORT,
        host: str = "0.0.0.0",
    ) -> None:
        self._info = info
        self._metrics = metrics
        self._gauges = gauges
        self._histograms = histograms
        self.port = port
        self.host = host
        self.ready = False
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections: Set[asyncio.Task] = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for task in list(self._connections):
            task.cancel()
        if self._connections:
            await asyncio.wait(list(self._connections), timeout=5.0)
        await self._server.wait_closed()
        self._server = None

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._connections.add(task)
        try:
            request = await read_request(reader)
            if request is None:
                return
            if request.method != "GET":
                response = text_response("method not allowed", 405)
            else:
                response = await self._dispatch(request.path, dict(request.query))
            await write_response(writer, response)
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.CancelledError):
            pass
        except Exception:  # noqa: BLE001 — one broken request must not stop the server
            logger.exception("agent http request failed")
        finally:
            self._connections.discard(task)
            writer.close()

    async def _dispatch(self, path: str, query: Dict[str, str]) -> Response:
        if path == "/info":
            return json_response(self._info())
        if path == "/metrics":
            return self._metrics_response()
        if path in ("/ready", "/ok"):
            return text_response("OK" if self.ready else "STARTING",
                                 200 if self.ready else 503)
        if path == "/debug/profile":
            return await self._profile(query)
        if path == "/debug/launches":
            return await launches_response()
        return text_response("404: Not Found", 404)

    def _metrics_response(self) -> Response:
        counters = self._metrics.snapshot() if self._metrics is not None else {}
        gauges = self._gauges() if self._gauges is not None else {}
        histograms: Dict[str, Any] = {}
        if self._metrics is not None:
            histograms.update(self._metrics.histogram_snapshots())
        if self._histograms is not None:
            histograms.update(self._histograms())
        return Response(200, prometheus_text(counters, gauges, histograms).encode("utf-8"),
                        "text/plain; charset=utf-8")

    async def _profile(self, query: Dict[str, str]) -> Response:
        """One profiler capture of ``?seconds=N`` (default 3), one at a
        time, off the event loop: the agents keep running meanwhile."""
        try:
            seconds = float(query.get("seconds", 3))
        except (TypeError, ValueError):
            return json_response({"error": "seconds must be a number"}, 400)
        try:
            path = await asyncio.to_thread(tracing.capture, seconds)
        except ValueError as error:
            return json_response({"error": str(error)}, 400)
        except tracing.ProfileBusyError as error:
            return json_response({"error": str(error)}, 409)
        return json_response({"path": path, "seconds": seconds})


# ---------------------------------------------------------------------- #
# pod configuration (the mounted Secret)
# ---------------------------------------------------------------------- #
def load_pod_configuration(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as handle:
        return json.load(handle)


def node_from_document(doc: Dict[str, Any]) -> AgentNode:
    """Rebuild an :class:`AgentNode` from its ``dataclasses.asdict`` form
    (the ``agentNode`` field the operator serializes into Agent CRs and
    pod Secrets)."""

    def spec(value: Optional[Dict[str, Any]]) -> Optional[AgentSpec]:
        if not value:
            return None
        return AgentSpec(
            agent_id=value["agent_id"],
            agent_type=value["agent_type"],
            configuration=value.get("configuration", {}) or {},
        )

    return AgentNode(
        id=doc["id"],
        pipeline=doc.get("pipeline", ""),
        module=doc.get("module", ""),
        source=spec(doc.get("source")),
        processors=[s for s in map(spec, doc.get("processors", [])) if s],
        sink=spec(doc.get("sink")),
        service=spec(doc.get("service")),
        input_topic=doc.get("input_topic"),
        output_topic=doc.get("output_topic"),
        errors=ErrorsSpec(**(doc.get("errors") or {})),
        resources=ResourcesSpec(**(doc.get("resources") or {})),
    )


def pod_configuration(plan: ExecutionPlan, node: AgentNode) -> Dict[str, Any]:
    """The ``pod-configuration.json`` of one plan node: the document
    :func:`agent_runner_main` reads (the JAX operator's Secret carries the
    same fields)."""
    application = plan.application
    return {
        "applicationId": application.application_id,
        "tenant": application.tenant,
        "agentNode": dataclasses.asdict(node),
        "resources": application.resources,
        "streamingCluster": application.instance.streaming_cluster,
        "globals": application.instance.globals_,
    }


def _application_for_pod(config: Dict[str, Any]) -> Application:
    """A minimal Application carrying what agents need at runtime:
    AI-provider resources, the streaming cluster, and resolved secrets
    (the pipeline/module structure stays behind in the control plane)."""
    app = Application(
        application_id=config.get("applicationId", "application"),
        tenant=config.get("tenant", "default"),
        resources=config.get("resources", {}) or {},
    )
    app.instance = Instance(
        streaming_cluster=config.get("streamingCluster") or {"type": "memory"},
        compute_cluster={"type": "local"},
        globals_=config.get("globals", {}) or {},
    )
    code_dir = os.environ.get("LANGSTREAM_CODE_DIR")
    if code_dir:
        python_dir = os.path.join(code_dir, "python")
        if os.path.isdir(python_dir):
            app.python_path = python_dir
        elif os.path.isdir(code_dir):
            app.python_path = code_dir
    return app


# ---------------------------------------------------------------------- #
# agent-runner
# ---------------------------------------------------------------------- #
async def agent_runner_main(
    config_path: str,
    *,
    http_port: int = AGENT_HTTP_PORT,
    device: Any = "cuda",
    stop_event: Optional[asyncio.Event] = None,
) -> None:
    """Run one execution-plan node until SIGTERM or SIGINT, serving the
    HTTP surface on ``http_port`` (``$LANGSTREAM_HTTP_PORT`` overrides it;
    0 picks a free one). The node's engines run on ``device``: the card
    unless the caller asks for the CPU; CUDA absent raises before any
    topic or agent exists. On the signal the runner stops: each consumer
    leaves its group, so a new runner of the same group takes its
    partitions at once, from the committed watermark.

    Reference: ``AgentRunnerStarter.java:39`` → ``AgentRunner.run``.
    """
    from langstream_tpu_torch.providers.torch_local.engine import (
        engines_histograms,
        engines_snapshot,
    )
    from langstream_tpu_torch.runtime import flight
    from langstream_tpu_torch.runtime.local import LocalApplicationRunner
    from langstream_tpu_torch.runtime.multihost import initialize_multihost

    http_port = int(os.environ.get("LANGSTREAM_HTTP_PORT", http_port))
    plugins_dir = os.environ.get("LANGSTREAM_PLUGINS_DIR")
    if plugins_dir:
        from langstream_tpu_torch.runtime.plugins import load_plugins

        load_plugins(plugins_dir)
    flight.configure_from_env()
    flight.record("phase", name="pod-start", config=config_path)
    # a replica spread over hosts joins its process group first; a no-op
    # for a replica on one host
    initialize_multihost()
    config = load_pod_configuration(config_path)
    node = node_from_document(config["agentNode"])
    # one pod = one replica; data parallelism is the StatefulSet's
    # replica count (all replicas share one consumer group)
    node = dataclasses.replace(
        node, resources=dataclasses.replace(node.resources, parallelism=1)
    )
    application = _application_for_pod(config)
    plan = ExecutionPlan(application=application, topics={}, agents=[node])
    state_dir = os.environ.get("LANGSTREAM_STATE_DIR")
    if state_dir:
        os.makedirs(state_dir, exist_ok=True)
    runner = LocalApplicationRunner(plan, state_directory=state_dir or None, device=device)
    http = AgentHttpServer(
        info=runner.info, metrics=runner.metrics, gauges=engines_snapshot,
        histograms=engines_histograms, port=http_port,
    )
    await http.start()
    logger.info("agent-runner %s serving /info,/metrics on :%d", node.id, http.port)
    print(f"agent-runner {node.id} on {runner.device}: http://{http.host}:{http.port}/metrics",
          flush=True)

    stop = stop_event or asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):  # not the main thread
            pass
    try:
        await runner.start()
        http.ready = True
        print(f"agent-runner {node.id} ready", flush=True)
        join = asyncio.ensure_future(runner.join())
        stop_task = asyncio.ensure_future(stop.wait())
        await asyncio.wait([join, stop_task], return_when=asyncio.FIRST_COMPLETED)
        for task in (join, stop_task):
            if not task.done():
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        if join.done() and not join.cancelled():
            join.result()  # propagate a crashed runner
    finally:
        http.ready = False
        await runner.stop()
        await http.stop()
        print(f"agent-runner {node.id} stopped", flush=True)


# ---------------------------------------------------------------------- #
# application-setup
# ---------------------------------------------------------------------- #
def application_document(application: Application) -> str:
    """The ``$LANGSTREAM_APPLICATION`` value of ``application``: the form
    :func:`_application_from_env` reads (the JAX deployer's Application
    CR spec)."""
    instance = {"streamingCluster": application.instance.streaming_cluster,
                "computeCluster": application.instance.compute_cluster,
                "globals": application.instance.globals_}
    return json.dumps({
        "application": json.dumps(dataclasses.asdict(application), default=str),
        "instance": json.dumps(instance), "applicationId": application.application_id,
        "tenant": application.tenant})


def _application_from_env() -> Application:
    """Parse the Application CR spec the setup Job receives in
    ``$LANGSTREAM_APPLICATION``: ``{"application": <definition>,
    "instance": <instance>, "applicationId", "tenant"}``, each of the two
    documents a mapping or its JSON text."""
    raw = os.environ.get("LANGSTREAM_APPLICATION")
    if not raw:
        raise SystemExit("LANGSTREAM_APPLICATION env var is required")
    spec = json.loads(raw)
    definition = spec.get("application")
    instance = spec.get("instance")
    if isinstance(definition, str):
        definition = json.loads(definition or "{}")
    if isinstance(instance, str):
        instance = json.loads(instance or "{}")
    application = Application.from_document(definition or {}, instance or {})
    if spec.get("applicationId"):
        application.application_id = spec["applicationId"]
    if spec.get("tenant"):
        application.tenant = spec["tenant"]
    return application


async def application_setup_main(*, delete: bool = False, device: Any = "cuda") -> None:
    """Create (or, with ``delete``, clean up) the application's topics on
    its streaming cluster, then deploy its assets on ``device``.

    Reference: ``ApplicationSetupRunner.java:40`` (runApplicationSetup:
    topics + assets; cleanup path on delete).
    """
    from langstream_tpu_torch.api.assets import deploy_assets
    from langstream_tpu_torch.compiler.planner import build_execution_plan
    from langstream_tpu_torch.topics import create_topic_runtime

    application = _application_from_env()
    plan = build_execution_plan(application)
    runtime = create_topic_runtime(application.instance.streaming_cluster)
    admin = runtime.create_admin()
    try:
        for spec in plan.topics.values():
            if delete:
                if spec.deletion_mode == "delete":
                    await admin.delete_topic(spec.name)
            elif spec.creation_mode == "create-if-not-exists":
                await admin.create_topic(spec)
                logger.info("topic %s ready", spec.name)
    finally:
        await admin.close()
        await runtime.close()
    if plan.assets and not delete:
        await deploy_assets(plan.assets, application.resources, device)
        logger.info("deployed %d assets", len(plan.assets))
