"""The agent runner's HTTP surface.

The port's own copy of ``AgentHttpServer`` from
``langstream_tpu/runtime/pod.py`` (the reference's ``AgentRunner.java:99-113``),
on the port's asyncio HTTP (the gateway's, ``gateway/server.py``), not
aiohttp, which the card's machine lacks:

- ``/info``: the runner's agents as JSON;
- ``/metrics``: Prometheus text of the runner's ``MetricsReporter`` (each
  agent node's ``records_in``, ``records_out`` and the rest, prefixed
  ``agent_<node id>_``) and, in a process that runs the engine, its
  gauges and histograms;
- ``/ready`` and ``/ok``: the probes (503 until :attr:`ready`);
- ``/debug/profile?seconds=N``: one ``runtime/tracing.capture`` while the
  agents run (400 on a bad duration, 409 while another capture runs).

``python -m langstream_tpu_torch apps run --http-port PORT`` serves it
beside the app. The rest of the JAX module (the pod entry that reads its
node from the environment or a config file, the code download) is not
yet ported.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable, Dict, Optional, Set

from langstream_tpu_torch.api.metrics import prometheus_text
from langstream_tpu_torch.gateway.server import (
    Response,
    json_response,
    read_request,
    text_response,
    write_response,
)
from langstream_tpu_torch.runtime import tracing

logger = logging.getLogger(__name__)

AGENT_HTTP_PORT = 8080


class AgentHttpServer:
    """``/info`` (JSON), ``/metrics`` (Prometheus text), ``/ready`` and
    ``/ok`` (probes), ``/debug/profile``. ``port`` 0 picks a free one;
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
