"""The gateway server: WS produce/consume/chat + HTTP produce/service.

The port's own copy of ``langstream_tpu/gateway/server.py``, on
``asyncio`` streams (HTTP/1.1 parsed here, one request a connection) and
the port's own WebSockets (``gateway/websocket.py``) instead of aiohttp,
which the card's machine lacks. Endpoint and wire parity with the JAX
gateway and the reference:

- WS ``/v1/{produce|consume|chat}/{tenant}/{application}/{gateway}``
  (``websocket/WebSocketConfig.java:46-48``); query args use the
  reference's conventions (``GatewayRequestHandler.java:105-116``):
  ``param:<name>=...`` for declared gateway parameters,
  ``option:<name>=...`` for options (e.g. ``option:position=earliest``),
  ``credentials=...`` / ``test-credentials=...`` for auth.
- Produce frames are ``{"key", "value", "headers"}``
  (``api/ProduceRequest.java:20``); consume pushes are
  ``{"record": {...}, "offset": "..."}`` (``api/ConsumePushMessage.java:20``).
- HTTP ``POST /api/gateways/produce/{tenant}/{app}/{gateway}`` and the
  ``service`` gateway ``/api/gateways/service/...`` topic round-trip
  correlated by ``langstream-service-request-id``
  (``http/GatewayResource.java:74-96,156-190``).
- Gateway lifecycle events (ClientConnected/Disconnected) go to the
  configured events-topic (``events/EventRecord.java:13-29``).
- ``/healthz``, and ``/metrics`` with the gateway's counters and, in a
  process that runs the engine (``apps run``), the engine's gauges and
  histograms (``engines_snapshot``, ``engines_histograms``).
- ``/debug/launches`` (the port's own): the engines' model calls by
  function and CUDA graphs captured by kind
  (``engines_dispatches``), and each kernel's launches on the card since
  its library loaded (``ops/launches.py``). Reading the card's counters
  waits for the device: a debugging read, for a check around a burst,
  not for a periodic scraper (a wait while an engine captures a graph
  would break the capture).

Not ported: gateway authentication (``gateway/auth.py``: a gateway that
declares ``authentication`` is refused when its app registers), the UI,
the service gateway's proxy to an agent service (``service-url``,
``agent-id``), and the fleet router's replica affinity.
"""

from __future__ import annotations

import asyncio
import json
import logging
import sys
import time
import urllib.parse
import uuid
from typing import Any, Dict, List, Optional, Set, Tuple

from langstream_tpu_torch.api.metrics import MetricsReporter, prometheus_text
from langstream_tpu_torch.api.records import Record, now_millis
from langstream_tpu_torch.api.topics import OffsetPosition
from langstream_tpu_torch.gateway import websocket
from langstream_tpu_torch.model.application import Application, Gateway
from langstream_tpu_torch.runtime.tracing import TRACE_ID_HEADER, get_tracer, new_trace_id

logger = logging.getLogger(__name__)

_REASONS = {200: "OK", 400: "Bad Request", 401: "Unauthorized", 404: "Not Found",
            405: "Method Not Allowed", 409: "Conflict", 500: "Internal Server Error",
            503: "Service Unavailable", 504: "Gateway Timeout"}
_ENGINE_MODULE = "langstream_tpu_torch.providers.torch_local.engine"


class GatewayError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status


class Principal:
    """Who a request speaks for: without authentication, the subject is
    the ``credentials`` the client passed (the JAX gateway's)."""

    def __init__(self, subject: str) -> None:
        self.subject = subject

    def get(self, field: str) -> Any:
        return self.subject if field == "subject" else None


class Request:
    """One parsed HTTP request."""

    def __init__(self, method: str, path: str, query: List[Tuple[str, str]],
                 headers: Dict[str, str], body: bytes) -> None:
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.match_info: Dict[str, str] = {}

    def text(self) -> str:
        return self.body.decode("utf-8")


class Response:
    def __init__(self, status: int, body: bytes, content_type: str) -> None:
        self.status = status
        self.body = body
        self.content_type = content_type


def json_response(value: Any, status: int = 200) -> Response:
    return Response(status, json.dumps(value).encode("utf-8"), "application/json; charset=utf-8")


def text_response(text: str, status: int = 200) -> Response:
    return Response(status, text.encode("utf-8"), "text/plain; charset=utf-8")


async def read_request(reader: asyncio.StreamReader) -> Optional[Request]:
    """One HTTP/1.1 request off ``reader``; None for a malformed start line."""
    start, headers = await websocket.read_head(reader)
    fields = start.split(" ")
    if len(fields) != 3:
        return None
    method, target, _version = fields
    length = int(headers.get("content-length", "0") or 0)
    body = await reader.readexactly(length) if length else b""
    split = urllib.parse.urlsplit(target)
    return Request(method, urllib.parse.unquote(split.path),
                   urllib.parse.parse_qsl(split.query, keep_blank_values=True), headers, body)


async def write_response(writer: asyncio.StreamWriter, response: Response) -> None:
    """``response`` as the one answer of the connection."""
    writer.write((
        f"HTTP/1.1 {response.status} {_REASONS.get(response.status, 'Error')}\r\n"
        f"Content-Type: {response.content_type}\r\n"
        f"Content-Length: {len(response.body)}\r\nConnection: close\r\n\r\n"
    ).encode("latin-1") + response.body)
    await writer.drain()


async def launches_response() -> Response:
    """``/debug/launches``: this process's engines' model calls and graphs
    captured (``engines_dispatches``), and each kernel's launches on the
    card since its library loaded (``ops/launches.py``)."""
    engine_module = sys.modules.get(_ENGINE_MODULE)
    out: Dict[str, Any] = {"model_calls": {}, "graphs_captured": {}}
    if engine_module is not None:
        out.update(engine_module.engines_dispatches())
    from langstream_tpu_torch.ops import launches

    # off the event loop: the read waits for the card
    out["launches"] = await asyncio.get_running_loop().run_in_executor(
        None, lambda: launches.read(shapes=True))
    return json_response(out)


class _RegisteredApp:
    def __init__(self, application: Application, topic_runtime) -> None:
        self.application = application
        self.topic_runtime = topic_runtime
        self.producers: Dict[str, Any] = {}

    async def producer(self, topic: str):
        producer = self.producers.get(topic)
        if producer is None:
            producer = self.topic_runtime.create_producer("gateway", {"topic": topic})
            await producer.start()
            self.producers[topic] = producer
        return producer


class GatewayServer:
    """Serves every registered application's gateways on one port
    (``port`` 0 picks a free one; :attr:`port` holds it after
    :meth:`start`)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8091) -> None:
        self.host = host
        self.port = port
        self._apps: Dict[Tuple[str, str], _RegisteredApp] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        # every open connection's handler task: stop() cancels them, so a
        # client still connected never keeps the process alive
        self._connections: Set[asyncio.Task] = set()
        self.tracer = get_tracer("gateway")
        self.metrics = MetricsReporter(prefix="gateway")

    # ------------------------------------------------------------------ #
    # registration / lifecycle
    # ------------------------------------------------------------------ #
    def register(self, tenant: str, application: Application, topic_runtime) -> None:
        for gateway in application.gateways:
            if gateway.authentication:
                raise ValueError(
                    f"gateway {gateway.id!r} declares authentication, which is not yet "
                    "ported to langstream_tpu_torch (ROADMAP A7.2)"
                )
        self._apps[(tenant, application.application_id)] = _RegisteredApp(
            application, topic_runtime
        )

    def register_local_runner(self, local_runner, tenant: str = "default") -> None:
        self.register(tenant, local_runner.application, local_runner.topic_runtime)

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("gateway listening on %s:%d", self.host, self.port)

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

    # ------------------------------------------------------------------ #
    # HTTP
    # ------------------------------------------------------------------ #
    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._connections.add(task)
        try:
            request = await read_request(reader)
            if request is None:
                return
            response = await self._dispatch(request, reader, writer)
            if response is not None:
                await write_response(writer, response)
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.CancelledError):
            pass
        except Exception:  # noqa: BLE001 — one broken request must not stop the server
            logger.exception("gateway request failed")
        finally:
            self._connections.discard(task)
            writer.close()

    async def _dispatch(self, request: Request, reader, writer) -> Optional[Response]:
        parts = [p for p in request.path.split("/") if p]
        if request.path == "/healthz":
            return json_response({"status": "OK", "apps": len(self._apps)})
        if request.path == "/metrics":
            return self._metrics()
        if request.path == "/debug/launches":
            return await launches_response()
        if len(parts) == 5 and parts[0] == "v1" and parts[1] in ("produce", "consume", "chat"):
            request.match_info = dict(zip(("tenant", "application", "gateway"), parts[2:]))
            if request.method != "GET":
                return text_response("method not allowed", 405)
            handler = {"produce": self._ws_produce, "consume": self._ws_consume,
                       "chat": self._ws_chat}[parts[1]]
            return await handler(request, reader, writer)
        if (len(parts) == 6 and parts[:2] == ["api", "gateways"]
                and parts[2] in ("produce", "service")):
            request.match_info = dict(zip(("tenant", "application", "gateway"), parts[3:]))
            if request.method != "POST":
                return text_response("method not allowed", 405)
            if parts[2] == "produce":
                return await self._http_produce(request)
            return await self._http_service(request)
        return text_response("404: Not Found", 404)

    def _metrics(self) -> Response:
        gauges = {"gateway_registered_apps": float(len(self._apps))}
        histograms = dict(self.metrics.histogram_snapshots())
        # `apps run` hosts the gateway in the SAME process as the engine:
        # its gauges and histograms are served here too. Lazy through
        # sys.modules — a gateway-only process never imports the engine
        engine_module = sys.modules.get(_ENGINE_MODULE)
        if engine_module is not None:
            gauges.update(engine_module.engines_snapshot())
            histograms.update(engine_module.engines_histograms())
        return Response(200, prometheus_text(self.metrics.snapshot(), gauges,
                                             histograms).encode("utf-8"),
                        "text/plain; charset=utf-8")

    # ------------------------------------------------------------------ #
    # request validation (GatewayRequestHandler.validateRequest parity)
    # ------------------------------------------------------------------ #
    def _resolve(
        self, request: Request, expected_type: str
    ) -> Tuple[_RegisteredApp, Gateway, Dict[str, str], Dict[str, str], Optional[str]]:
        tenant = request.match_info["tenant"]
        application_id = request.match_info["application"]
        gateway_id = request.match_info["gateway"]
        registered = self._apps.get((tenant, application_id))
        if registered is None:
            raise GatewayError(404, f"unknown application {tenant}/{application_id}")
        gateway = next((g for g in registered.application.gateways if g.id == gateway_id), None)
        if gateway is None:
            raise GatewayError(404, f"unknown gateway {gateway_id!r}")
        if gateway.type != expected_type:
            raise GatewayError(
                400,
                f"gateway {gateway_id!r} is of type {gateway.type!r}, "
                f"expected {expected_type!r}",
            )
        options: Dict[str, str] = {}
        parameters: Dict[str, str] = {}
        credentials: Optional[str] = None
        for key, value in request.query:
            if key in ("credentials", "test-credentials"):
                credentials = value
            elif key.startswith("option:"):
                options[key[len("option:"):]] = value
            elif key.startswith("param:"):
                parameters[key[len("param:"):]] = value
            else:
                raise GatewayError(
                    400,
                    f"invalid query parameter {key!r}. To specify a gateway "
                    "parameter, use the format param:<parameter_name>. "
                    "To specify an option, use the format option:<option_name>.",
                )
        required = set(gateway.parameters) | self._referenced_parameters(gateway)
        for name in sorted(required):
            if not parameters.get(name):
                raise GatewayError(
                    400,
                    f"missing required parameter {name!r}. "
                    f"Required parameters: {sorted(required)}",
                )
        unknown = set(parameters) - required
        if unknown:
            raise GatewayError(400, f"unknown parameters: {sorted(unknown)}")
        return registered, gateway, parameters, options, credentials

    @staticmethod
    def _referenced_parameters(gateway: Gateway) -> set:
        names = set()
        for options in (
            gateway.produce_options,
            gateway.consume_options.get("filters", {}),
            gateway.chat_options,
        ):
            for header in options.get("headers", []) or []:
                name = header.get("value-from-parameters")
                if name:
                    names.add(name)
        return names

    @staticmethod
    def _principal(credentials: Optional[str]) -> Optional[Principal]:
        return Principal(credentials) if credentials else None

    @staticmethod
    def _resolve_headers(
        entries: List[Dict[str, Any]],
        parameters: Dict[str, str],
        principal: Optional[Principal],
    ) -> List[Tuple[str, str]]:
        """Resolve configured gateway headers: literal ``value``,
        ``value-from-parameters`` or ``value-from-authentication``. Entries
        without a ``key`` default to the client-session header (the shape
        used by chat-options in the reference examples)."""
        out = []
        for entry in entries or []:
            key = entry.get("key", "langstream-client-session-id")
            if "value" in entry:
                value = entry["value"]
            elif "value-from-parameters" in entry:
                value = parameters.get(entry["value-from-parameters"], "")
            elif "value-from-authentication" in entry:
                if principal is None:
                    raise GatewayError(401, "authentication required for header")
                value = principal.get(entry["value-from-authentication"])
            else:
                value = ""
            out.append((key, str(value) if value is not None else ""))
        return out

    async def _emit_event(
        self, registered: _RegisteredApp, gateway: Gateway, event_type: str,
        parameters: Dict[str, str],
    ) -> None:
        topic = gateway.events_topic
        if not topic:
            return
        producer = await registered.producer(topic)
        await producer.write(
            Record(
                value={
                    "type": event_type,
                    "timestamp": now_millis(),
                    "source": {"gateway": gateway.id, "type": gateway.type},
                    "data": {"user-parameters": parameters},
                }
            )
        )

    # ------------------------------------------------------------------ #
    # produce
    # ------------------------------------------------------------------ #
    @staticmethod
    def _parse_produce(payload: str) -> Tuple[Any, Any, List[Tuple[str, str]]]:
        try:
            body = json.loads(payload)
        except json.JSONDecodeError as error:
            raise GatewayError(400, f"invalid JSON: {error}") from error
        if not isinstance(body, dict):
            raise GatewayError(400, "produce payload must be a JSON object")
        headers = [
            (str(k), str(v)) for k, v in (body.get("headers") or {}).items()
        ]
        return body.get("key"), body.get("value"), headers

    @staticmethod
    def _stamp_trace(
        headers: Tuple[Tuple[str, str], ...]
    ) -> Tuple[Tuple[Tuple[str, str], ...], str]:
        """Ensure a ``langstream-trace-id`` header: keep a client-supplied
        one (cross-system traces), mint one otherwise. Every ingress path
        stamps here so one id follows the request through every topic
        hop, runner span, and engine span."""
        for key, value in headers:
            if key == TRACE_ID_HEADER and value:
                return headers, str(value)
        trace_id = new_trace_id()
        return headers + ((TRACE_ID_HEADER, trace_id),), trace_id

    async def _do_produce(
        self, registered, gateway, parameters, principal, payload: str
    ) -> None:
        key, value, user_headers = self._parse_produce(payload)
        gateway_headers = self._resolve_headers(
            gateway.produce_options.get("headers"), parameters, principal
        )
        headers, trace_id = self._stamp_trace(tuple(user_headers) + tuple(gateway_headers))
        with self.tracer.span(
            "gateway.produce", trace_id=trace_id,
            gateway=gateway.id, topic=gateway.topic,
        ):
            await (await registered.producer(gateway.topic)).write(
                Record(value=value, key=key, headers=headers)
            )
        self.metrics.counter("records_produced").count()

    async def _upgrade(self, request: Request, reader, writer, expected_type: str,
                       statuses: bool = False):
        """Validate, then upgrade. A refusal answers 400 (``statuses``:
        the error's own status, as the JAX gateway's produce route)."""
        try:
            resolved = self._resolve(request, expected_type)
        except GatewayError as error:
            return None, text_response(str(error), error.status if statuses else 400)
        try:
            ws = await websocket.server_handshake(reader, writer, request.headers)
        except websocket.WebSocketError as error:
            return None, text_response(str(error), 400)
        return (ws, *resolved), None

    async def _ws_produce(self, request: Request, reader, writer) -> Optional[Response]:
        upgraded, refusal = await self._upgrade(request, reader, writer, "produce", statuses=True)
        if refusal is not None:
            return refusal
        ws, registered, gateway, parameters, _options, credentials = upgraded
        principal = self._principal(credentials)
        await self._emit_event(registered, gateway, "ClientConnected", parameters)
        try:
            async for message in ws:
                if message.type != "text":
                    continue
                try:
                    await self._do_produce(
                        registered, gateway, parameters, principal, message.data
                    )
                    await ws.send_json({"status": "OK"})
                except GatewayError as error:
                    await ws.send_json({"status": "BAD_REQUEST", "reason": str(error)})
        finally:
            await self._emit_event(registered, gateway, "ClientDisconnected", parameters)
            await ws.close(websocket.GOING_AWAY)
        return None

    async def _http_produce(self, request: Request) -> Response:
        try:
            registered, gateway, parameters, _options, credentials = self._resolve(
                request, "produce"
            )
            await self._do_produce(
                registered, gateway, parameters, self._principal(credentials), request.text()
            )
        except GatewayError as error:
            return json_response({"status": "ERROR", "reason": str(error)}, status=error.status)
        return json_response({"status": "OK"})

    # ------------------------------------------------------------------ #
    # consume
    # ------------------------------------------------------------------ #
    @staticmethod
    def _record_to_json(record: Record) -> Dict[str, Any]:
        value = record.value
        if isinstance(value, bytes):
            value = value.decode("utf-8", errors="replace")
        offset = ""
        partition = getattr(record, "partition", None)
        if partition is not None:
            offset = f"{partition}-{getattr(record, 'offset', '')}"
        return {
            "record": {
                "key": record.key,
                "value": value,
                "headers": {str(k): str(v) for k, v in record.headers},
            },
            "offset": offset,
        }

    @staticmethod
    def _matches(record: Record, filters: List[Tuple[str, str]]) -> bool:
        return all(str(record.header(k)) == v for k, v in filters)

    async def _consume_loop(
        self, ws, registered, topic: str, filters, position: OffsetPosition
    ) -> None:
        reader = registered.topic_runtime.create_reader({"topic": topic}, position)
        await reader.start()
        try:
            while not ws.closed:
                batch = await reader.read(timeout=0.2)
                for record in batch:
                    if self._matches(record, filters):
                        await ws.send_json(self._record_to_json(record))
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            await reader.close()

    async def _ws_consume(self, request: Request, reader, writer) -> Optional[Response]:
        upgraded, refusal = await self._upgrade(request, reader, writer, "consume")
        if refusal is not None:
            return refusal
        ws, registered, gateway, parameters, options, credentials = upgraded
        position = OffsetPosition.LATEST
        if options.get("position") == "earliest":
            position = OffsetPosition.EARLIEST
        filters = self._resolve_headers(
            gateway.consume_options.get("filters", {}).get("headers"), parameters,
            self._principal(credentials))
        await self._emit_event(registered, gateway, "ClientConnected", parameters)
        consume_task = asyncio.ensure_future(
            self._consume_loop(ws, registered, gateway.topic, filters, position)
        )
        try:
            async for _message in ws:
                # client offset acks are accepted and ignored (the reader is
                # positional; reconnect with option:position to replay)
                continue
        finally:
            consume_task.cancel()
            await self._emit_event(registered, gateway, "ClientDisconnected", parameters)
            await ws.close(websocket.GOING_AWAY)
        return None

    # ------------------------------------------------------------------ #
    # chat (produce + filtered consume on one socket; ChatHandler.java:42)
    # ------------------------------------------------------------------ #
    async def _ws_chat(self, request: Request, reader, writer) -> Optional[Response]:
        try:
            registered, gateway, parameters, _options, credentials = self._resolve(request, "chat")
        except GatewayError as error:
            return text_response(str(error), 400)
        chat = gateway.chat_options
        questions_topic = chat.get("questions-topic")
        answers_topic = chat.get("answers-topic")
        if not questions_topic or not answers_topic:
            return text_response(
                "chat gateway requires chat-options.questions-topic and answers-topic", 400)
        headers = self._resolve_headers(chat.get("headers"), parameters,
                                        self._principal(credentials))
        try:
            ws = await websocket.server_handshake(reader, writer, request.headers)
        except websocket.WebSocketError as error:
            return text_response(str(error), 400)
        await self._emit_event(registered, gateway, "ClientConnected", parameters)
        consume_task = asyncio.ensure_future(
            self._consume_loop(ws, registered, answers_topic, headers, OffsetPosition.LATEST)
        )
        try:
            async for message in ws:
                if message.type != "text":
                    continue
                try:
                    key, value, user_headers = self._parse_produce(message.data)
                    chat_headers, trace_id = self._stamp_trace(
                        tuple(user_headers) + tuple(headers)
                    )
                    with self.tracer.span(
                        "gateway.chat.produce", trace_id=trace_id,
                        gateway=gateway.id, topic=questions_topic,
                    ):
                        await (await registered.producer(questions_topic)).write(
                            Record(value=value, key=key, headers=chat_headers)
                        )
                    self.metrics.counter("records_produced").count()
                except GatewayError as error:
                    await ws.send_json({"status": "BAD_REQUEST", "reason": str(error)})
        finally:
            consume_task.cancel()
            await self._emit_event(registered, gateway, "ClientDisconnected", parameters)
            await ws.close(websocket.GOING_AWAY)
        return None

    # ------------------------------------------------------------------ #
    # service gateway (topic round-trip; GatewayResource.java:156-190)
    # ------------------------------------------------------------------ #
    async def _http_service(self, request: Request) -> Response:
        try:
            registered, gateway, _parameters, _options, _credentials = self._resolve(
                request, "service"
            )
        except GatewayError as error:
            return json_response({"status": "ERROR", "reason": str(error)}, status=error.status)
        service = gateway.service_options
        if service.get("service-url") or service.get("agent-id"):
            return json_response(
                {"status": "ERROR", "reason": "the service gateway's proxy to an agent service "
                                              "is not yet ported to langstream_tpu_torch "
                                              "(ROADMAP A7.2)"},
                status=400,
            )
        input_topic = service.get("input-topic")
        output_topic = service.get("output-topic")
        if not input_topic or not output_topic:
            return json_response(
                {"status": "ERROR", "reason": "service gateway needs input/output topics"},
                status=400,
            )
        request_id = uuid.uuid4().hex
        reader = registered.topic_runtime.create_reader(
            {"topic": output_topic}, OffsetPosition.LATEST
        )
        await reader.start()
        try:
            try:
                key, value, user_headers = self._parse_produce(request.text())
            except GatewayError as error:
                return json_response({"status": "ERROR", "reason": str(error)},
                                     status=error.status)
            service_headers, trace_id = self._stamp_trace(
                tuple(user_headers) + (("langstream-service-request-id", request_id),)
            )
            with self.tracer.span(
                "gateway.service.produce", trace_id=trace_id,
                gateway=gateway.id, topic=input_topic,
            ):
                await (await registered.producer(input_topic)).write(
                    Record(value=value, key=key, headers=service_headers)
                )
            self.metrics.counter("service_requests").count()
            deadline = time.monotonic() + float(service.get("timeout-seconds", 30))
            while time.monotonic() < deadline:
                for record in await reader.read(timeout=0.2):
                    if record.header("langstream-service-request-id") == request_id:
                        return json_response(self._record_to_json(record))
        finally:
            await reader.close()
        return json_response(
            {"status": "ERROR", "reason": "timed out waiting for the response"},
            status=504,
        )
