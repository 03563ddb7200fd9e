"""``camel-source``: Apache Camel endpoint URIs mapped onto native
sources.

Reference: ``langstream-agent-camel/src/main/java/ai/langstream/agents/
camel/CamelSource.java:171-232`` — a generic connector escape hatch that
consumes any Camel ``component-uri`` and turns exchanges into records
(body → value, exchange headers → headers, ``key-header`` names the
header used as the record key).

The TPU build has no JVM, so the full Camel component zoo cannot run
in-process. Instead the URI is dispatched through a **scheme registry**
(:data:`CAMEL_SCHEMES`, extensible via :func:`register_camel_scheme` —
plugin packages can map additional component families) and the COMMON
component URIs are executed natively by delegating to the framework's
own sources, keeping pipeline definitions portable as-is:

- ``timer:name?period=1000&repeatCount=N`` — periodic records with
  Camel's ``timer``/``firedTime`` headers;
- ``file:/dir?delete=true&fileExtensions=txt`` — directory source
  (delegates to :class:`agents.storage.FileSource`);
- ``http://…`` / ``https://…?delay=500`` — polling HTTP consumer;
- ``kafka:topic?brokers=host:port&groupId=g`` — consumes a Kafka topic
  through the framework's own wire-protocol client (Camel's kafka
  component options ``brokers``/``groupId``/``autoOffsetReset``);
- ``netty-http:http://bind:port/path`` — embedded HTTP *server*
  consumer (Camel's netty-http in ``from()`` position listens): every
  incoming request becomes a record;
- ``aws2-s3://bucket?accessKey=…&deleteAfterRead=false`` — S3 object
  polling via the native SigV4 client (``agents/storage.S3Source``);
- ``azure-storage-blob://account/container?accessKey=…`` — Azure blob
  polling via the native REST client;
- ``pulsar:persistent://tenant/ns/topic?webServiceUrl=…`` — planned as
  JAX plans it (its URI needs a topic), but refused by name when the
  agent starts: the port has no Pulsar runtime yet (ROADMAP A7.4).

Unsupported schemes fail **at plan time** (planner calls
:func:`validate_component_uri`) with the supported list and the
exec-source bridge recipe.

Anything else raises with the honest escape hatch: register a scheme
mapping from a plugin, or run the real Camel route in its own process
via ``exec-source`` (``agents/connector.py``). ``component-options``
merge into the URI's query parameters, matching Camel's own config
layering.

The port's own copy of ``langstream_tpu/agents/camel.py``. The polling
HTTP consumer and the schema registry speak through the port's asyncio
HTTP client (``agents/http_client.py``) and ``netty-http`` listens on an
asyncio server of its own: aiohttp is not among the card machine's
packages.
"""

from __future__ import annotations

import asyncio
import time
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Tuple

from langstream_tpu_torch.api.agent import AgentSource
from langstream_tpu_torch.api.records import Record, now_millis


def parse_component_uri(
    uri: str, options: Optional[Dict[str, Any]] = None
) -> Tuple[str, str, List[Tuple[str, str]]]:
    """Split a Camel endpoint URI into (scheme, path, param pairs).
    Pairs preserve duplicates and valueless flags (``?delete`` keeps a
    blank value); query parameters and ``component-options`` merge,
    options appended last — Camel's own layering."""
    scheme, _, rest = uri.partition(":")
    if not scheme or not rest:
        raise ValueError(f"not a Camel endpoint URI: {uri!r}")
    path, _, query = rest.partition("?")
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    for key, value in (options or {}).items():
        pairs.append((str(key), str(value)))
    scheme = scheme.lower()
    if scheme in ("timer", "kafka"):
        path = path.strip("/")
    return scheme, path, pairs


def _last(pairs: List[Tuple[str, str]], key: str, default: str) -> str:
    value = default
    for name, item in pairs:
        if name == key:
            value = item
    return value


def _flag(pairs: List[Tuple[str, str]], key: str) -> bool:
    """Boolean endpoint option: ``=true`` or a valueless ``?flag``."""
    value = _last(pairs, key, "false")
    return value == "" or value.lower() == "true"


_DURATION_UNITS = {"ms": 1.0, "s": 1000.0, "m": 60_000.0, "h": 3_600_000.0}


def _duration_ms(value: str, key: str) -> float:
    """Camel duration syntax: plain milliseconds or a single-unit
    suffix (``5s``, ``1m``, ``250ms``)."""
    text = str(value).strip()
    for suffix in ("ms", "s", "m", "h"):
        if text.endswith(suffix):
            number = text[: -len(suffix)]
            try:
                return float(number) * _DURATION_UNITS[suffix]
            except ValueError:
                break
    try:
        return float(text)
    except ValueError:
        raise ValueError(
            f"camel-source: cannot parse {key}={value!r} (use "
            "milliseconds or a single-unit duration like 5s, 1m, 250ms)"
        ) from None


# ------------------------------------------------------------------ #
# per-scheme endpoints — each is a normal AgentSource the facade
# delegates to, so read/commit/close flow uniformly
# ------------------------------------------------------------------ #


class _TimerEndpoint(AgentSource):
    def __init__(self, path: str, pairs: List[Tuple[str, str]]) -> None:
        self.timer_name = path
        self.period = _duration_ms(_last(pairs, "period", "1000"), "period") / 1000.0
        repeat = int(_last(pairs, "repeatCount", "0"))
        self.remaining: Optional[int] = repeat if repeat > 0 else None
        self._next_fire = time.monotonic() + self.period

    async def read(self, max_records: int = 100) -> List[Record]:
        if self.remaining is not None and self.remaining <= 0:
            # exhausted: yield so the runner's poll loop never busy-spins
            await asyncio.sleep(0.2)
            return []
        delay = self._next_fire - time.monotonic()
        if delay > 0:
            # bounded sleep (not the full delay) so close() stays prompt
            await asyncio.sleep(min(delay, 0.2))
            if time.monotonic() < self._next_fire:
                return []
        self._next_fire = time.monotonic() + self.period
        if self.remaining is not None:
            self.remaining -= 1
        headers = (("timer", self.timer_name), ("firedTime", now_millis()))
        return [Record(value=None, headers=headers, timestamp=now_millis())]

    async def commit(self, records: List[Record]) -> None:
        pass


class _HttpPollEndpoint(AgentSource):
    def __init__(
        self, uri: str, pairs: List[Tuple[str, str]]
    ) -> None:
        # rebuild the URL from the pair list so duplicate keys
        # (?ids=1&ids=2) survive; only the polling `delay` is ours
        self.url = uri.split("?", 1)[0]
        keep = [(k, v) for k, v in pairs if k != "delay"]
        if keep:
            self.url += "?" + urllib.parse.urlencode(keep)
        self.poll_delay = _duration_ms(_last(pairs, "delay", "500"), "delay") / 1000.0

    async def read(self, max_records: int = 100) -> List[Record]:
        from langstream_tpu_torch.agents import http_client

        await asyncio.sleep(self.poll_delay)
        # non-2xx responses are still emitted as records — Camel's
        # polling consumer does the same; consumers distinguish them via
        # the CamelHttpResponseCode header
        response = await http_client.request("GET", self.url)
        body = await response.read()
        record = Record(
            value=body,
            headers=(
                ("CamelHttpResponseCode", response.status),
                ("Content-Type", response.headers.get("Content-Type", "")),
            ),
            origin=self.url,
            timestamp=now_millis(),
        )
        return [record]

    async def commit(self, records: List[Record]) -> None:
        pass


class _KafkaEndpoint(AgentSource):
    """``kafka:topic?brokers=host:port&groupId=g`` — Camel's kafka
    component consumed through the framework's own Kafka runtime
    (topics/kafka), so the wire protocol, watermark commit, and group
    membership are the ones already tested by test_topic_contract."""

    def __init__(self, path: str, pairs: List[Tuple[str, str]]) -> None:
        from langstream_tpu_torch.topics.kafka.runtime import (
            KafkaTopicConnectionsRuntime,
        )

        if not path:
            raise ValueError("camel-source: kafka URI needs a topic name")
        self.topic = path
        configuration: Dict[str, Any] = {
            "bootstrapServers": _last(pairs, "brokers", "127.0.0.1:9092"),
        }
        reset = _last(pairs, "autoOffsetReset", "earliest")
        configuration["autoOffsetReset"] = reset
        self._runtime = KafkaTopicConnectionsRuntime(configuration)
        self._consumer = self._runtime.create_consumer(
            "camel-source",
            {"topic": path, "group": _last(pairs, "groupId", "") or None},
        )

    async def start(self) -> None:
        await self._consumer.start()

    async def read(self, max_records: int = 100) -> List[Record]:
        records = await self._consumer.read(max_records, timeout=0.5)
        out = []
        for record in records:
            headers = tuple(record.headers or ()) + (
                ("kafka.TOPIC", self.topic),
            )
            out.append(
                Record(
                    key=record.key,
                    value=record.value,
                    headers=headers,
                    origin=self.topic,
                    timestamp=record.timestamp,
                )
            )
            self._raw = getattr(self, "_raw", {})
            self._raw[id(out[-1])] = record
        return out

    async def commit(self, records: List[Record]) -> None:
        raw = getattr(self, "_raw", {})
        underlying = [raw.pop(id(r)) for r in records if id(r) in raw]
        if underlying:
            await self._consumer.commit(underlying)

    async def close(self) -> None:
        await self._consumer.close()
        await self._runtime.close()


class _NettyHttpEndpoint(AgentSource):
    """``netty-http:http://bind:port/path`` — Camel's netty-http
    component in consumer position is an embedded HTTP **server**:
    every incoming request becomes one record (body → value, request
    headers + method/path → headers). Responds 200 immediately —
    ingestion is asynchronous from processing, like the reference's
    Camel consumer handing exchanges to the LangStream buffer. The
    configured path and everything under it are served; any other path
    answers 404."""

    def __init__(self, path: str, pairs: List[Tuple[str, str]]) -> None:
        inner = path if "://" in path else f"http://{path}"
        parsed = urllib.parse.urlsplit(inner)
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or 0
        self.path = parsed.path or "/"
        self.bound_port: Optional[int] = None
        self._queue: "asyncio.Queue[Record]" = asyncio.Queue(
            maxsize=int(_last(pairs, "maxBuffered", "1000"))
        )
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections: set = set()

    def _serves(self, path: str) -> bool:
        if path == self.path or self.path == "/":
            return True
        return path.startswith(self.path.rstrip("/") + "/")

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._connection, self.host, self.port)
        self.bound_port = self._server.sockets[0].getsockname()[1]

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._connections.add(task)
        try:
            while True:
                start = (await reader.readline()).decode("latin-1").strip()
                if not start:
                    return
                headers: List[Tuple[str, str]] = []
                while True:
                    line = (await reader.readline()).decode("latin-1").rstrip("\r\n")
                    if not line:
                        break
                    name, _, value = line.partition(":")
                    headers.append((name.strip(), value.strip()))
                fields = start.split(" ")
                if len(fields) != 3:
                    return
                method, target, _version = fields
                lowered = {name.lower(): value for name, value in headers}
                length = int(lowered.get("content-length", "0") or 0)
                body = await reader.readexactly(length) if length else b""
                split = urllib.parse.urlsplit(target)
                path = urllib.parse.unquote(split.path)
                if self._serves(path):
                    record_headers = [
                        ("CamelHttpMethod", method),
                        ("CamelHttpPath", path),
                        ("CamelHttpQuery", split.query),
                    ] + headers
                    await self._queue.put(
                        Record(
                            value=body,
                            headers=tuple(record_headers),
                            origin=path,
                            timestamp=now_millis(),
                        )
                    )
                    status = "200 OK"
                else:
                    status = "404 Not Found"
                close = lowered.get("connection", "").lower() == "close"
                writer.write(
                    f"HTTP/1.1 {status}\r\nContent-Length: 0\r\n"
                    f"Connection: {'close' if close else 'keep-alive'}\r\n\r\n".encode("latin-1")
                )
                await writer.drain()
                if close:
                    return
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.CancelledError):
            pass
        finally:
            self._connections.discard(task)
            writer.close()

    async def read(self, max_records: int = 100) -> List[Record]:
        try:
            first = await asyncio.wait_for(self._queue.get(), timeout=0.5)
        except asyncio.TimeoutError:
            return []
        out = [first]
        while len(out) < max_records:
            try:
                out.append(self._queue.get_nowait())
            except asyncio.QueueEmpty:
                break
        return out

    async def commit(self, records: List[Record]) -> None:
        pass

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            for task in list(self._connections):
                task.cancel()
            await self._server.wait_closed()
            self._server = None


def _file_endpoint(path: str, pairs: List[Tuple[str, str]]) -> AgentSource:
    from langstream_tpu_torch.agents.storage import FileSource

    source = FileSource()
    source._camel_init_config = {  # consumed by CamelSourceAgent.init
        "path": path,
        "delete-objects": _flag(pairs, "delete"),
        "file-extensions": _last(pairs, "fileExtensions", ""),
        "idle-time": _duration_ms(_last(pairs, "delay", "500"), "delay") / 1000.0,
    }
    return source


def _polling_options(pairs: List[Tuple[str, str]]) -> Dict[str, Any]:
    """The option triple every object-store polling consumer shares
    (Camel spellings → native source config) — one copy, two users."""
    return {
        "delete-objects": _last(pairs, "deleteAfterRead", "true").lower()
        != "false",
        "idle-time": _duration_ms(_last(pairs, "delay", "5000"), "delay")
        / 1000.0,
        "file-extensions": _last(pairs, "fileExtensions", ""),
    }


def _s3_endpoint(path: str, pairs: List[Tuple[str, str]]) -> AgentSource:
    """``aws2-s3://bucket?accessKey=&secretKey=&region=&delay=5s&
    deleteAfterRead=false&uriEndpointOverride=http://minio:9000`` —
    Camel's aws2-s3 polling consumer mapped onto the framework's own
    :class:`agents.storage.S3Source` (SigV4 client, delete-on-commit).
    Camel option names per the aws2-s3 endpoint docs; deleteAfterRead
    defaults true there, so it does here too."""
    from langstream_tpu_torch.agents.storage import S3Source

    bucket = path.strip("/")
    if not bucket:
        raise ValueError("camel-source: aws2-s3 URI needs a bucket name")
    endpoint = _last(pairs, "uriEndpointOverride", "")
    region = _last(pairs, "region", "us-east-1")
    source = S3Source()
    source._camel_init_config = {
        "bucketName": bucket,
        "endpoint": endpoint or f"https://s3.{region}.amazonaws.com",
        "access-key": _last(pairs, "accessKey", ""),
        "secret-key": _last(pairs, "secretKey", ""),
        "region": region,
        **_polling_options(pairs),
    }
    return source


def _azure_blob_endpoint(path: str, pairs: List[Tuple[str, str]]) -> AgentSource:
    """``azure-storage-blob://account/container?accessKey=…`` — Camel's
    azure-storage-blob consumer mapped onto
    :class:`agents.storage.AzureBlobStorageSource` (native Azure REST
    client). Path is accountName[/containerName], per the Camel
    component; connectionString / sasToken options supported."""
    from langstream_tpu_torch.agents.storage import AzureBlobStorageSource

    account, _, container = path.strip("/").partition("/")
    connection = _last(pairs, "connectionString", "")
    if not account and not connection:
        raise ValueError(
            "camel-source: azure-storage-blob URI needs "
            "accountName/containerName (or a connectionString option)"
        )
    if not container:
        # a silent default container would poll the wrong place and
        # yield an empty stream with no clue — the consumer endpoint
        # must name its container
        raise ValueError(
            "camel-source: azure-storage-blob URI needs a container "
            "segment (azure-storage-blob://account/container)"
        )
    source = AzureBlobStorageSource()
    config: Dict[str, Any] = {
        "container": container,
        **_polling_options(pairs),
    }
    if connection:
        config["storage-account-connection-string"] = connection
    if account:
        config["storage-account-name"] = account
    access_key = _last(pairs, "accessKey", "")
    if access_key:
        config["storage-account-key"] = access_key
    sas = _last(pairs, "sasToken", "")
    if sas:
        config["sas-token"] = sas
    source._camel_init_config = config
    return source


def _pulsar_endpoint(path: str, pairs: List[Tuple[str, str]]) -> AgentSource:
    """``pulsar:persistent://tenant/ns/topic?webServiceUrl=…`` — JAX maps
    it onto its Pulsar runtime (``topics/pulsar.py``), which the port does
    not have yet: refused by name when the agent starts. The planner
    still checks the URI's topic, as JAX's does."""
    raise ValueError(
        "camel-source: the pulsar: scheme is not yet ported to langstream_tpu_torch "
        "(ROADMAP A7.4: Pulsar); the port maps timer, file, http(s), kafka, "
        "netty-http, aws2-s3 and azure-storage-blob"
    )


# scheme → factory(path, pairs) -> AgentSource. Extensible: plugin
# packages call register_camel_scheme to map more component families.
CAMEL_SCHEMES: Dict[str, Callable[[str, List[Tuple[str, str]]], AgentSource]] = {
    "timer": _TimerEndpoint,
    "file": _file_endpoint,
    "kafka": _KafkaEndpoint,
    "netty-http": _NettyHttpEndpoint,
    "aws2-s3": _s3_endpoint,
    "azure-storage-blob": _azure_blob_endpoint,
    "pulsar": _pulsar_endpoint,
}

# what the endpoint needs in the URI path, declared ON the factory —
# the ONE source the plan-time validator reads, so runtime checks and
# plan-time guidance can't drift, and plugin schemes opt in the same
# way (timer's name may legitimately be empty)
_KafkaEndpoint.requires_path = "a topic name"
_pulsar_endpoint.requires_path = "a topic"
_s3_endpoint.requires_path = "a bucket name"
_azure_blob_endpoint.requires_path = "accountName/containerName"
_file_endpoint.requires_path = "a directory path"
_NettyHttpEndpoint.requires_path = "a bind URL"


def supported_schemes() -> List[str]:
    """All natively-mapped scheme spellings (registry + http/https) —
    the single list both the runtime error and the PLAN-TIME validator
    print, so guidance can't drift from reality."""
    return sorted(CAMEL_SCHEMES) + ["http", "https"]


def _unsupported_scheme_message(scheme: str) -> str:
    return (
        f"camel-source component {scheme!r} has no native mapping "
        f"(supported: {', '.join(supported_schemes())}); register one "
        "with register_camel_scheme from a plugin package (declare "
        "`expect-plugin-scheme: true` on the agent so the planner defers "
        "the check to runtime), or run the real Camel route in its own "
        "process and bridge it with exec-source (agents/connector.py)"
    )


def validate_component_uri(
    uri: str,
    options: Optional[Dict[str, Any]] = None,
    expect_plugin_scheme: bool = False,
) -> Optional[str]:
    """Plan-time check for the planner's config validation: returns an
    actionable error string for an unsupported/unparseable URI, None
    when the URI maps to a native scheme.

    The SCHEME is judged statically even when the query string carries
    unresolved placeholders (``jms:q?password=${secrets.pw}`` must still
    fail at plan time); only a placeholder in the scheme segment itself
    defers the check. ``expect_plugin_scheme`` (the agent's
    ``expect-plugin-scheme: true``) defers unknown schemes to runtime —
    plugin packages register schemes when the pod loads them, which the
    planner cannot see."""
    if not uri:
        return None
    scheme_segment = uri.partition(":")[0]
    if "${" in scheme_segment:
        return None  # resolves per-deploy
    if not isinstance(options, dict):
        options = None
    try:
        scheme, path, _pairs = parse_component_uri(uri, options)
    except ValueError as error:
        return str(error)
    if scheme in CAMEL_SCHEMES or scheme in ("http", "https"):
        # a query-only URI for a scheme that needs a path must still
        # fail at plan time ('kafka:?brokers=…' — topic forgotten).
        # The requirement lives on the factory (requires_path), one
        # source shared with the runtime checks; http/https need a URL.
        needs = (
            "a URL" if scheme in ("http", "https")
            else getattr(CAMEL_SCHEMES[scheme], "requires_path", None)
        )
        if needs and not path.strip("/"):
            return f"camel-source: {scheme} URI needs {needs} (got {uri!r})"
        return None
    if expect_plugin_scheme:
        return None
    return _unsupported_scheme_message(scheme)


def register_camel_scheme(
    scheme: str,
    factory: Callable[[str, List[Tuple[str, str]]], AgentSource],
) -> None:
    """Map an additional Camel component scheme onto a native source.
    Plugin packages (runtime/plugins.py) use this to extend the zoo.
    Set ``factory.requires_path = "<what>"`` to get the plan-time
    empty-path rejection the built-in schemes have."""
    CAMEL_SCHEMES[scheme.lower()] = factory


class CamelSourceAgent(AgentSource):
    agent_type = "camel-source"

    async def init(self, configuration: Dict[str, Any]) -> None:
        uri = configuration.get("component-uri") or ""
        self.key_header = configuration.get("key-header") or ""
        self.max_buffered = int(configuration.get("max-buffered-records", 100))
        self.scheme, path, pairs = parse_component_uri(
            uri, configuration.get("component-options")
        )
        if self.scheme in ("http", "https"):
            self._delegate: AgentSource = _HttpPollEndpoint(uri, pairs)
        elif self.scheme in CAMEL_SCHEMES:
            self._delegate = CAMEL_SCHEMES[self.scheme](path, pairs)
        else:
            # normally unreachable: the planner rejects unsupported URIs
            # at plan time with the same message (validate_component_uri)
            # — this guards direct/SDK construction and plugin schemes
            # that never got registered
            raise ValueError(
                validate_component_uri(uri)
                or _unsupported_scheme_message(self.scheme)
            )
        init_config = getattr(self._delegate, "_camel_init_config", None)
        if init_config is not None:
            await self._delegate.init(init_config)

    def __getattr__(self, name: str):
        # endpoint attributes (url, period, bound_port, …) read through
        # the facade — the pre-registry API exposed them directly
        delegate = self.__dict__.get("_delegate")
        if delegate is not None and not name.startswith("_"):
            return getattr(delegate, name)
        raise AttributeError(name)

    # ---------------------------------------------------------------- #
    async def start(self) -> None:
        await self._delegate.start()

    async def read(self, max_records: int = 100) -> List[Record]:
        max_records = min(max_records, self.max_buffered)
        records = await self._delegate.read(max_records)
        return [self._rekey(r) for r in records]

    _MISSING = object()

    def _rekey(self, record: Record) -> Record:
        """Apply the reference's ``key-header`` rule: the named header's
        value becomes the record key."""
        if not self.key_header:
            return record
        value = record.header(self.key_header, self._MISSING)
        return record if value is self._MISSING else record.with_key(value)

    async def commit(self, records: List[Record]) -> None:
        await self._delegate.commit(records)

    async def close(self) -> None:
        if getattr(self, "_delegate", None) is not None:
            await self._delegate.close()
