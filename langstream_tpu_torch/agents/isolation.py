"""Process-isolated user Python agents: the crash boundary.

The reference ALWAYS runs user Python code in a child process behind a
bidi-gRPC contract with deliberate crash semantics
(``langstream-agent-grpc/src/main/java/ai/langstream/agents/grpc/PythonGrpcServer.java:54-91``
spawns ``python3 -m langstream_grpc`` on a free localhost port;
``langstream-runtime/langstream-runtime-impl/src/main/python/langstream_grpc/grpc_service.py:359``
``crash_process`` kills the child on unrecoverable agent error so the
pod — not the runtime — dies). This framework's runtime *is* Python, so
built-in agents run in-process; but **untrusted app code** still needs
the boundary: one bad native dependency or OOM in user code must not
destroy in-flight KV state for every session on the card.

``isolation: process`` on a ``python-source/processor/sink/service``
agent restores that boundary:

- the runner spawns ``sys.executable -m langstream_tpu_torch.agents.isolation
  <socket>`` (whose imports reach no ``torch``: the child starts in a
  fraction of a second) (a Unix domain socket; no ports, no TLS surface) and
  hands it the ``className``/``pythonPath``/configuration over the
  wire, NOT over argv (secrets stay out of /proc cmdline);
- the parent keeps the existing duck-typed user-agent surface — the
  proxy slots into :class:`~langstream_tpu_torch.agents.python_agents._PythonAgentMixin`
  exactly where the in-process instance would sit, so all four agent
  kinds, the tuple/dict record coercions, and agent_info flow
  unchanged;
- **user exceptions** cross the boundary as structured errors and
  re-raise in the parent → the record-level error policies
  (fail/skip/dead-letter, ``api/errors.py``) apply exactly as
  in-process;
- **child death** (segfault, ``os._exit``, OOM-kill) surfaces as
  :class:`AgentProcessCrashed` on every in-flight and subsequent call →
  the runner's fail-fast path ends the pod, Kubernetes restarts it,
  and the serving engine in OTHER pods (and any engine living in this
  runner before the crash) is untouched — the reference's
  ``crash_process`` contract with the roles inverted.

Framing is length-prefixed JSON with base64 for byte values —
deliberately NOT pickle: nothing executable crosses the boundary in
either direction. The codec round-trips the JSON-shaped record domain
(str/num/bool/None/list/dict-with-string-keys) plus bytes and nested
Records; dicts whose keys collide with the escape markers are wrapped,
and non-string dict keys are stringified (a JSON limitation — same as
every broker codec in this framework).

The port's own copy of ``langstream_tpu/agents/isolation.py``, with two
repairs: ``close()`` fails every call still in flight once the reader
stops (JAX's could cancel the reader before it saw the child's EOF, and
leave a service's ``join()`` waiting), and the context's
``persistent_state_directory`` crosses as the directory, not as the
bound method's text.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import struct
import sys
import tempfile
import uuid
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.api.errors import FatalAgentError
from langstream_tpu_torch.api.records import Record, record_from_value
from langstream_tpu_torch.utils import wire_json

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">I")
_MAX_FRAME = 256 * 1024 * 1024


class AgentProcessCrashed(FatalAgentError):
    """The isolated agent process died (crash, exit, or kill).

    Subclasses :class:`FatalAgentError` so the record error policy can
    NEVER consume it: with ``on-failure: skip`` a dead child would
    otherwise silently drop every subsequent record instead of
    restarting the pod (the reference's ``crash_process`` contract)."""


class RemoteAgentError(RuntimeError):
    """A user exception raised inside the isolated process, re-raised
    in the parent with the remote traceback attached."""

    def __init__(self, message: str, remote_traceback: str = "") -> None:
        super().__init__(message)
        self.remote_traceback = remote_traceback


# --------------------------------------------------------------------- #
# value / record codec (JSON + base64 bytes; bijective for the types the
# record model allows)
# --------------------------------------------------------------------- #
_RECORD_TAG = "__record__"
_RECORD_MARKERS = (frozenset((_RECORD_TAG,)),)


def _enc(value: Any) -> Any:
    return wire_json.encode_value(
        value,
        extra_markers=_RECORD_MARKERS,
        encode_special=lambda v: (
            {_RECORD_TAG: _enc_record(v)} if isinstance(v, Record) else None
        ),
    )


def _dec(value: Any) -> Any:
    def decode_special(data: Dict[str, Any]):
        if set(data.keys()) == {_RECORD_TAG}:
            return _dec_record(data[_RECORD_TAG])
        return NotImplemented

    return wire_json.decode_value(
        value,
        extra_markers=_RECORD_MARKERS,
        decode_special=decode_special,
    )


def _enc_record(record: Record) -> Dict[str, Any]:
    return {
        "key": _enc(record.key),
        "value": _enc(record.value),
        "origin": record.origin,
        "timestamp": record.timestamp,
        "headers": [[k, _enc(v)] for k, v in record.headers],
    }


def _dec_record(data: Dict[str, Any]) -> Record:
    return Record(
        key=_dec(data.get("key")),
        value=_dec(data.get("value")),
        origin=data.get("origin"),
        timestamp=data.get("timestamp"),
        headers=tuple((k, _dec(v)) for k, v in data.get("headers") or ()),
    )


async def _send(writer: asyncio.StreamWriter, message: Dict[str, Any]) -> None:
    payload = json.dumps(message, default=str).encode()
    if len(payload) > _MAX_FRAME:
        raise ValueError(
            f"isolation frame too large ({len(payload)} bytes > "
            f"{_MAX_FRAME}); shrink the record batch"
        )
    writer.write(_LEN.pack(len(payload)) + payload)
    await writer.drain()


async def _recv(reader: asyncio.StreamReader) -> Dict[str, Any]:
    header = await reader.readexactly(_LEN.size)
    (size,) = _LEN.unpack(header)
    if size > _MAX_FRAME:
        raise RuntimeError(f"isolation frame too large: {size}")
    return json.loads(await reader.readexactly(size))


# --------------------------------------------------------------------- #
# parent side
# --------------------------------------------------------------------- #
class RemoteUserAgent:
    """Duck-typed stand-in for the user agent instance: same async
    surface (`init/start/close/set_context/process/read/commit/write/
    join/agent_info`) as the in-process object, but every call is an
    RPC to the child. Created by ``spawn()``."""

    def __init__(self) -> None:
        self._process: Optional[asyncio.subprocess.Process] = None
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: Dict[str, asyncio.Future] = {}
        self._reader_task: Optional[asyncio.Task] = None
        self._socket_path = ""
        self._crashed: Optional[AgentProcessCrashed] = None
        self._closing = False

    # ---------------------------------------------------------------- #
    @classmethod
    async def spawn(
        cls,
        kind: str,
        configuration: Dict[str, Any],
        connect_timeout: float = 20.0,
    ) -> "RemoteUserAgent":
        self = cls()
        sock_dir = tempfile.mkdtemp(prefix="ls-agent-")
        self._socket_path = os.path.join(sock_dir, "agent.sock")
        connected: asyncio.Future = asyncio.get_running_loop().create_future()

        async def on_connect(reader, writer):
            if not connected.done():
                connected.set_result((reader, writer))

        server = await asyncio.start_unix_server(
            on_connect, path=self._socket_path
        )
        # child inherits the parent's interpreter + sys.path (the
        # framework must be importable; user code paths travel in the
        # init message, not argv)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in sys.path if p
        )
        self._process = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "langstream_tpu_torch.agents.isolation",
            self._socket_path,
            env=env,
            stdout=None, stderr=None,  # user prints flow to the pod log
        )
        try:
            self._reader, self._writer = await asyncio.wait_for(
                connected, connect_timeout
            )
        except asyncio.TimeoutError:
            await self.close()  # kill + reap + remove the socket tempdir
            raise AgentProcessCrashed(
                f"isolated agent worker did not connect within "
                f"{connect_timeout:.0f}s"
            ) from None
        finally:
            server.close()
        self._reader_task = asyncio.ensure_future(self._read_loop())
        try:
            await self._call(
                "boot", kind=kind, configuration=_enc(configuration)
            )
        except BaseException:
            # bad className / failing user init(): don't leak the child,
            # the reader task, or the socket tempdir on every deploy retry
            await self.close()
            raise
        return self

    async def _read_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                message = await _recv(self._reader)
                future = self._pending.pop(message.get("id"), None)
                if future is not None and not future.done():
                    future.set_result(message)
        except asyncio.CancelledError:
            raise
        except BaseException as error:  # noqa: BLE001 — ANY reader death
            if self._closing:
                # the child's clean EOF after our close RPC is not a
                # crash (marking it one would report crashed=true on
                # /info for every normal shutdown) — but in-flight RPCs
                # (a service join() blocking in the child) must still
                # resolve or their awaiters hang forever
                closed = RuntimeError("isolated agent closed")
                for future in self._pending.values():
                    if not future.done():
                        future.set_exception(closed)
                self._pending.clear()
                return
            # must fail fast: a decode error (oversized frame, bad JSON)
            # that killed only the reader task would leave every
            # in-flight and future call hanging forever
            returncode: Any = None
            if self._process is not None and isinstance(
                error, (asyncio.IncompleteReadError, ConnectionError, OSError)
            ):
                try:
                    returncode = await asyncio.wait_for(
                        self._process.wait(), timeout=5.0
                    )
                except asyncio.TimeoutError:
                    returncode = "unknown (socket closed, process alive)"
            detail = (
                f"exit code {returncode}" if returncode is not None
                else f"transport error: {error!r}"
            )
            self._crashed = AgentProcessCrashed(
                f"isolated agent process died ({detail})"
            )
            for future in self._pending.values():
                if not future.done():
                    future.set_exception(self._crashed)
            self._pending.clear()

    async def _call(self, method: str, **kwargs) -> Any:
        if self._crashed is not None:
            raise self._crashed
        assert self._writer is not None
        request_id = uuid.uuid4().hex
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[request_id] = future
        try:
            await _send(
                self._writer,
                {"id": request_id, "method": method, **kwargs},
            )
        except (ConnectionError, OSError) as error:
            self._pending.pop(request_id, None)
            raise self._crashed or AgentProcessCrashed(
                f"isolated agent socket write failed: {error}"
            ) from error
        except BaseException:
            # e.g. oversize-frame ValueError: the request never went out,
            # so its future must not linger in _pending (it would log
            # 'exception was never retrieved' when the child later dies)
            self._pending.pop(request_id, None)
            raise
        response = await future
        if "error" in response:
            error = response["error"]
            raise RemoteAgentError(
                error.get("message", "remote agent error"),
                error.get("traceback", ""),
            )
        return _dec(response.get("result"))

    # -------------------------- SPI surface ------------------------- #
    async def init(self, configuration: Dict[str, Any]) -> None:
        # configuration already travelled in the boot message; the
        # child ran user init() there so import/config errors surface
        # at deploy time like in-process agents
        return None

    async def set_context(self, context: Any) -> None:
        # only the serializable subset crosses (the reference's gRPC
        # context carries the same: persistent dir + ids, agent.proto);
        # the runner's AgentContext has the directory behind a method
        state_dir = getattr(context, "persistent_state_directory", None)
        await self._call("set_context", context={
            "agent_id": getattr(context, "agent_id", None),
            "application_id": getattr(context, "application_id", None),
            "persistent_state_directory": state_dir() if callable(state_dir) else state_dir,
        })

    async def start(self) -> None:
        await self._call("start")

    async def process(self, record: Record) -> List[Record]:
        # the child already coerced loose user returns; _dec in _call
        # materialized the Record envelopes
        return await self._call("process", record=_enc_record(record)) or []

    async def read(self) -> List[Record]:
        return await self._call("read") or []

    async def commit(self, records: List[Record]) -> None:
        await self._call(
            "commit", records=[_enc_record(r) for r in records]
        )

    async def permanent_failure(self, record: Record, error: BaseException) -> None:
        await self._call(
            "permanent_failure",
            record=_enc_record(record), message=str(error),
        )

    async def write(self, record: Record) -> None:
        await self._call("write", record=_enc_record(record))

    async def join(self) -> None:
        await self._call("join")

    def agent_info(self) -> Dict[str, Any]:
        return {"isolation": "process", "crashed": self._crashed is not None}

    async def close(self) -> None:
        self._closing = True
        if self._crashed is None and self._writer is not None:
            try:
                await asyncio.wait_for(self._call("close"), timeout=10.0)
            except (Exception, asyncio.TimeoutError):
                # includes the 'isolated agent closed' RuntimeError the
                # read loop sets on pending futures when the child EOFs
                # before the close response — cleanup below must run
                # regardless
                pass
        if self._writer is not None:
            self._writer.close()
        if self._process is not None and self._process.returncode is None:
            try:
                self._process.terminate()
                await asyncio.wait_for(self._process.wait(), timeout=5.0)
            except (asyncio.TimeoutError, ProcessLookupError):
                try:
                    self._process.kill()
                except ProcessLookupError:
                    pass
        if self._reader_task is not None:
            self._reader_task.cancel()
        # the reader may have been cancelled before it saw the child's
        # EOF: whatever still waits (a service's join) must not hang
        closed = RuntimeError("isolated agent closed")
        for future in self._pending.values():
            if not future.done():
                future.set_exception(closed)
        self._pending.clear()
        try:
            os.unlink(self._socket_path)
            os.rmdir(os.path.dirname(self._socket_path))
        except OSError:
            pass


# --------------------------------------------------------------------- #
# child side (python -m langstream_tpu_torch.agents.isolation <socket>)
# --------------------------------------------------------------------- #
async def _worker(socket_path: str) -> None:
    from langstream_tpu_torch.agents.python_agents import _maybe_await

    reader, writer = await asyncio.open_unix_connection(socket_path)
    agent: Any = None
    lock = asyncio.Lock()  # user agents are single-threaded, like the SPI

    async def handle(message: Dict[str, Any]) -> None:
        nonlocal agent
        response: Dict[str, Any] = {"id": message.get("id")}
        try:
            method = message["method"]
            if method == "boot":
                configuration = _dec(message["configuration"])
                class_name = configuration.get("className")
                if not class_name:
                    raise ValueError(
                        "python agent requires 'className' configuration"
                    )
                # this child belongs to ONE app, so the reference's flat
                # PYTHONPATH semantics apply (PythonGrpcServer.java:81-85:
                # python/ + python/lib, in that precedence, ahead of
                # site-packages): user modules AND their third-party
                # deps import absolutely — no namespacing needed here,
                # the process IS the namespace
                fresh = [
                    str(p) for p in configuration.get("pythonPath") or []
                    if p and str(p) not in sys.path
                ]
                sys.path[:0] = fresh
                from langstream_tpu_torch.runtime.registry import load_class

                cls = load_class(class_name)
                agent = cls()
                if hasattr(agent, "init"):
                    await _maybe_await(agent.init(configuration))
            elif method == "set_context":
                if hasattr(agent, "set_context"):
                    import types

                    await _maybe_await(agent.set_context(
                        types.SimpleNamespace(**message["context"])
                    ))
            elif method == "start":
                if hasattr(agent, "start"):
                    await _maybe_await(agent.start())
            elif method == "process":
                source_record = _dec_record(message["record"])
                async with lock:
                    results = await _maybe_await(agent.process(source_record))
                # same coercion the in-process path applies
                # (python_agents.py process_record): bare values inherit
                # the source record's origin
                coerced = [
                    record_from_value(r, origin=source_record.origin)
                    for r in (results or [])
                ]
                response["result"] = [
                    {"__record__": _enc_record(r)} for r in coerced
                ]
            elif method == "read":
                async with lock:
                    results = await _maybe_await(agent.read())
                coerced = [record_from_value(r) for r in (results or [])]
                response["result"] = [
                    {"__record__": _enc_record(r)} for r in coerced
                ]
            elif method == "commit":
                if hasattr(agent, "commit"):
                    async with lock:
                        await _maybe_await(agent.commit(
                            [_dec_record(r) for r in message["records"]]
                        ))
            elif method == "permanent_failure":
                if hasattr(agent, "permanent_failure"):
                    await _maybe_await(agent.permanent_failure(
                        _dec_record(message["record"]),
                        RuntimeError(message.get("message", "")),
                    ))
                else:
                    raise RuntimeError(message.get("message", ""))
            elif method == "write":
                async with lock:
                    await _maybe_await(agent.write(_dec_record(message["record"])))
            elif method == "join":
                if hasattr(agent, "join"):
                    await _maybe_await(agent.join())
                elif hasattr(agent, "main"):
                    await _maybe_await(agent.main())
                else:
                    await asyncio.Event().wait()
            elif method == "close":
                if agent is not None and hasattr(agent, "close"):
                    await _maybe_await(agent.close())
                await _send(writer, response)
                writer.close()
                # stdio is a block-buffered pipe into the pod log; flush
                # or a short-lived agent loses its print() diagnostics
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(0)
            else:
                raise ValueError(f"unknown method {method!r}")
        except BaseException as error:  # noqa: BLE001 — report, don't die
            import traceback

            response["error"] = {
                "message": f"{type(error).__name__}: {error}",
                "traceback": traceback.format_exc(),
            }
        try:
            await _send(writer, response)
        except (ConnectionError, OSError):
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)  # parent gone; nothing to serve

    while True:
        try:
            message = await _recv(reader)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            # parent died or closed: exit quietly (reference child dies
            # with its Java parent the same way)
            return
        # each request is its own task so a blocking join() (service
        # agents) cannot starve close()/reads; the per-agent lock keeps
        # record-path calls sequential
        asyncio.ensure_future(handle(message))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    asyncio.run(_worker(sys.argv[1]))
