"""TCP broker server: multi-process access to a :class:`LogBroker`.

This is the standalone face of the tpulog broker — what Kafka's network
layer is to its log layer. One process runs ``BrokerServer`` (or
``python -m langstream_tpu_torch broker DIR``); agent-runner processes connect with
:class:`langstream_tpu_torch.topics.log.client.RemoteTopicConnectionsRuntime`.

Protocol: 4-byte little-endian length prefix + JSON request/response, one
in-flight request per connection (clients pipeline by opening extra
connections). Consumer-group coordination is server-side:

- ``join``/``leave``/``poll`` manage membership; every request from a
  member doubles as a heartbeat, and members silent for longer than
  ``session_timeout`` are evicted, bumping the group generation (an
  evicted member's next poll joins it again)
  (reference semantics: Kafka group coordinator + the rebalance listener in
  ``KafkaConsumerWrapper.java:82-111``).
- ``commit`` sends acknowledged offsets; the server advances the durable
  contiguous watermark per partition.

The port's own copy of ``langstream_tpu/topics/log/server.py``: the same
protocol, so either package's client talks to either's server.
"""

from __future__ import annotations

import asyncio
import json
import struct
import time
from typing import Any, Dict, Optional, Set, Tuple

from langstream_tpu_torch.api.topics import TopicSpec
from langstream_tpu_torch.topics.log import codec
from langstream_tpu_torch.topics.log.broker import LogBroker

_LEN = struct.Struct("<I")
MAX_FRAME = 256 << 20


class _ServedGroup:
    """Server-side view of one (topic, group): members + ack sets."""

    def __init__(self) -> None:
        self.last_seen: Dict[str, float] = {}  # member_id -> monotonic ts
        self.acked: Dict[int, Set[int]] = {}

    def touch(self, member_id: str) -> None:
        self.last_seen[member_id] = time.monotonic()

    def evict_expired(self, session_timeout: float) -> bool:
        deadline = time.monotonic() - session_timeout
        expired = [m for m, ts in self.last_seen.items() if ts < deadline]
        for member in expired:
            del self.last_seen[member]
        return bool(expired)

    def members(self) -> list:
        return sorted(self.last_seen)


class BrokerServer:
    def __init__(
        self,
        broker: LogBroker,
        host: str = "127.0.0.1",
        port: int = 0,
        session_timeout: float = 15.0,
    ) -> None:
        self.broker = broker
        self.host = host
        self.port = port
        self.session_timeout = session_timeout
        self._served: Dict[Tuple[str, str], _ServedGroup] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections: Set[asyncio.StreamWriter] = set()

    # -- lifecycle ---------------------------------------------------- #
    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            for writer in list(self._connections):
                writer.close()
            await self._server.wait_closed()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # -- group coordination ------------------------------------------- #
    def _group_pair(self, topic: str, group_id: str):
        state = self.broker.group(topic, group_id)
        served = self._served.setdefault((topic, group_id), _ServedGroup())
        if served.evict_expired(self.session_timeout):
            state.members = served.members()
            state.generation += 1
        return state, served

    def _member_assignment(self, state, member_id: str) -> list:
        members = state.members
        if member_id not in members:
            return []
        n = len(members)
        i = members.index(member_id)
        return [p for p in range(len(state.committed)) if p % n == i]

    # -- request handling ---------------------------------------------- #
    async def _handle_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._connections.add(writer)
        try:
            while True:
                try:
                    header = await reader.readexactly(_LEN.size)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                (length,) = _LEN.unpack(header)
                if length > MAX_FRAME:
                    break
                body = await reader.readexactly(length)
                request = json.loads(body)
                try:
                    response = await self._dispatch(request)
                except Exception as err:  # surface to the client
                    response = {"ok": False, "error": f"{type(err).__name__}: {err}"}
                payload = json.dumps(response, default=str).encode()
                writer.write(_LEN.pack(len(payload)) + payload)
                await writer.drain()
        finally:
            self._connections.discard(writer)
            writer.close()

    async def _dispatch(self, request: Dict[str, Any]) -> Dict[str, Any]:
        op = request.get("op")
        if op == "produce":
            stored = await self.broker.publish(
                request["topic"], codec.record_from_json(request["record"])
            )
            return {"ok": True, "partition": stored.partition, "offset": stored.offset}
        if op == "fetch":
            return await self._fetch(request)
        if op == "end_offsets":
            return {"ok": True, "ends": self.broker.end_offsets(request["topic"])}
        if op in ("join", "poll"):
            # a poll from a member the group no longer holds (evicted after
            # a silence longer than the session timeout, say while its
            # agents started) joins it again: the JAX server's poll only
            # touches it, and it never gets a partition back
            state, served = self._group_pair(request["topic"], request["group"])
            member = request["member"]
            if member not in served.last_seen:
                served.touch(member)
                state.members = served.members()
                state.generation += 1
            else:
                served.touch(member)
            return self._poll_response(state, member)
        if op == "leave":
            state, served = self._group_pair(request["topic"], request["group"])
            if request["member"] in served.last_seen:
                del served.last_seen[request["member"]]
                state.members = served.members()
                state.generation += 1
            return {"ok": True}
        if op == "commit":
            return self._commit(request)
        if op == "create_topic":
            spec = request["spec"]
            self.broker.create_topic(
                TopicSpec(
                    name=spec["name"], partitions=spec.get("partitions", 1)
                )
            )
            return {"ok": True}
        if op == "delete_topic":
            self.broker.delete_topic(request["topic"])
            return {"ok": True}
        if op == "stats":
            return {"ok": True, "stats": self.broker.stats()}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _poll_response(self, state, member: str) -> Dict[str, Any]:
        return {
            "ok": True,
            "generation": state.generation,
            "assignment": self._member_assignment(state, member),
            "committed": list(state.committed),
        }

    async def _fetch(self, request: Dict[str, Any]) -> Dict[str, Any]:
        topic = request["topic"]
        partitions: Dict[int, int] = {
            int(p): int(start) for p, start in request["positions"].items()
        }
        max_records = int(request.get("max_records", 100))
        timeout = float(request.get("timeout", 0.1))
        deadline = time.monotonic() + timeout
        while True:
            records = []
            for partition, start in partitions.items():
                if len(records) >= max_records:
                    break
                records.extend(
                    self.broker.fetch(
                        topic, partition, start, max_records - len(records)
                    )
                )
            if records or time.monotonic() >= deadline:
                return {
                    "ok": True,
                    "records": [codec.record_to_json(r) for r in records],
                }
            await self.broker.wait_for_data(deadline - time.monotonic())

    def _commit(self, request: Dict[str, Any]) -> Dict[str, Any]:
        state, served = self._group_pair(request["topic"], request["group"])
        served.touch(request.get("member", ""))
        dirty = False
        for partition_str, offsets in request["offsets"].items():
            partition = int(partition_str)
            acked = served.acked.setdefault(partition, set())
            acked.update(int(o) for o in offsets)
            watermark = state.committed[partition]
            while watermark in acked:
                acked.discard(watermark)
                watermark += 1
            if watermark != state.committed[partition]:
                state.committed[partition] = watermark
                dirty = True
        if dirty:
            state.persist()
        return {"ok": True, "committed": list(state.committed)}


async def serve(
    root: str, host: str = "127.0.0.1", port: int = 4551
) -> BrokerServer:
    server = BrokerServer(LogBroker(root), host=host, port=port)
    await server.start()
    return server
