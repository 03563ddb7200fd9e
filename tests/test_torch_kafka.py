"""The port's Kafka layer (``langstream_tpu_torch/topics/kafka/``) held
against the JAX package's:

- record batches v2, their CRC32C, and the group codecs, byte for byte;
- the native CRC32C (``native/kafkacodec.cpp``, built with g++) against
  the plain table version, the standard vector and JAX's;
- the port's client against the JAX ``KafkaFacadeBroker`` and the JAX
  client against the port's: records, readers, groups;
- group join and sync (two members splitting two partitions in one
  generation) and the out-of-order commit on a contiguous watermark, with
  the same committed offsets as JAX's;
- Avro and the Confluent framing byte for byte, and the schema registry on
  a local fake: a foreign Confluent-framed record decoded by the consumer,
  a schema registered, each package's client the same requests.
"""

from __future__ import annotations

import asyncio
import json
import threading
import types
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import langstream_tpu.api.records as jax_records
import langstream_tpu.api.topics as jax_topics
import langstream_tpu.topics.kafka.avro as jax_avro
import langstream_tpu.topics.kafka.protocol as jax_proto
import langstream_tpu.topics.kafka.runtime as jax_runtime
import langstream_tpu.topics.kafka.server as jax_server
import langstream_tpu_torch.api.records as port_records
import langstream_tpu_torch.api.topics as port_topics
import langstream_tpu_torch.topics.kafka.avro as port_avro
import langstream_tpu_torch.topics.kafka.protocol as port_proto
import langstream_tpu_torch.topics.kafka.runtime as port_runtime
import langstream_tpu_torch.topics.kafka.server as port_server
from langstream_tpu_torch import native

WAIT_S = 20.0
PACKAGES = {
    name: types.SimpleNamespace(Record=records.Record, OffsetPosition=topics.OffsetPosition,
                                TopicSpec=topics.TopicSpec, proto=proto, avro=avro,
                                Runtime=runtime.KafkaTopicConnectionsRuntime,
                                serve=server.serve_kafka_facade)
    for name, records, topics, proto, avro, runtime, server in (
        ("jax", jax_records, jax_topics, jax_proto, jax_avro, jax_runtime, jax_server),
        ("port", port_records, port_topics, port_proto, port_avro, port_runtime, port_server))
}


def seeded_batch(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(1, 12))):
        key = None if rng.random() < 0.3 else bytes(rng.integers(0, 256, 4, dtype=np.uint8))
        value = None if rng.random() < 0.2 else bytes(
            rng.integers(0, 256, int(rng.integers(0, 400)), dtype=np.uint8))
        headers = [(f"h{j}", None if rng.random() < 0.3 else bytes([j, i]))
                   for j in range(int(rng.integers(0, 3)))]
        out.append((key, value, headers, 1_700_000_000_000 + int(rng.integers(0, 10_000))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_wire_bytes_like_jax(seed):
    records = seeded_batch(seed)
    batch = port_proto.encode_record_batch(records, base_offset=seed * 7)
    assert batch == jax_proto.encode_record_batch(records, base_offset=seed * 7)
    decoded = port_proto.decode_record_batches(batch + batch[:-3])  # a torn tail skipped
    assert [vars(r) for r in decoded] == [vars(r) for r in jax_proto.decode_record_batches(batch)]
    topics = [f"t{i}" for i in range(seed + 1)]
    assert port_proto.encode_subscription(topics) == jax_proto.encode_subscription(topics)
    assignment = {t: list(range(i + 1)) for i, t in enumerate(topics)}
    assert port_proto.encode_assignment(assignment) == jax_proto.encode_assignment(assignment)
    assert port_proto.decode_assignment(port_proto.encode_assignment(assignment)) == assignment
    members = [(f"m{i}", topics) for i in range(seed + 2)]
    counts = {t: 5 + i for i, t in enumerate(topics)}
    assert port_proto.range_assign(members, counts) == jax_proto.range_assign(members, counts)


def test_native_crc32c_matches_the_plain_version():
    rng = np.random.default_rng(0)
    assert port_proto.crc32c(b"123456789") == 0xE3069283 and port_proto.crc32c(b"") == 0
    for size in (1, 7, 8, 9, 63, 64, 1000, 65_537):
        data = bytes(rng.integers(0, 256, size, dtype=np.uint8))
        seed = int(rng.integers(0, 2**32))
        want = port_proto._crc32c_python(data, seed)
        assert port_proto.crc32c(data, seed) == want == jax_proto.crc32c(data, seed)
    assert "kafkacodec" in native.LOADED


async def _roundtrip(client, facade) -> dict:
    """``client``'s runtime against ``facade``: typed records through a
    reader, then a group member's out-of-order commits and a second member
    resuming at the watermark."""
    runtime = client.Runtime({"bootstrapServers": facade.bootstrap})
    try:
        admin = runtime.create_admin()
        await admin.create_topic(client.TopicSpec(name="t", partitions=1))
        producer = runtime.create_producer("p", {"topic": "t"})
        values = ["hello", {"a": [1, 2]}, b"\x00\x01", None, 2.5, "r5"]
        for i, value in enumerate(values):
            await producer.write(client.Record(value=value, key=f"k{i}", headers=(("h", i),)))
        reader = runtime.create_reader({"topic": "t"}, client.OffsetPosition.EARLIEST)
        read = await _drain(reader, len(values))
        await reader.close()
        consumer = runtime.create_consumer("a", {"topic": "t", "group": "g"})
        await consumer.start()
        got = await _drain(consumer, len(values))
        watermarks = []
        for index in (1, 3, 0, 2, 5):
            await consumer.commit([got[index]])
            watermarks.append(consumer.committed_offsets()[got[index].partition])
        await consumer.close()
        second = runtime.create_consumer("a", {"topic": "t", "group": "g"})
        await second.start()
        again = await _drain(second, 2)
        await second.commit(again)
        await second.close()
        await producer.close()
        return {"read": [(r.value, r.key, tuple(r.headers)) for r in read],
                "offsets": [r.offset for r in got], "watermarks": watermarks,
                "again": [r.value for r in again]}
    finally:
        await runtime.close()


async def _drain(source, want: int) -> list:
    out: list = []
    deadline = asyncio.get_running_loop().time() + WAIT_S
    while len(out) < want:
        assert asyncio.get_running_loop().time() < deadline, f"got {len(out)}/{want}"
        out.extend(await source.read(timeout=0.1))
    return out


@pytest.mark.parametrize("client,broker", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_client_against_a_facade(client, broker):
    async def main(client_name, broker_name):
        facade = await PACKAGES[broker_name].serve()
        try:
            return await _roundtrip(PACKAGES[client_name], facade)
        finally:
            await facade.close()

    got = asyncio.run(asyncio.wait_for(main(client, broker), 3 * WAIT_S))
    want = asyncio.run(asyncio.wait_for(main("jax", "jax"), 3 * WAIT_S))
    assert got == want
    assert want["watermarks"] == [0, 0, 2, 4, 4] and want["again"] == [2.5, "r5"]


@pytest.mark.parametrize("name", ["jax", "port"])
def test_group_join_sync_splits_partitions(name):
    """Two members joining at once land in one generation, one partition
    each (the range assignor); eight keyed records reach the group once."""
    pkg = PACKAGES[name]

    async def main():
        facade = await pkg.serve()
        runtime = pkg.Runtime({"bootstrapServers": facade.bootstrap})
        try:
            await runtime.create_admin().create_topic(pkg.TopicSpec(name="t2", partitions=2))
            one = runtime.create_consumer("a", {"topic": "t2", "group": "g2"})
            two = runtime.create_consumer("b", {"topic": "t2", "group": "g2"})
            await asyncio.gather(one.start(), two.start())
            deadline = asyncio.get_running_loop().time() + WAIT_S
            while not (len(one._assignment) == 1 and len(two._assignment) == 1):
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.gather(one.read(timeout=0.05), two.read(timeout=0.05))
            producer = runtime.create_producer("p", {"topic": "t2"})
            for i in range(8):
                await producer.write(pkg.Record(value=f"r{i}", key=f"k{i}"))
            got = []
            while len(got) < 8:
                assert asyncio.get_running_loop().time() < deadline
                for batch in await asyncio.gather(one.read(timeout=0.1), two.read(timeout=0.1)):
                    got.extend(batch)
            await asyncio.gather(one.close(), two.close())
            await producer.close()
            return sorted(one._assignment + two._assignment), sorted(
                (r.partition, r.offset, r.value) for r in got)
        finally:
            await runtime.close()
            await facade.close()

    assignment, got = asyncio.run(asyncio.wait_for(main(), 3 * WAIT_S))
    assert assignment == [0, 1] and sorted(v for *_, v in got) == [f"r{i}" for i in range(8)]
    # the stable key hash (crc32 of the key's text) routes each key, as JAX's
    assert {v: p for p, _, v in got} == {
        f"r{i}": zlib.crc32(f"k{i}".encode()) % 2 for i in range(8)}


USER_SCHEMA = {
    "type": "record", "name": "User",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "age", "type": "long"},
        {"name": "email", "type": ["null", "string"], "default": None},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "scores", "type": {"type": "map", "values": "double"}},
        {"name": "kind", "type": {"type": "enum", "name": "Kind", "symbols": ["A", "B"]}},
        {"name": "active", "type": "boolean"},
        {"name": "blob", "type": "bytes"},
        {"name": "ratio", "type": "float"},
        {"name": "id", "type": {"type": "fixed", "name": "Id", "size": 4}},
    ],
}


def seeded_users(seed: int, count: int = 6) -> list:
    rng = np.random.default_rng(seed)
    return [{
        "name": "".join(rng.choice(list("abcdé"), int(rng.integers(0, 8)))),
        "age": int(rng.integers(-2**40, 2**40)),
        "email": None if rng.random() < 0.5 else f"u{i}@example.com",
        "tags": [f"t{j}" for j in range(int(rng.integers(0, 4)))],
        "scores": {f"s{j}": float(rng.random()) for j in range(int(rng.integers(0, 3)))},
        "kind": "AB"[int(rng.integers(0, 2))],
        "active": bool(rng.integers(0, 2)),
        "blob": bytes(rng.integers(0, 256, int(rng.integers(0, 9)), dtype=np.uint8)),
        "ratio": 0.5 * int(rng.integers(-8, 8)),
        "id": bytes(rng.integers(0, 256, 4, dtype=np.uint8)),
    } for i in range(count)]


def test_avro_and_confluent_framing_like_jax():
    schema = port_avro.parse_schema(USER_SCHEMA)
    for i, user in enumerate(seeded_users(0)):
        payload = port_avro.encode(schema, user)
        assert payload == jax_avro.encode(jax_avro.parse_schema(USER_SCHEMA), user)
        assert port_avro.decode_bytes(USER_SCHEMA, payload) == user
        framed = port_avro.encode_confluent(i + 1, USER_SCHEMA, user)
        assert framed == jax_avro.encode_confluent(i + 1, USER_SCHEMA, user)
        assert port_avro.is_confluent_framed(framed) and port_avro.split_confluent(framed) == (
            i + 1, payload)
    assert not port_avro.is_confluent_framed(b"plain text")


class FakeRegistry:
    """A Confluent Schema Registry's two routes over ``http.server`` in a
    thread: ``GET /schemas/ids/N`` and ``POST /subjects/S/versions``."""

    def __init__(self, schemas: dict) -> None:
        self.schemas = dict(schemas)
        self.requests: list = []
        registry = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, status, doc):
                body = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/vnd.schemaregistry.v1+json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                registry.requests.append(("GET", self.path))
                schema_id = int(self.path.rsplit("/", 1)[1])
                if schema_id not in registry.schemas:
                    return self._reply(404, {"error_code": 40403})
                self._reply(200, {"schema": json.dumps(registry.schemas[schema_id])})

            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                registry.requests.append(("POST", self.path, body))
                schema_id = 100 + len(registry.schemas)
                registry.schemas[schema_id] = json.loads(body["schema"])
                self._reply(200, {"id": schema_id})

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.parametrize("name", ["jax", "port"])
def test_schema_registry_on_a_local_fake(name):
    """A foreign Confluent-framed record decodes to its dict through the
    consumer (the schema fetched once, then cached), the package's own
    records pass untouched, and ``register`` posts the schema; the fake
    sees the same requests from either package."""
    evt = {"type": "record", "name": "Evt", "fields": [{"name": "q", "type": "string"}]}

    async def main(pkg, url):
        facade = await pkg.serve()
        runtime = pkg.Runtime({"bootstrapServers": facade.bootstrap, "schemaRegistryUrl": url})
        try:
            await runtime.create_admin().create_topic(pkg.TopicSpec(name="t"))
            for word in ("hello", "again"):
                framed = pkg.avro.encode_confluent(42, evt, {"q": word})
                await runtime._client.produce(  # noqa: SLF001 — a foreign producer's bytes
                    "t", 0, pkg.proto.encode_record_batch([(None, framed, [], 1000)]))
            await runtime.create_producer("p", {"topic": "t"}).write(
                pkg.Record(value={"native": True}))
            consumer = runtime.create_consumer("a", {"topic": "t", "group": "g"})
            await consumer.start()
            got = await _drain(consumer, 3)
            await consumer.close()
            client = pkg.avro.SchemaRegistryClient(url)
            schema_id = await client.register("t-value", evt)
            await client.close()
            return [r.value for r in got], schema_id
        finally:
            await runtime.close()
            await facade.close()

    outcome = {}
    for pkg_name in (name, "jax"):
        with FakeRegistry({42: evt}) as registry:
            got = asyncio.run(asyncio.wait_for(main(PACKAGES[pkg_name], registry.url), 3 * WAIT_S))
            outcome[pkg_name] = (got, registry.requests)
    assert outcome[name] == outcome["jax"]
    (values, schema_id), requests = outcome[name]
    assert values == [{"q": "hello"}, {"q": "again"}, {"native": True}] and schema_id == 101
    assert [r[:2] for r in requests] == [("GET", "/schemas/ids/42"),
                                         ("POST", "/subjects/t-value/versions")]
