"""The topic contract of ``tests/test_topic_contract.py`` over the port's
brokers, each case held against the JAX package's runtime of the same kind
on the same seeded records.

One parametrised test, over the broker (``memory``, ``tpulog`` embedded
over a directory, ``tpulog`` served by a ``BrokerServer`` over TCP, and
``kafka`` against the package's own ``KafkaFacadeBroker``) and the
scenario:

- ``roundtrip``: typed payloads (text, JSON documents, raw bytes, None,
  numbers), keys and headers come back as they were written;
- ``redeliver``: out-of-order commits advance the group only over the
  contiguous watermark, and what is past it returns to the next member;
- ``latest``: a reader at ``latest`` sees only what is written after it
  starts.

Each package runs the scenario over its own broker and client; the
outcomes, plain data, must be equal.
"""

from __future__ import annotations

import asyncio
import contextlib
import types

import numpy as np
import pytest

import langstream_tpu.api.records as jax_records
import langstream_tpu.api.topics as jax_topics
import langstream_tpu.topics as jax_registry
import langstream_tpu.topics.kafka.server as jax_kafka_server
import langstream_tpu.topics.log.server as jax_log_server
import langstream_tpu_torch.api.records as port_records
import langstream_tpu_torch.api.topics as port_topics
import langstream_tpu_torch.topics as port_registry
import langstream_tpu_torch.topics.kafka.server as port_kafka_server
import langstream_tpu_torch.topics.log.server as port_log_server

PACKAGES = {
    name: types.SimpleNamespace(Record=records.Record, OffsetPosition=topics.OffsetPosition,
                                TopicSpec=topics.TopicSpec,
                                create_topic_runtime=registry.create_topic_runtime,
                                serve_log=log_server.serve, serve_kafka=kafka_server.serve_kafka_facade)
    for name, records, topics, registry, log_server, kafka_server in (
        ("jax", jax_records, jax_topics, jax_registry, jax_log_server, jax_kafka_server),
        ("port", port_records, port_topics, port_registry, port_log_server, port_kafka_server))
}
BROKERS = ["memory", "tpulog", "tpulog-served", "kafka"]
WAIT_S = 20.0


@contextlib.asynccontextmanager
async def runtime_of(pkg, kind: str, directory):
    stop = []
    if kind == "memory":
        runtime = pkg.create_topic_runtime({"type": "memory"})
    elif kind == "tpulog":
        runtime = pkg.create_topic_runtime(
            {"type": "tpulog", "configuration": {"directory": str(directory)}})
    elif kind == "tpulog-served":
        server = await pkg.serve_log(str(directory), port=0)
        stop += [server.close, server.broker.close]
        runtime = pkg.create_topic_runtime(
            {"type": "tpulog", "configuration": {"address": server.address}})
    else:
        facade = await pkg.serve_kafka()
        stop.append(facade.close)
        runtime = pkg.create_topic_runtime(
            {"type": "kafka", "configuration": {"bootstrapServers": facade.bootstrap}})
    try:
        yield runtime
    finally:
        await runtime.close()
        for fn in stop:
            result = fn()
            if asyncio.iscoroutine(result):
                await result


async def drain(source, want: int) -> list:
    out: list = []
    deadline = asyncio.get_running_loop().time() + WAIT_S
    while len(out) < want:
        if asyncio.get_running_loop().time() > deadline:
            raise TimeoutError(f"got {len(out)}/{want}")
        out.extend(await source.read(timeout=0.1))
    return out


def seeded_payloads(seed: int, count: int = 8) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        kind = i % 5
        if kind == 0:
            out.append("text-" + "".join(rng.choice(list("abcdef"), 6)))
        elif kind == 1:
            out.append({"nested": [int(x) for x in rng.integers(0, 100, 3)], "i": i})
        elif kind == 2:
            out.append(bytes(rng.integers(0, 256, 5, dtype=np.uint8)))
        elif kind == 3:
            out.append(None)
        else:
            out.append(float(rng.integers(0, 1000)) / 8)
    return out


async def roundtrip(pkg, runtime) -> list:
    admin = runtime.create_admin()
    await admin.create_topic(pkg.TopicSpec(name="t"))
    await admin.close()
    producer = runtime.create_producer("p", {"topic": "t"})
    await producer.start()
    payloads = seeded_payloads(7)
    for i, value in enumerate(payloads):
        await producer.write(pkg.Record(value=value, key=f"k{i % 3}",
                                        headers=(("h-str", f"x{i}"), ("h-bytes", bytes([i])))))
    reader = runtime.create_reader({"topic": "t"}, pkg.OffsetPosition.EARLIEST)
    await reader.start()
    got = await drain(reader, len(payloads))
    await producer.close()
    await reader.close()
    assert [r.value for r in got] == payloads
    return [(r.value, r.key, tuple(r.headers)) for r in got]


async def redeliver(pkg, runtime) -> tuple:
    admin = runtime.create_admin()
    await admin.create_topic(pkg.TopicSpec(name="t"))
    await admin.close()
    producer = runtime.create_producer("p", {"topic": "t"})
    await producer.start()
    for i in range(8):
        await producer.write(pkg.Record(value=f"r{i}"))
    consumer = runtime.create_consumer("a", {"topic": "t", "group": "g"})
    await consumer.start()
    first = await drain(consumer, 8)
    # acks out of order: 0, 1, 2 and a seeded few past the gap at 3
    rng = np.random.default_rng(3)
    later = sorted(int(i) for i in rng.choice(np.arange(4, 8), 2, replace=False))
    acked = [first[i] for i in [2, 0, *later, 1]]
    for record in acked:
        await consumer.commit([record])
    await consumer.close()
    second = runtime.create_consumer("a", {"topic": "t", "group": "g"})
    await second.start()
    again = await drain(second, 5)  # everything from the watermark at 3 on
    extra = await second.read(timeout=0.3)
    await second.commit(again + extra)
    await second.close()
    await producer.close()
    return [r.value for r in first], later, [r.value for r in again + extra]


async def latest(pkg, runtime) -> tuple:
    admin = runtime.create_admin()
    await admin.create_topic(pkg.TopicSpec(name="t"))
    await admin.close()
    producer = runtime.create_producer("p", {"topic": "t"})
    await producer.start()
    await producer.write(pkg.Record(value="old"))
    reader = runtime.create_reader({"topic": "t"}, pkg.OffsetPosition.LATEST)
    await reader.start()
    before = await reader.read(timeout=0.2)
    await producer.write(pkg.Record(value="new"))
    got = await drain(reader, 1)
    await producer.close()
    await reader.close()
    return [r.value for r in before], [r.value for r in got]


SCENARIOS = {"roundtrip": roundtrip, "redeliver": redeliver, "latest": latest}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("kind", BROKERS)
def test_topic_contract_like_jax(kind, scenario, tmp_path):
    async def run(name):
        pkg = PACKAGES[name]
        async with runtime_of(pkg, kind, tmp_path / name) as runtime:
            return await SCENARIOS[scenario](pkg, runtime)

    got = {name: asyncio.run(asyncio.wait_for(run(name), 3 * WAIT_S)) for name in PACKAGES}
    assert got["port"] == got["jax"]
    if scenario == "redeliver":
        values, _later, again = got["port"]
        assert values == [f"r{i}" for i in range(8)] and again == values[3:]
    if scenario == "latest":
        assert got["port"] == ([], ["new"])
