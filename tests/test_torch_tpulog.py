"""The port's ``tpulog`` broker (``langstream_tpu_torch/topics/log/``) held
against the JAX package's:

- the native store (``native/logstore.cpp``, built with g++) and the
  port's pure-Python reference write the same bytes, segment rolls and a
  torn tail's recovery included;
- a topic directory written by either package's broker is read by the
  other's, records and group watermarks alike;
- the committed watermarks persist across a served broker's restart;
- the port's client against the JAX ``BrokerServer`` and the JAX client
  against the port's, consumer groups and readers included;
- ``python -m langstream_tpu_torch broker DIR`` serves a directory as a
  process of its own.
"""

from __future__ import annotations

import asyncio
import os
import pathlib
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

import langstream_tpu.api.records as jax_records
import langstream_tpu.api.topics as jax_topics
import langstream_tpu.topics.log.broker as jax_broker
import langstream_tpu.topics.log.client as jax_client
import langstream_tpu.topics.log.server as jax_server
import langstream_tpu_torch.api.records as port_records
import langstream_tpu_torch.api.topics as port_topics
import langstream_tpu_torch.topics.log.broker as port_broker
import langstream_tpu_torch.topics.log.client as port_client
import langstream_tpu_torch.topics.log.server as port_server
import langstream_tpu_torch.topics.log.store as port_store
from langstream_tpu_torch import native

REPO = pathlib.Path(__file__).resolve().parents[1]
WAIT_S = 20.0
JAX = dict(records=jax_records, topics=jax_topics, broker=jax_broker, client=jax_client,
           server=jax_server)
PORT = dict(records=port_records, topics=port_topics, broker=port_broker, client=port_client,
            server=port_server)


def seeded_payloads(seed: int, count: int) -> list:
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8))
            for _ in range(count)]


def tree(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_native_store_writes_the_python_references_bytes(tmp_path):
    """Appends across segment rolls, then a reopen after a torn tail: the
    same files, byte for byte, and the same reads."""
    payloads = seeded_payloads(0, 60)
    logs = {}
    for name, opener in (("native", port_store.open_partition_log),
                         ("python", port_store._PyPartitionLog)):
        directory = tmp_path / name
        log = opener(str(directory), 2048)
        offsets = [log.append(p) for p in payloads]
        log.sync()
        assert offsets == list(range(60))
        log.close()
        logs[name] = directory
    assert native.LOADED["logstore"].startswith(str(REPO / "build" / "native"))
    assert tree(logs["native"]) == tree(logs["python"])
    assert len(list(logs["native"].glob("*.log"))) > 3  # rolled
    for name, directory in logs.items():
        last = sorted(directory.glob("*.log"))[-1]
        with open(last, "ab") as handle:
            handle.write(b"\x07\x00\x00\x00torn")  # a frame cut short
    reads = {}
    for name, opener in (("native", port_store.open_partition_log),
                         ("python", port_store._PyPartitionLog)):
        log = opener(str(logs[name]), 2048)
        assert log.end_offset() == 60
        log.append(b"after")
        reads[name] = log.read_batch(0, 100)
        log.close()
    assert tree(logs["native"]) == tree(logs["python"])
    assert reads["native"] == reads["python"] == list(enumerate(payloads + [b"after"]))


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_segments_and_watermarks_cross_packages(writer, reader, tmp_path):
    """One package's broker writes a topic of two partitions and commits a
    group out of order; the other's opens the directory: the same records
    at the same coordinates, the same watermarks, and its files unchanged
    by the reopen."""
    pkgs = {"jax": JAX, "port": PORT}
    w, r = pkgs[writer], pkgs[reader]
    rng = np.random.default_rng(5)
    values = [{"i": i, "x": float(x)} for i, x in enumerate(rng.random(12))]

    async def write():
        broker = w["broker"].LogBroker(str(tmp_path), segment_bytes=512)
        runtime = w["broker"].LogTopicConnectionsRuntime(broker)
        await runtime.create_admin().create_topic(w["topics"].TopicSpec(name="t", partitions=2))
        producer = runtime.create_producer("p", {"topic": "t"})
        for i, value in enumerate(values):
            await producer.write(w["records"].Record(value=value, key=f"k{i % 5}",
                                                     headers=(("n", i),)))
        consumer = runtime.create_consumer("c", {"topic": "t", "group": "g"})
        got = []
        while len(got) < len(values):
            got += await consumer.read(100, 0.05)
        await consumer.commit([x for x in got if x.offset % 3 != 2])
        await consumer.close()
        await runtime.close()
        return [(x.partition, x.offset, x.value, x.key, tuple(x.headers)) for x in got]

    async def read():
        broker = r["broker"].LogBroker(str(tmp_path))
        got = []
        for partition in range(2):
            got += broker.fetch("t", partition, 0, 100)
        committed = broker.group("t", "g").committed
        broker.close()
        return [(x.partition, x.offset, x.value, x.key, tuple(x.headers)) for x in got], committed

    written = asyncio.run(write())
    before = tree(tmp_path)
    seen, committed = asyncio.run(read())
    assert sorted(seen) == sorted(written)
    assert tree(tmp_path) == before
    ends = {p: max(o for q, o, *_ in written if q == p) + 1 for p in (0, 1)}
    assert committed == [min(ends[p], 2) for p in (0, 1)]


def test_watermarks_persist_across_a_served_restart(tmp_path):
    """A served broker stops and a new one serves the same directory: a
    group member resumes at the committed watermark, the acks past its gap
    delivered again."""
    async def main():
        server = await port_server.serve(str(tmp_path), port=0)
        runtime = port_client.RemoteTopicConnectionsRuntime(server.address)
        producer = runtime.create_producer("p", {"topic": "t"})
        for i in range(6):
            await producer.write(port_records.Record(value=f"r{i}"))
        consumer = runtime.create_consumer("c", {"topic": "t", "group": "g"})
        got = []
        while len(got) < 6:
            got += await consumer.read(100, 0.05)
        await consumer.commit([got[i] for i in (0, 1, 4)])
        await consumer.close()
        await producer.close()
        await server.close()
        server.broker.close()
        server = await port_server.serve(str(tmp_path), port=0)
        runtime = port_client.RemoteTopicConnectionsRuntime(server.address)
        consumer = runtime.create_consumer("c", {"topic": "t", "group": "g"})
        again = []
        deadline = asyncio.get_running_loop().time() + WAIT_S
        while len(again) < 4 and asyncio.get_running_loop().time() < deadline:
            again += await consumer.read(100, 0.05)
        await consumer.commit(again)
        await consumer.close()
        committed = server.broker.group("t", "g").committed
        await server.close()
        server.broker.close()
        return [x.value for x in again], committed

    again, committed = asyncio.run(main())
    assert again == ["r2", "r3", "r4", "r5"] and committed == [6]


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_client_against_the_other_packages_server(client, server, tmp_path):
    """Produce, a group of two members splitting two partitions, commits, a
    member leaving (its partitions and uncommitted records move to the
    other), and a reader from the earliest offset."""
    pkgs = {"jax": JAX, "port": PORT}
    c, s = pkgs[client], pkgs[server]

    async def main():
        served = await s["server"].serve(str(tmp_path), port=0)
        broker = served.broker
        broker.create_topic(s["topics"].TopicSpec(name="t", partitions=2))
        runtime = c["client"].RemoteTopicConnectionsRuntime(served.address)
        producer = runtime.create_producer("p", {"topic": "t"})
        for i in range(10):
            await producer.write(c["records"].Record(value={"i": i}, key=f"k{i}"))
        one = runtime.create_consumer("a", {"topic": "t", "group": "g"})
        two = runtime.create_consumer("b", {"topic": "t", "group": "g"})
        await one.start()
        await two.start()
        got_one, got_two = [], []
        deadline = asyncio.get_running_loop().time() + WAIT_S
        while len(got_one) + len(got_two) < 10:
            assert asyncio.get_running_loop().time() < deadline
            got_one += await one.read(100, 0.05)
            got_two += await two.read(100, 0.05)
        assert got_one and got_two  # the partitions split across the members
        await one.commit(got_one)
        await two.close()  # leaves uncommitted: its records move to `one`
        moved = []
        while len(moved) < len(got_two):
            assert asyncio.get_running_loop().time() < deadline
            moved += await one.read(100, 0.05)
        await one.commit(moved)
        await one.close()
        reader = runtime.create_reader({"topic": "t"}, c["topics"].OffsetPosition.EARLIEST)
        everything = []
        while len(everything) < 10:
            assert asyncio.get_running_loop().time() < deadline
            everything += await reader.read(100, 0.05)
        await reader.close()
        await producer.close()
        committed = broker.group("t", "g").committed
        ends = broker.end_offsets("t")
        await served.close()
        broker.close()
        key = lambda r: (r.partition, r.offset)  # noqa: E731
        return (sorted((r.partition, r.offset, r.value["i"]) for r in moved),
                sorted((r.partition, r.offset, r.value["i"]) for r in got_two),
                sorted(r.value["i"] for r in everything), committed == ends,
                sorted(map(key, got_one + got_two)) == sorted(map(key, everything)))

    moved, lost, everything, all_committed, same = asyncio.run(
        asyncio.wait_for(main(), 3 * WAIT_S))
    assert moved == lost and everything == list(range(10)) and all_committed and same


def test_a_member_evicted_while_silent_rejoins_on_its_next_poll(tmp_path):
    """A member that joined and then stayed silent past the session
    timeout (an agent runner whose engine is still starting) is evicted;
    its next poll joins it again and it reads its partition. The JAX
    server's poll only touches such a member, which then holds no
    partition for good, so only the port's server is held here."""
    async def main():
        server = port_server.BrokerServer(port_broker.LogBroker(str(tmp_path)), port=0,
                                          session_timeout=0.2)
        await server.start()
        runtime = port_client.RemoteTopicConnectionsRuntime(server.address)
        producer = runtime.create_producer("p", {"topic": "t"})
        await producer.write(port_records.Record(value="hello"))
        consumer = runtime.create_consumer("c", {"topic": "t", "group": "g"})
        await consumer.start()
        joined = server.broker.group("t", "g").generation
        await asyncio.sleep(0.5)  # silent past the session timeout
        got = []
        deadline = asyncio.get_running_loop().time() + WAIT_S
        while not got and asyncio.get_running_loop().time() < deadline:
            got += await consumer.read(10, 0.05)
        # evicted (one generation), then joined again (another)
        generations = server.broker.group("t", "g").generation - joined
        await consumer.close()
        await producer.close()
        await server.close()
        server.broker.close()
        return generations, [r.value for r in got]

    assert asyncio.run(main()) == (2, ["hello"])


def test_broker_cli_serves_a_directory(tmp_path):
    """``python -m langstream_tpu_torch broker DIR --port 0`` prints its
    address and the native log store it loaded; records produced through
    it land in DIR, and SIGTERM stops it."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    process = subprocess.Popen(
        [sys.executable, "-m", "langstream_tpu_torch", "broker", str(tmp_path), "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        line = process.stdout.readline()
        found = re.search(r"on (\S+:\d+) \(native log store (\S+)\)$", line.strip())
        address = found.group(1)
        assert found.group(2) == native.library_path("logstore")

        async def produce():
            runtime = port_client.RemoteTopicConnectionsRuntime(address)
            producer = runtime.create_producer("p", {"topic": "cli"})
            await producer.write(port_records.Record(value="hello"))
            await producer.close()

        asyncio.run(produce())
    finally:
        process.send_signal(signal.SIGTERM)
        assert process.wait(timeout=30) == 0
    broker = jax_broker.LogBroker(str(tmp_path))
    assert [r.value for r in broker.fetch("cli", 0, 0, 10)] == ["hello"]
    broker.close()
