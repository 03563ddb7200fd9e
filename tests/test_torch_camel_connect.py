"""The port's ``camel-source`` (``agents/camel.py``) and Kafka Connect
agents (``agents/kafka_connect.py``) against the JAX package's, one
scenario through both packages' agents (``tests/torch_agent_pair.py``):

- ``camel-source`` for each scheme the port maps: ``timer``, ``file``,
  ``http`` polling, ``kafka`` (each package's Kafka facade broker),
  ``netty-http`` (an HTTP server of the agent's own), ``aws2-s3`` and
  ``azure-storage-blob`` (the local fakes of ``test_torch_connectors.py``,
  which recompute SigV4 and Shared Key);
- the ``pulsar:`` scheme: planned as JAX plans it, refused by name when
  the port's agent is built;
- ``kafka-connect-source`` and ``kafka-connect-sink`` against
  ``tests/connect_worker_mock.py`` (a Connect worker's REST API) and each
  package's Kafka facade: the connector's lifecycle, the data topics, the
  409s of a rebalance retried, a FAILED task restarted.
"""

from __future__ import annotations

import asyncio
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import langstream_tpu.topics.kafka.runtime as jax_kafka_runtime
import langstream_tpu.topics.kafka.server as jax_kafka_server
import langstream_tpu_torch.topics.kafka.runtime as port_kafka_runtime
import langstream_tpu_torch.topics.kafka.server as port_kafka_server
from connect_worker_mock import MockConnectWorker
from test_torch_connectors import (
    ACCESS,
    ACCOUNT,
    ACCOUNT_KEY,
    REGION,
    SECRET,
    api_route,
    azure_route,
    s3_route,
    seeded_objects,
    serving,
)
from torch_agent_pair import PACKAGES, WAIT_S, fields, make, read_until

KAFKA = {
    id(PACKAGES["jax"]): types.SimpleNamespace(serve=jax_kafka_server.serve_kafka_facade,
                                               Runtime=jax_kafka_runtime.KafkaTopicConnectionsRuntime),
    id(PACKAGES["port"]): types.SimpleNamespace(serve=port_kafka_server.serve_kafka_facade,
                                                Runtime=port_kafka_runtime.KafkaTopicConnectionsRuntime),
}


def run_both(scenario) -> dict:
    return {name: asyncio.run(asyncio.wait_for(scenario(pkg), 3 * WAIT_S))
            for name, pkg in PACKAGES.items()}


def kafka_of(pkg):
    return KAFKA[id(pkg)]


async def camel(pkg, uri: str, **config):
    return await make(pkg, "camel-source", {"component-uri": uri, **config})


async def timer_case(pkg, tmp_path, _server):
    agent = await camel(pkg, "timer:tick?period=20&repeatCount=3", **{"key-header": "timer"})
    records = await read_until(agent, 3)
    after = await agent.read()
    await agent.close()
    # firedTime is the clock's: compared by name only
    return [(r.value, r.key, [name for name, _ in r.headers]) for r in records], after


async def file_case(pkg, tmp_path, _server):
    root = tmp_path / f"camel-files-{id(pkg)}"
    root.mkdir()
    for name, data in seeded_objects().items():
        if "/" not in name:
            (root / name).write_bytes(data)
    agent = await camel(pkg, f"file:{root}?delete=true&fileExtensions=txt,md&delay=0")
    records = await read_until(agent, 4)
    await agent.commit(records)
    again = await agent.read()
    await agent.close()
    return [fields(r) for r in records], again, sorted(p.name for p in root.iterdir())


async def http_case(pkg, tmp_path, server):
    agent = await camel(pkg, f"{server.base}/api?ids=1&ids=2&delay=10")
    records = await read_until(agent, 2)
    await agent.close()
    return [(r.value, r.header("CamelHttpResponseCode"), r.header("Content-Type"))
            for r in records]


async def kafka_case(pkg, tmp_path, _server):
    kafka = kafka_of(pkg)
    facade = await kafka.serve()
    runtime = kafka.Runtime({"bootstrapServers": facade.bootstrap})
    try:
        facade.create_topic("orders")
        producer = runtime.create_producer("p", {"topic": "orders"})
        rng = np.random.default_rng(6)
        for i in range(5):
            await producer.write(pkg.Record(value={"n": int(rng.integers(0, 99))}, key=f"o{i}",
                                            headers=(("h", str(i)),)))
        uri = f"kafka:orders?brokers={facade.bootstrap}&groupId=g"
        agent = await camel(pkg, uri)
        records = await read_until(agent, 5)
        await agent.commit(records[:3])
        await agent.close()
        second = await camel(pkg, uri)
        again = await read_until(second, 2)
        await second.commit(again)
        await second.close()
        await producer.close()
        return [fields(r) for r in records], [fields(r) for r in again]
    finally:
        await runtime.close()
        await facade.close()


def _send(url: str, method: str, body: bytes = b""):
    request = urllib.request.Request(url, data=body or None, method=method,
                                     headers={"Content-Type": "text/plain", "X-Test": "1"})
    try:
        with urllib.request.urlopen(request, timeout=WAIT_S) as response:
            return response.status
    except urllib.error.HTTPError as error:
        return error.code


async def netty_case(pkg, tmp_path, _server):
    agent = await camel(pkg, "netty-http:http://127.0.0.1:0/ingest")
    base = f"http://127.0.0.1:{agent.bound_port}"
    statuses = [await asyncio.to_thread(_send, base + "/ingest?a=1", "POST", b"first"),
                await asyncio.to_thread(_send, base + "/ingest/sub/x", "PUT", b"second"),
                await asyncio.to_thread(_send, base + "/elsewhere", "POST", b"lost")]
    records = await read_until(agent, 2)
    await agent.close()
    port = str(agent.bound_port)
    # the Host header names the port each agent bound
    return statuses, [(r.value, r.key, tuple((k, v.replace(port, "PORT") if k == "Host" else v)
                                             for k, v in r.headers)) for r in records]


async def s3_case(pkg, tmp_path, server):
    server.objects.clear()
    server.objects.update(seeded_objects())
    uri = (f"aws2-s3://docs?accessKey={ACCESS}&region={REGION}&delay=0"
           f"&uriEndpointOverride={server.base}&fileExtensions=txt")
    agent = await camel(pkg, uri, **{"component-options": {"secretKey": SECRET}})
    records = await read_until(agent, 4)
    await agent.commit(records)
    await agent.close()
    return [fields(r) for r in records], sorted(server.objects)


async def azure_case(pkg, tmp_path, server):
    server.objects.clear()
    server.objects.update(seeded_objects())
    connection = (f"DefaultEndpointsProtocol=http;AccountName={ACCOUNT};"
                  f"AccountKey={ACCOUNT_KEY};BlobEndpoint={server.base}/{ACCOUNT};")
    agent = await camel(pkg, f"azure-storage-blob://{ACCOUNT}/box?fileExtensions=txt&delay=0"
                             "&deleteAfterRead=false",
                        **{"component-options": {"connectionString": connection}})
    records = await read_until(agent, 4)
    await agent.commit(records)
    await agent.close()
    return [fields(r) for r in records], sorted(server.objects)


CASES = {"timer": (timer_case, None), "file": (file_case, None), "http": (http_case, "api"),
         "kafka": (kafka_case, None), "netty-http": (netty_case, None),
         "aws2-s3": (s3_case, "s3"), "azure-storage-blob": (azure_case, "azure")}
WANT_COUNTS = {"timer": 3, "file": 4, "http": 2, "kafka": 5, "netty-http": 2, "aws2-s3": 4,
               "azure-storage-blob": 4}


@pytest.mark.parametrize("scheme", sorted(CASES))
def test_camel_source_like_jax(scheme, tmp_path):
    case, fake = CASES[scheme]
    objects: dict = {}
    routes = {"api": lambda: api_route, "s3": lambda: s3_route(objects),
              "azure": lambda: azure_route(objects, sas=False)}
    if fake is None:
        got = run_both(lambda pkg: case(pkg, tmp_path, None))
    else:
        with serving(routes[fake]()) as server:
            server.objects = objects
            got = run_both(lambda pkg: case(pkg, tmp_path, server))
    assert got["port"] == got["jax"]
    first = {"http": got["port"], "netty-http": got["port"][1]}.get(scheme, got["port"][0])
    assert len(first) == WANT_COUNTS[scheme]
    if scheme == "timer":
        assert first[0] == (None, "tick", ["timer", "firedTime"]) and got["port"][1] == []
    if scheme == "file":
        assert got["port"][1] == [] and got["port"][2] == ["e.bin"]
    if scheme == "kafka":
        assert [key for _, key, _ in got["port"][1]] == ["o3", "o4"]  # past the watermark
        assert first[0][2][-1] == ("kafka.TOPIC", "orders")
    if scheme == "netty-http":
        assert got["port"][0] == [200, 200, 404]
        assert [value for value, _, _ in first] == [b"first", b"second"]
    if scheme == "aws2-s3":
        assert got["port"][1] == ["b.md", "e.bin"]  # deleteAfterRead defaults true


def test_camel_pulsar_is_planned_like_jax_and_refused_by_name():
    """``pulsar:`` URIs pass or fail the plan-time check as JAX's do; the
    port's agent refuses the scheme by name, naming the ROADMAP item."""
    from langstream_tpu.agents import camel as jax_camel
    from langstream_tpu_torch.agents import camel as port_camel

    for uri in ("pulsar:", "pulsar:persistent://public/default/t?webServiceUrl=http://h:8080"):
        assert port_camel.validate_component_uri(uri) == jax_camel.validate_component_uri(uri)

    async def build():
        await make(PACKAGES["port"], "camel-source", {
            "component-uri": "pulsar:persistent://public/default/t?webServiceUrl=http://h:8080"},
            start=False)

    with pytest.raises(ValueError, match=r"pulsar: scheme is not yet ported.*ROADMAP A7\.4"):
        asyncio.run(build())


async def connect_roundtrip(pkg):
    kafka = kafka_of(pkg)
    broker = await kafka.serve()
    worker = await MockConnectWorker().start()
    runtime = kafka.Runtime({"bootstrapServers": broker.bootstrap})
    try:
        source = await make(pkg, "kafka-connect-source", {
            "connect-url": worker.url, "connector-name": "jdbc-in",
            "connector-config": {"connector.class": "JdbcSourceConnector", "tasks.max": 2},
            "topic": "from-connector", "bootstrapServers": broker.bootstrap,
            "delete-on-close": True, "health-check-interval": 0})
        created = (sorted(worker.connectors), worker.task_states("jdbc-in"))
        external = runtime.create_producer("ext", {"topic": "from-connector"})
        for i in range(3):
            await external.write(pkg.Record(value={"row": i}, key=f"r{i}"))
        rows = await read_until(source, 3)
        await source.commit(rows)
        await source.close()
        deleted = sorted(worker.connectors)
        sink = await make(pkg, "kafka-connect-sink", {
            "connect-url": worker.url, "connector-name": "es-out",
            "connector-config": {"connector.class": "ElasticsearchSinkConnector"},
            "topic": "to-connector", "bootstrapServers": broker.bootstrap})
        for i in range(2):
            await sink.write(pkg.Record(value=f"doc-{i}", key=f"d{i}"))
        reader = runtime.create_reader({"topic": "to-connector"}, pkg.OffsetPosition.EARLIEST)
        staged = await read_until(types.SimpleNamespace(read=lambda: reader.read(timeout=0.2)), 2)
        await reader.close()
        await sink.close()
        await external.close()
        requests = [(method, path) for method, path in worker.requests]
        return (created, [fields(r) for r in rows], deleted,
                worker.connectors["es-out"]["config"], [fields(r) for r in staged], requests)
    finally:
        await runtime.close()
        await worker.close()
        await broker.close()


def test_kafka_connect_source_and_sink_like_jax():
    got = run_both(connect_roundtrip)
    assert got["port"] == got["jax"]
    created, rows, deleted, sink_config, staged, _ = got["port"]
    assert created == (["jdbc-in"], ["RUNNING", "RUNNING"]) and deleted == []
    assert [value for value, _, _ in rows] == [{"row": i} for i in range(3)]
    assert sink_config["topics"] == "to-connector" and len(staged) == 2


async def connect_faults(pkg):
    """A rebalance's 409s waited out on create; a FAILED task restarted
    by the health check; a rebalance that never ends failing loudly."""
    kafka = kafka_of(pkg)
    broker = await kafka.serve()
    worker = await MockConnectWorker().start()
    try:
        broker.create_topic("rb-topic")
        worker.start_rebalance()

        async def end_later():
            await asyncio.sleep(0.5)
            worker.end_rebalance()

        ender = asyncio.ensure_future(end_later())
        source = await make(pkg, "kafka-connect-source", {
            "connect-url": worker.url, "connector-name": "rb-conn",
            "connector-config": {"connector.class": "X", "tasks.max": 1},
            "topic": "rb-topic", "bootstrapServers": broker.bootstrap,
            "rebalance-timeout": 10, "health-check-interval": 0.01})
        await ender
        puts = sum(1 for m, p in worker.requests if m == "PUT" and p.endswith("/config"))
        worker.fail_task("rb-conn", 0, "boom")
        await asyncio.sleep(0.05)
        await source.read()
        restarted = worker.task_states("rb-conn")
        await source.close()
        worker.start_rebalance()
        stuck = await make(pkg, "kafka-connect-source", {
            "connect-url": worker.url, "connector-name": "stuck",
            "connector-config": {"connector.class": "X"}, "topic": "rb-topic",
            "bootstrapServers": broker.bootstrap, "rebalance-timeout": 0.3}, start=False)
        try:
            await stuck.start()
            failure = None
        except IOError as error:
            failure = "409" in str(error)
        await stuck.rest.close()
        await stuck._runtime.close()  # noqa: SLF001
        return puts >= 2, restarted, failure
    finally:
        await worker.close()
        await broker.close()


def test_kafka_connect_rebalance_and_failed_task_like_jax():
    got = run_both(connect_faults)
    assert got["port"] == got["jax"] == (True, ["RUNNING"], True)
