"""The port's memory broker and agent runner against the JAX package's, on
the same records, without a model.

- The broker: key partitioning, offsets, out-of-order commits advancing
  only the contiguous watermark, a rebalance's redelivery, readers at
  ``EARLIEST`` and ``LATEST``: the same records, partitions, offsets and
  committed watermarks as JAX's ``MemoryBroker``.
- An app of ``document-to-json`` and a chain of the GenAI model-free
  steps (``drop-fields``, ``compute``, ``merge-key-value``, ``cast``,
  ``flatten``): the output records (value, key, headers but the minted
  timestamp, partition, offset) and the committed offsets equal JAX's.
- An agent that raises on some records, under each ``errors`` setting
  (``fail``, ``skip``, ``dead-letter``, with a retry): the output and
  dead-letter topics, the commits and the runner's counters equal JAX's,
  and ``fail`` stops both runners with the agent's error.
- ``run_application`` of the port on the tiny completions app, in a
  subprocess, leaves ``yaml``, ``aiohttp``, ``jax`` and ``langstream_tpu``
  out of ``sys.modules``.
"""

import asyncio
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from langstream_tpu.api import agent as jax_agent
from langstream_tpu.api.records import Record as JaxRecord
from langstream_tpu.api.topics import OffsetPosition as JaxOffsetPosition
from langstream_tpu.api.topics import TopicSpec as JaxTopicSpec
from langstream_tpu.runtime import registry as jax_registry
from langstream_tpu.runtime.local import run_application as jax_run_application
from langstream_tpu.topics.memory import MemoryTopicConnectionsRuntime as JaxRuntime
from langstream_tpu_torch.api import agent as port_agent
from langstream_tpu_torch.api.records import Record
from langstream_tpu_torch.api.topics import OffsetPosition, TopicSpec
from langstream_tpu_torch.runtime import registry as port_registry
from langstream_tpu_torch.runtime.local import run_application
from langstream_tpu_torch.topics.memory import MemoryTopicConnectionsRuntime

REPO = pathlib.Path(__file__).resolve().parents[1]

PACKAGES = {
    "jax": dict(record=JaxRecord, runtime=JaxRuntime, spec=JaxTopicSpec,
                position=JaxOffsetPosition, run=lambda app: jax_run_application(app)),
    "port": dict(record=Record, runtime=MemoryTopicConnectionsRuntime, spec=TopicSpec,
                 position=OffsetPosition, run=lambda app: run_application(app, device="cpu")),
}


def record_document(record) -> dict:
    """A delivered record as plain data, its timestamp left out (minted
    at publish)."""
    return {"value": record.value, "key": record.key, "origin": record.origin,
            "headers": list(record.headers), "partition": getattr(record, "partition", None),
            "offset": getattr(record, "offset", None)}


# ---------------------------------------------------------------------- #
# the broker
# ---------------------------------------------------------------------- #
async def broker_scenario(package: dict) -> dict:
    Record_, position = package["record"], package["position"]
    runtime = package["runtime"]()
    admin = runtime.create_admin()
    await admin.create_topic(package["spec"](name="t", partitions=3))
    latest = runtime.create_reader({"topic": "t"}, position.LATEST)
    await latest.start()
    producer = runtime.create_producer("a", {"topic": "t"})
    for i in range(12):
        key = None if i % 4 == 3 else f"user-{i % 3}"
        await producer.write(Record_(value={"i": i}, key=key, headers=(("h", str(i)),)))
    first = runtime.create_consumer("a", {"topic": "t", "group": "g"})
    read = []
    while len(read) < 12:
        read.extend(await first.read(max_records=5, timeout=0.05))
    # acknowledge out of order: odd offsets first, then a prefix of the even
    await first.commit([r for r in read if r.offset % 2 == 1])
    after_odd = first.committed_offsets()
    await first.commit([r for r in read if r.offset % 2 == 0 and r.offset < 2])
    after_prefix = first.committed_offsets()
    # a second member joins: the rebalance redelivers what is uncommitted
    second = runtime.create_consumer("b", {"topic": "t", "group": "g"})
    await second.start()
    redelivered = (await first.read(timeout=0.05)) + (await second.read(timeout=0.05))
    earliest = runtime.create_reader({"topic": "t"}, position.EARLIEST)
    return {
        "read": [record_document(r) for r in read],
        "after_odd": after_odd, "after_prefix": after_prefix,
        "redelivered": sorted((r.partition, r.offset) for r in redelivered),
        "latest": [record_document(r) for r in await latest.read(timeout=0.05)],
        "earliest": [record_document(r) for r in await earliest.read(timeout=0.05)],
        "out": first.total_out(), "in": producer.total_in(),
    }


def test_memory_broker_equals_jax():
    got = asyncio.run(broker_scenario(PACKAGES["port"]))
    want = asyncio.run(broker_scenario(PACKAGES["jax"]))
    assert got == want
    assert len(got["read"]) == 12 and got["after_prefix"] != [0, 0, 0]


# ---------------------------------------------------------------------- #
# apps without a model
# ---------------------------------------------------------------------- #
STEPS_APP = """\
topics:
  - {name: in, creation-mode: create-if-not-exists}
  - {name: out, creation-mode: create-if-not-exists}
pipeline:
  - name: to-json
    type: document-to-json
    input: in
    configuration: {text-field: question}
  - type: compute
    configuration:
      fields:
        - {name: value.length, expression: "fn:len(value.question)", type: INT32}
        - {name: value.upper, expression: "fn:uppercase(value.question)"}
        - {name: value.meta, expression: "fn:mapOf('lang', 'en', 'n', 2)"}
        - {name: properties.seen, expression: "'yes'"}
  - type: drop-fields
    configuration: {fields: [lang]}
  - type: merge-key-value
  - type: cast
    when: "value.length > 100"
    configuration: {schema-type: string}
  - type: flatten
    output: out
    configuration: {delimiter: "."}
"""

INPUTS = [("what is a GPU?", {"id": 1, "lang": "en"}, (("session", "s1"),)),
          ("and a TPU?", None, (("session", "s2"), ("lang", "fr"))),
          ("x" * 120, {"id": 3}, ())]


async def drive(package: dict, app_dir: str, inputs, topics, settle: float = 0.3):
    Record_ = package["record"]
    runner = await package["run"](app_dir)
    failure = None
    try:
        producer = runner.producer("in")
        for value, key, headers in inputs:
            await producer.write(Record_(value=value, key=key, headers=headers))
        await asyncio.sleep(settle)
        out = {}
        for topic in topics:
            out[topic] = [record_document(r) for r in await runner.reader(topic).read(timeout=0.2)]
        out["committed"] = {
            name: list(group.committed)
            for (topic, name), group in runner.topic_runtime.broker.groups.items()
        }
        out["stats"] = [
            {k: v for k, v in r.stats.snapshot().items() if k != "uptime-s"}
            for r in runner.runners
        ]
    finally:
        try:
            await runner.stop()
        except Exception as error:  # noqa: BLE001 — compared below
            failure = f"{type(error).__name__}: {error}"
    out["failure"] = failure
    return out


def test_model_free_steps_equal_jax(tmp_path):
    (tmp_path / "pipeline.yaml").write_text(STEPS_APP)
    got = asyncio.run(drive(PACKAGES["port"], str(tmp_path), INPUTS, ["out"]))
    want = asyncio.run(drive(PACKAGES["jax"], str(tmp_path), INPUTS, ["out"]))
    assert got == want
    values = [r["value"] for r in got["out"]]
    assert values[0]["meta.n"] == 2 and values[0]["id"] == 1 and "lang" not in values[0]
    assert values[0]["length"] == len("what is a GPU?") and values[2]["length"] == 120
    assert ("seen", "yes") in [tuple(h) for h in got["out"][0]["headers"]]
    assert list(got["committed"].values()) == [[3]]


class Flaky:
    """Raises on records whose text holds ``bad``; passes the rest."""

    def __init__(self, base):
        self.base = base

    def make(self):
        base = self.base

        class FlakyProcessor(base):
            async def process_record(self, record):
                if "bad" in record.value_as_text():
                    raise RuntimeError(f"refused {record.value_as_text()}")
                return [record.with_value(record.value_as_text().upper())]

        return FlakyProcessor()


@pytest.fixture(scope="module", autouse=True)
def flaky_agents():
    port_registry.register_agent("test-flaky", Flaky(port_agent.SingleRecordProcessor).make)
    jax_registry.register_agent("test-flaky", Flaky(jax_agent.SingleRecordProcessor).make)
    yield


FLAKY_APP = """\
topics:
  - {name: in, creation-mode: create-if-not-exists}
  - {name: out, creation-mode: create-if-not-exists}
  - {name: in-deadletter, creation-mode: create-if-not-exists}
errors:
  on-failure: {action}
  retries: 1
pipeline:
  - name: flaky
    type: test-flaky
    input: in
    output: out
"""


@pytest.mark.parametrize("action", ["skip", "dead-letter", "fail"])
def test_error_policy_equals_jax(tmp_path, action):
    (tmp_path / "pipeline.yaml").write_text(FLAKY_APP.replace("{action}", action))
    inputs = [("good one", None, ()), ("bad two", "k", (("h", "2"),)), ("good three", None, ())]
    topics = ["out", "in-deadletter"]
    got = asyncio.run(drive(PACKAGES["port"], str(tmp_path), inputs, topics))
    want = asyncio.run(drive(PACKAGES["jax"], str(tmp_path), inputs, topics))
    assert got == want
    stats = got["stats"][0]
    if action == "fail":
        assert got["failure"] == "RuntimeError: refused bad two"
        assert stats["errors"] == 2  # the first attempt and its retry
    else:
        assert [r["value"] for r in got["out"]] == ["GOOD ONE", "GOOD THREE"]
        assert got["failure"] is None and stats["errors"] == 2
        assert len(got["in-deadletter"]) == (action == "dead-letter")
        assert list(got["committed"].values()) == [[3]]


def test_app_path_imports_no_yaml_aiohttp_or_jax(tmp_path):
    """``run_application`` of the port on the tiny completions app, one
    question answered, in a fresh interpreter: none of the libraries the
    card's machine lacks, and nothing of the JAX package, was imported."""
    script = textwrap.dedent(f"""
        import asyncio, json, sys
        from langstream_tpu_torch.api.records import Record
        from langstream_tpu_torch.runtime.local import run_application

        async def main():
            runner = await run_application(
                {str(REPO / 'langstream_tpu_torch' / 'examples' / 'applications' / 'torch-completions')!r},
                instance_file={str(REPO / 'examples' / 'instances' / 'local-tiny.yaml')!r},
                device="cpu")
            try:
                await runner.producer("input-topic").write(Record(value="hi"))
                history = runner.reader("history-topic")
                out = []
                while not out:
                    out.extend(await history.read(timeout=0.2))
            finally:
                await runner.stop()
            return out[0].value["answer"]

        answer = asyncio.run(main())
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("yaml", "aiohttp", "jax", "jaxlib", "langstream_tpu"))
        print(json.dumps({{"answer": answer, "loaded": loaded}}))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, cwd=str(tmp_path), timeout=240)
    assert done.returncode == 0, done.stderr[-2000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["loaded"] == [] and isinstance(result["answer"], str)
