"""The port's pod entry points (``langstream_tpu_torch/runtime/pod.py``)
against the JAX package's:

- ``agent-runner --config pod-configuration.json --device cpu`` as a
  process of its own over a served ``tpulog`` broker: the node's answers on
  its output topic, ``/info``, ``/metrics`` and ``/ready``, and SIGTERM
  ending it, against JAX's ``agent_runner_main`` over its own served broker
  on the same records;
- ``agent-runner`` without ``--device cpu`` refusing a machine without
  CUDA;
- ``application-setup`` creating the app's topics and, with ``--delete``,
  deleting those whose ``deletion-mode`` is ``delete``, against JAX's
  ``application_setup_main``, each over its package's Kafka facade broker.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import langstream_tpu.api.topics as jax_topics
import langstream_tpu.compiler as jax_compiler
import langstream_tpu.runtime.pod as jax_pod
import langstream_tpu.topics.kafka.server as jax_kafka_server
import langstream_tpu.topics.log.client as jax_log_client
import langstream_tpu.topics.log.server as jax_log_server
import langstream_tpu_torch.api.topics as port_topics
import langstream_tpu_torch.compiler as port_compiler
import langstream_tpu_torch.runtime.pod as port_pod
import langstream_tpu_torch.topics.kafka.server as port_kafka_server
import langstream_tpu_torch.topics.log.client as port_log_client
import langstream_tpu_torch.topics.log.server as port_log_server
from langstream_tpu_torch.agents import http_client
from langstream_tpu_torch.api.records import Record

REPO = pathlib.Path(__file__).resolve().parents[1]
WAIT_S = 60.0
PIPELINE = """\
topics:
  - name: "in"
    creation-mode: create-if-not-exists
  - name: "out"
    creation-mode: create-if-not-exists
    deletion-mode: delete
    partitions: 2
pipeline:
  - id: "convert"
    type: "document-to-json"
    input: "in"
    output: "out"
    configuration:
      text-field: "question"
"""


def app_dir(root: pathlib.Path, streaming_cluster: dict) -> str:
    root.mkdir(parents=True, exist_ok=True)
    (root / "pipeline.yaml").write_text(PIPELINE)
    (root / "instance.yaml").write_text(
        "instance:\n  streamingCluster: " + json.dumps(streaming_cluster)
        + "\n  computeCluster:\n    type: local\n")
    return str(root)


def plan_of(compiler, directory: str):
    application = compiler.build_application(directory,
                                             instance_file=os.path.join(directory, "instance.yaml"))
    return compiler.build_execution_plan(application)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def questions() -> list:
    rng = np.random.default_rng(4)
    return ["".join(rng.choice(list("abcdefgh "), 12)) for _ in range(6)]


async def drive(address: str, client, earliest, http: str) -> dict:
    """Produce the questions to ``in`` through ``client`` at ``address``,
    read the answers on ``out`` from ``earliest`` (the client's package's
    ``OffsetPosition.EARLIEST``), and read the runner's HTTP surface."""
    runtime = client.RemoteTopicConnectionsRuntime(address)
    producer = runtime.create_producer("test", {"topic": "in"})
    for i, question in enumerate(questions()):
        await producer.write(Record(value=question, key=f"s{i % 3}"))
    await producer.close()
    reader = runtime.create_reader({"topic": "out"}, earliest)
    answers: list = []
    deadline = asyncio.get_running_loop().time() + WAIT_S
    while len(answers) < len(questions()):
        assert asyncio.get_running_loop().time() < deadline, answers
        answers += await reader.read(100, 0.1)
    await reader.close()
    info = json.loads(await (await http_client.request("GET", http + "/info")).read())
    metrics = (await (await http_client.request("GET", http + "/metrics")).read()).decode()
    counters = dict(re.findall(r"^(agent_convert_records_(?:in|out)_total) (\S+)$", metrics, re.M))
    return {"answers": sorted((r.key, json.dumps(r.value, sort_keys=True)) for r in answers),
            "agents": [agent["agent-id"] for agent in info["agents"]],
            "counters": {name: float(value) for name, value in counters.items()}}


async def wait_ready(http: str) -> None:
    deadline = asyncio.get_running_loop().time() + WAIT_S
    while True:
        try:
            if (await http_client.request("GET", http + "/ready", timeout=5)).status == 200:
                return
        except OSError:
            pass
        assert asyncio.get_running_loop().time() < deadline, "runner never ready"
        await asyncio.sleep(0.1)


async def run_port(tmp_path: pathlib.Path) -> dict:
    server = await port_log_server.serve(str(tmp_path / "port-broker"), port=0)
    directory = app_dir(tmp_path / "port-app", {"type": "tpulog",
                                                "configuration": {"address": server.address}})
    plan = plan_of(port_compiler, directory)
    config_path = tmp_path / "port-pod-configuration.json"
    config_path.write_text(json.dumps(port_pod.pod_configuration(plan, plan.agents[0])))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    runner = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "langstream_tpu_torch", "agent-runner", "--config", str(config_path),
        "--http-port", "0", "--device", "cpu",
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT, env=env)
    lines = []
    try:
        while True:
            line = (await asyncio.wait_for(runner.stdout.readline(), WAIT_S)).decode()
            assert line, "".join(lines)
            lines.append(line)
            found = re.search(r"on cpu: (http://\S+)/metrics", line)
            if found:
                http = found.group(1)
                break
        await wait_ready(http)
        got = await drive(server.address, port_log_client, port_topics.OffsetPosition.EARLIEST,
                          http)
        runner.send_signal(signal.SIGTERM)
        rest = (await asyncio.wait_for(runner.stdout.read(), WAIT_S)).decode()
        got["exit"] = await runner.wait()
        got["stopped"] = "agent-runner convert stopped" in rest
        # the runner left its group: nothing left assigned to a dead member
        group = f"{plan.application.application_id}-{plan.agents[0].id}"
        got["members"] = (("in", group) in server.broker.groups
                          and server.broker.group("in", group).members)
        return got
    finally:
        if runner.returncode is None:
            runner.kill()
            await runner.wait()
        await server.close()
        server.broker.close()


async def run_jax(tmp_path: pathlib.Path, monkeypatch) -> dict:
    server = await jax_log_server.serve(str(tmp_path / "jax-broker"), port=0)
    directory = app_dir(tmp_path / "jax-app", {"type": "tpulog",
                                               "configuration": {"address": server.address}})
    plan = plan_of(jax_compiler, directory)
    config_path = tmp_path / "jax-pod-configuration.json"
    config_path.write_text(json.dumps({
        "applicationId": plan.application.application_id, "tenant": plan.application.tenant,
        "agentNode": dataclasses.asdict(plan.agents[0]), "resources": plan.application.resources,
        "streamingCluster": plan.application.instance.streaming_cluster,
        "globals": plan.application.instance.globals_}))
    port = free_port()
    monkeypatch.setenv("LANGSTREAM_HTTP_PORT", str(port))
    stop = asyncio.Event()
    task = asyncio.ensure_future(jax_pod.agent_runner_main(str(config_path), stop_event=stop))
    try:
        http = f"http://127.0.0.1:{port}"
        await wait_ready(http)
        got = await drive(server.address, jax_log_client, jax_topics.OffsetPosition.EARLIEST, http)
        stop.set()
        await asyncio.wait_for(task, WAIT_S)
        got["exit"], got["stopped"] = 0, True
        group = f"{plan.application.application_id}-{plan.agents[0].id}"
        got["members"] = (("in", group) in server.broker.groups
                          and server.broker.group("in", group).members)
        return got
    finally:
        stop.set()
        await server.close()
        server.broker.close()


def test_agent_runner_over_served_tpulog_like_jax(tmp_path, monkeypatch):
    port = asyncio.run(asyncio.wait_for(run_port(tmp_path), 3 * WAIT_S))
    jax = asyncio.run(asyncio.wait_for(run_jax(tmp_path, monkeypatch), 3 * WAIT_S))
    assert port == jax
    assert port["exit"] == 0 and port["stopped"] and port["members"] == []
    assert len(port["answers"]) == 6 and port["counters"] == {
        "agent_convert_records_in_total": 6.0, "agent_convert_records_out_total": 6.0}


def test_agent_runner_refuses_a_machine_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    directory = app_dir(tmp_path / "app", {"type": "memory"})
    plan = plan_of(port_compiler, directory)
    config_path = tmp_path / "pod-configuration.json"
    config_path.write_text(json.dumps(port_pod.pod_configuration(plan, plan.agents[0])))
    done = subprocess.run(
        [sys.executable, "-m", "langstream_tpu_torch", "agent-runner", "--config",
         str(config_path), "--http-port", "0"],
        capture_output=True, text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert done.returncode != 0 and "device='cpu'" in done.stderr


def test_application_setup_creates_and_deletes_like_jax(tmp_path, monkeypatch):
    """The port's ``application-setup`` (a process) and JAX's
    ``application_setup_main`` (in-process), each against its package's
    Kafka facade: the same topics with the same partitions, then only the
    ``deletion-mode: delete`` topic gone."""
    async def run(name):
        serve = {"port": port_kafka_server, "jax": jax_kafka_server}[name].serve_kafka_facade
        facade = await serve()
        try:
            compiler = {"port": port_compiler, "jax": jax_compiler}[name]
            directory = app_dir(tmp_path / f"{name}-app", {
                "type": "kafka", "configuration": {"bootstrapServers": facade.bootstrap}})
            # the port's document: JAX's _application_from_env reads it too
            env_value = port_pod.application_document(plan_of(compiler, directory).application)
            seen = []
            for delete in (False, True):
                if name == "port":
                    args = ["--delete"] if delete else []
                    setup = await asyncio.create_subprocess_exec(
                        sys.executable, "-m", "langstream_tpu_torch", "application-setup", *args,
                        "--device", "cpu", stdout=asyncio.subprocess.PIPE,
                        stderr=asyncio.subprocess.STDOUT,
                        env=dict(os.environ, PYTHONPATH=str(REPO), LANGSTREAM_APPLICATION=env_value))
                    out = await asyncio.wait_for(setup.stdout.read(), WAIT_S)
                    assert await setup.wait() == 0, out.decode()[-2000:]
                else:
                    monkeypatch.setenv("LANGSTREAM_APPLICATION", env_value)
                    await jax_pod.application_setup_main(delete=delete)
                seen.append({topic: len(parts) for topic, parts in facade.topics.items()})
            return seen
        finally:
            await facade.close()

    port = asyncio.run(asyncio.wait_for(run("port"), 3 * WAIT_S))
    jax = asyncio.run(asyncio.wait_for(run("jax"), 3 * WAIT_S))
    assert port == jax == [{"in": 1, "out": 2}, {"in": 1}]


def test_pod_configuration_round_trips_its_node(tmp_path):
    """``pod_configuration`` writes the node as the JAX operator's Secret
    carries it: the port's ``node_from_document`` and JAX's read it back to
    the node each package planned."""
    directory = app_dir(tmp_path / "app", {"type": "memory"})
    plan = plan_of(port_compiler, directory)
    config = json.loads(json.dumps(port_pod.pod_configuration(plan, plan.agents[0])))
    jax_plan = plan_of(jax_compiler, directory)
    assert port_pod.node_from_document(config["agentNode"]) == plan.agents[0]
    assert jax_pod.node_from_document(config["agentNode"]) == jax_plan.agents[0]
    assert config["streamingCluster"] == {"type": "memory"}
