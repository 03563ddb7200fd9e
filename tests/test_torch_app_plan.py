"""The port's application model, parser and planner against the JAX
package's, over every example app.

- Every directory of ``examples/applications/`` and ``examples/archetypes/``,
  with no instance, with ``examples/instances/local-tiny.yaml`` and with
  ``local-rag-tiny.yaml``: where the JAX package plans it, the port's
  ``build_execution_plan`` gives the same topics, agent nodes (ids,
  topics, source / processors / sink / service with their types and
  resolved configuration, composite merges of ``ai-tools`` steps, error
  policy, resources), gateways and resources; where JAX's placeholder
  resolution fails, the port's fails too.
- What the port does not carry is refused by name: an agent type it
  lacks when the runner builds it (Camel and Kafka Connect), brokers
  other than the in-memory one, gateways with authentication, an asset
  type it has no manager for. The RAG path's GenAI steps,
  refused until the port carried them, now build; a step type neither
  package knows is refused.
"""

import asyncio
import dataclasses
import os
import pathlib

import pytest

from langstream_tpu.compiler import build_application as jax_build_application
from langstream_tpu.compiler import build_execution_plan as jax_build_plan
from langstream_tpu_torch.compiler import build_application, build_execution_plan
from langstream_tpu_torch.compiler.placeholders import PlaceholderError
from langstream_tpu_torch.gateway import GatewayServer
from langstream_tpu_torch.runtime.local import LocalApplicationRunner
from langstream_tpu_torch.runtime.registry import create_agent
from langstream_tpu_torch.topics import create_topic_runtime

REPO = pathlib.Path(__file__).resolve().parents[1]
APPS = sorted(
    [p for p in (REPO / "examples" / "applications").iterdir() if p.is_dir()]
    + [p for p in (REPO / "examples" / "archetypes").iterdir() if p.is_dir()]
)
INSTANCES = {
    "none": None,
    "local-tiny": str(REPO / "examples" / "instances" / "local-tiny.yaml"),
    "local-rag-tiny": str(REPO / "examples" / "instances" / "local-rag-tiny.yaml"),
}


def plan_document(plan) -> dict:
    """A plan as plain data: topics, nodes, and the resolved application."""
    application = plan.application
    return {
        "topics": {name: dataclasses.asdict(spec) for name, spec in plan.topics.items()},
        "agents": [dataclasses.asdict(node) for node in plan.agents],
        "assets": [dataclasses.asdict(asset) for asset in plan.assets],
        "resources": application.resources,
        "gateways": [dataclasses.asdict(gateway) for gateway in application.gateways],
        "instance": dataclasses.asdict(application.instance),
        "application_id": application.application_id,
    }


def jax_plan_or_error(app_dir, instance):
    try:
        return jax_build_plan(jax_build_application(app_dir, instance_file=instance)), None
    except Exception as error:  # noqa: BLE001 — the port must fail alike
        return None, error


@pytest.mark.parametrize("instance", sorted(INSTANCES))
@pytest.mark.parametrize("app", APPS, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_plan_equals_jax(app, instance):
    want, error = jax_plan_or_error(str(app), INSTANCES[instance])
    if error is not None:
        # the JAX planner refuses only unresolved placeholders here
        assert type(error).__name__ == "PlaceholderError", error
        with pytest.raises(PlaceholderError) as raised:
            build_execution_plan(build_application(str(app), instance_file=INSTANCES[instance]))
        assert str(raised.value) == str(error)
        return
    got = build_execution_plan(build_application(str(app), instance_file=INSTANCES[instance]))
    assert plan_document(got) == plan_document(want)


def test_the_jax_planner_plans_most_example_apps():
    planned = sum(jax_plan_or_error(str(app), INSTANCES["local-rag-tiny"])[1] is None
                  for app in APPS)
    assert planned >= 30, planned


def test_composite_merge_of_genai_steps(tmp_path):
    """Consecutive GenAI steps with no topic between them merge into one
    ``ai-tools`` node's ``steps``; an explicit topic seals a node."""
    (tmp_path / "pipeline.yaml").write_text(
        "topics:\n  - name: in\n  - name: mid\n  - name: out\n"
        "pipeline:\n"
        "  - {type: document-to-json, input: in, configuration: {text-field: q}}\n"
        "  - {type: compute, configuration: {fields: [{name: value.n, expression: '1'}]}}\n"
        "  - {type: drop-fields, output: mid, configuration: {fields: [q]}}\n"
        "  - {type: flatten, input: mid, output: out}\n"
    )
    plan = build_execution_plan(build_application(str(tmp_path)))
    assert [(n.input_topic, n.output_topic, [p.agent_type for p in n.processors])
            for n in plan.agents] == [("in", "mid", ["document-to-json", "ai-tools"]),
                                      ("mid", "out", ["ai-tools"])]
    assert [s["type"] for s in plan.agents[0].processors[1].configuration["steps"]] == [
        "compute", "drop-fields"]
    want = jax_build_plan(jax_build_application(str(tmp_path)))
    assert plan_document(plan) == plan_document(want)


def test_unported_agent_type_is_refused_by_name_at_start(tmp_path):
    """Every agent type of the JAX package builds since the port carried
    Camel and Kafka Connect; what is left unported, Camel's ``pulsar:``
    scheme, plans as in JAX and is refused by name, naming the ROADMAP
    item it waits for, when the runner starts it."""
    (tmp_path / "pipeline.yaml").write_text(
        "topics:\n  - name: out\n"
        "pipeline:\n  - type: camel-source\n    output: out\n    configuration:\n"
        "      component-uri: 'pulsar:persistent://public/default/t?webServiceUrl=http://h:8080'\n")
    plan = build_execution_plan(build_application(str(tmp_path)))
    runner = LocalApplicationRunner(plan, device="cpu")
    with pytest.raises(ValueError, match=r"pulsar: scheme is not yet ported.*ROADMAP A7\.4"):
        asyncio.run(runner.start())
    for agent_type in ("camel-source", "kafka-connect-source", "kafka-connect-sink",
                       "http-request", "webcrawler-source"):
        assert create_agent(agent_type).agent_type == agent_type
    with pytest.raises(ValueError, match="unknown agent type 'no-such-agent'"):
        create_agent("no-such-agent")


@pytest.mark.parametrize("step", ["compute-ai-embeddings", "query"])
def test_rag_steps_are_refused_by_name(step):
    """The RAG steps were refused by name until the port carried them:
    now each builds, and a step type neither package knows is refused."""
    from langstream_tpu_torch.agents import genai

    agent = create_agent("ai-tools")
    asyncio.run(agent.init({"steps": [{"type": step, "query": "q"}]}))
    assert type(agent.steps[0]) is {"compute-ai-embeddings": genai.ComputeAIEmbeddingsStep,
                                    "query": genai.QueryStep}[step]
    with pytest.raises(ValueError, match="unknown GenAI step type 'no-such-step'"):
        asyncio.run(create_agent("ai-tools").init({"steps": [{"type": "no-such-step"}]}))


@pytest.mark.parametrize("broker", ["kafka", "pulsar", "pravega", "tpulog"])
def test_other_brokers_are_refused_by_name(broker, tmp_path):
    """Pulsar and Pravega are refused by name, naming the ROADMAP item they
    wait for; ``kafka`` and ``tpulog`` were refused so until the port
    carried them, and now build."""
    if broker in ("pulsar", "pravega"):
        with pytest.raises(ValueError, match=rf"'{broker}' is not yet ported.*ROADMAP A7\.4"):
            create_topic_runtime({"type": broker})
        return
    configuration = ({"bootstrapServers": "127.0.0.1:9092"} if broker == "kafka"
                     else {"directory": str(tmp_path)})
    runtime = create_topic_runtime({"type": broker, "configuration": configuration})
    package = {"kafka": "kafka", "tpulog": "log"}[broker]
    assert type(runtime).__module__.startswith(f"langstream_tpu_torch.topics.{package}.")
    asyncio.run(runtime.close())


def test_gateway_authentication_is_refused_by_name():
    app = REPO / "examples" / "applications" / "gateway-authentication"
    application = build_application(str(app))
    with pytest.raises(ValueError, match="declares authentication"):
        GatewayServer().register("default", application, create_topic_runtime({}))


def test_assets_are_refused(tmp_path):
    (tmp_path / "pipeline.yaml").write_text(
        "topics:\n  - name: in\n"
        "assets:\n  - {name: t, asset-type: cassandra-table}\n"
        "pipeline:\n  - {type: document-to-json, input: in}\n")
    plan = build_execution_plan(build_application(str(tmp_path)))
    with pytest.raises(ValueError, match="cassandra-table.*not yet ported"):
        LocalApplicationRunner(plan, device="cpu")


def test_apps_run_refuses_the_cpu_unless_asked():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    from langstream_tpu_torch.cli.main import apps_run, build_parser
    from langstream_tpu_torch.runtime.local import run_application

    app = os.path.join(REPO, "langstream_tpu_torch", "examples", "applications", "torch-completions")
    instance = INSTANCES["local-tiny"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyncio.run(run_application(app, instance_file=instance))
    args = build_parser().parse_args(["apps", "run", app, "--instance", instance])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyncio.run(apps_run(args))
