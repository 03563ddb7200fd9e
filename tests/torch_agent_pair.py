"""What the agent tests of the port share: each package's agent API under
one name, so that one scenario runs through the JAX package's agents and
the port's, and their output records are compared field by field.

Imported as the top-level ``torch_agent_pair`` (pytest puts ``tests/`` on
the path), as ``torch_tp_worker`` is.
"""

from __future__ import annotations

import asyncio
import types
from typing import Any, Dict, List, Optional

import langstream_tpu.api.agent as jax_agent
import langstream_tpu.api.records as jax_records
import langstream_tpu.api.topics as jax_topics
import langstream_tpu.runtime.registry as jax_registry
import langstream_tpu.runtime.runner as jax_runner
import langstream_tpu.topics.memory as jax_memory
import langstream_tpu_torch.api.agent as port_agent
import langstream_tpu_torch.api.records as port_records
import langstream_tpu_torch.api.topics as port_topics
import langstream_tpu_torch.runtime.registry as port_registry
import langstream_tpu_torch.runtime.runner as port_runner
import langstream_tpu_torch.topics.memory as port_memory

# the suite's own cap on any one wait for a record or a process
WAIT_S = 30.0


def _package(agent, records, topics, registry, runner, memory) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        AgentContext=agent.AgentContext, Record=records.Record,
        OffsetPosition=topics.OffsetPosition, create_agent=registry.create_agent,
        process_and_collect=runner.process_and_collect,
        runtime=lambda: memory.MemoryTopicConnectionsRuntime(memory.MemoryBroker()))


PACKAGES = {
    "jax": _package(jax_agent, jax_records, jax_topics, jax_registry, jax_runner, jax_memory),
    "port": _package(port_agent, port_records, port_topics, port_registry, port_runner,
                     port_memory),
}


async def make(pkg, agent_type: str, config: Dict[str, Any], *, runtime=None,
               state_dir: Optional[str] = None, start: bool = True, **context):
    """An agent of ``pkg`` built, given its context and started, as the
    runner does (the port's on the CPU)."""
    agent = pkg.create_agent(agent_type)
    agent.agent_id = f"test-{agent_type}"
    await agent.init(config)
    if pkg is PACKAGES["port"]:
        context.setdefault("device", "cpu")
    await agent.set_context(pkg.AgentContext(
        agent_id="t", topic_connections=runtime, persistent_state_directory=state_dir,
        **context))
    if start:
        await agent.start()
    return agent


async def process(pkg, agent, records) -> List[Any]:
    """Each record's results, or its error, in order."""
    out = []
    for record in records:
        (result,) = await pkg.process_and_collect(agent, [record])
        out.append(result.error if result.error is not None else result.result_records)
    return out


def fields(record) -> tuple:
    """What two packages' records are compared by."""
    return (record.value, record.key, tuple(record.headers))


def outcome(results) -> list:
    """``process`` results as plain data: records' fields, or an error's
    type name and text."""
    return [(type(r).__name__, str(r)) if isinstance(r, BaseException)
            else [fields(x) for x in r] for r in results]


async def topic(pkg, runtime, name: str) -> list:
    """Every record on ``name``, by its fields."""
    reader = runtime.create_reader({"topic": name}, pkg.OffsetPosition.EARLIEST)
    await reader.start()
    out = await reader.read(max_records=10_000, timeout=0.05)
    await reader.close()
    return [fields(r) for r in out]


async def read_until(source, count: int, timeout: float = WAIT_S) -> list:
    """``source.read()`` until ``count`` records came (or the wait ends)."""
    got: list = []
    deadline = asyncio.get_running_loop().time() + timeout
    while len(got) < count and asyncio.get_running_loop().time() < deadline:
        got.extend(await source.read())
    return got

