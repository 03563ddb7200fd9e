"""The port's flow agents (``agents/flow.py``) against the JAX package's.

The same seeded records (numpy, seed 24) go through each package's
``dispatch``, ``trigger-event`` and ``log-event``, each agent writing to
its package's memory broker: the records each returns (value, key,
headers), or the error it raises, and the records on every destination
topic must be equal. ``timer-source`` fires with computed fields, a
``count`` among them, and the records it emits must be equal.

``examples/applications/timer-events`` routes on ``value.count``, a field
its ``timer-source`` does not emit in either package: the dispatch's
expression then fails alike in both (held here, and the app in
``test_torch_agent_apps.py``).
"""

import asyncio
import logging

import numpy as np
import pytest

from torch_agent_pair import PACKAGES, make, outcome, process, read_until, topic

ROUTES = [
    {"when": "properties['lang'] == 'fr'", "destination": "french"},
    {"when": "value.n > 80", "destination": "big"},
    {"when": "properties['lang'] == 'spam'", "action": "drop"},
    {"when": "value.n % 7 == 0", "destination": "sevens", "action": "dispatch"},
]


def seeded_records(pkg, count: int = 48, seed: int = 24) -> list:
    rng = np.random.default_rng(seed)
    langs = ["en", "fr", "spam", "de"]
    out = []
    for i in range(count):
        n = int(rng.integers(0, 100))
        headers = (("lang", langs[int(rng.integers(0, len(langs)))]), ("i", str(i)))
        key = None if i % 3 == 0 else f"k{int(rng.integers(0, 5))}"
        out.append(pkg.Record(value={"n": n, "word": f"w{int(rng.integers(0, 9))}"},
                              key=key, headers=headers))
    return out


def run_both(scenario):
    return {name: asyncio.run(scenario(pkg)) for name, pkg in PACKAGES.items()}


def test_dispatch_routes_drops_and_passes_like_jax():
    async def scenario(pkg):
        runtime = pkg.runtime()
        agent = await make(pkg, "dispatch", {"routes": ROUTES}, runtime=runtime)
        returned = outcome(await process(pkg, agent, seeded_records(pkg)))
        await agent.close()
        topics = {name: await topic(pkg, runtime, name) for name in ("french", "big", "sevens")}
        return returned, topics

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    returned, topics = got["port"]
    # every route taken on these records: passed, dispatched and dropped
    assert all(topics.values()) and sum(r == [] for r in returned) > sum(map(len, topics.values()))
    assert any(r != [] for r in returned)


@pytest.mark.parametrize("continue_processing", [True, False])
def test_trigger_event_like_jax(continue_processing):
    config = {"when": "value.n > 50", "destination": "alerts",
              "continue-processing": continue_processing,
              "fields": [{"name": "value.alert", "expression": "value.n"},
                         {"name": "word", "expression": "value.word"}]}

    async def scenario(pkg):
        runtime = pkg.runtime()
        agent = await make(pkg, "trigger-event", config, runtime=runtime)
        returned = outcome(await process(pkg, agent, seeded_records(pkg)))
        await agent.close()
        return returned, await topic(pkg, runtime, "alerts")

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    returned, alerts = got["port"]
    assert alerts and all(value.keys() == {"alert", "word"} for value, _, _ in alerts)
    assert sum(r == [] for r in returned) == (0 if continue_processing else len(alerts))


def test_trigger_event_without_fields_forwards_the_record_like_jax():
    async def scenario(pkg):
        runtime = pkg.runtime()
        agent = await make(pkg, "trigger-event", {"destination": "copy"}, runtime=runtime)
        returned = outcome(await process(pkg, agent, seeded_records(pkg, count=6)))
        await agent.close()
        return returned, await topic(pkg, runtime, "copy")

    got = run_both(scenario)
    assert got["port"] == got["jax"] and len(got["port"][1]) == 6


def test_log_event_logs_and_passes_like_jax(caplog):
    config = {"message": "seen", "fields": [{"name": "n", "expression": "value.n"}]}

    async def scenario(pkg):
        agent = await make(pkg, "log-event", config)
        plain = await make(pkg, "log-event", {})
        records = seeded_records(pkg, count=8)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            returned = outcome(await process(pkg, agent, records))
            returned += outcome(await process(pkg, plain, records[:2]))
        return returned, [r.getMessage() for r in caplog.records if "flow" in r.name]

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    assert len(got["port"][1]) == 10 and got["port"][1][0].startswith("seen {'n': ")


def test_timer_source_count_field_and_dispatch_on_it_like_jax():
    """The timer's computed fields (``value.count`` among them) equal,
    and a dispatch on the count's parity routes them alike."""
    timer = {"period-seconds": 0.01,
             "fields": [{"name": "value.count", "expression": "3"},
                        {"name": "value.source", "expression": "'timer'"},
                        {"name": "label", "expression": "fn:concat('t', 1 + 1)"}]}
    routes = {"routes": [{"when": "value.count % 2 == 0", "destination": "even-ticks"},
                         {"when": "value.count % 2 == 1", "destination": "odd-ticks"}]}

    async def scenario(pkg):
        runtime = pkg.runtime()
        source = await make(pkg, "timer-source", timer)
        ticks = await read_until(source, 3)
        await source.close()
        dispatch = await make(pkg, "dispatch", routes, runtime=runtime)
        returned = outcome(await process(pkg, dispatch, ticks))
        await dispatch.close()
        return ([(t.value, t.key, tuple(t.headers)) for t in ticks[:3]], returned,
                await topic(pkg, runtime, "odd-ticks"))

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    ticks, returned, odd = got["port"]
    assert ticks[0][0] == {"count": 3, "source": "timer", "label": "t2"}
    assert returned == [[], [], []] and len(odd) == 3


def test_dispatch_on_a_missing_count_fails_like_jax():
    """timer-events' route reads ``value.count``, which its timer does not
    emit: both packages' dispatch raise the same expression error."""
    async def scenario(pkg):
        runtime = pkg.runtime()
        agent = await make(pkg, "dispatch", {"routes": [
            {"when": "value.count % 2 == 0", "destination": "even-ticks"}]}, runtime=runtime)
        returned = outcome(await process(pkg, agent, [pkg.Record(value={"source": "timer"})]))
        await agent.close()
        return returned

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == "ExpressionError" and "NoneType" in got["port"][0][1]
