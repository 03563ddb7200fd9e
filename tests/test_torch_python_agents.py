"""The port's python agents (``agents/python_agents.py``,
``agents/isolation.py``, ``utils/wire_json.py``) against the JAX
package's.

- All four kinds, in-process and under ``isolation: process``, over the
  same seeded records (numpy, seed 31): a processor's results (value,
  key, headers, origin) or its error, a source's records and what it was
  asked to commit, a sink's writes, a service's ``join`` ending on
  ``close``, equal in both packages.
- User errors under the runner's error policy: one app with a python
  processor that raises on some records, run by each package's
  ``LocalApplicationRunner`` under ``skip`` and ``dead-letter`` (the
  output and dead-letter topics equal) and ``fail`` (the runner fails
  with the user's error), in-process and isolated.
- A child that dies (``os._exit``) is a crash (``AgentProcessCrashed``,
  its exit code named), never a hang, every later call failing at once,
  and a runner with the isolated agent fails with it; a fresh child
  spawns after.
- The same module name in two apps' ``python/`` loads twice, once per
  app.
- The isolation child imports no ``torch`` (its start is timed and
  printed; ``chip_smoke.py`` phase 19 times it on the card's machine).
- The wire codec's escapes against the JAX package's, both ways.

Every wait here is on an event (a record, a connection, a process's exit)
under ``torch_agent_pair.WAIT_S``; none sleeps to let time pass.
"""

import asyncio
import copy
import os
import pathlib
import textwrap
import time

import numpy as np
import pytest

from langstream_tpu.runtime.local import run_application as jax_run_application
from langstream_tpu_torch.runtime.local import run_application
from torch_agent_pair import PACKAGES, WAIT_S, fields, make, outcome, process

USER_AGENTS = '''
import asyncio, json, os, sys

class Scale:
    def init(self, config):
        self.factor = config.get("factor", 2)

    def process(self, record):
        value = record.value
        if value["n"] % 11 == 0:
            raise ValueError(f"bad n {value['n']}")
        if value["n"] == 97:
            os._exit(7)
        if value["n"] % 5 == 0:
            return []
        out = [{"n": value["n"] * self.factor, "tag": record.header("tag")}]
        if value["n"] % 3 == 0:
            out.append((record.key, {"copy": value["n"]}))
        if value["n"] % 4 == 0:
            out.append({"value": b"raw" + bytes([value["n"]]), "key": "bytes",
                        "headers": {"h": "x"}})
        return out

class AsyncScale(Scale):
    async def process(self, record):
        await asyncio.sleep(0)
        return Scale.process(self, record)

class Source:
    def init(self, config):
        self.batches = config["batches"]
        self.committed = []

    def read(self):
        if not self.batches:
            return []
        return [tuple(pair) if isinstance(pair, list) else pair for pair in self.batches.pop(0)]

    def commit(self, records):
        self.committed.extend(r.value for r in records)

    def agent_info(self):
        return {"committed": self.committed}

class Sink:
    def init(self, config):
        self.path = config["spool"]

    def write(self, record):
        with open(self.path, "a") as fh:
            fh.write(json.dumps([record.value, record.key, list(map(list, record.headers))]) + "\\n")

class Service:
    def init(self, config):
        self.address = config["address"]

    async def main(self):
        reader, writer = await asyncio.open_unix_connection(self.address)
        writer.write(b"started\\n")
        await writer.drain()
        await asyncio.Event().wait()

class Modules:
    def process(self, record):
        return [sorted(name for name in ("torch", "numpy", "jax") if name in sys.modules)]
'''


@pytest.fixture(scope="module")
def agents_dir(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("user-agents")
    (path / "user_agents.py").write_text(USER_AGENTS)
    return str(path)


def seeded_records(pkg, count: int = 40, seed: int = 31, dying: bool = False) -> list:
    rng = np.random.default_rng(seed)
    values = [int(v) for v in rng.integers(0, 96, size=count)]
    if dying:
        values[count // 2] = 97
    return [pkg.Record(value={"n": n}, key=f"k{i % 4}", headers=(("tag", f"t{n % 6}"),),
                       origin="in-topic") for i, n in enumerate(values)]


def with_origin(results) -> list:
    return [r if isinstance(r, BaseException) else [(fields(x), x.origin) for x in r]
            for r in results]


def run_both(scenario) -> dict:
    return {name: asyncio.run(asyncio.wait_for(scenario(pkg), 3 * WAIT_S))
            for name, pkg in PACKAGES.items()}


def isolation(mode: str) -> dict:
    return {"isolation": mode} if mode != "in-process" else {}


@pytest.mark.parametrize("mode", ["in-process", "process"])
@pytest.mark.parametrize("cls", ["Scale", "AsyncScale"])
def test_processor_like_jax(agents_dir, mode, cls):
    config = {"className": f"user_agents.{cls}", "pythonPath": [agents_dir], "factor": 3,
              **isolation(mode)}

    async def scenario(pkg):
        agent = await make(pkg, "python-processor", config)
        results = await process(pkg, agent, seeded_records(pkg))
        info = agent.agent_info()
        await agent.close()
        shown = [(type(r).__name__, str(r)) if isinstance(r, BaseException) else r
                 for r in with_origin(results)]
        return shown, info.get("user"), info["className"]

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    shown = got["port"][0]
    errors = [r for r in shown if isinstance(r, tuple)]
    assert errors and all("bad n" in text for _, text in errors)
    assert any(r == [] for r in shown) and any(len(r) >= 2 for r in shown if isinstance(r, list))


@pytest.mark.parametrize("mode", ["in-process", "process"])
def test_source_and_commit_like_jax(agents_dir, mode):
    rng = np.random.default_rng(32)
    batches = [[[f"k{i}", {"n": int(n)}] for i, n in enumerate(rng.integers(0, 50, size=3))],
               [{"value": "plain", "headers": {"h": "1"}}], ["bare-string", 7]]
    config = {"className": "user_agents.Source", "pythonPath": [agents_dir],
              "batches": batches, **isolation(mode)}

    async def scenario(pkg):
        # the in-process source pops its batches from the config it was given
        agent = await make(pkg, "python-source", copy.deepcopy(config))
        read = []
        for _ in range(3):
            records = await agent.read()
            await agent.commit(records)
            read.append([fields(r) for r in records])
        empty = await agent.read()
        info = agent.agent_info()
        await agent.close()
        return read, empty, info.get("user")

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    read, empty, _ = got["port"]
    assert [len(batch) for batch in read] == [3, 1, 2] and empty == []


@pytest.mark.parametrize("mode", ["in-process", "process"])
def test_sink_like_jax(agents_dir, tmp_path, mode):
    async def scenario(pkg):
        spool = tmp_path / f"{id(pkg)}-{mode}.jsonl"
        agent = await make(pkg, "python-sink", {"className": "user_agents.Sink",
                                                 "pythonPath": [agents_dir], "spool": str(spool),
                                                 **isolation(mode)})
        for record in seeded_records(pkg, count=12):
            await agent.write(record)
        await agent.close()
        return spool.read_text().splitlines()

    got = run_both(scenario)
    assert got["port"] == got["jax"] and len(got["port"]) == 12


@pytest.mark.parametrize("mode", ["in-process", "process"])
def test_service_join_ends_on_close(agents_dir, tmp_path, mode):
    """The service's ``main`` says it started over a Unix socket; then
    ``close`` ends the ``join`` waiting on it. In-process, both packages
    alike. Isolated, the port alone: ``join`` fails with "isolated agent
    closed" and no crash is reported. The JAX package's isolated close can
    leave its ``join`` waiting (its reader task is cancelled before it sees
    the child's EOF), a fault of its own that this test does not wait on."""
    async def scenario(pkg):
        address = str(tmp_path / f"svc-{id(pkg)}-{mode}.sock")
        started = asyncio.get_running_loop().create_future()

        async def on_connect(reader, writer):
            started.set_result(await reader.readline())
            writer.close()

        server = await asyncio.start_unix_server(on_connect, path=address)
        agent = await make(pkg, "python-service", {"className": "user_agents.Service",
                                                    "pythonPath": [agents_dir],
                                                    "address": address, **isolation(mode)})
        join = asyncio.ensure_future(agent.join())
        line = await asyncio.wait_for(started, WAIT_S)
        assert not join.done()
        await agent.close()
        server.close()
        if mode == "in-process":
            join.cancel()  # an in-process main() has no child to lose
            outcome_ = "cancelled"
        else:
            try:
                await asyncio.wait_for(join, WAIT_S)
                outcome_ = "returned"
            except RuntimeError as error:
                outcome_ = str(error)
        return line, outcome_, (agent.agent_info().get("user") or {}).get("crashed")

    if mode == "process":
        port = asyncio.run(asyncio.wait_for(scenario(PACKAGES["port"]), 3 * WAIT_S))
        assert port == (b"started\n", "isolated agent closed", False)
    else:
        got = run_both(scenario)
        assert got["port"] == got["jax"] == (b"started\n", "cancelled", None)


def write_app(root: pathlib.Path, agents_dir: str, policy: str, mode: str) -> str:
    app = root / f"app-{policy}-{mode}"
    (app / "python").mkdir(parents=True)
    (app / "python" / "user_agents.py").write_text(USER_AGENTS)
    extra = "" if mode == "in-process" else f"\n      isolation: {mode}"
    (app / "pipeline.yaml").write_text(textwrap.dedent(f"""\
        topics:
          - name: "in"
            creation-mode: create-if-not-exists
          - name: "out"
            creation-mode: create-if-not-exists
        pipeline:
          - name: "scale"
            type: "python-processor"
            input: "in"
            output: "out"
            errors:
              on-failure: "{policy}"
              retries: 1
            configuration:
              className: "user_agents.Scale"
              factor: 5""") + extra + "\n")
    return str(app)


async def drive_app(pkg, start, app: str, records: list, want: int, topics) -> dict:
    """Start the app, write ``records`` to ``in``, wait until ``want``
    records arrived over ``topics`` (or the runner ended), stop it."""
    runner = await start(app)
    error = None
    try:
        producer = runner.producer("in")
        await producer.start()
        for record in records:
            await producer.write(record)
        readers = {name: runner.reader(name) for name in topics}
        got = {name: [] for name in topics}
        join = asyncio.ensure_future(runner.join())
        deadline = asyncio.get_running_loop().time() + WAIT_S
        while sum(map(len, got.values())) < want and not join.done():
            assert asyncio.get_running_loop().time() < deadline, got
            for name, reader in readers.items():
                got[name].extend(await reader.read(max_records=1000, timeout=0.05))
        if join.done():
            error = join.exception()
        else:
            join.cancel()
    finally:
        try:
            await runner.stop()
        except Exception as stopped:  # noqa: BLE001 — the failed runner's error
            error = error or stopped
    return {"topics": {name: [fields(r) for r in got[name]] for name in topics},
            "error": None if error is None else (type(error).__name__, str(error).split("\n")[0])}


STARTS = {"jax": lambda app: jax_run_application(app),
          "port": lambda app: run_application(app, device="cpu")}


@pytest.mark.parametrize("mode", ["in-process", "process"])
@pytest.mark.parametrize("policy", ["skip", "dead-letter", "fail"])
def test_user_errors_under_the_runner_error_policy_like_jax(agents_dir, tmp_path, policy, mode):
    def scenario_for(name):
        async def scenario(pkg):
            app = write_app(tmp_path / name, agents_dir, policy, mode)
            records = seeded_records(pkg, count=30)
            failing = sum(r.value["n"] % 11 == 0 for r in records)
            produced = sum(len(out) for out in [
                [] if r.value["n"] % 11 == 0 or r.value["n"] % 5 == 0
                else [1] + [1] * (r.value["n"] % 3 == 0) + [1] * (r.value["n"] % 4 == 0)
                for r in records])
            assert failing > 0
            want = produced + (failing if policy == "dead-letter" else 0)
            if policy == "fail":
                want = 10 ** 6  # until the runner fails
            return await drive_app(pkg, STARTS[name], app, records, want,
                                   ("out", "in-deadletter"))
        return scenario

    got = {name: asyncio.run(scenario_for(name)(pkg)) for name, pkg in PACKAGES.items()}
    if policy == "fail":
        # a failing record ends the runner in both, with the user's error;
        # which failing record comes first depends on the batch's timing
        # in both packages, and records before it may or may not have
        # reached ``out`` by then
        for name in ("port", "jax"):
            kind, text = got[name]["error"]
            assert kind == ("ValueError" if mode == "in-process" else "RemoteAgentError"), kind
            number = int(text.rpartition("bad n ")[2])
            assert number % 11 == 0, text
    else:
        assert got["port"] == got["jax"]
        assert got["port"]["error"] is None
        assert bool(got["port"]["topics"]["in-deadletter"]) == (policy == "dead-letter")


def test_child_death_is_a_crash_not_a_hang(agents_dir):
    """``os._exit(7)`` in the child: that call and every later one raise
    ``AgentProcessCrashed`` naming exit code 7; the error policy cannot
    skip it; a fresh child spawns after."""
    async def scenario(pkg):
        mod = __import__(f"{'langstream_tpu_torch' if pkg is PACKAGES['port'] else 'langstream_tpu'}"
                         ".agents.isolation", fromlist=["AgentProcessCrashed"])
        config = {"className": "user_agents.Scale", "pythonPath": [agents_dir],
                  "isolation": "process"}
        agent = await make(pkg, "python-processor", config)
        results = await process(pkg, agent, seeded_records(pkg, count=6, dying=True))
        after = await process(pkg, agent, seeded_records(pkg, count=1))
        crashed = agent.agent_info()["user"]["crashed"]
        await agent.close()
        fresh = await make(pkg, "python-processor", config)
        again = outcome(await process(pkg, fresh, seeded_records(pkg, count=2)))
        await fresh.close()
        kinds = [type(r).__name__ if isinstance(r, BaseException) else len(r) for r in results]
        assert all(isinstance(r, mod.AgentProcessCrashed) for r in results[3:] + after)
        assert issubclass(mod.AgentProcessCrashed, mod.FatalAgentError)
        return kinds, str(results[3]), crashed, again

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    kinds, message, crashed, _ = got["port"]
    assert kinds[3:] == ["AgentProcessCrashed"] * 3 and "exit code 7" in message and crashed


def test_runner_fails_with_a_dead_child(agents_dir, tmp_path):
    async def scenario(pkg, name):
        app = write_app(tmp_path / name, agents_dir, "skip", "process")
        return await drive_app(pkg, STARTS[name], app, seeded_records(pkg, count=6, dying=True),
                               10 ** 6, ("out",))

    got = {name: asyncio.run(scenario(pkg, name)) for name, pkg in PACKAGES.items()}
    assert got["port"]["error"] == got["jax"]["error"]
    assert got["port"]["error"][0] == "AgentProcessCrashed"
    assert "exit code 7" in got["port"]["error"][1]


def test_same_module_name_in_two_apps(tmp_path):
    for name, mark in (("app_a", "A"), ("app_b", "B")):
        d = tmp_path / name / "python"
        d.mkdir(parents=True)
        (d / "dup_module.py").write_text(
            f"class P:\n    def process(self, record):\n        return [record.value + '-{mark}']\n")

    async def scenario(pkg):
        outs = []
        for name in ("app_a", "app_b", "app_a"):
            agent = await make(pkg, "python-processor", {
                "className": "dup_module.P", "pythonPath": [str(tmp_path / name / "python")]})
            outs.append(outcome(await process(pkg, agent, [pkg.Record(value="x")])))
        return outs

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    assert [o[0][0][0] for o in got["port"]] == ["x-A", "x-B", "x-A"]


def test_isolation_child_imports_no_torch(agents_dir):
    async def main():
        pkg = PACKAGES["port"]
        started = time.perf_counter()
        agent = await make(pkg, "python-processor", {
            "className": "user_agents.Modules", "pythonPath": [agents_dir],
            "isolation": "process"})
        (records,) = await process(pkg, agent, [pkg.Record(value=None)])
        spawn_s = time.perf_counter() - started
        await agent.close()
        return records[0].value, spawn_s

    loaded, spawn_s = asyncio.run(main())
    print(f"isolation child: spawned and answered in {spawn_s * 1e3:.0f} ms (this host's CPU)")
    assert loaded == []


def test_isolation_codec_against_jax():
    from langstream_tpu.agents import isolation as jax_isolation
    from langstream_tpu.utils import wire_json as jax_wire
    from langstream_tpu_torch.agents import isolation
    from langstream_tpu_torch.utils import wire_json

    rng = np.random.default_rng(33)
    tricky = [
        {"payload": {"__b64__": "aGk="}, "n": [1, {"__record__": 2}]},
        b"\x00\xff" + bytes(rng.integers(0, 256, size=16).astype(np.uint8)),
        {"__esc__": {"__b64__": "x"}}, {"__esc__": "legacy"}, {"__esc__": {"a": 1}},
        {"k": [None, True, 1.5, "s", {"deep": b"\x01"}], 3: "int key"},
    ]
    for value in tricky:
        assert wire_json.encode_value(value) == jax_wire.encode_value(value)
        assert isolation._enc(value) == jax_isolation._enc(value)
        encoded = jax_isolation._enc(value)
        assert isolation._dec(encoded) == jax_isolation._dec(encoded)
        assert wire_json.decode_value(encoded) == jax_wire.decode_value(encoded)
    record = PACKAGES["port"].Record(value={"__record__": 1}, key=b"k", origin="o",
                                     headers=(("h", b"\x02"),), timestamp=5)
    jax_record = PACKAGES["jax"].Record(value={"__record__": 1}, key=b"k", origin="o",
                                        headers=(("h", b"\x02"),), timestamp=5)
    assert isolation._enc_record(record) == jax_isolation._enc_record(jax_record)
    assert fields(isolation._dec_record(jax_isolation._enc_record(jax_record))) == fields(record)


def test_isolated_boot_failure_leaves_nothing(tmp_path):
    async def main():
        from langstream_tpu_torch.agents.isolation import RemoteAgentError

        before = set(os.listdir(os.environ.get("TMPDIR", "/tmp")))
        agent = PACKAGES["port"].create_agent("python-processor")
        with pytest.raises(RemoteAgentError, match="no_such"):
            await agent.init({"className": "no_such.Missing", "pythonPath": [str(tmp_path)],
                              "isolation": "process"})
        left = set(os.listdir(os.environ.get("TMPDIR", "/tmp"))) - before
        assert not [name for name in left if name.startswith("ls-agent-")], left

    asyncio.run(main())


def test_isolation_modes_are_checked(agents_dir, monkeypatch):
    async def main():
        agent = PACKAGES["port"].create_agent("python-processor")
        with pytest.raises(ValueError, match="isolation must be"):
            await agent.init({"className": "user_agents.Scale", "isolation": "Process"})
        monkeypatch.setenv("LS_PYTHON_ISOLATION", "process")
        agent = await make(PACKAGES["port"], "python-processor", {
            "className": "user_agents.Scale", "pythonPath": [agents_dir]})
        info = agent.agent_info()["user"]
        await agent.close()
        return info

    assert asyncio.run(main()) == {"isolation": "process", "crashed": False}
