"""The port's plugins (``runtime/plugins.py``), assets (``api/assets.py``,
``runtime/assets.py``) and typed configuration check (``model/docs.py``,
``compiler/planner.py``) against the JAX package's.

- Plugins: two plugins shipping the same module name load side by side, a
  ``.zip`` loads as a directory does, a plugin agent runs in a YAML app
  through ``LANGSTREAM_PLUGINS_DIR`` (its output equal to the JAX
  runner's), and ``plugins package`` / ``plugins list`` work.
- Assets: ``jdbc-table`` on the sqlite datasource (create, idempotent,
  delete) and ``vector-collection`` on the app's device, deployed by the
  runner before its agents start, as JAX's runner deploys them; an asset
  type no manager serves is refused by name.
- The typed check: the table is JAX's, property for property; the same
  configurations accepted and rejected as ``tests/test_docs.py`` holds
  for JAX, each rejection naming the same property; the planners of both
  packages reject the same seeded set of bad configurations with the
  same messages; ``camel-source`` URIs judged alike at plan time; the
  table covers every type the port registers; the port's own apps pass
  the check unchanged; the CLI's ``docs``.
"""

import asyncio
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import zipfile

import numpy as np
import pytest
import torch

from langstream_tpu.compiler import build_application as jax_build_application
from langstream_tpu.compiler import build_execution_plan as jax_build_plan
from langstream_tpu.model import docs as jax_docs
from langstream_tpu.runtime.local import run_application as jax_run_application
from langstream_tpu_torch.compiler import build_application, build_execution_plan
from langstream_tpu_torch.compiler.planner import GENAI_STEP_TYPES
from langstream_tpu_torch.model import docs
from langstream_tpu_torch.runtime import registry
from langstream_tpu_torch.runtime.local import LocalApplicationRunner, run_application
from langstream_tpu_torch.runtime.plugins import load_plugin, load_plugins
from torch_agent_pair import PACKAGES, WAIT_S, fields, outcome, process

REPO = pathlib.Path(__file__).resolve().parents[1]
PLUGIN = """
    from {package}.api.agent import SingleRecordProcessor

    MARK = "{mark}"

    class Shout(SingleRecordProcessor):
        async def process_record(self, record):
            return [record.with_value(str(record.value).upper() + MARK)]
"""


def write_plugin(root: pathlib.Path, name: str, agent_type: str, mark: str,
                 package: str = "langstream_tpu_torch") -> pathlib.Path:
    plugin = root / name
    (plugin / "python").mkdir(parents=True)
    (plugin / "plugin.yaml").write_text(f"name: {name}\nagents:\n  {agent_type}: impl.Shout\n")
    # every plugin ships a module of the same name
    (plugin / "python" / "impl.py").write_text(
        textwrap.dedent(PLUGIN.format(package=package, mark=mark)))
    return plugin


def shout(agent_type: str, values) -> list:
    async def main():
        port = PACKAGES["port"]
        agent = port.create_agent(agent_type)
        await agent.init({})
        return outcome(await process(port, agent, [port.Record(value=v) for v in values]))

    return asyncio.run(main())


def test_plugins_with_the_same_module_name_do_not_collide(tmp_path):
    write_plugin(tmp_path, "port-plug-a", "port-upper-a", "A")
    write_plugin(tmp_path, "port-plug-b", "port-upper-b", "B")
    assert load_plugins(str(tmp_path)) == {"port-plug-a": ["port-upper-a"],
                                           "port-plug-b": ["port-upper-b"]}
    assert shout("port-upper-a", ["hi"]) == [[("HIA", None, ())]]
    assert shout("port-upper-b", ["hi"]) == [[("HIB", None, ())]]


def test_zip_plugin_and_the_cli(tmp_path):
    source = write_plugin(tmp_path / "src", "port-zipped", "port-zip-agent", "Z")
    archive = tmp_path / "port-zipped.zip"
    done = subprocess.run(
        [sys.executable, "-m", "langstream_tpu_torch", "plugins", "package", str(source),
         "-o", str(archive)], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert done.returncode == 0, done.stderr[-2000:]
    assert sorted(zipfile.ZipFile(archive).namelist()) == ["plugin.yaml", "python/impl.py"]
    assert load_plugin(str(archive)) == ["port-zip-agent"]
    assert shout("port-zip-agent", ["a", "b"]) == [[("AZ", None, ())], [("BZ", None, ())]]
    listed = subprocess.run(
        [sys.executable, "-m", "langstream_tpu_torch", "plugins", "list"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO), LANGSTREAM_PLUGINS_DIR=str(tmp_path)))
    assert listed.returncode == 0, listed.stderr[-2000:]
    assert list(json.loads(listed.stdout)) == ["port_zipped"]
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "plugin.yaml").write_text("name: bad\n")
    with pytest.raises(ValueError, match="declares no agents"):
        load_plugin(str(bad))


def test_plugin_agent_in_a_yaml_app_like_jax(tmp_path, monkeypatch):
    app = tmp_path / "app"
    app.mkdir()
    (app / "pipeline.yaml").write_text(textwrap.dedent("""\
        topics:
          - {name: "in", creation-mode: create-if-not-exists}
          - {name: "out", creation-mode: create-if-not-exists}
        pipeline:
          - {id: "shout", type: "shout-plugin", input: "in", output: "out"}
    """))
    values = [f"v{int(n)}" for n in np.random.default_rng(51).integers(0, 99, size=5)]

    async def drive(pkg, start, plugins):
        monkeypatch.setenv("LANGSTREAM_PLUGINS_DIR", str(plugins))
        runner = await start(str(app))
        try:
            producer = runner.producer("in")
            for value in values:
                await producer.write(pkg.Record(value=value))
            reader = runner.reader("out")
            out = []
            deadline = asyncio.get_running_loop().time() + WAIT_S
            while len(out) < len(values):
                assert asyncio.get_running_loop().time() < deadline, out
                out.extend(await reader.read(timeout=0.2))
            return sorted(fields(r) for r in out)
        finally:
            await runner.stop()

    write_plugin(tmp_path / "port-plugins", "app-plug", "shout-plugin", "P")
    write_plugin(tmp_path / "jax-plugins", "app-plug", "shout-plugin", "P",
                 package="langstream_tpu")
    port = asyncio.run(drive(PACKAGES["port"], lambda d: run_application(d, device="cpu"),
                             tmp_path / "port-plugins"))
    jax = asyncio.run(drive(PACKAGES["jax"], jax_run_application, tmp_path / "jax-plugins"))
    assert port == jax == sorted((v.upper() + "P", None, ()) for v in values)


# ---------------------------------------------------------------------- #
# assets
# ---------------------------------------------------------------------- #
def asset_app(root: pathlib.Path, db: str, collection: str, extra: str = "") -> str:
    """An app with a ``jdbc-table`` and a ``vector-collection`` asset (and
    ``extra``, one more asset's flow mapping), whose one agent inserts
    each record into the table."""
    app = root / "app"
    app.mkdir(parents=True)
    (app / "configuration.yaml").write_text(textwrap.dedent(f"""\
        configuration:
          resources:
            - type: "datasource"
              name: "my-db"
              configuration: {{service: "sqlite", path: "{db}"}}
    """))
    (app / "pipeline.yaml").write_text(textwrap.dedent(f"""\
        assets:
          - name: "docs-table"
            asset-type: "jdbc-table"
            creation-mode: create-if-not-exists
            deletion-mode: delete
            config:
              datasource: "my-db"
              table-name: "docs"
              create-statements:
                - "CREATE TABLE docs (id INTEGER PRIMARY KEY, text TEXT, score REAL)"
                - "CREATE INDEX docs_text ON docs (text)"
          - name: "corpus"
            asset-type: "vector-collection"
            creation-mode: create-if-not-exists
            config: {{collection-name: "{collection}", dimensions: 12}}
        EXTRA
        topics:
          - {{name: "in", creation-mode: create-if-not-exists}}
        pipeline:
          - name: "store"
            type: "query"
            input: "in"
            configuration:
              datasource: "my-db"
              mode: "execute"
              query: "INSERT INTO docs (id, text) VALUES (?, ?)"
              fields: ["value.id", "value.text"]
              output-field: "value.result"
    """).replace("EXTRA\n", f"  - {extra}\n" if extra else ""))
    return str(app)


def sqlite_schema(db: str) -> list:
    import sqlite3

    with sqlite3.connect(db) as connection:
        return sorted(connection.execute("SELECT type, name, sql FROM sqlite_master").fetchall())


def test_assets_deploy_before_the_agents_like_jax(tmp_path):
    from langstream_tpu.agents import vectorstore as jax_vectorstore
    from langstream_tpu_torch.agents import vectorstore

    async def drive(name, start, stores):
        db = str(tmp_path / f"{name}.sqlite")
        runner = await start(asset_app(tmp_path / name, db, f"corpus-{name}"))
        try:
            await runner.producer("in").write(PACKAGES[name].Record(
                value={"id": 7, "text": "seven"}))
            deadline = asyncio.get_running_loop().time() + WAIT_S
            import sqlite3

            while True:
                with sqlite3.connect(db) as connection:
                    rows = connection.execute("SELECT id, text FROM docs").fetchall()
                if rows:
                    break
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.05)
        finally:
            await runner.stop()
        store = stores.pop(f"corpus-{name}")
        return sqlite_schema(db), rows, store.dimensions, store

    port = asyncio.run(drive("port", lambda d: run_application(d, device="cpu"),
                             vectorstore._SHARED_STORES))
    jax = asyncio.run(drive("jax", jax_run_application, jax_vectorstore._SHARED_STORES))
    assert port[:3] == jax[:3]
    assert port[1] == [(7, "seven")] and port[2] == 12
    assert port[3].device == torch.device("cpu")


def test_jdbc_table_asset_roundtrip(tmp_path):
    from langstream_tpu_torch.api.assets import cleanup_assets, create_asset_manager, deploy_assets
    from langstream_tpu_torch.model.application import AssetDefinition

    db = str(tmp_path / "db.sqlite")
    resources = {"my-db": {"configuration": {"service": "sqlite", "path": db}}}
    asset = AssetDefinition(id="t1", name="docs", asset_type="jdbc-table",
                            creation_mode="create-if-not-exists", deletion_mode="delete",
                            config={"datasource": "my-db", "table-name": "docs",
                                    "create-statements": ["CREATE TABLE docs (id INTEGER)"]})

    async def exists():
        manager = create_asset_manager("jdbc-table")
        await manager.init(asset, resources, "cpu")
        return await manager.asset_exists()

    async def main():
        await deploy_assets([asset], resources, "cpu")
        assert await exists()
        await deploy_assets([asset], resources, "cpu")  # idempotent
        await cleanup_assets([asset], resources, "cpu")
        assert not await exists()

    asyncio.run(main())


@pytest.mark.parametrize("asset_type", ["cassandra-table", "opensearch-index"])
def test_unmanaged_asset_types_are_refused_by_name(tmp_path, asset_type):
    app = asset_app(tmp_path, str(tmp_path / "db.sqlite"), "unused",
                    extra=f"{{name: other, asset-type: {asset_type}}}")
    plan = build_execution_plan(build_application(app))
    assert [a.asset_type for a in plan.assets][-1] == asset_type
    with pytest.raises(ValueError, match=f"'{asset_type}' \\('other'\\) is not yet ported"):
        LocalApplicationRunner(plan, device="cpu")


# ---------------------------------------------------------------------- #
# the typed configuration check
# ---------------------------------------------------------------------- #
def test_the_table_is_jaxs():
    assert docs.generate_docs_model() == jax_docs.generate_docs_model()


def test_the_table_covers_every_type_the_port_registers():
    documented = set(docs.all_docs())
    # the built-in table (plugins of other tests register their own types)
    assert not (set(registry._BUILTIN) | GENAI_STEP_TYPES) - documented


# the accepts and rejects of tests/test_docs.py, with the property each names
CASES = [
    ("drop-fields", {"fields": ["a"]}, None),
    ("drop-fields", {"fields": ["a"], "oops": 1}, "unknown property 'oops'"),
    ("compute", {}, "missing required property 'fields'"),
    ("text-splitter", {"chunk_size": "big"}, "'chunk_size' expects integer"),
    ("text-splitter", {"chunk_size": "256"}, None),
    ("cast", {"schema-type": "string", "part": "header"}, "'part' must be one of"),
    ("my-custom-agent", {"whatever": 1}, None),
    ("python-processor", {"className": "x.Y", "custom-knob": 3}, None),
    ("re-rank", {"vector-field": "v"}, None),
    ("re-rank", {}, None),
    ("log-event", {"message": "hi"}, None),
    ("file-source", {"path": "/tmp", "delete-objects": True}, None),
    ("query-vector-db", {"datasource": "db", "query": "q", "output-field": "o",
                         "only-first": ""}, "'only-first' is blank"),
    ("drop-fields", {"fields": ""}, "'fields' is blank"),
    ("ai-chat-completions", {"model": "m", "messages": [], "completion-field": ""}, None),
    ("drop-fields", {"fields": "a,b"}, "'fields' expects list"),
    ("exec-source", {"command": "ls", "parse-json": "maybe"}, "'parse-json' expects boolean"),
    ("http-request", {"method": "GET"}, "missing required property 'url'"),
    ("webcrawler-source", {"seed-urls": ["u"], "state-storage": "cloud"},
     "'state-storage' must be one of"),
    ("timer-source", {"period-seconds": 1.5}, "'period-seconds' expects integer"),
]


@pytest.mark.parametrize("agent_type,config,error", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_accepts_and_rejects_like_jax(agent_type, config, error):
    got = docs.validate_agent_config(agent_type, config)
    assert got == jax_docs.validate_agent_config(agent_type, config)
    if error is None:
        assert got == []
    else:
        assert any(error in message for message in got), got


def bad_config_app(root: pathlib.Path, rng) -> str:
    """An app whose agents carry seeded mistakes: unknown keys, missing
    required ones, wrong types, bad choices, camel URIs."""
    choices = [
        ("compute", {"fieldz": []}),
        ("drop-fields", {"fields": ["a"], "part": "middle"}),
        ("exec-source", {"commandline": "ls"}),
        ("http-request", {"url": "http://x", "allow-redirects": "perhaps"}),
        ("langserve-invoke", {"url": "http://x", "min-chunks-per-message": "lots"}),
        ("webcrawler-source", {"seed-urls": "one"}),
        ("s3-source", {"idle-time": "soon", "bucketName": "b"}),
        ("camel-source", {"component-uri": "jms:queue:orders"}),
        ("camel-source", {"component-uri": "kafka:?brokers=h:9092"}),
        ("camel-source", {"component-uri": "timer:t?period=100"}),
        ("camel-source", {"component-uri": "custom:x", "expect-plugin-scheme": True}),
        ("python-processor", {"isolation": "process"}),
        ("trigger-event", {"continue-processing": "", "destination": "t"}),
    ]
    picked = [choices[i] for i in sorted(rng.choice(len(choices), size=8, replace=False))]
    agents = "".join(
        f"  - name: a{i}\n    type: {agent_type}\n    input: in\n"
        f"    configuration: {json.dumps(config)}\n" for i, (agent_type, config) in enumerate(picked))
    app = root / f"bad-{len(list(root.iterdir())) if root.exists() else 0}"
    app.mkdir(parents=True)
    (app / "pipeline.yaml").write_text(f"topics:\n  - name: in\npipeline:\n{agents}")
    return str(app)


@pytest.mark.parametrize("seed", [61, 62, 63])
def test_planners_reject_the_same_configurations(tmp_path, seed):
    app = bad_config_app(tmp_path, np.random.default_rng(seed))
    with pytest.raises(ValueError) as jax_error:
        jax_build_plan(jax_build_application(app))
    with pytest.raises(ValueError) as port_error:
        build_execution_plan(build_application(app))
    # the messages name the same agents and properties; the camel
    # recipe names each package's own module
    want = str(jax_error.value).replace("langstream_tpu.agents.camel.register_camel_scheme",
                                        "register_camel_scheme")
    assert str(port_error.value) == want
    assert str(port_error.value).startswith("invalid agent configuration:")


@pytest.mark.parametrize("uri", [
    "jms:queue:orders", "kafka:?brokers=h:9092", "kafka:orders?brokers=h:9092", "timer:",
    "timer:t?period=100", "file:", "file:/tmp/in?delete=true", "aws2-s3://bkt?accessKey=a",
    "aws2-s3://?accessKey=a", "azure-storage-blob://acct/cont", "pulsar:topic", "http:",
    "https://example.invalid/x", "netty-http:", "${globals.uri:-}", "jms:q?pw=${secrets.pw}",
    "no-colon", ":missing-scheme", "HTTP://Upper.invalid"])
@pytest.mark.parametrize("plugin", [False, True])
def test_camel_uris_judged_like_jax(uri, plugin):
    from langstream_tpu.agents.camel import validate_component_uri

    from langstream_tpu_torch.agents import camel

    want = validate_component_uri(uri, None, expect_plugin_scheme=plugin)
    got = camel.validate_component_uri(uri, None, expect_plugin_scheme=plugin)
    assert (got is None) == (want is None)
    if want is not None:
        assert got == want.replace("langstream_tpu.agents.camel.register_camel_scheme",
                                   "register_camel_scheme")


@pytest.mark.parametrize("app,instance", [
    ("torch-completions", "local-tiny.yaml"), ("torch-rag", "local-rag-tiny.yaml"),
    ("torch-chatbot-memory", "local-tiny.yaml")])
def test_the_ports_apps_pass_the_check(app, instance):
    application = build_application(
        str(REPO / "langstream_tpu_torch" / "examples" / "applications" / app),
        instance_file=str(REPO / "examples" / "instances" / instance))
    plan = build_execution_plan(application)
    assert plan.agents


def test_cli_docs():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", "langstream_tpu_torch", "docs", "re-rank"],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "MMR" in out.stdout and out.stdout.startswith("re-rank (processor)")
    out = subprocess.run([sys.executable, "-m", "langstream_tpu_torch", "docs", "--json"],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout) == jax_docs.generate_docs_model()
