"""The agent apps end to end on the CPU.

``torch-chatbot-memory`` (``examples/applications/chatbot-memory`` on the
port): the JAX tiny preset's parameters (seed 3) are saved in f32 by each
package's ``save_model``, and a copy of each package's app in
``tmp_path`` names its own as its resource's ``checkpoint``. The port's app
runs under its runner and its gateway, on the dense and the paged
layout with the prefix cache off: two sessions ask three turns each
through the ``chat`` gateway, turn by turn. Gates: every answer reaches
its own session; the engine counts two session hits per follow-up turn;
each follow-up's generated token ids equal those of a cold session asked
the text that follow-up rendered (its history then its question), in the
same app; and the answers (question, history, session, answer) equal
those of the JAX package's ``chatbot-memory`` over the same checkpoint,
its engine's token ids the port's, greedy both.

The JAX package's ``timer-events``, ``http-request-processor``,
``langserve-invoke``, ``exec-connector``, ``python-custom-agent`` and
``webcrawler-to-vector`` run unchanged through the port's
``LocalApplicationRunner`` and the JAX one (``webcrawler-to-vector`` with
its resource's ``type: jax-local`` swapped for ``torch-local``, as
``test_torch_rag_apps.py`` does), their URLs pointed at a local
``http.server`` through ``globals``; their output topics must be equal.
``timer-events`` routes on a ``value.count`` its timer does not emit, so
in both packages its dispatch fails on the first tick and its runner
ends with the same error. ``exec-connector``'s command exits at once, and
JAX's ``exec-source`` then spins on its EOF without yielding (its runner
hangs): the port, which waits for the exit and restarts the command, is
held to the records each run of it makes.
"""

import asyncio
import contextlib
import http.server
import json
import pathlib
import shutil
import threading

import numpy as np
import pytest
import torch

from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.runtime.local import run_application as jax_run_application
from langstream_tpu_torch.agents import vectorstore
from langstream_tpu_torch.gateway import GatewayServer, websocket
from langstream_tpu_torch.providers.torch_local import model
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax
from langstream_tpu_torch.runtime.local import run_application
from torch_agent_pair import PACKAGES, WAIT_S, fields

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
INSTANCE = EXAMPLES / "instances" / "local-tiny.yaml"
PORT_APP = REPO / "langstream_tpu_torch" / "examples" / "applications" / "torch-chatbot-memory"
SESSION = "langstream-client-session-id"
SESSIONS = ("conv-a", "conv-b")
TURNS = 3


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory) -> dict:
    """The JAX tiny preset's f32 weights (seed 3), saved by each package's
    ``training.checkpoint.save_model``: in f32 the two packages' logits
    agree to about 1e-6, so greedy streams do not part at bf16's
    near-ties (as ``test_torch_app_e2e.py``'s seeded case serves them)."""
    from langstream_tpu.training.checkpoint import save_model as jax_save_model
    from langstream_tpu_torch.training.checkpoint import save_model

    base = tmp_path_factory.mktemp("tiny-weights")
    jconfig = jax_model.LlamaConfig.tiny()
    jparams = jax_model.init_params(jconfig, seed=3)
    jax_save_model(str(base / "jax"), jconfig, jparams)
    config = model.LlamaConfig.tiny()
    save_model(str(base / "port"), config,
               params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, config))
    return {"jax": str(base / "jax"), "port": str(base / "port")}


def copy_app(source: pathlib.Path, target: pathlib.Path, checkpoint: str) -> str:
    """The app with ``checkpoint`` in its resource, and its engine keeping
    the top-2 logprobs of each token (what a parting is judged by)."""
    shutil.copytree(source, target)
    configuration = target / "configuration.yaml"
    text = configuration.read_text()
    assert text.count("        model:\n") == 1 and text.count("        engine:\n") == 1
    configuration.write_text(text.replace(
        "        model:\n", f"        checkpoint: {json.dumps(checkpoint)}\n        model:\n").replace(
        "        engine:\n", "        engine:\n          logprobs-top-k: 2\n"))
    return str(target)


def questions() -> dict:
    rng = np.random.default_rng(71)
    words = ["stream", "token", "kernel", "agent", "topic", "card", "memory", "turn"]
    return {(session, turn): f"{session} turn {turn}: " + " ".join(rng.choice(words, size=5)) + "?"
            for turn in range(TURNS) for session in SESSIONS}


def record_generations(engine) -> list:
    """Wrap ``engine.generate`` to keep each call's session, prompt and
    generated ids, in the order they finish."""
    calls = []
    generate = engine.generate

    async def recording(prompt_tokens, sampling, **kwargs):
        result = await generate(prompt_tokens, sampling, **kwargs)
        calls.append((kwargs.get("session_id"), list(prompt_tokens),
                      [int(t) for t in result.tokens],
                      [[float(lp) for lp in lps] for _ids, lps in result.top_logprobs or []]))
        return result

    engine.generate = recording
    return calls


async def chat_turns(base: str, app_id: str, asks) -> list:
    """Each (session, question) in turn over the chat gateway; the answer
    record each got."""
    out = []
    sockets = {}
    try:
        for session, question in asks:
            if session not in sockets:
                sockets[session] = await websocket.connect(
                    f"{base}/v1/chat/default/{app_id}/chat?param:session-id={session}")
            ws = sockets[session]
            await ws.send_json({"value": question})
            message = await asyncio.wait_for(ws.receive(), WAIT_S)
            out.append(message.json()["record"])
    finally:
        for ws in sockets.values():
            await ws.close()
    return out


def port_chat_run(base: pathlib.Path, checkpoint: str, layout: str) -> dict:
    """The port's app on ``layout`` with the prefix cache off (a prompt
    reuses KV only through its session), so that the oracle's sessions
    prefill cold."""
    app = copy_app(PORT_APP, base / "torch-chatbot-memory", checkpoint)
    instance = base / "instance.yaml"
    instance.write_text(INSTANCE.read_text() + f"    kv-layout: {layout}\n    prefix-cache: false\n")
    asks = questions()

    async def main():
        runner = await run_application(app, instance_file=str(instance), device="cpu")
        gateway = GatewayServer(port=0)
        gateway.register_local_runner(runner)
        await gateway.start()
        engine = runner._service_provider_registry.completions().engine  # noqa: SLF001
        calls = record_generations(engine)
        base = f"ws://127.0.0.1:{gateway.port}"
        try:
            answers, hits = [], []
            for turn in range(TURNS):
                answers += await chat_turns(base, runner.application.application_id,
                                            [(s, asks[s, turn]) for s in SESSIONS])
                hits.append(engine.stats["session_hits"])
            warm, prefills = len(calls), engine.stats["prefill_calls"]
            # the cold oracle: fresh sessions asked what each follow-up rendered
            rendered = [(f"cold-{r['headers'][SESSION]}-{i}",
                         r["value"]["history"] + r["value"]["question"])
                        for i, r in enumerate(answers) if r["value"]["history"]]
            cold = await chat_turns(base, runner.application.application_id, rendered)
            return {"answers": answers, "hits": hits, "calls": calls[:warm],
                    "cold": cold, "cold_calls": calls[warm:], "stats": dict(engine.stats),
                    "cold_prefills": engine.stats["prefill_calls"] - prefills}
        finally:
            await gateway.stop()
            await runner.stop()

    return asyncio.run(main())


@pytest.fixture(scope="module")
def port_chat(tmp_path_factory, checkpoints):
    return port_chat_run(tmp_path_factory.mktemp("port"), checkpoints["port"], "dense")


@pytest.fixture(scope="module")
def port_chat_paged(tmp_path_factory, checkpoints):
    return port_chat_run(tmp_path_factory.mktemp("port-paged"), checkpoints["port"], "paged")


@pytest.fixture(scope="module")
def jax_chat(tmp_path_factory, checkpoints):
    app = copy_app(EXAMPLES / "applications" / "chatbot-memory",
                   tmp_path_factory.mktemp("jax") / "chatbot-memory", checkpoints["jax"])
    asks = questions()

    async def main():
        runner = await jax_run_application(app, instance_file=str(INSTANCE))
        engine = runner._service_provider_registry.completions().engine  # noqa: SLF001
        calls = record_generations(engine)
        try:
            producer = runner.producer("questions")
            reader = runner.reader("answers")
            answers = []
            for turn in range(TURNS):
                for session in SESSIONS:
                    await producer.write(PACKAGES["jax"].Record(
                        value=asks[session, turn], headers=((SESSION, session),)))
                    got = []
                    deadline = asyncio.get_running_loop().time() + WAIT_S
                    while not got:
                        assert asyncio.get_running_loop().time() < deadline
                        got.extend(await reader.read(timeout=0.2))
                    answers.append(got[0])
            return {"answers": [(r.value, r.header(SESSION)) for r in answers], "calls": calls,
                    "hits": engine.stats["session_hits"]}
        finally:
            await runner.stop()

    return asyncio.run(main())


LAYOUTS = {"dense": "port_chat", "paged": "port_chat_paged"}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_chatbot_answers_reach_their_sessions(request, layout):
    asks = questions()
    answers = request.getfixturevalue(LAYOUTS[layout])["answers"]
    assert len(answers) == TURNS * len(SESSIONS)
    for i, record in enumerate(answers):
        session = SESSIONS[i % len(SESSIONS)]
        value = record["value"]
        assert record["headers"][SESSION] == session and value["sessionId"] == session
        assert value["question"] == asks[session, i // len(SESSIONS)]
        assert isinstance(value["answer"], str)
    # each follow-up's history is its session's transcript so far
    for i, record in enumerate(answers[len(SESSIONS):], start=len(SESSIONS)):
        before = answers[i - len(SESSIONS)]["value"]
        assert record["value"]["history"] == before["history"] + before["question"] + before["answer"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_chatbot_follow_ups_hit_their_sessions(request, layout):
    port_chat = request.getfixturevalue(LAYOUTS[layout])
    # no hit on the first turn; two (one per session) on each follow-up
    assert port_chat["hits"] == [0, 2, 4]
    assert port_chat["stats"]["warm_prefill_calls"] >= 4


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_chatbot_follow_ups_equal_a_cold_run(request, layout):
    port_chat = request.getfixturevalue(LAYOUTS[layout])
    # the oracle's prompts prefilled cold: one cold prefill each, no hit
    assert port_chat["cold_prefills"] == (TURNS - 1) * len(SESSIONS)
    assert port_chat["stats"]["session_hits"] == port_chat["hits"][-1]
    warm = port_chat["calls"][len(SESSIONS):]
    cold = port_chat["cold_calls"]
    assert len(warm) == len(cold) == (TURNS - 1) * len(SESSIONS)
    for (session, prompt, tokens, _), (_, cold_prompt, cold_tokens, _) in zip(warm, cold):
        assert prompt == cold_prompt, session  # the same rendered prompt
        assert tokens == cold_tokens and tokens, session
    assert [r["value"]["answer"] for r in port_chat["cold"]] == [
        r["value"]["answer"] for r in port_chat["answers"][len(SESSIONS):]]


# f32 weights: the packages' logits agree to about 1e-6, so a greedy
# stream may part only where JAX's top two logprobs are this close
NEAR_TIE = 1e-4


def test_chatbot_equals_the_jax_app(port_chat, jax_chat):
    """Each turn's prompt and generated ids equal JAX's, or part at a
    near-tie of JAX's run (after which that session's transcripts, and so
    its later prompts, differ); the answers of every turn before any
    parting equal JAX's records."""
    parted = set()
    equal = 0
    for (session, prompt, tokens, _), (jax_session, jax_prompt, jax_tokens, tops) in zip(
            port_chat["calls"], jax_chat["calls"]):
        assert session == jax_session
        if session in parted:
            continue
        assert prompt == jax_prompt, session
        if tokens == jax_tokens:
            equal += 1
            continue
        part = next(k for k, (a, b) in enumerate(zip(tokens, jax_tokens)) if a != b)
        gap = tops[part][0] - tops[part][1]
        assert gap <= NEAR_TIE, (session, part, gap)
        parted.add(session)
    assert equal >= len(port_chat["calls"]) - 1, equal
    # the gateway's trace id (a fresh uuid, copied into the value by
    # document-to-json) is the one field the JAX run, fed by a producer,
    # does not have
    port = [({k: v for k, v in r["value"].items() if k != "langstream-trace-id"},
             r["headers"][SESSION]) for r in port_chat["answers"]]
    same = [i for i, (_, session) in enumerate(port) if session not in parted]
    assert [port[i] for i in same] == [jax_chat["answers"][i] for i in same]
    assert jax_chat["hits"] == port_chat["hits"][-1]


# ---------------------------------------------------------------------- #
# the JAX package's agent apps through both runners
# ---------------------------------------------------------------------- #
class _Handler(http.server.BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def _reply(self, status, content_type, body: str):
        data = body.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/robots.txt":
            return self._reply(200, "text/plain", "User-agent: *\nDisallow: /private\n")
        if self.path.startswith("/forecast"):
            return self._reply(200, "application/json", json.dumps({"echo": self.path}))
        pages = {"/": '<html><body><p>stream processing on the card.</p><a href="/two">two</a>'
                      '<a href="/private/x">x</a></body></html>',
                 "/two": "<html><body><h1>Kernels</h1><p>paged attention and topics.</p>"
                         "</body></html>"}
        if self.path in pages:
            return self._reply(200, "text/html", pages[self.path])
        return self._reply(404, "text/plain", "missing")

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self._reply(200, "application/json",
                    json.dumps({"output": f"a story about {body['input']['topic']}"}))


@contextlib.contextmanager
def local_site():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()


APPS = {
    # app: (instance, records to write to its input, output topics, records to wait for)
    "timer-events": (None, None, ("ticks", "even-ticks", "odd-ticks"), None),
    "http-request-processor": ("api-url: '{base}/forecast'", ("requests", ["Rome", "Oslo"]),
                               ("responses",), 2),
    "langserve-invoke": ("langserve-url: '{base}/chain/invoke'", ("in", ["cats", "dogs"]),
                         ("out",), 2),
    "exec-connector": (None, None, ("lines",), 2),
    "python-custom-agent": (None, ("in", [{"a": 1}, "text"]), ("out",), 2),
    "webcrawler-to-vector": ("seed-url: '{base}/'\n    allowed-domain: '{base}'", None,
                             ("crawled",), 2),
}


def app_instance(tmp_path: pathlib.Path, name: str, base: str) -> str:
    extra, *_ = APPS[name]
    source = EXAMPLES / "instances" / ("local-rag-tiny.yaml" if name == "webcrawler-to-vector"
                                       else "local-tiny.yaml")
    text = source.read_text()
    if extra:
        text += "    " + extra.format(base=base) + "\n"
    path = tmp_path / f"{name}.yaml"
    path.write_text(text)
    return str(path)


def app_dir(tmp_path: pathlib.Path, name: str, package: str) -> str:
    """The app as it is for the JAX runner; for the port's, its
    ``jax-local`` resource is a ``torch-local`` one."""
    if package == "jax":
        return str(EXAMPLES / "applications" / name)
    target = tmp_path / name
    shutil.copytree(EXAMPLES / "applications" / name, target)
    configuration = target / "configuration.yaml"
    if configuration.exists():
        text = configuration.read_text()
        configuration.write_text(text.replace('type: "jax-local"', 'type: "torch-local"'))
    return str(target)


async def drive(pkg, runner, name: str) -> dict:
    _, inputs, topics, want = APPS[name]
    error = None
    try:
        if inputs:
            producer = runner.producer(inputs[0])
            for value in inputs[1]:
                await producer.write(pkg.Record(value=value))
        readers = {topic: runner.reader(topic) for topic in topics}
        got = {topic: [] for topic in topics}
        join = asyncio.ensure_future(runner.join())
        deadline = asyncio.get_running_loop().time() + WAIT_S
        while not join.done() and (want is None or sum(map(len, got.values())) < want):
            assert asyncio.get_running_loop().time() < deadline, got
            for topic, reader in readers.items():
                got[topic].extend(await reader.read(timeout=0.05))
        if join.done():
            error = join.exception()
        else:
            join.cancel()
    finally:
        try:
            await runner.stop()
        except Exception as stopped:  # noqa: BLE001 — a failed runner's error
            error = error or stopped
    return {"topics": {topic: [fields(r) for r in records][:want]
                       for topic, records in got.items()},
            "error": None if error is None else (type(error).__name__, str(error))}


@pytest.mark.parametrize("name", sorted(APPS))
def test_jax_example_app_runs_on_the_port_like_jax(tmp_path, name):
    with local_site() as base:
        instance = app_instance(tmp_path, name, base)
        async def port():
            runner = await run_application(app_dir(tmp_path, name, "port"),
                                           instance_file=instance, device="cpu")
            try:
                return await drive(PACKAGES["port"], runner, name)
            finally:
                vectorstore._SHARED_STORES.clear()

        async def jax():
            from langstream_tpu.agents import vectorstore as jax_vectorstore

            runner = await jax_run_application(app_dir(tmp_path, name, "jax"),
                                               instance_file=instance)
            try:
                return await drive(PACKAGES["jax"], runner, name)
            finally:
                jax_vectorstore._SHARED_STORES.clear()

        if name == "exec-connector":
            # JAX's exec-source spins on its command's EOF and never yields
            # to the loop again (the port's waits for the exit): its runner
            # hangs, so the port is held to the records JAX's agent makes
            # of each run of the command, one line, as shlex splits it
            got = {"port": asyncio.run(port())}
            line = ("one; echo two; echo three", None, ())
            assert got["port"] == {"topics": {"lines": [line, line]}, "error": None}
            return
        got = {"port": asyncio.run(port()), "jax": asyncio.run(jax())}
    assert got["port"] == got["jax"]
    result = got["port"]
    if name == "timer-events":
        assert result["error"][0] == "ExpressionError" and len(result["topics"]["ticks"]) == 1
    else:
        assert result["error"] is None and all(result["topics"].values())
