"""The RAG path's modules of the port against the JAX package's, unit by
unit, on the same inputs (made from a seed with numpy), on the CPU.

- ``runtime/batching.py``: the two executors on the scenarios of
  ``tests/test_batching.py``, each package's batches equal.
- ``agents/text.py``: the splitter on seeded texts over several
  separators, chunk sizes, overlaps and both length functions (equal
  chunks); the ``text-splitter``, ``text-normaliser``,
  ``language-detector`` and ``text-extractor`` agents' records equal.
- ``agents/rerank.py``: ``mmr_rank`` and the ``re-rank`` agent equal.
- ``agents/flare.py``: ``low_confidence_spans`` equal; the controller's
  passed and looped records equal.
- ``agents/datasource.py``: the SQLite and memory datasources' ``query``
  and ``execute`` rows equal; the unported services refused by name.
- ``agents/genai.py``: ``compute-ai-embeddings`` against JAX's with the
  same encoder (vectors within 1e-5, one service call per batch, the
  same batches); ``query`` in both modes.
- ``agents/vector.py``: the sink's upserts and the query agent's results
  (ids equal, similarity within 1e-5).
- ``providers/registry.py``: ``embeddings`` cached per (resource, model),
  closed with the registry.
- ``runtime/registry.py``: every JAX built-in type the port lacks refused
  by name; the ten new types build.
- ``apps run --http-port``: ``/metrics`` counts the ingest sink's records,
  ``/info``, ``/ready``, ``/ok``, ``/debug/profile``'s 400.
- Without CUDA, ``DataSourceRegistry``, the vector store through it, the
  embeddings service and ``run_application`` of ``torch-rag`` raise
  unless asked for the CPU.
"""

import asyncio
import copy
import json
import math
import os
import pathlib
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import langstream_tpu.agents  # noqa: F401 — registers the JAX package's agent types
from langstream_tpu.agents import datasource as jax_datasource
from langstream_tpu.agents import flare as jax_flare
from langstream_tpu.agents import rerank as jax_rerank
from langstream_tpu.agents import text as jax_text
from langstream_tpu.agents import vectorstore as jax_vectorstore
from langstream_tpu.api.agent import AgentContext as JaxAgentContext
from langstream_tpu.api.records import Record as JaxRecord
from langstream_tpu.providers.jax_local.provider import JaxEmbeddingsService
from langstream_tpu.runtime import batching as jax_batching
from langstream_tpu.runtime.registry import agent_types as jax_agent_types
from langstream_tpu.runtime.registry import create_agent as jax_create_agent
from langstream_tpu.runtime.runner import process_and_collect as jax_process_and_collect
from langstream_tpu_torch.agents import datasource, flare, rerank, text, vectorstore
from langstream_tpu_torch.api.agent import AgentContext
from langstream_tpu_torch.api.records import Record
from langstream_tpu_torch.providers.registry import ServiceProviderRegistry
from langstream_tpu_torch.providers.torch_local.convert import encoder_params_from_jax
from langstream_tpu_torch.providers.torch_local.provider import TorchEmbeddingsService
from langstream_tpu_torch.runtime import batching
from langstream_tpu_torch.runtime.registry import agent_types, create_agent
from langstream_tpu_torch.runtime.runner import process_and_collect

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
RAG_APP = REPO / "langstream_tpu_torch" / "examples" / "applications" / "torch-rag"
RAG_INSTANCE = REPO / "examples" / "instances" / "local-rag-tiny.yaml"
EMBED_TOLERANCE = 1e-5
SCORE_TOLERANCE = 1e-5
CPU = "cpu"
NEW_TYPES = ("compute-ai-embeddings", "query", "vector-db-sink", "query-vector-db",
             "text-splitter", "text-normaliser", "language-detector", "text-extractor",
             "re-rank", "flare-controller")
WORDS = ["stream", "vector", "kernel", "topic", "agent", "card", "search", "token", "batch",
         "the", "and", "of", "la", "de", "und", "der", "a", "is"]

# each package's pieces under one name: ``PKG["jax"]`` and ``PKG["port"]``
PKG = {
    "jax": dict(create_agent=jax_create_agent, context=JaxAgentContext, record=JaxRecord,
                collect=jax_process_and_collect, batching=jax_batching, text=jax_text,
                datasource=jax_datasource, vectorstore=jax_vectorstore, flare=jax_flare,
                rerank=jax_rerank, context_kwargs={}),
    "port": dict(create_agent=create_agent, context=AgentContext, record=Record,
                 collect=process_and_collect, batching=batching, text=text,
                 datasource=datasource, vectorstore=vectorstore, flare=flare, rerank=rerank,
                 context_kwargs={"device": CPU}),
}


def both(fn):
    """``fn(package)`` for the JAX package, then the port: (jax, port)."""
    return fn(PKG["jax"]), fn(PKG["port"])


async def make(pkg, agent_type, config, **context):
    agent = pkg["create_agent"](agent_type)
    agent.agent_id = f"test-{agent_type}"
    await agent.init(config)
    await agent.set_context(pkg["context"](agent_id="t", **pkg["context_kwargs"], **context))
    await agent.start()
    return agent


async def process(agent, pkg, records):
    results = await pkg["collect"](agent, records)
    for result in results:
        if result.error:
            raise result.error
    return [[(r.value, tuple(r.headers)) for r in result.result_records] for result in results]


def run_agent(agent_type, config, values, **context):
    """Each package's agent over records of ``values``: their outputs."""
    def one(pkg):
        async def go():
            agent = await make(pkg, agent_type, config, **context)
            try:
                # a step sets fields in its record's value: each run its own copy
                return await process(agent, pkg, [pkg["record"](value=copy.deepcopy(v))
                                                  for v in values])
            finally:
                await agent.close()
        return asyncio.run(go())
    return both(one)


def _texts(seed, count=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        paragraphs = []
        for _ in range(int(rng.integers(1, 5))):
            lines = [" ".join(rng.choice(WORDS, size=int(rng.integers(3, 30))))
                     + str(rng.choice(["", ".", ",", "!"])) for _ in range(int(rng.integers(1, 4)))]
            paragraphs.append("\n".join(lines))
        out.append("\n\n".join(paragraphs))
    return out


# ---------------------------------------------------------------------- #
# batching
# ---------------------------------------------------------------------- #
def _batches(module, scenario):
    async def go():
        batches = []

        async def proc(batch):
            await asyncio.sleep(0.005)
            batches.append(list(batch))

        if scenario == "size":
            ex = module.BatchExecutor(3, proc)
            for i in range(7):
                await ex.add(i)
            mid = [list(b) for b in batches]
            await ex.close()
            return mid, batches
        if scenario == "timer":
            ex = module.BatchExecutor(100, proc, flush_interval=0.05)
            await ex.add("a")
            await asyncio.sleep(0.15)
            return batches
        if scenario == "bytes":
            ex = module.BatchExecutor(100, proc, max_bytes=10, size_of=len)
            for item in ("aaaa", "bbbbbbb", "c", "dddddddddddd", "e"):
                await ex.add(item)
            await ex.close()
            return batches
        ex = module.OrderedAsyncBatchExecutor(2, proc, buckets=4, hash_fn=lambda item: item[1])
        items = [(i, key) for i in range(6) for key in (1, 2, 7)]
        for item in items:
            await ex.add(item)
        await ex.close()
        return {key: [i for batch in batches for i, k in batch if k == key] for key in (1, 2, 7)}

    return asyncio.run(go())


@pytest.mark.parametrize("scenario", ["size", "timer", "bytes", "ordered"])
def test_batch_executors_match_jax(scenario):
    got, want = _batches(batching, scenario), _batches(jax_batching, scenario)
    assert got == want
    if scenario == "ordered":
        assert got == {key: list(range(6)) for key in (1, 2, 7)}


def _inflight(module, buckets, hash_fn, items):
    async def go():
        inflight = {"now": 0, "max": 0}

        async def proc(batch):
            inflight["now"] += 1
            inflight["max"] = max(inflight["max"], inflight["now"])
            await asyncio.sleep(0.02)
            inflight["now"] -= 1

        ex = module.OrderedAsyncBatchExecutor(1, proc, buckets=buckets, hash_fn=hash_fn)
        for item in items:
            await ex.add(item)
        await ex.close()
        return inflight["max"]

    return asyncio.run(go())


def test_ordered_executor_inflight_matches_jax():
    """One batch in flight per bucket; buckets overlap."""
    one_bucket = (1, lambda item: 0, range(5))
    spread = (4, lambda key: int(key.split("-")[1]), [f"key-{i}" for i in range(4)])
    assert _inflight(batching, *one_bucket) == _inflight(jax_batching, *one_bucket) == 1
    assert _inflight(batching, *spread) > 1 and _inflight(jax_batching, *spread) > 1
    with pytest.raises(ValueError, match="batch_size"):
        batching.BatchExecutor(0, None)
    with pytest.raises(ValueError, match="buckets"):
        batching.OrderedAsyncBatchExecutor(1, None, buckets=0)


# ---------------------------------------------------------------------- #
# text
# ---------------------------------------------------------------------- #
SPLITS = [
    dict(chunk_size=40, chunk_overlap=10),
    dict(chunk_size=120, chunk_overlap=0),
    dict(chunk_size=25, chunk_overlap=20, keep_separator=True),
    dict(chunk_size=60, chunk_overlap=15, separators=["\n", " "]),
    dict(chunk_size=30, chunk_overlap=5, separators=[". ", " ", ""]),
    dict(chunk_size=7, chunk_overlap=2, separators=["\n\n", ""]),
]


@pytest.mark.parametrize("length", ["length", "tokens"])
@pytest.mark.parametrize("case", range(len(SPLITS)))
def test_splitter_matches_jax(case, length):
    kwargs = dict(SPLITS[case])
    texts = _texts(case)
    got, want = both(lambda pkg: [pkg["text"].RecursiveCharacterTextSplitter(
        **kwargs, length_function=len if length == "length" else pkg["text"]._simple_token_length
    ).split_text(t) for t in texts])
    assert got == want
    assert sum(len(chunks) for chunks in got) > len(texts)  # texts do split


def test_text_splitter_agent_matches_jax():
    config = {"chunk_size": 30, "chunk_overlap": 8}
    values = _texts(11, count=4)
    want, got = run_agent("text-splitter", config, values)
    assert got == want
    assert all(len(out) > 1 for out in got)
    want, got = run_agent("text-splitter", dict(config, length_function="length"), values)
    assert got == want
    assert got[0][0][1][0] == ("chunk_id", "0")
    with pytest.raises(ValueError, match="only RecursiveCharacterTextSplitter"):
        asyncio.run(create_agent("text-splitter").init({"splitter_type": "TokenTextSplitter"}))


@pytest.mark.parametrize("config", [{}, {"make-lowercase": False}, {"trim-spaces": False}])
def test_text_normaliser_matches_jax(config):
    values = ["  Hello   World \n\t Again\tHERE  ", "ÄBC  def\n\n  GHI"] + _texts(3, count=2)
    want, got = run_agent("text-normaliser", config, values)
    assert got == want


def test_language_detector_matches_jax():
    values = ["the cat and the dog is in the house", "el perro y la casa de los niños",
              "der Hund und die Katze ist nicht", "le chat et les chiens dans la maison",
              "zzz qqq", ""] + _texts(5, count=3)
    assert [jax_text.detect_language(v) for v in values] == [text.detect_language(v)
                                                            for v in values]
    for config in ({}, {"property": "lang", "allowedLanguages": ["en", "de"]}):
        want, got = run_agent("language-detector", config, values)
        assert got == want
    assert sum(1 for out in got if out) < len(values)  # some filtered out


def test_text_extractor_matches_jax():
    values = [
        "<!DOCTYPE html><html><head><style>p {}</style><script>x()</script></head>"
        "<body><p>Hello &amp; welcome</p><div>to the <b>card</b></div></body></html>",
        "<html><body>café</body></html>",
        b"plain bytes \xc3\xa9",
        {"a": 1, "b": [1, 2]},
        "just text",
    ]
    want, got = run_agent("text-extractor", {}, values)
    assert got == want
    assert got[0][0][0] == "Hello & welcome\nto the\ncard"
    with pytest.raises(ValueError, match="PDF extraction is not supported"):
        run_agent("text-extractor", {}, [b"%PDF-1.4 ..."])


def test_document_to_json_still_matches_jax():
    want, got = run_agent("document-to-json", {"text-field": "question"}, ["what?", "why?"])
    assert got == want


# ---------------------------------------------------------------------- #
# re-rank and FLARE
# ---------------------------------------------------------------------- #
def _candidates(rng, count, dims=6):
    return [{"id": f"doc-{i}", "vector": rng.standard_normal(dims).round(3).tolist(), "n": i}
            for i in range(count)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mmr_rank_matches_jax(seed):
    rng = np.random.default_rng(seed)
    query = rng.standard_normal(6).tolist()
    candidates = _candidates(rng, 12)
    candidates[3] = dict(candidates[1], id="dup")  # a duplicate: redundancy 1
    candidates.append({"id": "no-vector"})
    for lam, top in ((0.5, 10), (0.2, 4), (1.0, 20)):
        got = rerank.mmr_rank(query, candidates, vector_field="vector", lambda_param=lam,
                              max_results=top)
        want = jax_rerank.mmr_rank(query, candidates, vector_field="vector", lambda_param=lam,
                                   max_results=top)
        assert [c["id"] for c in got] == [c["id"] for c in want]
        assert len(got) == min(top, 12)  # the one without a vector is left out


def test_rerank_agent_matches_jax():
    rng = np.random.default_rng(7)
    values = [{"qv": rng.standard_normal(6).tolist(), "candidates": _candidates(rng, 8)},
              {"candidates": _candidates(rng, 8)}]
    config = {"field": "value.candidates", "output-field": "value.ranked",
              "query-embeddings": "value.qv", "max": 3, "lambda": 0.3}
    want, got = run_agent("re-rank", config, values)
    assert got == want
    assert len(got[0][0][0]["ranked"]) == 3
    with pytest.raises(ValueError, match="unknown re-rank algorithm"):
        run_agent("re-rank", dict(config, algorithm="bm25"), values[:1])


@pytest.mark.parametrize("seed", range(4))
def test_low_confidence_spans_match_jax(seed):
    rng = np.random.default_rng(seed)
    tokens = [str(rng.choice(["a", "bc", " ", ".", "word", "", "x1"])) for _ in range(40)]
    logprobs = np.log(rng.uniform(0.01, 1.0, size=40)).tolist()
    for kwargs in ({}, {"min_prob": 0.5, "min_token_gap": 2, "num_pad_tokens": 0},
                   {"min_prob": 0.9, "min_token_gap": 10, "num_pad_tokens": 3}):
        assert flare.low_confidence_spans(tokens, logprobs, **kwargs) == \
            jax_flare.low_confidence_spans(tokens, logprobs, **kwargs)
    assert flare.low_confidence_spans(tokens, [0.0] * 40) == []


class _CapturingRuntime:
    """A topic runtime that keeps what the controller loops."""

    def __init__(self):
        self.written = []

    def create_producer(self, agent_id, config):
        runtime = self

        class Producer:
            async def start(self):
                pass

            async def close(self):
                pass

            async def write(self, record):
                runtime.written.append((config["topic"], record.value, tuple(record.headers)))

        return Producer()


def test_flare_controller_matches_jax():
    low = math.log(0.01)
    values = [{"tokens": ["a", "b"], "logprobs": [0.0, 0.0]},
              {"tokens": ["x", "y", "z", ".", "w"], "logprobs": [low, low, 0.0, low, low]},
              {"tokens": ["x"], "logprobs": [low], "flare_iterations": 3},
              {"tokens": ["x"], "logprobs": [low], "flare_iterations": 10}]
    for config in ({"loop-topic": "loop"}, {"loop-topic": "again", "max-iterations": 0},
                   {"loop-topic": "loop", "min-prob": 0.5, "num-pad-tokens": 0,
                    "num-iterations-field": "value.n", "retrieve-documents-field": "value.r"}):
        runtimes = (_CapturingRuntime(), _CapturingRuntime())
        outputs = []
        for pkg, runtime in zip((PKG["jax"], PKG["port"]), runtimes):
            async def go():
                agent = await make(pkg, "flare-controller", config, topic_connections=runtime)
                try:
                    return await process(agent, pkg, [pkg["record"](value=copy.deepcopy(v))
                                                      for v in values])
                finally:
                    await agent.close()
            outputs.append(asyncio.run(go()))
        assert outputs[1] == outputs[0]
        assert runtimes[1].written == runtimes[0].written
    # under its own iteration field every low-confidence record loops once
    assert [topic for topic, *_ in runtimes[1].written] == ["loop"] * 3
    assert all(value["n"] == 1 and value["r"] for _, value, _ in runtimes[1].written)


# ---------------------------------------------------------------------- #
# datasources
# ---------------------------------------------------------------------- #
def _rows(seed):
    rng = np.random.default_rng(seed)
    return [(i, str(rng.choice(WORDS)), float(rng.integers(0, 100))) for i in range(20)]


def _sqlite_session(module, path):
    async def go():
        source = module.SqliteDataSource({"url": f"sqlite:{path}"})
        out = [await source.execute("CREATE TABLE t (id INTEGER, name TEXT, score REAL)", [])]
        for row in _rows(5):
            out.append(await source.execute("INSERT INTO t VALUES (?, ?, ?)", list(row)))
        out.append(await source.execute("DELETE FROM t WHERE score < ?", [30.0]))
        out.append(await source.query("SELECT * FROM t WHERE name = ? ORDER BY id", ["kernel"]))
        out.append(await source.query("SELECT name, COUNT(*) AS n FROM t GROUP BY name "
                                      "ORDER BY name", []))
        await source.close()
        return out

    return asyncio.run(go())


def test_sqlite_datasource_matches_jax(tmp_path):
    got = _sqlite_session(datasource, tmp_path / "port.db")
    want = _sqlite_session(jax_datasource, tmp_path / "jax.db")
    assert got == want
    assert got[-2] and got[-1]
    memory = asyncio.run(datasource.DataSourceRegistry(
        {"db": {"configuration": {"service": "sqlite"}}}, device=CPU).resolve("db").query(
        "SELECT 1 AS one", []))
    assert memory == [{"one": 1}]


def test_memory_datasource_matches_jax():
    tables = {"users": [{"id": i, "name": name, "group": i % 3} for i, name, _ in _rows(2)]}

    def session(module):
        async def go():
            source = module.MemoryDataSource({"tables": tables})
            where = json.dumps({"table": "users", "where": {"group": "?"}, "limit": 4})
            out = [await source.query(where, [1]), await source.query(where.replace("4", "0"), [2])]
            out.append(await source.execute(
                json.dumps({"table": "users", "insert": {"id": 99, "name": "?", "group": 1}}),
                ["new"]))
            out.append(await source.execute(
                json.dumps({"table": "users", "delete-where": {"group": "?"}}), [0]))
            out.append(await source.query(json.dumps({"table": "users"}), []))
            out.append(await source.query(json.dumps({"table": "none"}), []))
            try:
                await source.execute(json.dumps({"table": "users", "update": {}}), [])
            except ValueError as error:
                out.append(str(error))
            return out
        return asyncio.run(go())

    assert session(datasource) == session(jax_datasource)


@pytest.mark.parametrize("service", datasource.NOT_PORTED_SERVICES)
def test_unported_datasource_services_are_refused_by_name(service):
    registry = datasource.DataSourceRegistry({"db": {"configuration": {"service": service}}},
                                             device=CPU)
    with pytest.raises(ValueError, match=f"'{service}' is not yet ported"):
        registry.resolve("db")


def test_datasource_registry_resolves_and_caches():
    registry = datasource.DataSourceRegistry({
        "db": {"configuration": {"service": "memory", "tables": {"t": [{"a": 1}]}}},
        "vdb": {"type": "datasource", "configuration": {
            "service": "vector", "name": f"units-{time.time_ns()}", "dimensions": 3}},
        "odd": {"configuration": {"service": "no-such"}}}, device=CPU)
    source = registry.resolve("db")
    assert registry.resolve("db") is source and isinstance(source, datasource.MemoryDataSource)
    vector = registry.resolve("vdb")
    assert isinstance(vector, vectorstore.VectorStoreDataSource)
    assert vector.store.device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown datasource 'nope'"):
        registry.resolve("nope")
    with pytest.raises(ValueError, match="unknown datasource service 'no-such'"):
        registry.resolve("odd")
    asyncio.run(registry.close())


# ---------------------------------------------------------------------- #
# GenAI steps and the vector agents
# ---------------------------------------------------------------------- #
class _Counted:
    """An embeddings service that records the size of every call."""

    def __init__(self, service):
        self.service = service
        self.calls = []

    async def compute_embeddings(self, texts):
        self.calls.append(len(texts))
        return await self.service.compute_embeddings(texts)


class _Registry:
    def __init__(self, service):
        self.service = service
        self.asked = []

    def embeddings(self, resource_name=None, model=None):
        self.asked.append((resource_name, model))
        return self.service


@pytest.fixture(scope="module")
def encoders():
    """The JAX service over its seed-0 tiny encoder and the port's over
    the same params carried across."""
    reference = JaxEmbeddingsService({"embeddings-model": {"preset": "tiny"}}, None)
    port = TorchEmbeddingsService({"embeddings-model": {"preset": "tiny"}}, device=CPU)
    port.embedder.params = encoder_params_from_jax(
        {k: np.asarray(v) for k, v in reference.embedder.params.items()}, CPU)
    return {"jax": reference, "port": port}


def test_compute_ai_embeddings_step_matches_jax(encoders):
    texts = [" ".join(words) for words in np.random.default_rng(4).choice(WORDS, size=(10, 5))]
    config = {"steps": [{"type": "compute-ai-embeddings", "text": "{{ value.text }}",
                         "embeddings-field": "value.vec", "batch-size": 4, "model": "m",
                         "ai-service": "llm"}]}
    runs = {}
    for name in ("jax", "port"):
        pkg, counted = PKG[name], _Counted(encoders[name])
        registry = _Registry(counted)

        async def go():
            agent = await make(pkg, "ai-tools", config, service_provider_registry=registry)
            try:
                return await process(agent, pkg, [pkg["record"](value={"text": t}) for t in texts])
            finally:
                await agent.close()

        runs[name] = (asyncio.run(go()), counted.calls, registry.asked)
    (got, got_calls, asked), (want, want_calls, _) = runs["port"], runs["jax"]
    assert asked == [("llm", "m")]
    assert got_calls == want_calls and sum(got_calls) == len(texts)
    assert max(got_calls) == 4 and len(got_calls) == math.ceil(len(texts) / 4)
    # records complete out of order in both packages: matched by text
    got = {g[0]["text"]: g[0]["vec"] for (g,) in got}
    want = {w[0]["text"]: w[0]["vec"] for (w,) in want}
    assert sorted(got) == sorted(want) == sorted(texts)
    for key in texts:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=EMBED_TOLERANCE)


def test_compute_ai_embeddings_step_routes_a_failure_to_every_record():
    class Broken:
        async def compute_embeddings(self, texts):
            return [[0.0]]  # one vector for a batch of several

    async def go():
        agent = await make(PKG["port"], "ai-tools", {"steps": [
            {"type": "compute-ai-embeddings", "batch-size": 3}]},
            service_provider_registry=_Registry(Broken()))
        results = await process_and_collect(agent, [Record(value={"a": i}) for i in range(3)])
        await agent.close()
        return results

    results = asyncio.run(go())
    assert all("returned 1 vectors for 3 texts" in str(r.error) for r in results)


def test_query_step_matches_jax(tmp_path):
    outs = []
    for name in ("jax", "port"):
        pkg = PKG[name]
        resources = {"db": {"type": "datasource", "configuration": {
            "service": "sqlite", "url": f"sqlite:{tmp_path / (name + '.db')}"}}}
        create = {"steps": [{"type": "query", "datasource": "db", "mode": "execute",
                             "query": "CREATE TABLE IF NOT EXISTS t (id INTEGER, name TEXT)",
                             "output-field": "value.created"},
                            {"type": "query", "datasource": "db", "mode": "execute",
                             "query": "INSERT INTO t VALUES (?, ?)",
                             "fields": ["value.id", "value.name"], "output-field": "value.done"}]}
        select = {"steps": [{"type": "query", "datasource": "db",
                             "query": "SELECT name FROM t WHERE id >= ? ORDER BY id",
                             "fields": ["value.id"], "output-field": "value.rows"},
                            {"type": "query", "datasource": "db", "only-first": True,
                             "query": "SELECT id, name FROM t WHERE id >= ? ORDER BY id",
                             "fields": ["value.id"], "output-field": "value.first"}]}

        async def go():
            writer = await make(pkg, "ai-tools", create, resources=resources)
            out = []
            for i, word in enumerate(["alpha", "beta", "gamma"]):
                out += await process(writer, pkg, [pkg["record"](value={"id": i, "name": word})])
            await writer.close()
            reader = await make(pkg, "ai-tools", select, resources=resources)
            out += await process(reader, pkg, [pkg["record"](value={"id": 1}),
                                               pkg["record"](value={"id": 9})])
            await reader.close()
            return out

        outs.append(asyncio.run(go()))
    assert outs[1] == outs[0]
    assert outs[1][3][0][0]["rows"] == [{"name": "beta"}, {"name": "gamma"}]
    assert outs[1][3][0][0]["first"] == {"id": 1, "name": "beta"}
    assert outs[1][4][0][0]["first"] == []


def test_vector_agents_match_jax():
    rng = np.random.default_rng(9)
    store = f"units-vectors-{time.time_ns()}"
    resources = {"vdb": {"type": "datasource", "configuration": {
        "service": "vector", "name": store, "dimensions": 5}}}
    docs = [{"doc_id": f"d{i}", "embeddings": rng.standard_normal(5).tolist(),
             "text": f"text {i}", "meta": {"k": i}} for i in range(12)]
    docs.append(dict(docs[2], embeddings=rng.standard_normal(5).tolist()))  # an update
    queries = [{"q": rng.standard_normal(5).tolist()} for _ in range(4)]
    sink_config = {"datasource": "vdb", "vector.id": "value.doc_id",
                   "vector.vector": "value.embeddings", "vector.metadata": "value.meta",
                   "vector.text": "value.text"}
    query_config = {"datasource": "vdb", "fields": ["value.q"], "output-field": "value.hits",
                    "query": json.dumps({"action": "search", "vector": "?", "top-k": 4})}
    outs = []
    for name in ("jax", "port"):
        pkg = PKG[name]

        async def go():
            sink = await make(pkg, "vector-db-sink", sink_config, resources=resources)
            for doc in docs:
                await sink.write(pkg["record"](value=copy.deepcopy(doc)))
            with pytest.raises(ValueError, match="no embeddings vector"):
                await sink.write(pkg["record"](value={"doc_id": "x"}))
            await sink.close()
            out = []
            for only_first in (False, True):
                agent = await make(pkg, "query-vector-db",
                                   dict(query_config, **{"only-first": only_first}),
                                   resources=resources)
                out.append(await process(agent, pkg, [pkg["record"](value=copy.deepcopy(q)) for q in queries]))
                await agent.close()
            return out, len(pkg["vectorstore"]._SHARED_STORES[store])

        outs.append(asyncio.run(go()))
    (got, got_len), (want, want_len) = outs[1], outs[0]
    assert got_len == want_len == 12
    assert vectorstore._SHARED_STORES[store].device == torch.device("cpu")
    for got_run, want_run in zip(got, want):
        for ((g, _),), ((w, _),) in zip(got_run, want_run):
            g_hits, w_hits = g["hits"], w["hits"]
            if isinstance(g_hits, dict):
                g_hits, w_hits = [g_hits], [w_hits]
            assert [(h["id"], h["text"], h["k"]) for h in g_hits] == [
                (h["id"], h["text"], h["k"]) for h in w_hits]
            np.testing.assert_allclose([h["similarity"] for h in g_hits],
                                       [h["similarity"] for h in w_hits], rtol=0,
                                       atol=SCORE_TOLERANCE)
    assert len(got[0][0][0][0]["hits"]) == 4 and isinstance(got[1][0][0][0]["hits"], dict)


# ---------------------------------------------------------------------- #
# registries
# ---------------------------------------------------------------------- #
def test_registry_embeddings_cached_per_resource_and_model():
    resources = {"llm": {"type": "torch-local", "configuration": {
        "embeddings-model": {"preset": "tiny"}}},
        "vdb": {"type": "datasource", "configuration": {"service": "vector"}}}
    registry = ServiceProviderRegistry(resources, device=CPU)
    first = registry.embeddings("llm")
    assert isinstance(first, TorchEmbeddingsService)
    assert registry.embeddings("llm") is first
    assert registry.embeddings(None) is first  # the one resource a provider owns
    other = registry.embeddings("llm", model="another")
    assert other is not first and registry.embeddings("llm", model="another") is other
    assert first.embedder.device == torch.device("cpu")
    closed = []
    for service in (first, other):
        service.close = lambda service=service: closed.append(service)
    asyncio.run(registry.close())
    assert closed == [first, other]
    assert registry.embeddings("llm") is not first  # built anew after close
    with pytest.raises(ValueError, match="unknown resource 'nope'"):
        registry.embeddings("nope")


def test_every_unported_agent_type_is_refused_by_name_and_the_new_ones_build():
    """Since Camel and Kafka Connect came, the port builds every built-in
    type of the JAX package's table (the table is the JAX package's own:
    plugins other tests load register their types in its registry); what
    is left unported is Camel's ``pulsar:`` scheme, refused by name
    (``tests/test_torch_camel_connect.py``)."""
    from langstream_tpu import agents as jax_agents

    port_types = set(agent_types())
    assert set(jax_agents._BUILTIN) <= set(jax_agent_types())
    assert sorted(set(jax_agents._BUILTIN) - port_types) == []
    for agent_type in ("camel-source", "kafka-connect-sink", "kafka-connect-source"):
        assert create_agent(agent_type).agent_type == agent_type
    for agent_type in NEW_TYPES:
        if agent_type in ("compute-ai-embeddings", "query"):
            agent = create_agent("ai-tools")
            asyncio.run(agent.init({"steps": [{"type": agent_type, "query": "q"}]}))
        else:
            assert agent_type in port_types
            assert create_agent(agent_type).agent_type == agent_type


# ---------------------------------------------------------------------- #
# apps run --http-port
# ---------------------------------------------------------------------- #
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as response:
            return response.status, response.read().decode()
    except urllib.error.HTTPError as error:
        return error.code, error.read().decode()


def _metric(body, name):
    found = re.search(rf"^{re.escape(name)} (\S+)$", body, re.M)
    return float(found.group(1)) if found else 0.0


def test_apps_run_http_port_serves_metrics_of_the_sink(tmp_path):
    documents = [" ".join(np.random.default_rng(seed).choice(WORDS, size=700)) + "."
                 for seed in range(2)]
    splitter = text.RecursiveCharacterTextSplitter(chunk_size=400, chunk_overlap=50,
                                                   length_function=text._simple_token_length)
    chunks = sum(len(splitter.split_text(doc)) for doc in documents)
    assert chunks > len(documents)
    env = dict(os.environ, PYTHONPATH=str(REPO), LANGSTREAM_PROFILE_DIR=str(tmp_path / "p"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "langstream_tpu_torch", "apps", "run", str(RAG_APP),
         "--instance", str(RAG_INSTANCE), "--device", "cpu", "--gateway-port", "0",
         "--http-port", "0"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(tmp_path), env=env)
    try:
        metrics_url = gateway = None
        while metrics_url is None or gateway is None:
            line = proc.stdout.readline()
            assert line, "apps run exited before it listened"
            found = re.match(r"metrics on (http://\S+)/metrics", line)
            metrics_url = found.group(1) if found else metrics_url
            found = re.match(r"gateway on ws://([^/]+)/v1/", line)
            gateway = found.group(1) if found else gateway
        assert _get(f"{metrics_url}/ready") == (200, "OK") and _get(f"{metrics_url}/ok")[0] == 200
        info = json.loads(_get(f"{metrics_url}/info")[1])
        assert info["application-id"] == "torch-rag"
        assert _get(f"{metrics_url}/nope")[0] == 404
        status, body = _get(f"{metrics_url}/debug/profile?seconds=abc")
        assert status == 400 and "number" in json.loads(body)["error"]
        for document in documents:
            request = urllib.request.Request(
                f"http://{gateway}/api/gateways/produce/default/torch-rag/ingest",
                data=json.dumps({"value": document}).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(request, timeout=30) as response:
                assert response.status == 200
        deadline = time.time() + 60
        written = 0.0
        while written < chunks and time.time() < deadline:
            time.sleep(0.2)
            body = _get(f"{metrics_url}/metrics")[1]
            written = _metric(body, "agent_split_document_records_out_total")
        assert written == chunks, body
        assert _metric(body, "agent_split_document_records_in_total") == len(documents)
    finally:
        proc.send_signal(signal.SIGTERM)
        stdout, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0 and "application stopped" in stdout


# ---------------------------------------------------------------------- #
# the device
# ---------------------------------------------------------------------- #
def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    from langstream_tpu_torch.runtime.local import run_application

    resources = {"vdb": {"configuration": {"service": "vector", "dimensions": 3}}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        datasource.DataSourceRegistry(resources)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vectorstore.VectorStoreDataSource(resources["vdb"]["configuration"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEmbeddingsService({})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServiceProviderRegistry({"llm": {"type": "torch-local"}}).embeddings("llm")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyncio.run(run_application(str(RAG_APP), instance_file=str(RAG_INSTANCE)))
    # through the agent context: an agent of an app on the card resolves
    # its datasources on the card
    agent = create_agent("query-vector-db")
    asyncio.run(agent.init({"datasource": "vdb", "query": "{}"}))
    asyncio.run(agent.set_context(AgentContext(resources=resources)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyncio.run(agent.start())
