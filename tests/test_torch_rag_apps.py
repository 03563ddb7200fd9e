"""The RAG variants on the port alone, end to end on the CPU: the JAX
package's ``rerank-rag``, ``flare`` and ``dp-embeddings`` examples,
rewritten into ``tmp_path`` with their resource's ``type: jax-local``
swapped for ``torch-local``, run by the port's runner.

- ``rerank-rag`` and ``flare`` have no ingest pipeline: their store
  (``rag-corpus``) is filled first with seeded chunks embedded by the
  port's encoder of the same preset, each chunk's vector (rounded to 3
  decimals) in its metadata as ``vector``, which ``re-rank`` reads. They
  run with ``examples/instances/local-rag-tiny.yaml`` but for
  ``max-seq-len``, raised from 512 to 2048 to hold the retrieved rows in
  the prompt. Gates: every question answered under its session; for
  ``rerank-rag`` a context of ``max`` 5 rows in the order ``mmr_rank``
  gives over the 20 retrieved; for ``flare`` each answer's tokens and
  logprobs, its record on ``answers`` (confident) or on its
  ``flare-loop`` topic (with the low-confidence spans), and its
  iteration count within ``max-iterations``.
- ``dp-embeddings`` with ``examples/instances/local-tiny.yaml``: 4
  replicas in one consumer group, 8 records in, 8 vectors of the
  encoder's width out.
"""

import asyncio
import pathlib
import shutil

import numpy as np
import pytest
import torch

from langstream_tpu_torch.agents import rerank, vectorstore
from langstream_tpu_torch.api.records import Record
from langstream_tpu_torch.providers.torch_local.provider import TorchEmbeddingsService
from langstream_tpu_torch.runtime.local import run_application

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
SESSION = "langstream-client-session-id"
WORDS = ["stream", "vector", "kernel", "topic", "agent", "card", "search", "token", "batch"]
QUESTIONS = [("s1", "what is a kernel?"), ("s2", "how does search work?"),
             ("s1", "and the card?")]
MAX_ITERATIONS = 10  # the flare-controller's default


def rewrite(name: str, target: pathlib.Path) -> str:
    shutil.copytree(EXAMPLES / "applications" / name, target)
    configuration = target / "configuration.yaml"
    text = configuration.read_text()
    assert text.count('type: "jax-local"') == 1
    configuration.write_text(text.replace('type: "jax-local"', 'type: "torch-local"'))
    return str(target)


def rag_instance(tmp_path: pathlib.Path) -> str:
    source = (EXAMPLES / "instances" / "local-rag-tiny.yaml").read_text()
    assert "    max-seq-len: 512\n" in source
    path = tmp_path / "local-rag-tiny.yaml"
    path.write_text(source.replace("    max-seq-len: 512\n", "    max-seq-len: 2048\n"))
    return str(path)


@pytest.fixture
def corpus():
    """``rag-corpus`` filled with 24 seeded chunks; the store is the
    process's, so it is emptied after the test."""
    rng = np.random.default_rng(5)
    texts = [" ".join(rng.choice(WORDS, size=6)) for _ in range(24)]
    encoder = TorchEmbeddingsService({"embeddings-model": {}}, device="cpu")
    vectors = asyncio.run(encoder.compute_embeddings(texts))
    vectorstore._SHARED_STORES.clear()
    store = vectorstore.shared_store("rag-corpus", len(vectors[0]), device="cpu")
    for i, (text, vector) in enumerate(zip(texts, vectors)):
        store.upsert(f"chunk-{i}", vector, {"text": text,
                                            "vector": np.round(vector, 3).tolist()})
    yield store
    vectorstore._SHARED_STORES.clear()


async def ask(runner, output_topics):
    """Each question under its session, the next after the answer: the
    answer records, read from any of ``output_topics``."""
    readers = [runner.reader(topic) for topic in output_topics]
    producer = runner.producer("questions")
    out = []
    for session, question in QUESTIONS:
        await producer.write(Record(value=question, headers=((SESSION, session),)))
        got = []
        deadline = asyncio.get_running_loop().time() + 120
        while not got and asyncio.get_running_loop().time() < deadline:
            for topic, reader in zip(output_topics, readers):
                got += [(topic, r) for r in await reader.read(timeout=0.1)]
        assert len(got) == 1, question
        out.append(got[0])
    return out


def test_rerank_rag_answers_with_the_mmr_context(tmp_path, corpus):
    app = rewrite("rerank-rag", tmp_path / "rerank-rag")

    async def go():
        runner = await run_application(app, instance_file=rag_instance(tmp_path), device="cpu")
        try:
            return await ask(runner, ["answers"])
        finally:
            await runner.stop()

    answers = asyncio.run(go())
    for (session, question), (_, record) in zip(QUESTIONS, answers):
        value = record.value
        assert record.header(SESSION) == session and value["question"] == question
        assert value["answer"]
        assert len(value["candidates"]) == 20
        want = rerank.mmr_rank(value["question_embeddings"], value["candidates"],
                               vector_field="vector", lambda_param=0.5, max_results=5)
        assert [row["id"] for row in value["context"]] == [row["id"] for row in want]
        assert len(value["context"]) == 5


def test_flare_answers_within_its_iterations(tmp_path, corpus):
    app = rewrite("flare", tmp_path / "flare")

    async def go():
        runner = await run_application(app, instance_file=rag_instance(tmp_path), device="cpu")
        try:
            return await ask(runner, ["answers", "flare-loop"])
        finally:
            await runner.stop()

    answers = asyncio.run(go())
    for (session, question), (topic, record) in zip(QUESTIONS, answers):
        value = record.value
        assert record.header(SESSION) == session and value["question"] == question
        assert value["answer"] and len(value["documents"]) == 4
        assert len(value["tokens"]) == len(value["logprobs"]) > 0
        iterations = value.get("flare_iterations", 0)
        assert 0 <= iterations <= MAX_ITERATIONS
        if topic == "flare-loop":
            assert iterations == 1 and value["documents_to_retrieve"]
        else:
            assert iterations == 0 and "documents_to_retrieve" not in value


def test_dp_embeddings_four_replicas(tmp_path):
    app = rewrite("dp-embeddings", tmp_path / "dp-embeddings")

    async def go():
        runner = await run_application(
            app, instance_file=str(EXAMPLES / "instances" / "local-tiny.yaml"), device="cpu")
        try:
            assert len(runner.runners) == 4  # one consumer group of four replicas
            producer = runner.producer("text-topic")
            for i in range(8):
                await producer.write(Record(value=f"text number {i}", key=f"k{i}"))
            reader = runner.reader("embeddings-topic")
            out = []
            deadline = asyncio.get_running_loop().time() + 60
            while len(out) < 8 and asyncio.get_running_loop().time() < deadline:
                out += await reader.read(timeout=0.2)
            return out
        finally:
            await runner.stop()

    out = asyncio.run(go())
    assert sorted(record.value["text"] for record in out) == sorted(
        f"text number {i}" for i in range(8))
    assert all(len(record.value["embeddings"]) == 32 for record in out)
