"""The RAG app end to end: the port's ``torch-rag`` against the JAX
package's ``rag-pipeline``, on the same LLM and encoder weights, on the
CPU.

- One LLM checkpoint is written from the JAX tiny preset's parameters
  (bf16, as ``tests/test_torch_app_e2e.py`` writes it) and one encoder as
  a HF BERT directory (``config.json``, safetensors, a WordPiece
  ``vocab.txt`` of letters and punctuation) from the JAX tiny encoder's
  parameters. A copy of each app in ``tmp_path`` names both as its
  resource's ``checkpoint`` and ``embeddings-model: {checkpoint: ...}``.
- Both run with ``examples/instances/local-rag-tiny.yaml`` but for
  ``max-seq-len``, raised from 512 to 4096: four retrieved chunks of up
  to 400 estimated tokens do not fit 512 byte tokens in either package.
- Traffic: three seeded documents ingested one after another (each
  splits into several chunks), then three questions in two sessions,
  each after the one before is answered.
- Gates: the stored chunks' texts equal, in order; their vectors within
  1e-5; each answer's ``context`` the same texts in the same order, its
  ``similarity`` within 1e-5; the greedy answers equal.

The answer's prompt renders the context with ``fn:toJson``: each row's
``id`` (a ``fn:uuid()`` of the ingest pipeline) and ``similarity`` (f32
of two frameworks, equal to about 1e-7). For the prompts to be equal,
and so the greedy answers comparable, the test makes ``fn:uuid()``
count from a seed in both packages and ``fn:toJson`` round floats to 4
decimals in both; the contexts are compared unrounded.
"""

import asyncio
import copy
import dataclasses
import json
import pathlib
import re
import shutil
import uuid

import numpy as np
import pytest
import torch

import chip_smoke
from langstream_tpu.agents import el as jax_el
from langstream_tpu.agents import vectorstore as jax_vectorstore
from langstream_tpu.api.records import Record as JaxRecord
from langstream_tpu.providers.jax_local import embeddings as jax_embeddings
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.runtime.local import run_application as jax_run_application
from langstream_tpu_torch.agents import el, text, vectorstore
from langstream_tpu_torch.api.records import Record
from langstream_tpu_torch.providers.torch_local import embeddings, model
from langstream_tpu_torch.providers.torch_local.convert import (
    encoder_params_from_jax,
    params_from_jax,
)
from langstream_tpu_torch.providers.torch_local.weights import write_safetensors
from langstream_tpu_torch.runtime.local import run_application

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_APP = REPO / "examples" / "applications" / "rag-pipeline"
PORT_APP = REPO / "langstream_tpu_torch" / "examples" / "applications" / "torch-rag"
INSTANCE = REPO / "examples" / "instances" / "local-rag-tiny.yaml"
MAX_SEQ_LEN = 4096
TOLERANCE = 1e-5
SESSION = "langstream-client-session-id"
# short words and punctuation: about 1.5 characters an estimated token,
# so four chunks of 400 estimated tokens make a prompt under 4096 bytes
DOC_WORDS = ["a", "b", "io", "ok", "x", "yz", "de", "f", "gh", "k"]
QUESTIONS = [("session-a", "what is io ok?"), ("session-b", "where is yz de?"),
             ("session-a", "and gh k?")]


def _documents():
    rng = np.random.default_rng(23)
    docs = []
    for _ in range(3):
        paragraphs = []
        for _ in range(int(rng.integers(6, 9))):
            words = rng.choice(DOC_WORDS, size=int(rng.integers(50, 90)))
            marks = rng.choice([",", ".", ""], size=len(words))
            paragraphs.append(" ".join(w + m for w, m in zip(words, marks)))
        docs.append("\n\n".join(paragraphs))
    return docs


DOCUMENTS = _documents()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The LLM checkpoint and the encoder's BERT directory."""
    root = tmp_path_factory.mktemp("rag-weights")
    jparams = jax_model.init_params(jax_model.LlamaConfig.tiny(), seed=3)
    config = model.LlamaConfig.tiny(max_seq_len=MAX_SEQ_LEN)
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, config)
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    chip_smoke.write_hf_checkpoint(str(root / "llm"), dataclasses.replace(
        config, dtype=torch.bfloat16), params)
    transformers = pytest.importorskip("transformers")
    encoder = embeddings.EncoderConfig.tiny()
    jencoder = jax_embeddings.init_encoder_params(jax_embeddings.EncoderConfig.tiny())
    eparams = encoder_params_from_jax({k: np.asarray(v) for k, v in jencoder.items()}, "cpu")
    bert = root / "bert"
    bert.mkdir()
    (bert / "config.json").write_text(json.dumps({
        "architectures": ["BertModel"], "model_type": "bert", "vocab_size": encoder.vocab_size,
        "hidden_size": encoder.hidden_size, "intermediate_size": encoder.intermediate_size,
        "num_hidden_layers": encoder.num_layers, "num_attention_heads": encoder.num_heads,
        "max_position_embeddings": encoder.max_positions, "layer_norm_eps": encoder.norm_eps,
        "hidden_act": "gelu", "type_vocab_size": 2, "torch_dtype": "float32"}))
    write_safetensors(str(bert / "model.safetensors"), chip_smoke.bert_tensors(
        encoder, eparams, torch.zeros(2, encoder.hidden_size)))
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ",", ".", "?"] + letters
             + ["##" + c for c in letters])
    assert len(vocab) <= encoder.vocab_size
    (bert / "vocab.txt").write_text("\n".join(vocab) + "\n")
    transformers.BertTokenizer(str(bert / "vocab.txt")).save_pretrained(str(bert))
    return {"llm": str(root / "llm"), "bert": str(bert)}


def copy_app(source: pathlib.Path, target: pathlib.Path, weights) -> str:
    """The app with both checkpoints in its resource."""
    shutil.copytree(source, target)
    configuration = target / "configuration.yaml"
    text_ = configuration.read_text()
    encoder = f"        embeddings-model: {{checkpoint: {json.dumps(weights['bert'])}}}\n"
    text_, count = re.subn(r"        embeddings-model:( \{\})?\n(          .*\n)*", encoder, text_)
    assert count == 1
    assert text_.count("        model:\n") == 1
    text_ = text_.replace("        model:\n",
                          f"        checkpoint: {json.dumps(weights['llm'])}\n        model:\n")
    configuration.write_text(text_)
    return str(target)


class _Rendering:
    """``fn:uuid()`` counting from a seed and ``fn:toJson`` rounding
    floats to 4 decimals, in one package's EL."""

    def __init__(self, module, monkeypatch):
        self.count = 0
        render = module.Functions.toJson

        def uuid_() -> str:
            self.count += 1
            return uuid.UUID(int=self.count).hex

        def to_json(value):
            return render(_rounded(value))

        monkeypatch.setattr(module.Functions, "uuid", staticmethod(uuid_))
        monkeypatch.setattr(module.Functions, "toJson", staticmethod(to_json))


def _rounded(value):
    if isinstance(value, float):
        return round(value, 4)
    if isinstance(value, dict):
        return {k: _rounded(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_rounded(v) for v in value]
    return value


async def _drive(runner, record_type, stores) -> dict:
    """Ingest each document and wait for its chunks, then ask each
    question and wait for its answer."""
    splitter = text.RecursiveCharacterTextSplitter(
        chunk_size=400, chunk_overlap=50, length_function=text._simple_token_length)
    loop = asyncio.get_running_loop()
    docs = runner.producer("docs-topic")
    await docs.start()
    expected = 0
    for document in DOCUMENTS:
        await docs.write(record_type(value=document))
        expected += len(splitter.split_text(document))
        deadline = loop.time() + 120
        while loop.time() < deadline:
            store = stores.get("rag-corpus")
            if store is not None and len(store) == expected:
                break
            await asyncio.sleep(0.05)
        assert len(stores["rag-corpus"]) == expected
    store = stores["rag-corpus"]
    chunks = [store._meta[doc_id]["text"] for doc_id in store._ids]
    vectors = np.array(store._matrix[: len(store)])
    answers_reader = runner.reader("answers-topic")
    questions = runner.producer("questions-topic")
    await questions.start()
    answers = []
    for session, question in QUESTIONS:
        await questions.write(record_type(value=question, headers=((SESSION, session),)))
        got = []
        deadline = loop.time() + 120
        while not got and loop.time() < deadline:
            got.extend(await answers_reader.read(timeout=0.2))
        assert len(got) == 1, question
        answers.append((copy.deepcopy(got[0].value), got[0].header(SESSION)))
    return {"chunks": chunks, "vectors": vectors, "answers": answers}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, weights):
    base = tmp_path_factory.mktemp("rag")
    instance = base / "local-rag-tiny.yaml"
    source = INSTANCE.read_text()
    assert "    max-seq-len: 512\n" in source
    instance.write_text(source.replace("    max-seq-len: 512\n",
                                       f"    max-seq-len: {MAX_SEQ_LEN}\n"))
    jax_dir = copy_app(JAX_APP, base / "rag-pipeline", weights)
    port_dir = copy_app(PORT_APP, base / "torch-rag", weights)
    monkeypatch = pytest.MonkeyPatch()
    out = {}
    try:
        _Rendering(jax_el, monkeypatch)
        _Rendering(el, monkeypatch)
        vectorstore._SHARED_STORES.clear()
        jax_vectorstore._SHARED_STORES.clear()

        async def port():
            runner = await run_application(port_dir, instance_file=str(instance), device="cpu")
            try:
                return await _drive(runner, Record, vectorstore._SHARED_STORES)
            finally:
                await runner.stop()

        async def jax():
            runner = await jax_run_application(jax_dir, instance_file=str(instance))
            try:
                return await _drive(runner, JaxRecord, jax_vectorstore._SHARED_STORES)
            finally:
                await runner.stop()

        out["port"] = asyncio.run(port())
        out["jax"] = asyncio.run(jax())
    finally:
        monkeypatch.undo()
        vectorstore._SHARED_STORES.clear()
        jax_vectorstore._SHARED_STORES.clear()
    return out


def test_stored_chunks_equal_jax_in_order(runs):
    got, want = runs["port"], runs["jax"]
    assert got["chunks"] == want["chunks"]
    assert len(got["chunks"]) >= 2 * len(DOCUMENTS)  # each document splits
    assert all(0 < text._simple_token_length(chunk) <= 400 for chunk in got["chunks"])


def test_stored_vectors_match_jax(runs):
    got, want = runs["port"], runs["jax"]
    assert got["vectors"].shape == want["vectors"].shape == (len(got["chunks"]), 32)
    assert got["vectors"].dtype == np.float32
    np.testing.assert_allclose(got["vectors"], want["vectors"], rtol=0, atol=TOLERANCE)


def test_contexts_match_jax(runs):
    for (got, got_session), (want, want_session) in zip(runs["port"]["answers"],
                                                        runs["jax"]["answers"]):
        assert got_session == want_session
        assert got["question"] == want["question"]
        assert [row["text"] for row in got["context"]] == [row["text"] for row in want["context"]]
        assert len(got["context"]) == 4
        np.testing.assert_allclose([row["similarity"] for row in got["context"]],
                                   [row["similarity"] for row in want["context"]],
                                   rtol=0, atol=TOLERANCE)
        np.testing.assert_allclose(got["question_embeddings"], want["question_embeddings"],
                                   rtol=0, atol=TOLERANCE)


def test_greedy_answers_equal_jax(runs):
    got = [answer["answer"] for answer, _ in runs["port"]["answers"]]
    want = [answer["answer"] for answer, _ in runs["jax"]["answers"]]
    assert got == want
    assert all(got)
