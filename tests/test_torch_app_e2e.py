"""The completions app end to end: the port's ``torch-completions`` against
the JAX package's ``jax-completions``, on one checkpoint, on the CPU.

One safetensors checkpoint is written from the JAX tiny preset's
parameters (``chip_smoke.write_hf_checkpoint`` of their port layout, in
bf16, the dtype both providers load such a checkpoint in). A copy of
each app in ``tmp_path`` names it as its resource's ``checkpoint``
(greedy sampling, the apps' own). Each package runs its app once per
module and answers the same three questions in two sessions, each
question after the one before is answered. Gates:

- the ``history-topic`` records equal (``answer``, ``prompt``, the
  copied question and session header);
- the ``output-topic`` chunks equal in text, ``stream-index``,
  ``stream-last-message`` and the session header, and each answer's
  chunks concatenate to its ``history-topic`` answer;
- the same with ``kv-quant: int8`` in both engines;
- a seeded case: the chat-completions step samples with ``temperature``
  0.9 and ``seed`` 11 and asks for ``logprobs``. In bf16 the two
  packages' logits differ by about 1e-2, and a sample from the tiny
  random model's flat distribution can part at such a near-tie, so the
  seeded case serves the same f32 weights instead, each package from its
  own ``training.checkpoint.save_model`` directory: there the logits
  agree to about 1e-6, and the records must be equal, the logprobs to
  1e-4, but for C3's last-place ties (none shows on these inputs).
"""

import asyncio
import dataclasses
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from langstream_tpu.api.records import Record as JaxRecord
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.runtime.local import run_application as jax_run_application
from langstream_tpu_torch.api.records import Record
from langstream_tpu_torch.providers.torch_local import model
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax
from langstream_tpu_torch.runtime.local import run_application

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_APP = REPO / "examples" / "applications" / "jax-completions"
PORT_APP = REPO / "langstream_tpu_torch" / "examples" / "applications" / "torch-completions"
INSTANCE = REPO / "examples" / "instances" / "local-tiny.yaml"
QUESTIONS = [("session-a", "what is a GPU?"), ("session-b", "name a prime number"),
             ("session-a", "and what is a TPU?")]
SESSION = "langstream-client-session-id"


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("tiny-checkpoint")
    jparams = jax_model.init_params(jax_model.LlamaConfig.tiny(), seed=3)
    config = model.LlamaConfig.tiny()
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, config)
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    chip_smoke.write_hf_checkpoint(str(path), dataclasses.replace(config, dtype=torch.bfloat16),
                                   params)
    return str(path)


def copy_app(source: pathlib.Path, target: pathlib.Path, checkpoint: str,
             seeded: bool = False) -> str:
    """The app with ``checkpoint`` in its resource; ``seeded`` adds
    ``temperature``, ``seed`` and ``logprobs`` to its step."""
    shutil.copytree(source, target)
    configuration = target / "configuration.yaml"
    text = configuration.read_text()
    assert text.count("        model:\n") == 1
    configuration.write_text(text.replace(
        "        model:\n", f"        checkpoint: {json.dumps(checkpoint)}\n        model:\n"))
    if seeded:
        pipeline = target / "pipeline.yaml"
        text = pipeline.read_text()
        assert text.count("      min-chunks-per-message: 10\n") == 1
        pipeline.write_text(text.replace(
            "      min-chunks-per-message: 10\n",
            "      min-chunks-per-message: 10\n      temperature: 0.9\n      seed: 11\n"
            "      logprobs: true\n"))
    return str(target)


async def ask_all(runner, record_type) -> dict:
    """Every question, one at a time: the answers and every chunk."""
    history = runner.reader("history-topic")
    await history.start()
    producer = runner.producer("input-topic")
    answers = []
    for session, question in QUESTIONS:
        await producer.write(record_type(value=question, headers=((SESSION, session),)))
        got = []
        deadline = asyncio.get_running_loop().time() + 120
        while not got and asyncio.get_running_loop().time() < deadline:
            got.extend(await history.read(timeout=0.2))
        assert len(got) == 1, question
        answers.append(got[0].value)
    chunks = await runner.reader("output-topic").read(max_records=1000, timeout=0.2)
    return {
        "history": answers,
        "chunks": [(c.value, c.header("stream-index"), c.header("stream-last-message"),
                    c.header(SESSION), c.header("stream-id")) for c in chunks],
    }


def run_both(base: pathlib.Path, checkpoints, instance: str, seeded: bool = False) -> dict:
    """Each package's app over its checkpoint (``checkpoints``: the JAX
    one's, then the port's), started once."""
    jax_dir = copy_app(JAX_APP, base / "jax-completions", checkpoints[0], seeded)
    port_dir = copy_app(PORT_APP, base / "torch-completions", checkpoints[1], seeded)

    async def port():
        runner = await run_application(port_dir, instance_file=instance, device="cpu")
        try:
            return await ask_all(runner, Record)
        finally:
            await runner.stop()

    async def jax():
        runner = await jax_run_application(jax_dir, instance_file=instance)
        try:
            return await ask_all(runner, JaxRecord)
        finally:
            await runner.stop()

    return {"port": asyncio.run(port()), "jax": asyncio.run(jax())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, checkpoint):
    return run_both(tmp_path_factory.mktemp("greedy"), (checkpoint, checkpoint), str(INSTANCE))


@pytest.fixture(scope="module")
def int8_runs(tmp_path_factory, checkpoint):
    base = tmp_path_factory.mktemp("int8")
    instance = base / "local-tiny-int8.yaml"
    instance.write_text(INSTANCE.read_text() + "    kv-quant: int8\n")
    return run_both(base, (checkpoint, checkpoint), str(instance))


@pytest.fixture(scope="module")
def seeded_runs(tmp_path_factory):
    """f32 weights: the JAX tiny preset's, saved by each package's
    ``save_model``."""
    from langstream_tpu.training.checkpoint import save_model as jax_save_model
    from langstream_tpu_torch.training.checkpoint import save_model

    base = tmp_path_factory.mktemp("seeded")
    jconfig = jax_model.LlamaConfig.tiny()
    jparams = jax_model.init_params(jconfig, seed=3)
    jax_save_model(str(base / "jax-weights"), jconfig, jparams)
    config = model.LlamaConfig.tiny()
    save_model(str(base / "port-weights"), config,
               params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, config))
    return run_both(base, (str(base / "jax-weights"), str(base / "port-weights")),
                    str(INSTANCE), seeded=True)


def chunk_fields(chunks):
    """Text, index, last flag and session of each chunk (``stream-id`` is
    a fresh uuid per answer in both packages)."""
    return [chunk[:4] for chunk in chunks]


def assert_answers_stream(run):
    """Each answer's chunks, grouped by ``stream-id``, end with
    ``stream-last-message: true`` and concatenate to its answer."""
    by_stream = {}
    for text, index, last, session, stream in run["chunks"]:
        by_stream.setdefault(stream, []).append((int(index), text, last, session))
    assert len(by_stream) == len(QUESTIONS)
    for (session, question), answer, parts in zip(QUESTIONS, run["history"], by_stream.values()):
        assert [index for index, *_ in parts] == list(range(len(parts)))
        assert [last for *_, last, _ in parts] == ["false"] * (len(parts) - 1) + ["true"]
        assert {s for *_, s in parts} == {session}
        assert "".join(text for _, text, _, _ in parts) == answer["answer"]
        assert answer["question"] == question and answer[SESSION] == session
        assert question in json.loads(answer["prompt"])["messages"][0]["content"]


def without_logprobs(history):
    return [{k: v for k, v in answer.items() if k != "logprobs"} for answer in history]


@pytest.mark.parametrize("case", ["greedy", "int8 KV", "seeded"])
def test_history_and_chunks_equal_jax(request, case):
    fixture = {"greedy": "runs", "int8 KV": "int8_runs", "seeded": "seeded_runs"}[case]
    got, want = (request.getfixturevalue(fixture)[package] for package in ("port", "jax"))
    assert without_logprobs(got["history"]) == without_logprobs(want["history"])
    assert chunk_fields(got["chunks"]) == chunk_fields(want["chunks"])
    assert all(answer["answer"] for answer in got["history"])
    assert_answers_stream(got)
    assert_answers_stream(want)


def test_seeded_answers_carry_equal_tokens_and_logprobs(seeded_runs):
    port, jax = seeded_runs["port"]["history"], seeded_runs["jax"]["history"]
    for got, want in zip(port, jax):
        assert got["tokens"] == want["tokens"] and len(got["tokens"]) == 16
        np.testing.assert_allclose(got["logprobs"], want["logprobs"], rtol=1e-4, atol=1e-4)
    assert json.loads(port[0]["prompt"])["options"]["seed"] == 11
