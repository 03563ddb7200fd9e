"""Top-K logprobs (OpenAI ``top_logprobs``) in the port, against the JAX
package, on the CPU (``tiny`` f32 weights).

- ``sampling.top_logprobs`` equals the JAX engine's ``_top_logprobs``:
  ids equal (ties ranked as ``lax.top_k`` ranks them: the lower id first,
  +0 above -0) and logprobs within 1e-6, on random and crafted-tie logits.
- The engine with ``logprobs_topk=3`` returns per token the JAX engine's
  top-K ids (equal) and logprobs (within 1e-5; 1e-4 over the int8 cache)
  on the dense, paged, mixed and speculative paths over the f32 and the
  int8 cache, greedy and seeded together; on greedy rows the sampled
  token ranks first with its own logprob.
- The port's server restates the JAX server's ``tests/test_openai_api.py``
  tests ``test_chat_top_logprobs``,
  ``test_top_logprobs_validation_and_legacy_format`` and
  ``test_legacy_int_logprobs_means_topk``, adds the streamed chat's
  ``logprobs.content``, and the provider trims the alternatives with the
  tokens when a stop string cuts them.
"""

import asyncio
import concurrent.futures
import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu_torch.cli.main import build_parser, serve_config, start_server
from langstream_tpu_torch.providers.torch_local import engine, model, sampling
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax

torch.set_num_threads(2)


# ---------------------------------------------------------------------- #
# _top_logprobs
# ---------------------------------------------------------------------- #
def _both_tops(logits: np.ndarray, k: int):
    jids, jlps = jax_engine._top_logprobs(jnp.asarray(logits), k)
    tids, tlps = sampling.top_logprobs(torch.from_numpy(logits), k)
    assert tids.dtype == torch.int32 and tlps.dtype == torch.float32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tlps.numpy(), np.asarray(jlps), rtol=1e-6, atol=1e-6)
    return tids.numpy(), tlps.numpy()


@pytest.mark.parametrize("k", [1, 3, 8])
def test_top_logprobs_equal_jax_on_random_logits(k):
    rng = np.random.default_rng(k)
    _both_tops((rng.standard_normal((2, 5, 301)) * 4).astype(np.float32), k)


@pytest.mark.parametrize("seed", range(4))
def test_top_logprobs_rank_ties_as_jax(seed):
    """Logits drawn from a handful of values, so ties run through the
    K-th place and past it, with signed zeros and infinities: the lower
    id ranks first among equal values, +0 above -0."""
    rng = np.random.default_rng(seed)
    logits = (rng.integers(-3, 4, size=(6, 64)) * 0.5).astype(np.float32)
    logits[0, :6] = [0.0, -0.0, np.inf, -np.inf, 0.0, -0.0]
    logits[1, ::2] = -0.0
    ids, _ = _both_tops(logits, 7)
    values = np.take_along_axis(logits, ids.astype(np.int64), axis=1)
    for row in range(len(logits)):
        for j in range(6):
            if values[row, j] == values[row, j + 1] and np.signbit(values[row, j]) == np.signbit(
                    values[row, j + 1]):
                assert ids[row, j] < ids[row, j + 1]


# ---------------------------------------------------------------------- #
# the engine
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def weights():
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=128)
    tcfg = model.LlamaConfig.tiny(max_seq_len=128)
    jparams = jax_model.init_params(jcfg, seed=0)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)
    return jcfg, jparams, tcfg, tparams


PATHS = {
    "dense": {},
    "paged": dict(kv_layout="paged", kv_block_size=8),
    "mixed": dict(kv_layout="paged", kv_block_size=8, prefill_mode="mixed", prefill_chunk=16),
    "spec": dict(spec_decode="ngram", spec_k=4, spec_ngram=2),
}
ARGS = dict(max_slots=4, max_seq_len=128, prefill_buckets=[32], decode_chunk=4, seed=7,
            logprobs_topk=3)
# two greedy requests (one repeating, for the drafter) beside a seeded
# sampled one
REQUESTS = [
    ((list(range(1, 9)) * 4)[:30], dict(max_new_tokens=12)),
    (list(range(40, 59)), dict(max_new_tokens=10)),
    (list(range(3, 27)), dict(max_new_tokens=10, temperature=0.8, top_p=0.9, seed=5)),
]


def _serve(eng, lib):
    """Every request submitted while the engine thread is stopped (both
    engines admit the same queue), then run to its end."""
    futures = []
    for prompt, kwargs in REQUESTS:
        future = concurrent.futures.Future()
        eng.submit(lib.GenerationRequest(prompt_tokens=list(prompt), sampling=lib.SamplingParams(**kwargs),
                                         future=future))
        futures.append(future)
    try:
        eng.start()
        return [future.result(timeout=300) for future in futures]
    finally:
        eng.stop()


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32-kv", "int8-kv"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_engine_top_logprobs_equal_jax(weights, path, kv_quant):
    jcfg, jparams, tcfg, tparams = weights
    args = dict(ARGS, kv_quant=kv_quant, **PATHS[path])
    reference = dict(paged_kernel="reference") if "kv_layout" in args else {}
    got = _serve(engine.DecodeEngine(tcfg, tparams, device="cpu", **args), engine)
    want = _serve(jax_engine.DecodeEngine(jcfg, jparams, **reference, **args), jax_engine)
    tolerance = 1e-4 if kv_quant else 1e-5
    for (_, kwargs), mine, theirs in zip(REQUESTS, got, want):
        assert mine.tokens == theirs.tokens and len(mine.tokens) == kwargs["max_new_tokens"]
        assert len(mine.top_logprobs) == len(mine.tokens) == len(theirs.top_logprobs)
        for token, logprob, (ids, lps), (jids, jlps) in zip(
                mine.tokens, mine.logprobs, mine.top_logprobs, theirs.top_logprobs):
            assert ids == list(jids) and len(ids) == 3
            np.testing.assert_allclose(lps, jlps, rtol=tolerance, atol=tolerance)
            assert lps == sorted(lps, reverse=True) and lps[0] <= 0
            if not kwargs.get("temperature"):
                assert ids[0] == token and lps[0] == pytest.approx(logprob, abs=1e-6)


def test_engine_without_top_k_keeps_none(weights):
    _, _, tcfg, tparams = weights
    eng = engine.DecodeEngine(tcfg, tparams, device="cpu", **dict(ARGS, logprobs_topk=0))
    assert "top_ids" not in eng._step_body(engine.Variant("decode", 1, "greedy"))(
        {name: torch.from_numpy(value) for name, value in
         eng._step_dummy(engine.Variant("decode", 1, "greedy")).items()})
    assert all(result.top_logprobs is None for result in _serve(eng, engine))


# ---------------------------------------------------------------------- #
# the server (JAX's tests/test_openai_api.py, restated)
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def server():
    args = build_parser().parse_args([
        "serve", "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
        "--max-slots", "2", "--max-seq-len", "256", "--logprobs-top-k", "3",
    ])
    assert serve_config(args)["engine"]["logprobs-top-k"] == 3
    service, api = start_server(args)
    assert service.top_logprobs_limit == 3
    yield f"http://127.0.0.1:{api.port}"
    api.stop()
    service.engine.stop()


def _post(url, body):
    request = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=120) as response:
            return response.status, response.read().decode()
    except urllib.error.HTTPError as error:
        return error.code, error.read().decode()


def _json(url, body):
    status, raw = _post(url, body)
    return status, json.loads(raw)


def test_chat_top_logprobs(server):
    """Chat ``content`` entries with up to N ranked alternatives per
    token (the engine keeps 3, the request asks for 2)."""
    status, body = _json(server + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hello"}], "max_tokens": 5, "temperature": 0.0,
        "logprobs": True, "top_logprobs": 2,
    })
    assert status == 200, body
    content = body["choices"][0]["logprobs"]["content"]
    assert len(content) == 5
    for entry in content:
        assert isinstance(entry["token"], str) and entry["logprob"] <= 0
        tops = entry["top_logprobs"]
        assert len(tops) == 2
        # rank 1 is the greedy-sampled token itself
        assert abs(tops[0]["logprob"] - entry["logprob"]) < 1e-4
        assert tops[0]["logprob"] >= tops[1]["logprob"]


def test_top_logprobs_validation_and_legacy_format(server):
    # over the server's static K -> 400 before generating
    status, body = _json(server + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}], "max_tokens": 2, "logprobs": True,
        "top_logprobs": 5,
    })
    assert status == 400 and "logprobs-top-k" in body["error"]["message"]
    for bad in ({"top_logprobs": "two", "logprobs": True}, {"top_logprobs": 2},
                {"top_logprobs": 21, "logprobs": True}):
        status, _ = _json(server + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "x"}], "max_tokens": 2, **bad})
        assert status == 400, bad
    # legacy /v1/completions: a {token: logprob} dict per position
    status, body = _json(server + "/v1/completions", {
        "prompt": "hi", "max_tokens": 3, "temperature": 0.0, "logprobs": True, "top_logprobs": 2,
    })
    assert status == 200, body
    lp = body["choices"][0]["logprobs"]
    assert "content" not in lp and len(lp["top_logprobs"]) == 3
    assert all(isinstance(d, dict) and len(d) <= 2 and all(isinstance(v, float) for v in d.values())
               for d in lp["top_logprobs"])


def test_legacy_int_logprobs_means_topk(server):
    """The legacy integer ``logprobs: K`` reaches the top-logprobs option,
    clamped to the server's limit; ``logprobs: true`` stays the sampled
    token's logprob alone."""
    status, body = _json(server + "/v1/completions", {
        "prompt": "hello", "max_tokens": 3, "temperature": 0.0, "logprobs": 2,
    })
    assert status == 200, body
    lp = body["choices"][0]["logprobs"]
    assert len(lp["top_logprobs"]) == 3
    assert all(isinstance(d, dict) and 0 < len(d) <= 2 for d in lp["top_logprobs"])
    status, body = _json(server + "/v1/completions", {"prompt": "hello", "max_tokens": 2, "logprobs": 9})
    assert status == 200, body
    assert all(isinstance(d, dict) and 0 < len(d) <= 3
               for d in body["choices"][0]["logprobs"]["top_logprobs"])
    status, body = _json(server + "/v1/completions", {"prompt": "hello", "max_tokens": 2, "logprobs": True})
    assert status == 200, body
    assert "top_logprobs" not in body["choices"][0]["logprobs"]


def test_streamed_chat_carries_top_logprobs(server):
    """A streamed chat with ``top_logprobs`` ends with a chunk holding
    every token's ``logprobs.content`` entry, the non-streamed answer's."""
    request = {"messages": [{"role": "user", "content": "stream me"}], "max_tokens": 6,
               "temperature": 0.0, "logprobs": True, "top_logprobs": 3}
    status, raw = _post(server + "/v1/chat/completions", dict(request, stream=True))
    assert status == 200
    frames = [line[len("data: "):] for line in raw.split("\n\n") if line.startswith("data: ")]
    assert frames[-1] == "[DONE]"
    final = json.loads(frames[-2])["choices"][0]
    content = final["logprobs"]["content"]
    assert len(content) == 6 and all(len(entry["top_logprobs"]) == 3 for entry in content)
    _, whole = _json(server + "/v1/chat/completions", request)
    assert content == whole["choices"][0]["logprobs"]["content"]


def test_provider_trims_alternatives_at_a_stop_string():
    """A stop string that cuts the answer trims the alternatives with the
    tokens and their logprobs."""
    from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService

    service = TorchCompletionsService({
        "model": {"preset": "tiny", "max_seq_len": 128},
        "engine": {"max-slots": 2, "decode-chunk": 4, "prefill-buckets": [32], "logprobs-top-k": 2},
    }, device="cpu")
    try:
        options = {"max-tokens": 16, "logprobs": True, "top-logprobs": 2}
        whole = asyncio.run(service.get_text_completions(["once upon"], options))
        assert len(whole.top_logprobs) == len(whole.tokens) == 16
        stop = whole.content[len(whole.content) // 2:][:2]
        assert stop
        cut = asyncio.run(service.get_text_completions(["once upon"], dict(options, stop=stop)))
        assert cut.finish_reason == "stop" and len(cut.tokens) < 16
        assert len(cut.top_logprobs) == len(cut.tokens) == len(cut.logprobs)
        assert cut.top_logprobs == whole.top_logprobs[: len(cut.tokens)]
        plain = asyncio.run(service.get_text_completions(["once upon"], {"max-tokens": 4, "logprobs": True}))
        assert plain.top_logprobs is None and len(plain.logprobs) == 4
    finally:
        service.engine.stop()
