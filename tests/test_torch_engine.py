"""The port's engine against the JAX ``DecodeEngine``, on the CPU, plus
the sampling noise against ``jax.random``.

Both engines serve ``tiny`` with the same carried-across weights,
``decode_chunk=4``, ``max_slots=4`` and ``prefix_cache=False`` on the JAX
side (the port's dense layout has no cross-slot prefix copy yet). Six concurrent requests of
different lengths — greedy with a repetition penalty, a stop token
landing mid-chunk, seeded
temperature / top-k / top-p with penalties and logit bias, and one
auto-seeded request — must produce the same token streams. The same
holds over the int8 KV cache (``kv_quant="int8"``) on both sides.
"""

import asyncio
import concurrent.futures
import threading

import jax
import numpy as np
import pytest
import torch

from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu_torch.providers.torch_local import engine, model, prng, sampling
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax

torch.set_num_threads(2)

ENGINE_ARGS = dict(max_slots=4, max_seq_len=128, prefill_buckets=[32], decode_chunk=4, seed=0)


@pytest.mark.parametrize("seed,position", [(0, 0), (1, 7), (12345, 100), (2**32 - 1, 3), (42, 65535)])
def test_sampling_keys_and_categorical_match_jax_random(seed, position):
    jkey = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), np.int32(position))
    key = prng.sampling_keys(torch.tensor([seed]), torch.tensor([position], dtype=torch.int32))
    assert [int(key[0][0]), int(key[1][0])] == np.asarray(jkey).tolist()
    rng = np.random.default_rng(seed % 1000)
    logits = rng.standard_normal((1, 3000), dtype=np.float32)
    ref = jax.random.categorical(jkey, logits[0])
    assert int(prng.categorical(key, torch.from_numpy(logits))[0]) == int(ref)
    # the noise itself: both take -log(-log(u)) of the same uniforms; the
    # two log implementations may differ in the last place
    noise = prng.gumbel(key, 3000)[0].numpy()
    np.testing.assert_allclose(noise, np.asarray(jax.random.gumbel(jkey, (3000,))), rtol=1e-6, atol=1e-6)


def test_truncation_mask_matches_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((4, 300), dtype=np.float32)
    top_k = np.array([0, 5, 0, 40], dtype=np.int32)
    top_p = np.array([0.0, 0.0, 0.7, 0.9], dtype=np.float32)
    ref = jax_engine._truncation_mask(logits, top_k, top_p)
    out = sampling.truncation_mask(torch.from_numpy(logits), torch.from_numpy(top_k), torch.from_numpy(top_p))
    np.testing.assert_array_equal(np.isinf(out.numpy()), np.isinf(np.asarray(ref)))


def _generate(eng, requests):
    async def main():
        return await asyncio.gather(*[
            eng.generate(prompt, params, stop_tokens=stops)
            for prompt, params, stops in requests
        ])

    return asyncio.run(main())


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=128)
    tcfg = model.LlamaConfig.tiny(max_seq_len=128)
    jparams = jax_model.init_params(jcfg, seed=5)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)
    ported = engine.DecodeEngine(tcfg, tparams, device="cpu", **ENGINE_ARGS)
    reference = jax_engine.DecodeEngine(jcfg, jparams, prefix_cache=False, **ENGINE_ARGS)
    yield ported, reference
    ported.stop()
    reference.stop()


def _stop_request(ported, rng):
    """A greedy request plus a stop token whose first occurrence lands
    strictly inside a decode chunk (found with the port alone)."""
    for _ in range(20):
        prompt = rng.integers(0, 256, size=int(rng.integers(8, 30))).tolist()
        # an explicit seed: the probe must not advance the auto-seed sequence
        probe = engine.SamplingParams(max_new_tokens=16, seed=0)
        (free,) = _generate(ported, [(prompt, probe, set())])
        for position in range(1, len(free.tokens)):
            token = free.tokens[position]
            # token 0 comes from prefill; chunks then emit 1-4, 5-8, ...
            if free.tokens.index(token) == position and position % 4 != 0:
                return prompt, token, position
    raise AssertionError("no mid-chunk stop token found")


def test_token_streams_match_jax_engine(engines):
    ported, reference = engines
    rng = np.random.default_rng(11)
    stop_prompt, stop_token, stop_at = _stop_request(ported, rng)

    def prompt(n):
        return rng.integers(0, 256, size=n).tolist()

    S = engine.SamplingParams
    requests = [
        (prompt(5), S(frequency_penalty=1.5, max_new_tokens=12), set()),
        (stop_prompt, S(max_new_tokens=16), {stop_token}),
        (prompt(17), S(temperature=0.8, seed=11, max_new_tokens=10), set()),
        (prompt(30), S(temperature=1.0, top_k=20, seed=5, max_new_tokens=14), set()),
        (prompt(9), S(temperature=0.9, top_p=0.8, seed=3, presence_penalty=0.5,
                      frequency_penalty=0.3, max_new_tokens=9), set()),
        (prompt(23), S(temperature=0.7, logit_bias={7: 5.0}, max_new_tokens=11), set()),
    ]
    jax_requests = [
        (p, jax_engine.SamplingParams(**s.__dict__), stops) for p, s, stops in requests
    ]
    got = _generate(ported, requests)
    want = _generate(reference, jax_requests)
    for index, (mine, theirs) in enumerate(zip(got, want)):
        assert mine.tokens == theirs.tokens, index
        assert mine.finish_reason == theirs.finish_reason
        assert mine.prompt_tokens == theirs.prompt_tokens
        np.testing.assert_allclose(mine.logprobs, theirs.logprobs, rtol=1e-4, atol=1e-4)
    assert got[1].finish_reason == "stop" and len(got[1].tokens) == stop_at
    assert [len(r.tokens) for r in got[2:]] == [10, 14, 9, 11]


def test_engine_streams_and_cancels(engines):
    ported, reference = engines
    seen = []
    handle = []

    async def main():
        streamed = await ported.generate(
            [1, 2, 3], engine.SamplingParams(max_new_tokens=6),
            on_token=lambda token, last: seen.append((token, last)),
        )
        cancelled = asyncio.ensure_future(ported.generate(
            [4, 5, 6], engine.SamplingParams(max_new_tokens=100), handle=handle,
        ))
        while not handle:
            await asyncio.sleep(0.001)
        handle[0].cancel()
        return streamed, await cancelled

    streamed, cancelled = asyncio.run(main())
    assert [t for t, _ in seen] == streamed.tokens and seen[-1][1] is True
    assert cancelled.finish_reason == "cancelled" and len(cancelled.tokens) < 100
    # a prompt past the largest bucket (32) is prefilled in windows and
    # answered as the JAX engine answers it; max_seq_len tokens are refused
    long_prompt = [(7 * i) % 250 + 1 for i in range(40)]
    (mine,) = _generate(ported, [(long_prompt, engine.SamplingParams(max_new_tokens=6), set())])
    (theirs,) = _generate(reference, [(long_prompt, jax_engine.SamplingParams(max_new_tokens=6), set())])
    assert mine.tokens == theirs.tokens and len(mine.tokens) == 6
    np.testing.assert_allclose(mine.logprobs, theirs.logprobs, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="context limit"):
        ported.submit(engine.GenerationRequest(prompt_tokens=[1] * 128, sampling=engine.SamplingParams()))


def test_submit_from_plain_threads(engines):
    """``submit`` from threads without an event loop, each waiting on a
    concurrent future, as the HTTP handler threads may."""
    ported, _ = engines
    results = {}

    def worker(i):
        future = concurrent.futures.Future()
        ported.submit(engine.GenerationRequest(
            prompt_tokens=[i + 1, i + 2], sampling=engine.SamplingParams(max_new_tokens=3 + i),
            future=future,
        ))
        results[i] = future.result(timeout=60)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=60)
    assert not any(thread.is_alive() for thread in threads)
    assert {i: len(r.tokens) for i, r in results.items()} == {i: 3 + i for i in range(6)}


# ---------------------------------------------------------------------- #
# the int8 KV cache
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def int8_engines():
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=128)
    tcfg = model.LlamaConfig.tiny(max_seq_len=128)
    jparams = jax_model.init_params(jcfg, seed=5)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)
    ported = engine.DecodeEngine(tcfg, tparams, device="cpu", kv_quant="int8", **ENGINE_ARGS)
    reference = jax_engine.DecodeEngine(
        jcfg, jparams, prefix_cache=False, kv_quant="int8", **ENGINE_ARGS
    )
    yield ported, reference
    ported.stop()
    reference.stop()


def test_int8_token_streams_match_jax_engine(int8_engines):
    """Greedy and seeded streams over the int8 dense cache, one prompt
    past the largest bucket (prefilled in windows), equal the JAX int8
    engine's."""
    ported, reference = int8_engines
    assert ported.kv_quant and ported.cache["k"].dtype == torch.int8
    rng = np.random.default_rng(31)

    def prompt(n):
        return rng.integers(0, 256, size=n).tolist()

    S = engine.SamplingParams
    requests = [
        (prompt(5), S(frequency_penalty=1.5, max_new_tokens=12), set()),
        (prompt(17), S(temperature=0.8, seed=11, max_new_tokens=10), set()),
        (prompt(30), S(temperature=1.0, top_k=20, seed=5, max_new_tokens=14), set()),
        (prompt(9), S(temperature=0.9, top_p=0.8, seed=3, presence_penalty=0.5, max_new_tokens=9), set()),
        (prompt(45), S(max_new_tokens=8), set()),
    ]
    jax_requests = [(p, jax_engine.SamplingParams(**s.__dict__), stops) for p, s, stops in requests]
    got = _generate(ported, requests)
    want = _generate(reference, jax_requests)
    for index, (mine, theirs) in enumerate(zip(got, want)):
        assert mine.tokens == theirs.tokens, index
        np.testing.assert_allclose(mine.logprobs, theirs.logprobs, rtol=1e-4, atol=1e-4)
    assert [len(r.tokens) for r in got] == [12, 10, 14, 9, 8]


def test_int8_long_prompt_chunked_matches_whole():
    """A 90-token prompt prefilled in 32-token windows gives the tokens of
    one whole 128-token prefill (``tests/test_kv_quant.py``'s contract)."""
    config = model.LlamaConfig.tiny(max_seq_len=256)
    params = model.init_params(config, seed=2)
    prompt = [(13 * i) % 250 + 1 for i in range(90)]

    def run(buckets):
        eng = engine.DecodeEngine(config, params, device="cpu", kv_quant="int8", max_slots=2,
                                  max_seq_len=256, prefill_buckets=buckets)
        try:
            return _generate(eng, [(prompt, engine.SamplingParams(max_new_tokens=8), set())])[0].tokens
        finally:
            eng.stop()

    chunked = run([32])
    assert len(chunked) == 8 and chunked == run([128])


def test_int8_logits_close_to_bf16_cache():
    """Prefill and four greedy decode steps: logits over the int8 cache
    within 5% of max |logit| of the model-dtype cache's, argmax agreeing
    on at least 80% of steps (``tests/test_kv_quant.py``'s bound)."""
    config = model.LlamaConfig.tiny(max_seq_len=64)
    params = model.init_params(config, seed=0)
    freqs = model.model_freqs(config)
    tokens = torch.tensor([[(7 * i) % 250 + 1 for i in range(12)]])
    outs = {}
    for quant in (False, True):
        cache = model.init_cache(config, 1, 64, kv_quant=quant)
        lengths = torch.tensor([12], dtype=torch.int32)
        logits = model.prefill(config, params, cache, tokens, lengths, torch.tensor([0]), freqs)
        steps = [logits]
        for _ in range(4):
            lengths = lengths + 1
            logits = model.decode_step(config, params, cache, logits.argmax(-1), lengths, freqs)
            steps.append(logits)
        outs[quant] = torch.stack(steps).numpy()
    reference, quantized = outs[False], outs[True]
    assert np.abs(reference - quantized).max() < 0.05 * np.abs(reference).max()
    assert (reference.argmax(-1) == quantized.argmax(-1)).mean() >= 0.8


def test_unknown_kv_quant_rejected():
    config = model.LlamaConfig.tiny(max_seq_len=64)
    with pytest.raises(ValueError, match="kv cache quantization"):
        engine.DecodeEngine(config, model.init_params(config), device="cpu", kv_quant="fp4",
                            max_slots=2, max_seq_len=64)
