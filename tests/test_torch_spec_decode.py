"""Self-drafting speculative decoding in the port, against the JAX
package, on the CPU (``tiny`` f32 weights): the port of the JAX
package's ``tests/test_spec_decode.py``.

- The drafter (``spec_decode.draft_ngram``) equals JAX's bit for bit, on
  the JAX tests' hand-made histories (``:71-111``) and on random ones.
- ``_accept_or_fallback``: its decisions and tokens equal JAX's bit for
  bit (the uniforms are JAX's), rejection sampling keeps the sampling
  distribution (the TV test, ``:265``), and a draft outside the
  truncation set is never accepted (``:307``).
- ``verify_step`` and ``paged_verify_step``, over the f32 and the int8
  cache, equal JAX's logits at every block position to 1e-4 of max
  |logit| and write the same cache rows; a verify whose
  drafts spill into the next block rolls back by a length rewind alone
  (``:340``).
- The engine: greedy streams with ``spec_decode="ngram"`` equal the
  spec-off streams and the JAX spec engine's (logprobs within 1e-5; int8
  cache 1e-4), on both layouts and over the int8 cache, with a warm
  second turn (``:148``); with the JAX engine's drafted and accepted
  counts and fewer decode steps than tokens (``:173``); a stop inside a
  verified block (``:204``); a seeded sampled request with nothing to
  draft equals the plain step bit for bit (``:239``).
- The variant list holds one spec chunk per JAX ``_spec_decode_fns``
  step count at every tier; the provider serves ``spec-decode: ngram``.
"""

import asyncio
import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.providers.jax_local import spec_decode as jax_spec
from langstream_tpu_torch.providers.torch_local import engine, model, prng, sampling
from langstream_tpu_torch.providers.torch_local import spec_decode
from langstream_tpu_torch.providers.torch_local.convert import cache_from_jax, params_from_jax
from langstream_tpu_torch.providers.torch_local.graphs import TIERS, Variant
from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService

torch.set_num_threads(2)

ARGS = dict(max_slots=2, max_seq_len=128, prefill_buckets=[32], spec_k=4, spec_ngram=2, seed=7)
PAGED = dict(kv_layout="paged", kv_block_size=8)
LOGPROB_TOLERANCE = {None: 1e-5, "int8": 1e-4}


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=128)
    tcfg = model.LlamaConfig.tiny(max_seq_len=128)
    jparams = jax_model.init_params(jcfg, seed=0)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)
    return jcfg, jparams, tcfg, tparams


def _repetitive(n=30):
    return (list(range(1, 9)) * 8)[:n]


# ---------------------------------------------------------------------- #
# the drafter
# ---------------------------------------------------------------------- #
def _both_drafts(history, lengths, active, ngram, k):
    jd, jn = jax_spec.draft_ngram(jnp.asarray(history, jnp.int32), jnp.asarray(lengths, jnp.int32),
                                  jnp.asarray(active), ngram=ngram, k=k)
    td, tn = spec_decode.draft_ngram(torch.from_numpy(np.asarray(history, np.int32)),
                                     torch.tensor(lengths, dtype=torch.int32),
                                     torch.tensor(active), ngram=ngram, k=k)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    return td.numpy().tolist(), tn.numpy().tolist()


# the JAX tests' cases: (history, length, k, width, active) -> (drafts, num)
DRAFT_CASES = {
    "continuation": (([7, 2, 3, 4, 9, 2, 3], 7, 3, 16, True), ([4, 9, 2], 3)),
    "most-recent": (([2, 3, 4, 2, 3, 8, 9, 2, 3], 9, 3, 16, True), ([8, 9, 2], 3)),
    "no-match": (([1, 2, 3, 4, 5, 6], 6, 3, 16, True), (None, 0)),
    "self-match-only": (([1, 2, 3], 3, 3, 16, True), (None, 0)),
    "context-boundary": (([5, 1, 2, 9, 9, 9, 9, 9, 9, 9, 9, 9, 5, 1], 14, 3, 16, True), ([2, 9], 2)),
    "inactive": (([2, 3, 4, 2, 3], 5, 3, 16, False), (None, 0)),
}


@pytest.mark.parametrize("case", sorted(DRAFT_CASES))
def test_drafter_cases_equal_jax(case):
    (history, length, k, width, active), (drafts, num) = DRAFT_CASES[case]
    row = history + [0] * (width - len(history))
    got, nums = _both_drafts([row], [length], [active], 2, k)
    assert nums[0] == num
    if drafts is not None:
        assert got[0][:len(drafts)] == drafts


@pytest.mark.parametrize("ngram, k", [(1, 3), (2, 4), (3, 2)])
def test_drafter_equals_jax_on_random_histories(ngram, k):
    rng = np.random.default_rng(ngram * 10 + k)
    history = rng.integers(0, 4, size=(64, 48))
    lengths = rng.integers(0, 49, size=64).tolist()
    _both_drafts(history, lengths, (rng.random(64) < 0.8).tolist(), ngram, k)


# ---------------------------------------------------------------------- #
# the acceptance pass
# ---------------------------------------------------------------------- #
def _both_accept(logits, temperature, top_k, top_p, seeds, position, candidate, have):
    rows = logits.shape[0]
    jkeys = jax_engine._sampling_keys(jnp.asarray(seeds, jnp.uint32), jnp.full((rows,), position, jnp.int32))
    ja, jf = jax_spec._accept_or_fallback(
        jnp.asarray(logits), jnp.asarray(temperature), jnp.asarray(top_k, jnp.int32),
        jnp.asarray(top_p), jkeys, jnp.asarray(candidate, jnp.int32), jnp.asarray(have))
    tkeys = prng.sampling_keys(torch.from_numpy(np.asarray(seeds, np.int64)),
                               torch.full((rows,), position))
    ta, tf = spec_decode._accept_or_fallback(
        torch.from_numpy(logits), torch.from_numpy(temperature), torch.from_numpy(top_k),
        torch.from_numpy(top_p), tkeys, torch.from_numpy(candidate), torch.from_numpy(have),
        stochastic=bool((temperature > 0).any()), truncated=bool((top_k > 0).any() or (top_p > 0).any()))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    return ta.numpy(), tf.numpy()


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (4, 0.0), (0, 0.85)])
def test_rejection_sampling_preserves_distribution(top_k, top_p):
    """Accept w.p. p(draft), else resample the residual: the emitted
    tokens follow the truncated, temperature-scaled distribution (total
    variation under 0.03 over 8192 seeds), and every decision and token
    equals JAX's."""
    vocab, rows, temp = 8, 8192, 0.7
    logits = np.tile(np.asarray([2.0, 1.5, 1.0, 0.6, 0.3, 0.0, -0.5, -1.0], np.float32), (rows, 1))
    accepted, fallback = _both_accept(
        logits, np.full(rows, temp, np.float32), np.full(rows, top_k, np.int64),
        np.full(rows, top_p, np.float32), np.arange(rows), 5,
        np.full(rows, 1, np.int64), np.ones(rows, bool))
    emitted = np.where(accepted, 1, fallback)
    target = sampling.truncation_mask(torch.from_numpy(logits[:1]), torch.tensor([top_k]),
                                      torch.tensor([top_p], dtype=torch.float32))[0] / temp
    probs = torch.softmax(target, dim=-1).numpy()
    counts = np.bincount(emitted, minlength=vocab) / rows
    assert 0.05 < float(accepted.mean()) < 1.0
    assert 0.5 * np.abs(counts - probs).sum() < 0.03


def test_draft_outside_truncation_always_rejected():
    rows = 512
    logits = np.tile(np.asarray([3.0, 2.5, 2.0, 1.5, -2.0, -3.0, -4.0, -5.0], np.float32), (rows, 1))
    accepted, _ = _both_accept(
        logits, np.full(rows, 0.9, np.float32), np.full(rows, 4, np.int64), np.zeros(rows, np.float32),
        np.arange(rows), 3, np.full(rows, 6, np.int64), np.ones(rows, bool))
    assert not accepted.any()


def test_mixed_batch_acceptance_equals_jax():
    """Greedy and sampled rows together, with and without drafts, over
    random logits: every decision and token equals JAX's."""
    rng = np.random.default_rng(9)
    rows = 256
    temperature = np.where(rng.random(rows) < 0.5, 0.8, 0.0).astype(np.float32)
    _both_accept(rng.normal(size=(rows, 16)).astype(np.float32), temperature,
                 rng.integers(0, 6, size=rows), np.where(rng.random(rows) < 0.3, 0.9, 0.0).astype(np.float32),
                 np.arange(rows), 11, rng.integers(0, 16, size=rows), rng.random(rows) < 0.7)


# ---------------------------------------------------------------------- #
# verify_step and paged_verify_step
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32-kv", "int8-kv"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_verify_step_matches_jax(weights, layout, kv_quant):
    """Three rows after a prefill (a full block, two drafts, an inactive
    row), the last block reaching the context's end: logits at every
    real position within 1e-4 of max |JAX logit|, and the written rows
    equal JAX's (int8 values within one quantum: activations that differ
    in the last place may round across a .5)."""
    jcfg, jparams, tcfg, tparams = weights
    quant = kv_quant == "int8"
    rng = np.random.default_rng(21)
    prompts = rng.integers(1, 250, size=(3, 32)).astype(np.int32)
    prompt_lengths = np.asarray([20, 32, 9], np.int32)
    block = rng.integers(1, 250, size=(3, 5)).astype(np.int32)
    lengths = np.asarray([21, 33, 0], np.int32)
    valid = np.asarray([5, 3, 0], np.int32)
    active = np.asarray([True, True, False])
    jfreqs, tfreqs = jax_model.model_freqs(jcfg), model.model_freqs(tcfg)
    if layout == "dense":
        jcache = jax_model.init_cache(jcfg, 3, 128, kv_quant=quant)
        jcache, _ = jax_model.prefill(jcfg, jparams, jcache, jnp.asarray(prompts), jnp.asarray(prompt_lengths),
                                      jnp.arange(3), jfreqs)
        tcache = cache_from_jax({k: np.asarray(v) for k, v in jcache.items()})
        jcache, jl = jax_model.verify_step(jcfg, jparams, jcache, jnp.asarray(block), jnp.asarray(lengths),
                                           jnp.asarray(valid), jfreqs, write_mask=jnp.asarray(active))
        tl = model.verify_step(tcfg, tparams, tcache, torch.from_numpy(block).long(),
                               torch.from_numpy(lengths), torch.from_numpy(valid), tfreqs,
                               write_mask=torch.from_numpy(active))
    else:
        tables = np.zeros((3, 16), np.int32)
        tables[:2, :6] = (rng.permutation(12) + 1).reshape(2, 6)
        jcache = jax_model.init_paged_cache(jcfg, 13, 8, kv_quant=quant)
        jcache, _ = jax_model.paged_prefill(jcfg, jparams, jcache, jnp.asarray(prompts[:2]),
                                            jnp.asarray(prompt_lengths[:2]), jnp.asarray(tables[:2]), jfreqs,
                                            kernel="reference")
        tcache = cache_from_jax({k: np.asarray(v) for k, v in jcache.items()})
        jcache, jl = jax_model.paged_verify_step(
            jcfg, jparams, jcache, jnp.asarray(block), jnp.asarray(lengths), jnp.asarray(valid),
            jnp.asarray(tables), jfreqs, write_mask=jnp.asarray(active), kernel="reference")
        tl = model.paged_verify_step(
            tcfg, tparams, tcache, torch.from_numpy(block).long(), torch.from_numpy(lengths),
            torch.from_numpy(valid), torch.from_numpy(tables), tfreqs, write_mask=torch.from_numpy(active))
    jl = np.asarray(jl)
    assert tl.shape == jl.shape == (3, 5, tcfg.vocab_size)
    scale = np.abs(jl[:2]).max()
    for row in range(2):
        np.testing.assert_allclose(tl[row, : valid[row]].numpy(), jl[row, : valid[row]], atol=1e-4 * scale,
                                   rtol=0)
    for leaf, value in tcache.items():
        want = np.asarray(jcache[leaf])
        if layout == "paged":  # block 0, the null block, takes masked writes in any order
            value, want = value[:, 1:], want[:, 1:]
        if leaf in ("k", "v") and quant:
            assert np.abs(value.numpy().astype(np.int32) - want.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(value.numpy(), want, rtol=1e-4, atol=1e-5)


def test_paged_length_rewind_at_block_boundary(weights):
    """Drafts written into the next block and all rejected: the length
    advances by one only, and the next verify sees what a cache that
    never saw the drafts sees (``tests/test_spec_decode.py:340``)."""
    _, _, tcfg, tparams = weights
    freqs = model.model_freqs(tcfg)
    tables = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    prompt = torch.tensor([[3, 1, 4, 1, 5, 9, 2]])
    caches = []
    for _ in range(2):
        cache = model.init_paged_cache(tcfg, 8, 8)
        model.paged_prefill(tcfg, tparams, cache, prompt, torch.tensor([7], dtype=torch.int32), tables, freqs)
        caches.append(cache)
    spec_cache, control_cache = caches
    lengths = torch.tensor([8], dtype=torch.int32)
    spec_logits = model.paged_verify_step(tcfg, tparams, spec_cache, torch.tensor([[6, 11, 12, 13]]), lengths,
                                          torch.tensor([4], dtype=torch.int32), tables, freqs)
    control = model.paged_decode_step(tcfg, tparams, control_cache, torch.tensor([6]), lengths, tables, freqs)
    torch.testing.assert_close(spec_logits[:, 0], control, rtol=2e-5, atol=2e-5)
    lengths = torch.tensor([9], dtype=torch.int32)
    after = [model.paged_verify_step(tcfg, tparams, cache, torch.tensor([[7, 21, 22, 23]]), lengths,
                                     torch.tensor([4], dtype=torch.int32), tables, freqs)
             for cache in (spec_cache, control_cache)]
    torch.testing.assert_close(after[0], after[1], rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------- #
# the engine
# ---------------------------------------------------------------------- #
def _engines(weights, spec, *, layout="dense", kv_quant=None, **kwargs):
    jcfg, jparams, tcfg, tparams = weights
    args = dict(ARGS, spec_decode=spec, kv_quant=kv_quant, **(PAGED if layout == "paged" else {}), **kwargs)
    reference = dict(paged_kernel="reference") if layout == "paged" else {}
    return (engine.DecodeEngine(tcfg, tparams, device="cpu", **args),
            jax_engine.DecodeEngine(jcfg, jparams, **reference, **args))


def _serve(eng, turns):
    """Each turn's (prompt, sampling kwargs, stop tokens) submitted while
    the thread is stopped, then run to its end."""
    lib = jax_engine if isinstance(eng, jax_engine.DecodeEngine) else engine
    results = []
    try:
        for prompt, kwargs, stops in turns:
            future = concurrent.futures.Future()
            eng.submit(lib.GenerationRequest(prompt_tokens=list(prompt), sampling=lib.SamplingParams(**kwargs),
                                             stop_tokens=set(stops), future=future))
            eng.start()
            results.append(future.result(timeout=300))
            eng.stop()
    finally:
        eng.stop()
    return results


def _same(got, want, tolerance=1e-5):
    for index, (mine, theirs) in enumerate(zip(got, want)):
        assert mine.tokens == theirs.tokens, index
        assert mine.finish_reason == theirs.finish_reason, index
        np.testing.assert_allclose(mine.logprobs, theirs.logprobs, rtol=tolerance, atol=tolerance)


TURNS = [(_repetitive(30), dict(max_new_tokens=12), ()), (_repetitive(24) + [99, 98], dict(max_new_tokens=12), ())]
ENGINE_CASES = [("dense", None), ("paged", None), ("dense", "int8"), ("paged", "int8")]


@pytest.mark.parametrize("layout, kv_quant", ENGINE_CASES,
                         ids=[f"{layout}-{kv or 'f32'}-kv" for layout, kv in ENGINE_CASES])
def test_greedy_streams_equal_spec_off_and_jax(weights, layout, kv_quant):
    """A cold turn and a warm second one (paged prefix hit, dense prefix
    copy): the spec engine's greedy streams equal the spec-off engine's
    and the JAX spec engine's, and it speculated (drafted, accepted,
    the same counts as JAX)."""
    spec, reference = _engines(weights, "ngram", layout=layout, kv_quant=kv_quant)
    plain, _ = _engines(weights, "off", layout=layout, kv_quant=kv_quant)
    got, want, oracle = _serve(spec, TURNS), _serve(reference, TURNS), _serve(plain, TURNS)
    _same(got, want, LOGPROB_TOLERANCE[kv_quant])
    _same(got, oracle, LOGPROB_TOLERANCE[kv_quant])
    for key in ("tokens_drafted", "tokens_draft_accepted", "prefix_hits", "prefix_tokens_reused"):
        assert spec.stats[key] == reference.stats[key], key
    assert spec.stats["tokens_drafted"] > 0
    assert spec.stats["tokens_wasted"]["draft_rejected"] == (
        spec.stats["tokens_drafted"] - spec.stats["tokens_draft_accepted"])


def test_fewer_steps_and_mid_block_stop(weights):
    """High repetition: the stream of 32 tokens from fewer decode steps
    than tokens, with JAX's drafted and accepted counts; then a stop
    token in mid-stream ends both engines' streams at the same place."""
    spec, reference = _engines(weights, "ngram", max_seq_len=128, decode_chunk=4)
    plain, _ = _engines(weights, "off", decode_chunk=4)
    turn = [(_repetitive(30), dict(max_new_tokens=32), ())]
    got, want, oracle = _serve(spec, turn), _serve(reference, turn), _serve(plain, turn)
    _same(got, want)
    _same(got, oracle)
    assert spec.stats["decode_steps"] < plain.stats["decode_steps"]
    assert spec.stats["decode_steps"] < spec.stats["tokens_generated"]
    for key in ("tokens_drafted", "tokens_draft_accepted", "decode_steps", "tokens_generated"):
        assert spec.stats[key] == reference.stats[key], key
    stop = oracle[0].tokens[16]
    stopped = [(_repetitive(30), dict(max_new_tokens=32), (stop,))]
    got, want = _serve(spec, stopped), _serve(reference, stopped)
    _same(got, want)
    assert got[0].finish_reason == "stop" and stop not in got[0].tokens


def test_no_draft_stochastic_equals_plain_step(weights):
    """A prompt with nothing to draft, sampled with a seed: the spec
    engine's tokens equal the spec-off engine's and JAX's bit for bit."""
    spec, reference = _engines(weights, "ngram")
    plain, _ = _engines(weights, "off")
    turn = [(list(range(1, 31)), dict(temperature=0.8, top_k=20, top_p=0.9, max_new_tokens=8, seed=1234), ())]
    got, want, oracle = _serve(spec, turn), _serve(reference, turn), _serve(plain, turn)
    _same(got, want)
    _same(got, oracle)


def test_spec_variants_cover_jax_spec_jobs(weights):
    """One spec chunk per step count of the JAX ``_variant_jobs``' spec
    decode functions, at every sampling tier; no plain decode chunk."""
    ported, reference = _engines(weights, "ngram", layout="paged", admission_chunk=2)
    jobs = {id(fn) for fn, _ in reference._variant_jobs()}
    steps = {n for n, fn in reference._spec_decode_fns.items() if id(fn) in jobs}
    keys = ported._variant_keys()
    assert {Variant("spec", n, tier) for n in steps for tier in TIERS} == {
        key for key in keys if key.kind in ("spec", "decode")}
    assert steps == {ported.decode_chunk, 1, 2}
    for eng in (ported, reference):
        eng.stop()


def test_engine_and_provider_spec_settings():
    """The provider serves ``spec-decode: ngram`` with its ``spec-k`` and
    ``spec-ngram`` (strings coerced, as in the JAX provider); a mode the
    engine does not know raises, as in JAX."""
    service = TorchCompletionsService({
        "model": {"preset": "tiny", "max_seq_len": 64},
        "engine": {"max-slots": "2", "spec-decode": "ngram", "spec-k": "3", "spec-ngram": "3"},
    }, device="cpu")
    try:
        eng = service.engine
        assert (eng.spec, eng.spec_k, eng.spec_ngram, eng.spec_block) == (True, 3, 3, 4)
        result = asyncio.run(service.get_text_completions(["abcabcabcabc"], {"max-tokens": 6}))
        assert result.completion_tokens == 6
    finally:
        service.engine.stop()
    with pytest.raises(ValueError, match="spec decode"):
        engine.DecodeEngine(model.LlamaConfig.tiny(), {}, device="cpu", spec_decode="turbo")
