"""The port's paged KV layout against the JAX package's, on the CPU.

The block manager (``paged.py``, copied into the port) against the JAX
one: the four manager cases of ``tests/test_paged_kv.py`` and a seeded
random sequence of allocate / publish / match / release / evict, with
identical block ids, matches, refcounts and stats.

The engine with ``kv_layout="paged"`` against the JAX paged engine
(``paged_kernel="reference"``, sessionless, the same carried-across
``tiny`` weights): greedy and seeded token streams and logprobs, a
prefix hit after slot turnover, a shared 288-token prefix that prefills
only its suffix with the same hit count as JAX, eviction under pool
pressure, admission that waits for blocks, the constructor's refusals,
and the port's paged layout against its dense one. Over int8 pools
(``kv_quant="int8"``): the streams against the JAX int8 paged engine,
warm-by-prefix against cold, and paged against the int8 dense layout.
"""

import asyncio

import numpy as np
import pytest
import torch

from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.providers.jax_local.paged import PagedKVManager as JaxManager
from langstream_tpu_torch.providers.torch_local import engine, model
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax
from langstream_tpu_torch.providers.torch_local.paged import PagedKVManager

torch.set_num_threads(2)

MANAGERS = [PagedKVManager, JaxManager]
ENGINE_ARGS = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 32, 64], decode_chunk=4, seed=0)
PAGED_ARGS = dict(kv_layout="paged", kv_block_size=8)


# ---------------------------------------------------------------------- #
# PagedKVManager: the port's copy against the JAX one
# ---------------------------------------------------------------------- #
def _match_is_block_granular(cls):
    manager = cls(num_blocks=16, block_size=4)
    blocks = manager.allocate(3)
    tokens = list(range(1, 11))
    manager.publish(tokens, blocks)
    return [
        blocks, manager.match(tokens),
        manager.match([1, 2, 3, 4, 99, 99, 99, 99, 9]), manager.match([7, 7, 7, 7, 7]),
    ]


def _refcounts_protect_from_eviction(cls):
    manager = cls(num_blocks=4, block_size=2)
    held = manager.allocate(2)
    manager.publish([1, 2, 3, 4], held)
    trace = [held, manager.allocate(2)]
    manager.release(held)
    trace += [manager.match([1, 2, 3, 4]), manager.allocate(3), dict(manager.stats)]
    return trace + [manager.match([1, 2, 3, 4])]


def _evicts_leaves_before_parents(cls):
    manager = cls(num_blocks=8, block_size=2)
    blocks = manager.allocate(3)
    manager.publish([1, 2, 3, 4, 5, 6], blocks)
    manager.release(blocks)
    return [blocks, manager._evict_one(), list(manager._free), manager.match([1, 2, 3, 4])]


def _publish_is_idempotent(cls):
    manager = cls(num_blocks=16, block_size=2)
    first = manager.allocate(2)
    manager.publish([5, 6, 7, 8], first)
    duplicate = manager.allocate(2)
    manager.publish([5, 6, 7, 8], duplicate)
    trace = [first, duplicate, manager.match([5, 6, 7, 8])]
    manager.release(duplicate)
    return trace + [list(manager._free), manager.blocks_cached, dict(manager.stats)]


@pytest.mark.parametrize("case", [
    _match_is_block_granular, _refcounts_protect_from_eviction,
    _evicts_leaves_before_parents, _publish_is_idempotent,
])
def test_manager_cases_match_jax(case):
    ported, reference = (case(cls) for cls in MANAGERS)
    assert ported == reference


def _random_sequence(cls, seed):
    rng = np.random.default_rng(seed)
    manager = cls(num_blocks=24, block_size=4)
    held = []   # (tokens, blocks) owned by a pretend slot
    trace = []
    vocab = [1, 2, 3]  # a tiny vocabulary so prompts share prefixes
    for _ in range(300):
        op = rng.integers(0, 5)
        if op == 0 or not held:
            tokens = rng.choice(vocab, size=int(rng.integers(1, 20))).tolist()
            chain, matched = manager.match(tokens)
            manager.ref(chain)
            fresh = manager.allocate(-(-len(tokens) // 4) - len(chain))
            if fresh is None:
                manager.release(chain)
                trace.append(("refused", chain, matched))
                continue
            held.append((tokens, chain + fresh))
            trace.append(("admit", chain, matched, fresh))
        elif op == 1:
            tokens, blocks = held[int(rng.integers(0, len(held)))]
            manager.publish(tokens, blocks)
            trace.append(("publish", dict(manager.stats)))
        elif op == 2:
            tokens, blocks = held.pop(int(rng.integers(0, len(held))))
            manager.publish(tokens, blocks)
            manager.release(blocks)
            trace.append(("finish", manager.blocks_in_use, manager.blocks_cached))
        elif op == 3:
            trace.append(("evict", manager._evict_one(), list(manager._free)))
        else:
            tokens = rng.choice(vocab, size=int(rng.integers(1, 20))).tolist()
            trace.append(("match", manager.match(tokens)))
    refcounts = [manager.refcount(b) for b in range(manager.num_blocks)]
    return trace + [refcounts, dict(manager.stats), list(manager._free)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_manager_random_sequence_matches_jax(seed):
    ported, reference = (_random_sequence(cls, seed) for cls in MANAGERS)
    assert ported == reference
    assert any(entry[0] == "admit" and entry[2] for entry in ported[:-3])  # prefix hits happened


# ---------------------------------------------------------------------- #
# engine: the port's paged layout against the JAX paged engine
# ---------------------------------------------------------------------- #
def _generate(eng, requests):
    async def main():
        return await asyncio.gather(*[
            eng.generate(prompt, params, stop_tokens=stops) for prompt, params, stops in requests
        ])

    return asyncio.run(main())


def _in_order(eng, requests):
    """One request at a time, each after the previous finished."""
    return [_generate(eng, [request])[0] for request in requests]


def _jax_requests(requests):
    return [(p, jax_engine.SamplingParams(**s.__dict__), stops) for p, s, stops in requests]


def _weights(max_seq_len=128):
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=max_seq_len)
    tcfg = model.LlamaConfig.tiny(max_seq_len=max_seq_len)
    jparams = jax_model.init_params(jcfg, seed=5)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module")
def engines(weights):
    jcfg, jparams, tcfg, tparams = weights
    ported = engine.DecodeEngine(tcfg, tparams, device="cpu", **ENGINE_ARGS, **PAGED_ARGS)
    dense = engine.DecodeEngine(tcfg, tparams, device="cpu", **ENGINE_ARGS)
    reference = jax_engine.DecodeEngine(
        jcfg, jparams, paged_kernel="reference", **ENGINE_ARGS, **PAGED_ARGS
    )
    yield ported, dense, reference
    for eng in (ported, dense, reference):
        eng.stop()


def _assert_same(got, want):
    for index, (mine, theirs) in enumerate(zip(got, want)):
        assert mine.tokens == theirs.tokens, index
        assert mine.finish_reason == theirs.finish_reason, index
        np.testing.assert_allclose(mine.logprobs, theirs.logprobs, rtol=1e-4, atol=1e-4)


def test_paged_token_streams_match_jax_paged_engine(engines):
    ported, _, reference = engines
    rng = np.random.default_rng(21)

    def prompt(n):
        return rng.integers(1, 256, size=n).tolist()

    shared = prompt(20)  # two requests share 16 tokens (two full blocks)
    S = engine.SamplingParams
    requests = [
        (prompt(5), S(frequency_penalty=1.5, max_new_tokens=12), set()),
        (shared + prompt(7), S(max_new_tokens=10), set()),
        (prompt(17), S(temperature=0.8, seed=11, max_new_tokens=10), set()),
        (prompt(30), S(temperature=1.0, top_k=20, seed=5, max_new_tokens=14), set()),
        (shared[:18] + prompt(3), S(temperature=0.9, top_p=0.8, seed=3, presence_penalty=0.5,
                                   frequency_penalty=0.3, max_new_tokens=9), set()),
        (prompt(70), S(temperature=0.7, seed=8, logit_bias={7: 5.0}, max_new_tokens=11), set()),
    ]
    got = _generate(ported, requests)
    want = _generate(reference, _jax_requests(requests))
    _assert_same(got, want)
    assert [len(r.tokens) for r in got] == [12, 10, 10, 14, 9, 11]


def test_prefix_hit_after_slot_turnover(engines):
    """The prefix cache serves a prefix whose slot is long gone: the
    second prompt shares 32 tokens (four blocks) with the first."""
    ported, _, reference = engines
    S = engine.SamplingParams
    requests = [
        (list(range(1, 40)), S(max_new_tokens=6), set()),
        (list(range(1, 33)) + [99, 98], S(max_new_tokens=6), set()),
    ]
    hits, reused = ported.kv_manager.stats["hit_tokens"], ported.stats["prefix_tokens_reused"]
    _assert_same(_in_order(ported, requests), _in_order(reference, _jax_requests(requests)))
    assert ported.kv_manager.stats["hit_tokens"] >= hits + 32
    assert ported.stats["prefix_tokens_reused"] - reused == ported.kv_manager.stats["hit_tokens"] - hits


def test_shared_prefix_prefills_only_its_suffix():
    """A second request sharing a 288-token prefix (18 blocks of 16) is
    admitted onto the cached chain and prefills only its 32-token suffix
    in one warm call; the hit count equals the JAX engine's."""
    jcfg, jparams, tcfg, tparams = _weights(max_seq_len=512)
    shared = [(13 * i) % 250 + 1 for i in range(288)]
    requests = [
        (shared + [(7 * i) % 250 + 1 for i in range(32)], engine.SamplingParams(max_new_tokens=8), set()),
        (shared + [(11 * i) % 250 + 1 for i in range(32)], engine.SamplingParams(max_new_tokens=8), set()),
    ]
    args = dict(max_slots=2, max_seq_len=512, prefill_buckets=[64, 512], decode_chunk=4,
                kv_layout="paged", kv_block_size=16)
    ported = engine.DecodeEngine(tcfg, tparams, device="cpu", **args)
    reference = jax_engine.DecodeEngine(jcfg, jparams, paged_kernel="reference", **args)
    try:
        got = _in_order(ported, requests)
        want = _in_order(reference, _jax_requests(requests))
    finally:
        ported.stop()
        reference.stop()
    _assert_same(got, want)
    assert ported.kv_manager.stats["hit_tokens"] == reference.kv_manager.stats["hit_tokens"] >= 256
    assert ported.stats["prefix_hits"] == 1 and ported.stats["warm_prefill_calls"] == 1
    assert ported.stats["model_dispatches"]["paged_prefill"] == 1
    assert ported.stats["model_dispatches"]["paged_prefill_at_offset"] == 1


def test_eviction_under_pool_pressure_keeps_parity(weights, engines):
    """A pool with no slack (two worst-case sequences) evicts published
    chains as fresh prompts arrive; the tokens still equal the JAX paged
    engine's, which never evicts, and nothing leaks."""
    _, _, tcfg, tparams = weights
    _, _, reference = engines
    paged = engine.DecodeEngine(
        tcfg, tparams, device="cpu", max_slots=2, max_seq_len=128, prefill_buckets=[16, 32, 64],
        decode_chunk=4, kv_layout="paged", kv_block_size=16, kv_blocks=2 * (128 // 16) + 1,
    )
    requests = [
        ([(i * 31 + j) % 250 + 1 for j in range(40)], engine.SamplingParams(max_new_tokens=24), set())
        for i in range(6)
    ]
    try:
        got = _generate(paged, requests)
        manager = paged.kv_manager
        assert manager.stats["evictions"] > 0
        assert manager.blocks_in_use == manager.blocks_cached  # all slots free: only the cache
    finally:
        paged.stop()
    _assert_same(got, _generate(reference, _jax_requests(requests)))


def test_admission_waits_for_blocks(weights):
    """More concurrent requests than the pool holds at once: late arrivals
    wait for running ones to release blocks, and every one is answered."""
    _, _, tcfg, tparams = weights
    paged = engine.DecodeEngine(
        tcfg, tparams, device="cpu", max_slots=4, max_seq_len=128, prefill_buckets=[16, 32, 64],
        decode_chunk=4, kv_layout="paged", kv_block_size=16, kv_blocks=(128 // 16) + 2,
    )
    requests = [
        ([(i * 17 + j) % 250 + 1 for j in range(24)], engine.SamplingParams(max_new_tokens=16), set())
        for i in range(5)
    ]
    try:
        assert [len(r.tokens) for r in _generate(paged, requests)] == [16] * 5
    finally:
        paged.stop()


def test_constructor_refusals(weights):
    _, _, tcfg, tparams = weights
    with pytest.raises(ValueError, match="kv_blocks"):
        engine.DecodeEngine(tcfg, tparams, device="cpu", max_seq_len=128,
                            kv_layout="paged", kv_block_size=16, kv_blocks=4)
    with pytest.raises(ValueError, match="paged kernel"):
        engine.DecodeEngine(tcfg, tparams, device="cpu", kv_layout="paged", paged_kernel="pallas")
    with pytest.raises(ValueError, match="layout"):
        engine.DecodeEngine(tcfg, tparams, device="cpu", kv_layout="ragged")
    small = engine.DecodeEngine(tcfg, tparams, device="cpu", max_slots=3, max_seq_len=100,
                                kv_layout="paged", kv_block_size=16)
    assert (small.max_blocks, small.num_blocks) == (7, 3 * 7 + 1)
    assert small._block_tables.shape == (3, 7)
    assert tuple(small.cache["k"].shape) == (tcfg.num_layers, 22, 16, tcfg.num_kv_heads,
                                            tcfg.dims_per_head)


def test_paged_matches_dense_greedy(engines):
    ported, dense, _ = engines
    prompts = [[i + 1, i + 2, i + 3, i + 4, i + 5] for i in range(6)] + [list(range(1, 30))]
    requests = [(p, engine.SamplingParams(max_new_tokens=6), set()) for p in prompts]
    assert [r.tokens for r in _generate(ported, requests)] == [
        r.tokens for r in _generate(dense, requests)
    ]


def test_reference_kernel_matches_fused_route(weights, engines):
    """``paged_kernel="reference"`` (the gather composition, asked for
    explicitly) gives the fused route's tokens; on the CPU both run plain
    PyTorch."""
    _, _, tcfg, tparams = weights
    ported, _, _ = engines
    oracle = engine.DecodeEngine(tcfg, tparams, device="cpu", paged_kernel="reference",
                                 **ENGINE_ARGS, **PAGED_ARGS)
    requests = [
        (list(range(3, 50)), engine.SamplingParams(max_new_tokens=7), set()),
        (list(range(3, 20)) + [5], engine.SamplingParams(temperature=0.8, seed=2, max_new_tokens=7), set()),
    ]
    try:
        _assert_same(_in_order(oracle, requests), _in_order(ported, requests))
    finally:
        oracle.stop()


# ---------------------------------------------------------------------- #
# int8 pools
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def int8_engines(weights):
    jcfg, jparams, tcfg, tparams = weights
    ported = engine.DecodeEngine(tcfg, tparams, device="cpu", kv_quant="int8",
                                 **ENGINE_ARGS, **PAGED_ARGS)
    reference = jax_engine.DecodeEngine(
        jcfg, jparams, paged_kernel="reference", kv_quant="int8", **ENGINE_ARGS, **PAGED_ARGS
    )
    yield ported, reference
    for eng in (ported, reference):
        eng.stop()


def test_int8_paged_token_streams_match_jax_paged_engine(int8_engines):
    ported, reference = int8_engines
    assert ported.cache["k"].dtype == torch.int8 and "v_scale" in ported.cache
    rng = np.random.default_rng(41)

    def prompt(n):
        return rng.integers(1, 256, size=n).tolist()

    shared = prompt(20)
    S = engine.SamplingParams
    requests = [
        (prompt(5), S(frequency_penalty=1.5, max_new_tokens=12), set()),
        (shared + prompt(7), S(max_new_tokens=10), set()),
        (prompt(17), S(temperature=0.8, seed=11, max_new_tokens=10), set()),
        (shared[:18] + prompt(3), S(temperature=0.9, top_p=0.8, seed=3, max_new_tokens=9), set()),
        (prompt(70), S(temperature=0.7, seed=8, max_new_tokens=11), set()),
    ]
    _assert_same(_generate(ported, requests), _generate(reference, _jax_requests(requests)))


def test_int8_paged_warm_by_prefix_equals_cold(weights, int8_engines):
    """A prompt admitted onto another request's int8 blocks decodes the
    tokens of a cold run on an engine without the prefix cache."""
    _, _, tcfg, tparams = weights
    ported, _ = int8_engines
    shared = [(11 * i) % 250 + 1 for i in range(40)]
    S = engine.SamplingParams
    first = (shared + [7, 8], S(max_new_tokens=6), set())
    follow = (shared + [9, 9, 9], S(max_new_tokens=6), set())
    hits = ported.stats["prefix_hits"]
    warm = _in_order(ported, [first, follow])[1]
    assert ported.stats["prefix_hits"] > hits
    cold_engine = engine.DecodeEngine(tcfg, tparams, device="cpu", kv_quant="int8",
                                      prefix_cache=False, **ENGINE_ARGS, **PAGED_ARGS)
    try:
        (cold,) = _generate(cold_engine, [follow])
        assert cold_engine.stats["prefix_hits"] == 0
    finally:
        cold_engine.stop()
    assert warm.tokens == cold.tokens


def test_int8_paged_matches_int8_dense_greedy(weights, int8_engines):
    _, _, tcfg, tparams = weights
    ported, _ = int8_engines
    dense = engine.DecodeEngine(tcfg, tparams, device="cpu", kv_quant="int8", **ENGINE_ARGS)
    prompts = [[i + 1, i + 2, i + 3, i + 4, i + 5] for i in range(4)] + [list(range(1, 30))]
    requests = [(p, engine.SamplingParams(max_new_tokens=6), set()) for p in prompts]
    try:
        assert [r.tokens for r in _generate(ported, requests)] == [
            r.tokens for r in _generate(dense, requests)
        ]
    finally:
        dense.stop()
