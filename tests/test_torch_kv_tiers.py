"""The host-DRAM KV tier in the port, held to the JAX package on the CPU.

Mirrors ``tests/test_kv_tiers.py``: the host arena (leaf-first LRU,
capacity backpressure, idempotent demotion) and the digest-keyed edges
(``:43-131``) run on the port's ``paged.py`` and JAX's side by side, with
the same answers and stats. The engine scenario (``:157-227``) runs on the
same tiny config (``LlamaConfig.tiny(max_seq_len=128)``, 4 slots, buckets
[16, 32, 64], blocks of 8): a 32-token chain demoted under the pressure of
six 32-token strangers in a 20-block pool, and promoted back by a prompt
that continues it. The port's tiered engine gives the streams of the
port's never-evicting oracle and of the JAX engine, token for token, for
int8 and model-dtype (f32) pools, greedy and seeded, with the demotions,
promotions and host hits of the JAX tiered engine. A torn promotion
(fault point ``host_promote_torn``) prefills cold with the same streams;
promoted tokens are not billed as ``evicted_recompute`` (the same bill as
the JAX engine's). ``engine: {kv-host-blocks}`` and ``serve
--kv-host-blocks`` reach the engine, and ``/metrics`` carries the tier's
series under the JAX names."""

import asyncio
import concurrent.futures
import gc
import urllib.request

import numpy as np
import pytest
import torch

from langstream_tpu.api import metrics as jax_metrics
from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.providers.jax_local import paged as jax_paged
from langstream_tpu.runtime import faults as jax_faults
from langstream_tpu_torch.cli.main import build_parser, serve_config, start_server
from langstream_tpu_torch.providers.torch_local import engine, model, paged
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax
from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService
from langstream_tpu_torch.runtime import faults

torch.set_num_threads(2)

@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


# ---------------------------------------------------------------------- #
# the host arena and the digest-keyed edges, on both packages
# ---------------------------------------------------------------------- #
def _arena_backpressure(lib):
    arena = lib.HostKVArena(capacity_blocks=2)
    # a parent/child chain plus an unrelated leaf
    assert arena.put("p", "", (1, 2), None, 0)
    assert arena.put("c", "p", (3, 4), None, 0)
    # full: a third entry evicts exactly one LEAF, the LRU-oldest leaf
    # "c", never the parent "p"
    assert arena.put("x", "", (9, 9), None, 0)
    assert arena.has("p") and arena.has("x") and not arena.has("c")
    assert arena.snapshot_stats()["evictions"] == 1
    arena.touch("p")
    assert arena.put("y", "", (8, 8), None, 0)
    assert arena.has("p") and arena.has("y") and not arena.has("x")
    assert arena.blocks_in_use == 2
    return arena.snapshot_stats(), sorted(arena.digests())


def _arena_idempotent(lib):
    arena = lib.HostKVArena(capacity_blocks=4)
    assert arena.put("d", "", (1,), None, 16)
    # a re-demotion of a promoted-then-evicted chain only refreshes it
    assert not arena.put("d", "", (1,), None, 16)
    stats = arena.snapshot_stats()
    assert stats["demoted_blocks"] == 1 and stats["demoted_bytes"] == 16
    assert arena.digests() == {"d"}
    return stats


def _managed_pair(lib, num_blocks=8, block_size=2, host_blocks=8):
    manager = lib.PagedKVManager(num_blocks=num_blocks, block_size=block_size)
    arena = lib.HostKVArena(host_blocks)
    manager.attach_host(arena)  # accounting only: the matching semantics
    return manager, arena


def _recycled_id(lib):
    """After chain A is demoted and its block ids recycle into chain B,
    neither tier resolves A's identity to B's rows."""
    manager, _ = _managed_pair(lib, num_blocks=4, block_size=2)  # 3 usable
    tokens_a = [1, 2, 3, 4, 5, 6]
    blocks_a = manager.allocate(3)
    manager.publish(tokens_a, blocks_a)
    manager.release(blocks_a)
    blocks_b = manager.allocate(3)
    assert blocks_b is not None and set(blocks_b) == set(blocks_a)
    tokens_b = [7, 8, 9, 10, 11, 12]
    manager.publish(tokens_b, blocks_b)
    assert manager.match(tokens_a) == ([], 0)
    chain_b, matched_b = manager.match(tokens_b)
    assert chain_b == blocks_b and matched_b == 6
    assert len(manager.host_match(tokens_a, 0)) == 3
    assert manager.host_match(tokens_b, 0) == []
    digest_b = manager.chain_digest(blocks_b[0])
    digests_a = [e.digest for e in manager.host_match(tokens_a, 0)]
    assert digest_b is not None and digest_b not in digests_a
    return blocks_a, blocks_b, digest_b, digests_a, dict(manager.stats)


def _first_missing_ancestor(lib):
    """host_match returns a consecutive continuation: past a missing
    ancestor nothing matches, but a scan starting past the hole does."""
    manager, arena = _managed_pair(lib, num_blocks=4, block_size=2)
    tokens = [1, 2, 3, 4, 5, 6]
    blocks = manager.allocate(3)
    manager.publish(tokens, blocks)
    manager.release(blocks)
    assert manager.allocate(3) is not None  # demotes the whole chain
    entries = manager.host_match(tokens, 0)
    assert len(entries) == 3
    with arena._lock:
        arena._remove_locked(entries[1].digest)
    truncated = manager.host_match(tokens, 0)
    assert [e.digest for e in truncated] == [entries[0].digest]
    past = manager.host_match(tokens, 2)
    assert [e.digest for e in past] == [entries[2].digest]
    return [e.digest for e in entries], dict(manager.stats), arena.snapshot_stats()


@pytest.mark.parametrize("case", [_arena_backpressure, _arena_idempotent, _recycled_id,
                                  _first_missing_ancestor],
                         ids=["arena-backpressure", "arena-idempotent", "recycled-id",
                              "first-missing-ancestor"])
def test_arena_and_digest_edges_match_jax(case):
    assert case(paged) == case(jax_paged)


# ---------------------------------------------------------------------- #
# engines: demote -> promote against a never-evicting oracle and JAX
# ---------------------------------------------------------------------- #
PROMPT1 = list(range(1, 33))
PROMPT2 = PROMPT1 + list(range(101, 109))
THRASH = [[(i * 31 + j) % 240 + 2 for j in range(32)] for i in range(6)]
SAMPLINGS = (dict(max_new_tokens=8), dict(max_new_tokens=8, temperature=0.8, seed=7))
ENGINE_ARGS = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 32, 64],
                   kv_layout="paged", kv_block_size=8)
TIERED = dict(kv_blocks=20, kv_host_blocks=32)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=128)
    tcfg = model.LlamaConfig.tiny(max_seq_len=128)
    jparams = jax_model.init_params(jcfg)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)
    return jcfg, jparams, tcfg, tparams


def _engine(weights, package, **kwargs):
    """An engine of either package as ``tests/test_kv_tiers.py`` builds
    it, started."""
    jcfg, jparams, tcfg, tparams = weights
    args = dict(ENGINE_ARGS, max_slots=kwargs.pop("max_slots", 4), **kwargs)
    if package == "jax":
        eng = jax_engine.DecodeEngine(jcfg, jparams, **args)
    else:
        eng = engine.DecodeEngine(tcfg, tparams, device="cpu", **args)
    eng.start()
    return eng


def _lib(eng):
    return jax_engine if isinstance(eng, jax_engine.DecodeEngine) else engine


async def _pressure(eng, sampling):
    params = _lib(eng).SamplingParams(**sampling)
    out = [(await eng.generate(PROMPT1, params)).tokens]
    for prompt in THRASH:
        await eng.generate(prompt, params)
    out.append((await eng.generate(PROMPT2, params)).tokens)
    return out


def _tier_stats(eng):
    return {
        "demotions": eng.kv_manager.stats["demotions"],
        "evictions": eng.kv_manager.stats["evictions"],
        "hit_tokens": eng.kv_manager.stats["hit_tokens"],
        "host_demotions": eng.stats["host_demotions"],
        "host_promotions": eng.stats["host_promotions"],
        "kv_host_hit_tokens": eng.stats["kv_host_hit_tokens"],
        "host_promote_aborts": eng.stats["host_promote_aborts"],
        "prefix_tokens_reused": eng.stats["prefix_tokens_reused"],
        "arena": eng.kv_host_arena.snapshot_stats(),
    }


@pytest.fixture(scope="module")
def jax_runs(weights):
    """The JAX tiered engine's and oracle's streams of the pressure
    scenario (both samplings on one engine pair, as the JAX test runs
    them), with the tiered engine's stats, per pool type; and the JAX
    gauge names a tiered paged engine exposes. Made on first use."""
    made = {}

    def get(kv_quant):
        if kv_quant not in made:
            quant_kw = dict(kv_quant=kv_quant) if kv_quant else {}
            tiered = _engine(weights, "jax", **TIERED, **quant_kw)
            oracle = _engine(weights, "jax", **quant_kw)
            try:
                got = [asyncio.run(_pressure(tiered, s)) for s in SAMPLINGS]
                want = [asyncio.run(_pressure(oracle, s)) for s in SAMPLINGS]
                names = sorted(k for k in jax_engine.engines_snapshot()
                               if k.startswith(("kv_host_", "kv_handoff_")))
                made[kv_quant] = got, want, _tier_stats(tiered), names
            finally:
                tiered.stop()
                oracle.stop()
        return made[kv_quant]

    return get


@pytest.mark.parametrize("kv_quant", ["int8", None], ids=["int8", "f32"])
def test_promoted_continuation_matches_oracle_and_jax(weights, jax_runs, kv_quant):
    """int8 pools demote their rows and scale leaves; the promoted
    continuation reproduces the never-evicting oracle exactly, greedy and
    seeded, as the JAX engines do, with the JAX tiered engine's demotions,
    promotions and host hits."""
    jax_got, jax_want, jax_stats, _ = jax_runs(kv_quant)
    quant_kw = dict(kv_quant=kv_quant) if kv_quant else {}
    tiered = _engine(weights, "port", **TIERED, **quant_kw)
    oracle = _engine(weights, "port", **quant_kw)
    try:
        got = [asyncio.run(_pressure(tiered, s)) for s in SAMPLINGS]
        want = [asyncio.run(_pressure(oracle, s)) for s in SAMPLINGS]
        stats = _tier_stats(tiered)
        assert got == want == jax_want == jax_got
        assert stats == jax_stats
        assert stats["demotions"] > 0 and stats["host_promotions"] > 0
        assert stats["kv_host_hit_tokens"] >= 8
        assert stats["host_promote_aborts"] == 0
        assert oracle.kv_manager.stats["evictions"] == 0
        # the demoted rows are the pool's bytes: int8 values with their f32
        # scales, or f32 values
        entry = next(iter(tiered.kv_host_arena._entries.values()))
        assert set(entry.data) == set(tiered.cache)
        for leaf, rows in entry.data.items():
            assert rows.dtype == tiered.cache[leaf].dtype
            assert tuple(rows.shape) == (tiered.cache[leaf].shape[0], *tiered.cache[leaf].shape[2:])
        assert tiered.stats["host_demote_bytes"] == tiered.stats["host_demotions"] * entry.nbytes
    finally:
        tiered.stop()
        oracle.stop()


def test_torn_promotion_aborts_to_cold_prefill(weights, jax_runs):
    """A promotion torn mid-transfer aborts before anything publishes: the
    admission prefills cold, the streams still match the oracle's (and
    JAX's), and the client sees no error."""
    _, jax_want, _, _ = jax_runs(None)
    faults.configure("host_promote_torn@step=1")
    tiered = _engine(weights, "port", **TIERED)
    try:
        got = asyncio.run(_pressure(tiered, SAMPLINGS[0]))
        assert got == jax_want[0]
        assert tiered.stats["host_promote_aborts"] >= 1
        assert tiered.stats["host_promotions"] == 0
        assert tiered.stats["kv_host_hit_tokens"] == 0
    finally:
        tiered.stop()


def _billing(eng):
    """A session follow-up whose slot and chain were evicted re-enters
    through promotion; returns its cached length and the engine's bill."""
    params = _lib(eng).SamplingParams(max_new_tokens=8)

    async def run():
        first = await eng.generate(PROMPT1, params, session_id="attr")
        history = PROMPT1 + first.tokens
        # more concurrent strangers than slots: the pinned session's slot
        # is evicted, and the pool pressure demotes its chain
        await asyncio.gather(*[eng.generate(p, params) for p in THRASH[:4]])
        await eng.generate(history, params, session_id="attr")
        return len(history)

    cached = asyncio.run(run())
    return cached, {
        "evicted_recompute": eng.stats["tokens_wasted"].get("evicted_recompute", 0),
        "kv_host_hit_tokens": eng.stats["kv_host_hit_tokens"],
        "host_promotions": eng.stats["host_promotions"],
        "host_promote_aborts": eng.stats["host_promote_aborts"],
    }


def test_promotion_is_not_billed_as_evicted_recompute(weights):
    """Promoted tokens were not prefilled again, so they are not billed as
    ``tokens_wasted{evicted_recompute}``; only the cold tail may be, and
    the bill is the JAX engine's."""
    bills = {}
    for package in ("port", "jax"):
        eng = _engine(weights, package, max_slots=2, **TIERED)
        try:
            bills[package] = _billing(eng)
            if package == "port":
                gc.collect()
                snapshot = engine.engines_snapshot()
                assert snapshot["kv_host_hit_tokens_total"] >= eng.stats["kv_host_hit_tokens"]
        finally:
            eng.stop()
    cached, bill = bills["port"]
    assert bill["host_promotions"] > 0 and bill["host_promote_aborts"] == 0
    assert 0 <= bill["evicted_recompute"] <= cached - bill["kv_host_hit_tokens"] < cached
    assert bills["port"] == bills["jax"]


# ---------------------------------------------------------------------- #
# configuration: the provider key, the serve flag, /metrics
# ---------------------------------------------------------------------- #
def test_kv_host_blocks_reaches_the_engine_through_the_provider():
    config = {"model": {"preset": "tiny", "max_seq_len": 128},
              "engine": {"max-slots": 2, "max-seq-len": 128, "kv-layout": "paged",
                         "kv-block-size": 8, "kv-blocks": 20, "kv-host-blocks": 32,
                         "prefill-buckets": [16, 32, 64]}}
    service = TorchCompletionsService(config, device="cpu")
    try:
        eng = service.engine
        assert eng.kv_host_blocks == 32
        assert eng.kv_host_arena is eng.kv_manager.host
        assert eng.kv_host_arena.capacity_blocks == 32
        assert eng.kv_manager._demote_data == eng._demote_block_data
        result = asyncio.run(service.get_text_completions(["once upon"], {"max-tokens": 3}))
        assert result.completion_tokens == 3
    finally:
        service.close()
    # the dense layout has no pool to tier: the key is accepted, as in JAX
    config["engine"]["kv-layout"] = "dense"
    service = TorchCompletionsService(config, device="cpu")
    try:
        assert service.engine.kv_host_arena is None and service.engine.kv_host_blocks == 0
    finally:
        service.close()


def test_serve_kv_host_blocks_reaches_the_engine_and_metrics(weights, jax_runs):
    """``serve --kv-host-blocks N`` builds a tiered engine, and ``/metrics``
    carries the handoff's and the tier's series under the JAX names, with
    the engine's counts after a demote and a promote."""
    args = build_parser().parse_args([
        "serve", "--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--model", "tiny",
        "--max-slots", "4", "--max-seq-len", "128", "--decode-chunk", "4",
        "--kv-layout", "paged", "--kv-block-size", "8", "--kv-blocks", "20",
        "--kv-host-blocks", "32",
    ])
    config = serve_config(args)
    assert config["engine"]["kv-host-blocks"] == 32
    assert serve_config(build_parser().parse_args(["serve"]))["engine"]["kv-host-blocks"] == ""
    config["engine"]["prefill-buckets"] = [16, 32, 64]
    service, server = start_server(args, config)
    try:
        eng = service.engine
        assert eng.kv_host_arena.capacity_blocks == 32
        futures = []
        for prompt in [PROMPT1, *THRASH, PROMPT2]:
            futures.append(concurrent.futures.Future())
            eng.submit(engine.GenerationRequest(
                prompt_tokens=prompt, sampling=engine.SamplingParams(max_new_tokens=4),
                future=futures[-1]))
            futures[-1].result(timeout=120)
        assert eng.stats["host_demotions"] > 0 and eng.stats["host_promotions"] > 0
        gc.collect()
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics",
                                    timeout=30) as response:
            parsed = jax_metrics.parse_prometheus_text(response.read().decode())
        names = sorted(k for k in engine.engines_snapshot()
                       if k.startswith(("kv_host_", "kv_handoff_")))
        assert names == jax_runs("int8")[3]
        value = {name: parsed[name][0][1] for name in names}
        assert value["kv_host_blocks_total"] >= 32
        assert value["kv_host_demotions_total"] >= eng.stats["host_demotions"]
        assert value["kv_host_promotions_total"] >= eng.stats["host_promotions"]
        assert value["kv_host_hit_tokens_total"] >= eng.stats["kv_host_hit_tokens"] > 0
        assert value["kv_handoff_imports_total"] >= 0
    finally:
        server.stop()
        service.close()
