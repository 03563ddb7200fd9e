"""The port's pipelined decode carry and mixed-step carry against its own
serial engine and the JAX package's carry engines, on the CPU.

Pipelined decode (``pipeline_decode=True``): the traffic of the JAX
package's ``tests/test_engine.py`` pipeline tests without their session
legs (sessions are not ported): five concurrent greedy requests over two
slots, two of them ending on a stop token inside a decode chunk, then
three seeded requests (temperature, top-k, top-p) over two slots. Token
streams and finish reasons of the port's pipelined engine equal its
serial engine's and the JAX pipelined engine's, on both layouts and both
cache types, and chunks were really chained (counted through a wrapper
on the engine's ``_dispatch_decode``).

Mixed-step carry: the ``tests/test_mixed_dispatch.py`` carry A/B: carry
on == carry off == the JAX carry engine, greedy and seeded, through a
prefix hit and a stop that lands while a speculated step is in flight;
the carry engine chained steps and counted the ``stale_row`` and
``drained`` invalidations.
"""

import asyncio

import numpy as np
import pytest
import torch

from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu_torch.cli.main import build_parser, serve_config
from langstream_tpu_torch.providers.torch_local import engine, model
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax
from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService

torch.set_num_threads(2)

PIPELINE_ARGS = dict(max_slots=2, max_seq_len=128, prefill_buckets=[16, 32], decode_chunk=4, seed=7)
LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged", kv_block_size=8)}


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=384)
    tcfg = model.LlamaConfig.tiny(max_seq_len=384)
    jparams = jax_model.init_params(jcfg, seed=0)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)
    return jcfg, jparams, tcfg, tparams


def _params_of(eng, **kw):
    cls = jax_engine.SamplingParams if isinstance(eng, jax_engine.DecodeEngine) else engine.SamplingParams
    return cls(**kw)


def _count_chains(eng):
    """Count the engine's chained dispatches (``_dispatch_decode`` and
    ``_dispatch_mixed`` called with a carry) through wrappers on the
    instance; the engine thread looks both up on it."""
    counts = {"decode": 0, "mixed": 0}
    for kind in counts:
        original = getattr(eng, f"_dispatch_{kind}")

        def counted(*args, _original=original, _kind=kind, **kwargs):
            if kwargs.get("carry") is not None:
                counts[_kind] += 1
            return _original(*args, **kwargs)

        setattr(eng, f"_dispatch_{kind}", counted)
    return counts


def _stops(weights, layout):
    """For requests 1 and 3 of the burst, a stop token whose first
    occurrence in the unstopped greedy stream lies inside a decode chunk
    (found with a serial port engine)."""
    _, _, tcfg, tparams = weights
    eng = engine.DecodeEngine(tcfg, tparams, device="cpu", **PIPELINE_ARGS, **LAYOUTS[layout])
    try:
        stops = {}
        for i in (1, 3):
            free = asyncio.run(eng.generate([1 + i, 2, 3], engine.SamplingParams(max_new_tokens=17)))
            # token 0 comes from prefill; chunks then emit 1-4, 5-8, ...
            position = next(p for p in range(5, 16)
                            if p % 4 != 0 and free.tokens.index(free.tokens[p]) == p)
            stops[i] = (free.tokens[position], position)
        return stops
    finally:
        eng.stop()


async def _burst(eng, stops):
    """More requests than slots (slot recycling), two ending on a stop
    token mid-chunk, then seeded sampling."""
    greedy = await asyncio.gather(*[
        eng.generate([1 + i, 2, 3], _params_of(eng, max_new_tokens=17),
                     stop_tokens={stops[i][0]} if i in stops else set())
        for i in range(5)
    ])
    sampled = await asyncio.gather(*[
        eng.generate([1 + i, 2, 3], _params_of(eng, temperature=0.9, top_k=8, top_p=0.95,
                                               max_new_tokens=13))
        for i in range(3)
    ])
    results = list(greedy) + list(sampled)
    return [r.tokens for r in results], [r.finish_reason for r in results]


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16-kv", "int8-kv"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pipelined_matches_serial_and_jax_pipelined(weights, layout, kv_quant):
    jcfg, jparams, tcfg, tparams = weights
    stops = _stops(weights, layout)
    args = dict(PIPELINE_ARGS, kv_quant=kv_quant, **LAYOUTS[layout])
    serial = engine.DecodeEngine(tcfg, tparams, device="cpu", **args)
    pipelined = engine.DecodeEngine(tcfg, tparams, device="cpu", pipeline_decode=True, **args)
    reference = jax_engine.DecodeEngine(
        jcfg, jparams, pipeline_decode=True, prefix_cache=layout == "paged",
        **({"paged_kernel": "reference"} if layout == "paged" else {}), **args)
    chains = _count_chains(pipelined)
    try:
        want = asyncio.run(_burst(serial, stops))
        got = asyncio.run(_burst(pipelined, stops))
        assert got == want
        assert got == asyncio.run(_burst(reference, stops))
        for i, (token, position) in stops.items():
            assert got[1][i] == "stop" and len(got[0][i]) == position, (i, got[0][i], token)
        assert [len(t) for t in got[0][5:]] == [13, 13, 13]
        assert chains["decode"] > 0 and chains["mixed"] == 0
        assert pipelined.stats["requests"] == serial.stats["requests"] == 8
        assert pipelined.stats["decode_steps"] >= serial.stats["decode_steps"]
    finally:
        for eng in (serial, pipelined, reference):
            eng.stop()


def test_pipelined_chunk_never_chains_past_a_request_budget(weights):
    """``_can_chain`` holds: every chained chunk leaves each of its riders
    two chunks of budget, so no rider ever finishes by length inside a
    blind chunk; a request admitted while a chunk is in flight joins the
    next fresh chunk."""
    _, _, tcfg, tparams = weights
    eng = engine.DecodeEngine(tcfg, tparams, device="cpu", pipeline_decode=True, **PIPELINE_ARGS)
    seen = []
    can_chain = eng._can_chain

    def recorded(inflight):
        verdict = can_chain(inflight)
        if verdict:
            assert not any(s.ready for i, s in enumerate(eng.slots) if not inflight["active"][i])
            seen.append([(len(s.generated), s.request.sampling.max_new_tokens)
                         for i, s in enumerate(eng.slots) if inflight["active"][i]])
        return verdict

    eng._can_chain = recorded
    try:
        async def main():
            first = asyncio.ensure_future(eng.generate([5, 6, 7], engine.SamplingParams(max_new_tokens=30)))
            await asyncio.sleep(0.2)
            second = await eng.generate([8, 9], engine.SamplingParams(max_new_tokens=6))
            return await first, second

        first, second = asyncio.run(main())
        assert len(first.tokens) == 30 and len(second.tokens) == 6
        assert seen and all(done + 8 <= budget for row in seen for done, budget in row)
    finally:
        eng.stop()


# ---------------------------------------------------------------------- #
# mixed-step carry
# ---------------------------------------------------------------------- #
MIXED_ARGS = dict(max_slots=4, max_seq_len=384, prefill_buckets=[16, 32, 64], kv_layout="paged",
                  kv_block_size=8, prefill_mode="mixed", prefill_chunk=16, decode_chunk=4, seed=11)
GREEDY = dict(max_new_tokens=6)
SEEDED = dict(max_new_tokens=8, temperature=0.9, top_k=20, top_p=0.9, seed=1234,
              presence_penalty=0.4, frequency_penalty=0.2)


async def _drive(eng):
    """One at a time: a cold prompt of 39 tokens, one sharing 32
    block-aligned tokens with it (its windows resume mid-prompt), a
    seeded one with penalties and truncation."""
    first = await eng.generate(list(range(1, 40)), _params_of(eng, **GREEDY))
    second = await eng.generate(list(range(1, 33)) + [99, 98], _params_of(eng, **GREEDY))
    third = await eng.generate(list(range(3, 30)), _params_of(eng, **SEEDED))
    return [(r.tokens, r.finish_reason) for r in (first, second, third)]


async def _contended_stop(eng):
    """Both prompts submitted back to back: the long prompt keeps the
    engine in chained mixed steps while the short one decodes and then
    stops mid-stream, with a speculated step in flight."""
    base = await eng.generate(list(range(1, 20)), _params_of(eng, **GREEDY))
    stop = {base.tokens[4]}
    short = asyncio.ensure_future(eng.generate(
        list(range(1, 20)), _params_of(eng, max_new_tokens=24), stop_tokens=stop))
    long = asyncio.ensure_future(eng.generate(list(range(5, 150)), _params_of(eng, **GREEDY)))
    results = await asyncio.gather(short, long)
    return [(base.tokens, base.finish_reason)] + [(r.tokens, r.finish_reason) for r in results]


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16-kv", "int8-kv"])
def test_mixed_carry_on_matches_off_and_jax_carry(weights, kv_quant):
    jcfg, jparams, tcfg, tparams = weights
    args = dict(MIXED_ARGS, kv_quant=kv_quant, pipeline_decode=True)
    on = engine.DecodeEngine(tcfg, tparams, device="cpu", mixed_carry=True, **args)
    off = engine.DecodeEngine(tcfg, tparams, device="cpu", mixed_carry=False, **args)
    reference = jax_engine.DecodeEngine(jcfg, jparams, paged_kernel="reference", mixed_carry=True,
                                        **args)
    chains = _count_chains(on)
    try:
        for traffic in (_drive, _contended_stop):
            got = asyncio.run(traffic(on))
            assert got == asyncio.run(traffic(off)), traffic.__name__
            assert got == asyncio.run(traffic(reference)), traffic.__name__
        # the contended stop: the short request stopped mid-stream
        base = got[0][0]
        assert got[1][1] == "stop" and got[1][0] == base[:base.index(base[4])]
        assert on.stats["mixed_steps_chained"] > 0 and off.stats["mixed_steps_chained"] == 0
        assert chains["mixed"] == on.stats["mixed_steps_chained"]
        assert reference.stats["mixed_steps_chained"] > 0
        invalidations = on.stats["mixed_carry_invalidations"]
        assert invalidations.get("drained", 0) >= 1, invalidations
        assert invalidations.get("stale_row", 0) >= 1, invalidations
        assert off.stats["mixed_carry_invalidations"] == {}
        assert on.stats["model_dispatches"].get("paged_mixed_step", 0) > 0
    finally:
        for eng in (on, off, reference):
            eng.stop()


def test_carry_keys_and_flags_reach_the_engine():
    """``pipeline-decode`` and ``mixed-carry`` reach the engine from the
    provider config (string-coerced, JAX defaults: pipeline off, carry
    on), and ``serve`` pipelines unless given ``--no-pipeline-decode``,
    as the JAX ``serve`` does."""
    base = {"model": {"preset": "tiny", "max_seq_len": 64}}
    cases = [
        ({}, (False, False)),
        ({"pipeline-decode": "true"}, (True, False)),
        ({"pipeline-decode": True, "kv-layout": "paged", "kv-block-size": "8",
          "prefill-mode": "mixed"}, (True, True)),
        ({"pipeline-decode": "yes", "kv-layout": "paged", "kv-block-size": "8",
          "prefill-mode": "mixed", "mixed-carry": "off"}, (True, False)),
    ]
    for engine_config, want in cases:
        service = TorchCompletionsService(
            dict(base, engine=dict(engine_config, **{"max-slots": 2})), device="cpu")
        try:
            assert (service.engine.pipeline_decode, service.engine.mixed_carry) == want, engine_config
        finally:
            service.engine.stop()
    assert serve_config(build_parser().parse_args(["serve"]))["engine"]["pipeline-decode"] is True
    unpipelined = serve_config(build_parser().parse_args(["serve", "--no-pipeline-decode"]))
    assert unpipelined["engine"]["pipeline-decode"] is False
    assert "quantization" not in unpipelined
    int8 = serve_config(build_parser().parse_args(["serve", "--quantization", "int8"]))
    assert int8["quantization"] == "int8"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["serve", "--quantization", "fp4"])
