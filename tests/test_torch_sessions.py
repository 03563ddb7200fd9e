"""KV reuse across requests in the port, against the JAX engine, on the CPU:
sessions (``session_id`` pinning, warm-first admission, least recently
used eviction), the dense cross-slot prefix copy (and the salvage of a
finished slot's rows), and paged copy-on-write.

Each scenario of the JAX package's ``tests/test_engine.py`` (``:104``,
``:164``, ``:244``, ``:761``, ``:875``, ``:1013``, ``:1100``, ``:1142``,
``:1177``, ``:1247``, ``:1277``, ``:1333``), ``tests/test_paged_kv.py``
(``:154``, ``:186``) and ``tests/test_kv_quant.py`` (``:88``) runs on a
port engine and a JAX engine of the same ``tiny`` f32 weights, on the
dense, paged and mixed layouts and over the int8 KV cache. The token
streams are equal, the logprobs within 1e-5 (1e-4 over the int8 cache,
where activations that differ in the last place may quantize across a
.5, one quantum, as ``test_torch_kv_quant.py`` holds the cache), and so
are the reuse stats:
``session_hits``, ``prefix_hits``, ``prefix_tokens_reused``, the paged
``cow_copies``, the prefill calls cold and warm, and the tokens booked as
``evicted_recompute``. A scenario submits each round of requests while
the engine thread is stopped and then starts it, so that both engines
admit the same queue (the JAX package's ``test_warm_followups_batch``
does the same); every round fits the slots, so admission does not
depend on when the host harvests. The two engines of a configuration
live for the module, so what one scenario leaves in the caches is part
of the next one's start, on both sides.

By hand: a copy or block-copy variant first met while other slots hold
rows leaves every other slot's rows (and the source's) bit for bit; a
session's slot keeps its history and (paged) only the blocks it fills;
``session_id``, else ``user``, sent to the server pins the engine's slot.
"""

import concurrent.futures
import json
import urllib.request

import numpy as np
import pytest
import torch

from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu_torch.cli.main import build_parser, start_server
from langstream_tpu_torch.providers.torch_local import engine, model
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax
from langstream_tpu_torch.serving.openai_api import _options_from_request

torch.set_num_threads(2)

ARGS = dict(max_slots=4, max_seq_len=256, prefill_buckets=[16, 32, 64], decode_chunk=4, seed=7)
LAYOUTS = {
    "dense": {},
    "paged": dict(kv_layout="paged", kv_block_size=8),
    "mixed": dict(kv_layout="paged", kv_block_size=8, prefill_mode="mixed", prefill_chunk=16),
}
CONFIGS = {"dense": ("dense", None), "paged": ("paged", None), "mixed": ("mixed", None),
           "dense-int8": ("dense", "int8"), "paged-int8": ("paged", "int8")}
LOGPROB_TOLERANCE = {None: 1e-5, "int8": 1e-4}
STATS = ("session_hits", "prefix_hits", "prefix_tokens_reused", "prefill_calls", "warm_prefill_calls")


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=256)
    tcfg = model.LlamaConfig.tiny(max_seq_len=256)
    jparams = jax_model.init_params(jcfg, seed=5)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def pairs(weights):
    """(port engine, JAX engine) per configuration, made on first use and
    kept for the module."""
    jcfg, jparams, tcfg, tparams = weights
    made = {}

    def get(name):
        if name not in made:
            layout, kv_quant = CONFIGS[name]
            kwargs = dict(ARGS, **LAYOUTS[layout], kv_quant=kv_quant)
            reference = dict(paged_kernel="reference") if layout != "dense" else {}
            made[name] = (engine.DecodeEngine(tcfg, tparams, device="cpu", **kwargs),
                          jax_engine.DecodeEngine(jcfg, jparams, **reference, **kwargs))
        return made[name]

    yield get
    for pair in made.values():
        for eng in pair:
            eng.stop()


def _round(eng, batch):
    """Submit every (prompt, sampling kwargs, session) of ``batch`` while
    the engine thread is stopped, start it, wait for every result, stop
    it."""
    lib = jax_engine if isinstance(eng, jax_engine.DecodeEngine) else engine
    futures = []
    for prompt, sampling, session in batch:
        futures.append(concurrent.futures.Future())
        eng.submit(lib.GenerationRequest(
            prompt_tokens=list(prompt), sampling=lib.SamplingParams(**sampling),
            session_id=session, future=futures[-1]))
    eng.start()
    try:
        return [future.result(timeout=300) for future in futures]
    finally:
        eng.stop()


def _stats(eng):
    stats = {key: eng.stats[key] for key in STATS}
    stats["evicted_recompute"] = eng.stats["tokens_wasted"].get("evicted_recompute", 0)
    stats["cow_copies"] = eng.kv_manager.stats["cow_copies"] if eng.kv_manager else 0
    return stats


def _seq(n, a, b=1):
    return [(a * i + b) % 250 + 1 for i in range(n)]


SIX = dict(max_new_tokens=6)


def session_reuse(run):
    """``test_engine.py:104`` and ``:761``: a session's follow-up extends
    its history (one short, one long suffix) and a cold twin of it."""
    r1, = run([([1, 2, 3, 4], SIX, "sess-A")])
    follow = [1, 2, 3, 4] + r1.tokens + [40, 41]
    r2, = run([(follow, SIX, "sess-A")])
    r3, = run([(follow, SIX, None)])
    long = follow + r2.tokens + [(i % 50) + 1 for i in range(70)]
    r4, = run([(long, SIX, "sess-A")])
    return [r1, r2, r3, r4]


def long_warm_suffix(run):
    """``:164``: a follow-up whose suffix passes the largest bucket."""
    first = _seq(24, 7)
    r1, = run([(first, SIX, "s")])
    r2, = run([(first + r1.tokens + _seq(90, 11), SIX, "s")])
    return [r1, r2]


def pressure(run):
    """``:244`` and ``:875``: more sessions than slots, pinned sessions
    evicted least recently used first, follow-ups racing cold ones."""
    prompts = [_seq(20, 5, i) for i in range(8)]
    first = run([(prompts[i], SIX, f"c{i}") for i in range(4)])
    first += run([(prompts[i], SIX, f"c{i}") for i in range(4, 8)])
    touched, = run([(prompts[5] + first[5].tokens + [9], SIX, "c5")])
    cold = run([([7, 8, 9], SIX, None)])
    follows = [prompts[i] + first[i].tokens + _seq(6, 3, i) for i in range(8)]
    seconds = run([(follows[i], SIX, f"c{i}") for i in (0, 5, 6, 7)])
    seconds += run([(follows[i], SIX, f"c{i}") for i in (1, 2, 3, 4)])
    return first + [touched] + cold + seconds


def batched_followups(run):
    """``:1013``: four sessions' follow-ups in one warm batch."""
    first = run([([i + 1, 2, 3], dict(max_new_tokens=3), f"b{i}") for i in range(4)])
    follow = run([([i + 1, 2, 3] + first[i].tokens + [9], dict(max_new_tokens=3), f"b{i}")
                  for i in range(4)])
    return first + follow


def partial_prefix(run):
    """``:1100``: a follow-up that diverges after 24 shared tokens."""
    shared = list(range(1, 25))
    first = run([(shared + [30, 31], SIX, "p")])
    return first + run([(shared + [40, 41, 42], SIX, "p")])


def cross_slot_copies(run):
    """``:1142``, ``:1177``, ``:1247``, ``tests/test_paged_kv.py:154``:
    sessionless prompts sharing a prefix with a pinned session, a
    finished sessionless slot, and with a long divergent tail."""
    shared = _seq(40, 5)
    out = run([(shared + [7, 8], SIX, "pin")])
    out += run([(shared + [9, 10, 11], SIX, None)])
    template = _seq(32, 3)
    out += run([(template + [1, 2], SIX, None)])
    out += run([(template + [3, 4, 5], SIX, None)])
    long = _seq(100, 11)
    out += run([(long, SIX, "pin2")])
    out += run([(long[:90] + _seq(80, 13), SIX, None)])
    out += run([(list(range(1, 40)), SIX, None)])
    out += run([(list(range(1, 33)) + [99, 98], SIX, None)])
    return out


def cow(run):
    """``tests/test_paged_kv.py:186``: a follow-up that diverges inside a
    published block, then a sessionless request resending the original
    chain, which must read it uncorrupted."""
    prompt = list(range(1, 36))
    s1, = run([(prompt, SIX, "cow")])
    history = prompt + s1.tokens
    s2, = run([(history[:30] + [201, 202, 203], SIX, "cow")])
    probe, = run([(history + [42], SIX, None)])
    return [s1, s2, probe]


def stress(run):
    """``:1277`` and ``:1333``: template sharers and session traffic with
    long suffixes, four at a time, and a continuation of a slot's
    prompt and answer."""
    template = _seq(30, 17)
    prompts = []
    for i in range(12):
        if i % 2 == 0:
            prompts.append((template + _seq(4, 7, i), None))
        else:
            prompts.append((template[:20] + _seq(70 if i % 4 == 3 else 6, 11, i), f"st-{i % 5}"))
    out = []
    for start in range(0, 12, 4):
        out += run([(prompt, SIX, session) for prompt, session in prompts[start:start + 4]])
    a, = run([(_seq(24, 19), dict(max_new_tokens=24), None)])
    out += [a] + run([(_seq(24, 19) + a.tokens, SIX, None)])
    return out


def int8_reuse(run):
    """``tests/test_kv_quant.py:88``: a warm follow-up and a cross-slot
    copy, over whichever cache the engine holds."""
    shared = _seq(40, 5, 2)
    r1, = run([(shared + [7, 8], SIX, "q")])
    warm, = run([(shared + [7, 8] + r1.tokens + [30, 31], SIX, "q")])
    copied, = run([(shared + [9, 9, 9], SIX, None)])
    return [r1, warm, copied]


SCENARIOS = [session_reuse, long_warm_suffix, pressure, batched_followups, partial_prefix,
             cross_slot_copies, cow, stress, int8_reuse]
CASES = [(config, scenario) for config in ("dense", "paged", "mixed") for scenario in SCENARIOS] + [
    ("dense-int8", int8_reuse), ("paged-int8", int8_reuse), ("paged-int8", cow),
    ("dense-int8", cross_slot_copies)]


@pytest.mark.parametrize("config, scenario", CASES,
                         ids=[f"{config}-{scenario.__name__}" for config, scenario in CASES])
def test_reuse_scenario_matches_jax(pairs, config, scenario):
    """The scenario's streams, logprobs and reuse stats on the port equal
    the JAX engine's."""
    ported, reference = pairs(config)
    before = _stats(ported), _stats(reference)
    got = scenario(lambda batch: _round(ported, batch))
    want = scenario(lambda batch: _round(reference, batch))
    assert len(got) == len(want)
    for index, (mine, theirs) in enumerate(zip(got, want)):
        assert mine.tokens == theirs.tokens, index
        assert mine.finish_reason == theirs.finish_reason, index
        tolerance = LOGPROB_TOLERANCE[CONFIGS[config][1]]
        np.testing.assert_allclose(mine.logprobs, theirs.logprobs, rtol=tolerance, atol=tolerance)
    delta = [{key: after[key] - start[key] for key in after}
             for after, start in zip((_stats(ported), _stats(reference)), before)]
    assert delta[0] == delta[1], delta
    if scenario in (session_reuse, long_warm_suffix, pressure, batched_followups, partial_prefix):
        assert delta[0]["session_hits"] > 0
    if scenario in (cross_slot_copies, stress, int8_reuse) or (
            scenario is cow and config != "dense"):
        assert delta[0]["prefix_hits"] + delta[0]["session_hits"] > 0
    if scenario is cow and config != "dense":
        assert delta[0]["cow_copies"] > 0
    if scenario is pressure:
        assert delta[0]["evicted_recompute"] > 0


def test_session_pins_and_trims_paged_reservation(weights):
    """At finish a session's slot keeps its history and, paged, only the
    blocks its history fills (``tests/test_paged_kv.py``'s trim test);
    a sessionless dense slot keeps its rows for a later copy, a paged
    one releases its blocks."""
    _, _, tcfg, tparams = weights
    for layout in ("dense", "paged"):
        eng = engine.DecodeEngine(tcfg, tparams, device="cpu", **dict(ARGS, **LAYOUTS[layout]))
        pinned, free = _round(eng, [(_seq(6, 3), dict(max_new_tokens=40), "trim"),
                                    (_seq(20, 9), SIX, None)])
        slots = {slot.session_id: slot for slot in eng.slots if slot.history}
        slot = slots["trim"]
        assert slot.history[: 6] == _seq(6, 3) and slot.length == len(slot.history) == 6 + 39
        if layout == "paged":
            assert len(slot.blocks) == -(-slot.length // eng.block_size)
            assert None not in slots
        else:
            assert slots[None].history == _seq(20, 9) + free.tokens[:-1]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_copy_first_met_while_serving_leaves_other_slots_alone(weights, layout):
    """A copy variant captured on first use warms up on its dummy (a slot,
    or the null block, copied onto itself) and then copies: the
    destination's rows (dense: the window) are the source's, and every
    other slot's rows or block, the source's included, stay bit for
    bit."""
    _, _, tcfg, tparams = weights
    eng = engine.DecodeEngine(tcfg, tparams, device="cpu", **dict(ARGS, **LAYOUTS[layout]))
    rng = np.random.default_rng(3)
    for leaf in eng.cache.values():
        noise = rng.integers(-100, 100, size=leaf.shape) if leaf.dtype == torch.int8 else \
            rng.standard_normal(leaf.shape)
        leaf.copy_(torch.from_numpy(noise))
    before = {name: leaf.clone() for name, leaf in eng.cache.items()}
    with torch.inference_mode():
        if layout == "dense":
            eng._dispatch_prefix_copy(2, 1, 40)  # windows of 64 (largest) rows
            changed = (slice(None), 1)
            source = (slice(None), 2, slice(0, 64))
            target = (slice(None), 1, slice(0, 64))
        else:
            eng._dispatch_block_copy(5, 9)
            changed = (slice(None), 9)
            source = target = None
    assert eng.steps.stats["kinds"][("copy" if layout == "dense" else "block_copy")]["captured"] == 1
    for name, leaf in eng.cache.items():
        if source is not None:
            assert torch.equal(leaf[target], before[name][source]), name
            assert torch.equal(leaf[:, 1, 64:], before[name][:, 1, 64:]), name
        else:
            assert torch.equal(leaf[:, 9], before[name][:, 5]), name
        others = torch.ones(leaf.shape[1], dtype=torch.bool)
        others[changed[1]] = False
        assert torch.equal(leaf[:, others], before[name][:, others]), name
    assert eng.stats["prefix_hits"] == (1 if layout == "dense" else 0)


def test_server_maps_session_id_then_user():
    """``session_id``, else the OpenAI ``user`` field, reaches the engine
    as the request's session (the JAX server's mapping): through the
    port's server and provider, the slots pin those sessions; only choice
    0 of n keeps it."""
    assert _options_from_request({"session_id": "a", "user": "b"}, "m")["session-id"] == "a"
    assert "session-id" not in _options_from_request({}, "m")
    args = build_parser().parse_args([
        "serve", "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
        "--max-slots", "4", "--max-seq-len", "256", "--decode-chunk", "4"])
    service, api = start_server(args)
    url = f"http://127.0.0.1:{api.port}/v1/chat/completions"
    try:
        for body in ({"user": "u-7"}, {"session_id": "s-1", "user": "ignored"},
                     {"user": "u-8", "n": 2}):
            request = urllib.request.Request(url, data=json.dumps(dict(
                body, messages=[{"role": "user", "content": "hello"}], max_tokens=3)).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(request, timeout=60) as response:
                assert json.loads(response.read())["choices"]
        pinned = sorted(slot.session_id for slot in service.engine.slots if slot.session_id)
        assert pinned == ["s-1", "u-7", "u-8"]
    finally:
        api.stop()
        service.engine.stop()
