"""Self-healing serving in the port, held to the JAX package on the CPU:
the fault registry, the engine supervisor with bitwise session
resurrection, admission-deadline shedding, the watchdog's escalation,
the typed 503 with ``Retry-After`` and ``/metrics``.

Mirrors ``tests/test_recovery.py`` case by case, on the same tiny config
(``LlamaConfig.tiny(max_seq_len=512)``, 4 slots, buckets [16, 32], decode
chunk 4, seed 11) and sampling. Where the JAX test compares a crashed and
resumed stream with an uncrashed oracle, three streams must agree token
for token and logprob for logprob within 1e-5 (f32): the port's crashed
and resumed one, the port's uncrashed oracle and the JAX engine's
uncrashed oracle on the same converted weights."""

import asyncio
import concurrent.futures
import json
import threading
import time
import urllib.error
import urllib.request
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from langstream_tpu.api import metrics as jax_metrics
from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.runtime import faults as jax_faults
from langstream_tpu.runtime import supervisor as jax_supervisor
from langstream_tpu.runtime import watchdog as jax_watchdog
from langstream_tpu_torch.api import errors as api_errors
from langstream_tpu_torch.api import metrics
from langstream_tpu_torch.providers.torch_local import engine, model
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax
from langstream_tpu_torch.providers.torch_local.graphs import StepRunner, Variant
from langstream_tpu_torch.providers.torch_local.paged import PagedKVManager
from langstream_tpu_torch.runtime import faults, flight, supervisor, watchdog
from langstream_tpu_torch.runtime.supervisor import EngineSupervisor
from langstream_tpu_torch.runtime.watchdog import EngineWatchdog
from langstream_tpu_torch.serving.openai_api import OpenAIApiServer

torch.set_num_threads(2)

LOGPROB_TOLERANCE = 1e-5


@pytest.fixture(autouse=True)
def _clean_faults():
    """Every test starts and ends disarmed with zeroed arrival counters,
    in both registries (each is process-global by design)."""
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


@pytest.fixture()
def flight_recorder(tmp_path):
    saved = flight.RECORDER.path
    flight.RECORDER.path = None
    flight.RECORDER._pending.clear()
    path = flight.configure(str(tmp_path / "flight"))
    yield path
    flight.RECORDER.flush()
    flight.RECORDER.path = saved


# ---------------------------------------------------------------------- #
# fault registry (runtime/faults.py)
# ---------------------------------------------------------------------- #
def test_fault_spec_parsing_and_describe():
    text = "engine_thread_crash@step=40,dispatch_error@step=7:1.0,stuck_step@step=5;dur=45"
    specs = faults.parse_spec(text)
    assert [s.point for s in specs] == ["engine_thread_crash", "dispatch_error", "stuck_step"]
    assert specs[0].step == 40 and specs[0].prob is None
    assert specs[1].prob == 1.0
    assert specs[2].params == {"dur": "45"}
    assert specs[2].describe() == "stuck_step@step=5;dur=45"
    assert [s.describe() for s in specs] == [s.describe() for s in jax_faults.parse_spec(text)]
    for bad in ("nope", "x@stop=3", "x@step=abc", "x@step=1:1.5"):
        with pytest.raises(ValueError):
            faults.parse_spec(bad)


def test_one_shot_fires_exactly_once():
    faults.configure("p@step=3")
    fired = [bool(faults.fire("p")) for _ in range(6)]
    assert fired == [False, False, True, False, False, False]
    # a rebuilt engine passing the point again does NOT fire it again:
    # the arrival counters are process-global for the registry's life
    with pytest.raises(faults.InjectedFault):
        faults.configure("q@step=1")
        faults.check("q")
    faults.check("q")  # consumed


def test_probabilistic_faults_are_deterministic():
    faults.configure("p@step=2:0.5", seed=7)
    first = [bool(faults.fire("p")) for _ in range(64)]
    assert not first[0]  # armed only from step 2
    assert any(first) and not all(first)
    faults.reset()
    faults.configure("p@step=2:0.5", seed=7)
    assert [bool(faults.fire("p")) for _ in range(64)] == first
    faults.reset()
    faults.configure("p@step=2:1.0", seed=7)
    assert [bool(faults.fire("p")) for _ in range(4)] == [False, True, True, True]


@pytest.mark.parametrize("spec,seed", [
    ("p@step=2:0.5", 7),
    ("p@step=1:0.25", 0),
    ("p@step=5:0.9;dur=1", 123456),
    ("p@step=3", 0),
    ("p@step=2:0.5,q@step=4:0.3", 99),
])
def test_firing_sequence_equals_the_jax_registry(spec, seed):
    """The same spec and seed fire at the same arrivals in both packages
    (sha256 over point, arrival and seed), point by point."""
    faults.configure(spec, seed=seed)
    jax_faults.configure(spec, seed=seed)
    for point in ("p", "q"):
        port = [faults.fire(point) is not None for _ in range(200)]
        reference = [jax_faults.fire(point) is not None for _ in range(200)]
        assert port == reference, (spec, point)


def test_unarmed_registry_is_inert_and_cheap():
    assert not faults.armed()
    assert faults.fire("anything") is None
    faults.check("anything")  # no raise
    assert faults.maybe_sleep("anything") == 0.0


def test_stuck_step_sleeps_for_configured_duration():
    faults.configure("stuck_step@step=1;dur=0.05")
    started = time.perf_counter()
    slept = faults.maybe_sleep("stuck_step")
    assert slept == pytest.approx(0.05)
    assert time.perf_counter() - started >= 0.04


def test_pool_exhausted_fault_point():
    manager = PagedKVManager(num_blocks=8, block_size=4)
    faults.configure("pool_exhausted@step=1")
    assert manager.allocate(2) is None  # injected exhaustion, no state
    fresh = manager.allocate(2)         # one-shot consumed
    assert fresh is not None and len(fresh) == 2


def test_env_arming(monkeypatch):
    monkeypatch.setenv("LANGSTREAM_FAULTS", "engine_thread_crash@step=9")
    faults.configure_from_env()
    assert faults.armed()
    assert "engine_thread_crash" in faults.REGISTRY.describe()


# ---------------------------------------------------------------------- #
# crash → rebuild → bitwise resurrection
# ---------------------------------------------------------------------- #
ENGINE_ARGS = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 32], decode_chunk=4, seed=11)
GREEDY = dict(max_new_tokens=20)
SEEDED = dict(max_new_tokens=20, temperature=0.9, top_k=8, top_p=0.9, seed=1234,
              presence_penalty=0.4, frequency_penalty=0.25)
PAGED = dict(max_seq_len=512, prefill_buckets=[16, 32, 64, 128, 256], kv_layout="paged",
             kv_block_size=16)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=512)
    jparams = jax_model.init_params(jcfg)
    tcfg = model.LlamaConfig.tiny(max_seq_len=512)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)
    return jcfg, jparams, tcfg, tparams


def _factory(tiny, **overrides):
    _, _, tcfg, tparams = tiny
    kwargs = dict(ENGINE_ARGS, **overrides)
    return lambda: engine.DecodeEngine(tcfg, tparams, device="cpu", **kwargs)


def _run(eng, prompt, sampling, **kw):
    lib = jax_engine if isinstance(eng, jax_engine.DecodeEngine) else engine

    async def main():
        return await eng.generate(list(prompt), lib.SamplingParams(**sampling), **kw)

    return asyncio.run(main())


def _run_many(eng, jobs):
    lib = jax_engine if isinstance(eng, jax_engine.DecodeEngine) else engine

    async def main():
        return await asyncio.gather(*(
            eng.generate(list(prompt), lib.SamplingParams(**sampling)) for prompt, sampling in jobs))

    return asyncio.run(main())


def _jax_oracle(tiny, jobs, **overrides):
    """The JAX engine's uncrashed results of ``jobs`` on the same weights
    (its paged attention through the reference composition on the CPU)."""
    jcfg, jparams, _, _ = tiny
    kwargs = dict(ENGINE_ARGS, **overrides)
    if kwargs.get("kv_layout") == "paged":
        kwargs["paged_kernel"] = "reference"
    eng = jax_engine.DecodeEngine(jcfg, jparams, **kwargs)
    eng.start()
    try:
        return _run_many(eng, jobs)
    finally:
        eng.stop()


def _port_oracle(tiny, jobs, **overrides):
    eng = _factory(tiny, **overrides)()
    eng.start()
    try:
        return _run_many(eng, jobs)
    finally:
        eng.stop()


def _assert_same(got, *wants):
    for want in wants:
        assert got.tokens == want.tokens
        assert got.finish_reason == want.finish_reason
        np.testing.assert_allclose(got.logprobs, want.logprobs, rtol=0, atol=LOGPROB_TOLERANCE)


MIXED = dict(kv_layout="paged", kv_block_size=8, prefill_mode="mixed", prefill_chunk=16)
# (id, engine overrides, prompt, sampling, crash step): the crash cases held
# three ways. The mixed prompt takes 3 mixed steps to admit: its crash
# comes after 2 decode chunks, and its replay rides mixed steps again
CRASH_CASES = [
    ("dense-greedy", {}, [1, 2, 3, 4, 5], GREEDY, 2),
    ("dense-seeded", {}, [1, 2, 3, 4, 5], SEEDED, 2),
    ("dense-pipelined-greedy", dict(pipeline_decode=True), [1, 2, 3, 4, 5], GREEDY, 2),
    ("dense-pipelined-seeded", dict(pipeline_decode=True), [1, 2, 3, 4, 5], SEEDED, 2),
    ("dense-int8kv-seeded", dict(kv_quant="int8"), [1, 2, 3, 4, 5], SEEDED, 2),
    ("mixed-seeded", MIXED, list(range(3, 40)), SEEDED, 5),
    ("mixed-pipelined-greedy", dict(MIXED, pipeline_decode=True), list(range(3, 40)), GREEDY, 5),
]


@pytest.mark.parametrize("overrides,prompt,sampling,step", [c[1:] for c in CRASH_CASES],
                         ids=[c[0] for c in CRASH_CASES])
def test_crash_mid_decode_resumes_bitwise_dense(tiny, overrides, prompt, sampling, step,
                                                flight_recorder):
    """A session killed mid-decode (the engine thread dies after its 2nd
    chunk) resumes on a rebuilt engine: its full output equals the
    port's uncrashed oracle and the JAX engine's, and its stream saw each
    token exactly once."""
    expected = _port_oracle(tiny, [(prompt, sampling)], **overrides)[0]
    reference = _jax_oracle(tiny, [(prompt, sampling)], **overrides)[0]
    assert len(expected.tokens) == sampling["max_new_tokens"]
    faults.configure(f"engine_thread_crash@step={step}")
    sup = EngineSupervisor(_factory(tiny, **overrides))
    first_engine = sup.engine
    streamed = []
    try:
        result = _run(sup.engine, prompt, sampling, on_token=lambda token, last: streamed.append(token))
        assert sup.restarts == 1 and sup.state == "serving"
        assert sup.engine is not first_engine
        _assert_same(result, expected, reference)
        assert result.prompt_tokens == len(prompt)
        # the pre-crash tokens from the dead engine, the continuation from
        # the rebuilt one: replayed tokens are never emitted again
        asyncio.run(asyncio.sleep(0))
        assert streamed == expected.tokens
        assert sup.engine.stats["tokens_wasted"].get("crash_replay", 0) > 0
        # the dead engine's device state went before the rebuild
        assert first_engine.cache == {} and first_engine._counts is None
        assert not first_engine.steps._entries
    finally:
        sup.stop()


def test_crash_spares_no_session_and_seeds_survive_together(tiny):
    """Two concurrent sessions, one crash: both resume bitwise (no
    in-flight session fails), against both oracles."""
    jobs = [([1, 2, 3, 4, 5], GREEDY), ([9, 8, 7], SEEDED)]
    expected = _port_oracle(tiny, jobs)
    reference = _jax_oracle(tiny, jobs)
    faults.configure("engine_thread_crash@step=2")
    sup = EngineSupervisor(_factory(tiny))
    try:
        results = _run_many(sup.engine, jobs)
        assert sup.restarts == 1
        for got, want, ref in zip(results, expected, reference):
            _assert_same(got, want, ref)
    finally:
        sup.stop()


@pytest.mark.parametrize("pipelined", [False, True], ids=["serial", "pipelined"])
def test_crash_resumes_bitwise_paged_across_block_boundary(tiny, pipelined, flight_recorder):
    """Paged layout: the replay prefill ends mid-block (300 prompt + 9
    accepted - 1 = 308 tokens, 308 % 16 == 4), the rebuilt pool learns it
    through a cold prefill, and the continuation equals both oracles.
    Then a prompt sharing a ≥256-token prefix with the resurrected session
    hits the rebuilt engine's prefix cache."""
    prompt = [(i * 7) % 250 + 1 for i in range(300)]
    overrides = dict(PAGED, pipeline_decode=pipelined)
    jobs = [(prompt, GREEDY), (prompt, SEEDED)]
    expected = [_port_oracle(tiny, [job], **overrides)[0] for job in jobs]
    reference = [_jax_oracle(tiny, [job], **overrides)[0] for job in jobs]
    for (_, sampling), want, ref in zip(jobs, expected, reference):
        faults.reset()
        faults.configure("engine_thread_crash@step=2")
        sup = EngineSupervisor(_factory(tiny, **overrides))
        try:
            result = _run(sup.engine, prompt, sampling)
            assert sup.restarts == 1
            _assert_same(result, want, ref)
            eng = sup.engine
            assert eng.stats["tokens_wasted"].get("crash_replay", 0) > 0
            if sampling is GREEDY:
                before = eng.kv_manager.stats["hit_tokens"]
                follow = _run(eng, prompt + [33, 34], GREEDY)
                assert len(follow.tokens) == GREEDY["max_new_tokens"]
                assert eng.kv_manager.stats["hit_tokens"] - before >= 256
        finally:
            sup.stop()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_crash_resumes_bitwise_with_spec_decode(tiny, layout):
    """Speculative decoding on: accepted drafts are part of the replay
    state, and the resumed spec engine continues bitwise."""
    prompt = [5, 6, 7, 8] * 6  # repetition for the prompt-lookup drafter
    overrides = dict(spec_decode="ngram", spec_k=3, spec_ngram=2, decode_chunk=2)
    if layout == "paged":
        overrides.update(kv_layout="paged", kv_block_size=8)
    expected = _port_oracle(tiny, [(prompt, GREEDY)], **overrides)[0]
    reference = _jax_oracle(tiny, [(prompt, GREEDY)], **overrides)[0]
    faults.configure("engine_thread_crash@step=2")
    sup = EngineSupervisor(_factory(tiny, **overrides))
    try:
        result = _run(sup.engine, prompt, GREEDY)
        assert sup.restarts == 1
        _assert_same(result, expected, reference)
    finally:
        sup.stop()


def test_recovery_evidence_metrics_flight_trace(tiny, flight_recorder):
    """Every plane carries the recovery: the snapshot gauges, the
    recovery-seconds histogram, flight events and the trace span."""
    faults.configure("engine_thread_crash@step=1")
    sup = EngineSupervisor(_factory(tiny))

    class SpanRecorder:
        enabled = True
        events = []

        def event(self, name, duration_s, **kw):
            self.events.append((name, duration_s, kw))

    sup.tracer = SpanRecorder()
    try:
        result = _run(sup.engine, [1, 2, 3], GREEDY)
        assert len(result.tokens) == GREEDY["max_new_tokens"]
        assert sup.restarts == 1
        gauges = engine.engines_snapshot()
        assert gauges["engine_restarts_total"] >= 1.0
        assert gauges["sessions_resurrected_total"] >= 1.0
        assert gauges["engine_degraded"] == 0.0
        assert 'torch_engine_tokens_wasted_total{reason="crash_replay"}' in gauges
        assert engine.engines_histograms()["engine_recovery_seconds"]["count"] >= 1
        spans = [e for e in SpanRecorder.events if e[0] == "engine.recovery"]
        assert spans and spans[0][2]["sessions"] == 1
        flight.flush()
        records = flight.read_artifact(flight_recorder)
        kinds = [e["kind"] for e in records]
        for kind in ("fault_injected", "engine_crash", "engine_recovery", "session_resume"):
            assert kind in kinds, kinds
        phases = [e.get("phase") for e in records if e["kind"] == "engine_recovery"]
        assert "begin" in phases and "complete" in phases
    finally:
        sup.stop()


def test_degraded_mode_is_typed_503_not_500(tiny):
    """While rebuilding, submits raise the typed retryable error."""
    sup = EngineSupervisor(_factory(tiny))
    eng = sup.engine
    sup.state = "rebuilding"
    eng._crashed = RuntimeError("boom")
    try:
        with pytest.raises(api_errors.EngineRebuildingError) as info:
            eng.submit(engine.GenerationRequest(prompt_tokens=[1], sampling=engine.SamplingParams()))
        assert info.value.retry_after_s > 0
        assert engine.engines_snapshot()["engine_degraded"] == 1.0
    finally:
        eng._crashed = None
        sup.state = "serving"
        sup.stop()


def test_restart_budget_gives_up(tiny):
    """A crash on every chunk: the second restart passes max_restarts=1
    and the supervisor fails the waiter with a plain error, terminally."""
    faults.configure("engine_thread_crash@step=1:1.0")
    sup = EngineSupervisor(_factory(tiny), max_restarts=1)
    with pytest.raises(RuntimeError, match="giving up"):
        _run(sup.engine, [1, 2, 3], GREEDY)
    assert sup.state == "failed"
    with pytest.raises(RuntimeError, match="crashed") as info:
        sup.engine.submit(engine.GenerationRequest(prompt_tokens=[1], sampling=engine.SamplingParams()))
    assert not isinstance(info.value, api_errors.UnavailableError)


# ---------------------------------------------------------------------- #
# admission deadlines / load shedding
# ---------------------------------------------------------------------- #
def _shed_scenario(eng):
    """A hog owns the only slot; a second request waits past the deadline
    and is shed with the typed error."""
    lib = jax_engine if isinstance(eng, jax_engine.DecodeEngine) else engine

    async def main():
        hog = asyncio.ensure_future(eng.generate([1, 2, 3], lib.SamplingParams(max_new_tokens=64)))
        while not eng.stats["tokens_generated"]:
            await asyncio.sleep(0.005)  # the hog owns the only slot
        starved = asyncio.ensure_future(eng.generate([4, 5, 6], lib.SamplingParams(max_new_tokens=4)))
        with pytest.raises(Exception) as info:
            await starved
        await hog
        return info.value

    return asyncio.run(main())


def test_queue_deadline_sheds_with_retry_after(tiny, flight_recorder):
    _, _, tcfg, tparams = tiny
    eng = engine.DecodeEngine(tcfg, tparams, device="cpu", max_slots=1, max_seq_len=128,
                              prefill_buckets=[16], decode_chunk=2, queue_timeout_s=0.02)
    eng.start()
    try:
        error = _shed_scenario(eng)
        assert isinstance(error, api_errors.QueueTimeoutError)
        assert error.retry_after_s >= 1.0
        assert eng.stats["requests_shed"] == {"queue_timeout": 1}
        assert engine.engines_snapshot()['requests_shed_total{reason="queue_timeout"}'] >= 1.0
        flight.flush()
        sheds = [e for e in flight.read_artifact(flight_recorder) if e["kind"] == "request_shed"]
        assert sheds and sheds[0]["reason"] == "queue_timeout"
    finally:
        eng.stop()


# ---------------------------------------------------------------------- #
# watchdog escalation
# ---------------------------------------------------------------------- #
def _stalled_engine():
    return SimpleNamespace(
        stats={"decode_chunks": 0, "decode_steps": 0, "decode_token_steps": 0.0,
               "decode_time": 0.0, "prefill_calls": 0, "warm_prefill_calls": 0},
        slots=[SimpleNamespace(active=True)], _pending=[], kv_manager=None)


def test_watchdog_escalates_after_n_trips_within_window():
    """Three no-progress trips past the cooldown escalate once a window,
    as the JAX watchdog does on the same clock."""
    seen = {}
    for name, cls in (("port", EngineWatchdog), ("jax", jax_watchdog.EngineWatchdog)):
        dog = cls(_stalled_engine(), no_progress_s=10.0, trip_cooldown_s=5.0, capture_profile=False,
                  escalate_trips=3, escalate_window_s=100.0)
        escalations = []
        dog.on_escalate = escalations.append
        now = 1000.0
        reasons = [dog.check(now=now)]  # anchors the stall
        for _ in range(4):
            now += 15.0
            reasons.append(dog.check(now=now))
        seen[name] = (reasons, escalations, dog.trips)
    reasons, escalations, trips = seen["port"]
    assert reasons == [None] + ["no_progress"] * 4
    assert escalations == ["watchdog_escalation:no_progress"]
    assert trips == 4
    assert seen["port"] == seen["jax"]


def test_watchdog_reads_the_engines_stats():
    """The watchdog's inputs exist on the port's engine under the JAX
    engine's names, and a healthy engine does not trip."""
    cfg = model.LlamaConfig.tiny(max_seq_len=64)
    eng = engine.DecodeEngine(cfg, model.init_params(cfg, seed=0, device="cpu"), device="cpu",
                              max_slots=2, prefill_buckets=[16], decode_chunk=4)
    dog = EngineWatchdog(eng, capture_profile=False, no_progress_s=0.0, min_baseline_chunks=1)
    assert dog.check(now=0.0) is None
    eng.start()
    try:
        _run(eng, [1, 2, 3], dict(max_new_tokens=9))
        assert eng.stats["decode_chunks"] >= 2 and eng.stats["decode_token_steps"] == eng.stats["decode_steps"]
        assert dog.check(now=1.0) is None
    finally:
        eng.stop()


def test_escalation_restart_resurrects_live_session(tiny):
    """The supervisor's second detection arm: a restart request on a live
    engine tears it down and resumes the in-flight session bitwise."""
    expected = _port_oracle(tiny, [([2, 4, 6, 8], GREEDY)])[0]
    reference = _jax_oracle(tiny, [([2, 4, 6, 8], GREEDY)])[0]
    sup = EngineSupervisor(_factory(tiny))
    first_engine = sup.engine

    async def main():
        task = asyncio.ensure_future(sup.engine.generate([2, 4, 6, 8], engine.SamplingParams(**GREEDY)))
        while not first_engine.stats["tokens_generated"]:
            await asyncio.sleep(0.005)
        await asyncio.to_thread(sup.request_restart, "watchdog_escalation:test")
        return await task

    try:
        result = asyncio.run(main())
        assert sup.restarts == 1 and sup.engine is not first_engine
        _assert_same(result, expected, reference)
    finally:
        sup.stop()


def test_watchdog_escalation_of_a_wedged_step_resurrects_and_the_zombie_stays_silent(tiny):
    """``stuck_step`` wedges the engine thread; the real watchdog thread
    (thresholds cut short) trips, escalates, and the supervisor condemns
    the engine. Its thread outlives the join and, when it wakes, launches
    and emits nothing: the session resumes on the rebuilt engine, bitwise,
    every token streamed once."""
    expected = _port_oracle(tiny, [([3, 1, 4, 1, 5], GREEDY)])[0]
    faults.configure("stuck_step@step=3;dur=2.5")

    def dog(eng):
        return EngineWatchdog(eng, interval=0.05, no_progress_s=0.5, trip_cooldown_s=0.1,
                              capture_profile=False, escalate_trips=2, escalate_window_s=60.0)

    sup = EngineSupervisor(_factory(tiny), watchdog_factory=dog)
    first_engine = sup.engine
    streamed = []
    joins = []
    original_join = threading.Thread.join

    def short_join(self, timeout=None):  # the 10 s join, cut to 0.2 s
        joins.append(timeout)
        return original_join(self, 0.2 if timeout == 10.0 else timeout)

    try:
        threading.Thread.join = short_join
        result = _run(sup.engine, [3, 1, 4, 1, 5], GREEDY,
                      on_token=lambda token, last: streamed.append(token))
    finally:
        threading.Thread.join = original_join
    try:
        assert sup.restarts == 1 and sup.engine is not first_engine and 10.0 in joins
        generated = first_engine.stats["tokens_generated"]
        zombie = first_engine._thread
        zombie.join(5.0)
        assert not zombie.is_alive()
        assert first_engine.stats["tokens_generated"] == generated  # silent after condemnation
        _assert_same(result, expected)
        assert streamed == expected.tokens
    finally:
        sup.stop()


# ---------------------------------------------------------------------- #
# the OpenAI surface: 503 + Retry-After, sibling errors, /metrics
# ---------------------------------------------------------------------- #
def _post(port, path, payload):
    request = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=60) as response:
            return response.status, dict(response.headers), response.read().decode()
    except urllib.error.HTTPError as error:
        return error.code, dict(error.headers), error.read().decode()


def _serving(service, **kw):
    server = OpenAIApiServer(service, model="tiny", host="127.0.0.1", port=0, **kw)
    server.start()
    return server


def test_api_answers_503_with_retry_after_while_rebuilding():
    class Rebuilding:
        def available(self):
            return 3.0

        async def get_chat_completions(self, *a, **k):  # pragma: no cover
            raise AssertionError("must be gated before the service")

    server = _serving(Rebuilding())
    try:
        for path, stream in (("/v1/chat/completions", False), ("/v1/chat/completions", True),
                             ("/v1/completions", False), ("/v1/completions", True)):
            body = {"stream": stream}
            body.update({"messages": [{"role": "user", "content": "hi"}]} if "chat" in path
                        else {"prompt": "hi"})
            status, headers, raw = _post(server.port, path, body)
            assert status == 503 and headers["Retry-After"] == "3", (path, stream)
            assert "rebuilding" in json.loads(raw)["error"]["message"]
    finally:
        server.stop()


def test_sibling_cancel_race_propagates_first_real_error():
    """With n > 1, when the first exception gather surfaces is a
    sibling's cancellation, the other sibling's real typed error reaches
    the client: a 503 with Retry-After from a fault-injected dispatch
    error, not a dropped connection."""
    faults.configure("dispatch_error@step=1")

    class Racy:
        calls = 0

        async def get_chat_completions(self, messages, options, consumer=None):
            Racy.calls += 1
            if Racy.calls == 1:
                await asyncio.sleep(0.01)
                raise asyncio.CancelledError()
            await asyncio.sleep(0.05)
            try:
                faults.check("dispatch_error")  # the first arrival fires
            except faults.InjectedFault as fault:
                raise api_errors.QueueTimeoutError(f"dispatch failed: {fault}", retry_after_s=2.0) from fault
            raise AssertionError("the fault should have fired")

    server = _serving(Racy())
    try:
        status, headers, raw = _post(server.port, "/v1/chat/completions",
                                     {"messages": [{"role": "user", "content": "hi"}], "n": 2})
        assert status == 503, raw
        assert headers["Retry-After"] == "2"
        assert "dispatch failed" in json.loads(raw)["error"]["message"]
    finally:
        server.stop()


def test_provider_surfaces_rebuild_as_typed_unavailable():
    """The service's available() and its pre-generate gate: a rebuilding
    supervisor turns new work into the typed retryable error; the
    supervisor is on by default and queue-timeout-s reaches the engine."""
    from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService

    service = TorchCompletionsService({
        "model": {"preset": "tiny", "max_seq_len": 128},
        "engine": {"max-slots": 2, "max-seq-len": 128, "queue-timeout-s": 30},
    }, device="cpu")
    try:
        assert service.supervisor is not None  # on by default
        assert service.available() is None
        service.supervisor.state = "rebuilding"
        assert service.available() == pytest.approx(service.supervisor.retry_after())
        with pytest.raises(api_errors.EngineRebuildingError):
            asyncio.run(service.get_text_completions(["hi"], {"max-tokens": 4}))
        service.supervisor.state = "serving"
        assert service.engine.queue_timeout_s == 30.0
    finally:
        service.close()


def test_shed_answers_503_streamed_and_not(tiny):
    """A request shed at its queue deadline answers 503 with Retry-After
    over HTTP, a stream too (its SSE headers wait for its first delta),
    while the request holding the slot answers 200."""
    from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService

    service = TorchCompletionsService({
        "model": {"preset": "tiny", "max_seq_len": 128},
        "engine": {"max-slots": 1, "max-seq-len": 128, "decode-chunk": 2, "prefill-buckets": [32],
                   "queue-timeout-s": 0.05},
    }, device="cpu")
    server = _serving(service)
    hog_body = {"prompt": "hold the slot", "max_tokens": 120}
    try:
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            hog = pool.submit(_post, server.port, "/v1/completions", hog_body)
            while not service.engine.stats["tokens_generated"]:
                time.sleep(0.005)
            shed = [pool.submit(_post, server.port, "/v1/completions", {"prompt": "a", "max_tokens": 2}),
                    pool.submit(_post, server.port, "/v1/chat/completions", {
                        "messages": [{"role": "user", "content": "b"}], "max_tokens": 2, "stream": True})]
            replies = [job.result(timeout=120) for job in shed]
            assert hog.result(timeout=120)[0] == 200
        for status, headers, raw in replies:
            assert status == 503 and int(headers["Retry-After"]) >= 1, raw
            assert "queue timeout" in json.loads(raw)["error"]["message"]
        assert service.engine.stats["requests_shed"] == {"queue_timeout": 2}
    finally:
        server.stop()
        service.close()


RECOVERY_FAMILIES = ("engine_restarts_total", "sessions_resurrected_total", "engine_degraded",
                     "watchdog_trips_total", "requests_shed_total", "engine_recovery_seconds_count")


def _families(text):
    parsed = jax_metrics.parse_prometheus_text(text)
    samples = {name: sorted((tuple(sorted(labels.items())), value) for labels, value in rows)
               for name, rows in parsed.items() if name in RECOVERY_FAMILIES}
    types = sorted(line for line in text.splitlines() if line.startswith("# TYPE ")
                   and line.split()[2] in RECOVERY_FAMILIES + ("engine_recovery_seconds",))
    buckets = sorted(labels["le"] for labels, _ in parsed.get("engine_recovery_seconds_bucket", []))
    return samples, types, buckets


def test_metrics_route_series_equal_the_jax_servers(tiny, monkeypatch):
    """After one crash (one session resurrected), one shed and one
    watchdog trip, the port's ``/metrics`` renders the recovery, shedding
    and watchdog series with the names, types and values the JAX
    package's ``prometheus_text`` gives for the same events (the recovery
    histogram by its count and buckets: its seconds differ)."""
    jcfg, jparams, tcfg, tparams = tiny
    # fresh process-wide series and live sets on both sides, so other
    # tests' engines and events do not count
    for module in (supervisor, jax_supervisor):
        monkeypatch.setattr(module, "ENGINE_RESTARTS", metrics.Counter("engine_restarts_total"))
        monkeypatch.setattr(module, "SESSIONS_RESURRECTED", metrics.Counter("sessions_resurrected_total"))
        monkeypatch.setattr(module, "RECOVERY_SECONDS", metrics.Histogram(
            "engine_recovery_seconds", buckets=module.RECOVERY_SECONDS.buckets))
        monkeypatch.setattr(module, "_ACTIVE", weakref.WeakSet())
    for module in (watchdog, jax_watchdog):
        monkeypatch.setattr(module, "TRIPS", metrics.Counter("watchdog_trips_total"))
    monkeypatch.setattr(engine, "_LIVE_ENGINES", weakref.WeakSet())
    monkeypatch.setattr(jax_engine, "_LIVE_ENGINES", weakref.WeakSet())
    kept = []
    for side in ("port", "jax"):
        faults.reset()
        jax_faults.reset()
        if side == "port":
            faults.configure("engine_thread_crash@step=2")
            sup = EngineSupervisor(_factory(tiny))
            shedder = engine.DecodeEngine(tcfg, tparams, device="cpu", max_slots=1, max_seq_len=128,
                                          prefill_buckets=[16], decode_chunk=2, queue_timeout_s=0.02)
            dog = EngineWatchdog(_stalled_engine(), no_progress_s=1.0, capture_profile=False)
        else:
            jax_faults.configure("engine_thread_crash@step=2")
            sup = jax_supervisor.EngineSupervisor(
                lambda: jax_engine.DecodeEngine(jcfg, jparams, **ENGINE_ARGS))
            shedder = jax_engine.DecodeEngine(jcfg, jparams, max_slots=1, max_seq_len=128,
                                              prefill_buckets=[16], decode_chunk=2, queue_timeout_s=0.02)
            dog = jax_watchdog.EngineWatchdog(_stalled_engine(), no_progress_s=1.0, capture_profile=False)
        _run(sup.engine, [1, 2, 3, 4, 5], GREEDY)
        assert sup.restarts == 1
        shedder.start()
        assert "queue" in str(_shed_scenario(shedder))
        dog.check(now=0.0)
        assert dog.check(now=2.0) == "no_progress"
        kept.append((sup, shedder))
    try:
        server = _serving(None, gauges=engine.engines_snapshot, histograms=engine.engines_histograms)
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=30) as response:
                port_text = response.read().decode()
        finally:
            server.stop()
        jax_text = jax_metrics.prometheus_text({}, jax_engine.engines_snapshot(),
                                               jax_engine.engines_histograms())
        port_families, jax_families = _families(port_text), _families(jax_text)
        assert port_families == jax_families
        samples = port_families[0]
        assert samples["engine_restarts_total"] == [((), 1.0)]
        assert samples["sessions_resurrected_total"] == [((), 1.0)]
        assert samples["watchdog_trips_total"] == [((), 1.0)]
        assert samples["requests_shed_total"] == [((("reason", "queue_timeout"),), 1.0)]
        assert samples["engine_recovery_seconds_count"] == [((), 1.0)]
        assert 'torch_engine_tokens_wasted_total{reason="crash_replay"}' in port_text
    finally:
        for sup, shedder in kept:
            sup.stop()
            shedder.stop()


def test_recovery_span_dumps_and_the_profiler_writes_a_chrome_trace(tmp_path, monkeypatch):
    """With ``LANGSTREAM_TRACE_DIR`` set, the engine tracer's
    ``engine.recovery`` span lands in a Chrome trace dump; the watchdog's
    ``capture`` (``torch.profiler``) writes a Chrome trace, one capture at
    a time."""
    from langstream_tpu_torch.runtime import tracing

    monkeypatch.setenv("LANGSTREAM_TRACE_DIR", str(tmp_path / "traces"))
    monkeypatch.setattr(tracing, "_TRACERS", {})
    tracer = tracing.get_tracer("engine")
    assert tracer.enabled and tracing.get_tracer("engine") is tracer
    tracer.event("engine.recovery", 0.25, sessions=3, replayed=2)
    (path,) = tracing.dump_all()
    with open(path) as handle:
        (span,) = json.load(handle)["traceEvents"]
    assert span["name"] == "engine.recovery" and span["dur"] == 250000.0
    assert span["args"]["sessions"] == 3
    directory = tracing.capture(0.05, base_dir=str(tmp_path / "profiles"))
    with open(f"{directory}/trace.json") as handle:
        assert "traceEvents" in json.load(handle)
    with tracing.PROFILE_LOCK, pytest.raises(tracing.ProfileBusyError):
        tracing.capture(0.05, base_dir=str(tmp_path / "profiles"))


# ---------------------------------------------------------------------- #
# the heal arc's device state
# ---------------------------------------------------------------------- #
def test_step_runner_release_drops_every_variant():
    """``release`` empties the runner (graphs reset on the card, static
    buffers freed); a later run captures afresh."""
    runner = StepRunner(torch.device("cpu"), graphs=True,
                        body=lambda key: (lambda x: {"y": x["x"] * 2}),
                        dummy=lambda key: {"x": np.zeros((2,), dtype=np.float32)})
    key = Variant("decode", 1, "greedy")
    _, out = runner.run(key, {"x": np.ones((2,), dtype=np.float32)})
    assert out["y"].tolist() == [2.0, 2.0] and runner.stats["captured"] == 1
    runner.release()
    assert not runner._entries
    _, out = runner.run(key, {"x": np.full((2,), 3, dtype=np.float32)})
    assert out["y"].tolist() == [6.0, 6.0] and runner.stats["captured"] == 2


def test_drained_engine_fails_late_submits_typed(tiny):
    """After the recovery drain swept its queue, a retired engine fails a
    late submit (that lost the race against the crash flag) with the
    typed retryable error instead of leaving it hanging."""
    eng = _factory(tiny)()
    eng.on_crash = lambda error: None
    eng.drain_for_recovery()
    future = concurrent.futures.Future()
    request = engine.GenerationRequest(prompt_tokens=[1, 2], sampling=engine.SamplingParams(),
                                       future=future)
    eng._queue.put(request)  # the put that lands after the crash flag
    eng._crashed = RuntimeError("crashed")
    eng._fail_stragglers()
    with pytest.raises(api_errors.EngineRebuildingError):
        future.result(timeout=5)
