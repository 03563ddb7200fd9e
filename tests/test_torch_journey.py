"""Request journeys, trace ids, the flight artifact's digests and
``/debug/profile`` in the port, held to the JAX package on the CPU.

Each scenario runs on the port's engine and the JAX engine with the same
weights and requests, each request tagged with a trace id, and each
package's flight recorder writing its own artifact: sessions (a cold
turn, a warm follow-up, a sessionless prompt onto the first one's prefix;
dense and paged), the host tier (a prompt demoted under pressure and
promoted back, as ``tests/test_torch_kv_tiers.py`` runs it) and the KV
handoff (an exported prefill leg and its imported decode leg, as
``tests/test_torch_disagg.py`` runs it). Every port journey tiles its
request's wall clock (no overlap, no negative stage, no gap but the one
the JAX engine leaves between an import and its admission) and each
request's admission class equals the JAX engine's, stage names included.
``python -m langstream_tpu_torch journey`` and the JAX ``run_journey``
print the same lines over a port artifact; ``tools/ab_analyze.py``,
unchanged, digests a port artifact into its efficiency and journey
lines; the server's trace id reaches the journey records; and
``/debug/profile`` answers 400, 409 and a capture on the CPU."""

import asyncio
import contextlib
import io
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.runtime import flight as jax_flight
from langstream_tpu.runtime import journey as jax_journey
from langstream_tpu_torch.cli.main import build_parser, main, start_server
from langstream_tpu_torch.providers.torch_local import engine, model
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax
from langstream_tpu_torch.runtime import flight, journey, tracing
from langstream_tpu_torch.serving.openai_api import OpenAIApiServer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 32, 64], decode_chunk=4, seed=7)
PAGED = dict(kv_layout="paged", kv_block_size=8)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=128)
    tcfg = model.LlamaConfig.tiny(max_seq_len=128)
    jparams = jax_model.init_params(jcfg, seed=3)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture
def recorders(tmp_path):
    """Both packages' flight recorders, each writing a fresh artifact under
    ``tmp_path/<package>/flight``; restored after the test."""
    saved = [(module, module.RECORDER.path) for module in (flight, jax_flight)]
    paths = {}
    for package, module in (("port", flight), ("jax", jax_flight)):
        module.RECORDER.path = None
        module.RECORDER._pending.clear()
        paths[package] = module.configure(str(tmp_path / package / "flight"))
    yield paths
    for module, path in saved:
        module.RECORDER.flush()
        module.RECORDER.path = path


def _journeys(package, recorders):
    """The artifact's journey records by trace id."""
    module = flight if package == "port" else jax_flight
    module.flush()
    return {record["trace_id"]: record for record in module.read_artifact(recorders[package])
            if record.get("kind") == "journey"}


def _engine(weights, package, **kwargs):
    jcfg, jparams, tcfg, tparams = weights
    args = dict(ARGS, **kwargs)
    if package == "jax":
        if args.get("kv_layout") == "paged":
            args.setdefault("paged_kernel", "reference")
        return jax_engine.DecodeEngine(jcfg, jparams, **args)
    return engine.DecodeEngine(tcfg, tparams, device="cpu", **args)


def _generate(eng, prompt, trace_id, session=None, **fields):
    lib = jax_engine if isinstance(eng, jax_engine.DecodeEngine) else engine

    async def run():
        return await eng.generate(list(prompt), lib.SamplingParams(max_new_tokens=6), session_id=session,
                                  trace_id=trace_id, request_fields=fields or None)

    return asyncio.run(run())


def _tiles(record):
    """The leg's stages tile its wall clock, the JAX ledger's invariant
    (``tests/test_journey.py``): no overlapping and no negative stage, and
    at least 95% covered; a leg with no handoff import is covered whole
    (an import leg leaves the import's end to the admission uncovered, as
    the JAX engine's does)."""
    leg = journey.Journey(record["trace_id"])
    leg.add(record)
    assert leg.overlaps() == [] and leg.negatives() == [], record
    assert leg.coverage() >= 0.95, record
    if not any(stage["stage"] == "handoff_import" for stage in record["stages"]):
        assert leg.coverage() == pytest.approx(1.0), record
    assert leg.missing_stages() == [], record
    return [stage["stage"] for stage in record["stages"]]


PROMPT = [(i * 7) % 250 + 1 for i in range(40)]


def _sessions(eng):
    first = _generate(eng, PROMPT, "s-cold", session="alice")
    _generate(eng, PROMPT + first.tokens + [5, 6, 7], "s-warm", session="alice")
    _generate(eng, PROMPT[:32] + [9, 8, 7, 6], "s-prefix")
    return ("s-cold", "s-warm", "s-prefix")


TIER_PROMPT1 = list(range(1, 33))
TIER_PROMPT2 = TIER_PROMPT1 + list(range(101, 109))
THRASH = [[(i * 31 + j) % 240 + 2 for j in range(32)] for i in range(6)]


def _host_tier(eng):
    _generate(eng, TIER_PROMPT1, "t-first")
    for i, prompt in enumerate(THRASH):
        _generate(eng, prompt, f"t-thrash-{i}")
    _generate(eng, TIER_PROMPT2, "t-promoted")
    return ("t-first", "t-thrash-0", "t-promoted")


HANDOFF_PROMPT = [(i * 7) % 250 + 1 for i in range(40)]  # 5 full blocks of 8


def _handoff(prefill, decode):
    leg = _generate(prefill, HANDOFF_PROMPT, "h-prefill", export_handoff=True)
    payload = leg.kv_handoff
    assert payload is not None
    _generate(decode, HANDOFF_PROMPT + leg.tokens[:-1], "h-decode", kv_import=payload,
              replay_tokens=list(leg.tokens), prompt_len=len(HANDOFF_PROMPT),
              handoff_export_ts=payload["export_ts"])
    return ("h-prefill", "h-decode")


SCENARIOS = ["sessions-dense", "sessions-paged", "host-tier", "handoff"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_journeys_tile_and_admit_classes_match_jax(weights, recorders, scenario):
    found = {}
    for package in ("port", "jax"):
        if scenario == "handoff":
            engines = [_engine(weights, package, **PAGED) for _ in range(2)]
            try:
                ids = _handoff(*engines)
            finally:
                for eng in engines:
                    eng.stop()
        else:
            kwargs = {"sessions-dense": {}, "sessions-paged": PAGED,
                      "host-tier": dict(PAGED, kv_blocks=20, kv_host_blocks=32)}[scenario]
            eng = _engine(weights, package, **kwargs)
            try:
                ids = (_host_tier if scenario == "host-tier" else _sessions)(eng)
            finally:
                eng.stop()
        records = _journeys(package, recorders)
        found[package] = {tid: (records[tid]["admit_class"],
                                [stage["stage"] for stage in records[tid]["stages"]]) for tid in ids}
        if package == "port":
            for tid in ids:
                _tiles(records[tid])
    assert found["port"] == found["jax"]
    classes = {tid: admit for tid, (admit, _) in found["port"].items()}
    if scenario.startswith("sessions"):
        assert classes == {"s-cold": "cold", "s-warm": "hbm-hit", "s-prefix": "hbm-hit"}
    elif scenario == "host-tier":
        assert classes == {"t-first": "cold", "t-thrash-0": "cold", "t-promoted": "host-promote"}
    else:
        assert classes == {"h-prefill": "cold", "h-decode": "handoff-import"}
        assert "handoff_export" in found["port"]["h-prefill"][1]
        stages = found["port"]["h-decode"][1]
        assert stages[:3] == ["handoff_transit", "queue", "handoff_import"]


# ---------------------------------------------------------------------- #
# the journey commands, ab_analyze, the server's trace id
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def port_artifact(weights, tmp_path_factory):
    """A port flight artifact: the dense sessions scenario and a few
    sessionless requests, with an SLO so that blame is booked."""
    directory = tmp_path_factory.mktemp("artifact")
    saved = flight.RECORDER.path
    flight.RECORDER.path = None
    flight.RECORDER._pending.clear()
    path = flight.configure(str(directory / "flight"))
    eng = _engine(weights, "port", slo={"ttft_ms_p95": 0.001, "tpot_ms_p95": 0.001})
    try:
        _sessions(eng)
        for i in range(3):
            _generate(eng, PROMPT[i:i + 20], f"plain-{i}")
        snapshot = engine.engines_snapshot()
    finally:
        eng.stop()
        flight.flush()
        flight.RECORDER.path = saved
    return str(directory), path, snapshot


@pytest.mark.parametrize("argv, kwargs", [
    ([], {}),
    (["--slo-ttft-ms", "0.001", "--slo-tpot-ms", "0.001", "--top", "2"],
     dict(slo_ttft_ms=0.001, slo_tpot_ms=0.001, waterfalls=2)),
    (["--trace-id", "s-warm"], dict(trace_id="s-warm")),
    (["--json"], dict(as_json=True)),
], ids=["tables", "slo-blame", "one-trace", "json"])
def test_journey_command_prints_the_jax_lines(port_artifact, argv, kwargs):
    directory, path, _ = port_artifact
    flight_dir = os.path.join(directory, "flight")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        main(["journey", flight_dir, *argv])
    lines = printed.getvalue().splitlines()
    assert lines == "\n".join(jax_journey.run_journey([flight_dir], **kwargs)).splitlines()
    # the port's run_journey reads the JAX package's artifacts alike
    assert journey.run_journey([path], **kwargs) == jax_journey.run_journey([path], **kwargs)
    if "--json" not in argv:
        assert lines[0].startswith("1 journey(s)" if "--trace-id" in argv else "6 journey(s)")


def test_slo_burn_and_blame_reach_the_snapshot(port_artifact):
    *_, snapshot = port_artifact
    assert snapshot["torch_engine_slo_ttft_p95_target_ms"] == 0.001
    assert snapshot["torch_engine_slo_ttft_burn_rate_5m"] > 1.0
    blamed = {name: value for name, value in snapshot.items()
              if name.startswith("torch_engine_slo_blame_total")}
    assert sum(blamed.values()) >= 6, blamed


def test_ab_analyze_digests_a_port_artifact(port_artifact):
    """``tools/ab_analyze.py`` as it is: its flight digest of the port's
    artifact carries the roofline and goodput columns, and its journey
    digest the stages."""
    directory, _, _ = port_artifact
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import ab_analyze
    finally:
        sys.path.pop(0)
    digest = ab_analyze.flight_summary(directory)
    assert digest is not None
    roofline = [line for line in digest.splitlines() if "roofline: MFU" in line]
    goodput = [line for line in digest.splitlines() if "goodput:" in line]
    assert roofline and goodput, digest
    assert "decode:" in digest and "occupancy:" in digest
    journeys = ab_analyze.journey_summary(directory)
    assert journeys is not None and "journeys: 6" in journeys and "prefill" in journeys


@pytest.fixture(scope="module")
def cpu_server():
    args = build_parser().parse_args([
        "serve", "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
        "--max-slots", "2", "--max-seq-len", "128", "--decode-chunk", "4",
    ])
    service, api = start_server(args)
    yield f"http://127.0.0.1:{api.port}"
    api.stop()
    service.close()


def _post(url, body, headers=None):
    request = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(request, timeout=60) as response:
        return response.headers, response.read().decode()


def test_trace_id_reaches_the_journey(cpu_server, recorders):
    headers, _ = _post(cpu_server + "/v1/completions", {"prompt": "once upon", "max_tokens": 3},
                       {"x-langstream-trace-id": "client-trace-1"})
    assert headers["x-langstream-trace-id"] == "client-trace-1"
    headers, _ = _post(cpu_server + "/v1/chat/completions",
                       {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3,
                        "trace_id": "body-trace-2"})
    assert headers["x-langstream-trace-id"] == "body-trace-2"
    headers, raw = _post(cpu_server + "/v1/chat/completions",
                         {"messages": [{"role": "user", "content": "hey"}], "max_tokens": 3,
                          "stream": True})
    minted = headers["x-langstream-trace-id"]
    assert len(minted) == 32 and raw.rstrip().endswith("data: [DONE]")
    records = _journeys("port", recorders)
    for tid in ("client-trace-1", "body-trace-2", minted):
        assert records[tid]["tokens"] == 3
        _tiles(records[tid])


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as response:
            return response.status, json.loads(response.read())
    except urllib.error.HTTPError as error:
        return error.code, json.loads(error.read())


@pytest.mark.parametrize("flag", [False, True], ids=["default", "profile-kernels"])
def test_serve_primes_the_profiler_only_when_asked(monkeypatch, flag):
    """``serve --profile-kernels`` brings the profiler's device tracing up
    in the serving thread at start (it leaves CUPTI attached, so not by
    default)."""
    calls = []
    monkeypatch.setattr(tracing, "prime_profiler", lambda: calls.append(1))
    args = build_parser().parse_args(["serve", "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
                                      "--max-slots", "2", "--max-seq-len", "64"]
                                     + (["--profile-kernels"] if flag else []))
    service, api = start_server(args)
    try:
        assert calls == ([1] if flag else [])
    finally:
        api.stop()
        service.close()


def test_debug_profile_answers_400_409_and_a_capture(tmp_path, monkeypatch):
    monkeypatch.setenv(tracing.PROFILE_DIR_ENV, str(tmp_path / "profiles"))
    api = OpenAIApiServer(completions=None, host="127.0.0.1", port=0)
    api.start()
    base = f"http://127.0.0.1:{api.port}/debug/profile"
    try:
        for bad in ("abc", "0", "-1", "61"):
            status, body = _get(f"{base}?seconds={bad}")
            assert status == 400, (bad, body)
        # a second capture while one runs: 409
        first = {}
        runner = threading.Thread(target=lambda: first.update(zip(("status", "body"),
                                                                  _get(f"{base}?seconds=1.5"))))
        runner.start()
        deadline = time.monotonic() + 30
        while not tracing.PROFILE_LOCK.locked() and time.monotonic() < deadline:
            time.sleep(0.01)
        status, body = _get(f"{base}?seconds=1")
        assert status == 409 and body["error"]["type"] == "conflict"
        runner.join(timeout=60)
        assert first["status"] == 200 and first["body"]["seconds"] == 1.5
        directory = first["body"]["path"]
        assert directory.startswith(str(tmp_path / "profiles"))
        assert os.path.isfile(os.path.join(directory, "trace.json"))
        with open(os.path.join(directory, "device_memory.json")) as handle:
            snapshot = json.load(handle)
        assert snapshot["devices"] == [] and snapshot["captured_s"] >= 1.5
        # and the default duration's range check passes a plain capture
        status, body = _get(f"{base}?seconds=0.2")
        assert status == 200 and os.path.isdir(body["path"])
    finally:
        api.stop()
