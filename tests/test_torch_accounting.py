"""The port's accounting plane held to the JAX package's on the CPU.

``runtime/accounting.py``: every ``CostModel`` accessor of the port equals
the JAX model's over a grid (the tiny preset and Llama-3-8B's shape;
bf16 and int8 weights; bf16 and int8 KV; the dense layout and blocks of
16 with the fused and the reference paged kernel; plain decode and a
verify block of 1 + 4), and the H100 peaks are the port's defaults.
``count_le``, ``violation_fraction`` and the ``SLOTracker``'s burn rates
and blame are the goldens of ``tests/test_efficiency.py`` under the
port's gauge names.

The engines: the port's and the JAX engine (``device="cpu"``, the JAX
engine's harvest, which here takes every finished prefill at each harvest
point, as the port's does on the CPU) serve the same requests, one of
them cancelled from its token callback, on four paths: dense split,
paged split, mixed (pipelined, the carry on) and speculative. Their
dispatch plans agree (decode chunks and steps, prefill calls), and then
every accounting counter: the modeled decode FLOPs and bytes, prefill
FLOPs, active slot steps, useful tokens and all seven waste reasons. The
latency histograms count the same observations, and ``engines_snapshot``
and ``engines_histograms`` carry every family of the JAX package's under
the port's names (``torch_engine_*`` for ``jax_engine_*``)."""

import concurrent.futures
import dataclasses
import gc
import pathlib
import re

import numpy as np
import pytest
import torch

from langstream_tpu.api.metrics import Histogram as JaxHistogram
from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.runtime import accounting as jax_accounting
from langstream_tpu.runtime import journey as jax_journey
from langstream_tpu_torch.api.metrics import Histogram
from langstream_tpu_torch.providers.torch_local import engine, model
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax
from langstream_tpu_torch.runtime import accounting, journey

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------- #
# the cost model against the JAX one
# ---------------------------------------------------------------------- #
SHAPES = {
    "tiny": (jax_model.LlamaConfig.tiny(max_seq_len=64), model.LlamaConfig.tiny(max_seq_len=64)),
    "llama3_8b": (jax_model.LlamaConfig.llama3_8b(), model.LlamaConfig.llama3_8b()),
}
# (block size, paged kernel): the dense layout, and blocks of 16 under
# either paged attention
LAYOUT_GRID = [(1, None), (16, "fused"), (16, "reference")]
GRID = [(shape, weight_quant, kv_quant, block, kernel)
        for shape in SHAPES for weight_quant in (None, "int8") for kv_quant in (False, True)
        for block, kernel in LAYOUT_GRID]


@pytest.mark.parametrize(
    "shape, weight_quant, kv_quant, block, kernel", GRID,
    ids=[f"{s}-{w or 'bf16'}-w-{'int8' if k else 'bf16'}-kv-{'dense' if b == 1 else f'{kern}{b}'}"
         for s, w, k, b, kern in GRID])
def test_cost_model_equals_jax(shape, weight_quant, kv_quant, block, kernel):
    jcfg, tcfg = SHAPES[shape]
    kwargs = dict(weight_quant=weight_quant, kv_quant=kv_quant, kv_block_size=block,
                  paged_kernel=kernel)
    want = jax_accounting.CostModel.from_model_config(jcfg, **kwargs)
    got = accounting.CostModel.from_model_config(tcfg, **kwargs)
    for field in ("params", "num_layers", "num_heads", "num_kv_heads", "head_dim", "weight_bytes",
                  "kv_row_bytes", "kv_block_size", "paged_kernel"):
        assert getattr(got, field) == getattr(want, field), field
    for ctx in (0, 1, 15, 16, 17, 513, 4096):
        assert got.kv_read_tokens(ctx) == want.kv_read_tokens(ctx)
        assert got.kv_read_bytes(ctx) == want.kv_read_bytes(ctx)
        assert got.kv_handoff_bytes(ctx) == want.kv_handoff_bytes(ctx)
        assert got.kv_demote_bytes(ctx) == want.kv_demote_bytes(ctx)
        assert got.kv_promote_bytes(ctx) == want.kv_promote_bytes(ctx)
    for spec_block in (1, 5):
        for steps, active, kv_tokens in ((1, 1, 32), (8, 32, 16384), (4, 3, 300)):
            assert got.decode_chunk_flops(steps, active, kv_tokens, block=spec_block) == \
                want.decode_chunk_flops(steps, active, kv_tokens, block=spec_block)
            assert got.decode_chunk_bytes(steps, active, kv_tokens, block=spec_block) == \
                want.decode_chunk_bytes(steps, active, kv_tokens, block=spec_block)
    for new, offset in ((0, 0), (10, 5), (256, 0), (1024, 512)):
        assert got.prefill_flops(new, offset=offset) == want.prefill_flops(new, offset=offset)
        assert got.prefill_bytes(new, offset=offset) == want.prefill_bytes(new, offset=offset)
    windows = [(0, 16), (40, 7)]
    assert got.mixed_step_flops(5, 900, windows) == want.mixed_step_flops(5, 900, windows)
    assert got.mixed_step_bytes(1000, 28) == want.mixed_step_bytes(1000, 28)
    peaks = accounting.PeakSpecs(flops=1e12, hbm_bytes_per_s=2e12)
    jpeaks = jax_accounting.PeakSpecs(flops=1e12, hbm_bytes_per_s=2e12)
    assert got.mfu(3e11, 0.5, peaks) == want.mfu(3e11, 0.5, jpeaks) == pytest.approx(0.6)
    assert got.mbu(3e11, 0.5, peaks) == want.mbu(3e11, 0.5, jpeaks) == pytest.approx(0.3)
    assert got.mfu(1.0, 0.0, peaks) == 0.0 and got.mbu(1.0, 0.0, peaks) == 0.0


def test_peaks_are_the_h100s(monkeypatch):
    """The defaults are the H100 SXM's dense bf16 and HBM3 peaks, the same
    overrides apply, and no v5e figure is left in the port."""
    monkeypatch.delenv(accounting.ENV_PEAK_TFLOPS, raising=False)
    monkeypatch.delenv(accounting.ENV_PEAK_HBM_GBS, raising=False)
    assert accounting.PeakSpecs() == accounting.PeakSpecs.from_env()
    assert accounting.PeakSpecs().flops == 989e12
    assert accounting.PeakSpecs().hbm_bytes_per_s == 3.35e12
    monkeypatch.setenv("LANGSTREAM_PEAK_TFLOPS", "919")
    monkeypatch.setenv("LANGSTREAM_PEAK_HBM_GBS", "2765")
    peaks = accounting.PeakSpecs.from_env()
    assert peaks.flops == pytest.approx(919e12)
    assert peaks.hbm_bytes_per_s == pytest.approx(2765e9)
    v5e = re.compile(r"197e12|\b197(\.0)?\s*TFLOP|\b819(\.0)?\b|819e9")
    for path in sorted((REPO / "langstream_tpu_torch").rglob("*.py")):
        assert not v5e.search(path.read_text()), path


# ---------------------------------------------------------------------- #
# SLO math: the goldens of tests/test_efficiency.py, both packages
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("package", ["port", "jax"])
def test_violation_fraction_from_histogram_snapshots(package):
    acc, hist = (accounting, Histogram) if package == "port" else (jax_accounting, JaxHistogram)
    histogram = hist("ttft", buckets=(0.1, 0.2, 0.4))
    for _ in range(10):
        histogram.observe(0.05)
    then = histogram.snapshot()
    for _ in range(10):
        histogram.observe(0.3)
    now = histogram.snapshot()
    assert acc.count_le(now, 0.3) == pytest.approx(15.0)
    assert acc.count_le(now, 10.0) == pytest.approx(20.0)
    assert acc.violation_fraction(now, then, 0.2) == pytest.approx(1.0)
    assert acc.violation_fraction(now, None, 0.2) == pytest.approx(0.5)
    assert acc.violation_fraction(then, then, 0.2) is None
    # and the port's value is the JAX function's on the same snapshots
    assert accounting.violation_fraction(now, then, 0.25) == jax_accounting.violation_fraction(
        now, then, 0.25)


def _tracker_run(acc, hist):
    histogram = hist("ttft", buckets=(0.1, 0.2, 0.4))
    tpot = hist("tpot", buckets=(0.01, 0.02))
    tracker = acc.SLOTracker({"ttft_ms_p95": 200.0, "tpot_ms_p95": 0}, {"ttft": histogram, "tpot": tpot},
                             snapshot_interval=1.0)
    tracker.tick(now=0.0)
    for _ in range(19):
        histogram.observe(0.05)
    histogram.observe(0.5)
    first = tracker.gauges(now=400.0)
    for _ in range(10):
        histogram.observe(0.5)
    tracker.attribute("ttft", "queue")
    tracker.attribute("ttft", "queue")
    tracker.attribute("ttft", "prefill")
    tracker.attribute("tpot", "decode")
    tracker.attribute("ttft", None)       # no dominant stage: not booked
    tracker.attribute("e2e", "queue")     # not an SLO kind: not booked
    return first, tracker.gauges(now=800.0)


def test_slo_tracker_burn_rates_and_blame_match_jax():
    """The burn-rate goldens (one violation in 20 is the 5% budget, burn
    1; then 10 of 10, burn 20 over 5m, 11 of 30 over the hour), a zero
    TPOT target dropped, and the blame table; equal to the JAX tracker's
    with ``jax_engine_`` read as ``torch_engine_``."""
    first, second = _tracker_run(accounting, Histogram)
    assert first["torch_engine_slo_ttft_p95_target_ms"] == 200.0
    assert first["torch_engine_slo_ttft_burn_rate_5m"] == pytest.approx(1.0)
    assert second["torch_engine_slo_ttft_burn_rate_5m"] == pytest.approx(20.0)
    assert second["torch_engine_slo_ttft_burn_rate_1h"] == pytest.approx((11 / 30) / 0.05, rel=1e-3)
    assert not any("tpot_p95" in name or "tpot_burn" in name for name in second)
    assert second['torch_engine_slo_blame_total{kind="ttft",stage="queue"}'] == 2.0
    assert second['torch_engine_slo_blame_total{kind="ttft",stage="prefill"}'] == 1.0
    assert second['torch_engine_slo_blame_total{kind="tpot",stage="decode"}'] == 1.0
    for got, want in zip((first, second), _tracker_run(jax_accounting, JaxHistogram)):
        assert got == {name.replace("jax_engine_", "torch_engine_"): value
                       for name, value in want.items()}


def test_blame_stage_matches_jax():
    stages = [{"stage": "queue", "start": 0.0, "end": 0.3}, {"stage": "admit", "start": 0.3, "end": 0.3},
              {"stage": "prefill", "start": 0.3, "end": 0.5}, {"stage": "decode", "start": 0.5, "end": 2.0},
              {"stage": "finish", "start": 2.0, "end": 2.0}]
    for first_token in (None, 0.5, 0.2):
        for kind in ("ttft", "tpot"):
            assert journey.blame_stage(stages, first_token, kind) == jax_journey.blame_stage(
                stages, first_token, kind)
    assert journey.blame_stage(stages, 0.5, "ttft") == "queue"
    assert journey.blame_stage(stages, 0.5, "tpot") == "decode"


# ---------------------------------------------------------------------- #
# the engines, on matching dispatch plans
# ---------------------------------------------------------------------- #
ARGS = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 32], decode_chunk=4, seed=7)
PATHS = {
    "dense": {},
    "paged": dict(kv_layout="paged", kv_block_size=8),
    # every request admitted at once, so the prompt windows chain (a
    # waiting request breaks the carry's chain)
    "mixed": dict(kv_layout="paged", kv_block_size=8, prefill_mode="mixed", prefill_chunk=16,
                  pipeline_decode=True, max_slots=8),
    "spec": dict(spec_decode="ngram", spec_k=4),
}
COUNTERS = ("decode_flops", "decode_bytes", "prefill_flops", "active_slot_steps", "tokens_useful",
            "tokens_generated", "requests")


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=128)
    tcfg = model.LlamaConfig.tiny(max_seq_len=128)
    jparams = jax_model.init_params(jcfg, seed=4)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)
    return jcfg, jparams, tcfg, tparams


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 250, size=n).tolist()


def _repetitive(n):
    return [(11 + i % 6) for i in range(n)]


SHARED = _prompt(0, 20)
# (prompt, sampling, cancel after this many tokens or None): six requests
# over four slots (bucket padding, a 70-token prompt in windows, warm
# prefixes on the paged layout, one cancelled from its token callback)
BURST = [
    (SHARED + _prompt(1, 5), dict(frequency_penalty=1.5, max_new_tokens=14), None),
    (_prompt(2, 30), dict(temperature=0.8, seed=11, max_new_tokens=12), 3),
    (SHARED + _prompt(3, 7), dict(temperature=1.0, top_k=20, seed=5, max_new_tokens=10), None),
    (_prompt(4, 70), dict(max_new_tokens=11), None),
    (SHARED[:18] + _prompt(5, 3), dict(temperature=0.9, top_p=0.8, seed=3, max_new_tokens=9), None),
    (_prompt(6, 12), dict(max_new_tokens=13), None),
]
SPEC_BURST = [
    (_repetitive(30), dict(max_new_tokens=16), None),
    (_repetitive(26) + [99, 98], dict(max_new_tokens=16), 6),
    (_prompt(7, 20), dict(max_new_tokens=12), None),
]


def _engines(weights, path):
    jcfg, jparams, tcfg, tparams = weights
    kwargs = dict(ARGS, **PATHS[path])
    port = engine.DecodeEngine(tcfg, tparams, device="cpu", join_prefills=False, prefix_cache=True,
                               **kwargs)
    paged = "kv_layout" in kwargs
    reference = jax_engine.DecodeEngine(jcfg, jparams, prefix_cache=True,
                                        **({"paged_kernel": "reference"} if paged else {}), **kwargs)
    if paged:
        # the JAX engine here runs its gather composition: model the fused
        # kernel the port dispatches, so both charge the same bytes
        reference.cost_model = dataclasses.replace(reference.cost_model, paged_kernel="fused")
    # the JAX engine's harvest point takes every finished prefill, as the
    # port's does on the CPU (its records complete when dispatched), so
    # the two dispatch the same chunks over the same slots
    harvest = reference._harvest_prefills

    def harvest_all(block=False):
        while reference._prefill_inflight:
            harvest(block=True)

    reference._harvest_prefills = harvest_all
    return port, reference


def _serve(eng, burst):
    """Submit every request before the engine starts (its first admission
    round sees them all), then wait for every result."""
    lib = jax_engine if isinstance(eng, jax_engine.DecodeEngine) else engine
    futures = []
    for prompt, sampling, cancel_after in burst:
        request = lib.GenerationRequest(prompt_tokens=list(prompt), sampling=lib.SamplingParams(**sampling),
                                        future=concurrent.futures.Future())
        if cancel_after is not None:
            seen = [0]

            def on_token(token, last, request=request, seen=seen, limit=cancel_after):
                seen[0] += 1
                if seen[0] >= limit:
                    request.cancel()

            request.on_token = on_token
        futures.append(request.future)
        eng.submit(request)
    eng.start()
    try:
        return [future.result(timeout=300) for future in futures]
    finally:
        eng.stop()


def _histogram_counts(module, prefix):
    return {name: module.engines_histograms()[f"{prefix}_{name}_seconds"]["count"]
            for name in ("ttft", "tpot", "request", "decode_step")}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_engine_accounting_matches_jax(weights, path):
    port, reference = _engines(weights, path)
    burst = SPEC_BURST if path == "spec" else BURST
    before = (_histogram_counts(engine, "torch_engine"), _histogram_counts(jax_engine, "jax_engine"))
    got, want = _serve(port, burst), _serve(reference, burst)
    after = (_histogram_counts(engine, "torch_engine"), _histogram_counts(jax_engine, "jax_engine"))
    for mine, theirs in zip(got, want):
        assert mine.tokens == theirs.tokens
        assert mine.finish_reason == theirs.finish_reason
    assert [r.finish_reason for r in got].count("cancelled") == 1
    # the dispatch plans first
    for key in ("decode_chunks", "decode_steps", "prefill_calls", "warm_prefill_calls", "mixed_steps",
                "mixed_steps_chained", "tokens_drafted", "tokens_draft_accepted"):
        assert port.stats[key] == reference.stats[key], key
    # then the accounting
    for key in COUNTERS:
        assert port.stats[key] == reference.stats[key], key
    assert port.stats["tokens_wasted"] == reference.stats["tokens_wasted"]
    wasted = port.stats["tokens_wasted"]
    assert wasted["cancelled"] > 0 and wasted["prefill_padding"] > 0
    if path == "spec":
        assert wasted["draft_rejected"] > 0
    if path == "mixed":
        # the cancelled request's row rode a chained step in flight when
        # it ended
        assert port.stats["mixed_steps_chained"] > 0 and wasted["carry_invalidated"] > 0
        assert port.stats["mixed_carry_invalidations"] == reference.stats["mixed_carry_invalidations"]
    assert port.stats["decode_flops"] > 0 and port.stats["decode_bytes"] > 0
    assert (port.stats["prefill_flops"] > 0) == (path != "mixed")
    # every generated token is useful or cancelled (no stop token here),
    # and the useful ones are what the callers received
    assert port.stats["tokens_useful"] + wasted["cancelled"] == port.stats["tokens_generated"]
    assert port.stats["tokens_useful"] == sum(len(r.tokens) for r in got
                                             if r.finish_reason != "cancelled")
    # the latency histograms counted the same observations
    deltas = [{name: after[i][name] - before[i][name] for name in after[i]} for i in (0, 1)]
    assert deltas[0] == deltas[1]
    assert deltas[0]["ttft"] == deltas[0]["request"] == len(burst)


# ---------------------------------------------------------------------- #
# /metrics: every JAX family under the port's name
# ---------------------------------------------------------------------- #
def _family(name):
    return re.sub(r"\{.*\}$", "", name)


def test_snapshot_families_cover_jax(weights):
    """A mixed paged engine with an SLO and a host tier and a spec engine
    on each side, one request through each: every family (name with its
    labels) of the JAX ``engines_snapshot`` and ``engines_histograms`` is
    in the port's, ``jax_engine_`` read as ``torch_engine_``."""
    jcfg, jparams, tcfg, tparams = weights
    slo = {"ttft_ms_p95": 1.0, "tpot_ms_p95": 1.0}
    mixed = dict(ARGS, **PATHS["mixed"], kv_host_blocks=8, slo=slo)
    spec = dict(ARGS, **PATHS["spec"])
    made = [engine.DecodeEngine(tcfg, tparams, device="cpu", **mixed),
            engine.DecodeEngine(tcfg, tparams, device="cpu", **spec),
            jax_engine.DecodeEngine(jcfg, jparams, paged_kernel="reference", **mixed),
            jax_engine.DecodeEngine(jcfg, jparams, **spec)]
    try:
        for eng in made:
            _serve(eng, BURST[:1])
        gauges = {"port": set(engine.engines_snapshot()), "jax": set(jax_engine.engines_snapshot())}
        histograms = {"port": set(engine.engines_histograms()),
                      "jax": set(jax_engine.engines_histograms())}
    finally:
        for eng in made:
            eng.stop()
        del made
        gc.collect()
    for kind in (gauges, histograms):
        want = {name.replace("jax_engine_", "torch_engine_") for name in kind["jax"]}
        assert want <= kind["port"], sorted(want - kind["port"])
    for name in ("torch_engine_mfu", "torch_engine_mbu", "torch_engine_prefill_mfu",
                 "torch_engine_goodput_ratio", "torch_engine_slot_occupancy",
                 "torch_engine_tokens_useful_total", "torch_engine_slo_ttft_burn_rate_5m",
                 "torch_engine_mixed_steps_chained_total"):
        assert name in gauges["port"], name
    assert 'torch_engine_tokens_wasted_total{reason="carry_invalidated"}' in gauges["port"]
    assert any(_family(name) == "torch_engine_slo_blame_total" for name in gauges["port"])
