"""The port's prefill as the JAX engine runs it, on the CPU: one step
variant per (kind, bucket, group) model call and per (group, tier)
first-token sampling, dispatched without blocking and harvested at the
run loop's harvest points.

- Token streams and logprobs equal the JAX engine's (``tiny`` weights,
  greedy and seeded; logprobs within 1e-4, the bound of the other engine
  tests) on the dense and paged layouts, over the bf16 and the int8 KV
  cache, pipelined and not, for a burst of cold prompts, prefix-cache
  warm batches (paged), a prompt longer than the largest bucket, and
  late arrivals admitted while decode runs. Every first token is emitted
  by a harvest after its dispatch, never inside it.
- By hand, without the engine thread: a prefilling slot stays out of
  decode until its record is harvested; no chunk chains and a fresh
  chunk runs ``admission_chunk`` steps while a record is in flight; two
  groups of one variant dispatched before one harvest keep their own
  first tokens; ``stop()`` drops what was never harvested. The loop's
  harvest point waits for every record only when no chunk is on the card
  (``join_prefills``), or as the JAX engine's.
- A long prompt leaves its slot's penalty counts as the JAX engine does.
- A variant first met while other slots are live warms up on its own
  call: every other slot's cache rows and counts stay bit for bit.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu_torch.providers.torch_local import engine, model
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax

torch.set_num_threads(2)

ARGS = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 32], decode_chunk=4, seed=7)
LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged", kv_block_size=8)}
# logprobs of the port against the JAX engine's (f32 on both sides)
LOGPROB_TOLERANCE = 1e-4


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=128)
    tcfg = model.LlamaConfig.tiny(max_seq_len=128)
    jparams = jax_model.init_params(jcfg, seed=4)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)
    return jcfg, jparams, tcfg, tparams


def _port(weights, layout="dense", **kwargs):
    _, _, tcfg, tparams = weights
    return engine.DecodeEngine(tcfg, tparams, device="cpu", **dict(ARGS, **LAYOUTS[layout], **kwargs))


def _jax(weights, layout="dense", **kwargs):
    jcfg, jparams, _, _ = weights
    paged = layout == "paged"
    return jax_engine.DecodeEngine(jcfg, jparams, prefix_cache=paged,
                                   **({"paged_kernel": "reference"} if paged else {}),
                                   **dict(ARGS, **LAYOUTS[layout], **kwargs))


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 250, size=n).tolist()


SHARED = _prompt(0, 20)  # two full 8-token blocks and 4 more
# (prompt, sampling): with 4 slots the first four are admitted at once
# (two cold prompts of bucket 32, on the paged layout a warm one onto the
# first's published blocks, a 70-token prompt in windows); the last two
# arrive while the first ones decode (a warm one and a cold one)
BURST = [
    (SHARED + _prompt(1, 5), dict(frequency_penalty=1.5, max_new_tokens=14)),
    (_prompt(2, 30), dict(temperature=0.8, seed=11, max_new_tokens=12)),
    (SHARED + _prompt(3, 7), dict(temperature=1.0, top_k=20, seed=5, max_new_tokens=10)),
    (_prompt(4, 70), dict(max_new_tokens=11)),
    (SHARED[:18] + _prompt(5, 3), dict(temperature=0.9, top_p=0.8, seed=3, presence_penalty=0.5,
                                       logit_bias={7: 5.0}, max_new_tokens=9)),
    (_prompt(6, 12), dict(max_new_tokens=13)),
]


def _request(eng, prompt, sampling, future=None):
    lib = jax_engine if isinstance(eng, jax_engine.DecodeEngine) else engine
    return lib.GenerationRequest(prompt_tokens=list(prompt), sampling=lib.SamplingParams(**sampling),
                                 future=future)


def _serve(eng, requests):
    """Submit every request before the engine starts, so that its first
    admission round sees them all, then wait for every result. Returns
    the results and the prefill records still in flight at the end."""
    futures = []
    for prompt, sampling in requests:
        futures.append(concurrent.futures.Future())
        eng.submit(_request(eng, prompt, sampling, futures[-1]))
    eng.start()
    try:
        return [future.result(timeout=300) for future in futures], list(eng._prefill_inflight)
    finally:
        eng.stop()


def _same(got, want):
    for index, (mine, theirs) in enumerate(zip(got, want)):
        assert mine.tokens == theirs.tokens, index
        assert mine.finish_reason == theirs.finish_reason, index
        np.testing.assert_allclose(mine.logprobs, theirs.logprobs,
                                   rtol=LOGPROB_TOLERANCE, atol=LOGPROB_TOLERANCE)


STREAM_CASES = [(kv_quant, pipeline, True) for kv_quant in (None, "int8")
                for pipeline in (False, True)] + [(None, True, False)]


@pytest.mark.parametrize(
    "kv_quant, pipeline, join", STREAM_CASES,
    ids=[f"{'int8' if kv_quant else 'bf16'}-kv-{'pipelined' if pipeline else 'serial'}"
         + ("" if join else "-jax-harvest") for kv_quant, pipeline, join in STREAM_CASES])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_prefill_streams_match_jax(weights, layout, kv_quant, pipeline, join):
    """The burst's streams equal the JAX engine's, whether the harvest
    joins every prefill to the next fresh chunk or runs as the JAX
    engine's; every prefill went through the step runner, and each first
    token was emitted by a harvest that found its record already
    dispatched."""
    kwargs = dict(kv_quant=kv_quant, pipeline_decode=pipeline)
    ported = _port(weights, layout, join_prefills=join, **kwargs)
    reference = _jax(weights, layout, **kwargs)
    harvests = []
    harvest = ported._harvest_prefills

    def counted(block=False, every=False):
        pending = len(ported._prefill_inflight)
        harvest(block=block, every=every)
        harvests.append(pending - len(ported._prefill_inflight))

    ported._harvest_prefills = counted
    got, left = _serve(ported, BURST)
    _same(got, _serve(reference, BURST)[0])
    assert [len(r.tokens) for r in got] == [sampling["max_new_tokens"] for _, sampling in BURST]
    # each record harvested once, at a harvest point of the loop
    dispatched = ported.stats["prefill_calls"] + ported.stats["warm_prefill_calls"]
    assert sum(harvests) == dispatched >= 4
    assert left == [] and not any(slot.active for slot in ported.slots)
    kinds = ported.steps.stats["kinds"]
    assert {"prefill", "prefill_offset", "first_token"} <= set(kinds)
    calls = ported.stats["model_dispatches"]
    prefix = "paged_" if layout == "paged" else ""
    assert kinds["prefill"]["replayed"] == calls[prefix + "prefill"]
    assert kinds["prefill_offset"]["replayed"] == calls[prefix + "prefill_at_offset"]
    if layout == "paged":
        assert ported.stats["warm_prefill_calls"] >= 2 and ported.stats["prefix_hits"] >= 2


# ---------------------------------------------------------------------- #
# by hand: the engine's dispatch, harvest and chunk rules
# ---------------------------------------------------------------------- #
def _admit(eng, *requests):
    """Queue requests and run one admission round (no engine thread)."""
    eng._pending.extend(_request(eng, prompt, sampling) for prompt, sampling in requests)
    eng._admit()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_prefilling_slot_joins_decode_only_when_harvested(weights, layout):
    """Slot 0 decodes. Slot 1's prefill, dispatched while slot 0's chunk
    is in flight, keeps slot 1 ``prefilling``, out of the next chunk and
    without a token, until a harvest; meanwhile no chunk chains off the
    carry and a fresh chunk runs ``admission_chunk`` steps. ``stop()``
    drops a record never harvested."""
    eng = _port(weights, layout, pipeline_decode=True, admission_chunk=2, decode_chunk=4)
    with torch.inference_mode():
        _admit(eng, (_prompt(7, 10), dict(max_new_tokens=40)))
        assert eng.slots[0].prefilling and eng.slots[0].generated == []
        assert not eng._any_ready()
        eng._harvest_prefills()
        assert eng.slots[0].ready and len(eng.slots[0].generated) == 1
        chunk = eng._dispatch_decode()
        assert chunk["steps"] == 4 and eng._can_chain(chunk)
        _admit(eng, (_prompt(8, 20), dict(max_new_tokens=5)))
        assert len(eng._prefill_inflight) == 1 and eng.slots[1].prefilling
        assert not eng._can_chain(chunk)
        eng._process_decode(chunk)
        assert len(eng.slots[0].generated) == 5 and eng.slots[1].generated == []
        short = eng._dispatch_decode()
        assert short["steps"] == 2 and list(short["active"]) == [True, False, False, False]
        eng._process_decode(short)
        assert eng.slots[1].prefilling and eng.slots[1].generated == []
        eng._harvest_prefills(block=False)  # on the CPU every record is ready
        assert eng._prefill_inflight == [] and eng.slots[1].ready
        assert len(eng.slots[1].generated) == 1
        full = eng._dispatch_decode()
        assert full["steps"] == 4 and list(full["active"]) == [True, True, False, False]
        eng._process_decode(full)
        _admit(eng, (_prompt(9, 12), dict(max_new_tokens=5)))
        assert len(eng._prefill_inflight) == 1
    eng.stop()
    assert eng._prefill_inflight == []


class _Running:
    """A record's copy event whose work the card has not finished: not
    done when queried; :meth:`synchronize` is the wait, and counts."""

    def __init__(self, waits):
        self.waits = waits

    def query(self):
        return False

    def synchronize(self):
        self.waits.append(self)


@pytest.mark.parametrize("join", [True, False], ids=["join", "jax-harvest"])
def test_harvest_point_waits_for_every_prefill_only_with_no_chunk_in_flight(weights, join):
    """Three records still running on the card while slot 0 decodes. With
    a chunk in flight the loop's harvest point takes none. With none, it
    takes all three (``join_prefills``: a fresh chunk would queue behind
    them), or, as the JAX engine, none while a slot is ready and only the
    oldest once no slot is."""
    eng = _port(weights, join_prefills=join)
    waits = []
    with torch.inference_mode():
        _admit(eng, (_prompt(16, 10), dict(max_new_tokens=40)))
        eng._harvest_prefills()
        for seed in (17, 18, 19):
            _admit(eng, (_prompt(seed, 5 + seed), dict(max_new_tokens=5)))
        assert len(eng._prefill_inflight) == 3
        for record in eng._prefill_inflight:
            record["out"] = (record["out"][0], _Running(waits))
        chunk = eng._dispatch_decode()
        eng._harvest_at_loop(chunk)
        assert len(eng._prefill_inflight) == 3 and waits == []
        eng._process_decode(chunk)
        eng._harvest_at_loop(None)
        if join:
            assert eng._prefill_inflight == [] and len(waits) == 3
            assert all(slot.ready for slot in eng.slots)
        else:
            assert len(eng._prefill_inflight) == 3 and waits == []
            eng._finish(0, "length")
            eng._harvest_at_loop(None)
            assert len(eng._prefill_inflight) == 2 and len(waits) == 1
            assert [slot.ready for slot in eng.slots] == [False, True, False, False]
    eng.stop()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_same_variant_groups_keep_their_own_first_tokens(weights, layout):
    """Two one-row groups of one variant (cold, bucket 16, group 1, the
    same tier) dispatched before one harvest: the second replay
    overwrites the variant's static outputs, yet each request gets the
    first token and logprob it gets alone."""
    pair = [(_prompt(10, 9), dict(temperature=0.7, seed=1, max_new_tokens=1)),
            (_prompt(11, 14), dict(temperature=0.7, seed=2, max_new_tokens=1))]
    alone = [_serve(_port(weights, layout), [request])[0][0] for request in pair]
    eng = _port(weights, layout)
    with torch.inference_mode():
        for request in pair:
            _admit(eng, request)
        assert len(eng._prefill_inflight) == 2
        assert eng.steps.stats["kinds"]["prefill"] == dict(eng.steps.stats["kinds"]["prefill"],
                                                           captured=1, replayed=2)
        futures = []
        for index in (0, 1):
            futures.append(concurrent.futures.Future())
            eng.slots[index].request.future = futures[-1]
        eng._harvest_prefills()
    eng.stop()
    _same([future.result(timeout=10) for future in futures], alone)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_long_prompt_counts_match_jax(weights, layout):
    """A 70-token prompt over buckets of 16 and 32 (three windows) on a
    slot whose penalty counts hold a previous occupant's noise: the JAX
    engine samples and resets the counts at every window, the port only
    at the last; both leave the same counts, and the same stream."""
    noise = np.random.default_rng(12).integers(0, 3, size=(4, 256)).astype(np.int32)
    request = [(_prompt(13, 70), dict(temperature=0.8, seed=9, frequency_penalty=0.7,
                                      max_new_tokens=6))]
    ported, reference = _port(weights, layout), _jax(weights, layout)
    ported._counts.copy_(torch.from_numpy(noise))
    reference._counts = jnp.asarray(noise)
    windows = ported.stats["model_dispatches"]
    got, _ = _serve(ported, request)
    want, _ = _serve(reference, request)
    _same(got, want)
    assert len(engine.long_prefill_windows(70, 0, ARGS["prefill_buckets"])) == 3
    assert sum(windows.values()) >= 3
    np.testing.assert_array_equal(ported._counts.numpy(), np.asarray(reference._counts))
    assert not np.array_equal(ported._counts.numpy()[0], noise[0])


@pytest.mark.parametrize("kind", ["cold", "long"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_first_use_capture_leaves_other_slots_alone(weights, layout, kind):
    """No ``precompile``: a prefill variant first met while serving is
    warmed up on its own call, so the cache rows (dense: every other
    slot's; paged: every block outside the new slot's table, the null
    block aside) and the penalty counts of every other slot stay bit for
    bit as they were; the dense dummy would have rewritten slot 0."""
    eng = _port(weights, layout)
    rng = np.random.default_rng(14)
    for leaf in eng.cache.values():
        noise = rng.integers(-100, 100, size=leaf.shape) if leaf.dtype == torch.int8 else \
            rng.standard_normal(leaf.shape)
        leaf.copy_(torch.from_numpy(noise))
    eng._counts.copy_(torch.from_numpy(rng.integers(0, 3, size=eng._counts.shape)))
    before = {name: leaf.clone() for name, leaf in eng.cache.items()}
    counts = eng._counts.clone()
    for index in (0, 2, 3):  # live slots: not free for admission
        eng.slots[index].request = _request(eng, [1], dict())
    with torch.inference_mode():
        _admit(eng, (_prompt(15, 40 if kind == "long" else 11), dict(max_new_tokens=4)))
    assert eng.slots[1].prefilling and eng.steps.stats["captured"] == 3 - (kind == "cold")
    eng.stop()
    if layout == "paged":
        untouched = sorted(set(range(1, eng.num_blocks)) - set(eng.slots[1].blocks))
        for name, leaf in eng.cache.items():
            assert torch.equal(leaf[:, untouched], before[name][:, untouched]), name
    else:
        for name, leaf in eng.cache.items():
            for index in (0, 2, 3):
                assert torch.equal(leaf[:, index], before[name][:, index]), (name, index)
    others = [0, 2, 3]
    assert torch.equal(eng._counts[others], counts[others])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_prefill_with_the_mlp_in_row_slices_matches_jax(weights, layout, monkeypatch):
    """With ``MLP_ROWS`` cut to 7, every prefill call (up to 4 × 32 rows)
    runs its MLP in slices of at most 7 rows, ending in a shorter one;
    the burst's streams still equal the JAX engine's."""
    slices = []
    block = model._mlp_block

    def counted(config, normed, params, i):
        slices.append(normed.reshape(-1, normed.shape[-1]).shape[0])
        return block(config, normed, params, i)

    monkeypatch.setattr(model, "MLP_ROWS", 7)
    monkeypatch.setattr(model, "_mlp_block", counted)
    kwargs = dict(pipeline_decode=True)
    got, _ = _serve(_port(weights, layout, **kwargs), BURST)
    _same(got, _serve(_jax(weights, layout, **kwargs), BURST)[0])
    assert max(slices) == 7 and any(rows < 7 for rows in slices) and slices.count(7) > 32
