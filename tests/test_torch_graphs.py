"""The port's step runner (``graphs.py``) and the engine's step variants,
``precompile`` and ``admission_chunk``, against the JAX engine, on the
CPU.

On the CPU the runner has no graph: it runs each variant's body eagerly
through the same static buffers a graph would read and write (as it does
on the card with ``step_graphs=False``), so these tests hold the staging,
the carries through the static buffers and the variant list;
``tests/test_torch_gpu.py`` holds the graphs themselves on the card.

- ``_variant_keys()`` lists exactly the decode step counts and mixed
  widths of the JAX engine's ``_variant_jobs``, at every sampling tier,
  and its prefill lattice (cold and at an offset, by bucket and group,
  and a first-token variant by group and tier) on both layouts.
- Token streams and logprobs of the staged engine equal the JAX engine's
  and those of an engine built with ``step_graphs=False``, greedy and
  seeded, on the dense and paged layouts, the int8 KV cache, int8
  weights, the mixed step with its carry, and the pipelined decode (which
  must also equal the serial engine: a replay that overwrote a carried
  output would show).
- ``admission_chunk`` shortens chunks while admissions wait and keeps the
  tokens, as in the JAX package's ``tests/test_engine.py``, on the dense
  layout and with mixed prefill.
- ``precompile`` captures every variant, the prefill lattice's
  included, leaves the cache (but for the paged null block) and the
  penalty counts as they were, and serving after it equals serving
  without it.
- The counters: the engine counts a step's model calls on the host, at
  dispatch, the same with or without graphs; the runner leaves the
  kernel wrappers' counts to the body.
"""

import asyncio
from pathlib import Path

import numpy as np
import pytest
import torch

from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu_torch.ops import launches
from langstream_tpu_torch.ops.decode_kernel import flash_decode_attention
from langstream_tpu_torch.providers.torch_local import engine, model
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax
from langstream_tpu_torch.providers.torch_local.graphs import TIERS, StepRunner, Variant

torch.set_num_threads(2)

BASE = dict(max_slots=2, max_seq_len=128, prefill_buckets=[16, 32], decode_chunk=4, seed=7)
PAGED = dict(kv_layout="paged", kv_block_size=8)
MIXED = dict(PAGED, prefill_mode="mixed", prefill_chunk=16, pipeline_decode=True, mixed_carry=True)
CONFIGS = {
    "dense": {},
    "paged": PAGED,
    "int8-kv": dict(PAGED, kv_quant="int8"),
    "int8-weights": dict(quantize="int8"),
    "mixed-carry": MIXED,
    "pipelined": dict(pipeline_decode=True),
}


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=128)
    tcfg = model.LlamaConfig.tiny(max_seq_len=128)
    jparams = jax_model.init_params(jcfg, seed=3)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)
    return jcfg, jparams, tcfg, tparams


def _port(weights, **kwargs):
    _, _, tcfg, tparams = weights
    return engine.DecodeEngine(tcfg, tparams, device="cpu", **dict(BASE, **kwargs))


def _jax(weights, **kwargs):
    jcfg, jparams, _, _ = weights
    args = dict(BASE, **kwargs)
    args.pop("step_graphs", None)
    paged = args.get("kv_layout") == "paged"
    return jax_engine.DecodeEngine(jcfg, jparams, prefix_cache=args.pop("prefix_cache", paged),
                                   **({"paged_kernel": "reference"} if paged else {}), **args)


def _params(eng, **kwargs):
    cls = jax_engine.SamplingParams if isinstance(eng, jax_engine.DecodeEngine) else engine.SamplingParams
    return cls(**kwargs)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 250, size=n).tolist()


async def _traffic(eng):
    """Three greedy requests over two slots (one prompt past the largest
    bucket, one with a penalty), then three seeded ones (temperature,
    top-k, top-p with penalty and bias)."""
    greedy = await asyncio.gather(
        eng.generate(_prompt(1, 12), _params(eng, max_new_tokens=17)),
        eng.generate(_prompt(2, 40), _params(eng, max_new_tokens=16, frequency_penalty=1.5)),
        eng.generate(_prompt(3, 70), _params(eng, max_new_tokens=15)),
    )
    seeded = await asyncio.gather(
        eng.generate(_prompt(4, 17), _params(eng, temperature=0.8, seed=11, max_new_tokens=10)),
        eng.generate(_prompt(5, 30), _params(eng, temperature=1.0, top_k=20, seed=5, max_new_tokens=12)),
        eng.generate(_prompt(6, 9), _params(eng, temperature=0.9, top_p=0.8, seed=3, presence_penalty=0.5,
                                            logit_bias={7: 5.0}, max_new_tokens=9)),
    )
    return list(greedy) + list(seeded)


def _same(got, want, logprobs=True):
    for index, (mine, theirs) in enumerate(zip(got, want)):
        assert mine.tokens == theirs.tokens, index
        assert mine.finish_reason == theirs.finish_reason, index
        if logprobs:
            np.testing.assert_allclose(mine.logprobs, theirs.logprobs, rtol=1e-4, atol=1e-4)


def _count_chains(eng):
    counts = {"decode": 0}
    original = eng._dispatch_decode

    def counted(*args, **kwargs):
        counts["decode"] += kwargs.get("carry") is not None
        return original(*args, **kwargs)

    eng._dispatch_decode = counted
    return counts


def _run_all(*engines):
    try:
        return [asyncio.run(_traffic(eng)) for eng in engines]
    finally:
        for eng in engines:
            eng.stop()


# ---------------------------------------------------------------------- #
# the variant list
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("admission_chunk", [None, 2, 8], ids=["none", "2", "capped"])
@pytest.mark.parametrize("layout", ["dense", "paged", "mixed"])
def test_variant_keys_cover_jax_variant_jobs(weights, layout, admission_chunk):
    """The decode step counts and mixed widths of ``_variant_keys()`` are
    those of the JAX engine's ``_variant_jobs`` for the same settings
    (an admission chunk above the decode chunk is capped to it), each at
    every sampling tier; a split engine has no mixed variant. The
    prefill lattice too: every (bucket, group) of the JAX prefill jobs,
    cold and at an offset; a first-token sampling per group and tier;
    none in mixed mode. And the KV copies: the dense prefix copy at every
    bucket, the paged block copy."""
    kwargs = dict(decode_chunk=8, admission_chunk=admission_chunk, prefix_cache=True)
    if layout == "paged":
        kwargs.update(PAGED)
    if layout == "mixed":
        kwargs.update(MIXED, prefill_chunk=40)
    ported = _port(weights, **kwargs)
    reference = _jax(weights, **kwargs)
    jobs = reference._variant_jobs()
    ids = {id(fn) for fn, _ in jobs}
    want_steps = {steps for steps, fn in reference._decode_fns.items() if id(fn) in ids}
    want_widths = {width for width, fn in reference._mixed_fns.items() if id(fn) in ids}
    prefill_fns = {id(fn): ("prefill", bucket) for bucket, fn in reference._compiled_prefill.items()}
    prefill_fns.update({id(fn): ("prefill_offset", bucket)
                        for bucket, fn in reference._prefill_offset_fns.items()})
    # (kind, bucket, group): the group is the rows of the tokens argument
    want_prefill = {(*prefill_fns[id(fn)], args[2].shape[0]) for fn, args in jobs if id(fn) in prefill_fns}
    want_copies = {Variant("copy", bucket) for bucket, fn in reference._copy_fns.items() if id(fn) in ids}
    if id(reference._block_copy_fn) in ids:
        want_copies.add(Variant("block_copy", 0))
    groups = {group for _, _, group in want_prefill}
    keys = ported._variant_keys()
    assert len(keys) == len(set(keys))
    assert {k.size for k in keys if k.kind == "decode"} == want_steps
    assert {k.size for k in keys if k.kind == "mixed"} == want_widths
    assert {(k.kind, k.size, k.group) for k in keys if k.kind.startswith("prefill")} == want_prefill
    assert set(keys) == {Variant(kind, size, tier)
                         for kind, sizes in (("decode", want_steps), ("mixed", want_widths))
                         for size in sizes for tier in TIERS} | {
        Variant(kind, bucket, "", group) for kind, bucket, group in want_prefill} | {
        Variant("first_token", 0, tier, group) for group in groups for tier in TIERS} | want_copies
    assert want_steps == ({8, 1} | ({admission_chunk} if admission_chunk == 2 else set()))
    assert bool(want_widths) == (layout == "mixed")
    assert groups == (set() if layout == "mixed" else {1, 2})
    assert {(kind, bucket) for kind, bucket, group in want_prefill if group == 2} == (
        set() if layout == "mixed" else {("prefill", 16), ("prefill", 32), ("prefill_offset", 16),
                                         ("prefill_offset", 32)})
    assert want_copies == ({Variant("copy", 16), Variant("copy", 32)} if layout == "dense"
                           else {Variant("block_copy", 0)})
    ported.stop()
    reference.stop()


# ---------------------------------------------------------------------- #
# staged streams against the JAX engine and the uncaptured control
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_staged_streams_match_jax_and_uncaptured(weights, config):
    kwargs = CONFIGS[config]
    staged = _port(weights, **kwargs)
    unstaged = _port(weights, step_graphs=False, **kwargs)
    reference = _jax(weights, **kwargs)
    chains = _count_chains(staged)
    got, eager, want = _run_all(staged, unstaged, reference)
    _same(got, want)
    _same(got, eager)
    assert [len(r.tokens) for r in got] == [17, 16, 15, 10, 12, 9]
    ran = {key.kind for key in staged.steps._entries}
    # split: cold prefill, and at an offset the 70-token prompt's windows
    assert ran == ({"decode", "mixed"} if config == "mixed-carry"
                   else {"decode", "prefill", "prefill_offset", "first_token"})
    assert {key.tier for key in staged.steps._entries} >= {"greedy", "truncated"}
    assert staged.steps.stats["replayed"] > 0 and unstaged.steps.stats["replayed"] > 0
    if config == "mixed-carry":
        assert staged.stats["mixed_steps_chained"] > 0, staged.stats
    if config == "pipelined":
        # pipelined and staged == serial: chunk N's tokens were copied out
        # before chunk N+1's run overwrote the static outputs
        assert chains["decode"] > 0
        (serial,) = _run_all(_port(weights))
        _same(got, serial)


# ---------------------------------------------------------------------- #
# admission_chunk
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", ["dense", "mixed"])
def test_admission_chunk_shortens_chunks_and_matches_jax(weights, layout):
    """While admissions wait, fresh chunks run ``admission_chunk`` steps
    (the runner replayed both step counts; mixed: beside its mixed
    steps), and the tokens equal the JAX engine's with the same cap and a
    serial engine's without it (``tests/test_engine.py``'s admission-chunk
    contract)."""
    kwargs = dict(max_slots=2, prefill_buckets=[16], decode_chunk=8, admission_chunk=2)
    if layout == "mixed":
        kwargs.update(MIXED)
    sampling = dict(max_new_tokens=12)

    def prompt(i):
        return [(11 * i + j) % 250 + 1 for j in range(8 + i % 3)]

    async def staggered(eng):
        async def late(i):
            await asyncio.sleep(0.004 * i)
            return await eng.generate(prompt(i), _params(eng, **sampling))

        return await asyncio.gather(*[late(i) for i in range(8)])

    adaptive = _port(weights, **kwargs)
    assert adaptive.admission_chunk == 2
    assert _port(weights, decode_chunk=4, admission_chunk=9).admission_chunk == 4
    ran = []
    run = adaptive.steps.run

    def recorded(key, inputs):
        ran.append(key)
        return run(key, inputs)

    adaptive.steps.run = recorded
    reference = _jax(weights, **kwargs)
    serial = _port(weights, prefill_buckets=[16], decode_chunk=8)
    try:
        got = asyncio.run(staggered(adaptive))
        assert {2, 8} <= {key.size for key in ran if key.kind == "decode"}, set(ran)
        assert any(key.kind == "mixed" for key in ran) == (layout == "mixed"), set(ran)
        _same(got, asyncio.run(staggered(reference)))
        for i in range(8):
            alone = asyncio.run(serial.generate(prompt(i), _params(serial, **sampling)))
            assert got[i].tokens == alone.tokens, i
    finally:
        for eng in (adaptive, reference, serial):
            eng.stop()


# ---------------------------------------------------------------------- #
# precompile
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("config", ["dense", "paged", "int8-kv", "mixed-carry"])
def test_precompile_leaves_state_and_streams_alone(weights, config):
    """``precompile`` captures every variant, the prefill lattice's
    included, on a cache and counts filled with seeded noise: both end as
    they were (the paged null block aside), no model call is counted, and
    a precompiled engine serves what a cold one serves without capturing
    again."""
    kwargs = CONFIGS[config]
    eng = _port(weights, **kwargs)
    rng = np.random.default_rng(17)
    for leaf in eng.cache.values():
        noise = rng.integers(-100, 100, size=leaf.shape) if leaf.dtype == torch.int8 else \
            rng.standard_normal(leaf.shape)
        leaf.copy_(torch.from_numpy(noise))
    eng._counts.copy_(torch.from_numpy(rng.integers(0, 3, size=eng._counts.shape)))
    before = {name: leaf.clone() for name, leaf in eng.cache.items()}
    counts = eng._counts.clone()
    eng.precompile()
    try:
        assert eng.steps.stats["captured"] == len(eng._variant_keys()) > 0
        prefill = {kind: stats["captured"] for kind, stats in eng.steps.stats["kinds"].items()
                   if kind in engine.PREFILL_KINDS}
        assert prefill == ({} if eng.mixed else {
            "prefill": 4, "prefill_offset": 4, "first_token": 6})
        assert eng.precompile_s is not None
        for name, leaf in eng.cache.items():
            live = slice(1, None) if eng.paged else slice(None)  # block 0: the null block
            assert torch.equal(leaf[:, live], before[name][:, live]), name
        assert torch.equal(eng._counts, counts)
        assert eng.stats["model_dispatches"] == {} and eng.stats["prefill_calls"] == 0
    finally:
        eng.stop()

    warm = _port(weights, **kwargs)
    warm.precompile()
    captured = warm.steps.stats["captured"]
    got, cold = _run_all(warm, _port(weights, **kwargs))
    _same(got, cold)
    assert warm.steps.stats["captured"] == captured
    with pytest.raises(RuntimeError, match="before start"):
        started = _port(weights)
        started.start()
        try:
            started.precompile()
        finally:
            started.stop()


# ---------------------------------------------------------------------- #
# the counters and the runner's staging
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("config", ["paged", "mixed-carry"])
def test_model_calls_are_counted_at_dispatch(weights, config):
    """One request at a time (no admission timing in play): the model
    calls by function, counted on the host as each step is dispatched,
    are the same with graphs on and off, and a decode chunk counts one
    call a step."""
    counts = []
    for graphs in (True, False):
        eng = _port(weights, step_graphs=graphs, **CONFIGS[config])
        steps = []
        dispatch = eng._dispatch_decode

        def counted(*args, **kwargs):
            record = dispatch(*args, **kwargs)
            steps.append(0 if record.get("mixed") else record["steps"])
            return record

        eng._dispatch_decode = counted
        try:
            for i in range(3):
                asyncio.run(eng.generate(_prompt(i, 10 + 9 * i), engine.SamplingParams(max_new_tokens=9)))
            counts.append(dict(eng.stats["model_dispatches"]))
        finally:
            eng.stop()
        assert counts[-1]["paged_decode_step"] == sum(steps) > 0, (counts[-1], steps)
    assert counts[0] == counts[1]
    assert ("paged_mixed_step" in counts[0]) == (config == "mixed-carry")


def _toy_runner(graphs):
    """A runner whose one variant adds 2 to its input, launching a kernel
    three times a run (counted as the kernel wrappers count)."""

    def body(key):
        def step(x):
            flash_decode_attention.launches += 3
            return {"out": x["a"] + 2}

        return step

    return StepRunner(torch.device("cpu"), graphs=graphs, body=body,
                      dummy=lambda key: {"a": np.zeros((3,), dtype=np.int64)})


@pytest.mark.parametrize("graphs", [True, False], ids=["graphs", "no-graphs"])
def test_runner_leaves_counting_to_the_body(graphs):
    """The runner adds nothing to a wrapper's count: on the CPU the
    warm-up run and every run of the body count what the body launches,
    with graphs asked for or not."""
    runner = _toy_runner(graphs)
    key = Variant("decode", 1, "greedy")
    launches = flash_decode_attention.launches
    try:
        runner.prepare(key)
        assert flash_decode_attention.launches == launches + 3
        assert runner.stats["captured"] == 1 and not runner.graphed
        for run in range(1, 3):
            _, out = runner.run(key, {"a": np.full((3,), run, dtype=np.int64)})
            assert out["out"].tolist() == [run + 2] * 3
            assert flash_decode_attention.launches == launches + 3 * (run + 1)
        assert runner.stats == dict(runner.stats, captured=1, replayed=2)
    finally:
        flash_decode_attention.launches = launches


def test_runner_stages_through_static_buffers_and_checks_inputs():
    """Staged: every run returns the same static buffers, overwritten by
    the next run; a device tensor input is copied in, the static input
    itself is left; a missing, misshapen or mistyped input raises. A body
    that fails to capture raises naming the variant."""
    runner = _toy_runner(True)
    key = Variant("decode", 1, "greedy")
    inputs, first = runner.run(key, {"a": np.ones((3,), dtype=np.int64)})
    kept = first["out"].clone()
    inputs_again, second = runner.run(key, {"a": torch.full((3,), 5, dtype=torch.int64)})
    assert second is first and inputs_again is inputs and kept.tolist() == [3, 3, 3]
    assert first["out"].tolist() == [7, 7, 7]
    runner.run(key, inputs)  # the static input itself: no copy, same values
    assert first["out"].tolist() == [7, 7, 7]
    for bad in ({}, {"a": np.zeros((4,), dtype=np.int64)}, {"a": np.zeros((3,), dtype=np.int32)}):
        with pytest.raises(ValueError, match="step input"):
            runner.run(key, bad)

    def broken(key):
        def step(x):
            raise RuntimeError("operation not permitted when stream is capturing")
        return step

    failing = StepRunner(torch.device("cpu"), graphs=True, body=broken,
                         dummy=lambda key: {"a": np.zeros((3,), dtype=np.int64)})
    with pytest.raises(RuntimeError, match=r"capturing step variant .*mixed.*64.*truncated"):
        failing.prepare(Variant("mixed", 64, "truncated"))


def test_device_launch_counts_name_every_kernel_and_read_zero_unloaded():
    """The device counters read under the eight kernels' names, and as 0
    where no kernel library is loaded (here: no card)."""
    names = {"flash_prefill", "flash_decode", "paged_attention", "paged_attention_ragged_q"}
    assert set(launches.KERNEL_NAMES) == names | {name + "_quant" for name in names}
    assert launches.read() == dict.fromkeys(launches.KERNEL_NAMES, 0)
    with launches.device_launches() as counts:
        pass
    assert counts == dict.fromkeys(launches.KERNEL_NAMES, 0)


def test_device_launch_counters_match_each_library_and_shapes_read_zero():
    """Each library's list of forms is as long as its ``csrc`` counter
    array (the read copies that many counters into it), and the
    prefill-shape and verify counters of B3 and B6 read as 0 with
    ``shapes``, apart from the eight kernels' names."""
    csrc = Path(launches.__file__).resolve().parent.parent / "csrc"
    for library, forms in launches.FORMS.items():
        source = (csrc / f"{library}.cu").read_text()
        assert f"constexpr int FORMS = {len(forms)};" in source, library
    assert launches.SHAPES == ("paged_attention/prefill", "paged_attention_quant/prefill",
                               "paged_attention/verify", "paged_attention_quant/verify")
    assert not set(launches.SHAPES) & set(launches.KERNEL_NAMES)
    names = launches.KERNEL_NAMES + launches.SHAPES
    assert launches.read(shapes=True) == dict.fromkeys(names, 0)
    with launches.device_launches(shapes=True) as counts:
        pass
    assert counts == dict.fromkeys(names, 0)
