"""The port's mixed prefill+decode dispatch against the JAX package's, on
the CPU.

Op level: the token-ragged wrappers' CPU path (the plain versions of B7
and B8) against the JAX ``ragged_q_paged_attention(_quant)`` run in
interpret mode, on ``_mixed_case`` batches of ``tests/test_mixed_dispatch.py``
(a decode row, a warm window, a cold window, an idle row over a shuffled
pool): GQA 4/4 and 4/2, softcap, window, int8, the all-decode and
all-prefill batches and packed (non-uniform) ``q_offsets``, to 2e-5 of
max |JAX| (f32; the online softmax reassociates the sums); q tiles past a
row's live count and idle rows exactly zero; the "tile" refusal.

Model level: ``paged_mixed_step`` against JAX's on ``tiny`` and
``tiny_gemma2`` (two chained steps: decode rows, windows resuming at an
offset, an idle row), over the model-dtype pool and the int8 one, both
port routes against the JAX reference route: logits to 1e-4 of max, every
pool row but the null block's to 1e-5 (values within one quantum and
scales to 1e-5 over int8).

Engine level: the port's ``prefill_mode="mixed"`` engine against the JAX
mixed engine (``paged_kernel="reference"``) and the port's own split
engine, over both pools: greedy and seeded streams (penalties, top-k/p,
per-request seeds) through a prefix hit, a long cold prompt admitted
mid-decode, a mid-stream stop and a >= 256-token prefix hit; no mixed step
carries more than ``prefill_chunk`` prompt tokens; no prefill model call;
the refusals; the provider's keys and ``serve``'s flags.
"""

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.ops.attention import quantize_kv as jax_quantize_kv
from langstream_tpu.ops.paged_attention import (
    ragged_q_paged_attention as jax_ragged_q,
    ragged_q_paged_attention_quant as jax_ragged_q_quant,
)
from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu_torch.cli.main import build_parser, serve_config
from langstream_tpu_torch.ops.paged_attention import (
    ragged_q_paged_attention,
    ragged_q_paged_attention_quant,
)
from langstream_tpu_torch.providers.torch_local import engine, model
from langstream_tpu_torch.providers.torch_local.convert import cache_from_jax, params_from_jax
from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService

torch.set_num_threads(2)

BLOCK = 8
OP_TOLERANCE = 2e-5


def _t(array):
    return torch.from_numpy(np.array(array))  # a writable copy of a JAX buffer


def _close(out, ref, rel):
    out, ref = np.asarray(out, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-6)
    assert float(np.abs(out - ref).max()) <= rel * scale


# ---------------------------------------------------------------------- #
# op level: the plain B7/B8 against the JAX kernels in interpret mode
# ---------------------------------------------------------------------- #
def _mixed_case(seed=0, heads=4, kv_heads=2, dim=16, width=8):
    """The JAX test's mixed batch over a shuffled pool: a decode row at
    context 21, a warm window of 5 at offset 11, a cold window of
    ``width`` at 0, an idle row. numpy arrays."""
    rng = np.random.RandomState(seed)
    batch, blocks_per_row = 4, 6
    total = batch * blocks_per_row
    order = rng.permutation(total) + 1  # block 0 stays the null block
    tables = order.reshape(batch, blocks_per_row).astype(np.int32)
    k_pool = rng.randn(total + 1, BLOCK, kv_heads, dim).astype(np.float32)
    v_pool = rng.randn(total + 1, BLOCK, kv_heads, dim).astype(np.float32)
    starts = np.asarray([20, 11, 0, 0], np.int32)
    totals = np.asarray([21, 16, width, 0], np.int32)
    q = rng.randn(batch * width, heads, dim).astype(np.float32)
    q_offsets = (np.arange(batch) * width).astype(np.int32)
    return q, (k_pool, v_pool), tables, starts, totals, q_offsets


def _quantized_pools(pools):
    (kq, ks), (vq, vs) = (jax_quantize_kv(jnp.asarray(p)) for p in pools)
    return tuple(np.asarray(a) for a in (kq, ks, vq, vs))


def _both(q, pools, tables, starts, totals, q_offsets, *, max_q_len, block_q, **family):
    """(port, JAX) flat outputs of the same inputs; int8 when ``pools``
    has four leaves."""
    port_fn, jax_fn = (
        (ragged_q_paged_attention_quant, jax_ragged_q_quant) if len(pools) == 4
        else (ragged_q_paged_attention, jax_ragged_q)
    )
    args = (q, *pools, tables, starts, totals, q_offsets)
    port = port_fn(*(_t(a) for a in args), max_q_len=max_q_len, block_q=block_q, **family)
    window = family.pop("window", None)
    ref = jax_fn(*(jnp.asarray(a) for a in args), max_q_len=max_q_len, block_q=block_q,
                 window=None if window is None else jnp.asarray(window, jnp.int32),
                 interpret=True, **family)
    return port.numpy(), np.asarray(ref)


def _check_rows(port, ref, starts, totals, q_offsets, *, max_q_len, block_q):
    """Each row's live span within OP_TOLERANCE of JAX; its q tiles past
    the live count exactly zero on both sides."""
    for row, (start, total, offset) in enumerate(zip(starts, totals, q_offsets)):
        live = int(total - start)
        if live > 0:
            _close(port[offset:offset + live], ref[offset:offset + live], OP_TOLERANCE)
        first_dead = offset + -(-live // block_q) * block_q
        assert not port[first_dead:offset + max_q_len].any(), row
        assert not ref[first_dead:offset + max_q_len].any(), row


@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2)])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_ragged_q_plain_matches_jax(heads, kv_heads, softcap):
    q, pools, tables, starts, totals, q_offsets = _mixed_case(heads=heads, kv_heads=kv_heads)
    port, ref = _both(q, pools, tables, starts, totals, q_offsets, max_q_len=8, block_q=4,
                      softcap=softcap)
    _check_rows(port, ref, starts, totals, q_offsets, max_q_len=8, block_q=4)
    assert not port[24:].any(), "the idle row is all zeros"


def test_ragged_q_plain_window_and_int8_match_jax():
    q, pools, tables, starts, totals, q_offsets = _mixed_case(seed=3)
    port, ref = _both(q, pools, tables, starts, totals, q_offsets, max_q_len=8, block_q=4,
                      window=12)
    _check_rows(port, ref, starts, totals, q_offsets, max_q_len=8, block_q=4)
    int8 = _quantized_pools(pools)
    port, ref = _both(q, int8, tables, starts, totals, q_offsets, max_q_len=8, block_q=4,
                      softcap=30.0, window=12)
    _check_rows(port, ref, starts, totals, q_offsets, max_q_len=8, block_q=4)


@pytest.mark.parametrize("batch_kind", ["all-decode", "all-prefill"])
def test_ragged_q_plain_degenerate_batches_match_jax(batch_kind):
    """Every row a decode row (admissions drained mid-plan), or every row
    a full-width cold window (a burst with no decoding riders)."""
    q, pools, tables, _, _, q_offsets = _mixed_case(seed=5)
    if batch_kind == "all-decode":
        totals = np.asarray([21, 16, 9, 30], np.int32)
        starts = totals - 1
    else:
        starts = np.zeros(4, np.int32)
        totals = np.full(4, 8, np.int32)
    port, ref = _both(q, _quantized_pools(pools), tables, starts, totals, q_offsets,
                      max_q_len=8, block_q=4)
    _check_rows(port, ref, starts, totals, q_offsets, max_q_len=8, block_q=4)
    port, ref = _both(q, pools, tables, starts, totals, q_offsets, max_q_len=8, block_q=4)
    _check_rows(port, ref, starts, totals, q_offsets, max_q_len=8, block_q=4)


def test_ragged_q_plain_packed_offsets_match_jax():
    """Spans at non-uniform, tile-aligned offsets of a longer flat tile
    (gaps between them): every span equals JAX's, and the positions no
    span covers are zero on the port."""
    q, pools, tables, starts, totals, _ = _mixed_case(seed=7)
    q = np.concatenate([q, q[:16]])  # Q = 48
    q_offsets = np.asarray([40, 0, 16, 28], np.int32)  # multiples of block_q = 4
    for leaves in (pools, _quantized_pools(pools)):
        port, ref = _both(q, leaves, tables, starts, totals, q_offsets, max_q_len=8, block_q=4,
                          softcap=30.0)
        _check_rows(port, ref, starts, totals, q_offsets, max_q_len=8, block_q=4)
        covered = np.zeros(48, bool)
        for offset in q_offsets:
            covered[offset:offset + 8] = True
        assert not port[~covered].any()


def test_ragged_q_refusals():
    q, pools, tables, starts, totals, q_offsets = _mixed_case()
    args = [_t(a) for a in (q, *pools, tables, starts, totals, q_offsets)]
    with pytest.raises(ValueError, match="tile"):  # 8 % 3
        ragged_q_paged_attention(*args, max_q_len=8, block_q=3)
    with pytest.raises(ValueError, match="tile"):  # flat q of 30 rows
        ragged_q_paged_attention(args[0][:30], *args[1:], max_q_len=6, block_q=3)
    shifted = args[:-1] + [torch.tensor([0, 8, 18, 24], dtype=torch.int32)]
    with pytest.raises(ValueError, match="multiple"):
        ragged_q_paged_attention(*shifted, max_q_len=8, block_q=4)
    outside = args[:-1] + [torch.tensor([0, 8, 16, 28], dtype=torch.int32)]
    with pytest.raises(ValueError, match="outside"):
        ragged_q_paged_attention(*outside, max_q_len=8, block_q=4)
    # offsets the caller knows on the host are checked in place of q_offsets
    with pytest.raises(ValueError, match="multiple"):
        ragged_q_paged_attention(*args, max_q_len=8, block_q=4, q_offsets_host=[0, 8, 18, 24])
    with pytest.raises(ValueError, match="hold 4"):
        ragged_q_paged_attention(*args, max_q_len=8, block_q=4, q_offsets_host=[0, 8, 16])
    assert ragged_q_paged_attention.launches == 0  # the CPU path launches nothing


# ---------------------------------------------------------------------- #
# model level: paged_mixed_step against the JAX one
# ---------------------------------------------------------------------- #
MAX_LEN, SLOTS, WIDTH = 64, 4, 8


def _jit(fn, cfg, **kw):
    return jax.jit(functools.partial(fn, cfg, **kw))


@pytest.mark.parametrize("preset", ["tiny", "tiny_gemma2"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_mixed_step_matches_jax(preset, kv_quant):
    """Two chained mixed steps over a pool seeded with random contents:
    a decode row, a warm window resuming at offset 11, a cold window
    over the full width, an idle row; then the decode row again, the warm
    row's next window and the cold row's second window."""
    jcfg = getattr(jax_model.LlamaConfig, preset)(max_seq_len=MAX_LEN)
    tcfg = getattr(model.LlamaConfig, preset)(max_seq_len=MAX_LEN)
    jparams = jax_model.init_params(jcfg, seed=3)
    tparams = params_from_jax({name: np.asarray(leaf) for name, leaf in jparams.items()}, tcfg)
    rng = np.random.default_rng(17)
    width_blocks = MAX_LEN // BLOCK
    num_blocks = SLOTS * width_blocks + 1
    jcache = jax_model.init_paged_cache(jcfg, num_blocks, BLOCK, kv_quant=kv_quant)
    seeded = {}
    for name, leaf in jcache.items():
        shape = np.asarray(leaf).shape
        if name in ("k", "v") and kv_quant:
            seeded[name] = rng.integers(-127, 128, size=shape).astype(np.int8)
        elif name in ("k", "v"):
            seeded[name] = rng.standard_normal(shape, dtype=np.float32)
        else:
            seeded[name] = np.abs(rng.standard_normal(shape, dtype=np.float32)) * 0.02
    tables = (rng.permutation(num_blocks - 1) + 1)[: SLOTS * width_blocks].reshape(
        SLOTS, width_blocks).astype(np.int32)
    jfreqs, tfreqs = jax_model.model_freqs(jcfg), model.model_freqs(tcfg)
    step = _jit(jax_model.paged_mixed_step, jcfg, kernel="reference")
    steps = [
        # offsets, num_tokens
        (np.asarray([20, 11, 0, 0], np.int32), np.asarray([1, 5, WIDTH, 0], np.int32)),
        (np.asarray([21, 16, WIDTH, 0], np.int32), np.asarray([1, 3, WIDTH, 0], np.int32)),
    ]
    for kernel in ("fused", "reference"):
        jc = {name: jnp.asarray(leaf) for name, leaf in seeded.items()}
        tc = cache_from_jax(seeded)
        for offsets, num_tokens in steps:
            tokens = rng.integers(0, jcfg.vocab_size, size=(SLOTS, WIDTH)).astype(np.int32)
            jc, jlogits = step(jparams, jc, *(jnp.asarray(a) for a in (
                tokens, offsets, num_tokens, tables)), jfreqs)
            tlogits = model.paged_mixed_step(
                tcfg, tparams, tc, *(_t(a) for a in (tokens, offsets, num_tokens, tables)),
                tfreqs, kernel=kernel)
            live = num_tokens > 0  # an idle row's logits are discarded (and differ by route)
            _close(tlogits.numpy()[live], np.asarray(jlogits)[live], 1e-4)
        for name in tc:
            out, ref = tc[name][:, 1:].numpy(), np.asarray(jc[name])[:, 1:]
            if out.dtype == np.int8:
                assert int(np.abs(out.astype(np.int32) - ref.astype(np.int32)).max()) <= 1, name
            else:
                np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------- #
# engine level: mixed against the JAX mixed engine and the port's split
# ---------------------------------------------------------------------- #
ENGINE_ARGS = dict(max_slots=4, max_seq_len=384, prefill_buckets=[16, 32, 64],
                   kv_layout="paged", kv_block_size=8, prefill_chunk=16, decode_chunk=4, seed=11)
GREEDY = dict(max_new_tokens=6)
SEEDED = dict(max_new_tokens=8, temperature=0.9, top_k=20, top_p=0.9, seed=1234,
              presence_penalty=0.4, frequency_penalty=0.2)
SHARED = list(np.arange(280) % 250 + 1)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=512)
    tcfg = model.LlamaConfig.tiny(max_seq_len=512)
    jparams = jax_model.init_params(jcfg, seed=0)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)
    return jcfg, jparams, tcfg, tparams


def _engines(weights, kv_quant):
    jcfg, jparams, tcfg, tparams = weights
    mixed = engine.DecodeEngine(tcfg, tparams, device="cpu", prefill_mode="mixed",
                                kv_quant=kv_quant, **ENGINE_ARGS)
    split = engine.DecodeEngine(tcfg, tparams, device="cpu", prefill_mode="split",
                                kv_quant=kv_quant, **ENGINE_ARGS)
    reference = jax_engine.DecodeEngine(jcfg, jparams, paged_kernel="reference",
                                        prefill_mode="mixed", kv_quant=kv_quant, **ENGINE_ARGS)
    # every window plan of the port's mixed engine, to bound its tokens
    plans = []
    plan_windows = mixed._plan_windows

    def recorded(admitting):
        windows, width = plan_windows(admitting)
        plans.append((windows, width))
        return windows, width

    mixed._plan_windows = recorded
    return mixed, split, reference, plans


@pytest.fixture(scope="module")
def engines(weights):
    built = _engines(weights, None)
    yield built
    for eng in built[:3]:
        eng.stop()


@pytest.fixture(scope="module")
def int8_engines(weights):
    built = _engines(weights, "int8")
    yield built
    for eng in built[:3]:
        eng.stop()


def _params_of(eng, **kw):
    cls = jax_engine.SamplingParams if isinstance(eng, jax_engine.DecodeEngine) else engine.SamplingParams
    return cls(**kw)


async def _drive(eng):
    """One request at a time: a cold prompt of 39 tokens, one sharing 32
    block-aligned tokens with it (a prefix hit whose windows resume
    mid-prompt), a seeded one with penalties and truncation."""
    first = await eng.generate(list(range(1, 40)), _params_of(eng, **GREEDY))
    second = await eng.generate(list(range(1, 33)) + [99, 98], _params_of(eng, **GREEDY))
    third = await eng.generate(list(range(3, 30)), _params_of(eng, **SEEDED))
    return [first, second, third]


async def _contended(eng):
    """A long cold prompt admitted while another request decodes."""
    t1 = asyncio.ensure_future(eng.generate(list(range(1, 20)), _params_of(eng, max_new_tokens=24)))
    await asyncio.sleep(0.15)
    t2 = asyncio.ensure_future(eng.generate(list(range(5, 150)), _params_of(eng, **GREEDY)))
    return list(await asyncio.gather(t1, t2))


async def _stopped(eng):
    """A stop token hit mid-stream: the surplus is discarded."""
    base = await eng.generate(list(range(1, 24)), _params_of(eng, **GREEDY))
    stopped = await eng.generate(list(range(1, 24)), _params_of(eng, max_new_tokens=16),
                                 stop_tokens={base.tokens[3]})
    return [base, stopped]


async def _prefix256(eng):
    """A second prompt sharing 280 tokens: its windows resume at the
    matched offset (>= 256 tokens served from the pool)."""
    first = await eng.generate(SHARED + [7, 8], _params_of(eng, **GREEDY))
    second = await eng.generate(SHARED + [9, 10, 11], _params_of(eng, **GREEDY))
    return [first, second]


def _same(got, want, logprobs=True):
    for index, (mine, theirs) in enumerate(zip(got, want)):
        assert mine.tokens == theirs.tokens, index
        assert mine.finish_reason == theirs.finish_reason, index
        if logprobs:
            np.testing.assert_allclose(mine.logprobs, theirs.logprobs, rtol=1e-4, atol=1e-4)


def _assert_mixed_only(mixed, plans):
    calls = mixed.stats["model_dispatches"]
    assert calls.get("paged_mixed_step", 0) > 0 and mixed.stats["mixed_steps"] > 0
    assert not any(name.startswith("paged_prefill") for name in calls), calls
    assert plans and max(sum(n for _, n in windows.values()) for windows, _ in plans) <= 16
    assert all(width in (8, 16) for _, width in plans)


@pytest.mark.parametrize("traffic", [_drive, _contended, _stopped, _prefix256],
                         ids=["prefix-hit-and-seeded", "admitted-mid-decode", "stop", "prefix-256"])
def test_mixed_engine_matches_jax_mixed_and_port_split(engines, traffic):
    mixed, split, reference, plans = engines
    hits = mixed.kv_manager.stats["hit_tokens"]
    got = asyncio.run(traffic(mixed))
    _same(got, asyncio.run(traffic(reference)))
    _same(got, asyncio.run(traffic(split)), logprobs=False)
    _assert_mixed_only(mixed, plans)
    if traffic is _drive:
        assert mixed.kv_manager.stats["hit_tokens"] >= hits + 32
        assert mixed.stats["prefix_hits"] > 0 and mixed.stats["warm_prefill_calls"] > 0
    if traffic is _stopped:
        stop = got[0].tokens[3]
        assert got[1].finish_reason == "stop"
        assert got[1].tokens == got[0].tokens[:got[0].tokens.index(stop)]
    if traffic is _prefix256:
        assert mixed.kv_manager.stats["hit_tokens"] >= hits + 256


def test_int8_mixed_engine_matches_jax_mixed_and_port_split(int8_engines):
    mixed, split, reference, plans = int8_engines
    assert mixed.cache["k"].dtype == torch.int8
    got = asyncio.run(_drive(mixed))
    _same(got, asyncio.run(_drive(reference)))
    _same(got, asyncio.run(_drive(split)), logprobs=False)
    got = asyncio.run(_contended(mixed))
    _same(got, asyncio.run(_contended(split)), logprobs=False)
    _assert_mixed_only(mixed, plans)


def test_mixed_refusals_and_plumbing(weights):
    _, _, tcfg, tparams = weights
    with pytest.raises(ValueError, match="paged"):
        engine.DecodeEngine(tcfg, tparams, device="cpu", max_slots=2, max_seq_len=64,
                            prefill_mode="mixed")
    with pytest.raises(ValueError, match="prefill mode"):
        engine.DecodeEngine(tcfg, tparams, device="cpu", max_slots=2, max_seq_len=64,
                            kv_layout="paged", kv_block_size=8, prefill_mode="fused")
    eng = engine.DecodeEngine(tcfg, tparams, device="cpu", max_slots=2, max_seq_len=64,
                              kv_layout="paged", kv_block_size=8, prefill_mode="mixed",
                              prefill_chunk=40)
    assert (eng.mixed, eng.prefill_chunk, eng._mixed_widths) == (True, 40, [8, 16, 32, 64])
    split = engine.DecodeEngine(tcfg, tparams, device="cpu", max_slots=2, max_seq_len=64,
                                kv_layout="paged", kv_block_size=8)
    assert not split.mixed
    # the JAX provider test's config, string-coerced like every other key
    service = TorchCompletionsService({
        "model": {"preset": "tiny"},
        "engine": {"max-slots": "2", "max-seq-len": "64", "kv-layout": "paged",
                   "kv-block-size": "8", "prefill-mode": "mixed", "prefill-chunk": "24",
                   "mixed-carry": "off"},
    }, device="cpu")
    try:  # mixed-carry reaches the engine
        assert (service.engine.prefill_mode, service.engine.mixed,
                service.engine.prefill_chunk, service.engine.mixed_carry) == ("mixed", True, 24, False)
    finally:
        service.engine.stop()
    args = build_parser().parse_args([
        "serve", "--kv-layout", "paged", "--prefill-mode", "mixed", "--prefill-chunk", "32",
        "--mixed-carry", "off",
    ])
    engine_config = serve_config(args)["engine"]
    assert (engine_config["prefill-mode"], engine_config["prefill-chunk"],
            engine_config["mixed-carry"]) == ("mixed", 32, "off")
    defaults = serve_config(build_parser().parse_args(["serve"]))["engine"]
    assert (defaults["prefill-mode"], defaults["prefill-chunk"], defaults["mixed-carry"]) == (
        "split", 64, "on")


def test_mixed_admission_bookkeeping(weights):
    """A 29-token prompt at a 16-token budget takes two mixed steps (the
    second samples its first token), then plain decode chunks; the slot's
    admission state is clear once the request finishes."""
    _, _, tcfg, tparams = weights
    eng = engine.DecodeEngine(tcfg, tparams, device="cpu", prefill_mode="mixed", **ENGINE_ARGS)
    try:
        result = asyncio.run(eng.generate(list(range(1, 30)), engine.SamplingParams(max_new_tokens=3)))
        assert len(result.tokens) == 3
        assert all(not s.prefilling and s.prefill_pos is None and not s.active for s in eng.slots)
        assert eng.stats["prefill_calls"] == 1 and eng.stats["mixed_steps"] == 2
        assert eng.stats["model_dispatches"]["paged_decode_step"] > 0
    finally:
        eng.stop()
