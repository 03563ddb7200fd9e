"""The port's weight-only int8 weights (``quant.py``) against the JAX
package's, on the CPU.

``quantize`` bit for bit (values and scales, f32 and bf16 weights, exact
.5 ties and an all-zero channel); ``dq`` and ``qmatmul`` (the port of
``qeinsum``) to 1e-6 of max |JAX|; ``params_from_jax`` of a quantized
param dict. Model: prefill, decode and prefill-at-offset on the dense
cache, paged prefill, decode and one mixed step on the pool, with the
JAX ``quantize_params`` of the same weights on both sides, on ``tiny``,
``tiny_qwen2`` and ``tiny_gemma2``: logits to 1e-4 of max |JAX| (f32;
the two frameworks sum in another order). Engine: greedy and seeded
token streams of the port's int8 engine equal the JAX int8 engine's;
``init_quantized_params`` draws int8 directly and serves a request.
Weight cache (``init_quantized_params_cached``, as the JAX package's
cases in ``tests/test_quant.py`` and ``tests/test_observability.py``): a
cached load equals a fresh draw bit for bit; a norm-convention flip and
another seed get entries of their own and their own weights; a corrupt
entry is drawn again; with no directory it is the plain draw; a stale
temporary file is swept and a fresh one kept; the provider's int8 draw
goes through it under ``LS_WEIGHTS_CACHE_DIR``.
"""

import asyncio
import dataclasses
import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.providers.jax_local import quant as jax_quant
from langstream_tpu_torch.providers.torch_local import engine, model, quant
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax

torch.set_num_threads(2)

PRESETS = ["tiny", "tiny_qwen2", "tiny_gemma2"]
SLOTS, MAX_LEN, BLOCK = 4, 64, 8
LOGITS_TOLERANCE = 1e-4
OP_TOLERANCE = 1e-6


def _close(out, ref, rel):
    out, ref = np.asarray(out, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-6)
    assert float(np.abs(out - ref).max()) <= rel * scale


def _t(array):
    return torch.from_numpy(np.array(array))  # a writable copy of a JAX buffer


# ---------------------------------------------------------------------- #
# ops
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 40, 24), dtype=np.float32)
    w[0, :, 0] = 0.0  # an all-zero channel: the 1e-8 floor
    # exact .5 ties: abs-max 127 makes the scale 1, so w / scale keeps the .5
    w[1, :, 2] = np.arange(40, dtype=np.float32) - 20.5
    w[1, 0, 2] = 127.0
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    ref = jax_quant.quantize(jw)
    got = quant.quantize(tw)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert tuple(got.scale.shape) == (3, 24)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    # every tie rounds half to even (numpy's rule): -19.5 → -20, 18.5 → 18
    np.testing.assert_array_equal(got.q.numpy()[1, 1:, 2], np.round(w[1, 1:, 2]))
    # another contraction axis: the scale drops that axis
    ref0, got0 = jax_quant.quantize(jw, contract_axis=0), quant.quantize(tw, contract_axis=0)
    np.testing.assert_array_equal(got0.q.numpy(), np.asarray(ref0.q))
    np.testing.assert_array_equal(got0.scale.numpy(), np.asarray(ref0.scale))


def test_dq_qmatmul_and_layer_slicing_match_jax():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((2, 32, 48), dtype=np.float32)
    x = rng.standard_normal((5, 3, 32), dtype=np.float32)
    jq = jax_quant.quantize(jnp.asarray(w))
    tq = quant.quantize(torch.from_numpy(w))
    for layer in range(2):
        ref = jax_quant.qeinsum("...h,hd->...d", jnp.asarray(x), jax_quant.QTensor(jq.q[layer], jq.scale[layer]))
        sliced = tq[layer]
        assert tuple(sliced.q.shape) == (32, 48) and tuple(sliced.scale.shape) == (48,)
        _close(quant.qmatmul(torch.from_numpy(x), sliced).numpy(), ref, OP_TOLERANCE)
        _close(quant.dq(sliced, torch.float32).numpy(),
               jax_quant.dq(jax_quant.QTensor(jq.q[layer], jq.scale[layer]), jnp.float32), OP_TOLERANCE)
    # a plain weight: qmatmul is x @ w in x's dtype
    plain = torch.from_numpy(w[0])
    assert torch.equal(quant.qmatmul(torch.from_numpy(x), plain), torch.from_numpy(x) @ plain)
    with pytest.raises(IndexError, match="stacked"):
        tq[0][1]


def test_quantize_params_and_params_from_jax():
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=MAX_LEN)
    tcfg = model.LlamaConfig.tiny(max_seq_len=MAX_LEN)
    jparams = jax_quant.quantize_params(jax_model.init_params(jcfg, seed=1))
    tparams = params_from_jax(jparams, tcfg)
    assert set(tparams) == set(jparams)
    for name, leaf in tparams.items():
        if name in jax_quant.QUANTIZED_PARAMS:
            assert isinstance(leaf, quant.QTensor), name
            assert leaf.q.dtype == torch.int8 and leaf.scale.dtype == torch.float32
            np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(jparams[name].q))
            np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(jparams[name].scale))
        else:
            assert isinstance(leaf, torch.Tensor), name
    assert quant.QUANTIZED_PARAMS == jax_quant.QUANTIZED_PARAMS
    # the port's quantize_params of the f32 weights gives the same leaves;
    # quantized leaves pass through
    f32 = params_from_jax(jax_model.init_params(jcfg, seed=1), tcfg)
    requantized = quant.quantize_params(f32)
    for name in quant.QUANTIZED_PARAMS:
        if name in f32:
            assert torch.equal(requantized[name].q, tparams[name].q), name
    assert quant.quantize_params(requantized)["wq"] is requantized["wq"]


# ---------------------------------------------------------------------- #
# model calls
# ---------------------------------------------------------------------- #
def _quantized_params(preset):
    jcfg = getattr(jax_model.LlamaConfig, preset)(max_seq_len=MAX_LEN)
    tcfg = getattr(model.LlamaConfig, preset)(max_seq_len=MAX_LEN)
    jparams = jax_model.init_params(jcfg, seed=3)
    if jcfg.qkv_bias:
        # init draws zero biases; make them count (they stay f32)
        rng = np.random.default_rng(3)
        for name in ("bq", "bk", "bv"):
            jparams[name] = jnp.asarray(0.1 * rng.standard_normal(jparams[name].shape, dtype=np.float32))
    jparams = jax_quant.quantize_params(jparams)
    return jcfg, tcfg, jparams, params_from_jax(jparams, tcfg)


def _jit(fn, cfg, **kw):
    return jax.jit(functools.partial(fn, cfg, **kw))


@pytest.mark.parametrize("preset", PRESETS)
def test_int8_weight_dense_calls_match_jax(preset):
    """Prefill of two rows, three decode steps (two rows ride along
    masked), then a prefill-at-offset of a third row onto its own
    prefix: logits against the JAX int8 model."""
    jcfg, tcfg, jparams, tparams = _quantized_params(preset)
    assert isinstance(tparams["wq"], quant.QTensor)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    lengths = np.array([24, 13], dtype=np.int32)
    slot_ids = np.array([1, 3], dtype=np.int32)
    jfreqs, tfreqs = jax_model.model_freqs(jcfg), model.model_freqs(tcfg)
    jcache = jax_model.init_cache(jcfg, SLOTS, MAX_LEN)
    tcache = model.init_cache(tcfg, SLOTS, MAX_LEN)
    jcache, jlogits = _jit(jax_model.prefill, jcfg)(
        jparams, jcache, *(jnp.asarray(a) for a in (tokens, lengths, slot_ids)), jfreqs)
    tlogits = model.prefill(tcfg, tparams, tcache, *(_t(a) for a in (tokens, lengths, slot_ids)), tfreqs)
    _close(tlogits.numpy(), jlogits, LOGITS_TOLERANCE)
    active = np.zeros(SLOTS, dtype=bool)
    active[slot_ids] = True
    step_tokens = np.zeros(SLOTS, dtype=np.int32)
    step_tokens[slot_ids] = np.asarray(jnp.argmax(jlogits, axis=-1))
    step_lengths = np.zeros(SLOTS, dtype=np.int32)
    step_lengths[slot_ids] = lengths + 1
    decode = _jit(jax_model.decode_step, jcfg)
    for _ in range(3):
        jcache, jl = decode(jparams, jcache, jnp.asarray(step_tokens), jnp.asarray(step_lengths),
                            jfreqs, jnp.asarray(active))
        tl = model.decode_step(tcfg, tparams, tcache, _t(step_tokens), _t(step_lengths), tfreqs,
                               _t(active))
        _close(tl.numpy()[active], np.asarray(jl)[active], LOGITS_TOLERANCE)
        step_tokens = np.where(active, np.asarray(jnp.argmax(jl, axis=-1)), 0).astype(np.int32)
        step_lengths = np.where(active, step_lengths + 1, step_lengths).astype(np.int32)
    suffix = rng.integers(0, jcfg.vocab_size, size=(1, 8)).astype(np.int32)
    args = (suffix, np.array([8], np.int32), np.array([16], np.int32), np.array([0], np.int32))
    jcache, jl = _jit(jax_model.prefill, jcfg)(
        jparams, jcache, jnp.asarray(tokens[:1, :16]), jnp.asarray([16], jnp.int32),
        jnp.asarray([0], jnp.int32), jfreqs)
    model.prefill(tcfg, tparams, tcache, _t(tokens[:1, :16]), torch.tensor([16], dtype=torch.int32),
                  torch.tensor([0], dtype=torch.int32), tfreqs)
    jcache, jl = _jit(jax_model.prefill_at_offset, jcfg)(
        jparams, jcache, *(jnp.asarray(a) for a in args), jfreqs)
    tl = model.prefill_at_offset(tcfg, tparams, tcache, *(_t(a) for a in args), tfreqs)
    _close(tl.numpy(), jl, LOGITS_TOLERANCE)


@pytest.mark.parametrize("preset", PRESETS)
def test_int8_weight_paged_and_mixed_calls_match_jax(preset):
    """Paged prefill of two prompts, two paged decode steps, then one
    mixed step (both prompts decoding, a cold window of 8, an idle row),
    the port's fused route against the JAX reference route."""
    jcfg, tcfg, jparams, tparams = _quantized_params(preset)
    rng = np.random.default_rng(11)
    width_blocks = MAX_LEN // BLOCK
    num_blocks = SLOTS * width_blocks + 1
    tables = (rng.permutation(num_blocks - 1) + 1).reshape(SLOTS, width_blocks).astype(np.int32)
    jfreqs, tfreqs = jax_model.model_freqs(jcfg), model.model_freqs(tcfg)
    jcache = jax_model.init_paged_cache(jcfg, num_blocks, BLOCK)
    tcache = model.init_paged_cache(tcfg, num_blocks, BLOCK)
    prompts = rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    lengths = np.array([24, 13], dtype=np.int32)
    jcache, jl = _jit(jax_model.paged_prefill, jcfg, kernel="reference")(
        jparams, jcache, jnp.asarray(prompts), jnp.asarray(lengths), jnp.asarray(tables[:2]), jfreqs)
    tl = model.paged_prefill(tcfg, tparams, tcache, _t(prompts), _t(lengths), _t(tables[:2]), tfreqs)
    _close(tl.numpy(), jl, LOGITS_TOLERANCE)
    active = np.array([True, True, False, False])
    step_tokens = np.zeros(SLOTS, dtype=np.int32)
    step_tokens[:2] = np.asarray(jnp.argmax(jl, axis=-1))
    step_lengths = np.array([25, 14, 0, 0], dtype=np.int32)
    decode = _jit(jax_model.paged_decode_step, jcfg, kernel="reference")
    for _ in range(2):
        jcache, jl = decode(jparams, jcache, jnp.asarray(step_tokens), jnp.asarray(step_lengths),
                            jnp.asarray(tables), jfreqs, jnp.asarray(active))
        tl = model.paged_decode_step(tcfg, tparams, tcache, _t(step_tokens), _t(step_lengths),
                                     _t(tables), tfreqs, _t(active))
        _close(tl.numpy()[active], np.asarray(jl)[active], LOGITS_TOLERANCE)
        step_tokens = np.where(active, np.asarray(jnp.argmax(jl, axis=-1)), 0).astype(np.int32)
        step_lengths = np.where(active, step_lengths + 1, step_lengths).astype(np.int32)
    width = 8
    tokens = np.zeros((SLOTS, width), dtype=np.int32)
    tokens[:2, 0] = step_tokens[:2]
    tokens[2] = rng.integers(0, jcfg.vocab_size, size=width)
    offsets = np.array([step_lengths[0] - 1, step_lengths[1] - 1, 0, 0], dtype=np.int32)
    num_tokens = np.array([1, 1, width, 0], dtype=np.int32)
    args = (tokens, offsets, num_tokens, tables)
    jcache, jl = _jit(jax_model.paged_mixed_step, jcfg, kernel="reference")(
        jparams, jcache, *(jnp.asarray(a) for a in args), jfreqs)
    tl = model.paged_mixed_step(tcfg, tparams, tcache, *(_t(a) for a in args), tfreqs)
    live = num_tokens > 0
    _close(tl.numpy()[live], np.asarray(jl)[live], LOGITS_TOLERANCE)


# ---------------------------------------------------------------------- #
# engine
# ---------------------------------------------------------------------- #
ENGINE_ARGS = dict(max_slots=4, max_seq_len=128, prefill_buckets=[32], decode_chunk=4, seed=0)


def _generate(eng, requests):
    async def main():
        return await asyncio.gather(*[
            eng.generate(prompt, params, stop_tokens=stops) for prompt, params, stops in requests
        ])

    return asyncio.run(main())


@pytest.mark.parametrize("preset,layout,prequantized", [
    ("tiny", "dense", False), ("tiny", "paged", True), ("tiny_qwen2", "dense", True)])
def test_int8_weight_engine_streams_match_jax(preset, layout, prequantized):
    """Greedy (with penalties) and seeded (temperature, top-k, top-p,
    bias) streams, one prompt past the largest bucket: the port's engine
    with ``quantize="int8"`` (or handed the JAX-quantized params) against
    the JAX engine with ``quantize="int8"`` over the same weights."""
    jcfg = getattr(jax_model.LlamaConfig, preset)(max_seq_len=128)
    tcfg = getattr(model.LlamaConfig, preset)(max_seq_len=128)
    jparams = jax_model.init_params(jcfg, seed=5)
    handed = jax_quant.quantize_params(jparams) if prequantized else jparams
    tparams = params_from_jax(handed, tcfg)
    paged = dict(kv_layout="paged", kv_block_size=8) if layout == "paged" else {}
    ported = engine.DecodeEngine(tcfg, tparams, device="cpu", quantize=None if prequantized else "int8",
                                 **ENGINE_ARGS, **paged)
    reference = jax_engine.DecodeEngine(
        jcfg, jparams, quantize="int8", prefix_cache=layout == "paged",
        **({"paged_kernel": "reference"} if paged else {}), **ENGINE_ARGS, **paged)
    try:
        assert all(isinstance(ported.params[name], quant.QTensor)
                   for name in quant.QUANTIZED_PARAMS if name in ported.params)
        rng = np.random.default_rng(31)

        def prompt(n):
            return rng.integers(0, 256, size=n).tolist()

        S = engine.SamplingParams
        requests = [
            (prompt(5), S(frequency_penalty=1.5, max_new_tokens=12), set()),
            (prompt(17), S(temperature=0.8, seed=11, max_new_tokens=10), set()),
            (prompt(30), S(temperature=1.0, top_k=20, seed=5, max_new_tokens=14), set()),
            (prompt(9), S(temperature=0.9, top_p=0.8, seed=3, presence_penalty=0.5,
                          logit_bias={7: 5.0}, max_new_tokens=9), set()),
            (prompt(45), S(max_new_tokens=8), set()),
        ]
        got = _generate(ported, requests)
        want = _generate(reference, [(p, jax_engine.SamplingParams(**s.__dict__), st)
                                     for p, s, st in requests])
        for index, (mine, theirs) in enumerate(zip(got, want)):
            assert mine.tokens == theirs.tokens, index
            np.testing.assert_allclose(mine.logprobs, theirs.logprobs, rtol=1e-4, atol=1e-4)
        assert [len(r.tokens) for r in got] == [12, 10, 14, 9, 8]
    finally:
        ported.stop()
        reference.stop()


def test_engine_refuses_unknown_quantization():
    config = model.LlamaConfig.tiny(max_seq_len=64)
    params = model.init_params(config)
    with pytest.raises(ValueError, match="unknown quantization"):
        engine.DecodeEngine(config, params, device="cpu", quantize="fp4")
    with pytest.raises(ValueError, match="unknown quantization"):
        engine.DecodeEngine(config, quant.quantize_params(params), device="cpu", quantize="int4")


@pytest.mark.parametrize("preset", ["tiny", "tiny_gemma2"])
def test_init_quantized_params_direct_shapes_and_one_request(preset):
    """The direct init draws every matmul weight in int8 (scales f32, one
    per output channel), the embedding in the model dtype and the norms
    (and Qwen-2 biases) in f32, and an engine serves a request from it."""
    config = getattr(model.LlamaConfig, preset)(max_seq_len=64)
    params = quant.init_quantized_params(config, seed=2, direct=True)
    h, f, layers = config.hidden_size, config.intermediate_size, config.num_layers
    q_width, kv_width = config.num_heads * config.dims_per_head, config.num_kv_heads * config.dims_per_head
    shapes = {"wq": (layers, h, q_width), "wk": (layers, h, kv_width), "wv": (layers, h, kv_width),
              "wo": (layers, q_width, h), "w_gate": (layers, h, f), "w_up": (layers, h, f),
              "w_down": (layers, f, h)}
    if not config.tie_embeddings:
        shapes["lm_head"] = (h, config.vocab_size)
    for name, shape in shapes.items():
        leaf = params[name]
        assert isinstance(leaf, quant.QTensor) and tuple(leaf.q.shape) == shape, name
        assert leaf.q.dtype == torch.int8 and leaf.scale.dtype == torch.float32
        assert tuple(leaf.scale.shape) == shape[:-2] + shape[-1:]
        assert int(leaf.q.min()) >= -127 and int(leaf.q.max()) <= 127
    assert ("lm_head" in params) == (not config.tie_embeddings)
    assert params["embedding"].dtype == config.dtype
    assert tuple(params["embedding"].shape) == (config.vocab_size, h)
    for name in ("attn_norm", "mlp_norm", "final_norm"):
        assert params[name].dtype == torch.float32
    assert ("post_attn_norm" in params) == config.post_norms
    # the same seed draws the same weights
    again = quant.init_quantized_params(config, seed=2, direct=True)
    assert torch.equal(again["w_up"].q, params["w_up"].q)
    # small models go through init + quantize_params unless asked
    assert torch.equal(
        quant.init_quantized_params(config, seed=2)["wq"].q,
        quant.quantize_params(model.init_params(config, seed=2))["wq"].q)
    eng = engine.DecodeEngine(config, params, device="cpu", max_slots=2, prefill_buckets=[16])
    try:
        assert isinstance(eng.params["wq"], quant.QTensor)
        result = asyncio.run(eng.generate([1, 2, 3], engine.SamplingParams(max_new_tokens=4)))
        assert len(result.tokens) == 4 and result.finish_reason == "length"
    finally:
        eng.stop()


# ---------------------------------------------------------------------- #
# the weight cache
# ---------------------------------------------------------------------- #
def _assert_same_params(got, want):
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        parts = (("q", "scale") if isinstance(leaf, quant.QTensor) else (None,))
        assert isinstance(got[name], quant.QTensor) == isinstance(leaf, quant.QTensor), name
        for part in parts:
            a = getattr(got[name], part) if part else got[name]
            b = getattr(leaf, part) if part else leaf
            assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device, name
            assert torch.equal(a, b), name


def _entries(path):
    return sorted(n for n in os.listdir(path) if n.endswith(".npz"))


@pytest.mark.parametrize("preset", ["tiny", "tiny_gemma2"])
def test_weights_cache_round_trips_bit_for_bit(tmp_path, preset):
    config = getattr(model.LlamaConfig, preset)(max_seq_len=64)
    fresh = quant.init_quantized_params(config, seed=3)
    first = quant.init_quantized_params_cached(config, seed=3, cache_dir=str(tmp_path))
    assert _entries(tmp_path) == [quant.weights_cache_key(config, 3) + ".npz"]
    _assert_same_params(first, fresh)
    loaded = quant.init_quantized_params_cached(config, seed=3, cache_dir=str(tmp_path))
    _assert_same_params(loaded, fresh)  # bf16 and int8 leaves through the file
    # another seed is an entry of its own, with other weights
    other = quant.init_quantized_params_cached(config, seed=4, cache_dir=str(tmp_path))
    assert len(_entries(tmp_path)) == 2
    assert not torch.equal(other["wq"].q, fresh["wq"].q)


def test_weights_cache_key_separates_norm_conventions(tmp_path):
    config = model.LlamaConfig.tiny(max_seq_len=64)
    flipped = dataclasses.replace(config, norm_plus_one=True)
    assert config.num_params() == flipped.num_params()
    quant.init_quantized_params_cached(config, cache_dir=str(tmp_path))
    quant.init_quantized_params_cached(flipped, cache_dir=str(tmp_path))
    assert len(_entries(tmp_path)) == 2
    warm_flipped = quant.init_quantized_params_cached(flipped, cache_dir=str(tmp_path))
    warm = quant.init_quantized_params_cached(config, cache_dir=str(tmp_path))
    assert not torch.equal(warm_flipped["final_norm"], warm["final_norm"])
    _assert_same_params(warm_flipped, quant.init_quantized_params(flipped))
    # the keys of the other conventions differ too
    keys = {quant.weights_cache_key(dataclasses.replace(config, **{field: True}), 0)
            for field in ("norm_plus_one", "post_norms", "qkv_bias", "tie_embeddings")}
    assert len(keys | {quant.weights_cache_key(config, 0)}) == 5


def test_weights_cache_heals_a_corrupt_entry(tmp_path):
    config = model.LlamaConfig.tiny(max_seq_len=64)
    quant.init_quantized_params_cached(config, seed=5, cache_dir=str(tmp_path))
    (entry,) = _entries(tmp_path)
    (tmp_path / entry).write_bytes(b"garbage")
    healed = quant.init_quantized_params_cached(config, seed=5, cache_dir=str(tmp_path))
    _assert_same_params(healed, quant.init_quantized_params(config, seed=5))
    assert _entries(tmp_path) == [entry] and (tmp_path / entry).stat().st_size > 1000
    _assert_same_params(quant.init_quantized_params_cached(config, seed=5,
                                                           cache_dir=str(tmp_path)), healed)


def test_weights_cache_off_is_the_plain_draw(tmp_path, monkeypatch):
    config = model.LlamaConfig.tiny(max_seq_len=64)
    monkeypatch.delenv("LS_WEIGHTS_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    _assert_same_params(quant.init_quantized_params_cached(config, seed=6),
                        quant.init_quantized_params(config, seed=6))
    assert os.listdir(tmp_path) == []
    # a tp rank's shard is never cached
    shard = quant.init_quantized_params_cached(config, seed=6, cache_dir=str(tmp_path / "c"),
                                               keep=lambda name, leaf: leaf)
    _assert_same_params(shard, quant.init_quantized_params(config, seed=6))
    assert not (tmp_path / "c").exists()
    # the environment turns it on
    monkeypatch.setenv("LS_WEIGHTS_CACHE_DIR", str(tmp_path / "env"))
    quant.init_quantized_params_cached(config, seed=6)
    assert len(_entries(tmp_path / "env")) == 1


def test_weights_cache_sweeps_stale_temporary_files(tmp_path):
    config = model.LlamaConfig.tiny(max_seq_len=64)
    stale, live = tmp_path / "x.npz.tmp123.npz", tmp_path / "y.npz.tmp456.npz"
    stale.write_bytes(b"partial")
    live.write_bytes(b"partial")
    old = time.time() - 600
    os.utime(stale, (old, old))
    quant.init_quantized_params_cached(config, cache_dir=str(tmp_path))
    assert not stale.exists() and live.exists()
    assert not any(".tmp" in n for n in os.listdir(tmp_path) if n != live.name)


def test_provider_int8_draw_goes_through_the_weights_cache(tmp_path, monkeypatch):
    from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService

    monkeypatch.setenv("LS_WEIGHTS_CACHE_DIR", str(tmp_path))
    config = {"model": {"preset": "tiny"}, "quantization": "int8", "seed": 2,
              "engine": {"max-slots": 2, "max-seq-len": 64, "supervisor": False}}
    services = [TorchCompletionsService(config, device="cpu") for _ in range(2)]
    try:
        assert len(_entries(tmp_path)) == 1
        _assert_same_params(services[1].engine.params, services[0].engine.params)
    finally:
        for service in services:
            service.close()
