"""The port's model against the JAX package's, on the CPU.

JAX params are drawn once and carried across with ``params_from_jax``;
logits and the written cache rows (dense cache or paged pool) of
prefill, prefill-at-offset and decode steps are compared to 1e-4 of max
|value| (f32 on both sides; the two frameworks sum in another order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu_torch.providers.torch_local import model
from langstream_tpu_torch.providers.torch_local.convert import cache_from_jax, params_from_jax

torch.set_num_threads(2)

PRESETS = ["tiny", "tiny_qwen2", "tiny_gemma2"]
SLOTS, MAX_LEN = 4, 64


def _close(out, ref, rel=1e-4):
    out, ref = np.asarray(out, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-6)
    assert float(np.abs(out - ref).max()) <= rel * scale


def _configs(preset):
    return (
        getattr(jax_model.LlamaConfig, preset)(max_seq_len=MAX_LEN),
        getattr(model.LlamaConfig, preset)(max_seq_len=MAX_LEN),
    )


def _params(jcfg, tcfg, seed=3):
    jparams = jax_model.init_params(jcfg, seed=seed)
    if jcfg.qkv_bias:
        # init draws zero biases; make them count
        rng = np.random.default_rng(seed)
        for name in ("bq", "bk", "bv"):
            jparams[name] = jnp.asarray(
                0.1 * rng.standard_normal(jparams[name].shape, dtype=np.float32)
            )
    np_params = {name: np.asarray(leaf) for name, leaf in jparams.items()}
    return jparams, params_from_jax(np_params, tcfg)


def test_config_fields_and_presets_mirror_jax():
    jax_fields = [f.name for f in dataclasses.fields(jax_model.LlamaConfig)]
    assert [f.name for f in dataclasses.fields(model.LlamaConfig)] == jax_fields
    for preset in ("llama-3-8b", "llama-3.1-8b", "gemma-2-2b", "qwen-2.5-7b", "tiny"):
        jcfg = jax_model.LlamaConfig.from_dict({"preset": preset})
        tcfg = model.LlamaConfig.from_dict({"preset": preset, "dtype": "bfloat16"})
        for name in jax_fields:
            if name != "dtype":
                assert getattr(tcfg, name) == getattr(jcfg, name), (preset, name)
        assert tcfg.dtype == torch.bfloat16


@pytest.mark.parametrize("preset", PRESETS)
def test_prefill_and_decode_match_jax(preset):
    jcfg, tcfg = _configs(preset)
    jparams, tparams = _params(jcfg, tcfg)
    rng = np.random.default_rng(7)
    seq = 24
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, seq)).astype(np.int32)
    lengths = np.array([24, 13], dtype=np.int32)
    slot_ids = np.array([1, 3], dtype=np.int32)

    jfreqs = jax_model.model_freqs(jcfg)
    jcache = jax_model.init_cache(jcfg, SLOTS, MAX_LEN)
    jcache, jlogits = jax.jit(functools.partial(jax_model.prefill, jcfg))(
        jparams, jcache, jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(slot_ids), jfreqs,
    )
    tfreqs = model.model_freqs(tcfg)
    tcache = model.init_cache(tcfg, SLOTS, MAX_LEN)
    tlogits = model.prefill(
        tcfg, tparams, tcache, torch.from_numpy(tokens), torch.from_numpy(lengths),
        torch.from_numpy(slot_ids), tfreqs,
    )
    _close(tlogits.numpy(), jlogits)
    for leaf in ("k", "v"):
        _close(tcache[leaf][:, slot_ids, :seq].numpy(), np.asarray(jcache[leaf])[:, slot_ids, :seq])

    # eight greedy decode steps; slots 0 and 2 ride along masked
    decode = jax.jit(functools.partial(jax_model.decode_step, jcfg))
    active = np.zeros(SLOTS, dtype=bool)
    active[slot_ids] = True
    step_lengths = np.zeros(SLOTS, dtype=np.int32)
    step_tokens = np.zeros(SLOTS, dtype=np.int32)
    step_tokens[slot_ids] = np.asarray(jnp.argmax(jlogits, axis=-1))
    step_lengths[slot_ids] = lengths + 1
    for _ in range(8):
        jcache, jl = decode(
            jparams, jcache, jnp.asarray(step_tokens), jnp.asarray(step_lengths),
            jfreqs, jnp.asarray(active),
        )
        tl = model.decode_step(
            tcfg, tparams, tcache, torch.from_numpy(step_tokens),
            torch.from_numpy(step_lengths), tfreqs, torch.from_numpy(active),
        )
        _close(tl.numpy()[active], np.asarray(jl)[active])
        step_tokens = np.where(active, np.asarray(jnp.argmax(jl, axis=-1)), 0).astype(np.int32)
        step_lengths = np.where(active, step_lengths + 1, step_lengths).astype(np.int32)
    for leaf in ("k", "v"):
        end = int(step_lengths.max()) - 1
        _close(tcache[leaf][:, slot_ids, :end].numpy(), np.asarray(jcache[leaf])[:, slot_ids, :end])


def test_unported_paths_raise():
    """The paths this once refused now run: ``init_params(tiny_moe)`` has
    JAX's leaves and shapes, and ``verify_step`` on it gives JAX's
    logits (a block of 3 after a prefill of 10)."""
    jcfg, tcfg = jax_model.LlamaConfig.tiny_moe(max_seq_len=MAX_LEN), model.LlamaConfig.tiny_moe(
        max_seq_len=MAX_LEN)
    drawn = model.init_params(tcfg)
    assert {k: tuple(v.shape) for k, v in drawn.items()} == {
        k: tuple(v.shape) for k, v in jax_model.init_params(jcfg).items()}
    jparams, tparams = _params(jcfg, tcfg)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, jcfg.vocab_size, size=(2, 10)).astype(np.int32)
    block = rng.integers(0, jcfg.vocab_size, size=(2, 3)).astype(np.int32)
    jcache = jax_model.init_cache(jcfg, 2, MAX_LEN)
    jcache, _ = jax_model.prefill(jcfg, jparams, jcache, jnp.asarray(prompt),
                                  jnp.asarray([10, 10], jnp.int32), jnp.arange(2), jax_model.model_freqs(jcfg))
    tcache = cache_from_jax({k: np.asarray(v) for k, v in jcache.items()})
    step = (block, np.array([11, 11], np.int32), np.array([3, 2], np.int32))
    _, jlogits = jax_model.verify_step(jcfg, jparams, jcache, *map(jnp.asarray, step),
                                       jax_model.model_freqs(jcfg))
    tlogits = model.verify_step(tcfg, tparams, tcache, *(torch.from_numpy(a) for a in step),
                                model.model_freqs(tcfg))
    _close(tlogits[0].numpy(), np.asarray(jlogits)[0])
    _close(tlogits[1, :2].numpy(), np.asarray(jlogits)[1, :2])


def _assert_int8_cache(cache, shape):
    assert set(cache) == {"k", "v", "k_scale", "v_scale"}
    for leaf in ("k", "v"):
        assert cache[leaf].dtype == torch.int8 and tuple(cache[leaf].shape) == shape
        assert cache[leaf + "_scale"].dtype == torch.float32
        assert tuple(cache[leaf + "_scale"].shape) == shape[:-1]
    assert not any(bool(leaf.any()) for leaf in cache.values())


def test_init_cache_int8_dtypes_and_shapes():
    config = model.LlamaConfig.tiny()
    _assert_int8_cache(model.init_cache(config, 3, 40, kv_quant=True), (2, 3, 40, 2, 16))


def test_init_paged_cache_int8_dtypes_and_shapes():
    config = model.LlamaConfig.tiny_gemma2()
    _assert_int8_cache(model.init_paged_cache(config, 9, 8, kv_quant=True), (2, 9, 8, 2, 16))


def _jit(fn, cfg, **kw):
    return jax.jit(functools.partial(fn, cfg, **kw))


def _arrays(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("preset", PRESETS)
def test_dense_prefill_zeros_stale_rows_and_prefill_at_offset_match_jax(preset):
    """Dense ``prefill`` over slots holding stale rows leaves [T, max_len)
    zero, as JAX's ``pad_rows`` does; ``prefill_at_offset`` then extends
    the slots by a suffix (one row at a window past its prefix, one
    padded) and both agree with JAX, cache rows included."""
    jcfg, tcfg = _configs(preset)
    jparams, tparams = _params(jcfg, tcfg)
    rng = np.random.default_rng(11)
    stale = rng.standard_normal((jcfg.num_layers, SLOTS, MAX_LEN, jcfg.num_kv_heads,
                                 jcfg.dims_per_head)).astype(np.float32)
    jcache = {"k": jnp.asarray(stale), "v": jnp.asarray(-stale)}
    tcache = cache_from_jax(jcache)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    lengths = np.array([16, 9], dtype=np.int32)
    slot_ids = np.array([2, 0], dtype=np.int32)
    (jt, jl, js), (tt, tl, ts) = _arrays(tokens, lengths, slot_ids)
    jfreqs, tfreqs = jax_model.model_freqs(jcfg), model.model_freqs(tcfg)
    jcache, jlogits = _jit(jax_model.prefill, jcfg)(jparams, jcache, jt, jl, js, jfreqs)
    tlogits = model.prefill(tcfg, tparams, tcache, tt, tl, ts, tfreqs)
    _close(tlogits.numpy(), jlogits)
    for leaf in ("k", "v"):
        rows = tcache[leaf][:, slot_ids].numpy()
        assert not rows[:, :, 16:].any()
        _close(rows, np.asarray(jcache[leaf])[:, slot_ids])

    suffix = rng.integers(0, jcfg.vocab_size, size=(2, 8)).astype(np.int32)
    suffix_lengths = np.array([8, 5], dtype=np.int32)
    offsets = lengths.copy()
    (jt, jl, jo, js), (tt, tl, to, ts) = _arrays(suffix, suffix_lengths, offsets, slot_ids)
    jcache, jlogits = _jit(jax_model.prefill_at_offset, jcfg)(jparams, jcache, jt, jl, jo, js, jfreqs)
    tlogits = model.prefill_at_offset(tcfg, tparams, tcache, tt, tl, to, ts, tfreqs)
    _close(tlogits.numpy(), jlogits)
    for leaf in ("k", "v"):
        _close(tcache[leaf][:, slot_ids].numpy(), np.asarray(jcache[leaf])[:, slot_ids])


@pytest.mark.parametrize("preset", PRESETS)
def test_paged_prefill_offset_and_decode_match_jax(preset):
    """Paged prefill of two prompts, prefill-at-offset of a third row
    whose table reuses the first prompt's full blocks, then four decode
    steps (a fourth, empty row rides along masked), against the JAX
    reference route; logits and every pool block but the null block."""
    jcfg, tcfg = _configs(preset)
    jparams, tparams = _params(jcfg, tcfg)
    rng = np.random.default_rng(13)
    block, width = 8, MAX_LEN // 8
    num_blocks = SLOTS * width + 1
    jcache = jax_model.init_paged_cache(jcfg, num_blocks, block)
    tcache = model.init_paged_cache(tcfg, num_blocks, block)
    tables = np.zeros((SLOTS, width), dtype=np.int32)
    tables[:3] = (rng.permutation(num_blocks - 1) + 1)[: 3 * width].reshape(3, width)
    tables[2, :2] = tables[0, :2]  # row 2 continues row 0's first 16 tokens
    jfreqs, tfreqs = jax_model.model_freqs(jcfg), model.model_freqs(tcfg)

    prompts = rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    lengths = np.array([24, 13], dtype=np.int32)
    (jt, jl, jtab), (tt, tl, ttab) = _arrays(prompts, lengths, tables[:2])
    jcache, jlogits = _jit(jax_model.paged_prefill, jcfg, kernel="reference")(
        jparams, jcache, jt, jl, jtab, jfreqs)
    tlogits = model.paged_prefill(tcfg, tparams, tcache, tt, tl, ttab, tfreqs)
    _close(tlogits.numpy(), jlogits)

    suffix = rng.integers(0, jcfg.vocab_size, size=(1, 8)).astype(np.int32)
    (jt, jl, jo, jtab), (tt, tl, to, ttab) = _arrays(
        suffix, np.array([8], np.int32), np.array([16], np.int32), tables[2:3])
    jcache, jwarm = _jit(jax_model.paged_prefill_at_offset, jcfg, kernel="reference")(
        jparams, jcache, jt, jl, jo, jtab, jfreqs)
    twarm = model.paged_prefill_at_offset(tcfg, tparams, tcache, tt, tl, to, ttab, tfreqs)
    _close(twarm.numpy(), jwarm)

    decode = _jit(jax_model.paged_decode_step, jcfg, kernel="reference")
    active = np.array([True, True, True, False])
    step_lengths = np.array([25, 14, 25, 0], dtype=np.int32)
    step_tokens = np.zeros(SLOTS, dtype=np.int32)
    step_tokens[:2] = np.asarray(jnp.argmax(jlogits, axis=-1))
    step_tokens[2] = int(jnp.argmax(jwarm[0]))
    for _ in range(4):
        (jtok, jlen, jtab, jact), (ttok, tlen, ttab, tact) = _arrays(
            step_tokens, step_lengths, tables, active)
        jcache, jl = decode(jparams, jcache, jtok, jlen, jtab, jfreqs, jact)
        tl = model.paged_decode_step(tcfg, tparams, tcache, ttok, tlen, ttab, tfreqs, tact)
        _close(tl.numpy()[active], np.asarray(jl)[active])
        step_tokens = np.where(active, np.asarray(jnp.argmax(jl, axis=-1)), 0).astype(np.int32)
        step_lengths = np.where(active, step_lengths + 1, step_lengths).astype(np.int32)
    for leaf in ("k", "v"):
        _close(tcache[leaf][:, 1:].numpy(), np.asarray(jcache[leaf])[:, 1:])
