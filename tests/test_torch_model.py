"""The port's model against the JAX package's, on the CPU.

JAX params are drawn once and carried across with ``params_from_jax``;
prefill logits, the written cache rows and eight decode steps are
compared to 1e-4 of max |value| (f32 on both sides; the two frameworks
sum in another order).
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
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax

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
    moe = model.LlamaConfig.tiny_moe()
    with pytest.raises(NotImplementedError):
        model.init_params(moe)
    with pytest.raises(NotImplementedError):
        model.prefill_at_offset()
    with pytest.raises(NotImplementedError):
        model.verify_step()
    with pytest.raises(NotImplementedError):
        model.init_cache(model.LlamaConfig.tiny(), 1, kv_quant=True)
