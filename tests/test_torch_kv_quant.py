"""The port's int8 KV cache against the JAX package's, on the CPU.

Ops: ``quantize_kv`` bit for bit; the four plain int8 attention functions
to 1e-5 of max |reference|; the int8 kernel wrappers' CPU path (their
plain versions) against the JAX Pallas kernels run in interpret mode, to
the 2e-4 the JAX package's own kernel tests use (the online softmax
reassociates the f32 sums). Model: int8 dense prefill, decode and
prefill-at-offset, and int8 paged prefill (both routes), prefill-at-offset
and decode, against JAX on ``tiny``, ``tiny_qwen2`` and ``tiny_gemma2``:
logits to 1e-4 of max, cache values within one quantum (activations that
differ in the last place may round across a .5), scales to 1e-5
relative. Inputs come from numpy seeds; everything is f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.ops import attention as jax_attention
from langstream_tpu.ops.decode_kernel import flash_decode_attention_quant as jax_flash_decode_quant
from langstream_tpu.ops.flash_attention import flash_prefill_attention_quant as jax_flash_prefill_quant
from langstream_tpu.ops.paged_attention import ragged_paged_attention_quant as jax_ragged_quant
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu_torch.ops import attention
from langstream_tpu_torch.ops.decode_kernel import flash_decode_attention_quant
from langstream_tpu_torch.ops.flash_attention import flash_prefill_attention_quant
from langstream_tpu_torch.ops.paged_attention import ragged_paged_attention_quant
from langstream_tpu_torch.providers.torch_local import model
from langstream_tpu_torch.providers.torch_local.convert import cache_from_jax, params_from_jax

torch.set_num_threads(2)

GQA = [(4, 4), (4, 2), (8, 2)]
DIM = 32
PRESETS = ["tiny", "tiny_qwen2", "tiny_gemma2"]
SLOTS, MAX_LEN = 4, 64


def _draw(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _t(array):
    return torch.from_numpy(np.array(array))  # a writable copy of a JAX buffer


def _close(out, ref, rel):
    out, ref = np.asarray(out, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-6)
    assert float(np.abs(out - ref).max()) <= rel * scale


def _quantized(rng, *shape):
    """Seeded activations [..., D] through the JAX quantizer: (values,
    scales) as numpy, the same arrays for both sides."""
    q, s = jax_attention.quantize_kv(jnp.asarray(_draw(rng, *shape)))
    return np.asarray(q), np.asarray(s)


# ---------------------------------------------------------------------- #
# quantize_kv
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(3)
    x = 3.0 * _draw(rng, 5, 7, 2, DIM)
    x[0, 0, 0] = 0.0  # an all-zero row: the 1e-8 clamp
    # exact .5 ties: amax 127 makes the scale 1, so x / scale keeps the .5
    x[1, 2, 1] = np.arange(DIM, dtype=np.float32) - 16.5
    x[1, 2, 1, 0] = 127.0
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref_values, ref_scales = jax_attention.quantize_kv(jx)
    tx = _t(x).to(getattr(torch, dtype))
    values, scales = attention.quantize_kv(tx)
    assert values.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_values))
    np.testing.assert_array_equal(scales.numpy().view(np.uint32), np.asarray(ref_scales).view(np.uint32))
    assert not values[0, 0, 0].any()
    # half to even: -15.5 → -16, -14.5 → -14, -13.5 → -14, -12.5 → -12
    assert values[1, 2, 1, 1:5].tolist() == [-16, -14, -14, -12]


# ---------------------------------------------------------------------- #
# the plain int8 attention functions against JAX's
# ---------------------------------------------------------------------- #
FAMILIES = [(None, 0, None), (30.0, 0, None), (None, 12, 0.3), (30.0, 12, None)]


def _jax_family(softcap, window, scale):
    return dict(softcap=softcap, window=jnp.int32(window) if window else None, scale=scale)


def _jax_jit(fn):
    """One compiled JAX reference per shape and family (cheaper here than
    dispatching its ops one by one)."""
    return jax.jit(fn, static_argnames=("softcap", "scale"))


@pytest.mark.parametrize("heads,kv_heads", GQA)
@pytest.mark.parametrize("softcap,window,scale", FAMILIES)
def test_decode_and_chunk_attention_quant_match_jax(heads, kv_heads, softcap, window, scale):
    rng = np.random.default_rng(heads * 10 + kv_heads)
    max_len = 40
    kc, ks = _quantized(rng, 4, max_len, kv_heads, DIM)
    vc, vs = _quantized(rng, 4, max_len, kv_heads, DIM)
    family = dict(softcap=softcap, window=window, scale=scale)
    # decode: a full row, a block-boundary row, a single token, an empty row
    lengths = np.array([40, 16, 1, 0], dtype=np.int32)
    q = _draw(rng, 4, heads, DIM)
    ref = _jax_jit(jax_attention.decode_attention_quant)(
        *map(jnp.asarray, (q, kc, ks, vc, vs, lengths)), **_jax_family(**family))
    out = attention.decode_attention_quant(*map(_t, (q, kc, ks, vc, vs, lengths)), **family)
    for b in np.flatnonzero(lengths):
        _close(out[b].numpy(), ref[b], 1e-5)
    # prefill-at-offset: warm rows, a cold row, a single new token
    starts = np.array([20, 0, 39, 8], dtype=np.int32)
    news = np.array([8, 8, 1, 5], dtype=np.int32)
    q = _draw(rng, 4, 8, heads, DIM)
    ref = _jax_jit(jax_attention.chunk_attention_quant)(
        *map(jnp.asarray, (q, kc, ks, vc, vs, starts, starts + news)), **_jax_family(**family))
    out = attention.chunk_attention_quant(*map(_t, (q, kc, ks, vc, vs, starts, starts + news)), **family)
    for b, n in enumerate(news):
        _close(out[b, :n].numpy(), ref[b, :n], 1e-5)


def _pool(rng, batch, width, block, kv_heads):
    """Int8 pools for ``batch`` rows of ``width`` table entries through a
    shuffled table; rows 0 and 1 share their first two blocks."""
    num_blocks = batch * width + 1
    tables = (rng.permutation(num_blocks - 1) + 1)[: batch * width]
    tables = tables.reshape(batch, width).astype(np.int32)
    tables[1, :2] = tables[0, :2]
    k_pool, k_scale = _quantized(rng, num_blocks, block, kv_heads, DIM)
    v_pool, v_scale = _quantized(rng, num_blocks, block, kv_heads, DIM)
    return (k_pool, k_scale, v_pool, v_scale), tables


@pytest.mark.parametrize("heads,kv_heads", GQA)
@pytest.mark.parametrize("softcap,window,scale", FAMILIES)
def test_paged_attention_quant_matches_jax(heads, kv_heads, softcap, window, scale):
    rng = np.random.default_rng(50 + heads * 10 + kv_heads)
    block, width = 8, 8
    family = dict(softcap=softcap, window=window, scale=scale)
    # decode over empty, single-token, block-boundary and max-table rows
    lengths = np.array([64, 17, 1, 16, 0], dtype=np.int32)
    pools, tables = _pool(rng, len(lengths), width, block, kv_heads)
    q = _draw(rng, len(lengths), heads, DIM)
    ref = _jax_jit(jax_attention.paged_decode_attention_quant)(
        *map(jnp.asarray, (q, *pools, tables, lengths)), **_jax_family(**family))
    out = attention.paged_decode_attention_quant(*map(_t, (q, *pools, tables, lengths)), **family)
    for b in np.flatnonzero(lengths):
        _close(out[b].numpy(), ref[b], 1e-5)
    starts = np.array([20, 5, 0, 40, 6, 54], dtype=np.int32)
    news = np.array([10, 10, 3, 1, 10, 10], dtype=np.int32)
    pools, tables = _pool(rng, len(starts), width, block, kv_heads)
    q = _draw(rng, len(starts), 10, heads, DIM)
    ref = _jax_jit(jax_attention.paged_chunk_attention_quant)(
        *map(jnp.asarray, (q, *pools, tables, starts, starts + news)), **_jax_family(**family))
    out = attention.paged_chunk_attention_quant(
        *map(_t, (q, *pools, tables, starts, starts + news)), **family)
    for b, n in enumerate(news):
        _close(out[b, :n].numpy(), ref[b, :n], 1e-5)


# ---------------------------------------------------------------------- #
# the wrappers' CPU path against the JAX Pallas kernels (interpret mode)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("heads,kv_heads,softcap,window", [(4, 4, None, 0), (8, 2, 30.0, 40)])
def test_flash_prefill_quant_matches_pallas_kernel(heads, kv_heads, softcap, window):
    rng = np.random.default_rng(7 + heads)
    batch, seq = 2, 128
    q = _draw(rng, batch, seq, heads, DIM)
    kq, ks = _quantized(rng, batch, seq, kv_heads, DIM)
    vq, vs = _quantized(rng, batch, seq, kv_heads, DIM)
    lengths = np.array([128, 70], dtype=np.int32)
    ref = jax_flash_prefill_quant(
        *map(jnp.asarray, (q, kq, ks, vq, vs)), lengths=jnp.asarray(lengths), softcap=softcap,
        window=jnp.int32(window), block_q=128, block_k=128, interpret=True)
    before = flash_prefill_attention_quant.launches
    out = flash_prefill_attention_quant(
        *map(_t, (q, kq, ks, vq, vs)), lengths=_t(lengths), softcap=softcap, window=window)
    assert flash_prefill_attention_quant.launches == before  # the CPU path counts nothing
    for b, n in enumerate(lengths):
        _close(out[b, :n].numpy(), ref[b, :n], 2e-4)


@pytest.mark.parametrize("heads,kv_heads,softcap,window", [(8, 4, None, 0), (8, 2, 30.0, 50)])
def test_flash_decode_quant_matches_pallas_kernel(heads, kv_heads, softcap, window):
    rng = np.random.default_rng(17 + heads)
    slots, max_len = 4, 128
    q = _draw(rng, slots, heads, DIM)
    kc, ks = _quantized(rng, slots, max_len, kv_heads, DIM)
    vc, vs = _quantized(rng, slots, max_len, kv_heads, DIM)
    lengths = np.array([128, 64, 1, 77], dtype=np.int32)
    ref = jax_flash_decode_quant(
        *map(jnp.asarray, (q, kc, ks, vc, vs, lengths)), softcap=softcap, window=jnp.int32(window),
        block_k=64, interpret=True)
    before = flash_decode_attention_quant.launches
    out = flash_decode_attention_quant(
        *map(_t, (q, kc, ks, vc, vs, lengths)), softcap=softcap, window=window)
    assert flash_decode_attention_quant.launches == before
    _close(out.numpy(), ref, 2e-4)


@pytest.mark.parametrize("window", [0, 300])
def test_flash_decode_quant_matches_pallas_kernel_at_split_edges(window):
    """Llama-3-8B's group (32 q / 8 kv heads, D 128) over T 1024, lengths
    at every key-tile edge of the card kernel (64-key tiles) and where its
    split over the cluster's two CTAs changes, with and without a window
    whose first key falls inside a tile."""
    rng = np.random.default_rng(19)
    lengths = np.array([0, 1, 63, 64, 65, 255, 256, 257, 511, 512, 513, 1024], dtype=np.int32)
    slots, max_len, heads, kv_heads, dim = len(lengths), 1024, 32, 8, 128
    q = _draw(rng, slots, heads, dim)
    kc, ks = _quantized(rng, slots, max_len, kv_heads, dim)
    vc, vs = _quantized(rng, slots, max_len, kv_heads, dim)
    ref = jax_flash_decode_quant(
        *map(jnp.asarray, (q, kc, ks, vc, vs, lengths)), window=jnp.int32(window),
        block_k=64, interpret=True)
    out = flash_decode_attention_quant(*map(_t, (q, kc, ks, vc, vs, lengths)), window=window)
    for s, n in enumerate(lengths):
        if n:  # an empty slot's row is don't-care on the plain path
            _close(out[s].numpy(), np.asarray(ref)[s], 1e-5)


@pytest.mark.parametrize("seq,heads,kv_heads,softcap,window", [
    (1, 4, 2, None, 0), (1, 8, 2, 30.0, 12), (10, 4, 4, None, 0), (10, 8, 2, 30.0, 12),
])
def test_ragged_paged_quant_matches_pallas_kernel(seq, heads, kv_heads, softcap, window):
    rng = np.random.default_rng(27 + seq + heads)
    if seq == 1:
        lengths = np.array([64, 17, 1, 16], dtype=np.int32)
        starts = lengths - 1
    else:
        starts = np.array([20, 0, 40, 54], dtype=np.int32)
        lengths = starts + np.array([10, 3, 1, 10], dtype=np.int32)
    pools, tables = _pool(rng, len(lengths), 8, 8, kv_heads)
    q = _draw(rng, len(lengths), seq, heads, DIM)
    ref = jax_ragged_quant(
        *map(jnp.asarray, (q, *pools, tables, starts, lengths)), softcap=softcap,
        window=jnp.int32(window), block_q=min(seq, 4), interpret=True)
    before = ragged_paged_attention_quant.launches
    out = ragged_paged_attention_quant(
        *map(_t, (q, *pools, tables, starts, lengths)), softcap=softcap, window=window)
    assert ragged_paged_attention_quant.launches == before
    for b, (start, total) in enumerate(zip(starts, lengths)):
        _close(out[b, : total - start].numpy(), ref[b, : total - start], 2e-4)


# ---------------------------------------------------------------------- #
# the model over an int8 cache against the JAX model
# ---------------------------------------------------------------------- #
def _configs(preset):
    return (
        getattr(jax_model.LlamaConfig, preset)(max_seq_len=MAX_LEN),
        getattr(model.LlamaConfig, preset)(max_seq_len=MAX_LEN),
    )


def _params(jcfg, tcfg, seed=3):
    jparams = jax_model.init_params(jcfg, seed=seed)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed)
        for name in ("bq", "bk", "bv"):
            jparams[name] = jnp.asarray(0.1 * rng.standard_normal(jparams[name].shape, dtype=np.float32))
    return jparams, params_from_jax({name: np.asarray(leaf) for name, leaf in jparams.items()}, tcfg)


def _jit(fn, cfg, **kw):
    return jax.jit(functools.partial(fn, cfg, **kw))


def _arrays(*arrays):
    return [jnp.asarray(a) for a in arrays], [_t(a) for a in arrays]


def _close_cache(tcache, jcache, index=slice(None)):
    """Values within one quantum, scales to 1e-5 relative, on the given
    slots/blocks of every layer."""
    for leaf in ("k", "v"):
        out = tcache[leaf][:, index].numpy().astype(np.int32)
        ref = np.asarray(jcache[leaf])[:, index].astype(np.int32)
        assert int(np.abs(out - ref).max()) <= 1, leaf
        np.testing.assert_allclose(
            tcache[leaf + "_scale"][:, index].numpy(), np.asarray(jcache[leaf + "_scale"])[:, index],
            rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("preset", PRESETS)
def test_int8_dense_prefill_decode_and_offset_match_jax(preset):
    """Int8 dense prefill into slots that hold stale rows (rows [T,
    max_len) of values and scales come out zero), four greedy decode
    steps with two slots riding along masked, then a prefill-at-offset
    of a suffix onto each prompt."""
    jcfg, tcfg = _configs(preset)
    jparams, tparams = _params(jcfg, tcfg)
    rng = np.random.default_rng(11)
    jcache = jax_model.init_cache(jcfg, SLOTS, MAX_LEN, kv_quant=True)
    stale = {name: np.asarray(leaf) for name, leaf in jcache.items()}
    stale["k"] = rng.integers(-127, 128, size=stale["k"].shape).astype(np.int8)
    stale["k_scale"] = np.abs(_draw(rng, *stale["k_scale"].shape))
    jcache = {name: jnp.asarray(leaf) for name, leaf in stale.items()}
    tcache = cache_from_jax(stale)
    assert tcache["k"].dtype == torch.int8 and tcache["k_scale"].dtype == torch.float32
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    lengths = np.array([16, 9], dtype=np.int32)
    slot_ids = np.array([1, 3], dtype=np.int32)
    (jt, jl, js), (tt, tl, ts) = _arrays(tokens, lengths, slot_ids)
    jfreqs, tfreqs = jax_model.model_freqs(jcfg), model.model_freqs(tcfg)
    jcache, jlogits = _jit(jax_model.prefill, jcfg)(jparams, jcache, jt, jl, js, jfreqs)
    tlogits = model.prefill(tcfg, tparams, tcache, tt, tl, ts, tfreqs)
    _close(tlogits.numpy(), jlogits, 1e-4)
    _close_cache(tcache, jcache, slot_ids)
    for leaf in tcache:
        assert not tcache[leaf][:, slot_ids, 16:].any(), leaf

    decode = _jit(jax_model.decode_step, jcfg)
    active = np.zeros(SLOTS, dtype=bool)
    active[slot_ids] = True
    step_lengths = np.zeros(SLOTS, dtype=np.int32)
    step_lengths[slot_ids] = lengths + 1
    step_tokens = np.zeros(SLOTS, dtype=np.int32)
    step_tokens[slot_ids] = np.asarray(jnp.argmax(jlogits, axis=-1))
    for _ in range(4):
        (jtok, jlen, jact), (ttok, tlen, tact) = _arrays(step_tokens, step_lengths, active)
        jcache, jl = decode(jparams, jcache, jtok, jlen, jfreqs, jact)
        tl = model.decode_step(tcfg, tparams, tcache, ttok, tlen, tfreqs, tact)
        _close(tl.numpy()[active], np.asarray(jl)[active], 1e-4)
        step_tokens = np.where(active, np.asarray(jnp.argmax(jl, axis=-1)), 0).astype(np.int32)
        step_lengths = np.where(active, step_lengths + 1, step_lengths).astype(np.int32)
    _close_cache(tcache, jcache)  # the masked slots' stale rows are untouched on both sides

    suffix = rng.integers(0, jcfg.vocab_size, size=(2, 8)).astype(np.int32)
    offsets = step_lengths[slot_ids] - 1
    (jt, jl, jo, js), (tt, tl, to, ts) = _arrays(
        suffix, np.array([8, 5], np.int32), offsets.astype(np.int32), slot_ids)
    jcache, jlogits = _jit(jax_model.prefill_at_offset, jcfg)(jparams, jcache, jt, jl, jo, js, jfreqs)
    tlogits = model.prefill_at_offset(tcfg, tparams, tcache, tt, tl, to, ts, tfreqs)
    _close(tlogits.numpy(), jlogits, 1e-4)
    _close_cache(tcache, jcache, slot_ids)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("kernel", ["fused", "reference"])
def test_int8_paged_prefill_offset_and_decode_match_jax(preset, kernel):
    """Int8 paged prefill of two prompts, prefill-at-offset of a third
    row onto the first prompt's blocks, and four decode steps (an empty
    row rides along), against the JAX reference route; logits, and every
    pool block and scale but the null block's."""
    jcfg, tcfg = _configs(preset)
    jparams, tparams = _params(jcfg, tcfg)
    rng = np.random.default_rng(13)
    block, width = 8, MAX_LEN // 8
    num_blocks = SLOTS * width + 1
    jcache = jax_model.init_paged_cache(jcfg, num_blocks, block, kv_quant=True)
    tcache = cache_from_jax({name: np.asarray(leaf) for name, leaf in jcache.items()})
    tables = np.zeros((SLOTS, width), dtype=np.int32)
    tables[:3] = (rng.permutation(num_blocks - 1) + 1)[: 3 * width].reshape(3, width)
    tables[2, :2] = tables[0, :2]
    jfreqs, tfreqs = jax_model.model_freqs(jcfg), model.model_freqs(tcfg)
    prompts = rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    (jt, jl, jtab), (tt, tl, ttab) = _arrays(prompts, np.array([24, 13], np.int32), tables[:2])
    jcache, jlogits = _jit(jax_model.paged_prefill, jcfg, kernel="reference")(
        jparams, jcache, jt, jl, jtab, jfreqs)
    tlogits = model.paged_prefill(tcfg, tparams, tcache, tt, tl, ttab, tfreqs, kernel=kernel)
    _close(tlogits.numpy(), jlogits, 1e-4)

    suffix = rng.integers(0, jcfg.vocab_size, size=(1, 8)).astype(np.int32)
    (jt, jl, jo, jtab), (tt, tl, to, ttab) = _arrays(
        suffix, np.array([8], np.int32), np.array([16], np.int32), tables[2:3])
    jcache, jwarm = _jit(jax_model.paged_prefill_at_offset, jcfg, kernel="reference")(
        jparams, jcache, jt, jl, jo, jtab, jfreqs)
    twarm = model.paged_prefill_at_offset(tcfg, tparams, tcache, tt, tl, to, ttab, tfreqs, kernel=kernel)
    _close(twarm.numpy(), jwarm, 1e-4)

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
        tl = model.paged_decode_step(tcfg, tparams, tcache, ttok, tlen, ttab, tfreqs, tact, kernel=kernel)
        _close(tl.numpy()[active], np.asarray(jl)[active], 1e-4)
        step_tokens = np.where(active, np.asarray(jnp.argmax(jl, axis=-1)), 0).astype(np.int32)
        step_lengths = np.where(active, step_lengths + 1, step_lengths).astype(np.int32)
    _close_cache(tcache, jcache, slice(1, None))
