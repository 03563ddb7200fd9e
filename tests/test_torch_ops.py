"""The port's ops against the JAX package's, on the CPU.

Inputs are drawn from a numpy seed and fed to both. The kernel modules'
CPU paths (the plain versions) are held against the JAX Pallas kernels
run in interpret mode, as the JAX package's own kernel tests run them.
Everything is f32; tolerances are stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.ops import attention as jax_attention
from langstream_tpu.ops import norms as jax_norms
from langstream_tpu.ops import rope as jax_rope
from langstream_tpu.ops.decode_kernel import flash_decode_attention as jax_flash_decode
from langstream_tpu.ops.flash_attention import flash_prefill_attention as jax_flash_prefill
from langstream_tpu_torch.ops import attention, norms, rope
from langstream_tpu_torch.ops.decode_kernel import flash_decode_attention
from langstream_tpu_torch.ops.flash_attention import flash_prefill_attention

torch.set_num_threads(2)

GQA = [(4, 4), (4, 2), (8, 2)]
# (softcap, window, scale): the Llama path, then the Gemma-2 mechanisms
FAMILIES = [(None, None, None), (50.0, 24, 0.2)]


def _draw(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _t(array):
    return torch.from_numpy(np.asarray(array))


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_matches_jax(plus_one):
    rng = np.random.default_rng(0)
    x, w = _draw(rng, 3, 5, 64), _draw(rng, 64)
    ref = jax_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, plus_one=plus_one)
    out = norms.rms_norm(_t(x), _t(w), 1e-6, plus_one=plus_one)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scaling", [None, ("llama3", 8.0, 1.0, 4.0, 8192.0)])
def test_rope_matches_jax(scaling):
    rng = np.random.default_rng(1)
    freqs_ref = jax_rope.rope_frequencies(64, 512, 500000.0, scaling=scaling)
    freqs = rope.rope_frequencies(64, 512, 500000.0, scaling=scaling)
    # f32 cos/sin of angles up to 511 rad: both round the same angle
    np.testing.assert_allclose(freqs.numpy(), np.asarray(freqs_ref), rtol=0, atol=2e-6)
    x = _draw(rng, 2, 7, 3, 64)
    positions = rng.integers(0, 512, size=(2, 7))
    ref = jax_rope.apply_rope(jnp.asarray(x), freqs_ref, jnp.asarray(positions))
    out = rope.apply_rope(_t(x), freqs, _t(positions))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("softcap,window,scale", FAMILIES)
def test_attention_ops_match_jax(softcap, window, scale):
    rng = np.random.default_rng(2)
    q, k, v = _draw(rng, 2, 40, 4, 16), _draw(rng, 2, 40, 2, 16), _draw(rng, 2, 40, 2, 16)
    mask = np.arange(40)[None, :] < np.array([40, 23])[:, None]
    family = dict(softcap=softcap, window=window, scale=scale)
    ref = jax_attention.prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask), **family
    )
    out = attention.prefill_attention(_t(q), _t(k), _t(v), mask=_t(mask), **family)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    qd = _draw(rng, 3, 4, 16)
    kc, vc = _draw(rng, 3, 50, 2, 16), _draw(rng, 3, 50, 2, 16)
    lengths = np.array([50, 31, 1], dtype=np.int32)
    ref = jax_attention.decode_attention(
        jnp.asarray(qd), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lengths), **family
    )
    out = attention.decode_attention(_t(qd), _t(kc), _t(vc), _t(lengths), **family)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("softcap,window,scale", FAMILIES)
@pytest.mark.parametrize("heads,kv_heads", GQA)
def test_flash_prefill_cpu_path_matches_pallas_kernel(heads, kv_heads, softcap, window, scale):
    rng = np.random.default_rng(3)
    batch, seq, dim = 4, 160, 128
    q = _draw(rng, batch, seq, heads, dim)
    k, v = _draw(rng, batch, seq, kv_heads, dim), _draw(rng, batch, seq, kv_heads, dim)
    lengths = np.array([160, 97, 1, 0], dtype=np.int32)
    family = dict(softcap=softcap, window=window, scale=scale)
    ref = jax_flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lengths=jnp.asarray(lengths),
        block_q=128, block_k=128, interpret=True, **family,
    )
    out = flash_prefill_attention(_t(q), _t(k), _t(v), lengths=_t(lengths), **family)
    assert out.shape == (batch, seq, heads, dim)
    # rows past a prompt's length attend to its live keys in both; rows
    # no key may reach (an empty prompt, or outside every window) are
    # zeros in the kernel and a uniform average in the plain version
    for b, n in enumerate(lengths):
        rows = seq if n and not window else n
        np.testing.assert_allclose(
            out[b, :rows].numpy(), np.asarray(ref[b, :rows]), rtol=1e-5, atol=1e-5
        )


@pytest.mark.parametrize("softcap,window,scale", FAMILIES)
@pytest.mark.parametrize("heads,kv_heads", GQA)
def test_flash_decode_cpu_path_matches_pallas_kernel(heads, kv_heads, softcap, window, scale):
    rng = np.random.default_rng(4)
    slots, max_len, dim = 4, 128, 128
    q = _draw(rng, slots, heads, dim)
    kc, vc = _draw(rng, slots, max_len, kv_heads, dim), _draw(rng, slots, max_len, kv_heads, dim)
    lengths = np.array([128, 70, 1, 0], dtype=np.int32)
    family = dict(softcap=softcap, window=window, scale=scale)
    ref = jax_flash_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lengths),
        block_k=64, interpret=True, **family,
    )
    out = flash_decode_attention(_t(q), _t(kc), _t(vc), _t(lengths), **family)
    # an empty slot's row is don't-care on the plain path; compare live ones
    for s, n in enumerate(lengths):
        if n:
            np.testing.assert_allclose(
                out[s].numpy(), np.asarray(ref[s]), rtol=1e-5, atol=1e-5
            )


def test_kernel_wrappers_count_only_card_launches():
    """On the CPU the wrappers take the plain path and count nothing."""
    rng = np.random.default_rng(5)
    q = _t(_draw(rng, 1, 8, 2, 16))
    before = (flash_prefill_attention.launches, flash_decode_attention.launches)
    flash_prefill_attention(q, q, q)
    flash_decode_attention(q[:, 0], q, q, torch.tensor([3], dtype=torch.int32))
    assert (flash_prefill_attention.launches, flash_decode_attention.launches) == before
