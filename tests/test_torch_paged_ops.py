"""The port's paged ops against the JAX package's, on the CPU.

The ragged paged-attention wrapper's CPU path (its plain version) is held
against the JAX Pallas kernel run in interpret mode, over the matrix of
``tests/test_paged_kernel.py``: GQA 4/4, 4/2 and 8/2, softcap, sliding
window, and ragged rows (empty, single-token, block-boundary, full-table)
at Tq 1 and Tq > 1. Pools are shuffled through non-identity tables with
two rows sharing a prefix chain. Inputs come from a numpy seed; all f32.
Attention agrees to 1e-5 of max |reference| (the two frameworks sum in
another order); the scatter and gather are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.ops import attention as jax_attention
from langstream_tpu.ops.paged_attention import ragged_paged_attention as jax_ragged
from langstream_tpu_torch.ops import attention
from langstream_tpu_torch.ops.paged_attention import (
    block_bounds,
    fused_shapes_ok,
    last_live_block,
    ragged_paged_attention,
)

torch.set_num_threads(2)

GQA = [(4, 4), (4, 2), (8, 2)]
BLOCK = 8
DIM = 16


def _draw(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _t(array):
    return torch.from_numpy(np.asarray(array))


def _pool(rng, batch, width, kv_heads):
    """A shuffled pool for ``batch`` rows of ``width`` table entries each;
    rows 0 and 1 share their first two blocks."""
    num_blocks = batch * width + 1
    tables = (rng.permutation(num_blocks - 1) + 1)[: batch * width]
    tables = tables.reshape(batch, width).astype(np.int32)
    tables[1, :2] = tables[0, :2]
    k_pool = _draw(rng, num_blocks, BLOCK, kv_heads, DIM)
    v_pool = _draw(rng, num_blocks, BLOCK, kv_heads, DIM)
    return k_pool, v_pool, tables


def _close(out, ref, rel=1e-5):
    out, ref = np.asarray(out, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-6)
    assert float(np.abs(out - ref).max()) <= rel * scale


@pytest.mark.parametrize("heads,kv_heads", GQA)
@pytest.mark.parametrize("softcap,window", [(None, 0), (30.0, 0), (None, 12), (30.0, 12)])
def test_decode_matches_pallas_kernel(heads, kv_heads, softcap, window):
    rng = np.random.default_rng(heads * 10 + kv_heads)
    width = 8  # a full table is 64 positions
    lengths = np.array([64, 17, 1, 16, 0], dtype=np.int32)
    batch = len(lengths)
    k_pool, v_pool, tables = _pool(rng, batch, width, kv_heads)
    q = _draw(rng, batch, 1, heads, DIM)
    starts = np.maximum(lengths - 1, 0).astype(np.int32)
    family = dict(softcap=softcap, window=window)
    ref = jax_ragged(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(tables),
        jnp.asarray(starts), jnp.asarray(lengths), interpret=True,
        softcap=softcap, window=jnp.int32(window),
    )
    out = ragged_paged_attention(
        _t(q), _t(k_pool), _t(v_pool), _t(tables), _t(starts), _t(lengths), **family
    )
    assert out.shape == (batch, 1, heads, DIM)
    # the empty row is don't-care on the plain path (zeros in the kernel)
    for b in np.flatnonzero(lengths):
        _close(out[b].numpy(), ref[b])


@pytest.mark.parametrize("heads,kv_heads", GQA)
@pytest.mark.parametrize("softcap,window", [(None, 0), (30.0, 0), (None, 12), (30.0, 12)])
def test_prefill_at_offset_matches_pallas_kernel(heads, kv_heads, softcap, window):
    """Rows at ragged offsets: warm continuations, a cold row (start 0),
    a padded suffix, a single new token, a row ending on a block boundary
    and a full-table row."""
    rng = np.random.default_rng(100 + heads * 10 + kv_heads)
    width, seq = 8, 10
    starts = np.array([20, 5, 0, 40, 6, 54], dtype=np.int32)
    news = np.array([10, 10, 3, 1, 10, 10], dtype=np.int32)
    lengths = starts + news  # 30, 15, 3, 41, 16 (a block boundary), 64 (full)
    batch = len(starts)
    k_pool, v_pool, tables = _pool(rng, batch, width, kv_heads)
    q = _draw(rng, batch, seq, heads, DIM)
    ref = jax_ragged(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(tables),
        jnp.asarray(starts), jnp.asarray(lengths), interpret=True, block_q=4,
        softcap=softcap, window=jnp.int32(window),
    )
    out = ragged_paged_attention(
        _t(q), _t(k_pool), _t(v_pool), _t(tables), _t(starts), _t(lengths),
        softcap=softcap, window=window,
    )
    # positions past a row's new tokens are discarded by every caller
    for b, n in enumerate(news):
        _close(out[b, :n].numpy(), ref[b, :n])


def test_gather_and_paged_write_rows_match_jax_exactly():
    rng = np.random.default_rng(7)
    batch, width, seq = 3, 4, 12
    k_pool, _, tables = _pool(rng, batch, width, 2)
    new = _draw(rng, batch, seq, 2, DIM)
    # row 1 writes 5 valid tokens of 12; row 2's window runs past the
    # table's capacity (32 positions): those rows, like the invalid ones,
    # must land in the null block
    offsets = np.array([0, 16, 26], dtype=np.int32)
    valid = np.arange(seq)[None, :] < np.array([12, 5, 12])[:, None]
    ref = jax_attention.paged_write_rows(
        jnp.asarray(k_pool), jnp.asarray(new), jnp.asarray(tables),
        jnp.asarray(offsets), jnp.asarray(valid),
    )
    pool = _t(k_pool.copy())
    out = attention.paged_write_rows(pool, _t(new), _t(tables), _t(offsets), _t(valid))
    assert out is pool  # in place
    # block 0 takes every masked write; which of them wins does not matter
    np.testing.assert_array_equal(out.numpy()[1:], np.asarray(ref)[1:])
    np.testing.assert_array_equal(
        attention.gather_blocks(out, _t(tables)).numpy(),
        np.asarray(jax_attention.gather_blocks(jnp.asarray(out.numpy()), jnp.asarray(tables))),
    )


@pytest.mark.parametrize("softcap,window,scale", [(None, None, None), (50.0, 24, 0.2)])
def test_chunk_attention_matches_jax(softcap, window, scale):
    rng = np.random.default_rng(9)
    q = _draw(rng, 3, 8, 4, DIM)
    kc, vc = _draw(rng, 3, 60, 2, DIM), _draw(rng, 3, 60, 2, DIM)
    starts = np.array([20, 0, 52], dtype=np.int32)
    lengths = starts + np.array([8, 5, 8], dtype=np.int32)
    family = dict(softcap=softcap, window=window, scale=scale)
    ref = jax_attention.chunk_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(starts),
        jnp.asarray(lengths), **dict(family, window=None if window is None else jnp.int32(window)),
    )
    out = attention.chunk_attention(_t(q), _t(kc), _t(vc), _t(starts), _t(lengths), **family)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_block_bounds_and_shape_gate():
    # decode of a 64-token row over 16-token blocks: blocks 0..3
    assert block_bounds(63, 64, 0, 0, 1, 16) == (0, 3)
    # a window floors the range; an empty row still maps block 0
    assert block_bounds(63, 64, 20, 0, 1, 16) == (2, 3)
    assert block_bounds(0, 0, 0, 0, 1, 16) == (0, 0)
    assert last_live_block(0, 16) == 0 and last_live_block(17, 16) == 1
    # the tile's causal frontier caps the top below the row's length
    assert block_bounds(0, 256, 0, 0, 16, 16) == (0, 0)
    assert fused_shapes_ok(32, 8, 128) and fused_shapes_ok(8, 4, 256)
    assert not fused_shapes_ok(5, 2) and not fused_shapes_ok(8, 2, 12)
    assert not fused_shapes_ok(8, 2, 264)


def test_wrapper_counts_only_card_launches():
    """On the CPU the wrapper takes the plain path and counts nothing."""
    rng = np.random.default_rng(5)
    k_pool, v_pool, tables = _pool(rng, 2, 2, 2)
    q = _t(_draw(rng, 2, 1, 4, DIM))
    before = ragged_paged_attention.launches
    ragged_paged_attention(
        q, _t(k_pool), _t(v_pool), _t(tables), torch.tensor([3, 0], dtype=torch.int32),
        torch.tensor([4, 1], dtype=torch.int32),
    )
    assert ragged_paged_attention.launches == before
