"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skips where there is no CUDA device (the check runs inside each
test, never at import). Run on a GPU machine with::

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the repository's conftest configures JAX, which the
port does not need.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from langstream_tpu_torch.ops.attention import (
    chunk_attention_quant,
    decode_attention,
    decode_attention_quant,
    paged_chunk_attention,
    paged_chunk_attention_quant,
    paged_decode_attention,
    paged_decode_attention_quant,
    prefill_attention,
    quantize_kv,
)
from langstream_tpu_torch.ops.decode_kernel import flash_decode_attention, flash_decode_attention_quant
from langstream_tpu_torch.ops.flash_attention import flash_prefill_attention, flash_prefill_attention_quant
from langstream_tpu_torch.ops.paged_attention import ragged_paged_attention, ragged_paged_attention_quant
from langstream_tpu_torch.providers.torch_local import engine, model

# bf16: p is rounded to bf16 before p·v and sums run in another order
# than the plain einsum; f32: only the summation order differs
TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-4}

FAMILIES = [
    # heads, kv_heads, dim, softcap, window, scale
    (32, 8, 128, None, 0, None),   # Llama-3-8B
    (4, 4, 64, None, 0, None),
    (8, 2, 128, 50.0, 48, 0.1),    # Gemma-2 mechanisms
    (8, 4, 256, None, 0, None),
]


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out.float() - ref.float()).abs().max() / ref.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("heads,kv_heads,dim,softcap,window,scale", FAMILIES)
def test_flash_prefill_kernel_matches_plain(dtype, heads, kv_heads, dim, softcap, window, scale):
    device = _card()
    rng = np.random.default_rng(0)
    batch, seq = 4, 200
    torch_dtype = getattr(torch, dtype)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch_dtype)

    q, k, v = draw(batch, seq, heads, dim), draw(batch, seq, kv_heads, dim), draw(batch, seq, kv_heads, dim)
    lengths = torch.tensor([200, 130, 64, 1], dtype=torch.int32, device=device)
    before = flash_prefill_attention.launches
    out = flash_prefill_attention(q, k, v, lengths=lengths, softcap=softcap, window=window, scale=scale)
    torch.cuda.synchronize()
    assert flash_prefill_attention.launches == before + 1
    mask = torch.arange(seq, device=device)[None, :] < lengths[:, None]
    ref = prefill_attention(q, k, v, mask=mask, softcap=softcap, window=window, scale=scale)
    for b in range(batch):
        # rows past the length attend to the live keys too; only with a
        # window can a row lose every key (the kernel writes zeros there)
        n = seq if not window else int(lengths[b])
        assert _rel_err(out[b, :n], ref[b, :n]) < TOLERANCE[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("heads,kv_heads,dim,softcap,window,scale", FAMILIES)
def test_flash_decode_kernel_matches_plain(dtype, heads, kv_heads, dim, softcap, window, scale):
    device = _card()
    rng = np.random.default_rng(1)
    slots, max_len = 6, 300
    torch_dtype = getattr(torch, dtype)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch_dtype)

    q = draw(slots, heads, dim)
    k, v = draw(slots, max_len, kv_heads, dim), draw(slots, max_len, kv_heads, dim)
    lengths = torch.tensor([300, 129, 64, 1, 0, 77], dtype=torch.int32, device=device)
    out = flash_decode_attention(q, k, v, lengths, softcap=softcap, window=window, scale=scale)
    torch.cuda.synchronize()
    ref = decode_attention(q, k, v, lengths, softcap=softcap, window=window, scale=scale)
    for s in range(slots):
        if int(lengths[s]) == 0:
            assert float(out[s].float().abs().max()) == 0.0
            continue
        assert _rel_err(out[s], ref[s]) < TOLERANCE[dtype]


@pytest.mark.gpu
def test_kernels_refuse_what_they_cannot_take():
    device = _card()
    q = torch.zeros(1, 8, 4, 48, dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError):
        flash_prefill_attention(q, q, q)  # head_dim 48
    with pytest.raises(TypeError):
        flash_prefill_attention(q.half(), q.half(), q.half())
    cache = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError):
        flash_decode_attention(cache[:, 0], cache, cache, torch.ones(1, dtype=torch.int64, device=device))


# B3: heads, kv_heads, dim, softcap, window, scale — D 64/128/256 and GQA
# groups 1/2/4/8 between them
PAGED_FAMILIES = [
    (32, 8, 128, None, 0, None),   # Llama-3-8B (G 4)
    (4, 4, 64, None, 0, None),     # G 1
    (8, 4, 256, 50.0, 40, 0.0625), # Gemma-2 mechanisms (G 2)
    (16, 2, 64, 30.0, 0, 0.2),     # G 8
]


def _paged_case(rng, device, torch_dtype, heads, kv_heads, dim, block_size, seq):
    """A shuffled pool with rows 0 and 1 sharing their first blocks, an
    empty row, a single-token row, a block-boundary row and a full-table
    row; ``seq`` new tokens per row at most (fewer where the row is
    shorter)."""
    width = 96 // block_size + 2  # table entries per row
    lengths = [96, 80, 0, 1, block_size, width * block_size]
    batch = len(lengths)
    num_blocks = batch * width + 1
    order = rng.permutation(num_blocks - 1) + 1  # block 0 stays the null block
    tables = order[: batch * width].reshape(batch, width).astype(np.int32)
    tables[1, :3] = tables[0, :3]  # a shared prefix chain
    news = [min(seq, n) for n in lengths]
    starts = [n - m for n, m in zip(lengths, news)]

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch_dtype)

    q = draw(batch, seq, heads, dim)
    k_pool = draw(num_blocks, block_size, kv_heads, dim)
    v_pool = draw(num_blocks, block_size, kv_heads, dim)

    def ints(values):
        return torch.tensor(values, dtype=torch.int32, device=device)

    return q, k_pool, v_pool, ints(tables), ints(starts), ints(lengths), news


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("heads,kv_heads,dim,softcap,window,scale", PAGED_FAMILIES)
@pytest.mark.parametrize("block_size", [8, 16, 32])
@pytest.mark.parametrize("seq", [1, 64])
def test_ragged_paged_kernel_matches_plain(dtype, heads, kv_heads, dim, softcap, window, scale, block_size, seq):
    device = _card()
    rng = np.random.default_rng(block_size * 1000 + seq)
    q, k_pool, v_pool, tables, starts, lengths, news = _paged_case(
        rng, device, getattr(torch, dtype), heads, kv_heads, dim, block_size, seq)
    family = dict(softcap=softcap, window=window, scale=scale)
    before = ragged_paged_attention.launches
    out = ragged_paged_attention(q, k_pool, v_pool, tables, starts, lengths, **family)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    if seq == 1:
        ref = paged_decode_attention(q[:, 0], k_pool, v_pool, tables, lengths, **family)[:, None]
    else:
        ref = paged_chunk_attention(q, k_pool, v_pool, tables, starts, lengths, **family)
    for b, n in enumerate(news):
        if int(lengths[b]) == 0:
            assert float(out[b].float().abs().max()) == 0.0, "an empty row must yield zeros"
            continue
        assert _rel_err(out[b, :n], ref[b, :n]) < TOLERANCE[dtype], b


@pytest.mark.gpu
def test_ragged_paged_kernel_is_deterministic_and_refuses():
    device = _card()
    rng = np.random.default_rng(5)
    q, k_pool, v_pool, tables, starts, lengths, _ = _paged_case(
        rng, device, torch.bfloat16, 32, 8, 128, 16, 64)
    first = ragged_paged_attention(q, k_pool, v_pool, tables, starts, lengths)
    second = ragged_paged_attention(q, k_pool, v_pool, tables, starts, lengths)
    assert torch.equal(first, second)
    with pytest.raises(TypeError):
        ragged_paged_attention(q.half(), k_pool.half(), v_pool.half(), tables, starts, lengths)
    with pytest.raises(ValueError):
        ragged_paged_attention(q, k_pool.cpu(), v_pool.cpu(), tables, starts, lengths)
    with pytest.raises(ValueError):
        ragged_paged_attention(q, k_pool, v_pool, tables.long(), starts, lengths)
    with pytest.raises(ValueError):
        ragged_paged_attention(q[..., :12].contiguous(), k_pool[..., :12].contiguous(),
                               v_pool[..., :12].contiguous(), tables, starts, lengths)


@pytest.mark.gpu
def test_paged_engine_refuses_shapes_the_kernel_cannot_take():
    """On the card a paged engine whose config B3 cannot take raises at
    init instead of running the gather composition quietly."""
    device = _card()
    config = dataclasses.replace(model.LlamaConfig.tiny(), head_dim=12)
    params = model.init_params(config)
    with pytest.raises(ValueError, match="paged_kernel='reference'"):
        engine.DecodeEngine(config, params, device=device, kv_layout="paged")
    engine.DecodeEngine(config, params, device=device, kv_layout="paged", paged_kernel="reference")


# ---------------------------------------------------------------------- #
# B4, B5, B6: the int8 kernels against their plain versions. k/v are
# quantize_kv of seeded activations; p.v runs in f32 in the kernels as in
# the plain versions, so only q's and out's dtype and the summation order
# differ.
# ---------------------------------------------------------------------- #
# FAMILIES plus GQA 8 at head_dim 80 (int8 tiles padded to 128 in B4)
QUANT_FAMILIES = FAMILIES + [(16, 2, 80, 30.0, 0, 0.2)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("heads,kv_heads,dim,softcap,window,scale", QUANT_FAMILIES)
def test_flash_prefill_quant_kernel_matches_plain(dtype, heads, kv_heads, dim, softcap, window, scale):
    device = _card()
    rng = np.random.default_rng(10)
    batch, seq = 5, 200
    torch_dtype = getattr(torch, dtype)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch_dtype)

    q = draw(batch, seq, heads, dim)
    k, k_scale = quantize_kv(draw(batch, seq, kv_heads, dim))
    v, v_scale = quantize_kv(draw(batch, seq, kv_heads, dim))
    lengths = torch.tensor([200, 128, 64, 1, 0], dtype=torch.int32, device=device)
    family = dict(softcap=softcap, window=window, scale=scale)
    before = flash_prefill_attention_quant.launches
    out = flash_prefill_attention_quant(q, k, k_scale, v, v_scale, lengths=lengths, **family)
    torch.cuda.synchronize()
    assert flash_prefill_attention_quant.launches == before + 1
    assert out.dtype == torch_dtype
    ref = chunk_attention_quant(q, k, k_scale, v, v_scale, torch.zeros_like(lengths), lengths, **family)
    assert float(out[4].float().abs().max()) == 0.0, "an empty prompt must yield zeros"
    for b in range(batch - 1):
        n = int(lengths[b])
        assert _rel_err(out[b, :n], ref[b, :n]) < TOLERANCE[dtype], b


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("heads,kv_heads,dim,softcap,window,scale", QUANT_FAMILIES)
def test_flash_decode_quant_kernel_matches_plain(dtype, heads, kv_heads, dim, softcap, window, scale):
    device = _card()
    rng = np.random.default_rng(11)
    slots, max_len = 6, 300
    torch_dtype = getattr(torch, dtype)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch_dtype)

    q = draw(slots, heads, dim)
    k, k_scale = quantize_kv(draw(slots, max_len, kv_heads, dim))
    v, v_scale = quantize_kv(draw(slots, max_len, kv_heads, dim))
    lengths = torch.tensor([300, 129, 64, 1, 0, 77], dtype=torch.int32, device=device)
    family = dict(softcap=softcap, window=window, scale=scale)
    before = flash_decode_attention_quant.launches
    out = flash_decode_attention_quant(q, k, k_scale, v, v_scale, lengths, **family)
    torch.cuda.synchronize()
    assert flash_decode_attention_quant.launches == before + 1
    ref = decode_attention_quant(q, k, k_scale, v, v_scale, lengths, **family)
    for s in range(slots):
        if int(lengths[s]) == 0:
            assert float(out[s].float().abs().max()) == 0.0
            continue
        assert _rel_err(out[s], ref[s]) < TOLERANCE[dtype], s


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("heads,kv_heads,dim,softcap,window,scale", PAGED_FAMILIES)
@pytest.mark.parametrize("block_size", [8, 16, 32])
@pytest.mark.parametrize("seq", [1, 64])
def test_ragged_paged_quant_kernel_matches_plain(dtype, heads, kv_heads, dim, softcap, window, scale,
                                                 block_size, seq):
    device = _card()
    rng = np.random.default_rng(block_size * 1000 + seq + 7)
    q, k_pool, v_pool, tables, starts, lengths, news = _paged_case(
        rng, device, getattr(torch, dtype), heads, kv_heads, dim, block_size, seq)
    pools = (*quantize_kv(k_pool), *quantize_kv(v_pool))
    family = dict(softcap=softcap, window=window, scale=scale)
    before = ragged_paged_attention_quant.launches
    out = ragged_paged_attention_quant(q, *pools, tables, starts, lengths, **family)
    torch.cuda.synchronize()
    assert ragged_paged_attention_quant.launches == before + 1
    if seq == 1:
        ref = paged_decode_attention_quant(q[:, 0], *pools, tables, lengths, **family)[:, None]
    else:
        ref = paged_chunk_attention_quant(q, *pools, tables, starts, lengths, **family)
    for b, n in enumerate(news):
        if int(lengths[b]) == 0:
            assert float(out[b].float().abs().max()) == 0.0, "an empty row must yield zeros"
            continue
        assert _rel_err(out[b, :n], ref[b, :n]) < TOLERANCE[dtype], b


@pytest.mark.gpu
def test_quant_kernels_are_deterministic_and_refuse():
    device = _card()
    rng = np.random.default_rng(6)
    q, k_pool, v_pool, tables, starts, lengths, _ = _paged_case(
        rng, device, torch.bfloat16, 32, 8, 128, 16, 64)
    (kq, ks), (vq, vs) = quantize_kv(k_pool), quantize_kv(v_pool)
    first = ragged_paged_attention_quant(q, kq, ks, vq, vs, tables, starts, lengths)
    second = ragged_paged_attention_quant(q, kq, ks, vq, vs, tables, starts, lengths)
    assert torch.equal(first, second)
    with pytest.raises(TypeError):  # bf16 pools
        ragged_paged_attention_quant(q, k_pool, ks, v_pool, vs, tables, starts, lengths)
    with pytest.raises(TypeError):  # bf16 scales
        ragged_paged_attention_quant(q, kq, ks.bfloat16(), vq, vs.bfloat16(), tables, starts, lengths)
    with pytest.raises(ValueError):  # head_dim 40
        ragged_paged_attention_quant(q[..., :40].contiguous(), kq[..., :40].contiguous(), ks,
                                     vq[..., :40].contiguous(), vs, tables, starts, lengths)
    qd = torch.zeros(2, 8, 40, dtype=torch.bfloat16, device=device)
    cache = torch.zeros(2, 16, 4, 40, dtype=torch.int8, device=device)
    scales = torch.ones(2, 16, 4, device=device)
    lens = torch.ones(2, dtype=torch.int32, device=device)
    with pytest.raises(ValueError):  # head_dim 40
        flash_decode_attention_quant(qd, cache, scales, cache, scales, lens)
    with pytest.raises(ValueError):
        flash_prefill_attention_quant(qd[:, None], cache[:, :1], scales[:, :1], cache[:, :1],
                                      scales[:, :1])
    good = torch.zeros(2, 16, 4, 64, dtype=torch.int8, device=device)
    qg = torch.zeros(2, 8, 64, dtype=torch.bfloat16, device=device)
    with pytest.raises(TypeError):  # k not int8
        flash_decode_attention_quant(qg, good.bfloat16(), scales, good, scales, lens)
    with pytest.raises(TypeError):  # scales not f32
        flash_decode_attention_quant(qg, good, scales.half(), good, scales.half(), lens)
    with pytest.raises(TypeError):
        flash_prefill_attention_quant(qg[:, None], good[:, :1].bfloat16(), scales[:, :1],
                                      good[:, :1], scales[:, :1])
    with pytest.raises(TypeError):
        flash_prefill_attention_quant(qg[:, None], good[:, :1], scales[:, :1].double(),
                                      good[:, :1], scales[:, :1].double())
