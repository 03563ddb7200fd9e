"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skips where there is no CUDA device (the check runs inside each
test, never at import). Run on a GPU machine with::

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the repository's conftest configures JAX, which the
port does not need.)
"""

import asyncio
import dataclasses
import time

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
    paged_ragged_q_attention,
    paged_ragged_q_attention_quant,
    prefill_attention,
    quantize_kv,
)
from langstream_tpu_torch.ops.decode_kernel import flash_decode_attention, flash_decode_attention_quant
from langstream_tpu_torch.ops.flash_attention import flash_prefill_attention, flash_prefill_attention_quant
from langstream_tpu_torch.ops.paged_attention import (
    ragged_paged_attention,
    ragged_paged_attention_quant,
    ragged_q_paged_attention,
    ragged_q_paged_attention_quant,
)
from langstream_tpu_torch.ops import launches as launches_lib
from langstream_tpu_torch.providers.torch_local import engine, model, quant

# the kernel wrappers under the names of ops/launches.py's device counters
WRAPPERS = {
    "flash_prefill": flash_prefill_attention,
    "flash_prefill_quant": flash_prefill_attention_quant,
    "flash_decode": flash_decode_attention,
    "flash_decode_quant": flash_decode_attention_quant,
    "paged_attention": ragged_paged_attention,
    "paged_attention_quant": ragged_paged_attention_quant,
    "paged_attention_ragged_q": ragged_q_paged_attention,
    "paged_attention_ragged_q_quant": ragged_q_paged_attention_quant,
}

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
        assert not bool(out[b, n:].any()), "positions past the new tokens are zero"


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
        assert not bool(out[b, n:].any()), "positions past the new tokens are zero"


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


# ---------------------------------------------------------------------- #
# B1, B4: the cases the warpgroup tensor-core body, with its TMA ring over
# 4-D tensor maps, can get wrong. q tiles are 128 rows (64 at D 256), key
# tiles 64.
# ---------------------------------------------------------------------- #
# id: heads, kv_heads, dim, seq, lengths, window, softcap
PREFILL_EDGES = {
    # one token: every box mostly past T
    "t1": (8, 2, 128, 1, [1, 0], 0, None),
    # T one past a key tile, G 1; lengths 0 and 1
    "t65-g1": (4, 4, 64, 65, [65, 64, 1, 0], 0, None),
    # T not a multiple of either tile, G 4, a window boundary inside a key tile
    "t200-g4-window": (8, 2, 128, 200, [200, 150, 37, 1], 37, 30.0),
    # one short of the top bucket, G 8: 8 q tiles, the diagonal at every offset
    "t1023-g8": (16, 2, 128, 1023, [1023, 700], 0, None),
    # D 256 (one consumer warpgroup, 64-row q tiles), G 4
    "t200-d256": (8, 2, 256, 200, [200, 129, 64, 0], 0, None),
    # D 64, G 8, a window of exactly one key tile
    "t130-d64-g8-window": (16, 2, 64, 130, [130, 128, 127, 2], 64, 50.0),
}
# int8 k/v only: head dims the tiles pad (80 in a 128 tile, 32 in a 64 one)
PREFILL_QUANT_EDGES = {
    "t200-d80-g8": (16, 2, 80, 200, [200, 131, 1, 0], 0, 30.0),
    "t97-d32-g4": (8, 2, 32, 97, [97, 65, 64], 20, None),
}


def _prefill_case(rng, device, heads, kv_heads, dim, seq, lengths, quant):
    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch.bfloat16)

    batch = len(lengths)
    q, k, v = draw(batch, seq, heads, dim), draw(batch, seq, kv_heads, dim), draw(batch, seq, kv_heads, dim)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    if not quant:
        return q, (k, v), lens
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return q, (kq, ks, vq, vs), lens


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["B1", "B4"])
@pytest.mark.parametrize("case", sorted(PREFILL_EDGES) + sorted(PREFILL_QUANT_EDGES))
def test_flash_prefill_edge_cases(quant, case):
    """B1 (B4) against the plain version at the edges of the q and key
    tiles and of the ring, row by row (every q-tile offset of the causal
    diagonal), and bitwise equal on a repeated launch."""
    if case in PREFILL_QUANT_EDGES and not quant:
        pytest.skip("a head dim that only the int8 kernel takes")
    device = _card()
    heads, kv_heads, dim, seq, lengths, window, softcap = {**PREFILL_EDGES, **PREFILL_QUANT_EDGES}[case]
    rng = np.random.default_rng(sum(map(ord, case)) + (3 if quant else 0))
    q, kv, lens = _prefill_case(rng, device, heads, kv_heads, dim, seq, lengths, quant)
    family = dict(softcap=softcap, window=window)
    if quant:
        out = flash_prefill_attention_quant(q, *kv[:2], *kv[2:], lengths=lens, **family)
        again = flash_prefill_attention_quant(q, *kv[:2], *kv[2:], lengths=lens, **family)
        ref = chunk_attention_quant(q, kv[0], kv[1], kv[2], kv[3], torch.zeros_like(lens), lens, **family)
    else:
        out = flash_prefill_attention(q, *kv, lengths=lens, **family)
        again = flash_prefill_attention(q, *kv, lengths=lens, **family)
        mask = torch.arange(seq, device=device)[None, :] < lens[:, None]
        ref = prefill_attention(q, *kv, mask=mask, **family)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "a repeated launch must give the same bits"
    for b, n in enumerate(lengths):
        if n == 0:
            assert not bool(out[b].any()), (case, b, "an empty prompt must yield zeros")
            continue
        # rows past the length attend to the live keys too (B1 without a
        # window); with a window, or for B4's reference, only live rows
        rows = seq if not (window or quant) else n
        got, want = out[b, :rows].float(), ref[b, :rows].float()
        per_row = (got - want).abs().amax(dim=(1, 2)) / want.abs().amax(dim=(1, 2))
        assert float(per_row.max()) < TOLERANCE["bfloat16"], (case, b, int(per_row.argmax()))


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["B1", "B4"])
def test_flash_prefill_reads_no_row_past_its_own(quant):
    """The 4-D tensor maps stop each batch row's tiles at T: the row after
    a full-length row holds NaN (and is empty), so a tile that reached
    into it would turn the first row's output to NaN."""
    device = _card()
    heads, kv_heads, dim, seq = 8, 2, 128, 200
    rng = np.random.default_rng(23)
    q, kv, lens = _prefill_case(rng, device, heads, kv_heads, dim, seq, [200, 0, 130], False)
    k, v = (t.clone() for t in kv)
    k[1], v[1] = float("nan"), float("nan")
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(kv[0]), quantize_kv(kv[1])
        ks[1], vs[1] = float("nan"), float("nan")
        out = flash_prefill_attention_quant(q, kq, ks, vq, vs, lengths=lens)
        ref = chunk_attention_quant(q, kq, ks, vq, vs, torch.zeros_like(lens), lens)
    else:
        out = flash_prefill_attention(q, k, v, lengths=lens)
        mask = torch.arange(seq, device=device)[None, :] < lens[:, None]
        ref = prefill_attention(q, *kv, mask=mask)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert not bool(out[1].any())
    for b in (0, 2):
        n = int(lens[b])
        assert _rel_err(out[b, :n], ref[b, :n]) < TOLERANCE["bfloat16"], b


# ---------------------------------------------------------------------- #
# B7, B8: the token-ragged kernels (the mixed step's launch) against their
# plain versions, over B3's matrix; per row bitwise B3 / B6 at window 0
# ---------------------------------------------------------------------- #
RAGGED_Q_FAMILIES = PAGED_FAMILIES + [(16, 2, 80, 30.0, 0, 0.2)]  # + head_dim 80 (G 8)


def _ragged_q_case(rng, device, torch_dtype, heads, kv_heads, dim, block_size, width, block_q):
    """A mixed batch over a shuffled pool, spans packed at non-uniform
    tile-aligned offsets of a longer flat tile: decode rows at contexts 1,
    block_size, 96 and the full table; a warm window of width - 3 at
    offset 33; a cold window of the full width; a one-token cold prompt;
    an idle row. Returns the operands and the host rows (start, total,
    offset)."""
    table_width = 96 // block_size + 4
    capacity = table_width * block_size
    rows = [(0, 1), (block_size - 1, block_size), (95, 96), (capacity - 1, capacity),
            (33, 33 + max(width - 3, 1)), (0, width), (0, 1), (0, 0)]
    batch = len(rows)
    num_blocks = batch * table_width + 1
    order = rng.permutation(num_blocks - 1) + 1  # block 0 stays the null block
    tables = order[: batch * table_width].reshape(batch, table_width).astype(np.int32)
    tables[1, :1] = tables[0, :1]  # a shared prefix block
    gaps = rng.integers(0, 3, size=batch) * block_q
    offsets = np.cumsum(gaps + width) - width  # each span after the previous one and a gap
    order_rows = rng.permutation(batch)  # spans in another order than the rows
    q_offsets = np.zeros(batch, dtype=np.int32)
    q_offsets[order_rows] = offsets
    total_q = int(offsets[-1] + width + block_q)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch_dtype)

    q = draw(total_q, heads, dim)
    k_pool, v_pool = draw(num_blocks, block_size, kv_heads, dim), draw(num_blocks, block_size, kv_heads, dim)

    def ints(values):
        return torch.tensor(np.asarray(values), dtype=torch.int32, device=device)

    starts, totals = zip(*rows)
    hosts = list(zip(starts, totals, q_offsets.tolist()))
    return q, (k_pool, v_pool), ints(tables), ints(starts), ints(totals), ints(q_offsets), hosts


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["B7", "B8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("heads,kv_heads,dim,softcap,window,scale", RAGGED_Q_FAMILIES)
@pytest.mark.parametrize("block_size", [8, 16, 32])
@pytest.mark.parametrize("width", [8, 16, 64])
def test_ragged_q_kernel_matches_plain(quant, dtype, heads, kv_heads, dim, softcap, window, scale,
                                       block_size, width):
    device = _card()
    rng = np.random.default_rng(block_size * 1000 + width + (7 if quant else 0))
    block_q = 8
    q, pools, tables, starts, totals, q_offsets, hosts = _ragged_q_case(
        rng, device, getattr(torch, dtype), heads, kv_heads, dim, block_size, width, block_q)
    if quant:
        pools = (*quantize_kv(pools[0]), *quantize_kv(pools[1]))
    kernel = ragged_q_paged_attention_quant if quant else ragged_q_paged_attention
    plain = paged_ragged_q_attention_quant if quant else paged_ragged_q_attention
    family = dict(softcap=softcap, window=window, scale=scale)
    before = kernel.launches
    out = kernel(q, *pools, tables, starts, totals, q_offsets, max_q_len=width, block_q=block_q,
                 **family)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = plain(q, *pools, tables, starts, totals, q_offsets, max_q_len=width, block_q=block_q,
                **family)
    covered = torch.zeros(q.shape[0], dtype=torch.bool, device=device)
    for b, (start, total, offset) in enumerate(hosts):
        covered[offset:offset + width] = True
        live = total - start
        if live:
            assert _rel_err(out[offset:offset + live], ref[offset:offset + live]) < TOLERANCE[dtype], b
        # past the live count: zero, the dead tiles and the padding of the
        # last live tile alike
        assert not bool(out[offset + live:offset + width].any()), b
    assert not bool(out[~covered].any()), "positions outside every span stay zero"


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["B7", "B8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("heads,kv_heads,dim", [(32, 8, 128), (4, 4, 64), (16, 2, 80), (8, 4, 256)])
def test_ragged_q_rows_are_bitwise_b3(quant, dtype, heads, kv_heads, dim):
    """At window 0 every live row of B7 (B8) equals B3's (B6's) for that
    row bit for bit: decode rows against a Tq = 1 launch, windows
    against a Tq = W launch. The mixed step's parity with the split
    paths rests on it."""
    device = _card()
    rng = np.random.default_rng(dim + heads)
    width, block_size = 64, 16
    q, pools, tables, starts, totals, q_offsets, hosts = _ragged_q_case(
        rng, device, getattr(torch, dtype), heads, kv_heads, dim, block_size, width, 8)
    if quant:
        pools = (*quantize_kv(pools[0]), *quantize_kv(pools[1]))
    ragged_q = ragged_q_paged_attention_quant if quant else ragged_q_paged_attention
    fixed = ragged_paged_attention_quant if quant else ragged_paged_attention
    family = dict(softcap=30.0, scale=0.1)
    out = ragged_q(q, *pools, tables, starts, totals, q_offsets, max_q_len=width, block_q=8, **family)
    spans = torch.stack([q[offset:offset + width] for _, _, offset in hosts])  # [B, W, H, D]
    decode = fixed(spans[:, :1].contiguous(), *pools, tables, starts, totals, **family)
    windows = fixed(spans.contiguous(), *pools, tables, starts, totals, **family)
    torch.cuda.synchronize()
    for b, (start, total, offset) in enumerate(hosts):
        live = total - start
        if live == 1:
            assert torch.equal(out[offset], decode[b, 0]), b
        if live >= 1:
            assert torch.equal(out[offset:offset + live], windows[b, :live]), b


@pytest.mark.gpu
def test_ragged_q_kernels_are_deterministic_and_refuse():
    device = _card()
    rng = np.random.default_rng(8)
    q, pools, tables, starts, totals, q_offsets, _ = _ragged_q_case(
        rng, device, torch.bfloat16, 32, 8, 128, 16, 64, 8)
    (kq, ks), (vq, vs) = quantize_kv(pools[0]), quantize_kv(pools[1])
    args = (tables, starts, totals, q_offsets)
    for fn, leaves in ((ragged_q_paged_attention, pools),
                       (ragged_q_paged_attention_quant, (kq, ks, vq, vs))):
        first = fn(q, *leaves, *args, max_q_len=64, block_q=8)
        second = fn(q, *leaves, *args, max_q_len=64, block_q=8)
        assert torch.equal(first, second)
        with pytest.raises(ValueError, match="tile"):
            fn(q, *leaves, *args, max_q_len=64, block_q=6)
        with pytest.raises(ValueError, match="multiple"):
            fn(q, *leaves, tables, starts, totals, q_offsets + 4, max_q_len=64, block_q=8)
        with pytest.raises(ValueError, match="outside"):  # offsets given on the host
            fn(q, *leaves, *args, max_q_len=64, block_q=8,
               q_offsets_host=(q_offsets.cpu() + q.shape[0]).tolist())
        with pytest.raises(ValueError):  # q_offsets on the CPU
            fn(q, *leaves, tables, starts, totals, q_offsets.cpu(), max_q_len=64, block_q=8)
        with pytest.raises(ValueError):  # head_dim 12 (8 for int8 cannot divide by 16 either)
            fn(q[..., :12].contiguous(), *(t[..., :12].contiguous() if t.dim() == 4 else t
                                           for t in leaves), *args, max_q_len=64, block_q=8)
    with pytest.raises(TypeError):
        ragged_q_paged_attention(q.half(), pools[0].half(), pools[1].half(), *args, max_q_len=64)
    with pytest.raises(TypeError):  # bf16 pools to the int8 kernel
        ragged_q_paged_attention_quant(q, pools[0], ks, pools[1], vs, *args, max_q_len=64)


# ---------------------------------------------------------------------- #
# B3, B6 (and B7, B8 over the same rows): the cases the tensor-core body
# with its cp.async ring can get wrong. Key tiles are 64 keys (32 at
# D 256) and the ring holds three of them.
# ---------------------------------------------------------------------- #
# id: heads, kv_heads, dim, block_size, seq, window, softcap, rows (start, total)
EDGE_CASES = {
    # several key tiles, starts aligned neither to the key tile nor the block
    "unaligned-starts": (32, 8, 128, 16, 64, 0, None, [(37, 87), (130, 194), (201, 250), (135, 199)]),
    # a window boundary inside a key tile and inside a block
    "window-in-tile": (8, 4, 64, 8, 64, 37, 30.0, [(100, 164), (50, 90), (3, 40), (0, 1)]),
    # G 1, odd live counts: the q tile's live rows are not a multiple of 16
    "odd-rows-g1": (4, 4, 64, 16, 16, 0, None, [(10, 23), (0, 7), (55, 56), (70, 85)]),
    # head dims padded in shared memory (80) and split across warps (256), G 8
    "d80-g8": (16, 2, 80, 16, 64, 0, 50.0, [(0, 64), (77, 141), (300, 301), (19, 40)]),
    "d256-g8": (16, 2, 256, 32, 64, 0, None, [(0, 64), (77, 141), (300, 301), (19, 40)]),
    # lengths ending mid-stage of the ring: one key tile, two (fewer than the
    # stages), and the ring wrapped with a partly live last tile
    "ends-mid-stage": (32, 8, 128, 16, 16, 0, None, [(0, 5), (60, 65), (193, 209), (500, 513)]),
}


def _rows_case(rng, device, torch_dtype, heads, kv_heads, dim, block_size, seq, rows):
    """A shuffled pool holding ``rows`` (start, total) with their own
    tables; q of ``seq`` tokens per row (each row's new tokens at most
    ``seq``)."""
    table_width = max(total for _, total in rows) // block_size + 2
    batch = len(rows)
    num_blocks = batch * table_width + 1
    order = rng.permutation(num_blocks - 1) + 1  # block 0 stays the null block
    tables = order[: batch * table_width].reshape(batch, table_width).astype(np.int32)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch_dtype)

    q = draw(batch, seq, heads, dim)
    pools = (draw(num_blocks, block_size, kv_heads, dim), draw(num_blocks, block_size, kv_heads, dim))

    def ints(values):
        return torch.tensor(np.asarray(values), dtype=torch.int32, device=device)

    starts, totals = zip(*rows)
    return q, pools, ints(tables), ints(starts), ints(totals)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["B3", "B6"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_ragged_paged_kernel_edge_cases(quant, dtype, case):
    """B3 (B6) against the plain version at the edges of the key tiles,
    the ring and the row tiles; zeros past each row's new tokens; at
    window 0, B7's (B8's) rows over the same spans bitwise equal."""
    device = _card()
    heads, kv_heads, dim, block_size, seq, window, softcap, rows = EDGE_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)) + (7 if quant else 0))
    q, pools, tables, starts, totals = _rows_case(
        rng, device, getattr(torch, dtype), heads, kv_heads, dim, block_size, seq, rows)
    if quant:
        pools = (*quantize_kv(pools[0]), *quantize_kv(pools[1]))
    fixed = ragged_paged_attention_quant if quant else ragged_paged_attention
    plain = paged_chunk_attention_quant if quant else paged_chunk_attention
    family = dict(softcap=softcap, window=window)
    out = fixed(q, *pools, tables, starts, totals, **family)
    ref = plain(q, *pools, tables, starts, totals, **family)
    torch.cuda.synchronize()
    for b, (start, total) in enumerate(rows):
        live = total - start
        assert _rel_err(out[b, :live], ref[b, :live]) < TOLERANCE[dtype], (case, b)
        assert not bool(out[b, live:].any()), (case, b)
    if window:
        return
    ragged_q = ragged_q_paged_attention_quant if quant else ragged_q_paged_attention
    batch = len(rows)
    offsets = [b * seq for b in range(batch)]
    flat = ragged_q(q.reshape(batch * seq, heads, dim), *pools, tables, starts, totals,
                    torch.tensor(offsets, dtype=torch.int32, device=device), max_q_len=seq,
                    block_q=8, q_offsets_host=offsets, **family)
    torch.cuda.synchronize()
    flat = flat.view(batch, seq, heads, dim)
    for b, (start, total) in enumerate(rows):
        assert torch.equal(flat[b, : total - start], out[b, : total - start]), (case, b)


# ---------------------------------------------------------------------- #
# B2, B5: the cases the tensor-core body, with each slot's keys cut into
# live key tiles split over the CTAs of a cluster, each key tile split
# over the CTA's warps and a cp.async ring per warp, can get wrong. At
# these shapes the key tile is 64 (32 at D 256), and a slot has 1 (T 300)
# or 2 (T 1024, split at the middle live tile) CTAs.
# ---------------------------------------------------------------------- #
# lengths at every tile edge (63, 64, 65 …), at the edges of 4, 8 and 12
# tiles, and the whole cache
DECODE_LENGTHS_300 = [0, 1, 63, 64, 65, 255, 256, 257, 300]
DECODE_LENGTHS_1024 = DECODE_LENGTHS_300[:-1] + [511, 512, 513, 767, 768, 769, 1023, 1024]
# id: heads, kv_heads, dim, max_len, lengths, window, softcap
DECODE_EDGES = {
    # T not a multiple of the tile, G 4 (Llama-3-8B heads): one CTA a slot
    "t300-g4": (32, 8, 128, 300, DECODE_LENGTHS_300, 0, None),
    # two CTAs a slot, G 1, D 64
    "t1024-g1-d64": (8, 8, 64, 1024, DECODE_LENGTHS_1024, 0, None),
    # D 256 (two warps a key group, 32-key tiles), G 2, a softcap
    "t1024-g2-d256": (8, 4, 256, 1024, DECODE_LENGTHS_1024, 0, 50.0),
    # a window whose first key falls inside a tile, G 8
    "t300-g8-window": (16, 2, 128, 300, DECODE_LENGTHS_300, 37, None),
    # a window of 300: its first key inside a tile, and whole tiles below
    # it for the long slots
    "t1024-g4-window": (32, 8, 128, 1024, DECODE_LENGTHS_1024, 300, None),
    # G 8, D 64, a window of exactly one tile and a softcap
    "t1024-g8-d64-window": (16, 2, 64, 1024, DECODE_LENGTHS_1024, 64, 30.0),
    # G 32: two 16-head row tiles per kv head
    "t300-g32": (32, 1, 128, 300, DECODE_LENGTHS_300, 0, None),
}
# int8 cache only: head dim 80 (padded to 128)
DECODE_QUANT_EDGES = {
    "t300-d80-g8": (16, 2, 80, 300, DECODE_LENGTHS_300, 0, 30.0),
    "t1024-d80-g4-window": (8, 2, 80, 1024, DECODE_LENGTHS_1024, 300, None),
}
DECODE_EDGE_PARAMS = [pytest.param(False, case, id=f"B2-{case}") for case in sorted(DECODE_EDGES)] + [
    pytest.param(True, case, id=f"B5-{case}") for case in sorted({**DECODE_EDGES, **DECODE_QUANT_EDGES})
]


def _decode_case(case, quant, dead_rows_nan=False):
    """q, the cache operands the kernel reads, the operands the plain
    version reads, lengths and the family of ``case``. With
    ``dead_rows_nan``, every cache row outside a slot's live keys [window
    start, length) holds NaN (its scales, for int8) in the kernel's
    operands and zeros in the plain version's."""
    device = _card()
    heads, kv_heads, dim, max_len, lengths, window, softcap = {**DECODE_EDGES, **DECODE_QUANT_EDGES}[case]
    rng = np.random.default_rng(sum(map(ord, case)) + (5 if quant else 0))

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch.bfloat16)

    slots = len(lengths)
    q = draw(slots, heads, dim)
    k, v = draw(slots, max_len, kv_heads, dim), draw(slots, max_len, kv_heads, dim)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    cache = (*quantize_kv(k), *quantize_kv(v)) if quant else (k, v)
    plain_cache = cache
    if dead_rows_nan:
        pos = torch.arange(max_len, device=device)[None, :]
        lo = (lens[:, None] - window).clamp(min=0) if window else torch.zeros_like(lens[:, None])
        dead = (pos >= lens[:, None]) | (pos < lo)  # [S, T]
        if quant:
            kq, ks, vq, vs = cache
            nan_s = [t.masked_fill(dead[..., None], float("nan")) for t in (ks, vs)]
            zero_s = [t.masked_fill(dead[..., None], 0.0) for t in (ks, vs)]
            zero_v = [t.masked_fill(dead[..., None, None], 0) for t in (kq, vq)]
            cache = (kq, nan_s[0], vq, nan_s[1])
            plain_cache = (zero_v[0], zero_s[0], zero_v[1], zero_s[1])
        else:
            cache = tuple(t.masked_fill(dead[..., None, None], float("nan")) for t in (k, v))
            plain_cache = tuple(t.masked_fill(dead[..., None, None], 0.0) for t in (k, v))
    return q, cache, plain_cache, lens, dict(softcap=softcap, window=window)


def _decode_pair(quant, q, cache, plain_cache, lens, family):
    if quant:
        return (flash_decode_attention_quant(q, *cache, lens, **family),
                decode_attention_quant(q, *plain_cache, lens, **family))
    return flash_decode_attention(q, *cache, lens, **family), decode_attention(q, *plain_cache, lens, **family)


@pytest.mark.gpu
@pytest.mark.parametrize("quant,case", DECODE_EDGE_PARAMS)
def test_flash_decode_edge_cases(quant, case):
    """B2 (B5) against the plain version at every tile edge and split point of
    the length and of the window, slot by slot; an empty slot exactly
    zero; bitwise equal on a repeated launch."""
    q, cache, plain_cache, lens, family = _decode_case(case, quant)
    out, ref = _decode_pair(quant, q, cache, plain_cache, lens, family)
    again, _ = _decode_pair(quant, q, cache, plain_cache, lens, family)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "a repeated launch must give the same bits"
    for s, n in enumerate(lens.tolist()):
        if n == 0:
            assert not bool(out[s].any()), (case, s, "an empty slot must decode to zeros")
            continue
        assert _rel_err(out[s], ref[s]) < TOLERANCE["bfloat16"], (case, s, n)


@pytest.mark.gpu
@pytest.mark.parametrize("quant,case", DECODE_EDGE_PARAMS)
def test_flash_decode_reads_no_dead_row(quant, case):
    """Every cache row outside a slot's live keys holds NaN: a length-0
    slot's whole cache, and in a live slot every row past its length and
    below its window (so every whole key tile there too). No
    NaN may reach the output, which must match the plain version over a
    copy whose dead rows are zeros."""
    q, cache, plain_cache, lens, family = _decode_case(case, quant, dead_rows_nan=True)
    out, ref = _decode_pair(quant, q, cache, plain_cache, lens, family)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()), case
    for s, n in enumerate(lens.tolist()):
        if n == 0:
            assert not bool(out[s].any()), (case, s)
            continue
        assert _rel_err(out[s], ref[s]) < TOLERANCE["bfloat16"], (case, s, n)


# ---------------------------------------------------------------------- #
# int8 weights and the carries on the card
# ---------------------------------------------------------------------- #
# the model on the card (bf16, kernels, cuBLAS) against the CPU (bf16,
# plain path): the GEMMs round bf16 activations differently
MODEL_TOLERANCE = 5e-2


def _small_llama(max_seq_len):
    """Llama-3's heads (head_dim 128, GQA 4) at a small width, 2 layers."""
    return dataclasses.replace(
        model.LlamaConfig.llama3_8b(max_seq_len=max_seq_len), num_layers=2, hidden_size=1024,
        intermediate_size=2048, num_heads=8, num_kv_heads=2, head_dim=128, vocab_size=4096)


@pytest.mark.gpu
@pytest.mark.parametrize("call", ["dense", "paged", "mixed"])
def test_int8_weight_model_calls_match_cpu(call):
    """int8 weights (``quantize_params`` of bf16 ones) through prefill and
    two decode steps (dense: B1, B2), paged prefill and two paged decode
    steps (B3), or paged prefill and one mixed step (B7): the card's
    logits within MODEL_TOLERANCE of the same calls on the CPU, fed the
    same tokens."""
    device = _card()
    config = _small_llama(128)
    params = quant.quantize_params(model.init_params(config, seed=5, device=device))
    assert isinstance(params["wq"], quant.QTensor) and params["wq"].q.dtype == torch.int8
    cpu_params = {name: leaf.to("cpu") for name, leaf in params.items()}
    rng = np.random.default_rng(5)
    prompts = torch.from_numpy(rng.integers(0, config.vocab_size, size=(2, 40)))
    lengths = torch.tensor([40, 23], dtype=torch.int32)
    fed = torch.from_numpy(rng.integers(0, config.vocab_size, size=(2, 16)))
    tables = torch.arange(1, 17, dtype=torch.int32).view(2, 8)

    def run(where, p):
        freqs = model.model_freqs(config, device=where)
        step = (lengths + 1).to(where)
        if call == "dense":
            cache = model.init_cache(config, 2, 128, device=where)
            stages = [model.prefill(config, p, cache, prompts.to(where), lengths.to(where),
                                    torch.tensor([0, 1], device=where), freqs)]
            for j in range(2):
                stages.append(model.decode_step(config, p, cache, fed[:, j].to(where), step + j, freqs))
            return stages
        cache = model.init_paged_cache(config, 17, 16, device=where)
        t = tables.to(where)
        stages = [model.paged_prefill(config, p, cache, prompts.to(where), lengths.to(where), t, freqs)]
        if call == "paged":
            for j in range(2):
                stages.append(model.paged_decode_step(config, p, cache, fed[:, j].to(where), step + j, t,
                                                      freqs))
            return stages
        # row 0 decodes its next token, row 1 re-teaches a window of 16 from 23
        tokens = fed.clone()
        offsets = torch.tensor([40, 23], dtype=torch.int32)
        num_tokens = torch.tensor([1, 16], dtype=torch.int32)
        stages.append(model.paged_mixed_step(config, p, cache, tokens.to(where), offsets.to(where),
                                             num_tokens.to(where), t, freqs))
        return stages

    card = run(device, params)
    cpu = run("cpu", cpu_params)
    for index, (out, ref) in enumerate(zip(card, cpu)):
        out = out.float().cpu()
        assert bool(torch.isfinite(out).all()), (call, index)
        assert _rel_err(out, ref) < MODEL_TOLERANCE, (call, index, _rel_err(out, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["dense", "paged", "mixed"])
def test_pipelined_engine_matches_serial(layout):
    """Greedy streams of a 2-layer engine on the card, six concurrent
    requests over four slots: pipelined (``pipeline_decode``, and the
    mixed-step carry in the mixed layout) equal serial, and the pipelined
    engine chained."""
    device = _card()
    config = _small_llama(256)
    params = model.init_params(config, seed=6, device=device)
    extra = {
        "dense": {}, "paged": dict(kv_layout="paged"),
        "mixed": dict(kv_layout="paged", prefill_mode="mixed", prefill_chunk=32),
    }[layout]
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, config.vocab_size, size=n).tolist() for n in (12, 30, 45, 60, 20, 50)]

    def run(pipeline):
        eng = engine.DecodeEngine(config, params, device=device, max_slots=4, prefill_buckets=[32, 64],
                                  decode_chunk=4, pipeline_decode=pipeline, **extra)
        chained = [0]
        dispatch = eng._dispatch_decode

        def counted(*args, **kwargs):
            chained[0] += kwargs.get("carry") is not None
            return dispatch(*args, **kwargs)

        eng._dispatch_decode = counted

        async def main():
            return await asyncio.gather(*[
                eng.generate(prompt, engine.SamplingParams(max_new_tokens=20)) for prompt in prompts])

        try:
            results = asyncio.run(main())
        finally:
            eng.stop()
        return [r.tokens for r in results], chained[0], eng.stats

    serial, _, _ = run(False)
    pipelined, chained, stats = run(True)
    assert pipelined == serial
    assert all(len(tokens) == 20 for tokens in serial)
    assert chained > 0, stats
    if layout == "mixed":
        assert stats["mixed_steps_chained"] > 0, stats


MIXED_LAYOUT = dict(kv_layout="paged", prefill_mode="mixed", prefill_chunk=32)
# layout -> engine settings; every one but "mixed" runs chunks of 2 while
# requests wait (admission_chunk, a variant of its own). With it, this
# traffic leaves the mixed layout no mixed step to chain (every chain
# plan finds an admission waiting), so "mixed" runs without it, for the
# mixed carry, and "mixed-admission" with it.
GRAPH_LAYOUTS = {
    "dense": dict(admission_chunk=2),
    "paged": dict(kv_layout="paged", admission_chunk=2),
    "mixed": MIXED_LAYOUT,
    "mixed-admission": dict(MIXED_LAYOUT, admission_chunk=2),
}


def _graph_engine(config, params, layout, graphs, **kwargs):
    return engine.DecodeEngine(config, params, device=params["embedding"].device, max_slots=4,
                               prefill_buckets=[32, 64], decode_chunk=4, pipeline_decode=True,
                               step_graphs=graphs, **GRAPH_LAYOUTS[layout], **kwargs)


@pytest.mark.gpu
@pytest.mark.parametrize("quantize", [None, "int8"], ids=["bf16-weights", "int8-weights"])
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16-kv", "int8-kv"])
@pytest.mark.parametrize("layout", sorted(GRAPH_LAYOUTS))
def test_graphed_engine_captures_every_variant_and_matches_eager(layout, kv_quant, quantize):
    """``precompile`` captures every step variant as a CUDA graph (every
    mixed width in the mixed layouts, the admission chunk's step count);
    serving then captures nothing, and its greedy and seeded streams over
    six concurrent requests on four slots, pipelined with the carries,
    equal an eager engine's. The kernels the card ran while serving
    (counted by the kernels' device counters, replays included) hold the
    chip check's gate: each path's kernels once per layer per model call,
    no other kernel; in the eager run they equal the wrappers' counts."""
    device = _card()
    config = _small_llama(256)
    params = model.init_params(config, seed=8, device=device)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, config.vocab_size, size=n).tolist() for n in (12, 30, 45, 60, 20, 50)]
    samplings = [
        engine.SamplingParams(max_new_tokens=20) if i % 3 else
        engine.SamplingParams(max_new_tokens=20, temperature=0.8, top_p=0.9, seed=i)
        for i in range(len(prompts))
    ]

    def run(graphs):
        eng = _graph_engine(config, params, layout, graphs, kv_quant=kv_quant, quantize=quantize)
        if graphs:
            eng.precompile()
        captured = eng.steps.stats["captured"]
        chained = [0]
        dispatch = eng._dispatch_decode

        def counted(*args, **kwargs):
            chained[0] += kwargs.get("carry") is not None
            return dispatch(*args, **kwargs)

        eng._dispatch_decode = counted
        for wrapper in WRAPPERS.values():
            wrapper.launches = 0

        async def main():
            return await asyncio.gather(*[eng.generate(p, s) for p, s in zip(prompts, samplings)])

        try:
            with launches_lib.device_launches() as launches:
                results = asyncio.run(main())
        finally:
            eng.stop()
        if not graphs:
            assert launches == {name: wrapper.launches for name, wrapper in WRAPPERS.items()}
        return [r.tokens for r in results], eng, captured, launches, chained[0]

    eager, _, _, _, _ = run(False)
    graphed, eng, captured, launches, chained = run(True)
    mixed = layout.startswith("mixed")
    keys = eng._variant_keys()
    assert {k.size for k in keys if k.kind == "decode"} == ({1, 4} if layout == "mixed" else {1, 2, 4})
    assert captured == len(keys) == eng.steps.stats["captured"]
    assert all(entry.graph is not None for entry in eng.steps._entries.values())
    if mixed:
        assert {k.size for k in eng.steps._entries if k.kind == "mixed"} == set(eng._mixed_widths)
    assert graphed == eager
    assert all(len(tokens) == 20 for tokens in graphed)
    if layout != "mixed-admission":
        assert chained > 0, eng.stats
    if layout == "mixed":
        assert eng.stats["mixed_steps_chained"] > 0, eng.stats
    calls, layers, q = eng.stats["model_dispatches"], config.num_layers, "_quant" if kv_quant else ""
    if layout == "dense":
        expect = {f"flash_prefill{q}": layers * calls.get("prefill", 0),
                  f"flash_decode{q}": layers * calls.get("decode_step", 0)}
    elif layout == "paged":
        expect = {f"paged_attention{q}": layers * sum(calls.values())}
    else:
        expect = {f"paged_attention_ragged_q{q}": layers * calls.get("paged_mixed_step", 0),
                  f"paged_attention{q}": layers * calls.get("paged_decode_step", 0)}
    assert all(count > 0 for count in expect.values()), (expect, calls)
    assert launches == {name: expect.get(name, 0) for name in launches}, (launches, calls)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(GRAPH_LAYOUTS))
def test_precompile_leaves_cache_and_counts_on_the_card(layout):
    """On the card, ``precompile``'s warm-up runs, captures and prefill
    calls leave a cache and penalty counts filled with seeded noise as
    they were (the paged null block aside), over both cache types."""
    device = _card()
    config = _small_llama(256)
    params = model.init_params(config, seed=9, device=device)
    for kv_quant in (None, "int8"):
        eng = _graph_engine(config, params, layout, True, kv_quant=kv_quant)
        gen = torch.Generator(device=device).manual_seed(9)
        for leaf in eng.cache.values():
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-100, 100, leaf.shape, device=device, generator=gen))
            else:
                leaf.copy_(torch.randn(leaf.shape, device=device, generator=gen))
        eng._counts.copy_(torch.randint(0, 3, eng._counts.shape, device=device, generator=gen))
        before = {name: leaf.clone() for name, leaf in eng.cache.items()}
        counts = eng._counts.clone()
        eng.precompile()
        torch.cuda.synchronize()
        live = slice(1, None) if eng.paged else slice(None)
        for name, leaf in eng.cache.items():
            assert torch.equal(leaf[:, live], before[name][:, live]), (kv_quant, name)
        assert torch.equal(eng._counts, counts), kv_quant
        assert eng.stats["model_dispatches"] == {}


# ---------------------------------------------------------------------- #
# prefill as CUDA graphs, and its harvest
# ---------------------------------------------------------------------- #
# the kernel a prefill replay launches -> (layout, kv cache)
PREFILL_GRAPH_CASES = {"B1": ("dense", None), "B4": ("dense", "int8"),
                       "B3": ("paged", None), "B6": ("paged", "int8")}


def _by_hand(eng, requests):
    """Admit ``requests`` in one round and harvest every record, on the
    test's thread (no engine thread); returns each slot's first token and
    logprob."""
    with torch.inference_mode():
        for prompt, sampling in requests:
            eng._pending.append(engine.GenerationRequest(prompt_tokens=prompt, sampling=sampling))
        eng._admit()
        while eng._prefill_inflight:
            eng._harvest_prefills(block=True)
    return [(slot.generated[0], slot.logprobs[0]) for slot in eng.slots if slot.active]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(PREFILL_GRAPH_CASES))
def test_prefill_graph_replay_matches_eager(kernel):
    """One admission round (two cold prompts in one group, a third that is
    cold on the dense layout and warm onto the first's blocks on the paged
    one, a prompt past the largest bucket in windows) replayed from the
    graphs ``precompile`` captured, and the same round run eagerly
    (``step_graphs=False``): the prefill calls' logits bit for bit equal
    (the same kernels on the same inputs), and so the first tokens and
    logprobs. The replays captured nothing, and the card ran the path's
    kernel once per layer per cold or paged model call (device counters;
    B3/B6 all at the prefill shape); eagerly, the wrappers counted the same."""
    device = _card()
    layout, kv_quant = PREFILL_GRAPH_CASES[kernel]
    config = _small_llama(256)
    params = model.init_params(config, seed=10, device=device)
    rng = np.random.default_rng(10)
    shared = rng.integers(0, config.vocab_size, size=40).tolist()
    requests = [
        (shared + rng.integers(0, config.vocab_size, size=5).tolist(),
         engine.SamplingParams(max_new_tokens=4)),
        (rng.integers(0, config.vocab_size, size=50).tolist(),
         engine.SamplingParams(max_new_tokens=4, temperature=0.8, top_p=0.9, seed=1)),
        (shared + rng.integers(0, config.vocab_size, size=9).tolist(),
         engine.SamplingParams(max_new_tokens=4, temperature=1.0, top_k=20, seed=2)),
        (rng.integers(0, config.vocab_size, size=100).tolist(), engine.SamplingParams(max_new_tokens=4)),
    ]

    def run(graphs):
        eng = engine.DecodeEngine(config, params, device=device, max_slots=4, prefill_buckets=[32, 64],
                                  decode_chunk=4, kv_layout=layout, kv_block_size=16, kv_quant=kv_quant,
                                  step_graphs=graphs)
        if graphs:
            eng.precompile()
        captured = eng.steps.stats["captured"]
        logits = []
        step = eng.steps.run

        def recorded(key, inputs):
            staged, outputs = step(key, inputs)
            if key.kind in ("prefill", "prefill_offset"):
                logits.append((key, outputs["logits"].clone()))
            return staged, outputs

        eng.steps.run = recorded
        for wrapper in WRAPPERS.values():
            wrapper.launches = 0
        try:
            with launches_lib.device_launches(shapes=True) as launches:
                firsts = _by_hand(eng, requests)
        finally:
            eng.stop()
        if graphs:
            assert eng.steps.stats["captured"] == captured
        else:
            assert all(launches[name] == wrapper.launches for name, wrapper in WRAPPERS.items())
        return firsts, logits, launches, eng

    eager, eager_logits, _, _ = run(False)
    graphed, graphed_logits, launches, eng = run(True)
    assert [key for key, _ in graphed_logits] == [key for key, _ in eager_logits]
    for (key, mine), (_, theirs) in zip(graphed_logits, eager_logits):
        assert torch.equal(mine, theirs), key
    assert graphed == eager and len(graphed) == 4
    calls, q = eng.stats["model_dispatches"], "_quant" if kv_quant else ""
    if layout == "dense":
        expect = {f"flash_prefill{q}": config.num_layers * calls["prefill"]}
        assert calls["prefill_at_offset"] >= 2  # the long prompt's windows: plain attention
    else:
        # every B3/B6 launch a prefill call's, more than one q token per slot
        prefills = config.num_layers * (calls["paged_prefill"] + calls["paged_prefill_at_offset"])
        expect = {f"paged_attention{q}": prefills, f"paged_attention{q}/prefill": prefills}
        assert eng.stats["warm_prefill_calls"] == 1
    assert launches == {name: expect.get(name, 0) for name in launches}, (launches, calls)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_behind_inflight_chunk_is_harvested_without_blocking(layout):
    """Slot 0 decodes; a sleep kernel holds the card, then its chunk is
    dispatched and slot 1's prefill replays behind it. A harvest that
    must not block returns at once with the record in flight and slot 1
    still out of decode; once the card has run both, a harvest emits slot
    1's first token: the one the same request gets alone on an eager
    engine (the same kernels on the same inputs)."""
    device = _card()
    config = _small_llama(256)
    params = model.init_params(config, seed=11, device=device)
    rng = np.random.default_rng(11)
    first = (rng.integers(0, config.vocab_size, size=20).tolist(), engine.SamplingParams(max_new_tokens=12))
    late = (rng.integers(0, config.vocab_size, size=30).tolist(),
            engine.SamplingParams(max_new_tokens=12, temperature=0.8, seed=4))
    args = dict(device=device, max_slots=4, prefill_buckets=[32, 64], decode_chunk=4, kv_layout=layout,
                pipeline_decode=True)
    eng = engine.DecodeEngine(config, params, **args)
    eng.precompile()
    try:
        with torch.inference_mode():
            _by_hand(eng, [first])
            torch.cuda._sleep(200_000_000)  # ~0.1 s at <= 2 GHz
            chunk = eng._dispatch_decode()
            eng._pending.append(engine.GenerationRequest(prompt_tokens=late[0], sampling=late[1]))
            eng._admit()
            started = time.perf_counter()
            eng._harvest_prefills(block=False)
            waited = time.perf_counter() - started
            assert len(eng._prefill_inflight) == 1 and eng.slots[1].prefilling, waited
            assert waited < 0.02, waited
            assert not eng._can_chain(chunk)
            eng._process_decode(chunk)
            torch.cuda.synchronize()
            eng._harvest_prefills(block=False)
            assert eng._prefill_inflight == [] and eng.slots[1].ready
            got = (eng.slots[1].generated[0], eng.slots[1].logprobs[0])
            assert len(eng.slots[0].generated) == 5
    finally:
        eng.stop()
    alone = engine.DecodeEngine(config, params, step_graphs=False, **args)
    try:
        want = _by_hand(alone, [late])[0]
    finally:
        alone.stop()
    assert got == want


# ---------------------------------------------------------------------- #
# embeddings and vector search on the card
# ---------------------------------------------------------------------- #
# the f32 encoder and search on the card against the CPU: cuBLAS and the
# CPU's GEMMs sum in other orders (unit vectors)
EMBED_TOLERANCE = 1e-4
SEARCH_TOLERANCE = 1e-5


def _embed_texts(rng, count):
    words = ["stream", "vector", "kernel", "topic", "agent", "card", "search", "token"]
    return [" ".join(rng.choice(words, int(rng.integers(2, 300)))) for _ in range(count)]


@pytest.mark.gpu
def test_encoder_on_the_card_matches_cpu_at_minilm_width():
    """MiniLM-L6 at full width, weights drawn on the card: batches of 8
    and 5 texts (three padding rows) within ``EMBED_TOLERANCE`` of the
    CPU run of the same weights, no NaN, padding rows zero."""
    from langstream_tpu_torch.providers.torch_local.embeddings import (
        EncoderConfig,
        TorchEmbedder,
        init_encoder_params,
    )
    from langstream_tpu_torch.providers.torch_local.tokenizer import ByteTokenizer

    device = _card()
    config = EncoderConfig.minilm_l6()
    params = init_encoder_params(config, seed=3, device=device)
    card = TorchEmbedder(config, params, ByteTokenizer(), device=device)
    cpu = TorchEmbedder(config, {k: v.cpu() for k, v in params.items()}, ByteTokenizer(), device="cpu")
    texts = _embed_texts(np.random.default_rng(3), 8)
    for batch in (texts, texts[:5], texts[:1]):
        tokens, mask = card.batch(batch)
        got, want = card.encode_batch(tokens, mask), cpu.encode_batch(tokens, mask)
        assert got.device.type == "cpu" and not torch.isnan(got).any()
        assert float((got - want).abs().max()) <= EMBED_TOLERANCE
        assert torch.equal(got[len(batch):], torch.zeros_like(got[len(batch):]))
    assert len(card.embed(texts)) == 8


@pytest.mark.gpu
def test_load_hf_bert_onto_the_card_bit_for_bit(tmp_path):
    """``load_hf_bert`` onto the card equals the same load on the CPU bit
    for bit, from a model object and from a ``pytorch_model.bin``
    directory (f32 and bf16)."""
    import json
    import types

    from langstream_tpu_torch.providers.torch_local import weights

    device = _card()
    hf = dict(vocab_size=500, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, max_position_embeddings=128, layer_norm_eps=1e-12)
    gen = torch.Generator().manual_seed(4)
    h, f = hf["hidden_size"], hf["intermediate_size"]
    state = {"embeddings.word_embeddings.weight": torch.randn(500, h, generator=gen),
             "embeddings.position_embeddings.weight": torch.randn(128, h, generator=gen),
             "embeddings.token_type_embeddings.weight": torch.randn(2, h, generator=gen),
             "embeddings.LayerNorm.weight": torch.randn(h, generator=gen),
             "embeddings.LayerNorm.bias": torch.randn(h, generator=gen)}
    for i in range(2):
        p = f"encoder.layer.{i}."
        for name, shape in (("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (f, h)), ("output.dense", (h, f)),
                            ("attention.output.LayerNorm", (h,)), ("output.LayerNorm", (h,))):
            state[p + name + ".weight"] = torch.randn(shape, generator=gen)
            state[p + name + ".bias"] = torch.randn(shape[0], generator=gen)
    obj = types.SimpleNamespace(config=types.SimpleNamespace(**hf), state_dict=lambda: state)
    torch.save(state, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps(dict(hf, model_type="bert")))
    for source in (obj, str(tmp_path)):
        for dtype in (torch.float32, torch.bfloat16):
            card_config, card = weights.load_hf_bert(source, device=device, dtype=dtype)
            cpu_config, cpu = weights.load_hf_bert(source, device="cpu", dtype=dtype)
            assert card_config == cpu_config and sorted(card) == sorted(cpu)
            for name, leaf in cpu.items():
                assert card[name].device.type == "cuda" and card[name].dtype == leaf.dtype, name
                assert torch.equal(card[name].cpu(), leaf), name


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_vector_search_on_the_card_matches_numpy_and_ties(metric):
    """4096 unit vectors x 384 (with exact duplicates) in a store on the
    card: its ids equal the CPU store's (``lax.top_k``'s order: on a tie
    the lower row first) and the numpy path's but for near-ties, scores
    within ``SEARCH_TOLERANCE``; after deletes and re-upserts (a partial
    upload) still."""
    from langstream_tpu_torch.agents.vectorstore import VectorStore

    device = _card()
    rng = np.random.default_rng(5)
    data = rng.standard_normal((4096, 384), dtype=np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    data[[100, 2000, 4000]] = data[7]  # ties with row 7
    card = VectorStore(384, metric=metric, device=device)
    cpu = VectorStore(384, metric=metric, device="cpu")
    host = VectorStore(384, metric=metric, use_torch=False)
    for store in (card, cpu, host):
        for i, vector in enumerate(data):
            store.upsert(f"d{i}", vector)
    queries = np.concatenate([data[[7]], rng.standard_normal((15, 384), dtype=np.float32)])
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)  # at the data's scale

    def compare():
        matrix = host._matrix[:len(host)]
        for query in queries:
            got, want, plain = card.search(query, 12), cpu.search(query, 12), host.search(query, 12)
            assert [r["id"] for r in got] == [r["id"] for r in want]
            for mine, theirs in zip(got, want):
                assert abs(mine["similarity"] - theirs["similarity"]) <= SEARCH_TOLERANCE
            q = query / np.linalg.norm(query) if metric == "cosine" else query
            exact = -np.linalg.norm(matrix - q, axis=1) if metric == "l2" else matrix @ q
            for mine, theirs in zip(got, plain):  # numpy orders exact ties its own way
                if mine["id"] != theirs["id"]:
                    rows = host._index[mine["id"]], host._index[theirs["id"]]
                    assert abs(exact[rows[0]] - exact[rows[1]]) <= SEARCH_TOLERANCE, rows

    compare()
    top = [r["id"] for r in card.search(data[7], 4)]
    assert top == ["d7", "d100", "d2000", "d4000"]
    for i in rng.choice(4096, 50, replace=False):
        for store in (card, cpu, host):
            store.delete(f"d{i}")
    for i in range(50):
        for store in (card, cpu, host):
            store.upsert(f"new{i}", data[i])
    compare()
    assert torch.equal(card._resident.cpu(), torch.from_numpy(card._matrix))


@pytest.mark.gpu
def test_embeddings_served_while_an_engine_captures():
    """``precompile`` of a graphed engine (Llama-3's heads at a small
    width) on one thread while another keeps embedding on the card: the
    capture completes (every variant captured, then a request served)
    and every embedding equals the CPU's within ``EMBED_TOLERANCE``,
    calls inside the capture included."""
    import threading

    from langstream_tpu_torch.providers.torch_local.embeddings import (
        EncoderConfig,
        TorchEmbedder,
        init_encoder_params,
    )
    from langstream_tpu_torch.providers.torch_local.tokenizer import ByteTokenizer

    device = _card()
    config = EncoderConfig.minilm_l6()
    params = init_encoder_params(config, seed=6, device=device)
    card = TorchEmbedder(config, params, ByteTokenizer(), device=device)
    cpu = TorchEmbedder(config, {k: v.cpu() for k, v in params.items()}, ByteTokenizer(), device="cpu")
    rng = np.random.default_rng(6)
    batches = [_embed_texts(rng, n) for n in (1, 3, 8)]
    references = [torch.tensor(cpu.embed(batch)) for batch in batches]
    llama = _small_llama(256)
    eng = _graph_engine(llama, model.init_params(llama, seed=6, device=device), "dense", True)
    done = threading.Event()
    calls = []

    def embed_until_done():
        i = 0
        while not done.is_set():
            started = time.perf_counter()
            got = torch.tensor(card.embed(batches[i % 3]))
            calls.append((started, time.perf_counter(), float((got - references[i % 3]).abs().max())))
            i += 1

    worker = threading.Thread(target=embed_until_done)
    worker.start()
    try:
        time.sleep(0.5)
        window = time.perf_counter()
        eng.precompile()
        window = (window, time.perf_counter())
    finally:
        done.set()
        worker.join(timeout=120)
    assert not worker.is_alive()
    try:
        assert eng.steps.stats["captured"] == len(eng._variant_keys())
        assert all(entry.graph is not None for entry in eng.steps._entries.values())
        result = asyncio.run(eng.generate([1, 2, 3, 4, 5], engine.SamplingParams(max_new_tokens=6)))
        assert len(result.tokens) == 6
    finally:
        eng.stop()
    assert any(start < window[1] and end > window[0] for start, end, _ in calls), (window, calls[:3])
    assert max(error for _, _, error in calls) <= EMBED_TOLERANCE


# ---------------------------------------------------------------------- #
# disaggregation and the host tier on the card
# ---------------------------------------------------------------------- #
def _f32_llama(max_seq_len):
    """:func:`_small_llama` in f32: a replay prefills one row that the
    oracle wrote in a decode step, and only f32 keeps the two in step."""
    return dataclasses.replace(_small_llama(max_seq_len), dtype=torch.float32)


def _paged_gate(eng, calls_before, entries_before, counts, kv_quant):
    """B3 (B6) once per layer per model call in the window, by its card
    counter, and no other kernel; a variant first met there runs its body
    once more to make its outputs (``size`` steps of a decode chunk, one
    call of a prefill), and those count too."""
    name = "paged_attention_quant" if kv_quant else "paged_attention"
    calls = {k: n - calls_before.get(k, 0) for k, n in eng.stats["model_dispatches"].items()}
    new = [key for key in eng.steps._entries if key not in entries_before]
    warm = sum(key.size if key.kind == "decode" else key.kind in ("prefill", "prefill_offset") for key in new)
    expect = eng.config.num_layers * (sum(calls.values()) + warm)
    assert expect > 0 and counts[name] == expect, (counts, calls, new)
    assert all(n == 0 for k, n in counts.items() if k != name), counts


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["B3", "B6"])
def test_handoff_replay_on_the_card_matches_unified(kv_quant):
    """A prefill engine on the card exports a 2-token leg's chain; the
    records cross the assembler and a second engine imports and replays
    them: its pool rows equal the payload bit for bit, its stream the
    unified engine's, greedy and seeded, and B3 (B6) ran once per layer
    per model call of the replay by its card counter."""
    from langstream_tpu_torch.fleet.handoff import HandoffAssembler, handoff_records, manifest_for_request

    device = _card()
    config = _f32_llama(512)
    params = model.init_params(config, seed=8, device=device)
    # eager: a graph's first use runs its body once more, uncounted by the engine
    kwargs = dict(device=device, max_slots=4, max_seq_len=512, prefill_buckets=[32, 64, 128],
                  decode_chunk=4, kv_layout="paged", kv_block_size=16, kv_quant=kv_quant,
                  step_graphs=False)
    a, b = engine.DecodeEngine(config, params, **kwargs), engine.DecodeEngine(config, params, **kwargs)
    prompt = np.random.default_rng(8).integers(1, config.vocab_size, size=150).tolist()
    run = lambda eng, p, s, **kw: asyncio.run(eng.generate(p, engine.SamplingParams(**s), **kw))
    try:
        for sampling in (dict(max_new_tokens=10), dict(max_new_tokens=10, temperature=0.9, top_k=8, seed=3)):
            a.kv_manager._evict(a.num_blocks)  # the oracle runs cold
            want = run(a, prompt, sampling)
            a.kv_manager._evict(a.num_blocks)  # and so does the leg
            leg = run(a, prompt, dict(sampling, max_new_tokens=2), request_fields={"export_handoff": True})
            assert leg.tokens == want.tokens[:2]
            asm = HandoffAssembler()
            assembled = None
            for record in handoff_records(leg.kv_handoff, manifest_for_request(prompt, leg.tokens, sampling),
                                          max_chunk_bytes=64 * 1024):
                assembled = asm.offer(record, now=0.0) or assembled
            replay = assembled["manifest"]["generated"]
            calls, entries = dict(b.stats["model_dispatches"]), set(b.steps._entries)
            with launches_lib.device_launches() as counts:
                got = run(b, prompt + replay[:-1], sampling, request_fields={
                    "kv_import": assembled["payload"], "replay_tokens": replay, "prompt_len": len(prompt)})
            _paged_gate(b, calls, entries, counts, kv_quant)
            assert got.tokens == want.tokens
            chain, matched = b.kv_manager.match(leg.kv_handoff["tokens"])
            assert matched == 144
            index = torch.tensor(chain, device=device)
            for leaf, rows in assembled["payload"]["arrays"].items():
                assert torch.equal(b.cache[leaf].index_select(1, index).cpu(), rows), leaf
            b.kv_manager._evict(b.num_blocks)
        assert b.stats["handoff_imports"] == 2 and a.stats["handoff_exports"] == 2
        assert b.stats["tokens_wasted"].get("handoff_aborted", 0) == 0
    finally:
        a.stop()
        b.stop()


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["B3", "B6"])
def test_host_promotion_on_the_card_matches_unified(kv_quant):
    """A chain demoted to pinned host memory under pool pressure and
    promoted back by a prompt that continues it: the stream equals a
    never-evicting engine's, and B3 (B6) ran once per layer per model
    call of that admission by its card counter."""
    device = _card()
    config = _f32_llama(128)
    params = model.init_params(config, seed=9, device=device)
    kwargs = dict(device=device, max_slots=4, max_seq_len=128, prefill_buckets=[16, 32, 64],
                  kv_layout="paged", kv_block_size=8, kv_quant=kv_quant, step_graphs=False)
    tiered = engine.DecodeEngine(config, params, kv_blocks=20, kv_host_blocks=32, **kwargs)
    oracle = engine.DecodeEngine(config, params, **kwargs)
    prompt1 = list(range(1, 33))
    prompt2 = prompt1 + list(range(101, 109))
    thrash = [[(i * 31 + j) % 240 + 2 for j in range(32)] for i in range(6)]
    sampling = engine.SamplingParams(max_new_tokens=8)
    run = lambda eng, p: asyncio.run(eng.generate(p, sampling)).tokens
    try:
        outs = {}
        for name, eng in (("tiered", tiered), ("oracle", oracle)):
            outs[name] = [run(eng, prompt1)] + [run(eng, p) for p in thrash]
            calls, entries = dict(eng.stats["model_dispatches"]), set(eng.steps._entries)
            with launches_lib.device_launches() as counts:
                outs[name].append(run(eng, prompt2))
            _paged_gate(eng, calls, entries, counts, kv_quant)
        assert outs["tiered"] == outs["oracle"]
        assert tiered.stats["host_promotions"] > 0 and tiered.stats["host_promote_aborts"] == 0
        entry = next(iter(tiered.kv_host_arena._entries.values()))
        assert all(rows.is_pinned() for rows in entry.data.values())
    finally:
        tiered.stop()
        oracle.stop()


@pytest.mark.gpu
def test_training_step_on_the_card_matches_cpu():
    """``chip_smoke``'s 2-layer check: ``llama3_1b`` at full width and 2
    layers deep, one loss and its gradients (``trainer.loss_fn``, remat)
    in bf16 on the card against the port in f32 on the CPU from the same
    weights, B 2 × T 128 with a padded row: the loss within 1e-2
    relative, every leaf's gradient at cosine 0.99 or more."""
    device = _card()
    import chip_smoke

    result = chip_smoke.check_training_against_cpu(device)
    assert result["loss_err"] <= chip_smoke.TRAIN_LOSS_TOLERANCE
    assert result["worst_cosine"] >= chip_smoke.TRAIN_GRAD_COSINE


@pytest.mark.gpu
def test_moe_training_step_on_the_card_matches_cpu():
    """The MoE train step: ``tiny_moe`` widened to hidden 512 (4 heads of
    128, intermediate 1024) with 8 experts, 2 layers, one loss (the CE
    plus 0.01 × the router's aux loss, the capacity regime) and its
    gradients in bf16 on the card against the port in f32 on the CPU
    from the same weights, B 2 × T 128 with a padded row: the loss within
    1e-2 relative, every leaf's gradient (the router's and the experts'
    included) at cosine 0.99 or more."""
    device = _card()
    import chip_smoke

    config = dataclasses.replace(model.LlamaConfig.tiny_moe(max_seq_len=256), hidden_size=512,
                                 intermediate_size=1024, num_experts=8, dtype=torch.bfloat16)
    result = chip_smoke.check_training_against_cpu(device, config=config)
    print(f"MoE train step, card vs CPU: {result}")
    assert result["loss_err"] <= chip_smoke.TRAIN_LOSS_TOLERANCE
    assert result["worst_cosine"] >= chip_smoke.TRAIN_GRAD_COSINE
    assert result["tokens_routed"] > 0


# ---------------------------------------------------------------------- #
# tensor parallelism: a rank's launch on its head shard, two ranks on one card
# ---------------------------------------------------------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kernel", ["prefill", "decode", "paged"])
def test_sharded_launch_on_a_head_shard_matches_plain(kernel, quant):
    """Each tp=2 rank's launch at Llama-3-8B's shard shape (H 32 over KVH
    8 whole, 16 over 4 a rank, D 128, q bf16): B1/B2/B3 (B4/B5/B6 over
    int8 k/v) on the rank's heads, one launch each, within the bf16
    kernel tolerance of the plain version on the same heads."""
    from langstream_tpu_torch.ops.decode_kernel import flash_decode_attention_sharded
    from langstream_tpu_torch.ops.flash_attention import flash_prefill_attention_sharded
    from langstream_tpu_torch.ops.paged_attention import ragged_paged_attention_sharded
    from langstream_tpu_torch.parallel.mesh import head_shard

    device = _card()
    rng = np.random.default_rng(5)
    heads, kv_heads, dim, size = 32, 8, 128, 2

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch.bfloat16)

    if kernel == "prefill":
        q, k, v = draw(2, 128, heads, dim), draw(2, 128, kv_heads, dim), draw(2, 128, kv_heads, dim)
        lengths = torch.tensor([128, 77], dtype=torch.int32, device=device)
        rows = (k, v)
    elif kernel == "decode":
        q, k, v = draw(4, heads, dim), draw(4, 256, kv_heads, dim), draw(4, 256, kv_heads, dim)
        lengths = torch.tensor([256, 100, 1, 37], dtype=torch.int32, device=device)
        rows = (k, v)
    else:
        q, k, v = draw(3, 1, heads, dim), draw(33, 16, kv_heads, dim), draw(33, 16, kv_heads, dim)
        tables = torch.from_numpy((rng.permutation(32) + 1).reshape(2, 16).astype(np.int32))
        tables = torch.cat([tables, torch.zeros((1, 16), dtype=torch.int32)]).to(device)
        lengths = torch.tensor([250, 17, 1], dtype=torch.int32, device=device)
        rows = (k, v)
    scales = {}
    if quant:
        (k, k_scale), (v, v_scale) = quantize_kv(rows[0]), quantize_kv(rows[1])
        scales = dict(k_scale=k_scale, v_scale=v_scale)
    for rank in range(size):
        qs, ks, vs = head_shard(q, q.dim() - 2, rank, size), head_shard(k, 2, rank, size), \
            head_shard(v, 2, rank, size)
        shard_scales = {name: head_shard(value, 2, rank, size) for name, value in scales.items()}
        if kernel == "prefill":
            name = "flash_prefill"
            call = lambda: flash_prefill_attention_sharded(q, k, v, rank=rank, size=size, lengths=lengths,
                                                          **scales)
            mask = torch.arange(128, device=device)[None, :] < lengths[:, None]
            plain = (chunk_attention_quant(qs, ks, shard_scales["k_scale"], vs, shard_scales["v_scale"],
                                           torch.zeros_like(lengths), lengths) if quant
                     else prefill_attention(qs, ks, vs, mask=mask))
            plain = plain[:, :77]
        elif kernel == "decode":
            name = "flash_decode"
            call = lambda: flash_decode_attention_sharded(q, k, v, lengths, rank=rank, size=size, **scales)
            plain = (decode_attention_quant(qs, ks, shard_scales["k_scale"], vs, shard_scales["v_scale"],
                                            lengths) if quant else decode_attention(qs, ks, vs, lengths))
        else:
            name = "paged_attention"
            call = lambda: ragged_paged_attention_sharded(q, k, v, tables, lengths - 1, lengths, rank=rank,
                                                         size=size, **scales)
            plain = (paged_decode_attention_quant(qs[:, 0], ks, shard_scales["k_scale"], vs,
                                                  shard_scales["v_scale"], tables, lengths) if quant
                     else paged_decode_attention(qs[:, 0], ks, vs, tables, lengths))[:, None]
        name += "_quant" if quant else ""
        with launches_lib.device_launches() as counts:
            out = call()
        assert counts[name] == 1 and sum(counts.values()) == 1, counts
        assert out.shape[-2] == heads // size
        got = out[:, :77] if kernel == "prefill" else out
        assert _rel_err(got, plain) < TOLERANCE["bfloat16"], (kernel, rank)


@pytest.mark.gpu
def test_two_ranks_on_one_card_match_one_rank(tmp_path):
    """Two tp ranks sharing the card over gloo (``parallel/launch.py``,
    ``tests/torch_tp_worker.py``): a cold prefill and one decode step at
    Llama-3-8B's head shape (16 heads over 4 of 128; 8 over 2 a rank),
    bf16, 2 layers. Both ranks' logits equal bit for bit (gathered
    whole) and within the model tolerance of one rank's on the card; each
    rank launched B1 and B2 once per layer per call."""
    import json
    import pathlib

    from langstream_tpu_torch.parallel import launch
    from langstream_tpu_torch.runtime.multihost import free_port
    import torch_tp_worker as worker

    device = _card()
    out = str(tmp_path / "ranks")
    repo = pathlib.Path(__file__).resolve().parents[1]
    children = launch.spawn_ranks("torch_tp_worker:card_decode_step", {"out": out},
                                  ["cuda:0", "cuda:0"], f"127.0.0.1:{free_port()}", timeout_s=120,
                                  ranks=range(2), path=[str(repo / "tests")], cwd=str(repo))
    config = dataclasses.replace(model.LlamaConfig(**worker.CARD_CONFIG), dtype=torch.bfloat16)
    want, _ = worker.card_calls(config, model.init_params(config, seed=0, device=device), str(device))
    assert launch.stop_ranks(children, timeout_s=180) == [0, 0]
    ranks = [dict(np.load(f"{out}.{rank}.npz")) for rank in range(2)]
    accounts = [json.load(open(f"{out}.{rank}.json")) for rank in range(2)]
    for call, logits in want.items():
        np.testing.assert_array_equal(ranks[0][call], ranks[1][call])
        assert _rel_err(torch.from_numpy(ranks[0][call]), torch.from_numpy(logits)) < 5e-2, call
    for account in accounts:
        assert account["backend"] == "gloo"
        assert account["launches"] == {"prefill": {"flash_prefill": 2}, "decode": {"flash_decode": 2}}
