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
