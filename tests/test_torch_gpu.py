"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skips where there is no CUDA device (the check runs inside each
test, never at import). Run on a GPU machine with::

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the repository's conftest configures JAX, which the
port does not need.)
"""

import numpy as np
import pytest
import torch

from langstream_tpu_torch.ops.attention import decode_attention, prefill_attention
from langstream_tpu_torch.ops.decode_kernel import flash_decode_attention
from langstream_tpu_torch.ops.flash_attention import flash_prefill_attention

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
