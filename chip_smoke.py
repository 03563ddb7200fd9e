"""Drive the PyTorch/CUDA port on one GPU and check it.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases (any failure propagates and the exit code is not 0):

1. Device: the card's name, and its name and power limit from nvidia-smi.
2. Kernels: build every CUDA kernel of the serving paths from
   ``langstream_tpu_torch/csrc`` (one nvcc per source, started together),
   hold each against its plain PyTorch version at the paths' shapes
   (q bf16), and time kernel, plain version, the PyTorch library call
   (``scaled_dot_product_attention``, a yardstick only; over a dequantized
   bf16 view for the int8 kernels, SDPA takes no int8) and the least time
   the card could take (bound). Times are device times: the timed calls
   are enqueued while a sleep kernel holds the card, so the host's share
   is left out; each kernel's wall time per call with the host in the
   loop is printed beside it. B1 flash prefill and B2 flash decode carry
   the dense path; B3 ragged paged attention the paged path, at a decode
   and a prefill-at-offset shape; B4, B5 and B6 are their int8-KV twins,
   at the same shapes over ``quantize_kv`` of the same activations.
3. Reference: the model at Llama-3-8B width, depth cut to 2 layers, on the
   card (kernels) against the same weights on the CPU (plain path), for
   the dense layout and the paged one (cold prefill, prefill-at-offset
   onto another row's blocks, decode), with the bf16 cache and with the
   int8 one. On the card the paged logits are also held against the
   dense ones, the windowed prefill of a long prompt (both layouts)
   against a one-shot prefill, and the int8 logits against the bf16 ones.
4. Dense serving: Llama-3-8B (bf16, random weights from seed 0) behind
   the port's OpenAI server, started as ``python -m langstream_tpu_torch
   serve`` starts it, answering 16 concurrent chat and text completions
   plus one SSE stream. The kernels' launch counters are zeroed just
   before and read just after; B1 and B2 must have been launched once per
   layer per model call. Then one eager decode step of that model: host
   enqueue time against wall time (again in phase 6, over the int8 cache).
5. Paged serving: the same model with ``--kv-layout paged``, answering 16
   chats that share a ~512-byte system message, 8 text completions and
   one SSE stream. The prefix cache must have served tokens, B3 must have
   been launched once per layer per model call, and B1 and B2 not at all.
6. int8 serving: phases 4 and 5 again, same model and traffic, with
   ``kv-quant: int8`` in the provider's engine config (``serve`` has no
   flag for it). Dense: B4 and B5 once per layer per model call; paged:
   B6 once per layer per model call; no other kernel launched.

The line before the last holds the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import dataclasses
import gc
import json
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")

import torch.nn.functional as F  # noqa: E402

from langstream_tpu_torch.cli.main import build_parser, serve_config, start_server  # noqa: E402
from langstream_tpu_torch.ops import _build  # noqa: E402
from langstream_tpu_torch.ops.attention import (  # noqa: E402
    chunk_attention_quant,
    decode_attention,
    decode_attention_quant,
    gather_blocks,
    paged_chunk_attention,
    paged_chunk_attention_quant,
    paged_decode_attention,
    paged_decode_attention_quant,
    prefill_attention,
    quantize_kv,
)
from langstream_tpu_torch.ops.decode_kernel import (  # noqa: E402
    flash_decode_attention,
    flash_decode_attention_quant,
)
from langstream_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_prefill_attention,
    flash_prefill_attention_quant,
)
from langstream_tpu_torch.ops.paged_attention import (  # noqa: E402
    block_bounds,
    ragged_paged_attention,
    ragged_paged_attention_quant,
)
from langstream_tpu_torch.providers.torch_local import model  # noqa: E402
from langstream_tpu_torch.providers.torch_local.engine import long_prefill_windows  # noqa: E402

# H100 SXM published peaks (dense bf16 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# bf16 inputs: p is rounded to bf16 before p·v (B1-B3) and the sums run
# in another order than the plain einsum; relative to max |reference|
KERNEL_TOLERANCE = 2e-2
# the 2-layer model on the card (bf16, kernels) vs the CPU (bf16, plain
# path): cuBLAS and the CPU's GEMMs round bf16 activations differently
MODEL_TOLERANCE = 5e-2
# int8 vs bf16 KV cache logits, relative to max |bf16 logit|: the bound
# of the JAX package's tests/test_kv_quant.py
INT8_TOLERANCE = 5e-2
# bytes of the int8 cache per live position and kv head beyond the values:
# one f32 k scale and one f32 v scale
SCALE_BYTES = 8
# (name, source, TPU kernel) of each kernel, B1-B6
SOURCES = {
    "flash_prefill": ("flash_prefill.cu", "flash_attention.py:64"),
    "flash_decode": ("flash_decode.cu", "decode_kernel.py:198"),
    "paged_attention": ("paged_attention.cu", "paged_attention.py:245"),
    "flash_prefill_quant": ("flash_prefill.cu", "flash_attention.py:153"),
    "flash_decode_quant": ("flash_decode.cu", "decode_kernel.py:206"),
    "paged_attention_quant": ("paged_attention.cu", "paged_attention.py:254"),
}


def log(message: str) -> None:
    print(message, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Device time per call: CUDA events around ``iters`` calls that were
    all enqueued while the card was held busy by a sleep kernel longer
    than their host time, so they run back to back and the host's
    enqueue time (Python checks, allocation, the launch) is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - started
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2.0e9) + 1_000_000)  # cycles at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters: int = 20) -> float:
    """Wall time per call with the host in the loop (enqueue + device),
    what a caller that waits on each call pays."""
    fn()
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - started) / iters * 1e3


def bound(flops: float, nbytes: float):
    by_ops, by_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def errors(out: torch.Tensor, ref: torch.Tensor):
    diff = float((out.float() - ref.float()).abs().max())
    return diff, diff / float(ref.float().abs().max())


def dequantize(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """A bf16 view of an int8 cache, for the SDPA yardstick only."""
    return (values.float() * scales[..., None]).bfloat16()


def entry(name, worst_abs, kernel_ms, plain_ms, bound_ms, bound_by, library_ms) -> dict:
    source, replaces = SOURCES[name]
    return {
        "name": name, "route": "cuda", "source": f"langstream_tpu_torch/csrc/{source}",
        "replaces": f"langstream_tpu/ops/{replaces}", "max_abs_err": worst_abs, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def check_prefill_kernel(device, quant: bool = False) -> dict:
    """B1 at a prefill call of the serving path: B=4, T=256, Llama-3-8B
    heads; with ``quant``, B4 over ``quantize_kv`` of the same k/v."""
    batch, seq, heads, kv_heads, dim = 4, 256, 32, 8, 128
    gen = torch.Generator(device=device).manual_seed(1)
    q = torch.randn(batch, seq, heads, dim, device=device, generator=gen).bfloat16()
    k = torch.randn(batch, seq, kv_heads, dim, device=device, generator=gen).bfloat16()
    v = torch.randn(batch, seq, kv_heads, dim, device=device, generator=gen).bfloat16()
    lengths = torch.tensor([256, 201, 97, 1], dtype=torch.int32, device=device)
    mask = torch.arange(seq, device=device)[None, :] < lengths[:, None]
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        starts = torch.zeros_like(lengths)

        def kernel():
            return flash_prefill_attention_quant(q, kq, ks, vq, vs, lengths=lengths)

        def plain():
            return chunk_attention_quant(q, kq, ks, vq, vs, starts, lengths)

        k, v = dequantize(kq, ks), dequantize(vq, vs)  # the SDPA yardstick's inputs
    else:
        def kernel():
            return flash_prefill_attention(q, k, v, lengths=lengths)

        def plain():
            return prefill_attention(q, k, v, mask=mask)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    worst_abs = worst_rel = 0.0
    for b, n in enumerate(lengths.tolist()):
        a, r = errors(out[b, :n], ref[b, :n])
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
    name = "flash_prefill_quant" if quant else "flash_prefill"
    assert worst_rel < KERNEL_TOLERANCE, f"{name} disagrees: {worst_rel}"
    # SDPA yardstick: same function through one library call (bool mask)
    rows = torch.arange(seq, device=device)
    sdpa_mask = (rows[None, :] <= rows[:, None])[None, None] & mask[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kernel_ms = time_ms(kernel)
    wall_ms = call_ms(kernel)
    plain_ms = time_ms(plain)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=True))
    live = lengths.long()
    pairs = float((live * (live + 1) // 2).sum())        # causal (row, col) pairs
    flops = 4.0 * heads * dim * pairs
    kv_rows = float(live.sum()) * kv_heads               # live (position, kv head) rows
    kv_bytes = kv_rows * (2 * dim + SCALE_BYTES) if quant else 2.0 * 2 * kv_rows * dim
    nbytes = 2.0 * 2 * q.numel() + kv_bytes + 4 * batch
    bound_ms, bound_by = bound(flops, nbytes)
    label = ("B4 flash_prefill_quant", "int8 k/v") if quant else ("B1 flash_prefill", "bf16")
    log(f"{label[0]} [B={batch} T={seq} H={heads} KVH={kv_heads} D={dim} q bf16, {label[1]}]: "
        f"max_abs_err={worst_abs:.3e} max_rel_err={worst_rel:.3e} (tol {KERNEL_TOLERANCE}) "
        f"kernel_ms={kernel_ms:.4f} (call with host {wall_ms:.4f}) plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f}{' (SDPA on a dequantized bf16 view, untimed)' if quant else ''} "
        f"bound_ms={bound_ms:.5f} ({bound_by})")
    return entry(name, worst_abs, kernel_ms, plain_ms, bound_ms, bound_by, library_ms)


def check_decode_kernel(device, quant: bool = False) -> dict:
    """B2 at a decode step of the serving path: 32 slots × 1024 context;
    with ``quant``, B5 over ``quantize_kv`` of the same cache."""
    slots, max_len, heads, kv_heads, dim = 32, 1024, 32, 8, 128
    gen = torch.Generator(device=device).manual_seed(2)
    q = torch.randn(slots, heads, dim, device=device, generator=gen).bfloat16()
    kc = torch.randn(slots, max_len, kv_heads, dim, device=device, generator=gen).bfloat16()
    vc = torch.randn(slots, max_len, kv_heads, dim, device=device, generator=gen).bfloat16()
    lengths_host = [0, 1, max_len] + torch.randint(
        2, max_len, (slots - 3,), generator=torch.Generator().manual_seed(3)).tolist()
    lengths = torch.tensor(lengths_host, dtype=torch.int32, device=device)
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(kc), quantize_kv(vc)

        def kernel():
            return flash_decode_attention_quant(q, kq, ks, vq, vs, lengths)

        def plain():
            return decode_attention_quant(q, kq, ks, vq, vs, lengths)

        kc, vc = dequantize(kq, ks), dequantize(vq, vs)  # the SDPA yardstick's inputs
    else:
        def kernel():
            return flash_decode_attention(q, kc, vc, lengths)

        def plain():
            return decode_attention(q, kc, vc, lengths)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    name = "flash_decode_quant" if quant else "flash_decode"
    assert float(out[0].float().abs().max()) == 0.0, f"{name}: an empty slot must decode to zeros"
    worst_abs = worst_rel = 0.0
    for s in range(1, slots):
        a, r = errors(out[s], ref[s])
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
    assert worst_rel < KERNEL_TOLERANCE, f"{name} disagrees: {worst_rel}"
    sdpa_mask = (torch.arange(max_len, device=device)[None, :] < lengths[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
    kernel_ms = time_ms(kernel)
    wall_ms = call_ms(kernel)
    plain_ms = time_ms(plain)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=True))
    live = float(sum(lengths_host))
    flops = 4.0 * heads * dim * live
    kv_bytes = live * kv_heads * (2 * dim + SCALE_BYTES) if quant else 2.0 * 2 * live * kv_heads * dim
    nbytes = 2.0 * 2 * q.numel() + kv_bytes + 4 * slots
    bound_ms, bound_by = bound(flops, nbytes)
    label = ("B5 flash_decode_quant", "int8 cache") if quant else ("B2 flash_decode", "bf16")
    log(f"{label[0]} [S={slots} T={max_len} H={heads} KVH={kv_heads} D={dim} q bf16, {label[1]}, "
        f"live rows {int(live)}]: max_abs_err={worst_abs:.3e} max_rel_err={worst_rel:.3e} "
        f"(tol {KERNEL_TOLERANCE}) kernel_ms={kernel_ms:.4f} (call with host {wall_ms:.4f}) "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f}"
        f"{' (SDPA on a dequantized bf16 view, untimed)' if quant else ''} "
        f"bound_ms={bound_ms:.5f} ({bound_by})")
    return entry(name, worst_abs, kernel_ms, plain_ms, bound_ms, bound_by, library_ms)


def _paged_bound(seq, heads, kv_heads, dim, block_size, table_width, starts, lengths,
                 window=0, quant=False):
    """The least time B3 (B6 with ``quant``) could take on these inputs
    (and its kind, and the live (query, key) pairs): q and out once, every
    live block-padded k/v block inside each row's [first, last] once (int8
    values and their f32 scales for B6), the tables; 4·H·D FLOPs per live
    pair."""
    batch = len(starts)
    pairs = blocks = 0
    for start, total in zip(starts, lengths):
        new = min(seq, total - start)
        if total <= 0 or new <= 0:
            continue
        first, last = block_bounds(start, total, window, 0, new, block_size)
        blocks += last - first + 1
        for t in range(new):
            pos = start + t
            low = max(0, pos - window + 1) if window > 0 else 0
            pairs += min(pos + 1, total) - low
    flops = 4.0 * heads * dim * pairs
    kv_rows = float(blocks * block_size * kv_heads)
    kv_bytes = kv_rows * (2 * dim + SCALE_BYTES) if quant else 2.0 * 2 * kv_rows * dim
    nbytes = 2.0 * 2 * batch * seq * heads * dim + kv_bytes + 4.0 * batch * (table_width + 2)
    return (*bound(flops, nbytes), pairs)


def check_paged_kernel(device, quant: bool = False) -> dict:
    """B3 at the paged path's two shapes, Llama-3-8B heads, bf16, 16-token
    blocks, in one pool of 2049 blocks through seeded permuted tables
    (rows 0 and 1 share their prefix blocks): a decode step of 32 rows
    over 1024 positions, and a prefill-at-offset of 4 rows. With
    ``quant``, B6 over ``quantize_kv`` of the same pools."""
    heads, kv_heads, dim, block_size, num_blocks, width = 32, 8, 128, 16, 2049, 64
    gen = torch.Generator(device=device).manual_seed(4)
    k_pool = torch.randn(num_blocks, block_size, kv_heads, dim, device=device, generator=gen).bfloat16()
    v_pool = torch.randn(num_blocks, block_size, kv_heads, dim, device=device, generator=gen).bfloat16()
    if quant:
        pools = (*quantize_kv(k_pool), *quantize_kv(v_pool))
        # the SDPA yardstick's inputs
        k_pool, v_pool = dequantize(*pools[:2]), dequantize(*pools[2:])
    else:
        pools = (k_pool, v_pool)
    name = "paged_attention_quant" if quant else "paged_attention"
    rng = np.random.default_rng(4)
    decode_lengths = [0, 1, 16, 17, 1024] + rng.integers(2, 1025, size=27).tolist()
    cases = [
        ("decode", 1, [max(n - 1, 0) for n in decode_lengths], decode_lengths),
        ("prefill-at-offset", 256, [0, 256, 512, 767], [256, 457, 609, 768]),
    ]
    first_entry = None
    for label, seq, starts_host, lengths_host in cases:
        batch = len(starts_host)
        tables_host = (rng.permutation(num_blocks - 1) + 1)[: batch * width].reshape(batch, width)
        tables_host[1, : width // 2] = tables_host[0, : width // 2]
        tables = torch.from_numpy(tables_host.astype(np.int32)).to(device)
        starts = torch.tensor(starts_host, dtype=torch.int32, device=device)
        lengths = torch.tensor(lengths_host, dtype=torch.int32, device=device)
        q = torch.randn(batch, seq, heads, dim, device=device, generator=gen).bfloat16()

        def kernel():
            fn = ragged_paged_attention_quant if quant else ragged_paged_attention
            return fn(q, *pools, tables, starts, lengths)

        def plain():
            if seq == 1:
                fn = paged_decode_attention_quant if quant else paged_decode_attention
                return fn(q[:, 0], *pools, tables, lengths)[:, None]
            fn = paged_chunk_attention_quant if quant else paged_chunk_attention
            return fn(q, *pools, tables, starts, lengths)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        worst_abs = worst_rel = 0.0
        for b, (start, total) in enumerate(zip(starts_host, lengths_host)):
            if total == 0:
                assert float(out[b].float().abs().max()) == 0.0, f"{name}: an empty row must yield zeros"
                continue
            a, r = errors(out[b, : total - start], ref[b, : total - start])
            worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        assert worst_rel < KERNEL_TOLERANCE, f"{name} ({label}) disagrees: {worst_rel}"
        # SDPA yardstick on a contiguous copy gathered through the tables
        # beforehand (the gather, and for B6 the dequantization, untimed)
        kt = gather_blocks(k_pool, tables).transpose(1, 2)
        vt = gather_blocks(v_pool, tables).transpose(1, 2)
        pos_q = starts[:, None] + torch.arange(seq, device=device)[None, :]
        pos_s = torch.arange(kt.shape[2], device=device)
        sdpa_mask = ((pos_s[None, None, :] <= pos_q[:, :, None])
                     & (pos_s[None, None, :] < lengths[:, None, None]))[:, None]
        qt = q.transpose(1, 2)
        kernel_ms = time_ms(kernel)
        wall_ms = call_ms(kernel)
        plain_ms = time_ms(plain)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=True))
        bound_ms, bound_by, pairs = _paged_bound(
            seq, heads, kv_heads, dim, block_size, width, starts_host, lengths_host, quant=quant)
        tag = ("B6", "int8 pools") if quant else ("B3", "bf16")
        log(f"{tag[0]} {name} {label} [B={batch} Tq={seq} H={heads} KVH={kv_heads} D={dim} "
            f"Bs={block_size} M={width} N={num_blocks} q bf16, {tag[1]}, {pairs} live (query, key) "
            f"pairs]: max_abs_err={worst_abs:.3e} max_rel_err={worst_rel:.3e} (tol {KERNEL_TOLERANCE}) "
            f"kernel_ms={kernel_ms:.4f} (call with host {wall_ms:.4f}) plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (SDPA on the pre-gathered{' dequantized' if quant else ''} "
            f"view, untimed) bound_ms={bound_ms:.5f} ({bound_by})")
        if first_entry is None:  # the decode shape stands for the kernel in the kernels line
            first_entry = entry(name, worst_abs, kernel_ms, plain_ms, bound_ms, bound_by, library_ms)
    return first_entry


def check_model_against_cpu(device, kv_quant: bool = False, feed=None):
    """Llama-3-8B width, 2 layers: prefill + 4 decode steps on the card
    (kernels) against the same bf16 weights on the CPU (plain path), over
    the bf16 cache or (``kv_quant``) the int8 one. Decode feeds the card's
    argmax, or the tokens ``feed`` gives; returns the card's logits of
    every stage and the tokens fed."""
    config = dataclasses.replace(model.LlamaConfig.llama3_8b(max_seq_len=128), num_layers=2)
    params = model.init_params(config, seed=7, device=device)
    cpu_params = {name: p.cpu() for name, p in params.items()}
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size, size=(2, 48)))
    lengths = torch.tensor([48, 30], dtype=torch.int32)
    slots = torch.tensor([0, 2])
    worst = 0.0
    caches, logits = {}, {}
    for where, p in (("cuda", params), ("cpu", cpu_params)):
        caches[where] = model.init_cache(config, 3, 128, kv_quant=kv_quant, device=where)
        logits[where] = model.prefill(
            config, p, caches[where], tokens.to(where), lengths.to(where),
            slots.to(where), model.model_freqs(config, device=where))
    active = torch.tensor([True, False, True])
    step_lengths = torch.tensor([49, 0, 31], dtype=torch.int32)
    step_tokens = torch.zeros(3, dtype=torch.long)
    card, fed = [], []
    for step in range(5):
        if step:
            step_tokens[active] = feed[step - 1] if feed else logits["cuda"].argmax(-1).cpu()
            fed.append(step_tokens[active].clone())
            for where, p in (("cuda", params), ("cpu", cpu_params)):
                logits[where] = model.decode_step(
                    config, p, caches[where], step_tokens.to(where), step_lengths.to(where),
                    model.model_freqs(config, device=where), active.to(where))[active.to(where)]
            step_lengths = torch.where(active, step_lengths + 1, step_lengths)
        out, ref = logits["cuda"].cpu(), logits["cpu"]
        assert out.shape == ref.shape and bool(torch.isfinite(out).all())
        worst = max(worst, errors(out, ref)[1])
        card.append(out)
    assert worst < MODEL_TOLERANCE, f"model on the card disagrees with the CPU: {worst}"
    log(f"reference: Llama-3-8B width, 2 layers, {'int8' if kv_quant else 'bf16'} KV cache, prefill "
        f"+ 4 decode steps, card ({'B4/B5' if kv_quant else 'B1/B2'}) vs CPU max_rel_err={worst:.3e} "
        f"(tol {MODEL_TOLERANCE})")
    return card, fed


def check_int8_against_bf16(device) -> None:
    """The dense reference over the int8 cache, fed the bf16 run's tokens:
    its logits on the card within INT8_TOLERANCE of the bf16 cache's."""
    bf16, fed = check_model_against_cpu(device)
    int8, _ = check_model_against_cpu(device, kv_quant=True, feed=fed)
    worst = max(errors(out, ref)[1] for out, ref in zip(int8, bf16))
    agree = float(np.mean([float((o.argmax(-1) == r.argmax(-1)).float().mean())
                           for o, r in zip(int8, bf16)]))
    assert worst < INT8_TOLERANCE, f"int8 KV cache logits vs bf16: {worst}"
    log(f"int8 vs bf16 KV cache: Llama-3-8B width, 2 layers, prefill + 4 decode steps on the card, "
        f"max_rel_err={worst:.3e} (tol {INT8_TOLERANCE}), argmax agreement {agree:.2f}")


def check_paged_model(device, kv_quant: bool = False) -> None:
    """Llama-3-8B width, 2 layers, paged layout (16-token blocks): cold
    prefill of two prompts, prefill-at-offset of a third row whose table
    reuses the first prompt's first two blocks, then four decode steps (a
    fourth, empty row rides along), on the card (B3; B6 over int8 pools)
    against the CPU (plain), and on the card against the dense path
    (B1/B2; B4/B5). Then a 200-token prompt prefilled in the engine's
    long-prompt windows (buckets 64/128), dense and paged, against a
    one-shot prefill."""
    config = dataclasses.replace(model.LlamaConfig.llama3_8b(max_seq_len=256), num_layers=2)
    params = model.init_params(config, seed=7, device=device)
    cpu_params = {name: p.cpu() for name, p in params.items()}
    block, width = 16, 256 // 16
    num_blocks = 4 * width + 1
    rng = np.random.default_rng(9)
    tables = np.zeros((4, width), dtype=np.int32)
    tables[:3] = (rng.permutation(num_blocks - 1) + 1)[: 3 * width].reshape(3, width)
    tables[2, :2] = tables[0, :2]
    tables = torch.from_numpy(tables)
    prompts = torch.from_numpy(rng.integers(0, config.vocab_size, size=(2, 48)))
    lengths = torch.tensor([48, 30], dtype=torch.int32)
    suffix = torch.from_numpy(rng.integers(0, config.vocab_size, size=(1, 16)))
    active = torch.tensor([True, True, True, False])

    def run(where, p, layout, step_tokens):
        """Logits of each stage; decode feeds ``step_tokens`` (or, when
        None, its own argmax, which it returns)."""
        i32 = dict(dtype=torch.int32, device=where)
        freqs = model.model_freqs(config, device=where)
        t = tables.to(where)
        if layout == "paged":
            cache = model.init_paged_cache(config, num_blocks, block, kv_quant=kv_quant, device=where)
            cold = model.paged_prefill(config, p, cache, prompts.to(where), lengths.to(where), t[:2], freqs)
            warm = model.paged_prefill_at_offset(
                config, p, cache, suffix.to(where), torch.tensor([16], **i32),
                torch.tensor([32], **i32), t[2:3], freqs)
        else:
            cache = model.init_cache(config, 4, 256, kv_quant=kv_quant, device=where)
            cold = model.prefill(config, p, cache, prompts.to(where), lengths.to(where),
                                 torch.tensor([0, 1], device=where), freqs)
            model.prefill(config, p, cache, prompts[:1, :32].to(where), torch.tensor([32], **i32),
                          torch.tensor([2], device=where), freqs)
            warm = model.prefill_at_offset(
                config, p, cache, suffix.to(where), torch.tensor([16], **i32),
                torch.tensor([32], **i32), torch.tensor([2], device=where), freqs)
        stages = [cold, warm]
        tokens = torch.zeros(4, dtype=torch.long)
        tokens[:2] = cold.argmax(-1).cpu()
        tokens[2] = warm[0].argmax().cpu()
        step_lengths = torch.tensor([49, 31, 49, 0], dtype=torch.int32)
        used = []
        for step in range(4):
            if step_tokens is not None:
                tokens = step_tokens[step]
            used.append(tokens.clone())
            args = (tokens.to(where), step_lengths.to(where))
            if layout == "paged":
                logits = model.paged_decode_step(config, p, cache, *args, t, freqs, active.to(where))
            else:
                logits = model.decode_step(config, p, cache, *args, freqs, active.to(where))
            stages.append(logits[active.to(where)])
            tokens = torch.where(active, logits.argmax(-1).cpu(), torch.zeros_like(tokens))
            step_lengths = torch.where(active, step_lengths + 1, step_lengths)
        return [x.float().cpu() for x in stages], used

    card, used = run(device, params, "paged", None)
    cpu, _ = run("cpu", cpu_params, "paged", used)
    dense, _ = run(device, params, "dense", used)
    worst = {"cpu": 0.0, "dense": 0.0}
    for name, other in (("cpu", cpu), ("dense", dense)):
        for out, ref in zip(card, other):
            assert out.shape == ref.shape and bool(torch.isfinite(out).all())
            worst[name] = max(worst[name], errors(out, ref)[1])
        assert worst[name] < MODEL_TOLERANCE, f"paged model on the card vs {name}: {worst[name]}"

    # the engine's long-prompt schedule, both layouts, against one shot
    long_prompt = torch.from_numpy(rng.integers(0, config.vocab_size, size=(1, 256)))
    total = 200
    freqs = model.model_freqs(config, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    dense_cache = model.init_cache(config, 2, 256, kv_quant=kv_quant, device=device)
    one_shot = model.prefill(config, params, dense_cache, long_prompt.to(device),
                             torch.tensor([total], **i32), torch.tensor([1], device=device), freqs)
    pool = model.init_paged_cache(config, num_blocks, block, kv_quant=kv_quant, device=device)
    windows = long_prefill_windows(total, 0, [64, 128])
    for offset, bucket in windows:
        chunk = torch.zeros((1, bucket), dtype=torch.long)
        piece = long_prompt[0, offset:min(offset + bucket, total)]
        chunk[0, : len(piece)] = piece
        args = (chunk.to(device), torch.tensor([len(piece)], **i32), torch.tensor([offset], **i32))
        dense_logits = model.prefill_at_offset(
            config, params, dense_cache, *args, torch.tensor([0], device=device), freqs)
        paged_logits = model.paged_prefill_at_offset(
            config, params, pool, *args, tables[:1].to(device), freqs)
    windowed = max(errors(dense_logits, one_shot)[1], errors(paged_logits, one_shot)[1])
    assert windowed < MODEL_TOLERANCE, f"windowed prefill disagrees with one shot: {windowed}"
    log(f"paged reference: Llama-3-8B width, 2 layers, {'int8' if kv_quant else 'bf16'} KV cache, "
        f"paged prefill + prefill-at-offset + 4 decode steps, card ({'B6' if kv_quant else 'B3'}) vs "
        f"CPU max_rel_err={worst['cpu']:.3e}, card paged vs card dense "
        f"max_rel_err={worst['dense']:.3e}; windowed prefill {windows} (dense and paged) vs one "
        f"shot max_rel_err={windowed:.3e} (tol {MODEL_TOLERANCE})")


def time_decode_step(engine, live: int = 512, iters: int = 5) -> None:
    """One eager decode step of the stopped engine's model (all slots at
    ``live`` rows): host time to enqueue it against wall time to finish
    it. Equal times mean the card waits on the host."""
    slots = engine.max_slots
    tokens = torch.zeros(slots, dtype=torch.long, device=engine.device)
    lengths = torch.full((slots,), live, dtype=torch.int32, device=engine.device)

    def step():
        model.decode_step(engine.config, engine.params, engine.cache, tokens, lengths, engine.freqs)

    step()
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(iters):
        step()
    enqueued = time.perf_counter()
    torch.cuda.synchronize()
    finished = time.perf_counter()
    # every weight is read once per step except the embedding (a gather)
    weight_bytes = sum(
        p.numel() * p.element_size() for name, p in engine.params.items() if name != "embedding")
    cache = "int8" if engine.kv_quant else "bf16"
    log(f"decode step (model only, {cache} KV cache, {slots} slots x {live} live rows): "
        f"wall {(finished - started) / iters * 1e3:.2f} ms, host enqueue "
        f"{(enqueued - started) / iters * 1e3:.2f} ms, weight-read bound "
        f"{weight_bytes / PEAK_BYTES * 1e3:.2f} ms")


WORDS = ["stream", "token", "kernel", "batch", "event", "topic", "agent", "model",
         "cache", "device", "latency", "record", "gateway", "prompt", "answer"]
KERNELS = {
    "flash_prefill": flash_prefill_attention,
    "flash_decode": flash_decode_attention,
    "paged_attention": ragged_paged_attention,
    "flash_prefill_quant": flash_prefill_attention_quant,
    "flash_decode_quant": flash_decode_attention_quant,
    "paged_attention_quant": ragged_paged_attention_quant,
}


def prompt_text(rng, n_bytes: int) -> str:
    text = ""
    while len(text) < n_bytes:
        text += rng.choice(WORDS) + " "
    return text.strip()


def start_llama_server(*extra: str, kv_quant: bool = False):
    """``serve`` with these flags; ``kv_quant`` adds ``kv-quant: int8`` to
    the provider's engine config, the way a deployment asks for it."""
    args = build_parser().parse_args([
        "serve", "--model", "llama-3-8b", "--max-slots", "32", "--max-seq-len", "1024",
        "--decode-chunk", "8", "--host", "127.0.0.1", "--port", "0", *extra,
    ])
    config = serve_config(args)
    if kv_quant:
        config["engine"]["kv-quant"] = "int8"
    t0 = time.perf_counter()
    service, server = start_server(args, config)
    log(f"serve {' '.join(extra) or '(dense)'}{' kv-quant: int8' if kv_quant else ''}: Llama-3-8B "
        f"bf16 random weights up in {time.perf_counter() - t0:.1f}s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    return service, server


def run_burst(service, server, jobs):
    """All jobs at once against the server: the main path's run, with
    every kernel's launch count zeroed just before and read just after."""
    url = f"http://127.0.0.1:{server.port}"

    def post(job):
        path, body = job
        request = urllib.request.Request(
            url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=600) as response:
            return response.read().decode()

    service.engine.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    started = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        replies = list(pool.map(post, jobs))
    wall = time.perf_counter() - started
    launches = {name: wrapper.launches for name, wrapper in KERNELS.items()}
    stats = dict(service.engine.stats)
    return replies, wall, launches, stats, torch.cuda.max_memory_allocated() / 2**30


def check_replies(jobs, replies) -> int:
    """Every reply complete (its max_tokens, or stopped) and the stream
    (the last job) ended by [DONE]; returns the completion tokens."""
    tokens = 0
    for (path, body), raw in zip(jobs[:-1], replies[:-1]):
        reply = json.loads(raw)
        choice = reply["choices"][0]
        got = reply["usage"]["completion_tokens"]
        assert got == body["max_tokens"] or choice["finish_reason"] == "stop", (path, got, choice)
        assert ("message" in choice) == path.endswith("chat/completions")
        tokens += got
    frames = [f[len("data: "):] for f in replies[-1].split("\n\n") if f.startswith("data: ")]
    assert frames[-1] == "[DONE]", "the SSE stream must end with [DONE]"
    final = json.loads(frames[-2])
    streamed = final["usage"]["completion_tokens"]
    assert streamed == jobs[-1][1]["max_tokens"] or final["choices"][0]["finish_reason"] == "stop"
    return tokens + streamed


def report(label, kind, jobs, wall, tokens, stats, launches, peak_gib) -> None:
    requests = stats["requests"]
    log(f"serving {kind} [{label}]: {requests} requests, {tokens} completion tokens in {wall:.3f}s "
        f"= {tokens / wall:.1f} tok/s; mean TTFT {stats['ttft_time'] / requests * 1e3:.1f} ms "
        f"(engine submit → first token); prefill calls {stats['prefill_calls']} + warm "
        f"{stats['warm_prefill_calls']} ({stats['prefill_time']:.3f}s), decode steps "
        f"{stats['decode_steps']} ({stats['decode_time']:.3f}s); prefix hits {stats['prefix_hits']}, "
        f"reused tokens {stats['prefix_tokens_reused']}; model calls {stats['model_dispatches']}; "
        f"peak memory {peak_gib:.2f} GiB; launches {launches}")
    assert requests == len(jobs), (requests, len(jobs))


def serve_dense_and_check(label: str, kv_quant: bool = False) -> dict:
    service, server = start_llama_server(kv_quant=kv_quant)
    rng = np.random.default_rng(0)
    jobs = []
    for i in range(16):
        body = {"max_tokens": int(32 + 2 * i)}
        if i % 4 == 3:
            body.update(temperature=0.8, top_p=0.9, seed=i)
        if i % 2 == 0:
            jobs.append(("/v1/chat/completions", dict(
                body, messages=[{"role": "user", "content": prompt_text(rng, 100 + 12 * i)}])))
        else:
            jobs.append(("/v1/completions", dict(body, prompt=prompt_text(rng, 100 + 12 * i))))
    jobs.append(("/v1/chat/completions", {
        "messages": [{"role": "user", "content": prompt_text(rng, 180)}],
        "max_tokens": 48, "stream": True}))
    try:
        replies, wall, launches, stats, peak_gib = run_burst(service, server, jobs)
    finally:
        server.stop()
        service.engine.stop()
    time_decode_step(service.engine)
    tokens = check_replies(jobs, replies)
    layers = model.LlamaConfig.llama3_8b().num_layers
    calls = stats["model_dispatches"]
    prefill, decode = (
        ("flash_prefill_quant", "flash_decode_quant") if kv_quant else ("flash_prefill", "flash_decode"))
    assert launches[prefill] > 0 and launches[decode] > 0, launches
    assert launches[prefill] == layers * calls.get("prefill", 0), (launches, calls)
    assert launches[decode] == layers * calls.get("decode_step", 0), (launches, calls)
    others = [name for name in KERNELS if name not in (prefill, decode)]
    assert all(launches[name] == 0 for name in others), launches
    report(label, "dense int8 KV" if kv_quant else "dense", jobs, wall, tokens, stats, launches,
           peak_gib)
    return launches


def serve_paged_and_check(label: str, kv_quant: bool = False) -> dict:
    service, server = start_llama_server(
        "--kv-layout", "paged", "--kv-block-size", "16", kv_quant=kv_quant)
    rng = np.random.default_rng(1)
    system = {"role": "system", "content": prompt_text(rng, 512)}
    jobs = []
    for i in range(16):
        body = {"max_tokens": int(24 + 2 * i), "messages": [
            system, {"role": "user", "content": f"question {i}: " + prompt_text(rng, 40 + 6 * i)}]}
        if i % 4 == 3:
            body.update(temperature=0.8, top_p=0.9, seed=i)
        jobs.append(("/v1/chat/completions", body))
    for i in range(8):
        jobs.append(("/v1/completions", {
            "prompt": prompt_text(rng, 120 + 20 * i), "max_tokens": int(32 + 3 * i)}))
    jobs.append(("/v1/chat/completions", {
        "messages": [system, {"role": "user", "content": prompt_text(rng, 60)}],
        "max_tokens": 40, "stream": True}))
    try:
        replies, wall, launches, stats, peak_gib = run_burst(service, server, jobs)
    finally:
        server.stop()
        service.engine.stop()
    tokens = check_replies(jobs, replies)
    layers = model.LlamaConfig.llama3_8b().num_layers
    calls = sum(stats["model_dispatches"].values())
    paged = "paged_attention_quant" if kv_quant else "paged_attention"
    assert stats["prefix_tokens_reused"] > 0, stats
    assert launches[paged] > 0, launches
    assert launches[paged] == layers * calls, (launches, stats["model_dispatches"])
    assert all(launches[name] == 0 for name in KERNELS if name != paged), launches
    report(label, "paged int8 KV" if kv_quant else "paged", jobs, wall, tokens, stats, launches,
           peak_gib)
    return launches


def main() -> None:
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    label = card_label()
    log(f"device: {name} ({torch.cuda.device_count()} visible); torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"built {sorted(_build.SIGNATURES)} in {time.perf_counter() - t0:.1f}s -> {_build.BUILD_DIR}")
    kernels = [check(device, quant) for quant in (False, True)
               for check in (check_prefill_kernel, check_decode_kernel, check_paged_kernel)]
    check_int8_against_bf16(device)
    check_paged_model(device)
    check_paged_model(device, kv_quant=True)
    # each kernel's launches come from the serving phase of its own path
    launches = {}
    for serve, kv_quant, names in (
        (serve_dense_and_check, False, ("flash_prefill", "flash_decode")),
        (serve_paged_and_check, False, ("paged_attention",)),
        (serve_dense_and_check, True, ("flash_prefill_quant", "flash_decode_quant")),
        (serve_paged_and_check, True, ("paged_attention_quant",)),
    ):
        counts = serve(label, kv_quant=kv_quant)
        launches.update({name: counts[name] for name in names})
        gc.collect()
        torch.cuda.empty_cache()
    for item in kernels:
        item["launches"] = launches[item["name"]]
        assert item["launches"] > 0, item
    log(label)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
