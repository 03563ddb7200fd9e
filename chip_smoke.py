"""Drive the PyTorch/CUDA port on one GPU and check it.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases (any failure propagates and the exit code is not 0):

1. Device: the card's name, and its name and power limit from nvidia-smi.
2. Kernels: build every CUDA kernel of the main path from
   ``langstream_tpu_torch/csrc`` (one nvcc per source, started together),
   hold each against its plain PyTorch version at the main path's shapes
   in bf16, and time kernel, plain version, the PyTorch library call
   (``scaled_dot_product_attention``, a yardstick only) and the least time
   the card could take (bound).
3. Reference: the model at Llama-3-8B width, depth cut to 2 layers, on the
   card (kernels) against the same weights on the CPU (plain path).
4. Serving: Llama-3-8B (bf16, random weights from seed 0) behind the
   port's OpenAI server, started as ``python -m langstream_tpu_torch
   serve`` starts it, answering 16 concurrent chat and text completions
   plus one SSE stream. The kernels' launch counters are zeroed just
   before and read just after; each kernel must have been launched.
   Then one eager decode step of that model: host enqueue time against
   wall time.

The line before the last holds the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import dataclasses
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

from langstream_tpu_torch.cli.main import build_parser, start_server  # noqa: E402
from langstream_tpu_torch.ops import _build  # noqa: E402
from langstream_tpu_torch.ops.attention import decode_attention, prefill_attention  # noqa: E402
from langstream_tpu_torch.ops.decode_kernel import flash_decode_attention  # noqa: E402
from langstream_tpu_torch.ops.flash_attention import flash_prefill_attention  # noqa: E402
from langstream_tpu_torch.providers.torch_local import model  # noqa: E402

# H100 SXM published peaks (dense bf16 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# bf16 inputs: p is rounded to bf16 before p·v and the sums run in another
# order than the plain einsum; relative to max |reference|
KERNEL_TOLERANCE = 2e-2
# the 2-layer model on the card (bf16, kernels) vs the CPU (bf16, plain
# path): cuBLAS and the CPU's GEMMs round bf16 activations differently
MODEL_TOLERANCE = 5e-2


def log(message: str) -> None:
    print(message, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    by_ops, by_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def errors(out: torch.Tensor, ref: torch.Tensor):
    diff = float((out.float() - ref.float()).abs().max())
    return diff, diff / float(ref.float().abs().max())


def check_prefill_kernel(device) -> dict:
    """B1 at a prefill call of the serving path: B=4, T=256, Llama-3-8B heads."""
    batch, seq, heads, kv_heads, dim = 4, 256, 32, 8, 128
    gen = torch.Generator(device=device).manual_seed(1)
    q = torch.randn(batch, seq, heads, dim, device=device, generator=gen).bfloat16()
    k = torch.randn(batch, seq, kv_heads, dim, device=device, generator=gen).bfloat16()
    v = torch.randn(batch, seq, kv_heads, dim, device=device, generator=gen).bfloat16()
    lengths = torch.tensor([256, 201, 97, 1], dtype=torch.int32, device=device)
    mask = torch.arange(seq, device=device)[None, :] < lengths[:, None]
    out = flash_prefill_attention(q, k, v, lengths=lengths)
    ref = prefill_attention(q, k, v, mask=mask)
    torch.cuda.synchronize()
    worst_abs = worst_rel = 0.0
    for b, n in enumerate(lengths.tolist()):
        a, r = errors(out[b, :n], ref[b, :n])
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
    assert worst_rel < KERNEL_TOLERANCE, f"flash_prefill disagrees: {worst_rel}"
    # SDPA yardstick: same function through one library call (bool mask)
    rows = torch.arange(seq, device=device)
    sdpa_mask = (rows[None, :] <= rows[:, None])[None, None] & mask[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kernel_ms = time_ms(lambda: flash_prefill_attention(q, k, v, lengths=lengths))
    plain_ms = time_ms(lambda: prefill_attention(q, k, v, mask=mask))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=True))
    live = lengths.long()
    pairs = float((live * (live + 1) // 2).sum())        # causal (row, col) pairs
    flops = 4.0 * heads * dim * pairs
    nbytes = 2.0 * (2 * q.numel() + 2 * float(live.sum()) * kv_heads * dim) + 4 * batch
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"B1 flash_prefill [B={batch} T={seq} H={heads} KVH={kv_heads} D={dim} bf16]: "
        f"max_abs_err={worst_abs:.3e} max_rel_err={worst_rel:.3e} (tol {KERNEL_TOLERANCE}) "
        f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={bound_ms:.5f} ({bound_by})")
    return {
        "name": "flash_prefill", "route": "cuda",
        "source": "langstream_tpu_torch/csrc/flash_prefill.cu",
        "replaces": "langstream_tpu/ops/flash_attention.py:64",
        "max_abs_err": worst_abs, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def check_decode_kernel(device) -> dict:
    """B2 at a decode step of the serving path: 32 slots × 1024 context."""
    slots, max_len, heads, kv_heads, dim = 32, 1024, 32, 8, 128
    gen = torch.Generator(device=device).manual_seed(2)
    q = torch.randn(slots, heads, dim, device=device, generator=gen).bfloat16()
    kc = torch.randn(slots, max_len, kv_heads, dim, device=device, generator=gen).bfloat16()
    vc = torch.randn(slots, max_len, kv_heads, dim, device=device, generator=gen).bfloat16()
    lengths_host = [0, 1, max_len] + torch.randint(
        2, max_len, (slots - 3,), generator=torch.Generator().manual_seed(3)).tolist()
    lengths = torch.tensor(lengths_host, dtype=torch.int32, device=device)
    out = flash_decode_attention(q, kc, vc, lengths)
    ref = decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert float(out[0].float().abs().max()) == 0.0, "an empty slot must decode to zeros"
    worst_abs = worst_rel = 0.0
    for s in range(1, slots):
        a, r = errors(out[s], ref[s])
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
    assert worst_rel < KERNEL_TOLERANCE, f"flash_decode disagrees: {worst_rel}"
    sdpa_mask = (torch.arange(max_len, device=device)[None, :] < lengths[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
    kernel_ms = time_ms(lambda: flash_decode_attention(q, kc, vc, lengths))
    plain_ms = time_ms(lambda: decode_attention(q, kc, vc, lengths))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=True))
    live = float(sum(lengths_host))
    flops = 4.0 * heads * dim * live
    nbytes = 2.0 * (2 * q.numel() + 2 * live * kv_heads * dim) + 4 * slots
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"B2 flash_decode [S={slots} T={max_len} H={heads} KVH={kv_heads} D={dim} bf16, "
        f"live rows {int(live)}]: max_abs_err={worst_abs:.3e} max_rel_err={worst_rel:.3e} "
        f"(tol {KERNEL_TOLERANCE}) kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by})")
    return {
        "name": "flash_decode", "route": "cuda",
        "source": "langstream_tpu_torch/csrc/flash_decode.cu",
        "replaces": "langstream_tpu/ops/decode_kernel.py:198",
        "max_abs_err": worst_abs, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def check_model_against_cpu(device) -> None:
    """Llama-3-8B width, 2 layers: prefill + 4 decode steps on the card
    (kernels) against the same bf16 weights on the CPU (plain path)."""
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
        caches[where] = model.init_cache(config, 3, 128, device=where)
        logits[where] = model.prefill(
            config, p, caches[where], tokens.to(where), lengths.to(where),
            slots.to(where), model.model_freqs(config, device=where))
    active = torch.tensor([True, False, True])
    step_lengths = torch.tensor([49, 0, 31], dtype=torch.int32)
    step_tokens = torch.zeros(3, dtype=torch.long)
    step_tokens[slots] = logits["cuda"].argmax(-1).cpu()
    for step in range(5):
        if step:
            for where, p in (("cuda", params), ("cpu", cpu_params)):
                logits[where] = model.decode_step(
                    config, p, caches[where], step_tokens.to(where), step_lengths.to(where),
                    model.model_freqs(config, device=where), active.to(where))[active.to(where)]
            step_tokens[active] = logits["cuda"].argmax(-1).cpu()
            step_lengths = torch.where(active, step_lengths + 1, step_lengths)
        out, ref = logits["cuda"].cpu(), logits["cpu"]
        assert out.shape == ref.shape and bool(torch.isfinite(out).all())
        worst = max(worst, errors(out, ref)[1])
    assert worst < MODEL_TOLERANCE, f"model on the card disagrees with the CPU: {worst}"
    log(f"reference: Llama-3-8B width, 2 layers, prefill + 4 decode steps, card vs CPU "
        f"max_rel_err={worst:.3e} (tol {MODEL_TOLERANCE})")


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
    log(f"decode step (model only, {slots} slots x {live} live rows): "
        f"wall {(finished - started) / iters * 1e3:.2f} ms, host enqueue "
        f"{(enqueued - started) / iters * 1e3:.2f} ms, weight-read bound "
        f"{weight_bytes / PEAK_BYTES * 1e3:.2f} ms")


def serve_and_check(label: str) -> dict:
    args = build_parser().parse_args([
        "serve", "--model", "llama-3-8b", "--max-slots", "32", "--max-seq-len", "1024",
        "--decode-chunk", "8", "--host", "127.0.0.1", "--port", "0",
    ])
    t0 = time.perf_counter()
    service, server = start_server(args)
    log(f"serve: Llama-3-8B bf16 random weights up in {time.perf_counter() - t0:.1f}s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    url = f"http://127.0.0.1:{server.port}"
    try:
        rng = np.random.default_rng(0)
        words = ["stream", "token", "kernel", "batch", "event", "topic", "agent", "model",
                 "cache", "device", "latency", "record", "gateway", "prompt", "answer"]

        def prompt_text(n_bytes: int) -> str:
            text = ""
            while len(text) < n_bytes:
                text += rng.choice(words) + " "
            return text.strip()

        jobs = []
        for i in range(16):
            body = {"max_tokens": int(32 + 2 * i)}
            if i % 4 == 3:
                body.update(temperature=0.8, top_p=0.9, seed=i)
            if i % 2 == 0:
                jobs.append(("/v1/chat/completions", dict(
                    body, messages=[{"role": "user", "content": prompt_text(100 + 12 * i)}])))
            else:
                jobs.append(("/v1/completions", dict(body, prompt=prompt_text(100 + 12 * i))))
        jobs.append(("/v1/chat/completions", {
            "messages": [{"role": "user", "content": prompt_text(180)}],
            "max_tokens": 48, "stream": True}))

        def post(job):
            path, body = job
            request = urllib.request.Request(
                url + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(request, timeout=600) as response:
                return response.read().decode()

        # the main path's run: counts zeroed just before, read just after
        service.engine.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        flash_prefill_attention.launches = 0
        flash_decode_attention.launches = 0
        started = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            replies = list(pool.map(post, jobs))
        wall = time.perf_counter() - started
        launches = {
            "flash_prefill": flash_prefill_attention.launches,
            "flash_decode": flash_decode_attention.launches,
        }
        stats = dict(service.engine.stats)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        server.stop()
        service.engine.stop()
    time_decode_step(service.engine)

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
    assert streamed == 48 or final["choices"][0]["finish_reason"] == "stop"
    tokens += streamed
    layers = model.LlamaConfig.llama3_8b().num_layers
    assert launches["flash_prefill"] > 0 and launches["flash_decode"] > 0, launches
    assert launches["flash_prefill"] == layers * stats["prefill_calls"], (launches, stats)
    assert launches["flash_decode"] == layers * stats["decode_steps"], (launches, stats)
    requests = stats["requests"]
    log(f"serving [{label}]: {requests} requests, {tokens} completion tokens in {wall:.3f}s "
        f"= {tokens / wall:.1f} tok/s; mean TTFT {stats['ttft_time'] / requests * 1e3:.1f} ms "
        f"(engine submit → first token); prefill calls {stats['prefill_calls']} "
        f"({stats['prefill_time']:.3f}s), decode steps {stats['decode_steps']} "
        f"({stats['decode_time']:.3f}s); peak memory {peak_gib:.2f} GiB; launches {launches}")
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
    kernels = [check_prefill_kernel(device), check_decode_kernel(device)]
    check_model_against_cpu(device)
    launches = serve_and_check(label)
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    log(label)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
