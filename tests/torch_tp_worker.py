"""Rank programs for the port's tensor-parallel CPU tests
(``tests/test_torch_tp.py``, ``tests/test_torch_mirror.py``).

Each test starts its ranks as separate processes over gloo with
``langstream_tpu_torch.parallel.launch`` (``spawn_ranks(...,
ranks=range(world))``), each running one function of this module as
``FUNCTION(rank, world, device, payload)``; the outputs go to files the
test reads back. The module imports the port only, never JAX: the test
process holds the JAX references. The inputs come from
:func:`call_inputs`, which both sides import.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
from typing import Any, Dict, List

import numpy as np
import torch

from langstream_tpu_torch.parallel.mesh import MeshConfig
from langstream_tpu_torch.providers.torch_local import engine as engine_lib
from langstream_tpu_torch.providers.torch_local import model, quant
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax

torch.set_num_threads(1)

SLOTS, MAX_LEN, BLOCK, BLOCKS_PER_ROW = 3, 64, 8, 8
PRESETS = {"tiny": model.LlamaConfig.tiny, "tiny-qwen2": model.LlamaConfig.tiny_qwen2,
           "tiny-gemma2": model.LlamaConfig.tiny_gemma2, "tiny-moe": model.LlamaConfig.tiny_moe}
ENGINE_ARGS = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 32, 64], kv_block_size=8,
                   decode_chunk=4, pipeline_decode=True, seed=0)


def layout_args(layout: str) -> Dict[str, Any]:
    """The engine arguments of a test layout: dense, paged, or mixed (the
    paged layout with the mixed prefill+decode step)."""
    if layout == "mixed":
        return dict(kv_layout="paged", prefill_mode="mixed", prefill_chunk=16)
    return dict(kv_layout=layout)


def preset(name: str, max_seq_len: int = MAX_LEN) -> model.LlamaConfig:
    return PRESETS[name](max_seq_len=max_seq_len)


def call_inputs(vocab: int) -> Dict[str, np.ndarray]:
    """One sequence's host inputs: a prefill of 3 rows, a suffix at their
    offsets, two decode steps, the paged rows' block tables, and a mixed
    step of 8-token spans after the decode steps (a decode row, windows of
    5 and 3 tokens)."""
    rng = np.random.default_rng(7)
    lengths = np.array([16, 9, 12], np.int32)
    suffix = np.array([8, 3, 5], np.int32)
    tables = np.zeros((SLOTS, BLOCKS_PER_ROW), np.int32)
    tables[:] = (rng.permutation(SLOTS * BLOCKS_PER_ROW) + 1).reshape(SLOTS, BLOCKS_PER_ROW)
    return {
        "tokens": rng.integers(0, vocab, size=(SLOTS, 16)).astype(np.int32),
        "lengths": lengths,
        "slots": np.arange(SLOTS, dtype=np.int32),
        "suffix_tokens": rng.integers(0, vocab, size=(SLOTS, 8)).astype(np.int32),
        "suffix_lengths": suffix,
        "offsets": lengths,
        "decode_tokens": rng.integers(0, vocab, size=(2, SLOTS)).astype(np.int32),
        "decode_lengths": np.stack([lengths + suffix + 1, lengths + suffix + 2]).astype(np.int32),
        "tables": tables,
        "mixed_tokens": rng.integers(0, vocab, size=(SLOTS, 8)).astype(np.int32),
        "mixed_offsets": (lengths + suffix + 2).astype(np.int32),
        "mixed_counts": np.array([1, 5, 3], np.int32),
    }


def load_params(path: str, config: model.LlamaConfig, int8: bool) -> Dict[str, Any]:
    with np.load(path) as stored:
        params = params_from_jax(dict(stored), config)
    return quant.quantize_params(params, config.num_experts) if int8 else params


def _t(array: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(array))


def run_calls(config: model.LlamaConfig, params: Dict[str, Any], layout: str, kv_quant: bool
              ) -> Dict[str, np.ndarray]:
    """The sequence of :func:`call_inputs` through one layout's serving
    calls → each call's logits by name."""
    x = call_inputs(config.vocab_size)
    freqs = model.model_freqs(config)
    out = {}
    if layout == "dense":
        cache = model.init_cache(config, SLOTS, MAX_LEN, kv_quant=kv_quant)
        out["prefill"] = model.prefill(config, params, cache, _t(x["tokens"]), _t(x["lengths"]),
                                       _t(x["slots"]), freqs)
        out["offset"] = model.prefill_at_offset(
            config, params, cache, _t(x["suffix_tokens"]), _t(x["suffix_lengths"]),
            _t(x["offsets"]), _t(x["slots"]), freqs)
        for step in range(2):
            out[f"decode{step}"] = model.decode_step(
                config, params, cache, _t(x["decode_tokens"][step]), _t(x["decode_lengths"][step]),
                freqs)
    else:
        cache = model.init_paged_cache(config, SLOTS * BLOCKS_PER_ROW + 1, BLOCK, kv_quant=kv_quant)
        tables = _t(x["tables"])
        out["prefill"] = model.paged_prefill(config, params, cache, _t(x["tokens"]),
                                             _t(x["lengths"]), tables, freqs)
        out["offset"] = model.paged_prefill_at_offset(
            config, params, cache, _t(x["suffix_tokens"]), _t(x["suffix_lengths"]),
            _t(x["offsets"]), tables, freqs)
        for step in range(2):
            out[f"decode{step}"] = model.paged_decode_step(
                config, params, cache, _t(x["decode_tokens"][step]), _t(x["decode_lengths"][step]),
                tables, freqs)
        out["mixed"] = model.paged_mixed_step(
            config, params, cache, _t(x["mixed_tokens"]), _t(x["mixed_offsets"]),
            _t(x["mixed_counts"]), tables, freqs)
    return {name: logits.numpy() for name, logits in out.items()}


def model_calls(rank: int, world: int, device: str, payload: Dict[str, Any]) -> None:
    """Every case of ``payload["cases"]`` (preset, layout, kv_quant,
    int8) through this rank's shard: the full params read, quantized
    whole when int8, cut to the rank's shard; the logits (gathered whole
    on every rank) saved as ``<out>.<rank>.npz``."""
    from langstream_tpu_torch.parallel.mesh import build_group

    mesh = MeshConfig(tp=world)
    group = build_group(mesh, device)
    saved = {}
    for case in payload["cases"]:
        config = preset(case["preset"])
        full = load_params(payload["params"][case["preset"]], config, case["int8"])
        params = model.rank_params(config, full, mesh, rank)
        for call, logits in run_calls(model.rank_config(config, group), params, case["layout"],
                                      case["kv_quant"]).items():
            saved[f"{case['name']}/{call}"] = logits
    np.savez(f"{payload['out']}.{rank}.npz", **saved)


REQUESTS = [
    (list(range(1, 40)), dict(max_new_tokens=6)),
    # 32 block-aligned tokens of the first prompt: a prefix hit
    (list(range(1, 33)) + [99, 98], dict(max_new_tokens=6)),
    (list(range(5, 20)), dict(max_new_tokens=9, temperature=0.8, seed=4)),
]


async def drive(engine, sampling_params=engine_lib.SamplingParams) -> List[List[int]]:
    """The requests one after another (each admission sees the last
    one's cache): their token streams."""
    streams = []
    for prompt, sampling in REQUESTS:
        streams.append(list((await engine.generate(prompt, sampling_params(**sampling))).tokens))
    return streams


def engine_streams(rank: int, world: int, device: str, payload: Dict[str, Any]) -> None:
    """Each case of ``payload["cases"]`` (preset, layout, kv_quant, int8)
    served over tp=``world``: rank 0 runs the engine with the dispatch
    mirror and :data:`REQUESTS`, the others replay its stream. Rank 0
    writes the streams, its published records, its digest and stats;
    every follower its account, to ``<out>.<rank>.json``."""
    import torch.distributed as dist

    from langstream_tpu_torch.serving.mirror import DispatchMirror, FollowerExecutor

    results = {}
    for case in payload["cases"]:
        config = preset(case["preset"], max_seq_len=128)
        params = load_params(payload["params"][case["preset"]], config, case["int8"])
        engine = engine_lib.DecodeEngine(
            config, params, device=device, kv_layout=case["layout"],
            kv_quant="int8" if case["kv_quant"] else None, mesh_config=MeshConfig(tp=world),
            **ENGINE_ARGS)
        mirror = DispatchMirror(host="127.0.0.1", port=0) if rank == 0 else None
        port = [mirror.port if mirror is not None else 0]
        dist.broadcast_object_list(port, src=0)
        if rank == 0:
            mirror.wait_for_followers(world - 1, timeout=120)
            engine.mirror = mirror
            engine.start()
            try:
                streams = asyncio.run(drive(engine))
            finally:
                engine.stop()
            results[case["name"]] = {
                "streams": streams, "published": mirror.published, "digest": mirror.digest.hexdigest(),
                "step_functions": engine.stats["step_functions"],
                "tp_shards": engine.cost_model.tp_shards,
                "prefix_tokens": engine.stats["prefix_tokens_reused"],
                "kv_heads": int(engine.cache["k"].shape[3]),
            }
        else:
            follower = FollowerExecutor(engine)
            follower.connect("127.0.0.1", port[0], timeout=120)
            follower.run()
            results[case["name"]] = follower.report()
    with open(f"{payload['out']}.{rank}.json", "w") as out:
        json.dump(results, out)


def replay_follower(rank: int, world: int, device: str, payload: Dict[str, Any]) -> None:
    """A one-card follower (tp=1): the engine of ``payload`` replaying the
    leader's stream from ``payload["port"]``; its cache and penalty
    counts saved as ``<out>.npz``, its account as ``<out>.json``."""
    from langstream_tpu_torch.serving.mirror import FollowerExecutor

    config = preset(payload["preset"], max_seq_len=128)
    params = load_params(payload["params"], config, False)
    engine = engine_lib.DecodeEngine(
        config, params, device=device, kv_quant="int8" if payload["kv_quant"] else None,
        **layout_args(payload["layout"]), **ENGINE_ARGS)
    follower = FollowerExecutor(engine)
    follower.connect("127.0.0.1", payload["port"], timeout=120,
                     fingerprint=bytes.fromhex(payload["fingerprint"]))
    follower.run()
    np.savez(f"{payload['out']}.npz", counts=engine._counts.numpy(),
             **{leaf: value.numpy() for leaf, value in engine.cache.items()})
    with open(f"{payload['out']}.json", "w") as out:
        json.dump(follower.report(), out)


# the card's check: Llama-3-8B's head shape over two layers (16 heads over
# 4 of 128, 8 over 2 a rank: the kernels' group of 4 kept), bf16
CARD_CONFIG = dict(vocab_size=2048, hidden_size=1024, intermediate_size=2048, num_layers=2,
                   num_heads=16, num_kv_heads=4, head_dim=128, max_seq_len=256)


def card_calls(config: model.LlamaConfig, params: Dict[str, Any], device: str):
    """A cold prefill of two prompts and one decode step on ``device``,
    the launches of each on the card → (logits by call, launches)."""
    from langstream_tpu_torch.ops import launches

    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size, size=(2, 48))).to(device)
    lengths = torch.tensor([48, 30], dtype=torch.int32, device=device)
    freqs = model.model_freqs(config, device=device)
    cache = model.init_cache(config, 2, 128, device=device)
    out, counts = {}, {}
    with launches.device_launches() as counts["prefill"]:
        out["prefill"] = model.prefill(config, params, cache, tokens, lengths,
                                       torch.arange(2, device=device), freqs)
    with launches.device_launches() as counts["decode"]:
        out["decode"] = model.decode_step(config, params, cache, out["prefill"].argmax(-1),
                                          lengths + 1, freqs)
    return ({name: logits.float().cpu().numpy() for name, logits in out.items()},
            {name: {k: v for k, v in c.items() if v} for name, c in counts.items()})


def card_decode_step(rank: int, world: int, device: str, payload: Dict[str, Any]) -> None:
    """Two ranks sharing one card over gloo: each draws the same weights
    on the card from seed 0, keeping its shard, and runs
    :func:`card_calls` on its heads; saves the logits and launches."""
    from langstream_tpu_torch.parallel.mesh import build_group

    mesh = MeshConfig(tp=world)
    group = build_group(mesh, device)
    config = dataclasses.replace(model.LlamaConfig(**CARD_CONFIG), dtype=torch.bfloat16)
    params = model.init_params(config, seed=0, device=device,
                               keep=lambda name, leaf: model.shard_leaf(config, name, leaf, mesh, rank))
    logits, counts = card_calls(model.rank_config(config, group), params, device)
    np.savez(f"{payload['out']}.{rank}.npz", **logits)
    with open(f"{payload['out']}.{rank}.json", "w") as out:
        json.dump({"launches": counts, "backend": group.backend}, out)


def follower_dies(rank: int, world: int, device: str, payload: Dict[str, Any]) -> None:
    """A tp=2 pair whose follower dies at its 4th record
    (``mirror_follower@step=4``): rank 0 serves one long request and
    writes what became of it, and how long it took, to ``<out>.json``;
    the follower raises and exits."""
    import time

    import torch.distributed as dist

    from langstream_tpu_torch.runtime import faults
    from langstream_tpu_torch.serving.mirror import DispatchMirror, FollowerExecutor

    config = preset("tiny", max_seq_len=128)
    params = load_params(payload["params"], config, False)
    engine = engine_lib.DecodeEngine(config, params, device=device,
                                     mesh_config=MeshConfig(tp=world), **ENGINE_ARGS)
    mirror = DispatchMirror(host="127.0.0.1", port=0) if rank == 0 else None
    port = [mirror.port if mirror is not None else 0]
    dist.broadcast_object_list(port, src=0)
    if rank:
        faults.configure("mirror_follower@step=4")
        follower = FollowerExecutor(engine)
        follower.connect("127.0.0.1", port[0], timeout=60)
        follower.run()
        return
    mirror.wait_for_followers(world - 1, timeout=60)
    engine.mirror = mirror
    engine.start()
    started = time.perf_counter()
    try:
        asyncio.run(engine.generate(list(range(1, 20)), engine_lib.SamplingParams(max_new_tokens=60)))
        outcome = "answered"
    except Exception as error:  # noqa: BLE001 — the outcome under test
        outcome = f"{type(error).__name__}: {error}"
    seconds = time.perf_counter() - started
    engine.stop()
    with open(f"{payload['out']}.json", "w") as out:
        json.dump({"outcome": outcome, "seconds": seconds}, out)


# ---------------------------------------------------------------------- #
# serve --tp on one host: what the mirror replays (test_torch_tp_features)
# ---------------------------------------------------------------------- #
def features_config(engine: Dict[str, Any], world: int) -> Dict[str, Any]:
    """The provider config of a features case: ``tiny`` at 128 tokens,
    random weights from seed 0, sampling seed 11, over tp=``world``."""
    return {"model": {"preset": "tiny", "max_seq_len": 128}, "seed": 0, "mesh": {"tp": world},
            "engine": dict({"max-slots": 4, "max-seq-len": 128, "prefill-buckets": [16, 32, 64],
                            "decode-chunk": 4, "sampling-seed": 11}, **engine)}


def _job_fields(fields: Dict[str, Any]) -> Dict[str, Any]:
    """A job's request fields; a ``kv_import`` names a saved payload."""
    fields = dict(fields)
    if isinstance(fields.get("kv_import"), str):
        fields["kv_import"] = load_payload(fields["kv_import"])
    return fields


def save_payload(path: str, payload: Dict[str, Any]) -> None:
    """A handoff payload (tokens, per-leaf host rows) as ``<path>.npz``."""
    np.savez(f"{path}.npz", tokens=np.asarray(payload["tokens"], dtype=np.int64),
             block_size=payload["block_size"], kv_quant=payload["kv_quant"],
             **{f"leaf/{leaf}": np.asarray(rows) for leaf, rows in payload["arrays"].items()})


def load_payload(path: str) -> Dict[str, Any]:
    with np.load(f"{path}.npz") as stored:
        return {"tokens": stored["tokens"].tolist(), "block_size": int(stored["block_size"]),
                "kv_quant": bool(stored["kv_quant"]),
                "arrays": {key[len("leaf/"):]: torch.from_numpy(stored[key])
                           for key in stored.files if key.startswith("leaf/")}}


async def run_jobs(engine_of, jobs, together: bool, out: str, sampling_params=engine_lib.SamplingParams):
    """``jobs`` of (prompt, sampling, request fields) through the engine
    ``engine_of()`` returns at each submit, all at once or one after
    another: each result's tokens, logprobs and finish reason; a handoff
    export is saved as ``<out>.<job>.npz``."""

    async def one(index, prompt, sampling, fields):
        result = await engine_of().generate(list(prompt), sampling_params(**sampling),
                                            request_fields=_job_fields(fields))
        exported = getattr(result, "kv_handoff", None)
        if exported is not None:
            save_payload(f"{out}.{index}", exported)
        return {"tokens": list(result.tokens), "logprobs": [float(x) for x in result.logprobs],
                "finish_reason": result.finish_reason, "exported": exported is not None}

    if together:
        return list(await asyncio.gather(*(one(i, *job) for i, job in enumerate(jobs))))
    return [await one(i, *job) for i, job in enumerate(jobs)]


FEATURE_STATS = ("mixed_steps", "mixed_steps_chained", "tokens_drafted", "tokens_draft_accepted",
                 "handoff_exports", "handoff_imports", "host_demotions", "host_promotions",
                 "kv_host_hit_tokens", "prefix_tokens_reused", "step_functions")


def tp_features(rank: int, world: int, device: str, payload: Dict[str, Any]) -> None:
    """Each case of ``payload["cases"]`` served as ``serve --tp`` serves
    it on one host: every rank builds the provider's service from the
    case's config; rank 0 attaches a one-host dispatch mirror
    (``attach_mirror``, as ``cli.main.start_tp_server``) and runs the
    case's jobs through the current engine (the supervisor's, rebuilt
    after a crash the case's ``faults`` inject), and the other ranks run
    ``cli.main.follow``. Rank 0 writes its results, its published record
    count, digest and stats, the supervisor's restarts and the sessions
    it resurrected to ``<out>.<case>.json``; each follower its account to
    ``<out>.<case>.<rank>``."""
    import torch.distributed as dist

    from langstream_tpu_torch.cli.main import follow
    from langstream_tpu_torch.providers.torch_local.provider import (
        TorchCompletionsService,
        mirror_fingerprint,
    )
    from langstream_tpu_torch.runtime import faults, supervisor
    from langstream_tpu_torch.serving.mirror import DispatchMirror

    for case in payload["cases"]:
        out = f"{payload['out']}.{case['name']}"
        config = features_config(case["engine"], world)
        mirror = None
        if rank == 0:
            mirror = DispatchMirror(host="127.0.0.1", port=0, fingerprint=mirror_fingerprint(config),
                                    local=True)
        port = [mirror.port if mirror is not None else 0]
        dist.broadcast_object_list(port, src=0)
        if rank:
            follow(rank, world, device, {"config": config, "mirror": f"127.0.0.1:{port[0]}",
                                         "report": out})
            continue
        service = TorchCompletionsService(config, device=device)
        mirror.wait_for_followers(world - 1, timeout=120)
        service.attach_mirror(mirror)
        resurrected = supervisor.SESSIONS_RESURRECTED.value()
        if case.get("faults"):
            faults.configure(case["faults"])
        try:
            results = asyncio.run(run_jobs(lambda: service.engine, case["jobs"],
                                           case.get("together", False), out))
        finally:
            faults.reset()
            engine = service.engine
            service.close()
        stats = {key: engine.stats[key] for key in FEATURE_STATS}
        with open(f"{out}.json", "w") as written:
            json.dump({"results": results, "published": mirror.published,
                       "digest": mirror.digest.hexdigest(), "stats": stats,
                       "restarts": service.supervisor.restarts,
                       "resurrected": supervisor.SESSIONS_RESURRECTED.value() - resurrected,
                       "kv_heads": int(engine.cache["k"].shape[3]),
                       "host_tier": (engine.kv_host_arena.blocks_in_use
                                     if engine.kv_host_arena is not None else 0)}, written)
