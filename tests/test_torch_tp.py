"""Tensor-parallel serving in the port against the JAX package, on the CPU.

The port runs one process per tp rank over gloo (``parallel/launch.py``
starts two ranks of ``tests/torch_tp_worker.py``); the JAX package runs
its SPMD mesh over the host devices ``tests/conftest.py`` forces. The
same numpy-seeded inputs and the JAX weights, carried across with
``params_from_jax``, go through both in f32:

- each sharded kernel wrapper (``flash_prefill_attention_sharded``,
  ``flash_decode_attention_sharded``, ``ragged_paged_attention_sharded``,
  ``ragged_q_paged_attention_sharded``,
  bf16-free f32 and over int8 k/v): the ranks' plain outputs concatenated
  over heads against JAX's sharded wrapper in interpret mode on a tp=2
  mesh and against the unsharded call, within 1e-5;
- the tp=2 model calls (``prefill``, ``prefill_at_offset``,
  ``decode_step``, their paged twins and ``paged_mixed_step``, B7 or B8
  per rank) on Llama, Qwen-2, Gemma-2 and
  the MoE ``tiny_moe`` (experts split on ``mlp``), f32 and int8 KV,
  model-dtype and int8 weights, against the JAX model within 1e-4 of
  max |logit| (the tolerance of ``tests/test_torch_model.py``); every
  rank's logits equal bit for bit;
- tp=2 engines (the leader with the dispatch mirror, the follower
  replaying it): greedy and seeded streams equal to the port's tp=1 and
  to the JAX engine at ``MeshConfig(tp=2)``, dense and paged, f32 and int8
  KV, the prefix cache hit included, as ``tests/test_multichip_paged.py``
  drives them; the follower's token digest equal to the leader's and its
  records the leader's; the MoE ``tiny_moe`` the same;
- ``serve --tp 2 --device cpu`` starting its follower rank and answering
  as the one-card server does, split, ``--prefill-mode mixed`` and
  ``--spec-decode ngram``, with the supervisor on;
- the cost model's ``tp_shards`` against the JAX goldens of
  ``tests/test_efficiency.py``, and the refusals (across hosts, the
  supervisor off and spec decode refused; a tp mesh without
  ``torch.distributed``).
"""

import asyncio
import json
import os
import pathlib
import signal
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from langstream_tpu.ops.attention import quantize_kv as jax_quantize_kv
from langstream_tpu.ops.decode_kernel import flash_decode_attention_sharded as jax_decode_sharded
from langstream_tpu.ops.flash_attention import (
    flash_prefill_attention_quant_sharded as jax_prefill_quant_sharded,
)
from langstream_tpu.ops.flash_attention import flash_prefill_attention_sharded as jax_prefill_sharded
from langstream_tpu.ops.paged_attention import (
    ragged_paged_attention_quant_sharded as jax_paged_quant_sharded,
)
from langstream_tpu.ops.paged_attention import ragged_paged_attention_sharded as jax_paged_sharded
from langstream_tpu.ops.paged_attention import (
    ragged_q_paged_attention_sharded as jax_ragged_q_sharded,
)
from langstream_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.providers.jax_local import quant as jax_quant
from langstream_tpu.runtime.accounting import CostModel as JaxCostModel
from langstream_tpu_torch.ops.decode_kernel import (
    flash_decode_attention,
    flash_decode_attention_quant,
    flash_decode_attention_sharded,
)
from langstream_tpu_torch.ops.flash_attention import (
    flash_prefill_attention,
    flash_prefill_attention_quant,
    flash_prefill_attention_sharded,
)
from langstream_tpu_torch.ops.paged_attention import (
    ragged_paged_attention,
    ragged_paged_attention_quant,
    ragged_paged_attention_sharded,
    ragged_q_paged_attention,
    ragged_q_paged_attention_quant,
    ragged_q_paged_attention_sharded,
)
from langstream_tpu_torch.parallel import launch
from langstream_tpu_torch.parallel.mesh import MeshConfig
from langstream_tpu_torch.providers.torch_local import engine, model
from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService
from langstream_tpu_torch.runtime.accounting import CostModel
from langstream_tpu_torch.runtime.multihost import free_port
import torch_tp_worker as worker

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
TP = 2
KERNEL_TOLERANCE = 1e-5
LOGITS_TOLERANCE = 1e-4
RANK_TIMEOUT_S = 150


def _close(out, ref, rel):
    out, ref = np.asarray(out, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    assert float(np.abs(out - ref).max()) <= rel * scale, (float(np.abs(out - ref).max()), scale)


def _mesh():
    return Mesh(np.array(jax.devices()[:TP]), ("tp",))


def _ranks(fn):
    """Each rank's output of a sharded port wrapper, concatenated over
    the heads (axis -2)."""
    return torch.cat([fn(rank) for rank in range(TP)], dim=-2).numpy()


# ---------------------------------------------------------------------- #
# the sharded kernel wrappers
# ---------------------------------------------------------------------- #
def _qkv(rng, q_shape, kv_shape):
    return [rng.standard_normal(shape).astype(np.float32) for shape in (q_shape, kv_shape, kv_shape)]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_flash_prefill_sharded_matches_jax(quant):
    """B1 (B4 over int8 k/v) per rank on 4 of 8 heads over 2 of 4 kv
    heads, concatenated: JAX's sharded wrapper (interpret) and the
    unsharded call, on every valid row."""
    batch, seq, heads, kv_heads, dim = 2, 256, 8, 4, 128
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, (batch, seq, heads, dim), (batch, seq, kv_heads, dim))
    lengths = np.array([256, 130], np.int32)
    tq, tk, tv, tl = map(torch.from_numpy, (q, k, v, lengths))
    if quant:
        (kq, ks), (vq, vs) = jax_quantize_kv(jnp.asarray(k)), jax_quantize_kv(jnp.asarray(v))
        want = jax.jit(lambda *a: jax_prefill_quant_sharded(
            *a, _mesh(), lengths=jnp.asarray(lengths), interpret=True))(jnp.asarray(q), kq, ks, vq, vs)
        tkq, tks, tvq, tvs = (torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs))
        got = _ranks(lambda r: flash_prefill_attention_sharded(
            tq, tkq, tvq, k_scale=tks, v_scale=tvs, rank=r, size=TP, lengths=tl))
        whole = flash_prefill_attention_quant(tq, tkq, tks, tvq, tvs, lengths=tl).numpy()
    else:
        want = jax.jit(lambda *a: jax_prefill_sharded(
            *a, _mesh(), lengths=jnp.asarray(lengths), interpret=True))(*map(jnp.asarray, (q, k, v)))
        got = _ranks(lambda r: flash_prefill_attention_sharded(
            tq, tk, tv, rank=r, size=TP, lengths=tl))
        whole = flash_prefill_attention(tq, tk, tv, lengths=tl).numpy()
    want = np.asarray(want)
    for b in range(batch):
        n = int(lengths[b])
        _close(got[b, :n], want[b, :n], KERNEL_TOLERANCE)
        _close(got[b, :n], whole[b, :n], KERNEL_TOLERANCE)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_flash_decode_sharded_matches_jax(quant):
    """B2 (B5) per rank on its heads of a dense cache."""
    slots, max_len, heads, kv_heads, dim = 3, 128, 8, 4, 128
    rng = np.random.default_rng(12)
    q, k, v = _qkv(rng, (slots, heads, dim), (slots, max_len, kv_heads, dim))
    lengths = np.array([128, 60, 7], np.int32)
    tq, tk, tv, tl = map(torch.from_numpy, (q, k, v, lengths))
    if quant:
        (kq, ks), (vq, vs) = jax_quantize_kv(jnp.asarray(k)), jax_quantize_kv(jnp.asarray(v))
        want = jax_decode_sharded(jnp.asarray(q), kq, vq, jnp.asarray(lengths), _mesh(), k_scale=ks,
                                  v_scale=vs, interpret=True)
        tkq, tks, tvq, tvs = (torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs))
        got = _ranks(lambda r: flash_decode_attention_sharded(
            tq, tkq, tvq, tl, k_scale=tks, v_scale=tvs, rank=r, size=TP))
        whole = flash_decode_attention_quant(tq, tkq, tks, tvq, tvs, tl).numpy()
    else:
        want = jax_decode_sharded(*map(jnp.asarray, (q, k, v, lengths)), _mesh(), interpret=True)
        got = _ranks(lambda r: flash_decode_attention_sharded(tq, tk, tv, tl, rank=r, size=TP))
        whole = flash_decode_attention(tq, tk, tv, tl).numpy()
    _close(got, np.asarray(want), KERNEL_TOLERANCE)
    _close(got, whole, KERNEL_TOLERANCE)


def _paged_pools(rng, batch, max_len, kv_heads, dim, block=8):
    """A shuffled block pool of ``batch`` rows and their tables (block 0
    the null block)."""
    per_row = max_len // block
    tables = (rng.permutation(batch * per_row) + 1).reshape(batch, per_row).astype(np.int32)
    pools = [rng.standard_normal((batch * per_row + 1, block, kv_heads, dim)).astype(np.float32)
             for _ in range(2)]
    return pools[0], pools[1], tables


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("shape", ["decode", "offset"])
def test_ragged_paged_sharded_matches_jax(shape, quant):
    """B3 (B6 over int8 pools) per rank on its kv heads of the pool: a
    decode step (Tq 1) and a prefill at offsets (Tq 8, a cold row
    included); the tables, starts and lengths every rank's."""
    batch, max_len, heads, kv_heads, dim = 3, 64, 8, 2, 32
    rng = np.random.default_rng(13 + quant)
    k_pool, v_pool, tables = _paged_pools(rng, batch, max_len, kv_heads, dim)
    if shape == "decode":
        lengths = np.array([64, 17, 1], np.int32)
        starts, seq = lengths - 1, 1
    else:
        starts = np.array([20, 5, 0], np.int32)
        seq = 8
        lengths = starts + seq
    q = rng.standard_normal((batch, seq, heads, dim)).astype(np.float32)
    args = (tables, starts, lengths)
    tq = torch.from_numpy(q)
    targs = [torch.from_numpy(a) for a in args]
    if quant:
        (kq, ks), (vq, vs) = jax_quantize_kv(jnp.asarray(k_pool)), jax_quantize_kv(jnp.asarray(v_pool))
        want = jax_paged_quant_sharded(jnp.asarray(q), kq, ks, vq, vs, *map(jnp.asarray, args), _mesh(),
                                       interpret=True)
        tkq, tks, tvq, tvs = (torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs))
        got = _ranks(lambda r: ragged_paged_attention_sharded(
            tq, tkq, tvq, *targs, k_scale=tks, v_scale=tvs, rank=r, size=TP))
        whole = ragged_paged_attention_quant(tq, tkq, tks, tvq, tvs, *targs).numpy()
    else:
        want = jax_paged_sharded(*map(jnp.asarray, (q, k_pool, v_pool, *args)), _mesh(), interpret=True)
        tk, tv = torch.from_numpy(k_pool), torch.from_numpy(v_pool)
        got = _ranks(lambda r: ragged_paged_attention_sharded(tq, tk, tv, *targs, rank=r, size=TP))
        whole = ragged_paged_attention(tq, tk, tv, *targs).numpy()
    _close(got, np.asarray(want), KERNEL_TOLERANCE)
    _close(got, whole, KERNEL_TOLERANCE)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_ragged_q_paged_sharded_matches_jax(quant):
    """B7 (B8 over int8 pools) per rank on its kv heads, the mixed step's
    token-ragged launch: a decode row (1 token), a prefill window (5
    tokens at an offset) and an idle row in a flat tile of 8-token spans;
    the tables, starts, lengths and q offsets every rank's. Held on every
    live position."""
    batch, width, max_len, heads, kv_heads, dim = 3, 8, 64, 8, 2, 32
    rng = np.random.default_rng(17 + quant)
    k_pool, v_pool, tables = _paged_pools(rng, batch, max_len, kv_heads, dim)
    starts = np.array([40, 12, 0], np.int32)
    counts = np.array([1, 5, 0], np.int32)
    lengths = starts + counts
    q_offsets = np.arange(batch, dtype=np.int32) * width
    q = rng.standard_normal((batch * width, heads, dim)).astype(np.float32)
    args = (tables, starts, lengths, q_offsets)
    tq = torch.from_numpy(q)
    targs = [torch.from_numpy(a) for a in args]
    kw = dict(max_q_len=width, block_q=width)
    if quant:
        (kq, ks), (vq, vs) = jax_quantize_kv(jnp.asarray(k_pool)), jax_quantize_kv(jnp.asarray(v_pool))
        want = jax_ragged_q_sharded(jnp.asarray(q), kq, vq, *map(jnp.asarray, args), _mesh(),
                                    k_scale=ks, v_scale=vs, interpret=True, **kw)
        tkq, tks, tvq, tvs = (torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs))
        got = _ranks(lambda r: ragged_q_paged_attention_sharded(
            tq, tkq, tvq, *targs, k_scale=tks, v_scale=tvs, rank=r, size=TP, **kw))
        whole = ragged_q_paged_attention_quant(tq, tkq, tks, tvq, tvs, *targs, **kw).numpy()
    else:
        want = jax_ragged_q_sharded(*map(jnp.asarray, (q, k_pool, v_pool, *args)), _mesh(),
                                    interpret=True, **kw)
        tk, tv = torch.from_numpy(k_pool), torch.from_numpy(v_pool)
        got = _ranks(lambda r: ragged_q_paged_attention_sharded(tq, tk, tv, *targs, rank=r, size=TP,
                                                                **kw))
        whole = ragged_q_paged_attention(tq, tk, tv, *targs, **kw).numpy()
    live = np.concatenate([np.arange(b * width, b * width + counts[b]) for b in range(batch)])
    _close(got[live], np.asarray(want)[live], KERNEL_TOLERANCE)
    _close(got[live], whole[live], KERNEL_TOLERANCE)


# ---------------------------------------------------------------------- #
# the ranks: model calls and engines over two gloo processes
# ---------------------------------------------------------------------- #
JAX_PRESETS = {"tiny": jax_model.LlamaConfig.tiny, "tiny-qwen2": jax_model.LlamaConfig.tiny_qwen2,
               "tiny-gemma2": jax_model.LlamaConfig.tiny_gemma2,
               "tiny-moe": jax_model.LlamaConfig.tiny_moe}


def _case(preset, layout, kv_quant=False, int8=False):
    name = f"{preset}-{layout}" + ("-int8kv" if kv_quant else "") + ("-int8w" if int8 else "")
    return {"name": name, "preset": preset, "layout": layout, "kv_quant": kv_quant, "int8": int8}


MODEL_CASES = [
    _case("tiny", "dense"), _case("tiny", "dense", kv_quant=True), _case("tiny", "dense", int8=True),
    _case("tiny", "paged"), _case("tiny", "paged", kv_quant=True), _case("tiny", "paged", int8=True),
    _case("tiny-qwen2", "dense"), _case("tiny-gemma2", "dense"), _case("tiny-gemma2", "paged"),
    _case("tiny-moe", "dense"), _case("tiny-moe", "paged"),
]
ENGINE_CASES = [
    _case("tiny", "dense"), _case("tiny", "dense", kv_quant=True), _case("tiny", "paged"),
    _case("tiny", "paged", kv_quant=True), _case("tiny-moe", "dense"),
]


def _jax_params(preset):
    return jax_model.init_params(JAX_PRESETS[preset](max_seq_len=worker.MAX_LEN), seed=3)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both rank pairs started at once (the model calls, the engines),
    the JAX references computed meanwhile by the tests: yields a function
    that waits for a pair and returns each rank's output."""
    root = tmp_path_factory.mktemp("tp")
    params = {}
    for preset in JAX_PRESETS:
        params[preset] = str(root / f"{preset}.npz")
        np.savez(params[preset], **{k: np.asarray(v) for k, v in _jax_params(preset).items()})
    pairs = {}
    for fn, cases in (("model_calls", MODEL_CASES), ("engine_streams", ENGINE_CASES)):
        out = str(root / fn)
        children = launch.spawn_ranks(
            f"torch_tp_worker:{fn}", {"cases": cases, "params": params, "out": out},
            ["cpu"] * TP, f"127.0.0.1:{free_port()}", timeout_s=RANK_TIMEOUT_S, ranks=range(TP),
            path=[str(REPO / "tests")], cwd=str(REPO))
        pairs[fn] = (children, out)
    results = {}

    def wait(fn):
        if fn not in results:
            children, out = pairs[fn]
            assert launch.stop_ranks(children, timeout_s=RANK_TIMEOUT_S) == [0] * TP, fn
            if fn == "model_calls":
                results[fn] = [dict(np.load(f"{out}.{rank}.npz")) for rank in range(TP)]
            else:
                results[fn] = [json.load(open(f"{out}.{rank}.json")) for rank in range(TP)]
        return results[fn]

    yield wait
    for children, _ in pairs.values():
        for child in children:
            if child.poll() is None:
                child.kill()


def _jax_calls(case):
    """The JAX model's logits for ``worker.call_inputs`` over one case."""
    config = JAX_PRESETS[case["preset"]](max_seq_len=worker.MAX_LEN)
    params = _jax_params(case["preset"])
    if case["int8"]:
        params = jax_quant.quantize_params(params, config.num_experts)
    x = {k: jnp.asarray(v) for k, v in worker.call_inputs(config.vocab_size).items()}
    freqs = jax_model.model_freqs(config)
    out = {}
    if case["layout"] == "dense":
        cache = jax_model.init_cache(config, worker.SLOTS, worker.MAX_LEN, kv_quant=case["kv_quant"])
        cache, out["prefill"] = jax_model.prefill(config, params, cache, x["tokens"], x["lengths"],
                                                  x["slots"], freqs)
        cache, out["offset"] = jax_model.prefill_at_offset(
            config, params, cache, x["suffix_tokens"], x["suffix_lengths"], x["offsets"], x["slots"],
            freqs)
        for step in range(2):
            cache, out[f"decode{step}"] = jax_model.decode_step(
                config, params, cache, x["decode_tokens"][step], x["decode_lengths"][step], freqs)
    else:
        cache = jax_model.init_paged_cache(config, worker.SLOTS * worker.BLOCKS_PER_ROW + 1,
                                           worker.BLOCK, kv_quant=case["kv_quant"])
        ref = dict(kernel="reference")
        cache, out["prefill"] = jax_model.paged_prefill(config, params, cache, x["tokens"], x["lengths"],
                                                        x["tables"], freqs, **ref)
        cache, out["offset"] = jax_model.paged_prefill_at_offset(
            config, params, cache, x["suffix_tokens"], x["suffix_lengths"], x["offsets"], x["tables"],
            freqs, **ref)
        for step in range(2):
            cache, out[f"decode{step}"] = jax_model.paged_decode_step(
                config, params, cache, x["decode_tokens"][step], x["decode_lengths"][step],
                x["tables"], freqs, **ref)
        cache, out["mixed"] = jax_model.paged_mixed_step(
            config, params, cache, x["mixed_tokens"], x["mixed_offsets"], x["mixed_counts"],
            x["tables"], freqs, **ref)
    return {name: np.asarray(logits) for name, logits in out.items()}


@pytest.mark.parametrize("case", MODEL_CASES, ids=[case["name"] for case in MODEL_CASES])
def test_tp2_model_calls_match_jax(ranks, case):
    """The tp=2 serving calls of one case: every rank's logits equal bit
    for bit (gathered whole), and within 1e-4 of the JAX model's."""
    want = _jax_calls(case)
    got = ranks("model_calls")
    for call, logits in want.items():
        key = f"{case['name']}/{call}"
        np.testing.assert_array_equal(got[0][key], got[1][key])
        _close(got[0][key], logits, LOGITS_TOLERANCE)


def _engine_args(case):
    return dict(worker.ENGINE_ARGS, kv_layout=case["layout"],
                kv_quant="int8" if case["kv_quant"] else None)


@pytest.mark.parametrize("case", ENGINE_CASES, ids=[case["name"] for case in ENGINE_CASES])
def test_tp2_engine_streams_match_tp1_and_jax(ranks, case):
    """The tp=2 engine pair: its streams equal the port's tp=1 engine's
    and the JAX engine's at ``MeshConfig(tp=2)`` (paged: the gather
    composition); the follower replayed every record the leader
    published and sampled the same tokens (digests equal); the leader's
    step functions ran eagerly, its cost model counts per card, its pool
    holds its kv heads only, and the prefix cache served tokens."""
    jconfig = JAX_PRESETS[case["preset"]](max_seq_len=128)
    jparams = _jax_params(case["preset"])
    jax_args = dict(_engine_args(case), paged_kernel="reference")
    jax_args.pop("seed")
    jax_tp2 = jax_engine.DecodeEngine(jconfig, jparams, mesh_config=JaxMeshConfig(tp=TP), seed=0,
                                      **jax_args)
    jax_tp2.start()
    try:
        jax_streams = asyncio.run(worker.drive(jax_tp2, jax_engine.SamplingParams))
    finally:
        jax_tp2.stop()
    config = worker.preset(case["preset"], max_seq_len=128)
    params = worker.params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, config)
    tp1 = engine.DecodeEngine(config, params, device="cpu", **_engine_args(case))
    tp1.start()
    try:
        tp1_streams = asyncio.run(worker.drive(tp1))
    finally:
        tp1.stop()
    leader, follower = (result[case["name"]] for result in ranks("engine_streams"))
    assert leader["streams"] == tp1_streams == jax_streams
    assert [len(s) for s in leader["streams"]] == [6, 6, 9]
    assert follower["digest"] == leader["digest"]
    assert follower["records"] == leader["published"] - 1  # the stop record is not replayed
    assert follower["kinds"]["first_token"] == len(worker.REQUESTS)
    assert leader["step_functions"] == "eager" and leader["tp_shards"] == TP
    assert leader["kv_heads"] == config.num_kv_heads // TP
    assert leader["prefix_tokens"] > 0


# ---------------------------------------------------------------------- #
# serve --tp 2
# ---------------------------------------------------------------------- #
def _serve_tp2(mode_flags, engine_keys):
    """``python -m langstream_tpu_torch serve --tp 2 --device cpu`` with
    ``mode_flags``: the leader starts its follower rank, serves a greedy
    completion equal to a one-card service's (``engine_keys`` added to its
    engine config) over the same random weights (seed 0, each rank keeping
    its shard as the leaves are drawn), and at SIGINT sends the follower
    its stop: the follower's account shows every record published and the
    leader's token digest. Returns the follower's record counts by kind."""
    flags = ["--model", "tiny", "--device", "cpu", "--max-slots", "2", "--max-seq-len", "128",
             "--decode-chunk", "4", "--no-watchdog", *mode_flags]
    env = dict(os.environ, LANGSTREAM_FLIGHT_DIR="", PYTHONPATH=str(REPO))
    leader = subprocess.Popen(
        [sys.executable, "-m", "langstream_tpu_torch", "serve", "--tp", "2", "--port", "0",
         "--mirror-port", "0", "--host", "127.0.0.1", *flags],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, text=True)
    lines = []
    try:
        for line in leader.stdout:
            lines.append(line)
            if line.startswith("serving tiny on "):
                url = line.split()[-1]
                break
        else:
            raise AssertionError("".join(lines))
        body = json.dumps({"prompt": "once upon a time", "max_tokens": 8, "temperature": 0}).encode()
        request = urllib.request.Request(url + "/v1/completions", data=body,
                                         headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=60) as response:
            served = json.loads(response.read())["choices"][0]["text"]
        leader.send_signal(signal.SIGINT)
        rest, _ = leader.communicate(timeout=RANK_TIMEOUT_S)
    finally:
        if leader.poll() is None:
            leader.kill()
    assert leader.returncode == 0
    accounts = [json.loads(line) for line in rest.splitlines() if line.startswith("{")]
    follower = next(a["follower"] for a in accounts if "follower" in a)
    mirror = next(a["mirror"] for a in accounts if "mirror" in a)
    assert follower["rank"] == 1 and follower["records"] == mirror["published"] - 1
    assert follower["digest"] == mirror["digest"]
    one_card = TorchCompletionsService(
        {"model": {"preset": "tiny", "max_seq_len": 128},
         "engine": dict({"max-slots": 2, "max-seq-len": 128, "decode-chunk": 4}, **engine_keys)},
        device="cpu")
    try:
        want = asyncio.run(one_card.get_text_completions(["once upon a time"], {"max-tokens": 8}))
    finally:
        one_card.close()
    assert served == want.content
    return follower["kinds"]


def test_serve_tp2_starts_its_follower_and_answers_as_one_card():
    """``serve --tp 2 --device cpu``, the supervisor on (its default):
    see :func:`_serve_tp2`."""
    kinds = _serve_tp2([], {})
    assert kinds["first_token"] == 1


@pytest.mark.parametrize("mode", ["mixed", "spec"])
def test_serve_tp2_mixed_and_spec_answer_as_one_card(mode):
    """``serve --tp 2 --device cpu --kv-layout paged --prefill-mode mixed``
    and ``--spec-decode ngram``, the supervisor on: the follower replays
    the mixed steps (the spec chunks) and the answer is one card's."""
    if mode == "mixed":
        kinds = _serve_tp2(["--kv-layout", "paged", "--prefill-mode", "mixed"],
                           {"kv-layout": "paged", "prefill-mode": "mixed"})
        assert kinds["mixed"] >= 1
    else:
        kinds = _serve_tp2(["--spec-decode", "ngram"], {"spec-decode": "ngram"})
        assert kinds["spec"] >= 1


# ---------------------------------------------------------------------- #
# the cost model per card, and the refusals
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", ["dense", "paged-fused", "paged-reference"])
def test_cost_model_tp_shards_matches_jax(layout):
    """``tp_shards`` 2 over the tiny shape and Llama-3-8B: every accessor
    equal to the JAX cost model's, which ``tests/test_efficiency.py`` pins
    to its goldens (dense: weight bytes halve, KV rows halve, FLOPs
    halve; paged: the table words stay whole)."""
    kwargs = {} if layout == "dense" else dict(kv_block_size=16, paged_kernel=layout.split("-")[1])
    for tcfg, jcfg in ((model.LlamaConfig.tiny(), jax_model.LlamaConfig.tiny()),
                       (model.LlamaConfig.llama3_8b(), jax_model.LlamaConfig.llama3_8b())):
        for kv_quant in (False, True):
            port = CostModel.from_model_config(tcfg, kv_quant=kv_quant, tp=TP, **kwargs)
            ref = JaxCostModel.from_model_config(jcfg, kv_quant=kv_quant, tp=TP, **kwargs)
            assert port.tp_shards == ref.tp_shards == TP
            assert (port.weight_bytes, port.kv_row_bytes) == (ref.weight_bytes, ref.kv_row_bytes)
            for args in ((4, 3, 300), (1, 1, 32), (2, 5, 1000, 5)):
                assert port.decode_chunk_flops(*args) == ref.decode_chunk_flops(*args)
                assert port.decode_chunk_bytes(*args) == ref.decode_chunk_bytes(*args)
            assert port.kv_read_bytes(32) == ref.kv_read_bytes(32)
            assert port.prefill_flops(10, offset=5) == ref.prefill_flops(10, offset=5)
            assert port.kv_handoff_bytes(40) == ref.kv_handoff_bytes(40)
    tiny = CostModel.from_model_config(model.LlamaConfig.tiny(), tp=TP)
    assert tiny.kv_row_bytes == 128 and tiny.decode_chunk_flops(4, 3, 300) == 4 * 397248
    paged = CostModel.from_model_config(model.LlamaConfig.tiny(), tp=TP, kv_block_size=16,
                                        paged_kernel="fused")
    assert paged.kv_read_bytes(32) == 4096 + 16


def test_tp_refusals():
    """Across hosts (``serve --followers``/``--follower-of``) the serve
    keeps the JAX serve's refusals: the supervisor off and spec decode
    refused (the engine's resurrection, import and demotion refusals are
    ``tests/test_torch_mirror.py``'s); on one host (``--tp``) the
    supervisor stays on and the mixed step under tp passes the engine's
    checks, up to its need of ``torch.distributed``. A tp mesh in a
    process without ``torch.distributed`` raises naming how to start the
    ranks; axes other than tp raise naming ROADMAP; the trainer takes a
    tp mesh, and without ``torch.distributed`` raises naming how to start
    the ranks."""
    from langstream_tpu_torch.cli.main import _refuse_spec_under_mirror, build_parser, serve_config
    from langstream_tpu_torch.training import trainer

    config = model.LlamaConfig.tiny()
    params = model.init_params(config)
    for flags in (["--followers", "1"], ["--follower-of", "leader:8477"]):
        across = serve_config(build_parser().parse_args(["serve", "--tp", "2", *flags,
                                                         "--spec-decode", "ngram"]))
        assert across["engine"]["supervisor"] is False
        with pytest.raises(SystemExit, match="multi-host"):
            _refuse_spec_under_mirror(across)
    one_host = serve_config(build_parser().parse_args(["serve", "--tp", "2", "--spec-decode", "ngram"]))
    assert one_host["engine"]["supervisor"] is True and one_host["engine"]["spec-decode"] == "ngram"
    with pytest.raises(RuntimeError, match="serve --tp"):
        engine.DecodeEngine(config, params, device="cpu", kv_layout="paged", prefill_mode="mixed",
                            mesh_config=MeshConfig(tp=2))
    with pytest.raises(RuntimeError, match="serve --tp"):
        engine.DecodeEngine(config, params, device="cpu", mesh_config=MeshConfig(tp=2))
    with pytest.raises(RuntimeError, match="serve --tp"):
        TorchCompletionsService({"model": {"preset": "tiny"}, "mesh": {"tp": 2}}, device="cpu")
    for axis in ("dp", "fsdp", "sp", "pp", "ep"):
        with pytest.raises(NotImplementedError, match=f"{axis}.*ROADMAP"):
            engine.DecodeEngine(config, params, device="cpu", mesh_config=MeshConfig(**{axis: 2}))
    with pytest.raises(RuntimeError, match="parallel.launch"):
        trainer.Trainer(config, params, mesh_config=MeshConfig(tp=2), device="cpu")
    with pytest.raises(ValueError, match="tp=3 must divide num_kv_heads=2"):
        engine.DecodeEngine(config, params, device="cpu", mesh_config=MeshConfig(tp=3))
    assert not hasattr(config, "tp_group")  # a one-card config has no group


def test_row_sharded_partials_stay_f32():
    """A row-sharded product's partial sums (``qmatmul`` with
    ``out_dtype``): bf16 inputs, f32 out, equal to the product in f32,
    the int8 weight's scale on the f32 sums; without ``out_dtype`` the
    one-card product as it was."""
    from langstream_tpu_torch.providers.torch_local import quant

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16), dtype=np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((16, 8), dtype=np.float32)).bfloat16()
    out = quant.qmatmul(x, w, out_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == (2, 3, 8)
    torch.testing.assert_close(out, x.float() @ w.float(), rtol=0, atol=0)
    q = quant.quantize(w.float())
    out = quant.qmatmul(x, q, out_dtype=torch.float32)
    torch.testing.assert_close(out, (x.float() @ q.q.float()) * q.scale, rtol=0, atol=0)
    assert torch.equal(quant.qmatmul(x, w), x @ w)
