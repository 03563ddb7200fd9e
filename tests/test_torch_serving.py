"""The port's OpenAI server, its import rules and its device rules, on
the CPU; the provider's int8 weights against the JAX int8 engine."""

import ast
import asyncio
import concurrent.futures
import json
import pathlib
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu_torch.cli.main import build_parser, serve_config, start_server
from langstream_tpu_torch.providers.torch_local import engine, model, quant
from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def server():
    args = build_parser().parse_args([
        "serve", "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
        "--max-slots", "4", "--max-seq-len", "256", "--decode-chunk", "4",
    ])
    service, api = start_server(args)
    yield f"http://127.0.0.1:{api.port}"
    api.stop()
    service.engine.stop()


def _post(url, body):
    request = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(request, timeout=60) as response:
        return response.read().decode()


def test_health_and_models(server):
    with urllib.request.urlopen(server + "/healthz", timeout=10) as response:
        assert json.loads(response.read()) == {"status": "ok", "model": "tiny"}
    with urllib.request.urlopen(server + "/v1/models", timeout=10) as response:
        assert json.loads(response.read())["data"][0]["id"] == "tiny"


def test_chat_and_text_completions(server):
    chat = json.loads(_post(server + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hello there"}], "max_tokens": 9,
    }))
    assert chat["object"] == "chat.completion"
    assert chat["choices"][0]["message"]["role"] == "assistant"
    assert chat["usage"]["completion_tokens"] == 9
    text = json.loads(_post(server + "/v1/completions", {
        "prompt": "once upon", "max_tokens": 5, "n": 2, "seed": 3,
        "temperature": 0.9, "logprobs": True,
    }))
    assert [c["index"] for c in text["choices"]] == [0, 1]
    assert text["usage"]["completion_tokens"] == 10
    assert len(text["choices"][0]["logprobs"]["token_logprobs"]) == 5


def test_burst_of_concurrent_clients_is_answered(server):
    """64 clients connect at once, more than http.server's default listen
    backlog of 5 holds: the server listens with the JAX server's backlog
    (aiohttp's 128), and every client is answered."""
    def complete(i):
        return json.loads(_post(server + "/v1/completions", {"prompt": f"burst {i}", "max_tokens": 2}))

    with concurrent.futures.ThreadPoolExecutor(64) as pool:
        replies = list(pool.map(complete, range(64)))
    assert [reply["usage"]["completion_tokens"] for reply in replies] == [2] * 64


@pytest.mark.parametrize("chat", [True, False])
def test_streaming_sse(server, chat):
    path, body = (
        ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}]})
        if chat else ("/v1/completions", {"prompt": "hi"})
    )
    raw = _post(server + path, dict(body, max_tokens=7, stream=True))
    frames = [line[len("data: "):] for line in raw.split("\n\n") if line.startswith("data: ")]
    assert frames[-1] == "[DONE]"
    chunks = [json.loads(frame) for frame in frames[:-1]]
    assert chunks[-1]["usage"]["completion_tokens"] == 7
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    kind = "chat.completion.chunk" if chat else "text_completion"
    assert all(chunk["object"] == kind for chunk in chunks)


def test_bad_requests_answer_400(server):
    for path, body in (
        ("/v1/chat/completions", {"messages": []}),
        ("/v1/completions", {}),
        ("/v1/completions", {"prompt": "x", "n": 0}),
        ("/v1/completions", {"prompt": "x", "top_logprobs": 2, "logprobs": True}),
    ):
        with pytest.raises(urllib.error.HTTPError) as error:
            _post(server + path, body)
        assert error.value.code == 400


@pytest.fixture(scope="module")
def paged_server():
    args = build_parser().parse_args([
        "serve", "--device", "cpu", "--model", "tiny", "--host", "127.0.0.1", "--port", "0",
        "--max-slots", "4", "--max-seq-len", "256", "--decode-chunk", "4",
        "--kv-layout", "paged", "--kv-block-size", "8",
    ])
    service, api = start_server(args)
    yield f"http://127.0.0.1:{api.port}", service.engine
    api.stop()
    service.engine.stop()


def test_paged_server_answers_chat_text_and_sse(paged_server):
    url, eng = paged_server
    assert eng.paged and eng.kv_manager is not None
    system = {"role": "system", "content": "You answer briefly about stream processing. " * 3}
    for question in ("what is a topic?", "what is an agent?"):
        chat = json.loads(_post(url + "/v1/chat/completions", {
            "messages": [system, {"role": "user", "content": question}], "max_tokens": 6,
        }))
        assert chat["usage"]["completion_tokens"] == 6
    # the second chat reused the first one's system-prompt blocks
    assert eng.stats["prefix_hits"] >= 1 and eng.stats["prefix_tokens_reused"] >= 8
    text = json.loads(_post(url + "/v1/completions", {"prompt": "once upon", "max_tokens": 5}))
    assert text["usage"]["completion_tokens"] == 5
    raw = _post(url + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 7, "stream": True,
    })
    frames = [line[len("data: "):] for line in raw.split("\n\n") if line.startswith("data: ")]
    assert frames[-1] == "[DONE]"
    assert json.loads(frames[-2])["usage"]["completion_tokens"] == 7


def test_paged_flags_and_provider_keys_reach_the_engine():
    args = build_parser().parse_args([
        "serve", "--kv-layout", "paged", "--kv-block-size", "32", "--kv-blocks", "40",
        "--paged-kernel", "reference", "--no-prefix-cache",
    ])
    assert (args.kv_layout, args.kv_block_size, args.kv_blocks, args.paged_kernel,
            args.no_prefix_cache) == ("paged", 32, 40, "reference", True)
    defaults = build_parser().parse_args(["serve"])
    assert (defaults.kv_layout, defaults.kv_block_size, defaults.kv_blocks,
            defaults.paged_kernel, defaults.no_prefix_cache) == ("dense", 16, 0, "fused", False)
    service = TorchCompletionsService({
        "model": {"preset": "tiny", "max_seq_len": 128},
        "engine": {"max-slots": 2, "kv-layout": "PAGED", "kv-block-size": "32",
                   "kv-blocks": "9", "paged-kernel": "reference", "prefix-cache": "false"},
    }, device="cpu")
    try:
        eng = service.engine
        assert (eng.kv_layout, eng.block_size, eng.num_blocks, eng.paged_kernel,
                eng.prefix_cache) == ("paged", 32, 9, "reference", False)
    finally:
        eng.stop()
    dense = TorchCompletionsService({"model": {"preset": "tiny", "max_seq_len": 128}}, device="cpu")
    try:
        assert (dense.engine.kv_layout, dense.engine.paged_kernel, dense.engine.prefix_cache) == (
            "dense", None, True)
    finally:
        dense.engine.stop()


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((REPO / "langstream_tpu_torch").rglob("*.py"))
    # the tensor-parallel slice's modules, the follower's entry script and
    # the ranks the CPU tests start are scanned by name: each must exist
    tp_files = [REPO / "langstream_tpu_torch" / path for path in (
        "serving/mirror.py", "runtime/multihost.py", "parallel/mesh.py", "parallel/launch.py")]
    assert all(path in files for path in tp_files), tp_files
    # and the brokers' and pod entry's modules, with the native loader
    broker_files = [REPO / "langstream_tpu_torch" / path for path in (
        "native/__init__.py", "topics/log/broker.py", "topics/log/server.py",
        "topics/log/client.py", "topics/kafka/protocol.py", "topics/kafka/runtime.py",
        "topics/kafka/server.py", "topics/kafka/avro.py", "runtime/pod.py", "agents/camel.py",
        "agents/kafka_connect.py")]
    assert all(path in files for path in broker_files), broker_files
    files += [REPO / "chip_smoke.py", REPO / "serve_ab.py", REPO / "tests" / "torch_tp_worker.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "langstream_tpu"), (path, name)


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    config = model.LlamaConfig.tiny()
    params = model.init_params(config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.DecodeEngine(config, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchCompletionsService({})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        start_server(build_parser().parse_args(["serve", "--port", "0"]))


def test_provider_kv_quant_serves_chat_text_and_sse():
    """``engine.kv-quant: int8`` in the provider config (``serve`` has no
    flag for it, as in the JAX package) builds an int8 cache, and the
    OpenAI server over it answers chat, text and SSE."""
    args = build_parser().parse_args([
        "serve", "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
        "--max-slots", "2", "--max-seq-len", "128", "--decode-chunk", "4",
    ])
    config = serve_config(args)
    config["engine"]["kv-quant"] = "int8"
    service, api = start_server(args, config)
    url = f"http://127.0.0.1:{api.port}"
    try:
        cache = service.engine.cache
        assert service.engine.kv_quant and cache["k"].dtype == torch.int8
        assert cache["k_scale"].dtype == torch.float32
        chat = json.loads(_post(url + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hello there"}], "max_tokens": 6,
        }))
        assert chat["usage"]["completion_tokens"] == 6
        text = json.loads(_post(url + "/v1/completions", {"prompt": "once upon", "max_tokens": 5}))
        assert text["usage"]["completion_tokens"] == 5
        raw = _post(url + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 7, "stream": True,
        })
        frames = [line[len("data: "):] for line in raw.split("\n\n") if line.startswith("data: ")]
        assert frames[-1] == "[DONE]"
        assert json.loads(frames[-2])["usage"]["completion_tokens"] == 7
    finally:
        api.stop()
        service.engine.stop()


def test_provider_refuses_int8_weights():
    """``quantization: int8`` serves int8 weights: the provider's engine
    holds the port's ``quantize_params`` of the random weights of its
    seed, and its greedy tokens equal the JAX engine's with
    ``quantize="int8"`` over the same model-dtype weights. Any other
    quantization is refused."""
    config = {"model": {"preset": "tiny", "max_seq_len": 64}, "seed": 3, "quantization": "int8",
              "engine": {"max-slots": 2, "decode-chunk": 4, "prefill-buckets": [16]}}
    service = TorchCompletionsService(config, device="cpu")
    tcfg = model.LlamaConfig.tiny(max_seq_len=64)
    weights = model.init_params(tcfg, seed=3)
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=64)
    reference = jax_engine.DecodeEngine(
        jcfg, {name: np.asarray(leaf) for name, leaf in weights.items()}, quantize="int8",
        max_slots=2, max_seq_len=64, prefill_buckets=[16], decode_chunk=4, prefix_cache=False)
    try:
        expected = quant.quantize_params(weights)
        for name in quant.QUANTIZED_PARAMS:
            leaf = service.engine.params[name]
            assert isinstance(leaf, quant.QTensor), name
            assert torch.equal(leaf.q, expected[name].q) and torch.equal(leaf.scale, expected[name].scale)
        prompt = service.tokenizer.encode("once upon a time")
        got = asyncio.run(service.engine.generate(prompt, engine.SamplingParams(max_new_tokens=9)))
        want = asyncio.run(reference.generate(prompt, jax_engine.SamplingParams(max_new_tokens=9)))
        assert got.tokens == want.tokens and len(got.tokens) == 9
        text = asyncio.run(service.get_text_completions(["once upon"], {"max-tokens": 5}))
        assert text.completion_tokens == 5
    finally:
        service.engine.stop()
        reference.stop()
    with pytest.raises(ValueError, match="unknown quantization"):
        TorchCompletionsService({"model": {"preset": "tiny"}, "quantization": "fp4"}, device="cpu")


# one value other than the JAX default for each key the JAX provider
# honours and the port does not serve yet: (where, key, value). The mesh's
# tp axis is served since the tensor-parallel slice; its other axes are not
UNPORTED = [
    ("top", "mesh", {"dp": 2}),
]
# keys the port serves since the self-healing slice (kv-host-blocks since
# the host-tier slice, slo since the accounting slice), each with a value
# other than the JAX default and the check that the service honours it
HONOURED = {
    "slo": ({"ttft-ms-p95": 200, "tpot-ms-p95": 0},
            lambda service: service.engine.slo is not None
            and service.engine.slo.targets_s == {"ttft": 0.2}),
    "kv-host-blocks": (64, lambda service: service.engine.kv_host_blocks == 64
                       and service.engine.kv_host_arena.capacity_blocks == 64
                       and service.engine.kv_manager.host is service.engine.kv_host_arena),
    "watchdog": ("on", lambda service: service.watchdog is not None
                 and service.supervisor.watchdog is service.watchdog
                 and service.watchdog.engine is service.engine),
    "queue-timeout-s": (1.5, lambda service: service.engine.queue_timeout_s == 1.5),
    "max-restarts": (5, lambda service: service.supervisor.max_restarts == 5),
    "restart-window-s": (60, lambda service: service.supervisor.restart_window_s == 60.0),
}
# the JAX defaults, spelled out: served
DEFAULTS = {
    "engine": {"kv-host-blocks": 0, "spec-decode": "off", "spec-k": 4, "spec-ngram": 2,
               "watchdog": "false", "pipeline-decode": "", "admission-chunk": None, "logprobs-top-k": 0,
               "queue-timeout-s": None, "precompile": "false", "max-restarts": 3,
               "restart-window-s": 600, "max-slots": 2},
    "slo": {"ttft-ms-p95": 0},
    "mesh": None,
}
# the other engine keys a honoured key needs (the host tier is paged only)
NEEDS = {"kv-host-blocks": {"kv-layout": "paged"}}
# honoured keys at the config's top level, not under ``engine``
TOP_LEVEL = {"slo"}
CASES = [("top" if key in TOP_LEVEL else "engine", key, value)
         for key, (value, _) in HONOURED.items()] + UNPORTED


@pytest.mark.parametrize(
    "where,key,value", CASES + [("defaults", None, None)],
    ids=[key for _, key, _ in CASES] + ["defaults-serve"],
)
def test_provider_refuses_keys_it_does_not_port(where, key, value):
    """Each key the JAX provider honours and the port does not (a ``mesh``
    axis other than ``tp``) raises when set to a non-default value, instead of being served as if
    it were absent; the keys the port serves since the self-healing slice
    (``watchdog``, ``queue-timeout-s``, ``max-restarts``,
    ``restart-window-s``), the host-tier slice (``kv-host-blocks``) and
    the accounting slice (``slo``) reach the service: the watchdog built
    and watching the engine, the engine's admission deadline, the
    supervisor's restart budget and window, the host arena attached to the
    paged pool, the SLO tracker with its nonzero target; the defaults,
    spelled out, still serve."""
    config = {"model": {"preset": "tiny", "max_seq_len": 64}, **DEFAULTS,
              "engine": dict(DEFAULTS["engine"])}
    if where == "defaults":
        service = TorchCompletionsService(config, device="cpu")
        try:
            result = asyncio.run(service.get_text_completions(["once"], {"max-tokens": 3}))
            assert result.completion_tokens == 3
            # the defaults: supervised, no watchdog, no deadline, no SLO
            # (a zero target is dropped)
            assert service.supervisor is not None and service.watchdog is None
            assert service.engine.queue_timeout_s is None
            assert service.engine.slo is None
        finally:
            service.close()
        return
    (config["engine"] if where == "engine" else config)[key] = value
    config["engine"].update(NEEDS.get(key, {}))
    if key in HONOURED:
        service = TorchCompletionsService(config, device="cpu")
        try:
            assert HONOURED[key][1](service), key
            result = asyncio.run(service.get_text_completions(["once"], {"max-tokens": 3}))
            assert result.completion_tokens == 3
        finally:
            service.close()
        return
    with pytest.raises(NotImplementedError, match=f"{key}.*ROADMAP.md"):
        TorchCompletionsService(config, device="cpu")


# keys the port serves since the step runner: (key, value, engine attribute check)
SERVED_SINCE_GRAPHS = {
    "admission-chunk": ("2", lambda eng: eng.admission_chunk == 2),
    "precompile": ("yes", lambda eng: eng.precompile_s is not None
                   and eng.steps.stats["captured"] == len(eng._variant_keys())),
}


@pytest.mark.parametrize("key", sorted(SERVED_SINCE_GRAPHS))
def test_provider_serves_precompile_and_admission_chunk(key):
    """``admission-chunk`` and ``precompile`` reach the engine from the
    provider config (string-coerced, as the JAX provider reads them) and
    from ``serve``'s flags, and the service answers; after
    ``precompile`` no step variant is captured while serving."""
    value, reached = SERVED_SINCE_GRAPHS[key]
    config = {"model": {"preset": "tiny", "max_seq_len": 64},
              "engine": {"max-slots": 2, "decode-chunk": 4, "prefill-buckets": [16], key: value}}
    service = TorchCompletionsService(config, device="cpu")
    try:
        eng = service.engine
        assert reached(eng), key
        captured = eng.steps.stats["captured"]
        result = asyncio.run(service.get_text_completions(["once"], {"max-tokens": 6}))
        assert result.completion_tokens == 6
        if key == "precompile":
            assert eng.steps.stats["captured"] == captured and eng.steps.stats["replayed"] > 0
    finally:
        service.engine.stop()
    flag = {"admission-chunk": ["--admission-chunk", "2"], "precompile": ["--precompile"]}[key]
    served = serve_config(build_parser().parse_args(["serve", *flag]))["engine"]
    assert served[key] == {"admission-chunk": 2, "precompile": True}[key]
    default = serve_config(build_parser().parse_args(["serve"]))["engine"]
    assert not default[key]
