"""The port's OpenAI server, its import rules and its device rules, on
the CPU."""

import ast
import asyncio
import json
import pathlib
import urllib.error
import urllib.request

import pytest
import torch

from langstream_tpu_torch.cli.main import build_parser, serve_config, start_server
from langstream_tpu_torch.providers.torch_local import engine, model
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
    files.append(REPO / "chip_smoke.py")
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
    """``quantization: int8`` (int8 weights) is not ported: the provider
    raises instead of serving the model-dtype weights."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TorchCompletionsService({"model": {"preset": "tiny"}, "quantization": "int8"}, device="cpu")
    with pytest.raises(ValueError, match="unknown quantization"):
        TorchCompletionsService({"model": {"preset": "tiny"}, "quantization": "fp4"}, device="cpu")


# one value other than the JAX default for each key the JAX provider
# honours and the port does not serve yet: (where, key, value)
UNPORTED = [
    ("engine", "kv-host-blocks", 64),
    ("engine", "spec-decode", "ngram"),
    ("engine", "spec-k", 6),
    ("engine", "spec-ngram", 3),
    ("engine", "pipeline-decode", "true"),
    ("engine", "admission-chunk", 2),
    ("engine", "logprobs-top-k", 5),
    ("engine", "queue-timeout-s", 1.5),
    ("engine", "precompile", "yes"),
    ("engine", "max-restarts", 5),
    ("engine", "restart-window-s", 60),
    ("top", "slo", {"ttft-ms-p95": 200}),
    ("top", "mesh", {"tp": 2}),
]
# the JAX defaults, spelled out: served
DEFAULTS = {
    "engine": {"kv-host-blocks": 0, "spec-decode": "off", "spec-k": 4, "spec-ngram": 2,
               "pipeline-decode": "", "admission-chunk": None, "logprobs-top-k": 0,
               "queue-timeout-s": None, "precompile": "false", "max-restarts": 3,
               "restart-window-s": 600, "max-slots": 2},
    "slo": {"ttft-ms-p95": 0},
    "mesh": None,
}


@pytest.mark.parametrize(
    "where,key,value", UNPORTED + [("defaults", None, None)],
    ids=[key for _, key, _ in UNPORTED] + ["defaults-serve"],
)
def test_provider_refuses_keys_it_does_not_port(where, key, value):
    """Each key the JAX provider honours and the port does not raises
    when set to a non-default value, instead of being served as if it were
    absent; the defaults, spelled out, still serve."""
    config = {"model": {"preset": "tiny", "max_seq_len": 64}, **DEFAULTS,
              "engine": dict(DEFAULTS["engine"])}
    if where == "defaults":
        service = TorchCompletionsService(config, device="cpu")
        try:
            result = asyncio.run(service.get_text_completions(["once"], {"max-tokens": 3}))
            assert result.completion_tokens == 3
        finally:
            service.engine.stop()
        return
    (config["engine"] if where == "engine" else config)[key] = value
    with pytest.raises(NotImplementedError, match=f"{key}.*ROADMAP.md"):
        TorchCompletionsService(config, device="cpu")
