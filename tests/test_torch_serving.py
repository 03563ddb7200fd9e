"""The port's OpenAI server, its import rules and its device rules, on
the CPU."""

import ast
import json
import pathlib
import urllib.error
import urllib.request

import pytest
import torch

from langstream_tpu_torch.cli.main import build_parser, start_server
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
