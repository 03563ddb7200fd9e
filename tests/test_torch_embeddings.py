"""The port's embeddings path against the JAX package's, on the CPU.

- ``embeddings.encode`` against the JAX ``encode`` (f32, tolerance 1e-5)
  on the tiny preset and on a 2-layer encoder at MiniLM-L6's width, with
  all-padding rows, which must come out as zeros, never NaN.
- ``TorchEmbedder.embed`` against ``JaxEmbedder.embed`` on the byte
  tokenizer: the padded (rows, bucket) batch the encoder gets, token for
  token, and the vectors (1e-5).
- ``weights.load_hf_bert`` against the JAX ``load_hf_bert``, bit for bit:
  a model object (a ``SimpleNamespace`` config and a state dict), a
  ``transformers`` ``BertModel`` saved as safetensors and as
  ``pytorch_model.bin``, and a ``bert.``-prefixed safetensors directory
  written by hand; a Llama directory raises.
- ``TorchEmbeddingsService``, ``TorchLocalServiceProvider``, the server's
  ``/v1/embeddings`` against the JAX server's handler, its 503 and 400s,
  and ``serve --embeddings-checkpoint``.

JAX params cross with ``convert.encoder_params_from_jax``.
"""

import asyncio
import dataclasses
import json
import os
import types
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.providers.jax_local import embeddings as jax_embeddings
from langstream_tpu.providers.jax_local import tokenizer as jax_tokenizer
from langstream_tpu.providers.jax_local.provider import JaxEmbeddingsService
from langstream_tpu_torch.api import errors as api_errors
from langstream_tpu_torch.api.service import EmbeddingsService
from langstream_tpu_torch.providers.torch_local import embeddings, tokenizer, weights
from langstream_tpu_torch.providers.torch_local.convert import encoder_params_from_jax
from langstream_tpu_torch.providers.torch_local.provider import (
    TorchCompletionsService,
    TorchEmbeddingsService,
    TorchLocalServiceProvider,
)
from langstream_tpu_torch.serving.openai_api import OpenAIApiServer

TOLERANCE = 1e-5
CPU = "cpu"

# a 2-layer encoder at all-MiniLM-L6-v2's width
MINILM_2L = dict(vocab_size=30522, hidden_size=384, intermediate_size=1536, num_layers=2,
                 num_heads=12, max_positions=512)

# texts whose byte lengths (+ BOS) span the buckets 16, 32 and the cap 48
WORDS = ["stream", "vector", "kernel", "topic", "agent", "Größe", "日本語", "🚀"]


def _texts(rng, count):
    out = []
    for _ in range(count):
        n = int(rng.choice([1, 3, 9, 20, 70]))  # 70 bytes and more pass max_length
        text = ""
        while len(text.encode()) < n:
            text += str(rng.choice(WORDS)) + " "
        out.append(text.strip())
    return out


def _port_config(jax_config):
    fields = {f.name: getattr(jax_config, f.name) for f in dataclasses.fields(jax_config)}
    fields["dtype"] = torch.float32
    return embeddings.EncoderConfig(**fields)


def _carry(jax_params):
    return encoder_params_from_jax({k: np.asarray(v) for k, v in jax_params.items()})


@pytest.mark.parametrize("shape", ["tiny", "minilm-2l"])
def test_encode_matches_jax(shape):
    jcfg = (jax_embeddings.EncoderConfig.tiny() if shape == "tiny"
            else jax_embeddings.EncoderConfig(**MINILM_2L))
    jparams = jax_embeddings.init_encoder_params(jcfg, seed=5)
    # LayerNorm params off their init values, so the test sees them
    rng = np.random.default_rng(5)
    for name in ("emb_norm_w", "emb_norm_b", "attn_norm_w", "attn_norm_b",
                 "mlp_norm_w", "mlp_norm_b", "bq", "b_in"):
        base = np.asarray(jparams[name])
        jparams[name] = jnp.asarray(base + rng.normal(0, 0.1, base.shape).astype(np.float32))
    rows, seq = 6, 32
    tokens = rng.integers(0, jcfg.vocab_size, (rows, seq)).astype(np.int32)
    mask = np.zeros((rows, seq), dtype=bool)
    for row, length in enumerate([32, 1, 17, 0, 5, 0]):  # rows 3 and 5: all padding
        mask[row, :length] = True
    want = np.asarray(jax_embeddings.encode(jcfg, jparams, tokens, mask))
    got = embeddings.encode(_port_config(jcfg), _carry(jparams), torch.from_numpy(tokens),
                            torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (rows, jcfg.hidden_size)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOLERANCE)
    assert torch.equal(got[3], torch.zeros(jcfg.hidden_size))
    assert torch.equal(got[5], torch.zeros(jcfg.hidden_size))
    norms = torch.linalg.vector_norm(got[[0, 1, 2, 4]], dim=-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-5)


def test_layer_norm_matches_jax():
    """``torch.var`` defaults to the unbiased variance, ``jnp.var`` is the
    population one: the port's LayerNorm is JAX's, in f32."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 3, (4, 7, 32)).astype(np.float32)
    weight = rng.normal(1, 0.1, 32).astype(np.float32)
    bias = rng.normal(0, 0.1, 32).astype(np.float32)
    want = np.asarray(jax_embeddings._layer_norm(jnp.asarray(x), weight, bias, 1e-12))
    got = embeddings._layer_norm(torch.from_numpy(x), torch.from_numpy(weight),
                                 torch.from_numpy(bias), 1e-12)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    unbiased = (torch.from_numpy(x) - torch.from_numpy(x).mean(-1, keepdim=True)) / torch.from_numpy(
        x).var(-1, keepdim=True).sqrt()
    assert not torch.allclose(got, unbiased * torch.from_numpy(weight) + torch.from_numpy(bias),
                              atol=1e-3)


def test_init_encoder_params_shapes_and_dtypes_match_jax():
    jcfg = jax_embeddings.EncoderConfig.tiny()
    jparams = jax_embeddings.init_encoder_params(jcfg)
    params = embeddings.init_encoder_params(embeddings.EncoderConfig.tiny(), seed=0, device=CPU)
    assert sorted(params) == sorted(jparams)
    for name, leaf in jparams.items():
        assert tuple(params[name].shape) == leaf.shape, name
        assert params[name].dtype == torch.float32
    again = embeddings.init_encoder_params(embeddings.EncoderConfig.tiny(), seed=0, device=CPU)
    assert all(torch.equal(again[name], leaf) for name, leaf in params.items())
    assert torch.equal(params["attn_norm_w"], torch.ones(2, 32))
    assert torch.equal(params["bq"], torch.zeros(2, 32))


def test_encoder_config_from_dict_matches_jax():
    for config in ({"preset": "minilm-l6"}, {"preset": "tiny", "max-length": 9},
                   {"hidden-size": 64, "num_heads": 4, "num-layers": 3, "unknown": 1}):
        want = jax_embeddings.EncoderConfig.from_dict(config)
        got = embeddings.EncoderConfig.from_dict(config)
        for field in dataclasses.fields(got):
            if field.name != "dtype":
                assert getattr(got, field.name) == getattr(want, field.name), (config, field.name)
        assert got.dtype == torch.float32
    assert embeddings.EncoderConfig.from_dict({"dtype": "bfloat16"}).dtype == torch.bfloat16


@pytest.mark.parametrize("count", [1, 3, 5, 17])
def test_embedder_matches_jax(count):
    jcfg = jax_embeddings.EncoderConfig.tiny()
    jparams = jax_embeddings.init_encoder_params(jcfg, seed=count)
    reference = jax_embeddings.JaxEmbedder(jcfg, jparams, jax_tokenizer.ByteTokenizer(),
                                           max_length=48)
    seen = []
    jit = reference._jit
    reference._jit = lambda p, t, m: (seen.append((np.asarray(t), np.asarray(m))), jit(p, t, m))[1]
    port = embeddings.TorchEmbedder(_port_config(jcfg), _carry(jparams), tokenizer.ByteTokenizer(),
                                    max_length=48, device=CPU)
    texts = _texts(np.random.default_rng(count), count)
    want = reference.embed(texts)
    got = port.embed(texts)
    tokens, mask = port.batch(texts)
    np.testing.assert_array_equal(tokens, seen[0][0])
    np.testing.assert_array_equal(mask, seen[0][1])
    longest = max(len(tokenizer.ByteTokenizer().encode(t)) for t in texts)
    assert tokens.shape == (embeddings._next_pow2(count), min(embeddings._next_pow2(longest, 16), 48))
    assert len(got) == count and all(len(v) == jcfg.hidden_size for v in got)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOLERANCE)


def test_embedder_caps_max_length_at_the_positions():
    cfg = embeddings.EncoderConfig.tiny()
    port = embeddings.TorchEmbedder(cfg, embeddings.init_encoder_params(cfg, device=CPU),
                                    tokenizer.ByteTokenizer(), max_length=1000, device=CPU)
    assert port.max_length == cfg.max_positions
    tokens, mask = port.batch(["x" * 500])
    assert tokens.shape == (1, 64) and mask.all()
    assert port.embed([]) == []


# ---------------------------------------------------------------------- #
# load_hf_bert
# ---------------------------------------------------------------------- #
HF_CONFIG = dict(vocab_size=120, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=64, layer_norm_eps=1e-12)


def _bert_state(seed, config=HF_CONFIG, prefix=""):
    """A BERT state dict of random f32 tensors, with the pooler and the
    position-id buffer a saved ``BertModel`` carries."""
    gen = torch.Generator().manual_seed(seed)
    h, f = config["hidden_size"], config["intermediate_size"]

    def rand(*shape):
        return torch.randn(shape, generator=gen) * 0.1

    state = {
        "embeddings.word_embeddings.weight": rand(config["vocab_size"], h),
        "embeddings.position_embeddings.weight": rand(config["max_position_embeddings"], h),
        "embeddings.token_type_embeddings.weight": rand(2, h),
        "embeddings.LayerNorm.weight": 1 + rand(h), "embeddings.LayerNorm.bias": rand(h),
        "embeddings.position_ids": torch.arange(config["max_position_embeddings"])[None],
        "pooler.dense.weight": rand(h, h), "pooler.dense.bias": rand(h),
    }
    for i in range(config["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name, (rows, cols) in (("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                                   ("attention.self.value", (h, h)),
                                   ("attention.output.dense", (h, h)),
                                   ("intermediate.dense", (f, h)), ("output.dense", (h, f))):
            state[p + name + ".weight"] = rand(rows, cols)
            state[p + name + ".bias"] = rand(rows)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            state[p + name + ".weight"] = 1 + rand(h)
            state[p + name + ".bias"] = rand(h)
    return {prefix + name: tensor for name, tensor in state.items()}


def _assert_same_load(jax_loaded, port_loaded):
    jcfg, jparams = jax_loaded
    cfg, params = port_loaded
    for field in dataclasses.fields(cfg):
        if field.name != "dtype":
            assert getattr(cfg, field.name) == getattr(jcfg, field.name), field.name
    assert sorted(params) == sorted(jparams)
    for name, leaf in jparams.items():
        want = np.asarray(leaf)
        got = params[name]
        assert str(got.dtype).replace("torch.", "") == want.dtype.name, name
        assert tuple(got.shape) == want.shape, name
        assert np.array_equal(got.float().numpy(), want.astype(np.float32)), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_hf_bert_from_a_model_object_matches_jax_bit_for_bit(dtype):
    model = types.SimpleNamespace(config=types.SimpleNamespace(**HF_CONFIG),
                                  state_dict=lambda: _bert_state(3))
    want = jax_embeddings.load_hf_bert(model, dtype=getattr(jnp, dtype))
    got = weights.load_hf_bert(model, device=CPU, dtype=getattr(torch, dtype))
    assert got[0].dtype == getattr(torch, dtype)
    _assert_same_load(want, got)
    # the norms widened back to f32 from the checkpoint dtype, as in JAX
    assert got[1]["attn_norm_w"].dtype == torch.float32


@pytest.fixture(scope="module")
def bert_dirs(tmp_path_factory):
    """A tiny ``transformers`` BertModel (random LayerNorms and biases) and
    its BERT tokenizer, saved as safetensors and as ``pytorch_model.bin``."""
    transformers = pytest.importorskip("transformers")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        chr(c) for c in range(ord("a"), ord("z") + 1)] + [
        "stream", "vector", "kernel", "topic", "agent", "##s", "##ing", "card", "search"]
    root = tmp_path_factory.mktemp("bert")
    vocab_file = root / "vocab.txt"
    vocab_file.write_text("\n".join(vocab) + "\n")
    tok = transformers.BertTokenizer(str(vocab_file))
    config = transformers.BertConfig(**dict(HF_CONFIG, vocab_size=len(vocab)))
    torch.manual_seed(0)
    bert = transformers.BertModel(config)
    with torch.no_grad():
        for name, param in bert.named_parameters():
            param.add_(torch.randn_like(param) * 0.05)
    dirs = {}
    for fmt, safe in (("safetensors", True), ("bin", False)):
        path = root / fmt
        bert.save_pretrained(str(path), safe_serialization=safe)
        tok.save_pretrained(str(path))
        dirs[fmt] = str(path)
    return dirs


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_hf_bert_from_a_saved_bert_matches_jax_bit_for_bit(bert_dirs, fmt):
    path = bert_dirs[fmt]
    assert os.path.exists(os.path.join(path, "model.safetensors" if fmt == "safetensors"
                                       else "pytorch_model.bin"))
    _assert_same_load(jax_embeddings.load_hf_bert(path), weights.load_hf_bert(path, device=CPU))


def test_load_hf_bert_takes_bert_prefixed_keys(tmp_path):
    """A task model's checkpoint (``BertForMaskedLM`` and kin) prefixes the
    encoder's keys with ``bert.``; its head's keys are not read."""
    safetensors_torch = pytest.importorskip("safetensors.torch")
    pytest.importorskip("transformers")
    state = _bert_state(7, prefix="bert.")
    state["cls.predictions.bias"] = torch.zeros(HF_CONFIG["vocab_size"])
    safetensors_torch.save_file(state, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(dict(
        HF_CONFIG, model_type="bert", architectures=["BertForMaskedLM"])))
    got = weights.load_hf_bert(str(tmp_path), device=CPU)
    _assert_same_load(jax_embeddings.load_hf_bert(str(tmp_path)), got)
    plain = types.SimpleNamespace(config=types.SimpleNamespace(**HF_CONFIG),
                                  state_dict=lambda: _bert_state(7))
    _assert_same_load(jax_embeddings.load_hf_bert(plain), got)


def test_load_hf_bert_refuses_another_architecture(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "llama", "architectures": ["LlamaForCausalLM"], "vocab_size": 300}))
    with pytest.raises(ValueError, match="not a BERT-architecture"):
        weights.load_hf_bert(str(tmp_path), device=CPU)


# ---------------------------------------------------------------------- #
# service, provider, server
# ---------------------------------------------------------------------- #
TEXTS = ["alpha", "beta stream vector", "a much longer text about kernels " * 4, ""]


def _tiny_services():
    """The JAX service over its seed-0 tiny encoder, and the port's over
    the same params carried across."""
    reference = JaxEmbeddingsService({"embeddings-model": {"preset": "tiny"}}, None)
    port = TorchEmbeddingsService({"embeddings-model": {"preset": "tiny"}}, device=CPU)
    port.embedder.params = _carry(reference.embedder.params)
    return reference, port


def test_service_from_a_preset_matches_jax():
    reference, port = _tiny_services()
    assert isinstance(port, EmbeddingsService)
    assert isinstance(port.embedder.tokenizer, tokenizer.ByteTokenizer)
    assert port.embedder.max_length == reference.embedder.max_length == 64
    got = asyncio.run(port.compute_embeddings(TEXTS))
    want = asyncio.run(reference.compute_embeddings(TEXTS))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOLERANCE)
    minilm = TorchEmbeddingsService({"embeddings-model": {"preset": "minilm-l6", "max-length": 128}},
                                    device=CPU)
    assert minilm.embedder.config == embeddings.EncoderConfig.minilm_l6()
    assert minilm.embedder.max_length == 128
    port.close()


def test_service_from_a_checkpoint_matches_jax(bert_dirs):
    path = bert_dirs["safetensors"]
    reference = JaxEmbeddingsService({"embeddings-model": {"checkpoint": path}}, None)
    port = TorchEmbeddingsService({"embeddings-model": {"checkpoint": path}}, device=CPU)
    assert isinstance(port.embedder.tokenizer, tokenizer.HFTokenizer)
    texts = ["stream vector", "kernel search card", "topics"]
    assert port.embedder.tokenizer.encode(texts[0]) == reference.embedder.tokenizer.encode(texts[0])
    got = asyncio.run(port.compute_embeddings(texts))
    want = asyncio.run(reference.compute_embeddings(texts))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOLERANCE)
    # a model name holding "/" is read as a checkpoint
    by_name = TorchEmbeddingsService({}, model=path, device=CPU)
    np.testing.assert_allclose(np.asarray(asyncio.run(by_name.compute_embeddings(texts))),
                               np.asarray(got), rtol=0, atol=0)


def test_provider_supports_and_hands_out_both_services():
    provider = TorchLocalServiceProvider(device=CPU)
    assert provider.name == "torch-local"
    assert provider.supports({"type": "torch-local"}) and provider.supports({"type": "torch"})
    assert provider.supports({"torch-local": {}})
    assert not provider.supports({"type": "jax-local"}) and not provider.supports({})
    service = provider.get_embeddings_service({"embeddings-model": {"preset": "tiny"}})
    assert isinstance(service, TorchEmbeddingsService)
    assert len(asyncio.run(service.compute_embeddings(["x"]))[0]) == 32
    completions = provider.get_completions_service({
        "type": "torch-local", "engine": {"max-slots": 2, "max-seq-len": 64, "supervisor": False}})
    try:
        assert isinstance(completions, TorchCompletionsService)
        assert completions.engine.device.type == "cpu"
    finally:
        completions.close()


def test_entry_points_refuse_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    cfg = embeddings.EncoderConfig.tiny()
    params = embeddings.init_encoder_params(cfg, device=CPU)
    for build in (lambda: TorchEmbeddingsService({}),
                  lambda: embeddings.init_encoder_params(cfg),
                  lambda: embeddings.TorchEmbedder(cfg, params, tokenizer.ByteTokenizer()),
                  lambda: weights.load_hf_bert(str(tmp_path)),
                  lambda: TorchLocalServiceProvider().get_embeddings_service({})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


class _JsonRequest:
    """The one thing the JAX handler reads of an aiohttp request."""

    def __init__(self, body):
        self._body = body

    async def json(self):
        if isinstance(self._body, bytes):
            return json.loads(self._body)
        return self._body


def _post(port, body, raw=None):
    request = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/embeddings",
        data=raw if raw is not None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=60) as response:
            return response.status, dict(response.headers), json.loads(response.read())
    except urllib.error.HTTPError as error:
        return error.code, dict(error.headers), json.loads(error.read())


@pytest.fixture
def served():
    """The port's server over the port's tiny service, and the JAX server
    over the JAX one (the same params); the JAX handler is called
    directly."""
    from langstream_tpu.serving.openai_api import OpenAIApiServer as JaxServer

    reference, port = _tiny_services()
    server = OpenAIApiServer(None, port, model="tiny", host="127.0.0.1", port=0)
    server.start()
    try:
        yield server, JaxServer(None, reference, model="tiny")
    finally:
        server.stop()


@pytest.mark.parametrize("body", [
    {"input": ["alpha", "beta stream", "gamma " * 20]},
    {"input": "one string", "model": "my-embedder"},
    {"input": []},
])
def test_embeddings_route_matches_the_jax_server(served, body):
    server, reference = served
    status, _, got = _post(server.port, body)
    response = asyncio.run(reference._embeddings(_JsonRequest(body)))
    want = json.loads(response.text)
    assert status == 200 and response.status == 200
    assert got["object"] == want["object"] == "list"
    assert got["model"] == want["model"] and got["usage"] == want["usage"]
    assert [(d["object"], d["index"]) for d in got["data"]] == [
        (d["object"], d["index"]) for d in want["data"]]
    for mine, theirs in zip(got["data"], want["data"]):
        np.testing.assert_allclose(mine["embedding"], theirs["embedding"], rtol=0, atol=TOLERANCE)


def test_embeddings_route_errors_as_the_jax_server(served):
    from langstream_tpu.serving.openai_api import OpenAIApiServer as JaxServer

    server, reference = served
    status, _, got = _post(server.port, {"model": "x"})
    assert status == 400 and got["error"]["message"] == "input is required"
    assert asyncio.run(reference._embeddings(_JsonRequest({"model": "x"}))).status == 400
    status, _, got = _post(server.port, None, raw=b"{not json")
    assert status == 400 and got["error"]["message"] == "invalid JSON body"
    status, _, _ = _post(server.port, {"input": 5})
    assert status == 400
    bare = OpenAIApiServer(None, model="tiny", host="127.0.0.1", port=0)
    bare.start()
    try:
        status, _, got = _post(bare.port, {"input": ["x"]})
    finally:
        bare.stop()
    assert status == 503 and got["error"]["message"] == "no embeddings service configured"
    jax_bare = asyncio.run(JaxServer(None, None)._embeddings(_JsonRequest({"input": ["x"]})))
    assert jax_bare.status == 503


class _Shedding(EmbeddingsService):
    async def compute_embeddings(self, texts):
        raise api_errors.QueueTimeoutError("shed at its queue deadline", retry_after_s=2.2)


def test_embeddings_route_answers_unavailable_with_the_typed_503():
    server = OpenAIApiServer(None, _Shedding(), host="127.0.0.1", port=0)
    server.start()
    try:
        status, headers, got = _post(server.port, {"input": "x"})
    finally:
        server.stop()
    assert status == 503 and headers["Retry-After"] == "3"
    assert got["error"]["type"] == "overloaded_error"


def test_serve_embeddings_checkpoint(bert_dirs):
    """``serve --embeddings-checkpoint DIR`` on the CPU: the tiny
    completions model, and ``/v1/embeddings`` from the BERT directory's
    weights and tokenizer, equal to the JAX service over it."""
    from langstream_tpu_torch.cli.main import build_parser, start_server

    path = bert_dirs["bin"]
    args = build_parser().parse_args([
        "serve", "--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--model", "tiny",
        "--max-slots", "2", "--max-seq-len", "64", "--decode-chunk", "4",
        "--embeddings-checkpoint", path,
    ])
    service, server = start_server(args)
    try:
        assert isinstance(server.embeddings, TorchEmbeddingsService)
        assert server.embeddings.embedder.device.type == "cpu"
        texts = ["stream card", "vector search agent"]
        status, _, got = _post(server.port, {"input": texts})
    finally:
        server.stop()
        service.close()
        server.embeddings.close()
    assert status == 200 and len(got["data"]) == 2
    reference = JaxEmbeddingsService({"embeddings-model": {"checkpoint": path}}, None)
    want = asyncio.run(reference.compute_embeddings(texts))
    np.testing.assert_allclose([d["embedding"] for d in got["data"]], want, rtol=0, atol=TOLERANCE)


def test_concurrent_embeds_equal_serial_ones():
    """More threads than cores call one embedder at once (its lock
    serialises the device calls): every result equals the serial one."""
    import sys
    import threading

    cfg = embeddings.EncoderConfig.tiny()
    port = embeddings.TorchEmbedder(cfg, embeddings.init_encoder_params(cfg, seed=4, device=CPU),
                                    tokenizer.ByteTokenizer(), device=CPU)
    rng = np.random.default_rng(4)
    batches = [_texts(rng, int(n)) for n in rng.integers(1, 9, 12)]
    want = [port.embed(batch) for batch in batches]
    got = [None] * len(batches)

    def work(i):
        got[i] = port.embed(batches[i])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(batches))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert got == want
