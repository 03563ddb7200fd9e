"""The port's HuggingFace tokenizer (``tokenizer.HFTokenizer``) against
the JAX package's, on the CPU.

A byte-level BPE tokenizer is trained in the test with the ``tokenizers``
package on text with multibyte characters, wrapped in
``PreTrainedTokenizerFast`` with Llama-3's BOS template and special tokens
(``<|begin_of_text|>``, ``<|end_of_text|>``, ``<|eot_id|>``) and a chat
template, and saved to a temporary directory. Both packages' wrappers
load it and must agree on ``encode``, ``decode``, ``apply_chat_template``,
``bos_id``, ``eos_ids`` and the stream decoder's deltas, which never
split a multibyte character.
"""

import sys

import pytest

from langstream_tpu.providers.jax_local import tokenizer as jax_tokenizer
from langstream_tpu_torch.providers.torch_local import tokenizer

CORPUS = [
    "The stream processor batches tokens on the card.",
    "Größe, Straße, café, naïve — déjà vu.",
    "日本語のテキストとストリーム処理。",
    "emoji 🚀🔥 and more 🎉 text",
    "Привет, мир! Как дела?",
] * 20

CHAT_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}"
    "<|start_header_id|>{{ message['role'] }}<|end_header_id|>\n\n"
    "{{ message['content'] }}<|eot_id|>{% endfor %}"
    "{% if add_generation_prompt %}<|start_header_id|>assistant<|end_header_id|>\n\n{% endif %}"
)

TEXTS = ["hello stream", "Größe café 日本語 🚀 Привет", "déjà vu 🎉🔥 テキスト"]
MESSAGES = [
    [{"role": "user", "content": "hello"}],
    [{"role": "system", "content": "Sei kurz."},
     {"role": "user", "content": "Größe 🚀?"},
     {"role": "assistant", "content": "日本語"},
     {"role": "user", "content": "и ещё?"}],
]


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, processors, trainers
    from transformers import PreTrainedTokenizerFast

    specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>",
                "<|start_header_id|>", "<|end_header_id|>"]
    bpe = Tokenizer(models.BPE())
    bpe.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    bpe.decoder = decoders.ByteLevel()
    bpe.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=400, special_tokens=specials,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    # Llama-3's: BOS before every encoded text
    bpe.post_processor = processors.TemplateProcessing(
        single="<|begin_of_text|> $A", special_tokens=[("<|begin_of_text|>", 0)])
    fast = PreTrainedTokenizerFast(
        tokenizer_object=bpe, bos_token="<|begin_of_text|>", eos_token="<|end_of_text|>",
        additional_special_tokens=specials[2:])
    fast.chat_template = CHAT_TEMPLATE
    path = tmp_path_factory.mktemp("hf-tokenizer")
    fast.save_pretrained(str(path))
    return str(path)


@pytest.fixture(scope="module")
def pair(tokenizer_dir):
    return (tokenizer.get_tokenizer({"type": "hf", "path": tokenizer_dir}),
            jax_tokenizer.get_tokenizer({"type": "hf", "path": tokenizer_dir}))


def test_specials_and_vocab_equal_jax(pair):
    port, jax = pair
    assert isinstance(port, tokenizer.HFTokenizer)
    assert port.vocab_size == jax.vocab_size
    assert port.bos_id == jax.bos_id and port.pad_id == jax.pad_id
    # Llama-3 stops on <|eot_id|> as well as on the eos token
    assert port.eos_ids == jax.eos_ids and len(port.eos_ids) == 2


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("add_bos", [True, False])
def test_encode_decode_equal_jax(pair, text, add_bos):
    port, jax = pair
    ids = port.encode(text, add_bos=add_bos)
    assert ids == jax.encode(text, add_bos=add_bos)
    assert (ids[0] == port.bos_id) == add_bos
    # special tokens are skipped: the text round-trips
    assert port.decode(ids) == jax.decode(ids) == text
    assert port.decode(ids + port.eos_ids) == text


@pytest.mark.parametrize("index", range(len(MESSAGES)))
def test_chat_template_equals_jax(pair, index):
    port, jax = pair
    ids = port.apply_chat_template(MESSAGES[index])
    assert ids == jax.apply_chat_template(MESSAGES[index])
    assert ids[0] == port.bos_id
    assert port.decode(ids).endswith("assistant\n\n")


@pytest.mark.parametrize("text", TEXTS)
def test_stream_decoder_equals_jax_on_multibyte_text(pair, text):
    """Token by token, the deltas equal JAX's, never end inside a
    character (no replacement character), and join to the text."""
    port, jax = pair
    ids = port.encode(text, add_bos=False)
    mine, theirs = port.stream_decoder(), jax.stream_decoder()
    deltas = []
    for token in ids:
        delta = mine.push(token)
        assert delta == theirs.push(token)
        assert "�" not in delta
        deltas.append(delta)
    deltas.append(mine.flush())
    assert deltas[-1] == theirs.flush()
    assert "".join(deltas) == text
    # some token of the multibyte texts is a partial character on its own
    if text != TEXTS[0]:
        assert any(delta == "" for delta in deltas[:-1])


def test_missing_transformers_raises_an_import_error(tokenizer_dir, monkeypatch):
    """No quiet fallback to the byte tokenizer: without ``transformers``
    the HF tokenizer raises an ImportError that names the package."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        tokenizer.get_tokenizer({"type": "hf", "path": tokenizer_dir})
    with pytest.raises(ValueError, match="unknown tokenizer type"):
        tokenizer.get_tokenizer({"type": "sentencepiece"})


def test_serve_a_checkpoint_with_its_tokenizer(tokenizer_dir, tmp_path):
    """``serve --checkpoint DIR --tokenizer DIR --logprobs-top-k 2`` on
    the CPU: a tiny Llama checkpoint over this tokenizer's vocabulary,
    written by ``chip_smoke.write_hf_checkpoint``, answers a chat through
    the chat template; its greedy answer, token count and alternatives
    equal the JAX provider's over the same two directories."""
    import asyncio
    import dataclasses
    import json
    import urllib.request

    import torch

    import chip_smoke
    from langstream_tpu.providers.jax_local.provider import JaxCompletionsService
    from langstream_tpu_torch.api.service import ChatMessage
    from langstream_tpu_torch.cli.main import build_parser, start_server
    from langstream_tpu_torch.providers.torch_local import model

    port = tokenizer.get_tokenizer({"type": "hf", "path": tokenizer_dir})
    config = dataclasses.replace(model.LlamaConfig.tiny(), vocab_size=port.vocab_size,
                                 dtype=torch.bfloat16)
    checkpoint = str(tmp_path / "checkpoint")
    chip_smoke.write_hf_checkpoint(checkpoint, config, model.init_params(config, seed=9))
    args = build_parser().parse_args([
        "serve", "--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--model", "my-llama",
        "--checkpoint", checkpoint, "--tokenizer", tokenizer_dir, "--logprobs-top-k", "2",
        "--max-slots", "2", "--max-seq-len", "128", "--decode-chunk", "4",
    ])
    service, api = start_server(args)
    reference = JaxCompletionsService({
        "checkpoint": checkpoint, "tokenizer": {"type": "hf", "path": tokenizer_dir},
        "engine": {"max-slots": 2, "max-seq-len": 128, "decode-chunk": 4, "supervisor": False,
                   "logprobs-top-k": 2}})
    messages = MESSAGES[1]
    try:
        assert isinstance(service.tokenizer, tokenizer.HFTokenizer)
        assert service.engine.config.vocab_size == port.vocab_size
        body = {"model": "my-llama", "messages": messages, "max_tokens": 8, "temperature": 0,
                "logprobs": True, "top_logprobs": 2}
        request = urllib.request.Request(
            f"http://127.0.0.1:{api.port}/v1/chat/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=120) as response:
            reply = json.loads(response.read())
        assert reply["model"] == "my-llama"
        assert reply["usage"]["prompt_tokens"] == len(port.apply_chat_template(messages))
        want = asyncio.run(reference.get_chat_completions(
            [ChatMessage(**m) for m in messages],
            {"max-tokens": 8, "logprobs": True, "top-logprobs": 2}))
        choice = reply["choices"][0]
        assert choice["message"]["content"] == want.content
        assert reply["usage"]["completion_tokens"] == want.completion_tokens
        got_tops = [[top["token"] for top in entry["top_logprobs"]]
                    for entry in choice["logprobs"]["content"]]
        assert got_tops == [[text for text, _ in tops] for tops in want.top_logprobs]
    finally:
        api.stop()
        service.engine.stop()
        asyncio.run(reference.close())
