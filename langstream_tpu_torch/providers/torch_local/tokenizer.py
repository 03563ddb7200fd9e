"""Tokenizers for the torch-local provider, copies of the JAX
provider's.

- :class:`ByteTokenizer`: a dependency-free byte-level tokenizer (bytes
  plus BOS/EOS/PAD specials) used by tests and random-weight serving.
- :class:`HFTokenizer`: a local HuggingFace tokenizer (Llama-3 etc.) and
  its chat template, through the ``transformers`` package, imported only
  when one is built.

Both expose ``encode``, ``decode``, ``apply_chat_template``, ``bos_id`` /
``eos_ids``, ``vocab_size`` and an incremental :class:`StreamDecoder`
that buffers partial UTF-8 so streamed chunks never split a multibyte
character.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence


class StreamDecoder:
    """Incremental detokenizer: feed token ids, get printable text deltas."""

    def __init__(self, tokenizer: Any) -> None:
        self.tokenizer = tokenizer
        self._pending: List[int] = []
        self._emitted = 0
        self._all: List[int] = []

    def push(self, token_id: int) -> str:
        self._all.append(token_id)
        text = self.tokenizer.decode(self._all)
        # only emit the complete (non-replacement-suffix) prefix
        if text.endswith("�"):
            stripped = text.rstrip("�")
        else:
            stripped = text
        delta = stripped[self._emitted:]
        self._emitted = len(stripped)
        return delta

    def flush(self) -> str:
        text = self.tokenizer.decode(self._all)
        delta = text[self._emitted:]
        self._emitted = len(text)
        return delta


class ByteTokenizer:
    """Bytes + BOS/EOS/PAD specials. Token i<256 is byte i."""

    BOS = 256
    EOS = 257
    PAD = 258

    def __init__(self, config: Optional[Dict[str, Any]] = None) -> None:
        self.vocab_size = 259

    @property
    def bos_id(self) -> int:
        return self.BOS

    @property
    def eos_ids(self) -> List[int]:
        return [self.EOS]

    @property
    def pad_id(self) -> int:
        return self.PAD

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        tokens = list(text.encode("utf-8"))
        return ([self.BOS] + tokens) if add_bos else tokens

    def decode(self, tokens: Sequence[int]) -> str:
        data = bytes(t for t in tokens if t < 256)
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: List[Dict[str, str]]) -> List[int]:
        parts = []
        for message in messages:
            parts.append(f"<|{message['role']}|>\n{message['content']}\n")
        parts.append("<|assistant|>\n")
        return self.encode("".join(parts))

    def stream_decoder(self) -> StreamDecoder:
        return StreamDecoder(self)


class HFTokenizer:
    """A local HuggingFace tokenizer (no network: ``local_files_only``)."""

    def __init__(self, path: str) -> None:
        try:
            from transformers import AutoTokenizer
        except ImportError as error:
            raise ImportError(
                "the HuggingFace tokenizer (tokenizer type 'hf') needs the `transformers` "
                "package, which is not installed"
            ) from error
        self._tk = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self._tk)

    @property
    def bos_id(self) -> int:
        return self._tk.bos_token_id

    @property
    def eos_ids(self) -> List[int]:
        ids = [self._tk.eos_token_id]
        # Llama-3 also stops on <|eot_id|>
        eot = self._tk.convert_tokens_to_ids("<|eot_id|>")
        if isinstance(eot, int) and eot >= 0 and eot != ids[0]:
            ids.append(eot)
        return [i for i in ids if i is not None]

    @property
    def pad_id(self) -> int:
        return self._tk.pad_token_id or 0

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        return self._tk.encode(text, add_special_tokens=add_bos)

    def decode(self, tokens: Sequence[int]) -> str:
        return self._tk.decode(tokens, skip_special_tokens=True)

    def apply_chat_template(self, messages: List[Dict[str, str]]) -> List[int]:
        return self._tk.apply_chat_template(messages, add_generation_prompt=True)

    def stream_decoder(self) -> StreamDecoder:
        return StreamDecoder(self)


def get_tokenizer(config: Optional[Dict[str, Any]]) -> Any:
    config = config or {}
    kind = config.get("type", "byte")
    if kind == "byte":
        return ByteTokenizer(config)
    if kind in ("huggingface", "hf"):
        return HFTokenizer(config["path"])
    raise ValueError(f"unknown tokenizer type {kind!r}")
