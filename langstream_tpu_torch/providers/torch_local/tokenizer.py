"""Tokenizers for the torch-local provider.

:class:`ByteTokenizer` is a dependency-free byte-level tokenizer (bytes
plus BOS/EOS/PAD specials) used by tests and random-weight serving, with
an incremental :class:`StreamDecoder` that buffers partial UTF-8 so
streamed chunks never split a multibyte character. A copy of the JAX
provider's; the HuggingFace tokenizer is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence


class StreamDecoder:
    """Incremental detokenizer: feed token ids, get printable text deltas."""

    def __init__(self, tokenizer: "ByteTokenizer") -> None:
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


def get_tokenizer(config: Optional[Dict[str, Any]]) -> Any:
    config = config or {}
    kind = config.get("type", "byte")
    if kind == "byte":
        return ByteTokenizer(config)
    if kind in ("huggingface", "hf"):
        raise NotImplementedError(
            "the HuggingFace tokenizer is not ported to langstream_tpu_torch "
            "yet (see ROADMAP.md)"
        )
    raise ValueError(f"unknown tokenizer type {kind!r}")
