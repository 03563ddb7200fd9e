"""The AI service SPI the port's server and providers speak.

The port's own copy of ``langstream_tpu/api/service.py`` (the port
imports nothing of the JAX package): the completions data types, and the
service provider SPI (``ServiceProvider.java:24``,
``CompletionsService.java:22``, ``EmbeddingsService.java:24`` in the
reference): a provider resolves a completions service and an embeddings
service from a ``resources:`` config block.

One difference from the JAX package: ``close`` is a plain method. The
port's services are closed from the server's and ``serve``'s threads,
outside any event loop; the JAX ones are coroutines.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ChatMessage:
    """One chat turn (role + content)."""

    role: str
    content: str


@dataclasses.dataclass
class ChatChunk:
    """One streamed delta of a completion."""

    content: str
    index: int = 0


@dataclasses.dataclass
class ChatCompletionResult:
    """Final result of a (possibly streamed) completion."""

    content: str
    role: str = "assistant"
    finish_reason: str = "stop"
    prompt_tokens: int = 0
    completion_tokens: int = 0
    # per-token text pieces + log-probabilities (OpenAI-style logprobs)
    tokens: Optional[List[str]] = None
    logprobs: Optional[List[float]] = None
    # per-token top-K alternatives (OpenAI `top_logprobs`): one list of
    # (token text, logprob) pairs per generated token
    top_logprobs: Optional[List[List[Tuple[str, float]]]] = None



class CompletionsService(abc.ABC):
    """Chat + text completions (``CompletionsService.java:22``). A
    ``stream_consumer`` is any object with ``consume_chunk(answer_id,
    index, chunk, last)``."""

    # max top_logprobs alternatives this service can return per token
    # (0 = unsupported); the OpenAI HTTP layer validates requests against it
    top_logprobs_limit: int = 0

    @abc.abstractmethod
    async def get_chat_completions(
        self,
        messages: List[ChatMessage],
        options: Dict[str, Any],
        stream_consumer: Optional[Any] = None,
    ) -> ChatCompletionResult:
        ...

    async def get_text_completions(
        self,
        prompt: List[str],
        options: Dict[str, Any],
        stream_consumer: Optional[Any] = None,
    ) -> ChatCompletionResult:
        """Default: treat the prompt as a single user message."""
        messages = [ChatMessage("user", p) for p in prompt]
        return await self.get_chat_completions(messages, options, stream_consumer)

    def close(self) -> None:
        ...


class EmbeddingsService(abc.ABC):
    """Batch text → vectors (``EmbeddingsService.java:24``). Batched by
    contract: callers coalesce records into one call, so the card sees
    one padded batch."""

    @abc.abstractmethod
    async def compute_embeddings(self, texts: List[str]) -> List[List[float]]:
        ...

    def close(self) -> None:
        ...


class ServiceProvider(abc.ABC):
    """Resolves services from a resource config (``ServiceProvider.java:24``)."""

    name: str = ""

    @abc.abstractmethod
    def supports(self, resource_config: Dict[str, Any]) -> bool:
        """True when this provider owns the given ``resources:`` entry."""

    @abc.abstractmethod
    def get_completions_service(self, resource_config: Dict[str, Any]) -> CompletionsService:
        ...

    @abc.abstractmethod
    def get_embeddings_service(
        self, resource_config: Dict[str, Any], model: Optional[str] = None
    ) -> EmbeddingsService:
        ...

    def close(self) -> None:
        ...
