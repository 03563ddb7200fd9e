"""The completions service surface the port's server speaks.

The port's own copy of the data types of ``langstream_tpu/api/service.py``
that the completions path needs (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


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

