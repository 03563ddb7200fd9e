"""The ``torch-local`` completions service: chat and text completions on
one GPU.

Port of ``JaxCompletionsService`` (``providers/jax_local/provider.py``).
Configuration, with the JAX provider's keys::

    model: {preset: "llama-3-8b"}      # or explicit dims; default "tiny"
    seed: 0                            # random-init weight seed
    engine: {max-slots: 16, max-seq-len: 4096, decode-chunk: 8,
             prefill-buckets: [64, 128], sampling-seed: 7,
             kv-layout: paged, kv-block-size: 16, kv-blocks: 4097,
             paged-kernel: fused, prefix-cache: true, kv-quant: int8,
             prefill-mode: mixed, prefill-chunk: 64, mixed-carry: on}

With no ``checkpoint`` the weights are random, drawn from ``seed`` on the
device (checkpoint loading is not ported yet and raises). ``kv-quant:
int8`` stores the KV cache as int8 with per-(position, kv head) scales on
either layout. ``prefill-mode: mixed`` (paged only) carries prompt windows
of up to ``prefill-chunk`` tokens in the decode step instead of separate
prefill calls; ``mixed-carry`` is accepted, as in the JAX provider's
configs, and ignored: the mixed-step carry chains on the pipelined decode
carry, which is not ported. The top-level
``quantization: int8`` (int8 weights) is not ported yet and raises rather
than serving bf16 weights. So does every other key that the JAX provider
honours and the port does not (:data:`UNPORTED_ENGINE_KEYS`,
:data:`UNPORTED_KEYS`) when it is set to anything but the JAX default.
"""

from __future__ import annotations

import logging
import secrets
import uuid
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.api.service import ChatChunk, ChatCompletionResult, ChatMessage
from langstream_tpu_torch.device import resolve_device
from langstream_tpu_torch.providers.torch_local import model as model_lib
from langstream_tpu_torch.providers.torch_local.engine import (
    DecodeEngine,
    SamplingParams,
)
from langstream_tpu_torch.providers.torch_local.tokenizer import get_tokenizer

logger = logging.getLogger(__name__)


def _on(value: Any) -> bool:
    return str(value).lower() in ("1", "true", "yes")


# Keys the JAX provider honours that the port does not serve yet (ROADMAP.md,
# Queue A), each with the test for a value other than the JAX default. Set,
# they raise: served as if absent, a config would get another engine than
# the one it asked for (``queue-timeout-s`` would never shed, ``mesh`` would
# not shard).
UNPORTED_ENGINE_KEYS = {
    "kv-host-blocks": lambda value: int(value or 0) != 0,
    "spec-decode": lambda value: str(value or "off").lower() != "off",
    "spec-k": lambda value: int(value or 4) != 4,
    "spec-ngram": lambda value: int(value or 2) != 2,
    "pipeline-decode": _on,
    "admission-chunk": bool,
    "logprobs-top-k": lambda value: int(value or 0) != 0,
    "queue-timeout-s": bool,
    "precompile": _on,
    "max-restarts": lambda value: int(value or 3) != 3,
    "restart-window-s": lambda value: float(value or 600.0) != 600.0,
}
UNPORTED_KEYS = {
    "slo": lambda value: any((value or {}).values()),  # JAX drops zero targets
    "mesh": bool,
}


def _refuse_unported(config: Dict[str, Any], engine_config: Dict[str, Any]) -> None:
    for keys, section, where in (
        (UNPORTED_KEYS, config, ""), (UNPORTED_ENGINE_KEYS, engine_config, "engine."),
    ):
        for key, is_set in keys.items():
            if is_set(section.get(key)):
                raise NotImplementedError(
                    f"{where}{key}: {section[key]!r} is not ported to langstream_tpu_torch "
                    f"yet (see ROADMAP.md, Queue A); omit it"
                )


def _buckets(value: Any) -> Optional[List[int]]:
    """Prefill buckets from config: a list, an int, or "128,256"."""
    if isinstance(value, str):
        return [int(b) for b in value.replace(",", " ").split()] or None
    if isinstance(value, int):
        return [value]
    if value:
        return [int(b) for b in value]
    return None


class TorchCompletionsService:
    """Completions over a :class:`DecodeEngine`; the surface the port's
    OpenAI server calls (``get_chat_completions`` /
    ``get_text_completions``). A ``stream_consumer`` is any object with
    ``consume_chunk(answer_id, index, chunk, last)``; it is called on the
    caller's event loop as deltas decode."""

    def __init__(self, config: Dict[str, Any], device: Any = "cuda") -> None:
        self.device = resolve_device(device)
        if config.get("checkpoint"):
            raise NotImplementedError(
                "checkpoint loading is not ported to langstream_tpu_torch yet "
                "(see ROADMAP.md); omit `checkpoint` for random weights"
            )
        quantization = config.get("quantization")
        if quantization == "int8":
            raise NotImplementedError(
                "quantization: int8 (int8 weight-only params) is not ported to "
                "langstream_tpu_torch yet (see ROADMAP.md, Queue A); omit it for bf16 weights"
            )
        if quantization:
            raise ValueError(f"unknown quantization {quantization!r}")
        engine_config = config.get("engine", {}) or {}
        _refuse_unported(config, engine_config)
        model_config = model_lib.LlamaConfig.from_dict(
            config.get("model", {"preset": "tiny"})
        )
        params = model_lib.init_params(
            model_config, seed=int(config.get("seed", 0)), device=self.device
        )
        logger.warning(
            "torch-local: no checkpoint configured — RANDOM weights "
            "(%.2fB params, benchmarking only)", model_config.num_params() / 1e9,
        )
        self.tokenizer = get_tokenizer(config.get("tokenizer"))
        if engine_config.get("sampling-seed") is not None:
            sampling_seed = int(engine_config["sampling-seed"])
        else:
            # real entropy by default, so unseeded requests differ across
            # processes
            sampling_seed = secrets.randbits(32)
        self.engine = DecodeEngine(
            model_config, params,
            device=self.device,
            max_slots=int(engine_config.get("max-slots", 8)),
            max_seq_len=(
                int(engine_config["max-seq-len"])
                if engine_config.get("max-seq-len") is not None else None
            ),
            prefill_buckets=_buckets(engine_config.get("prefill-buckets")),
            decode_chunk=int(engine_config.get("decode-chunk", 8)),
            seed=sampling_seed,
            # paged KV cache + persistent prefix-block pool (dense stays the
            # default); values may arrive as strings, like every engine knob
            kv_layout=str(engine_config.get("kv-layout") or "dense").lower(),
            kv_block_size=int(engine_config.get("kv-block-size") or 16),
            kv_blocks=(
                int(engine_config["kv-blocks"]) if engine_config.get("kv-blocks") else None
            ),
            paged_kernel=str(engine_config.get("paged-kernel") or "fused").lower(),
            prefix_cache=str(engine_config.get("prefix-cache", "true")).lower()
            not in ("0", "false", "no"),
            kv_quant=engine_config.get("kv-quant") or None,
            prefill_mode=str(engine_config.get("prefill-mode") or "split").lower(),
            prefill_chunk=int(engine_config.get("prefill-chunk") or 64),
        )
        self.engine.start()

    async def get_chat_completions(
        self,
        messages: List[ChatMessage],
        options: Dict[str, Any],
        stream_consumer: Optional[Any] = None,
    ) -> ChatCompletionResult:
        prompt_tokens = self.tokenizer.apply_chat_template(
            [{"role": m.role, "content": m.content} for m in messages]
        )
        return await self._generate(prompt_tokens, options, stream_consumer)

    async def get_text_completions(
        self,
        prompt: List[str],
        options: Dict[str, Any],
        stream_consumer: Optional[Any] = None,
    ) -> ChatCompletionResult:
        """Legacy text completions continue the prompt verbatim — no chat
        template."""
        prompt_tokens = self.tokenizer.encode("".join(prompt))
        return await self._generate(prompt_tokens, options, stream_consumer)

    async def _generate(
        self,
        prompt_tokens: List[int],
        options: Dict[str, Any],
        stream_consumer: Optional[Any] = None,
    ) -> ChatCompletionResult:
        sampling = SamplingParams(
            temperature=float(options.get("temperature") or 0.0),
            top_k=int(options.get("top-k") or 0),
            top_p=float(options.get("top-p") or 0.0),
            max_new_tokens=int(options.get("max-tokens") or 256),
            presence_penalty=float(options.get("presence-penalty") or 0.0),
            frequency_penalty=float(options.get("frequency-penalty") or 0.0),
            seed=int(options["seed"]) if options.get("seed") is not None else None,
            logit_bias=(
                {int(k): float(v) for k, v in options["logit-bias"].items()}
                if options.get("logit-bias") else None
            ),
        )
        # OpenAI-style stop STRINGS: generation is cancelled at the next
        # token boundary once one appears in the decoded text, and the
        # result is trimmed at the match
        stop = options.get("stop") or []
        if isinstance(stop, str):
            stop_strings = [stop]
        elif isinstance(stop, (list, tuple)):
            stop_strings = [str(s) for s in stop if s is not None and s != ""]
        else:
            stop_strings = [str(stop)]
        handle: list = []
        released_parts: list = []
        retained = [""]
        stop_cut: list = []
        holdback = max((len(s) for s in stop_strings), default=1) - 1

        def watch_stop(delta: str, final: bool = False) -> str:
            """On a stop match, cancel the request and release only the
            text BEFORE the match; withhold the last ``len(longest stop) -
            1`` chars until cleared so a stop split across two deltas never
            partially leaks into the stream."""
            if not stop_strings:
                return delta
            if stop_cut:
                return ""
            window = retained[0] + delta
            hits = [p for p in (window.find(s) for s in stop_strings) if p != -1]
            if hits:
                release = window[: min(hits)]
                retained[0] = ""
                stop_cut.append(True)
                if handle:
                    handle[0].cancel()
            elif final:
                release = window
                retained[0] = ""
            else:
                keep = min(holdback, len(window))
                release = window[: len(window) - keep]
                retained[0] = window[len(window) - keep:]
            if release:
                released_parts.append(release)
            return release

        answer_id = uuid.uuid4().hex
        on_token = None
        decoder = None
        index_box = [0]
        last_sent = [False]
        if stream_consumer is not None:
            decoder = self.tokenizer.stream_decoder()

            def on_token(token_id: int, is_last: bool) -> None:
                text = decoder.push(token_id)
                if is_last:
                    text += decoder.flush()
                text = watch_stop(text, final=is_last)
                if text or is_last:
                    index = index_box[0]
                    index_box[0] += 1
                    if is_last:
                        last_sent[0] = True
                    stream_consumer.consume_chunk(
                        answer_id, index, ChatChunk(content=text, index=index),
                        last=is_last,
                    )

        elif stop_strings:
            plain_decoder = self.tokenizer.stream_decoder()

            def on_token(token_id: int, is_last: bool) -> None:
                watch_stop(plain_decoder.push(token_id))

        result = await self.engine.generate(
            prompt_tokens, sampling,
            stop_tokens=set(self.tokenizer.eos_ids),
            on_token=on_token,
            handle=handle,
        )
        if stop_cut:
            text = "".join(released_parts)
        else:
            text = self.tokenizer.decode(result.tokens)
        stop_trimmed = False
        if stop_strings and not stop_cut:
            for s in stop_strings:
                cut = text.find(s)
                if cut != -1:
                    text = text[:cut]
                    stop_trimmed = True
        kept_tokens, kept_logprobs = result.tokens, result.logprobs
        if stop_cut or stop_trimmed:
            # drop the tokens past the stop so per-token data aligns with
            # the trimmed content
            walker = self.tokenizer.stream_decoder()
            length = kept = 0
            for token in result.tokens:
                length += len(walker.push(token))
                if length > len(text):
                    break
                kept += 1
            kept_tokens = result.tokens[:kept]
            kept_logprobs = result.logprobs[:kept]
        if stream_consumer is not None and not last_sent[0]:
            # terminal marker when the stop token arrived without a
            # trailing streamed delta
            tail = watch_stop(decoder.flush(), final=True)
            stream_consumer.consume_chunk(
                answer_id, index_box[0],
                ChatChunk(content=tail, index=index_box[0]), last=True,
            )
        want_logprobs = bool(options.get("logprobs"))
        finish_reason = "stop" if (stop_cut or stop_trimmed) else result.finish_reason
        return ChatCompletionResult(
            content=text,
            finish_reason=finish_reason,
            prompt_tokens=result.prompt_tokens,
            completion_tokens=len(kept_tokens),
            tokens=(
                [self.tokenizer.decode([t]) for t in kept_tokens]
                if want_logprobs else None
            ),
            logprobs=list(kept_logprobs) if want_logprobs else None,
        )
