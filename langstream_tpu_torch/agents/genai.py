"""The GenAI toolkit agent: executes a list of declarative steps.

Equivalent of the reference's ``GenAIToolKitAgent``
(``langstream-agents/langstream-ai-agents/src/main/java/ai/langstream/ai/agents/GenAIToolKitAgent.java:53``)
and its step implementations under ``com/datastax/oss/streaming/ai/``
(dispatch table ``util/TransformFunctionUtil.java:166-216``). The planner
compiles every declarative step type (``drop-fields``, ``compute``,
``ai-chat-completions``, ...) into one node of this executor with a
``steps`` list; each step mutates a :class:`TransformContext` and may carry
a ``when`` predicate.

Streaming parity (``ChatCompletionsStep.java:42,126-190``): chunk records
copy the source context, set ``stream-id`` / ``stream-index`` /
``stream-last-message`` headers, write the delta into
``stream-response-completion-field`` (or ``completion-field``) and go to
``stream-to-topic`` immediately; the final full answer lands in
``completion-field`` on the main record. Exponential chunk batching
(1, 2, 4, ... up to ``min-chunks-per-message``,
``OpenAICompletionService.java:126,290-300``) is implemented here on the
caller side so every provider streams identically.

The port's own copy of ``langstream_tpu/agents/genai.py``, every step
type of it: the model-free steps, ``ai-chat-completions`` and
``ai-text-completions`` over the ``torch-local`` service (its engine
thread posts each token back to the agent's event loop, where the batcher
emits chunk records), ``compute-ai-embeddings`` (records micro-batched
through :class:`~langstream_tpu_torch.runtime.batching.BatchExecutor`
into one encoder call on the card) and ``query`` (a datasource of the
app's ``resources:``, on the app's device).
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.api.agent import SingleRecordProcessor
from langstream_tpu_torch.api.records import Record
from langstream_tpu_torch.api.service import ChatChunk, ChatMessage
from langstream_tpu_torch.agents.el import Expression, render_template
from langstream_tpu_torch.agents.transform import TransformContext
from langstream_tpu_torch.runtime.batching import BatchExecutor
from langstream_tpu_torch.runtime.tracing import TRACE_ID_HEADER

logger = logging.getLogger(__name__)


class Step:
    """One transform step; subclasses mutate the context in ``apply``."""

    def __init__(self, config: Dict[str, Any], agent: "GenAIToolKitAgent") -> None:
        self.config = config
        self.agent = agent
        when = config.get("when")
        self._when = Expression(when) if when else None

    async def start(self) -> None:
        ...

    async def close(self) -> None:
        ...

    def should_apply(self, ctx: TransformContext) -> bool:
        if self._when is None:
            return True
        return bool(self._when.evaluate(ctx.el_context()))

    async def apply(self, ctx: TransformContext) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------- #
# structural steps (CastStep, DropStep, DropFieldStep, FlattenStep,
# MergeKeyValueStep, UnwrapKeyValueStep, ComputeStep in the reference)
# ---------------------------------------------------------------------- #
class DropStep(Step):
    async def apply(self, ctx: TransformContext) -> None:
        ctx.dropped = True


class DropFieldsStep(Step):
    async def apply(self, ctx: TransformContext) -> None:
        part = self.config.get("part")  # None = both, like the reference
        for field in self.config.get("fields", []):
            if "." in field:
                ctx.delete_field(field)
                continue
            if part in (None, "value"):
                ctx.delete_field(f"value.{field}")
            if part in (None, "key"):
                ctx.delete_field(f"key.{field}")


class MergeKeyValueStep(Step):
    async def apply(self, ctx: TransformContext) -> None:
        key = ctx._structured(ctx.key)
        value = ctx._structured(ctx.value)
        if isinstance(key, dict) and isinstance(value, dict):
            ctx.value = {**key, **value}


class UnwrapKeyValueStep(Step):
    async def apply(self, ctx: TransformContext) -> None:
        if self.config.get("unwrapKey", self.config.get("unwrap-key", False)):
            ctx.value = ctx.key
        # else: value stays the value (drops the key pairing)
        ctx.key = None


class CastStep(Step):
    async def apply(self, ctx: TransformContext) -> None:
        schema_type = self.config.get("schema-type", "string")
        part = self.config.get("part", "value")
        current = ctx.get_field(part)
        ctx.set_field(part, _cast(current, schema_type))


def _cast(value: Any, schema_type: str) -> Any:
    if value is None:
        return None
    # the reference's type names are case-insensitive in practice: compute
    # fields use upper-case (ComputeFieldType.java:19, examples use
    # `type: STRING`) while cast uses lower-case schema-type values
    schema_type = str(schema_type).lower()
    if schema_type == "string":
        if isinstance(value, (dict, list)):
            return json.dumps(value, ensure_ascii=False, default=str)
        if isinstance(value, bytes):
            return value.decode("utf-8", errors="replace")
        return str(value)
    if schema_type in ("int32", "int64", "int"):
        return int(float(value))
    if schema_type in ("float", "double"):
        return float(value)
    if schema_type == "boolean":
        if isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes")
        return bool(value)
    if schema_type == "bytes":
        return value if isinstance(value, bytes) else str(value).encode("utf-8")
    if schema_type == "json":
        return json.loads(value) if isinstance(value, (str, bytes)) else value
    raise ValueError(f"unknown schema-type {schema_type!r}")


class FlattenStep(Step):
    async def apply(self, ctx: TransformContext) -> None:
        delimiter = self.config.get("delimiter", "_")
        part = self.config.get("part")
        if part in (None, "value"):
            value = ctx._structured(ctx.value)
            if isinstance(value, dict):
                ctx.value = _flatten(value, delimiter)
        if part in (None, "key"):
            key = ctx._structured(ctx.key)
            if isinstance(key, dict):
                ctx.key = _flatten(key, delimiter)


def _flatten(mapping: Dict[str, Any], delimiter: str, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in mapping.items():
        full = f"{prefix}{delimiter}{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flatten(value, delimiter, full))
        else:
            out[full] = value
    return out


class ComputeStep(Step):
    def __init__(self, config, agent) -> None:
        super().__init__(config, agent)
        self._fields = []
        for field in config.get("fields", []):
            self._fields.append(
                (
                    field["name"],
                    Expression(str(field["expression"])),
                    field.get("type"),
                    field.get("optional", False),
                )
            )

    async def apply(self, ctx: TransformContext) -> None:
        el_ctx = ctx.el_context()
        computed = []
        for name, expression, field_type, optional in self._fields:
            value = expression.evaluate(el_ctx)
            if value is None and optional:
                continue
            if field_type:
                value = _cast(value, field_type)
            computed.append((name, value))
        for name, value in computed:
            ctx.set_field(name, value)


# ---------------------------------------------------------------------- #
# AI steps
# ---------------------------------------------------------------------- #
class ComputeAIEmbeddingsStep(Step):
    """Micro-batched embeddings (``ComputeAIEmbeddingsStep.java:46``):
    records coalesce through a batch executor into one padded encoder
    call; per-key ordering is the runner's concern, batching is ours."""

    def __init__(self, config, agent) -> None:
        super().__init__(config, agent)
        self.text_template = config.get("text", "{{ value }}")
        self.embeddings_field = config.get("embeddings-field", "value.embeddings")
        self.model = config.get("model")
        self.batch_size = int(config.get("batch-size", 10))
        # reference default flush-interval: 0 = immediate; a small linger
        # lets concurrent records of one poll coalesce
        self.flush_interval = float(config.get("flush-interval", 0.01))
        self._executor: Optional[BatchExecutor] = None
        self._service = None
        self._calls = self._texts = None

    async def start(self) -> None:
        registry = self.agent.service_registry()
        self._service = registry.embeddings(
            self.config.get("ai-service"), model=self.model
        )
        self._executor = BatchExecutor(
            self.batch_size, self._process_batch, flush_interval=self.flush_interval
        )
        # the encoder's calls and texts on the agent's /metrics (the port's own)
        metrics = getattr(getattr(self.agent, "context", None), "metrics", None)
        if metrics is not None:
            self._calls = metrics.counter("embeddings_calls")
            self._texts = metrics.counter("embeddings_texts")

    async def _process_batch(self, items: List[Any]) -> None:
        texts = [text for text, _future in items]
        if self._calls is not None:
            self._calls.count()
            self._texts.count(len(texts))
        try:
            vectors = await self._service.compute_embeddings(texts)
            if len(vectors) != len(items):
                raise ValueError(
                    f"embeddings service returned {len(vectors)} vectors "
                    f"for {len(items)} texts"
                )
            for (_text, future), vector in zip(items, vectors):
                if not future.done():
                    future.set_result(vector)
        except asyncio.CancelledError:
            for _text, future in items:
                future.cancel()
            raise
        except Exception as error:  # noqa: BLE001 — routed to every record of the batch
            for _text, future in items:
                if not future.done():
                    future.set_exception(error)

    async def apply(self, ctx: TransformContext) -> None:
        text = render_template(self.text_template, ctx.el_context())
        future = asyncio.get_running_loop().create_future()
        await self._executor.add((text, future))
        vector = await future
        ctx.set_field(self.embeddings_field, vector)

    async def close(self) -> None:
        if self._executor is not None:
            await self._executor.close()


class QueryStep(Step):
    """Datasource query (``QueryStep.java:35``): ``fields`` evaluate to
    params, results land in ``output-field``."""

    def __init__(self, config, agent) -> None:
        super().__init__(config, agent)
        self.query = config["query"]
        self.output_field = config.get("output-field", "value.query-result")
        self.only_first = bool(config.get("only-first", False))
        self.mode = config.get("mode", "query")  # query | execute
        self._fields = [Expression(f) for f in config.get("fields", [])]
        self._datasource = None

    async def start(self) -> None:
        self._datasource = self.agent.datasource_registry().resolve(
            self.config.get("datasource", "datasource")
        )

    async def apply(self, ctx: TransformContext) -> None:
        el_ctx = ctx.el_context()
        params = [f.evaluate(el_ctx) for f in self._fields]
        if self.mode == "execute":
            result: Any = await self._datasource.execute(self.query, params)
        else:
            rows = await self._datasource.query(self.query, params)
            result = rows[0] if (self.only_first and rows) else rows
        ctx.set_field(self.output_field, result)


class _ChunkBatcher:
    """Exponential chunk batching: emit after 1, 2, 4, ... accumulated
    chunks up to ``min_chunks``, then every ``min_chunks``
    (``OpenAICompletionService.java:126,290-300``)."""

    def __init__(self, min_chunks: int, emit) -> None:
        self.min_chunks = max(1, min_chunks)
        self.emit = emit  # (answer_id, index, text, last) -> None
        self._threshold = 1
        self._buffer: List[str] = []
        self._out_index = 0

    def consume_chunk(self, answer_id: str, index: int, chunk: ChatChunk, last: bool) -> None:
        self._buffer.append(chunk.content)
        if last or len(self._buffer) >= self._threshold:
            text = "".join(self._buffer)
            self._buffer = []
            if self._threshold < self.min_chunks:
                self._threshold = min(self._threshold * 2, self.min_chunks)
            if text or last:
                self.emit(answer_id, self._out_index, text, last)
                self._out_index += 1


class ChatCompletionsStep(Step):
    """``ChatCompletionsStep.java:42`` — prompt templating, streaming, and
    result/log field mapping."""

    KIND = "chat"

    def __init__(self, config, agent) -> None:
        super().__init__(config, agent)
        self.completion_field = config.get("completion-field", "value")
        self.log_field = config.get("log-field")
        self.stream_to_topic = config.get("stream-to-topic")
        self.stream_response_field = config.get("stream-response-completion-field")
        self.min_chunks = int(config.get("min-chunks-per-message", 20))
        self.want_logprobs = bool(config.get("logprobs"))
        self.logprobs_field = config.get("logprobs-field", "value.logprobs")
        self.tokens_field = config.get("tokens-field", "value.tokens")
        self.messages = config.get("messages", [])
        self.prompt = config.get("prompt", [])
        self._service = None
        self._stream_producer = None
        self._options = {
            key: config.get(key)
            for key in (
                "model", "max-tokens", "temperature", "top-p", "top-k",
                "stop", "presence-penalty", "frequency-penalty", "seed",
                "logit-bias",
                "session-field",
            )
            if config.get(key) is not None
        }

    async def start(self) -> None:
        registry = self.agent.service_registry()
        self._service = registry.completions(self.config.get("ai-service"))
        if self.stream_to_topic:
            self._stream_producer = self.agent.topic_producer(self.stream_to_topic)
            await self._stream_producer.start()

    async def close(self) -> None:
        if self._stream_producer is not None:
            await self._stream_producer.close()

    def _render_messages(self, el_ctx: Dict[str, Any]) -> List[ChatMessage]:
        if self.KIND == "chat":
            return [
                ChatMessage(
                    role=m.get("role", "user"),
                    content=render_template(m.get("content", ""), el_ctx),
                )
                for m in self.messages
            ]
        prompts = self.prompt if isinstance(self.prompt, list) else [self.prompt]
        return [ChatMessage("user", render_template(p, el_ctx)) for p in prompts]

    async def apply(self, ctx: TransformContext) -> None:
        el_ctx = ctx.el_context()
        messages = self._render_messages(el_ctx)
        consumer = None
        loop = asyncio.get_running_loop()
        stream_tasks: List[asyncio.Task] = []
        if self._stream_producer is not None:

            def emit(answer_id: str, index: int, text: str, last: bool) -> None:
                chunk_record = self._make_chunk_record(ctx, answer_id, index, text, last)
                stream_tasks.append(
                    loop.create_task(self._stream_producer.write(chunk_record))
                )

            consumer = _ChunkBatcher(self.min_chunks, emit)

        options = dict(self._options)
        options["min-chunks-per-message"] = self.min_chunks
        if self.want_logprobs:
            options["logprobs"] = True
        # session affinity for KV-cache reuse (BASELINE config #5): the
        # gateway's session header, else the record key (broker partitioning
        # by key then gives replica affinity too)
        session = ctx.properties.get("langstream-client-session-id")
        if session is None and ctx.record.key is not None:
            session = str(ctx.record.key)
        if session is not None:
            options["session-id"] = session
        # end-to-end trace context: the gateway's trace header rides the
        # record into the engine's per-request spans (TTFT/TPOT land in
        # the same timeline as the gateway/runner spans)
        trace_id = ctx.properties.get(TRACE_ID_HEADER)
        if trace_id:
            options["trace-id"] = str(trace_id)
        if self.KIND == "text":
            # verbatim continuation, no chat template (reference:
            # TextCompletionsStep calls getTextCompletions)
            result = await self._service.get_text_completions(
                [m.content for m in messages], options, consumer
            )
        else:
            result = await self._service.get_chat_completions(
                messages, options, consumer
            )
        for task in stream_tasks:
            await task
        ctx.set_field(self.completion_field, result.content)
        if self.want_logprobs and result.logprobs is not None:
            # OpenAI-style logprobs surface: the flare-controller's
            # tokens-field/logprobs-field defaults resolve against these
            ctx.set_field(self.tokens_field, list(result.tokens or []))
            ctx.set_field(self.logprobs_field, list(result.logprobs))
        if self.log_field:
            ctx.set_field(
                self.log_field,
                json.dumps(
                    {
                        "model": self._options.get("model"),
                        "options": {k: v for k, v in options.items()},
                        "messages": [
                            {"role": m.role, "content": m.content} for m in messages
                        ],
                    },
                    ensure_ascii=False,
                ),
            )

    def _make_chunk_record(
        self, ctx: TransformContext, answer_id: str, index: int, text: str, last: bool
    ) -> Record:
        # deep-copy the context per chunk (ChatCompletionsStep.java:139-150):
        # chunk records must not alias the live value dict of the main record
        import copy as _copymod

        copy = TransformContext(ctx.record)
        copy.key = _copymod.deepcopy(ctx.key)
        copy.value = _copymod.deepcopy(ctx.value)
        copy.properties = dict(ctx.properties)
        copy.properties["stream-id"] = answer_id
        copy.properties["stream-index"] = str(index)
        copy.properties["stream-last-message"] = str(last).lower()
        field = self.stream_response_field or self.completion_field
        copy.set_field(field, text)
        return copy.to_record()


class TextCompletionsStep(ChatCompletionsStep):
    """``ai-text-completions``: prompt list instead of chat messages."""

    KIND = "text"

    async def apply(self, ctx: TransformContext) -> None:
        await super().apply(ctx)


_STEP_TYPES = {
    "drop": DropStep,
    "drop-fields": DropFieldsStep,
    "merge-key-value": MergeKeyValueStep,
    "unwrap-key-value": UnwrapKeyValueStep,
    "cast": CastStep,
    "flatten": FlattenStep,
    "compute": ComputeStep,
    "ai-chat-completions": ChatCompletionsStep,
    "ai-text-completions": TextCompletionsStep,
    "compute-ai-embeddings": ComputeAIEmbeddingsStep,
    "query": QueryStep,
}


class GenAIToolKitAgent(SingleRecordProcessor):
    """Executes the compiled ``steps`` list for each record."""

    agent_type = "ai-tools"
    agent_id = "ai-tools"

    def __init__(self) -> None:
        self.steps: List[Step] = []
        self._service_registry = None
        self._datasource_registry = None

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.configuration = configuration
        for step_config in configuration.get("steps", []):
            step_type = step_config.get("type")
            step_cls = _STEP_TYPES.get(step_type)
            if step_cls is None:
                raise ValueError(
                    f"unknown GenAI step type {step_type!r}; "
                    f"known: {sorted(_STEP_TYPES)}"
                )
            self.steps.append(step_cls(step_config, self))

    async def start(self) -> None:
        for step in self.steps:
            await step.start()

    async def close(self) -> None:
        for step in self.steps:
            await step.close()
        if self._datasource_registry is not None:
            await self._datasource_registry.close()

    # -- wiring helpers used by steps --------------------------------- #
    def service_registry(self):
        if self._service_registry is None:
            from langstream_tpu_torch.providers.registry import ServiceProviderRegistry

            resources = getattr(self.context, "resources", {}) or {}
            shared = getattr(self.context, "service_provider_registry", None)
            self._service_registry = shared or ServiceProviderRegistry(resources)
        return self._service_registry

    def datasource_registry(self):
        """The datasources of the app's ``resources:``, on the app's device."""
        if self._datasource_registry is None:
            from langstream_tpu_torch.agents.datasource import context_registry

            self._datasource_registry = context_registry(self.context)
        return self._datasource_registry

    def topic_producer(self, topic: str):
        connections = getattr(self.context, "topic_connections", None)
        if connections is None:
            raise ValueError(
                "stream-to-topic requires a topic runtime in the agent context"
            )
        return connections.create_producer(self.agent_id, {"topic": topic})

    def agent_info(self) -> Dict[str, Any]:
        return {
            "agent-id": self.agent_id,
            "agent-type": self.agent_type,
            "component-type": "processor",
            "steps": [s.config.get("type") for s in self.steps],
        }

    # -- record path --------------------------------------------------- #
    async def process_record(self, record: Record) -> List[Record]:
        ctx = TransformContext(record)
        for step in self.steps:
            if not step.should_apply(ctx):
                continue
            await step.apply(ctx)
            if ctx.dropped:
                return []
        out = ctx.to_record()
        if ctx.destination_topic:
            out = out.with_header("langstream-destination", ctx.destination_topic)
        return [out]
