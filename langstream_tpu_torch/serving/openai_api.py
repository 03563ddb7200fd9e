"""OpenAI-compatible HTTP serving surface over the port's completions
and embeddings services, on the standard library's ``ThreadingHTTPServer``.

Port of ``langstream_tpu/serving/openai_api.py`` (an aiohttp app there):

- ``POST /v1/chat/completions`` — messages in, completion out; with
  ``"stream": true`` the answer arrives as SSE ``data:`` chunks in the
  OpenAI chunk format, terminated by ``data: [DONE]``.
- ``POST /v1/completions`` — prompt in (legacy text completions).
- ``POST /v1/embeddings`` — ``input`` (a string or a list) in, one vector
  per input out, from the injected embeddings service; 503 "no
  embeddings service configured" without one.
- ``GET /v1/models`` and ``GET /healthz``.
- ``GET /metrics`` — Prometheus text from the injected ``gauges`` and
  ``histograms`` providers (``serve`` injects the engine's
  ``engines_snapshot`` / ``engines_histograms``: the engine gauges, MFU
  and MBU, the goodput ledger, the SLO burn rates and blame, the latency
  and journey-stage histograms, the supervisor's recovery series, the
  sheds and the watchdog's trips).
- ``GET /debug/profile?seconds=N`` — one ``torch.profiler`` capture of N
  seconds (default 3, at most 60) while serving goes on
  (``runtime/tracing.capture``): ``{"path", "seconds"}`` names the
  directory holding ``trace.json`` and ``device_memory.json``; 400 on a
  bad ``seconds``, 409 while another capture runs.

A completion's trace id is the client's ``x-langstream-trace-id`` header,
else the body's ``trace_id``, else one minted here; it reaches the engine
as the ``trace-id`` option (the request's spans and journey carry it) and
is echoed in the response's ``x-langstream-trace-id`` header.

A typed :class:`~langstream_tpu_torch.api.errors.UnavailableError` (the
engine rebuilding after a crash, a request shed at its queue deadline)
answers 503 with ``Retry-After``, never 500: while the service's
``available()`` says it rebuilds, a request is refused before any work;
a streamed request sends its SSE headers only with its first delta, so
a stream shed before it started gets the 503 too. With ``n`` > 1 the
first real error among the choices reaches the client, not a sibling's
cancellation.

``logprobs`` returns each token's logprob; ``top_logprobs: n`` (with
``logprobs: true``, n at most the service's ``top_logprobs_limit``, the
engine's ``logprobs-top-k``) adds its n most likely alternatives: in the
chat format a ``logprobs.content`` entry per token, in the legacy text
format a ``{token: logprob}`` dict per token. A text completion's integer
``logprobs: K`` asks for K alternatives, clamped to the limit. A streamed
chat carries the ``logprobs.content`` entries in its final chunk.

Each request runs on its own handler thread, which drives the service's
coroutines on a private event loop (``asyncio.run``); the engine thread
posts tokens onto that loop.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from langstream_tpu_torch.api import errors as api_errors
from langstream_tpu_torch.api.metrics import prometheus_text
from langstream_tpu_torch.api.service import ChatMessage
from langstream_tpu_torch.runtime import tracing

logger = logging.getLogger(__name__)


def _sse(payload: Dict[str, Any]) -> bytes:
    return b"data: " + json.dumps(payload, ensure_ascii=False).encode() + b"\n\n"


def _chat_logprobs_content(result, n_top: int) -> List[Dict[str, Any]]:
    """The chat format's ``logprobs.content``: one entry per token with
    its ``n_top`` ranked alternatives."""
    return [
        {"token": token, "logprob": logprob,
         "top_logprobs": [{"token": text, "logprob": value} for text, value in tops[:n_top]]}
        for token, logprob, tops in zip(result.tokens, result.logprobs, result.top_logprobs)
    ]


def _logprobs_block(result, options: Dict[str, Any], chat: bool) -> Dict[str, Any]:
    """A choice's ``logprobs``: the tokens and their logprobs, with the
    alternatives the request asked for."""
    block: Dict[str, Any] = {"tokens": result.tokens, "token_logprobs": result.logprobs}
    n_top = int(options.get("top-logprobs") or 0)
    if result.top_logprobs is None or n_top <= 0:
        return block
    if chat:
        block["content"] = _chat_logprobs_content(result, n_top)
    else:
        # legacy text format: a {token: logprob} dict per position. Two ids
        # may decode to the same text: the first (higher-ranked) one keeps
        # its logprob, so a dict may hold fewer than n_top keys
        legacy = []
        for tops in result.top_logprobs:
            row: Dict[str, float] = {}
            for text, value in tops[:n_top]:
                row.setdefault(text, value)
            legacy.append(row)
        block["top_logprobs"] = legacy
    return block


def _options_from_request(body: Dict[str, Any], model: str, topk_limit: int = 0) -> Dict[str, Any]:
    """OpenAI request params → service option names. Raises ValueError
    (→ HTTP 400) on malformed values so bad requests fail BEFORE burning a
    generation."""
    options: Dict[str, Any] = {"model": body.get("model") or model}
    if body.get("top_logprobs") is not None:
        try:
            n_top = int(body["top_logprobs"])
        except (TypeError, ValueError):
            raise ValueError("top_logprobs must be an integer") from None
        if not 0 <= n_top <= 20:
            raise ValueError("top_logprobs must be between 0 and 20")
        if n_top > 0 and not body.get("logprobs"):
            raise ValueError("top_logprobs requires logprobs: true")
        if n_top > topk_limit:
            raise ValueError(
                f"top_logprobs={n_top} exceeds this server's limit of {topk_limit} (start the "
                f"server with --logprobs-top-k >= {n_top})")
        body = dict(body, top_logprobs=n_top)
    mapping = {
        "temperature": "temperature",
        "top_p": "top-p",
        "top_k": "top-k",
        "max_tokens": "max-tokens",
        "max_completion_tokens": "max-tokens",
        "stop": "stop",
        "presence_penalty": "presence-penalty",
        "frequency_penalty": "frequency-penalty",
        "logprobs": "logprobs",
        "top_logprobs": "top-logprobs",
        "seed": "seed",
    }
    if body.get("logit_bias") is not None:
        if not isinstance(body["logit_bias"], dict):
            raise ValueError("logit_bias must be an object of id -> bias")
        options["logit-bias"] = {
            int(k): float(v) for k, v in body["logit_bias"].items()
        }
    for source, target in mapping.items():
        if body.get(source) is not None:
            options[target] = body[source]
    # KV-cache affinity: the explicit session_id, else the OpenAI `user`
    # field (stable per end user)
    session = body.get("session_id") or body.get("user")
    if session:
        options["session-id"] = str(session)
    return options


class _HTTPServer(ThreadingHTTPServer):
    # the JAX server's listen backlog (aiohttp's TCPSite default): a burst
    # of concurrent clients overflows http.server's default of 5, and an
    # overflowed connection may be reset before it is served
    request_queue_size = 128
    daemon_threads = True


class OpenAIApiServer:
    """Serves the OpenAI surface for one model from a background thread."""

    def __init__(
        self,
        completions,
        embeddings=None,
        *,
        model: str = "torch-local",
        host: str = "0.0.0.0",
        port: int = 8000,
        gauges=None,       # () -> Dict[str, float], rendered on /metrics
        histograms=None,   # () -> Dict[str, Dict[str, float]]
    ) -> None:
        self.completions = completions
        self.embeddings = embeddings
        self._gauges = gauges
        self._histograms = histograms
        # the most top_logprobs alternatives the service keeps (0 = none)
        self._topk_limit = int(getattr(completions, "top_logprobs_limit", 0) or 0)
        self.model = model
        self.host = host
        self.port = port
        self._httpd: Optional[_HTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 — http.server API
                server._get(self)

            def do_POST(self) -> None:  # noqa: N802 — http.server API
                server._post(self)

            def log_message(self, fmt: str, *args: Any) -> None:
                logger.debug("%s " + fmt, self.address_string(), *args)

        self._httpd = _HTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="openai-api", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def serve_forever(self) -> None:
        """Block until the server thread ends (KeyboardInterrupt stops)."""
        try:
            while self._thread is not None and self._thread.is_alive():
                self._thread.join(timeout=1.0)
        finally:
            self.stop()

    # ------------------------------------------------------------------ #
    @staticmethod
    def _json(handler: BaseHTTPRequestHandler, status: int, payload: Dict[str, Any],
              headers: Optional[Dict[str, str]] = None) -> None:
        data = json.dumps(payload, ensure_ascii=False).encode()
        handler.send_response(status)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(data)))
        for name, value in (headers or {}).items():
            handler.send_header(name, value)
        handler.end_headers()
        handler.wfile.write(data)

    def _error(self, handler, status: int, message: str) -> None:
        self._json(handler, status, {"error": {
            "message": message,
            "type": "invalid_request_error" if status == 400 else "server_error",
        }})

    @staticmethod
    def _unavailable(handler, message: str, retry_after_s: float) -> None:
        """A bounded 503 with ``Retry-After`` (whole seconds, at least 1):
        the engine rebuilds, or the queue shed the request."""
        data = json.dumps({"error": {"message": message, "type": "overloaded_error"}}).encode()
        handler.send_response(503)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(data)))
        handler.send_header("Retry-After", str(max(1, math.ceil(retry_after_s))))
        handler.end_headers()
        handler.wfile.write(data)

    def _get(self, handler: BaseHTTPRequestHandler) -> None:
        if handler.path == "/metrics":
            data = prometheus_text(
                {}, self._gauges() if self._gauges else {},
                self._histograms() if self._histograms else {}).encode()
            handler.send_response(200)
            handler.send_header("Content-Type", "text/plain; version=0.0.4")
            handler.send_header("Content-Length", str(len(data)))
            handler.end_headers()
            handler.wfile.write(data)
        elif handler.path == "/healthz":
            self._json(handler, 200, {"status": "ok", "model": self.model})
        elif handler.path == "/v1/models":
            self._json(handler, 200, {"object": "list", "data": [{
                "id": self.model, "object": "model",
                "created": int(time.time()), "owned_by": "langstream-tpu",
            }]})
        elif urlsplit(handler.path).path == "/debug/profile":
            self._profile(handler)
        else:
            self._error(handler, 404, f"no route {handler.path}")

    def _profile(self, handler: BaseHTTPRequestHandler) -> None:
        """One profiler capture while serving goes on (this handler's
        thread sleeps through it); a concurrent one gets 409."""
        query = parse_qs(urlsplit(handler.path).query)
        try:
            seconds = float(query.get("seconds", ["3"])[0])
        except ValueError:
            self._error(handler, 400, "seconds must be a number")
            return
        try:
            # capture() checks the range itself
            path = tracing.capture(seconds)
        except ValueError as error:
            self._error(handler, 400, str(error))
            return
        except tracing.ProfileBusyError as error:
            self._json(handler, 409, {"error": {"message": str(error), "type": "conflict"}})
            return
        self._json(handler, 200, {"path": path, "seconds": seconds})

    def _post(self, handler: BaseHTTPRequestHandler) -> None:
        if handler.path == "/v1/chat/completions":
            chat = True
        elif handler.path == "/v1/completions":
            chat = False
        elif handler.path != "/v1/embeddings":
            self._error(handler, 404, f"no route {handler.path}")
            return
        try:
            length = int(handler.headers.get("Content-Length") or 0)
            raw = handler.rfile.read(length)
        except ValueError:
            self._error(handler, 400, "invalid Content-Length")
            return
        if handler.path == "/v1/embeddings":
            self._embeddings(handler, raw)
            return
        # degraded mode: while the supervisor rebuilds a crashed engine,
        # new work (streams included) answers 503 before any work
        probe = getattr(self.completions, "available", None)
        retry_in = probe() if callable(probe) else None
        if retry_in is not None:
            self._unavailable(handler, "engine is rebuilding after a crash; retry shortly", retry_in)
            return
        try:
            body = json.loads(raw or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._error(handler, 400, "invalid JSON body")
            return
        if not isinstance(body, dict):
            self._error(handler, 400, "the body must be a JSON object")
            return
        parsed = self._parse(body, chat)
        if isinstance(parsed, str):
            self._error(handler, 400, parsed)
            return
        messages, prompt_texts, options, n = parsed
        # the trace context: the client's id, else one minted here; echoed
        # back so the client can find the request's journey
        trace_id = str(handler.headers.get(tracing.HTTP_TRACE_HEADER) or body.get("trace_id")
                       or tracing.new_trace_id())
        options["trace-id"] = trace_id
        created = int(time.time())
        completion_id = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex

        async def complete(consumer=None, options_override=None):
            request_options = options_override or options
            if chat:
                return await self.completions.get_chat_completions(
                    messages, request_options, consumer
                )
            return await self.completions.get_text_completions(
                prompt_texts, request_options, consumer
            )

        if body.get("stream"):
            if n > 1:
                self._error(handler, 400, "streaming supports n=1 only")
                return
            self._stream(handler, complete, chat, completion_id, created, options)
            return
        try:
            results = asyncio.run(self._complete_n(complete, options, n))
        except api_errors.UnavailableError as error:
            self._unavailable(handler, str(error), error.retry_after_s)
            return
        except (ValueError, TypeError) as error:
            self._error(handler, 400, str(error))
            return
        except Exception as error:  # noqa: BLE001 — the request boundary reports it
            logger.exception("completion failed")
            self._error(handler, 500, str(error))
            return
        choices = []
        for index, result in enumerate(results):
            choice: Dict[str, Any] = {"index": index, "finish_reason": result.finish_reason}
            if chat:
                choice["message"] = {"role": result.role, "content": result.content}
            else:
                choice["text"] = result.content
            if result.logprobs is not None:
                choice["logprobs"] = _logprobs_block(result, options, chat)
            choices.append(choice)
        completion_tokens = sum(r.completion_tokens for r in results)
        self._json(handler, 200, headers={tracing.HTTP_TRACE_HEADER: trace_id}, payload={
            "id": completion_id,
            "object": "chat.completion" if chat else "text_completion",
            "created": created,
            "model": options["model"],
            "choices": choices,
            "usage": {
                "prompt_tokens": results[0].prompt_tokens,
                "completion_tokens": completion_tokens,
                "total_tokens": results[0].prompt_tokens + completion_tokens,
            },
        })

    def _embeddings(self, handler: BaseHTTPRequestHandler, raw: bytes) -> None:
        """``/v1/embeddings``, as the JAX server answers it."""
        if self.embeddings is None:
            self._error(handler, 503, "no embeddings service configured")
            return
        try:
            body = json.loads(raw or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._error(handler, 400, "invalid JSON body")
            return
        if not isinstance(body, dict):
            self._error(handler, 400, "the body must be a JSON object")
            return
        texts = body.get("input")
        if texts is None:
            self._error(handler, 400, "input is required")
            return
        if isinstance(texts, str):
            texts = [texts]
        if not isinstance(texts, list):
            self._error(handler, 400, "input must be a string or a list of strings")
            return
        try:
            vectors = asyncio.run(self.embeddings.compute_embeddings([str(t) for t in texts]))
        except api_errors.UnavailableError as error:
            self._unavailable(handler, str(error), error.retry_after_s)
            return
        except Exception as error:  # noqa: BLE001 — the request boundary reports it
            logger.exception("embeddings failed")
            self._error(handler, 500, str(error))
            return
        self._json(handler, 200, {
            "object": "list",
            "model": body.get("model") or self.model,
            "data": [
                {"object": "embedding", "index": i, "embedding": vector}
                for i, vector in enumerate(vectors)
            ],
            "usage": {"prompt_tokens": 0, "total_tokens": 0},
        })

    def _parse(self, body: Dict[str, Any], chat: bool):
        """(messages, prompt_texts, options, n), or an error message."""
        if chat:
            raw = body.get("messages")
            if not isinstance(raw, list) or not raw:
                return "messages must be a non-empty list"
            messages = [
                ChatMessage(role=str(m.get("role", "user")), content=str(m.get("content", "")))
                for m in raw
            ]
            prompt_texts = None
        else:
            prompt = body.get("prompt")
            if prompt is None:
                return "prompt is required"
            if isinstance(prompt, list):
                prompt = "".join(str(p) for p in prompt)
            prompt_texts, messages = [str(prompt)], []
            # legacy completions spell "K alternatives" as an integer
            # `logprobs: K`: it reaches the top-logprobs option, clamped to
            # the server's limit (with the feature off it keeps meaning the
            # sampled token's logprob alone)
            lp = body.get("logprobs")
            if (isinstance(lp, int) and not isinstance(lp, bool) and lp > 0
                    and body.get("top_logprobs") is None and self._topk_limit > 0):
                body = dict(body, top_logprobs=min(lp, self._topk_limit))
        try:
            options = _options_from_request(body, self.model, self._topk_limit)
        except (ValueError, TypeError) as error:
            return f"invalid request parameter: {error}"
        n = body.get("n", 1) if body.get("n") is not None else 1
        if isinstance(n, bool) or not isinstance(n, int):
            return "n must be an integer"
        if not 1 <= n <= 16:
            return "n must be between 1 and 16"
        return messages, prompt_texts, options, n

    @staticmethod
    async def _complete_n(complete, options: Dict[str, Any], n: int):
        """n independent generations over the engine's slots; explicit
        seeds derive per choice (seed + index) so choices differ. Only
        choice 0 keeps the session: n pinned slots for one session would
        evict other sessions' warm rows."""
        per_choice = [dict(options) for _ in range(n)]
        for index, choice_options in enumerate(per_choice):
            if n > 1 and options.get("seed") is not None:
                choice_options["seed"] = int(options["seed"]) + index
            if index > 0:
                choice_options.pop("session-id", None)
        tasks = [asyncio.ensure_future(complete(options_override=o)) for o in per_choice]
        try:
            return await asyncio.gather(*tasks)
        except BaseException as first:
            # a real failure cancels the siblings so their slots free; but
            # when the first exception gather surfaces is a sibling's
            # cancellation, the real error may still be pending in another
            # choice, and cancelling it would lose the error the client
            # needs (a 503 becomes a dropped connection)
            if not isinstance(first, asyncio.CancelledError):
                for task in tasks:
                    if not task.done():
                        task.cancel()
            outcomes = await asyncio.gather(*tasks, return_exceptions=True)
            if isinstance(first, asyncio.CancelledError):
                for outcome in outcomes:
                    if isinstance(outcome, BaseException) and not isinstance(
                            outcome, asyncio.CancelledError):
                        first = outcome
                        break
            raise first

    def _stream(self, handler, complete, chat: bool, completion_id: str,
                created: int, options: Dict[str, Any]) -> None:
        """The SSE response. Its headers go out with the first delta (or
        the end of a generation that produced none), so a request that
        fails before it started, shed at its queue deadline or refused by
        a rebuilding engine, still gets its plain 503 or error status."""
        chunk_object = "chat.completion.chunk" if chat else "text_completion"

        def open_stream() -> None:
            handler.send_response(200)
            handler.send_header("Content-Type", "text/event-stream")
            handler.send_header("Cache-Control", "no-cache")
            handler.send_header("Connection", "close")
            handler.send_header(tracing.HTTP_TRACE_HEADER, options["trace-id"])
            handler.end_headers()
            if chat:
                write(frame({"index": 0, "delta": {"role": "assistant", "content": ""},
                             "finish_reason": None}))

        def frame(choice: Dict[str, Any], **extra) -> bytes:
            return _sse({
                "id": completion_id, "object": chunk_object, "created": created,
                "model": options["model"], "choices": [choice], **extra,
            })

        def write(data: bytes) -> None:
            handler.wfile.write(data)
            handler.wfile.flush()

        async def pump() -> None:
            chunks: "asyncio.Queue[Tuple[str, bool]]" = asyncio.Queue()

            class Consumer:
                def consume_chunk(self, answer_id, index, chunk, last):
                    chunks.put_nowait((chunk.content, last))

            async def run():
                try:
                    return await complete(Consumer())
                except BaseException:
                    chunks.put_nowait(("", True))  # wake the writer loop
                    raise

            task = asyncio.ensure_future(run())
            try:
                opened = False
                while True:
                    content, last = await chunks.get()
                    if not opened:
                        if task.done() and task.exception() is not None:
                            # failed before its first delta: a plain status
                            error = task.exception()
                            if isinstance(error, api_errors.UnavailableError):
                                self._unavailable(handler, str(error), error.retry_after_s)
                            else:
                                self._error(handler, 400 if isinstance(error, (ValueError, TypeError))
                                            else 500, str(error))
                            return
                        open_stream()
                        opened = True
                    if content:
                        choice: Dict[str, Any] = {"index": 0, "finish_reason": None}
                        if chat:
                            choice["delta"] = {"content": content}
                        else:
                            choice["text"] = content
                        write(frame(choice))
                    if last:
                        break
                try:
                    result = await task
                except Exception as error:  # noqa: BLE001 — reported in-stream
                    write(_sse({"error": {"message": str(error), "type": "server_error"}}))
                    write(b"data: [DONE]\n\n")
                    return
                final: Dict[str, Any] = {"index": 0, "finish_reason": result.finish_reason}
                if chat:
                    final["delta"] = {}
                    if result.top_logprobs is not None and int(options.get("top-logprobs") or 0) > 0:
                        # every token's entry, in the final chunk
                        final["logprobs"] = {"content": _chat_logprobs_content(
                            result, int(options["top-logprobs"]))}
                else:
                    final["text"] = ""
                write(frame(final, usage={
                    "prompt_tokens": result.prompt_tokens,
                    "completion_tokens": result.completion_tokens,
                    "total_tokens": result.prompt_tokens + result.completion_tokens,
                }))
                write(b"data: [DONE]\n\n")
            finally:
                if not task.done():
                    # client went away mid-stream: free the slot
                    task.cancel()
                    try:
                        await task
                    except (asyncio.CancelledError, Exception):  # noqa: BLE001
                        pass

        try:
            asyncio.run(pump())
        except (BrokenPipeError, ConnectionResetError):
            logger.info("client disconnected mid-stream")
