"""OpenAI-compatible HTTP serving surface over the port's completions
service, on the standard library's ``ThreadingHTTPServer``.

Port of ``langstream_tpu/serving/openai_api.py`` (an aiohttp app there):

- ``POST /v1/chat/completions`` — messages in, completion out; with
  ``"stream": true`` the answer arrives as SSE ``data:`` chunks in the
  OpenAI chunk format, terminated by ``data: [DONE]``.
- ``POST /v1/completions`` — prompt in (legacy text completions).
- ``GET /v1/models`` and ``GET /healthz``.

Each request runs on its own handler thread, which drives the service's
coroutines on a private event loop (``asyncio.run``); the engine thread
posts tokens onto that loop.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from langstream_tpu_torch.api.service import ChatMessage

logger = logging.getLogger(__name__)


def _sse(payload: Dict[str, Any]) -> bytes:
    return b"data: " + json.dumps(payload, ensure_ascii=False).encode() + b"\n\n"


def _options_from_request(body: Dict[str, Any], model: str) -> Dict[str, Any]:
    """OpenAI request params → service option names. Raises ValueError
    (→ HTTP 400) on malformed values so bad requests fail BEFORE burning a
    generation."""
    options: Dict[str, Any] = {"model": body.get("model") or model}
    if body.get("top_logprobs"):
        raise ValueError("top_logprobs is not supported by this server yet")
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
    return options


class OpenAIApiServer:
    """Serves the OpenAI surface for one model from a background thread."""

    def __init__(
        self,
        completions,
        *,
        model: str = "torch-local",
        host: str = "0.0.0.0",
        port: int = 8000,
    ) -> None:
        self.completions = completions
        self.model = model
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
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

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
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
    def _json(handler: BaseHTTPRequestHandler, status: int, payload: Dict[str, Any]) -> None:
        data = json.dumps(payload, ensure_ascii=False).encode()
        handler.send_response(status)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)

    def _error(self, handler, status: int, message: str) -> None:
        self._json(handler, status, {"error": {
            "message": message,
            "type": "invalid_request_error" if status == 400 else "server_error",
        }})

    def _get(self, handler: BaseHTTPRequestHandler) -> None:
        if handler.path == "/healthz":
            self._json(handler, 200, {"status": "ok", "model": self.model})
        elif handler.path == "/v1/models":
            self._json(handler, 200, {"object": "list", "data": [{
                "id": self.model, "object": "model",
                "created": int(time.time()), "owned_by": "langstream-tpu",
            }]})
        else:
            self._error(handler, 404, f"no route {handler.path}")

    def _post(self, handler: BaseHTTPRequestHandler) -> None:
        if handler.path == "/v1/chat/completions":
            chat = True
        elif handler.path == "/v1/completions":
            chat = False
        else:
            self._error(handler, 404, f"no route {handler.path}")
            return
        try:
            length = int(handler.headers.get("Content-Length") or 0)
            body = json.loads(handler.rfile.read(length) or b"{}")
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
                choice["logprobs"] = {
                    "tokens": result.tokens, "token_logprobs": result.logprobs,
                }
            choices.append(choice)
        completion_tokens = sum(r.completion_tokens for r in results)
        self._json(handler, 200, {
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
        try:
            options = _options_from_request(body, self.model)
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
        seeds derive per choice (seed + index) so choices differ."""
        per_choice = [dict(options) for _ in range(n)]
        if n > 1 and options.get("seed") is not None:
            for index, choice_options in enumerate(per_choice):
                choice_options["seed"] = int(options["seed"]) + index
        tasks = [asyncio.ensure_future(complete(options_override=o)) for o in per_choice]
        try:
            return await asyncio.gather(*tasks)
        except BaseException:
            for task in tasks:
                task.cancel()  # free the siblings' slots
            raise

    def _stream(self, handler, complete, chat: bool, completion_id: str,
                created: int, options: Dict[str, Any]) -> None:
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.send_header("Connection", "close")
        handler.end_headers()
        chunk_object = "chat.completion.chunk" if chat else "text_completion"

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
                if chat:
                    write(frame({"index": 0, "delta": {"role": "assistant", "content": ""},
                                 "finish_reason": None}))
                while True:
                    content, last = await chunks.get()
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
