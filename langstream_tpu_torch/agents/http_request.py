"""HTTP request agent: call an HTTP service per record.

Equivalent of the reference's ``http-request`` processor
(``langstream-agents/langstream-agent-http-request/.../HttpRequestAgent.java:51``):
url/method/headers/query templates evaluated against the record, response
body lands in ``output-field`` (JSON-parsed when the response is JSON).

The port's own copy of ``langstream_tpu/agents/http_request.py``, on the
port's HTTP client (``agents/http_client.py``) where the JAX package uses
``aiohttp``: the same requests, redirects and cookie policy.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.agents import http_client
from langstream_tpu_torch.api.agent import SingleRecordProcessor
from langstream_tpu_torch.api.records import Record
from langstream_tpu_torch.agents.el import Expression, render_template
from langstream_tpu_torch.agents.transform import TransformContext


class HttpRequestAgent(SingleRecordProcessor):
    agent_type = "http-request"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.url = configuration["url"]
        self.method = configuration.get("method", "GET").upper()
        self.output_field = configuration.get("output-field", "value")
        self.headers = configuration.get("headers", {}) or {}
        self.query_string = configuration.get("query-string", {}) or {}
        self.body = configuration.get("body")
        self.allow_redirects = bool(configuration.get("allow-redirects", True))
        self.handle_cookies = bool(configuration.get("handle-cookies", True))
        self._jar: Optional[http_client.CookieJar] = None

    async def start(self) -> None:
        self._jar = http_client.CookieJar() if self.handle_cookies else None

    async def process_record(self, record: Record) -> List[Record]:
        ctx = TransformContext(record)
        el_ctx = ctx.el_context()
        url = render_template(self.url, el_ctx)
        params = {
            key: render_template(str(value), el_ctx)
            for key, value in self.query_string.items()
        }
        headers = {
            key: render_template(str(value), el_ctx)
            for key, value in self.headers.items()
        }
        body = render_template(self.body, el_ctx) if self.body else None
        response = await http_client.request(
            self.method,
            url,
            params=params,
            headers=headers,
            data=body,
            allow_redirects=self.allow_redirects,
            jar=self._jar,
        )
        response.raise_for_status()
        content_type = response.headers.get("Content-Type", "")
        if "json" in content_type:
            payload: Any = await response.json()
        else:
            payload = await response.text()
        ctx.set_field(self.output_field, payload)
        return [ctx.to_record()]


class LangServeInvokeAgent(SingleRecordProcessor):
    """``langserve-invoke``: call a LangChain LangServe runnable.

    Equivalent of the reference's LangServe client
    (``langstream-agents/langstream-agent-http-request/.../LangServeInvokeAgent.java:49``):
    POST ``{"input": {fields...}}`` to the service URL; an ``/invoke``
    endpoint's ``output`` lands in ``output-field``, a ``/stream``
    endpoint's SSE chunks are forwarded to ``stream-to-topic`` as they
    arrive (content in ``content-field``) and concatenated into the
    final output.
    """

    agent_type = "langserve-invoke"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.url = configuration["url"]
        self.fields = [
            (f["name"], f["expression"])
            for f in configuration.get("fields", []) or []
        ]
        self.output_field = configuration.get("output-field", "value")
        self.content_field = configuration.get("content-field", "value")
        self.stream_to_topic = configuration.get("stream-to-topic")
        self.min_chunks = int(configuration.get("min-chunks-per-message", 20))
        self.headers = configuration.get("headers", {}) or {}
        self._producer = None

    async def close(self) -> None:
        if self._producer is not None:
            await self._producer.close()
            self._producer = None

    async def _stream_producer(self):
        if self._producer is None:
            producer = self.context.topic_connections.create_producer(
                self.agent_id, {"topic": self.stream_to_topic}
            )
            await producer.start()
            self._producer = producer
        return self._producer

    @staticmethod
    def _chunk_text(payload: Any) -> str:
        if isinstance(payload, str):
            return payload
        if isinstance(payload, dict):
            return str(payload.get("content", payload.get("output", "")))
        return str(payload)

    async def process_record(self, record: Record) -> List[Record]:
        ctx = TransformContext(record)
        el_ctx = ctx.el_context()
        payload = {
            "input": {
                name: Expression(expression).evaluate(el_ctx)
                for name, expression in self.fields
            }
        }
        streaming = self.url.rstrip("/").endswith("/stream")
        response = await http_client.open_stream(
            "POST", self.url, json=payload, headers=self.headers
        )
        try:
            response.raise_for_status()
            if not streaming:
                body = await response.json()
                output = body.get("output", body) if isinstance(body, dict) else body
                ctx.set_field(self.output_field, output)
                return [ctx.to_record()]
            # SSE: forward "data" events to the stream topic with the
            # reference's exponential chunk batching (1, 2, 4, ... up to
            # min-chunks-per-message chunks per emitted record)
            parts: List[str] = []
            buffer: List[str] = []
            batch_size, index = 1, 0
            producer = (
                await self._stream_producer() if self.stream_to_topic else None
            )

            async def flush(last: bool) -> None:
                nonlocal index, batch_size, buffer
                if producer is None or (not buffer and not last):
                    return
                # deep-copy per chunk: set_field mutates the value dict
                # in place, and every chunk record must not alias it
                chunk_ctx = TransformContext(record)
                chunk_ctx.value = copy.deepcopy(chunk_ctx.value)
                chunk_ctx.key = copy.deepcopy(chunk_ctx.key)
                chunk_ctx.set_field(self.content_field, "".join(buffer))
                chunk_ctx.properties["stream-index"] = str(index)
                chunk_ctx.properties["stream-last-message"] = str(last).lower()
                await producer.write(chunk_ctx.to_record())
                index += 1
                batch_size = min(batch_size * 2, max(self.min_chunks, 1))
                buffer = []

            async for raw_line in response.iter_lines():
                line = raw_line.decode("utf-8", "replace").strip()
                if not line.startswith("data:"):
                    continue
                data = line[len("data:"):].strip()
                if data in ("", "[DONE]"):
                    continue
                try:
                    parsed: Any = json.loads(data)
                except ValueError:
                    parsed = data
                text = self._chunk_text(parsed)
                if not text:
                    continue
                parts.append(text)
                buffer.append(text)
                if len(buffer) >= batch_size:
                    await flush(last=False)
            await flush(last=True)
        finally:
            response.close()
        ctx.set_field(self.output_field, "".join(parts))
        return [ctx.to_record()]
