"""The port's gateway and WebSocket code against the JAX gateway and
aiohttp, on the CPU.

- One model-free app (``document-to-json`` and a ``compute`` step answer
  each question; a ``compute`` step answers the service gateway), run by
  each package with its own gateway, driven by aiohttp's client: ``chat``
  (two sessions at once, each seeing only its own answers),
  ``produce``/``consume`` with the session filter, HTTP ``produce`` read
  back from ``option:position=earliest``, the ``service`` round trip,
  ``/healthz``, and the refusals (a missing parameter, an unknown
  gateway, a wrong type): every reply and frame equal to the JAX
  gateway's, minted trace and request ids aside.
- The port's server side (``websocket.server_handshake``) under aiohttp's
  client, and the port's client (``websocket.connect``) against an
  aiohttp server: text and binary messages of 0, 125, 126, 65,535 and
  65,536 bytes (each payload-length form) both ways, a message
  fragmented over continuation frames, ping and pong from either side,
  and the closing handshake with its code.
"""

import asyncio
import json
import pathlib
import re
import urllib.request

import aiohttp
import pytest
from aiohttp import WSMsgType, web

from langstream_tpu.gateway import GatewayServer as JaxGatewayServer
from langstream_tpu.runtime.local import run_application as jax_run_application
from langstream_tpu_torch.gateway import GatewayServer, websocket
from langstream_tpu_torch.runtime.local import run_application

SIZES = [0, 125, 126, 65535, 65536]

PIPELINE = """\
topics:
  - {name: questions, creation-mode: create-if-not-exists}
  - {name: answers, creation-mode: create-if-not-exists}
  - {name: svc-in, creation-mode: create-if-not-exists}
  - {name: svc-out, creation-mode: create-if-not-exists}
  - {name: events, creation-mode: create-if-not-exists}
pipeline:
  - name: to-json
    type: document-to-json
    input: questions
    configuration: {text-field: question}
  - type: compute
    output: answers
    configuration:
      fields:
        - {name: value.answer, expression: "fn:uppercase(value.question)"}
"""
SERVICE = """\
pipeline:
  - name: svc
    type: compute
    input: svc-in
    output: svc-out
    configuration:
      fields:
        - {name: value.echo, expression: "fn:concat(value.q, '!')"}
"""
GATEWAYS = """\
gateways:
  - id: produce-input
    type: produce
    topic: questions
    parameters: [sessionId]
    events-topic: events
    produce-options:
      headers:
        - {key: langstream-client-session-id, value-from-parameters: sessionId}
  - id: consume-output
    type: consume
    topic: answers
    parameters: [sessionId]
    consume-options:
      filters:
        headers:
          - {key: langstream-client-session-id, value-from-parameters: sessionId}
  - id: chat
    type: chat
    chat-options:
      questions-topic: questions
      answers-topic: answers
      headers:
        - value-from-parameters: session-id
  - id: svc
    type: service
    service-options: {input-topic: svc-in, output-topic: svc-out}
"""
MINTED = re.compile(r"\b[0-9a-f]{32}\b")


def write_app(root: pathlib.Path) -> str:
    app = root / "gw-app"
    app.mkdir()
    (app / "pipeline.yaml").write_text(PIPELINE)
    (app / "service.yaml").write_text(SERVICE)
    (app / "gateways.yaml").write_text(GATEWAYS)
    return str(app)


def scrub(value):
    """Minted trace and request ids (uuid4 hex) read alike."""
    return json.loads(MINTED.sub("<id>", json.dumps(value)))


async def receive_json(ws, count: int):
    out = []
    for _ in range(count):
        message = await ws.receive(timeout=20)
        assert message.type == WSMsgType.TEXT, message
        out.append(json.loads(message.data))
    return out


async def scenario(port: int) -> dict:
    ws_base = f"ws://127.0.0.1:{port}/v1"
    http_base = f"http://127.0.0.1:{port}"
    out = {}
    async with aiohttp.ClientSession() as session:
        # chat: two sessions at once
        chat_a = await session.ws_connect(f"{ws_base}/chat/default/gw-app/chat?param:session-id=a")
        chat_b = await session.ws_connect(f"{ws_base}/chat/default/gw-app/chat?param:session-id=b")
        await chat_a.send_json({"value": "first from a"})
        await chat_b.send_json({"value": "first from b", "key": "kb", "headers": {"x": "1"}})
        out["chat_b"] = await receive_json(chat_b, 1)
        out["chat_a"] = await receive_json(chat_a, 1)
        await chat_a.send_json({"value": "second from a"})
        out["chat_a"] += await receive_json(chat_a, 1)
        await chat_a.send_str("not json")
        out["chat_bad"] = await receive_json(chat_a, 1)
        await chat_a.close()
        await chat_b.close()
        # produce / consume with the session filter
        consume = await session.ws_connect(
            f"{ws_base}/consume/default/gw-app/consume-output?param:sessionId=s3")
        for sid in ("s3", "s4", "s3"):
            produce = await session.ws_connect(
                f"{ws_base}/produce/default/gw-app/produce-input?param:sessionId={sid}")
            await produce.send_json({"value": f"produced for {sid}"})
            out.setdefault("produce_acks", []).extend(await receive_json(produce, 1))
            await produce.close()
        out["consume"] = await receive_json(consume, 2)
        await consume.close()
        # HTTP produce, read back from the earliest position
        async with session.post(f"{http_base}/api/gateways/produce/default/gw-app/produce-input"
                                "?param:sessionId=s5", data=json.dumps({"value": "over http"})) as r:
            out["http_produce"] = (r.status, await r.json())
        replay = await session.ws_connect(
            f"{ws_base}/consume/default/gw-app/consume-output?param:sessionId=s5"
            "&option:position=earliest")
        out["replay"] = await receive_json(replay, 1)
        await replay.close()
        # the service gateway's round trip
        async with session.post(f"{http_base}/api/gateways/service/default/gw-app/svc",
                                data=json.dumps({"value": {"q": "ping"}, "key": "k1"})) as r:
            out["service"] = (r.status, await r.json())
        # refusals
        for url in (f"{ws_base}/chat/default/gw-app/chat",
                    f"{ws_base}/consume/default/gw-app/chat?param:session-id=a",
                    f"{ws_base}/produce/default/gw-app/nope"):
            try:
                await session.ws_connect(url)
                out.setdefault("refused", []).append(None)
            except aiohttp.WSServerHandshakeError as error:
                out.setdefault("refused", []).append(error.status)
        async with session.post(f"{http_base}/api/gateways/produce/default/gw-app/nope",
                                data="{}") as r:
            out["http_unknown"] = (r.status, await r.json())
        async with session.post(f"{http_base}/api/gateways/produce/default/gw-app/produce-input"
                                "?param:sessionId=s6&bad=1", data="{}") as r:
            out["http_bad_query"] = (r.status, await r.json())
        async with session.get(f"{http_base}/healthz") as r:
            out["healthz"] = (r.status, await r.json())
    return scrub(out)


async def run_port(app_dir: str) -> dict:
    runner = await run_application(app_dir, device="cpu")
    gateway = GatewayServer(port=0)
    gateway.register_local_runner(runner)
    await gateway.start()
    try:
        result = await scenario(gateway.port)
        result["events"] = [r.value["type"] for r in await runner.reader("events").read(timeout=0.2)]
        return result
    finally:
        await gateway.stop()
        await runner.stop()


async def run_jax(app_dir: str) -> dict:
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    runner = await jax_run_application(app_dir)
    gateway = JaxGatewayServer(port=port)
    gateway.register_local_runner(runner)
    await gateway.start()
    try:
        result = await scenario(port)
        result["events"] = [r.value["type"] for r in await runner.reader("events").read(timeout=0.2)]
        return result
    finally:
        await gateway.stop()
        await runner.stop()


def test_gateway_equals_jax(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = asyncio.run(run_port(write_app(tmp_path / "port")))
    want = asyncio.run(run_jax(write_app(tmp_path / "jax")))
    assert got == want
    assert [f["record"]["value"]["answer"] for f in got["chat_a"]] == ["FIRST FROM A", "SECOND FROM A"]
    assert got["chat_b"][0]["record"]["key"] == "kb"
    assert [f["record"]["value"]["question"] for f in got["consume"]] == ["produced for s3"] * 2
    assert got["service"][1]["record"]["value"] == {"q": "ping", "echo": "ping!"}
    assert got["refused"] == [400, 400, 404] and got["http_unknown"][0] == 404
    assert got["events"] == ["ClientConnected", "ClientDisconnected"] * 3


def test_metrics_serve_the_engine_series_beside_the_gateway_counters(tmp_path):
    """``/metrics`` in a process that runs the engine: the gateway's
    counters and the engine's series (``engines_histograms``)."""
    from langstream_tpu_torch.providers.torch_local import engine  # noqa: F401

    async def main():
        runner = await run_application(write_app(tmp_path), device="cpu")
        gateway = GatewayServer(port=0)
        gateway.register_local_runner(runner)
        await gateway.start()
        try:
            async with aiohttp.ClientSession() as session:
                url = f"http://127.0.0.1:{gateway.port}/api/gateways/produce/default/gw-app/produce-input?param:sessionId=m"
                async with session.post(url, data=json.dumps({"value": "q"})) as r:
                    assert r.status == 200
            return await asyncio.get_running_loop().run_in_executor(None, lambda: urllib.request.urlopen(
                f"http://127.0.0.1:{gateway.port}/metrics").read().decode())
        finally:
            await gateway.stop()
            await runner.stop()

    text = asyncio.run(main())
    assert "gateway_records_produced_total 1" in text
    assert "gateway_registered_apps 1.0" in text
    assert "torch_engine_ttft_seconds_count" in text


# ---------------------------------------------------------------------- #
# framing, both ways
# ---------------------------------------------------------------------- #
async def port_echo_server():
    """An echo server on the port's server side of the protocol."""
    closes = []

    async def handle(reader, writer):
        _start, headers = await websocket.read_head(reader)
        ws = await websocket.server_handshake(reader, writer, headers)
        while True:
            message = await ws.receive()
            if message.type == "text":
                await ws.send_str(message.data)
            elif message.type == "binary":
                await ws.send_bytes(message.data)
            else:
                closes.append((message.type, message.data))
                break
        writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    return server, closes


def test_port_server_side_under_aiohttp_client():
    async def main():
        server, closes = await port_echo_server()
        port = server.sockets[0].getsockname()[1]
        async with aiohttp.ClientSession() as session:
            ws = await session.ws_connect(f"ws://127.0.0.1:{port}/", autoping=False)
            for size in SIZES:
                # a two-byte character first: the frame holds `size` bytes
                text = ("é" + "x" * (size - 2)) if size >= 2 else "x" * size
                assert len(text.encode()) == size
                await ws.send_str(text)
                message = await ws.receive(timeout=10)
                assert message.type == WSMsgType.TEXT and message.data == text, size
                data = bytes(range(256)) * (size // 256 + 1)
                await ws.send_bytes(data[:size])
                message = await ws.receive(timeout=10)
                assert message.type == WSMsgType.BINARY and message.data == data[:size], size
            await ws.ping(b"are you there")
            message = await ws.receive(timeout=10)
            assert message.type == WSMsgType.PONG and message.data == b"are you there"
            await ws.close(code=4000, message=b"done")
            assert ws.close_code == 4000
        server.close()
        await server.wait_closed()
        return closes

    assert asyncio.run(main()) == [("close", 4000)]


def test_port_client_against_aiohttp_server():
    seen = []

    async def handler(request):
        ws = web.WebSocketResponse(autoping=False)
        await ws.prepare(request)
        async for message in ws:
            if message.type == WSMsgType.TEXT:
                if message.data == "ping-me":
                    await ws.ping(b"from server")
                elif message.data == "close-me":
                    await ws.close(code=4001, message=b"bye")
                else:
                    await ws.send_str(message.data)
            elif message.type == WSMsgType.BINARY:
                await ws.send_bytes(message.data)
            elif message.type == WSMsgType.PING:
                seen.append(("ping", message.data))
                await ws.pong(message.data)
            elif message.type == WSMsgType.PONG:
                seen.append(("pong", message.data))
                await ws.send_str("got your pong")
        return ws

    async def main():
        app = web.Application()
        app.router.add_get("/ws", handler)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        try:
            ws = await websocket.connect(f"ws://127.0.0.1:{port}/ws")
            for size in SIZES:
                text = "z" * size
                await ws.send_str(text)
                assert (await ws.receive()) == websocket.Message("text", text)
                data = bytes(range(256)) * (size // 256 + 1)
                await ws.send_bytes(data[:size])
                assert (await ws.receive()) == websocket.Message("binary", data[:size])
            # one message over three frames
            await ws.send_frame(websocket.TEXT, b"frag", fin=False)
            await ws.send_frame(websocket.CONTINUATION, b"ment" * 40, fin=False)
            await ws.send_frame(websocket.CONTINUATION, b"ed")
            assert (await ws.receive()).data == "frag" + "ment" * 40 + "ed"
            await ws.ping(b"from client")
            await ws.send_str("after the ping")
            assert (await ws.receive()).data == "after the ping"
            assert ws.last_pong == b"from client"
            await ws.send_str("ping-me")
            assert (await ws.receive()).data == "got your pong"
            await ws.send_str("close-me")
            closing = await ws.receive()
            assert (closing.type, closing.data, closing.extra) == ("close", 4001, "bye")
            await ws.close()
            with pytest.raises(websocket.WebSocketError) as refused:
                await websocket.connect(f"ws://127.0.0.1:{port}/missing")
            assert refused.value.status == 404
        finally:
            await runner.cleanup()

    asyncio.run(main())
    assert seen == [("ping", b"from client"), ("pong", b"from server")]


@pytest.mark.parametrize("size", SIZES)
def test_frame_lengths_and_masks_round_trip(size):
    """Each length form encodes as RFC 6455 lays it out, masked or not,
    and reads back through the other side's parser."""
    payload = bytes((i * 7) & 0xFF for i in range(size))
    head = 2 + (2 if 126 <= size <= 0xFFFF else 8 if size > 0xFFFF else 0)
    plain = websocket.encode_frame(websocket.BINARY, payload)
    assert plain[1] == (size if size <= 125 else 126 if size <= 0xFFFF else 127)
    assert len(plain) == head + size
    masked = websocket.encode_frame(websocket.BINARY, payload, mask=b"\x01\x02\x03\x04")
    assert masked[1] & 0x80 and len(masked) == head + 4 + size

    async def read(frame: bytes, client: bool):
        reader = asyncio.StreamReader()
        reader.feed_data(frame)
        reader.feed_eof()
        ws = websocket.WebSocket(reader, writer=None, client=client)
        return await ws._read_frame()

    assert asyncio.run(read(plain, client=True)) == (True, websocket.BINARY, payload)
    assert asyncio.run(read(masked, client=False)) == (True, websocket.BINARY, payload)


def test_stop_closes_a_connected_chat_client(tmp_path):
    """A chat client still connected when the gateway stops gets the
    closing handshake, and neither the gateway nor the app waits on it."""

    async def main():
        runner = await run_application(write_app(tmp_path), device="cpu")
        gateway = GatewayServer(port=0)
        gateway.register_local_runner(runner)
        await gateway.start()
        ws = await websocket.connect(
            f"ws://127.0.0.1:{gateway.port}/v1/chat/default/gw-app/chat?param:session-id=z")
        await ws.send_json({"value": "still here"})
        answer = (await ws.receive()).json()["record"]["value"]["answer"]
        await asyncio.wait_for(gateway.stop(), 10)
        await asyncio.wait_for(runner.stop(), 10)
        closing = await asyncio.wait_for(ws.receive(), 10)
        return answer, closing.type, closing.data

    assert asyncio.run(main()) == ("STILL HERE", "close", websocket.GOING_AWAY)
