"""RFC 6455 WebSockets on ``asyncio`` streams: the gateway's server side
and a client.

The card's machine has no aiohttp, so the port's gateway speaks the
protocol itself: the opening handshake (``Sec-WebSocket-Accept`` from the
client's key), frames with 7-bit, 16-bit and 64-bit payload lengths,
masking (a client masks every frame it sends, a server none), messages
fragmented over continuation frames, ping answered by pong, and the
closing handshake with its status code. No extension (``permessage-
deflate``) and no subprotocol is negotiated.

:func:`server_handshake` upgrades a parsed HTTP request on a server's
streams; :func:`connect` opens a client connection to a ``ws://`` URL.
Both return a :class:`WebSocket`.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import hashlib
import json
import os
import struct
import urllib.parse
from typing import Any, Dict, Optional

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

CONTINUATION, TEXT, BINARY, CLOSE, PING, PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA
_CONTROL = (CLOSE, PING, PONG)

# close codes (RFC 6455 §7.4.1)
NORMAL, GOING_AWAY, PROTOCOL_ERROR, NO_STATUS, TOO_BIG = 1000, 1001, 1002, 1005, 1009

MAX_MESSAGE_BYTES = 64 * 1024 * 1024


class WebSocketError(Exception):
    """A refused handshake (``status`` is the HTTP status) or a broken
    frame (``status`` 0)."""

    def __init__(self, message: str, status: int = 0) -> None:
        super().__init__(message)
        self.status = status


@dataclasses.dataclass
class Message:
    """One received message: ``type`` is ``"text"``, ``"binary"``,
    ``"close"`` (``data`` the close code, ``extra`` the reason) or
    ``"closed"`` (the stream ended without a closing handshake)."""

    type: str
    data: Any = None
    extra: str = ""

    def json(self) -> Any:
        return json.loads(self.data)


def accept_key(key: str) -> str:
    return base64.b64encode(hashlib.sha1((key + GUID).encode()).digest()).decode()


def apply_mask(data: bytes, mask: bytes) -> bytes:
    """XOR ``data`` with the 4-byte ``mask`` repeated (its own inverse)."""
    if not data:
        return data
    n = len(data)
    key = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "little") ^ int.from_bytes(key, "little")).to_bytes(n, "little")


def encode_frame(opcode: int, payload: bytes, *, fin: bool = True,
                 mask: Optional[bytes] = None) -> bytes:
    """One frame; ``mask`` (4 bytes) for a client's frames, None for a
    server's."""
    length = len(payload)
    head = bytes([(0x80 if fin else 0) | opcode])
    bit = 0x80 if mask is not None else 0
    if length <= 125:
        head += bytes([bit | length])
    elif length <= 0xFFFF:
        head += bytes([bit | 126]) + struct.pack("!H", length)
    else:
        head += bytes([bit | 127]) + struct.pack("!Q", length)
    if mask is None:
        return head + payload
    return head + mask + apply_mask(payload, mask)


class WebSocket:
    """An open connection. ``client`` says which side this is: a client
    masks what it sends and expects unmasked frames, a server the
    reverse. Sends are serialized under a lock, so several tasks may send
    on one socket while one task receives."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 *, client: bool) -> None:
        self.reader = reader
        self.writer = writer
        self.client = client
        self.close_code: Optional[int] = None
        self.last_pong: Optional[bytes] = None
        self._send_lock = asyncio.Lock()
        self._close_sent = False
        self._close_received = asyncio.Event()
        self._reading = False

    @property
    def closed(self) -> bool:
        return self._close_sent or self._close_received.is_set() or self.writer.is_closing()

    # -- sending ---------------------------------------------------------- #
    async def send_frame(self, opcode: int, payload: bytes, *, fin: bool = True) -> None:
        mask = os.urandom(4) if self.client else None
        async with self._send_lock:
            if self.writer.is_closing():
                raise ConnectionResetError("the WebSocket is closed")
            self.writer.write(encode_frame(opcode, payload, fin=fin, mask=mask))
            await self.writer.drain()

    async def send_str(self, text: str) -> None:
        await self.send_frame(TEXT, text.encode("utf-8"))

    async def send_bytes(self, data: bytes) -> None:
        await self.send_frame(BINARY, data)

    async def send_json(self, value: Any) -> None:
        await self.send_str(json.dumps(value))

    async def ping(self, payload: bytes = b"") -> None:
        await self.send_frame(PING, payload)

    async def _send_close(self, payload: bytes) -> None:
        """The close frame, once; a peer already gone is no error."""
        if self._close_sent:
            return
        self._close_sent = True
        try:
            await self.send_frame(CLOSE, payload)
        except (ConnectionError, RuntimeError):
            pass

    async def close(self, code: int = NORMAL, reason: str = "", timeout: float = 2.0) -> None:
        """Send the close frame, wait (up to ``timeout``) for the peer's,
        and close the stream."""
        await self._send_close(struct.pack("!H", code) + reason.encode("utf-8"))
        if not self._close_received.is_set():
            try:
                if self._reading:
                    await asyncio.wait_for(self._close_received.wait(), timeout)
                else:
                    await asyncio.wait_for(self._drain_until_close(), timeout)
            except (asyncio.TimeoutError, ConnectionError, asyncio.IncompleteReadError,
                    WebSocketError):
                pass
        self.writer.close()

    async def _fail(self, code: int) -> None:
        """Close at once on a broken peer: the close frame, no wait."""
        await self._send_close(struct.pack("!H", code))
        self.writer.close()

    async def _drain_until_close(self) -> None:
        while not self._close_received.is_set():
            message = await self.receive()
            if message.type in ("close", "closed"):
                return

    # -- receiving -------------------------------------------------------- #
    async def _read_frame(self):
        head = await self.reader.readexactly(2)
        fin = bool(head[0] & 0x80)
        if head[0] & 0x70:
            raise WebSocketError("reserved bits set without an extension")
        opcode = head[0] & 0x0F
        masked = bool(head[1] & 0x80)
        length = head[1] & 0x7F
        if length == 126:
            (length,) = struct.unpack("!H", await self.reader.readexactly(2))
        elif length == 127:
            (length,) = struct.unpack("!Q", await self.reader.readexactly(8))
        if masked == self.client:
            raise WebSocketError("a client must mask its frames and a server must not")
        if opcode in _CONTROL and (not fin or length > 125):
            raise WebSocketError("a control frame must be whole and at most 125 bytes")
        if length > MAX_MESSAGE_BYTES:
            raise WebSocketError(f"a {length}-byte frame exceeds {MAX_MESSAGE_BYTES} bytes")
        mask = await self.reader.readexactly(4) if masked else None
        payload = await self.reader.readexactly(length)
        if mask is not None:
            payload = apply_mask(payload, mask)
        return fin, opcode, payload

    async def receive(self) -> Message:
        """The next whole message. Pings are answered and pongs dropped
        on the way; a close frame is answered with the same code."""
        self._reading = True
        parts: Optional[list] = None
        kind = TEXT
        try:
            while True:
                try:
                    fin, opcode, payload = await self._read_frame()
                except (asyncio.IncompleteReadError, ConnectionError):
                    self._close_received.set()
                    return Message("closed")
                except WebSocketError:
                    await self._fail(PROTOCOL_ERROR)
                    raise
                if opcode == PING:
                    if not self._close_sent:
                        await self.send_frame(PONG, payload)
                    continue
                if opcode == PONG:
                    self.last_pong = payload
                    continue
                if opcode == CLOSE:
                    code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else NO_STATUS
                    self.close_code = code
                    self._close_received.set()
                    await self._send_close(payload[:2])
                    return Message("close", code, payload[2:].decode("utf-8", "replace"))
                if opcode in (TEXT, BINARY):
                    if parts is not None:
                        raise WebSocketError("a new message began inside a fragmented one")
                    parts, kind = [], opcode
                elif opcode == CONTINUATION:
                    if parts is None:
                        raise WebSocketError("a continuation frame outside a message")
                else:
                    raise WebSocketError(f"unknown opcode {opcode:#x}")
                parts.append(payload)
                if sum(len(p) for p in parts) > MAX_MESSAGE_BYTES:
                    await self._fail(TOO_BIG)
                    raise WebSocketError("message too big")
                if fin:
                    data = b"".join(parts)
                    if kind == TEXT:
                        return Message("text", data.decode("utf-8"))
                    return Message("binary", data)
        finally:
            self._reading = False

    def __aiter__(self):
        return self

    async def __anext__(self) -> Message:
        message = await self.receive()
        if message.type in ("close", "closed"):
            raise StopAsyncIteration
        return message


# ---------------------------------------------------------------------- #
# handshakes
# ---------------------------------------------------------------------- #
def is_upgrade(headers: Dict[str, str]) -> bool:
    return (headers.get("upgrade", "").lower() == "websocket"
            and "upgrade" in headers.get("connection", "").lower())


async def server_handshake(reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                           headers: Dict[str, str]) -> WebSocket:
    """Answer an upgrade request (lower-cased ``headers``) with 101 and
    return the server side of the connection."""
    key = headers.get("sec-websocket-key")
    if not is_upgrade(headers) or not key or headers.get("sec-websocket-version") != "13":
        raise WebSocketError("not a WebSocket version 13 upgrade request", 400)
    writer.write((
        "HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n").encode("latin-1"))
    await writer.drain()
    return WebSocket(reader, writer, client=False)


async def read_head(reader: asyncio.StreamReader):
    """An HTTP message head: the start line and lower-cased headers."""
    start = (await reader.readline()).decode("latin-1").rstrip("\r\n")
    headers: Dict[str, str] = {}
    while True:
        line = (await reader.readline()).decode("latin-1")
        if line in ("\r\n", "\n", ""):
            return start, headers
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()


async def connect(url: str, *, timeout: float = 30.0,
                  headers: Optional[Dict[str, str]] = None) -> WebSocket:
    """Open a client connection to ``ws://host:port/path?query``. A
    refused upgrade raises :class:`WebSocketError` with the HTTP status
    and the response body."""
    parts = urllib.parse.urlsplit(url)
    if parts.scheme != "ws":
        raise ValueError(f"only ws:// URLs are supported, got {url!r}")
    host, port = parts.hostname or "127.0.0.1", parts.port or 80
    target = parts.path or "/"
    if parts.query:
        target += "?" + parts.query
    reader, writer = await asyncio.wait_for(asyncio.open_connection(host, port), timeout)
    key = base64.b64encode(os.urandom(16)).decode()
    extra = "".join(f"{name}: {value}\r\n" for name, value in (headers or {}).items())
    writer.write((
        f"GET {target} HTTP/1.1\r\nHost: {host}:{port}\r\nUpgrade: websocket\r\n"
        f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n"
        f"{extra}\r\n").encode("latin-1"))
    await writer.drain()
    start, response = await asyncio.wait_for(read_head(reader), timeout)
    fields = start.split(" ", 2)
    status = int(fields[1]) if len(fields) > 1 and fields[1].isdigit() else 0
    if status != 101 or response.get("sec-websocket-accept") != accept_key(key):
        length = int(response.get("content-length", "0") or 0)
        body = (await reader.readexactly(length)).decode("utf-8", "replace") if length else ""
        writer.close()
        raise WebSocketError(f"upgrade refused: {start} {body}".strip(), status)
    return WebSocket(reader, writer, client=True)
