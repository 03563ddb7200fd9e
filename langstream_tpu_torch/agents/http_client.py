"""The agents' HTTP/1.1 client, on asyncio streams.

The JAX package's network agents (``http-request``, ``langserve-invoke``,
the S3 and Azure sources, ``webcrawler-source``) call out through
``aiohttp``, which the card's machine does not have. This is the one
client they share in the port: a request per connection
(``Connection: close``), ``http`` and ``https`` (the default TLS
context), ``Content-Length``, chunked and read-to-close bodies, redirects
followed as aiohttp follows them, and a cookie jar that, as aiohttp's
default jar, keeps no cookie from a host that is an IP address.

:func:`request` reads the whole body; :func:`open_stream` returns the
response with its body unread, for :meth:`Response.iter_lines` (the
streamed LangServe form). Non-2xx answers come back as responses;
:meth:`Response.raise_for_status` raises :class:`HttpError` for 4xx/5xx,
as aiohttp's does.
"""

from __future__ import annotations

import asyncio
import ipaddress
import json as _json
import urllib.parse
from http.cookies import SimpleCookie
from typing import Any, AsyncIterator, Dict, List, Mapping, Optional

DEFAULT_TIMEOUT_S = 300.0  # aiohttp's default total timeout
MAX_REDIRECTS = 10
USER_AGENT = "langstream-tpu-torch"
_REDIRECTS = (301, 302, 303, 307, 308)


class HttpError(IOError):
    """A 4xx/5xx answer (``raise_for_status``)."""

    def __init__(self, status: int, reason: str, url: str) -> None:
        super().__init__(f"{status}, message={reason!r}, url={url!r}")
        self.status = status


class CookieJar:
    """Cookies by host. As aiohttp's default jar (``unsafe=False``), a
    cookie set by a host that is an IP address is not kept."""

    def __init__(self) -> None:
        self._cookies: Dict[str, Dict[str, str]] = {}

    @staticmethod
    def _is_ip(host: str) -> bool:
        try:
            ipaddress.ip_address(host.strip("[]"))
            return True
        except ValueError:
            return False

    def update(self, host: str, set_cookie: List[str]) -> None:
        if self._is_ip(host):
            return
        for header in set_cookie:
            parsed = SimpleCookie()
            parsed.load(header)
            for name, morsel in parsed.items():
                domain = (morsel["domain"] or host).lstrip(".").lower()
                self._cookies.setdefault(domain, {})[name] = morsel.value

    def header(self, host: str) -> Optional[str]:
        host = host.lower()
        pairs = {}
        for domain, cookies in self._cookies.items():
            if host == domain or host.endswith("." + domain):
                pairs.update(cookies)
        return "; ".join(f"{k}={v}" for k, v in pairs.items()) or None


class _Headers(dict):
    """Response headers by lower-cased name; ``get`` ignores case."""

    def get(self, name: str, default: Any = None) -> Any:  # type: ignore[override]
        return super().get(name.lower(), default)

    def __getitem__(self, name: str) -> Any:
        return super().__getitem__(name.lower())

    def __contains__(self, name: object) -> bool:
        return super().__contains__(str(name).lower())


class Response:
    def __init__(self, url: str, status: int, reason: str, headers: _Headers,
                 reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 method: str) -> None:
        self.url = url
        self.status = status
        self.reason = reason
        self.headers = headers
        self._reader = reader
        self._writer = writer
        self._method = method
        self._body: Optional[bytes] = None

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "").split(";")[0].strip().lower()

    @property
    def charset(self) -> str:
        for part in self.headers.get("content-type", "").split(";")[1:]:
            name, _, value = part.strip().partition("=")
            if name.lower() == "charset" and value:
                return value.strip('"')
        return "utf-8"

    def raise_for_status(self) -> None:
        if self.status >= 400:
            raise HttpError(self.status, self.reason, self.url)

    async def _chunks(self) -> AsyncIterator[bytes]:
        """The body's bytes as they arrive: chunked, by ``Content-Length``,
        or until the server closes."""
        reader = self._reader
        if self._method == "HEAD" or self.status in (204, 304) or 100 <= self.status < 200:
            return
        if "chunked" in self.headers.get("transfer-encoding", "").lower():
            while True:
                size_line = await reader.readline()
                if not size_line:
                    return
                size = int(size_line.split(b";")[0].strip() or b"0", 16)
                if size == 0:
                    while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                        pass  # trailers
                    return
                data = await reader.readexactly(size)
                await reader.readline()
                yield data
        elif "content-length" in self.headers:
            left = int(self.headers["content-length"])
            while left > 0:
                data = await reader.read(min(left, 65536))
                if not data:
                    raise asyncio.IncompleteReadError(b"", left)
                left -= len(data)
                yield data
        else:
            while True:
                data = await reader.read(65536)
                if not data:
                    return
                yield data

    async def read(self) -> bytes:
        if self._body is None:
            self._body = b"".join([chunk async for chunk in self._chunks()])
            self.close()
        return self._body

    async def text(self) -> str:
        return (await self.read()).decode(self.charset, "replace")

    async def json(self) -> Any:
        if "json" not in self.content_type:
            raise ValueError(
                f"attempt to decode JSON with unexpected mimetype: {self.content_type!r}")
        return _json.loads((await self.read()).decode(self.charset))

    async def iter_lines(self) -> AsyncIterator[bytes]:
        """The body's lines as they arrive, each with its ``\\n`` (the
        last may lack it), as ``aiohttp``'s ``response.content`` yields."""
        buffer = b""
        async for chunk in self._chunks():
            buffer += chunk
            while b"\n" in buffer:
                line, buffer = buffer.split(b"\n", 1)
                yield line + b"\n"
        if buffer:
            yield buffer
        self.close()

    def close(self) -> None:
        self._writer.close()


# what aiohttp's URL library leaves unescaped in a query's names and values
_QUERY_SAFE = "?/:@!$'()*,"


def _with_params(url: str, params: Optional[Mapping[str, Any]]) -> str:
    """``url`` with ``params`` appended to its query, escaped as aiohttp
    escapes them (space as ``+``), so the same bytes go on the wire."""
    if not params:
        return url
    parts = urllib.parse.urlsplit(url)
    extra = urllib.parse.urlencode([(str(k), str(v)) for k, v in params.items()],
                                   safe=_QUERY_SAFE)
    query = f"{parts.query}&{extra}" if parts.query else extra
    return urllib.parse.urlunsplit(parts._replace(query=query))


async def _send_once(method: str, url: str, headers: Dict[str, str], body: Optional[bytes],
                     jar: Optional[CookieJar]) -> Response:
    parts = urllib.parse.urlsplit(url)
    if parts.scheme not in ("http", "https"):
        raise ValueError(f"unsupported URL scheme in {url!r}")
    host = parts.hostname or ""
    port = parts.port or (443 if parts.scheme == "https" else 80)
    reader, writer = await asyncio.open_connection(
        host, port, ssl=True if parts.scheme == "https" else None)
    target = parts.path or "/"
    if parts.query:
        target += "?" + parts.query
    names = {name.lower() for name in headers}
    lines = [f"{method} {target} HTTP/1.1"]
    if "host" not in names:
        default = (parts.scheme == "http" and port == 80) or (parts.scheme == "https" and port == 443)
        lines.append(f"Host: {parts.hostname if default else parts.netloc.rpartition('@')[2]}")
    lines += [f"{name}: {value}" for name, value in headers.items()]
    if "user-agent" not in names:
        lines.append(f"User-Agent: {USER_AGENT}")
    if "accept" not in names:
        lines.append("Accept: */*")
    cookie = jar.header(host) if jar is not None else None
    if cookie and "cookie" not in names:
        lines.append(f"Cookie: {cookie}")
    if body is not None or method in ("POST", "PUT", "PATCH"):
        lines.append(f"Content-Length: {len(body or b'')}")
    lines.append("Connection: close")
    writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + (body or b""))
    await writer.drain()
    status_line = (await reader.readline()).decode("latin-1").rstrip("\r\n")
    if not status_line:
        writer.close()
        raise ConnectionError(f"{url}: the server closed the connection without an answer")
    _version, _, rest = status_line.partition(" ")
    code, _, reason = rest.partition(" ")
    response_headers = _Headers()
    set_cookie: List[str] = []
    while True:
        line = (await reader.readline()).decode("latin-1").rstrip("\r\n")
        if not line:
            break
        name, _, value = line.partition(":")
        name, value = name.strip().lower(), value.strip()
        if name == "set-cookie":
            set_cookie.append(value)
        response_headers[name] = (f"{response_headers[name]}, {value}"
                                  if name in response_headers else value)
    if jar is not None and set_cookie:
        jar.update(host, set_cookie)
    return Response(url, int(code), reason, response_headers, reader, writer, method)


async def _open(method: str, url: str, *, params: Optional[Mapping[str, Any]] = None,
                headers: Optional[Mapping[str, Any]] = None, data: Any = None, json: Any = None,
                allow_redirects: bool = True, jar: Optional[CookieJar] = None) -> Response:
    method = method.upper()
    url = _with_params(url, params)
    sent = {str(k): str(v) for k, v in (headers or {}).items()}
    names = {name.lower() for name in sent}
    body: Optional[bytes] = None
    if json is not None:
        body = _json.dumps(json).encode("utf-8")
        if "content-type" not in names:
            sent["Content-Type"] = "application/json"
    elif isinstance(data, str):
        body = data.encode("utf-8")
        if "content-type" not in names:
            sent["Content-Type"] = "text/plain; charset=utf-8"
    elif data is not None:
        body = bytes(data)
    for _ in range(MAX_REDIRECTS + 1):
        response = await _send_once(method, url, sent, body, jar)
        location = response.headers.get("location")
        if not allow_redirects or response.status not in _REDIRECTS or not location:
            return response
        response.close()
        url = urllib.parse.urljoin(url, location)
        if response.status == 303 or (response.status in (301, 302) and method == "POST"):
            method, body = "GET", None
            sent = {k: v for k, v in sent.items() if k.lower() != "content-type"}
    raise HttpError(response.status, "too many redirects", url)


async def open_stream(method: str, url: str, *, timeout: float = DEFAULT_TIMEOUT_S,
                      **kwargs) -> Response:
    """The response with its body unread (:meth:`Response.iter_lines`)."""
    return await asyncio.wait_for(_open(method, url, **kwargs), timeout)


async def request(method: str, url: str, *, timeout: float = DEFAULT_TIMEOUT_S,
                  **kwargs) -> Response:
    """One request with its whole body read (:meth:`Response.read`):
    ``params`` extend the URL's query, ``data`` (str or bytes) or ``json``
    is the body, ``jar`` a :class:`CookieJar`."""

    async def whole() -> Response:
        response = await _open(method, url, **kwargs)
        try:
            await response.read()
        finally:
            response.close()
        return response

    return await asyncio.wait_for(whole(), timeout)

