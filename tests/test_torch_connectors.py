"""The port's network and connector agents against the JAX package's:
``http-request`` and ``langserve-invoke`` (``agents/http_request.py``, on
the port's ``agents/http_client.py``), ``exec-source``/``exec-sink``
(``agents/connector.py``), ``file-source``, ``s3-source`` and
``azure-blob-storage-source`` (``agents/storage.py``,
``agents/azure_blob.py``) and ``webcrawler-source``
(``agents/webcrawler.py``).

One local HTTP server per test (``http.server`` in a thread) plays the
remote side for both packages: an echo API (query, body, headers,
cookies, redirects, a 404), a LangServe runnable (``/invoke`` and a
chunked SSE ``/stream``), an S3 bucket that recomputes each request's
SigV4 signature from the AWS rules and refuses a wrong one, an Azure
container that does the same for Shared Key (and checks a SAS token),
and a small site with a ``robots.txt``. The same seeded records (numpy)
go through each package's agent; the records it returns or emits
(value, key, headers), the chunks it streams to a topic and what the
fakes saw must be equal.
"""

import asyncio
import base64
import contextlib
import email.utils
import hashlib
import hmac
import http.server
import json
import os
import sys
import threading
import urllib.parse

import numpy as np
import pytest

from torch_agent_pair import PACKAGES, WAIT_S, fields, make, outcome, process, read_until, topic


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # quiet
        pass

    def _serve(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        status, headers, payload = self.server.route(self, body)
        self.send_response(status)
        for name, value in headers:
            self.send_header(name, value)
        if isinstance(payload, (bytes, str)):
            data = payload.encode() if isinstance(payload, str) else payload
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:  # an iterator of chunks: chunked transfer encoding
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for chunk in payload:
                data = chunk.encode()
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")

    do_GET = do_POST = do_PUT = do_DELETE = _serve


class FakeServer(http.server.ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, route):
        super().__init__(("127.0.0.1", 0), _Handler)
        self.route = route
        self.seen = []
        threading.Thread(target=self.serve_forever, daemon=True).start()

    @property
    def base(self) -> str:
        return f"http://127.0.0.1:{self.server_address[1]}"


@contextlib.contextmanager
def serving(route):
    server = FakeServer(route)
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()


def run_both(scenario) -> dict:
    return {name: asyncio.run(asyncio.wait_for(scenario(pkg), 3 * WAIT_S))
            for name, pkg in PACKAGES.items()}


# ---------------------------------------------------------------------- #
# http-request
# ---------------------------------------------------------------------- #
def api_route(handler, body):
    parts = urllib.parse.urlsplit(handler.path)
    handler.server.seen.append((handler.command, parts.path))
    if parts.path == "/redirect":
        return 302, [("Location", "/api?from=redirect")], "moved"
    if parts.path == "/text":
        return 200, [("Content-Type", "text/plain; charset=utf-8")], f"plain {parts.query}"
    if parts.path != "/api":
        return 404, [("Content-Type", "text/plain")], "no such path"
    headers = [("Content-Type", "application/json")]
    cookie = handler.headers.get("Cookie")
    if cookie is None:
        headers.append(("Set-Cookie", f"sid=s{len(handler.server.seen)}; Path=/"))
    return 200, headers, json.dumps({
        "method": handler.command, "query": sorted(urllib.parse.parse_qsl(parts.query)),
        "body": body.decode(), "x": handler.headers.get("X-Test"), "cookie": cookie,
        "type": handler.headers.get("Content-Type")})


def city_records(pkg, count: int = 6, seed: int = 41) -> list:
    rng = np.random.default_rng(seed)
    return [pkg.Record(value={"city": f"c{i}", "lat": round(float(rng.uniform(-90, 90)), 4),
                              "lon": round(float(rng.uniform(-180, 180)), 4)},
                       key=f"k{i}", headers=(("h", str(i)),)) for i in range(count)]


@pytest.mark.parametrize("case", ["get", "post", "text", "redirect", "no-redirect",
                                  "no-cookies", "ip-cookies", "404"])
def test_http_request_like_jax(case):
    with serving(api_route) as server:
        host = server.base.replace("127.0.0.1", "127.0.0.1" if case == "ip-cookies" else "localhost")
        path = {"text": "/text", "redirect": "/redirect", "no-redirect": "/redirect",
                "404": "/missing"}.get(case, "/api")
        config = {"url": host + path + "?fixed=1",
                  "output-field": "value.api_response",
                  "query-string": {"latitude": "{{ value.lat }}", "longitude": "{{ value.lon }}",
                                   "q": "a b/c?d"},
                  "headers": {"X-Test": "city {{ value.city }}"}}
        if case == "post":
            config.update(method="POST", body='{"city": "{{ value.city }}"}')
        if case == "no-redirect":
            config["allow-redirects"] = False
        if case == "no-cookies":
            config["handle-cookies"] = False

        async def scenario(pkg):
            server.seen.clear()
            agent = await make(pkg, "http-request", config)
            results = await process(pkg, agent, city_records(pkg))
            await agent.close()
            shown = [r.status if hasattr(r, "status") else r for r in results]
            return outcome([r for r in shown if not isinstance(r, int)]), \
                [r for r in shown if isinstance(r, int)], list(server.seen)

        got = run_both(scenario)
    assert got["port"] == got["jax"]
    records, statuses, seen = got["port"]
    if case == "404":
        assert statuses == [404] * 6 and not records
        return
    assert len(records) == 6 and not statuses
    response = records[-1][0][0]["api_response"]
    if case in ("text", "no-redirect"):
        assert isinstance(response, str)
        return
    assert response["x"] == "city c5"
    if case == "redirect":
        assert response["query"] == [["from", "redirect"]] and len(seen) == 12
        return
    assert ["q", "a b/c?d"] in response["query"] and ["fixed", "1"] in response["query"]
    if case in ("get", "post"):  # the first answer's cookie, sent back
        assert response["cookie"] == "sid=s1"
    if case in ("no-cookies", "ip-cookies"):
        assert response["cookie"] is None


# ---------------------------------------------------------------------- #
# langserve-invoke
# ---------------------------------------------------------------------- #
def langserve_route(handler, body):
    payload = json.loads(body or b"{}")
    handler.server.seen.append((handler.path, payload))
    if handler.path.endswith("/invoke"):
        return 200, [("Content-Type", "application/json")], json.dumps(
            {"output": {"echo": payload["input"]}, "metadata": {"run_id": "r"}})
    words = f"{payload['input']['topic']} is one topic of many".split()

    def events():
        yield "event: metadata\ndata: {\"run_id\": \"r\"}\n\n"
        for word in words:
            yield f"event: data\ndata: {json.dumps(word + ' ')}\n\n"
        yield "event: data\ndata: {\"content\": \"end\"}\n\n"
        yield "event: end\ndata: [DONE]\n\n"

    return 200, [("Content-Type", "text/event-stream")], events()


@pytest.mark.parametrize("endpoint", ["invoke", "stream"])
def test_langserve_invoke_like_jax(endpoint):
    with serving(langserve_route) as server:
        config = {"url": f"{server.base}/chain/{endpoint}", "output-field": "value.answer",
                  "content-field": "value.chunk", "min-chunks-per-message": 3,
                  "fields": [{"name": "topic", "expression": "value.topic"},
                             {"name": "n", "expression": "value.n"}],
                  "headers": {"X-Test": "1"}}
        if endpoint == "stream":
            config["stream-to-topic"] = "chunks"

        async def scenario(pkg):
            server.seen.clear()
            runtime = pkg.runtime()
            agent = await make(pkg, "langserve-invoke", config, runtime=runtime)
            rng = np.random.default_rng(42)
            records = [pkg.Record(value={"topic": f"t{int(rng.integers(0, 99))}",
                                         "n": int(rng.integers(0, 9))}, key=f"k{i}")
                       for i in range(4)]
            results = outcome(await process(pkg, agent, records))
            await agent.close()
            return results, await topic(pkg, runtime, "chunks"), list(server.seen)

        got = run_both(scenario)
    assert got["port"] == got["jax"]
    results, chunks, seen = got["port"]
    assert len(results) == 4 and all(len(r) == 1 for r in results)
    if endpoint == "invoke":
        assert results[0][0][0]["answer"] == {"echo": seen[0][1]["input"]} and not chunks
    else:
        answer = results[0][0][0]["answer"]
        assert answer.endswith("many end") and chunks
        # the batching ramp 1, 2, 3, 3 ... over each answer's chunks
        assert [len(c[0]["chunk"].split()) for c in chunks[:4]] == [1, 2, 3, 1]


# ---------------------------------------------------------------------- #
# exec-source / exec-sink
# ---------------------------------------------------------------------- #
def test_exec_source_and_sink_like_jax(tmp_path):
    rng = np.random.default_rng(43)
    lines = [json.dumps({"n": int(n)}) for n in rng.integers(0, 100, size=5)] + ["not json", ""]
    script = tmp_path / "emit.py"
    script.write_text(f"import sys, time\nfor line in {lines!r}:\n    print(line)\n"
                      "sys.stdout.flush()\ntime.sleep(600)\n")

    async def scenario(pkg):
        out = {}
        for parse in (True, False):
            source = await make(pkg, "exec-source", {"command": f"{sys.executable} {script}",
                                                     "parse-json": parse})
            got = await read_until(source, 6)
            await source.close()
            out[parse] = [fields(r) for r in got]
        spool = tmp_path / f"sink-{id(pkg)}.txt"
        sink = await make(pkg, "exec-sink", {
            "command": f"{sys.executable} -c \"import sys; open({str(spool)!r}, 'w')"
                       ".write(sys.stdin.read())\""})
        for record in [pkg.Record(value=v) for v in ({"a": 1}, "text", [1, 2], b"by", None)]:
            await sink.write(record)
        await sink.close()
        out["sink"] = spool.read_text()
        return out

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    assert [v for v, _, _ in got["port"][True]][:5] == [json.loads(x) for x in lines[:5]]
    assert got["port"][False][5][0] == "not json"
    assert got["port"]["sink"].splitlines()[:2] == ['{"a": 1}', '"text"']


def test_exec_source_restarts_a_command_that_exits():
    """A command that prints and exits: each run's line comes, the
    command restarting after its exit. (JAX's ``exec-source`` spins on
    the EOF without yielding, so its exit is never seen; not run here.)"""
    async def main():
        pkg = PACKAGES["port"]
        source = await make(pkg, "exec-source", {
            "command": f"{sys.executable} -c \"print('{{\\\"run\\\": 1}}')\""})
        got = await read_until(source, 3)
        await source.close()
        return [fields(r) for r in got], source._restarts

    records, restarts = asyncio.run(asyncio.wait_for(main(), WAIT_S))
    assert records[:3] == [({"run": 1}, None, ())] * 3 and restarts >= 2


# ---------------------------------------------------------------------- #
# file-source, s3-source, azure-blob-storage-source
# ---------------------------------------------------------------------- #
def seeded_objects(seed: int = 44) -> dict:
    rng = np.random.default_rng(seed)
    names = ["a.txt", "b.md", "c.txt", "d d.txt", "e.bin", "sub/f.txt"]
    return {name: bytes(rng.integers(0, 256, size=int(rng.integers(1, 64))).astype(np.uint8))
            for name in names}


def test_file_source_like_jax(tmp_path):
    async def scenario(pkg):
        root = tmp_path / f"files-{id(pkg)}"
        root.mkdir()
        for name, data in seeded_objects().items():
            if "/" not in name:
                (root / name).write_bytes(data)
        agent = await make(pkg, "file-source", {"path": str(root), "file-extensions": "txt,md",
                                                "delete-objects": True, "idle-time": 0})
        first = await agent.read(max_records=2)
        rest = await agent.read()
        await agent.commit(first + rest)
        again = await agent.read()
        await agent.close()
        return [fields(r) for r in first + rest], again, sorted(os.listdir(root))

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    records, again, left = got["port"]
    assert [key for _, key, _ in records] == ["a.txt", "b.md", "c.txt", "d d.txt"]
    assert again == [] and left == ["e.bin"]


ACCESS, SECRET, REGION = "AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY", "eu-west-1"


def verify_sigv4(handler, body: bytes) -> None:
    """The AWS Signature Version 4 of an S3 request, recomputed from the
    request as received: raises AssertionError when it differs."""
    auth = handler.headers["Authorization"]
    assert auth.startswith("AWS4-HMAC-SHA256 "), auth
    parts = dict(item.strip().split("=", 1) for item in auth[len("AWS4-HMAC-SHA256 "):].split(","))
    access, date, region, service, terminal = parts["Credential"].split("/")
    assert (access, region, service, terminal) == (ACCESS, REGION, "s3", "aws4_request")
    signed = parts["SignedHeaders"].split(";")
    assert {"host", "x-amz-date", "x-amz-content-sha256"} <= set(signed)
    payload_hash = hashlib.sha256(body).hexdigest()
    assert handler.headers["x-amz-content-sha256"] == payload_hash
    path, _, raw_query = handler.path.partition("?")
    pairs = urllib.parse.parse_qsl(raw_query, keep_blank_values=True)
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(pairs))
    canonical_headers = "".join(f"{name}:{handler.headers[name].strip()}\n" for name in signed)
    request = "\n".join([handler.command, path, canonical_query, canonical_headers,
                         ";".join(signed), payload_hash])
    amz_date = handler.headers["x-amz-date"]
    assert amz_date.startswith(date)
    to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, f"{date}/{region}/s3/aws4_request",
                         hashlib.sha256(request.encode()).hexdigest()])
    key = f"AWS4{SECRET}".encode()
    for part in (date, region, "s3", "aws4_request"):
        key = hmac.new(key, part.encode(), hashlib.sha256).digest()
    want = hmac.new(key, to_sign.encode(), hashlib.sha256).hexdigest()
    assert hmac.compare_digest(want, parts["Signature"]), "SigV4 signature differs"


def s3_route(objects, page: int = 2):
    def route(handler, body):
        try:
            verify_sigv4(handler, body)
        except AssertionError as error:
            handler.server.seen.append(("refused", str(error)))
            return 403, [("Content-Type", "application/xml")], "<Error>SignatureDoesNotMatch</Error>"
        path, _, raw_query = handler.path.partition("?")
        query = dict(urllib.parse.parse_qsl(raw_query))
        bucket, _, key = path.lstrip("/").partition("/")
        key = urllib.parse.unquote(key)
        handler.server.seen.append((handler.command, bucket, key, query.get("continuation-token")))
        if bucket != "docs":
            return 404, [], "<Error>NoSuchBucket</Error>"
        if handler.command == "GET" and not key:
            names = sorted(n for n in objects if n.startswith(query.get("prefix", "")))
            start = int(query.get("continuation-token") or 0)
            shown = names[start:start + page]
            more = start + page < len(names)
            contents = "".join(f"<Contents><Key>{n}</Key><Size>{len(objects[n])}</Size>"
                               f"<ETag>\"{hashlib.md5(objects[n]).hexdigest()}\"</ETag></Contents>"
                               for n in shown)
            tail = (f"<IsTruncated>true</IsTruncated><NextContinuationToken>{start + page}"
                    "</NextContinuationToken>" if more else "<IsTruncated>false</IsTruncated>")
            return 200, [("Content-Type", "application/xml")], (
                '<?xml version="1.0" encoding="UTF-8"?><ListBucketResult '
                f'xmlns="http://s3.amazonaws.com/doc/2006-03-01/">{contents}{tail}</ListBucketResult>')
        if handler.command == "GET":
            return (200, [], objects[key]) if key in objects else (404, [], "")
        if handler.command == "DELETE":
            objects.pop(key, None)
            return 204, [], b""
        return 405, [], ""
    return route


@pytest.mark.parametrize("secret", [SECRET, "wrong-secret"])
def test_s3_source_signs_and_reads_like_jax(secret):
    def scenario_for(server, objects):
        async def scenario(pkg):
            objects.clear()
            objects.update(seeded_objects())
            server.seen.clear()
            agent = await make(pkg, "s3-source", {
                "endpoint": server.base, "bucketName": "docs", "access-key": ACCESS,
                "secret-key": secret, "region": REGION, "file-extensions": "txt",
                "idle-time": 0})
            try:
                records = await agent.read()
                await agent.commit(records)
                again = await agent.read()
                result = [fields(r) for r in records], again, sorted(objects)
            except IOError as error:
                result = ("IOError", "HTTP 403" in str(error))
            await agent.close()
            return result, [s for s in server.seen if s[0] != "refused"]
        return scenario

    objects: dict = {}
    with serving(s3_route(objects)) as server:
        got = run_both(scenario_for(server, objects))
    assert got["port"] == got["jax"]
    result, seen = got["port"]
    if secret != SECRET:
        assert result == ("IOError", True) and seen == []
        return
    records, again, left = result
    assert [key for _, key, _ in records] == ["a.txt", "c.txt", "d d.txt", "sub/f.txt"]
    assert records[0][2] == (("name", "a.txt"),) and again == []
    assert left == ["b.md", "e.bin"]
    assert ("GET", "docs", "", "2") in seen  # the listing's second page


ACCOUNT = "devaccount"
ACCOUNT_KEY = base64.b64encode(bytes(np.random.default_rng(45).integers(
    0, 256, size=32).astype(np.uint8))).decode()
SAS = "sv=2021-08-06&ss=b&srt=co&sp=rld&sig=c2lnbmF0dXJl"


def verify_shared_key(handler, body: bytes) -> None:
    """Azure Storage's Shared Key signature of a request, recomputed from
    the request as received."""
    auth = handler.headers["Authorization"]
    assert auth and auth.startswith(f"SharedKey {ACCOUNT}:"), auth
    path, _, raw_query = handler.path.partition("?")
    headers = {name.lower(): value for name, value in handler.headers.items()}
    canonical_headers = "".join(f"{name}:{headers[name]}\n"
                                for name in sorted(n for n in headers if n.startswith("x-ms-")))
    resource = path  # path-style: /<account>/<container>[/<blob>], as signed
    for name, value in sorted(urllib.parse.parse_qsl(raw_query)):
        resource += f"\n{name}:{value}"
    length = headers.get("content-length", "")
    to_sign = "\n".join([handler.command, "", "", "" if length in ("", "0") else length, "",
                         headers.get("content-type", ""), "", "", "", "", "", "",
                         canonical_headers + resource])
    want = base64.b64encode(hmac.new(base64.b64decode(ACCOUNT_KEY), to_sign.encode(),
                                     hashlib.sha256).digest()).decode()
    assert hmac.compare_digest(auth.split(":", 1)[1], want), "Shared Key signature differs"
    date = email.utils.parsedate_to_datetime(headers["x-ms-date"])
    assert date.tzinfo is not None


def azure_route(objects, sas: bool, page: int = 2):
    def route(handler, body):
        path, _, raw_query = handler.path.partition("?")
        query = dict(urllib.parse.parse_qsl(raw_query))
        try:
            if sas:
                assert "Authorization" not in handler.headers
                assert all(query.get(k) == v for k, v in urllib.parse.parse_qsl(SAS)), query
            else:
                verify_shared_key(handler, body)
        except AssertionError as error:
            handler.server.seen.append(("refused", str(error)))
            return 403, [], "<Error>AuthenticationFailed</Error>"
        account, container, *blob = path.lstrip("/").split("/", 2)
        blob = urllib.parse.unquote(blob[0]) if blob else ""
        handler.server.seen.append((handler.command, container, blob, query.get("marker")))
        if (account, container) != (ACCOUNT, "box"):
            return 404, [], ""
        if handler.command == "GET" and query.get("comp") == "list":
            names = sorted(objects)
            start = int(query.get("marker") or 0)
            shown = names[start:start + page]
            marker = str(start + page) if start + page < len(names) else ""
            items = "".join(f"<Blob><Name>{n}</Name><Properties><Content-Length>"
                            f"{len(objects[n])}</Content-Length></Properties></Blob>" for n in shown)
            return 200, [("Content-Type", "application/xml")], (
                f"<?xml version=\"1.0\"?><EnumerationResults><Blobs>{items}</Blobs>"
                f"<NextMarker>{marker}</NextMarker></EnumerationResults>")
        if handler.command == "GET":
            return (200, [], objects[blob]) if blob in objects else (404, [], "")
        if handler.command == "DELETE":
            objects.pop(blob, None)
            return 202, [], b""
        return 405, [], ""
    return route


@pytest.mark.parametrize("auth", ["shared-key", "sas", "connection-string", "wrong-key"])
def test_azure_blob_source_signs_and_reads_like_jax(auth):
    def scenario_for(server, objects):
        async def scenario(pkg):
            objects.clear()
            objects.update(seeded_objects())
            server.seen.clear()
            config = {"container": "box", "file-extensions": "txt", "idle-time": 0}
            endpoint = f"{server.base}/{ACCOUNT}"
            if auth == "sas":
                config.update(endpoint=endpoint, **{"sas-token": "?" + SAS})
            elif auth == "connection-string":
                config["storage-account-connection-string"] = (
                    f"DefaultEndpointsProtocol=http;AccountName={ACCOUNT};"
                    f"AccountKey={ACCOUNT_KEY};BlobEndpoint={endpoint};")
            else:
                key = ACCOUNT_KEY if auth == "shared-key" else base64.b64encode(b"x" * 32).decode()
                config.update(endpoint=endpoint, **{"storage-account-name": ACCOUNT,
                                                    "storage-account-key": key})
            agent = await make(pkg, "azure-blob-storage-source", config)
            try:
                records = await agent.read()
                await agent.commit(records)
                result = [fields(r) for r in records], sorted(objects)
            except IOError as error:
                result = ("IOError", "HTTP 403" in str(error))
            await agent.close()
            return result, [s for s in server.seen if s[0] != "refused"]
        return scenario

    objects: dict = {}
    with serving(azure_route(objects, sas=auth == "sas")) as server:
        got = run_both(scenario_for(server, objects))
    assert got["port"] == got["jax"]
    result, seen = got["port"]
    if auth == "wrong-key":
        assert result == ("IOError", True) and seen == []
        return
    records, left = result
    assert [key for _, key, _ in records] == ["a.txt", "c.txt", "d d.txt", "sub/f.txt"]
    assert left == ["b.md", "e.bin"] and ("GET", "box", "", "2") in seen


# ---------------------------------------------------------------------- #
# webcrawler-source
# ---------------------------------------------------------------------- #
SITE = {
    "/robots.txt": ("text/plain", "User-agent: *\nDisallow: /private\n"),
    "/index.html": ("text/html; charset=utf-8",
                    '<html><body><a href="/a.html">a</a> <a href="b.txt">b</a>'
                    '<a href="/private/secret.html">s</a><a href="http://elsewhere.invalid/x">x</a>'
                    '<a href="/a.html#frag">again</a><a name="no-href">n</a>'
                    '<A HREF="/c.html">c</A></body></html>'),
    "/a.html": ("text/html", '<p><a href="/d.html"/><a href="index.html">home</a></p>'),
    "/b.txt": ("text/plain", "plain text, no links: <a href='/never.html'>"),
    "/c.html": ("text/html", "<a href='/missing.html'>gone</a> &amp; <a href=/a.html>a</a>"),
    "/d.html": ("text/html", "<html>leaf</html>"),
    "/private/secret.html": ("text/html", "secret"),
}


def site_route(handler, body):
    handler.server.seen.append(handler.path)
    if handler.path not in SITE:
        return 404, [("Content-Type", "text/plain")], "missing"
    content_type, text = SITE[handler.path]
    return 200, [("Content-Type", content_type)], text


def test_webcrawler_crawls_resumes_and_honours_robots_like_jax(tmp_path):
    def scenario_for(server):
        async def scenario(pkg):
            config = {"seed-urls": [f"{server.base}/index.html"], "allowed-domains": [server.base],
                      "min-time-between-requests": 0, "max-urls": 50,
                      "user-agent": "test-crawler"}
            server.seen.clear()
            os.makedirs(tmp_path / f"full-{id(pkg)}")
            full = await make(pkg, "webcrawler-source", config,
                              state_dir=str(tmp_path / f"full-{id(pkg)}"))
            crawled = await read_until(full, 5)
            await full.close()
            fetched = list(server.seen)
            state = str(tmp_path / f"resume-{id(pkg)}")
            os.makedirs(state)
            first = await make(pkg, "webcrawler-source", config, state_dir=state)
            part = await read_until(first, 2)
            await first.close()
            with open(os.path.join(state, "webcrawler.status.json")) as fh:
                saved = json.load(fh)
            second = await make(pkg, "webcrawler-source", config, state_dir=state)
            part += await read_until(second, 3)
            await second.close()
            return ([fields(r) for r in crawled], [fields(r) for r in part], fetched,
                    sorted(saved["visited"]), saved["frontier"])
        return scenario

    with serving(site_route) as server:
        got = run_both(scenario_for(server))
        base = server.base
    assert got["port"] == got["jax"]
    crawled, resumed, fetched, visited, frontier = got["port"]
    assert [key for _, key, _ in crawled] == [f"{base}/{p}" for p in (
        "index.html", "a.html", "b.txt", "c.html", "d.html")]
    assert resumed == crawled
    assert "/private/secret.html" not in fetched and fetched.count("/robots.txt") == 1
    assert crawled[0][2] == (("url", f"{base}/index.html"),
                             ("content_type", "text/html; charset=utf-8"))
    assert len(visited) == 2 and frontier


def test_the_port_imports_no_aiohttp_yaml_or_bs4():
    """The card's machine has none of them: every module of the port, the
    isolation child's entry among them, imports none of them (the JAX
    package's network agents, plugins and crawler do)."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "langstream_tpu_torch"
    files = sorted(root.rglob("*.py"))
    assert root / "agents" / "isolation.py" in files and root / "agents" / "http_client.py" in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            names = ([alias.name for alias in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            for name in names:
                assert name.split(".")[0] not in ("aiohttp", "yaml", "bs4"), (path, name)
