"""Azure Blob Storage over the REST API (no Azure SDK).

Reference: ``langstream-agent-azure-blob-storage-source/.../
AzureBlobStorageSource.java:39`` and the Azure ``CodeStorage`` impl.
Auth: either a SAS token (query-string credential) or Shared Key
(HMAC-SHA256 over the canonicalized request, the classic storage-account
key scheme) — both implemented directly, mirroring how ``agents/storage``
implements SigV4 for S3.

The port's own copy of ``langstream_tpu/agents/azure_blob.py``, over the
port's HTTP client (``agents/http_client.py``) where the JAX package uses
``aiohttp``; the signature is the same.
"""

from __future__ import annotations

import base64
import email.utils
import hashlib
import hmac
import urllib.parse
from typing import Any, Dict, List, Optional
from xml.etree import ElementTree

from langstream_tpu_torch.agents import http_client


class AzureBlobClient:
    def __init__(
        self,
        *,
        endpoint: str,
        container: str,
        account: Optional[str] = None,
        account_key: Optional[str] = None,
        sas_token: Optional[str] = None,
    ) -> None:
        self.endpoint = endpoint.rstrip("/")
        self.container = container
        parsed = urllib.parse.urlparse(self.endpoint)
        if account:
            self.account = account
        elif parsed.path.strip("/"):
            # path-style endpoint (Azurite / emulators):
            # http://host:port/<account> — the account is the path
            self.account = parsed.path.strip("/").split("/")[0]
        else:
            self.account = parsed.netloc.split(".")[0]
        self.account_key = account_key
        self.sas_token = (sas_token or "").lstrip("?")

    async def close(self) -> None:
        pass  # a connection per request: nothing stays open

    # -- shared key signing --------------------------------------------- #
    def _sign(
        self, method: str, path: str, query: Dict[str, str],
        headers: Dict[str, str], content_length: int,
    ) -> Dict[str, str]:
        # RFC 1123 in C locale — strftime('%a/%b') is locale-dependent
        # and a localized day name breaks the Shared Key signature
        now = email.utils.formatdate(usegmt=True)
        headers = {
            **headers,
            "x-ms-date": now,
            "x-ms-version": "2021-08-06",
        }
        if not self.account_key:
            return headers
        canonical_headers = "".join(
            f"{name}:{headers[name]}\n"
            for name in sorted(h for h in headers if h.startswith("x-ms-"))
        )
        canonical_resource = f"/{self.account}{path}"
        for name in sorted(query):
            canonical_resource += f"\n{name}:{query[name]}"
        string_to_sign = "\n".join([
            method,
            "",                                     # Content-Encoding
            "",                                     # Content-Language
            str(content_length) if content_length else "",
            "",                                     # Content-MD5
            headers.get("content-type", ""),        # Content-Type
            "",                                     # Date (x-ms-date used)
            "", "", "", "", "",                     # If-*/Range
            canonical_headers + canonical_resource,
        ])
        key = base64.b64decode(self.account_key)
        signature = base64.b64encode(
            hmac.new(key, string_to_sign.encode(), hashlib.sha256).digest()
        ).decode()
        headers["Authorization"] = f"SharedKey {self.account}:{signature}"
        return headers

    async def _request(
        self, method: str, blob: Optional[str],
        query: Optional[Dict[str, str]] = None,
        body: bytes = b"", headers: Optional[Dict[str, str]] = None,
    ) -> bytes:
        query = dict(query or {})
        path = f"/{self.container}"
        if blob:
            path += f"/{urllib.parse.quote(blob)}"
        signed = self._sign(
            method, path, query, dict(headers or {}), len(body)
        )
        query_string = urllib.parse.urlencode(query)
        if self.sas_token:
            query_string = (
                f"{query_string}&{self.sas_token}"
                if query_string else self.sas_token
            )
        url = f"{self.endpoint}{path}"
        if query_string:
            url += f"?{query_string}"
        response = await http_client.request(
            method, url, data=body or None, headers=signed
        )
        payload = await response.read()
        if response.status >= 300:
            raise IOError(
                f"azure {method} {path}: HTTP {response.status}: "
                f"{payload[:400]!r}"
            )
        return payload

    # -- blob ops ------------------------------------------------------- #
    async def list_blobs(self, prefix: str = "") -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        marker = ""
        while True:
            query = {"restype": "container", "comp": "list"}
            if prefix:
                query["prefix"] = prefix
            if marker:
                query["marker"] = marker
            payload = await self._request("GET", None, query)
            root = ElementTree.fromstring(payload)
            for blob in root.iter("Blob"):
                name = blob.findtext("Name")
                size = blob.findtext("Properties/Content-Length") or "0"
                out.append({"name": name, "size": int(size)})
            marker = root.findtext("NextMarker") or ""
            if not marker:
                return out

    async def get_blob(self, name: str) -> bytes:
        return await self._request("GET", name)

    async def put_blob(self, name: str, body: bytes) -> None:
        await self._request(
            "PUT", name, body=body,
            headers={"x-ms-blob-type": "BlockBlob",
                     "content-type": "application/octet-stream"},
        )

    async def delete_blob(self, name: str) -> None:
        await self._request("DELETE", name)


def parse_connection_string(connection: str) -> Dict[str, Optional[str]]:
    """Parse the standard ``AccountName=...;AccountKey=...;...`` form."""
    parts: Dict[str, str] = {}
    for piece in connection.split(";"):
        name, _, value = piece.partition("=")
        if name:
            parts[name.strip()] = value.strip()
    endpoint = parts.get("BlobEndpoint")
    account = parts.get("AccountName")
    if not endpoint and account:
        suffix = parts.get("EndpointSuffix", "core.windows.net")
        protocol = parts.get("DefaultEndpointsProtocol", "https")
        endpoint = f"{protocol}://{account}.blob.{suffix}"
    return {
        "endpoint": endpoint,
        "account": account,
        "key": parts.get("AccountKey"),
    }
