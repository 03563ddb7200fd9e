"""Object-store sources: S3 (native SigV4 REST client), local files, Azure.

Equivalent of the reference's storage sources
(``langstream-agents/langstream-agent-s3/.../S3Source.java:51`` and
``langstream-agent-azure-blob-storage-source/.../AzureBlobStorageSource.java:39``):
list objects in a bucket, emit one record per object, optionally delete
after downstream processing commits (``delete-objects``).

The S3 client here is a minimal SigV4 implementation (no boto3) that
works against AWS S3 and MinIO; Azure rides the native REST client in
``agents/azure_blob.py`` (Shared Key or SAS auth, no Azure SDK).
``file-source`` reads a local directory — the zero-infra analogue used by
tests and local runs.

The port's own copy of ``langstream_tpu/agents/storage.py``; both clients
speak through the port's HTTP client (``agents/http_client.py``) where the
JAX package uses ``aiohttp``, and sign the same requests.
"""

from __future__ import annotations

import asyncio
import datetime
import hashlib
import hmac
import os
import urllib.parse
from typing import Any, Dict, List, Optional
from xml.etree import ElementTree

from langstream_tpu_torch.agents import http_client
from langstream_tpu_torch.api.agent import AgentSource
from langstream_tpu_torch.api.records import Record


# ---------------------------------------------------------------------- #
# minimal SigV4 S3 client
# ---------------------------------------------------------------------- #
class S3Client:
    def __init__(
        self,
        *,
        endpoint: str,
        access_key: str,
        secret_key: str,
        region: str = "us-east-1",
    ) -> None:
        self.endpoint = endpoint.rstrip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    async def close(self) -> None:
        pass  # a connection per request: nothing stays open

    def _sign(self, method: str, path: str, query: str, headers: Dict[str, str],
              payload_hash: str) -> Dict[str, str]:
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        date_stamp = now.strftime("%Y%m%d")
        host = urllib.parse.urlparse(self.endpoint).netloc
        headers = {**headers, "host": host, "x-amz-date": amz_date,
                   "x-amz-content-sha256": payload_hash}
        signed_names = ";".join(sorted(headers))
        canonical_headers = "".join(
            f"{name}:{headers[name].strip()}\n" for name in sorted(headers)
        )
        canonical_request = "\n".join(
            [method, path, query, canonical_headers, signed_names, payload_hash]
        )
        scope = f"{date_stamp}/{self.region}/s3/aws4_request"
        string_to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical_request.encode()).hexdigest(),
            ]
        )

        def _hmac(key: bytes, message: str) -> bytes:
            return hmac.new(key, message.encode(), hashlib.sha256).digest()

        key = _hmac(f"AWS4{self.secret_key}".encode(), date_stamp)
        key = _hmac(key, self.region)
        key = _hmac(key, "s3")
        key = _hmac(key, "aws4_request")
        signature = hmac.new(key, string_to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed_names}, Signature={signature}"
        )
        return headers

    async def _request(self, method: str, path: str, query: Dict[str, str],
                       body: bytes = b"") -> bytes:
        payload_hash = hashlib.sha256(body).hexdigest()
        query_string = "&".join(
            f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
            for k, v in sorted(query.items())
        )
        headers = self._sign(method, path, query_string, {}, payload_hash)
        url = f"{self.endpoint}{path}" + (f"?{query_string}" if query_string else "")
        resp = await http_client.request(method, url, data=body, headers=headers)
        payload = await resp.read()
        if resp.status >= 300:
            raise IOError(f"S3 {method} {path}: HTTP {resp.status}: {payload[:500]!r}")
        return payload

    async def list_objects(self, bucket: str, prefix: str = "") -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        token: Optional[str] = None
        while True:
            query = {"list-type": "2", "prefix": prefix}
            if token:
                query["continuation-token"] = token
            payload = await self._request("GET", f"/{bucket}", query)
            root = ElementTree.fromstring(payload)
            ns = root.tag.split("}")[0] + "}" if root.tag.startswith("{") else ""
            for contents in root.findall(f"{ns}Contents"):
                out.append(
                    {
                        "key": contents.findtext(f"{ns}Key"),
                        "size": int(contents.findtext(f"{ns}Size") or 0),
                        "etag": (contents.findtext(f"{ns}ETag") or "").strip('"'),
                    }
                )
            if root.findtext(f"{ns}IsTruncated") != "true":
                return out
            token = root.findtext(f"{ns}NextContinuationToken")
            if not token:
                return out

    async def get_object(self, bucket: str, key: str) -> bytes:
        return await self._request("GET", f"/{bucket}/{urllib.parse.quote(key)}", {})

    async def put_object(self, bucket: str, key: str, body: bytes) -> None:
        await self._request("PUT", f"/{bucket}/{urllib.parse.quote(key)}", {}, body)

    async def delete_object(self, bucket: str, key: str) -> None:
        await self._request("DELETE", f"/{bucket}/{urllib.parse.quote(key)}", {})


class S3Source(AgentSource):
    """Emit one record per S3 object; delete on commit when configured
    (``S3Source.java:51`` semantics: idle-poll the bucket, remember
    processed keys, ``delete-objects`` after commit)."""

    agent_type = "s3-source"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.bucket = configuration.get("bucketName", "langstream-source")
        self.client = S3Client(
            endpoint=configuration.get("endpoint", "https://s3.amazonaws.com"),
            access_key=configuration.get("access-key", ""),
            secret_key=configuration.get("secret-key", ""),
            region=configuration.get("region", "us-east-1"),
        )
        self.delete_after = bool(configuration.get("delete-objects", True))
        self.idle_time = float(configuration.get("idle-time", 5))
        self.extensions = [
            e.strip() for e in str(configuration.get("file-extensions", "")).split(",")
            if e.strip()
        ]
        self._processed: set = set()

    async def read(self, max_records: int = 100) -> List[Record]:
        objects = await self.client.list_objects(self.bucket)
        out: List[Record] = []
        for obj in objects:
            key = obj["key"]
            if key in self._processed:
                continue
            if self.extensions and not any(key.endswith(f".{e}") for e in self.extensions):
                continue
            body = await self.client.get_object(self.bucket, key)
            self._processed.add(key)
            out.append(Record(value=body, key=key, headers=(("name", key),)))
            if len(out) >= max_records:
                break
        if not out:
            await asyncio.sleep(self.idle_time)
        return out

    async def commit(self, records: List[Record]) -> None:
        if not self.delete_after:
            return
        for record in records:
            if record.key:
                await self.client.delete_object(self.bucket, str(record.key))

    async def close(self) -> None:
        await self.client.close()


class FileSource(AgentSource):
    """Local-directory source (the zero-infra S3Source analogue)."""

    agent_type = "file-source"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.path = configuration["path"]
        self.delete_after = bool(configuration.get("delete-objects", False))
        self.idle_time = float(configuration.get("idle-time", 1))
        self.extensions = [
            e.strip() for e in str(configuration.get("file-extensions", "")).split(",")
            if e.strip()
        ]
        self._processed: set = set()

    async def read(self, max_records: int = 100) -> List[Record]:
        out: List[Record] = []
        try:
            names = sorted(os.listdir(self.path))
        except FileNotFoundError:
            names = []
        for name in names:
            full = os.path.join(self.path, name)
            if full in self._processed or not os.path.isfile(full):
                continue
            if self.extensions and not any(name.endswith(f".{e}") for e in self.extensions):
                continue
            with open(full, "rb") as handle:
                body = handle.read()
            self._processed.add(full)
            out.append(Record(value=body, key=name, headers=(("name", name),)))
            if len(out) >= max_records:
                break
        if not out:
            await asyncio.sleep(self.idle_time)
        return out

    async def commit(self, records: List[Record]) -> None:
        if not self.delete_after:
            return
        for record in records:
            full = os.path.join(self.path, str(record.key))
            if os.path.exists(full):
                os.unlink(full)


class AzureBlobStorageSource(AgentSource):
    """Emit one record per blob; delete on commit when configured
    (reference: ``AzureBlobStorageSource.java:39`` — same polling shape
    as :class:`S3Source`, over the native Azure REST client)."""

    agent_type = "azure-blob-storage-source"

    async def init(self, configuration: Dict[str, Any]) -> None:
        from langstream_tpu_torch.agents.azure_blob import (
            AzureBlobClient,
            parse_connection_string,
        )

        endpoint = configuration.get("endpoint")
        account = configuration.get("storage-account-name")
        account_key = configuration.get("storage-account-key")
        connection = configuration.get("storage-account-connection-string")
        if connection:
            parsed = parse_connection_string(connection)
            endpoint = endpoint or parsed.get("endpoint")
            account = account or parsed.get("account")
            account_key = account_key or parsed.get("key")
        if not endpoint:
            if not account:
                raise ValueError(
                    "azure-blob-storage-source needs 'endpoint', "
                    "'storage-account-name', or a connection string"
                )
            endpoint = f"https://{account}.blob.core.windows.net"
        self.client = AzureBlobClient(
            endpoint=endpoint,
            container=configuration.get(
                "container", "langstream-azure-source"
            ),
            account=account,
            account_key=account_key,
            sas_token=configuration.get("sas-token"),
        )
        self.delete_after = bool(configuration.get("delete-objects", True))
        self.idle_time = float(configuration.get("idle-time", 5))
        self.extensions = [
            e.strip()
            for e in str(configuration.get("file-extensions", "")).split(",")
            if e.strip()
        ]
        self._processed: set = set()

    async def read(self, max_records: int = 100) -> List[Record]:
        blobs = await self.client.list_blobs()
        out: List[Record] = []
        for blob in blobs:
            name = blob["name"]
            if name in self._processed:
                continue
            if self.extensions and not any(
                name.endswith(f".{e}") for e in self.extensions
            ):
                continue
            body = await self.client.get_blob(name)
            self._processed.add(name)
            out.append(Record(value=body, key=name, headers=(("name", name),)))
            if len(out) >= max_records:
                break
        if not out:
            await asyncio.sleep(self.idle_time)
        return out

    async def commit(self, records: List[Record]) -> None:
        if not self.delete_after:
            return
        for record in records:
            if record.key:
                await self.client.delete_blob(str(record.key))

    async def close(self) -> None:
        await self.client.close()
