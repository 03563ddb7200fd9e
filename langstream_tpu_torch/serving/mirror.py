"""Tensor-parallel serving across processes: the dispatch mirror.

Port of ``langstream_tpu/serving/mirror.py``. Under tensor parallelism
every rank is a process holding its head shard, and every rank must
enter the same model calls in the same order, since the collectives
(``parallel.collectives`` over a ``parallel.mesh.AxisGroup``) ride
inside them. Only rank 0 sees traffic: it runs the engine and the HTTP
surface, and its engine makes
timing-dependent host decisions (admission groups, buckets, chunk sizes,
chaining). The followers cannot recompute that schedule; they replay it.

- Rank 0's :class:`~langstream_tpu_torch.providers.torch_local.engine.DecodeEngine`
  has ``engine.mirror`` set to a :class:`DispatchMirror`. Every step the
  engine dispatches through its step runner publishes a record BEFORE
  the local dispatch: the step variant (``kind``, ``size``, ``tier``,
  ``group``) and its host input arrays by name. The kinds are the
  variants' own, ``prefill``, ``prefill_offset``, ``first_token`` (the
  first-token sampling behind a prefill, which the port dispatches as a
  step of its own), ``decode``, ``copy`` and ``block_copy``; then
  ``decode_chained`` and ``stop``.
- Each follower builds the identical engine (same config, so the same
  seed, weights and variants, over its own shard of the weights and of
  the KV pool) and replays the stream with :class:`FollowerExecutor`
  through the same step runner with the same host arguments. Device
  operands the leader carries are the follower's own: a ``first_token``
  samples the logits of the follower's last prefill call, and a
  ``decode_chained`` record carries no arrays: the follower chains from
  its own previous chunk's final tokens and lengths, which hold the
  leader's values, since the logits are gathered whole on every rank and
  every rank samples them with the same keys.
- Paged records carry each row's block-table slice (host metadata; pool
  data never crosses), and copy-on-write publishes ``block_copy``, so
  the followers make the same pool mutations on their kv-head shard
  without the block allocator or the prefix cache's bookkeeping.
- Both sides keep a digest of every token tensor they sampled
  (:class:`TokenDigest`, in dispatch order); at ``stop`` the follower
  reports it with its record count and its kernels' launches, and a
  follower that diverged shows a digest unlike the leader's.

Not replayed (the engine refuses them under the mirror, as the JAX engine
does): speculative decoding, the mixed prefill+decode step (ROADMAP.md
A10), a KV handoff, session resurrection; host-tier demotion is skipped.

Transport: a length-prefixed JSON header plus raw array bytes over TCP,
byte for byte the JAX package's frames (nothing executable crosses the
wire). Rank 0 listens; followers connect before serving starts
(:meth:`DispatchMirror.wait_for_followers` blocks until all joined, with a
time limit), after a handshake of a magic word and the serving config's
fingerprint.
"""

from __future__ import annotations

import hashlib
import json
import logging
import queue
import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def config_fingerprint(config: Dict[str, Any]) -> bytes:
    """16-byte digest of the serving config: leader and followers must
    run the same model and engine configuration, or replay on mismatched
    shapes would silently diverge. The handshake compares digests."""
    canonical = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(canonical.encode()).digest()[:16]


_MAGIC = b"LSM1"
_FINGERPRINT_LEN = 16
_ANY_FINGERPRINT = bytes(_FINGERPRINT_LEN)  # all-zero = skip the check
_HEADER = struct.Struct("!I")  # payload length
# record payloads are not pickle: a JSON header (kind, meta, array dtypes
# and shapes) and raw array bytes
_ALLOWED_DTYPES = frozenset(
    ("int32", "uint32", "float32", "bool", "int64", "float64")
)


def _encode_record(kind: str, meta: Dict[str, Any], arrays: list) -> bytes:
    specs = []
    buffers: List[bytes] = []
    for array in arrays:
        # np.asarray, not ascontiguousarray: the latter promotes 0-d
        # scalars to shape (1,)
        array = np.asarray(array)
        specs.append({"dtype": array.dtype.name, "shape": list(array.shape)})
        buffers.append(array.tobytes())  # C order regardless
    header = json.dumps(
        {"kind": kind, "meta": meta, "arrays": specs}
    ).encode()
    return b"".join(
        [_HEADER.pack(len(header)), header, *buffers]
    )


def _send_record(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks: List[bytes] = []
    while n:
        part = sock.recv(n)
        if not part:
            raise ConnectionError("mirror stream closed")
        chunks.append(part)
        n -= len(part)
    return b"".join(chunks)


def _recv_record(sock: socket.socket) -> Tuple[str, Dict[str, Any], list]:
    (length,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    payload = _recv_exact(sock, length)
    (header_len,) = _HEADER.unpack(payload[: _HEADER.size])
    cursor = _HEADER.size + header_len
    header = json.loads(payload[_HEADER.size: cursor])
    arrays = []
    for spec in header["arrays"]:
        dtype = spec["dtype"]
        if dtype not in _ALLOWED_DTYPES:
            raise ValueError(f"mirror: disallowed dtype {dtype!r}")
        shape = tuple(int(d) for d in spec["shape"])
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        size = count * np.dtype(dtype).itemsize
        arrays.append(
            np.frombuffer(
                payload[cursor: cursor + size], dtype=dtype
            ).reshape(shape)
        )
        cursor += size
    if cursor != len(payload):
        raise ValueError("mirror: record length mismatch")
    return header["kind"], header["meta"], arrays


class TokenDigest:
    """A running digest of the token tensors a rank sampled, in dispatch
    order; equal on every rank that replayed the same stream to the same
    tokens."""

    def __init__(self) -> None:
        self._hash = hashlib.sha256()
        self.tensors = 0

    def update(self, tokens: Any) -> None:
        values = tokens.detach().to("cpu").numpy() if hasattr(tokens, "detach") else tokens
        self._hash.update(np.asarray(values, dtype=np.int64).tobytes())
        self.tensors += 1

    def hexdigest(self) -> str:
        return self._hash.hexdigest()[:16]


class DispatchMirror:
    """Rank 0's side: accept the followers, then fan every published
    record out to all of them in order.

    ``publish`` only enqueues (the engine thread never blocks on the
    network); one writer thread keeps the order. A follower that drops
    its connection is fatal to the replica (the next collective would
    hang anyway): the writer's error is raised into the engine thread at
    its next publish. The queue is bounded: a follower that falls behind
    for ``PUBLISH_TIMEOUT_S`` is the same fault."""

    QUEUE_MAXSIZE = 65536
    PUBLISH_TIMEOUT_S = 60.0

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 0,
        fingerprint: bytes = _ANY_FINGERPRINT,
    ) -> None:
        self._server = socket.create_server((host, port))
        self.port = self._server.getsockname()[1]
        self._fingerprint = fingerprint
        self._followers: List[socket.socket] = []
        self._queue: "queue.Queue[Optional[bytes]]" = queue.Queue(
            maxsize=self.QUEUE_MAXSIZE
        )
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._closed = False
        # records published, and the leader's digest of its sampled tokens
        self.published = 0
        self.digest = TokenDigest()

    def wait_for_followers(self, expected: int, timeout: float = 300.0) -> None:
        """Block until ``expected`` followers complete the handshake, then
        start the writer; raises ``socket.timeout`` when one does not
        come within ``timeout`` seconds. Runs before any traffic."""
        self._server.settimeout(timeout)
        while len(self._followers) < expected:
            conn, addr = self._server.accept()
            # bound the handshake read too: a connection that sends
            # nothing must not hang startup
            conn.settimeout(10.0)
            try:
                magic = _recv_exact(conn, len(_MAGIC))
                theirs = _recv_exact(conn, _FINGERPRINT_LEN)
            except (socket.timeout, ConnectionError, OSError):
                conn.close()
                logger.warning("mirror: handshake timeout from %s", addr)
                continue
            if magic != _MAGIC:
                conn.close()
                logger.warning("mirror: bad handshake from %s", addr)
                continue
            if (
                self._fingerprint != _ANY_FINGERPRINT
                and theirs != _ANY_FINGERPRINT
                and theirs != self._fingerprint
            ):
                conn.close()
                logger.error(
                    "mirror: follower %s runs a different serving config "
                    "(fingerprint mismatch): rejected", addr,
                )
                continue
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._followers.append(conn)
            logger.info(
                "mirror: follower %d/%d connected from %s",
                len(self._followers), expected, addr,
            )
        self._writer = threading.Thread(
            target=self._write_loop, name="mirror-writer", daemon=True
        )
        self._writer.start()

    @property
    def followers(self) -> int:
        return len(self._followers)

    def publish(self, kind: str, meta: Dict[str, Any], arrays: list) -> None:
        if self._error is not None:
            raise RuntimeError("mirror writer failed") from self._error
        try:
            self._queue.put(
                _encode_record(kind, meta, arrays),
                timeout=self.PUBLISH_TIMEOUT_S,
            )
        except queue.Full:
            self._error = RuntimeError(
                f"mirror publish queue full for {self.PUBLISH_TIMEOUT_S:.0f}s"
                " — follower cannot keep up with the dispatch rate"
            )
            raise RuntimeError("mirror writer failed") from self._error
        self.published += 1

    def _write_loop(self) -> None:
        while True:
            payload = self._queue.get()
            if payload is None:
                return
            for follower in self._followers:
                try:
                    _send_record(follower, payload)
                except OSError as error:
                    self._error = error
                    logger.error("mirror: follower write failed: %s", error)
                    return

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass  # the writer is wedged; the bounded join below handles it
        if self._writer is not None:
            self._writer.join(timeout=10)
        for follower in self._followers:
            try:
                follower.close()
            except OSError:
                pass
        self._server.close()


def record_meta(key: Any, names: List[str]) -> Dict[str, Any]:
    """A step record's meta: the variant's fields and its arrays' names."""
    return {"size": key.size, "tier": key.tier, "group": key.group, "names": names}


class FollowerExecutor:
    """A follower rank's side: replay rank 0's dispatch stream into this
    process's engine, on its shard of the weights and the KV pool.

    The engine must be built with the leader's config and must not be
    running (the executor owns its dispatches). Outputs are dropped but
    the last prefill call's logits (a ``first_token`` samples them) and
    the last decode chunk's inputs and outputs (a ``decode_chained``
    chains from them); the sampled tokens feed :attr:`digest`."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self._sock: Optional[socket.socket] = None
        self._logits = None
        # the last decode chunk: (variant, its device inputs, its outputs)
        self._carry: Optional[Tuple[Any, Dict[str, Any], Dict[str, Any]]] = None
        self.records = 0
        # records replayed by kind, and the digest of the sampled tokens
        self.kinds: Dict[str, int] = {}
        self.digest = TokenDigest()
        # model calls replayed: prefill calls by kind, decode steps
        self.model_calls: Dict[str, int] = {}

    def connect(
        self,
        host: str,
        port: int,
        timeout: float = 300.0,
        fingerprint: bytes = _ANY_FINGERPRINT,
    ) -> None:
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.sendall(_MAGIC + fingerprint)
        # records may be minutes apart while the leader idles
        self._sock.settimeout(None)

    def run(self) -> int:
        """Replay records until a ``stop`` record or the stream closes.
        Returns the number of records executed."""
        import torch

        from langstream_tpu_torch.runtime import faults

        assert self._sock is not None, "connect() first"
        try:
            # as the leader's engine thread runs its steps (and as its
            # precompile made the runner's static buffers)
            with torch.inference_mode():
                while True:
                    try:
                        kind, meta, arrays = _recv_record(self._sock)
                    except ConnectionError:
                        logger.info("mirror: stream closed, follower exiting")
                        return self.records
                    if kind == "stop":
                        return self.records
                    # chaos (LANGSTREAM_FAULTS=mirror_follower@step=N): a
                    # follower dying mid-replay
                    faults.check("mirror_follower")
                    self._execute(kind, meta, arrays)
                    self.records += 1
                    self.kinds[kind] = self.kinds.get(kind, 0) + 1
        finally:
            self._sock.close()

    def _execute(self, kind: str, meta: Dict[str, Any], arrays: list) -> None:
        from langstream_tpu_torch.providers.torch_local.graphs import Variant

        engine = self.engine
        if kind == "decode_chained":
            if self._carry is None:
                raise ValueError("mirror: a chained decode before any decode")
            key, inputs, outputs = self._carry
            inputs = dict(inputs, tokens=outputs["final_tokens"], lengths=outputs["final_lengths"])
        else:
            key = Variant(kind, int(meta["size"]), meta["tier"], int(meta["group"]))
            # writable copies: the frame's buffers are read-only
            inputs = {name: np.array(array) for name, array in zip(meta["names"], arrays)}
            if kind == "first_token":
                if self._logits is None:
                    raise ValueError("mirror: a first-token sampling before any prefill")
                inputs["logits"] = self._logits
        staged, outputs = engine.steps.run(key, inputs)
        if kind in ("prefill", "prefill_offset"):
            self._logits = outputs["logits"]
            self.model_calls[kind] = self.model_calls.get(kind, 0) + 1
        elif kind in ("decode", "decode_chained"):
            self._carry = (key, staged, outputs)
            self.model_calls["decode"] = self.model_calls.get("decode", 0) + key.size
        if kind in ("first_token", "decode", "decode_chained"):
            self.digest.update(outputs["tokens"])

    def report(self) -> Dict[str, Any]:
        """The follower's account at the end of its stream: records by
        kind, model calls, the token digest, its kernels' launches on the
        card (``ops.launches``; zeros on the CPU) and its step variants."""
        from langstream_tpu_torch.ops import launches

        return {"records": self.records, "kinds": dict(self.kinds),
                "model_calls": dict(self.model_calls), "digest": self.digest.hexdigest(),
                "launches": launches.read(shapes=True),
                # every variant warmed or captured: a first use runs its body
                # once more (a decode variant: its steps, on idle rows)
                "variants": [[key.kind, key.size] for key in self.engine.steps.variants]}
