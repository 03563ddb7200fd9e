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
  step of its own), ``decode``, ``spec``, ``mixed``, ``copy`` and
  ``block_copy``; then ``decode_chained``, ``spec_chained``,
  ``mixed_chained``, the records below, and ``stop``.
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
- The mixed step publishes ``mixed`` (its host arrays: windows, counts,
  masks, tables, sampling arrays) and, chained off the carry,
  ``mixed_chained`` with the window delta only; the follower takes the
  tables, sampling arrays and the previous ``sampled`` from its own mixed
  carry (the JAX contract). A speculative chunk publishes ``spec`` with
  the token history as a host array, and ``spec_chained`` nothing: the
  follower chains from its own ``final_tokens``, ``final_lengths`` and
  ``final_history``. :data:`CHAINED` names what each chained kind takes
  from the follower's previous step.
- Writes outside a step are records too, published before the write:
  ``handoff_export`` (the blocks whose rows every rank gathers over the
  tp group), ``handoff_import`` (the fresh blocks rank 0 broadcasts the
  payload's rows into, each rank keeping its kv heads), ``host_demote``
  (a block the host tier took, by digest), ``host_evict`` (a digest the
  tier dropped), ``host_promote`` (digests into fresh blocks), ``counts``
  (a resurrected session's penalty-count row), and the supervisor's
  heal: ``release`` (the followers free their engine's device state and
  drop their carries and tier) and ``rebuild`` (they build a new engine
  from the same config, meeting rank 0's in the group). Pool data never
  rides a frame: it crosses over the tp group.
- Both sides keep a digest of every token tensor they sampled
  (:class:`TokenDigest`, in dispatch order); at ``stop`` the follower
  reports it with its record count and its kernels' launches, and a
  follower that diverged shows a digest unlike the leader's.

A mirror is of one host (``local``: ``serve --tp``, whose ranks share a
host as the JAX mesh's devices do) or across hosts (``serve
--followers``). Across hosts the engine keeps the JAX engine's multi-host
refusals: speculative decoding and session resurrection raise, a KV
handoff import aborts, host-tier demotion is skipped, and the serve turns
the supervisor off.

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
from typing import Any, Callable, Dict, List, Optional, Tuple

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


# the output holding a step's sampled tokens, which both sides digest
SAMPLED = {"first_token": "tokens", "decode": "tokens", "spec": "tokens", "mixed": "sampled"}
# a chained record's device operands: each input the follower takes from
# its own previous step of the kind, by the output that holds it
CHAINED = {
    "decode": {"tokens": "final_tokens", "lengths": "final_lengths"},
    "spec": {"tokens": "final_tokens", "lengths": "final_lengths", "history": "final_history"},
    "mixed": {"chain_tokens": "sampled"},
}


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
        local: bool = False,
    ) -> None:
        # the followers are this host's ranks (serve --tp), not other hosts'
        self.local = bool(local)
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

    @property
    def closed(self) -> bool:
        return self._closed

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


# records that are not steps: writes outside a step, and the heal
_ENGINE_RECORDS = frozenset(("handoff_export", "handoff_import", "host_demote", "host_evict",
                             "host_promote", "counts", "release", "rebuild"))


def record_meta(key: Any, names: List[str]) -> Dict[str, Any]:
    """A step record's meta: the variant's fields and its arrays' names."""
    return {"size": key.size, "tier": key.tier, "group": key.group, "names": names}


class FollowerExecutor:
    """A follower rank's side: replay rank 0's dispatch stream into this
    process's engine, on its shard of the weights and the KV pool.

    The engine must be built with the leader's config and must not be
    running (the executor owns its dispatches). Outputs are dropped but
    the last prefill call's logits (a ``first_token`` samples them) and
    the last step of each chaining kind, its inputs and outputs (a
    ``<kind>_chained`` record chains from them); the sampled tokens feed
    :attr:`digest`. ``rebuild`` builds a new engine from the same config,
    for a ``rebuild`` record (the leader's supervisor healed a crash);
    :attr:`host_tier` holds this rank's kv heads of each block rank 0's
    host tier holds, by digest."""

    def __init__(self, engine, rebuild: Optional[Callable[[], Any]] = None) -> None:
        self.engine = engine
        self._rebuild = rebuild
        self._sock: Optional[socket.socket] = None
        self._logits = None
        # the last step of each kind in CHAINED: (variant, its device
        # inputs, its outputs)
        self._carries: Dict[str, Tuple[Any, Dict[str, Any], Dict[str, Any]]] = {}
        self.host_tier: Dict[str, Dict[str, Any]] = {}
        self.records = 0
        # records replayed by kind, and the digest of the sampled tokens
        self.kinds: Dict[str, int] = {}
        self.digest = TokenDigest()
        # model calls replayed: prefill calls by kind, decode, verify and
        # mixed steps
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
        # writable copies: the frame's buffers are read-only
        named = {name: np.array(array) for name, array in zip(meta.get("names", ()), arrays)}
        base = kind[: -len("_chained")] if kind.endswith("_chained") else kind
        if base != kind:
            if base not in self._carries:
                raise ValueError(f"mirror: a chained {base} before any {base}")
            key, inputs, outputs = self._carries[base]
            inputs = dict(inputs, **named, **{name: outputs[output]
                                              for name, output in CHAINED[base].items()})
        elif kind in _ENGINE_RECORDS:
            self._engine_record(kind, meta, arrays)
            return
        else:
            key = Variant(kind, int(meta["size"]), meta["tier"], int(meta["group"]))
            inputs = named
            if kind == "first_token":
                if self._logits is None:
                    raise ValueError("mirror: a first-token sampling before any prefill")
                inputs["logits"] = self._logits
        staged, outputs = engine.steps.run(key, inputs)
        if kind in ("prefill", "prefill_offset"):
            self._logits = outputs["logits"]
            self.model_calls[kind] = self.model_calls.get(kind, 0) + 1
        elif base in CHAINED:
            self._carries[base] = (key, staged, outputs)
            calls = "verify" if base == "spec" else base
            self.model_calls[calls] = self.model_calls.get(calls, 0) + (
                1 if base == "mixed" else key.size)
        if base in SAMPLED:
            self.digest.update(outputs[SAMPLED[base]])

    def _engine_record(self, kind: str, meta: Dict[str, Any], arrays: list) -> None:
        """A write outside a step, or the supervisor's heal, as rank 0's
        engine made it (``engine.py``: the same helpers, on this rank's kv
        heads)."""
        engine = self.engine
        if kind == "handoff_export":
            engine._gather_blocks(arrays[0].tolist())
        elif kind == "handoff_import":
            engine._write_blocks(arrays[0].tolist(), None)
        elif kind == "host_demote":
            self.host_tier[meta["digest"]] = engine._copy_block_out(int(meta["block"]))
        elif kind == "host_evict":
            self.host_tier.pop(meta["digest"], None)
        elif kind == "host_promote":
            engine._copy_blocks_in(arrays[0].tolist(),
                                   [self.host_tier[digest] for digest in meta["digests"]])
        elif kind == "counts":
            engine._write_counts(int(meta["slot"]), np.array(arrays[0]))
        elif kind == "release":
            engine.release()
            self._logits = None
            self._carries.clear()
            self.host_tier.clear()
        else:  # rebuild
            if self._rebuild is None:
                raise ValueError("mirror: a rebuild record and no engine factory")
            self.engine = self._rebuild()

    def report(self) -> Dict[str, Any]:
        """The follower's account at the end of its stream: records by
        kind, model calls, the token digest, the blocks its host tier
        holds, its kernels' launches on the
        card (``ops.launches``; zeros on the CPU) and its step variants."""
        from langstream_tpu_torch.ops import launches

        return {"records": self.records, "kinds": dict(self.kinds),
                "model_calls": dict(self.model_calls), "digest": self.digest.hexdigest(),
                "host_tier": len(self.host_tier),
                "launches": launches.read(shapes=True),
                # every variant warmed or captured: a first use runs its body
                # once more (a decode variant: its steps, on idle rows)
                "variants": [[key.kind, key.size] for key in self.engine.steps.variants]}
