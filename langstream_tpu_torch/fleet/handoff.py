"""Paged-KV handoff over the topic fabric (prefill/decode disaggregation).

The port's own copy of the wire schema of ``langstream_tpu/fleet/handoff.py``
(the port imports nothing of the JAX package): a prefill replica exports a
finished session's published block chain, the chain crosses the fabric as
a short-lived stream of bounded ``kv_handoff`` records keyed by
``handoff_id``, and the decode replica reassembles them
(:class:`HandoffAssembler`) and imports the rows into its own pool at
admission (``engine.GenerationRequest.kv_import``).

Wire schema (one record per chunk; every field JSON-able)::

    {
      "kind":       "kv_handoff",
      "handoff_id": "h-9f3a…",        # one export = one id
      "chunk":      0,                # 0..chunks-1, any arrival order
      "chunks":     4,
      "block_start": 0,               # first chain block in this chunk
      "block_size": 16,
      "kv_quant":   false,            # int8 pools ship values + scales
      "tokens":     […],              # the chunk's blocks' token ids
      "arrays":     {leaf: {"dtype", "shape", "data": b64}},
      "manifest":   {…}               # chunk 0 only: the warm-admission
                                      #   envelope (prompt, sampled
                                      #   tokens, sampling params, seed)
    }

``arrays`` holds the pool rows of the chunk's blocks, ``[layers, blocks,
block_size, kv_heads, head_dim]`` per value leaf (``k``, ``v``) and
``[layers, blocks, block_size, kv_heads]`` per f32 scale leaf of an int8
pool (``k_scale``, ``v_scale``). A bf16 leaf travels as its raw bytes
under the dtype string ``"bfloat16"``, which is what the JAX package
writes from its ``ml_dtypes`` arrays: numpy has no bf16 of its own, so
the port encodes from the tensor's bytes (viewed as int16) and decodes
with ``torch.frombuffer``. A record made by either package decodes
bitwise in the other. An assembled payload holds CPU torch tensors; the
engine's import also takes numpy leaves.

:class:`HandoffAssembler` reassembles chunks on the decode side and
collects orphans: a prefill replica dying mid-handoff leaves an incomplete
chunk set, dropped after ``orphan_timeout_s`` without progress (counted,
never raised), and the session replays as a cold prefill. The importer's
block-level unwind lives with the pool accounting
(``paged.PagedKVManager.abort_import``): nothing from a torn handoff is
published before its block ids recycle.
"""

from __future__ import annotations

import base64
import dataclasses
import threading
import time
import uuid
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

# the handoff stream shares the heartbeat fabric, not the heartbeat topic:
# a fat KV transfer must never delay the gossip the router's liveness view
# depends on
HANDOFF_TOPIC = "fleet-kv-handoff"
RECORD_KIND = "kv_handoff"

# bounded chunk size: one chunk's array payload never exceeds this, so a
# single handoff record cannot head-of-line-block the topic (Kafka's
# default max.message.bytes is 1 MiB)
DEFAULT_MAX_CHUNK_BYTES = 256 * 1024

# wire dtype string -> torch dtype (the numpy names, plus bfloat16)
_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def as_tensor(array: Any) -> torch.Tensor:
    """A CPU tensor over ``array`` (a tensor, or a numpy array; a numpy
    bf16 array from ``ml_dtypes`` is taken by its bytes)."""
    if isinstance(array, torch.Tensor):
        return array
    array = np.ascontiguousarray(array)
    if str(array.dtype) == "bfloat16":
        return torch.from_numpy(array.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def _encode_array(array: Any) -> Dict[str, Any]:
    if isinstance(array, torch.Tensor):
        tensor = array.detach().cpu().contiguous()
        dtype = str(tensor.dtype).removeprefix("torch.")
        raw = tensor.reshape(-1).view(torch.uint8).numpy().tobytes()
        shape = list(tensor.shape)
    else:
        array = np.ascontiguousarray(array)
        dtype, raw, shape = str(array.dtype), array.tobytes(), list(array.shape)
    return {"dtype": dtype, "shape": shape, "data": base64.b64encode(raw).decode("ascii")}


def _decode_array(spec: Mapping[str, Any]) -> torch.Tensor:
    raw = bytearray(base64.b64decode(spec["data"]))
    dtype = _TORCH_DTYPES[spec["dtype"]]
    shape = [int(n) for n in spec["shape"]]
    if not raw:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(raw, dtype=dtype).reshape(shape)


def _nbytes(array: Any) -> int:
    return int(array.nbytes) if isinstance(array, torch.Tensor) else int(np.asarray(array).nbytes)


def payload_nbytes(payload: Mapping[str, Any]) -> int:
    """Device bytes behind an engine export payload (what the
    ``kv_handoff_*_bytes_total`` gauges bill: array bytes before base64,
    what crossed between the card and the host, not wire framing)."""
    arrays = payload.get("arrays") or {}
    return sum(_nbytes(a) for a in arrays.values())


def new_handoff_id() -> str:
    return f"h-{uuid.uuid4().hex[:16]}"


def handoff_records(
    payload: Mapping[str, Any],
    manifest: Mapping[str, Any],
    *,
    handoff_id: Optional[str] = None,
    max_chunk_bytes: int = DEFAULT_MAX_CHUNK_BYTES,
) -> List[Dict[str, Any]]:
    """Split one engine export payload (``tokens`` + per-leaf ``arrays``
    + ``block_size``/``kv_quant``) into bounded ``kv_handoff`` records.
    ``manifest`` rides chunk 0: the warm-admission envelope the decode
    side replays from."""
    block_size = int(payload["block_size"])
    tokens = list(payload["tokens"])
    arrays = dict(payload.get("arrays") or {})
    n_blocks = len(tokens) // block_size
    if arrays:
        per_block = sum(_nbytes(a) // max(1, a.shape[1]) for a in arrays.values())
        blocks_per_chunk = max(1, max_chunk_bytes // max(1, per_block))
    else:
        # accounting-only payloads: no arrays; chunk on a nominal budget
        per_block = int(payload.get("sim_block_bytes", 0) or 0)
        blocks_per_chunk = (max(1, max_chunk_bytes // per_block) if per_block else n_blocks) or 1
    chunks = max(1, -(-n_blocks // blocks_per_chunk))
    handoff_id = handoff_id or new_handoff_id()
    records: List[Dict[str, Any]] = []
    for index in range(chunks):
        start = index * blocks_per_chunk
        stop = min(n_blocks, start + blocks_per_chunk)
        record: Dict[str, Any] = {
            "kind": RECORD_KIND,
            "handoff_id": handoff_id,
            "chunk": index,
            "chunks": chunks,
            "block_start": start,
            "block_size": block_size,
            "kv_quant": bool(payload.get("kv_quant", False)),
            "tokens": tokens[start * block_size: stop * block_size],
        }
        if arrays:
            record["arrays"] = {
                leaf: _encode_array(array[:, start:stop]) for leaf, array in arrays.items()
            }
        elif per_block:
            record["sim_bytes"] = per_block * (stop - start)
        if index == 0:
            record["manifest"] = dict(manifest)
        records.append(record)
    return records


@dataclasses.dataclass
class _Pending:
    chunks: int
    received: Dict[int, Mapping[str, Any]]
    last_progress: float
    nbytes: int = 0


class HandoffAssembler:
    """Decode-side chunk reassembly with orphan collection.

    Thread-safe: a fabric consumer offers records while a serve path
    drives :meth:`gc`, and every read and write of the pending table holds
    the lock. Assembly is pure dict and tensor splicing; nothing here
    touches a KV pool (the engine imports the assembled payload on its own
    thread at admission)."""

    def __init__(self, *, orphan_timeout_s: float = 30.0) -> None:
        self.orphan_timeout_s = float(orphan_timeout_s)
        self._pending: Dict[str, _Pending] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {  # guarded-by: _lock
            "handoffs_assembled": 0,
            "handoffs_orphaned": 0,
            "chunks_received": 0,
            "bytes_received": 0,
        }

    def offer(self, value: Mapping[str, Any], now: float) -> Optional[Dict[str, Any]]:
        """Apply one fabric record; returns the assembled handoff
        (``{"handoff_id", "manifest", "payload"}``) when its final chunk
        lands, else None. Malformed records are dropped: a bad record must
        never take the consumer loop down."""
        if not isinstance(value, Mapping) or value.get("kind") != RECORD_KIND:
            return None
        handoff_id = value.get("handoff_id")
        chunk = value.get("chunk")
        chunks = value.get("chunks")
        if not isinstance(handoff_id, str) or not isinstance(chunk, int) \
                or not isinstance(chunks, int) or not 0 <= chunk < chunks:
            return None
        with self._lock:
            pending = self._pending.get(handoff_id)
            if pending is None:
                pending = _Pending(chunks=chunks, received={}, last_progress=now)
                self._pending[handoff_id] = pending
            if pending.chunks != chunks:
                return None  # torn: mismatched chunk counts
            duplicate = chunk in pending.received
            pending.received[chunk] = value
            pending.last_progress = now
            if not duplicate:
                # an at-least-once fabric redelivers: the replacement is
                # fine (same content), but its bytes must not count twice
                self.stats["chunks_received"] += 1
                nbytes = value.get("sim_bytes")
                if not isinstance(nbytes, int):
                    nbytes = sum(
                        len(spec.get("data", "")) * 3 // 4
                        for spec in (value.get("arrays") or {}).values()
                        if isinstance(spec, Mapping)
                    )
                pending.nbytes += int(nbytes)
                self.stats["bytes_received"] += int(nbytes)
            if len(pending.received) < pending.chunks:
                return None
            self._pending.pop(handoff_id)
        try:
            assembled = self._assemble(handoff_id, pending)
        except Exception:  # noqa: BLE001 — a torn or mixed-schema chunk
            # set (a leaf missing from a later chunk, a shape mismatch, bad
            # base64) drops like any malformed record; the session replays
            # cold through the caller's timeout path
            with self._lock:
                self.stats["handoffs_orphaned"] += 1
            return None
        with self._lock:
            self.stats["handoffs_assembled"] += 1
        return assembled

    @staticmethod
    def _assemble(handoff_id: str, pending: _Pending) -> Dict[str, Any]:
        ordered = [pending.received[i] for i in range(pending.chunks)]
        first = ordered[0]
        tokens: List[int] = []
        for record in ordered:
            tokens.extend(int(t) for t in record.get("tokens", ()))
        payload: Dict[str, Any] = {
            "tokens": tokens,
            "block_size": int(first.get("block_size", 0) or 0),
            "kv_quant": bool(first.get("kv_quant", False)),
            "nbytes": pending.nbytes,
        }
        if first.get("arrays"):
            payload["arrays"] = {
                leaf: torch.cat([_decode_array(rec["arrays"][leaf]) for rec in ordered], dim=1)
                for leaf in first["arrays"]
            }
        return {
            "handoff_id": handoff_id,
            "manifest": dict(first.get("manifest") or {}),
            "payload": payload,
        }

    def gc(self, now: float) -> List[str]:
        """Drop incomplete handoffs with no progress inside the orphan
        timeout (the prefill replica died mid-handoff; its session replays
        cold elsewhere)."""
        with self._lock:
            orphans = [
                handoff_id for handoff_id, pending in self._pending.items()
                if now - pending.last_progress >= self.orphan_timeout_s
            ]
            for handoff_id in orphans:
                self._pending.pop(handoff_id)
                self.stats["handoffs_orphaned"] += 1
        return orphans

    def pending_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._pending)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return {
                "fleet_handoffs_assembled_total": float(self.stats["handoffs_assembled"]),
                "fleet_handoffs_orphaned_total": float(self.stats["handoffs_orphaned"]),
                "fleet_handoff_bytes_total": float(self.stats["bytes_received"]),
                "fleet_handoffs_pending": float(len(self._pending)),
            }


def manifest_for_request(
    prompt_tokens: Sequence[int],
    generated: Sequence[int],
    sampling: Mapping[str, Any],
    *,
    session_id: Optional[str] = None,
    trace_id: Optional[str] = None,
    replica: Optional[str] = None,
    export_ts: Optional[float] = None,
) -> Dict[str, Any]:
    """The warm-admission envelope: everything the decode side needs to
    rebuild the replay request: the original prompt, every token the
    prefill leg sampled (the last one is teacher-forced, its KV row
    written by the first decode step), and the sampling params with the
    effective seed (sampling keys derive from ``(seed, position)`` and
    positions are absolute, so the continuation is bitwise wherever it
    lands). ``export_ts`` (wall seconds; now when omitted) lets the decode
    side measure the transit."""
    return {
        "prompt_tokens": [int(t) for t in prompt_tokens],
        "generated": [int(t) for t in generated],
        "sampling": dict(sampling),
        "session_id": session_id,
        "trace_id": trace_id,
        "replica": replica,
        "export_ts": float(export_ts) if export_ts is not None else time.time(),
    }
