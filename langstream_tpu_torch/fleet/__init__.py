"""Fleet layer of the port: the prefill/decode handoff's wire schema
(:mod:`~langstream_tpu_torch.fleet.handoff`), the port's copy of
``langstream_tpu/fleet/handoff.py``. The router, autoscaler, heartbeat
and fleet simulator of the JAX package are not ported yet (ROADMAP.md,
A8)."""

from langstream_tpu_torch.fleet.handoff import (  # noqa: F401
    DEFAULT_MAX_CHUNK_BYTES,
    HANDOFF_TOPIC,
    RECORD_KIND,
    HandoffAssembler,
    handoff_records,
    manifest_for_request,
    new_handoff_id,
    payload_nbytes,
)
