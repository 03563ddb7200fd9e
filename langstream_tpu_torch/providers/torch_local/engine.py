"""Continuous-batching decode engine on one GPU — the serving core of
``torch-local``.

Port of ``langstream_tpu/providers/jax_local/engine.py`` reduced to the
split-prefill path over either KV layout, and the mixed prefill+decode
path over the paged one:

- **Slot-based static batch**: every decode step runs ALL ``max_slots``
  slots through the model. Empty slots ride along masked.
- **Two KV layouts**, each in the model's dtype or, with ``kv_quant="int8"``,
  as int8 values with one f32 scale per (position, kv head) (half the
  bytes; the attention kernels read the int8 rows): ``kv_layout="dense"``
  (the default) gives each slot
  ``max_seq_len`` cache rows; ``kv_layout="paged"`` shares one block pool
  through host-authoritative per-slot block tables, with a persistent
  block prefix cache (``paged.py``): a request whose prompt starts with a
  published chain of full blocks references those blocks and prefills
  only its suffix. Every request reserves its worst case (prompt +
  max_new_tokens) at admission, so decode never allocates; when the pool
  cannot cover a reservation even after LRU eviction, the request waits.
- **KV reuse across requests**: a request with a ``session_id`` (the
  OpenAI ``session_id`` or ``user`` field) pins its slot at finish, and a
  follow-up whose prompt extends (or shares at least ``WARM_MIN_PREFIX``
  tokens of) the pinned history prefills only its suffix at an offset;
  the least recently used pinned slot is evicted under slot pressure.
  Warm-eligible requests are admitted first (:meth:`_scan_admission`,
  bounded by ``MAX_HEAD_SKIPS``). On the dense layout with
  ``prefix_cache``, a finished sessionless slot keeps its history too,
  and a cold request whose prompt shares a prefix with any slot's rows
  copies them on the card (``Variant("copy", bucket)``, one graph per
  bucket) instead of prefilling them (:meth:`_find_prefix_source`). On the
  paged layout a session keeps its blocks; a follow-up that diverges
  inside a shared block copies that block first (copy-on-write,
  ``Variant("block_copy")``).
- **Continuous batching**: requests join mid-flight. Cold requests that
  share a prompt bucket are prefilled together (power-of-two groups) and
  their first token is sampled on the card right behind the call; a
  finishing request frees its slot at once. A prompt longer than the
  largest bucket is prefilled in bucket-sized windows (``_prefill_long``).
- **Non-blocking prefill**: a prefill call is dispatched without waiting
  for the card. Its slots stay ``prefilling`` (out of decode) and its
  record joins ``_prefill_inflight``; the run loop's harvest points
  (:meth:`DecodeEngine._harvest_at_loop`) emit the first tokens later,
  in dispatch order. A prefill queued behind a decode chunk in flight so
  never stalls the host. Once no chunk is on the card, the next fresh
  chunk would queue behind every prefill in flight, so the loop waits
  for them all first and their slots join that chunk
  (``join_prefills``); with ``join_prefills=False`` it blocks, as the
  JAX engine, only when decode has nothing to run, and decode chunks of
  running slots go on past a prefill still running.
- **Mixed prefill+decode dispatch** (``prefill_mode="mixed"``, paged
  only): admission reserves blocks but runs no prefill call; the slot
  parks at a prompt watermark, and while any slot is admitting every
  dispatch is one mixed step (``model.paged_mixed_step``, the token-ragged
  kernels B7/B8) in which every ready slot decodes one token and up to
  ``prefill_chunk`` prompt tokens of admitting slots ride along, shared
  FIFO by admission order. The window that completes a prompt samples its
  first token in the same step.
- **Pipelined decode** (``pipeline_decode=True``; off by default, as in the
  JAX engine, on in ``serve``): chunk N+1 is dispatched off chunk N's
  device-resident final tokens, lengths, active mask, sampling tensors and
  block tables BEFORE chunk N's tokens are processed on the host, when no
  admission waits and every rider has two chunks of budget left
  (:meth:`DecodeEngine._can_chain`). A chunk's tokens cross to the host
  through pinned buffers behind a CUDA event, so processing N waits for N
  only, never for N+1 queued behind it. Results are epoch-guarded: a
  slot's surplus chunk after a stop is discarded.
- **Mixed-step carry** (``mixed_carry=True``, the default; it needs
  ``pipeline_decode``): while admissions chunk through mixed steps, step
  N+1's windows are planned from the watermarks advanced at N's dispatch
  (:meth:`DecodeEngine._plan_mixed_chain`) and dispatched off N's
  device-resident sample; only the prompt-window tokens upload. A plan the
  host cannot predict falls back to a host-built step, counted by reason
  in ``stats["mixed_carry_invalidations"]``.
- **K-step decode chunks**: the JAX ``lax.scan`` becomes a loop of K
  steps whose sampled tokens stay on the device; the chunk's tokens cross
  to the host once, are emitted per chunk, and a stop in mid-chunk
  discards the rest of the chunk (the slot's length stops at the stop).
  While admissions wait, ``admission_chunk`` (when set) caps the chunk.
- **One CUDA graph per step variant** (``graphs.py``): each decode chunk
  (step count × sampling tier), each mixed step (width × tier), each
  prefill model call (cold or at an offset × bucket × pow2 group) and
  each first-token sampling (group × tier) that
  :meth:`DecodeEngine._variant_keys` lists is captured once, as the JAX
  engine jits ``_get_decode``, ``_get_mixed``, ``_get_prefill`` and
  ``_get_prefill_offset``, and replayed with one launch;
  :meth:`DecodeEngine.precompile` captures them all before traffic. On
  the CPU, and with ``step_graphs=False`` (an eager control on the
  card), the same body runs op by op through the same static buffers,
  uncaptured.
- **On-device sampling**: greedy / temperature / top-k / top-p, presence
  and frequency penalties over a per-slot count array, logit bias, and
  per-request keys from (seed, position) that reproduce ``jax.random``.
- **Dedicated engine thread**: callers enqueue requests (thread-safe
  :meth:`DecodeEngine.submit`, or ``await`` :meth:`DecodeEngine.generate`)
  and receive per-token callbacks on their own event loop.
- **Weight-only int8** (``quantize="int8"``, or params that already hold
  ``quant.QTensor`` leaves): the matmul weights in int8 with per-channel
  scales, as the JAX engine's ``quantize``.
- **Speculative decoding** (``spec_decode="ngram"``): every step of a
  decode chunk drafts up to ``spec_k`` tokens per slot from the slot's
  token history on the card, verifies the ``1 + spec_k`` block in one
  model call and accepts 1 to ``spec_k + 1`` tokens a slot
  (``spec_decode.py``), one graph per (steps, tier), ``Variant("spec")``.
- **Top-K logprobs** (``logprobs_topk`` K > 0, static per engine as in the
  JAX engine, since it shapes every step's outputs): every sampling body
  also returns the K largest raw logits' ids and logprobs
  (:func:`sampling.top_logprobs`, ranked as ``lax.top_k`` ranks them) as
  static outputs of its graph; they cross to the host in the same copy as
  the tokens and land in ``GenerationResult.top_logprobs``.

- **Self-healing** (``runtime/supervisor.py``): with ``on_crash`` set, a
  crashed engine thread hands its live sessions to the hook instead of
  failing every waiter; :meth:`DecodeEngine.drain_for_recovery` turns
  each into a replay request, and a rebuilt engine prefills ``prompt +
  replay[:-1]`` and fast-forwards the slot through the accepted tokens
  (:meth:`DecodeEngine._resume_replay`): the pending token and the
  penalty counts are written in place into the static buffers the
  graphs read, so the continuation is bitwise the uncrashed one. The
  fault points of ``runtime/faults.py`` (``dispatch_error``,
  ``stuck_step``, ``engine_thread_crash``) sit on the host, never inside
  a capture. ``queue_timeout_s`` sheds a request that waited longer for
  admission with a typed ``QueueTimeoutError`` (HTTP 503).

- **Prefill/decode disaggregation** (``fleet/handoff.py``, paged layout):
  a request with ``export_handoff`` gathers its published block chain off
  the pool at finish (``GenerationResult.kv_handoff``: tokens and the
  per-leaf pool rows ``[layers, blocks, block_size, kv_heads(, head_dim)]``,
  the JAX payload's shapes and leaf names); a request carrying
  ``kv_import`` has that payload scattered into freshly reserved blocks
  and published before the admission scan (:meth:`_import_pending_handoffs`),
  so its own admission is a prefix hit. The gather and the scatter are
  eager ``index_select`` / ``index_copy_`` per cache leaf on the engine's
  current stream, where the step graphs replay, so they are ordered
  against every replay. A failed import is counted (``handoff_aborted``)
  and the request prefills cold.
- **Host-DRAM KV tier** (``kv_host_blocks`` N > 0, paged layout): the
  prefix cache's LRU eviction demotes each victim block into a bounded
  arena (``paged.HostKVArena``, keyed by the chain digest) through a
  non-blocking copy into pinned host memory on the engine's stream
  (:meth:`_demote_block_data`); an admission whose prompt continues its
  HBM match into the arena promotes those entries back into its fresh
  blocks (:meth:`_promote_host_chain`, an H2D copy queued behind the
  demotion on the same stream) instead of prefilling them. A torn
  promotion (fault point ``host_promote_torn``) aborts before anything
  publishes and the admission prefills cold.

- **Tensor parallelism** (``mesh_config`` with ``tp`` N > 1): the engine
  is one rank of N processes (``parallel.mesh.build_group``), holding its
  shard of the weights (``model.rank_params``, from the full tensors a
  one-card engine draws or loads) and a KV cache of its own kv heads; no
  pool is ever gathered. The model calls take the rank's config
  (``model.rank_config``), whose group sums the row-sharded products and
  gathers the vocabulary's columns, so every rank samples the same full
  logits. Rank 0 serves with ``mirror`` set (``serving/mirror.py``): each
  step it dispatches is published first, and the followers replay the
  stream. Under tp the step functions run eagerly (a gloo collective
  cannot sit inside a CUDA graph; ``stats["step_functions"]`` says so).
  A mirror of one host's ranks (``serve --tp``) serves all the JAX engine
  serves on one host's mesh: the mixed step and its carry, speculative
  decoding, a KV handoff export (the ranks' kv heads gathered over the
  group, so the payload is one card's) and import (rank 0 broadcasts the
  rows, each rank keeps its kv heads), the host tier (each rank keeps its
  kv heads of each demoted block under rank 0's digest) and session
  resurrection (the counts restore is a record); every write outside a
  step is published before it is made (:meth:`_publish`). A mirror across
  hosts (``serve --followers``) keeps the JAX engine's multi-host
  refusals: speculative decoding and session resurrection raise, an
  import aborts (``mirror``) and demotion is skipped. The digest of every
  sampled token tensor costs one copy to the host per sampling step.

- **Accounting** (``runtime/accounting.py``, ``runtime/journey.py``): a
  cost model built from the config, the weights' and the cache's widths
  and the layout charges each decode chunk and mixed step its modeled
  FLOPs and bytes (from the context its riders held at dispatch) and each
  prefill call its FLOPs, for per-chunk MFU and MBU against the H100's
  peaks and the cumulative ``torch_engine_mfu`` / ``_mbu`` /
  ``_prefill_mfu`` over the busy-time union. Every generated token is
  booked useful or wasted by reason, and ``_finish`` observes TTFT, TPOT
  and request seconds, ticks the SLO tracker (``slo``) and emits the
  request's journey (its stages tiling submit to finish, with the
  admission class), which feeds the per-stage histograms and the SLO
  blame. With the flight recorder or a tracer on, each prefill call,
  decode chunk, mixed step, request and journey is recorded there too;
  all of it is host arithmetic on the engine thread, outside every graph.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import queue
import sys
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from langstream_tpu_torch.api import errors as api_errors
from langstream_tpu_torch.api.metrics import Histogram
from langstream_tpu_torch.device import resolve_device
from langstream_tpu_torch.ops.paged_attention import fused_shapes_ok
from langstream_tpu_torch.parallel import collectives
from langstream_tpu_torch.parallel.mesh import (
    MeshConfig,
    build_group,
    require_serving_mesh,
    validate_mesh,
)
from langstream_tpu_torch.providers.torch_local import model as model_lib
from langstream_tpu_torch.providers.torch_local import prng, sampling
from langstream_tpu_torch.providers.torch_local import spec_decode as spec_lib
from langstream_tpu_torch.providers.torch_local.graphs import (
    TIERS,
    StepRunner,
    Variant,
    sampling_tier,
)
from langstream_tpu_torch.fleet.handoff import as_tensor, payload_nbytes
from langstream_tpu_torch.providers.torch_local.paged import HostKVArena, HostKVEntry, PagedKVManager
from langstream_tpu_torch.providers.torch_local.quant import QTensor, quantize_params
from langstream_tpu_torch.runtime import accounting, faults, flight
from langstream_tpu_torch.runtime import journey as journey_ledger
from langstream_tpu_torch.runtime.threadsafe import stable_items, stable_list
from langstream_tpu_torch.runtime.tracing import get_tracer
from langstream_tpu_torch.serving.mirror import SAMPLED, record_meta

logger = logging.getLogger(__name__)

# live engines, for /metrics (weak: a stopped engine's tensors must not
# be pinned by the metrics path; a superseded one is retired at once)
_LIVE_ENGINES: "weakref.WeakSet" = weakref.WeakSet()

# latency histograms across every engine of the process, the JAX engine's
# buckets: the decode step (a chunk's wall over its steps), and per request
# TTFT (submit → first token), TPOT (the mean gap after the first token)
# and end to end, observed at finish; the SLO tracker reads snapshots of
# TTFT and TPOT
DECODE_STEP_SECONDS = Histogram(
    "torch_engine_decode_step_seconds",
    buckets=(0.001, 0.002, 0.005, 0.01, 0.02, 0.035, 0.05, 0.075, 0.1, 0.15, 0.25, 0.5, 1.0))
TTFT_SECONDS = Histogram(
    "torch_engine_ttft_seconds",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.2, 0.35, 0.5, 0.75, 1.0, 2.0, 5.0, 10.0, 30.0))
TPOT_SECONDS = Histogram(
    "torch_engine_tpot_seconds",
    buckets=(0.002, 0.005, 0.01, 0.02, 0.035, 0.05, 0.075, 0.1, 0.15, 0.25, 0.5, 1.0))
REQUEST_SECONDS = Histogram("torch_engine_request_seconds")
# per-chunk roofline shares of the card's peaks
_UTIL_BUCKETS = (0.01, 0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
MFU_PER_CHUNK = Histogram("torch_engine_mfu_per_chunk", buckets=_UTIL_BUCKETS)
MBU_PER_CHUNK = Histogram("torch_engine_mbu_per_chunk", buckets=_UTIL_BUCKETS)

# the goodput ledger's waste reasons, the JAX engine's: tokens decoded for
# a cancelled request; a follow-up re-prefilling its evicted session's
# rows; drafts the verify pass rejected; a resurrected session's replay
# prefill; prompt padding (bucket rounding and window shifts on the split
# path, a mixed step's padded windows); tokens a chained mixed step sampled
# for rows whose request had ended; a KV handoff import that aborted
WASTE_REASONS = ("cancelled", "evicted_recompute", "draft_rejected", "crash_replay",
                 "prefill_padding", "carry_invalidated", "handoff_aborted")
# the pool leaves' kv-head axis ([layers, blocks, block_size, kv_heads(,
# head_dim)]), which a tp rank holds its part of
KV_HEAD_AXIS = 3
# why mixed-step chains broke, the JAX engine's reasons
CARRY_INVALIDATIONS = ("admission", "replay", "budget", "epoch", "condemned", "width",
                       "drained", "stale_row")


def _supervisor_module():
    """The supervisor module iff something in this process imported it:
    an unsupervised process exports none of the recovery families."""
    return sys.modules.get("langstream_tpu_torch.runtime.supervisor")


def engines_histograms() -> Dict[str, Dict[str, float]]:
    """Histogram snapshots for ``/metrics``: the engine's latency and
    per-chunk roofline histograms, the journey stages', and the
    supervisor's ``engine_recovery_seconds`` once a supervisor exists."""
    out = {h.name: h.snapshot() for h in (DECODE_STEP_SECONDS, TTFT_SECONDS, TPOT_SECONDS,
                                          REQUEST_SECONDS, MFU_PER_CHUNK, MBU_PER_CHUNK)}
    out.update(journey_ledger.stage_histograms())
    supervisor_mod = _supervisor_module()
    if supervisor_mod is not None:
        out.update(supervisor_mod.supervisor_histograms())
    return out


def engines_dispatches() -> Dict[str, Dict[str, int]]:
    """Host counters over every live engine of this process: the model
    calls by function (``stats["model_dispatches"]``) and the CUDA graphs
    captured by kind (``steps.stats``). The gateway's
    ``/debug/launches`` serves them beside the kernels' card counters."""
    calls: Dict[str, int] = {}
    captured: Dict[str, int] = {}
    for engine in stable_list(_LIVE_ENGINES):
        for function, count in stable_items(engine.stats["model_dispatches"]):
            calls[function] = calls.get(function, 0) + count
        for kind, counts in stable_items(engine.steps.stats["kinds"]):
            captured[kind] = captured.get(kind, 0) + counts.get("captured", 0)
    return {"model_calls": calls, "graphs_captured": captured}


def engines_snapshot() -> Dict[str, float]:
    """Prometheus gauges over every live engine of this process, as the
    JAX ``engines_snapshot`` gives them: the recovery, shedding and
    watchdog families under the JAX names (``engine_restarts_total``,
    ``sessions_resurrected_total``, ``engine_degraded``,
    ``requests_shed_total{reason}``, ``watchdog_trips_total``), the paged
    pool's, the KV handoff's, the host tier's, speculation's and the
    mixed carry's series under theirs, and the engine's own counters, the
    goodput ledger, slot occupancy, MFU and MBU against the card's peaks
    and the SLO gauges as ``torch_engine_*`` where the JAX engine says
    ``jax_engine_*``."""
    out: Dict[str, float] = {}
    tokens = steps = chunks = requests = 0
    session_hits = prefix_hits = prefix_tokens = 0
    decode_time = prefill_time = 0.0
    paged_engines = kv_blocks_in_use = kv_blocks_total = 0
    prefix_hit_tokens = prefix_evictions = 0
    handoff_exported_bytes = handoff_imported_bytes = 0
    handoff_exports = handoff_imports = handoff_imported_tokens = 0
    host_engines = kv_host_blocks_in_use = kv_host_blocks_total = 0
    host_demotions = host_promotions = host_evictions = 0
    host_demote_bytes = host_promote_bytes = 0
    kv_host_hit_tokens = host_promote_aborts = 0
    spec_engines = spec_drafted = spec_accepted = 0
    mixed_engines = mixed_chained = 0
    active_slot_steps = total_slot_steps = useful_tokens = 0
    decode_flops = decode_bytes = prefill_flops = 0.0
    peaks: Optional[accounting.PeakSpecs] = None
    wasted: Dict[str, int] = dict.fromkeys(WASTE_REASONS, 0)
    # pre-seeded: every series exists before its first event
    carry_invalidations: Dict[str, int] = dict.fromkeys(CARRY_INVALIDATIONS, 0)
    shed_engines = 0
    shed: Dict[str, int] = {"queue_timeout": 0}
    # snapshot-tolerant reads: a supervisor rebuild registers the new
    # engine from the dying engine thread, and the engine thread adds new
    # wasted/shed reasons while a scrape iterates
    live_engines = stable_list(_LIVE_ENGINES)
    for engine in live_engines:
        stats = engine.stats
        tokens += stats["tokens_generated"]
        steps += stats["decode_steps"]
        chunks += stats["decode_chunks"]
        requests += stats["requests"]
        decode_time += stats["decode_time"]
        prefill_time += stats["prefill_time"]
        session_hits += stats["session_hits"]
        prefix_hits += stats["prefix_hits"]
        prefix_tokens += stats["prefix_tokens_reused"]
        active_slot_steps += stats["active_slot_steps"]
        total_slot_steps += stats["decode_steps"] * engine.max_slots
        useful_tokens += stats["tokens_useful"]
        for reason, count in stable_items(stats["tokens_wasted"]):
            wasted[reason] = wasted.get(reason, 0) + count
        decode_flops += stats["decode_flops"]
        decode_bytes += stats["decode_bytes"]
        prefill_flops += stats["prefill_flops"]
        peaks = engine.peaks
        if engine.slo is not None:
            # the targets are config: visible from the first scrape
            out.update(engine.slo.gauges())
        if engine.mixed:
            mixed_engines += 1
            mixed_chained += stats["mixed_steps_chained"]
            for reason, count in stable_items(stats["mixed_carry_invalidations"]):
                carry_invalidations[reason] = carry_invalidations.get(reason, 0) + count
        if engine.queue_timeout_s:
            shed_engines += 1
        for reason, count in stable_items(stats["requests_shed"]):
            shed[reason] = shed.get(reason, 0) + count
        if engine.spec:
            spec_engines += 1
            spec_drafted += stats["tokens_drafted"]
            spec_accepted += stats["tokens_draft_accepted"]
        if engine.kv_manager is not None:
            paged_engines += 1
            kv_blocks_in_use += engine.kv_manager.blocks_in_use
            kv_blocks_total += engine.num_blocks
            prefix_hit_tokens += engine.kv_manager.stats["hit_tokens"]
            prefix_evictions += engine.kv_manager.stats["evictions"]
            handoff_exports += stats["handoff_exports"]
            handoff_exported_bytes += stats["handoff_export_bytes"]
            handoff_imports += stats["handoff_imports"]
            handoff_imported_bytes += stats["handoff_import_bytes"]
            handoff_imported_tokens += stats["handoff_import_tokens"]
            arena = engine.kv_host_arena
            if arena is not None:
                host_engines += 1
                arena_stats = arena.snapshot_stats()
                kv_host_blocks_in_use += arena_stats["blocks_in_use"]
                kv_host_blocks_total += arena.capacity_blocks
                host_evictions += arena_stats["evictions"]
                host_demotions += stats["host_demotions"]
                host_demote_bytes += stats["host_demote_bytes"]
                host_promotions += stats["host_promotions"]
                host_promote_bytes += stats["host_promote_bytes"]
                kv_host_hit_tokens += stats["kv_host_hit_tokens"]
                host_promote_aborts += stats["host_promote_aborts"]
    if live_engines:
        # the series exist from construction (0 included): rate() alerts
        # need them before the first trip
        from langstream_tpu_torch.runtime.watchdog import trips_total

        out["watchdog_trips_total"] = float(trips_total())
        out["torch_engine_queue_depth"] = float(sum(e.queue_depth for e in live_engines))
    if paged_engines:
        out["kv_blocks_in_use"] = float(kv_blocks_in_use)
        out["kv_blocks_total"] = float(kv_blocks_total)
        out["prefix_cache_hit_tokens_total"] = float(prefix_hit_tokens)
        out["prefix_cache_evictions_total"] = float(prefix_evictions)
        # the KV handoff's series exist on every paged engine from
        # construction: a decode replica importing nothing scrapes a flat 0
        out["kv_handoff_exports_total"] = float(handoff_exports)
        out["kv_handoff_exported_bytes_total"] = float(handoff_exported_bytes)
        out["kv_handoff_imports_total"] = float(handoff_imports)
        out["kv_handoff_imported_bytes_total"] = float(handoff_imported_bytes)
        out["kv_handoff_imported_tokens_total"] = float(handoff_imported_tokens)
    if host_engines:
        # the host tier's series, only where one is configured (an
        # untiered deployment's exposition stays as it was)
        out["kv_host_blocks_in_use"] = float(kv_host_blocks_in_use)
        out["kv_host_blocks_total"] = float(kv_host_blocks_total)
        out["kv_host_demotions_total"] = float(host_demotions)
        out["kv_host_demoted_bytes_total"] = float(host_demote_bytes)
        out["kv_host_promotions_total"] = float(host_promotions)
        out["kv_host_promoted_bytes_total"] = float(host_promote_bytes)
        out["kv_host_hit_tokens_total"] = float(kv_host_hit_tokens)
        out["kv_host_promote_aborts_total"] = float(host_promote_aborts)
        out["kv_host_evictions_total"] = float(host_evictions)
    if spec_engines:
        out["spec_tokens_drafted_total"] = float(spec_drafted)
        out["spec_tokens_accepted_total"] = float(spec_accepted)
        out["spec_acceptance_rate"] = round(spec_accepted / spec_drafted, 4) if spec_drafted else 0.0
    if mixed_engines:
        # the mixed-step carry's chains and their breaks by reason, from
        # construction (process-wide: read deltas)
        out["torch_engine_mixed_steps_chained_total"] = float(mixed_chained)
        for reason, count in sorted(carry_invalidations.items()):
            out[f'mixed_carry_invalidations_total{{reason="{reason}"}}'] = float(count)
    if shed_engines or any(shed.values()):
        # admission deadlines armed (or sheds already made)
        for reason, count in sorted(shed.items()):
            out[f'requests_shed_total{{reason="{reason}"}}'] = float(count)
    # the recovery families exist even with no live engine: mid-rebuild is
    # when an operator scrapes for them
    supervisor_mod = _supervisor_module()
    if supervisor_mod is not None:
        out.update(supervisor_mod.supervisor_gauges())
    if not (tokens or steps):
        return out
    out["torch_engine_requests"] = float(requests)
    out["torch_engine_session_hits"] = float(session_hits)
    out["torch_engine_prefix_hits"] = float(prefix_hits)
    out["torch_engine_prefix_tokens_reused"] = float(prefix_tokens)
    out["torch_engine_tokens_generated"] = float(tokens)
    out["torch_engine_decode_steps"] = float(steps)
    out["torch_engine_decode_chunks"] = float(chunks)
    out["torch_engine_decode_time_seconds"] = round(decode_time, 6)
    out["torch_engine_prefill_time_seconds"] = round(prefill_time, 6)
    if steps:
        out["torch_engine_decode_ms_per_step"] = round(decode_time / steps * 1e3, 4)
    if total_slot_steps:
        out["torch_engine_slot_occupancy"] = round(active_slot_steps / total_slot_steps, 4)
    # the goodput ledger: tokens useful, and wasted by reason
    out["torch_engine_tokens_useful_total"] = float(useful_tokens)
    for reason, count in sorted(wasted.items()):
        out[f'torch_engine_tokens_wasted_total{{reason="{reason}"}}'] = float(count)
    accounted = useful_tokens + sum(wasted.values())
    if accounted:
        out["torch_engine_goodput_ratio"] = round(useful_tokens / accounted, 4)
    # roofline shares of all decode work so far: modeled FLOPs and bytes
    # over the busy decode time (the union of pipelined chunks' intervals)
    if peaks is not None and decode_time > 0:
        out["torch_engine_mfu"] = round(accounting.CostModel.mfu(decode_flops, decode_time, peaks), 6)
        out["torch_engine_mbu"] = round(accounting.CostModel.mbu(decode_bytes, decode_time, peaks), 6)
    if peaks is not None and prefill_time > 0 and prefill_flops:
        # prefill runs in its own calls and is bound by operations: a gauge
        # of its own
        out["torch_engine_prefill_mfu"] = round(
            accounting.CostModel.mfu(prefill_flops, prefill_time, peaks), 6)
    return out


def fail_request_future(request: "GenerationRequest", error: BaseException) -> None:
    """Deliver ``error`` to a request's waiter from any thread: the one
    future-failing path of crash fail-fast, load shedding, the retired
    queue's stragglers and the supervisor's give-up."""
    future = request.future
    if future is None:
        return

    def resolve() -> None:
        if not future.done():
            future.set_exception(error)

    if request.loop is not None:
        try:
            request.loop.call_soon_threadsafe(resolve)
        except RuntimeError:
            pass  # the waiter's loop is already closed
    else:
        resolve()


class _Condemned(Exception):
    """Raised on a condemned engine's thread before it would launch:
    the supervisor took over while the thread slept or worked."""

# the step variants of a prefill call: the model call, cold or at an
# offset, and the first-token sampling behind it
PREFILL_KINDS = ("prefill", "prefill_offset", "first_token")


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0            # 0 = no top-k
    top_p: float = 0.0        # 0 = no nucleus truncation
    max_new_tokens: int = 256
    # OpenAI-style repetition penalties over the GENERATED tokens
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # per-request RNG seed (OpenAI `seed`): keys derive from (seed, cache
    # position). None = a fresh auto-seed per request
    seed: Optional[int] = None
    # OpenAI `logit_bias`: token id → additive logit adjustment
    logit_bias: Optional[Dict[int, float]] = None


@dataclasses.dataclass
class GenerationRequest:
    prompt_tokens: List[int]
    sampling: SamplingParams
    stop_tokens: Set[int] = dataclasses.field(default_factory=set)
    # called with (token_id, is_last) — on ``loop`` when one is set
    on_token: Optional[Callable[[int, bool], None]] = None
    # KV-cache affinity: the slot is pinned for this session at finish
    session_id: Optional[str] = None
    # an asyncio future (with ``loop``) or a concurrent.futures.Future
    future: Optional[Any] = None
    loop: Optional[Any] = None
    # set from ANY thread via cancel(); the engine finishes the request
    # with reason "cancelled" at the next token boundary
    cancelled: bool = False
    # session resurrection (runtime/supervisor.py): the tokens a crashed
    # engine had already emitted. drain_for_recovery rewrites
    # prompt_tokens to prompt + replay[:-1], prefilled as any prompt, and
    # the harvest fast-forwards the slot through them instead of emitting
    # a fresh sample. prompt_len keeps the original prompt length
    replay_tokens: Optional[List[int]] = None
    replay_logprobs: Optional[List[float]] = None
    replay_tops: Optional[List[Tuple[List[int], List[float]]]] = None
    prompt_len: Optional[int] = None
    # prefill/decode disaggregation (fleet/handoff.py): a prefill-leg
    # request asks the engine to export its published KV chain at finish
    # (GenerationResult.kv_handoff); a decode-leg replay request carries
    # the assembled payload, imported into the pool before admission so
    # the replay prefill hits the prefix cache instead of recomputing it
    export_handoff: bool = False
    kv_import: Optional[Dict[str, Any]] = None
    # the prefill replica's export stamp (wall seconds, from the manifest):
    # the decode leg's journey starts with its handoff_transit stage
    handoff_export_ts: Optional[float] = None
    # end-to-end trace context (the x-langstream-trace-id header, or one
    # the server minted): tags the request's spans and its journey
    trace_id: Optional[str] = None

    def cancel(self) -> None:
        self.cancelled = True


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    prompt_tokens: int
    finish_reason: str = "stop"
    # per-token log-probability under the untruncated distribution
    logprobs: List[float] = dataclasses.field(default_factory=list)
    # per-token top-K alternatives (OpenAI `top_logprobs`): one (ids,
    # logprobs) pair per generated token; None when the engine runs with
    # logprobs_topk=0
    top_logprobs: Optional[List[Tuple[List[int], List[float]]]] = None
    # disaggregation prefill leg (request.export_handoff): the published
    # KV chain, tokens and per-leaf pool rows (fleet/handoff.py chunks it
    # into records)
    kv_handoff: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class _Slot:
    request: Optional[GenerationRequest] = None
    length: int = 0                 # valid cache length
    generated: Optional[List[int]] = None
    logprobs: Optional[List[float]] = None
    tops: Optional[List[Tuple[List[int], List[float]]]] = None  # top-K
    history: Optional[List[int]] = None  # tokens in cache + the pending one
    epoch: int = 0                  # bumps on assign/finish
    blocks: Optional[List[int]] = None   # paged: the slot's reserved pool blocks
    session_id: Optional[str] = None     # pinned session (slot free but warm)
    last_used: float = 0.0          # monotonic; the LRU eviction order
    prefilling: bool = False        # admitted, first token not sampled yet
    # mixed dispatch: the next prompt index a mixed step teaches (None =
    # not admitting through mixed steps); windows of up to prefill_chunk
    # tokens ride successive steps until it reaches the prompt's end
    prefill_pos: Optional[int] = None
    prefill_seq: int = 0            # admission order (the FIFO budget share)
    prefill_t0: float = 0.0         # admission time
    prefill_reused: int = 0         # prompt tokens the prefix cache served

    @property
    def active(self) -> bool:
        return self.request is not None

    @property
    def ready(self) -> bool:
        """Taking part in decode (its first token sampled)."""
        return self.request is not None and not self.prefilling


def _bucket(length: int, buckets: List[int]) -> int:
    for size in buckets:
        if length <= size:
            return size
    return buckets[-1]


def long_prefill_windows(total: int, reused: int, buckets: List[int]) -> List[Tuple[int, int]]:
    """(offset, bucket) windows that prefill positions [reused, total):
    largest-bucket windows left to right, then the tail's bucket shifted
    left to end exactly at ``total`` (it re-teaches a few written
    positions, same tokens and so the same KV, instead of needing a
    ragged tail, and never writes past the prompt)."""
    largest = buckets[-1]
    windows: List[Tuple[int, int]] = []
    position = reused
    while total - position > largest:
        windows.append((position, largest))
        position += largest
    tail_bucket = _bucket(total - position, buckets)
    windows.append((max(0, total - tail_bucket), tail_bucket))
    return windows


def _pow2_groups(batch: List[Any]) -> List[List[Any]]:
    """Split into power-of-two group sizes (no padding rows)."""
    groups: List[List[Any]] = []
    remaining = batch
    while remaining:
        size = 1
        while size * 2 <= len(remaining):
            size *= 2
        groups.append(remaining[:size])
        remaining = remaining[size:]
    return groups


class DecodeEngine:
    """Runs one model on one device with continuous batching."""

    # sparse per-request logit_bias entries threaded to the device as
    # [batch, MAX_LOGIT_BIAS] (id, value) pairs; padding = (0, 0.0)
    MAX_LOGIT_BIAS = 64

    def __init__(
        self,
        config: model_lib.LlamaConfig,
        params: Dict[str, torch.Tensor],
        *,
        device: Any = "cuda",
        max_slots: int = 8,
        max_seq_len: Optional[int] = None,
        prefill_buckets: Optional[List[int]] = None,
        decode_chunk: int = 8,
        seed: int = 0,
        kv_layout: str = "dense",         # "dense" | "paged" (block pool)
        kv_block_size: int = 16,          # paged: tokens per pool block
        kv_blocks: Optional[int] = None,  # paged: pool size (None = the
                                          # dense-equivalent worst case)
        kv_host_blocks: int = 0,          # paged: host-DRAM demotion tier
                                          # capacity in blocks: evicted
                                          # chains demote there and are
                                          # promoted back on a digest
                                          # match (0 = off)
        paged_kernel: str = "fused",      # paged attention: "fused" (the
                                          # ragged kernel) | "reference"
                                          # (the gather composition)
        prefix_cache: bool = True,
        kv_quant: Optional[str] = None,   # "int8" = int8 KV cache
        prefill_mode: str = "split",      # paged prefill scheduling:
                                          # "split" (bucketed prefill
                                          # calls) | "mixed" (prompt
                                          # windows ride the decode step)
        prefill_chunk: int = 64,          # mixed: most prompt tokens one
                                          # step carries
        mixed_carry: bool = True,         # mixed: chain consecutive mixed
                                          # steps off the previous step's
                                          # device outputs; needs
                                          # pipeline_decode
        pipeline_decode: bool = False,    # dispatch chunk N+1 off chunk
                                          # N's device carry before
                                          # processing N on the host
        quantize: Optional[str] = None,   # "int8" = weight-only int8
        admission_chunk: Optional[int] = None,  # cap the decode chunk at
                                          # this many steps while
                                          # admissions wait (None = off)
        step_graphs: bool = True,         # decode chunks, mixed steps and
                                          # prefill calls as one CUDA graph
                                          # per variant (eager on the CPU);
                                          # False = eager dispatch
        join_prefills: bool = True,       # with no chunk in flight, wait
                                          # for every prefill in flight
                                          # before a fresh chunk, which
                                          # they then join (False = the
                                          # JAX engine's harvest)
        spec_decode: str = "off",         # "off" | "ngram" (self-drafting
                                          # speculative decoding)
        spec_k: int = 4,                  # drafted tokens per decode step
        spec_ngram: int = 2,              # suffix n-gram the drafter matches
        logprobs_topk: int = 0,           # top-K alternatives a token
                                          # (OpenAI `top_logprobs`); static:
                                          # it shapes every step's outputs
        queue_timeout_s: Optional[float] = None,  # admission deadline: a
                                          # request pending longer is shed
                                          # with QueueTimeoutError (None = off)
        slo: Optional[Dict[str, float]] = None,  # p95 targets,
                                          # {"ttft_ms_p95", "tpot_ms_p95"}:
                                          # burn rates and blame on /metrics
        mesh_config: Optional[MeshConfig] = None,  # tp N > 1: this process
                                          # is one rank of N (torch.distributed
                                          # up); other axes raise
    ) -> None:
        # chaos and evidence planes, as every JAX engine construction arms
        # them (a rebuilt engine re-arms the same spec; the arrival
        # counters are process-global, so a one-shot fault stays consumed)
        faults.configure_from_env()
        flight.configure_from_env()
        self.device = resolve_device(device)
        mesh_config = mesh_config or MeshConfig()
        require_serving_mesh(mesh_config)
        validate_mesh(mesh_config, num_heads=config.num_heads, num_kv_heads=config.num_kv_heads,
                      intermediate_size=config.intermediate_size,
                      num_experts=config.num_experts, num_layers=config.num_layers)
        self.mesh_config = mesh_config
        self.tp = mesh_config.tp
        # multi-rank serving: when set (serving/mirror.py), every step
        # dispatch and every write to the pool or the counts outside a step
        # is published before it runs, for the followers to replay
        self.mirror: Optional[Any] = None
        self.config = config
        self.max_slots = max_slots
        self.decode_chunk = max(1, decode_chunk)
        # TTFT lever, as in the JAX engine: while requests wait for a slot,
        # a fresh chunk runs at most this many steps so a slot frees sooner
        self.admission_chunk = (
            min(int(admission_chunk), self.decode_chunk)
            if admission_chunk and int(admission_chunk) > 0 else None
        )
        self.max_seq_len = min(max_seq_len or config.max_seq_len, config.max_seq_len)
        self.prefill_buckets = sorted(prefill_buckets or self._default_buckets())
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv layout {kv_layout!r}")
        if paged_kernel not in model_lib.PAGED_KERNELS:
            raise ValueError(f"unknown paged kernel {paged_kernel!r}")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unknown kv cache quantization {kv_quant!r}")
        if prefill_mode not in ("split", "mixed"):
            raise ValueError(f"unknown prefill mode {prefill_mode!r}")
        if spec_decode not in ("off", "ngram"):
            raise ValueError(f"unknown spec decode mode {spec_decode!r}")
        if prefill_mode == "mixed" and kv_layout != "paged":
            raise ValueError(
                "prefill_mode 'mixed' requires kv_layout 'paged': the dense cache has no "
                "per-row table for the token-ragged mixed step to address"
            )
        self.kv_quant = kv_quant == "int8"
        self.spec_decode = spec_decode
        self.spec = spec_decode == "ngram"
        self.spec_k = max(1, int(spec_k))
        self.spec_ngram = max(1, int(spec_ngram))
        # tokens one decode step can emit a slot (the verify block's width)
        self.spec_block = self.spec_k + 1 if self.spec else 1
        self.logprobs_topk = max(0, int(logprobs_topk))
        self.kv_layout = kv_layout
        self.paged = kv_layout == "paged"
        # mixed: admitting slots park at a prefill_pos watermark and every
        # step carries up to prefill_chunk of their prompt tokens beside
        # the decode rows, in one model call (paged_mixed_step)
        self.prefill_mode = prefill_mode
        self.mixed = prefill_mode == "mixed"
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.pipeline_decode = bool(pipeline_decode)
        self.join_prefills = bool(join_prefills)
        self.mixed_carry = self.mixed and bool(mixed_carry)
        # mixed step widths: powers of two up to the rounded-up budget, so
        # every width tiles by the token-ragged kernel's q tile
        cap = 1
        while cap < self.prefill_chunk:
            cap *= 2
        widths = [min(8, cap)]
        while widths[-1] < cap:
            widths.append(widths[-1] * 2)
        self._mixed_widths = widths
        self._admit_seq = 0
        self.paged_kernel = paged_kernel if self.paged else None
        self.prefix_cache = prefix_cache
        if quantize or any(isinstance(p, QTensor) for p in params.values()):
            if quantize not in (None, "int8"):
                raise ValueError(f"unknown quantization {quantize!r}")
            if self.tp > 1 and not isinstance(params.get("wo"), QTensor):
                wq = params["wq"]
                if wq.shape[-1] != config.num_heads * config.dims_per_head:
                    # a row-sharded weight's scale is the whole row's
                    raise ValueError("quantize the full weights before sharding them over tp")
            params = quantize_params(params, config.num_experts)
        model_lib.validate_family_params(config, params)
        full_config = config
        if self.tp > 1:
            # this rank's shard and config (the heads, kv heads and
            # intermediate width divided, the group for the collectives)
            self.group = build_group(mesh_config, self.device)
            params = model_lib.rank_params(config, params, mesh_config, self.group.rank)
            config = self.config = model_lib.rank_config(config, self.group)
        else:
            self.group = None
        if (
            self.paged_kernel == "fused" and self.device.type == "cuda"
            and not fused_shapes_ok(
                config.num_heads, config.num_kv_heads, config.dims_per_head, quantized=self.kv_quant
            )
        ):
            # never relabelled to "reference" quietly: the caller asks for it
            raise ValueError(
                f"the ragged paged-attention kernel cannot take {config.num_heads} heads "
                f"over {config.num_kv_heads} kv heads at head_dim {config.dims_per_head}"
                f"{' over int8 pools' if self.kv_quant else ''}; "
                f"pass paged_kernel='reference' to run the gather composition"
            )
        self.params = {name: p.to(self.device) for name, p in params.items()}
        self.freqs = model_lib.model_freqs(config, device=self.device)
        self.kv_manager: Optional[PagedKVManager] = None
        self.kv_host_blocks = 0
        self.kv_host_arena: Optional[HostKVArena] = None
        # device state, mutated in place only on the engine thread
        if self.paged:
            self.block_size = max(1, int(kv_block_size))
            # per-slot table width: enough blocks to address max_seq_len
            self.max_blocks = -(-self.max_seq_len // self.block_size)
            # default pool = the dense layout's worst case (+ the null
            # block); deployments size it down
            self.num_blocks = int(kv_blocks or max_slots * self.max_blocks + 1)
            if self.num_blocks < self.max_blocks + 1:
                raise ValueError(
                    f"kv_blocks={self.num_blocks} cannot hold even one "
                    f"max-length sequence ({self.max_blocks} blocks of "
                    f"{self.block_size})"
                )
            self.kv_manager = PagedKVManager(self.num_blocks, self.block_size)
            # two-tier pool: a bounded host-RAM arena below the block pool.
            # Eviction demotes victim blocks into it (a D2H copy into
            # pinned memory) and admission promotes digest matches back
            # (an H2D scatter) before falling back to a cold prefill
            self.kv_host_blocks = max(0, int(kv_host_blocks or 0))
            if self.kv_host_blocks:
                self.kv_host_arena = HostKVArena(self.kv_host_blocks)
                self.kv_host_arena.on_evict = self._note_host_evicted
                self.kv_manager.attach_host(self.kv_host_arena, self._demote_block_data,
                                            self._note_demoted)
            # host-authoritative block tables [slots, max_blocks]; rows are
            # uploaded per dispatch (0 = the null block)
            self._block_tables = np.zeros((max_slots, self.max_blocks), dtype=np.int32)
            self.cache = model_lib.init_paged_cache(
                config, self.num_blocks, self.block_size, kv_quant=self.kv_quant,
                device=self.device,
            )
            if self.kv_host_arena is not None and self.device.type == "cuda":
                # pin the arena's host memory now: a pinned allocation costs
                # about a millisecond per MiB, which a demotion would pay
                # per block inside an admission's eviction pass. Freed here,
                # the buffers stay in the caching host allocator, where the
                # demotions' buffers of the same sizes come from
                pinned = [self._host_buffer(value[:, 0]) for _ in range(self.kv_host_blocks)
                          for value in self.cache.values()]
                del pinned
        else:
            self.cache = model_lib.init_cache(
                config, max_slots, self.max_seq_len, kv_quant=self.kv_quant, device=self.device
            )
        # per-slot generated-token counts for presence/frequency penalties
        self._counts = torch.zeros(
            (max_slots, config.vocab_size), dtype=torch.int32, device=self.device
        )
        self.slots = [_Slot() for _ in range(max_slots)]
        # the accounting plane: modeled FLOPs and bytes of every dispatch
        # from the shape, the weights' and the cache's widths and the
        # layout, over measured wall time and the card's peaks
        self.peaks = accounting.PeakSpecs.from_env()
        self.cost_model = accounting.CostModel.from_model_config(
            full_config,
            weight_quant="int8" if any(isinstance(p, QTensor) for p in self.params.values()) else None,
            kv_quant=self.kv_quant,
            kv_block_size=self.block_size if self.paged else 1,
            paged_kernel=self.paged_kernel,
            tp=self.tp,
        )
        # SLO burn rates over the process-wide TTFT and TPOT histograms
        self.slo = (accounting.SLOTracker(slo, {"ttft": TTFT_SECONDS, "tpot": TPOT_SECONDS})
                    if slo else None)
        # per-request spans (the no-op tracer unless LANGSTREAM_TRACE_DIR)
        self.tracer = get_tracer("engine")
        # pinned sessions whose warm cache was evicted -> the history length
        # it held, so a follow-up's re-prefill is booked as recompute
        self._evicted_sessions: Dict[str, int] = {}
        # every decode chunk, mixed step, prefill call and KV copy goes
        # through the step runner; a prefill variant first met while
        # serving warms up on its own call, never on a dummy that writes
        # another slot's rows (a copy's dummy copies a slot onto itself)
        # under tp a gloo collective cannot sit inside a CUDA graph: the
        # step functions run eagerly
        step_graphs = step_graphs and self.tp == 1
        self.steps = StepRunner(
            self.device, graphs=step_graphs, body=self._step_body, dummy=self._step_dummy,
            warm_on_call=lambda key: key.kind in PREFILL_KINDS,
        )
        self.precompile_s: Optional[float] = None
        self.base_seed = seed
        self._seed_sequence = 0
        self._queue: "queue.Queue[Optional[GenerationRequest]]" = queue.Queue()
        self._pending: List[GenerationRequest] = []  # owned by the engine thread
        # prefill calls dispatched and not yet harvested, oldest first
        self._prefill_inflight: List[Dict[str, Any]] = []  # owned by the engine thread
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._crashed: Optional[BaseException] = None
        # supervised mode (runtime/supervisor.py): a crashed engine thread
        # hands its live sessions to this hook instead of failing every
        # waiter. Unset, the engine fails fast
        self.on_crash: Optional[Callable[[BaseException], None]] = None
        self.queue_timeout_s = float(queue_timeout_s) if queue_timeout_s else None
        # EWMA seconds per decode step: the Retry-After estimate of a shed
        self._step_ewma: Optional[float] = None
        # set once drain_for_recovery swept the queue: a later submit
        # fails itself, since nothing reads the queue again
        self._recovery_drained = False
        # end of the latest processed chunk: pipelined chunks overlap, so
        # decode_time sums the union of their intervals
        self._decode_busy_until = 0.0
        # end of the latest processed mixed step (0 after a plain chunk)
        self._last_mixed_end = 0.0
        self.stats = self._fresh_stats()
        self.step_functions = "graphs" if self.steps.graphed else "eager"
        self.stats["step_functions"] = self.step_functions
        _LIVE_ENGINES.add(self)
        flight.record("engine_start", slots=max_slots, ctx=self.max_seq_len,
                      layout=kv_layout, device=str(self.device))

    @staticmethod
    def _fresh_stats() -> Dict[str, Any]:
        return {
            "requests": 0,
            "prefill_calls": 0,
            "decode_steps": 0,    # model decode steps, mixed steps included
            "decode_chunks": 0,   # decode chunks and mixed steps processed
            # tokens an average active slot gained, summed over chunks:
            # decode_steps without speculation (the watchdog's per-token
            # normalizer, as the JAX engine's)
            "decode_token_steps": 0.0,
            "decode_time": 0.0,   # wall secs inside decode chunks and mixed
                                  # steps (the union of pipelined ones)
            "active_slot_steps": 0,  # active slots summed over decode steps
            "tokens_generated": 0,
            # the goodput ledger: tokens that reached a live caller (the
            # wasted ones are in tokens_wasted)
            "tokens_useful": 0,
            # modeled work: decode chunks and mixed steps, and prefill calls
            "decode_flops": 0.0,
            "decode_bytes": 0.0,
            "prefill_flops": 0.0,
            "prefill_time": 0.0,  # wall secs dispatching prefill calls and
                                  # waiting for them at harvest
            "ttft_time": 0.0,     # summed submit → first-token secs of
                                  # finished requests
            "warm_prefill_calls": 0,     # prefills at an offset (prefix hits)
            "session_hits": 0,           # admissions onto a pinned session
            "prefix_hits": 0,            # admissions onto another request's
                                         # rows (dense copy, paged chain)
            "prefix_tokens_reused": 0,   # prompt tokens those did not prefill
            # speculative decoding: drafted candidates, and those accepted
            "tokens_drafted": 0,
            "tokens_draft_accepted": 0,
            # tokens computed for nothing, by reason (WASTE_REASONS)
            "tokens_wasted": {},
            # requests failed fast at their admission deadline, by reason
            "requests_shed": {},
            "mixed_steps": 0,            # mixed prefill+decode model calls
            "mixed_time": 0.0,           # wall secs inside them (in decode_time too)
            "mixed_admit_time": 0.0,     # summed admission → first-token secs
                                         # of prompts the mixed steps carried
            # mixed-step carry: steps chained off the previous step's
            # device outputs, and why chains broke (reason -> events)
            "mixed_steps_chained": 0,
            "mixed_carry_invalidations": {},
            # every call into the model, by model function
            "model_dispatches": {},
            # paged-KV handoff (prefill/decode disaggregation): exports
            # gathered off this engine's pool, imports written into it,
            # and the device bytes each way
            "handoff_exports": 0,
            "handoff_export_bytes": 0,
            "handoff_imports": 0,
            "handoff_import_bytes": 0,
            "handoff_import_tokens": 0,
            # host-DRAM tier: blocks moved each way with their bytes,
            # prompt tokens promotions served instead of a prefill, and
            # promotions that tore and fell back to a cold prefill
            "host_demotions": 0,
            "host_demote_bytes": 0,
            "host_promotions": 0,
            "host_promote_bytes": 0,
            "kv_host_hit_tokens": 0,
            "host_promote_aborts": 0,
        }

    def reset_stats(self) -> None:
        self.stats = self._fresh_stats()
        self.stats["step_functions"] = self.step_functions

    def _default_buckets(self) -> List[int]:
        buckets, size = [], 64
        while size < self.max_seq_len:
            buckets.append(size)
            size *= 2
        buckets.append(self.max_seq_len)
        return buckets

    # ------------------------------------------------------------------ #
    # public API (thread-safe)
    # ------------------------------------------------------------------ #
    def start(self) -> None:
        if self._crashed is not None:
            if self.on_crash is not None:
                raise api_errors.EngineRebuildingError(
                    "engine is rebuilding after a crash; retry shortly", retry_after_s=2.0)
            raise RuntimeError("decode engine crashed") from self._crashed
        if self._thread is not None:
            return
        self._running = True
        self._thread = threading.Thread(
            target=self._run_loop, name="torch-local-engine", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._prefill_inflight = []
        flight.record("engine_stop", tokens=self.stats["tokens_generated"],
                      requests=self.stats["requests"], decode_steps=self.stats["decode_steps"])
        flight.flush()
        if self.mirror is not None:
            try:
                self.mirror.publish("stop", {}, [])
            except Exception:  # noqa: BLE001 — the writer died with a follower
                logger.warning("mirror: stop record not delivered")
            self.mirror.close()

    def _mirror_crosses_hosts(self) -> bool:
        """Rank 0 of a mirror whose followers sit on other hosts
        (``serve --followers``): the engine keeps the JAX engine's
        multi-host refusals. A mirror of one host's ranks (``serve --tp``)
        serves what the JAX engine serves on one host's mesh."""
        return self.mirror is not None and not self.mirror.local

    def _publish(self, kind: str, meta: Dict[str, Any], arrays: list) -> None:
        """Publish a record outside a step (a write to the pool or the
        counts, a collective) when a mirror is set: before the write, so
        the followers make it in stream order, and before the collective,
        so they enter it too."""
        if self.mirror is not None:
            self._check_condemned()
            self.mirror.publish(kind, meta, arrays)

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot: the submit queue and the pending
        list (each read an atomic snapshot)."""
        return self._queue.qsize() + len(self._pending)

    def submit(self, request: GenerationRequest) -> None:
        """Enqueue a request; safe from any thread. Its ``future`` (an
        asyncio future with ``loop`` set, or a concurrent.futures.Future)
        receives the :class:`GenerationResult`. A crashed engine under a
        supervisor raises :class:`EngineRebuildingError` (HTTP 503)."""
        if self._crashed is not None:
            if self.on_crash is not None:
                raise api_errors.EngineRebuildingError(
                    "engine is rebuilding after a crash; retry shortly", retry_after_s=2.0)
            raise RuntimeError("decode engine crashed") from self._crashed
        if request.replay_tokens and self._mirror_crosses_hosts():
            # as the JAX engine under its multi-host mirror: on one host the
            # replay's counts restore rides a record of its own
            raise NotImplementedError(
                "session resurrection over the multi-host mirror is not supported")
        bias = request.sampling.logit_bias
        if bias and len(bias) > self.MAX_LOGIT_BIAS:
            raise ValueError(
                f"logit_bias has {len(bias)} entries; this engine supports "
                f"at most {self.MAX_LOGIT_BIAS}"
            )
        if not request.prompt_tokens:
            raise ValueError("empty prompt")
        # prompts longer than the largest bucket prefill in bucket-sized
        # windows, so context length is the only limit
        limit = self.max_seq_len - 1
        if len(request.prompt_tokens) > limit:
            raise ValueError(
                f"prompt of {len(request.prompt_tokens)} tokens exceeds the "
                f"context limit of {limit} (max_seq_len {self.max_seq_len})"
            )
        # durations from perf_counter; the wall twin places the journey's
        # stages on a timeline other processes share
        request._submit_ts = time.perf_counter()  # type: ignore[attr-defined]
        request._submit_wall = time.time()  # type: ignore[attr-defined]
        self._queue.put(request)
        if self._crashed is not None:
            # crashed between the check above and the put: the loop never
            # drains the queue again
            if self.on_crash is None:
                self._fail_all_pending()
            elif self._recovery_drained:
                # the recovery drain already swept the queue: fail any
                # stray (this request too, unless the drain took it) with
                # the typed retryable error
                self._fail_stragglers()

    async def generate(
        self,
        prompt_tokens: List[int],
        sampling_params: SamplingParams,
        *,
        stop_tokens: Optional[Set[int]] = None,
        on_token: Optional[Callable[[int, bool], None]] = None,
        session_id: Optional[str] = None,
        handle: Optional[List[GenerationRequest]] = None,
        trace_id: Optional[str] = None,
        request_fields: Optional[Dict[str, Any]] = None,
    ) -> GenerationResult:
        """Asyncio entry: submit and await the result. ``session_id`` pins
        the slot for the session's next turn. Pass ``handle`` (an empty
        list) to receive the live request, whose ``cancel()`` ends
        generation at the next token boundary. ``trace_id`` tags the
        request's spans and journey. ``request_fields`` sets
        extra :class:`GenerationRequest` fields before submit: the
        disaggregation seam (``export_handoff`` on the prefill leg;
        ``kv_import``, ``replay_tokens`` and ``prompt_len`` on the decode
        leg's warm admission)."""
        loop = asyncio.get_running_loop()
        future: "asyncio.Future[GenerationResult]" = loop.create_future()
        request = GenerationRequest(
            prompt_tokens=list(prompt_tokens),
            sampling=sampling_params,
            stop_tokens=stop_tokens or set(),
            on_token=on_token,
            session_id=session_id,
            future=future,
            loop=loop,
            trace_id=trace_id,
        )
        for name, value in (request_fields or {}).items():
            if not hasattr(request, name):
                raise TypeError(f"GenerationRequest has no field {name!r}")
            setattr(request, name, value)
        if handle is not None:
            handle.append(request)
        self.start()
        self.submit(request)
        try:
            return await future
        except asyncio.CancelledError:
            request.cancel()
            raise

    # ------------------------------------------------------------------ #
    # engine thread
    # ------------------------------------------------------------------ #
    def _run_loop(self) -> None:
        logger.info(
            "engine started: %d slots × %d ctx on %s",
            self.max_slots, self.max_seq_len, self.device,
        )
        try:
            with torch.inference_mode():
                inflight: Optional[Dict[str, Any]] = None
                while self._running:
                    self._drain_queue(
                        block=not self._any_active() and not self._pending
                        and inflight is None and not self._prefill_inflight
                    )
                    if not self._running:
                        break
                    if (
                        self._pending and inflight is None
                        and any(not s.active for s in self.slots)
                    ):
                        # admission linger: let a burst land so prefill
                        # batches fill up (not while a chunk is in flight:
                        # it would delay that chunk's tokens)
                        time.sleep(0.003)
                        self._drain_queue(block=False)
                    # prefills dispatch without blocking: they queue behind
                    # the chunk in flight, and their slots join decode once
                    # harvested
                    self._admit()
                    if inflight is not None:
                        # chain the next dispatch off the in-flight one's
                        # device outputs BEFORE waiting for its tokens
                        chained = None
                        if inflight.get("mixed"):
                            plan_next = self._plan_mixed_chain(inflight)
                            if isinstance(plan_next, dict):
                                chained = self._dispatch_mixed(carry=inflight, plan_next=plan_next)
                            else:
                                self._note_carry_invalidation(plan_next)
                        elif self._can_chain(inflight):
                            chained = self._dispatch_decode(carry=inflight)
                        self._process_decode(inflight)
                        inflight = chained
                    self._harvest_at_loop(inflight)
                    if inflight is None and (self._any_ready() or self._any_admitting()):
                        # one K-step decode chunk over the ready slots, or
                        # one mixed step while any slot is admitting
                        inflight = self._dispatch_decode()
                        if not self.pipeline_decode or (
                            inflight.get("mixed") and not self.mixed_carry
                        ):
                            # unpipelined (and mixed with the carry off):
                            # the next dispatch depends on this one's
                            # bookkeeping
                            self._process_decode(inflight)
                            inflight = None
                            self._harvest_prefills(block=False)
        except _Condemned:
            # the supervisor took this engine over while its thread slept
            # or worked: it owns the sessions now, and nothing is launched
            # or emitted from here
            logger.warning("condemned engine thread exits")
        except BaseException as exc:  # noqa: BLE001 — fail every waiter, re-raise
            logger.exception("engine loop crashed")
            # the crash flag first, so a racing submit either lands in the
            # queue the hook drains or raises
            self._crashed = exc
            self._running = False
            # the flight artifact is the crash's on-disk evidence
            flight.record("engine_crash", error=repr(exc)[:512])
            flight.flush()
            if self.on_crash is not None:
                # supervised: the live sessions stay in the queue, pending
                # list and slots for the hook, which runs the whole heal
                # arc on this dying thread; the crash is logged and handled
                self.on_crash(exc)
                return
            self._fail_all_pending()
            raise

    def _any_active(self) -> bool:
        return any(slot.active for slot in self.slots)

    def _any_ready(self) -> bool:
        return any(slot.ready for slot in self.slots)

    def _any_admitting(self) -> bool:
        """Mixed mode: slots parked at a prefill watermark, waiting for
        steps to carry their prompt windows."""
        return self.mixed and any(
            slot.prefill_pos is not None and slot.request is not None for slot in self.slots
        )

    def _drain_queue(self, block: bool) -> None:
        try:
            item = self._queue.get(timeout=0.05) if block else self._queue.get_nowait()
            if item is not None:
                self._pending.append(item)
        except queue.Empty:
            return
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                self._pending.append(item)

    def _admit(self) -> None:
        """Move pending requests into slots, the JAX engine's admission.
        Warm-session follow-ups are admitted first; cold requests sharing
        a prompt bucket are prefilled in one batched call (FIFO; a request
        in another bucket starts the next round), warm follow-ups sharing a
        suffix bucket in one call at an offset; a prompt longer than the
        largest bucket is prefilled in windows. On the dense layout with
        ``prefix_cache``, a cold request whose prompt shares at least
        ``WARM_MIN_PREFIX`` tokens with another slot's rows copies them
        and prefills only its suffix.

        A round with copies dispatches cold batch → copies → long warm
        suffixes → warm suffixes: a copy reads rows whose writes are
        already enqueued and never rows a warm prefill is about to
        overwrite (every call is enqueued on the one stream in this
        order). Without copies it is warm first (a warm suffix is much
        cheaper than a cold batch). A request that waited past
        ``queue_timeout_s`` is shed first (:meth:`_shed_expired`)."""
        self._shed_expired()
        if any(r.cancelled for r in self._pending):
            keep = []
            for request in self._pending:
                if request.cancelled:
                    self._resolve_cancelled(request)
                else:
                    keep.append(request)
            self._pending = keep
        self._import_pending_handoffs()
        if self.mixed:
            return self._admit_mixed()
        if self.paged:
            return self._admit_paged()
        largest = self.prefill_buckets[-1]
        while self._pending:
            cold: List[Tuple[int, GenerationRequest]] = []
            cold_bucket: Optional[int] = None
            # suffix bucket -> [(slot, request, reused prefix length)]
            warm: Dict[int, List[Tuple[int, GenerationRequest, int]]] = {}
            copies: List[Tuple[int, int, int]] = []  # (src, dst, rows)
            # session follow-ups with a long suffix, dispatched at round end
            long_warm: List[Tuple[int, GenerationRequest, int]] = []
            sources: Set[int] = set()        # copy sources, kept from eviction
            cold_reserved: Set[int] = set()  # this round's cold slots
            warm_reserved: Set[int] = set()  # this round's warm slots
            progressed = False
            while self._pending:
                position, index, reused = self._scan_admission(frozenset(sources))
                if index is None:
                    break
                request = self._pending[position]
                if position > 0:
                    self._note_head_skip()
                if reused is not None:
                    suffix = len(request.prompt_tokens) - reused
                    suffix_bucket = _bucket(suffix, self.prefill_buckets)
                    self._pending.pop(position)
                    self.slots[index].request = request  # reserve the slot
                    self.stats["session_hits"] += 1
                    warm_reserved.add(index)
                    if suffix > largest or reused + suffix_bucket > self.max_seq_len:
                        # too big for one window, or a window at the offset
                        # would pass max_seq_len: the windowed path, at
                        # round end
                        long_warm.append((index, request, reused))
                    else:
                        warm.setdefault(suffix_bucket, []).append((index, request, reused))
                    continue
                prompt_len = len(request.prompt_tokens)
                found = (self._find_prefix_source(request, frozenset(cold_reserved),
                                                  frozenset(warm_reserved))
                         if self.prefix_cache else None)
                if found is not None:
                    src, lcp, in_round = found
                    suffix_bucket = _bucket(prompt_len - lcp, self.prefill_buckets)
                    needs_long = prompt_len - lcp > largest or lcp + suffix_bucket > self.max_seq_len
                    if src == index:
                        # the chosen slot holds the prefix itself (a
                        # finished slot's history): the rows are in place
                        self._pending.pop(position)
                        self.slots[index].request = request
                        self.stats["prefix_hits"] += 1
                        self.stats["prefix_tokens_reused"] += lcp
                        if needs_long:
                            self._prefill_long(index, request, lcp)
                            progressed = True
                        else:
                            warm.setdefault(suffix_bucket, []).append((index, request, lcp))
                            warm_reserved.add(index)
                        continue
                    if needs_long and not in_round:
                        # the windowed suffix dispatches now, so the copy
                        # does too (the source's rows are all enqueued)
                        self._pending.pop(position)
                        self.slots[index].request = request
                        self._dispatch_prefix_copy(src, index, lcp)
                        self._prefill_long(index, request, lcp)
                        progressed = True
                        continue
                    if not needs_long:
                        self._pending.pop(position)
                        self.slots[index].request = request
                        copies.append((src, index, lcp))
                        sources.add(src)
                        warm.setdefault(suffix_bucket, []).append((index, request, lcp))
                        warm_reserved.add(index)
                        continue
                    # a long suffix over an in-round source, whose prefill
                    # is not enqueued yet: cold
                if prompt_len > largest:
                    self._pending.pop(position)
                    self.slots[index].request = request  # reserve the slot
                    self._prefill_long(index, request, 0)
                    progressed = True
                    continue
                bucket = _bucket(prompt_len, self.prefill_buckets)
                if cold_bucket is None:
                    cold_bucket = bucket
                elif bucket != cold_bucket:
                    break  # different bucket: next outer round
                self._pending.pop(position)
                self.slots[index].request = request  # reserve the slot
                cold.append((index, request))
                cold_reserved.add(index)
                if len(cold) >= self.max_slots:
                    break
            if copies:
                if cold:
                    self._prefill_batch(cold, cold_bucket)
                    progressed = True
                for src, dst, rows in copies:
                    self._dispatch_prefix_copy(src, dst, rows)
                for index, request, reused in long_warm:
                    self._prefill_long(index, request, reused)
                    progressed = True
                for suffix_bucket, batch in warm.items():
                    self._prefill_warm_batch(batch, suffix_bucket)
                    progressed = True
            else:
                for index, request, reused in long_warm:
                    self._prefill_long(index, request, reused)
                    progressed = True
                for suffix_bucket, batch in warm.items():
                    self._prefill_warm_batch(batch, suffix_bucket)
                    progressed = True
                if cold:
                    self._prefill_batch(cold, cold_bucket)
                    progressed = True
            if not progressed:
                return

    def _shed_expired(self) -> None:
        """Admission deadlines (``queue_timeout_s``): a pending request
        older than the deadline fails fast with a typed
        :class:`QueueTimeoutError` instead of starving in the queue while
        its caller times out anyway."""
        timeout = self.queue_timeout_s
        if not timeout or not self._pending:
            return
        now = time.perf_counter()
        keep: List[GenerationRequest] = []
        for request in self._pending:
            waited = now - getattr(request, "_submit_ts", now)
            if waited < timeout:
                keep.append(request)
            else:
                self._shed(request, waited)
        self._pending = keep

    def _shed(self, request: GenerationRequest, waited: float) -> None:
        shed = self.stats["requests_shed"]
        shed["queue_timeout"] = shed.get("queue_timeout", 0) + 1
        self.stats["requests"] += 1
        # Retry-After ≈ when a slot plausibly frees: the backlog this
        # request would wait behind × the EWMA step time
        step_s = self._step_ewma if self._step_ewma else 0.05
        retry_after = max(1.0, len(self._pending) * step_s)
        flight.record("request_shed", reason="queue_timeout", waited_s=round(waited, 3),
                      queue_depth=len(self._pending), retry_after_s=round(retry_after, 3))
        fail_request_future(request, api_errors.QueueTimeoutError(
            f"request waited {waited:.2f}s in the admission queue (queue timeout "
            f"{self.queue_timeout_s}s); shed before admission — retry later",
            retry_after_s=retry_after))

    def _check_condemned(self) -> None:
        """Called before any launch: a thread the supervisor condemned
        (``request_restart``) while it slept in a wedged step or worked
        must launch nothing on the retired engine's released state. A
        plain :meth:`stop` condemns nothing."""
        if self._crashed is not None:
            raise _Condemned()

    # a partial prefix match must cover at least this many tokens to be
    # worth a warm admission; a full extension of the pinned history always
    # qualifies
    WARM_MIN_PREFIX = 16
    # warm-first fairness: after this many jump-aheads the queue head is
    # admitted regardless, so warm traffic cannot starve it
    MAX_HEAD_SKIPS = 4
    # evicted sessions remembered for the recompute ledger (FIFO)
    MAX_EVICTED_SESSIONS = 512

    def _note_head_skip(self) -> None:
        head = self._pending[0]
        head._skipped = getattr(head, "_skipped", 0) + 1  # type: ignore[attr-defined]

    def _scan_admission(self, exclude: frozenset = frozenset()
                        ) -> Tuple[int, Optional[int], Optional[int]]:
        """The warm-first admission policy every admission path shares:
        the first pending request (at most ``2 × max_slots`` deep) whose
        pinned session slot can serve it warm, unless the queue head has
        been skipped ``MAX_HEAD_SKIPS`` times; else the queue head into a
        free or evictable slot (:meth:`_find_slot`, never one of
        ``exclude``). Returns (position in ``_pending``, slot or None,
        session prefix length or None)."""
        position, index, session_lcp = 0, None, None
        head = self._pending[0]
        if getattr(head, "_skipped", 0) < self.MAX_HEAD_SKIPS:
            for p, queued in enumerate(self._pending[: max(2 * self.max_slots, 8)]):
                warm_index = self._find_warm_slot(queued)
                if warm_index is None:
                    continue
                lcp = self._session_warm(warm_index, queued)
                if lcp is not None:
                    position, index, session_lcp = p, warm_index, lcp
                    break
        if index is None:
            index = self._find_slot(self._pending[position], exclude)
            if index is not None:
                session_lcp = self._session_warm(index, self._pending[position])
        return position, index, session_lcp

    def _find_warm_slot(self, request: GenerationRequest) -> Optional[int]:
        if request.session_id is None:
            return None
        for i, slot in enumerate(self.slots):
            if not slot.active and slot.session_id == request.session_id and slot.history is not None:
                return i
        return None

    def _find_slot(self, request: GenerationRequest, exclude: frozenset = frozenset()
                   ) -> Optional[int]:
        """The request's pinned slot; else a free unpinned slot not in
        ``exclude`` (this round's copy sources, whose rows must stay until
        the copies are enqueued); else the least recently used pinned
        slot not in ``exclude``, evicted."""
        warm = self._find_warm_slot(request)
        if warm is not None:
            return warm
        for i, slot in enumerate(self.slots):
            if not slot.active and slot.session_id is None and i not in exclude:
                return i
        victim: Optional[int] = None
        for i, slot in enumerate(self.slots):
            if not slot.active and i not in exclude and (
                victim is None or slot.last_used < self.slots[victim].last_used
            ):
                victim = i
        return victim

    def _session_warm(self, index: int, request: GenerationRequest) -> Optional[int]:
        """The reusable prefix of a warm admission onto the request's
        pinned slot, or None (cold): the longest common prefix of the
        prompt and the pinned history, at least ``WARM_MIN_PREFIX`` tokens
        unless the prompt extends the whole history, and never the whole
        prompt (its last token is prefilled again for fresh logits)."""
        slot = self.slots[index]
        prompt = request.prompt_tokens
        if not (request.session_id is not None and slot.session_id == request.session_id
                and slot.history):
            return None
        lcp = self._lcp(prompt, slot.history)
        if lcp == len(prompt):
            lcp = len(prompt) - 1
        if lcp <= 0:
            return None
        if lcp != len(slot.history) and lcp < self.WARM_MIN_PREFIX:
            return None
        return lcp

    @staticmethod
    def _lcp(a: List[int], b: List[int]) -> int:
        """Longest common prefix of two token lists (64-token slices first)."""
        limit = min(len(a), len(b))
        lcp = 0
        while lcp < limit:
            n = min(64, limit - lcp)
            if a[lcp:lcp + n] == b[lcp:lcp + n]:
                lcp += n
                continue
            while lcp < limit and a[lcp] == b[lcp]:
                lcp += 1
            break
        return lcp

    def _find_prefix_source(self, request: GenerationRequest, cold_reserved: frozenset,
                            warm_reserved: frozenset) -> Optional[Tuple[int, int, bool]]:
        """The dense slot whose rows share the longest prefix with a
        sessionless cold request: (slot, rows, in_round) or None. Sources:
        this round's cold reservations (``in_round``: their prefill is
        enqueued before the copies; the n > 1 choices case), and slots
        with a history and no reservation of this round (decoding,
        prefilling, pinned or finished), whose copyable rows stop at their
        length. This round's warm reservations are skipped: their rows are
        about to change."""
        prompt = request.prompt_tokens
        full = len(prompt) - 1  # the last token is always prefilled again
        best: Optional[Tuple[int, int, bool]] = None
        for i, slot in enumerate(self.slots):
            if i in cold_reserved:
                history = slot.request.prompt_tokens if slot.request else None
                in_round = True
            elif i in warm_reserved:
                continue
            else:
                history = slot.history
                in_round = False
                if slot.length < self.WARM_MIN_PREFIX:
                    continue
            if not history:
                continue
            lcp = self._lcp(prompt, history)
            if not in_round:
                # a live slot's newest history token has no row yet
                lcp = min(lcp, slot.length)
            if lcp == len(prompt):
                lcp = len(prompt) - 1
            if lcp < self.WARM_MIN_PREFIX:
                continue
            if best is None or lcp > best[1]:
                best = (i, lcp, in_round)
                if lcp >= full:
                    break
        return best

    def _note_eviction(self, session_id: str, cached_tokens: int) -> None:
        """Remember a pinned session whose warm rows were evicted, so that
        its follow-up's re-prefill is booked as recompute (bounded FIFO)."""
        if cached_tokens <= 0:
            return
        evicted = self._evicted_sessions
        evicted.pop(session_id, None)
        while len(evicted) >= self.MAX_EVICTED_SESSIONS:
            evicted.pop(next(iter(evicted)))
        evicted[session_id] = cached_tokens

    def _waste(self, reason: str, tokens: int) -> None:
        if tokens > 0:
            wasted = self.stats["tokens_wasted"]
            wasted[reason] = wasted.get(reason, 0) + tokens

    def _dispatch_prefix_copy(self, src: int, dst: int, length: int) -> None:
        """Copy dense cache rows [0, length) of slot ``src`` into ``dst`` in
        bucket-sized windows, each one replay of ``Variant("copy",
        bucket)``. A window may copy past ``length``: those rows are
        overwritten by the suffix prefill or lie past the slot's length,
        and decode writes a row before it reads it."""
        self._check_condemned()
        largest = self.prefill_buckets[-1]
        position = 0
        while position < length:
            remaining = length - position
            bucket = largest if remaining > largest else _bucket(remaining, self.prefill_buckets)
            self._run_step(Variant("copy", bucket), dict(
                src=np.asarray([src], dtype=np.int64), dst=np.asarray([dst], dtype=np.int64),
                offset=np.asarray([position], dtype=np.int64)))
            position += bucket
        self.stats["prefix_hits"] += 1
        self.stats["prefix_tokens_reused"] += length

    def _dispatch_block_copy(self, src: int, dst: int) -> None:
        """Copy pool block ``src`` into ``dst`` across every layer and leaf
        (copy-on-write), one replay of ``Variant("block_copy")``."""
        self._check_condemned()
        self._run_step(Variant("block_copy", 0), dict(
            src=np.asarray([src], dtype=np.int64), dst=np.asarray([dst], dtype=np.int64)))
        self.kv_manager.stats["cow_copies"] += 1

    # ------------------------------------------------------------------ #
    # paged-KV handoff (prefill/decode disaggregation, fleet/handoff.py)
    # ------------------------------------------------------------------ #
    def _block_index(self, blocks: List[int]) -> torch.Tensor:
        """Block ids as a device index, uploaded without waiting for the
        stream (a blocking upload would wait for a chunk in flight)."""
        index = torch.tensor(blocks, dtype=torch.long)
        if self.device.type == "cuda":
            index = index.pin_memory().to(self.device, non_blocking=True)
        return index

    def _host_buffer(self, like: torch.Tensor) -> torch.Tensor:
        """A host tensor shaped as ``like``, pinned when the pool is on
        the card (a non-blocking copy into it then runs on the copy
        engine, ordered on the stream that enqueued it)."""
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=self.device.type == "cuda")

    def _export_handoff(self, slot: _Slot, history: List[int]) -> Optional[Dict[str, Any]]:
        """The finishing slot's published chain for the topic fabric: the
        full blocks of ``history`` (the rows in the cache; exactly what
        :meth:`PagedKVManager.publish` made matchable; the final sampled
        token is never in the cache, so it rides the manifest's replay).
        Returns the payload ``fleet.handoff.handoff_records`` chunks, or
        None when no full block exists yet.

        The rows are gathered on the card and copied into pinned host
        memory behind everything the stream has queued, so the host waits
        for a pipelined chunk in flight too. That is correct: the rows
        lie in full blocks below the slot's length, and a chunk in flight
        writes only at its rows' lengths or above."""
        full = len(history) // self.block_size
        if full <= 0 or not slot.blocks:
            return None
        blocks = slot.blocks[:full]
        # under tp the followers enter the gather of their kv heads
        self._publish("handoff_export", {}, [np.asarray(blocks, dtype=np.int32)])
        arrays = self._gather_blocks(blocks)
        payload = {
            "tokens": list(history[: full * self.block_size]),
            "arrays": arrays,
            "block_size": self.block_size,
            "kv_quant": bool(self.kv_quant),
            # stamped after the rows reached the host: transit measures
            # the fabric, not this replica's copy
            "export_ts": time.time(),
        }
        nbytes = payload_nbytes(payload)
        self.stats["handoff_exports"] += 1
        self.stats["handoff_export_bytes"] += nbytes
        flight.record("kv_handoff_export", tokens=full * self.block_size, blocks=full, nbytes=nbytes)
        return payload

    def _gather_blocks(self, blocks: List[int]) -> Dict[str, torch.Tensor]:
        """The pool rows of ``blocks``, every layer and leaf, in host
        memory (``leaf -> [layers, len(blocks), block_size, kv_heads(,
        head_dim)]``). Under tp each rank holds its kv heads: the ranks'
        rows are gathered over the group along the kv-head axis in rank
        order (every rank enters the gather; the followers at the
        ``handoff_export`` record), so rank 0's are laid out as one card's
        with every kv head."""
        index = self._block_index(blocks)
        arrays: Dict[str, torch.Tensor] = {}
        for leaf, value in self.cache.items():
            rows = value.index_select(1, index)
            if self.group is not None:
                rows = collectives.all_gather_cat(self.group, rows, dim=KV_HEAD_AXIS)
            arrays[leaf] = self._host_buffer(rows)
            arrays[leaf].copy_(rows, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return arrays

    def _whole_shape(self, leaf: str, blocks: int) -> Tuple[int, ...]:
        """Pool leaf ``leaf``'s rows of ``blocks`` blocks with every kv
        head: a handoff payload's shape, which a tp rank's pool holds a
        1/tp part of."""
        shape = list(self.cache[leaf].shape)
        shape[1] = blocks
        shape[KV_HEAD_AXIS] *= self.tp
        return tuple(shape)

    def _write_blocks(self, blocks: List[int], rows: Optional[Dict[str, torch.Tensor]]) -> None:
        """Write ``rows`` (leaf -> :meth:`_whole_shape` rows, on rank 0;
        None on a follower, at the ``handoff_import`` record) into pool
        ``blocks``, IN PLACE on the engine's stream. Under tp rank 0
        broadcasts them over the group and each rank keeps its kv heads."""
        index = self._block_index(blocks)
        for leaf, value in self.cache.items():
            part = rows[leaf].to(value.dtype) if rows is not None else None
            if self.group is not None:
                part = collectives.own_part(self.group, collectives.broadcast(
                    self.group, part, self._whole_shape(leaf, len(blocks)), value.dtype,
                    self.device), dim=KV_HEAD_AXIS)
            value.index_copy_(1, index, part.to(self.device, non_blocking=True))

    def _import_pending_handoffs(self) -> None:
        """Import every pending request's handoff payload before the
        admission scan, on the engine thread (the manager's owner): the
        written chain publishes under the normal ``(parent_block, chunk)``
        keys, so the request's own admission, and any other admission
        sharing the prefix, hits the prefix cache instead of prefilling.
        A failed import bills ``handoff_aborted`` and the request
        prefills cold, never a caller-visible error. An engine with no
        prefix cache to import into (the dense layout, or ``prefix_cache``
        off) leaves the payload alone and bills nothing, as the JAX
        engine: the request prefills cold. A successful import's window
        is the journey's ``handoff_import`` stage, and its admission's
        class ``handoff-import``."""
        if not self.paged or not self.prefix_cache:
            return
        for request in self._pending:
            if request.kv_import is not None:
                payload, request.kv_import = request.kv_import, None
                started = time.time()
                if self._import_handoff(payload, trace_id=request.trace_id or ""):
                    request._jt_import = (started, time.time())  # type: ignore[attr-defined]
                    request._jt_admit_class = "handoff-import"  # type: ignore[attr-defined]

    def _import_handoff(self, payload: Dict[str, Any], trace_id: str = "") -> bool:
        manager = self.kv_manager
        tokens = list(payload.get("tokens") or [])
        arrays = payload.get("arrays") or {}
        size = int(payload.get("block_size", 0) or 0)
        full = len(tokens) // size if size else 0

        def aborted(reason: str) -> bool:
            self._waste("handoff_aborted", len(tokens))
            flight.record("kv_handoff_import_aborted", reason=reason, tokens=len(tokens),
                          trace_id=trace_id)
            return False

        if self._mirror_crosses_hosts():
            # as the JAX engine under its multi-host mirror: refused rather
            # than forking the ranks' pools
            return aborted("mirror")
        if (
            full <= 0
            or size != self.block_size
            or bool(payload.get("kv_quant", False)) != bool(self.kv_quant)
            or set(arrays) != set(self.cache)
        ):
            return aborted("layout_mismatch")
        for leaf in self.cache:
            if tuple(arrays[leaf].shape) != self._whole_shape(leaf, full):
                return aborted("shape_mismatch")
        reserved = manager.import_session(tokens)
        if reserved is None:
            return aborted("pool_exhausted")
        chain, fresh = reserved
        try:
            if fresh:
                # only the blocks the pool does not already hold are
                # written; a resident prefix keeps its rows (the same
                # content, bit for bit)
                start = len(chain)
                self._publish("handoff_import", {}, [np.asarray(fresh, dtype=np.int32)])
                self._write_blocks(fresh, {leaf: as_tensor(arrays[leaf])[:, start:full].contiguous()
                                           for leaf in self.cache})
        except Exception:  # noqa: BLE001 — unwind before any id recycles
            manager.abort_import(chain + fresh)
            raise
        manager.commit_import(tokens, chain + fresh)
        nbytes = payload.get("nbytes")
        if not isinstance(nbytes, (int, float)):
            nbytes = payload_nbytes(payload)
        self.stats["handoff_imports"] += 1
        self.stats["handoff_import_bytes"] += int(nbytes)
        self.stats["handoff_import_tokens"] += len(tokens)
        flight.record("kv_handoff_import", tokens=len(tokens), blocks_written=len(fresh),
                      blocks_local=len(chain), nbytes=int(nbytes), trace_id=trace_id)
        return True

    # ------------------------------------------------------------------ #
    # host-DRAM KV tier: demotion and promotion
    # ------------------------------------------------------------------ #
    def _demote_block_data(self, block: int) -> Optional[Tuple[Dict[str, torch.Tensor], int]]:
        """The manager's data-plane hook while it demotes one victim block
        (inside the eviction pass of ``allocate``, on the engine thread):
        copy the block's pool rows, every layer and leaf, into pinned host
        memory without waiting. The copy is enqueued on the engine's
        stream before the block id returns to the free list, so it runs
        before any new owner's write to the block, and the promotion's H2D
        copy of the same buffer queues behind it; nothing on the host
        reads the buffer's values (the pinned allocator does not reuse a
        freed buffer before its copy has finished). Returns ``(leaf ->
        [layers, block_size, kv_heads(, head_dim)], nbytes)``, or None
        under a mirror across hosts (as the JAX engine's): nothing is
        demoted. Under tp the rows are this rank's kv heads, and the
        followers copy theirs out at the ``host_demote`` record the arena's
        acceptance publishes (:meth:`_note_demoted`)."""
        if self._mirror_crosses_hosts():
            return None
        data = self._copy_block_out(block)
        nbytes = sum(rows.nbytes for rows in data.values())
        self.stats["host_demotions"] += 1
        self.stats["host_demote_bytes"] += nbytes
        flight.record("kv_host_demote", block=block, nbytes=nbytes)
        return data, nbytes

    def _copy_block_out(self, block: int) -> Dict[str, torch.Tensor]:
        """Pool block ``block``'s rows, every layer and leaf, into (pinned)
        host memory without waiting."""
        data: Dict[str, torch.Tensor] = {}
        for leaf, value in self.cache.items():
            rows = value[:, block]
            data[leaf] = self._host_buffer(rows)
            data[leaf].copy_(rows, non_blocking=True)
        return data

    def _copy_blocks_in(self, blocks: List[int], entries: List[Dict[str, torch.Tensor]]) -> None:
        """Host rows ``entries`` (one :meth:`_copy_block_out` each) into
        pool ``blocks``, IN PLACE on the engine's stream."""
        index = self._block_index(blocks)
        for leaf, value in self.cache.items():
            rows = torch.stack([entry[leaf].to(self.device, non_blocking=True) for entry in entries],
                               dim=1)
            value.index_copy_(1, index, rows)

    def _note_demoted(self, block: int, digest: str) -> None:
        """The arena took ``block``'s rows under ``digest``: the followers
        copy their kv heads of it into their tiers under the same key,
        before any record that reuses the block."""
        self._publish("host_demote", {"block": int(block), "digest": digest}, [])

    def _note_host_evicted(self, digest: str) -> None:
        """The arena's LRU dropped ``digest``: the followers drop theirs,
        so that each tier holds what rank 0's holds."""
        self._publish("host_evict", {"digest": digest}, [])

    def _host_probe(self, prompt: List[int], match: Optional[Tuple[List[int], int]]
                    ) -> List[HostKVEntry]:
        """The host tier's continuation of the HBM prefix match: the
        demoted entries extending ``match``'s chain, cut at the first entry
        without rows (an accounting-only entry cannot be promoted)."""
        if not self.prefix_cache or self.kv_host_arena is None:
            return []
        start = len(match[0]) if match is not None else 0
        out: List[HostKVEntry] = []
        for entry in self.kv_manager.host_match(prompt, start):
            if entry.data is None:
                break
            out.append(entry)
        return out

    def _promote_host_chain(self, prompt: List[int], matched: List[int], matched_tokens: int,
                            entries: List[HostKVEntry], fresh: List[int]) -> int:
        """Scatter ``entries`` (the host tier's continuation of the matched
        chain) into the first ``len(entries)`` fresh blocks, then publish
        the promoted chain. The H2D copies and the scatter are enqueued on
        the engine's stream here, so any reader (this round's suffix
        prefill, a later mixed window) runs after them. Any failure aborts
        before anything publishes (``host_promote_aborts``): the fresh
        blocks stay private and the admission prefills cold. Returns the
        promoted blocks (0 = aborted)."""
        count = len(entries)
        target = fresh[:count]
        size = self.block_size
        try:
            if faults.fire("host_promote_torn") is not None:
                raise RuntimeError("chaos: torn host promotion")
            for leaf, expect in self.cache.items():
                for entry in entries:
                    if tuple(entry.data[leaf].shape) != (expect.shape[0], *expect.shape[2:]):
                        raise ValueError(f"host entry of shape {tuple(entry.data[leaf].shape)} "
                                         f"does not fit pool leaf {leaf}")
            self._publish("host_promote", {"digests": [entry.digest for entry in entries]},
                          [np.asarray(target, dtype=np.int32)])
            self._copy_blocks_in(target, [entry.data for entry in entries])
        except Exception:  # noqa: BLE001 — abort before anything publishes
            self.stats["host_promote_aborts"] += 1
            flight.record("kv_host_promote_aborted", blocks=count, tokens=count * size)
            return 0
        self.kv_manager.publish(list(prompt[: matched_tokens + count * size]), matched + target)
        nbytes = sum(entry.nbytes for entry in entries)
        self.stats["host_promotions"] += count
        self.stats["host_promote_bytes"] += nbytes
        self.stats["kv_host_hit_tokens"] += count * size
        self.kv_host_arena.note_promoted(count)
        flight.record("kv_host_promote", blocks=count, tokens=count * size, nbytes=nbytes)
        return count

    def _admit_paged(self) -> None:
        """Paged admission. Warm-session follow-ups first
        (:meth:`_scan_admission`); otherwise block-granular matching
        against the prefix cache: shared blocks are referenced through the
        table, never copied, so a shared system or RAG prefix survives any
        slot turnover. Every request reserves its worst case up front;
        when the pool (after LRU eviction) cannot cover it, the request
        stays pending until running requests release blocks.

        A round dispatches cold batch → long prefills → warm suffixes, so
        a suffix admitted onto blocks published this round reads rows
        whose writes already ran."""
        largest = self.prefill_buckets[-1]
        while self._pending:
            cold: List[Tuple[int, GenerationRequest]] = []
            cold_bucket: Optional[int] = None
            # suffix bucket -> [(slot, request, resume offset)]
            warm: Dict[int, List[Tuple[int, GenerationRequest, int]]] = {}
            long_entries: List[Tuple[int, GenerationRequest, int]] = []
            progressed = False
            while self._pending:
                position, index, session_lcp = self._scan_admission()
                if index is None:
                    break
                request = self._pending[position]
                # probe the resume offset without committing, so the
                # cold-bucket grouping can end the round before any block
                # moves (match() only touches LRU ticks); the probe's match
                # is handed to _paged_reserve so the chain walk runs once
                prompt_len = len(request.prompt_tokens)
                probe_match = None
                host_probe: List[HostKVEntry] = []
                if session_lcp is not None:
                    probe = session_lcp
                elif self.prefix_cache:
                    probe_match = self.kv_manager.match(request.prompt_tokens)
                    # the host tier continues the HBM match: demoted
                    # entries extend the probe as resident blocks would
                    # (the reservation promotes them)
                    host_probe = self._host_probe(request.prompt_tokens, probe_match)
                    probe = probe_match[1] + len(host_probe) * self.block_size
                    while probe >= prompt_len:
                        if host_probe:
                            host_probe.pop()
                        probe -= self.block_size
                else:
                    probe = 0
                suffix = prompt_len - probe
                needs_long = suffix > largest or (
                    probe > 0
                    and probe + _bucket(suffix, self.prefill_buckets) > self.max_seq_len
                )
                if probe == 0 and not needs_long:
                    bucket = _bucket(prompt_len, self.prefill_buckets)
                    if cold_bucket is None:
                        cold_bucket = bucket
                    elif bucket != cold_bucket:
                        break  # different bucket: next outer round
                resume = self._paged_reserve(index, request, session_lcp, probe_match,
                                             host_entries=host_probe)
                if resume is None:
                    # pool exhausted even after eviction: every block is
                    # referenced by running work — wait for releases
                    break
                if position > 0:
                    self._note_head_skip()
                self._pending.pop(position)
                self.slots[index].request = request  # reserve the slot
                if session_lcp is not None:
                    self.stats["session_hits"] += 1
                if resume < probe or needs_long:
                    # (resume < probe: a torn promotion fell back toward
                    # cold, and the probe's cold/warm grouping no longer
                    # holds; the long path takes any resume offset)
                    long_entries.append((index, request, resume))
                elif resume == 0:
                    cold.append((index, request))
                    if len(cold) >= self.max_slots:
                        break
                else:
                    warm.setdefault(
                        _bucket(prompt_len - resume, self.prefill_buckets), []
                    ).append((index, request, resume))
            if cold:
                self._prefill_batch(cold, cold_bucket)
                progressed = True
            for index, request, resume in long_entries:
                self._prefill_long(index, request, resume)
                progressed = True
            for suffix_bucket, batch in warm.items():
                self._prefill_warm_batch(batch, suffix_bucket)
                progressed = True
            if not progressed:
                return

    def _admit_mixed(self) -> None:
        """Mixed-mode admission: a request claims a slot and its
        worst-case block reservation as on the split paged path (warm
        sessions first, the same :meth:`_scan_admission`), but no prefill
        call runs here. The slot parks as admitting (its ``prefill_pos``
        watermark) and successive mixed steps carry windows of its prompt
        beside the decoding rows (:meth:`_dispatch_mixed`). Cold prompts
        are not published at admission: their blocks fill over several
        steps, and a duplicate matching the chain early would attend over
        rows not yet written. They publish at finish, like partially
        matched prompts."""
        while self._pending:
            position, index, session_lcp = self._scan_admission()
            if index is None:
                return
            request = self._pending[position]
            match = None
            host_probe: List[HostKVEntry] = []
            if session_lcp is None and self.prefix_cache:
                match = self.kv_manager.match(request.prompt_tokens)
                host_probe = self._host_probe(request.prompt_tokens, match)
            resume = self._paged_reserve(index, request, session_lcp, match, publish_cold=False,
                                         host_entries=host_probe)
            if resume is None:
                # pool exhausted even after eviction: wait for releases
                return
            if position > 0:
                self._note_head_skip()
            self._pending.pop(position)
            if session_lcp is not None:
                self.stats["session_hits"] += 1
            self._assign_slot(index, request, reused=resume)
            slot = self.slots[index]
            slot.prefilling = True
            slot.prefill_pos = resume
            slot.prefill_reused = resume
            self._admit_seq += 1
            slot.prefill_seq = self._admit_seq
            slot.prefill_t0 = time.perf_counter()

    def _paged_reserve(
        self,
        index: int,
        request: GenerationRequest,
        session_lcp: Optional[int],
        match: Optional[Tuple[List[int], int]],
        publish_cold: bool = True,
        host_entries: Optional[List[HostKVEntry]] = None,
    ) -> Optional[int]:
        """Commit pool blocks for a request before it is admitted. Returns
        the resume offset (prompt tokens already in the pool for this
        slot), or None when the pool cannot cover the reservation.

        A session follow-up (``session_lcp``) keeps its slot's blocks: a
        boundary block it diverges inside is copied to a private block
        first when it is shared (copy-on-write), shared blocks in the
        region it overwrites are swapped for fresh ones (a whole overwrite
        needs no copy), and the reservation grows or shrinks to its worst
        case: a published chain is never written after publication.
        Otherwise the slot's old blocks (an evicted session) are released
        and the request references the prefix chain ``match`` found (None
        with the prefix cache off), plus fresh blocks up to its worst
        case. ``host_entries`` (the admission's :meth:`_host_probe`)
        continue that chain from the host tier: they are promoted into the
        first fresh blocks. ``publish_cold``: publish a fully cold prompt's
        blocks now (split mode; mixed mode publishes at finish)."""
        slot = self.slots[index]
        manager = self.kv_manager
        size = self.block_size
        prompt = request.prompt_tokens
        need_tokens = min(len(prompt) + request.sampling.max_new_tokens, self.max_seq_len)
        need_blocks = -(-need_tokens // size)
        if session_lcp is not None and slot.blocks:
            blocks = list(slot.blocks)
            keep_full, partial = divmod(session_lcp, size)
            replace: List[int] = []
            cow: Optional[int] = None
            if partial and keep_full < len(blocks) and manager.is_shared(blocks[keep_full]):
                cow = keep_full
                replace.append(keep_full)
            for j in range(keep_full + (1 if partial else 0), min(len(blocks), need_blocks)):
                if manager.is_shared(blocks[j]):
                    replace.append(j)
            fresh = manager.allocate(len(replace) + max(0, need_blocks - len(blocks)))
            if fresh is None:
                return None
            for j, new in zip(replace, fresh):
                if j == cow:
                    self._dispatch_block_copy(blocks[j], new)
                manager.unref(blocks[j])
                blocks[j] = new
            blocks.extend(fresh[len(replace):])
            for extra in blocks[need_blocks:]:
                manager.unref(extra)  # shrink to this request's worst case
            slot.blocks = blocks[:need_blocks]
            resume = session_lcp
        else:
            if slot.blocks:
                # a new owner evicts this slot's pinned session or leftover
                if slot.session_id is not None:
                    self._note_eviction(slot.session_id, slot.length)
                manager.release(slot.blocks)
                slot.blocks = None
                slot.session_id = None
                slot.history = None
                slot.length = 0
            matched: List[int] = []
            matched_tokens = 0
            if self.prefix_cache:
                # the admission probe already walked the chain; nothing can
                # change it between probe and commit
                matched, matched_tokens = (
                    (list(match[0]), match[1]) if match is not None else manager.match(prompt))
            promote = list(host_entries or [])
            # re-prefill at least the last prompt token so fresh logits
            # exist for the first sample. Host entries trim first: they
            # continue the HBM chain, so they are its tail
            total = matched_tokens + size * len(promote)
            while promote and total >= len(prompt):
                promote.pop()
                total -= size
            while matched and matched_tokens >= len(prompt):
                matched.pop()
                matched_tokens -= size
            manager.ref(matched)
            fresh = manager.allocate(need_blocks - len(matched))
            if fresh is None:
                manager.release(matched)
                return None
            promoted = 0
            if promote:
                # the fresh allocation covers every block past the match,
                # so the promotion writes the first len(promote) of them;
                # an abort leaves them private cold blocks
                promoted = self._promote_host_chain(prompt, matched, matched_tokens, promote, fresh)
            slot.blocks = matched + fresh
            if matched_tokens:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_reused"] += matched_tokens
                manager.stats["hit_tokens"] += matched_tokens
            if promoted:
                self.stats["prefix_tokens_reused"] += promoted * size
                # the journey's admission class: the host tier served it
                if getattr(request, "_jt_admit_class", None) is None:
                    request._jt_admit_class = "host-promote"  # type: ignore[attr-defined]
            if self.prefix_cache and publish_cold and not matched_tokens and not promoted:
                # publish a fully cold prompt's blocks now so same-round
                # duplicates share them: the cold batch (or long prefill)
                # that writes them dispatches before any warm suffix of
                # this round. Partially matched prompts publish their tail
                # at finish (a promoted chain is published already, and
                # publishing its unwritten tail here would expose it).
                manager.publish(prompt, slot.blocks)
            resume = matched_tokens + promoted * size
        table = self._block_tables[index]
        table[:] = 0
        table[: len(slot.blocks)] = slot.blocks
        return resume

    def _assign_slot(self, index: int, request: GenerationRequest, reused: int = 0) -> None:
        """Reset a slot's bookkeeping for a newly admitted request;
        ``reused``: cache tokens this admission did not prefill (a
        session, a prefix copy or a paged prefix hit). Every admission
        path passes here: it stamps the journey's queue → prefill boundary
        and the admission class (unless a handoff import or a host
        promotion classed it first)."""
        request._admit_wall = time.time()  # type: ignore[attr-defined]
        if getattr(request, "_jt_admit_class", None) is None:
            request._jt_admit_class = "hbm-hit" if reused > 0 else "cold"  # type: ignore[attr-defined]
        slot = self.slots[index]
        if slot.session_id is not None and slot.session_id != request.session_id and slot.history:
            # a new owner evicts this pinned session's warm rows
            self._note_eviction(slot.session_id, slot.length)
        if request.session_id is not None:
            cached = self._evicted_sessions.pop(request.session_id, None)
            if cached:
                self._waste("evicted_recompute", min(cached, len(request.prompt_tokens)) - reused)
        slot.request = request
        slot.generated = []
        slot.logprobs = []
        slot.tops = [] if self.logprobs_topk else None
        slot.history = list(request.prompt_tokens)
        slot.session_id = None
        slot.length = len(request.prompt_tokens)
        slot.last_used = time.monotonic()
        slot.epoch += 1
        slot.prefill_pos = None  # mixed admission parks it again after this
        slot.prefill_reused = 0

    def _request_seed(self, request: GenerationRequest) -> int:
        """The request's sampling seed: explicit (OpenAI `seed`) or a
        fresh auto-seed, fixed for the request's whole lifetime."""
        if request.sampling.seed is not None:
            return request.sampling.seed & 0xFFFFFFFF
        assigned = getattr(request, "_auto_seed", None)
        if assigned is None:
            self._seed_sequence += 1
            assigned = (self.base_seed * 1_000_003 + self._seed_sequence) & 0xFFFFFFFF
            request._auto_seed = assigned  # type: ignore[attr-defined]
        return assigned

    def _bias_rows(self, requests: List[Optional[GenerationRequest]]):
        """[len(requests), MAX_LOGIT_BIAS] (ids, values); rows for
        None/bias-less requests are all (0, 0.0) — a +0 on token 0."""
        k = self.MAX_LOGIT_BIAS
        ids = np.zeros((len(requests), k), dtype=np.int64)
        values = np.zeros((len(requests), k), dtype=np.float32)
        vocab = self.config.vocab_size
        for row, request in enumerate(requests):
            bias = request.sampling.logit_bias if request else None
            if not bias:
                continue
            valid = [
                (int(token), float(value)) for token, value in bias.items()
                if 0 <= int(token) < vocab
            ]
            for column, (token, value) in enumerate(valid[:k]):
                ids[row, column] = token
                values[row, column] = value
        return ids, values

    def _to_host(self, *tensors: torch.Tensor) -> Tuple[List[torch.Tensor], Any]:
        """Start copying device tensors to the host: on the card into
        pinned buffers without blocking, behind an event that
        :meth:`_from_host` waits on, so the copies finish with the work
        queued before them and never wait for work queued after. Either
        way the copy is taken now: a step's outputs are the runner's
        static buffers, which the next step of its variant overwrites."""
        if self.device.type != "cuda":
            return [tensor.clone() for tensor in tensors], None
        buffers = []
        for tensor in tensors:
            buffer = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            buffer.copy_(tensor, non_blocking=True)
            buffers.append(buffer)
        event = torch.cuda.Event()
        event.record()
        return buffers, event

    @staticmethod
    def _from_host(copies: Tuple[List[torch.Tensor], Any]) -> List[np.ndarray]:
        buffers, event = copies
        if event is not None:
            event.synchronize()
        return [buffer.numpy() for buffer in buffers]

    def _sampling_arrays(
        self, requests: List[Optional[GenerationRequest]]
    ) -> Tuple[Dict[str, np.ndarray], str]:
        """Per-row sampling arrays by step input name (temperature, top-k,
        top-p, seed, bias ids and values, presence and frequency
        penalties [S, 1]; None rows are inactive), and the batch's
        host-known sampling tier (:data:`graphs.TIERS`)."""
        rows = [r.sampling if r is not None else SamplingParams() for r in requests]
        temperature = np.asarray([s.temperature for s in rows], dtype=np.float32)
        top_k = np.asarray([s.top_k for s in rows], dtype=np.int64)
        top_p = np.asarray([s.top_p for s in rows], dtype=np.float32)
        bias_ids, bias_vals = self._bias_rows(requests)
        arrays = {
            "temperature": temperature,
            "top_k": top_k,
            "top_p": top_p,
            "seeds": np.asarray(
                [self._request_seed(r) if r is not None else 0 for r in requests], dtype=np.int64),
            "bias_ids": bias_ids,
            "bias_vals": bias_vals,
            "presence": np.asarray([[s.presence_penalty] for s in rows], dtype=np.float32),
            "frequency": np.asarray([[s.frequency_penalty] for s in rows], dtype=np.float32),
        }
        tier = sampling_tier(
            stochastic=bool((temperature > 0).any()),
            truncated=bool((top_k > 0).any() or (top_p > 0).any()),
        )
        return arrays, tier

    def _sample(self, logits: torch.Tensor, x: Dict[str, torch.Tensor], positions: torch.Tensor,
                tier: str, raw: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Bias, then sample ``logits`` (penalized where the caller
        penalized them) with the sampling tensors ``x`` at keys from (seed,
        ``positions``); returns the tokens and their logprobs under the
        RAW untruncated distribution ``raw`` (default ``logits``)."""
        adjusted = logits.scatter_add(1, x["bias_ids"], x["bias_vals"])
        key = prng.sampling_keys(x["seeds"], positions)
        stochastic, truncated = TIERS[tier]
        sampled = sampling.sample(adjusted, x["temperature"], x["top_k"], key, x["top_p"],
                                  stochastic=stochastic, truncated=truncated)
        return sampled, sampling.token_logprob(logits if raw is None else raw, sampled)

    def _tops(self, logits: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A sampling body's top-K outputs over its raw ``logits`` [...,
        V]: ``top_ids`` int32 and ``top_lps`` f32 [..., K]; none with K 0."""
        if not self.logprobs_topk:
            return {}
        ids, lps = sampling.top_logprobs(logits, self.logprobs_topk)
        return {"top_ids": ids, "top_lps": lps}

    @staticmethod
    def _stack_tops(steps: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        """A chunk's per-step top-K outputs stacked on the step axis (1)."""
        if not steps or not steps[0]:
            return {}
        return {name: torch.stack([step[name] for step in steps], dim=1) for name in steps[0]}

    def _host_tops(self, outputs: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """The top-K outputs that ride a step's copy to the host."""
        return [outputs["top_ids"], outputs["top_lps"]] if self.logprobs_topk else []

    @staticmethod
    def _top(tops: List[np.ndarray], *index) -> Optional[Tuple[List[int], List[float]]]:
        """One token's (ids, logprobs) from the host copies, or None."""
        if not tops:
            return None
        return tops[0][index].tolist(), tops[1][index].tolist()

    def _run_step(self, key: Variant, inputs: Dict[str, Any], chained: bool = False):
        """Every dispatch of a step: :meth:`StepRunner.run`, published to
        the mirror first when one is set. A record carries the variant and
        its host arrays by name; a device operand is the follower's own (a
        first-token sampling's logits). A ``chained`` step (a decode or
        spec chunk, a mixed step off the carry) publishes ``<kind>_chained``
        with only its host arrays: its device operands are the carry's,
        which the follower takes from its own previous step of that kind
        (``serving/mirror.py``, ``CHAINED``). The sampled tokens feed the
        mirror's digest."""
        mirror = self.mirror
        if mirror is not None:
            # a thread the supervisor condemned publishes nothing
            self._check_condemned()
            self._check_mirror_layout()
            names = sorted(name for name, value in inputs.items() if isinstance(value, np.ndarray))
            if chained:
                meta: Dict[str, Any] = {"size": key.size, "tier": key.tier}
                if names:
                    meta["names"] = names
                mirror.publish(f"{key.kind}_chained", meta, [inputs[name] for name in names])
            else:
                carried = set(inputs) - set(names)
                if carried - {"logits"} or (carried and key.kind != "first_token"):
                    raise RuntimeError(f"step {key} carries device operands {sorted(carried)} "
                                       "no mirror record ships")
                mirror.publish(key.kind, record_meta(key, names), [inputs[name] for name in names])
        staged, outputs = self.steps.run(key, inputs)
        if mirror is not None and key.kind in SAMPLED:
            mirror.digest.update(outputs[SAMPLED[key.kind]])
        return staged, outputs

    def _check_mirror_layout(self) -> None:
        """What the followers' replay does not take across hosts (the JAX
        serve's check): speculative decoding, whose steps the JAX engine's
        multi-host mirror has no record for. Fails loudly instead of
        letting the ranks diverge. On one host every step replays."""
        if self.spec and self._mirror_crosses_hosts():
            raise NotImplementedError(
                "the multi-host dispatch mirror does not support spec_decode")

    def _count_dispatch(self, name: str, calls: int = 1) -> None:
        dispatches = self.stats["model_dispatches"]
        dispatches[name] = dispatches.get(name, 0) + calls

    def _prefill_call(self, kind: str, tokens: np.ndarray, lengths: np.ndarray,
                      slot_ids: np.ndarray, offsets: Optional[np.ndarray] = None
                      ) -> torch.Tensor:
        """Stage and run one prefill model call (``kind`` "prefill", cold,
        or "prefill_offset") on either layout through the step runner;
        host arrays in. Returns its logits [B, V] f32: the variant's
        static output, which its next run overwrites."""
        group, bucket = tokens.shape
        inputs = dict(tokens=tokens, lengths=lengths)
        if offsets is not None:
            inputs["offsets"] = offsets
        if self.paged:
            inputs["tables"] = self._block_tables[slot_ids]
        else:
            inputs["slot_ids"] = slot_ids
        _, outputs = self._run_step(Variant(kind, bucket, "", group), inputs)
        # counted here, on the host: a replay runs none of the body
        self._count_dispatch(("paged_" if self.paged else "")
                             + ("prefill" if kind == "prefill" else "prefill_at_offset"))
        return outputs["logits"]

    def _first_token_arrays(
        self, requests: List[Optional[GenerationRequest]]
    ) -> Tuple[Dict[str, np.ndarray], str]:
        """The first-token sampling's per-row arrays and tier: those of
        :meth:`_sampling_arrays` but the penalties, which a first token
        does not take."""
        arrays, tier = self._sampling_arrays(requests)
        del arrays["presence"], arrays["frequency"]
        return arrays, tier

    def _first_token(
        self,
        requests: List[GenerationRequest],
        slot_ids: np.ndarray,
        logits: torch.Tensor,
        positions: np.ndarray,
    ) -> Tuple[List[torch.Tensor], Any]:
        """First-token sampling of a prefill call's ``logits``, replayed
        right behind it on the card: ``positions`` is each row's total
        cache length, so a warm continuation samples exactly like a cold
        run of the same full prompt; the slots' penalty counts reset, then
        count the sampled token. Returns the tokens' and logprobs' copy to
        the host, started now (:meth:`_to_host`): a later group of the
        same variant overwrites the static outputs."""
        arrays, tier = self._first_token_arrays(requests)
        arrays.update(logits=logits, slot_ids=slot_ids, positions=positions)
        _, outputs = self._run_step(Variant("first_token", 0, tier, len(requests)), arrays)
        return self._to_host(outputs["tokens"], outputs["logprobs"], *self._host_tops(outputs))

    def _prefill_batch(
        self, batch: List[Tuple[int, GenerationRequest]], bucket: int
    ) -> None:
        """Cold prefills with the first token sampled right behind the
        call, dispatched without blocking: :meth:`_harvest_prefills`
        emits the tokens. Groups split to power-of-two sizes."""
        faults.check("dispatch_error")
        self._check_condemned()
        for group in _pow2_groups(batch):
            started = time.perf_counter()
            size = len(group)
            tokens = np.zeros((size, bucket), dtype=np.int64)
            lengths = np.zeros((size,), dtype=np.int32)
            slot_ids = np.zeros((size,), dtype=np.int64)
            for row, (index, request) in enumerate(group):
                prompt = request.prompt_tokens
                tokens[row, : len(prompt)] = prompt
                lengths[row] = len(prompt)
                slot_ids[row] = index
                self._assign_slot(index, request)
                self.slots[index].prefilling = True
            logits = self._prefill_call("prefill", tokens, lengths, slot_ids)
            out = self._first_token([request for _, request in group], slot_ids, logits, lengths)
            self.stats["prefill_calls"] += 1
            self.stats["prefill_time"] += time.perf_counter() - started
            self._charge_prefill(started, bucket, [(len(r.prompt_tokens), 0) for _, r in group])
            self._prefill_inflight.append({"group": list(group), "out": out,
                                           "epochs": self._epochs(group)})

    def _prefill_warm_batch(
        self, batch: List[Tuple[int, GenerationRequest, int]], bucket: int
    ) -> None:
        """Admissions onto a cached prefix that share a suffix bucket: one
        prefill-at-offset call writes every suffix. Groups split to
        power-of-two sizes and dispatch without blocking, like cold
        prefill."""
        faults.check("dispatch_error")
        self._check_condemned()
        for group in _pow2_groups(batch):
            started = time.perf_counter()
            size = len(group)
            tokens = np.zeros((size, bucket), dtype=np.int64)
            lengths = np.zeros((size,), dtype=np.int32)
            offsets = np.zeros((size,), dtype=np.int32)
            slot_ids = np.zeros((size,), dtype=np.int64)
            for row, (index, request, reused) in enumerate(group):
                suffix = request.prompt_tokens[reused:]
                tokens[row, : len(suffix)] = suffix
                lengths[row] = len(suffix)
                offsets[row] = reused
                slot_ids[row] = index
                self._assign_slot(index, request, reused)
                self.slots[index].prefilling = True
            logits = self._prefill_call("prefill_offset", tokens, lengths, slot_ids, offsets)
            out = self._first_token(
                [request for _, request, _ in group], slot_ids, logits, offsets + lengths
            )
            self.stats["warm_prefill_calls"] += 1
            self.stats["prefill_time"] += time.perf_counter() - started
            self._charge_prefill(started, bucket,
                                 [(len(r.prompt_tokens) - reused, reused) for _, r, reused in group])
            pairs = [(index, request) for index, request, _ in group]
            self._prefill_inflight.append({
                "group": pairs, "out": out, "epochs": self._epochs(pairs),
                "reused": {index: reused for index, _, reused in group},
            })

    def _prefill_long(self, index: int, request: GenerationRequest, reused: int) -> None:
        """Chunked prefill of a prompt (or suffix past a cached prefix)
        longer than the largest bucket: one group-1 prefill-at-offset call
        per window of :func:`long_prefill_windows`, without blocking. Only
        the final window samples (the JAX windows each sample, but each
        resets the slot's counts first, so only the last one's count
        stays) and records the first token for the harvest."""
        faults.check("dispatch_error")
        self._check_condemned()
        prompt = request.prompt_tokens
        self._assign_slot(index, request, reused)
        self.slots[index].prefilling = True
        started = time.perf_counter()
        slot_ids = np.asarray([index], dtype=np.int64)
        windows = long_prefill_windows(len(prompt), reused, self.prefill_buckets)
        for offset, bucket in windows:
            chunk = prompt[offset:offset + bucket]
            tokens = np.zeros((1, bucket), dtype=np.int64)
            tokens[0, : len(chunk)] = chunk
            lengths = np.asarray([len(chunk)], dtype=np.int32)
            offsets = np.asarray([offset], dtype=np.int32)
            logits = self._prefill_call("prefill_offset", tokens, lengths, slot_ids, offsets)
        out = self._first_token([request], slot_ids, logits, offsets + lengths)
        self.stats["warm_prefill_calls" if reused else "prefill_calls"] += 1
        self.stats["prefill_time"] += time.perf_counter() - started
        # each window at its own offset (the shifted tail re-teaches a few
        # rows: its padding is the overlap)
        total = len(prompt)
        self.stats["prefill_flops"] += sum(
            self.cost_model.prefill_flops(min(bucket, total - offset), offset=offset)
            for offset, bucket in windows)
        self._waste("prefill_padding", sum(bucket for _, bucket in windows) - (total - reused))
        self._prefill_inflight.append({"group": [(index, request)], "out": out,
                                       "epochs": self._epochs([(index, request)]),
                                       "reused": {index: reused}})

    def _charge_prefill(self, started: float, bucket: int, rows: List[Tuple[int, int]]) -> None:
        """Book one batched prefill call's modeled FLOPs (each row's
        ``(new tokens, offset)``), its bucket padding as waste, and its
        ``prefill`` flight record."""
        flops = sum(self.cost_model.prefill_flops(new, offset=offset) for new, offset in rows)
        self.stats["prefill_flops"] += flops
        live = sum(new for new, _ in rows)
        self._waste("prefill_padding", len(rows) * bucket - live)
        flight.record("prefill", bucket=bucket, batch=len(rows),
                      warm=any(offset for _, offset in rows),
                      reused_tokens=int(sum(offset for _, offset in rows)),
                      wall_ms=round((time.perf_counter() - started) * 1e3, 3),
                      queue_depth=len(self._pending), flops=flops)

    def _epochs(self, group: List[Tuple[int, GenerationRequest]]) -> List[int]:
        """The slots' epochs when a prefill record is made: the harvest
        emits only into slots still holding them (a recovery drain bumps
        every live slot's)."""
        return [self.slots[index].epoch for index, _ in group]

    def _harvest_at_loop(self, inflight: Optional[Dict[str, Any]]) -> None:
        """The run loop's harvest point, once the chunk in flight (if any)
        is processed or chained; ``inflight`` is the chunk on the card
        now. With no chunk on the card, a fresh chunk would queue behind
        every prefill in flight anyway: ``join_prefills`` waits for them
        all, so that their slots ride it, and the card idles only for the
        host's turn. Otherwise, as the JAX engine: wait for the oldest
        only when decode has nothing to run anyway."""
        if inflight is None and self.join_prefills:
            self._harvest_prefills(block=True, every=True)
            return
        self._harvest_prefills(
            block=inflight is None and not self._any_ready() and not self._any_admitting()
        )

    def _harvest_prefills(self, block: bool = False, every: bool = False) -> None:
        """Emit the first tokens of finished prefill calls, oldest first
        (the card runs them in order, so a younger one is not done while
        the oldest is not). ``block`` waits for the oldest one, and with
        ``every`` for every one. The wait counts in ``prefill_time``, as
        in the JAX engine."""
        while self._prefill_inflight:
            record = self._prefill_inflight[0]
            event = record["out"][1]
            if not block and event is not None and not event.query():
                return
            waited = time.perf_counter()
            firsts, lps, *tops = self._from_host(record["out"])
            self.stats["prefill_time"] += time.perf_counter() - waited
            self._prefill_inflight.pop(0)
            for row, (index, request) in enumerate(record["group"]):
                if self.slots[index].epoch != record["epochs"][row]:
                    continue  # drained for recovery meanwhile
                self.slots[index].prefilling = False
                if request.replay_tokens:
                    # a resurrected session: fast-forward through its
                    # accepted tokens instead of emitting the prefill's
                    # own sample (_resume_replay)
                    self._resume_replay(index, request, reused=record.get("reused", {}).get(index, 0))
                else:
                    self._emit_token(index, int(firsts[row]), float(lps[row]), self._top(tops, row))
            block = every

    def _resume_replay(self, index: int, request: GenerationRequest, reused: int = 0) -> None:
        """Fast-forward a resurrected session (the JAX engine's
        ``_resume_replay``). The harvested prefill taught the cache
        ``prompt + replay[:-1]``; the slot takes the accepted tokens as
        generated and ``replay[-1]`` as its pending token, whose KV row the
        next decode step writes, so the continuation samples at position
        ``len(prompt) + len(replay)`` with the key the uncrashed run used.
        The prefill's own sample is discarded (its logits saw no penalty
        state, and the caller already holds that position's token), and
        the penalty counts are restored exactly (:meth:`_restore_counts`).
        The replayed tokens are not emitted again: the caller's stream has
        them; they re-enter the result through ``slot.generated``.

        The pending token lives on the host (``slot.history[-1]``, staged
        into the next chunk's static input); the counts row is written IN
        PLACE into the buffer the captured graphs read."""
        slot = self.slots[index]
        replay = list(request.replay_tokens)
        slot.generated = replay
        lps = list(request.replay_logprobs or [])
        slot.logprobs = lps + [0.0] * (len(replay) - len(lps))
        if slot.tops is not None:
            tops = list(request.replay_tops or [])
            slot.tops = tops + [([], [])] * (len(replay) - len(tops))
        slot.history.append(replay[-1])
        self._restore_counts(index, replay)
        # the TTFT anchor of the resumed span: the next emitted token is
        # the first this engine produces for the request
        request._first_token_ts = time.perf_counter()  # type: ignore[attr-defined]
        self._waste("crash_replay", len(request.prompt_tokens) - reused)
        flight.record("session_resume", slot=index, replayed=len(replay), reused_tokens=reused,
                      trace_id=request.trace_id or "")
        if request.cancelled:
            self._finish(index, "cancelled")
        elif (len(replay) >= request.sampling.max_new_tokens
              or slot.length + 1 >= self.max_seq_len):
            # the crash raced the finish: close it as the oracle did
            self._finish(index, "length")

    def _restore_counts(self, index: int, tokens: List[int]) -> None:
        """Overwrite slot ``index``'s penalty-count row with the exact
        multiset of ``tokens``, in place and in stream order after the
        first-token sampling that reset it: a rebound tensor would leave
        the captured graphs reading the old storage."""
        row = np.zeros((self.config.vocab_size,), dtype=np.int32)
        for token in tokens:
            if 0 <= token < self.config.vocab_size:
                row[token] += 1
        self._publish("counts", {"slot": int(index)}, [row])
        self._write_counts(index, row)

    def _write_counts(self, index: int, row: np.ndarray) -> None:
        self._counts[index].copy_(torch.from_numpy(row))

    def _can_chain(self, inflight: Dict[str, Any]) -> bool:
        """A chunk may be dispatched off the in-flight chunk's carry only
        when no admission waits, no prefill is in flight, no slot joined
        since that chunk (a slot prefilled meanwhile joins the next fresh
        chunk), and every rider has two chunks of budget and context left,
        so the blind chunk cannot run a request past its end (a spec
        step emits up to ``spec_block`` tokens)."""
        if self._pending or self._prefill_inflight or self._any_admitting():
            return False
        # the most tokens a chunk can emit a slot: a spec step may accept
        # every draft and the bonus token
        budget = inflight["steps"] * self.spec_block
        for i, slot in enumerate(self.slots):
            if not inflight["active"][i]:
                if slot.ready:
                    return False
                continue
            if not slot.active or slot.epoch != inflight["epochs"][i]:
                return False
            if len(slot.generated) + 2 * budget > slot.request.sampling.max_new_tokens:
                return False
            if slot.length + 1 + 2 * budget >= self.max_seq_len:
                return False
        return True

    # ------------------------------------------------------------------ #
    # step variants (the JAX engine's jitted decode and mixed programs)
    # ------------------------------------------------------------------ #
    def _variant_keys(self) -> List[Variant]:
        """Every step variant the engine can dispatch, as the JAX engine's
        ``_variant_jobs``: the decode step counts {decode_chunk, 1,
        admission_chunk} and, mixed, the widths of the ladder, each at
        every sampling tier (a decode chunk is a "spec" chunk with
        ``spec_decode``); split, the prefill lattice of every pow2 group up
        to ``max_slots`` × every bucket (:meth:`_prefill_keys`); the KV
        copies: the paged block copy, or the dense prefix copy of every
        bucket with ``prefix_cache``."""
        steps = {self.decode_chunk, 1}
        if self.admission_chunk:
            steps.add(self.admission_chunk)
        chunk = "spec" if self.spec else "decode"
        keys = [Variant(chunk, n, tier) for n in sorted(steps) for tier in TIERS]
        if self.mixed:
            keys += [Variant("mixed", width, tier) for width in self._mixed_widths for tier in TIERS]
        if self.paged:
            keys.append(Variant("block_copy", 0))
        elif self.prefix_cache:
            keys += [Variant("copy", bucket) for bucket in self.prefill_buckets]
        return keys + self._prefill_keys()

    def _prefill_keys(self) -> List[Variant]:
        """The prefill variants: cold and at an offset (warm batches,
        long prompts' windows) at every (group, bucket); the first-token
        sampling at every (group, tier). Mixed mode admits through mixed
        steps and dispatches none, as in the JAX engine."""
        keys: List[Variant] = []
        group = 1
        while not self.mixed and group <= self.max_slots:
            for bucket in self.prefill_buckets:
                keys.append(Variant("prefill", bucket, "", group))
                keys.append(Variant("prefill_offset", bucket, "", group))
            keys += [Variant("first_token", 0, tier, group) for tier in TIERS]
            group *= 2
        return keys

    def _step_dummy(self, key: Variant) -> Dict[str, np.ndarray]:
        """``key``'s step inputs for a warm-up before traffic. Decode and
        mixed: every row inactive, so no cache row changes (a masked dense
        write keeps the old value, a masked paged one goes to the null
        block) and no count moves. Prefill: one token a row, of slot 0 on
        the dense layout (whose rows it rewrites: :meth:`precompile` puts
        them back) or of the paged null block; the first-token sampling
        resets slot 0's counts (put back too). A copy: slot 0 (the null
        block) onto itself, which changes nothing, so a copy first met
        while serving warms up on it safely."""
        slots = self.max_slots
        if key.kind in ("copy", "block_copy"):
            arrays = dict(src=np.zeros((1,), dtype=np.int64), dst=np.zeros((1,), dtype=np.int64))
            if key.kind == "copy":
                arrays["offset"] = np.zeros((1,), dtype=np.int64)
            return arrays
        if key.kind in PREFILL_KINDS:
            group = key.group
            rows = np.zeros((group,), dtype=np.int64)
            ones = np.ones((group,), dtype=np.int32)
            if key.kind == "first_token":
                arrays, _ = self._first_token_arrays([None] * group)
                arrays.update(logits=np.zeros((group, self.config.vocab_size), dtype=np.float32),
                              slot_ids=rows, positions=ones)
                return arrays
            arrays = dict(tokens=np.zeros((group, key.size), dtype=np.int64), lengths=ones)
            if key.kind == "prefill_offset":
                arrays["offsets"] = np.zeros((group,), dtype=np.int32)
            if self.paged:
                arrays["tables"] = np.zeros((group, self.max_blocks), dtype=np.int32)
            else:
                arrays["slot_ids"] = rows
            return arrays
        arrays, _ = self._sampling_arrays([None] * slots)
        if self.paged:
            arrays["tables"] = np.zeros((slots, self.max_blocks), dtype=np.int32)
        if key.kind in ("decode", "spec"):
            arrays.update(tokens=np.zeros((slots,), dtype=np.int64),
                          lengths=np.zeros((slots,), dtype=np.int32),
                          active=np.zeros((slots,), dtype=bool))
            if key.kind == "spec":
                arrays["history"] = np.zeros((slots, self.max_seq_len), dtype=np.int32)
        else:
            arrays.update(tokens=np.zeros((slots, key.size), dtype=np.int64),
                          offsets=np.zeros((slots,), dtype=np.int32),
                          num_tokens=np.zeros((slots,), dtype=np.int32),
                          decode=np.zeros((slots,), dtype=bool),
                          completes=np.zeros((slots,), dtype=bool),
                          chain_tokens=np.zeros((slots,), dtype=np.int64),
                          chain_mask=np.zeros((slots,), dtype=bool))
        return arrays

    def _step_body(self, key: Variant):
        if key.kind == "decode":
            return self._decode_body(key.size, key.tier)
        if key.kind == "spec":
            return self._spec_body(key.size, key.tier)
        if key.kind == "copy":
            return self._copy_body(key.size)
        if key.kind == "block_copy":
            return self._block_copy_body()
        if key.kind == "mixed":
            return self._mixed_body(key.size, key.tier)
        if key.kind == "first_token":
            return self._first_token_body(key.tier)
        return self._prefill_body(key.kind)

    def _prefill_body(self, kind: str):
        """One prefill model call, cold or at ``offsets``, over the rows'
        dense slots or paged tables: the JAX ``_get_prefill`` and
        ``_get_prefill_offset`` programs up to their logits."""

        def call(x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            rows = x["tables"] if self.paged else x["slot_ids"]
            args = (self.config, self.params, self.cache, x["tokens"], x["lengths"])
            if kind == "prefill" and self.paged:
                logits = model_lib.paged_prefill(*args, rows, self.freqs, kernel=self.paged_kernel)
            elif kind == "prefill":
                logits = model_lib.prefill(*args, rows, self.freqs)
            elif self.paged:
                logits = model_lib.paged_prefill_at_offset(
                    *args, x["offsets"], rows, self.freqs, kernel=self.paged_kernel)
            else:
                logits = model_lib.prefill_at_offset(*args, x["offsets"], rows, self.freqs)
            return {"logits": logits}

        return call

    def _first_token_body(self, tier: str):
        """The JAX prefill programs' ``sample_first``: bias, sample at keys
        from (seed, total length), the logprob under the raw logits; then
        the rows' slots' penalty counts reset and count the sampled token
        (the rows name distinct slots, so setting the count to 1 is
        JAX's add of 1 to a zeroed row)."""

        def first(x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            sampled, lps = self._sample(x["logits"], x, x["positions"], tier)
            slots = x["slot_ids"]
            self._counts.index_fill_(0, slots, 0)
            self._counts.index_put_((slots, sampled), torch.ones_like(sampled, dtype=torch.int32))
            return {"tokens": sampled, "logprobs": lps, **self._tops(x["logits"])}

        return first

    def _decode_body(self, steps: int, tier: str):
        """The K-step decode chunk over every slot: tokens, lengths and
        counts chain on the device from step to step; inactive rows write
        no cache row, sample 0 and count nothing."""

        def chunk(x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            tokens, lengths, active = x["tokens"], x["lengths"], x["active"]
            active_counts = active.to(torch.int32)[:, None]
            out_tokens, out_lps, out_tops = [], [], []
            for _ in range(steps):
                if self.paged:
                    logits = model_lib.paged_decode_step(
                        self.config, self.params, self.cache, tokens, lengths,
                        x["tables"], self.freqs, write_mask=active, kernel=self.paged_kernel,
                    )
                else:
                    logits = model_lib.decode_step(
                        self.config, self.params, self.cache, tokens, lengths,
                        self.freqs, write_mask=active,
                    )
                # presence/frequency penalties over generated tokens
                counts = self._counts
                penalized = logits - x["presence"] * (counts > 0) - x["frequency"] * counts
                sampled, lps = self._sample(penalized, x, lengths, tier, raw=logits)
                sampled = torch.where(active, sampled, torch.zeros_like(sampled))
                self._counts.scatter_add_(1, sampled[:, None], active_counts)
                lengths = torch.where(active, lengths + 1, lengths)
                tokens = sampled
                out_tokens.append(sampled)
                out_lps.append(lps)
                out_tops.append(self._tops(logits))
            return {"tokens": torch.stack(out_tokens, dim=1), "logprobs": torch.stack(out_lps, dim=1),
                    "final_tokens": tokens, "final_lengths": lengths, **self._stack_tops(out_tops)}

        return chunk

    def _spec_body(self, steps: int, tier: str):
        """The K-step speculative decode chunk (the JAX
        ``_get_spec_decode``): each step drafts from the slots' token
        history on the card, verifies the [S, 1 + spec_k] block in one
        model call (``verify_step``; paged ``paged_verify_step``, B3 or B6
        at Tq = 1 + spec_k) and accepts 1 to spec_k + 1 tokens a slot
        (``spec_decode.accept_block``, its counts updated in place); the
        accepted tokens extend the history, and a rejected suffix rolls
        back by not advancing the length. Outputs [S, steps, 1 + spec_k]
        tokens, logprobs and the valid mask, and the drafted counts [S,
        steps]."""
        k, width = self.spec_k, self.max_seq_len
        stochastic, truncated = TIERS[tier]

        def chunk(x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            tokens, lengths, active, history = x["tokens"], x["lengths"], x["active"], x["history"]
            rows = torch.arange(tokens.shape[0], device=tokens.device)
            out_tokens, out_lps, out_valid, out_drafted, out_tops = [], [], [], [], []
            for _ in range(steps):
                drafts, num = spec_lib.draft_ngram(history, lengths, active, ngram=self.spec_ngram, k=k)
                block = torch.cat([tokens[:, None], drafts], dim=1)  # [S, 1 + k]
                valid_lens = torch.where(active, 1 + num, torch.zeros_like(num))
                if self.paged:
                    logits = model_lib.paged_verify_step(
                        self.config, self.params, self.cache, block, lengths, valid_lens,
                        x["tables"], self.freqs, write_mask=active, kernel=self.paged_kernel)
                else:
                    logits = model_lib.verify_step(
                        self.config, self.params, self.cache, block, lengths, valid_lens,
                        self.freqs, write_mask=active)
                emitted, lps, valid = spec_lib.accept_block(
                    logits, block, num, self._counts, active, x, lengths,
                    stochastic=stochastic, truncated=truncated)
                # each block position's alternatives under its raw logits
                out_tops.append(self._tops(logits))
                accepted = valid.sum(dim=1)  # [S] tokens emitted
                # the emitted tokens extend the history at lengths ..
                # lengths + accepted - 1; the rest go to a dropped column
                positions = lengths.long()[:, None] + torch.arange(k + 1, device=tokens.device)
                positions = torch.where(valid, positions, torch.full_like(positions, width))
                extended = torch.cat([history, history[:, :1]], dim=1)
                extended.scatter_(1, positions, emitted.to(history.dtype))
                history = extended[:, :width]
                last = emitted[rows, (accepted - 1).clamp(0, k)]
                tokens = torch.where(active & (accepted > 0), last, tokens)
                lengths = lengths + torch.where(active, accepted, torch.zeros_like(accepted)).to(lengths.dtype)
                out_tokens.append(emitted)
                out_lps.append(lps)
                out_valid.append(valid)
                out_drafted.append(num)
            return {"tokens": torch.stack(out_tokens, dim=1), "logprobs": torch.stack(out_lps, dim=1),
                    "valid": torch.stack(out_valid, dim=1), "drafted": torch.stack(out_drafted, dim=1),
                    "final_tokens": tokens, "final_lengths": lengths, "final_history": history,
                    **self._stack_tops(out_tops)}

        return chunk

    def _copy_body(self, bucket: int):
        """The dense prefix copy (the JAX ``_get_copy_prefix``): rows
        [offset, offset + bucket) of slot ``src`` into slot ``dst``, every
        layer and leaf, IN PLACE. A window past the cache's end starts at
        ``max_len - bucket`` instead, as JAX's dynamic slice clamps."""
        max_len = self.max_seq_len

        def copy(x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            start = x["offset"].clamp(0, max(max_len - bucket, 0))
            rows = start + torch.arange(min(bucket, max_len), device=start.device)
            for leaf in self.cache.values():
                flat = leaf.view(leaf.shape[0], leaf.shape[1] * max_len, *leaf.shape[3:])
                flat.index_copy_(1, x["dst"] * max_len + rows,
                                 flat.index_select(1, x["src"] * max_len + rows))
            return {}

        return copy

    def _block_copy_body(self):
        """The paged copy-on-write (the JAX ``_get_block_copy``): pool
        block ``src`` into ``dst``, every layer and leaf, IN PLACE."""

        def copy(x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            for leaf in self.cache.values():
                leaf.index_copy_(1, x["dst"], leaf.index_select(1, x["src"]))
            return {}

        return copy

    def _mixed_body(self, width: int, tier: str):
        """One mixed step ``width`` tokens wide (:meth:`_dispatch_mixed`
        has the sampling semantics); a chained step's riders take their
        pending token from ``chain_tokens`` where ``chain_mask`` is set,
        as the JAX mixed program takes its carry operands."""

        def step(x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            first = torch.where(x["chain_mask"], x["chain_tokens"], x["tokens"][:, 0])
            tokens = torch.cat([first[:, None], x["tokens"][:, 1:]], dim=1)
            decode, completes = x["decode"], x["completes"]
            logits = model_lib.paged_mixed_step(
                self.config, self.params, self.cache, tokens, x["offsets"],
                x["num_tokens"], x["tables"], self.freqs, kernel=self.paged_kernel,
            )
            sample_mask = decode | completes
            counts = self._counts
            counts.masked_fill_(completes[:, None], 0)
            penalized = logits - x["presence"] * (counts > 0) - x["frequency"] * counts
            adjusted = torch.where(decode[:, None], penalized, logits)
            sampled, lps = self._sample(adjusted, x, x["offsets"] + x["num_tokens"], tier, raw=logits)
            sampled = torch.where(sample_mask, sampled, torch.zeros_like(sampled))
            counts.scatter_add_(1, sampled[:, None], sample_mask.to(torch.int32)[:, None])
            return {"sampled": sampled, "logprobs": lps, **self._tops(logits)}

        return step

    def precompile(self) -> None:
        """Capture every step variant (:meth:`_variant_keys`), prefill's
        included, before traffic, so that no capture, kernel build or
        library first use ever stalls live requests (the JAX engine's
        ``precompile``). Runs before :meth:`start`, while nothing else
        enqueues work on the card. The dummy inputs (:meth:`_step_dummy`)
        rewrite slot 0's dense rows and penalty counts, which are put back
        after, and the paged null block: the cache and the counts end as
        they were."""
        if self._thread is not None:
            raise RuntimeError("precompile() must run before start()")
        started = time.perf_counter()
        keys = self._variant_keys()
        with torch.inference_mode():
            rows = None if self.paged else {leaf: t[:, 0].clone() for leaf, t in self.cache.items()}
            counts = self._counts[0].clone()
            # the largest prefill first: the later, smaller graphs reuse
            # its segments of the shared pool instead of adding their own
            for key in sorted(keys, key=lambda key: key.group * key.size, reverse=True):
                self.steps.prepare(key)
            if rows is not None:
                for leaf, saved in rows.items():
                    self.cache[leaf][:, 0].copy_(saved)
            self._counts[0].copy_(counts)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.precompile_s = time.perf_counter() - started
        logger.info("precompiled %d step variants in %.1fs", len(keys), self.precompile_s)

    def _dispatch_decode(self, carry: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Run one K-step decode chunk over the ready slots through the
        step runner (one graph replay on the card); the chunk's sampled
        tokens start their copy to the host at once. With ``carry`` (the
        in-flight chunk's record) the chunk is the same variant and starts
        from its final tokens and lengths on the device, with its active
        mask, sampling tensors and block tables: nothing crosses from the
        host. While requests wait for a slot, or a prefill is in flight, a
        fresh chunk runs at most ``admission_chunk`` steps. In mixed mode,
        while any slot is admitting, a fresh dispatch is one mixed step
        instead (:meth:`_dispatch_mixed`)."""
        if carry is None and self._any_admitting():
            return self._dispatch_mixed()
        # chaos on the host, before anything is staged or replayed: a
        # dispatch that errs, or one that wedges (stuck_step sleeps) and
        # may wake condemned
        faults.check("dispatch_error")
        faults.maybe_sleep("stuck_step")
        self._check_condemned()
        started = time.perf_counter()
        slots = self.max_slots
        # the riders' (block-padded) contexts summed at dispatch: the cost
        # model's attention and KV-read term
        kv_tokens = 0
        if carry is not None:
            key, active, epochs = carry["key"], carry["active"], carry["epochs"]
            # the JAX engine's estimate: the carried chunk advanced every
            # rider by its steps (a block crossing, a stop inside the chunk
            # and a spec step's extra tokens are not seen without a sync)
            kv_tokens = carry["kv_tokens"] + int(active.sum()) * key.size
            # read here only: this chunk's replay overwrites them
            final = carry.pop("outputs")
            inputs = dict(carry["inputs"], tokens=final["final_tokens"],
                          lengths=final["final_lengths"])
            if self.spec:
                inputs["history"] = final["final_history"]
        else:
            tokens = np.zeros((slots,), dtype=np.int64)
            lengths = np.zeros((slots,), dtype=np.int32)
            active = np.zeros((slots,), dtype=bool)
            epochs = [0] * slots
            steps = self.decode_chunk
            if self.admission_chunk and (self._pending or self._prefill_inflight):
                # someone waits for a slot: a short chunk frees one sooner
                steps = self.admission_chunk
            # the drafting source: each ready slot's token history, the
            # pending token included (history[i, t] = the token at t)
            history = np.zeros((slots, self.max_seq_len), dtype=np.int32) if self.spec else None
            for i, slot in enumerate(self.slots):
                lengths[i] = slot.length
                epochs[i] = slot.epoch
                if slot.ready:
                    active[i] = True
                    tokens[i] = slot.history[-1]
                    lengths[i] = slot.length + 1
                    kv_tokens += self.cost_model.kv_read_tokens(slot.length + 1)
                    if history is not None:
                        history[i, : len(slot.history)] = slot.history
                    # a chunk writes cache positions up to length + steps
                    # × spec_block - 1: drop to single steps near the
                    # context boundary (the drafter keeps one step inside)
                    if self.max_seq_len - slot.length - 1 < steps * self.spec_block:
                        steps = 1
            inputs, tier = self._sampling_arrays(
                [slot.request if slot.ready else None for slot in self.slots]
            )
            inputs.update(tokens=tokens, lengths=lengths, active=active)
            if self.paged:
                inputs["tables"] = self._block_tables
            if history is not None:
                inputs["history"] = history
            key = Variant("spec" if self.spec else "decode", steps, tier)
        # telemetry taken at dispatch: by processing time a rider's slot
        # may hold another request. A chained chunk keeps its carry's
        # (its riders are the same)
        if carry is not None:
            telemetry = carry["telemetry"]
        elif self.tracer.enabled or flight.RECORDER.enabled:
            telemetry = self._telemetry([i for i in range(slots) if active[i]])
        else:
            telemetry = {}
        inputs, outputs = self._run_step(key, inputs, chained=carry is not None)
        # counted here, on the host: a replay runs none of the body
        call = "verify_step" if self.spec else "decode_step"
        self._count_dispatch(("paged_" if self.paged else "") + call, key.size)
        host = [outputs["tokens"], outputs["logprobs"]]
        if self.spec:
            host += [outputs["valid"], outputs["drafted"]]
        host += self._host_tops(outputs)
        return {
            "key": key,
            "out": self._to_host(*host),
            "inputs": inputs,
            "outputs": outputs,
            "active": active,
            "epochs": epochs,
            "steps": key.size,
            "started": started,
            "kv_tokens": kv_tokens,
            "telemetry": telemetry,
        }

    def _telemetry(self, riders: List[int]) -> Dict[str, Any]:
        """A dispatch's flight and tracer fields, taken when it is
        dispatched: its riders' trace ids, the queue depth and the KV
        pressure (the pool's blocks on the paged layout)."""
        out: Dict[str, Any] = {
            "trace_ids": ",".join(self.slots[i].request.trace_id for i in riders
                                  if self.slots[i].request is not None
                                  and self.slots[i].request.trace_id),
            "queue_depth": len(self._pending),
        }
        if self.paged:
            in_use = self.kv_manager.blocks_in_use
            out.update(kv_frac=round(in_use / float(self.num_blocks), 4), kv_blocks=in_use,
                       prefix_hit_tokens=self.kv_manager.stats["hit_tokens"])
        else:
            out["kv_frac"] = round(sum(slot.length for slot in self.slots if slot.active)
                                   / float(self.max_slots * self.max_seq_len), 4)
        return out

    def _plan_windows(self, admitting: List[int]) -> Tuple[Dict[int, Tuple[int, int]], int]:
        """FIFO token-budget plan over admitting slot indices: ``{slot:
        (pos, n)}``, windows of at most ``prefill_chunk`` tokens in all,
        shared by admission order so an early prompt is never starved by
        a later burst, and the step's width (the smallest ladder width
        that holds the longest window)."""
        budget = self.prefill_chunk
        windows: Dict[int, Tuple[int, int]] = {}
        max_n = 1
        for i in sorted(admitting, key=lambda i: self.slots[i].prefill_seq):
            if budget <= 0:
                break
            slot = self.slots[i]
            n = min(len(slot.request.prompt_tokens) - slot.prefill_pos, budget)
            if n <= 0:
                continue
            windows[i] = (slot.prefill_pos, n)
            budget -= n
            max_n = max(max_n, n)
        width = next(w for w in self._mixed_widths if w >= max_n)
        return windows, width

    def _plan_mixed_chain(self, inflight: Dict[str, Any]):
        """Two-step window plan of the mixed-step carry: whether the next
        mixed step is predictable on the host from the in-flight one and,
        if so, its rows. The windows of step N+1 follow from the
        watermarks advanced when N was dispatched and from N's
        ``completes``; only N's sampled tokens are unknown to the host,
        and they stay on the device. Returns ``{"riders", "windows",
        "width"}`` or the reason the next step is host-built:
        ``admission`` (work N's sampling tensors do not cover), ``replay``
        (a resurrected session's prompt completes in N), ``budget``
        (a rider could finish by length during N), ``width`` (the ladder
        changes width), ``drained`` (no windows remain: plain chunks take
        over), ``epoch`` (a carried row's slot was recycled)."""
        if self._pending or self._prefill_inflight:
            return "admission"
        prev_plan = inflight["plan"]
        riders: List[int] = []
        admitting: List[int] = []
        for i, slot in enumerate(self.slots):
            carried = inflight["decode_mask"][i] or i in prev_plan
            if slot.request is None:
                if carried:
                    return "epoch"
                continue
            if slot.epoch != inflight["epochs"][i]:
                # admitted after the in-flight step was planned: its
                # sampling params are not in the carried tensors
                return "epoch" if carried else "admission"
            if inflight["decode_mask"][i] or (i in prev_plan and inflight["completes"][i]):
                if i in prev_plan and slot.request.replay_tokens:
                    # a replay's completing window: its pending token is
                    # replay[-1], not the step's sample
                    return "replay"
                riders.append(i)
            elif slot.prefill_pos is not None:
                admitting.append(i)
        for i in riders:
            # room for the in-flight token and the speculated one, so a
            # rider can only finish mid-chain by a stop, never by length
            generated = len(self.slots[i].generated or ())
            if generated + 2 > self.slots[i].request.sampling.max_new_tokens:
                return "budget"
            if int(inflight["offsets"][i]) + int(inflight["num_tokens"][i]) + 2 >= self.max_seq_len:
                return "budget"
        windows, width = self._plan_windows(admitting)
        if not windows:
            return "drained"
        if width != inflight["width"]:
            return "width"
        return {"riders": riders, "windows": windows, "width": width}

    def _note_carry_invalidation(self, reason: str, events: int = 1) -> None:
        invalidations = self.stats["mixed_carry_invalidations"]
        invalidations[reason] = invalidations.get(reason, 0) + events

    def _dispatch_mixed(
        self,
        carry: Optional[Dict[str, Any]] = None,
        plan_next: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """One mixed step: every ready slot rides as a one-token decode
        row, and up to ``prefill_chunk`` prompt tokens of admitting slots
        ride beside them as prefill windows, in one model call
        (:func:`model.paged_mixed_step`). Sampling keeps the split paths'
        semantics, so the two modes give the same tokens: decode rows
        take penalties over their counts; a window that completes its
        prompt samples the request's first token like a prefill (counts
        reset, no penalty, then the token counted); bias applies to every
        row; keys come from (seed, the row's cache length after the
        step); rows that do not sample return 0 and leave their counts
        alone.

        With ``carry`` (the in-flight step's record) and ``plan_next``
        (:meth:`_plan_mixed_chain`) the step chains on the device: each
        rider's pending token is the in-flight step's device-resident
        sample (``chain_mask`` splices it into column 0), its offset the
        in-flight row's offset plus its count, and the tables and
        sampling tensors are the carry's; only the window tokens and the
        per-row counts upload."""
        faults.check("dispatch_error")
        faults.maybe_sleep("stuck_step")
        self._check_condemned()
        started = time.perf_counter()
        slots = self.max_slots
        chained = carry is not None
        if chained:
            plan, riders, width = plan_next["windows"], plan_next["riders"], plan_next["width"]
        else:
            plan, width = self._plan_windows([
                i for i, slot in enumerate(self.slots)
                if slot.prefill_pos is not None and slot.request is not None
            ])
            riders = [i for i, slot in enumerate(self.slots) if slot.ready]
        tokens = np.zeros((slots, width), dtype=np.int64)
        offsets = np.zeros((slots,), dtype=np.int32)
        num_tokens = np.zeros((slots,), dtype=np.int32)
        decode_mask = np.zeros((slots,), dtype=bool)
        completes = np.zeros((slots,), dtype=bool)
        chain_mask = np.zeros((slots,), dtype=bool)
        kv_tokens = 0          # the decode rows' (block-padded) context reads
        prefill_kv_tokens = 0  # the windows' prefix and window reads
        padding = 0
        for i, (pos, n) in plan.items():
            prompt = self.slots[i].request.prompt_tokens
            tokens[i, :n] = prompt[pos:pos + n]
            offsets[i] = pos
            num_tokens[i] = n
            completes[i] = pos + n == len(prompt)
            padding += width - n
            prefill_kv_tokens += self.cost_model.kv_read_tokens(pos + n)
        for i in riders:
            if chained:
                chain_mask[i] = True
                offsets[i] = int(carry["offsets"][i]) + int(carry["num_tokens"][i])
            else:
                tokens[i, 0] = self.slots[i].history[-1]
                offsets[i] = self.slots[i].length
            num_tokens[i] = 1
            decode_mask[i] = True
            kv_tokens += self.cost_model.kv_read_tokens(int(offsets[i]) + 1)
        # the windows are final once dispatched: advance the watermarks,
        # which the next step's plan (chained or fresh) starts from
        for i, (pos, n) in plan.items():
            self.slots[i].prefill_pos = pos + n
        # the padded [S, W] grid's ghost positions behind short windows
        self._waste("prefill_padding", padding)
        telemetry = (self._telemetry(riders) if self.tracer.enabled or flight.RECORDER.enabled
                     else {})
        step = dict(tokens=tokens, offsets=offsets, num_tokens=num_tokens, decode=decode_mask,
                    completes=completes, chain_mask=chain_mask)
        if chained:
            # the same variant (the plan keeps the width, the tier is the
            # carry's); the sample is read here only: this step's replay
            # overwrites it
            key = carry["key"]
            inputs = dict(carry["inputs"], chain_tokens=carry.pop("outputs")["sampled"], **step)
        else:
            # every live row's params, planned or not, so a chained step
            # can reuse these tensors when the budget reaches a row this
            # step skipped
            inputs, tier = self._sampling_arrays([slot.request for slot in self.slots])
            inputs.update(tables=self._block_tables,
                          chain_tokens=np.zeros((slots,), dtype=np.int64), **step)
            key = Variant("mixed", width, tier)
        inputs, outputs = self._run_step(key, inputs, chained=chained)
        self._count_dispatch("paged_mixed_step")
        return {
            "mixed": True,
            "key": key,
            "chained": chained,
            "width": width,
            "plan": plan,
            "out": self._to_host(outputs["sampled"], outputs["logprobs"], *self._host_tops(outputs)),
            "inputs": inputs,
            "outputs": outputs,
            "decode_mask": decode_mask,
            "completes": completes,
            "offsets": offsets,
            "num_tokens": num_tokens,
            "epochs": [slot.epoch for slot in self.slots],
            "started": started,
            "kv_tokens": kv_tokens,
            "prefill_kv_tokens": prefill_kv_tokens,
            "prefill_tokens": int(sum(n for _, n in plan.values())),
            "telemetry": telemetry,
        }

    def _busy_since(self, started: float, ended: float) -> float:
        """Seconds of [started, ended] not yet counted: pipelined chunks
        overlap, so decode time sums the union of their intervals."""
        busy = max(0.0, ended - max(started, self._decode_busy_until))
        self._decode_busy_until = max(self._decode_busy_until, ended)
        return busy

    def _process_mixed(self, step: Dict[str, Any]) -> None:
        """Emit a mixed step's tokens: decode rows advance by one, a
        window that completed its prompt ends the slot's admission and
        emits its first token, other rows emit nothing. A chained step's
        row whose request ended while the step was in flight is counted
        as a ``stale_row`` invalidation."""
        sampled, lps, *tops = self._from_host(step["out"])
        ended = time.perf_counter()
        wall = ended - step["started"]
        busy = self._busy_since(step["started"], ended)
        self._note_step_time(wall)
        # the card's idle time since the previous mixed step was processed
        # (a chained step's collapses)
        gap_ms = max(0.0, step["started"] - self._last_mixed_end) * 1e3 if self._last_mixed_end else 0.0
        self._last_mixed_end = ended
        n_decode = int(step["decode_mask"].sum())
        self.stats["decode_steps"] += 1
        self.stats["decode_chunks"] += 1
        self.stats["decode_token_steps"] += 1.0
        self.stats["mixed_steps"] += 1
        self.stats["decode_time"] += busy
        self.stats["mixed_time"] += busy
        self.stats["active_slot_steps"] += n_decode
        if step["chained"]:
            self.stats["mixed_steps_chained"] += 1
        DECODE_STEP_SECONDS.observe(wall)
        flops = self.cost_model.mixed_step_flops(n_decode, step["kv_tokens"], list(step["plan"].values()))
        nbytes = self.cost_model.mixed_step_bytes(step["kv_tokens"] + step["prefill_kv_tokens"],
                                                  n_decode + step["prefill_tokens"])
        mfu, mbu = self._charge_decode(flops, nbytes, wall, n_decode or step["plan"])
        if self.tracer.enabled or flight.RECORDER.enabled:
            self._record_chunk(step, 1, n_decode, wall, mfu, mbu, mixed=1, width=step["width"],
                               prefill_rows=len(step["plan"]),
                               prefill_tokens=step["prefill_tokens"],
                               chained=int(step["chained"]), gap_ms=round(gap_ms, 3))
        stale_rows = 0
        for i, slot in enumerate(self.slots):
            if slot.epoch != step["epochs"][i] or not slot.active:
                if step["chained"] and (
                    step["decode_mask"][i] or (i in step["plan"] and step["completes"][i])
                ):
                    stale_rows += 1
                continue
            if step["decode_mask"][i]:
                slot.length += 1
                self._emit_token(i, int(sampled[i]), float(lps[i]), self._top(tops, i))
            elif i in step["plan"] and step["completes"][i]:
                slot.prefilling = False
                slot.prefill_pos = None
                self.stats["warm_prefill_calls" if slot.prefill_reused else "prefill_calls"] += 1
                self.stats["mixed_admit_time"] += ended - slot.prefill_t0
                if slot.request.replay_tokens:
                    # a resurrected session: fast-forward (_resume_replay)
                    self._resume_replay(i, slot.request, reused=slot.prefill_reused)
                else:
                    self._emit_token(i, int(sampled[i]), float(lps[i]), self._top(tops, i))
        if stale_rows:
            # a chained step sampled for rows whose request ended while it
            # was in flight: the discarded work goes to the ledger
            self._waste("carry_invalidated", stale_rows)
            self._note_carry_invalidation("stale_row", stale_rows)
        # chaos: the engine thread dies after this step's tokens reached
        # their callers (the JAX engine's point)
        faults.check("engine_thread_crash")

    def _process_decode(self, chunk: Dict[str, Any]) -> None:
        if chunk.get("mixed"):
            return self._process_mixed(chunk)
        out, lps, *rest = self._from_host(chunk["out"])
        spec, tops = (rest[:2], rest[2:]) if self.spec else ([], rest)
        steps, active = chunk["steps"], chunk["active"]
        # a plain chunk ends a run of mixed steps: the next one's gap does
        # not span it
        self._last_mixed_end = 0.0
        ended = time.perf_counter()
        wall = ended - chunk["started"]
        self._note_step_time(wall / max(steps, 1))
        self.stats["decode_steps"] += steps
        self.stats["decode_chunks"] += 1
        self.stats["decode_time"] += self._busy_since(chunk["started"], ended)
        n_active = int(active.sum())
        self.stats["active_slot_steps"] += n_active * steps
        DECODE_STEP_SECONDS.observe(wall / max(steps, 1))
        # a pipelined chunk shares wall time with its neighbour, so its own
        # MFU can read high; the cumulative gauges divide by the busy union
        flops = self.cost_model.decode_chunk_flops(steps, n_active, chunk["kv_tokens"],
                                                   block=self.spec_block)
        nbytes = self.cost_model.decode_chunk_bytes(steps, n_active, chunk["kv_tokens"],
                                                    block=self.spec_block)
        mfu, mbu = self._charge_decode(flops, nbytes, wall, n_active)
        # per accepted token: a spec step yields 1 + its accepted drafts
        self.stats["decode_token_steps"] += (
            int(spec[0][active].sum()) / n_active if spec and n_active else float(steps))
        if spec:
            # a step emits 1 + its leading accepted drafts a slot: the 1 is
            # the token the verify logits fund either way
            valid, drafted = spec
            drafted_total = int(drafted[active].sum())
            accepted_total = int(valid[active].sum()) - int(active.sum()) * steps
            self.stats["tokens_drafted"] += drafted_total
            self.stats["tokens_draft_accepted"] += accepted_total
            self._waste("draft_rejected", drafted_total - accepted_total)
        if self.tracer.enabled or flight.RECORDER.enabled:
            extra = dict(drafted=drafted_total, accepted=accepted_total) if spec else {}
            self._record_chunk(chunk, steps, n_active, wall, mfu, mbu, **extra)
        for i, slot in enumerate(self.slots):
            if not active[i] or slot.epoch != chunk["epochs"][i]:
                continue
            for j in range(steps):
                if not slot.active:
                    # finished mid-chunk: surplus tokens discarded; the
                    # length stopped at the stop, so later rows are dead
                    break
                if not spec:
                    slot.length += 1
                    self._emit_token(i, int(out[i, j]), float(lps[i, j]), self._top(tops, i, j))
                    continue
                # a True-prefix of the block; a stop inside it discards the
                # rest as a stop inside a chunk does
                for b in range(self.spec_block):
                    if not valid[i, j, b] or not slot.active:
                        break
                    slot.length += 1
                    self._emit_token(i, int(out[i, j, b]), float(lps[i, j, b]),
                                     self._top(tops, i, j, b))
        # chaos: the engine thread dies after this chunk's tokens reached
        # their callers; the supervisor resurrects every live session from
        # exactly here (the JAX engine's point)
        faults.check("engine_thread_crash")

    def _charge_decode(self, flops: float, nbytes: float, wall: float, observed) -> Tuple[float, float]:
        """Book a decode chunk's or mixed step's modeled work; returns its
        MFU and MBU over its own wall, observed in the per-chunk
        histograms when ``observed`` (it ran rows)."""
        self.stats["decode_flops"] += flops
        self.stats["decode_bytes"] += nbytes
        mfu = accounting.CostModel.mfu(flops, wall, self.peaks)
        mbu = accounting.CostModel.mbu(nbytes, wall, self.peaks)
        if observed:
            MFU_PER_CHUNK.observe(mfu)
            MBU_PER_CHUNK.observe(mbu)
        return mfu, mbu

    def _record_chunk(self, chunk: Dict[str, Any], steps: int, active: int, wall: float,
                      mfu: float, mbu: float, **extra: Any) -> None:
        """The ``engine.decode_chunk`` span (tagged with every rider's
        trace id) and the ``decode_chunk`` flight record of a processed
        decode chunk or mixed step, with the JAX engine's fields."""
        # (empty when the sinks came on after this dispatch)
        telemetry = chunk["telemetry"] or self._telemetry([])
        step_ms = round(wall / max(steps, 1) * 1e3, 3)
        self.tracer.event("engine.decode_chunk", wall, start_wall=time.time() - wall,
                          trace_ids=telemetry["trace_ids"], steps=steps, active=active,
                          step_ms=step_ms, mfu=round(mfu, 6), mbu=round(mbu, 6))
        fields: Dict[str, Any] = {}
        if self.paged:
            fields = dict(kv_blocks_in_use=telemetry["kv_blocks"], kv_blocks_total=self.num_blocks,
                          prefix_hit_tokens=telemetry["prefix_hit_tokens"])
        flight.record("decode_chunk", steps=steps, active=active, slots=self.max_slots,
                      step_ms=step_ms, queue_depth=telemetry["queue_depth"],
                      kv_frac=telemetry["kv_frac"], tokens=self.stats["tokens_generated"],
                      mfu=round(mfu, 6), mbu=round(mbu, 6),
                      tokens_useful=self.stats["tokens_useful"],
                      tokens_wasted=sum(self.stats["tokens_wasted"].values()),
                      **fields, **extra)

    def _note_step_time(self, step_s: float) -> None:
        """The EWMA seconds per decode step (the Retry-After of a shed)."""
        self._step_ewma = step_s if self._step_ewma is None else 0.8 * self._step_ewma + 0.2 * step_s

    def _emit_token(self, index: int, token: int, logprob: float = 0.0,
                    top: Optional[Tuple[List[int], List[float]]] = None) -> None:
        """Record a newly generated token (with its top-K alternatives
        when the engine keeps them) for a slot; finish if stopping."""
        slot = self.slots[index]
        request = slot.request
        if not slot.generated:
            # the TTFT anchor, and its wall twin: the journey's prefill →
            # decode boundary
            request._first_token_ts = time.perf_counter()  # type: ignore[attr-defined]
            request._first_token_wall = time.time()  # type: ignore[attr-defined]
        slot.generated.append(token)
        slot.logprobs.append(logprob)
        if slot.tops is not None:
            slot.tops.append(top if top is not None else ([], []))
        self.stats["tokens_generated"] += 1
        hit_stop = token in request.stop_tokens
        if not hit_stop:
            slot.history.append(token)
        done = (
            hit_stop
            or request.cancelled
            or len(slot.generated) >= request.sampling.max_new_tokens
            or slot.length + 1 >= self.max_seq_len
        )
        if request.on_token is not None and not hit_stop:
            self._post(request, request.on_token, token, done)
        if done:
            if hit_stop:
                reason = "stop"
            elif request.cancelled:
                reason = "cancelled"
            else:
                reason = "length"
            self._finish(index, reason)

    def _finish(self, index: int, reason: str) -> None:
        slot = self.slots[index]
        request = slot.request
        generated = list(slot.generated)
        logprobs = list(slot.logprobs)
        tops = list(slot.tops) if slot.tops is not None else None
        if generated and generated[-1] in request.stop_tokens:
            generated = generated[:-1]
            logprobs = logprobs[:-1]
            if tops is not None:
                tops = tops[:-1]
        # a resurrected session's prompt_tokens hold prompt + replay[:-1]:
        # usage reports the original prompt
        result = GenerationResult(
            tokens=generated,
            prompt_tokens=request.prompt_len if request.prompt_len is not None
            else len(request.prompt_tokens),
            finish_reason=reason,
            logprobs=logprobs,
            top_logprobs=tops,
        )
        self.stats["requests"] += 1
        # the goodput ledger: a cancelled request's tokens were decoded for
        # a caller that stopped listening
        if reason == "cancelled":
            self._waste("cancelled", len(generated))
        else:
            self.stats["tokens_useful"] += len(generated)
        # per-request latency, always: the SLO burn rates must not depend
        # on a tracer
        now = time.perf_counter()
        submit_ts = getattr(request, "_submit_ts", now)
        first_ts = getattr(request, "_first_token_ts", now)
        self.stats["ttft_time"] += first_ts - submit_ts
        ttft_ms = round((first_ts - submit_ts) * 1e3, 3)
        tpot_ms = round((now - first_ts) / (len(generated) - 1) * 1e3, 3) if len(generated) > 1 else 0.0
        TTFT_SECONDS.observe(max(0.0, ttft_ms / 1e3))
        if len(generated) > 1:
            TPOT_SECONDS.observe(max(0.0, tpot_ms / 1e3))
        REQUEST_SECONDS.observe(max(0.0, now - submit_ts))
        if self.slo is not None:
            self.slo.tick()
        if self.tracer.enabled or flight.RECORDER.enabled:
            tid = request.trace_id or ""
            self.tracer.event("engine.request", max(0.0, now - submit_ts), trace_id=tid,
                              start_wall=getattr(request, "_submit_wall", time.time()), slot=index,
                              prompt_tokens=len(request.prompt_tokens), tokens=len(generated),
                              finish_reason=reason, ttft_ms=ttft_ms, tpot_ms=tpot_ms)
            # the port's record also holds the answer's token ids (and, with
            # ``logprobs_topk``, each token's top-K ids and logprobs), so that
            # a request served behind text (an app's answer) can be held
            # against another run token by token, a parting judged by its gap
            extra = {} if tops is None else {"top_logprobs": [
                [[int(i) for i in ids], [float(x) for x in lps]] for ids, lps in tops]}
            flight.record("request", trace_id=tid, prompt_tokens=len(request.prompt_tokens),
                          tokens=len(generated), finish_reason=reason, ttft_ms=ttft_ms,
                          tpot_ms=tpot_ms, token_ids=[int(t) for t in generated], **extra)
        slot.request = None
        slot.prefilling = False
        slot.prefill_pos = None
        slot.epoch += 1
        slot.generated = None
        slot.logprobs = None
        slot.tops = None
        # keep only the history whose rows are IN the cache (the final
        # sampled token is never written)
        history = slot.history[: slot.length]
        slot.session_id = None
        slot.history = None
        if request.session_id is not None:
            # pin the slot for the session's next turn
            slot.session_id = request.session_id
            slot.last_used = time.monotonic()
            slot.history = history
        if self.paged and slot.blocks is not None:
            if self.prefix_cache:
                # publish the completed prefix (prompt + generated), full
                # blocks only. The chain outlives the slot, refcounted by
                # the map, until LRU eviction needs it
                self.kv_manager.publish(history, slot.blocks)
                if request.export_handoff and reason != "cancelled":
                    # disaggregation prefill leg: gather the chain just
                    # published while the slot's refs still pin it
                    started = time.time()
                    result.kv_handoff = self._export_handoff(slot, history)
                    if result.kv_handoff is not None:
                        request._jt_export = (started, time.time())  # type: ignore[attr-defined]
            if slot.session_id is not None:
                # a pinned session holds only the blocks its history
                # fills, not its worst-case reservation
                keep = -(-slot.length // self.block_size)
                for extra in slot.blocks[keep:]:
                    self.kv_manager.unref(extra)
                slot.blocks = slot.blocks[:keep]
                self._block_tables[index, keep:] = 0
            else:
                # sessionless: unpublished blocks free now, published ones
                # stay matchable until LRU eviction needs them
                self.kv_manager.release(slot.blocks)
                slot.blocks = None
                self._block_tables[index, :] = 0
                slot.length = 0
        elif slot.session_id is None:
            if self.prefix_cache:
                # the slot is free, and its rows stay for a later request
                # sharing their prefix to salvage or copy
                slot.history = history
            else:
                slot.length = 0
        self._emit_journey(index, request, reason, len(generated), ttft_ms)
        if request.future is not None:
            self._post_future(request, result)

    def _emit_journey(self, index: int, request: GenerationRequest, reason: str, tokens: int,
                      ttft_ms: float) -> None:
        """This leg's journey stages on the wall clock, tiled by
        construction (``journey.StageBuilder``): the per-stage histograms
        and the SLO blame always, the ``journey`` flight record and the
        per-stage spans when those sinks are on (the JAX engine's)."""
        now_wall = time.time()
        submit_wall = getattr(request, "_submit_wall", now_wall)
        admit_wall = getattr(request, "_admit_wall", submit_wall)
        first_wall = getattr(request, "_first_token_wall", None)
        import_window = getattr(request, "_jt_import", None)
        export_window = getattr(request, "_jt_export", None)
        admit_class = getattr(request, "_jt_admit_class", None) or "cold"
        builder = journey_ledger.StageBuilder()
        if request.handoff_export_ts is not None:
            # the decode leg of a handoff: the prefill replica's export
            # stamp to this submit is the fabric's and the assembler's time
            builder.add("handoff_transit", request.handoff_export_ts, submit_wall)
        builder.add("queue", submit_wall, import_window[0] if import_window else admit_wall)
        if import_window:
            builder.add("handoff_import", import_window[0], import_window[1])
        builder.add("admit", admit_wall, admit_wall, admit_class=admit_class)
        builder.add("prefill", admit_wall, first_wall if first_wall is not None else admit_wall)
        decode_end = export_window[0] if export_window else now_wall
        builder.add("decode", first_wall if first_wall is not None else admit_wall, decode_end)
        if export_window:
            builder.add("handoff_export", export_window[0], export_window[1])
        builder.add("finish", export_window[1] if export_window else decode_end, now_wall,
                    finish_reason=reason)
        stages = builder.stages
        journey_ledger.observe_stages(stages)
        if self.slo is not None and self.slo.targets_s:
            ttft_target = self.slo.targets_s.get("ttft")
            if ttft_target is not None and ttft_ms / 1e3 > ttft_target:
                self.slo.attribute("ttft", journey_ledger.blame_stage(stages, first_wall, "ttft"))
            tpot_target = self.slo.targets_s.get("tpot")
            if (tpot_target is not None and tokens > 1 and first_wall is not None
                    and (decode_end - first_wall) / (tokens - 1) > tpot_target):
                self.slo.attribute("tpot", journey_ledger.blame_stage(stages, first_wall, "tpot"))
        if not (self.tracer.enabled or flight.RECORDER.enabled):
            return
        tid = request.trace_id or ""
        flight.record("journey", trace_id=tid, session_id=request.session_id or "", slot=index,
                      finish_reason=reason, tokens=tokens, admit_class=admit_class,
                      first_token=first_wall, ttft_ms=ttft_ms,
                      e2e_ms=round((now_wall - stages[0]["start"]) * 1e3, 3), stages=stages)
        if self.tracer.enabled and tid:
            replica = flight.get_identity().get("replica", "")
            for stage in stages:
                self.tracer.event(f"engine.journey.{stage['stage']}", stage["end"] - stage["start"],
                                  trace_id=tid, start_wall=stage["start"], slot=index,
                                  replica=replica)

    def _resolve_cancelled(self, request: GenerationRequest) -> None:
        """Resolve a request cancelled before it reached a slot."""
        self.stats["requests"] += 1
        if request.future is not None:
            self._post_future(
                request,
                GenerationResult(
                    # a resurrected request cancelled before re-admission
                    # still owes its caller the tokens already delivered
                    tokens=list(request.replay_tokens or []),
                    prompt_tokens=request.prompt_len if request.prompt_len is not None
                    else len(request.prompt_tokens),
                    finish_reason="cancelled",
                    logprobs=list(request.replay_logprobs or []),
                ),
            )

    def _post(self, request: GenerationRequest, fn, *args) -> None:
        if request.loop is not None:
            request.loop.call_soon_threadsafe(fn, *args)
        else:
            fn(*args)

    def _post_future(self, request: GenerationRequest, result) -> None:
        def resolve():
            if not request.future.done():
                request.future.set_result(result)

        if request.loop is not None:
            request.loop.call_soon_threadsafe(resolve)
        else:
            resolve()

    def _fail_all_pending(self) -> None:
        """Fail every waiter promptly: queued, pending and in a slot."""
        error = RuntimeError("decode engine crashed; see logs")
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._pending.append(item)
        for request in self._pending:
            fail_request_future(request, error)
        self._pending = []
        self._prefill_inflight = []
        for slot in self.slots:
            if slot.active:
                fail_request_future(slot.request, error)
                slot.request = None
                slot.prefilling = False

    def _fail_stragglers(self) -> None:
        """Fail, with the typed retryable error, any request left in this
        retired engine's queue after the recovery drain swept it; requests
        the drain took ride the resurrection."""
        error = api_errors.EngineRebuildingError(
            "engine is rebuilding after a crash; retry shortly", retry_after_s=2.0)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                fail_request_future(item, error)

    # ------------------------------------------------------------------ #
    # supervisor takeover (runtime/supervisor.py)
    # ------------------------------------------------------------------ #
    def drain_for_recovery(self) -> List[GenerationRequest]:
        """Every live session of this dead or condemned engine as a
        request the supervisor resubmits to a rebuilt one (the JAX
        engine's ``drain_for_recovery``). A slot with emitted tokens
        becomes a REPLAY request: ``prompt_tokens`` is rewritten to
        ``prompt + generated[:-1]`` and the emitted tokens ride
        ``replay_tokens``; queued, pending and still-prefilling requests
        (no token reached their caller) go back untouched. Slots are
        neutralized first (request dropped, epoch bumped), so a condemned
        thread that wakes later emits into no resurrected stream."""
        requests: List[GenerationRequest] = []
        # the flag first, then the sweep: a submit whose put lands after
        # this point is either collected below or fails itself in submit()
        self._recovery_drained = True
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._pending.append(item)
        for slot in self.slots:
            if not slot.active:
                continue
            request = slot.request
            generated = list(slot.generated or [])
            logprobs = list(slot.logprobs or [])
            tops = list(slot.tops) if slot.tops is not None else None
            slot.request = None
            slot.prefilling = False
            slot.prefill_pos = None
            slot.epoch += 1
            original = request.prompt_len if request.prompt_len is not None else len(
                request.prompt_tokens)
            if generated:
                request.prompt_len = original
                request.prompt_tokens = request.prompt_tokens[:original] + generated[:-1]
                request.replay_tokens = generated
                request.replay_logprobs = logprobs
                request.replay_tops = tops
            requests.append(request)
        requests.extend(self._pending)
        self._pending = []
        self._prefill_inflight = []
        return requests

    def retire(self) -> None:
        """Drop this engine from the ``/metrics`` aggregation at once (a
        superseded engine must not count beside its replacement)."""
        _LIVE_ENGINES.discard(self)

    def release(self) -> None:
        """Free a retired engine's device state before its replacement
        allocates: wait for the work its stream has queued (a pipelined
        chunk may be in flight at the crash, and the caching allocator
        would hand its blocks to the new engine while it still writes
        them), then reset its graphs and drop the KV cache, the penalty
        counts and the step runner's static buffers. The weights are the
        replacement's too and stay. A condemned thread that wakes later
        checks ``_running`` before any launch (``_check_condemned``).

        Under a mirror the followers release theirs at the ``release``
        record; the mirror passes to the rebuilt engine (the provider's
        factory), and this one publishes nothing more."""
        mirror, self.mirror = self.mirror, None
        if mirror is not None and not mirror.closed:
            try:
                mirror.publish("release", {}, [])
            except Exception:  # noqa: BLE001 — the writer died with a follower
                logger.warning("mirror: release record not delivered")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.steps.release()
        self.cache = {}
        self._counts = None
        self._prefill_inflight = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def absorb_stats(self, previous: Dict[str, Any]) -> None:
        """Carry a crashed predecessor's cumulative counters into this
        engine (before its thread starts), so no ``/metrics`` series
        resets mid-incident."""
        for key, value in previous.items():
            if isinstance(value, dict):
                mine = self.stats.setdefault(key, {})
                for reason, count in value.items():
                    mine[reason] = mine.get(reason, 0) + count
            elif isinstance(value, (int, float)):
                self.stats[key] = self.stats.get(key, 0) + value
