"""Continuous-batching decode engine on one GPU — the serving core of
``torch-local``.

Port of ``langstream_tpu/providers/jax_local/engine.py`` reduced to the
split-prefill path over either KV layout:

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
- **Continuous batching**: requests join mid-flight. Cold requests that
  share a prompt bucket are prefilled together (power-of-two groups) and
  their first token is sampled in the same call; a finishing request
  frees its slot at once. A prompt longer than the largest bucket is
  prefilled in bucket-sized windows (``_prefill_long``).
- **K-step decode chunks**: the JAX ``lax.scan`` becomes a host loop of K
  steps whose sampled tokens stay on the device; the chunk's tokens cross
  to the host once, are emitted per chunk, and a stop in mid-chunk
  discards the rest of the chunk (the slot's length stops at the stop).
- **On-device sampling**: greedy / temperature / top-k / top-p, presence
  and frequency penalties over a per-slot count array, logit bias, and
  per-request keys from (seed, position) that reproduce ``jax.random``.
- **Dedicated engine thread**: callers enqueue requests (thread-safe
  :meth:`DecodeEngine.submit`, or ``await`` :meth:`DecodeEngine.generate`)
  and receive per-token callbacks on their own event loop.

Not in this slice (ROADMAP.md): warm sessions (and the paged
copy-on-write they need), the dense layout's cross-slot prefix copy, host
KV tiers and handoffs, speculative and mixed dispatch, the pipelined
carry, the supervisor and the telemetry planes.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from langstream_tpu_torch.device import resolve_device
from langstream_tpu_torch.ops.paged_attention import fused_shapes_ok
from langstream_tpu_torch.providers.torch_local import model as model_lib
from langstream_tpu_torch.providers.torch_local import prng, sampling
from langstream_tpu_torch.providers.torch_local.paged import PagedKVManager

logger = logging.getLogger(__name__)


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
    # an asyncio future (with ``loop``) or a concurrent.futures.Future
    future: Optional[Any] = None
    loop: Optional[Any] = None
    # set from ANY thread via cancel(); the engine finishes the request
    # with reason "cancelled" at the next token boundary
    cancelled: bool = False

    def cancel(self) -> None:
        self.cancelled = True


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    prompt_tokens: int
    finish_reason: str = "stop"
    # per-token log-probability under the untruncated distribution
    logprobs: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Slot:
    request: Optional[GenerationRequest] = None
    length: int = 0                 # valid cache length
    generated: Optional[List[int]] = None
    logprobs: Optional[List[float]] = None
    history: Optional[List[int]] = None  # tokens in cache + the pending one
    epoch: int = 0                  # bumps on assign/finish
    blocks: Optional[List[int]] = None   # paged: the slot's reserved pool blocks

    @property
    def active(self) -> bool:
        return self.request is not None


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
        paged_kernel: str = "fused",      # paged attention: "fused" (the
                                          # ragged kernel) | "reference"
                                          # (the gather composition)
        prefix_cache: bool = True,
        kv_quant: Optional[str] = None,   # "int8" = int8 KV cache
    ) -> None:
        self.device = resolve_device(device)
        self.config = config
        self.max_slots = max_slots
        self.decode_chunk = max(1, decode_chunk)
        self.max_seq_len = min(max_seq_len or config.max_seq_len, config.max_seq_len)
        self.prefill_buckets = sorted(prefill_buckets or self._default_buckets())
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv layout {kv_layout!r}")
        if paged_kernel not in model_lib.PAGED_KERNELS:
            raise ValueError(f"unknown paged kernel {paged_kernel!r}")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unknown kv cache quantization {kv_quant!r}")
        self.kv_quant = kv_quant == "int8"
        self.kv_layout = kv_layout
        self.paged = kv_layout == "paged"
        self.paged_kernel = paged_kernel if self.paged else None
        self.prefix_cache = prefix_cache
        model_lib.validate_family_params(config, params)
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
            # host-authoritative block tables [slots, max_blocks]; rows are
            # uploaded per dispatch (0 = the null block)
            self._block_tables = np.zeros((max_slots, self.max_blocks), dtype=np.int32)
            self.cache = model_lib.init_paged_cache(
                config, self.num_blocks, self.block_size, kv_quant=self.kv_quant,
                device=self.device,
            )
        else:
            self.cache = model_lib.init_cache(
                config, max_slots, self.max_seq_len, kv_quant=self.kv_quant, device=self.device
            )
            if prefix_cache:
                logger.info(
                    "prefix_cache on the dense layout: the cross-slot prefix "
                    "copy is not ported yet, so dense prompts prefill cold"
                )
        # per-slot generated-token counts for presence/frequency penalties
        self._counts = torch.zeros(
            (max_slots, config.vocab_size), dtype=torch.int32, device=self.device
        )
        self.slots = [_Slot() for _ in range(max_slots)]
        self.base_seed = seed
        self._seed_sequence = 0
        self._queue: "queue.Queue[Optional[GenerationRequest]]" = queue.Queue()
        self._pending: List[GenerationRequest] = []  # owned by the engine thread
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._crashed: Optional[BaseException] = None
        self.stats = self._fresh_stats()

    @staticmethod
    def _fresh_stats() -> Dict[str, Any]:
        return {
            "requests": 0,
            "prefill_calls": 0,
            "decode_steps": 0,
            "decode_time": 0.0,   # wall secs inside decode chunks
            "prefill_time": 0.0,  # wall secs inside prefill calls
            "ttft_time": 0.0,     # summed submit → first-token secs of
                                  # finished requests
            "warm_prefill_calls": 0,     # prefills at an offset (prefix hits)
            "prefix_hits": 0,            # admissions onto a cached prefix
            "prefix_tokens_reused": 0,   # prompt tokens those did not prefill
            # every call into the model, by model function
            "model_dispatches": {},
        }

    def reset_stats(self) -> None:
        self.stats = self._fresh_stats()

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

    def submit(self, request: GenerationRequest) -> None:
        """Enqueue a request; safe from any thread. Its ``future`` (an
        asyncio future with ``loop`` set, or a concurrent.futures.Future)
        receives the :class:`GenerationResult`."""
        if self._crashed is not None:
            raise RuntimeError("decode engine crashed") from self._crashed
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
        request._submit_ts = time.perf_counter()  # type: ignore[attr-defined]
        self._queue.put(request)
        if self._crashed is not None:
            self._fail_all_pending()

    async def generate(
        self,
        prompt_tokens: List[int],
        sampling_params: SamplingParams,
        *,
        stop_tokens: Optional[Set[int]] = None,
        on_token: Optional[Callable[[int, bool], None]] = None,
        handle: Optional[List[GenerationRequest]] = None,
    ) -> GenerationResult:
        """Asyncio entry: submit and await the result. Pass ``handle``
        (an empty list) to receive the live request, whose ``cancel()``
        ends generation at the next token boundary."""
        loop = asyncio.get_running_loop()
        future: "asyncio.Future[GenerationResult]" = loop.create_future()
        request = GenerationRequest(
            prompt_tokens=list(prompt_tokens),
            sampling=sampling_params,
            stop_tokens=stop_tokens or set(),
            on_token=on_token,
            future=future,
            loop=loop,
        )
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
                while self._running:
                    self._drain_queue(
                        block=not self._any_active() and not self._pending
                    )
                    if not self._running:
                        break
                    if self._pending and any(not s.active for s in self.slots):
                        # admission linger: let a burst land so prefill
                        # batches fill up
                        time.sleep(0.003)
                        self._drain_queue(block=False)
                    self._admit()
                    if self._any_active():
                        self._process_decode(self._dispatch_decode())
        except BaseException as exc:  # noqa: BLE001 — fail every waiter, re-raise
            logger.exception("engine loop crashed")
            self._crashed = exc
            self._running = False
            self._fail_all_pending()
            raise

    def _any_active(self) -> bool:
        return any(slot.active for slot in self.slots)

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
        """Move pending requests into free slots. Cold requests sharing a
        prompt bucket are prefilled in one batched call (FIFO; a request
        in another bucket starts the next round); a prompt longer than the
        largest bucket is prefilled at once in windows."""
        if any(r.cancelled for r in self._pending):
            keep = []
            for request in self._pending:
                if request.cancelled:
                    self._resolve_cancelled(request)
                else:
                    keep.append(request)
            self._pending = keep
        if self.paged:
            return self._admit_paged()
        largest = self.prefill_buckets[-1]
        while self._pending:
            batch: List[Tuple[int, GenerationRequest]] = []
            bucket: Optional[int] = None
            free = [i for i, slot in enumerate(self.slots) if not slot.active]
            while self._pending and free:
                request = self._pending[0]
                if len(request.prompt_tokens) > largest:
                    self._pending.pop(0)
                    index = free.pop(0)
                    self.slots[index].request = request  # reserve the slot
                    self._prefill_long(index, request, 0)
                    continue
                size = _bucket(len(request.prompt_tokens), self.prefill_buckets)
                if bucket is None:
                    bucket = size
                elif size != bucket:
                    break
                self._pending.pop(0)
                index = free.pop(0)
                self.slots[index].request = request  # reserve the slot
                batch.append((index, request))
            if not batch:
                return
            self._prefill_batch(batch, bucket)

    def _free_slot(self) -> Optional[int]:
        for i, slot in enumerate(self.slots):
            if not slot.active:
                return i
        return None

    def _admit_paged(self) -> None:
        """Paged admission. Block-granular matching against the prefix
        cache: shared blocks are referenced through the table, never
        copied, so a shared system or RAG prefix survives any slot
        turnover. Every request reserves its worst case up front; when
        the pool (after LRU eviction) cannot cover it, the request stays
        pending until running requests release blocks.

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
                index = self._free_slot()
                if index is None:
                    break
                request = self._pending[0]
                # probe the resume offset without committing, so the
                # cold-bucket grouping can end the round before any block
                # moves (match() only touches LRU ticks); the probe's match
                # is handed to _paged_reserve so the chain walk runs once
                prompt_len = len(request.prompt_tokens)
                probe_match = None
                probe = 0
                if self.prefix_cache:
                    probe_match = self.kv_manager.match(request.prompt_tokens)
                    probe = probe_match[1]
                    while probe >= prompt_len:
                        probe -= self.block_size
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
                resume = self._paged_reserve(index, request, probe_match)
                if resume is None:
                    # pool exhausted even after eviction: every block is
                    # referenced by running work — wait for releases
                    break
                self._pending.pop(0)
                self.slots[index].request = request  # reserve the slot
                if needs_long:
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

    def _paged_reserve(
        self,
        index: int,
        request: GenerationRequest,
        match: Optional[Tuple[List[int], int]],
    ) -> Optional[int]:
        """Commit pool blocks for a request before it is admitted: the
        prefix chain ``match`` found (None with the prefix cache off),
        referenced, plus fresh blocks up to its worst case. Returns the
        resume offset (prompt tokens already in the pool), or None when
        the pool cannot cover the reservation."""
        slot = self.slots[index]
        manager = self.kv_manager
        size = self.block_size
        prompt = request.prompt_tokens
        need_tokens = min(len(prompt) + request.sampling.max_new_tokens, self.max_seq_len)
        need_blocks = -(-need_tokens // size)
        matched: List[int] = []
        matched_tokens = 0
        if match is not None:
            # the admission probe already walked the chain; nothing can
            # change it between probe and commit
            matched, matched_tokens = list(match[0]), match[1]
        # re-prefill at least the last prompt token so fresh logits exist
        # for the first sample
        while matched and matched_tokens >= len(prompt):
            matched.pop()
            matched_tokens -= size
        manager.ref(matched)
        fresh = manager.allocate(need_blocks - len(matched))
        if fresh is None:
            manager.release(matched)
            return None
        slot.blocks = matched + fresh
        if matched_tokens:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_reused"] += matched_tokens
            manager.stats["hit_tokens"] += matched_tokens
        if self.prefix_cache and not matched_tokens:
            # publish a fully cold prompt's blocks now so same-round
            # duplicates share them: the cold batch (or long prefill) that
            # writes them dispatches before any warm suffix of this round.
            # Partially matched prompts publish their tail at finish.
            manager.publish(prompt, slot.blocks)
        table = self._block_tables[index]
        table[:] = 0
        table[: len(slot.blocks)] = slot.blocks
        return matched_tokens

    def _assign_slot(self, index: int, request: GenerationRequest) -> None:
        slot = self.slots[index]
        slot.request = request
        slot.generated = []
        slot.logprobs = []
        slot.history = list(request.prompt_tokens)
        slot.length = len(request.prompt_tokens)
        slot.epoch += 1

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

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def _sampling_inputs(self, requests: List[Optional[GenerationRequest]]):
        """Per-row sampling tensors on the device, plus the host-known
        tiers (any stochastic row, any truncated row)."""
        rows = [r.sampling if r is not None else SamplingParams() for r in requests]
        temperature = np.asarray([s.temperature for s in rows], dtype=np.float32)
        top_k = np.asarray([s.top_k for s in rows], dtype=np.int64)
        top_p = np.asarray([s.top_p for s in rows], dtype=np.float32)
        seeds = np.asarray(
            [self._request_seed(r) if r is not None else 0 for r in requests],
            dtype=np.int64,
        )
        bias_ids, bias_vals = self._bias_rows(requests)
        tiers = dict(
            stochastic=bool((temperature > 0).any()),
            truncated=bool((top_k > 0).any() or (top_p > 0).any()),
        )
        tensors = [
            self._to_device(a)
            for a in (temperature, top_k, top_p, seeds, bias_ids, bias_vals)
        ]
        return tensors, tiers

    def _count_dispatch(self, name: str) -> None:
        dispatches = self.stats["model_dispatches"]
        dispatches[name] = dispatches.get(name, 0) + 1

    def _table_rows(self, slot_ids: np.ndarray) -> torch.Tensor:
        return self._to_device(self._block_tables[slot_ids])

    def _prefill_at_offset(self, tokens, lengths, offsets, slot_ids) -> torch.Tensor:
        """One prefill-at-offset model call on either layout; host arrays
        in, logits [B, V] out."""
        args = (self._to_device(tokens), self._to_device(lengths), self._to_device(offsets))
        if self.paged:
            self._count_dispatch("paged_prefill_at_offset")
            return model_lib.paged_prefill_at_offset(
                self.config, self.params, self.cache, *args,
                self._table_rows(slot_ids), self.freqs, kernel=self.paged_kernel,
            )
        self._count_dispatch("prefill_at_offset")
        return model_lib.prefill_at_offset(
            self.config, self.params, self.cache, *args,
            self._to_device(slot_ids), self.freqs,
        )

    def _sample_first(
        self,
        requests: List[GenerationRequest],
        slot_ids: np.ndarray,
        logits: torch.Tensor,
        positions: np.ndarray,
    ) -> Tuple[List[int], List[float]]:
        """First-token sampling after a prefill. ``positions`` is each
        row's total cache length, so a warm continuation samples exactly
        like a cold run of the same full prompt. Resets the slots'
        penalty counts, then counts the sampled token."""
        (temperature, top_k, top_p, seeds, bias_ids, bias_vals), tiers = (
            self._sampling_inputs(requests)
        )
        adjusted = logits.scatter_add(1, bias_ids, bias_vals)
        key = prng.sampling_keys(seeds, self._to_device(positions))
        sampled = sampling.sample(adjusted, temperature, top_k, key, top_p, **tiers)
        lps = sampling.token_logprob(logits, sampled)
        slots_d = self._to_device(slot_ids)
        self._counts[slots_d] = 0
        self._counts.index_put_(
            (slots_d, sampled), torch.ones_like(sampled, dtype=torch.int32),
            accumulate=True,
        )
        return sampled.cpu().tolist(), lps.cpu().tolist()

    def _prefill_batch(
        self, batch: List[Tuple[int, GenerationRequest]], bucket: int
    ) -> None:
        """Cold prefills with the first token sampled in the same call,
        then emitted. Groups split to power-of-two sizes."""
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
            if self.paged:
                self._count_dispatch("paged_prefill")
                logits = model_lib.paged_prefill(
                    self.config, self.params, self.cache, self._to_device(tokens),
                    self._to_device(lengths), self._table_rows(slot_ids), self.freqs,
                    kernel=self.paged_kernel,
                )
            else:
                self._count_dispatch("prefill")
                logits = model_lib.prefill(
                    self.config, self.params, self.cache, self._to_device(tokens),
                    self._to_device(lengths), self._to_device(slot_ids), self.freqs,
                )
            firsts, lps = self._sample_first(
                [request for _, request in group], slot_ids, logits, lengths
            )
            self.stats["prefill_calls"] += 1
            self.stats["prefill_time"] += time.perf_counter() - started
            for row, (index, _) in enumerate(group):
                self._emit_token(index, firsts[row], lps[row])

    def _prefill_warm_batch(
        self, batch: List[Tuple[int, GenerationRequest, int]], bucket: int
    ) -> None:
        """Admissions onto a cached prefix that share a suffix bucket: one
        prefill-at-offset call writes every suffix. Groups split to
        power-of-two sizes, like cold prefill."""
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
                self._assign_slot(index, request)
            logits = self._prefill_at_offset(tokens, lengths, offsets, slot_ids)
            firsts, lps = self._sample_first(
                [request for _, request, _ in group], slot_ids, logits, offsets + lengths
            )
            self.stats["warm_prefill_calls"] += 1
            self.stats["prefill_time"] += time.perf_counter() - started
            for row, (index, _, _) in enumerate(group):
                self._emit_token(index, firsts[row], lps[row])

    def _prefill_long(self, index: int, request: GenerationRequest, reused: int) -> None:
        """Chunked prefill of a prompt (or suffix past a cached prefix)
        longer than the largest bucket: one prefill-at-offset call per
        window of :func:`long_prefill_windows`. Only the final window's
        sample is kept."""
        prompt = request.prompt_tokens
        self._assign_slot(index, request)
        started = time.perf_counter()
        slot_ids = np.asarray([index], dtype=np.int64)
        for offset, bucket in long_prefill_windows(len(prompt), reused, self.prefill_buckets):
            chunk = prompt[offset:offset + bucket]
            tokens = np.zeros((1, bucket), dtype=np.int64)
            tokens[0, : len(chunk)] = chunk
            lengths = np.asarray([len(chunk)], dtype=np.int32)
            offsets = np.asarray([offset], dtype=np.int32)
            logits = self._prefill_at_offset(tokens, lengths, offsets, slot_ids)
        firsts, lps = self._sample_first([request], slot_ids, logits, offsets + lengths)
        self.stats["warm_prefill_calls" if reused else "prefill_calls"] += 1
        self.stats["prefill_time"] += time.perf_counter() - started
        self._emit_token(index, firsts[0], lps[0])

    def _dispatch_decode(self) -> Dict[str, Any]:
        """Run one K-step decode chunk over every slot. Tokens, lengths
        and counts chain on the device from step to step; the chunk's
        sampled tokens cross to the host once at the end."""
        started = time.perf_counter()
        slots = self.max_slots
        tokens = np.zeros((slots,), dtype=np.int64)
        lengths = np.zeros((slots,), dtype=np.int32)
        active = np.zeros((slots,), dtype=bool)
        presence = np.zeros((slots,), dtype=np.float32)
        frequency = np.zeros((slots,), dtype=np.float32)
        epochs = [0] * slots
        steps = self.decode_chunk
        for i, slot in enumerate(self.slots):
            lengths[i] = slot.length
            epochs[i] = slot.epoch
            if slot.active:
                active[i] = True
                tokens[i] = slot.history[-1]
                lengths[i] = slot.length + 1
                presence[i] = slot.request.sampling.presence_penalty
                frequency[i] = slot.request.sampling.frequency_penalty
                # a chunk writes cache positions up to length + steps - 1:
                # drop to single steps near the context boundary
                if self.max_seq_len - slot.length - 1 < steps:
                    steps = 1
        (temperature, top_k, top_p, seeds, bias_ids, bias_vals), tiers = (
            self._sampling_inputs(
                [slot.request if slot.active else None for slot in self.slots]
            )
        )
        tokens_d = self._to_device(tokens)
        lengths_d = self._to_device(lengths)
        active_d = self._to_device(active)
        presence_d = self._to_device(presence)[:, None]
        frequency_d = self._to_device(frequency)[:, None]
        rows = torch.arange(slots, device=self.device)
        active_counts = active_d.to(torch.int32)
        tables_d = self._to_device(self._block_tables) if self.paged else None
        out_tokens, out_lps = [], []
        for _ in range(steps):
            if self.paged:
                self._count_dispatch("paged_decode_step")
                logits = model_lib.paged_decode_step(
                    self.config, self.params, self.cache, tokens_d, lengths_d,
                    tables_d, self.freqs, write_mask=active_d, kernel=self.paged_kernel,
                )
            else:
                self._count_dispatch("decode_step")
                logits = model_lib.decode_step(
                    self.config, self.params, self.cache, tokens_d, lengths_d,
                    self.freqs, write_mask=active_d,
                )
            # presence/frequency penalties over generated tokens
            counts = self._counts
            adjusted = logits - presence_d * (counts > 0) - frequency_d * counts
            adjusted = adjusted.scatter_add(1, bias_ids, bias_vals)
            key = prng.sampling_keys(seeds, lengths_d)
            sampled = sampling.sample(
                adjusted, temperature, top_k, key, top_p, **tiers
            )
            # logprob under the RAW untruncated distribution
            lps = sampling.token_logprob(logits, sampled)
            sampled = torch.where(active_d, sampled, torch.zeros_like(sampled))
            self._counts.index_put_((rows, sampled), active_counts, accumulate=True)
            lengths_d = torch.where(active_d, lengths_d + 1, lengths_d)
            tokens_d = sampled
            out_tokens.append(sampled)
            out_lps.append(lps)
        return {
            "out_tokens": torch.stack(out_tokens, dim=1).cpu().numpy(),
            "out_lps": torch.stack(out_lps, dim=1).cpu().numpy(),
            "active": active,
            "epochs": epochs,
            "steps": steps,
            "started": started,
        }

    def _process_decode(self, chunk: Dict[str, Any]) -> None:
        steps = chunk["steps"]
        self.stats["decode_steps"] += steps
        self.stats["decode_time"] += time.perf_counter() - chunk["started"]
        out, lps = chunk["out_tokens"], chunk["out_lps"]
        for i, slot in enumerate(self.slots):
            if not chunk["active"][i] or slot.epoch != chunk["epochs"][i]:
                continue
            for j in range(steps):
                if not slot.active:
                    # finished mid-chunk: surplus tokens discarded; the
                    # length stopped at the stop, so later rows are dead
                    break
                slot.length += 1
                self._emit_token(i, int(out[i, j]), float(lps[i, j]))

    def _emit_token(self, index: int, token: int, logprob: float = 0.0) -> None:
        """Record a newly generated token for a slot; finish if stopping."""
        slot = self.slots[index]
        request = slot.request
        if not slot.generated:
            request._first_token_ts = time.perf_counter()  # type: ignore[attr-defined]
        slot.generated.append(token)
        slot.logprobs.append(logprob)
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
        if generated and generated[-1] in request.stop_tokens:
            generated = generated[:-1]
            logprobs = logprobs[:-1]
        result = GenerationResult(
            tokens=generated,
            prompt_tokens=len(request.prompt_tokens),
            finish_reason=reason,
            logprobs=logprobs,
        )
        self.stats["requests"] += 1
        submitted = getattr(request, "_submit_ts", None)
        if submitted is not None:
            self.stats["ttft_time"] += request._first_token_ts - submitted
        if self.paged and slot.blocks is not None:
            if self.prefix_cache:
                # publish the completed prefix (prompt + generated): only
                # rows actually IN the cache (the final sampled token is
                # never written), full blocks only. The chain outlives the
                # slot, refcounted by the map, until LRU eviction needs it
                self.kv_manager.publish(slot.history[: slot.length], slot.blocks)
            self.kv_manager.release(slot.blocks)
            slot.blocks = None
            self._block_tables[index, :] = 0
        slot.request = None
        slot.epoch += 1
        slot.generated = None
        slot.logprobs = None
        slot.history = None
        slot.length = 0
        if request.future is not None:
            self._post_future(request, result)

    def _resolve_cancelled(self, request: GenerationRequest) -> None:
        """Resolve a request cancelled before it reached a slot."""
        self.stats["requests"] += 1
        if request.future is not None:
            self._post_future(
                request,
                GenerationResult(
                    tokens=[], prompt_tokens=len(request.prompt_tokens),
                    finish_reason="cancelled",
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

        def fail(request: GenerationRequest) -> None:
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

        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._pending.append(item)
        for request in self._pending:
            fail(request)
        self._pending = []
        for slot in self.slots:
            if slot.active:
                fail(slot.request)
                slot.request = None
