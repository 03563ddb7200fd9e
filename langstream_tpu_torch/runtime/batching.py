"""Micro-batching executors.

The port's own copy of ``langstream_tpu/runtime/batching.py``: the
reference's batching utilities
(``langstream-api/src/main/java/ai/langstream/api/util/BatchExecutor.java:30``
and ``OrderedAsyncBatchExecutor.java:39``), asyncio-native. They are the
seam where streaming per-record semantics meet the card's batch world:
the embeddings step coalesces records into one padded encoder call.

- ``BatchExecutor``: flush on size OR linger timeout, like the reference
  (size+time flush, ``BatchExecutor.java:30``). Optionally also flushes on a
  byte budget, for calls where tokens, not records, bound the batch.
- ``OrderedAsyncBatchExecutor``: N hash buckets; per bucket at most one
  in-flight async batch, so records that share a key are processed in order
  even though completion is async (``OrderedAsyncBatchExecutor.java:41-97``).
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Generic, List, Optional, Set, TypeVar

T = TypeVar("T")

AsyncBatchProcessor = Callable[[List[T]], Awaitable[None]]


class BatchExecutor(Generic[T]):
    """Flush a growing batch on size, byte budget, or linger timeout."""

    def __init__(
        self,
        batch_size: int,
        processor: AsyncBatchProcessor,
        *,
        flush_interval: float = 0.0,
        max_bytes: int = 0,
        size_of: Optional[Callable[[T], int]] = None,
    ) -> None:
        if batch_size <= 0:
            raise ValueError("batch_size must be > 0")
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self.max_bytes = max_bytes
        self.size_of = size_of
        self.processor = processor
        self._batch: List[T] = []
        self._bytes = 0
        self._timer: Optional[asyncio.TimerHandle] = None
        # the linger's flush tasks: the loop holds tasks weakly
        self._flushes: Set[asyncio.Task] = set()

    async def add(self, item: T) -> None:
        self._batch.append(item)
        if self.max_bytes and self.size_of is not None:
            self._bytes += self.size_of(item)
        if len(self._batch) >= self.batch_size or (
            self.max_bytes and self._bytes >= self.max_bytes
        ):
            await self.flush()
        elif self.flush_interval > 0 and self._timer is None:
            loop = asyncio.get_running_loop()
            self._timer = loop.call_later(self.flush_interval, self._linger_flush)

    def _linger_flush(self) -> None:
        task = asyncio.ensure_future(self.flush())
        self._flushes.add(task)
        task.add_done_callback(self._flushes.discard)

    async def flush(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if not self._batch:
            return
        batch, self._batch, self._bytes = self._batch, [], 0
        await self.processor(batch)

    async def close(self) -> None:
        await self.flush()


class OrderedAsyncBatchExecutor(Generic[T]):
    """N hash buckets, each preserving submission order with async batches.

    A record is routed to ``hash_fn(item) % buckets`` (records without a key
    hash to a rotating bucket). Within a bucket, batch *k+1* is not started
    until batch *k*'s processor coroutine completes — the property the
    reference guarantees for per-key ordered embeddings micro-batching
    (``OrderedAsyncBatchExecutor.java:39-97``, used by
    ``ComputeAIEmbeddingsStep.java:72-99``).
    """

    def __init__(
        self,
        batch_size: int,
        processor: AsyncBatchProcessor,
        *,
        buckets: int = 4,
        flush_interval: float = 0.0,
        hash_fn: Optional[Callable[[T], Optional[int]]] = None,
    ) -> None:
        if buckets <= 0:
            raise ValueError("buckets must be > 0")
        self.buckets = buckets
        self.hash_fn = hash_fn
        self._rr = 0
        self._queues: List[asyncio.Queue] = [asyncio.Queue() for _ in range(buckets)]
        self._workers: List[Optional[asyncio.Task]] = [None] * buckets
        self._executors = [
            BatchExecutor(
                batch_size,
                self._make_enqueue(i),
                flush_interval=flush_interval,
            )
            for i in range(buckets)
        ]
        self.processor = processor
        self._closing = False

    def _make_enqueue(self, bucket: int) -> AsyncBatchProcessor:
        async def enqueue(batch: List[T]) -> None:
            self._ensure_worker(bucket)
            await self._queues[bucket].put(batch)

        return enqueue

    def _ensure_worker(self, bucket: int) -> None:
        task = self._workers[bucket]
        if task is None or task.done():
            self._workers[bucket] = asyncio.get_running_loop().create_task(
                self._drain(bucket)
            )

    async def _drain(self, bucket: int) -> None:
        queue = self._queues[bucket]
        while True:
            try:
                batch = queue.get_nowait()
            except asyncio.QueueEmpty:
                if self._closing:
                    return
                try:
                    batch = await asyncio.wait_for(queue.get(), timeout=0.5)
                except asyncio.TimeoutError:
                    continue
            await self.processor(batch)
            queue.task_done()

    def _route(self, item: T) -> int:
        if self.hash_fn is not None:
            key_hash = self.hash_fn(item)
            if key_hash is not None:
                return key_hash % self.buckets
        self._rr = (self._rr + 1) % self.buckets
        return self._rr

    async def add(self, item: T) -> None:
        await self._executors[self._route(item)].add(item)

    async def flush(self) -> None:
        for executor in self._executors:
            await executor.flush()
        for queue in self._queues:
            await queue.join()

    async def close(self) -> None:
        await self.flush()
        self._closing = True
        for task in self._workers:
            if task is not None:
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
