"""The step runner: the engine's decode chunks and mixed steps, one CUDA
graph per variant.

Port of the JAX engine's unit of dispatch
(``langstream_tpu/providers/jax_local/engine.py``): a decode chunk there
is one jitted program per step count (``_get_decode``, a ``lax.scan`` of
K decode + sample steps, cached in ``_decode_fns``), a mixed step one per
width (``_get_mixed``, ``_mixed_fns``); ``_variant_jobs`` lists every
variant and ``precompile`` builds them all before traffic. Here a
:class:`Variant` (kind, size, sampling tier) is one ``torch.cuda.CUDAGraph``
of the engine's step body, which the engine thread replays with one
launch instead of enqueueing a thousand from Python.

The JAX program picks its sampling tier on the device (``lax.cond``); a
graph cannot branch, so the host-known tier (:data:`TIERS`) is part of
the key and a greedy batch never pays the [S, V] sort.

The runner keeps ``Variant -> (graph, static inputs, static outputs)``:

- **Static inputs and outputs are allocated by the runner, outside the
  graphs' pool.** The captured body ends by copying its results into the
  static outputs, so a replay overwrites only the runner's own buffers,
  never memory another graph uses as scratch.
- **All of a runner's graphs share one memory pool.** They replay on one
  stream and never at the same time, and no tensor of the pool outlives a
  replay, so one variant's scratch is free for the next.
- **Staging.** :meth:`StepRunner.run` takes every input by name: a host
  array goes through a pinned buffer the runner owns (two sets a
  variant, used in turns, so a buffer is never rewritten while its last
  upload may still be queued) into the static input without blocking; a
  device tensor (a carried output of the previous step) is copied into it
  on the device. Either copy is enqueued before the replay, so it reads
  the previous replay's outputs before this one overwrites them. A
  caller that keeps an output past the next :meth:`run` of the same
  variant must copy it first.
- **Capture.** A variant is captured on first use (as a jit compiles on
  first use) or at the engine's ``precompile``: the body runs once on the
  capture stream on the engine's all-inactive dummy inputs (which leave
  the cache, but for the paged null block, and the penalty counts as
  they were), then once under capture. A capture that fails raises,
  naming the variant; nothing falls back to eager dispatch.

A replay runs no Python: the kernel wrappers count the launches they
enqueue at the warm-up and the capture, never at a replay. What a
replayed step launched, the kernels count on the card
(``ops/launches.py``).

On the CPU (the tests), and with ``graphs=False`` (the engine's
``step_graphs=False``, the card's eager control), nothing is captured:
the runner runs the same body eagerly into the same static buffers, and
a "replay" runs it again, so the staging is exercised and a replay
overwrites the last one's outputs just as a graph's does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

# sampling tier -> (stochastic, truncated), the flags of sampling.sample:
# greedy rows only; some row samples; some sampled row truncates (the sort)
TIERS = {"greedy": (False, False), "plain": (True, False), "truncated": (True, True)}

Tensors = Dict[str, torch.Tensor]
Inputs = Dict[str, Union[np.ndarray, torch.Tensor]]


def sampling_tier(stochastic: bool, truncated: bool) -> str:
    """The tier of a batch from its host-known flags (any row sampled,
    any row truncated); truncation only matters where a row samples."""
    if not stochastic:
        return "greedy"
    return "truncated" if truncated else "plain"


class Variant(NamedTuple):
    """One step program: ``kind`` "decode" (a chunk of ``size`` decode +
    sample steps) or "mixed" (one mixed step ``size`` tokens wide), at
    sampling ``tier``."""

    kind: str
    size: int
    tier: str


@contextlib.contextmanager
def capture(graph: Any, pool: Any = None, stream: Any = None):
    """``torch.cuda.graph`` with Python's cyclic garbage collector held
    off: a collection during the capture may free another, unreachable
    engine's graphs, and destroying a graph while a stream captures is a
    call the capture forbids, which invalidates it (cuBLAS then reports
    the failure at its next product)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            yield
    finally:
        if enabled:
            gc.enable()


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of a host array on ``device``. On the card the copy goes
    through pinned memory without blocking, so an upload never waits for
    the work already queued (a pageable one syncs the stream)."""
    tensor = torch.from_numpy(array)
    if device.type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.clone()


@dataclasses.dataclass
class _Entry:
    body: Callable[[Tensors], Tensors]
    inputs: Tensors
    outputs: Tensors = dataclasses.field(default_factory=dict)
    graph: Optional[Any] = None
    # two sets of pinned staging buffers, used in turns, and the event
    # recorded after each set's last uploads
    pinned: List[Tensors] = dataclasses.field(default_factory=lambda: [{}, {}])
    staged: List[Any] = dataclasses.field(default_factory=lambda: [None, None])
    turn: int = 0


class StepRunner:
    """Runs the engine's step variants through static buffers: as CUDA
    graphs on the card, as the same body run eagerly on the CPU or with
    ``graphs=False``.

    ``body(key)`` returns the variant's step, a function from a dict of
    input tensors to a dict of output tensors; ``dummy(key)`` its inputs
    as host arrays of every row inactive (they fix the static inputs'
    shapes and dtypes)."""

    def __init__(
        self,
        device: torch.device,
        *,
        graphs: bool,
        body: Callable[[Variant], Callable[[Tensors], Tensors]],
        dummy: Callable[[Variant], Dict[str, np.ndarray]],
    ) -> None:
        self.device = device
        self.graphed = graphs and device.type == "cuda"
        self._body = body
        self._dummy = dummy
        self._entries: Dict[Variant, _Entry] = {}
        # one pool and one capture stream for every graph of this runner
        self.pool = torch.cuda.graph_pool_handle() if self.graphed else None
        self._stream = torch.cuda.Stream(device) if self.graphed else None
        # captures (uncaptured: warm-up runs) and their seconds, replays
        # (uncaptured: runs of the body)
        self.stats: Dict[str, Any] = {"captured": 0, "capture_s": 0.0, "replayed": 0}

    def prepare(self, key: Variant) -> None:
        """Capture ``key`` now, if it is not yet."""
        if key not in self._entries:
            self._entries[key] = self._capture(key)

    def run(self, key: Variant, inputs: Inputs) -> Tuple[Tensors, Tensors]:
        """One step of ``key`` on ``inputs`` (every input by name: host
        arrays, or device tensors such as a carried output). Returns the
        device inputs it ran on and its outputs: the static buffers, which
        the next run of the same variant overwrites."""
        if key not in self._entries:
            self._entries[key] = self._capture(key)
        entry = self._entries[key]
        self.stats["replayed"] += 1
        self._stage(entry, inputs)
        if entry.graph is None:
            for name, value in entry.body(entry.inputs).items():
                entry.outputs[name].copy_(value)
        else:
            entry.graph.replay()
        return entry.inputs, entry.outputs

    # ------------------------------------------------------------------ #
    def _stage(self, entry: _Entry, inputs: Inputs) -> None:
        """Copy ``inputs`` into the static inputs, host arrays through
        this turn's pinned buffers, device tensors on the device (a
        tensor that is the static input itself stays)."""
        if inputs.keys() != entry.inputs.keys():
            raise ValueError(
                f"step inputs {sorted(inputs)} do not match the variant's {sorted(entry.inputs)}")
        host = {}
        for name, value in inputs.items():
            static = entry.inputs[name]
            source = torch.from_numpy(value) if isinstance(value, np.ndarray) else value
            if source.shape != static.shape or source.dtype != static.dtype:
                raise ValueError(
                    f"step input {name}: {source.dtype} {tuple(source.shape)}, the variant takes "
                    f"{static.dtype} {tuple(static.shape)}")
            if isinstance(value, np.ndarray):
                host[name] = source
            elif value is not static:
                static.copy_(value)
        if not host:
            return
        if self.device.type != "cuda":
            for name, source in host.items():
                entry.inputs[name].copy_(source)
            return
        turn = entry.turn
        entry.turn ^= 1
        if entry.staged[turn] is not None:
            # the uploads out of these buffers two stagings ago (done long
            # since: the step between them was processed on the host)
            entry.staged[turn].synchronize()
        pinned = entry.pinned[turn]
        for name, source in host.items():
            buffer = pinned.get(name)
            if buffer is None:
                buffer = pinned[name] = torch.empty(
                    source.shape, dtype=source.dtype, pin_memory=True)
            buffer.copy_(source)
            entry.inputs[name].copy_(buffer, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        entry.staged[turn] = event

    def _capture(self, key: Variant) -> _Entry:
        """Warm ``key``'s body up on its dummy inputs and capture it."""
        started = time.perf_counter()
        try:
            entry = self._warm_and_capture(key)
        except Exception as exc:
            raise RuntimeError(f"capturing step variant {key} failed: {exc}") from exc
        self.stats["captured"] += 1
        self.stats["capture_s"] += time.perf_counter() - started
        return entry

    def _warm_and_capture(self, key: Variant) -> _Entry:
        body = self._body(key)
        dummy = self._dummy(key)
        entry = _Entry(body=body, inputs={
            name: torch.empty(array.shape, dtype=torch.from_numpy(array).dtype, device=self.device)
            for name, array in dummy.items()
        })
        self._stage(entry, dummy)
        if not self.graphed:
            # the warm-up run alone (kernel loads, cuBLAS first use)
            entry.outputs = {name: torch.empty_like(value)
                             for name, value in body(entry.inputs).items()}
            return entry
        # warm up on the capture stream: the kernels' modules load and
        # cuBLAS takes its workspace for that stream outside the pool
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            warm = body(entry.inputs)
        current.wait_stream(self._stream)
        entry.outputs = {name: torch.empty_like(value) for name, value in warm.items()}
        del warm
        graph = torch.cuda.CUDAGraph()
        with capture(graph, pool=self.pool, stream=self._stream):
            for name, value in body(entry.inputs).items():
                entry.outputs[name].copy_(value)
        entry.graph = graph
        return entry
