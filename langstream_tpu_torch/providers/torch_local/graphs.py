"""The step runner: the engine's decode chunks, mixed steps and prefill
calls, one CUDA graph per variant.

Port of the JAX engine's unit of dispatch
(``langstream_tpu/providers/jax_local/engine.py``): a decode chunk there
is one jitted program per step count (``_get_decode``, a ``lax.scan`` of
K decode + sample steps, cached in ``_decode_fns``), a mixed step one per
width (``_get_mixed``, ``_mixed_fns``), a prefill one per bucket, cold
(``_get_prefill``) or at an offset (``_get_prefill_offset``), compiled
once per power-of-two group size; ``_variant_jobs`` lists every variant
and ``precompile`` builds them all before traffic. Here a
:class:`Variant` is one ``torch.cuda.CUDAGraph`` of the engine's step
body, which the engine thread replays with one launch instead of
enqueueing a thousand from Python.

The JAX program picks its sampling tier on the device (``lax.cond``); a
graph cannot branch, so the host-known tier (:data:`TIERS`) is part of
the key and a greedy batch never pays the [S, V] sort. A prefill is two
graphs replayed back to back: the model call, keyed (kind, bucket,
group), writes the logits, and a first-token graph, keyed (group, tier),
samples them; so the tier does not multiply the prefill lattice.

The runner keeps ``Variant -> (graph, static inputs, static outputs)``:

- **Static inputs and outputs are allocated by the runner, outside the
  graphs' pool.** The captured body ends by copying its results into the
  static outputs, so a replay overwrites only the runner's own buffers,
  never memory another graph uses as scratch.
- **All of a runner's graphs share one memory pool.** They replay on one
  stream and never at the same time, and no tensor of the pool outlives a
  replay, so one variant's scratch is free for the next.
- **Staging.** :meth:`StepRunner.run` takes every input by name: a host
  array is copied into a fresh pinned buffer and from there into the
  static input without blocking (PyTorch's pinned-memory cache reuses
  that buffer only once the upload is done, so staging never waits for
  the card, however many runs are queued); a device tensor (a carried
  output of the previous step, a prefill's logits) is copied into it on
  the device. Either copy is enqueued before the replay, so it reads
  the previous replay's outputs before this one overwrites them. A
  caller that keeps an output past the next :meth:`run` of the same
  variant must copy it first.
- **Capture.** A variant is captured on first use (as a jit compiles on
  first use) or at the engine's ``precompile``: the body runs once on the
  capture stream, then once under capture. At ``precompile`` it runs on
  the engine's dummy inputs. On first use a decode or mixed variant runs
  on its all-inactive dummy (which leaves the cache, but for the paged
  null block, and the penalty counts as they were); a variant that
  ``warm_on_call`` names (prefill: its dummy writes a real slot's rows)
  runs on the call's own inputs instead, which its body may run twice
  on: it writes the same rows and counts again. A capture that fails
  raises, naming the variant; nothing falls back to eager dispatch. A
  capture runs on the runner's own stream in ``thread_local`` mode
  (:func:`capture`), so a rebuilt engine captures while other threads
  live. :meth:`StepRunner.release` drops every graph and buffer when the
  engine supervisor retires the engine.

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
    sampling ``tier``; "prefill" or "prefill_offset" (the model call of a
    cold prefill or one at an offset, ``group`` rows of a ``size``-token
    bucket, no tier), or "first_token" (the first-token sampling of
    ``group`` rows at ``tier``, no size)."""

    kind: str
    size: int
    tier: str = ""
    group: int = 0


@contextlib.contextmanager
def capture(graph: Any, pool: Any = None, stream: Any = None):
    """``torch.cuda.graph`` in ``thread_local`` capture mode, with
    Python's cyclic garbage collector held off. The mode: a capture
    forbids unsafe CUDA calls (a device synchronize, a blocking query)
    from the capturing thread only, so a rebuilt engine's ``precompile``
    can capture while the server's threads, the watchdog and a condemned
    engine's thread live (the default ``global`` mode would fail the
    capture on any of them). The capture stream is the runner's own, not
    the legacy default stream, so no other thread's work joins it. The
    collector: a collection during the capture may free another,
    unreachable engine's graphs, and destroying a graph while a stream
    captures invalidates the capture (cuBLAS then reports the failure at
    its next product)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
            yield
    finally:
        if enabled:
            gc.enable()


@dataclasses.dataclass
class _Entry:
    body: Callable[[Tensors], Tensors]
    inputs: Tensors
    outputs: Tensors = dataclasses.field(default_factory=dict)
    graph: Optional[Any] = None


class StepRunner:
    """Runs the engine's step variants through static buffers: as CUDA
    graphs on the card, as the same body run eagerly on the CPU or with
    ``graphs=False``.

    ``body(key)`` returns the variant's step, a function from a dict of
    input tensors to a dict of output tensors; ``dummy(key)`` its inputs
    as host arrays (they fix the static inputs' shapes and dtypes);
    ``warm_on_call(key)`` whether a variant first met in :meth:`run`
    warms up on the call's own inputs instead of its dummy."""

    def __init__(
        self,
        device: torch.device,
        *,
        graphs: bool,
        body: Callable[[Variant], Callable[[Tensors], Tensors]],
        dummy: Callable[[Variant], Dict[str, np.ndarray]],
        warm_on_call: Callable[[Variant], bool] = lambda key: False,
    ) -> None:
        self.device = device
        self.graphed = graphs and device.type == "cuda"
        self._body = body
        self._dummy = dummy
        self._warm_on_call = warm_on_call
        self._entries: Dict[Variant, _Entry] = {}
        # one pool and one capture stream for every graph of this runner
        self.pool = torch.cuda.graph_pool_handle() if self.graphed else None
        self._stream = torch.cuda.Stream(device) if self.graphed else None
        # captures (uncaptured: warm-up runs) and their seconds, replays
        # (uncaptured: runs of the body), in all and by variant kind
        self.stats: Dict[str, Any] = {"captured": 0, "capture_s": 0.0, "replayed": 0, "kinds": {}}

    def release(self) -> None:
        """Drop every variant: its graph reset (the graph's share of the
        pool handed back), its static inputs and outputs freed, and the
        pool handle itself. The caller first waits for the work the
        graphs have queued; the runner captures afresh if used again."""
        for entry in self._entries.values():
            if entry.graph is not None:
                entry.graph.reset()
        self._entries.clear()
        self.pool = torch.cuda.graph_pool_handle() if self.graphed else None

    @property
    def variants(self) -> List[Variant]:
        """The variants captured (or, uncaptured, warmed up) so far."""
        return list(self._entries)

    def prepare(self, key: Variant) -> None:
        """Capture ``key`` now on its dummy inputs, if it is not yet."""
        if key not in self._entries:
            self._entries[key] = self._capture(key, self._dummy(key))

    def run(self, key: Variant, inputs: Inputs) -> Tuple[Tensors, Tensors]:
        """One step of ``key`` on ``inputs`` (every input by name: host
        arrays, or device tensors such as a carried output). Returns the
        device inputs it ran on and its outputs: the static buffers, which
        the next run of the same variant overwrites."""
        if key not in self._entries:
            self._entries[key] = self._capture(
                key, inputs if self._warm_on_call(key) else self._dummy(key))
        entry = self._entries[key]
        self.stats["replayed"] += 1
        self._kind(key)["replayed"] += 1
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
        fresh pinned buffers, device tensors on the device (a tensor that
        is the static input itself stays)."""
        if inputs.keys() != entry.inputs.keys():
            raise ValueError(
                f"step inputs {sorted(inputs)} do not match the variant's {sorted(entry.inputs)}")
        for name, value in inputs.items():
            static = entry.inputs[name]
            source = torch.from_numpy(value) if isinstance(value, np.ndarray) else value
            if source.shape != static.shape or source.dtype != static.dtype:
                raise ValueError(
                    f"step input {name}: {source.dtype} {tuple(source.shape)}, the variant takes "
                    f"{static.dtype} {tuple(static.shape)}")
            if isinstance(value, np.ndarray):
                if self.device.type == "cuda":
                    source = source.pin_memory()
                static.copy_(source, non_blocking=True)
            elif value is not static:
                static.copy_(value)

    def _kind(self, key: Variant) -> Dict[str, Any]:
        return self.stats["kinds"].setdefault(
            key.kind, {"captured": 0, "capture_s": 0.0, "replayed": 0})

    def _capture(self, key: Variant, inputs: Inputs) -> _Entry:
        """Warm ``key``'s body up on ``inputs`` and capture it."""
        started = time.perf_counter()
        try:
            entry = self._warm_and_capture(key, inputs)
        except Exception as exc:
            raise RuntimeError(f"capturing step variant {key} failed: {exc}") from exc
        seconds = time.perf_counter() - started
        for stats in (self.stats, self._kind(key)):
            stats["captured"] += 1
            stats["capture_s"] += seconds
        return entry

    def _warm_and_capture(self, key: Variant, inputs: Inputs) -> _Entry:
        body = self._body(key)
        entry = _Entry(body=body, inputs={
            name: torch.empty(tuple(value.shape), device=self.device, dtype=(
                torch.from_numpy(value).dtype if isinstance(value, np.ndarray) else value.dtype))
            for name, value in inputs.items()
        })
        self._stage(entry, inputs)
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
