"""Efficiency accounting: the roofline cost model and SLO burn rates.

The port's own copy of ``langstream_tpu/runtime/accounting.py``. Three
pieces, all host arithmetic with no dependency beyond the standard
library and the port's :class:`~langstream_tpu_torch.api.metrics.Histogram`:

- :class:`PeakSpecs`: the card's peak FLOP/s and memory rate. The
  defaults are the H100 SXM's published peaks (989e12 dense bf16 FLOP/s
  on the tensor cores, 3.35e12 B/s of HBM3); ``LANGSTREAM_PEAK_TFLOPS``
  and ``LANGSTREAM_PEAK_HBM_GBS`` override them for another card.
- :class:`CostModel`: FLOPs and HBM bytes per prefill token, decode
  chunk and mixed step, from the model config alone (layers, heads and kv
  heads, head_dim, the weights' and the KV cache's widths, the layout).
  The engine divides them by each dispatch's wall time for per-chunk
  **MFU** (model FLOP utilization) and **MBU** (memory-bandwidth
  utilization), and the cumulative sums by its busy decode time.
- :class:`SLOTracker`: multi-window (5m / 1h) burn rates of TTFT and TPOT
  targets from timestamped snapshots of the engine's latency histograms,
  and the per-stage blame of the requests that broke them.

The cost model charges MODELED work, whatever implements it. With int8
weights it counts one byte a parameter, though the port's ``qmatmul``
today casts each int8 weight to a bf16 copy before its matmul, and so
writes and reads that copy too: MBU then shows what the eager cast
costs, and a fused int8 matmul would move it. The port serves one card
with no tensor parallelism, so the JAX model's ``tp`` shard divisor is
not here (every count is the whole model's).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Mapping, Optional, Tuple

# H100 SXM published peaks: dense bf16 on the tensor cores (int8 weights
# are cast to bf16 before the matmul, so the bf16 ceiling holds), HBM3
DEFAULT_PEAK_FLOPS = 989e12
DEFAULT_PEAK_HBM_GBS = 3350.0

ENV_PEAK_TFLOPS = "LANGSTREAM_PEAK_TFLOPS"
ENV_PEAK_HBM_GBS = "LANGSTREAM_PEAK_HBM_GBS"


@dataclasses.dataclass(frozen=True)
class PeakSpecs:
    """The card's ceilings the roofline divides by."""

    flops: float = DEFAULT_PEAK_FLOPS
    hbm_bytes_per_s: float = DEFAULT_PEAK_HBM_GBS * 1e9

    @classmethod
    def from_env(cls) -> "PeakSpecs":
        tflops = os.environ.get(ENV_PEAK_TFLOPS, "")
        gbs = os.environ.get(ENV_PEAK_HBM_GBS, "")
        return cls(
            flops=float(tflops) * 1e12 if tflops else DEFAULT_PEAK_FLOPS,
            hbm_bytes_per_s=float(gbs) * 1e9 if gbs else DEFAULT_PEAK_HBM_GBS * 1e9,
        )


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Analytical FLOPs and bytes per unit of engine work, built once
    from the model config; every accessor is a few multiplies, cheap on
    the engine thread per dispatch.

    Conventions, the JAX model's:

    - matmul FLOPs: ``2 * params`` per token (embedding lookups included
      in ``params``, the standard serving approximation).
    - attention FLOPs: QK^T and AV, ``4 * ctx * heads * head_dim`` per
      token per layer. GQA shrinks the KV bytes, not the query FLOPs.
    - decode-step bytes: every weight once per step (the batch shares
      it) plus each active slot's KV history read and one row written.
    - paged layout: reads round each slot's context up to the block size,
      and the bytes depend on the kernel (``paged_kernel``): the fused
      ragged kernel (B3/B6, and B7/B8 for the mixed step) streams each
      table-addressed block once plus one int32 table word per block per
      layer; the gather composition reads the pool, writes a contiguous
      copy and reads it again, three times the rows (:meth:`kv_read_bytes`).
    - int8 weights: one byte a parameter (scales left out); int8 KV: int8
      values plus one f32 scale per (layer, position, kv head) for each
      of k and v.
    - tensor parallelism (``tp_shards`` > 1): every count is per card.
      The weights shard over tp (the whole parameter set, to the serving
      approximation), the KV cache on its kv heads and the query heads'
      FLOPs the same way, so weight bytes, KV row bytes and every FLOPs
      accessor divide by ``tp_shards``; the block tables do not (every
      rank's kernel reads them whole), and a handoff moves every rank's
      rows.
    """

    params: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    weight_bytes: int
    kv_row_bytes: int       # per token of KV history, all layers
    kv_block_size: int = 1  # paged read granularity (1 = dense)
    # the paged attention the engine dispatches: "fused" | "reference"
    # (None = the dense layout: no table to charge for)
    paged_kernel: Optional[str] = None
    # tensor-parallel ranks: the FLOPs accessors divide by it (the weight
    # and KV row bytes are divided once, at construction)
    tp_shards: int = 1

    @classmethod
    def from_model_config(
        cls,
        config: Any,
        *,
        weight_quant: Optional[str] = None,
        kv_quant: bool = False,
        kv_block_size: int = 1,
        paged_kernel: Optional[str] = None,
        tp: int = 1,
    ) -> "CostModel":
        head_dim = config.dims_per_head
        tp = max(1, int(tp))
        if kv_quant:
            kv_row_bytes = 2 * config.num_layers * config.num_kv_heads * (head_dim + 4)
        else:
            kv_row_bytes = 2 * config.num_layers * config.num_kv_heads * head_dim * 2
        params = config.num_params()
        return cls(
            params=params,
            num_layers=config.num_layers,
            num_heads=config.num_heads,
            num_kv_heads=config.num_kv_heads,
            head_dim=head_dim,
            weight_bytes=params * (1 if weight_quant == "int8" else 2) // tp,
            kv_row_bytes=kv_row_bytes // tp,
            kv_block_size=max(1, int(kv_block_size)),
            paged_kernel=paged_kernel,
            tp_shards=tp,
        )

    # ------------------------------------------------------------------ #
    # decode
    # ------------------------------------------------------------------ #
    def kv_read_tokens(self, ctx: int) -> int:
        """KV rows one slot's decode step reads at context ``ctx`` (a
        paged read touches whole blocks)."""
        block = self.kv_block_size
        return -(-ctx // block) * block if block > 1 else ctx

    def kv_read_bytes(self, kv_tokens: float) -> float:
        """Bytes to read ``kv_tokens`` (block-padded) rows of KV history,
        per the dispatched kernel: dense rows once; the fused paged kernel
        the blocks once plus one int32 table word per block per layer;
        the gather composition three times the rows plus the same words."""
        base = float(self.kv_row_bytes) * kv_tokens
        if self.paged_kernel is None:
            return base
        table_bytes = 4.0 * self.num_layers * (-(-kv_tokens // self.kv_block_size))
        if self.paged_kernel == "fused":
            return base + table_bytes
        return 3.0 * base + table_bytes

    def decode_chunk_flops(self, steps: int, active: int, kv_tokens: int, block: int = 1) -> float:
        """FLOPs of a ``steps``-step decode chunk over ``active`` slots
        whose contexts sum to ``kv_tokens`` at dispatch. ``block`` is a
        speculative step's verify width (1 + spec_k; 1 = plain decode):
        every matmul runs ``block`` positions a slot, each attending over
        the context and its own causal prefix inside the block."""
        in_block = active * block * (block - 1) / 2.0
        per_step = (
            2.0 * self.params * active * block
            + 4.0 * (kv_tokens * block + in_block) * self.num_heads * self.head_dim
            * self.num_layers
        )
        return per_step * steps / self.tp_shards

    def decode_chunk_bytes(self, steps: int, active: int, kv_tokens: int, block: int = 1) -> float:
        """Bytes of a decode chunk: the weights once a step, each slot's
        kernel-aware KV read (``kv_tokens`` already block-padded on the
        paged layout) and ``block`` rows written a slot a step. A verify
        block shares the step's weight pass and KV read."""
        per_step = (
            float(self.weight_bytes)
            + self.kv_read_bytes(kv_tokens)
            + float(self.kv_row_bytes) * active * block
        )
        return per_step * steps

    def kv_handoff_bytes(self, tokens: int) -> float:
        """Bytes a paged-KV handoff moves for ``tokens`` rows of history,
        block-padded (the handoff ships whole blocks), every tp rank's."""
        return float(self.kv_row_bytes) * self.tp_shards * self.kv_read_tokens(int(tokens))

    def kv_demote_bytes(self, tokens: int) -> float:
        """Device-to-host bytes to demote ``tokens`` rows into the host
        tier: the handoff's rows."""
        return self.kv_handoff_bytes(tokens)

    def kv_promote_bytes(self, tokens: int) -> float:
        """Host-to-device bytes to promote ``tokens`` rows back: the
        demotion's, the other way."""
        return self.kv_handoff_bytes(tokens)

    # ------------------------------------------------------------------ #
    # prefill
    # ------------------------------------------------------------------ #
    def prefill_flops(self, new_tokens: int, offset: int = 0) -> float:
        """FLOPs to prefill ``new_tokens`` from cache position ``offset``:
        ``2·P`` a token plus causal attention over each token's prefix
        (position p costs ``4·p·heads·head_dim`` a layer)."""
        positions_sum = new_tokens * offset + new_tokens * (new_tokens - 1) // 2
        return (
            2.0 * self.params * new_tokens
            + 4.0 * positions_sum * self.num_heads * self.head_dim * self.num_layers
        ) / self.tp_shards

    def prefill_bytes(self, new_tokens: int, offset: int = 0) -> float:
        """Bytes of a prefill call: the weights once, the kernel-aware
        prefix read and the new rows written."""
        return (
            float(self.weight_bytes)
            + self.kv_read_bytes(self.kv_read_tokens(offset))
            + float(self.kv_row_bytes) * new_tokens
        )

    # ------------------------------------------------------------------ #
    # the mixed prefill+decode step
    # ------------------------------------------------------------------ #
    def mixed_step_flops(self, decode_rows: int, decode_kv_tokens: int, prefill_windows) -> float:
        """FLOPs of one mixed step: the decode rows' one-step chunk plus
        each ``(offset, new_tokens)`` prompt window. Only live tokens
        count: the padded grid's ghost positions show as lower MFU and as
        the ``prefill_padding`` waste, never as utilization."""
        flops = self.decode_chunk_flops(1, decode_rows, decode_kv_tokens)
        for offset, new_tokens in prefill_windows:
            flops += self.prefill_flops(new_tokens, offset=offset)
        return flops

    def mixed_step_bytes(self, kv_tokens: float, rows_written: int) -> float:
        """Bytes of one mixed step: one weight pass for every row, the
        kernel-aware reads of the decode contexts and window prefixes
        (block-padded, summed in ``kv_tokens``) and the rows written."""
        return (
            float(self.weight_bytes)
            + self.kv_read_bytes(kv_tokens)
            + float(self.kv_row_bytes) * rows_written
        )

    # ------------------------------------------------------------------ #
    # utilization
    # ------------------------------------------------------------------ #
    @staticmethod
    def mfu(flops: float, wall_s: float, peaks: PeakSpecs) -> float:
        return flops / wall_s / peaks.flops if wall_s > 0 else 0.0

    @staticmethod
    def mbu(hbm_bytes: float, wall_s: float, peaks: PeakSpecs) -> float:
        return hbm_bytes / wall_s / peaks.hbm_bytes_per_s if wall_s > 0 else 0.0


# ---------------------------------------------------------------------- #
# SLO burn rates from histogram snapshots
# ---------------------------------------------------------------------- #
def count_le(snapshot: Mapping[str, float], target: float) -> float:
    """Observations at most ``target`` in a cumulative ``le``-keyed
    histogram snapshot (``Histogram.snapshot``), interpolated linearly
    inside the bucket holding ``target``. The +Inf bucket never counts
    as at most a finite target."""
    entries = sorted(
        (float("inf") if le == "+Inf" else float(le), value)
        for le, value in snapshot.items()
        if le not in ("sum", "count")
    )
    prev_upper, prev_cum = 0.0, 0.0
    for upper, cumulative in entries:
        if target <= upper:
            if upper == float("inf"):
                return prev_cum
            if upper == prev_upper:
                return cumulative
            fraction = (target - prev_upper) / (upper - prev_upper)
            return prev_cum + (cumulative - prev_cum) * max(0.0, min(1.0, fraction))
        prev_upper, prev_cum = upper, cumulative
    return prev_cum


def violation_fraction(
    now: Mapping[str, float], then: Optional[Mapping[str, float]], target: float
) -> Optional[float]:
    """Share of the observations above ``target`` between two snapshots
    of one histogram (``then`` None: since the start); None when none
    landed between them."""
    total = now.get("count", 0) - (then.get("count", 0) if then else 0)
    if total <= 0:
        return None
    ok = count_le(now, target) - (count_le(then, target) if then else 0.0)
    return max(0.0, min(1.0, (total - ok) / total))


class SLOTracker:
    """Multi-window burn rates of p95 TTFT and TPOT targets
    (``{"ttft_ms_p95": 200, "tpot_ms_p95": 30}``, either optional).

    Burn rate = the window's violation share over the error budget
    (``1 - objective``): 1.0 spends the budget exactly as fast as the SLO
    allows, above 1 predicts a breach. Computed from timestamped
    snapshots of the engine's histograms, so it agrees with what a
    Prometheus scrape of the same buckets shows. Gauges are named
    ``torch_engine_slo_*`` where the JAX tracker says ``jax_engine_slo_*``.
    """

    WINDOWS: Tuple[Tuple[str, float], ...] = (("5m", 300.0), ("1h", 3600.0))

    def __init__(
        self,
        targets: Mapping[str, Any],
        histograms: Mapping[str, Any],  # {"ttft": Histogram, "tpot": Histogram}
        *,
        objective: float = 0.95,
        snapshot_interval: float = 15.0,
    ) -> None:
        self.objective = float(objective)
        self.snapshot_interval = float(snapshot_interval)
        self.histograms = dict(histograms)
        self.targets_s: Dict[str, float] = {}
        for key in ("ttft", "tpot"):
            raw = targets.get(f"{key}_ms_p95")
            if raw and key in self.histograms:
                self.targets_s[key] = float(raw) / 1e3
        self._ring: Deque[Tuple[float, Dict[str, Dict[str, float]]]] = deque()
        # violating requests by the journey stage that dominated the
        # violated window: (kind, stage) -> requests
        self._blame: Dict[Tuple[str, str], int] = {}
        self._lock = threading.Lock()

    def tick(self, now: Optional[float] = None) -> None:
        """Take a timestamped snapshot (at most one a
        ``snapshot_interval``); called at each finish and by
        :meth:`gauges`, so a scrape alone keeps the windows current."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._ring and now - self._ring[-1][0] < self.snapshot_interval:
                return
            self._ring.append((now, {key: self.histograms[key].snapshot() for key in self.targets_s}))
            horizon = now - self.WINDOWS[-1][1] - self.snapshot_interval
            while len(self._ring) > 1 and self._ring[1][0] <= horizon:
                self._ring.popleft()

    def attribute(self, kind: str, stage: Optional[str]) -> None:
        """Book one violating request against its dominant journey stage
        (``journey.blame_stage``): a burning TTFT budget blamed on
        ``queue`` is a capacity problem, on ``prefill`` a scheduling one."""
        if not stage or kind not in ("ttft", "tpot"):
            return
        with self._lock:
            key = (kind, str(stage))
            self._blame[key] = self._blame.get(key, 0) + 1

    def _snapshot_before(self, key: str, cutoff: float) -> Optional[Dict[str, float]]:
        """The newest snapshot taken at or before ``cutoff`` (None: the
        tracker is younger than the window, which then spans it all)."""
        best = None
        for ts, snaps in self._ring:
            if ts <= cutoff:
                best = snaps.get(key)
            else:
                break
        return best

    def gauges(self, now: Optional[float] = None) -> Dict[str, float]:
        now = time.monotonic() if now is None else now
        self.tick(now)
        out: Dict[str, float] = {}
        budget = max(1e-9, 1.0 - self.objective)
        with self._lock:
            for key, target_s in self.targets_s.items():
                out[f"torch_engine_slo_{key}_p95_target_ms"] = round(target_s * 1e3, 3)
                snap_now = self.histograms[key].snapshot()
                for label, window in self.WINDOWS:
                    then = self._snapshot_before(key, now - window)
                    fraction = violation_fraction(snap_now, then, target_s)
                    if fraction is not None:
                        out[f"torch_engine_slo_{key}_burn_rate_{label}"] = round(fraction / budget, 4)
            for (kind, stage), count in sorted(self._blame.items()):
                out[f'torch_engine_slo_blame_total{{kind="{kind}",stage="{stage}"}}'] = float(count)
        return out
