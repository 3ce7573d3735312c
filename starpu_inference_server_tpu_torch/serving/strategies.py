"""Batching strategies: disabled / fixed / adaptive.

Counterpart of ``starpu_inference_server_tpu/serving/strategies.py``,
unchanged.

Reference counterpart: ``BatchingStrategy`` and its three
implementations (src/starpu_task_worker/batching_strategy.{hpp,cpp}):

- Disabled: always batch limit 1, no coalescing (batching_strategy.cpp:48-61)
- Fixed: configured batch size + timeout (batching_strategy.cpp:359-368)
- Adaptive: a pressure-driven AIMD-like controller
  (batching_strategy.cpp:63-357): pressure is derived from the
  congestion monitor's EWMA snapshot when available, else from raw
  queue-fill and internal-backlog ratios; congestion jumps the limit to
  max; sustained high pressure steps it up; sustained low pressure steps
  it down by 1; the limit refreshes at most once per monitor tick; under
  congestion a minimum coalesce window is enforced even if the
  configured timeout is 0 (batching_strategy.cpp:10-26).

Bucket snapping: the returned ``target_batch_limit`` is additionally
snapped to the configured bucket set, because batches are padded to a
bucket (the engine primes one per bucket) — an "arbitrary" limit would
only create padding waste.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol

from ..utils.clock import now_s
from ..utils.config import BatchingStrategyKind, RuntimeConfig


@dataclasses.dataclass(frozen=True)
class StrategyInput:
    """A point-in-time pipeline sample (reference:
    RuntimeBatchingStrategyInputProvider::sample,
    batching_strategy_input_provider.cpp)."""

    queue_size: int
    queue_capacity: int
    prepared_depth: int
    inflight: int
    max_inflight: int
    congested: bool
    # congestion monitor EWMA snapshot (None when monitor disabled)
    ewma_queue_fill: Optional[float] = None
    monitor_tick: int = -1


@dataclasses.dataclass(frozen=True)
class BatchingDecision:
    target_batch_limit: int
    coalesce_timeout_ms: float


class BatchingStrategy(Protocol):
    def decide(self, sample: StrategyInput) -> BatchingDecision: ...


class DisabledBatchingStrategy:
    def decide(self, sample: StrategyInput) -> BatchingDecision:
        return BatchingDecision(target_batch_limit=1, coalesce_timeout_ms=0.0)


class FixedBatchingStrategy:
    def __init__(self, cfg: RuntimeConfig):
        self._batch = cfg.fixed_batching.batch_size
        self._timeout_ms = cfg.batch_coalesce_timeout_ms

    def decide(self, sample: StrategyInput) -> BatchingDecision:
        return BatchingDecision(self._batch, self._timeout_ms)


class AdaptiveBatchingStrategy:
    def __init__(self, cfg: RuntimeConfig):
        self._cfg = cfg
        self._knobs = cfg.adaptive_batching
        self._limit = 1
        self._low_ticks = 0
        self._last_refresh_tick = -1
        self._last_refresh_at = -1.0

    @property
    def current_limit(self) -> int:
        return self._limit

    def _pressure(self, s: StrategyInput) -> float:
        """max of external (queue fill) and internal (prepared+inflight
        backlog) pressure; EWMA fill preferred when the monitor runs."""
        if s.ewma_queue_fill is not None:
            fill = s.ewma_queue_fill
        else:
            fill = s.queue_size / max(1, s.queue_capacity)
        backlog = (s.prepared_depth + s.inflight) / max(1, s.max_inflight)
        return max(fill, min(1.0, backlog))

    def _should_refresh(self, s: StrategyInput) -> bool:
        """Refresh at most once per monitor tick; fall back to a wall
        interval when the monitor is off
        (reference: batching_strategy.cpp:194-357)."""
        if s.monitor_tick >= 0:
            if s.monitor_tick == self._last_refresh_tick:
                return False
            self._last_refresh_tick = s.monitor_tick
            return True
        t = now_s()
        interval_s = self._cfg.congestion.tick_interval_ms / 1000.0
        if self._last_refresh_at > 0 and (t - self._last_refresh_at) < interval_s:
            return False
        self._last_refresh_at = t
        return True

    def decide(self, sample: StrategyInput) -> BatchingDecision:
        knobs = self._knobs
        max_batch = self._cfg.max_batch_size

        if self._should_refresh(sample):
            pressure = self._pressure(sample)
            if sample.congested:
                # congestion: jump straight to the maximum batch
                self._limit = max_batch
                self._low_ticks = 0
            elif pressure >= knobs.pressure_high:
                step = max(1, self._limit // knobs.entry_ticks)
                if pressure >= knobs.pressure_severe:
                    step *= 2
                self._limit = min(max_batch, self._limit + step)
                self._low_ticks = 0
            elif pressure <= knobs.pressure_low:
                self._low_ticks += 1
                if self._low_ticks >= knobs.exit_horizon_ticks:
                    self._limit = max(1, self._limit - 1)
                    self._low_ticks = 0
            else:
                self._low_ticks = 0

        # snap to a primed bucket (no reference analogue)
        limit = self._cfg.bucket_for(self._limit)

        timeout_ms = self._cfg.batch_coalesce_timeout_ms if limit > 1 else 0.0
        if sample.congested:
            # keep a minimum per-slot coalesce window under congestion
            timeout_ms = max(timeout_ms, knobs.min_congested_coalesce_ms)
        return BatchingDecision(limit, timeout_ms)


def make_batching_strategy(cfg: RuntimeConfig) -> BatchingStrategy:
    """Factory (reference: make_batching_strategy, batching_strategy.cpp)."""
    if cfg.batching_strategy is BatchingStrategyKind.DISABLED:
        return DisabledBatchingStrategy()
    if cfg.batching_strategy is BatchingStrategyKind.FIXED:
        return FixedBatchingStrategy(cfg)
    return AdaptiveBatchingStrategy(cfg)
