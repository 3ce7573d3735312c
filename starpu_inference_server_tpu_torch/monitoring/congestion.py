"""Congestion monitor: EWMA-smoothed utilization/fill/latency detector
with hysteresis.

Counterpart of ``starpu_inference_server_tpu/monitoring/congestion.py``:
pure host code, so the same events and ``dt`` give the same snapshots bit
for bit. Two differences in the thread around it. ``on_tick`` (a public
attribute, so a caller may chain onto it) receives every snapshot, so the
server's gauges follow each tick; the JAX server publishes a snapshot to
them only when the state changes. And the ticks fall on fixed deadlines,
each passing the time measured since the tick before as ``dt``: the JAX
loop waits a whole interval after each tick ends and passes the interval,
so under load it drifts behind the clock (18 ticks in a 1.98 s burst at
100 ms on the H100 host) and divides a late tick's events by too short a
time. A wake-up late by more than an interval skips the deadlines it
missed; it does not run them.

Reference counterpart: ``congestion::Monitor``
(src/monitoring/congestion_monitor.{hpp,cpp}, 988 LoC; formulas in
docs/congestion_detection.md:27-196). The algorithm is backend-agnostic
control math and is preserved:

each tick (tick_interval_ms):
  - swap arrival/completion/rejection counters and the latency-sample
    vector collected since the previous tick;
  - lambda = arrivals/dt, mu = completions/dt, rho = lambda/mu,
    fill = queue_size/capacity, qdot = d(queue_size)/dt;
  - p95/p99 of completion latencies;
  - EWMA-smooth each signal: s_t = alpha*x_t + (1-alpha)*s_{t-1};
  - entry condition  (rho > rho_high) OR (fill > fill_high AND qdot > 0)
    OR (p95 > slo_entry_fraction * latency_slo_ms), held for
    entry_horizon ticks -> congested;
  - exit condition (all signals below their exit levels, p95 <
    slo_exit_fraction * SLO) held for exit_horizon ticks -> clear;
  - any rejection in the tick => immediate congestion.

Consumers: the adaptive batching strategy (via StrategyInput snapshot)
and the metrics gauges.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..utils.config import CongestionSettings


@dataclasses.dataclass(frozen=True)
class CongestionSnapshot:
    tick: int = -1
    congested: bool = False
    score: float = 0.0
    ewma_lambda: float = 0.0   # arrivals/s
    ewma_mu: float = 0.0       # completions/s
    ewma_rho: float = 0.0      # utilization
    ewma_queue_fill: Optional[float] = None
    p95_ms: float = 0.0
    p99_ms: float = 0.0
    rejections: int = 0


class _Ewma:
    def __init__(self, alpha: float):
        self._alpha = alpha
        self._value: Optional[float] = None

    def update(self, x: float) -> float:
        self._value = x if self._value is None else (
            self._alpha * x + (1 - self._alpha) * self._value
        )
        return self._value

    @property
    def value(self) -> float:
        return self._value if self._value is not None else 0.0


class CongestionMonitor:
    def __init__(
        self,
        cfg: CongestionSettings,
        queue_probe: Callable[[], tuple],  # () -> (size, capacity)
        on_state_change: Optional[Callable[[bool, CongestionSnapshot], None]] = None,
        on_tick: Optional[Callable[[CongestionSnapshot], None]] = None,
    ):
        self._cfg = cfg
        self._queue_probe = queue_probe
        self._on_state_change = on_state_change
        self.on_tick = on_tick

        self._lock = threading.Lock()
        self._arrivals = 0
        self._completions = 0
        self._rejections = 0
        self._latencies: List[float] = []

        self._ewma_lambda = _Ewma(cfg.ewma_alpha)
        self._ewma_mu = _Ewma(cfg.ewma_alpha)
        self._ewma_rho = _Ewma(cfg.ewma_alpha)
        self._ewma_fill = _Ewma(cfg.ewma_alpha)

        self._congested = False
        self._entry_streak = 0
        self._exit_streak = 0
        self._tick = 0
        self._last_queue_size = 0
        self._snapshot = CongestionSnapshot()

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- ingestion (called from hot paths; cheap) --------------------------

    def record_arrival(self) -> None:
        with self._lock:
            self._arrivals += 1

    def record_completion(self, latency_ms: float) -> None:
        with self._lock:
            self._completions += 1
            self._latencies.append(latency_ms)

    def record_rejection(self) -> None:
        with self._lock:
            self._rejections += 1

    # -- tick loop ---------------------------------------------------------

    def start(self) -> None:
        if not self._cfg.enabled:
            return
        self._thread = threading.Thread(
            target=self._tick_loop, name="congestion-monitor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _tick_loop(self) -> None:
        interval_s = max(0.001, self._cfg.tick_interval_ms / 1000.0)
        last = time.monotonic()
        due = last + interval_s
        while not self._stop.wait(timeout=max(0.0, due - time.monotonic())):
            now = time.monotonic()
            self.tick(now - last)
            last = now
            due += interval_s
            late = time.monotonic() - due
            if late > 0:  # skip the deadlines already missed
                due += interval_s * math.ceil(late / interval_s)

    def tick(self, dt_s: float) -> CongestionSnapshot:
        """One evaluation step; public for deterministic tests
        (the reference uses STARPU_TESTING hooks for the same purpose)."""
        with self._lock:
            arrivals, self._arrivals = self._arrivals, 0
            completions, self._completions = self._completions, 0
            rejections, self._rejections = self._rejections, 0
            latencies, self._latencies = self._latencies, []

        queue_size, capacity = self._queue_probe()
        lam = self._ewma_lambda.update(arrivals / dt_s)
        mu = self._ewma_mu.update(completions / dt_s)
        rho = self._ewma_rho.update((arrivals / dt_s) / max(1e-9, completions / dt_s)
                                    if completions > 0 else (1.5 if arrivals > 0 else 0.0))
        fill = self._ewma_fill.update(queue_size / max(1, capacity))
        qdot = (queue_size - self._last_queue_size) / dt_s
        self._last_queue_size = queue_size

        if latencies:
            arr = np.asarray(latencies)
            p95 = float(np.percentile(arr, 95))
            p99 = float(np.percentile(arr, 99))
        else:
            p95 = p99 = 0.0

        cfg = self._cfg
        slo_entry = cfg.slo_entry_fraction * cfg.latency_slo_ms
        slo_exit = cfg.slo_exit_fraction * cfg.latency_slo_ms

        entry = (
            rho > cfg.rho_high
            or (fill > cfg.fill_high and qdot > 0)
            or (p95 > slo_entry and p95 > 0)
        )
        exit_ok = (
            rho <= cfg.rho_high
            and fill <= cfg.fill_high
            and (p95 < slo_exit or p95 == 0.0)
        )

        was = self._congested
        if rejections > 0:
            # any rejection => immediate congestion
            self._congested = True
            self._entry_streak = 0
            self._exit_streak = 0
        elif not self._congested:
            self._entry_streak = self._entry_streak + 1 if entry else 0
            if self._entry_streak >= cfg.entry_horizon_ticks:
                self._congested = True
                self._exit_streak = 0
        else:
            self._exit_streak = self._exit_streak + 1 if exit_ok else 0
            if self._exit_streak >= cfg.exit_horizon_ticks:
                self._congested = False
                self._entry_streak = 0

        score = max(
            rho / max(1e-9, cfg.rho_high),
            fill / max(1e-9, cfg.fill_high),
            (p95 / slo_entry) if slo_entry > 0 else 0.0,
        )

        self._tick += 1
        snap = CongestionSnapshot(
            tick=self._tick,
            congested=self._congested,
            score=score,
            ewma_lambda=lam,
            ewma_mu=mu,
            ewma_rho=rho,
            ewma_queue_fill=fill,
            p95_ms=p95,
            p99_ms=p99,
            rejections=rejections,
        )
        self._snapshot = snap
        if was != self._congested and self._on_state_change is not None:
            self._on_state_change(self._congested, snap)
        if self.on_tick is not None:
            self.on_tick(snap)
        return snap

    def snapshot(self) -> CongestionSnapshot:
        return self._snapshot

    @property
    def congested(self) -> bool:
        return self._congested
