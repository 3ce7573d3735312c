"""Global inference-throughput window, excluding warmup.

Counterpart of ``starpu_inference_server_tpu/utils/perf_observer.py``.

Reference counterpart: ``perf_observer`` (src/utils/perf_observer.{hpp,cpp})
— a window that accumulates total inferences and reports ``total /
duration`` over the span between the first and the last non-warmup
completion; warmup jobs never count. The ResultDispatcher records into
it (record_job_metrics,
src/starpu_task_worker/result_dispatcher_component.cpp:407-456) and the
server logs it at shutdown. Each dispatcher owns its window here, not
the process: two servers in one process (``chip_smoke.py`` runs one per
config) keep their counts apart.
"""

from __future__ import annotations

import threading
from typing import Optional

from .clock import now_s


class PerfObserver:
    """Throughput window: total inferences / (last - first) seconds."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total = 0
        self._first_at: Optional[float] = None
        self._last_at: Optional[float] = None

    def record(self, inferences: int) -> None:
        """Count ``inferences`` completed samples (the dispatcher leaves
        warmup jobs out)."""
        if inferences <= 0:
            return
        t = now_s()
        with self._lock:
            if self._first_at is None:
                self._first_at = t
            self._last_at = t
            self._total += inferences

    def window_s(self) -> float:
        with self._lock:
            if self._first_at is None or self._last_at is None:
                return 0.0
            return self._last_at - self._first_at

    def throughput(self) -> float:
        """Inferences per second over the observed window; 0.0 until two
        distinct completion instants exist."""
        with self._lock:
            if self._first_at is None or self._last_at is None:
                return 0.0
            span = self._last_at - self._first_at
            if span <= 0.0:
                return 0.0
            return self._total / span
