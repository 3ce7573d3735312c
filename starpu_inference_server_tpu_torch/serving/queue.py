"""Bounded, thread-safe inference job queue.

Counterpart of ``starpu_inference_server_tpu/serving/queue.py``, unchanged.

Reference counterpart: ``InferenceQueue``
(src/starpu_task_worker/inference_queue.hpp:24-184). Contract preserved:

- ``push`` fails FAST when at capacity (no blocking) -> the gRPC layer
  maps it to RESOURCE_EXHAUSTED (inference_queue.hpp:41-69);
- ``close_for_push`` (shutdown begins: reject new work, let the drain
  finish) is distinct from full ``shutdown`` (wake all consumers);
- every size change is reported to the observability sink
  (inference_queue.hpp:161-173).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

from ..core.job import InferenceJob
from ..utils.exceptions import QueueClosedError, QueueFullError


class InferenceQueue:
    def __init__(
        self,
        max_size: int,
        on_size_change: Optional[Callable[[int, int], None]] = None,
    ):
        self._max_size = max_size
        self._items: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed_for_push = False
        self._shutdown = False
        self._on_size_change = on_size_change
        self.total_pushed = 0

    @property
    def capacity(self) -> int:
        return self._max_size

    def size(self) -> int:
        with self._lock:
            return len(self._items)

    def _notify_size(self, size: int) -> None:
        if self._on_size_change is not None:
            # observability must never break the pipeline
            from ..utils.exceptions import run_with_logged_exceptions

            run_with_logged_exceptions(
                lambda: self._on_size_change(size, self._max_size),
                "queue-size-observer",
            )

    def push(self, job: InferenceJob) -> None:
        with self._lock:
            if self._shutdown or self._closed_for_push:
                raise QueueClosedError("queue closed for push")
            if len(self._items) >= self._max_size:
                raise QueueFullError(
                    f"queue full ({self._max_size}); request rejected"
                )
            self._items.append(job)
            self.total_pushed += 1
            size = len(self._items)
            self._not_empty.notify()
        self._notify_size(size)

    def wait_and_pop(self, timeout: Optional[float] = None) -> Optional[InferenceJob]:
        """Block until a job is available; None on timeout or shutdown
        with an empty queue."""
        with self._lock:
            while not self._items:
                if self._shutdown:
                    return None
                if not self._not_empty.wait(timeout=timeout):
                    return None
            job = self._items.popleft()
            size = len(self._items)
        self._notify_size(size)
        return job

    def try_pop(self) -> Optional[InferenceJob]:
        with self._lock:
            if not self._items:
                return None
            job = self._items.popleft()
            size = len(self._items)
        self._notify_size(size)
        return job

    def wait_for_and_pop(self, deadline_s: float) -> Optional[InferenceJob]:
        """Pop with an absolute monotonic deadline — the coalesce-window
        pop (reference: wait_for_and_pop for batching deadlines)."""
        from ..utils.clock import now_s

        with self._lock:
            while not self._items:
                remaining = deadline_s - now_s()
                if remaining <= 0 or self._shutdown:
                    return None
                self._not_empty.wait(timeout=remaining)
            job = self._items.popleft()
            size = len(self._items)
        self._notify_size(size)
        return job

    def close_for_push(self) -> None:
        with self._lock:
            self._closed_for_push = True

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._closed_for_push = True
            self._not_empty.notify_all()

    @property
    def is_shutdown(self) -> bool:
        with self._lock:
            return self._shutdown
