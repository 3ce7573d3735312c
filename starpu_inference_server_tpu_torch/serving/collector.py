"""BatchCollector: the batching thread.

Counterpart of ``starpu_inference_server_tpu/serving/collector.py``,
unchanged.

Reference counterpart: ``BatchCollector``
(src/starpu_task_worker/batch_collector_component.{hpp,cpp}):

- ``wait_for_next_job`` blocks on the inflight cap FIRST (backpressure
  when inflight >= max_inflight_tasks; .cpp:248-266), then pops;
- ``collect_batch`` asks the strategy for {target_batch_limit,
  coalesce_timeout_ms} and pulls more jobs until limit / deadline /
  non-mergeable job, stashing the first non-mergeable job as
  ``pending_job_`` (.cpp:278-339);
- ``maybe_build_batched_job`` designates jobs[0] as master, aggregates
  timing metadata, attaches sub-jobs (copy deferred to lane staging) and
  records batch efficiency (.cpp:405-473);
- inflight is incremented at prepared-enqueue and decremented at
  terminal completion (.cpp:532-549).

Batch composition policy (can two jobs merge) follows
src/starpu_task_worker/batch_composition_policy.cpp: same input names,
dtypes and trailing (per-sample) shapes; jobs pinned to a fixed lane are
never merged.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from ..core.job import InferenceJob
from ..utils.clock import now_s
from ..utils.config import RuntimeConfig
from ..utils.logger import get_logger
from .queue import InferenceQueue
from .strategies import BatchingStrategy, StrategyInput


def can_merge(a: InferenceJob, b: InferenceJob) -> bool:
    """Batch-composition policy (reference:
    TensorBatchCompositionPolicy::can_merge)."""
    if b.fixed_lane_id is not None or a.fixed_lane_id is not None:
        return False
    if set(a.inputs) != set(b.inputs):
        return False
    for name, arr_a in a.inputs.items():
        arr_b = b.inputs[name]
        if arr_a.dtype != arr_b.dtype:
            return False
        if arr_a.shape[1:] != arr_b.shape[1:]:
            return False
    return True


class InflightTracker:
    """Inflight-task accounting with a backpressure wait
    (reference: InflightContext, batch_collector_component.cpp:248-266)."""

    def __init__(self, max_inflight: int):
        self.max_inflight = max_inflight
        self._count = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)

    def count(self) -> int:
        with self._lock:
            return self._count

    def increment(self) -> None:
        with self._lock:
            self._count += 1

    def decrement(self) -> None:
        with self._cond:
            if self._count <= 0:
                raise RuntimeError("inflight underflow")
            self._count -= 1
            self._cond.notify_all()

    def wait_below_cap(self, stop: Callable[[], bool], poll_s: float = 0.05) -> None:
        with self._cond:
            while self._count >= self.max_inflight and not stop():
                self._cond.wait(timeout=poll_s)


class BatchCollector:
    """Owns the batching thread; emits prepared (batched) master jobs."""

    def __init__(
        self,
        cfg: RuntimeConfig,
        queue: InferenceQueue,
        strategy: BatchingStrategy,
        inflight: InflightTracker,
        sample_provider: Callable[[], StrategyInput],
        on_prepared: Callable[[InferenceJob], None],
    ):
        self._cfg = cfg
        self._queue = queue
        self._strategy = strategy
        self._inflight = inflight
        self._sample_provider = sample_provider
        self._on_prepared = on_prepared
        self._pending_job: Optional[InferenceJob] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._exception: Optional[BaseException] = None
        self.prepared_depth = 0
        self._depth_lock = threading.Lock()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run_loop, name="batch-collector", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        if self._exception is not None:
            raise self._exception

    # -- the batching loop ------------------------------------------------

    def _run_loop(self) -> None:
        """reference: batching_loop, batch_collector_component.cpp:578-617"""
        log = get_logger()
        try:
            while not self._stop.is_set():
                first = self._wait_for_next_job()
                if first is None:
                    if self._queue.is_shutdown and self._pending_job is None:
                        break
                    continue
                batch = self._collect_batch(first)
                master = self._build_batched_job(batch)
                self._inflight.increment()
                self.note_prepared()
                self._on_prepared(master)
        except BaseException as exc:  # noqa: BLE001 - captured for rethrow at join
            self._exception = exc
            log.error("batch collector thread failed: %s", exc)
            self._stop.set()

    def note_prepared(self) -> None:
        with self._depth_lock:
            self.prepared_depth += 1

    def note_prepared_drained(self) -> None:
        with self._depth_lock:
            self.prepared_depth = max(0, self.prepared_depth - 1)

    def _wait_for_next_job(self) -> Optional[InferenceJob]:
        # backpressure: hold collection while at the inflight cap
        self._inflight.wait_below_cap(lambda: self._stop.is_set())
        if self._stop.is_set():
            return None
        if self._pending_job is not None:
            job, self._pending_job = self._pending_job, None
            return job
        return self._queue.wait_and_pop(timeout=0.05)

    def _collect_batch(self, first: InferenceJob) -> List[InferenceJob]:
        """reference: collect_batch, batch_collector_component.cpp:278-339"""
        first.timing.stamp("dequeued_at")
        first.timing.stamp("batch_collect_start")
        decision = self._strategy.decide(self._sample_provider())
        batch = [first]
        samples = first.batch_size()
        max_samples = min(decision.target_batch_limit, self._cfg.max_batch_size)
        if samples >= max_samples or decision.coalesce_timeout_ms <= 0:
            # still drain already-waiting mergeable jobs up to the cap
            while samples < max_samples:
                job = self._queue.try_pop()
                if job is None:
                    break
                if not self._try_admit(batch, job, samples, max_samples):
                    break
                samples += job.batch_size()
            first.timing.stamp("batch_collect_end")
            return batch

        deadline = now_s() + decision.coalesce_timeout_ms / 1000.0
        while samples < max_samples and not self._stop.is_set():
            job = self._queue.wait_for_and_pop(deadline)
            if job is None:
                break
            if not self._try_admit(batch, job, samples, max_samples):
                break
            samples += job.batch_size()
        first.timing.stamp("batch_collect_end")
        return batch

    def _try_admit(
        self,
        batch: List[InferenceJob],
        job: InferenceJob,
        samples: int,
        max_samples: int,
    ) -> bool:
        """Admit ``job`` into ``batch`` or stash it as the pending job
        (reference: pending_job_ handling + sample-cap overflow check)."""
        job.timing.stamp("dequeued_at")
        if not can_merge(batch[0], job) or samples + job.batch_size() > max_samples:
            self._pending_job = job
            return False
        batch.append(job)
        return True

    def _build_batched_job(self, batch: List[InferenceJob]) -> InferenceJob:
        """reference: maybe_build_batched_job,
        batch_collector_component.cpp:405-473 — jobs[0] is the master."""
        master = batch[0]
        master.is_batched_master = True
        master.sub_jobs = batch[1:]
        master.logical_jobs = len(batch)
        total = sum(j.batch_size() for j in batch)
        master.effective_batch = total
        master.bucket_size = self._cfg.bucket_for(total)
        # aggregate timing metadata (reference: aggregate_batch_metadata)
        enqueued = [j.timing.enqueued_at for j in batch if j.timing.enqueued_at]
        if enqueued:
            master.timing.enqueued_at = min(enqueued)
            master.timing.last_enqueued_at = max(enqueued)
        return master
