"""ResultDispatcher: terminal completion with exactly-once semantics.

Counterpart of ``starpu_inference_server_tpu/serving/dispatcher.py``,
unchanged: outputs arrive as host numpy arrays and are sliced per job.

Reference counterpart: ``ResultDispatcher``
(src/starpu_task_worker/result_dispatcher_component.{hpp,cpp}):

- every outcome (success / error / cancel / submit exception) converges
  to exactly one completion per job via the terminal CAS
  (dispatch_terminal_completion, .cpp:279-323);
- aggregated outputs are sliced back to each sub-job by batch offset
  (slice_outputs_for_sub_job, .cpp:678-739), timing/device info copied;
- job metrics recorded (batch size, per-lane runtime, latency breakdown,
  congestion completion; record_job_metrics .cpp:407-456);
- inflight decremented, completed_jobs bumped by the LOGICAL job count,
  and the shutdown drain notified (finalize_job_completion .cpp:485-496).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import numpy as np

from ..core.job import InferenceJob
from ..core.timing import compute_latency_breakdown
from ..utils.exceptions import CancelledError, run_with_logged_exceptions
from ..utils.perf_observer import PerfObserver
from .collector import InflightTracker


class ResultDispatcher:
    def __init__(
        self,
        inflight: InflightTracker,
        on_prepared_drained: Optional[Callable[[], None]] = None,
        on_job_metrics: Optional[Callable[[InferenceJob], None]] = None,
    ):
        self._inflight = inflight
        self._on_prepared_drained = on_prepared_drained
        self._on_job_metrics = on_job_metrics
        self.perf = PerfObserver()  # served inferences / s, warmup excluded
        self.completed_jobs = 0
        self.failed_jobs = 0
        self.cancelled_jobs = 0
        # per-batch-size aggregates for the ModelStatistics RPC
        # (reference: InferBatchStatistics, grpc_service.proto)
        self.batch_stats: Dict[int, Dict[str, float]] = {}
        self._lock = threading.Lock()
        self._drain_cond = threading.Condition(self._lock)

    # -- success/error entry point from lanes ------------------------------

    def complete(
        self,
        master: InferenceJob,
        outputs: Optional[Dict[str, "np.ndarray"]],
        error: Optional[BaseException],
        lane=None,
    ) -> None:
        master.timing.stamp("callback_start_at")
        if self._on_prepared_drained is not None:
            self._on_prepared_drained()
        try:
            if error is not None:
                self._fan_out_error(master, error)
            else:
                self._fan_out_success(master, outputs)
        finally:
            logical = master.logical_jobs
            if error is None and not master.is_warmup:
                size = master.effective_batch or master.batch_size()
                # global throughput window, warmup excluded (reference:
                # perf-observer record in record_job_metrics,
                # result_dispatcher_component.cpp:407-456)
                self.perf.record(size)
                lb = master.latency_breakdown
                with self._lock:
                    agg = self.batch_stats.setdefault(
                        size,
                        {"count": 0, "compute_input_ns": 0.0,
                         "compute_infer_ns": 0.0, "compute_output_ns": 0.0},
                    )
                    agg["count"] += 1
                    agg["compute_input_ns"] += lb.get("batch_ms", 0.0) * 1e6
                    agg["compute_infer_ns"] += lb.get("inference_ms", 0.0) * 1e6
                    agg["compute_output_ns"] += lb.get("callback_ms", 0.0) * 1e6
            with self._drain_cond:
                self.completed_jobs += logical
                if error is not None and not isinstance(error, CancelledError):
                    self.failed_jobs += logical
                self._drain_cond.notify_all()
            self._inflight.decrement()

    def handle_cancelled_job(self, job: InferenceJob) -> None:
        """Pre-submit cancellation path (reference: handle_cancelled_job,
        starpu_task_worker.cpp:688-693). Job was never prepared, so no
        inflight bookkeeping."""
        if job.try_mark_terminal_handled():
            with self._lock:
                self.cancelled_jobs += 1
                self.completed_jobs += 1
            run_with_logged_exceptions(
                lambda: job.run_completion(None, CancelledError("cancelled")),
                "cancelled-completion",
            )
            with self._drain_cond:
                self._drain_cond.notify_all()

    def fail_unsubmitted_job(self, job: InferenceJob, error: BaseException) -> None:
        """Failure before the job ever became a prepared batch (validation
        or submit exception; reference: finalize_job_after_exception)."""
        if job.try_mark_terminal_handled():
            with self._drain_cond:
                self.failed_jobs += 1
                self.completed_jobs += 1
                self._drain_cond.notify_all()
            run_with_logged_exceptions(
                lambda: job.run_completion(None, error), "failed-completion"
            )

    # -- fan-out -----------------------------------------------------------

    def _propagate_timing(self, master: InferenceJob, sub: InferenceJob) -> None:
        own_enqueued = sub.timing.enqueued_at
        sub.timing.copy_from(master.timing)
        if own_enqueued is not None:
            sub.timing.enqueued_at = own_enqueued
        sub.executed_on = master.executed_on

    def _finish_one(
        self,
        job: InferenceJob,
        outputs: Optional[Dict[str, np.ndarray]],
        error: Optional[BaseException],
    ) -> None:
        if not job.try_mark_terminal_handled():
            return
        job.timing.stamp("callback_end_at")
        job.latency_breakdown = compute_latency_breakdown(job.timing)
        if self._on_job_metrics is not None:
            run_with_logged_exceptions(
                lambda: self._on_job_metrics(job), "job-metrics"
            )
        run_with_logged_exceptions(
            lambda: job.run_completion(outputs, error), "completion-callback"
        )

    def _fan_out_success(self, master: InferenceJob, outputs) -> None:
        """Slice the batch outputs back per sub-job
        (reference: propagate_completion_to_sub_jobs)."""
        offset = 0
        for job in (master, *master.sub_jobs):
            n = job.batch_size()
            if job is not master:
                self._propagate_timing(master, job)
            if job.cancelled:
                self._finish_one(job, None, CancelledError("cancelled"))
            else:
                sliced = {
                    name: np.asarray(arr[offset : offset + n])
                    for name, arr in outputs.items()
                }
                self._finish_one(job, sliced, None)
            offset += n

    def _fan_out_error(self, master: InferenceJob, error: BaseException) -> None:
        for job in (master, *master.sub_jobs):
            if job is not master:
                self._propagate_timing(master, job)
            self._finish_one(job, None, error)

    # -- shutdown drain ----------------------------------------------------

    def wait_for_drain(self, target: int, timeout_s: float) -> bool:
        """Block until completed_jobs >= target (reference: drain until
        completed >= total_pushed with 30 s timeout,
        server_main_shutdown_runtime.hpp:126-227)."""
        from ..utils.clock import now_s

        deadline = now_s() + timeout_s
        with self._drain_cond:
            while self.completed_jobs < target:
                remaining = deadline - now_s()
                if remaining <= 0:
                    return False
                self._drain_cond.wait(timeout=remaining)
            return True
