"""TaskRunner: the serving-pipeline orchestrator.

Counterpart of ``starpu_inference_server_tpu/serving/runner.py``. The
staging slots are pinned host memory when the engine runs on CUDA.

Reference counterpart: ``StarPUTaskRunner``
(src/starpu_task_worker/starpu_task_worker.{hpp,cpp}) which owns the
BatchCollector, SlotManager and ResultDispatcher, assigns monotonic
submission ids, and converges every failure path into a dispatched
completion. Here the StarPU task submission becomes a lane-scheduler
pick + lane deque push; the prepared-job drain thread disappears because
the collector hands prepared masters directly to the scheduler (one
fewer hop; queueing happens in the lane deques where the backlog
actually lives).
"""

from __future__ import annotations

import itertools
import threading
from typing import Optional

from ..core.engine import ModelEngine
from ..core.job import InferenceJob
from ..core.slot_pool import SlotPool
from ..utils.config import RuntimeConfig
from ..utils.logger import get_logger
from .collector import BatchCollector, InflightTracker
from .dispatcher import ResultDispatcher
from .lanes import ExecutionLane, LaneScheduler
from .queue import InferenceQueue
from .strategies import StrategyInput, make_batching_strategy

DRAIN_TIMEOUT_S = 30.0  # reference: server_main_shutdown_runtime.hpp / warmup.cpp:38
# warmup gets longer: the first batch of a path builds its CUDA kernels
WARMUP_DRAIN_TIMEOUT_S = 300.0


class TaskRunner:
    def __init__(
        self,
        cfg: RuntimeConfig,
        engine: ModelEngine,
        queue: InferenceQueue,
        observability=None,
        congestion_monitor=None,
    ):
        self.cfg = cfg
        self.engine = engine
        self.queue = queue
        self.observability = observability
        self.congestion_monitor = congestion_monitor
        self._submission_ids = itertools.count()

        self.inflight = InflightTracker(cfg.max_inflight_tasks)
        self.slot_pool = SlotPool(
            engine.staging_specs(),
            engine.effective_bucket(cfg.max_batch_size),
            cfg.pool_size,
            pin_memory=engine.device.type == "cuda",
        )
        self.strategy = make_batching_strategy(cfg)

        self.dispatcher = ResultDispatcher(
            self.inflight,
            on_prepared_drained=self._note_prepared_drained,
            on_job_metrics=self._record_job_metrics,
        )

        self.lanes = [
            ExecutionLane(lane_id, engine, self.slot_pool, cfg, self._on_lane_complete)
            for lane_id in range(cfg.devices.lanes_per_device)
        ]
        self.scheduler = LaneScheduler(self.lanes, cfg.devices.scheduler)

        self.collector = BatchCollector(
            cfg,
            queue,
            self.strategy,
            self.inflight,
            sample_provider=self._sample_strategy_input,
            on_prepared=self._process_prepared_job,
        )
        self._started = False

    # -- wiring ------------------------------------------------------------

    def _sample_strategy_input(self) -> StrategyInput:
        congested = False
        ewma_fill = None
        tick = -1
        if self.congestion_monitor is not None:
            snap = self.congestion_monitor.snapshot()
            congested = snap.congested
            ewma_fill = snap.ewma_queue_fill
            tick = snap.tick
        return StrategyInput(
            queue_size=self.queue.size(),
            queue_capacity=self.queue.capacity,
            prepared_depth=self.collector.prepared_depth,
            inflight=self.inflight.count(),
            max_inflight=self.cfg.max_inflight_tasks,
            congested=congested,
            ewma_queue_fill=ewma_fill,
            monitor_tick=tick,
        )

    def _note_prepared_drained(self) -> None:
        self.collector.note_prepared_drained()

    def _record_job_metrics(self, job: InferenceJob) -> None:
        if self.observability is not None:
            self.observability.record_job(job)
        if self.congestion_monitor is not None and not job.is_warmup:
            total = job.latency_breakdown.get("total_ms", 0.0)
            self.congestion_monitor.record_completion(total)

    def _process_prepared_job(self, master: InferenceJob) -> None:
        """reference: process_prepared_job,
        starpu_task_worker_prepared_job_processor.hpp:16-71."""
        if master.cancelled and all(j.cancelled for j in master.sub_jobs):
            self.inflight.decrement()
            self.collector.note_prepared_drained()
            for job in (master, *master.sub_jobs):
                self.dispatcher.handle_cancelled_job(job)
            return
        master.submission_id = next(self._submission_ids)
        master.timing.stamp("before_submit_at")
        lane = self.scheduler.pick(master)
        lane.submit(master)

    def _on_lane_complete(self, master, outputs, error, lane) -> None:
        self.dispatcher.complete(master, outputs, error, lane)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for lane in self.lanes:
            lane.start()
        self.collector.start()

    def stop(self, drain: bool = True) -> None:
        """Graceful stop: close queue for push, drain, stop threads,
        rethrow any captured thread exception (reference:
        run_shutdown_sequence, server_main_shutdown_runtime.hpp:254-290)."""
        log = get_logger()
        self.queue.close_for_push()
        if drain:
            target = self.queue.total_pushed
            if not self.dispatcher.wait_for_drain(target, DRAIN_TIMEOUT_S):
                log.warn(
                    "drain timeout: completed=%d target=%d",
                    self.dispatcher.completed_jobs,
                    target,
                )
        self.queue.shutdown()
        self.collector.stop()
        for lane in self.lanes:
            lane.stop()
        self.collector.join(timeout=5.0)
        for lane in self.lanes:
            lane.join(timeout=5.0)
        self.slot_pool.close()

    # -- warmup ------------------------------------------------------------

    def warmup(self, requests_per_bucket: Optional[int] = None) -> int:
        """Pre-serving warmup: prime every bucket (kernel builds, cuDNN
        algorithm choice), then push pinned jobs through every lane so
        the whole pipeline path is hot (reference: WarmupRunner,
        warmup.cpp:493-613 — jobs pinned per worker via
        set_fixed_worker_id).

        Returns the number of warmup jobs executed.
        """
        import numpy as np

        from ..utils.input_generator import generate_inputs

        n_req = requests_per_bucket or self.cfg.warmup_request_nb
        self.engine.prime_all()
        if not self._started:
            self.start()

        rng = np.random.default_rng(self.cfg.seed)
        done = threading.Event()
        remaining = [0]
        lock = threading.Lock()

        def completion(job, outputs, error):
            with lock:
                remaining[0] -= 1
                if remaining[0] <= 0:
                    done.set()

        jobs = []
        for lane_index in range(len(self.lanes)):
            for bucket in self.engine.buckets:
                for _ in range(n_req):
                    inputs = generate_inputs(self.cfg.inputs, bucket, rng)
                    jobs.append(
                        InferenceJob(
                            inputs,
                            request_id=f"warmup-l{lane_index}-b{bucket}",
                            completion=completion,
                            fixed_lane_id=lane_index,
                            is_warmup=True,
                        )
                    )
        with lock:
            remaining[0] = len(jobs)
        if self.observability is not None:
            self.observability.set_warmup_suppressed(True)
        try:
            for job in jobs:
                job.timing.stamp("enqueued_at")
                master = job
                master.is_batched_master = True
                master.effective_batch = job.batch_size()
                master.bucket_size = self.cfg.bucket_for(master.effective_batch)
                self.inflight.wait_below_cap(lambda: False)
                self.inflight.increment()
                self.collector.note_prepared()
                self._process_prepared_job(master)
            if not done.wait(timeout=WARMUP_DRAIN_TIMEOUT_S):
                from ..utils.exceptions import WarmupTimeoutError

                raise WarmupTimeoutError(
                    f"warmup did not drain within {WARMUP_DRAIN_TIMEOUT_S}s"
                )
        finally:
            if self.observability is not None:
                self.observability.set_warmup_suppressed(False)
        return len(jobs)
