"""Execution lanes: worker threads running the model on the device.

Counterpart of ``starpu_inference_server_tpu/serving/lanes.py``
(reference: StarPU's workers executing the InferenceCodelet,
starpu_setup.cpp:594-846, plus the scheduler routing tasks to them). A
lane owns a work deque, a handle on the staging slot pool and an EWMA
cost per batch bucket (for the EWMA lane-picking policy).

On the card each lane has its own ``torch.cuda.Stream`` and runs its
put, execute and fetch under ``torch.cuda.stream(lane_stream)``. The
kernel wrappers launch on ``torch.cuda.current_stream``, which is
thread-local, so they follow the lane. Two lanes on one card
(``devices.lanes_per_device: 2``, the analogue of
``STARPU_NWORKER_PER_CUDA``) overlap the host staging and copies of
batch N+1 with the device work of batch N. A slot goes back to the pool
only after the lane's stream has finished reading it (the fetch fence).
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Callable, Dict, Optional

import torch

from ..core.engine import ModelEngine
from ..core.job import InferenceJob
from ..core.slot_pool import SlotPool
from ..utils.config import RuntimeConfig, SchedulerPolicy
from ..utils.exceptions import CancelledError
from ..utils.logger import get_logger

# complete(master, outputs_or_none, error_or_none, lane)
LaneCompleteFn = Callable[[InferenceJob, Optional[dict], Optional[BaseException], "ExecutionLane"], None]


class ExecutionLane:
    def __init__(self, lane_id: int, engine: ModelEngine, slot_pool: SlotPool,
                 cfg: RuntimeConfig, complete: LaneCompleteFn):
        self.lane_id = lane_id
        self._engine = engine
        self._slot_pool = slot_pool
        self._cfg = cfg
        self._complete = complete
        self._work: deque = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._exception: Optional[BaseException] = None
        self._stream = (torch.cuda.Stream(engine.device) if engine.device.type == "cuda"
                        else None)
        # EWMA codelet cost per bucket, ms (for the EWMA scheduler policy)
        self.ewma_cost_ms: Dict[int, float] = {}
        self._ewma_alpha = 0.2
        self.executed_batches = 0

    # -- scheduling interface ---------------------------------------------

    def submit(self, master: InferenceJob) -> None:
        with self._cond:
            self._work.append(master)
            self._cond.notify()

    def backlog(self) -> int:
        with self._lock:
            return len(self._work)

    def estimated_finish_ms(self, bucket: int) -> float:
        """Backlog-aware completion estimate (the ``heft``-style metric)."""
        cost = self.ewma_cost_ms.get(bucket)
        if cost is None:
            cost = (sum(self.ewma_cost_ms.values()) / len(self.ewma_cost_ms)
                    if self.ewma_cost_ms else 1.0)
        return cost * (self.backlog() + 1)

    def name(self) -> str:
        return f"lane{self.lane_id}@{self._engine.device_name()}"

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run_loop, name=self.name(), daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        if self._exception is not None:
            raise self._exception

    # -- the lane loop ----------------------------------------------------

    def _pop(self) -> Optional[InferenceJob]:
        with self._cond:
            while not self._work and not self._stop.is_set():
                self._cond.wait(timeout=0.05)
            if self._work:
                return self._work.popleft()
            return None

    def _run_loop(self) -> None:
        log = get_logger()
        while not self._stop.is_set() or self.backlog() > 0:
            master = self._pop()
            if master is None:
                continue
            try:
                self._execute(master)
            except BaseException as exc:  # noqa: BLE001 - converge to failed completion
                # exceptions become failed-job completions, never thread
                # death (reference: submit_job_or_handle_failure)
                log.error("lane %s execution failed: %s", self.name(), exc)
                self._complete(master, None, exc, self)

    def _execute(self, master: InferenceJob) -> None:
        master.timing.stamp("lane_start_at")
        master.executed_on = self.name()
        if master.cancelled and all(j.cancelled for j in master.sub_jobs):
            self._complete(master, None, CancelledError("cancelled"), self)
            return

        # a mesh engine rounds the bucket up to its batch granularity
        bucket = self._engine.effective_bucket(
            master.bucket_size or self._cfg.bucket_for(master.batch_size()))
        slot = self._slot_pool.acquire()
        if slot is None:
            raise RuntimeError("slot pool closed")
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        try:
            master.timing.stamp("codelet_start_at")
            # stage: master first, sub-jobs at their batch offsets
            # (reference: validate_batch_and_copy_inputs)
            offset = 0
            for job in (master, *master.sub_jobs):
                for name, arr in job.inputs.items():
                    slot.write(name, offset, arr)
                offset += job.batch_size()
            with stream:
                inputs = self._engine.put_inputs(slot.view(bucket))
                master.timing.stamp("inference_start_at")
                outputs = self._engine.execute(inputs)
                # one D2H per output, then this lane's stream is fenced:
                # the slot's pinned rows have been read
                host = self._engine.fetch(outputs)
            t_end = master.timing.stamp("codelet_end_at")
        finally:
            self._slot_pool.release(slot)
        outputs = self._engine.conform_outputs(host)

        cost_ms = (t_end - master.timing.codelet_start_at) * 1000.0
        prev = self.ewma_cost_ms.get(bucket)
        self.ewma_cost_ms[bucket] = (cost_ms if prev is None
                                     else prev + self._ewma_alpha * (cost_ms - prev))
        self.executed_batches += 1
        self._complete(master, outputs, None, self)


class LaneScheduler:
    """Routes prepared batches to lanes (round-robin / least-loaded /
    EWMA, the policy module replacing StarPU's scheduler choice)."""

    def __init__(self, lanes, policy: SchedulerPolicy):
        self._lanes = list(lanes)
        self._policy = policy
        self._rr = 0
        self._lock = threading.Lock()

    def pick(self, master: InferenceJob) -> ExecutionLane:
        if master.fixed_lane_id is not None:
            # warmup pinning (reference: execute_on_a_specific_worker)
            return self._lanes[master.fixed_lane_id % len(self._lanes)]
        if self._policy is SchedulerPolicy.ROUND_ROBIN:
            with self._lock:
                lane = self._lanes[self._rr % len(self._lanes)]
                self._rr += 1
            return lane
        if self._policy is SchedulerPolicy.LEAST_LOADED:
            return min(self._lanes, key=lambda lane: lane.backlog())
        bucket = master.bucket_size or 1
        return min(self._lanes, key=lambda lane: lane.estimated_finish_ms(bucket))
