"""InferenceJob: the unit of work flowing through the pipeline.

Counterpart of ``starpu_inference_server_tpu/core/job.py``, unchanged.

Reference counterpart: ``InferenceJob`` with its four state groups —
request payload, batch state, execution state, completion state
(src/core/inference_runner.hpp:30-636). The exactly-once terminal
semantics (``CompletionState::try_mark_terminal_handled`` CAS,
inference_runner.hpp:319-324) are preserved: every outcome path —
success, failure, cancellation, submit error — funnels through
``try_mark_terminal_handled`` so a job completes exactly once even under
cancel/complete races.
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from .timing import TimingInfo

# callback(job, outputs or None, error or None)
CompletionFn = Callable[["InferenceJob", Optional[Dict[str, np.ndarray]], Optional[BaseException]], None]

_job_ids = itertools.count()


class InferenceJob:
    __slots__ = (
        "job_id",
        "request_id",
        "inputs",
        "timing",
        "sub_jobs",
        "logical_jobs",
        "effective_batch",
        "bucket_size",
        "is_batched_master",
        "submission_id",
        "fixed_lane_id",
        "executed_on",
        "is_warmup",
        "_cancelled",
        "_terminal_lock",
        "_terminal_handled",
        "_completion",
        "outputs",
        "error",
        "latency_breakdown",
    )

    def __init__(
        self,
        inputs: Dict[str, np.ndarray],
        request_id: str = "",
        completion: Optional[CompletionFn] = None,
        fixed_lane_id: Optional[int] = None,
        is_warmup: bool = False,
    ):
        self.job_id: int = next(_job_ids)
        self.request_id = request_id or f"job-{self.job_id}"
        self.inputs = inputs
        self.timing = TimingInfo()
        # batch state (reference: BatchState)
        self.sub_jobs: List[InferenceJob] = []
        self.logical_jobs: int = 1
        self.effective_batch: int = 0
        self.bucket_size: int = 0
        self.is_batched_master: bool = False
        # execution state (reference: ExecutionState)
        self.submission_id: Optional[int] = None
        self.fixed_lane_id = fixed_lane_id
        self.executed_on: Optional[str] = None
        self.is_warmup = is_warmup
        # completion state (reference: CompletionState)
        self._cancelled = threading.Event()
        self._terminal_lock = threading.Lock()
        self._terminal_handled = False
        self._completion = completion
        self.outputs: Optional[Dict[str, np.ndarray]] = None
        self.error: Optional[BaseException] = None
        self.latency_breakdown: Dict[str, float] = {}

    # -- batch sizing -----------------------------------------------------

    def batch_size(self) -> int:
        """Leading-dim sample count of this job's inputs."""
        if not self.inputs:
            return 1
        first = next(iter(self.inputs.values()))
        return int(first.shape[0]) if first.ndim > 0 else 1

    # -- cancellation -----------------------------------------------------

    def cancel(self) -> None:
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    # -- exactly-once terminal path ---------------------------------------

    def try_mark_terminal_handled(self) -> bool:
        """Atomically claim the terminal path; only the first caller wins
        (reference: CompletionState CAS, inference_runner.hpp:319-324)."""
        with self._terminal_lock:
            if self._terminal_handled:
                return False
            self._terminal_handled = True
            return True

    def run_completion(
        self,
        outputs: Optional[Dict[str, np.ndarray]],
        error: Optional[BaseException],
    ) -> None:
        """Record the outcome and invoke the one-shot completion callback.
        Caller must have won ``try_mark_terminal_handled``."""
        self.outputs = outputs
        self.error = error
        if self._completion is not None:
            fn, self._completion = self._completion, None
            fn(self, outputs, error)

