"""Per-job timing: 11 monotonic timestamps -> 12-field latency breakdown.

Counterpart of ``starpu_inference_server_tpu/core/timing.py``, unchanged.

Reference counterpart: ``detail::TimingInfo`` + ``compute_latency_breakdown``
(src/core/inference_runner.hpp:30-73, .cpp:185-222) and the per-request
``server_*_ms`` response fields (src/proto/grpc_service.proto:823-908).

Phase mapping (the reference's writer-contract per thread,
inference_runner.hpp:397-409, is preserved — each field has exactly one
writing thread):

  enqueued_at          gRPC handler, at queue push
  dequeued_at          batch-collector thread, at queue pop
  batch_collect_start  batch-collector thread
  batch_collect_end    batch-collector thread
  before_submit_at     drain side, when the prepared batch is handed to a lane
  lane_start_at        lane thread picks the batch up ("scheduling" ends)
  codelet_start_at     lane thread, staging+dispatch begins (the "codelet")
  inference_start_at   model call dispatched to the device
  codelet_end_at       outputs on the host (the lane's stream synchronised)
  callback_start_at    result dispatcher begins fan-out
  callback_end_at      per-request completions done
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..utils.clock import now_s


@dataclasses.dataclass
class TimingInfo:
    enqueued_at: Optional[float] = None
    last_enqueued_at: Optional[float] = None
    dequeued_at: Optional[float] = None
    batch_collect_start: Optional[float] = None
    batch_collect_end: Optional[float] = None
    before_submit_at: Optional[float] = None
    lane_start_at: Optional[float] = None
    codelet_start_at: Optional[float] = None
    inference_start_at: Optional[float] = None
    codelet_end_at: Optional[float] = None
    callback_start_at: Optional[float] = None
    callback_end_at: Optional[float] = None

    def stamp(self, field: str) -> float:
        t = now_s()
        setattr(self, field, t)
        return t

    def copy_from(self, other: "TimingInfo") -> None:
        for f in dataclasses.fields(self):
            value = getattr(other, f.name)
            if value is not None:
                setattr(self, f.name, value)


def _delta_ms(a: Optional[float], b: Optional[float]) -> float:
    if a is None or b is None:
        return 0.0
    return max(0.0, (b - a) * 1000.0)


def compute_latency_breakdown(t: TimingInfo) -> Dict[str, float]:
    """Phase durations in ms, mirroring the reference's
    queue/batch/submit/scheduling/codelet/inference/callback/total split
    (inference_runner.cpp:185-222)."""
    return {
        "queue_ms": _delta_ms(t.enqueued_at, t.dequeued_at),
        "batch_ms": _delta_ms(t.batch_collect_start, t.batch_collect_end),
        "submit_ms": _delta_ms(t.batch_collect_end, t.before_submit_at),
        "scheduling_ms": _delta_ms(t.before_submit_at, t.lane_start_at),
        "codelet_ms": _delta_ms(t.codelet_start_at, t.codelet_end_at),
        "inference_ms": _delta_ms(t.inference_start_at, t.codelet_end_at),
        "callback_ms": _delta_ms(t.callback_start_at, t.callback_end_at),
        "total_ms": _delta_ms(t.enqueued_at, t.callback_end_at),
    }
