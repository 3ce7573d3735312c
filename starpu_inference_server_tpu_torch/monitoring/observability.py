"""RuntimeObservability: the tracer + metrics aggregate injected through
the pipeline.

Reference counterpart: ``RuntimeObservability``
(src/monitoring/runtime_observability.hpp:14-18) — a shared aggregate of
BatchingTraceLogger + MetricsRecorder handed to every component.

Counterpart of ``starpu_inference_server_tpu/monitoring/observability.py``,
unchanged.
"""

from __future__ import annotations

from typing import Optional

from ..core.job import InferenceJob
from ..utils.config import RuntimeConfig
from .metrics import MetricsRecorder, NullMetricsRecorder
from .trace import BatchingTraceLogger, NullTraceLogger


class RuntimeObservability:
    def __init__(self, metrics=None, tracer: Optional[BatchingTraceLogger] = None):
        self.metrics = metrics if metrics is not None else NullMetricsRecorder()
        self.tracer = tracer if tracer is not None else NullTraceLogger()
        self._congested = False

    # -- pipeline hooks ----------------------------------------------------

    def set_warmup_suppressed(self, suppressed: bool) -> None:
        self.tracer.set_warmup_suppressed(suppressed)

    def on_queue_size(self, size: int, capacity: int) -> None:
        self.metrics.on_queue_size(size, capacity)
        self.tracer.log_queue_sample(size)

    def on_request_enqueued(self, job: InferenceJob, queue_size: int) -> None:
        self.metrics.requests_received.inc()
        self.tracer.log_request_enqueued(job, queue_size)

    def on_rejection(self, request_id: str) -> None:
        self.metrics.requests_rejected.inc()
        self.tracer.log_rejection(request_id)

    def set_congested(self, congested: bool) -> None:
        self._congested = congested

    def record_job(self, job: InferenceJob) -> None:
        self.metrics.record_job(job)
        if job.is_batched_master:
            self.tracer.log_batch_executed(job, self._congested)

    def on_congestion_snapshot(self, snap) -> None:
        self._congested = snap.congested
        self.metrics.on_congestion_snapshot(snap)

    def flush(self) -> None:
        self.tracer.flush()


def create_observability(cfg: RuntimeConfig, expose_metrics: bool = True) -> RuntimeObservability:
    metrics = None
    if cfg.metrics_enabled:
        metrics = MetricsRecorder(
            port=cfg.metrics_port if expose_metrics else None,
            model_name=cfg.name,
        )
    tracer = None
    if cfg.trace_enabled:
        tracer = BatchingTraceLogger(cfg.trace_output or f"/tmp/{cfg.name}_trace")
    return RuntimeObservability(metrics=metrics, tracer=tracer)
