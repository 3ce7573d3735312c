"""Prometheus metrics registry + recorder facade.

Counterpart of ``starpu_inference_server_tpu/monitoring/metrics.py``:
the same families, help strings, label sets and buckets, except the
device families, which keep the reference's CUDA names
(``gpu_device_count``, ``gpu_memory_used_bytes{device="cuda:N"}``,
``gpu_memory_total_bytes``) and read the CUDA caching allocator. Two
additions for servers that start and stop in one process: ``port=0``
binds an ephemeral port (``exposer_port`` names the bound one), and
:meth:`MetricsRecorder.close` shuts the exposer down.

Reference counterpart: ``MetricsRegistry`` / ``MetricsRecorder``
(src/monitoring/metrics.{hpp,cpp}) exposing a prometheus-cpp pull
endpoint on ``metrics_port``. Metric family names are kept identical to
the reference's so its Grafana dashboard / alert rules port over
unchanged (inference_queue_size, inference_latency_ms,
inference_batch_size, requests_rejected_total, ...); the ``starpu_*``
families map to the lane scheduler (worker == lane).

Histogram buckets follow metrics_constants.hpp:13-22 — latency 1..1000
ms, batch size 1..1024.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from ..core.job import InferenceJob
from ..utils.logger import get_logger

LATENCY_BUCKETS_MS = (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
MAX_LABEL_SERIES = 10_000  # reference: metrics_constants.hpp:24


class MetricsRecorder:
    """All counters/gauges/histograms behind one facade; a no-op twin
    (NullMetricsRecorder) stands in when metrics are disabled, mirroring
    the reference's free-function fallback API (metrics.hpp:696-760)."""

    def __init__(self, port: Optional[int] = None, model_name: str = ""):
        from prometheus_client import (
            CollectorRegistry,
            Counter,
            Gauge,
            Histogram,
            start_http_server,
        )

        self.registry = CollectorRegistry()
        self.model_name = model_name
        reg = dict(registry=self.registry)

        # -- request counters (reference: metrics.hpp:83-161) --------------
        self.requests_total = Counter("requests_total", "Requests handled", **reg)
        self.requests_received = Counter(
            "requests_received_total", "Requests received", **reg
        )
        self.requests_rejected = Counter(
            "requests_rejected_total", "Requests rejected (queue full)", **reg
        )
        self.requests_by_status = Counter(
            "requests_by_status_total", "Requests by terminal status", ["code"], **reg
        )
        self.completed_total = Counter(
            "inference_completed_total", "Completed inference jobs", **reg
        )
        self.failures_total = Counter(
            "inference_failures_total",
            "Failed jobs by stage/reason",
            ["stage", "reason", "model"],
            **reg,
        )
        self.transfer_bytes = Counter(
            "inference_transfer_bytes_total",
            "Host<->device transfer bytes",
            ["direction", "worker_id"],
            **reg,
        )

        # -- queue / pipeline gauges ---------------------------------------
        self.queue_size = Gauge("inference_queue_size", "Queue depth", **reg)
        self.max_queue_size = Gauge("inference_max_queue_size", "Queue capacity", **reg)
        self.queue_fill_ratio = Gauge(
            "inference_queue_fill_ratio", "Queue fill ratio", **reg
        )
        self.inflight = Gauge("inference_inflight_tasks", "Inflight batches", **reg)
        self.max_inflight = Gauge(
            "inference_max_inflight_tasks", "Inflight cap", **reg
        )
        self.prepared_depth = Gauge(
            "starpu_prepared_queue_depth", "Prepared (batched) jobs waiting", **reg
        )
        self.batch_pending = Gauge(
            "inference_batch_collect_pending_jobs", "Jobs held by collector", **reg
        )
        self.server_health = Gauge("server_health_state", "1 = serving", **reg)
        self.models_loaded = Gauge("models_loaded", "Loaded model count", **reg)
        self.model_load_duration = Histogram(
            "model_load_duration_ms", "Model build+prime duration",
            buckets=(10, 100, 1000, 5000, 10000, 60000), **reg
        )
        self.worker_inflight = Gauge(
            "starpu_worker_inflight_tasks", "Backlog per lane", ["worker_id"], **reg
        )

        # -- latency histograms (ms) ---------------------------------------
        h = dict(buckets=LATENCY_BUCKETS_MS, **reg)
        self.latency = Histogram("inference_latency_ms", "Total job latency", **h)
        self.queue_latency = Histogram(
            "inference_queue_latency_ms", "Queue wait", **h
        )
        self.batch_collect_latency = Histogram(
            "inference_batch_collect_ms", "Batch collect span", **h
        )
        self.submit_latency = Histogram(
            "inference_submit_latency_ms", "Prepared->submit span", **h
        )
        self.scheduling_latency = Histogram(
            "inference_scheduling_latency_ms", "Submit->lane-start span", **h
        )
        self.codelet_latency = Histogram(
            "inference_codelet_latency_ms", "Lane staging+execute span", **h
        )
        self.compute_latency = Histogram(
            "inference_compute_latency_ms", "Device execution span", **h
        )
        self.compute_latency_by_worker = Histogram(
            "inference_compute_latency_ms_by_worker",
            "Device execution span per lane",
            ["worker_id"],
            **h,
        )
        self.callback_latency = Histogram(
            "inference_callback_latency_ms", "Completion fan-out span", **h
        )
        self.preprocess_latency = Histogram(
            "inference_preprocess_latency_ms", "Request validation/convert", **h
        )
        self.postprocess_latency = Histogram(
            "inference_postprocess_latency_ms", "Response serialization", **h
        )
        self.io_copy = Histogram("inference_io_copy_ms", "Input staging copy", **h)
        self.task_runtime = Histogram("starpu_task_runtime_ms", "Lane task runtime", **h)
        self.task_runtime_by_worker = Histogram(
            "starpu_task_runtime_ms_by_worker", "Lane task runtime per lane",
            ["worker_id"], **h
        )

        # -- batch shape histograms ----------------------------------------
        self.batch_size = Histogram(
            "inference_batch_size", "Samples per executed batch",
            buckets=BATCH_BUCKETS, **reg
        )
        self.logical_batch_size = Histogram(
            "inference_logical_batch_size", "Requests per executed batch",
            buckets=BATCH_BUCKETS, **reg
        )
        self.batch_efficiency = Histogram(
            "inference_batch_efficiency_ratio",
            "effective_batch / bucket (padding efficiency)",
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0), **reg
        )

        # -- generation engine (decoder continuous batching; net-new
        # surface — the reference serves encoders only) ---------------------
        self.generated_tokens_total = Counter(
            "generation_tokens_total", "Tokens emitted by the engine", **reg
        )
        self.generation_active_slots = Gauge(
            "generation_active_slots", "Slots holding live sequences", **reg
        )
        self.generation_pending = Gauge(
            "generation_pending_requests", "Requests awaiting a slot", **reg
        )
        self.generation_ttft = Histogram(
            "generation_time_to_first_token_ms", "Submit -> first token",
            **h
        )
        self.generation_tokens_per_request = Histogram(
            "generation_tokens_per_request", "Tokens emitted per request",
            buckets=BATCH_BUCKETS, **reg
        )
        self.draft_acceptance_ratio = Gauge(
            "generation_draft_acceptance_ratio",
            "Accepted draft tokens / drafted (speculative decoding)", **reg
        )
        self.prefix_cache_hits_total = Counter(
            "generation_prefix_cache_hits_total", "Prefix-cache hits", **reg
        )
        self.prefix_tokens_reused_total = Counter(
            "generation_prefix_tokens_reused_total",
            "Prompt tokens served from resident KV rows", **reg
        )
        # engine-loop phase accounting (device-bound loops show ~all
        # time in consume-wait; host-bound loops show admit/dispatch)
        self.generation_loop_seconds = Gauge(
            "generation_loop_phase_seconds_total",
            "Cumulative engine-loop seconds by phase",
            labelnames=("phase",), **reg
        )
        self.fetch_timeouts_total = Counter(
            "generation_fetch_timeouts_total",
            "Device fetches that exceeded fetch_timeout_s (transport "
            "wedge watchdog)", **reg
        )

        # -- congestion gauges (reference: 12 congestion gauges) -----------
        self.congestion_flag = Gauge("inference_congestion_flag", "1 = congested", **reg)
        self.congestion_score = Gauge("inference_congestion_score", "Pressure score", **reg)
        self.lambda_rps = Gauge("inference_lambda_rps", "EWMA arrival rate", **reg)
        self.mu_rps = Gauge("inference_mu_rps", "EWMA completion rate", **reg)
        self.rho_ewma = Gauge("inference_rho_ewma", "EWMA utilization", **reg)
        self.queue_fill_ewma = Gauge(
            "inference_queue_fill_ratio_ewma", "EWMA queue fill", **reg
        )
        self.queue_growth = Gauge("inference_queue_growth_rate", "dq/dt", **reg)
        self.e2e_p95 = Gauge("inference_e2e_latency_p95_ms", "Tick p95 latency", **reg)
        self.e2e_p99 = Gauge("inference_e2e_latency_p99_ms", "Tick p99 latency", **reg)
        self.rejection_rate = Gauge(
            "inference_rejection_rate_rps", "Rejections per second", **reg
        )
        self.throughput = Gauge("inference_throughput_rps", "Completions/s window", **reg)

        # -- host/device sampling ------------------------------------------
        self.cpu_usage = Gauge("system_cpu_usage_percent", "Process CPU usage", **reg)
        self.rss = Gauge("process_resident_memory_bytes", "Resident set size", **reg)
        self.open_fds = Gauge("process_open_fds", "Open fd count", **reg)
        self.gpu_device_count = Gauge("gpu_device_count", "Local GPU devices", **reg)
        # the reference's NVML gauges, read from the CUDA caching allocator
        self.gpu_memory_used = Gauge(
            "gpu_memory_used_bytes", "HBM bytes in use", ["device"], **reg
        )
        self.gpu_memory_total = Gauge(
            "gpu_memory_total_bytes", "HBM bytes total", ["device"], **reg
        )

        self._exposer = None
        self.exposer_port = None
        if port is not None:
            # port 0 binds an ephemeral port; the bound one is logged
            self._exposer = start_http_server(port, registry=self.registry)
            self.exposer_port = self._exposer[0].server_address[1]
            get_logger().info("metrics exposer on :%d", self.exposer_port)

        self._sampler_stop = threading.Event()
        self._sampler: Optional[threading.Thread] = None
        self._last_cpu = (0.0, 0.0)

    # -- sampler thread (reference: metrics.hpp:764-785) -------------------

    def start_sampler(self, interval_s: float = 5.0) -> None:
        self._sampler = threading.Thread(
            target=self._sample_loop, args=(interval_s,), name="metrics-sampler",
            daemon=True,
        )
        self._sampler.start()

    def stop_sampler(self) -> None:
        self._sampler_stop.set()
        if self._sampler is not None:
            self._sampler.join(timeout=2.0)

    def close(self) -> None:
        """Stop the sampler and shut the exposer down, freeing its port
        (the JAX module never closes its exposer)."""
        self.stop_sampler()
        if self._exposer is not None:
            httpd, thread = self._exposer
            self._exposer = None
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=2.0)

    def _sample_loop(self, interval_s: float) -> None:
        while not self._sampler_stop.wait(timeout=interval_s):
            try:
                self.sample_process_stats()
            except Exception as exc:  # noqa: BLE001 - sampling must never break serving
                get_logger().warn("metrics sampler: %s: %s", type(exc).__name__, exc)

    def sample_process_stats(self) -> None:
        try:
            with open("/proc/self/statm") as fh:
                rss_pages = int(fh.read().split()[1])
            self.rss.set(rss_pages * os.sysconf("SC_PAGE_SIZE"))
            self.open_fds.set(len(os.listdir("/proc/self/fd")))
            with open("/proc/self/stat") as fh:
                parts = fh.read().split()
            ticks = (int(parts[13]) + int(parts[14])) / os.sysconf("SC_CLK_TCK")
            now = time.monotonic()
            last_t, last_ticks = self._last_cpu
            if last_t > 0 and now > last_t:
                self.cpu_usage.set(100.0 * (ticks - last_ticks) / (now - last_t))
            self._last_cpu = (now, ticks)
        except OSError:
            pass
        self.sample_device_stats()

    def sample_device_stats(self) -> None:
        """Device memory of every local card: the caching allocator's
        bytes in use (as PJRT's ``bytes_in_use``) and the card's total
        (the reference samples NVML; metrics_gpu_cpu_providers.hpp).
        Sets nothing in a process that has not initialised CUDA, so a
        CPU server leaves the device families unset, and skips a card
        whose allocator this process never used (reading its total would
        open a context there). Raises what CUDA raises; only the periodic
        sampler swallows it."""
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return
        count = torch.cuda.device_count()
        self.gpu_device_count.set(count)
        for index in range(count):
            stats = torch.cuda.memory_stats(index)
            if not stats:
                continue
            label = f"cuda:{index}"
            self.gpu_memory_used.labels(label).set(stats["allocated_bytes.all.current"])
            self.gpu_memory_total.labels(label).set(torch.cuda.mem_get_info(index)[1])

    # -- pipeline recording hooks ------------------------------------------

    def on_queue_size(self, size: int, capacity: int) -> None:
        self.queue_size.set(size)
        self.max_queue_size.set(capacity)
        self.queue_fill_ratio.set(size / max(1, capacity))

    def record_job(self, job: InferenceJob) -> None:
        """Per-terminal-job metrics (reference: record_job_metrics,
        result_dispatcher_component.cpp:407-456)."""
        lb = job.latency_breakdown
        self.completed_total.inc()
        self.latency.observe(lb.get("total_ms", 0.0))
        self.queue_latency.observe(lb.get("queue_ms", 0.0))
        self.batch_collect_latency.observe(lb.get("batch_ms", 0.0))
        self.submit_latency.observe(lb.get("submit_ms", 0.0))
        self.scheduling_latency.observe(lb.get("scheduling_ms", 0.0))
        self.codelet_latency.observe(lb.get("codelet_ms", 0.0))
        self.compute_latency.observe(lb.get("inference_ms", 0.0))
        self.callback_latency.observe(lb.get("callback_ms", 0.0))
        if job.is_batched_master:
            self.batch_size.observe(job.effective_batch or job.batch_size())
            self.logical_batch_size.observe(job.logical_jobs)
            if job.bucket_size:
                self.batch_efficiency.observe(
                    (job.effective_batch or 1) / job.bucket_size
                )
            if job.executed_on:
                self.task_runtime.observe(lb.get("codelet_ms", 0.0))
                self.task_runtime_by_worker.labels(job.executed_on).observe(
                    lb.get("codelet_ms", 0.0)
                )
                self.compute_latency_by_worker.labels(job.executed_on).observe(
                    lb.get("inference_ms", 0.0)
                )

    def record_failure(self, stage: str, reason: str) -> None:
        self.failures_total.labels(stage, reason, self.model_name).inc()

    def on_congestion_snapshot(self, snap) -> None:
        self.congestion_flag.set(1 if snap.congested else 0)
        self.congestion_score.set(snap.score)
        self.lambda_rps.set(snap.ewma_lambda)
        self.mu_rps.set(snap.ewma_mu)
        self.rho_ewma.set(snap.ewma_rho)
        if snap.ewma_queue_fill is not None:
            self.queue_fill_ewma.set(snap.ewma_queue_fill)
        self.e2e_p95.set(snap.p95_ms)
        self.e2e_p99.set(snap.p99_ms)


class NullMetricsRecorder:
    """No-op stand-in so call sites never branch."""

    def __getattr__(self, name):
        return _null_call


class _NullMetric:
    def __call__(self, *a, **k):
        return self  # chainable: .labels(...).inc() etc.

    def __getattr__(self, name):
        return _null_call


_null_call = _NullMetric()
