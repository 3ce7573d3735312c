"""Batching trace logger: Chrome/Perfetto trace JSON + trace.csv +
metrics.csv.

Reference counterpart: ``BatchingTraceLogger``
(src/utils/batching_trace_logger.{hpp,cpp}, 1567 LoC). Contract kept:

- Chrome-trace-event JSON with ``request_enqueued`` instants, batch
  queue-wait spans, ``batch_build`` spans, lane execution spans with
  flow arrows from submission to the lane track, and a dedicated
  congestion track (log_congestion_span, hpp:250);
- ``trace.csv``: one row per executed batch — lane, batch size, request
  ids, arrival timestamps (us), per-phase timings, congested flag
  (SummaryWriter, hpp:259-278);
- ``metrics.csv``: queue size + cumulative rejections over time;
- warmup suppression: events inside warmup are dropped when suppressed
  (scoped_warmup_suppression; warmup rows otherwise carry a
  ``warming_`` prefix).

Counterpart of ``starpu_inference_server_tpu/monitoring/trace.py``,
unchanged: the same events, rows and files for the same jobs. The
deep-kernel tier (the reference's StarPU FXT + NVTX tiers) is
``torch.profiler`` on the card, run by the caller; this logger covers the
batching/serving tier.

The generation engine's tier is :class:`SpanTotals`: named host spans
whose seconds (and, where a reader needs it, count) add up in the engine's
``loop_timers``, each also
a ``torch.profiler`` range ``gen.<name>`` while the profiler records, and
:func:`device_range`, the ranges of the model's layers (``ops.dense``,
``ops.attn``) and :func:`ranged`, a function's. With no profiler a span
reads the clock twice and a flag once, and a layer's range reads the flag
once.
"""

from __future__ import annotations

import contextlib
import csv
import functools
import json
import os
import threading
from typing import Iterable, List, Optional

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

from ..core.job import InferenceJob
from ..utils.clock import now_s


class BatchingTraceLogger:
    def __init__(self, output_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.output_dir = output_dir
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._batch_rows: List[dict] = []
        self._metric_rows: List[dict] = []
        self._warmup_suppressed = False
        self._cum_rejections = 0
        self._epoch = now_s()
        if enabled:
            os.makedirs(output_dir, exist_ok=True)

    # -- runtime toggling (TraceSetting RPC) ---------------------------------

    def set_enabled(self, enabled: bool, output_dir: Optional[str] = None) -> None:
        """Toggle tracing at runtime (the TraceSetting RPC surface; the
        reference leaves that RPC UNIMPLEMENTED and only configures
        tracing at startup, batching_trace_logger.hpp:114+)."""
        if output_dir:
            self.output_dir = output_dir
        if enabled and not self.output_dir:
            raise ValueError("trace output directory not configured")
        if enabled:
            os.makedirs(self.output_dir, exist_ok=True)
        self.enabled = enabled

    # -- warmup suppression ------------------------------------------------

    def set_warmup_suppressed(self, suppressed: bool) -> None:
        self._warmup_suppressed = suppressed

    def _skip(self, job: Optional[InferenceJob] = None) -> bool:
        if not self.enabled:
            return True
        return self._warmup_suppressed and (job is None or job.is_warmup)

    def _us(self, t: float) -> int:
        return int((t - self._epoch) * 1e6)

    def _name(self, base: str, job: Optional[InferenceJob]) -> str:
        if job is not None and job.is_warmup:
            return f"warming_{base}"
        return base

    # -- event API ---------------------------------------------------------

    def log_request_enqueued(self, job: InferenceJob, queue_size: int) -> None:
        if self._skip(job):
            return
        with self._lock:
            self._events.append({
                "name": self._name("request_enqueued", job),
                "ph": "i", "s": "t",
                "ts": self._us(job.timing.enqueued_at or now_s()),
                "pid": 1, "tid": 0,
                "args": {"request_id": job.request_id, "queue_size": queue_size},
            })

    def log_rejection(self, request_id: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._cum_rejections += 1
            self._events.append({
                "name": "request_rejected", "ph": "i", "s": "t",
                "ts": self._us(now_s()), "pid": 1, "tid": 0,
                "args": {"request_id": request_id},
            })

    def log_queue_sample(self, size: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._metric_rows.append({
                "t_us": self._us(now_s()),
                "queue_size": size,
                "cum_rejections": self._cum_rejections,
            })

    def log_batch_executed(self, master: InferenceJob, congested: bool) -> None:
        """One executed batch: build span + lane execution span + flow
        arrow + trace.csv row."""
        if self._skip(master):
            return
        t = master.timing
        lane = master.executed_on or "?"
        request_ids = [master.request_id] + [j.request_id for j in master.sub_jobs]
        arrivals = [
            j.timing.enqueued_at for j in (master, *master.sub_jobs)
            if j.timing.enqueued_at
        ]
        flow_id = master.submission_id or master.job_id
        with self._lock:
            if t.batch_collect_start and t.batch_collect_end:
                self._events.append({
                    "name": self._name("batch_build", master), "ph": "X",
                    "ts": self._us(t.batch_collect_start),
                    "dur": max(1, self._us(t.batch_collect_end) - self._us(t.batch_collect_start)),
                    "pid": 1, "tid": 1,
                    "args": {"batch": master.effective_batch, "requests": len(request_ids)},
                })
                self._events.append({
                    "name": "submit_flow", "ph": "s", "id": flow_id,
                    "ts": self._us(t.batch_collect_end), "pid": 1, "tid": 1,
                })
            if t.codelet_start_at and t.codelet_end_at:
                self._events.append({
                    "name": self._name("batch", master), "ph": "X",
                    "ts": self._us(t.codelet_start_at),
                    "dur": max(1, self._us(t.codelet_end_at) - self._us(t.codelet_start_at)),
                    "pid": 2, "tid": hash(lane) % 1000,
                    "args": {
                        "lane": lane,
                        "batch": master.effective_batch,
                        "bucket": master.bucket_size,
                        "congested": congested,
                    },
                })
                self._events.append({
                    "name": "submit_flow", "ph": "f", "bp": "e", "id": flow_id,
                    "ts": self._us(t.codelet_start_at), "pid": 2,
                    "tid": hash(lane) % 1000,
                })
            lb = master.latency_breakdown
            self._batch_rows.append({
                "lane": lane,
                "batch_size": master.effective_batch,
                "bucket": master.bucket_size,
                "request_ids": ";".join(request_ids),
                "arrival_us": ";".join(str(self._us(a)) for a in arrivals),
                "queue_ms": round(lb.get("queue_ms", 0.0), 3),
                "batch_ms": round(lb.get("batch_ms", 0.0), 3),
                "scheduling_ms": round(lb.get("scheduling_ms", 0.0), 3),
                "codelet_ms": round(lb.get("codelet_ms", 0.0), 3),
                "inference_ms": round(lb.get("inference_ms", 0.0), 3),
                "total_ms": round(lb.get("total_ms", 0.0), 3),
                "congested": int(congested),
                "warmup": int(master.is_warmup),
            })

    def log_congestion_span(self, start_s: float, end_s: float, score: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._events.append({
                "name": "congested", "ph": "X",
                "ts": self._us(start_s),
                "dur": max(1, self._us(end_s) - self._us(start_s)),
                "pid": 3, "tid": 0, "args": {"score": round(score, 3)},
            })

    # -- flush -------------------------------------------------------------

    def flush(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            events = list(self._events)
            batch_rows = list(self._batch_rows)
            metric_rows = list(self._metric_rows)
        with open(os.path.join(self.output_dir, "batching_trace.json"), "w") as fh:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
        if batch_rows:
            with open(os.path.join(self.output_dir, "trace.csv"), "w", newline="") as fh:
                writer = csv.DictWriter(fh, fieldnames=list(batch_rows[0]))
                writer.writeheader()
                writer.writerows(batch_rows)
        if metric_rows:
            with open(os.path.join(self.output_dir, "metrics.csv"), "w", newline="") as fh:
                writer = csv.DictWriter(fh, fieldnames=list(metric_rows[0]))
                writer.writeheader()
                writer.writerows(metric_rows)


class NullTraceLogger(BatchingTraceLogger):
    def __init__(self):
        super().__init__(output_dir="", enabled=False)


# -- the generation engine's spans -------------------------------------------------

_NO_RANGE = contextlib.nullcontext()


def device_range(name: str):
    """A ``torch.profiler`` range ``name`` while the profiler records, else
    a no-op context: the ranges of the model's layers, which keep no
    totals (a layer's host time is its enqueue, not its work)."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_RANGE


def ranged(name: str):
    """Decorator: each call of the function in a :func:`device_range`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with device_range(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Span:
    __slots__ = ("_totals", "_keys", "_args", "_range", "_t0")

    def __init__(self, totals: dict, keys: tuple, args: Optional[str]):
        self._totals = totals
        self._keys = keys
        self._args = args

    def __enter__(self) -> "_Span":
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = record_function(self._keys[2], self._args)
            self._range.__enter__()
            if self._args:
                # the chrome trace drops a range's string args: an empty
                # range at the span's start names the request(s) instead
                with record_function("gen.request " + self._args):
                    pass
        self._t0 = now_s()
        return self

    def __exit__(self, kind, exc, tb) -> None:
        if kind is None:
            name, count, _ = self._keys
            self._totals[name] += now_s() - self._t0
            if count is not None:
                self._totals[count] += 1
        if self._range is not None:
            self._range.__exit__(kind, exc, tb)


class SpanTotals:
    """Cumulative host seconds (``now_s``) of named spans in ``totals``,
    and, for the names in ``counted``, under ``<name>.n`` how many ended.
    ``spans(name)`` is a context manager for a span of the calling thread
    (one writer a name: the engine's thread); :meth:`add` adds a span timed
    elsewhere, under a lock (the front door's thread and the engine's share
    those names). A span that raises adds nothing."""

    def __init__(self, names: Iterable[str], counted: Iterable[str] = ()):
        counted = set(counted)
        self.totals: dict = {}
        self._keys = {}
        for name in names:
            self.totals[name] = 0.0
            count = None
            if name in counted:
                count = name + ".n"
                self.totals[count] = 0
            self._keys[name] = (name, count, "gen." + name)
        self._lock = threading.Lock()

    def __call__(self, name: str, args: Optional[str] = None) -> _Span:
        return _Span(self.totals, self._keys[name], args)

    def add(self, name: str, seconds: float) -> None:
        _, count, _ = self._keys[name]
        with self._lock:
            self.totals[name] += seconds
            if count is not None:
                self.totals[count] += 1
