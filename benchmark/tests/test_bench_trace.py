"""The trace reader on synthetic chrome traces: busy time and the slice's
length are read between the slice's markers, so busy never exceeds it."""

from __future__ import annotations

import json

import pytest

from harness import trace


def kernel(ts, dur, corr, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def launch(ts, corr, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1.0,
            "args": {"correlation": corr}}


def annotation(name, ts, dur=0.0):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def markers(t0, t1):
    return [annotation(trace.SLICE_START, t0), annotation(trace.SLICE_STOP, t1)]


def analyse(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.analyse(path)


def test_busy_time_is_clipped_to_the_slice(tmp_path):
    # a kernel queued before the slice runs into it; one launched near its end
    # runs on after it: only the parts inside [1000, 5000) us count
    events = markers(1000.0, 5000.0) + [
        kernel(500.0, 1000.0, 1), launch(400.0, 1),
        kernel(2000.0, 1000.0, 2), launch(1900.0, 2),
        kernel(4500.0, 2000.0, 3), launch(4400.0, 3),
    ]
    p = analyse(tmp_path, events)
    assert p["marked"]
    assert p["window_s"] == pytest.approx(4000e-6)
    assert p["busy_s"] == pytest.approx((500.0 + 1000.0 + 500.0) * 1e-6)
    assert p["busy_s"] <= p["window_s"]
    assert p["span_s"] == pytest.approx(6000e-6)
    # the kernels launched inside the slice are the slice's work
    assert p["kernels"] == 2
    assert sum(s for _, s in p["device_ops"]) == pytest.approx(3000e-6)


def test_a_device_busier_than_the_host_slice_reads_at_most_the_slice(tmp_path):
    # kernels back to back on two streams from long before to long after
    events = markers(10_000.0, 14_000.0)
    for i in range(40):
        events += [kernel(i * 500.0, 600.0, 2 * i), launch(i * 500.0 - 50.0, 2 * i),
                   kernel(i * 500.0 + 100.0, 300.0, 2 * i + 1),
                   launch(i * 500.0 + 50.0, 2 * i + 1)]
    p = analyse(tmp_path, events)
    assert p["busy_s"] == pytest.approx(p["window_s"])
    assert p["idle_gaps"] == []


def test_idle_gaps_and_busy_time_fill_the_slice(tmp_path):
    events = markers(0.0, 10_000.0) + [
        annotation("engine.admit", 0.0, 3000.0), annotation("engine.wait", 6000.0, 4000.0),
        kernel(1000.0, 2000.0, 1), launch(900.0, 1),
        kernel(5000.0, 1000.0, 2), launch(4900.0, 2),
    ]
    p = analyse(tmp_path, events)
    idle = dict(p["idle_gaps"])
    assert idle["engine.admit"] == pytest.approx(1000e-6)    # [0, 1000)
    assert idle["engine.other"] == pytest.approx(2000e-6)    # [3000, 5000)
    assert idle["engine.wait"] == pytest.approx(4000e-6)     # [6000, 10000)
    assert p["busy_s"] + sum(idle.values()) == pytest.approx(p["window_s"])


def test_a_repeated_kernel_record_counts_once(tmp_path):
    one = [kernel(1000.0, 1000.0, 1), launch(900.0, 1)]
    events = markers(0.0, 4000.0) + one + one + [kernel(2500.0, 500.0, 2), launch(2400.0, 2)]
    p = analyse(tmp_path, events)
    assert p["kernels"] == 2
    assert sum(s for _, s in p["device_ops"]) == pytest.approx(1500e-6)
    assert p["busy_s"] == pytest.approx(1500e-6)


def test_a_trace_without_markers_reads_its_device_span(tmp_path):
    events = [kernel(100.0, 100.0, 1), launch(90.0, 1), kernel(400.0, 100.0, 2), launch(390.0, 2)]
    p = analyse(tmp_path, events)
    assert not p["marked"]
    assert p["window_s"] == pytest.approx(400e-6)
    assert p["busy_s"] == pytest.approx(200e-6)


def test_the_profiler_writes_the_markers_the_reader_looks_for(tmp_path):
    """The markers as ``torch.profiler`` exports them (host side only here)."""
    torch = pytest.importorskip("torch")
    from torch.profiler import ProfilerActivity, profile

    class Engine:
        steps_per_sync = 1
        _chunk_fn = None

        def _prefill_fn(self, *a):
            return None

        def _dispatch_block(self, *a):
            return None

        def _admit_pending(self):
            return None

    spans = trace.Spans(Engine())
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            spans._mark(trace.SLICE_START)
            torch.ones(4) + 1
            spans._mark(trace.SLICE_STOP)
        path = tmp_path / "host.json"
        prof.export_chrome_trace(str(path))
    finally:
        spans.remove()
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    marks = [e for e in events if e.get("name") in (trace.SLICE_START, trace.SLICE_STOP)]
    assert {(e["name"], e["cat"], e["ph"]) for e in marks} == {
        (trace.SLICE_START, "user_annotation", "X"), (trace.SLICE_STOP, "user_annotation", "X")}
    t0 = next(float(e["ts"]) for e in marks if e["name"] == trace.SLICE_START)
    t1 = next(float(e["ts"]) for e in marks if e["name"] == trace.SLICE_STOP)
    events.append(kernel(t0 - 10.0, t1 - t0 + 20.0, 7))
    path.write_text(json.dumps({"traceEvents": events}))
    p = trace.analyse(path)
    assert p["marked"]
    assert p["busy_s"] == pytest.approx(p["window_s"])
    assert 0 < p["window_s"] <= p["span_s"]
