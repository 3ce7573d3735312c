"""The generation engine's spans (``monitoring/trace.py:SpanTotals``).

A tiny paged engine with a prefix cache and chunked prompts serves three
requests on the test's own thread (``torch.profiler`` records the ranges
of the thread that starts it):

- every ``<name>.n`` equals what the test counts itself: admissions,
  chunks, first tokens, fetches that blocked; the other spans keep
  seconds only, and the ``admit.*`` parts sum to no more than ``admit``;
- with no profiler no ``record_function`` range is opened at all;
- under ``torch.profiler`` the chrome trace holds ``gen.admit`` with
  ``gen.admit.chunk`` inside it (and the chunk's request named inside
  that), ``gen.dispatch``, ``gen.consume``, ``ops.dense``, and
  ``ops.attn`` inside the chunk (the paged prefill's inline attention),
  all on the engine's thread; the streams are the unprofiled streams;
- the loop-phase gauge exports the loop's phases only.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from starpu_inference_server_tpu_torch.models import decoder as td
from starpu_inference_server_tpu_torch.monitoring import metrics as tmetrics
from starpu_inference_server_tpu_torch.monitoring import trace as ttrace
from starpu_inference_server_tpu_torch.serving import generation as tgen

TINY = {"layers": 2, "hidden": 128, "q_heads": 4, "kv_heads": 2, "intermediate": 256,
        "vocab": 128}
SHARED = list(range(40, 64))  # three pages of 8: the prefix the third request reuses
PROMPTS = [SHARED + [1, 2, 3, 4, 5, 6], [3, 7, 11, 5, 2], SHARED + [9, 8, 7, 6, 5]]


@pytest.fixture(scope="module")
def params():
    return td.init_params(td.get_spec("llama-tiny", TINY), np.random.default_rng(0))


def _engine(params, **kw):
    kw = dict(dict(num_slots=2, max_len=96, prefill_buckets=[8, 16], steps_per_sync=3,
                   prefill_chunk=16, kv_page_size=8, kv_pool_pages=24, prefix_cache=True,
                   prefix_cache_min=8), **kw)
    return tgen.GenerationEngine(td.get_spec("llama-tiny", TINY), params, dtype=torch.float32,
                                 device="cpu", **kw)


class Counted:
    """The engine's calls, counted from outside: chunk passes, bucketed
    prefill flushes, fetches, and a fetch made to block every other time."""

    def __init__(self, eng):
        self.chunks = self.flushes = self.fetches = self.blocked = 0
        self._block = False
        chunk_fn, prefill_many, fetch = eng._chunk_fn, eng._prefill_many, eng._fetch

        def chunk(*args):
            self.chunks += 1
            return chunk_fn(*args)

        def flush(*args):
            self.flushes += 1
            return prefill_many(*args)

        def fetched(host, event):
            self.fetches += 1
            self._block = self.fetches % 2 == 0
            self.blocked += self._block
            return fetch(host, event)

        def ready(event):
            block, self._block = self._block, False
            return not block

        eng._chunk_fn, eng._prefill_many, eng._fetch = chunk, flush, fetched
        eng._fetch_ready = ready


def _serve_here(eng, max_new=14):
    """Serve PROMPTS with the engine's loop on this thread; a helper thread
    stops it once every request is done. Returns the requests."""
    reqs = [tgen.GenerationRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=max_new,
                                   request_id=f"r{i}") for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)

    def stop_when_done():
        for r in reqs:
            r.done.wait(120)
        eng._stop.set()
        with eng._work:
            eng._work.notify_all()

    stopper = threading.Thread(target=stop_when_done, daemon=True)
    stopper.start()
    eng._serve()
    stopper.join(5)
    for r in reqs:
        r.result(timeout=0)
    return reqs


def test_span_counts_match_what_the_engine_did(params):
    eng = _engine(params)
    counted = Counted(eng)
    reqs = _serve_here(eng)
    t = eng.loop_timers
    assert eng.prefix_hits == 1 and counted.chunks >= 3 and counted.flushes == 1
    assert counted.blocked >= 2
    spans = tgen.LOOP_PHASES + tgen.REQUEST_SPANS
    assert set(t) == set(spans) | {name + ".n" for name in tgen.COUNTED_SPANS}
    n = {name: t[name + ".n"] for name in tgen.COUNTED_SPANS}
    assert n["request.queue"] == n["request.prefill"] == len(PROMPTS)
    assert n["admit.chunk"] == counted.chunks
    assert n["wait"] == counted.blocked
    assert n["request.send"] == 0  # no front door here
    assert all(t[name] > 0 for name in tgen.LOOP_PHASES)
    parts = sum(t[name] for name in tgen.LOOP_PHASES if name.startswith("admit."))
    assert 0 < parts <= t["admit"]
    assert t["dispatch"] + t["consume"] <= t["step"]
    assert all(r.submitted_at <= r.admitted_at <= r.first_token_at <= r.finished_at
               for r in reqs)
    assert t["request.queue"] == pytest.approx(sum(r.admitted_at - r.submitted_at
                                                   for r in reqs))
    assert t["request.prefill"] == pytest.approx(sum(r.first_token_at - r.admitted_at
                                                     for r in reqs))


def _events(path):
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(inner, outer):
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_ranges_open_only_under_the_profiler_and_leave_the_streams_alone(params, tmp_path,
                                                                         monkeypatch):
    opened = []
    record_function = ttrace.record_function

    def counting(name, args=None):
        opened.append(name)
        return record_function(name, args)

    monkeypatch.setattr(ttrace, "record_function", counting)
    eng = _engine(params)
    Counted(eng)  # fetches that block: the wait span
    plain = [r.tokens for r in _serve_here(eng)]
    assert opened == []

    eng = _engine(params)
    Counted(eng)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = [r.tokens for r in _serve_here(eng)]
    assert traced == plain
    assert opened
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = _events(tmp_path / "trace.json")
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    for name in ("gen.admit", "gen.admit.lookup", "gen.admit.grant", "gen.admit.chunk",
                 "gen.admit.prefill", "gen.dispatch", "gen.consume", "gen.land", "gen.wait",
                 "ops.dense", "ops.attn", "gen.step"):
        assert name in by_name, name
    engine_thread = threading.get_native_id()
    assert {e["tid"] for e in events} == {engine_thread}
    chunks = by_name["gen.admit.chunk"]
    assert all(any(_inside(c, a) for a in by_name["gen.admit"]) for c in chunks)
    # the paged prefill's attention, inside a chunk
    assert all(any(_inside(a, c) for a in by_name["ops.attn"]) for c in chunks)
    # each chunk names its request
    markers = [e for e in events if e["name"].startswith("gen.request ")]
    assert all(any(_inside(m, c) for m in markers) for c in chunks)
    assert {"gen.request r0", "gen.request r2"} <= {m["name"] for m in markers}


def test_the_loop_phase_gauge_exports_the_loop_phases_only(params):
    recorder = tmetrics.MetricsRecorder(port=None, model_name="g")
    eng = _engine(params, metrics=recorder)
    _serve_here(eng, max_new=66)  # past 64 steps: the gauge is set every 64
    phases = {s.labels["phase"]: s.value
              for metric in recorder.registry.collect()
              if metric.name == "generation_loop_phase_seconds_total"
              for s in metric.samples}
    assert set(phases) == set(tgen.LOOP_PHASES)
    assert all(phases[p] <= eng.loop_timers[p] for p in phases)


def test_spans_added_from_many_threads_lose_no_update():
    """``add`` is the front door's way in (the asyncio thread and the
    engine's share the request totals): under a short switch interval,
    twelve threads adding at once leave every count and second in place."""
    import sys

    spans = ttrace.SpanTotals(["request.send"], counted=["request.send"])
    threads = [threading.Thread(target=lambda: [spans.add("request.send", 0.5)
                                                for _ in range(2000)]) for _ in range(12)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert spans.totals["request.send.n"] == 24000
    assert spans.totals["request.send"] == 12000.0
