"""The traced run's instruments, all from outside the program.

:class:`Spans` records, from the start of the run, the work each call
dispatches (cheap: one list append a call):

- every decode block dispatched (its slots' contexts and remaining
  budgets) and every prefill pass (valid rows, start).

Only while the profiled slice runs does it also wrap the program's calls in
``torch.profiler.record_function`` ranges, so that the measured window runs
the program as an untraced run does:

- ``engine.admit`` / ``engine.dispatch`` / ``engine.consume`` /
  ``engine.land`` / ``engine.wait``: the generation engine's
  ``_admit_pending``, ``_dispatch_block``, ``_consume_block``,
  ``_land_prefills`` and ``_fetch`` (the host waiting for the device);
- ``bench.dense``: ``ops.nn.dense``, every linear layer (K1, K2, and the
  dequantise + f32 matmul route);
- ``bench.attn``: the attention entry points (``causal_attention`` K5,
  ``chunk_prefill_attention`` K4, ``decode_attention`` K3,
  ``paged_decode_attention`` K10).

A greedy decode block is one CUDA graph replay, whose kernels no host range
can enclose: those are classified by kernel name (:func:`kernel_layer`).
These wrappers depend on the program's function names; spans inside the
program belong to a later change.

:func:`analyse` reads a ``torch.profiler`` chrome trace of a slice. The
slice is the stretch between two marker ranges that the engine's thread
puts in right after the profiler starts and right before it stops
(``bench.slice_start`` / ``bench.slice_stop``), on the trace's own clock.
From it: the device's busy time inside the slice (the union of kernel
intervals, clipped to the slice, so that work still queued when the slice
ends, or records left from before it, never count), kernel time by layer
and the top device operations (the kernels launched inside the slice, the
work that ``Spans.between`` counts for the slice), and each idle gap on the
device inside the slice by the engine phase the host was in at its middle.

The profiler starts and stops on the engine's own thread (at the top of an
engine loop iteration), and the ranges go on and off there with it:
``torch.profiler`` records the host ranges of the thread that started it
only, and the device's kernels from every thread.
"""

from __future__ import annotations

import bisect
import collections
import json
import threading
import time
from pathlib import Path

ENGINE_SPANS = {"_admit_pending": "engine.admit", "_dispatch_block": "engine.dispatch",
                "_consume_block": "engine.consume", "_land_prefills": "engine.land",
                "_fetch": "engine.wait"}
# innermost first: a gap inside a fetch is a wait, whatever encloses it
GAP_ORDER = ("engine.wait", "engine.dispatch", "engine.consume", "engine.land", "engine.admit")
GEMM_NAMES = ("qmm::matmul_mma", "qmm::splitk_reduce", "gemm", "gemv", "cutlass", "xmma")
ATTN_NAMES = ("dmma::attend_kernel", "dmma::merge_kernel", "attention", "chunk_prefill",
              "flash")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160  # a device operation's name in the breakdown, cut to this
SLICE_START, SLICE_STOP = "bench.slice_start", "bench.slice_stop"


def kernel_layer(name: str) -> str:
    """The layer of a kernel launched inside a CUDA graph, by its name."""
    low = name.lower()
    if any(p in low for p in ATTN_NAMES):
        return "attn"
    if any(p in low for p in GEMM_NAMES):
        return "gemm"
    return "other"


class Spans:
    """Ranges and work records around the program's calls; :meth:`remove`
    puts every wrapped attribute back."""

    def __init__(self, engine):
        import torch

        self.torch = torch
        self.engine = engine
        self.blocks = []      # (host time, [(context, steps this block)] of live slots)
        self.prefills = []    # (host time, valid rows, start)
        self.lock = threading.Lock()
        self._undo = []       # the work records, undone by :meth:`remove`
        self._ranges = []     # the slice's ranges, undone when the slice ends
        self._plan = None
        self.prof = None
        self.profiled = threading.Event()
        self._record(engine, "_prefill_fn", lambda a: (int(a[4]), 0))
        if engine._chunk_fn is not None:
            self._record(engine, "_chunk_fn", lambda a: (int(a[5]), int(a[4])))
        self._wrap_dispatch(engine)
        self._admit = engine._admit_pending

        def admit_and_tick():
            self._profile_tick()
            return self._admit()

        self._set(engine, "_admit_pending", admit_and_tick)

    def _ranges_on(self) -> None:
        """Wrap the program's calls in ranges (on the engine's thread, at the
        top of a loop iteration, as the profiler starts)."""
        from starpu_inference_server_tpu_torch.models import paged_decoder
        from starpu_inference_server_tpu_torch.ops import decode_attention, nn, prefill_attention

        engine = self.engine
        admit = self._admit
        self._admit = self._ranged(admit, "engine.admit")
        self._ranges.append(lambda: setattr(self, "_admit", admit))
        for method, span in ENGINE_SPANS.items():
            if method != "_admit_pending":
                self._wrap(engine, method, span)
        self._wrap(nn, "dense", "bench.dense")
        self._wrap(prefill_attention, "causal_attention", "bench.attn")
        self._wrap(prefill_attention, "chunk_prefill_attention", "bench.attn")
        self._wrap(decode_attention, "decode_attention", "bench.attn")
        self._wrap(paged_decoder, "paged_decode_attention", "bench.attn")

    def _ranges_off(self) -> None:
        while self._ranges:
            self._ranges.pop()()

    def _ranged(self, fn, span):
        rf = self.torch.profiler.record_function

        def wrapped(*args, **kwargs):
            with rf(span):
                return fn(*args, **kwargs)

        return wrapped

    def _wrap(self, owner, attr, span):
        """A range around ``owner.attr`` until the slice ends."""
        had = attr in vars(owner)
        old = vars(owner).get(attr)
        setattr(owner, attr, self._ranged(getattr(owner, attr), span))
        self._ranges.append(lambda: setattr(owner, attr, old) if had else delattr(owner, attr))

    def _set(self, owner, attr, value):
        had = attr in vars(owner)
        old = vars(owner).get(attr)
        setattr(owner, attr, value)
        self._undo.append((owner, attr, had, old))

    def _record(self, engine, attr, rows_start):
        fn = getattr(engine, attr)

        def wrapped(*args):
            rows, start = rows_start(args)
            with self.lock:
                self.prefills.append((time.monotonic(), rows, start))
            return fn(*args)

        self._set(engine, attr, wrapped)

    def _wrap_dispatch(self, engine):
        fn = getattr(engine, "_dispatch_block")
        steps = engine.steps_per_sync

        def wrapped(ids, progress, snap, alive=None, chain=0):
            live = []
            for state in snap["states"]:
                if state is None:
                    continue
                req = state.request
                done = state.emitted + chain * steps
                left = req.max_new_tokens - done
                if left > 0:
                    live.append((len(req.prompt_ids) + done, min(steps, left)))
            with self.lock:
                self.blocks.append((time.monotonic(), live))
            return fn(ids, progress, snap, alive, chain)

        self._set(engine, "_dispatch_block", wrapped)

    def profile_from(self, start: float, length: float, cuda: bool) -> None:
        """Have the engine's thread run ``torch.profiler`` for ``length``
        seconds from its first loop iteration at or after ``start``
        (monotonic seconds); :attr:`profiled` is set once it has stopped,
        with the slice's ends in ``slice_t``."""
        self.profiled.clear()
        self._plan = {"start": start, "length": length, "cuda": cuda}

    def _profile_tick(self) -> None:
        plan = self._plan
        if plan is None:
            return
        now = time.monotonic()
        if self.prof is None and now >= plan["start"]:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if plan["cuda"] else [])
            self.prof = profile(activities=acts)
            self._ranges_on()
            self.prof.start()
            plan["t0"] = time.monotonic()
            self._mark(SLICE_START)
        elif self.prof is not None and now >= plan["t0"] + plan["length"]:
            self._mark(SLICE_STOP)
            plan["t1"] = time.monotonic()
            self.prof.stop()
            self._ranges_off()
            self.slice_t = (plan["t0"], plan["t1"])
            self._plan = None
            self.profiled.set()

    def _mark(self, name: str) -> None:
        """An empty range in the trace: the slice's end on the trace's clock."""
        with self.torch.profiler.record_function(name):
            pass

    def between(self, t0: float, t1: float):
        """The work records dispatched in [t0, t1)."""
        with self.lock:
            blocks = [b for t, b in self.blocks if t0 <= t < t1]
            prefills = [(r, s) for t, r, s in self.prefills if t0 <= t < t1]
        return blocks, prefills

    def remove(self) -> None:
        self._ranges_off()
        for owner, attr, had, old in reversed(self._undo):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._undo.clear()


def _intervals(spans):
    spans = sorted(spans)
    starts = [a for a, _ in spans]
    return starts, spans


def _inside(index, t) -> bool:
    starts, spans = index
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and spans[i][0] <= t < spans[i][1]


def _slice_ends(ranges, device):
    """The slice's ends in trace microseconds: the two markers, or where a
    trace lacks them, the first and last device operation."""
    a, b = ranges.get(SLICE_START), ranges.get(SLICE_STOP)
    if a and b and a[0][0] < b[-1][0]:
        return a[0][0], b[-1][0], True
    return min(x for x, _, _, _ in device), max(y for _, y, _, _ in device), False


def analyse(path: Path) -> dict:
    """Device busy seconds and the slice's seconds (``busy_s`` <=
    ``window_s``), kernel seconds by layer (each kernel record once), top device operations and idle
    gaps by engine phase, from a chrome trace file."""
    with open(path, encoding="utf-8") as fh:
        events = json.load(fh)
    events = events["traceEvents"] if isinstance(events, dict) else events
    device, launches, ranges = [], {}, collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, e.get("name", ""), (e.get("args") or {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("name", ""), ts)
        elif cat == "user_annotation":
            ranges[e.get("name", "")].append((ts, ts + dur))
    if not device:
        cats = collections.Counter(e.get("cat") for e in events if isinstance(e, dict))
        return {"busy_s": 0.0, "kernels": 0, "categories": dict(cats)}
    # one kernel is one record: a record repeated (same correlation, start and
    # name) would count its time twice in the layers and the top operations
    device = sorted(set(device))
    s0, s1, marked = _slice_ends(ranges, device)
    dense = _intervals(ranges.get("bench.dense", []))
    attn = _intervals(ranges.get("bench.attn", []))
    phases = {name: _intervals(ranges.get(name, [])) for name in GAP_ORDER}
    by_layer = collections.Counter()
    by_name = collections.Counter()
    kernels = 0
    busy, end = 0.0, s0
    gaps = collections.Counter()

    def gap(a, b):
        mid = (a + b) / 2
        phase = next((p for p in GAP_ORDER if _inside(phases[p], mid)), "engine.other")
        gaps[phase] += (b - a) / 1e6

    for a, b, name, corr in device:
        launcher, t = launches.get(corr, ("", None))
        if s0 <= (a if t is None else t) < s1:  # launched inside the slice
            kernels += 1
            by_name[name[:NAME_CHARS]] += (b - a) / 1e6
            if "Graph" in launcher:
                layer = kernel_layer(name)
            elif t is None:
                layer = "other"
            else:
                layer = "gemm" if _inside(dense, t) else "attn" if _inside(attn, t) else "other"
            by_layer[layer] += (b - a) / 1e6
        a, b = max(a, s0), min(b, s1)  # the part that ran inside the slice
        if b <= a or b <= end:
            continue
        if a > end:
            gap(end, a)
            busy += b - a
        else:
            busy += b - end
        end = b
    if s1 > end:
        gap(end, s1)
    return {
        "busy_s": busy / 1e6,
        "window_s": (s1 - s0) / 1e6,
        "marked": marked,
        # every device operation in the trace, first start to last end
        "span_s": (max(b for _, b, _, _ in device) - device[0][0]) / 1e6,
        "kernels": kernels,
        "by_layer": dict(by_layer),
        "device_ops": [[n, s] for n, s in by_name.most_common(10)],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(10)],
    }
