"""One run of one cell: set-up, the measured window, the check.

1. Set-up (``setup_s``, from process start to the window's opening): the
   weights from ``--seed`` on the device, the port's CUDA libraries that
   the configuration launches (its ``kernel_libraries``), the
   port's server with its own warm-up (the cell's buckets, a chunked
   prompt, the greedy block's CUDA graph at the cell's slot count), then
   the traffic's own warm-up (closed loop: until every client has completed
   one request; open loop: ``warmup_s`` of arrivals).
2. The window: ``--seconds`` of traffic from the load generator process.
   The engine's counters are read at its ends. With ``--trace 1`` the
   benchmark records the work dispatched from the start, and a
   ``torch.profiler`` slice of ``TRACE_SLICE_S`` follows the window, once
   each of its requests has its first token, while the traffic goes on;
   the ranges around the program's calls are on during the slice alone.
3. After the window: the device's peak memory is read, the server is
   stopped and freed, and the sample of served requests is checked against
   the plain reference (``harness/check.py``). With ``--control 1`` the
   control is judged by the same rule as the program (``control_correct``).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

from . import check, manifest, model, serve, trace, traffic, window

TRACE_SLICE_S = 4.0
# the open loop's arrivals go on this long past the window in a traced run,
# so the slice (after the window's first tokens) still sees traffic
TRACE_TAIL_S = 30.0
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "starpu_inference_server_tpu")


def log(msg: str) -> None:
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN_MODULES`, compared whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN_MODULES})


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    workload: str
    shape: model.Shape
    loop: str
    seconds: float
    t0: float
    t1: float
    end: float                  # when the load generator stopped waiting
    setup_s: float
    records: list
    c0: dict                    # engine counters at the window's ends
    c1: dict
    paged: bool
    spans: Optional[object] = None
    slice_s: float = 0.0
    slice_t: tuple = (0.0, 0.0)
    profile: Optional[dict] = None


def counters(engine) -> dict:
    timers = dict(engine.loop_timers)
    greedy = engine._greedy
    timers.update(steps=engine.steps, reused=engine.prefix_tokens_reused,
                  hits=engine.prefix_hits, generated=engine.generated_tokens,
                  replays=greedy.replays if greedy is not None else 0)
    return timers


def _sleep_until(t: float) -> None:
    time.sleep(max(0.0, t - time.monotonic()))


class LoadGenProcess:
    """The load generator (``harness/loadgen.py``) as a child process."""

    def __init__(self, spec: dict, root: Path):
        self.proc = subprocess.Popen(
            [sys.executable, str(manifest.BENCH_DIR / "harness" / "loadgen.py")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=str(root))
        self.proc.stdin.write(json.dumps(spec))
        self.proc.stdin.close()
        self.events: queue.Queue = queue.Queue()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            line = line.strip()
            if line.startswith("{"):
                self.events.put(json.loads(line))
        self.events.put({"event": "exit"})

    def next(self, name: str, timeout: float) -> dict:
        deadline = time.monotonic() + timeout
        while True:
            try:
                ev = self.events.get(timeout=max(0.01, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"the load generator sent no {name!r} in {timeout:.0f} s")
            if ev["event"] == name:
                return ev
            if ev["event"] == "exit":
                raise RuntimeError(f"the load generator exited (code {self.proc.wait()}) "
                                   f"before {name!r}")

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.reader.join(timeout=10.0)


def _log_window(records, t0: float, t1: float, end: float, loop: str, c0: dict, c1: dict):
    """The window's engine counters and client-side latencies, for the log."""
    seconds = t1 - t0
    d = {k: c1[k] - c0[k] for k in c0}
    firsts = sum(1 for r in records if r["times"] and t0 <= r["times"][0] < t1)
    log(f"engine in the window: {firsts} first tokens, {d['hits']} prefix hits, "
        f"{d['steps']} decode steps, admit {100 * d['admit'] / seconds:.1f}%, "
        f"step {1e3 * d['step'] / max(1, d['steps']):.2f} ms a step")
    ttfts = window.ttft_ms(records, t0, t1, loop, end)
    if not ttfts:
        return
    if loop == "open":  # arrival order: a growing backlog shows as a later third that waits longer
        third = max(1, len(ttfts) // 3)
        log(f"open loop backlog: mean ttft {sum(ttfts[:third]) / third:.1f} ms in the first "
            f"third of the window's arrivals, {sum(ttfts[-third:]) / third:.1f} ms in the last")
    attempted, failed = window.attempted_failed(records, t0, t1, loop)
    ordered = sorted(ttfts)
    log(f"window: {attempted} requests, {failed} failed, "
        f"{window.output_tok_s(records, t0, t1):.1f} tokens/s; ttft ms mean "
        f"{sum(ordered) / len(ordered):.1f} p50 {ordered[len(ordered) // 2]:.1f} "
        f"p95 {window.p95(ordered):.1f} max {ordered[-1]:.1f}")


def run_cell(workload: str, seed: int, seconds: float, want_trace: bool, device,
             started: float, root: Path = manifest.ROOT, config: Optional[dict] = None,
             control: bool = False, chips: int = 1) -> dict:
    """One run; returns the result object (the last line's JSON).
    ``config`` replaces the cell's configuration (the tests' tiny widths)."""
    import torch

    man = manifest.manifest(root)
    cell = manifest.cell(man, workload)
    cfg = config if config is not None else manifest.config(man, cell["config"], root)
    mix = manifest.traffic(cell["traffic"], root / "benchmark")
    lim = manifest.limits(workload, root / "benchmark")
    shape = model.shape_of(cfg)
    cuda = torch.device(device).type == "cuda"
    tail_s = TRACE_TAIL_S if want_trace else 0.0
    log(f"{workload}: {cfg['name']} ({shape.layers} layers, hidden {shape.hidden}, "
        f"{cfg['quantization']}), {traffic.describe(mix)}; seed {seed}, {seconds:g} s")

    split = {}
    t = time.monotonic()
    from . import weights
    tree = weights.make(shape, seed, device)
    if cuda:
        torch.cuda.synchronize()
    split["weights"] = time.monotonic() - t
    t = time.monotonic()
    if cuda:
        from starpu_inference_server_tpu_torch.ops import _build
        _build.build_all(cfg["kernel_libraries"])
    split["extensions"] = time.monotonic() - t

    srv = serve.Server(model.server_config(cfg, shape, seed, "127.0.0.1:0"), tree, device)
    engine = srv.engine
    spans = trace.Spans(engine) if want_trace else None
    gen = None
    try:
        port = srv.start()
        split["server_warmup"] = srv.warm_s
        if want_trace:  # the profiler's first start is slow: take it in set-up
            t = time.monotonic()
            spans.profile_from(t, 0.1, cuda)
            if not spans.profiled.wait(120.0):
                raise RuntimeError("the engine's thread did not run the profiler")
            spans.prof = None
            split["profiler_warmup"] = time.monotonic() - t
        t = time.monotonic()
        spec = {"port": port, "model": cfg["name"], "traffic": mix, "seed": int(seed),
                "vocab": shape.vocab, "seconds": float(seconds), "tail_s": tail_s,
                "slice_s": TRACE_SLICE_S if want_trace else 0.0}
        gen = LoadGenProcess(spec, root)
        t0 = gen.next("open", timeout=1500.0)["t0"]
        t1 = t0 + seconds
        _sleep_until(t0)
        split["traffic_warmup"] = t0 - t
        setup_s = t0 - started
        c0 = counters(engine)
        _sleep_until(t1)
        c1 = counters(engine)
        slice_s, slice_t, profile = 0.0, (t1, t1), None
        trace_file = root / "build" / "bench_trace" / "trace.json"
        if want_trace:  # after the window's first tokens: the profiler's stop stalls the host
            served = gen.next("served", timeout=tail_s + 120.0)["t"]
            spans.profile_from(served, TRACE_SLICE_S, cuda)
            if not spans.profiled.wait(TRACE_SLICE_S + 120.0):
                raise RuntimeError("the engine's thread did not run the profiler")
            slice_t = spans.slice_t
            slice_s = slice_t[1] - slice_t[0]
            trace_file.parent.mkdir(parents=True, exist_ok=True)
            spans.prof.export_chrome_trace(str(trace_file))
            spans.prof = None
        wait = tail_s + (float(mix.get("drain_s", 60.0)) if mix["loop"] == "open" else 0.0)
        done = gen.next("done", timeout=wait + 120.0)
        end = time.monotonic()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        paged = bool(engine.kv_page_size)
    finally:
        if gen is not None:
            gen.close()
        srv.stop()
        if spans is not None:
            spans.remove()
            spans.engine = None
        del engine, srv
    log("setup split (s): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    if cuda:
        from starpu_inference_server_tpu_torch.ops import _build
        extra = sorted(set(_build._libs) - set(cfg["kernel_libraries"]))
        log(f"kernel libraries loaded: {sorted(_build._libs)}"
            + (f"; beyond kernel_libraries (built at first use): {extra}" if extra else ""))
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if want_trace:
        profile = trace.analyse(trace_file) if cuda else None
        trace_file.unlink(missing_ok=True)
        if profile is not None:
            log(f"trace: {profile['kernels']} device operations launched in a {slice_s:.2f} s "
                f"slice (host clock); busy {profile['busy_s']:.4f} s of "
                f"{profile.get('window_s', 0.0):.4f} s between the markers "
                f"(found: {profile.get('marked')}); the trace's device operations span "
                f"{profile.get('span_s', 0.0):.4f} s"
                + (f", categories {profile['categories']}" if "categories" in profile else ""))

    records = done["records"]
    run = Run(workload=workload, shape=shape, loop=mix["loop"], seconds=float(seconds), t0=t0,
              t1=t1, end=end, setup_s=setup_s, records=records, c0=c0, c1=c1,
              paged=paged, spans=spans, slice_s=slice_s,
              slice_t=slice_t, profile=profile)
    metrics = {}
    for m in manifest.metrics_of(man, workload, want_trace):
        value = manifest.reader(m["name"], root / "benchmark")(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted, failed = window.attempted_failed(records, t0, t1, mix["loop"])
    _log_window(records, t0, t1, end, mix["loop"], c0, c1)

    requests = traffic.build(mix, seed, shape.vocab, seconds, tail_s)
    prompts = {r.index: r.prompt for r in requests}
    scope = [r for r in records if r["times"] and
             (r["phase"] == "window" if mix["loop"] == "open" else r["times"][-1] >= t0)]
    picked = check.sample(scope, seed, int(lim["sample_requests"]))
    t = time.monotonic()
    if picked:
        reference = check.load_reference(root, cfg)
        readings = check.gaps(reference, tree, shape, prompts, picked, device, control=control)
    else:
        readings = {"max_gap": None, "control_max_gap": None, "tokens": 0, "requests": 0}
    log(f"check: {readings['requests']} requests, {readings['tokens']} served tokens against "
        f"the reference in {time.monotonic() - t:.1f} s")
    checks = {"max_gap": {"value": readings["max_gap"], "limit": lim["max_gap"]},
              "failed_requests": {"value": failed, "limit": 0}}
    if control:
        checks["control_max_gap"] = {"value": readings["control_max_gap"],
                                     "limit": lim["max_gap"]}

    def meets(gap) -> bool:
        return gap is not None and gap <= lim["max_gap"] and failed == 0

    correct = meets(readings["max_gap"])

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if want_trace and profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile.get("window_s", slice_s)
        result["breakdown"] = {"device_ops": profile.get("device_ops", []),
                               "idle_gaps": profile.get("idle_gaps", [])}
    if control:
        result["control_correct"] = meets(readings["control_max_gap"])
    result["checks"] = checks
    return result
