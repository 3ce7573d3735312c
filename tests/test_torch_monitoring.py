"""The port's monitoring layer against the JAX package's on the CPU.

- congestion: every scenario of tests/unit/test_congestion.py, at the
  unit tests' alpha 1 and the configs' smoothing 0.3, driven into both
  monitors with the same events and the same ``dt``: the snapshots are
  equal field for field, exactly;
- the runner: ``TaskRunner._sample_strategy_input`` with a monitor gives
  the JAX runner's ``StrategyInput``, and the adaptive strategy the same
  decisions;
- metrics: the same events through both ``RuntimeObservability``
  aggregates give the same ``generate_latest`` text once the device
  families' names (``tpu_*`` -> ``gpu_*``) and help strings are mapped
  and the ``*_created`` timestamps are dropped;
- traces: the same jobs with fixed stamps give equal
  ``batching_trace.json``, ``trace.csv`` and ``metrics.csv``;
- the generation engine's families (tests/unit/test_timing_and_trace.py
  ``test_generation_engine_metrics``, mirrored): equal counters;
- the port's own additions: an ephemeral exposer that frees its port at
  ``close()``, device families unset on a CPU process.
"""

import dataclasses
import json
import socket
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from prometheus_client import generate_latest

from starpu_inference_server_tpu.core.engine import ModelEngine as JaxModelEngine
from starpu_inference_server_tpu.core.job import InferenceJob as JaxJob
from starpu_inference_server_tpu.models import build_model as jax_build_model
from starpu_inference_server_tpu.models import decoder as jd
from starpu_inference_server_tpu.monitoring import congestion as jcong
from starpu_inference_server_tpu.monitoring import metrics as jmetrics
from starpu_inference_server_tpu.monitoring import observability as jobs
from starpu_inference_server_tpu.monitoring import trace as jtrace
from starpu_inference_server_tpu.serving.generation import GenerationEngine as JaxEngine
from starpu_inference_server_tpu.serving.generation import GenerationRequest as JaxRequest
from starpu_inference_server_tpu.serving.queue import InferenceQueue as JaxQueue
from starpu_inference_server_tpu.serving.runner import TaskRunner as JaxRunner
from starpu_inference_server_tpu.utils import config as jcfg
from starpu_inference_server_tpu_torch.core.engine import ModelEngine
from starpu_inference_server_tpu_torch.core.job import InferenceJob
from starpu_inference_server_tpu_torch.models import decoder as td
from starpu_inference_server_tpu_torch.models.registry import build_model
from starpu_inference_server_tpu_torch.monitoring import congestion as tcong
from starpu_inference_server_tpu_torch.monitoring import metrics as tmetrics
from starpu_inference_server_tpu_torch.monitoring import observability as tobs
from starpu_inference_server_tpu_torch.monitoring import trace as ttrace
from starpu_inference_server_tpu_torch.serving.generation import (
    GenerationEngine,
    GenerationRequest,
)
from starpu_inference_server_tpu_torch.serving.queue import InferenceQueue
from starpu_inference_server_tpu_torch.serving.runner import TaskRunner
from starpu_inference_server_tpu_torch.utils import config as tcfg


# -- congestion ------------------------------------------------------------------

def _settings(cfg_mod, alpha):
    """The unit tests' monitor settings (tests/unit/test_congestion.py)."""
    return cfg_mod.CongestionSettings(
        enabled=True, tick_interval_ms=100, ewma_alpha=alpha, rho_high=1.1, fill_high=0.7,
        latency_slo_ms=150.0, entry_horizon_ticks=2, exit_horizon_ticks=2,
    )


def _idle(m, state):
    return [m.tick(0.1) for _ in range(5)]


def _overload(m, state):
    out = []
    for _ in range(3):
        for _ in range(20):
            m.record_arrival()
        for _ in range(2):
            m.record_completion(10.0)
        out.append(m.tick(0.1))
    return out


def _latency_slo(m, state):
    out = []
    for _ in range(3):
        for _ in range(5):
            m.record_arrival()
            m.record_completion(145.0)
        out.append(m.tick(0.1))
    return out


def _rejection(m, state):
    out = [m.tick(0.1)]
    m.record_rejection()
    out.append(m.tick(0.1))
    return out


def _exit_hysteresis(m, state):
    state[:] = [60, 64]
    m.record_rejection()
    out = [m.tick(0.1)]
    state[0] = 0
    for _ in range(4):
        m.record_arrival()
        m.record_completion(5.0)
        out.append(m.tick(0.1))
    return out


def _fill_with_growth(m, state):
    out = []
    for i in range(4):
        state[:] = [50 + i * 5, 64]
        m.record_arrival()
        m.record_completion(1.0)
        out.append(m.tick(0.1))
    return out


def _state_change(m, state):
    m.record_rejection()
    out = [m.tick(0.1)]
    for _ in range(3):
        m.record_arrival()
        m.record_completion(1.0)
        out.append(m.tick(0.1))
    return out


def _monotonic(m, state):
    return [m.tick(0.1), m.tick(0.1)]


def _mixed_latencies(m, state):
    """Many latencies a tick (p95/p99 interpolate), uneven dt."""
    rng = np.random.default_rng(5)
    out = []
    for i, dt in enumerate((0.1, 0.05, 0.2, 0.1, 0.137)):
        for lat in rng.gamma(2.0, 40.0, 37 + i):
            m.record_arrival()
            m.record_completion(float(lat))
        state[:] = [int(rng.integers(0, 64)), 64]
        out.append(m.tick(dt))
    return out


SCENARIOS = {
    "idle": _idle, "overload_after_horizon": _overload, "latency_slo": _latency_slo,
    "rejection": _rejection, "exit_hysteresis": _exit_hysteresis,
    "fill_with_growth": _fill_with_growth, "state_change_callback": _state_change,
    "tick_monotonic": _monotonic, "mixed_latencies": _mixed_latencies,
}


def _drive(mod, cfg_mod, scenario, alpha):
    state = [0, 64]
    changes = []
    m = mod.CongestionMonitor(_settings(cfg_mod, alpha), lambda: tuple(state),
                              on_state_change=lambda c, s: changes.append((c, s.tick)))
    snaps = SCENARIOS[scenario](m, state)
    return [dataclasses.asdict(s) for s in snaps] + [dataclasses.asdict(m.snapshot())], changes


@pytest.mark.parametrize("alpha", [1.0, 0.3])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_congestion_snapshots_equal_the_jax_monitor(scenario, alpha):
    got, got_changes = _drive(tcong, tcfg, scenario, alpha)
    want, want_changes = _drive(jcong, jcfg, scenario, alpha)
    assert got == want  # dict equality: every field, exactly
    assert got_changes == want_changes
    if scenario == "state_change_callback" and alpha == 1.0:
        assert [c for c, _ in got_changes] == [True, False]


def _slow_probe(calls):
    """Every tick's queue probe takes 40% of the 100 ms interval."""
    time.sleep(0.04)
    return (0, 64)


def _stalled_probe(calls):
    """The third tick's queue probe stalls for 3.5 intervals."""
    if calls == 3:
        time.sleep(0.35)
    return (0, 64)


@pytest.mark.parametrize("probe", [_slow_probe, _stalled_probe], ids=["slow", "stalled"])
def test_ticks_keep_deadlines_and_pass_measured_dt(probe):
    """The port's thread ticks on fixed 100 ms deadlines over 1.2 s and
    passes each tick the time measured since the tick before: a slow
    probe does not push the deadlines back, and a stall skips the
    deadlines it missed, its next tick covering the whole gap."""
    dts = []
    cfg = dataclasses.replace(_settings(tcfg, 0.3), tick_interval_ms=100)
    m = tcong.CongestionMonitor(cfg, lambda: probe(len(dts)))
    inner = m.tick
    m.tick = lambda dt_s: (dts.append(dt_s), inner(dt_s))[1]
    t0 = time.monotonic()
    m.start()
    time.sleep(1.2)
    m.stop()
    wall = time.monotonic() - t0
    assert m.snapshot().tick == len(dts)
    assert sum(dts) <= wall
    assert min(dts) > 0.05  # no catch-up tick with next to no time
    if probe is _slow_probe:
        assert len(dts) >= 10  # 10 of the 12 deadlines at least
    else:
        assert max(dts) >= 0.35  # the tick after the stall spans it
        assert len(dts) <= 9  # the three deadlines missed were skipped


def test_disabled_monitor_starts_no_thread():
    cfg = dataclasses.replace(_settings(tcfg, 0.3), enabled=False)
    m = tcong.CongestionMonitor(cfg, lambda: (0, 1))
    m.start()
    assert m._thread is None
    m.stop()


# -- the runner's strategy input ---------------------------------------------------

def _runner_cfg(cfg_mod):
    return cfg_mod.parse_config({
        "name": "m", "model": {"family": "add_one", "options": {"dims": [4]}},
        "inputs": [{"name": "input", "dims": [4], "dtype": "FP32"}],
        "outputs": [{"name": "output", "dims": [4], "dtype": "FP32"}],
        "pool_size": 2, "max_batch_size": 8, "batch_coalesce_timeout_ms": 2.0,
        "batching_strategy": "adaptive", "max_queue_size": 16, "max_inflight_tasks": 4,
        "congestion": {"ewma_alpha": 0.3, "latency_slo_ms": 50},
        "metrics_enabled": False,
    })


def test_runner_strategy_input_equals_the_jax_runner():
    """Both runners sample their monitor, queue and backlog into the same
    StrategyInput at every tick, and the adaptive strategy decides the
    same batch limit and window from it (congestion jumps to the max)."""
    tc, jc = _runner_cfg(tcfg), _runner_cfg(jcfg)
    t_queue, j_queue = InferenceQueue(tc.max_queue_size), JaxQueue(jc.max_queue_size)
    t_mon = tcong.CongestionMonitor(tc.congestion, lambda: (t_queue.size(), t_queue.capacity))
    j_mon = jcong.CongestionMonitor(jc.congestion, lambda: (j_queue.size(), j_queue.capacity))
    t_run = TaskRunner(tc, ModelEngine(tc, build_model(tc.model, device="cpu")), t_queue,
                       congestion_monitor=t_mon)
    j_run = JaxRunner(jc, JaxModelEngine(jc, jax_build_model(jc.model)), j_queue,
                      congestion_monitor=j_mon)
    got, want = [], []
    for step, (pushes, lat) in enumerate([(0, 5.0), (3, 10.0), (6, 80.0), (2, 90.0),
                                          (0, 5.0), (0, 5.0), (0, 5.0)]):
        for i in range(pushes):
            t_queue.push(InferenceJob({"input": np.zeros((1, 4), np.float32)}, f"{step}.{i}"))
            j_queue.push(JaxJob({"input": np.zeros((1, 4), np.float32)}, f"{step}.{i}"))
        for mon in (t_mon, j_mon):
            for _ in range(4):
                mon.record_arrival()
            mon.record_completion(lat)
            mon.tick(0.1)
        for run, out in ((t_run, got), (j_run, want)):
            sample = run._sample_strategy_input()
            out.append((dataclasses.asdict(sample),
                        dataclasses.asdict(run.strategy.decide(sample))))
    assert got == want
    assert any(s["congested"] for s, _ in got) and got[-1][0]["monitor_tick"] == 7
    assert max(d["target_batch_limit"] for _, d in got) == 8


# -- metrics and traces ------------------------------------------------------------

DEVICE_NAMES = (("tpu_", "gpu_"), ("Local TPU devices", "Local GPU devices"),
                ("HBM bytes limit", "HBM bytes total"))


def _exposition(recorder, jax_side=False):
    """generate_latest text without the *_created lines (creation
    times), with the JAX device families renamed as the port names them."""
    text = generate_latest(recorder.registry).decode()
    if jax_side:
        for old, new in DEVICE_NAMES:
            text = text.replace(old, new)
    return [line for line in text.splitlines() if "_created" not in line]


def _master(job_cls, rid, lane, batch, bucket, subs, warmup=False, base=100.0):
    """A batched master with fixed stamps and breakdown, and ``subs``
    sub-jobs (a logical batch of subs + 1 requests)."""
    master = job_cls({"x": np.zeros((batch, 4), np.float32)}, request_id=rid,
                     is_warmup=warmup)
    master.is_batched_master = True
    master.effective_batch = batch
    master.bucket_size = bucket
    master.logical_jobs = subs + 1
    master.executed_on = lane
    master.submission_id = 7
    for i in range(subs):
        sub = job_cls({"x": np.zeros((1, 4), np.float32)}, request_id=f"{rid}-{i}")
        sub.timing.enqueued_at = base + 0.0005 * (i + 1)
        master.sub_jobs.append(sub)
    t = master.timing
    t.enqueued_at = base
    t.batch_collect_start, t.batch_collect_end = base + 0.001, base + 0.0023
    t.codelet_start_at, t.codelet_end_at = base + 0.003, base + 0.0171
    master.latency_breakdown = {"queue_ms": 1.25, "batch_ms": 1.3, "submit_ms": 0.2,
                                "scheduling_ms": 0.5, "codelet_ms": 14.1,
                                "inference_ms": 12.345678, "callback_ms": 0.7,
                                "total_ms": 17.1 + batch}
    return master


def _drive_observability(obs_mod, job_cls, cong_mod, cfg_mod, out_dir, clock, monkeypatch):
    """One event sequence through a RuntimeObservability with a
    MetricsRecorder (no exposer) and a trace logger, at a fixed clock."""
    monkeypatch.setattr(f"{obs_mod.__name__.rsplit('.', 1)[0]}.trace.now_s", clock)
    rec = (tmetrics if job_cls is InferenceJob else jmetrics).MetricsRecorder(
        port=None, model_name="m")
    tracer = (ttrace if job_cls is InferenceJob else jtrace).BatchingTraceLogger(str(out_dir))
    obs = obs_mod.RuntimeObservability(metrics=rec, tracer=tracer)
    state = [0, 64]
    mon = cong_mod.CongestionMonitor(_settings(cfg_mod, 0.3), lambda: tuple(state),
                                     on_state_change=lambda c, s: obs.on_congestion_snapshot(s))
    for size in (1, 3, 2):
        obs.on_queue_size(size, 64)
    warm = _master(job_cls, "w0", "lane0@cuda:0", 4, 4, 0, warmup=True)
    obs.set_warmup_suppressed(True)
    obs.record_job(warm)
    obs.set_warmup_suppressed(False)
    obs.record_job(_master(job_cls, "w1", "lane1@cuda:0", 2, 2, 0, warmup=True))
    for i, (lane, batch, bucket, subs) in enumerate([("lane0@cuda:0", 3, 4, 2),
                                                     ("lane1@cuda:0", 16, 16, 15),
                                                     ("lane0@cuda:0", 1, 1, 0)]):
        job = _master(job_cls, f"r{i}", lane, batch, bucket, subs, base=100.0 + i)
        obs.on_request_enqueued(job, i + 1)
        rec.requests_total.inc()
        rec.preprocess_latency.observe(0.3 * (i + 1))
        mon.record_arrival()
        if i == 1:
            mon.record_rejection()
            obs.on_rejection(f"x{i}")
            rec.requests_by_status.labels("RESOURCE_EXHAUSTED").inc()
        mon.tick(0.1)  # the rejection: congested from here, job 2 says so
        obs.record_job(job)
        rec.postprocess_latency.observe(0.05 * (i + 1))
        rec.requests_by_status.labels("OK").inc()
    rec.record_failure("execute", "RuntimeError")
    obs.on_congestion_snapshot(mon.snapshot())
    obs.tracer.log_congestion_span(100.5, 101.75, 1.23456)
    # the generation families the engine updates
    rec.generated_tokens_total.inc(5)
    rec.generation_ttft.observe(42.5)
    rec.generation_tokens_per_request.observe(16)
    rec.generation_active_slots.set(3)
    rec.generation_loop_seconds.labels(phase="consume").set(1.5)
    rec.prefix_cache_hits_total.inc()
    rec.prefix_tokens_reused_total.inc(256)
    rec.draft_acceptance_ratio.set(0.75)
    obs.flush()
    return rec


def _fixed_clock():
    return 100.0


def test_metrics_and_traces_equal_the_jax_package(tmp_path, monkeypatch):
    t_dir, j_dir = tmp_path / "torch", tmp_path / "jax"
    t_rec = _drive_observability(tobs, InferenceJob, tcong, tcfg, t_dir, _fixed_clock,
                                 monkeypatch)
    j_rec = _drive_observability(jobs, JaxJob, jcong, jcfg, j_dir, _fixed_clock, monkeypatch)
    got, want = _exposition(t_rec), _exposition(j_rec, jax_side=True)
    assert got == want
    text = "\n".join(got)
    assert "inference_completed_total 5.0" in text  # warm-up jobs count, as in JAX
    assert "inference_congestion_flag 1.0" in text
    assert 'requests_by_status_total{code="OK"} 3.0' in text
    # the trace files: same events, rows and samples
    for name in ("batching_trace.json", "trace.csv", "metrics.csv"):
        assert (t_dir / name).read_text() == (j_dir / name).read_text(), name
    events = json.loads((t_dir / "batching_trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events]
    assert names.count("batch") == 3 and "warming_batch" in names and "congested" in names
    assert [e["args"]["congested"] for e in events if e["name"] == "batch"] == [False, True, True]


@pytest.mark.parametrize("suppressed", [True, False])
def test_trace_warmup_handling_equals_the_jax_logger(tmp_path, suppressed):
    out = {}
    for mod, job_cls in ((ttrace, InferenceJob), (jtrace, JaxJob)):
        d = tmp_path / mod.__name__.split(".")[0]
        logger = mod.BatchingTraceLogger(str(d))
        logger._epoch = 90.0  # the same origin for both loggers' timestamps
        logger.set_warmup_suppressed(suppressed)
        logger.log_batch_executed(_master(job_cls, "w", "lane0", 2, 2, 1, warmup=True), False)
        logger.flush()
        out[mod] = (d / "batching_trace.json").read_text()
    assert out[ttrace] == out[jtrace]
    assert ('warming_batch' in out[ttrace]) is not suppressed


# -- the generation engine's families ----------------------------------------------

GEN_OPTS = {"layers": 1, "hidden": 64, "q_heads": 2, "kv_heads": 1, "intermediate": 96,
            "vocab": 64}
GEN_KW = dict(num_slots=2, max_len=64, prefill_buckets=[8], prefill_chunk=8,
              prefix_cache=True, prefix_cache_min=4)
COUNTERS = {"generated_tokens_total": "generation_tokens_total",
            "prefix_cache_hits_total": "generation_prefix_cache_hits_total",
            "prefix_tokens_reused_total": "generation_prefix_tokens_reused_total"}


def _generation_metrics(engine_cls, request_cls, spec, params, recorder, **kw):
    eng = engine_cls(spec, params, metrics=recorder, **GEN_KW, **kw)
    eng.start()
    try:
        prompt = np.arange(1, 7, dtype=np.int32)
        for _ in range(2):
            req = request_cls(prompt_ids=prompt, max_new_tokens=4)
            eng.submit(req)
            req.result(timeout=60.0)
    finally:
        eng.stop()
    sample = recorder.registry.get_sample_value
    values = {name: sample(family) for name, family in COUNTERS.items()}
    values["ttft_count"] = sample("generation_time_to_first_token_ms_count")
    values["tokens_per_request_count"] = sample("generation_tokens_per_request_count")
    values["tokens_per_request_sum"] = sample("generation_tokens_per_request_sum")
    values["active_slots"] = sample("generation_active_slots")
    values["pending"] = sample("generation_pending_requests")
    return values, eng


def test_generation_engine_metrics_equal_the_jax_engine():
    """tests/unit/test_timing_and_trace.py::test_generation_engine_metrics
    on both engines: the same counters, and the port's equal to its
    engine's own counts."""
    spec = jd.get_spec("llama-tiny", GEN_OPTS)
    params = jax.tree.map(np.asarray, jd.init_params(spec, np.random.default_rng(0)))
    want, _ = _generation_metrics(JaxEngine, JaxRequest, spec, params,
                                  jmetrics.MetricsRecorder(port=None, model_name="g"),
                                  dtype=jnp.float32)
    got, eng = _generation_metrics(GenerationEngine, GenerationRequest,
                                   td.get_spec("llama-tiny", GEN_OPTS), params,
                                   tmetrics.MetricsRecorder(port=None, model_name="g"),
                                   dtype=torch.float32, device="cpu")
    assert got == want
    assert got["generated_tokens_total"] == eng.generated_tokens == 8
    assert got["prefix_cache_hits_total"] == eng.prefix_hits == 1
    assert got["prefix_tokens_reused_total"] == eng.prefix_tokens_reused == 5
    assert got["ttft_count"] == got["tokens_per_request_count"] == 2
    assert got["active_slots"] == 0


# -- the port's additions -----------------------------------------------------------

def _scrape(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
        return resp.read().decode()


def port_is_listened_on(port: int) -> bool:
    """True while a socket listens on ``port`` (a listener refuses a
    second bind even with SO_REUSEADDR; a closed one leaves only
    TIME_WAIT connections, which SO_REUSEADDR lets through)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("0.0.0.0", port))
            s.listen(1)
        except OSError:
            return True
    return False


def test_ephemeral_exposer_serves_and_frees_its_port():
    rec = tmetrics.MetricsRecorder(port=0, model_name="m")
    try:
        port = rec.exposer_port
        assert port and port > 0
        rec.completed_total.inc(3)
        assert "inference_completed_total 3.0" in _scrape(port)
        assert port_is_listened_on(port)
    finally:
        rec.close()
    assert not port_is_listened_on(port)
    rec.close()  # closing twice is harmless


def test_cpu_process_sampling_leaves_device_families_unset():
    rec = tmetrics.MetricsRecorder(port=None, model_name="m")
    rec.sample_process_stats()
    text = generate_latest(rec.registry).decode()
    assert "gpu_memory_used_bytes{" not in text and "gpu_memory_total_bytes{" not in text
    assert "gpu_device_count 0.0" in text
    assert rec.registry.get_sample_value("process_resident_memory_bytes") > 0
    assert rec.registry.get_sample_value("process_open_fds") > 0
