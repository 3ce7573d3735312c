"""The port's batch pipeline on the CPU: queue, batching strategies,
collector, slot pool, lane scheduler, dispatcher and TaskRunner.

The queue, strategy, collector, lane-scheduler and dispatcher cases run
the same inputs through the JAX package's class and the port's class
(both are pure Python) and require the same observable result: pops,
rejections, decision sequences, batch groupings, lane picks and the
per-request slices. The cases of the JAX package's own unit tests
(tests/unit/test_serving_queue.py, test_strategies.py) are among them,
with their expected values. The runner cases drive ``add_one`` through
the whole pipeline and check each request's exact output (x + 1)."""

import threading
import time
import types

import numpy as np
import pytest
import torch

from starpu_inference_server_tpu.core import job as jax_job
from starpu_inference_server_tpu.serving import collector as jax_collector
from starpu_inference_server_tpu.serving import dispatcher as jax_dispatcher
from starpu_inference_server_tpu.serving import lanes as jax_lanes
from starpu_inference_server_tpu.serving import queue as jax_queue
from starpu_inference_server_tpu.serving import strategies as jax_strategies
from starpu_inference_server_tpu.utils import config as jax_config
from starpu_inference_server_tpu.utils import exceptions as jax_exceptions
from starpu_inference_server_tpu_torch.core import job as port_job
from starpu_inference_server_tpu_torch.core.engine import ModelEngine
from starpu_inference_server_tpu_torch.core.slot_pool import SlotPool
from starpu_inference_server_tpu_torch.core.timing import TimingInfo, compute_latency_breakdown
from starpu_inference_server_tpu_torch.models.registry import build_model
from starpu_inference_server_tpu_torch.serving import collector as port_collector
from starpu_inference_server_tpu_torch.serving import dispatcher as port_dispatcher
from starpu_inference_server_tpu_torch.serving import lanes as port_lanes
from starpu_inference_server_tpu_torch.serving import queue as port_queue
from starpu_inference_server_tpu_torch.serving import strategies as port_strategies
from starpu_inference_server_tpu_torch.serving.queue import InferenceQueue
from starpu_inference_server_tpu_torch.serving.runner import TaskRunner
from starpu_inference_server_tpu_torch.utils import config as port_config
from starpu_inference_server_tpu_torch.utils import exceptions as port_exceptions
from starpu_inference_server_tpu_torch.utils.clock import now_s
from starpu_inference_server_tpu_torch.utils.config import SchedulerPolicy, TensorSpec
from starpu_inference_server_tpu_torch.utils.exceptions import DeviceError

PORT = types.SimpleNamespace(
    name="port", job=port_job, queue=port_queue, strategies=port_strategies,
    collector=port_collector, dispatcher=port_dispatcher, lanes=port_lanes,
    config=port_config, exceptions=port_exceptions)
JAX = types.SimpleNamespace(
    name="jax", job=jax_job, queue=jax_queue, strategies=jax_strategies,
    collector=jax_collector, dispatcher=jax_dispatcher, lanes=jax_lanes,
    config=jax_config, exceptions=jax_exceptions)


def same_in_both(fn):
    """Run ``fn(side)`` for the JAX package and the port; the two results
    must be equal. Returns the port's."""
    want, got = fn(JAX), fn(PORT)
    assert got == want, f"port {got!r} != jax {want!r}"
    return got


def make_job(i=0, rows=1, width=4, side=PORT, dtype=np.float32, **kw):
    return side.job.InferenceJob({"input": np.full((rows, width), i, dtype)},
                                 request_id=f"r{i}", **kw)


def raw_cfg(strategy="fixed", **over):
    raw = {
        "name": "m",
        "model": {"family": "add_one", "compute_dtype": "FP32", "options": {"dims": [4]}},
        "inputs": [{"name": "input", "dims": [4], "dtype": "FP32"}],
        "outputs": [{"name": "output", "dims": [4], "dtype": "FP32"}],
        "pool_size": 2,
        "max_batch_size": 16,
        "batch_coalesce_timeout_ms": 2.0,
        "batching_strategy": strategy,
        "max_queue_size": 64,
        "max_inflight_tasks": 8,
        "metrics_enabled": False,
    }
    raw.update(over)
    return raw


def cfg_for(strategy="fixed", side=PORT, **over):
    return side.config.parse_config(raw_cfg(strategy, **over))


# -- InferenceQueue (the JAX package's cases) ---------------------------------

def test_queue_push_pop_fifo_and_counts():
    def trace(side):
        q = side.queue.InferenceQueue(max_size=4)
        for i in range(3):
            q.push(make_job(i, side=side))
        sizes = (q.size(), q.total_pushed)
        return sizes, [q.wait_and_pop().request_id for _ in range(3)], q.try_pop()

    assert same_in_both(trace) == ((3, 3), ["r0", "r1", "r2"], None)


@pytest.mark.parametrize("case", ["full_fails_fast", "closed_for_push_still_drains"])
def test_queue_rejects_pushes(case):
    def trace(side):
        q = side.queue.InferenceQueue(max_size=1)
        q.push(make_job(0, side=side))
        if case == "closed_for_push_still_drains":
            q.close_for_push()
        t0 = now_s()
        with pytest.raises(side.exceptions.PipelineError) as err:
            q.push(make_job(1, side=side))
        assert now_s() - t0 < 0.1  # no blocking
        return type(err.value).__name__, q.total_pushed, q.wait_and_pop().request_id

    want = "QueueClosedError" if case == "closed_for_push_still_drains" else "QueueFullError"
    assert same_in_both(trace) == (want, 1, "r0")


def test_queue_shutdown_wakes_a_blocked_consumer():
    def trace(side):
        q = side.queue.InferenceQueue(max_size=4)
        result = []
        t = threading.Thread(target=lambda: result.append(q.wait_and_pop(timeout=5.0)))
        t.start()
        time.sleep(0.05)
        q.shutdown()
        t.join(timeout=2.0)
        with pytest.raises(side.exceptions.QueueClosedError):
            q.push(make_job(side=side))
        return t.is_alive(), result, q.is_shutdown

    assert same_in_both(trace) == (False, [None], True)


@pytest.mark.parametrize("producer", [False, True])
def test_queue_deadline_pop(producer):
    def trace(side):
        q = side.queue.InferenceQueue(max_size=4)
        t0 = now_s()
        if producer:
            threading.Timer(0.02, lambda: q.push(make_job(9, side=side))).start()
            job = q.wait_for_and_pop(now_s() + 1.0)
            return job is not None and job.request_id
        assert q.wait_for_and_pop(now_s() + 0.05) is None
        return 0.03 < now_s() - t0 < 0.5

    assert same_in_both(trace) == ("r9" if producer else True)


def test_queue_reports_size_changes():
    def trace(side):
        sizes = []
        q = side.queue.InferenceQueue(max_size=4, on_size_change=lambda s, c: sizes.append((s, c)))
        q.push(make_job(side=side))
        q.push(make_job(1, side=side))
        q.wait_and_pop()
        q.try_pop()
        q.try_pop()  # empty: no report
        return sizes

    assert same_in_both(trace) == [(1, 4), (2, 4), (1, 4), (0, 4)]


# -- batching strategies: the same samples through both packages ---------------

def sample(side, tick, queue=0, congested=False, fill=None, prepared=0, inflight=0):
    return side.strategies.StrategyInput(
        queue_size=queue, queue_capacity=64, prepared_depth=prepared, inflight=inflight,
        max_inflight=8, congested=congested, ewma_queue_fill=fill, monitor_tick=tick)


def decisions(side, cfg_over, ticks):
    """Feed ``ticks`` (keyword dicts for ``sample``) to a fresh strategy;
    return each decision and the adaptive strategy's raw limit."""
    cfg = cfg_for(side=side, **cfg_over)
    s = side.strategies.make_batching_strategy(cfg)
    out = []
    for t in ticks:
        d = s.decide(sample(side, **t))
        out.append((d.target_batch_limit, d.coalesce_timeout_ms,
                    getattr(s, "current_limit", None)))
    return out


def ramp(n, start=1, **kw):
    return [dict(tick=start + i, **kw) for i in range(n)]


# Each scenario: the config's overrides and the tick sequence.
STRATEGY_SCENARIOS = {
    "disabled": ({"batching_strategy": "disabled"}, ramp(3, queue=60, congested=True)),
    "fixed": ({"batching_strategy": "fixed", "fixed_batching": {"batch_size": 8}},
              ramp(3, fill=0.9)),
    "adaptive_high": ({"batching_strategy": "adaptive"}, ramp(12, fill=0.8)),
    "adaptive_severe": ({"batching_strategy": "adaptive"}, ramp(8, fill=0.97)),
    "adaptive_raw_fill_and_backlog": (
        {"batching_strategy": "adaptive"},
        ramp(3, queue=50) + ramp(3, start=4, prepared=3, inflight=4)
        + ramp(3, start=7, queue=10, prepared=1)),
    "adaptive_decay_and_reset": (
        {"batching_strategy": "adaptive"},
        ramp(6, fill=0.9) + ramp(7, start=7, fill=0.1) + [dict(tick=14, fill=0.5)]
        + ramp(20, start=15, fill=0.0)),
    "adaptive_congested_zero_timeout": (
        {"batching_strategy": "adaptive", "batch_coalesce_timeout_ms": 0},
        [dict(tick=1, congested=True), dict(tick=2, fill=0.0), dict(tick=3, congested=True),
         dict(tick=4, fill=0.0)]),
    "adaptive_repeated_tick": (
        {"batching_strategy": "adaptive"},
        [dict(tick=1, fill=0.95)] * 3 + [dict(tick=2, fill=0.95)] * 2),
    "adaptive_wall_clock_refresh": ({"batching_strategy": "adaptive"},
                                    [dict(tick=-1, fill=0.95)] * 3),
    "adaptive_snapped_buckets": (
        {"batching_strategy": "adaptive", "batch_bucket_sizes": [1, 4, 16, 32],
         "max_batch_size": 32},
        ramp(14, fill=0.9)),
}


@pytest.mark.parametrize("scenario", sorted(STRATEGY_SCENARIOS))
def test_strategy_decisions_match_jax(scenario):
    over, ticks = STRATEGY_SCENARIOS[scenario]
    got = same_in_both(lambda side: decisions(side, over, ticks))
    assert len(got) == len(ticks)


@pytest.mark.parametrize("kind,cls", [("disabled", "DisabledBatchingStrategy"),
                                      ("fixed", "FixedBatchingStrategy"),
                                      ("adaptive", "AdaptiveBatchingStrategy")])
def test_strategy_factory(kind, cls):
    def built(side):
        cfg = cfg_for(kind, side=side)
        assert cfg.batching_strategy is side.config.BatchingStrategyKind(kind)
        return type(side.strategies.make_batching_strategy(cfg)).__name__

    assert same_in_both(built) == cls


def test_disabled_and_fixed_decisions():
    got = same_in_both(lambda side: decisions(
        side, {"batching_strategy": "disabled"}, [dict(tick=0, queue=100, congested=True)]))
    assert got == [(1, 0.0, None)]
    got = same_in_both(lambda side: decisions(
        side, {"fixed_batching": {"batch_size": 8}}, [dict(tick=0)]))
    assert got == [(8, 2.0, None)]


def test_adaptive_steps_up_under_pressure_and_decays():
    """Exact step sizes: +max(1, limit // entry_ticks) above pressure_high,
    doubled above pressure_severe, capped at max_batch_size; the limit
    is snapped up to the buckets (1, 2, 4, 8, 16)."""
    high = same_in_both(lambda side: decisions(side, {"batching_strategy": "adaptive"},
                                               ramp(12, fill=0.8)))
    assert [d[2] for d in high] == [2, 3, 4, 5, 6, 7, 8, 10, 12, 15, 16, 16]
    assert [d[0] for d in high] == [2, 4, 4, 8, 8, 8, 8, 16, 16, 16, 16, 16]
    assert [d[1] for d in high] == [2.0] * 12
    severe = same_in_both(lambda side: decisions(side, {"batching_strategy": "adaptive"},
                                                 ramp(6, fill=0.97)))
    assert [d[2] for d in severe] == [3, 5, 7, 9, 13, 16]
    # exit_horizon_ticks (8) low ticks in a row step the limit down by 1;
    # a tick between the two thresholds restarts the count
    ticks = ramp(3, fill=0.9) + ramp(7, start=4, fill=0.1) + [dict(tick=11, fill=0.5)] \
        + ramp(16, start=12, fill=0.0)
    decay = same_in_both(lambda side: decisions(side, {"batching_strategy": "adaptive"}, ticks))
    limits = [d[2] for d in decay]
    assert limits[:11] == [2, 3] + [4] * 9 and limits[17:19] == [4, 3]
    assert limits[-2:] == [3, 2]
    assert decay[-1][:2] == (2, 2.0)


@pytest.mark.parametrize("timeout_ms", [2.0, 0])
def test_adaptive_congestion_jumps_to_max_with_a_coalesce_window(timeout_ms):
    ticks = [dict(tick=1, congested=True), dict(tick=2, fill=0.0)]
    got = same_in_both(lambda side: decisions(
        side, {"batching_strategy": "adaptive", "batch_coalesce_timeout_ms": timeout_ms}, ticks))
    min_ms = cfg_for("adaptive").adaptive_batching.min_congested_coalesce_ms
    assert got == [(16, max(timeout_ms, min_ms), 16), (16, timeout_ms, 16)]


def test_adaptive_refreshes_once_per_tick_and_snaps_to_buckets():
    got = same_in_both(lambda side: decisions(side, {"batching_strategy": "adaptive"},
                                              [dict(tick=1, fill=0.95)] * 2))
    assert [d[2] for d in got] == [3, 3]
    snapped = same_in_both(lambda side: decisions(
        side, {"batching_strategy": "adaptive", "batch_bucket_sizes": [1, 4, 16]},
        ramp(19, fill=0.9)))
    assert {d[0] for d in snapped} == {4, 16}


# -- collector: the same queued jobs through both packages -----------------------

def test_can_merge_policy():
    def verdicts(side):
        a = make_job(0, side=side)
        others = [make_job(1, side=side), make_job(2, width=5, side=side),
                  make_job(3, fixed_lane_id=0, side=side), make_job(4, rows=3, side=side),
                  make_job(5, dtype=np.float64, side=side),
                  side.job.InferenceJob({"input": np.zeros((1, 4), np.float32),
                                         "extra": np.zeros((1, 2), np.float32)})]
        return [side.collector.can_merge(a, b) for b in others]

    assert same_in_both(verdicts) == [True, False, False, True, False, False]


def collect(side, cfg_over, jobs, congested=False):
    """Queue ``jobs`` (keyword dicts for ``make_job``), run the collector
    until every row is prepared; return each prepared batch as
    (request ids, effective_batch, bucket_size)."""
    cfg = cfg_for(side=side, **cfg_over)
    q = side.queue.InferenceQueue(64)
    for i, spec in enumerate(jobs):
        q.push(make_job(i, side=side, **spec))
    prepared = []
    inflight = side.collector.InflightTracker(cfg.max_inflight_tasks)

    def on_prepared(master):
        prepared.append(master)
        inflight.decrement()

    collector = side.collector.BatchCollector(
        cfg, q, side.strategies.make_batching_strategy(cfg), inflight,
        sample_provider=lambda: sample(side, 1, congested=congested),
        on_prepared=on_prepared)
    collector.start()
    rows = sum(spec.get("rows", 1) for spec in jobs)
    deadline = now_s() + 5
    while sum(m.effective_batch for m in prepared) < rows and now_s() < deadline:
        time.sleep(0.01)
    collector.stop()
    q.shutdown()
    collector.join(timeout=2)
    return [([j.request_id for j in (m, *m.sub_jobs)], m.effective_batch, m.bucket_size)
            for m in prepared]


@pytest.mark.parametrize("strategy,want", [("disabled", [1, 1, 1, 1, 1]),
                                           ("fixed", [3, 2])])
def test_collector_coalesces_waiting_jobs(strategy, want):
    """Fixed batching at 3 coalesces five queued single-row jobs into
    3 + 2; disabled batching never merges."""
    over = {"batching_strategy": strategy, "fixed_batching": {"batch_size": 3},
            "batch_coalesce_timeout_ms": 50}
    got = same_in_both(lambda side: collect(side, over, [{}] * 5))
    assert [b[1] for b in got] == want
    assert [i for b in got for i in b[0]] == [f"r{i}" for i in range(5)]
    assert all(b[2] == cfg_for().bucket_for(b[1]) for b in got)


FIXED_8 = {"fixed_batching": {"batch_size": 8}, "batch_coalesce_timeout_ms": 50}
COLLECTOR_SCENARIOS = {
    # a job that would overflow the sample cap waits for the next batch
    "row_cap_overflow": (FIXED_8, [{"rows": 3}, {"rows": 4}, {"rows": 2}, {"rows": 1},
                                   {"rows": 5}, {"rows": 1}], False),
    # a job of another per-sample shape ends the batch and starts the next
    "shape_break": (FIXED_8, [{}, {}, {"width": 5}, {"width": 5}, {}], False),
    # a pinned (warmup) job is never merged
    "pinned_job": (FIXED_8, [{}, {"fixed_lane_id": 1}, {}, {}], False),
    # no coalesce window: only jobs already waiting are drained, up to the cap
    "zero_timeout_drains_waiting": ({"fixed_batching": {"batch_size": 4},
                                     "batch_coalesce_timeout_ms": 0}, [{}] * 6, False),
    # congestion jumps the adaptive limit to max_batch_size (16)
    "adaptive_congested": ({"batching_strategy": "adaptive", "batch_coalesce_timeout_ms": 50},
                           [{"rows": 2}] * 10, True),
    # no pressure: the adaptive limit stays 1 and nothing is merged
    "adaptive_calm": ({"batching_strategy": "adaptive", "batch_coalesce_timeout_ms": 50},
                      [{}] * 4, False),
}


@pytest.mark.parametrize("scenario", sorted(COLLECTOR_SCENARIOS))
def test_collector_groups_like_jax(scenario):
    over, jobs, congested = COLLECTOR_SCENARIOS[scenario]
    got = same_in_both(lambda side: collect(side, over, jobs, congested))
    assert [i for b in got for i in b[0]] == [f"r{i}" for i in range(len(jobs))]


def test_collector_row_cap_grouping():
    got = same_in_both(lambda side: collect(side, *COLLECTOR_SCENARIOS["row_cap_overflow"][:2]))
    assert got == [(["r0", "r1"], 7, 8), (["r2", "r3", "r4"], 8, 8), (["r5"], 1, 1)]


# -- dispatcher: the same batch outputs sliced by both packages ----------------

def dispatch(side, error=None):
    """Fan a batch of four jobs (rows 2, 1, 3, 1; the third cancelled)
    out through the dispatcher; return what each completion received."""
    got = []

    def completion(job, outputs, err):
        got.append((job.request_id,
                    None if outputs is None else {k: v.tolist() for k, v in outputs.items()},
                    type(err).__name__ if err is not None else None))

    jobs = [make_job(i, rows=r, side=side, completion=completion)
            for i, r in enumerate([2, 1, 3, 1])]
    for j in jobs:
        j.timing.stamp("enqueued_at")
    jobs[2].cancel()
    master = jobs[0]
    master.sub_jobs, master.logical_jobs = jobs[1:], 4
    master.is_batched_master, master.effective_batch = True, 7
    inflight = side.collector.InflightTracker(4)
    inflight.increment()
    d = side.dispatcher.ResultDispatcher(inflight)
    outputs = {"output": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
               "ids": np.arange(8, dtype=np.int32)}
    d.complete(master, None if error else outputs, error)
    return (got, d.completed_jobs, d.failed_jobs, inflight.count(),
            {size: agg["count"] for size, agg in d.batch_stats.items()},
            all(j.latency_breakdown["total_ms"] >= 0 for j in jobs))


@pytest.mark.parametrize("fails", [False, True])
def test_dispatcher_slices_like_jax(fails):
    got = same_in_both(lambda side: dispatch(
        side, side.exceptions.InferenceExecutionError("boom") if fails else None))
    completions, completed, failed, inflight, stats, timed = got
    assert (completed, failed, inflight, timed) == (4, 4 if fails else 0, 0, True)
    assert stats == ({} if fails else {7: 1})
    if fails:
        assert [c[2] for c in completions] == ["InferenceExecutionError"] * 4
        return
    rows = np.arange(8 * 3).reshape(8, 3).tolist()
    assert completions == [
        ("r0", {"output": rows[0:2], "ids": [0, 1]}, None),
        ("r1", {"output": rows[2:3], "ids": [2]}, None),
        ("r2", None, "CancelledError"),
        ("r3", {"output": rows[6:7], "ids": [6]}, None),
    ]


# -- slot pool and timing -------------------------------------------------------

def test_slot_pool_stages_float_inputs_as_bf16_and_guards_release():
    specs = [TensorSpec("input", (3,), "BF16"), TensorSpec("ids", (2,), "INT64")]
    pool = SlotPool(specs, max_batch=4, pool_size=1)
    slot = pool.acquire()
    x = np.array([[1.0, 1.00390625, -2.5e-3]], np.float32)
    x.setflags(write=False)  # a request's bytes are read-only views
    slot.write("input", 2, x)
    slot.write("ids", 0, np.array([[7, 8], [9, 10]], np.int64))
    view = slot.view(3)
    assert view["input"].dtype == torch.bfloat16
    assert torch.equal(view["input"][2], torch.from_numpy(x[0].copy()).to(torch.bfloat16))
    assert view["ids"][:2].tolist() == [[7, 8], [9, 10]]
    assert pool.acquire(timeout=0.01) is None  # the one slot is taken
    pool.release(slot)
    with pytest.raises(port_exceptions.PipelineError, match="double release"):
        pool.release(slot)


def test_latency_breakdown_from_stamps():
    t = TimingInfo(enqueued_at=1.0, dequeued_at=1.002, batch_collect_start=1.002,
                   batch_collect_end=1.004, before_submit_at=1.005, lane_start_at=1.006,
                   codelet_start_at=1.006, inference_start_at=1.007, codelet_end_at=1.010,
                   callback_start_at=1.010, callback_end_at=1.011)
    b = compute_latency_breakdown(t)
    assert b["queue_ms"] == pytest.approx(2.0) and b["inference_ms"] == pytest.approx(3.0)
    assert b["total_ms"] == pytest.approx(11.0)


# -- lane scheduler ---------------------------------------------------------------

class _Lane:
    def __init__(self, backlog, cost):
        self._backlog, self._cost = backlog, cost

    def backlog(self):
        return self._backlog

    def estimated_finish_ms(self, bucket):
        return self._cost * (self._backlog + 1)


@pytest.mark.parametrize("policy,want", [
    (SchedulerPolicy.ROUND_ROBIN, [0, 1, 2, 0]),
    (SchedulerPolicy.LEAST_LOADED, [1, 1, 1, 1]),
    (SchedulerPolicy.EWMA, [2, 2, 2, 2]),
])
def test_lane_scheduler_policies(policy, want):
    def picks(side):
        lanes = [_Lane(3, 1.0), _Lane(0, 10.0), _Lane(1, 1.0)]
        sched = side.lanes.LaneScheduler(lanes, side.config.SchedulerPolicy(policy.value))
        got = [lanes.index(sched.pick(make_job(i, side=side))) for i in range(4)]
        # warmup pinning: fixed_lane_id modulo the lane count
        return got + [lanes.index(sched.pick(make_job(9, side=side, fixed_lane_id=4)))]

    assert same_in_both(picks) == want + [1]


# -- the runner on add_one -------------------------------------------------------

@pytest.fixture
def runner():
    cfg = cfg_for("fixed", fixed_batching={"batch_size": 8}, batch_coalesce_timeout_ms=20,
                  devices={"lanes_per_device": 2})
    engine = ModelEngine(cfg, build_model(cfg.model, seed=cfg.seed, device="cpu"))
    r = TaskRunner(cfg, engine, InferenceQueue(cfg.max_queue_size))
    assert r.warmup() == 2 * len(cfg.buckets)
    yield r
    r.stop()


def test_runner_slices_batched_outputs_per_request(runner):
    done, results = threading.Event(), {}

    def completion(job, outputs, error):
        results[job.request_id] = (outputs, error, job.latency_breakdown)
        if len(results) == 6:
            done.set()

    sizes = [1, 3, 2, 1, 4, 2]
    for i, rows in enumerate(sizes):
        job = make_job(i, rows=rows, completion=completion)
        job.inputs["input"] = job.inputs["input"] + np.arange(rows, dtype=np.float32)[:, None]
        job.timing.stamp("enqueued_at")
        runner.queue.push(job)
    assert done.wait(10)
    for i, rows in enumerate(sizes):
        outputs, error, breakdown = results[f"r{i}"]
        assert error is None
        want = i + np.arange(rows, dtype=np.float32)[:, None] + 1 + np.zeros((rows, 4))
        np.testing.assert_array_equal(outputs["output"], want)
        assert breakdown["total_ms"] >= breakdown["inference_ms"] >= 0
    stats = runner.dispatcher.batch_stats
    assert sum(size * agg["count"] for size, agg in stats.items()) == sum(sizes)
    assert runner.dispatcher.completed_jobs >= 6


def test_cancelled_job_completes_once_with_an_error(runner):
    got = []
    job = make_job(1, completion=lambda j, o, e: got.append(type(e).__name__))
    job.cancel()
    job.timing.stamp("enqueued_at")
    runner.queue.push(job)
    deadline = now_s() + 5
    while not got and now_s() < deadline:
        time.sleep(0.01)
    assert got == ["CancelledError"]


def test_engine_requires_one_device_and_stages_bf16():
    cfg = cfg_for("fixed", devices={"mesh": {"pipe": 2}})
    model = build_model(cfg.model, device="cpu")
    with pytest.raises(DeviceError, match="has no pipeline_apply"):
        ModelEngine(cfg, model)
    cfg = cfg_for("fixed", model={"family": "add_one", "compute_dtype": "BF16",
                                  "options": {"dims": [4]}})
    engine = ModelEngine(cfg, build_model(cfg.model, device="cpu"))
    assert [s.dtype for s in engine.staging_specs()] == ["BF16"]
    out = engine.conform_outputs(engine.fetch(engine.run_padded(
        {"input": torch.ones(2, 4, dtype=torch.bfloat16)})))
    assert out["output"].dtype == np.float32 and (out["output"] == 2).all()


def test_engine_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this case checks the refusal on a machine without CUDA")
    cfg = cfg_for("fixed")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg.model)
