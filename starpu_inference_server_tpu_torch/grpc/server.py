"""Server bootstrap: config -> observability -> model -> engine -> warmup
-> gRPC.

Counterpart of ``starpu_inference_server_tpu/grpc/server.py``. Run it with

    python -m starpu_inference_server_tpu_torch.grpc.server --config configs/resnet18_int8.yml

(``--device cpu`` serves on the CPU). It logs ``serving <name> on
<address>`` when it is ready, and the kernel launches of the process so
far (``kernel launches ...: {json}``) once warmed up and at shutdown.

A config whose ``devices.mesh`` has more than one position runs as one
process per mesh position (``parallel/launch.py:serve_mesh``): with a
``pipe`` axis the pipelined decoder (``configs/llama_pipelined.yml``) or
the GPipe batch forward, without one GSPMD mode (slot-sharded generation
over ``data``, tensor- and expert-parallel weights; the batch pipeline on
a data- and tensor-parallel ``ModelEngine``). Rank 0 builds the weights,
sends every rank its shard and serves gRPC (the whole batch pipeline,
queue -> collector -> lanes -> engine, runs there), the other ranks
follow its commands; the backend is ``nccl`` when each rank
has a GPU of its own and ``gloo`` when they share one or run on the CPU
(``--device cpu``), and is printed as ``mesh backend: ...``. With
``distributed.coordinator_address`` set the process is one of
``distributed.num_processes`` launchers (the JAX server's
``jax.distributed`` processes, one a host): launcher
``distributed.process_id`` spawns its ``mesh.size / num_processes``
consecutive ranks, which join that address (launcher 0's first rank
hosts the store, serves and drives them all); ``process_id: -1`` and
``num_processes: 0`` are read from ``OMPI_COMM_WORLD_RANK`` /
``OMPI_COMM_WORLD_SIZE`` or ``SLURM_PROCID`` / ``SLURM_NTASKS``.
``--timeout-s`` bounds every collective: a rank or launcher that dies or
hangs makes every launcher exit non-zero; SIGINT / SIGTERM to launcher 0
stop them all with 0.

Decoder families get the continuous-batching generation engine (with
its draft model, prompt lookup, paged cache and prefix cache as the
config's options ask, see ``serving/generation.py:build_generation_engine``);
every other family, and a decoder with ``model.options.serve_logits:
true`` (teacher-forced logits of ``input_ids``, the JAX server's scoring
service), gets the batch pipeline: ``ModelEngine``, the bounded
``InferenceQueue`` and the ``TaskRunner`` (collector, lanes,
dispatcher), warmed up by ``TaskRunner.warmup()``. A batch server answers
``ModelStreamInfer`` UNIMPLEMENTED, as the JAX server does. It serves on the GPU
(``cuda``); ``InferenceServer(cfg, device="cpu")`` serves on the CPU, as
the tests do.

Wired as the JAX server wires it: the config's observability (Prometheus
recorder on ``metrics_port``, 0 for an ephemeral port, and the batching
trace logger) reaches the queue, the runner, the servicer and the
generation engine; the congestion monitor ticks on its own thread and
the adaptive strategy reads its snapshot; a batch server's
RepositoryModelLoad rebuilds the weights from the config and hot-swaps
them. Shutdown: close the queue, stop gRPC, drain, stop the monitor, the
sampler and the exposer, flush the traces, fork the plot script.
``profiler_port`` has no effect: ``torch.profiler`` has no server to
attach to, and device traces are taken by the caller.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import subprocess
import sys
from pathlib import Path
from typing import Optional

import grpc
import numpy as np

from ..core.engine import ModelEngine
from ..models.registry import build_model, get_family
from ..monitoring.congestion import CongestionMonitor
from ..monitoring.metrics import MetricsRecorder
from ..monitoring.observability import RuntimeObservability, create_observability
from ..ops._build import launch_counters
from ..serving.generation import build_generation_engine
from ..serving.queue import InferenceQueue
from ..serving.runner import TaskRunner
from ..utils.clock import StopWatch
from ..utils.config import RuntimeConfig, load_config
from ..utils.logger import get_logger, set_global_verbosity
from .service import InferenceServicer, add_inference_service

# scripts/plot_batch_summary.py of the checkout holding this package
PLOT_SCRIPT = Path(__file__).resolve().parents[2] / "scripts" / "plot_batch_summary.py"


def _log_launches(when: str) -> None:
    """The kernel launches of this process so far, by kernel (those launched)."""
    counts = {k: v for table in launch_counters() for k, v in table.items() if v}
    get_logger().info("kernel launches %s: %s", when, json.dumps(counts, sort_keys=True))


def _log_mesh(server, when: str) -> None:
    """Every rank's kernel launches and collectives so far, and a
    generation engine's steps and loop timers (a mesh server's
    statistics)."""
    from ..parallel.launch import mesh_worker

    stats = {"ranks": mesh_worker(server).gather_stats()}
    eng = server.generation_engine
    if eng is not None:
        stats.update(steps=eng.steps, loop_timers=eng.loop_timers)
    get_logger().info("mesh statistics %s: %s", when, json.dumps(stats, sort_keys=True))


def _log_congestion(congested: bool, snap) -> None:
    get_logger().info("congestion %s at tick %d (score %.2f, rho %.2f, fill %.2f, p95 %.1f ms)",
                      "entered" if congested else "cleared", snap.tick, snap.score,
                      snap.ewma_rho, snap.ewma_queue_fill or 0.0, snap.p95_ms)


class InferenceServer:
    """Owns the serving stack for one model (exactly one model per
    process, as in the reference)."""

    def __init__(self, cfg: RuntimeConfig, device=None,
                 observability: Optional[RuntimeObservability] = None,
                 expose_metrics: bool = True, mesh=None, params=None):
        """``mesh``: rank 0's ``parallel.mesh.RankMesh`` of a mesh config
        (``parallel/launch.py:rank_main`` passes it). ``params``: a decoder's
        parameter tree already built on ``device`` (one tree may serve
        several engines of a process); built from the config when None."""
        self.cfg = cfg
        self.mesh = mesh
        self._params = params
        set_global_verbosity(cfg.verbosity)
        self.observability = (observability if observability is not None
                              else create_observability(cfg, expose_metrics=expose_metrics))
        try:
            self._build(cfg, device)
        except BaseException:
            self._close_metrics()  # a failed start frees the exposer's port
            raise
        self._grpc_server: Optional["grpc.aio.Server"] = None
        self.bound_port = 0

    @property
    def recorder(self) -> Optional[MetricsRecorder]:
        """The Prometheus recorder (None when ``metrics_enabled`` is false)."""
        metrics = self.observability.metrics
        return metrics if isinstance(metrics, MetricsRecorder) else None

    @property
    def metrics_port(self) -> Optional[int]:
        """The port ``/metrics`` is served on (None: not exposed)."""
        return None if self.recorder is None else self.recorder.exposer_port

    def _build(self, cfg: RuntimeConfig, device) -> None:
        watch = StopWatch()
        self.queue = InferenceQueue(cfg.max_queue_size,
                                    on_size_change=self.observability.on_queue_size)
        self.congestion = CongestionMonitor(
            cfg.congestion,
            queue_probe=lambda: (self.queue.size(), self.queue.capacity),
            on_state_change=_log_congestion,
            # every tick's snapshot reaches the gauges (the JAX server
            # publishes only at state changes)
            on_tick=self.observability.on_congestion_snapshot,
        )
        self.generation_engine = None
        self.engine = None
        self.runner = None
        definition = get_family(cfg.model.family, cfg.model.options)
        serve_logits = bool(cfg.model.options.get("serve_logits", False))
        if definition.supports_generation and not serve_logits:
            self.generation_engine = build_generation_engine(cfg, device=device,
                                                             params=self._params,
                                                             metrics=self.recorder,
                                                             mesh=self.mesh)
            self.device = self.generation_engine.device
        else:
            self.engine = ModelEngine(cfg, build_model(cfg.model, seed=cfg.seed, device=device),
                                      mesh=self.mesh)
            self.runner = TaskRunner(cfg, self.engine, self.queue,
                                     observability=self.observability,
                                     congestion_monitor=self.congestion)
            self.device = self.engine.device
        self.servicer = InferenceServicer(
            cfg, self.queue,
            observability=self.observability,
            congestion_monitor=self.congestion,
            generation_engine=self.generation_engine,
            # a generation server holds decode state against its params:
            # its RepositoryModelLoad only gates
            reload_model=self._reload_model if self.runner is not None else None,
        )
        if self.runner is not None:
            self.servicer.batch_stats_source = self.runner.dispatcher
        load_ms = watch.elapsed_ms()
        if self.recorder is not None:
            self.recorder.model_load_duration.observe(load_ms)
            self.recorder.models_loaded.set(1)
            self.recorder.max_inflight.set(cfg.max_inflight_tasks)
        get_logger().info("model %s built on %s (quant=%s) in %.1f ms", cfg.model.family,
                          self.device, cfg.model.quantization.value, load_ms)

    # -- repository ----------------------------------------------------------

    def _reload_model(self) -> None:
        """RepositoryModelLoad: rebuild the model from the config's source
        on the engine's device and hot-swap it into the engine."""
        watch = StopWatch()
        self.engine.reload(build_model(self.cfg.model, seed=self.cfg.seed,
                                       device=self.engine.device))
        get_logger().info("model %s reloaded in %.1f ms", self.cfg.name, watch.elapsed_ms())

    # -- lifecycle -------------------------------------------------------------

    def start_pipeline(self, warmup: bool = True) -> None:
        log = get_logger()
        if self.runner is not None:
            for lane in self.runner.lanes:
                log.info("lane %d: %s (buckets %s)", lane.lane_id, lane.name(),
                         list(self.engine.buckets))
            if warmup:
                watch = StopWatch()
                n = self.runner.warmup()
                log.info("warmup: %d pinned jobs in %.1f ms", n, watch.elapsed_ms())
            else:
                self.runner.start()
        else:
            eng = self.generation_engine
            eng.start()
            if warmup:
                watch = StopWatch()
                # one prompt per prefill bucket, and one a token past the
                # chunk size, so every path has run once before traffic
                room = eng.headroom()
                for bucket in eng.prefill_buckets:
                    if bucket + 2 + room <= eng.max_len:
                        eng.generate(np.ones((bucket,), np.int32), max_new_tokens=2,
                                     timeout=1800.0)
                chunk = eng.prefill_chunk
                if chunk and chunk + 3 + room <= eng.max_len:
                    eng.generate(np.ones((chunk + 1,), np.int32), max_new_tokens=2,
                                 timeout=1800.0)
                log.info("decoder warmup in %.1f ms", watch.elapsed_ms())
        self.congestion.start()
        if self.recorder is not None:
            self.recorder.start_sampler()
            self.recorder.server_health.set(1)
        self.servicer.ready.set()

    async def serve(self, warmup: bool = True, ready_event=None) -> None:
        log = get_logger()
        self.start_pipeline(warmup=warmup)
        if self.mesh is not None:  # before the port opens: the engine is idle
            _log_mesh(self, "after warmup")
        max_bytes = self.cfg.resolved_max_message_bytes
        server = grpc.aio.server(options=[
            ("grpc.max_receive_message_length", max_bytes),
            ("grpc.max_send_message_length", max_bytes),
        ])
        add_inference_service(server, self.servicer)
        self.bound_port = server.add_insecure_port(self.cfg.server.address)
        await server.start()
        self._grpc_server = server
        _log_launches("after warmup")
        log.info("serving %s on %s (port %d; metrics port %s)", self.cfg.name,
                 self.cfg.server.address, self.bound_port, self.metrics_port)
        if ready_event is not None:
            ready_event.set()
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except (NotImplementedError, RuntimeError):
                pass
        self._stop_event = stop
        await stop.wait()
        await self.shutdown()

    async def shutdown(self) -> None:
        """Close the queue for push, stop accepting, drain, stop the
        monitor, the sampler and the exposer, flush the traces."""
        log = get_logger()
        log.info("shutdown: closing queue for push")
        self.queue.close_for_push()
        self.servicer.ready.clear()
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=5.0)
        if self.runner is not None:
            self.runner.stop(drain=True)
        else:
            self.generation_engine.stop()
        if self.mesh is not None:
            _log_mesh(self, "at shutdown")
        self.congestion.stop()
        if self.recorder is not None:
            self.recorder.server_health.set(0)
        self._close_metrics()
        self.observability.flush()
        self._run_trace_plots()
        if self.runner is not None:
            d = self.runner.dispatcher
            log.info("shutdown complete: completed=%d failed=%d "
                     "throughput_window=%.1f inf/s over %.1f s", d.completed_jobs,
                     d.failed_jobs, d.perf.throughput(), d.perf.window_s())
        else:
            log.info("shutdown complete: generated_tokens=%d steps=%d",
                     self.generation_engine.generated_tokens, self.generation_engine.steps)
        _log_launches("at shutdown")

    def _close_metrics(self) -> None:
        """Stop the sampler thread and free the exposer's port."""
        if self.recorder is not None:
            self.recorder.close()

    def _run_trace_plots(self) -> None:
        """Fork the plot script over the trace files at shutdown, as the
        JAX server does (the reference forks scripts/plot_batch_summary.py)."""
        if not self.cfg.trace_enabled or not self.cfg.trace_output:
            return
        try:
            subprocess.Popen([sys.executable, str(PLOT_SCRIPT), self.cfg.trace_output],
                             stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        except OSError:
            pass

    def request_stop(self) -> None:
        if hasattr(self, "_stop_event"):
            self._stop_event.set()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="PyTorch/CUDA inference server (KServe v2 gRPC)"
    )
    parser.add_argument("--config", required=True, help="YAML config file")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--timeout-s", type=float, default=300.0,
                        help="a mesh's collective timeout, seconds (default 300)")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    if cfg.devices.mesh.size > 1:
        from ..parallel.launch import serve_mesh

        return serve_mesh(args.config, cfg, args.device, args.timeout_s)
    server = InferenceServer(cfg, device=args.device)
    asyncio.run(server.serve())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
