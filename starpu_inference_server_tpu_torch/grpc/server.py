"""Server bootstrap: config -> model -> engine -> warmup -> gRPC.

Counterpart of ``starpu_inference_server_tpu/grpc/server.py``. Run it with

    python -m starpu_inference_server_tpu_torch.grpc.server --config configs/resnet18_int8.yml

Decoder families get the continuous-batching generation engine (with
its draft model, prompt lookup, paged cache and prefix cache as the
config's options ask, see ``serving/generation.py:build_generation_engine``);
every other family gets the batch pipeline: ``ModelEngine``, the bounded
``InferenceQueue`` and the ``TaskRunner`` (collector, lanes,
dispatcher), warmed up by ``TaskRunner.warmup()``. It serves on the GPU
(``cuda``); ``InferenceServer(cfg, device="cpu")`` serves on the CPU, as
the tests do. Metrics and congestion control are not ported yet: the
server runs with ``observability=None`` and ``congestion=None`` and says
so once.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
from typing import Optional

import grpc
import numpy as np

from ..core.engine import ModelEngine
from ..models.registry import build_model, get_family
from ..serving.generation import build_generation_engine
from ..serving.queue import InferenceQueue
from ..serving.runner import TaskRunner
from ..utils.clock import StopWatch
from ..utils.config import RuntimeConfig, load_config
from ..utils.logger import get_logger, set_global_verbosity
from .service import InferenceServicer, add_inference_service


class InferenceServer:
    """Owns the serving stack for one model (exactly one model per
    process, as in the reference)."""

    def __init__(self, cfg: RuntimeConfig, device=None):
        self.cfg = cfg
        log = get_logger()
        set_global_verbosity(cfg.verbosity)
        self.observability = None
        self.congestion = None
        log.info("metrics and congestion control are not yet ported: "
                 "serving with observability=None, congestion=None")
        watch = StopWatch()
        self.generation_engine = None
        self.engine = None
        self.queue = None
        self.runner = None
        definition = get_family(cfg.model.family, cfg.model.options)
        if definition.supports_generation:
            self.generation_engine = build_generation_engine(cfg, device=device)
            where = self.generation_engine.device
        else:
            self.engine = ModelEngine(cfg, build_model(cfg.model, seed=cfg.seed, device=device))
            self.queue = InferenceQueue(cfg.max_queue_size)
            self.runner = TaskRunner(cfg, self.engine, self.queue)
            where = self.engine.device
        log.info("model %s built on %s (quant=%s) in %.1f ms", cfg.model.family, where,
                 cfg.model.quantization.value, watch.elapsed_ms())
        self.servicer = InferenceServicer(cfg, queue=self.queue,
                                          generation_engine=self.generation_engine)
        if self.runner is not None:
            self.servicer.batch_stats_source = self.runner.dispatcher
        self._grpc_server: Optional["grpc.aio.Server"] = None
        self.bound_port = 0

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
            self.servicer.ready.set()
            return
        eng = self.generation_engine
        eng.start()
        if warmup:
            watch = StopWatch()
            # one prompt per prefill bucket, and one a token past the
            # chunk size, so every path has run once before traffic
            room = eng.headroom()
            for bucket in eng.prefill_buckets:
                if bucket + 2 + room <= eng.max_len:
                    eng.generate(np.ones((bucket,), np.int32), max_new_tokens=2, timeout=1800.0)
            chunk = eng.prefill_chunk
            if chunk and chunk + 3 + room <= eng.max_len:
                eng.generate(np.ones((chunk + 1,), np.int32), max_new_tokens=2, timeout=1800.0)
            log.info("decoder warmup in %.1f ms", watch.elapsed_ms())
        self.servicer.ready.set()

    async def serve(self, warmup: bool = True, ready_event=None) -> None:
        log = get_logger()
        self.start_pipeline(warmup=warmup)
        max_bytes = self.cfg.resolved_max_message_bytes
        server = grpc.aio.server(options=[
            ("grpc.max_receive_message_length", max_bytes),
            ("grpc.max_send_message_length", max_bytes),
        ])
        add_inference_service(server, self.servicer)
        self.bound_port = server.add_insecure_port(self.cfg.server.address)
        await server.start()
        self._grpc_server = server
        log.info("serving %s on %s (port %d)", self.cfg.name, self.cfg.server.address,
                 self.bound_port)
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
        log = get_logger()
        if self.queue is not None:
            self.queue.close_for_push()
        self.servicer.ready.clear()
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=5.0)
        if self.runner is not None:
            self.runner.stop(drain=True)
            d = self.runner.dispatcher
            log.info("shutdown complete: completed=%d failed=%d "
                     "throughput_window=%.1f inf/s over %.1f s", d.completed_jobs,
                     d.failed_jobs, d.perf.throughput(), d.perf.window_s())
            return
        self.generation_engine.stop()
        log.info("shutdown complete: generated_tokens=%d steps=%d",
                 self.generation_engine.generated_tokens, self.generation_engine.steps)

    def request_stop(self) -> None:
        if hasattr(self, "_stop_event"):
            self._stop_event.set()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="PyTorch/CUDA inference server (KServe v2 gRPC)"
    )
    parser.add_argument("--config", required=True, help="YAML config file")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    server = InferenceServer(cfg)
    asyncio.run(server.serve())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
