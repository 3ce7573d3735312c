"""Server bootstrap: config -> model -> generation engine -> warmup -> gRPC.

Counterpart of ``starpu_inference_server_tpu/grpc/server.py`` for
decoder families. Run it with

    python -m starpu_inference_server_tpu_torch.grpc.server --config configs/llama_decoder.yml

It serves on the GPU (``cuda``); ``InferenceServer(cfg, device="cpu")``
serves on the CPU, as the tests do. Non-decoder families raise "not yet
ported". Metrics and congestion control wait for the batch-pipeline
slice: the server runs with ``observability=None`` and says so once.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
from typing import Optional

import grpc
import numpy as np

from ..serving.generation import build_generation_engine
from ..utils.clock import StopWatch
from ..utils.config import RuntimeConfig, load_config
from ..utils.logger import get_logger, set_global_verbosity
from .service import InferenceServicer, add_inference_service


class InferenceServer:
    """Owns the serving stack for one decoder model."""

    def __init__(self, cfg: RuntimeConfig, device=None):
        self.cfg = cfg
        log = get_logger()
        set_global_verbosity(cfg.verbosity)
        self.observability = None
        log.info("metrics and congestion control are not yet ported: "
                 "serving with observability=None")
        watch = StopWatch()
        self.generation_engine = build_generation_engine(cfg, device=device)
        log.info("model %s built on %s (quant=%s) in %.1f ms", cfg.model.family,
                 self.generation_engine.device, cfg.model.quantization.value,
                 watch.elapsed_ms())
        self.servicer = InferenceServicer(cfg, self.generation_engine)
        self._grpc_server: Optional["grpc.aio.Server"] = None
        self.bound_port = 0

    def start_pipeline(self, warmup: bool = True) -> None:
        log = get_logger()
        eng = self.generation_engine
        eng.start()
        if warmup:
            watch = StopWatch()
            # one prompt per prefill bucket, and one a token past the
            # chunk size, so every path has run once before traffic
            for bucket in eng.prefill_buckets:
                if bucket + 2 <= eng.max_len:
                    eng.generate(np.ones((bucket,), np.int32), max_new_tokens=2, timeout=1800.0)
            chunk = eng.prefill_chunk
            if chunk and chunk + 3 <= eng.max_len:
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
        self.servicer.ready.clear()
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=5.0)
        self.generation_engine.stop()
        log.info("shutdown complete: generated_tokens=%d steps=%d",
                 self.generation_engine.generated_tokens, self.generation_engine.steps)

    def request_stop(self) -> None:
        if hasattr(self, "_stop_event"):
            self._stop_event.set()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="PyTorch/CUDA inference server (KServe v2 gRPC, decoder generation)"
    )
    parser.add_argument("--config", required=True, help="YAML config file")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    server = InferenceServer(cfg)
    asyncio.run(server.serve())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
