"""The gRPC inference service (asyncio).

Counterpart of ``starpu_inference_server_tpu/grpc/service.py``:
ServerLive, ServerReady, ModelReady, ServerMetadata, ModelMetadata,
ModelStatistics and ``ModelInfer`` on two routes: the batch pipeline
(validate, queue, batch, execute on a lane, slice; the completion
resolves an asyncio future from the dispatcher's thread) for every
non-decoder model, and full generation for decoders, whose
``ModelStreamInfer`` answers one response per generated token. The
standard health service is registered too. Every other RPC of the
KServe-v2 table answers UNIMPLEMENTED until its slice is ported.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Dict

import grpc
import numpy as np

from .. import __version__
from ..core.job import InferenceJob
from ..serving.generation import GenerationRequest
from ..utils.clock import now_s, wall_ms
from ..utils.config import RuntimeConfig
from ..utils.exceptions import CancelledError, QueueClosedError, QueueFullError, TensorError
from . import kserve_v2_pb2 as pb
from .io import (
    extract_prompt,
    fill_timing_fields,
    generation_params,
    populate_response,
    validate_and_convert_inputs,
)

SERVER_NAME = "starpu-inference-server-tpu-torch"
SERVICE_FULL_NAME = "inference.GRPCInferenceService"
PLATFORM = "pytorch_cuda"


class _ModelStats:
    """Per-model statistics aggregates of the batch route (reference:
    inference_service.hpp:482-521)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.inference_count = 0
        self.execution_count = 0
        self.last_inference_ms = 0
        self.success_count = 0
        self.success_ns = 0
        self.fail_count = 0
        self.fail_ns = 0
        self.queue_ns = 0
        self.infer_ns = 0
        self.input_ns = 0
        self.output_ns = 0

    def record_success(self, breakdown: Dict[str, float], batch: int) -> None:
        def ns(key):
            return int(breakdown.get(key, 0.0) * 1e6)

        with self.lock:
            self.inference_count += batch
            self.execution_count += 1
            self.last_inference_ms = int(time.time() * 1000)
            self.success_count += 1
            self.success_ns += ns("total_ms")
            self.queue_ns += ns("queue_ms")
            self.infer_ns += ns("inference_ms")
            self.input_ns += ns("batch_ms")
            self.output_ns += ns("callback_ms")

    def record_failure(self, total_ms: float) -> None:
        with self.lock:
            self.fail_count += 1
            self.fail_ns += int(total_ms * 1e6)


class InferenceServicer:
    def __init__(self, cfg: RuntimeConfig, queue=None, generation_engine=None):
        self.cfg = cfg
        self.queue = queue
        self.generation_engine = generation_engine
        self.stats = _ModelStats()
        self.batch_stats_source = None  # the ResultDispatcher, when wired
        self.ready = threading.Event()

    # -- liveness / metadata ----------------------------------------------

    async def ServerLive(self, request, context):
        return pb.ServerLiveResponse(live=True)

    async def ServerReady(self, request, context):
        return pb.ServerReadyResponse(ready=self.ready.is_set())

    async def ModelReady(self, request, context):
        known = not request.name or request.name == self.cfg.name
        return pb.ModelReadyResponse(ready=known and self.ready.is_set())

    async def ServerMetadata(self, request, context):
        return pb.ServerMetadataResponse(
            name=SERVER_NAME, version=__version__, extensions=["timing"]
        )

    async def ModelMetadata(self, request, context):
        if request.name and request.name != self.cfg.name:
            await context.abort(
                grpc.StatusCode.NOT_FOUND, f"unknown model {request.name!r}"
            )
        resp = pb.ModelMetadataResponse(
            name=self.cfg.name, versions=["1"], platform=PLATFORM
        )
        for spec in self.cfg.inputs:
            resp.inputs.add(name=spec.name, datatype=spec.dtype, shape=[-1, *spec.dims])
        for spec in self.cfg.outputs:
            resp.outputs.add(name=spec.name, datatype=spec.dtype, shape=[-1, *spec.dims])
        return resp

    async def ModelStatistics(self, request, context):
        s = self.stats
        with s.lock:
            stat = pb.ModelStatistics(
                name=self.cfg.name,
                version="1",
                last_inference=s.last_inference_ms,
                inference_count=s.inference_count,
                execution_count=s.execution_count,
                inference_stats=pb.InferStatistics(
                    success=pb.StatisticDuration(count=s.success_count, ns=s.success_ns),
                    fail=pb.StatisticDuration(count=s.fail_count, ns=s.fail_ns),
                    queue=pb.StatisticDuration(count=s.success_count, ns=s.queue_ns),
                    compute_input=pb.StatisticDuration(count=s.success_count, ns=s.input_ns),
                    compute_infer=pb.StatisticDuration(count=s.success_count, ns=s.infer_ns),
                    compute_output=pb.StatisticDuration(count=s.success_count, ns=s.output_ns),
                ),
            )
        source = self.batch_stats_source
        if source is not None:
            with source._lock:
                snapshot = {size: dict(agg) for size, agg in source.batch_stats.items()}
            for size in sorted(snapshot):
                agg = snapshot[size]
                count = int(agg["count"])
                stat.batch_stats.add(
                    batch_size=size,
                    compute_input=pb.StatisticDuration(count=count, ns=int(agg["compute_input_ns"])),
                    compute_infer=pb.StatisticDuration(count=count, ns=int(agg["compute_infer_ns"])),
                    compute_output=pb.StatisticDuration(count=count,
                                                        ns=int(agg["compute_output_ns"])),
                )
        return pb.ModelStatisticsResponse(model_stats=[stat])

    # -- decoder generation ------------------------------------------------

    def _request(self, request, on_token=None) -> GenerationRequest:
        prompt = extract_prompt(request)
        gp = generation_params(request)
        return GenerationRequest(
            prompt_ids=prompt.astype(np.int32),
            max_new_tokens=gp["max_new_tokens"],
            eos_id=gp["eos_id"],
            temperature=gp["temperature"],
            top_k=gp["top_k"],
            seed=gp["seed"],
            request_id=request.id or "",
            on_token=on_token,
        )

    async def ModelInfer(self, request, context):
        """reference: HandleModelInferAsyncImpl,
        inference_service_async.cpp:385-520."""
        server_receive = wall_ms()
        if request.model_name and request.model_name != self.cfg.name:
            await context.abort(
                grpc.StatusCode.NOT_FOUND, f"unknown model {request.model_name!r}"
            )
        if self.generation_engine is not None:
            return await self._model_generate(request, context, server_receive)
        return await self._model_batch(request, context, server_receive)

    async def _model_batch(self, request, context, server_receive):
        """The batch route: validate + zero-copy convert, push to the
        queue, await the completion the dispatcher resolves, serialize."""
        t0 = now_s()
        try:
            inputs = validate_and_convert_inputs(self.cfg, request)
        except TensorError as exc:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
        preprocess_ms = (now_s() - t0) * 1000.0

        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()

        def completion(job, outputs, error):
            def resolve():
                if not future.done():
                    future.set_result((job, outputs, error))
            loop.call_soon_threadsafe(resolve)

        job = InferenceJob(inputs, request_id=request.id or "", completion=completion)
        context.add_done_callback(lambda _ctx: job.cancel())
        job.timing.stamp("enqueued_at")
        try:
            self.queue.push(job)
        except QueueFullError as exc:
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(exc))
        except QueueClosedError as exc:
            await context.abort(grpc.StatusCode.UNAVAILABLE, str(exc))

        _, outputs, error = await future
        if error is not None:
            self.stats.record_failure(job.latency_breakdown.get("total_ms", 0.0))
            if isinstance(error, CancelledError):
                await context.abort(grpc.StatusCode.CANCELLED, "request cancelled")
            await context.abort(grpc.StatusCode.INTERNAL, str(error))

        t1 = now_s()
        response = populate_response(self.cfg, request, outputs)
        postprocess_ms = (now_s() - t1) * 1000.0
        fill_timing_fields(response, job.latency_breakdown, server_receive_ms=server_receive,
                           preprocess_ms=preprocess_ms, postprocess_ms=postprocess_ms)
        self.stats.record_success(job.latency_breakdown, job.batch_size())
        return response

    async def _model_generate(self, request, context, server_receive):
        """ModelInfer on a decoder = full generation: input_ids ->
        output_ids, driven by the continuous-batching engine."""
        try:
            gen = self._request(request)
            self.generation_engine.submit(gen)
        except (TensorError, ValueError) as exc:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
        # a dropped client stops burning the slot
        context.add_done_callback(lambda _ctx: gen.cancel())
        loop = asyncio.get_running_loop()
        try:
            tokens = await loop.run_in_executor(None, gen.result, 300.0)
        except Exception as exc:  # noqa: BLE001
            await context.abort(grpc.StatusCode.INTERNAL, str(exc))
        if gen.cancel_flag.is_set() and context.cancelled():
            await context.abort(grpc.StatusCode.CANCELLED, "request cancelled")

        out = np.asarray(tokens, np.int32)
        response = pb.ModelInferResponse(
            model_name=request.model_name or self.cfg.name,
            model_version="1",
            id=request.id,
        )
        t = response.outputs.add()
        t.name = "output_ids"
        t.datatype = "INT32"
        t.shape.extend([1, len(out)])
        response.raw_output_contents.append(out.tobytes())
        ttft_ms = max(0.0, (gen.first_token_at - gen.submitted_at) * 1000.0)
        total_ms = max(0.0, (gen.finished_at - gen.submitted_at) * 1000.0)
        fill_timing_fields(
            response,
            {"queue_ms": ttft_ms, "inference_ms": max(0.0, total_ms - ttft_ms),
             "total_ms": total_ms},
            server_receive_ms=server_receive,
        )
        return response

    async def ModelStreamInfer(self, request_iterator, context):
        """Streaming generation: one response per generated token."""
        if self.generation_engine is None:
            await context.abort(grpc.StatusCode.UNIMPLEMENTED,
                                "ModelStreamInfer is only available for decoder models")
        loop = asyncio.get_running_loop()
        async for request in request_iterator:
            token_queue: asyncio.Queue = asyncio.Queue()

            def on_token(token, _q=token_queue):
                loop.call_soon_threadsafe(_q.put_nowait, token)

            try:
                gen = self._request(request, on_token=on_token)
                self.generation_engine.submit(gen)
            except (TensorError, ValueError) as exc:
                yield pb.ModelStreamInferResponse(error_message=str(exc))
                continue

            context.add_done_callback(lambda _ctx, _g=gen: _g.cancel())
            done_task = loop.run_in_executor(None, gen.done.wait, 300.0)
            emitted = 0
            while True:
                get_task = asyncio.ensure_future(token_queue.get())
                await asyncio.wait({get_task, done_task}, return_when=asyncio.FIRST_COMPLETED)
                if get_task.done():
                    token = get_task.result()
                    emitted += 1
                    resp = pb.ModelInferResponse(
                        model_name=request.model_name or self.cfg.name, id=request.id
                    )
                    t = resp.outputs.add()
                    t.name = "output_ids"
                    t.datatype = "INT32"
                    t.shape.extend([1, 1])
                    resp.raw_output_contents.append(np.asarray([token], np.int32).tobytes())
                    yield pb.ModelStreamInferResponse(infer_response=resp)
                else:
                    get_task.cancel()
                if gen.done.is_set() and token_queue.empty() and emitted >= len(gen.tokens):
                    break
            if gen.error is not None:
                yield pb.ModelStreamInferResponse(error_message=str(gen.error))


_UNARY_RPCS = {
    "ServerLive": (pb.ServerLiveRequest, pb.ServerLiveResponse),
    "ServerReady": (pb.ServerReadyRequest, pb.ServerReadyResponse),
    "ModelReady": (pb.ModelReadyRequest, pb.ModelReadyResponse),
    "ServerMetadata": (pb.ServerMetadataRequest, pb.ServerMetadataResponse),
    "ModelMetadata": (pb.ModelMetadataRequest, pb.ModelMetadataResponse),
    "ModelInfer": (pb.ModelInferRequest, pb.ModelInferResponse),
    "ModelConfig": (pb.ModelConfigRequest, pb.ModelConfigResponse),
    "ModelStatistics": (pb.ModelStatisticsRequest, pb.ModelStatisticsResponse),
    "RepositoryIndex": (pb.RepositoryIndexRequest, pb.RepositoryIndexResponse),
    "RepositoryModelLoad": (pb.RepositoryModelLoadRequest, pb.RepositoryModelLoadResponse),
    "RepositoryModelUnload": (pb.RepositoryModelUnloadRequest, pb.RepositoryModelUnloadResponse),
    "SystemSharedMemoryStatus": (pb.SystemSharedMemoryStatusRequest, pb.SystemSharedMemoryStatusResponse),
    "SystemSharedMemoryRegister": (pb.SystemSharedMemoryRegisterRequest, pb.SystemSharedMemoryRegisterResponse),
    "SystemSharedMemoryUnregister": (pb.SystemSharedMemoryUnregisterRequest, pb.SystemSharedMemoryUnregisterResponse),
    "CudaSharedMemoryStatus": (pb.CudaSharedMemoryStatusRequest, pb.CudaSharedMemoryStatusResponse),
    "CudaSharedMemoryRegister": (pb.CudaSharedMemoryRegisterRequest, pb.CudaSharedMemoryRegisterResponse),
    "CudaSharedMemoryUnregister": (pb.CudaSharedMemoryUnregisterRequest, pb.CudaSharedMemoryUnregisterResponse),
    "TraceSetting": (pb.TraceSettingRequest, pb.TraceSettingResponse),
    "LogSettings": (pb.LogSettingsRequest, pb.LogSettingsResponse),
}


def _unimplemented(name: str):
    async def handler(request, context):
        await context.abort(
            grpc.StatusCode.UNIMPLEMENTED,
            f"{name} is not yet ported to the PyTorch server",
        )

    return handler


def add_inference_service(server: "grpc.aio.Server", servicer: InferenceServicer) -> None:
    handlers = {}
    for name, (req_cls, resp_cls) in _UNARY_RPCS.items():
        fn = getattr(servicer, name, None) or _unimplemented(name)
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )
    handlers["ModelStreamInfer"] = grpc.stream_stream_rpc_method_handler(
        servicer.ModelStreamInfer,
        request_deserializer=pb.ModelInferRequest.FromString,
        response_serializer=pb.ModelStreamInferResponse.SerializeToString,
    )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_FULL_NAME, handlers),)
    )
    add_health_service(server)


def add_health_service(server: "grpc.aio.Server") -> None:
    """Standard ``grpc.health.v1.Health``, hand-encoded (one enum field:
    SERVING = 1)."""
    serving = b"\x08\x01"

    async def check(request: bytes, context):
        return serving

    async def watch(request: bytes, context):
        yield serving

    handlers = {
        "Check": grpc.unary_unary_rpc_method_handler(
            check, request_deserializer=lambda b: b, response_serializer=lambda b: b,
        ),
        "Watch": grpc.unary_stream_rpc_method_handler(
            watch, request_deserializer=lambda b: b, response_serializer=lambda b: b,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler("grpc.health.v1.Health", handlers),)
    )
