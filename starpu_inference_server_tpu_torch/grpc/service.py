"""The gRPC inference service (asyncio), decoder-generation subset.

Counterpart of ``starpu_inference_server_tpu/grpc/service.py``:
ServerLive, ServerReady, ModelReady, ServerMetadata and ModelMetadata,
``ModelInfer`` as full generation and ``ModelStreamInfer`` as one
response per generated token, plus the standard health service. Every
other RPC of the KServe-v2 table answers UNIMPLEMENTED until its slice
is ported.
"""

from __future__ import annotations

import asyncio
import threading

import grpc
import numpy as np

from .. import __version__
from ..serving.generation import GenerationRequest
from ..utils.clock import wall_ms
from ..utils.config import RuntimeConfig
from ..utils.exceptions import TensorError
from . import kserve_v2_pb2 as pb
from .io import extract_prompt, fill_timing_fields, generation_params

SERVER_NAME = "starpu-inference-server-tpu-torch"
SERVICE_FULL_NAME = "inference.GRPCInferenceService"
PLATFORM = "pytorch_cuda"


class InferenceServicer:
    def __init__(self, cfg: RuntimeConfig, generation_engine):
        self.cfg = cfg
        self.generation_engine = generation_engine
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
        """ModelInfer on a decoder = full generation: input_ids ->
        output_ids, driven by the continuous-batching engine."""
        server_receive = wall_ms()
        if request.model_name and request.model_name != self.cfg.name:
            await context.abort(
                grpc.StatusCode.NOT_FOUND, f"unknown model {request.model_name!r}"
            )
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
