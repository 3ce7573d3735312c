"""The gRPC inference service (asyncio).

Counterpart of ``starpu_inference_server_tpu/grpc/service.py``:
ServerLive, ServerReady, ModelReady, ServerMetadata, ModelMetadata,
ModelConfig, ModelStatistics, the model repository (RepositoryIndex,
RepositoryModelLoad with hot weight reload, RepositoryModelUnload),
LogSettings, TraceSetting and ``ModelInfer`` on two routes: the batch
pipeline (validate, queue, batch, execute on a lane, slice; the
completion resolves an asyncio future from the dispatcher's thread) for
every non-decoder model, and full generation for decoders, whose
``ModelStreamInfer`` answers one response per generated token. The
request counters, latency histograms and congestion events are recorded
at the JAX servicer's points. The standard health and reflection
services are registered too. The shared-memory RPCs answer
UNIMPLEMENTED, as in the JAX server.
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
from ..utils.logger import get_logger
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

_DTYPE_TO_ENUM = {
    "BOOL": pb.TYPE_BOOL, "UINT8": pb.TYPE_UINT8, "UINT16": pb.TYPE_UINT16,
    "UINT32": pb.TYPE_UINT32, "UINT64": pb.TYPE_UINT64, "INT8": pb.TYPE_INT8,
    "INT16": pb.TYPE_INT16, "INT32": pb.TYPE_INT32, "INT64": pb.TYPE_INT64,
    "FP16": pb.TYPE_FP16, "FP32": pb.TYPE_FP32, "FP64": pb.TYPE_FP64,
    "BF16": pb.TYPE_BF16,
}


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
    def __init__(self, cfg: RuntimeConfig, queue=None, observability=None,
                 congestion_monitor=None, generation_engine=None, reload_model=None):
        self.cfg = cfg
        self.queue = queue
        self.observability = observability
        self.congestion = congestion_monitor
        self.generation_engine = generation_engine
        # hot weight reload (RepositoryModelLoad); None = re-mark loaded only
        self.reload_model = reload_model
        self.stats = _ModelStats()
        self.batch_stats_source = None  # the ResultDispatcher, when wired
        self.ready = threading.Event()
        # RepositoryModelUnload clears this; infers answer UNAVAILABLE
        # until a RepositoryModelLoad
        self.loaded = threading.Event()
        self.loaded.set()
        self._log = get_logger()

    def _count_status(self, code: str) -> None:
        if self.observability is not None:
            self.observability.metrics.requests_by_status.labels(code).inc()

    async def _abort_if_unloaded(self, context) -> None:
        if not self.loaded.is_set():
            await context.abort(grpc.StatusCode.UNAVAILABLE,
                                f"model {self.cfg.name!r} is unloaded")

    # -- liveness / metadata ----------------------------------------------

    async def ServerLive(self, request, context):
        return pb.ServerLiveResponse(live=True)

    async def ServerReady(self, request, context):
        return pb.ServerReadyResponse(ready=self.ready.is_set())

    async def ModelReady(self, request, context):
        known = not request.name or request.name == self.cfg.name
        return pb.ModelReadyResponse(
            ready=known and self.ready.is_set() and self.loaded.is_set())

    async def ServerMetadata(self, request, context):
        return pb.ServerMetadataResponse(
            name=SERVER_NAME, version=__version__,
            extensions=["timing", "statistics", "model_repository", "trace_setting",
                        "log_settings"],
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

    async def ModelConfig(self, request, context):
        if request.name and request.name != self.cfg.name:
            await context.abort(
                grpc.StatusCode.NOT_FOUND, f"unknown model {request.name!r}"
            )
        config = pb.ModelConfig(name=self.cfg.name, platform=PLATFORM,
                                max_batch_size=self.cfg.max_batch_size)
        for spec in self.cfg.inputs:
            config.input.add(name=spec.name, data_type=_DTYPE_TO_ENUM[spec.dtype],
                             dims=list(spec.dims))
        for spec in self.cfg.outputs:
            config.output.add(name=spec.name, data_type=_DTYPE_TO_ENUM[spec.dtype],
                              dims=list(spec.dims))
        return pb.ModelConfigResponse(config=config)

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

    # -- model repository --------------------------------------------------
    # The one served model can be unloaded (infers answer UNAVAILABLE) and
    # loaded again; a load of a batch model rebuilds its weights from the
    # config's source and hot-swaps them (``reload_model``).

    async def RepositoryIndex(self, request, context):
        is_ready = self.loaded.is_set() and self.ready.is_set()
        state = "READY" if is_ready else "UNAVAILABLE"
        reason = "" if is_ready else ("unloaded" if not self.loaded.is_set() else "starting")
        resp = pb.RepositoryIndexResponse()
        if not request.ready or is_ready:  # ready=true filters to ready models
            resp.models.add(name=self.cfg.name, version="1", state=state, reason=reason)
        return resp

    async def RepositoryModelLoad(self, request, context):
        if request.model_name and request.model_name != self.cfg.name:
            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"unknown model {request.model_name!r}")
        if self.reload_model is not None:
            loop = asyncio.get_running_loop()
            try:
                await loop.run_in_executor(None, self.reload_model)
            except Exception as exc:  # noqa: BLE001 - any reload failure answers INTERNAL
                self._log.error("model reload failed: %s", exc)
                await context.abort(grpc.StatusCode.INTERNAL, f"model reload failed: {exc}")
        elif self.loaded.is_set():
            # a generation server holds decode state (KV slots) against its
            # params, so no reload is wired: the RPC only gates
            self._log.warn(
                "RepositoryModelLoad on %s: no reload hook wired "
                "(generation server) — gating-only, weights NOT re-read",
                self.cfg.name,
            )
        self.loaded.set()
        self._log.info("model %s loaded via repository RPC", self.cfg.name)
        return pb.RepositoryModelLoadResponse()

    async def RepositoryModelUnload(self, request, context):
        if request.model_name and request.model_name != self.cfg.name:
            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"unknown model {request.model_name!r}")
        self.loaded.clear()
        self._log.info("model %s unloaded via repository RPC", self.cfg.name)
        return pb.RepositoryModelUnloadResponse()

    # -- runtime settings ----------------------------------------------------

    async def LogSettings(self, request, context):
        log = self._log
        for key, val in request.settings.items():
            if key != "verbosity":
                await context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"unknown log setting {key!r} (supported: verbosity)",
                )
            which = val.WhichOneof("parameter_choice")
            if which == "string_param":
                raw = val.string_param
            elif which == "uint32_param":
                raw = val.uint32_param
            else:  # bool_param or unset would silently read as 0 (Silent)
                await context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"verbosity takes string_param or uint32_param, got {which or 'unset'}",
                )
            try:
                log.set_verbosity(raw)
            except ValueError as exc:
                await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
        resp = pb.LogSettingsResponse()
        resp.settings["verbosity"].uint32_param = int(log.verbosity)
        resp.settings["verbosity_name"].string_param = log.verbosity.name
        return resp

    async def TraceSetting(self, request, context):
        tracer = self.observability.tracer if self.observability is not None else None
        if tracer is None:
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION, "no trace logger wired")
        enable = None
        out_dir = None
        for key, val in request.settings.items():
            values = list(val.value)
            if key == "trace_enabled":
                enable = bool(values) and values[0].lower() in ("true", "1")
            elif key == "trace_output":
                out_dir = values[0] if values else None
            else:
                await context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"unknown trace setting {key!r} (supported: trace_enabled, trace_output)",
                )
        try:
            if out_dir is not None and enable is None:
                tracer.set_enabled(tracer.enabled, output_dir=out_dir)
            elif enable is not None:
                if not enable:
                    tracer.flush()  # persist what was collected so far
                tracer.set_enabled(enable, output_dir=out_dir)
        except (ValueError, OSError) as exc:
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(exc))
        resp = pb.TraceSettingResponse()
        resp.settings["trace_enabled"].value.append("true" if tracer.enabled else "false")
        resp.settings["trace_output"].value.append(tracer.output_dir or "")
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
        """reference: HandleModelInferAsyncImpl,
        inference_service_async.cpp:385-520."""
        server_receive = wall_ms()
        await self._abort_if_unloaded(context)
        if self.generation_engine is None:  # counted before the name check, as in JAX
            if self.observability is not None:
                self.observability.metrics.requests_total.inc()
            if self.congestion is not None:
                self.congestion.record_arrival()
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
        obs = self.observability
        t0 = now_s()
        try:
            inputs = validate_and_convert_inputs(self.cfg, request)
        except TensorError as exc:
            self._count_status("INVALID_ARGUMENT")
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
        preprocess_ms = (now_s() - t0) * 1000.0
        if obs is not None:
            obs.metrics.preprocess_latency.observe(preprocess_ms)

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
            if self.congestion is not None:
                self.congestion.record_rejection()
            if obs is not None:
                obs.on_rejection(job.request_id)
            self._count_status("RESOURCE_EXHAUSTED")
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(exc))
        except QueueClosedError as exc:
            self._count_status("UNAVAILABLE")
            await context.abort(grpc.StatusCode.UNAVAILABLE, str(exc))
        if obs is not None:
            obs.on_request_enqueued(job, self.queue.size())

        _, outputs, error = await future
        if error is not None:
            self.stats.record_failure(job.latency_breakdown.get("total_ms", 0.0))
            if isinstance(error, CancelledError):
                self._count_status("CANCELLED")
                await context.abort(grpc.StatusCode.CANCELLED, "request cancelled")
            self._count_status("INTERNAL")
            if obs is not None:
                obs.metrics.record_failure("execute", type(error).__name__)
            await context.abort(grpc.StatusCode.INTERNAL, str(error))

        t1 = now_s()
        response = populate_response(self.cfg, request, outputs)
        postprocess_ms = (now_s() - t1) * 1000.0
        fill_timing_fields(response, job.latency_breakdown, server_receive_ms=server_receive,
                           preprocess_ms=preprocess_ms, postprocess_ms=postprocess_ms)
        if obs is not None:
            obs.metrics.postprocess_latency.observe(postprocess_ms)
        self._count_status("OK")
        self.stats.record_success(job.latency_breakdown, job.batch_size())
        return response

    async def _model_generate(self, request, context, server_receive):
        """ModelInfer on a decoder = full generation: input_ids ->
        output_ids, driven by the continuous-batching engine."""
        try:
            gen = self._request(request)
            self.generation_engine.submit(gen)
        except (TensorError, ValueError) as exc:
            self._count_status("INVALID_ARGUMENT")
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
        # a dropped client stops burning the slot
        context.add_done_callback(lambda _ctx: gen.cancel())
        loop = asyncio.get_running_loop()
        try:
            tokens = await loop.run_in_executor(None, gen.result, 300.0)
        except Exception as exc:  # noqa: BLE001
            self._count_status("INTERNAL")
            await context.abort(grpc.StatusCode.INTERNAL, str(exc))
        if gen.cancel_flag.is_set() and context.cancelled():
            self._count_status("CANCELLED")
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
        # the answer's queue: submit to admission (a slot and pages
        # granted); inference: admission to the last token
        admitted = gen.admitted_at or gen.finished_at
        ttft_ms = max(0.0, (gen.first_token_at - gen.submitted_at) * 1000.0)
        total_ms = max(0.0, (gen.finished_at - gen.submitted_at) * 1000.0)
        fill_timing_fields(
            response,
            {"queue_ms": max(0.0, (admitted - gen.submitted_at) * 1000.0),
             "inference_ms": max(0.0, (gen.finished_at - admitted) * 1000.0),
             "total_ms": total_ms},
            server_receive_ms=server_receive,
        )
        # the statistics keep the JAX package's split: the TTFT as queue
        self.stats.record_success(
            {"total_ms": total_ms, "inference_ms": total_ms, "queue_ms": ttft_ms}, len(out))
        self._count_status("OK")
        return response

    async def ModelStreamInfer(self, request_iterator, context):
        """Streaming generation: one response per generated token."""
        if self.generation_engine is None:
            await context.abort(grpc.StatusCode.UNIMPLEMENTED,
                                "ModelStreamInfer is only available for decoder models")
        await self._abort_if_unloaded(context)
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
                    if emitted == 1:  # the first token is on its way to the client
                        self.generation_engine.record_first_send(gen)
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
        await context.abort(grpc.StatusCode.UNIMPLEMENTED, f"{name} is not implemented")

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
    add_health_service(server, servicer)
    add_reflection_service(server)


def add_reflection_service(server: "grpc.aio.Server") -> None:
    """Standard ``grpc.reflection.v1alpha.ServerReflection`` service so
    grpcurl / grpc_cli can discover and call the server without local
    protos, as the JAX server registers it. Hand-registered (the
    grpc_reflection package is not a dependency); the descriptor source
    is this package's own compiled kserve_v2 file and its own copy of
    ``reflection_v1alpha_pb2``."""
    from google.protobuf import descriptor_pb2

    from . import reflection_v1alpha_pb2 as rpb

    kserve_fd = pb.DESCRIPTOR.serialized_pb  # self-contained (no deps)
    services = [
        SERVICE_FULL_NAME,
        "grpc.health.v1.Health",
        "grpc.reflection.v1alpha.ServerReflection",
    ]

    # --- synthesized descriptors for the hand-registered services so
    # grpcurl `describe` works on Health and ServerReflection too.
    # Reflection: the vendored pb2 is a message-only subset; append the
    # service to a copy of its own FileDescriptorProto.
    refl_fdp = descriptor_pb2.FileDescriptorProto.FromString(
        rpb.DESCRIPTOR.serialized_pb
    )
    svc_d = refl_fdp.service.add(name="ServerReflection")
    svc_d.method.add(
        name="ServerReflectionInfo",
        input_type=".grpc.reflection.v1alpha.ServerReflectionRequest",
        output_type=".grpc.reflection.v1alpha.ServerReflectionResponse",
        client_streaming=True,
        server_streaming=True,
    )
    refl_fd = refl_fdp.SerializeToString()
    # Health: built from scratch (the wire handlers hand-encode it).
    T = descriptor_pb2.FieldDescriptorProto
    health_fdp = descriptor_pb2.FileDescriptorProto(
        name="grpc/health/v1/health.proto", package="grpc.health.v1",
        syntax="proto3",
    )
    m = health_fdp.message_type.add(name="HealthCheckRequest")
    m.field.add(name="service", number=1, type=T.TYPE_STRING,
                label=T.LABEL_OPTIONAL)
    m = health_fdp.message_type.add(name="HealthCheckResponse")
    en = m.enum_type.add(name="ServingStatus")
    for nm, num in (("UNKNOWN", 0), ("SERVING", 1), ("NOT_SERVING", 2),
                    ("SERVICE_UNKNOWN", 3)):
        en.value.add(name=nm, number=num)
    m.field.add(
        name="status", number=1, type=T.TYPE_ENUM, label=T.LABEL_OPTIONAL,
        type_name=".grpc.health.v1.HealthCheckResponse.ServingStatus",
    )
    svc_d = health_fdp.service.add(name="Health")
    svc_d.method.add(name="Check",
                     input_type=".grpc.health.v1.HealthCheckRequest",
                     output_type=".grpc.health.v1.HealthCheckResponse")
    svc_d.method.add(name="Watch",
                     input_type=".grpc.health.v1.HealthCheckRequest",
                     output_type=".grpc.health.v1.HealthCheckResponse",
                     server_streaming=True)
    health_fd = health_fdp.SerializeToString()

    files = {  # filename -> serialized FileDescriptorProto
        pb.DESCRIPTOR.name: kserve_fd,
        refl_fdp.name: refl_fd,
        health_fdp.name: health_fd,
    }

    def _file_symbols(fdp: "descriptor_pb2.FileDescriptorProto") -> set:
        syms = {fdp.package}
        for s in fdp.service:
            syms.add(f"{fdp.package}.{s.name}")
            for meth in s.method:
                syms.add(f"{fdp.package}.{s.name}.{meth.name}")
        for msg in fdp.message_type:
            syms.add(f"{fdp.package}.{msg.name}")
        return syms

    # symbol -> serialized file (top-level names are enough for
    # grpcurl's lookups); message full names double as the valid-type
    # universe for all_extension_numbers_of_type
    symbols = {}
    message_names = set()
    for raw in (kserve_fd, refl_fd, health_fd):
        fdp = descriptor_pb2.FileDescriptorProto.FromString(raw)
        for s in _file_symbols(fdp):
            symbols[s] = raw
        for msg in fdp.message_type:
            message_names.add(f"{fdp.package}.{msg.name}")

    def _answer(req: "rpb.ServerReflectionRequest") -> "rpb.ServerReflectionResponse":
        resp = rpb.ServerReflectionResponse(
            valid_host=req.host, original_request=req
        )
        which = req.WhichOneof("message_request")
        if which == "list_services":
            for name in services:
                resp.list_services_response.service.add(name=name)
        elif which == "file_containing_symbol":
            sym = req.file_containing_symbol
            raw = symbols.get(sym)
            if raw is None and sym.startswith("inference."):
                raw = kserve_fd
            if raw is not None:
                resp.file_descriptor_response.file_descriptor_proto.append(raw)
            else:
                resp.error_response.error_code = grpc.StatusCode.NOT_FOUND.value[0]
                resp.error_response.error_message = f"symbol not found: {sym}"
        elif which == "file_by_filename":
            raw = files.get(req.file_by_filename)
            if raw is not None:
                resp.file_descriptor_response.file_descriptor_proto.append(raw)
            else:
                resp.error_response.error_code = grpc.StatusCode.NOT_FOUND.value[0]
                resp.error_response.error_message = (
                    f"file not found: {req.file_by_filename}"
                )
        elif which == "all_extension_numbers_of_type":
            base = req.all_extension_numbers_of_type
            if base in message_names:
                # proto3 files here: no extensions, valid type -> empty set
                resp.all_extension_numbers_response.base_type_name = base
            else:
                resp.error_response.error_code = grpc.StatusCode.NOT_FOUND.value[0]
                resp.error_response.error_message = f"type not found: {base}"
        else:
            resp.error_response.error_code = (
                grpc.StatusCode.UNIMPLEMENTED.value[0]
            )
            resp.error_response.error_message = f"unsupported: {which}"
        return resp

    async def server_reflection_info(request_iterator, context):
        async for req in request_iterator:
            yield _answer(req)

    handlers = {
        "ServerReflectionInfo": grpc.stream_stream_rpc_method_handler(
            server_reflection_info,
            request_deserializer=rpb.ServerReflectionRequest.FromString,
            response_serializer=rpb.ServerReflectionResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (
            grpc.method_handlers_generic_handler(
                "grpc.reflection.v1alpha.ServerReflection", handlers
            ),
        )
    )


def add_health_service(server: "grpc.aio.Server", servicer) -> None:
    """Standard ``grpc.health.v1.Health`` service, hand-encoded (one enum
    field). It answers SERVING while the server runs; ``servicer`` is
    taken for the JAX signature. Kubernetes-style ``grpc_health_probe``
    checks work against it."""
    SERVING = b"\x08\x01"  # HealthCheckResponse{status: SERVING}

    async def check(request: bytes, context):
        return SERVING

    async def watch(request: bytes, context):
        yield SERVING

    handlers = {
        "Check": grpc.unary_unary_rpc_method_handler(
            check,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        ),
        "Watch": grpc.unary_stream_rpc_method_handler(
            watch,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler("grpc.health.v1.Health", handlers),)
    )
