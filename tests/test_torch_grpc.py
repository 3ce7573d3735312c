"""The port's gRPC server on CPU over a real socket: ModelInfer and
ModelStreamInfer return the tokens of the port's own engine (modelled on
tests/e2e/test_decoder_grpc.py)."""

import asyncio
import threading

import grpc
import numpy as np
import pytest

from starpu_inference_server_tpu_torch.grpc import kserve_v2_pb2 as pb
from starpu_inference_server_tpu_torch.grpc.server import InferenceServer
from starpu_inference_server_tpu_torch.utils.config import parse_config
from starpu_inference_server_tpu_torch.utils.exceptions import UnknownModelFamilyError


def decoder_cfg(family="llama-tiny"):
    return parse_config({
        "name": "llama",
        "model": {
            "family": family,
            "compute_dtype": "FP32",
            "quantization": "int4",
            "options": {
                "layers": 2, "hidden": 128, "q_heads": 2, "kv_heads": 1,
                "intermediate": 256, "vocab": 128, "seq_len": 16,
                "num_slots": 2, "max_len": 64, "prefill_buckets": [8, 16],
                "prefill_chunk": 16, "steps_per_sync": 2,
            },
        },
        "inputs": [{"name": "input_ids", "dims": [16], "dtype": "INT64"}],
        "outputs": [{"name": "logits", "dims": [16, 128], "dtype": "FP32"}],
        "pool_size": 1,
        "max_batch_size": 1,
        "batch_coalesce_timeout_ms": 0,
        "batching_strategy": "disabled",
        "max_queue_size": 16,
        "max_inflight_tasks": 1,
        "metrics_enabled": False,
        "server": {"address": "127.0.0.1:0"},
    })


class Harness:
    """InferenceServer.serve() on a private asyncio loop thread."""

    def __init__(self, cfg):
        self.server = InferenceServer(cfg, device="cpu")
        self.ready = threading.Event()
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self.server.serve(warmup=True, ready_event=self.ready))
        self.loop.close()

    def __enter__(self):
        self.thread.start()
        assert self.ready.wait(timeout=60), "server failed to start"
        self.target = f"127.0.0.1:{self.server.bound_port}"
        return self

    def __exit__(self, *exc):
        self.loop.call_soon_threadsafe(self.server.request_stop)
        self.thread.join(timeout=30)


@pytest.fixture(scope="module")
def harness():
    with Harness(decoder_cfg()) as h:
        yield h


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _request(prompt, max_new, rid="r"):
    req = pb.ModelInferRequest(model_name="llama", id=rid)
    t = req.inputs.add()
    t.name = "input_ids"
    t.datatype = "INT64"
    t.shape.extend([1, len(prompt)])
    req.raw_input_contents.append(np.asarray(prompt, np.int64).tobytes())
    req.parameters["max_new_tokens"].int64_param = max_new
    return req


async def _unary(target, method, req, resp_cls):
    async with grpc.aio.insecure_channel(target) as channel:
        call = channel.unary_unary(
            f"/inference.GRPCInferenceService/{method}",
            request_serializer=type(req).SerializeToString,
            response_deserializer=resp_cls.FromString,
        )
        return await call(req, timeout=120)


PROMPTS = [[3, 7, 11], list(range(1, 13)), list(range(40, 60))]  # bucket 8, 16, chunked


@pytest.mark.parametrize("prompt", PROMPTS, ids=["bucket8", "bucket16", "chunked"])
def test_model_infer_returns_the_engine_tokens(harness, prompt):
    resp = run(_unary(harness.target, "ModelInfer", _request(prompt, 5), pb.ModelInferResponse))
    tokens = np.frombuffer(resp.raw_output_contents[0], np.int32).tolist()
    assert resp.outputs[0].name == "output_ids" and list(resp.outputs[0].shape) == [1, 5]
    assert tokens == harness.server.generation_engine.generate(np.asarray(prompt), 5)
    assert resp.server_total_ms > 0


def test_stream_infer_matches_model_infer(harness):
    async def stream():
        async with grpc.aio.insecure_channel(harness.target) as channel:
            call = channel.stream_stream(
                "/inference.GRPCInferenceService/ModelStreamInfer",
                request_serializer=pb.ModelInferRequest.SerializeToString,
                response_deserializer=pb.ModelStreamInferResponse.FromString,
            )

            async def requests():
                yield _request(PROMPTS[0], 6, rid="s1")

            out = []
            async for resp in call(requests()):
                assert not resp.error_message
                out.append(int(np.frombuffer(
                    resp.infer_response.raw_output_contents[0], np.int32)[0]))
            return out

    streamed = run(stream())
    unary = run(_unary(harness.target, "ModelInfer", _request(PROMPTS[0], 6),
                       pb.ModelInferResponse))
    assert streamed == np.frombuffer(unary.raw_output_contents[0], np.int32).tolist()


def test_liveness_and_metadata(harness):
    t = harness.target
    assert run(_unary(t, "ServerLive", pb.ServerLiveRequest(), pb.ServerLiveResponse)).live
    assert run(_unary(t, "ServerReady", pb.ServerReadyRequest(), pb.ServerReadyResponse)).ready
    assert run(_unary(t, "ModelReady", pb.ModelReadyRequest(name="llama"),
                      pb.ModelReadyResponse)).ready
    meta = run(_unary(t, "ModelMetadata", pb.ModelMetadataRequest(name="llama"),
                      pb.ModelMetadataResponse))
    assert meta.name == "llama" and meta.inputs[0].name == "input_ids"


@pytest.mark.parametrize("case", ["wrong_name", "too_long", "unported_rpc"])
def test_bad_requests_are_rejected(harness, case):
    if case == "unported_rpc":
        req, method, want = pb.ModelConfigRequest(name="llama"), "ModelConfig", \
            grpc.StatusCode.UNIMPLEMENTED
        resp_cls = pb.ModelConfigResponse
    else:
        req = _request([1, 2, 3], 5) if case == "wrong_name" else _request([1] * 60, 30)
        if case == "wrong_name":
            req.inputs[0].name = "wrong_name"
        method, want, resp_cls = "ModelInfer", grpc.StatusCode.INVALID_ARGUMENT, \
            pb.ModelInferResponse
    with pytest.raises(grpc.aio.AioRpcError) as err:
        run(_unary(harness.target, method, req, resp_cls))
    assert err.value.code() == want


def test_non_decoder_family_is_not_yet_ported():
    with pytest.raises(UnknownModelFamilyError, match="not yet ported"):
        InferenceServer(decoder_cfg(family="resnet18"), device="cpu")
