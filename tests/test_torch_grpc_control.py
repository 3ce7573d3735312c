"""The port's control RPCs against the JAX server's, over sockets on the CPU.

A JAX and a port server of the same ``matmul`` config (int8 weights, one
dense layer, the same name) answer the same for ModelConfig, the model
repository cycle (RepositoryIndex, RepositoryModelUnload with
UNAVAILABLE infers, RepositoryModelLoad), LogSettings (and its
INVALID_ARGUMENT cases), TraceSetting, reflection, health and the
shared-memory RPCs (UNIMPLEMENTED): the responses are equal once the
platform is set aside. A hot reload rebuilds the weights from the config
(the same seed: bit-equal responses; another seed: the new model's) and
a reload with another quantization answers INTERNAL on both. A decoder
server's load only gates. ``InferenceServer`` with ``metrics_port: 0``
serves ``/metrics`` (its counters equal the dispatcher's and the
servicer's counts, its congestion gauges the monitor's snapshot) and
frees the port at shutdown; with the metrics library missing it fails
at start.
"""

import asyncio
import dataclasses
import json
import socket
import sys
import threading
import time
import urllib.request

import grpc
import numpy as np
import pytest
import torch

from starpu_inference_server_tpu.grpc.server import InferenceServer as JaxServer
from starpu_inference_server_tpu.utils import config as jcfg
from starpu_inference_server_tpu.utils.logger import get_logger as jax_logger
from starpu_inference_server_tpu_torch.grpc import kserve_v2_pb2 as pb
from starpu_inference_server_tpu_torch.grpc import reflection_v1alpha_pb2 as rpb
from starpu_inference_server_tpu_torch.grpc.server import InferenceServer
from starpu_inference_server_tpu_torch.grpc.service import PLATFORM
from starpu_inference_server_tpu_torch.models.registry import build_model
from starpu_inference_server_tpu_torch.utils import config as tcfg
from starpu_inference_server_tpu_torch.utils.config import QuantMode
from starpu_inference_server_tpu_torch.utils.logger import get_logger

DIM = 8


def port_is_listened_on(port: int) -> bool:
    """True while a socket listens on ``port`` (a listener refuses a
    second bind even with SO_REUSEADDR)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("0.0.0.0", port))
            s.listen(1)
        except OSError:
            return True
    return False


def control_cfg(cfg_mod, **over):
    raw = {
        "name": "m",
        "model": {"family": "matmul", "compute_dtype": "FP32", "quantization": "int8",
                  "options": {"dim": DIM}},
        "inputs": [{"name": "input", "dims": [DIM], "dtype": "FP32"}],
        "outputs": [{"name": "output", "dims": [DIM], "dtype": "FP32"}],
        "pool_size": 2, "max_batch_size": 4, "batch_coalesce_timeout_ms": 1.0,
        "batching_strategy": "adaptive", "max_queue_size": 32, "max_inflight_tasks": 4,
        "warmup_request_nb": 1, "seed": 3,
        "metrics_enabled": False, "server": {"address": "127.0.0.1:0"},
    }
    raw.update(over)
    return cfg_mod.parse_config(raw)


class Harness:
    """A server's serve() on a private asyncio loop thread."""

    def __init__(self, server):
        self.server = server
        self.ready = threading.Event()
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self.server.serve(warmup=True, ready_event=self.ready))
        self.loop.close()

    def __enter__(self):
        self.thread.start()
        assert self.ready.wait(timeout=120), "server failed to start"
        self.target = f"127.0.0.1:{self.server.bound_port}"
        return self

    def __exit__(self, *exc):
        self.loop.call_soon_threadsafe(self.server.request_stop)
        self.thread.join(timeout=60)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def servers():
    with Harness(JaxServer(control_cfg(jcfg), expose_metrics=False)) as j, \
            Harness(InferenceServer(control_cfg(tcfg), device="cpu")) as t:
        yield {"jax": j, "torch": t}


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


async def _call(target, method, req, resp_cls, service="inference.GRPCInferenceService"):
    async with grpc.aio.insecure_channel(target) as channel:
        call = channel.unary_unary(f"/{service}/{method}",
                                   request_serializer=type(req).SerializeToString,
                                   response_deserializer=resp_cls.FromString)
        return await call(req, timeout=60)


def answer(target, method, req, resp_cls=None):
    """(status code name, details, response or None) of one unary call;
    the port's pb2 classes parse both servers' answers (the two pb2
    modules are the same file)."""
    resp_cls = resp_cls or getattr(pb, f"{method}Response")
    try:
        resp = run(_call(target, method, req, resp_cls))
    except grpc.aio.AioRpcError as err:
        return err.code().name, err.details(), None
    return "OK", "", resp


def _setting(**kw):
    return pb.LogSettingsRequest.SettingValue(**kw)


CASES = {
    "model_config": ("ModelConfig", lambda: pb.ModelConfigRequest(name="m")),
    "model_config_unknown": ("ModelConfig", lambda: pb.ModelConfigRequest(name="x")),
    "repository_index": ("RepositoryIndex", lambda: pb.RepositoryIndexRequest()),
    "repository_index_ready": ("RepositoryIndex", lambda: pb.RepositoryIndexRequest(ready=True)),
    "load_unknown": ("RepositoryModelLoad", lambda: pb.RepositoryModelLoadRequest(model_name="x")),
    "unload_unknown": ("RepositoryModelUnload",
                       lambda: pb.RepositoryModelUnloadRequest(model_name="x")),
    "log_settings_read": ("LogSettings", lambda: pb.LogSettingsRequest()),
    "log_settings_name": ("LogSettings", lambda: pb.LogSettingsRequest(
        settings={"verbosity": _setting(string_param="debug")})),
    "log_settings_number": ("LogSettings", lambda: pb.LogSettingsRequest(
        settings={"verbosity": _setting(uint32_param=1)})),
    "log_settings_unknown_key": ("LogSettings", lambda: pb.LogSettingsRequest(
        settings={"colour": _setting(string_param="red")})),
    "log_settings_bool": ("LogSettings", lambda: pb.LogSettingsRequest(
        settings={"verbosity": _setting(bool_param=True)})),
    "log_settings_out_of_range": ("LogSettings", lambda: pb.LogSettingsRequest(
        settings={"verbosity": _setting(uint32_param=9)})),
    "log_settings_bad_name": ("LogSettings", lambda: pb.LogSettingsRequest(
        settings={"verbosity": _setting(string_param="loud")})),
    "trace_setting_read": ("TraceSetting", lambda: pb.TraceSettingRequest()),
    "trace_setting_unknown_key": ("TraceSetting", lambda: pb.TraceSettingRequest(
        settings={"level": pb.TraceSettingRequest.SettingValue(value=["x"])})),
    "system_shm_status": ("SystemSharedMemoryStatus", lambda: pb.SystemSharedMemoryStatusRequest()),
    "system_shm_register": ("SystemSharedMemoryRegister",
                            lambda: pb.SystemSharedMemoryRegisterRequest(name="r")),
    "cuda_shm_status": ("CudaSharedMemoryStatus", lambda: pb.CudaSharedMemoryStatusRequest()),
    "cuda_shm_unregister": ("CudaSharedMemoryUnregister",
                            lambda: pb.CudaSharedMemoryUnregisterRequest(name="r")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_rpc_answers_as_the_jax_server(servers, case):
    method, make = CASES[case]
    try:
        got = answer(servers["torch"].target, method, make())
        want = answer(servers["jax"].target, method, make())
    finally:  # LogSettings changes each package's process-wide logger
        get_logger().set_verbosity("info")
        jax_logger().set_verbosity("info")
    if method == "ModelConfig" and got[2] is not None:
        assert got[2].config.platform == PLATFORM and want[2].config.platform == "jax_xla_tpu"
        got[2].config.platform = want[2].config.platform = ""
        assert got[2].config.max_batch_size == 4 and len(got[2].config.input) == 1
    assert got == want, (got, want)
    if case.endswith(("_unknown", "_key", "_bool", "_range", "_name")) and \
            case != "log_settings_name":
        assert got[0] in ("NOT_FOUND", "INVALID_ARGUMENT"), got
    if "shm" in case:
        assert got[0] == "UNIMPLEMENTED"


def test_server_metadata_lists_the_jax_extensions(servers):
    got = answer(servers["torch"].target, "ServerMetadata", pb.ServerMetadataRequest())[2]
    want = answer(servers["jax"].target, "ServerMetadata", pb.ServerMetadataRequest())[2]
    assert list(got.extensions) == list(want.extensions)
    assert got.name == "starpu-inference-server-tpu-torch"


def _infer(target, x, rid="r"):
    req = pb.ModelInferRequest(model_name="m", id=rid)
    t = req.inputs.add()
    t.name, t.datatype = "input", "FP32"
    t.shape.extend(x.shape)
    req.raw_input_contents.append(x.tobytes())
    code, details, resp = answer(target, "ModelInfer", req)
    out = None if resp is None else np.frombuffer(resp.raw_output_contents[0], np.float32)
    return code, out


def _cycle(target):
    """Index, unload, infer/ready/index while unloaded, load, infer."""
    x = np.linspace(-1, 1, DIM, dtype=np.float32)[None]
    seen = [answer(target, "RepositoryIndex", pb.RepositoryIndexRequest())]
    code, before = _infer(target, x)
    seen.append(code)
    seen.append(answer(target, "RepositoryModelUnload",
                       pb.RepositoryModelUnloadRequest(model_name="m")))
    seen.append(_infer(target, x)[0])
    seen.append(answer(target, "ModelReady", pb.ModelReadyRequest(name="m")))
    seen.append(answer(target, "RepositoryIndex", pb.RepositoryIndexRequest()))
    seen.append(answer(target, "RepositoryIndex", pb.RepositoryIndexRequest(ready=True)))
    seen.append(answer(target, "RepositoryModelLoad",
                       pb.RepositoryModelLoadRequest(model_name="m")))
    seen.append(answer(target, "ModelReady", pb.ModelReadyRequest(name="m")))
    code, after = _infer(target, x)
    seen.append(code)
    return seen, before, after


def test_repository_cycle_answers_as_the_jax_server(servers):
    got, before, after = _cycle(servers["torch"].target)
    want, _, _ = _cycle(servers["jax"].target)
    assert got == want
    assert got[3] == "UNAVAILABLE" and not got[4][2].ready and got[8][2].ready
    assert got[5][2].models[0].state == "UNAVAILABLE" and got[5][2].models[0].reason == "unloaded"
    assert len(got[6][2].models) == 0
    np.testing.assert_array_equal(after, before)  # the load reloaded the same weights


def test_hot_reload_swaps_the_weights(servers):
    """RepositoryModelLoad rebuilds from the config: another seed serves
    the new model's outputs, the config's seed again the first bit for
    bit; another quantization answers INTERNAL, as the JAX server does,
    and the served tree stays."""
    h = servers["torch"]
    cfg = h.server.cfg
    x = np.random.default_rng(0).standard_normal((2, DIM)).astype(np.float32)
    _, first = _infer(h.target, x)
    reload_ = pb.RepositoryModelLoadRequest(model_name="m")
    try:
        h.server.cfg = dataclasses.replace(cfg, seed=cfg.seed + 1)
        assert answer(h.target, "RepositoryModelLoad", reload_)[0] == "OK"
        _, other = _infer(h.target, x)
        ref = build_model(h.server.cfg.model, seed=cfg.seed + 1, device="cpu")
        want = ref.apply({"input": torch.from_numpy(x)})["output"].numpy().reshape(-1)
        np.testing.assert_array_equal(other, want)
        assert not np.array_equal(other, first)
        h.server.cfg = cfg
        assert answer(h.target, "RepositoryModelLoad", reload_)[0] == "OK"
        np.testing.assert_array_equal(_infer(h.target, x)[1], first)
        codes = []
        for side, mod in (("torch", tcfg), ("jax", jcfg)):
            srv = servers[side].server
            base = srv.cfg
            srv.cfg = dataclasses.replace(base, model=dataclasses.replace(
                base.model, quantization=mod.QuantMode.NONE))
            try:
                code, details, _ = answer(servers[side].target, "RepositoryModelLoad", reload_)
            finally:
                srv.cfg = base
            codes.append((code, details.split(":")[0]))
        assert codes[0] == codes[1] == ("INTERNAL", "model reload failed")
        np.testing.assert_array_equal(_infer(h.target, x)[1], first)
        assert h.server.engine.model.quant is QuantMode.INT8
    finally:
        h.server.cfg = cfg


def test_trace_setting_toggles_the_tracer(servers, tmp_path):
    """TraceSetting enables the tracer into a directory, the batches in
    between are traced, disabling flushes them; both servers answer the
    same settings."""
    out = {}
    for side in ("torch", "jax"):
        d = tmp_path / side
        target = servers[side].target
        on = pb.TraceSettingRequest(settings={
            "trace_enabled": pb.TraceSettingRequest.SettingValue(value=["true"]),
            "trace_output": pb.TraceSettingRequest.SettingValue(value=[str(d)])})
        off = pb.TraceSettingRequest(settings={
            "trace_enabled": pb.TraceSettingRequest.SettingValue(value=["false"])})
        enabled = answer(target, "TraceSetting", on)
        for i in range(3):
            _infer(target, np.full((1, DIM), i, np.float32), rid=f"t{i}")
        disabled = answer(target, "TraceSetting", off)
        out[side] = (enabled, disabled)
        events = json.loads((d / "batching_trace.json").read_text())["traceEvents"]
        assert sum(e["name"] == "batch" for e in events) >= 1
        assert sum(e["name"] == "request_enqueued" for e in events) == 3
    for side in out:  # the directories differ by name only
        for resp in (out[side][0][2], out[side][1][2]):
            resp.settings["trace_output"].value[0] = resp.settings["trace_output"].value[0] \
                .replace(str(tmp_path / side), "")
    assert out["torch"] == out["jax"]
    assert list(out["torch"][0][2].settings["trace_enabled"].value) == ["true"]
    assert list(out["torch"][1][2].settings["trace_enabled"].value) == ["false"]


async def _reflect(target, requests):
    async with grpc.aio.insecure_channel(target) as channel:
        call = channel.stream_stream(
            "/grpc.reflection.v1alpha.ServerReflection/ServerReflectionInfo",
            request_serializer=rpb.ServerReflectionRequest.SerializeToString,
            response_deserializer=rpb.ServerReflectionResponse.FromString)()
        out = []
        for r in requests:
            await call.write(r)
            out.append(await call.read())
        await call.done_writing()
        return out


async def _health(target):
    async with grpc.aio.insecure_channel(target) as channel:
        check = channel.unary_unary("/grpc.health.v1.Health/Check",
                                    request_serializer=lambda b: b,
                                    response_deserializer=lambda b: b)
        watch = channel.unary_stream("/grpc.health.v1.Health/Watch",
                                     request_serializer=lambda b: b,
                                     response_deserializer=lambda b: b)
        first = None
        async for msg in watch(b""):
            first = msg
            break
        return await check(b""), first


def test_reflection_and_health_answer_as_the_jax_server(servers):
    requests = [
        rpb.ServerReflectionRequest(list_services="*"),
        rpb.ServerReflectionRequest(file_containing_symbol="inference.GRPCInferenceService"),
        rpb.ServerReflectionRequest(file_containing_symbol="inference.ModelInferRequest"),
        rpb.ServerReflectionRequest(file_containing_symbol="grpc.health.v1.Health"),
        rpb.ServerReflectionRequest(
            file_containing_symbol="grpc.reflection.v1alpha.ServerReflection"),
        rpb.ServerReflectionRequest(file_containing_symbol="no.such.Symbol"),
        rpb.ServerReflectionRequest(file_by_filename="kserve_v2.proto"),
        rpb.ServerReflectionRequest(file_by_filename="nope.proto"),
        rpb.ServerReflectionRequest(all_extension_numbers_of_type="inference.ModelInferRequest"),
        rpb.ServerReflectionRequest(all_extension_numbers_of_type="no.such.Type"),
    ]
    got = run(_reflect(servers["torch"].target, requests))
    want = run(_reflect(servers["jax"].target, requests))
    assert [r.SerializeToString(deterministic=True) for r in got] == \
        [r.SerializeToString(deterministic=True) for r in want]
    names = {s.name for s in got[0].list_services_response.service}
    assert "inference.GRPCInferenceService" in names
    assert len(got[1].file_descriptor_response.file_descriptor_proto) == 1
    assert got[5].error_response.error_code == grpc.StatusCode.NOT_FOUND.value[0]
    assert run(_health(servers["torch"].target)) == run(_health(servers["jax"].target)) == \
        (b"\x08\x01", b"\x08\x01")


# -- a decoder server: the load gates only -----------------------------------------

def _generate_request(prompt, max_new):
    req = pb.ModelInferRequest(model_name="llama")
    t = req.inputs.add()
    t.name, t.datatype = "input_ids", "INT64"
    t.shape.extend([1, len(prompt)])
    req.raw_input_contents.append(np.asarray(prompt, np.int64).tobytes())
    req.parameters["max_new_tokens"].int64_param = max_new
    return req


def test_decoder_load_gates_streams_and_infers():
    cfg = tcfg.parse_config({
        "name": "llama",
        "model": {"family": "llama-tiny", "compute_dtype": "FP32",
                  "options": {"layers": 1, "hidden": 64, "q_heads": 2, "kv_heads": 1,
                              "intermediate": 96, "vocab": 64, "num_slots": 2,
                              "max_len": 32, "prefill_buckets": [8]}},
        "inputs": [{"name": "input_ids", "dims": [8], "dtype": "INT64"}],
        "outputs": [{"name": "logits", "dims": [8, 64], "dtype": "FP32"}],
        "pool_size": 1, "max_batch_size": 1, "batch_coalesce_timeout_ms": 0,
        "batching_strategy": "disabled", "metrics_enabled": False,
        "server": {"address": "127.0.0.1:0"},
    })
    with Harness(InferenceServer(cfg, device="cpu")) as h:
        assert answer(h.target, "RepositoryModelUnload", pb.RepositoryModelUnloadRequest())[0] \
            == "OK"
        assert answer(h.target, "ModelInfer", _generate_request([1, 2, 3], 4))[0] == "UNAVAILABLE"

        async def stream():
            async with grpc.aio.insecure_channel(h.target) as channel:
                call = channel.stream_stream(
                    "/inference.GRPCInferenceService/ModelStreamInfer",
                    request_serializer=pb.ModelInferRequest.SerializeToString,
                    response_deserializer=pb.ModelStreamInferResponse.FromString)
                return await call().read()

        with pytest.raises(grpc.aio.AioRpcError) as err:
            run(stream())
        assert err.value.code() == grpc.StatusCode.UNAVAILABLE
        assert answer(h.target, "RepositoryModelLoad", pb.RepositoryModelLoadRequest())[0] \
            == "OK"
        code, _, resp = answer(h.target, "ModelInfer", _generate_request([1, 2, 3], 4))
        assert code == "OK" and list(resp.outputs[0].shape) == [1, 4]
        # the model name is checked on the generation route too (the JAX
        # servicer routes a decoder's request before its name check)
        other = _generate_request([1, 2, 3], 4)
        other.model_name = "other"
        assert answer(h.target, "ModelInfer", other)[0] == "NOT_FOUND"


# -- the server's observability wiring ---------------------------------------------

def scrape(port) -> dict:
    """{sample line name with labels: value} of one /metrics scrape."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
        text = resp.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def test_server_serves_metrics_and_frees_its_port():
    cfg = control_cfg(tcfg, metrics_enabled=True, metrics_port=0,
                      congestion={"tick_interval_ms": 20, "latency_slo_ms": 300})
    with Harness(InferenceServer(cfg, device="cpu")) as h:
        server = h.server
        port = server.metrics_port
        assert port and port_is_listened_on(port)
        before = scrape(port)
        d = server.runner.dispatcher
        done0, formed0 = d.completed_jobs, sum(a["count"] for a in d.batch_stats.values())
        ticks0 = server.congestion.snapshot().tick
        x = np.ones((1, DIM), np.float32)
        for i in range(6):
            assert _infer(h.target, x, rid=str(i))[0] == "OK"
        time.sleep(0.1)  # a few ticks
        after = scrape(port)
        delta = {k: after[k] - before.get(k, 0.0) for k in after}
        assert delta["inference_completed_total"] == d.completed_jobs - done0 == 6
        assert delta["inference_batch_size_count"] == \
            sum(a["count"] for a in d.batch_stats.values()) - formed0
        assert delta['requests_by_status_total{code="OK"}'] == 6
        assert delta["requests_total"] == 6
        assert server.congestion.snapshot().tick > ticks0
        assert after["server_health_state"] == 1.0 and after["models_loaded"] == 1.0
        # the strategy decides on the monitor's snapshot
        assert server.runner._sample_strategy_input().monitor_tick >= 1
    assert not port_is_listened_on(port)


def test_congestion_gauges_follow_every_tick():
    cfg = control_cfg(tcfg, metrics_enabled=True, metrics_port=0)
    server = InferenceServer(cfg, device="cpu", expose_metrics=False)
    try:
        rec = server.recorder
        for i in range(3):
            server.congestion.record_arrival()
            server.congestion.record_completion(10.0 * (i + 1))
            snap = server.congestion.tick(0.1)
            assert not snap.congested  # no state change: the JAX wiring would not publish
            gauge = rec.registry.get_sample_value
            assert gauge("inference_lambda_rps") == snap.ewma_lambda
            assert gauge("inference_e2e_latency_p95_ms") == snap.p95_ms
            assert gauge("inference_queue_fill_ratio_ewma") == snap.ewma_queue_fill
    finally:
        server._close_metrics()


def test_metrics_enabled_without_the_library_fails_at_start(monkeypatch):
    monkeypatch.setitem(sys.modules, "prometheus_client", None)
    with pytest.raises(ImportError):
        InferenceServer(control_cfg(tcfg, metrics_enabled=True, metrics_port=0), device="cpu")
    # with metrics off the same server builds
    server = InferenceServer(control_cfg(tcfg), device="cpu")
    assert server.recorder is None and server.metrics_port is None
