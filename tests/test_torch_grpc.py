"""The port's gRPC server on CPU over a real socket: ModelInfer and
ModelStreamInfer return the tokens of the port's own engine (modelled on
tests/e2e/test_decoder_grpc.py), and the batch ModelInfer route returns
the JAX model's outputs for ``add_one`` and a 1-layer BERT (modelled on
tests/e2e/test_grpc_e2e.py)."""

import asyncio
import threading

import grpc
import numpy as np
import pytest
import torch

from starpu_inference_server_tpu_torch.grpc import kserve_v2_pb2 as pb
from starpu_inference_server_tpu_torch.grpc.server import InferenceServer
from starpu_inference_server_tpu_torch.utils.config import parse_config
from starpu_inference_server_tpu_torch.utils.exceptions import UnknownModelFamilyError


def decoder_cfg(family="llama-tiny", **options):
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
                "prefill_chunk": 16, "steps_per_sync": 2, **options,
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
    # queue: submit to admission; inference: admission to the last token
    assert 0 <= resp.server_queue_ms <= resp.server_total_ms
    assert resp.server_queue_ms + resp.server_inference_ms == pytest.approx(resp.server_total_ms)


SERVING_OPTIONS = {
    "speculative": {"draft_variant": "llama-tiny", "speculate_k": 3,
                    "draft_options": {"layers": 1, "hidden": 64, "q_heads": 2,
                                      "kv_heads": 1, "intermediate": 128}},
    "prompt_lookup": {"prompt_lookup_ngram": 2, "speculate_k": 3},
    "paged_prefix": {"kv_page_size": 8, "kv_pool_pages": 20, "prefix_cache": True,
                     "prefix_cache_min": 8},
}
# the same options on the FLAT cache layout, and the flat layout alone
SERVING_OPTIONS.update({f"flat_{k}": dict(v, kv_cache_layout="flat")
                        for k, v in list(SERVING_OPTIONS.items())})
SERVING_OPTIONS["flat"] = {"kv_cache_layout": "flat"}


@pytest.mark.parametrize("name", sorted(SERVING_OPTIONS))
def test_serving_options_over_grpc_give_the_plain_engine_tokens(harness, name):
    """A server built from a config with a draft model, prompt lookup or
    the paged cache with prefix reuse, in the standard or the flat cache
    layout, answers ModelInfer with the greedy tokens of the plain engine
    on the same weights."""
    options = SERVING_OPTIONS[name]
    shared = list(range(20, 36))  # a 16-token prefix for the prefix cache
    prompts = [[3, 7, 11], shared + [1, 2], shared + [5, 6, 7]]
    with Harness(decoder_cfg(**options)) as h:
        got = [np.frombuffer(run(_unary(h.target, "ModelInfer", _request(p, 8, f"r{i}"),
                                        pb.ModelInferResponse)).raw_output_contents[0],
                             np.int32).tolist() for i, p in enumerate(prompts)]
        eng = h.server.generation_engine
        assert eng.flat_cache == (options.get("kv_cache_layout") == "flat") == eng.cache.flat
        if "draft_variant" in options or "prompt_lookup_ngram" in options:
            assert eng.headroom() == 3
        if "draft_variant" in options:
            assert eng.draft_spec.vocab == 128 and eng.drafted_tokens > 0
        if "prefix_cache" in options:
            assert eng.kv_page_size == 8 and eng.prefix_hits >= 1
    want = [harness.server.generation_engine.generate(np.asarray(p), 8) for p in prompts]
    assert got == want


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

    timers = harness.server.generation_engine.loop_timers
    sends = timers["request.send.n"], timers["request.send"]
    streamed = run(stream())
    # the stream's first response was handed to gRPC once
    assert timers["request.send.n"] == sends[0] + 1 and timers["request.send"] > sends[1]
    unary = run(_unary(harness.target, "ModelInfer", _request(PROMPTS[0], 6),
                       pb.ModelInferResponse))
    assert streamed == np.frombuffer(unary.raw_output_contents[0], np.int32).tolist()
    assert timers["request.send.n"] == sends[0] + 1  # a unary answer sends no stream


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
    if case == "unported_rpc":  # shared memory: UNIMPLEMENTED, as in the JAX server
        req, method, want = pb.SystemSharedMemoryStatusRequest(), "SystemSharedMemoryStatus", \
            grpc.StatusCode.UNIMPLEMENTED
        resp_cls = pb.SystemSharedMemoryStatusResponse
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
    """Every model family of the JAX package is served now (ViT was the
    last non-decoder family); a name that neither package registers is
    refused at the door, and ``pipe_microgroups`` is read as the JAX
    server reads it: without a pipe axis it changes nothing (the engine
    is the single-device one, as the JAX engine ignores it there)."""
    from starpu_inference_server_tpu.models import available_families as jax_families
    from starpu_inference_server_tpu_torch.models import available_families

    assert set(jax_families()) <= set(available_families())
    with pytest.raises(UnknownModelFamilyError, match="unknown model family"):
        InferenceServer(decoder_cfg(family="vit_h_14"), device="cpu")
    tokens = []
    for cfg in (decoder_cfg(pipe_microgroups=2), decoder_cfg()):
        eng = InferenceServer(cfg, device="cpu").generation_engine
        assert eng.pipe is None and eng.mesh is None and not eng._pipe_stages
        eng.start()
        try:
            tokens.append(eng.generate(np.asarray(PROMPTS[0]), 4, timeout=60.0))
        finally:
            eng.stop()
    assert tokens[0] == tokens[1]


# -- the batch ModelInfer route -------------------------------------------------

def batch_cfg(family="add_one", **over):
    if family == "add_one":
        model = {"family": "add_one", "compute_dtype": "FP32", "options": {"dims": [4]}}
        inputs = [{"name": "input", "dims": [4], "dtype": "FP32"}]
        outputs = [{"name": "output", "dims": [4], "dtype": "FP32"}]
    else:
        model = {"family": "bert-base-uncased", "compute_dtype": "FP32",
                 "options": {"num_layers": 1, "seq_len": 512, "vocab_size": 512}}
        inputs = [{"name": "input_ids", "dims": [512], "dtype": "INT64"},
                  {"name": "attention_mask", "dims": [512], "dtype": "INT64"}]
        outputs = [{"name": "last_hidden_state", "dims": [512, 768], "dtype": "FP32"}]
    raw = {
        "name": "m", "model": model, "inputs": inputs, "outputs": outputs,
        "pool_size": 2, "max_batch_size": 4, "batch_coalesce_timeout_ms": 5,
        "batching_strategy": "fixed", "fixed_batching": {"batch_size": 4},
        "max_queue_size": 16, "max_inflight_tasks": 4, "devices": {"lanes_per_device": 2},
        "metrics_enabled": False, "server": {"address": "127.0.0.1:0"},
    }
    raw.update(over)
    return parse_config(raw)


def _infer_request(named_arrays, rid="b"):
    req = pb.ModelInferRequest(model_name="m", id=rid)
    for name, arr in named_arrays.items():
        t = req.inputs.add()
        t.name, t.datatype = name, {"float32": "FP32", "int64": "INT64"}[arr.dtype.name]
        t.shape.extend(arr.shape)
        req.raw_input_contents.append(arr.tobytes())
    return req


def _jax_apply(cfg, arrays):
    import jax.numpy as jnp

    from starpu_inference_server_tpu.models import build_model as jax_build
    from starpu_inference_server_tpu.utils.config import ModelSettings as JSettings

    jm = jax_build(JSettings(family=cfg.model.family, compute_dtype="FP32",
                             options=cfg.model.options), seed=cfg.seed)
    out = jm.apply({k: jnp.asarray(v) for k, v in arrays.items()})
    return np.asarray(out[cfg.outputs[0].name])


@pytest.fixture(scope="module")
def add_one_server():
    with Harness(batch_cfg()) as h:
        yield h


def test_batch_model_infer_coalesces_and_matches_jax(add_one_server):
    cfg = add_one_server.server.cfg
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((rows, 4)).astype(np.float32) for rows in (1, 2, 1, 3, 1, 1)]

    async def go():
        async with grpc.aio.insecure_channel(add_one_server.target) as channel:
            call = channel.unary_unary(
                "/inference.GRPCInferenceService/ModelInfer",
                request_serializer=pb.ModelInferRequest.SerializeToString,
                response_deserializer=pb.ModelInferResponse.FromString)
            return await asyncio.gather(*(call(_infer_request({"input": x}, rid=str(i)),
                                               timeout=60) for i, x in enumerate(xs)))

    for i, (x, resp) in enumerate(zip(xs, run(go()))):
        assert resp.id == str(i) and resp.outputs[0].name == "output"
        assert list(resp.outputs[0].shape) == [len(x), 4] and resp.outputs[0].datatype == "FP32"
        got = np.frombuffer(resp.raw_output_contents[0], np.float32).reshape(x.shape)
        np.testing.assert_array_equal(got, _jax_apply(cfg, {"input": x}))
        assert resp.server_total_ms >= resp.server_inference_ms >= 0
        assert resp.server_total_ms > 0 and resp.server_receive_ms > 0
    stats = run(_unary(add_one_server.target, "ModelStatistics", pb.ModelStatisticsRequest(),
                       pb.ModelStatisticsResponse)).model_stats[0]
    assert stats.inference_stats.success.count >= len(xs)
    assert sum(b.batch_size * b.compute_infer.count for b in stats.batch_stats) >= 9


@pytest.mark.parametrize("case", ["wrong_shape", "wrong_dtype", "batch_too_large", "stream"])
def test_batch_route_rejects_bad_requests(add_one_server, case):
    x = np.zeros((1, 4), np.float32)
    method, resp_cls, want = "ModelInfer", pb.ModelInferResponse, \
        grpc.StatusCode.INVALID_ARGUMENT
    if case == "wrong_shape":
        req = _infer_request({"input": np.zeros((1, 5), np.float32)})
    elif case == "wrong_dtype":
        req = _infer_request({"input": x})
        req.inputs[0].datatype = "INT32"
    elif case == "batch_too_large":
        req = _infer_request({"input": np.zeros((5, 4), np.float32)})

    if case == "stream":
        async def go():
            async with grpc.aio.insecure_channel(add_one_server.target) as channel:
                call = channel.stream_stream(
                    "/inference.GRPCInferenceService/ModelStreamInfer",
                    request_serializer=pb.ModelInferRequest.SerializeToString,
                    response_deserializer=pb.ModelStreamInferResponse.FromString)
                # read only: the server aborts before it reads a request, and
                # a client write racing that abort fails as INTERNAL instead
                return await call().read()

        with pytest.raises(grpc.aio.AioRpcError) as err:
            run(go())
        assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
        return
    with pytest.raises(grpc.aio.AioRpcError) as err:
        run(_unary(add_one_server.target, method, req, resp_cls))
    assert err.value.code() == want


def test_full_queue_answers_resource_exhausted():
    from starpu_inference_server_tpu_torch.core.job import InferenceJob

    with Harness(batch_cfg(max_queue_size=1, max_batch_size=1, pool_size=1,
                           max_inflight_tasks=1, batching_strategy="disabled")) as h:
        runner, queue = h.server.runner, h.server.queue
        runner.collector.stop()  # nothing drains the queue from here on
        runner.collector.join(timeout=5)
        parked = InferenceJob({"input": np.zeros((1, 4), np.float32)})
        queue.push(parked)
        with pytest.raises(grpc.aio.AioRpcError) as err:
            run(_unary(h.target, "ModelInfer", _infer_request({"input": np.zeros((1, 4),
                                                                         np.float32)}),
                       pb.ModelInferResponse))
        assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        assert queue.try_pop() is parked
        runner.dispatcher.fail_unsubmitted_job(parked, RuntimeError("parked"))


def test_batch_model_infer_serves_bert_like_the_jax_model():
    cfg = batch_cfg("bert")
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 512, (2, 512)).astype(np.int64)
    mask = np.ones((2, 512), np.int64)
    mask[1, 200:] = 0
    with Harness(cfg) as h:
        resp = run(_unary(h.target, "ModelInfer",
                          _infer_request({"input_ids": ids, "attention_mask": mask}),
                          pb.ModelInferResponse))
    assert list(resp.outputs[0].shape) == [2, 512, 768]
    got = np.frombuffer(resp.raw_output_contents[0], np.float32).reshape(2, 512, 768)
    want = _jax_apply(cfg, {"input_ids": ids, "attention_mask": mask})
    # the JAX package's own BERT tolerance (test_bidirectional_attention.py)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert resp.server_inference_ms > 0


# -- serve_logits: a decoder on the batch route -----------------------------------

def logits_cfg(parse=parse_config, seq=16):
    """llama-tiny (2 layers, hidden 128, int4) with ``serve_logits: true``:
    teacher-forced logits of ``input_ids`` through the batch pipeline."""
    return parse({
        "name": "m",
        "model": {"family": "llama-tiny", "compute_dtype": "FP32", "quantization": "int4",
                  "options": {"layers": 2, "hidden": 128, "q_heads": 2, "kv_heads": 1,
                              "intermediate": 256, "vocab": 128, "seq_len": seq,
                              "serve_logits": True}},
        "inputs": [{"name": "input_ids", "dims": [seq], "dtype": "INT64"}],
        "outputs": [{"name": "logits", "dims": [seq, 128], "dtype": "FP32"}],
        "pool_size": 2, "max_batch_size": 2, "batch_coalesce_timeout_ms": 2,
        "batching_strategy": "adaptive", "max_queue_size": 16, "max_inflight_tasks": 2,
        "warmup_request_nb": 1, "seed": 5,
        "metrics_enabled": False, "server": {"address": "127.0.0.1:0"},
    })


class _JaxHarness(Harness):
    def __init__(self, cfg):  # the JAX package's server in the same harness
        from starpu_inference_server_tpu.grpc.server import InferenceServer as JaxServer

        self.server = JaxServer(cfg, expose_metrics=False)
        self.ready = threading.Event()
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True)


def test_serve_logits_server_answers_like_the_jax_server():
    """A port server and a JAX server of the same ``serve_logits`` config
    side by side: neither builds a generation engine; four concurrent
    ModelInfer requests of 16 ids each get the same teacher-forced logits
    (int4 weights at FP32: f32 sums in another order, limit 1e-4);
    ModelStreamInfer answers UNIMPLEMENTED on both, as on any batch
    model."""
    from starpu_inference_server_tpu.utils import config as jcfg

    rng = np.random.default_rng(4)
    ids = [rng.integers(0, 128, (1, 16)).astype(np.int64) for _ in range(4)]
    outs = {}
    with _JaxHarness(logits_cfg(jcfg.parse_config)) as j, Harness(logits_cfg()) as t:
        assert t.server.generation_engine is None and t.server.runner is not None
        assert j.server.generation_engine is None
        for name, h in (("jax", j), ("torch", t)):
            async def go(target=h.target):
                async with grpc.aio.insecure_channel(target) as channel:
                    call = channel.unary_unary(
                        "/inference.GRPCInferenceService/ModelInfer",
                        request_serializer=pb.ModelInferRequest.SerializeToString,
                        response_deserializer=pb.ModelInferResponse.FromString)
                    return await asyncio.gather(*(
                        call(_infer_request({"input_ids": x}, rid=str(i)), timeout=120)
                        for i, x in enumerate(ids)))

            resps = run(go())
            assert [r.outputs[0].name for r in resps] == ["logits"] * 4
            assert all(list(r.outputs[0].shape) == [1, 16, 128] for r in resps)
            outs[name] = [np.frombuffer(r.raw_output_contents[0], np.float32).reshape(16, 128)
                          for r in resps]

            async def stream(target=h.target):
                async with grpc.aio.insecure_channel(target) as channel:
                    call = channel.stream_stream(
                        "/inference.GRPCInferenceService/ModelStreamInfer",
                        request_serializer=pb.ModelInferRequest.SerializeToString,
                        response_deserializer=pb.ModelStreamInferResponse.FromString)
                    return await call().read()

            with pytest.raises(grpc.aio.AioRpcError) as err:
                run(stream())
            assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
    for got, want in zip(outs["torch"], outs["jax"]):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_serve_logits_engine_packs_int4_and_reloads():
    """The batch engine of a ``serve_logits`` decoder with the kernel
    routes forced on: its int4 leaves are packed pairwise (the embedding
    table too, gathered packed), its logits equal the unpacked tree's
    (the int4 kernel's plain version rounds activations to bf16, as the
    kernel does: limit 5e-2, the decoder tests' own), and a hot reload of
    the same config swaps in a tree of the same leaves with equal
    outputs."""
    from starpu_inference_server_tpu_torch.core.engine import ModelEngine
    from starpu_inference_server_tpu_torch.models.registry import build_model
    from starpu_inference_server_tpu_torch.ops import nn

    cfg = logits_cfg()
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, 128, (2, 16)))
    plain = build_model(cfg.model, seed=cfg.seed, device="cpu")
    with torch.inference_mode():
        want = plain.apply({"input_ids": ids})["logits"]
    nn.set_use_kernels(True)
    try:
        engine = ModelEngine(cfg, build_model(cfg.model, seed=cfg.seed, device="cpu"))
        layer = engine.model.params["layers"][0]
        assert "w_p4" in layer["attn"]["qkv"]["w"] and "w_p4" in engine.model.params["embed"]["w"]
        got = engine.fetch(engine.run_padded({"input_ids": ids}))["logits"]
        engine.reload(build_model(cfg.model, seed=cfg.seed, device="cpu"))
        again = engine.fetch(engine.run_padded({"input_ids": ids}))["logits"]
    finally:
        nn.set_use_kernels(None)
    assert got.shape == (2, 16, 128)
    rel = ((got - want).abs().mean() / want.abs().mean()).item()
    assert rel < 5e-2, rel
    assert torch.equal(got, again)
