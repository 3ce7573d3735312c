"""A pipelined port server from the CLI on the CPU: a copy of
``configs/llama_pipelined.yml`` cut to llama-tiny at pipe=2 (FP32,
int8 weights) runs as two rank processes on gloo, answers ``ModelInfer``
and ``ModelStreamInfer`` with the greedy tokens of the JAX single-device
engine (``prefill_chunk`` = bucket / 2, prompts in the 16 bucket), and
exits non-zero once a rank is killed."""

import asyncio
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import grpc
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from starpu_inference_server_tpu.models import decoder as jdec
from starpu_inference_server_tpu.ops.quant import maybe_quantize_tree
from starpu_inference_server_tpu.serving.generation import GenerationEngine, GenerationRequest
from starpu_inference_server_tpu_torch.grpc import kserve_v2_pb2 as pb

ROOT = Path(__file__).resolve().parents[1]
OPTIONS = {"layers": 4, "hidden": 64, "q_heads": 4, "kv_heads": 2, "intermediate": 96,
           "vocab": 128, "num_slots": 4, "max_len": 64, "prefill_buckets": [8, 16],
           "steps_per_sync": 2, "pipe_microgroups": 2}
PROMPTS = [list(range(3, 13)), list(range(40, 53)), [5, 9, 2, 7, 1, 8, 4, 6, 3, 11, 12, 14]]
MAX_NEW = 6


def tiny_config(path: Path) -> Path:
    cfg = yaml.safe_load((ROOT / "configs" / "llama_pipelined.yml").read_text())
    cfg["model"].update(family="llama-tiny", compute_dtype="FP32", options=OPTIONS)
    cfg["inputs"] = [{"name": "input_ids", "dims": [16], "dtype": "INT64"}]
    cfg["outputs"] = [{"name": "logits", "dims": [16, 128], "dtype": "FP32"}]
    cfg["devices"] = {"mesh": {"pipe": 2}}
    cfg.update(metrics_enabled=False, congestion={"enabled": False},
               server={"address": "127.0.0.1:0"})
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_server")
    log = tmp / "server.log"
    fh = open(log, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "starpu_inference_server_tpu_torch.grpc.server",
         "--config", str(tiny_config(tmp / "tiny_pipelined.yml")), "--device", "cpu",
         "--timeout-s", "60"],
        cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    try:
        deadline = time.monotonic() + 120
        port = None
        while port is None and time.monotonic() < deadline and proc.poll() is None:
            m = re.search(r"serving \S+ on \S+ \(port (\d+)", log.read_text())
            port = int(m.group(1)) if m else None
            time.sleep(0.2)
        assert port, f"server did not start:\n{log.read_text()}"
        yield proc, f"127.0.0.1:{port}", log
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
        fh.close()


def _request(prompt, rid="r"):
    req = pb.ModelInferRequest(model_name="llama_pipelined", id=rid)
    t = req.inputs.add()
    t.name, t.datatype = "input_ids", "INT64"
    t.shape.extend([1, len(prompt)])
    req.raw_input_contents.append(np.asarray(prompt, np.int64).tobytes())
    req.parameters["max_new_tokens"].int64_param = MAX_NEW
    return req


async def _unary(target, prompt):
    async with grpc.aio.insecure_channel(target) as channel:
        call = channel.unary_unary("/inference.GRPCInferenceService/ModelInfer",
                                   request_serializer=pb.ModelInferRequest.SerializeToString,
                                   response_deserializer=pb.ModelInferResponse.FromString)
        resp = await call(_request(prompt), timeout=120)
    return np.frombuffer(resp.raw_output_contents[0], np.int32).tolist()


async def _stream(target, prompt):
    async with grpc.aio.insecure_channel(target) as channel:
        call = channel.stream_stream(
            "/inference.GRPCInferenceService/ModelStreamInfer",
            request_serializer=pb.ModelInferRequest.SerializeToString,
            response_deserializer=pb.ModelStreamInferResponse.FromString)

        async def requests():
            yield _request(prompt, rid="s")

        out = []
        async for resp in call(requests()):
            assert not resp.error_message
            out.append(int(np.frombuffer(resp.infer_response.raw_output_contents[0],
                                         np.int32)[0]))
        return out


@pytest.fixture(scope="module")
def want():
    """The JAX single-device engine on the server's weights (the config's
    default seed, 42; int8)."""
    spec = jdec.get_spec("llama-tiny", OPTIONS)
    params = maybe_quantize_tree(jdec.init_params(spec, np.random.default_rng(42)), bits=8)
    eng = GenerationEngine(spec, params, dtype=jnp.float32, num_slots=4, max_len=64,
                           prefill_buckets=[8, 16], steps_per_sync=2, prefill_chunk=8,
                           family="llama-tiny")
    eng.start()
    try:
        reqs = [GenerationRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=MAX_NEW)
                for p in PROMPTS]
        for r in reqs:
            eng.submit(r)
        return [r.result(timeout=120.0) for r in reqs]
    finally:
        eng.stop()


@pytest.mark.parametrize("route", ["ModelInfer", "ModelStreamInfer"])
def test_pipelined_server_answers_with_the_single_device_tokens(server, want, route):
    _, target, log = server
    fn = _unary if route == "ModelInfer" else _stream

    async def all_prompts():
        return await asyncio.gather(*(fn(target, p) for p in PROMPTS))

    got = asyncio.new_event_loop().run_until_complete(all_prompts())
    assert got == want
    assert "mesh backend: gloo" in log.read_text()


def test_a_killed_rank_makes_the_server_exit_non_zero(server, want):
    """Runs after the serving cases (it ends the module's server)."""
    proc, _, log = server
    pid = int(re.search(r"rank 1 pid (\d+)", log.read_text()).group(1))
    os.kill(pid, signal.SIGKILL)
    assert proc.wait(timeout=60) != 0
