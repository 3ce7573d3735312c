"""The port's clients against the JAX package's, on the CPU.

- ``utils/latency_statistics.py``: ``summarize`` and ``percentile`` give
  the JAX module's numbers on seeded samples.
- ``clients/client.py``: ``load_schedule`` and ``parse_input_arg`` equal
  the JAX client's on both ``ci/perf/*.csv`` files and sample arguments;
  the port client replays the CI smoke schedule against a port ``add_one``
  server with ``--validate`` and the analytic oracle (a wrong oracle
  fails every response); the four client x server pairings (JAX and port,
  each way) count the same requests and validations, with the JAX
  client's summary schema; the ``GenerationClient`` gets the same tokens,
  request for request, from a port and a JAX llama-tiny server of one
  seed, streaming and unary, and a stream's tokens equal the unary
  response's.
- The CLI entry points as separate processes: the port server (``--device
  cpu``), the port client and ``scripts/check_perf_summary.py``.
- ``clients/bert_client.py``: the offline tokenizer gives the same ids in
  interpreters with different ``PYTHONHASHSEED`` (the JAX client's
  ``hash()`` does not), and the client validates a port BERT server
  against its local reference on the CPU.
"""

import asyncio
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from starpu_inference_server_tpu.clients import client as jclient
from starpu_inference_server_tpu.utils import config as jcfg
from starpu_inference_server_tpu.utils import latency_statistics as jstats
from starpu_inference_server_tpu_torch.clients import bert_client as tbert
from starpu_inference_server_tpu_torch.clients import client as tclient
from starpu_inference_server_tpu_torch.grpc.server import InferenceServer
from starpu_inference_server_tpu_torch.utils import config as tcfg
from starpu_inference_server_tpu_torch.utils import latency_statistics as tstats

ROOT = Path(__file__).resolve().parent.parent
SMOKE = ROOT / "ci" / "perf" / "ci_perf_resnet_smoke.csv"
SMOKE_REQUESTS = 64
CLIENTS = {"jax": jclient, "torch": tclient}

# --- latency statistics, schedules, input arguments ---------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 7, 1000])
def test_latency_statistics_equal_jax(n):
    samples = np.random.default_rng(n).exponential(5.0, n).tolist()
    assert tstats.summarize(samples) == jstats.summarize(samples)
    for pct in (0, 50, 85, 95, 99.9, 100):
        assert tstats.percentile(samples, pct) == jstats.percentile(samples, pct)


def _schedule_file(tmp_path, name):
    if name != "with_input_ids":
        return ROOT / "ci" / "perf" / f"{name}.csv"
    path = tmp_path / "schedule.csv"
    path.write_text("# comment\n\n1000,3,2\n250,2\n  50,1,4  \n")
    return path


@pytest.mark.parametrize("name", ["ci_perf_resnet", "ci_perf_resnet_smoke", "with_input_ids"])
def test_load_schedule_equals_jax(name, tmp_path):
    path = str(_schedule_file(tmp_path, name))
    got = [(s.delta_us, s.repeat, s.input_id) for s in tclient.load_schedule(path)]
    want = [(s.delta_us, s.repeat, s.input_id) for s in jclient.load_schedule(path)]
    assert got == want and got
    if name == "ci_perf_resnet":
        assert sum(r for _, r, _ in got) == 6300


@pytest.mark.parametrize("arg", ["input:3x224x224:FP32", "input_ids:512:INT64", "x:1X8:fp16",
                                 "mask:4x4:BOOL", "bad", "x:3xa:FP32"])
def test_parse_input_arg_equals_jax(arg):
    try:
        want = jclient.parse_input_arg(arg)
    except ValueError:
        with pytest.raises(ValueError):
            tclient.parse_input_arg(arg)
        return
    got = tclient.parse_input_arg(arg)
    assert (got.name, got.dims, got.dtype) == (want.name, want.dims, want.dtype)


# --- servers on their own loop threads -----------------------------------------


class Harness:
    """A server's ``serve()`` on a private asyncio loop thread."""

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
        assert self.ready.wait(timeout=300), "server failed to start"
        self.target = f"127.0.0.1:{self.server.bound_port}"
        return self

    def __exit__(self, *exc):
        self.loop.call_soon_threadsafe(self.server.request_stop)
        self.thread.join(timeout=60)


def _serve(pkg, raw):
    if pkg == "torch":
        return Harness(InferenceServer(tcfg.parse_config(raw), device="cpu"))
    from starpu_inference_server_tpu.grpc.server import InferenceServer as JaxServer

    return Harness(JaxServer(jcfg.parse_config(raw), expose_metrics=False))


def add_one_raw(address="127.0.0.1:0"):
    return {
        "name": "add_one",
        "model": {"family": "add_one", "compute_dtype": "FP32", "options": {"dims": [8]}},
        "inputs": [{"name": "input", "dims": [8], "dtype": "FP32"}],
        "outputs": [{"name": "output", "dims": [8], "dtype": "FP32"}],
        "pool_size": 2, "max_batch_size": 4, "batch_coalesce_timeout_ms": 1.0,
        "batching_strategy": "fixed", "fixed_batching": {"batch_size": 4},
        "max_queue_size": 128, "max_inflight_tasks": 4, "warmup_request_nb": 1,
        "congestion": {"enabled": False}, "metrics_enabled": False,
        "server": {"address": address},
    }


@pytest.fixture(scope="module")
def add_one_servers():
    with _serve("jax", add_one_raw()) as j, _serve("torch", add_one_raw()) as t:
        yield {"jax": j, "torch": t}


def _replay(pkg, target, tmp_path, *extra):
    """``main`` of a package's client: the CI smoke schedule, validated."""
    out = tmp_path / f"summary_{pkg}.json"
    rc = CLIENTS[pkg].main(["--target", target, "--model", "add_one", "--input",
                            "input:8:FP32", "--schedule", str(SMOKE), "--validate",
                            "--summary-json", str(out), *extra])
    return rc, json.loads(out.read_text())


def _schema(node):
    """The nested key structure of a summary."""
    return {k: _schema(v) for k, v in node.items()} if isinstance(node, dict) else None


def _jax_summary_schema(validate=True):
    async def go():
        client = jclient.InferenceClient("127.0.0.1:1", "m", [], validate=validate)
        try:
            return client.summary(1.0)
        finally:
            await client.close()

    return _schema(asyncio.run(go()))


def test_port_client_validates_a_port_server_with_the_analytic_oracle(add_one_servers,
                                                                        tmp_path):
    rc, summary = _replay("torch", add_one_servers["torch"].target, tmp_path)
    assert rc == 0
    assert summary["requests"] == {"sent": SMOKE_REQUESTS, "handled": SMOKE_REQUESTS,
                                   "rejected": 0, "errors": 0}
    assert summary["validation"] == {"checked": SMOKE_REQUESTS, "failures": 0}
    assert summary["latency_ms"]["server_overall"]["p100"] > 0
    assert summary["throughput_rps"] > 0

    async def wrong_oracle():  # x + 2 where the server answers x + 1: every response fails
        client = tclient.InferenceClient(
            add_one_servers["torch"].target, "add_one", [tclient.parse_input_arg("input:8:FP32")],
            validate=True, expected_fn=lambda x: {"output": x["input"] + 2.0})
        await client.wait_ready(timeout_s=30)
        await client.prime_expected()
        elapsed = await client.run_fixed(8, 200)
        await client.close()
        return client.summary(elapsed)

    bad = asyncio.run(wrong_oracle())
    assert bad["validation"]["checked"] == 8 and bad["validation"]["failures"] == 8
    assert "mismatch" in bad["validation"]["first_mismatch"]


@pytest.mark.parametrize("server", ["jax", "torch"])
@pytest.mark.parametrize("client", ["jax", "torch"])
def test_client_server_pairings_count_alike(client, server, add_one_servers, tmp_path):
    rc, summary = _replay(client, add_one_servers[server].target, tmp_path)
    assert rc == 0
    assert summary["requests"] == {"sent": SMOKE_REQUESTS, "handled": SMOKE_REQUESTS,
                                   "rejected": 0, "errors": 0}
    assert summary["validation"] == {"checked": SMOKE_REQUESTS, "failures": 0}
    assert _schema(summary) == _jax_summary_schema()


# --- generation ----------------------------------------------------------------

DECODER_OPTS = {"layers": 2, "hidden": 256, "q_heads": 4, "kv_heads": 2,
                "intermediate": 512, "vocab": 512, "seq_len": 64, "num_slots": 4,
                "max_len": 256, "prefill_buckets": [8, 32, 64], "steps_per_sync": 4,
                "prefill_chunk": 64}
GEN = dict(prompt_len=20, max_new_tokens=8, vocab=512, seed=5)
GEN_REQUESTS = 10


def decoder_raw():
    return {
        "name": "llama",
        "model": {"family": "llama-tiny", "compute_dtype": "FP32", "quantization": "int4",
                  "options": DECODER_OPTS},
        "inputs": [{"name": "input_ids", "dims": [64], "dtype": "INT64"}],
        "outputs": [{"name": "logits", "dims": [64, 512], "dtype": "FP32"}],
        "pool_size": 1, "max_batch_size": 1, "batch_coalesce_timeout_ms": 0,
        "batching_strategy": "disabled", "max_queue_size": 64, "max_inflight_tasks": 4,
        "seed": 0, "metrics_enabled": False, "server": {"address": "127.0.0.1:0"},
    }


@pytest.fixture(scope="module")
def decoder_servers():
    with _serve("jax", decoder_raw()) as j, _serve("torch", decoder_raw()) as t:
        yield {"jax": j, "torch": t}


def _generate(pkg, target, stream, concurrency=4):
    async def go():
        client = CLIENTS[pkg].GenerationClient(target, "llama", **GEN)
        elapsed = await client.run(GEN_REQUESTS, concurrency, stream)
        await client.close()
        return client, client.summary(elapsed)

    return asyncio.run(go())


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "unary"])
def test_generation_client_gets_the_jax_servers_tokens(stream, decoder_servers):
    runs = {pkg: _generate("torch", decoder_servers[pkg].target, stream)
            for pkg in ("jax", "torch")}
    for client, summary in runs.values():
        assert summary["requests"] == {"sent": GEN_REQUESTS, "handled": GEN_REQUESTS,
                                       "rejected": 0, "errors": 0}
        assert summary["generation"]["tokens_total"] == GEN_REQUESTS * GEN["max_new_tokens"]
        assert ("ttft_ms" in summary["generation"]) == stream
        assert sorted(client.tokens_by_request) == list(range(GEN_REQUESTS))
        for rid, tokens in client.tokens_by_request.items():  # one prompt, one stream
            assert tokens == client.tokens_by_request[rid % tclient.INPUT_POOL_SIZE]
    assert runs["torch"][0].tokens_by_request == runs["jax"][0].tokens_by_request
    # the JAX client against the port server: the same counts and schema
    jax_client, jax_summary = _generate("jax", decoder_servers["torch"].target, stream)
    assert jax_client.tokens == runs["torch"][1]["generation"]["tokens_total"]
    assert _schema(jax_summary) == _schema(runs["torch"][1])


def test_stream_tokens_equal_unary_tokens(decoder_servers):
    target = decoder_servers["torch"].target
    streamed, _ = _generate("torch", target, stream=True, concurrency=GEN_REQUESTS)
    unary, _ = _generate("torch", target, stream=False, concurrency=GEN_REQUESTS)
    assert streamed.tokens_by_request == unary.tokens_by_request
    prompts = tclient.pooled_prompts(GEN["prompt_len"], GEN["vocab"], GEN["seed"])
    assert [p.tolist() for p in prompts] == [p.tolist() for p in streamed.prompts]


# --- the CLI entry points as processes -------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launches(log: str, when: str) -> dict:
    return json.loads(re.search(rf"kernel launches {when}: (\{{.*\}})", log).group(1))


def test_cli_server_and_client_processes(tmp_path):
    """``python -m ...grpc.server --device cpu`` serves a config as its own
    process; the port client's CLI replays the CI smoke schedule against
    it, validated, and ``scripts/check_perf_summary.py`` passes the summary
    with the perf smoke's flags; the server logs its kernel launches after
    warmup and at shutdown, on SIGINT."""
    import yaml

    address = f"127.0.0.1:{free_port()}"
    cfg = tmp_path / "add_one.yml"
    cfg.write_text(yaml.safe_dump(add_one_raw(address)))
    log = tmp_path / "server.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    with open(log, "w") as fh:
        server = subprocess.Popen([sys.executable, "-m", "starpu_inference_server_tpu_torch.grpc"
                                   ".server", "--config", str(cfg), "--device", "cpu"],
                                  cwd=ROOT, env=env, stdout=fh, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while f"serving add_one on {address}" not in log.read_text():
            assert server.poll() is None, log.read_text()
            assert time.monotonic() < deadline, log.read_text()
            time.sleep(0.2)
        summary = tmp_path / "summary.json"
        client = subprocess.run(
            [sys.executable, "-m", "starpu_inference_server_tpu_torch.clients.client",
             "--target", address, "--model", "add_one", "--input", "input:8:FP32",
             "--schedule", str(SMOKE), "--ready-timeout-s", "60", "--summary-json",
             str(summary), "--validate"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert client.returncode == 0, client.stderr
        check = subprocess.run(
            [sys.executable, "scripts/check_perf_summary.py", "--summary", str(summary),
             "--latency-metric", "server_overall", "--max-latency-p95-ms", "500",
             "--min-throughput-rps", "10", "--max-rejected", "0", "--expected-requests",
             str(SMOKE_REQUESTS)],
            cwd=ROOT, capture_output=True, text=True, timeout=60)
        assert check.returncode == 0 and "[perf-check] OK" in check.stdout, check.stderr
        server.send_signal(signal.SIGINT)
        assert server.wait(timeout=60) == 0
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    text = log.read_text()
    assert _launches(text, "after warmup") == {} and _launches(text, "at shutdown") == {}
    assert "shutdown complete: completed=" in text


# --- the BERT client -------------------------------------------------------------

TOKENIZE = """
import json, sys
sys.modules["transformers"] = None  # the offline fallback
from starpu_inference_server_tpu_torch.clients.bert_client import tokenize
ids, mask = tokenize(["Hello world, hello TPU", "a second line of text"], 16)
print(json.dumps([ids.tolist(), mask.tolist()]))
"""


def test_bert_tokenize_fallback_is_stable_across_hash_seeds():
    """The same text gives the same ids in interpreters with different
    ``PYTHONHASHSEED``; the JAX client's ``1000 + hash(w) % 28000`` differs."""
    outs, salted = [], []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONHASHSEED=seed)
        run = subprocess.run([sys.executable, "-c", TOKENIZE], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
        assert run.returncode == 0, run.stderr
        outs.append(run.stdout)
        salted.append(subprocess.run([sys.executable, "-c", "print(1000 + hash('hello') % 28000)"],
                                     env=env, capture_output=True, text=True).stdout)
    assert outs[0] == outs[1]
    assert salted[0] != salted[1]
    ids, mask = json.loads(outs[0])
    assert ids[0][0] == 101 and ids[0][5] == 102 and ids[0][1] == ids[0][3]
    assert mask[0] == [1] * 6 + [0] * 10 and mask[1] == [1] * 7 + [0] * 9


def test_bert_client_validates_a_port_server_on_the_cpu(monkeypatch, capsys):
    """``bert_client.main --validate --device cpu`` against a port server of
    FP32 ``bert-base-uncased`` (seed 42, s = 128): the local reference on
    the CPU agrees."""
    monkeypatch.setitem(sys.modules, "transformers", None)  # the offline fallback
    raw = {
        "name": "bert", "model": {"family": "bert-base-uncased", "compute_dtype": "FP32"},
        "inputs": [{"name": "input_ids", "dims": [128], "dtype": "INT64"},
                   {"name": "attention_mask", "dims": [128], "dtype": "INT64"}],
        "outputs": [{"name": "last_hidden_state", "dims": [128, 768], "dtype": "FP32"}],
        "pool_size": 1, "max_batch_size": 2, "batch_coalesce_timeout_ms": 0,
        "batching_strategy": "disabled", "max_queue_size": 8, "max_inflight_tasks": 1,
        "warmup_request_nb": 1, "metrics_enabled": False, "congestion": {"enabled": False},
        "server": {"address": "127.0.0.1:0"},
    }
    with _serve("torch", raw) as h:
        rc = tbert.main(["--target", h.target, "--model", "bert", "--text", "hello there",
                         "--text", "a longer line of text to encode", "--validate",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "output last_hidden_state: shape (2, 128, 768)" in out
    assert "reference validation: OK" in out
