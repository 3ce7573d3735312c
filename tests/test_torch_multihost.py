"""Multi-host meshes: several launchers (the JAX package's
``jax.distributed`` processes) of local ranks joining one coordinator,
against the JAX package's single-process runs, as JAX
``tests/integration/test_distributed_bringup.py`` holds its two
processes (llama-tiny at its spec there, CPU ranks over gloo):

- ``:230``: the int8 forward at data=2 x model=2 over 2 launchers of 2
  ranks, within ``test_torch_mesh_engine.py``'s 5e-4 of the JAX forward and
  bit-equal to the same world started by one launcher;
- ``:184``: FP32 greedy streams of the GSPMD engine, ``data`` across the
  launchers, equal to the JAX engine's;
- ``:460``: 2 launchers of 4 ranks at data=2 x model=4, each data row in
  one launcher, streams equal to JAX, every all-reduce over ``model`` and
  only ``data`` crossing: at kv_heads 4 (whole kv heads a rank) and at the
  JAX spec's 2 (``:489``; each kv head replicated on two ranks);
- ``:509``: pipe=2 x model=2, one stage a launcher: the first token is the
  JAX plain prefill's argmax, the next logits within 5e-3 of JAX
  ``decode_step``, and only the ``pipe`` hops cross;
- the server CLI as two ``--device cpu`` launchers of a tiny
  ``configs/llama_decoder.yml``: a gRPC stream equal to the JAX engine's
  greedy tokens after the mesh sat idle past ``--timeout-s``, SIGINT to
  launcher 0 ending both with 0, SIGINT to launcher 1 ending both
  non-zero; at ``num_processes == mesh.size`` a killed follower rank ends
  both non-zero within ``--timeout-s``;
- the configuration rules: auto-detection from the Open MPI and SLURM
  variables, a mesh that ``num_processes`` does not divide, launchers
  disagreeing on the backend, the axes crossing launchers.
"""

import asyncio
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import grpc
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from starpu_inference_server_tpu.models import decoder as jdec
from starpu_inference_server_tpu.ops.quant import maybe_quantize_tree
from starpu_inference_server_tpu.serving.generation import GenerationEngine as JaxEngine
from starpu_inference_server_tpu.serving.generation import GenerationRequest as JaxRequest
from starpu_inference_server_tpu_torch.grpc import kserve_v2_pb2 as pb
from starpu_inference_server_tpu_torch.models.decoder import get_spec
from starpu_inference_server_tpu_torch.parallel.census import collectives_by_axis, crossing_calls
from starpu_inference_server_tpu_torch.parallel.launch import run_world
from starpu_inference_server_tpu_torch.parallel.mesh import (
    MeshAxes,
    agree_backend,
    crossing_axes,
    local_size,
)
from starpu_inference_server_tpu_torch.serving.generation import check_mesh
from starpu_inference_server_tpu_torch.utils.config import (
    CLUSTER_VARIABLES,
    DistributedSettings,
    parse_config,
    resolve_distributed,
)
from starpu_inference_server_tpu_torch.utils.exceptions import InvalidConfigValueError

ROOT = Path(__file__).resolve().parents[1]
# the JAX bring-up tests' llama-tiny
SPEC = {"layers": 2, "hidden": 128, "q_heads": 4, "kv_heads": 2, "intermediate": 256,
        "vocab": 128}
SPEC4 = dict(SPEC, kv_heads=4)  # model=4 splits whole kv heads (at SPEC's 2: replicas)
PROMPTS = [[3, 7, 11], [5, 2], [9, 1, 4]]
ENGINE = dict(num_slots=4, max_len=64, prefill_buckets=[8], steps_per_sync=2)
IDS = np.tile(np.arange(1, 9, dtype=np.int64), (4, 1))
PIPE_PROMPT = np.asarray([3, 7, 11, 2, 9, 0, 0, 0], np.int32)


def _gen(name, opts):
    return {"name": name, "kind": "generate", "family": "llama-tiny", "opts": opts, "seed": 0,
            "prompts": PROMPTS, "engine": ENGINE, "quant": None, "max_new": 6, "draft": None}


FORWARD = {"name": "forward_int8", "kind": "forward", "family": "llama-tiny",
           "options": dict(SPEC, seq_len=8), "quant": "int8", "inputs": {"input_ids": IDS}}
# name: (rank bodies, axes, world, launchers, cases)
WORLDS = {
    "dm": ("torch_mesh_cases:world", {"data": 2, "model": 2}, 4, 2,
           [FORWARD, _gen("generate", SPEC)]),
    "dm_one_launcher": ("torch_mesh_cases:world", {"data": 2, "model": 2}, 4, 1, [FORWARD]),
    "tiered": ("torch_mesh_cases:world", {"data": 2, "model": 4}, 8, 2,
               [_gen("generate", SPEC4), _gen("generate_jax_spec", SPEC)]),
    "pipe": ("torch_parallel_cases:world", (2, 2, 1), 4, 2,
             [{"name": "prefill_decode", "kind": "prefill_decode", "family": "llama-tiny",
               "opts": SPEC, "seed": 0, "ids": PIPE_PROMPT, "length": 5, "num_slots": 4,
               "max_len": 64}]),
}

# -- the server CLI as launchers ------------------------------------------------

CLI_OPTIONS = dict(SPEC, num_slots=4, max_len=64, prefill_buckets=[8, 16], steps_per_sync=2)
CLI_PROMPTS = [list(range(3, 13)), [5, 9, 2, 7, 1, 8, 4], list(range(40, 53))]
MAX_NEW = 6
IDLE_TIMEOUT_S = 15  # the serving pair's --timeout-s, which it then sits idle past
KILL_TIMEOUT_S = 30


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Launchers:
    """``python -m starpu_inference_server_tpu_torch.grpc.server --device
    cpu`` as two launcher processes of a tiny ``configs/llama_decoder.yml``
    at ``mesh``, joined at a local coordinator; each logs to its file."""

    def __init__(self, tmp: Path, tag: str, mesh: dict, timeout_s: float,
                 follower_first: bool = False):
        raw = yaml.safe_load((ROOT / "configs" / "llama_decoder.yml").read_text())
        raw["model"].update(family="llama-tiny", compute_dtype="FP32", options=CLI_OPTIONS)
        raw["inputs"] = [{"name": "input_ids", "dims": [16], "dtype": "INT64"}]
        raw["outputs"] = [{"name": "logits", "dims": [16, 128], "dtype": "FP32"}]
        raw.update(metrics_enabled=False, congestion={"enabled": False},
                   server={"address": "127.0.0.1:0"}, devices={"mesh": mesh})
        coordinator = f"127.0.0.1:{free_port()}"
        env = {k: v for k, v in os.environ.items()
               if k not in {n for pair in CLUSTER_VARIABLES for n in pair}}
        env["PYTHONPATH"] = str(ROOT)
        self.logs = [tmp / f"{tag}{i}.log" for i in range(2)]
        self._files = [open(log, "w") for log in self.logs]
        self.procs = [None, None]
        for i in (1, 0) if follower_first else (0, 1):
            raw["distributed"] = {"coordinator_address": coordinator, "num_processes": 2,
                                  "process_id": i}
            config = tmp / f"{tag}{i}.yml"
            config.write_text(yaml.safe_dump(raw))
            self.procs[i] = subprocess.Popen(
                [sys.executable, "-m", "starpu_inference_server_tpu_torch.grpc.server",
                 "--config", str(config), "--device", "cpu", "--timeout-s", str(timeout_s)],
                cwd=ROOT, stdout=self._files[i], stderr=subprocess.STDOUT, env=env)
            if follower_first and i == 1:  # its ranks wait for rank 0's store
                deadline = time.monotonic() + 60
                while "rank 3 pid" not in self.text(1) and time.monotonic() < deadline:
                    time.sleep(0.1)
                time.sleep(2.0)

    def text(self, i: int) -> str:
        return self.logs[i].read_text()

    def wait_ready(self, timeout: float = 180.0) -> tuple:
        """(target, monotonic time the server was first seen serving)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            m = re.search(r"serving \S+ on \S+ \(port (\d+)", self.text(0))
            if m:
                return f"127.0.0.1:{m.group(1)}", time.monotonic()
            assert all(p.poll() is None for p in self.procs), self.text(0) + self.text(1)
            time.sleep(0.2)
        raise AssertionError(f"no launcher served in {timeout} s:\n{self.text(0)}{self.text(1)}")

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for fh in self._files:
            fh.close()


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The CLI pairs, started first so that they build while the worlds
    run: data=2 x model=2 (2 ranks a launcher; two pairs, the second with
    launcher 1 started first, its ranks waiting for rank 0's store) and
    data=2 (1 rank a launcher: ``num_processes == mesh.size``)."""
    tmp = tmp_path_factory.mktemp("launchers")
    pairs = {"serve": Launchers(tmp, "serve", {"data": 2, "model": 2}, IDLE_TIMEOUT_S),
             "kill": Launchers(tmp, "kill", {"data": 2}, KILL_TIMEOUT_S),
             "signal": Launchers(tmp, "signal", {"data": 2, "model": 2}, KILL_TIMEOUT_S,
                                 follower_first=True)}
    try:
        yield pairs
    finally:
        for pair in pairs.values():
            pair.close()


@pytest.fixture(scope="module")
def worlds(launched, tmp_path_factory):
    """Each world runs its cases once: {world: {key: [value of each rank]}}."""
    out = {}
    for name, (body, axes, size, launchers, cases) in WORLDS.items():
        ranks = run_world(body, size, {"axes": axes, "cases": cases}, timeout_s=240.0,
                          workdir=str(tmp_path_factory.mktemp(name)), launchers=launchers)
        out[name] = {key: [r[key] for r in ranks] for key in ranks[0]}
    return out


def jax_tokens(opts, prompts, engine, quant=None, seed=0):
    spec = jdec.get_spec("llama-tiny", opts)
    params = jdec.init_params(spec, np.random.default_rng(seed))
    if quant:
        params = maybe_quantize_tree(params, quant)
    eng = JaxEngine(spec, params, dtype=jnp.float32, family="llama-tiny", **engine)
    eng.start()
    try:
        reqs = [JaxRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=MAX_NEW)
                for p in prompts]
        for r in reqs:
            eng.submit(r)
        return [r.result(timeout=180) for r in reqs]
    finally:
        eng.stop()


# -- the worlds -----------------------------------------------------------------

def test_int8_forward_over_two_launchers_matches_jax_and_one_launcher(worlds):
    """JAX ``:230``: every rank returns the whole logits, within 5e-4 of the
    JAX single-process forward, and bit for bit the one-launcher world's
    (same ranks, shards, backend and sum order)."""
    spec = jdec.get_spec("llama-tiny", SPEC)
    params = maybe_quantize_tree(jdec.init_params(spec, np.random.default_rng(0)), 8)
    want = np.asarray(jdec.forward_logits(spec, params, jnp.asarray(IDS.astype(np.int32)),
                                          jnp.float32))
    one = worlds["dm_one_launcher"]["forward_int8"]
    for got, single in zip(worlds["dm"]["forward_int8"], one):
        np.testing.assert_allclose(got["out"]["logits"], want, rtol=5e-4, atol=5e-4)
        np.testing.assert_array_equal(got["out"]["logits"], single["out"]["logits"])
    assert worlds["dm"]["launcher"] == [0, 0, 1, 1]
    assert worlds["dm"]["crossing"][0] == ["data"]
    assert worlds["dm_one_launcher"]["crossing"][0] == []


def test_gspmd_streams_with_data_across_launchers_equal_jax(worlds):
    """JAX ``:184``: the data axis spans the two launchers."""
    res = worlds["dm"]["generate"][0]
    assert res["tokens"] == jax_tokens(SPEC, PROMPTS, ENGINE)
    assert [s["launcher"] for s in res["stats"]] == [0, 0, 1, 1]
    for stats in res["stats"]:
        crossing = crossing_calls(collectives_by_axis(stats["collectives"]), stats["crossing"])
        assert set(crossing) == {"all-gather"} and set(crossing["all-gather"]) == {"data"}


def test_two_tier_mesh_keeps_the_all_reduces_inside_a_launcher(worlds):
    """JAX ``:460``: data=2 across 2 launchers x model=4 inside each. Each
    data row lives in one launcher; the streams equal JAX; on every rank
    each all-reduce is over ``model`` and only the ``data`` all-gathers
    cross launchers."""
    w = worlds["tiered"]
    assert [c["data"] for c in w["coords"]] == w["launcher"] == [0] * 4 + [1] * 4
    assert w["crossing"][0] == ["data"]
    res = w["generate"][0]
    assert res["tokens"] == jax_tokens(SPEC4, PROMPTS, ENGINE)
    assert len(res["stats"]) == 8
    for stats in res["stats"]:
        census = collectives_by_axis(stats["collectives"])
        assert set(census["all-reduce"]) == {"model"} and census["all-reduce"]["model"] > 0
        assert crossing_calls(census, stats["crossing"]) == {
            "all-gather": {"data": census["all-gather"]["data"]}}


def test_pipe_stages_in_two_launchers_match_the_plain_path(worlds):
    """JAX ``:509``: stage 0 in launcher 0, stage 1 in launcher 1. The first
    token is the JAX plain prefill's argmax; the next logits are within
    5e-3 of JAX ``decode_step`` (the pipelined prefill reads chunk-boundary
    keys back through the int8 cache); the ``pipe`` hops are the only
    collectives that cross."""
    w = worlds["pipe"]
    assert [c["pipe"] for c in w["coords"]] == w["launcher"] == [0, 0, 1, 1]
    spec = jdec.get_spec("llama-tiny", SPEC)
    params = jdec.init_params(spec, np.random.default_rng(0))
    cache, lg = jdec.prefill(spec, params, jdec.init_cache(spec, 4, 64), jnp.asarray(PIPE_PROMPT),
                             jnp.int32(5), jnp.int32(0), jnp.float32)
    tok = int(np.argmax(np.asarray(lg)))
    _, want = jdec.decode_step(spec, params, cache, jnp.asarray([tok, 0, 0, 0], jnp.int32),
                               jnp.asarray([True, False, False, False]), jnp.float32)
    for r, res in enumerate(w["prefill_decode"]):
        assert res["first"] == tok
        census = collectives_by_axis(res["census"])
        assert w["crossing"][r] == ["pipe"]
        crossing = crossing_calls(census, ["pipe"])
        assert set(crossing) == {"collective-permute"}, census
        if w["coords"][r]["pipe"] == 0:
            np.testing.assert_allclose(res["logits"][0], np.asarray(want)[0], rtol=5e-3,
                                       atol=5e-3)


# -- the server CLI -------------------------------------------------------------

def _request(prompt):
    req = pb.ModelInferRequest(model_name="llama", id="s")
    t = req.inputs.add()
    t.name, t.datatype = "input_ids", "INT64"
    t.shape.extend([1, len(prompt)])
    req.raw_input_contents.append(np.asarray(prompt, np.int64).tobytes())
    req.parameters["max_new_tokens"].int64_param = MAX_NEW
    return req


async def _stream(target, prompt):
    async with grpc.aio.insecure_channel(target) as channel:
        call = channel.stream_stream(
            "/inference.GRPCInferenceService/ModelStreamInfer",
            request_serializer=pb.ModelInferRequest.SerializeToString,
            response_deserializer=pb.ModelStreamInferResponse.FromString)

        async def requests():
            yield _request(prompt)

        out = []
        async for resp in call(requests()):
            assert not resp.error_message
            out.append(int(np.frombuffer(resp.infer_response.raw_output_contents[0],
                                         np.int32)[0]))
        return out


def _streams(target):
    async def all_prompts():
        return await asyncio.gather(*(_stream(target, p) for p in CLI_PROMPTS))

    return asyncio.new_event_loop().run_until_complete(all_prompts())


@pytest.fixture(scope="module")
def cli_want():
    """The JAX single-process engine on the servers' weights (the config's
    seed 42, int4)."""
    return jax_tokens(SPEC, CLI_PROMPTS, dict(ENGINE, prefill_buckets=[8, 16]), quant=4, seed=42)


def test_two_cli_launchers_serve_the_jax_streams_and_stop_with_sigint(launched, worlds, cli_want):
    """Runs after the worlds, so the mesh has sat idle past its
    ``--timeout-s`` (rank 0's no-op commands keep it up). Launcher 0 serves;
    ``data`` crosses the launchers; SIGINT to launcher 0 ends both with 0."""
    pair = launched["serve"]
    target, ready_at = pair.wait_ready()
    time.sleep(max(0.0, ready_at + IDLE_TIMEOUT_S + 2 - time.monotonic()))
    assert _streams(target) == cli_want
    log0 = pair.text(0)
    assert "mesh backend: gloo" in log0
    assert 'axes crossing them: ["data"]' in log0
    assert re.search(r"launcher 1 of 2: ranks 2-3 of 4", pair.text(1))
    pair.procs[0].send_signal(signal.SIGINT)
    assert [p.wait(timeout=60) for p in pair.procs] == [0, 0], pair.text(0) + pair.text(1)
    m = re.search(r"weights sent: (\{.*\})", pair.text(0))
    assert m and '"other_launchers": {"mb": ' in m.group(1)


def test_one_rank_a_launcher_serves_and_a_killed_follower_fails_both(launched, worlds,
                                                                    cli_want):
    """``num_processes == mesh.size``: each launcher spawns one rank. A
    stream equals JAX's; then launcher 1's rank is killed, and both
    launchers exit non-zero within ``--timeout-s``."""
    pair = launched["kill"]
    target, _ = pair.wait_ready()
    assert _streams(target)[:1] == cli_want[:1]
    pid = int(re.search(r"rank 1 pid (\d+)", pair.text(1)).group(1))
    os.kill(pid, signal.SIGKILL)
    t0 = time.monotonic()
    codes = [p.wait(timeout=KILL_TIMEOUT_S + 15) for p in pair.procs]
    assert all(c != 0 for c in codes), codes
    assert time.monotonic() - t0 < KILL_TIMEOUT_S


def test_sigint_to_a_follower_launcher_stops_its_ranks_and_fails_the_mesh(launched, worlds):
    """Launcher 1 started first (the pair served, so its ranks waited for
    the store); SIGINT to it stops its ranks, and both launchers fail."""
    pair = launched["signal"]
    pair.wait_ready()
    pair.procs[1].send_signal(signal.SIGINT)
    t0 = time.monotonic()
    codes = [p.wait(timeout=KILL_TIMEOUT_S + 15) for p in pair.procs]
    assert all(c != 0 for c in codes), codes
    assert time.monotonic() - t0 < KILL_TIMEOUT_S
    assert "launcher 1 got signal 2; stopping its ranks" in pair.text(1)


# -- the configuration rules ----------------------------------------------------

def _clear_cluster(monkeypatch):
    for pair in CLUSTER_VARIABLES:
        for name in pair:
            monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("env", [{"SLURM_PROCID": "1", "SLURM_NTASKS": "2"},
                                 {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "2"}])
def test_process_id_and_count_auto_detect_from_the_cluster(monkeypatch, env):
    _clear_cluster(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = resolve_distributed(DistributedSettings("127.0.0.1:9", 0, -1))
    assert (got.num_processes, got.process_id) == (2, 1)
    # a value the config sets stays
    assert resolve_distributed(DistributedSettings("127.0.0.1:9", 2, 0)).process_id == 0


def test_open_mpi_comes_before_slurm_as_in_jax(monkeypatch):
    _clear_cluster(monkeypatch)
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "0")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "2")
    got = resolve_distributed(DistributedSettings("127.0.0.1:9", 0, -1))
    assert (got.num_processes, got.process_id) == (2, 0)


def test_auto_detect_without_the_cluster_variables_names_them(monkeypatch):
    _clear_cluster(monkeypatch)
    with pytest.raises(InvalidConfigValueError, match="OMPI_COMM_WORLD_RANK.*SLURM_NTASKS"):
        resolve_distributed(DistributedSettings("127.0.0.1:9", 0, -1))
    with pytest.raises(InvalidConfigValueError, match="not below"):
        resolve_distributed(DistributedSettings("127.0.0.1:9", 2, 2))
    # no coordinator: one launcher, nothing to detect (as the JAX server)
    assert resolve_distributed(DistributedSettings()) == DistributedSettings()


def test_a_mesh_num_processes_does_not_divide_is_refused(tmp_path):
    from starpu_inference_server_tpu_torch.grpc.server import main

    with pytest.raises(ValueError, match="4 positions.*num_processes=3"):
        local_size(4, 3)
    raw = yaml.safe_load((ROOT / "configs" / "llama_decoder.yml").read_text())
    raw["model"].update(family="llama-tiny", options=CLI_OPTIONS)
    raw.update(devices={"mesh": {"data": 2, "model": 2}},
               distributed={"coordinator_address": "127.0.0.1:9", "num_processes": 3,
                            "process_id": 0})
    path = tmp_path / "three.yml"
    path.write_text(yaml.safe_dump(raw))
    assert parse_config(raw).distributed.num_processes == 3
    with pytest.raises(ValueError, match="num_processes=3"):
        main(["--config", str(path), "--device", "cpu"])


def test_launchers_disagreeing_on_the_backend_is_an_error():
    store = torch.distributed.HashStore()
    store.set("backend/1", "nccl 1 GPU-b")
    with pytest.raises(ValueError, match="launcher 0 chose gloo, launcher 1 chose nccl"):
        agree_backend(store, 0, 2, 0, "gloo")
    agree_backend(store, 0, 2, 0, "nccl", "GPU-a")  # each rank on its own card
    agree_backend(torch.distributed.HashStore(), 0, 1, 0, "gloo")  # one launcher agrees


def test_nccl_ranks_of_two_launchers_sharing_a_card_are_refused():
    """Two launchers on one host, each counting its one card as its own:
    both choose nccl, and the card they share is named before NCCL starts."""
    store = torch.distributed.HashStore()
    store.set("backend/1", "nccl 1 GPU-a")
    with pytest.raises(ValueError, match="ranks 0 and 1 .*share card GPU-a"):
        agree_backend(store, 0, 2, 0, "nccl", "GPU-a")
    store.set("backend/3", "gloo 1 GPU-a")  # under gloo, ranks share cards
    store.set("backend/2", "gloo 1 GPU-a")
    store.set("backend/1", "gloo 0 GPU-a")
    agree_backend(store, 0, 4, 0, "gloo", "GPU-a")


@pytest.mark.parametrize("axes,local,want", [
    (MeshAxes(data=2, model=4), 4, ["data"]),
    (MeshAxes(data=2, model=2), 2, ["data"]),
    (MeshAxes(pipe=2, model=2), 2, ["pipe"]),
    (MeshAxes(data=2, expert=2, model=2), 2, ["data", "expert", "expert+model"]),
    (MeshAxes(data=2, model=2), 4, []),
    (MeshAxes(data=2, model=2), 1, ["data", "model", "expert+model"]),
])
def test_axes_crossing_launchers(axes, local, want):
    assert crossing_axes(axes, local) == want


def test_the_jax_spec_at_model_4_is_refused(worlds):
    """JAX ``:489`` exactly: the JAX spec's 2 kv heads over model=4, which
    the port once refused (the name is that test's). Each kv head is now
    replicated on the two ranks whose q heads read it; the engine accepts
    the mesh and, over 2 launchers, its streams equal the JAX engine's,
    with every all-reduce over ``model`` and none crossing launchers."""
    assert check_mesh(get_spec("llama-tiny", SPEC), MeshAxes(data=2, model=4), flat=False,
                      prefill_chunk=0, prefill_buckets=[8], num_slots=4, pipe_microgroups=0,
                      kv_page_size=0) == (0, 0)
    res = worlds["tiered"]["generate_jax_spec"][0]
    assert res["tokens"] == jax_tokens(SPEC, PROMPTS, ENGINE)
    for stats in res["stats"]:
        census = collectives_by_axis(stats["collectives"])
        assert set(census["all-reduce"]) == {"model"}
        crossing = crossing_calls(census, stats["crossing"])
        assert set(crossing) == {"all-gather"} and set(crossing["all-gather"]) == {"data"}
