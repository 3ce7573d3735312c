"""Pipelined decoding of the port (``parallel/pipeline_decode.py``,
``parallel/pipeline.py``) in a spawned world of two CPU ranks (pipe=2)
against the JAX package: ``pipelined_prefill`` against ``prefill_chunk``
run chunk by chunk, ``pipelined_decode_step`` against ``decode_step``,
``pipelined_verify_step`` against ``verify_step``, ``pipelined_decoder_logits``
against ``forward_logits`` (the JAX tests' tolerances: 2e-4 on logits,
2e-3 on dequantized cache rows), the generic GPipe forward against the
layers in order, the pipelined engine's greedy tokens against the JAX
single-device engine with ``prefill_chunk`` at the pipeline's chunk, and
two cases against JAX's pipelined programs themselves on the virtual CPU
mesh. The world runs once for the module (``world_out``); each case is
its own test."""

import jax.numpy as jnp
import numpy as np
import pytest

from starpu_inference_server_tpu.models import decoder as jdec
from starpu_inference_server_tpu.ops.quant import maybe_quantize_tree as jax_quantize
from starpu_inference_server_tpu.parallel.mesh import MeshAxes as JMeshAxes
from starpu_inference_server_tpu.parallel.mesh import make_device_mesh as jax_mesh
from starpu_inference_server_tpu.parallel.partition import partition_rules_for as jax_rules
from starpu_inference_server_tpu.parallel.pipeline import prepare_pipelined_params
from starpu_inference_server_tpu.parallel.pipeline_decode import (
    pipelined_decode_step as jax_pipelined_decode_step,
)
from starpu_inference_server_tpu.parallel.pipeline_decode import (
    pipelined_prefill as jax_pipelined_prefill,
)
from starpu_inference_server_tpu_torch.parallel.census import collectives_by_axis
from starpu_inference_server_tpu_torch.parallel.launch import run_world
from torch_parallel_refs import (
    MOE,
    TINY,
    _jax_cache,
    assert_cache_close,
    decode_case,
    jax_decode_reference,
    jax_engine_tokens,
    jax_sequential_prefill,
    prefill_case,
    start_cache,
)


# prompts that repeat themselves, so the n-gram lookup drafts
LOOKUP_PROMPTS = [np.asarray([5, 9, 2, 7, 5, 9, 2], np.int32), np.asarray([3, 1, 3, 1, 3], np.int32),
                  np.asarray([8, 4, 6, 8, 4, 6, 8, 4], np.int32)]
LOOKUP_ENGINE = dict(num_slots=4, max_len=64, prefill_buckets=[8], steps_per_sync=2,
                     prompt_lookup_ngram=2, speculate_k=3)


def pipe2_cases():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, TINY["vocab"], (4, 8), np.int32)
    layers = [(rng.standard_normal((16, 16)).astype(np.float32) * 0.3,
               rng.standard_normal((16,)).astype(np.float32) * 0.1) for _ in range(8)]
    x = rng.standard_normal((8, 16)).astype(np.float32)
    prng = np.random.default_rng(5)
    prompts = [prng.integers(0, TINY["vocab"], (n,), np.int32) for n in (5, 7, 8, 6)]
    return [
        prefill_case("prefill", "llama-tiny", TINY, 0),
        prefill_case("prefill_direct", "llama-tiny", TINY, 30, length=11, slot=0),
        decode_case("decode", "llama-tiny", TINY, 2),
        decode_case("decode_moe", "moe-tiny", MOE, 12),
        decode_case("decode_mg4", "llama-tiny", TINY, 14, microgroups=4),
        decode_case("verify", "llama-tiny", TINY, 16, window=3),
        {"name": "logits", "kind": "logits", "family": "llama-tiny", "opts": TINY, "seed": 4,
         "ids": ids, "microbatches": 2},
        {"name": "logits_int8", "kind": "logits", "family": "llama-tiny", "opts": TINY,
         "seed": 6, "ids": ids, "microbatches": 2, "quant": 8},
        {"name": "forward", "kind": "forward", "layers": layers, "x": x, "microbatches": 4},
        {"name": "forward_m1", "kind": "forward", "layers": layers, "x": x, "microbatches": 1},
        {"name": "engine", "kind": "engine", "family": "llama-tiny", "opts": TINY, "seed": 4,
         "prompts": prompts, "max_new": 6,
         "engine": dict(num_slots=4, max_len=64, prefill_buckets=[8], steps_per_sync=2)},
        {"name": "engine_lookup", "kind": "engine", "family": "llama-tiny", "opts": TINY,
         "seed": 4, "prompts": LOOKUP_PROMPTS, "max_new": 8, "engine": LOOKUP_ENGINE},
    ]


@pytest.fixture(scope="module")
def cases():
    return {c["name"]: c for c in pipe2_cases()}


@pytest.fixture(scope="module")
def world_out(cases, tmp_path_factory):
    """One world of two ranks runs every case; {case: [rank 0's, rank 1's]}."""
    payload = {"axes": (2, 1, 1), "cases": list(cases.values())}
    ranks = run_world("torch_parallel_cases:world", 2, payload, timeout_s=240.0,
                      workdir=str(tmp_path_factory.mktemp("pipe2")))
    return {name: [r[name] for r in ranks] for name in ranks[0]}


def test_pipelined_prefill_matches_sequential_chunks(cases, world_out):
    case = cases["prefill"]
    want_logits, want_cache = jax_sequential_prefill(case)
    out = world_out["prefill"]
    coords = world_out["coords"]
    assert out[1]["logits"] is None  # the head runs on stage 0
    np.testing.assert_allclose(out[0]["logits"], want_logits, rtol=2e-4, atol=2e-4)
    assert_cache_close(out, coords, want_cache, [(case["slot"], slice(0, case["length"]))])


@pytest.mark.parametrize("name", ["decode", "decode_moe", "decode_mg4", "verify"])
def test_pipelined_decode_and_verify_match_single_device(cases, world_out, name):
    """Logits of the active slots, the lengths and the rows written this
    step (each active slot's new positions; an inactive slot's write parks
    at t_max-1, which the JAX pipelined program also fills with fill /
    drain garbage, so that row is not compared)."""
    case = cases[name]
    want_logits, want_cache, before = jax_decode_reference(case)
    out = world_out[name]
    active = case["active"]
    assert out[1]["logits"] is None
    np.testing.assert_allclose(out[0]["logits"][active], want_logits[active],
                               rtol=2e-4, atol=2e-4)
    w = case["ids"].shape[1] if case["ids"].ndim == 2 else 1
    rows = [(s, slice(int(before[s]), int(before[s]) + w)) for s in range(4) if active[s]]
    if w > 1:  # verify leaves lengths to the caller
        want_cache = want_cache[:4] + (before,)
    assert_cache_close(out, world_out["coords"], want_cache, rows)


@pytest.mark.parametrize("name,seed,quant", [("logits", 4, None), ("logits_int8", 6, 8)])
def test_pipelined_decoder_logits_match_forward_logits(cases, world_out, name, seed, quant):
    spec = jdec.get_spec("llama-tiny", TINY)
    params = jdec.init_params(spec, np.random.default_rng(seed))
    if quant:
        params = jax_quantize(params, bits=quant)
    want = np.asarray(jdec.forward_logits(spec, params, jnp.asarray(cases[name]["ids"]),
                                          jnp.float32))
    for rank_out in world_out[name]:  # every rank returns the logits
        np.testing.assert_allclose(rank_out["logits"], want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["forward", "forward_m1"])
def test_generic_pipeline_matches_sequential(cases, world_out, name):
    case = cases[name]
    want = case["x"]
    for w, b in case["layers"]:
        want = np.tanh(want @ w + b)
    for rank_out in world_out[name]:
        np.testing.assert_allclose(rank_out["out"], want, rtol=1e-5, atol=1e-5)


def test_pipelined_engine_matches_jax_chunked_engine(cases, world_out):
    """Greedy tokens of the pipelined engine (pipe=2) equal the JAX
    single-device engine's with prefill_chunk = bucket / stages (prompt
    lengths in (chunk, bucket], so both take the same chunk boundaries)."""
    case = cases["engine"]
    want = jax_engine_tokens("llama-tiny", TINY, case["seed"], case["prompts"], case["max_new"],
                             chunk=4)
    assert world_out["engine"][0]["tokens"] == want
    assert world_out["engine"][1] is None


def test_pipelined_lookup_engine_matches_single_device(cases, world_out):
    """Prompt lookup on a pipe mesh (the JAX engine refuses it on any
    mesh): rank 0 drafts from its history, every verify window runs
    through the stages. Greedy streams equal the port's single-device
    lookup engine (held against the JAX engine by
    tests/test_torch_speculative.py) with prefill_chunk = bucket / 2."""
    import torch

    from starpu_inference_server_tpu_torch.models.decoder import get_spec, init_params
    from starpu_inference_server_tpu_torch.serving.generation import (
        GenerationEngine,
        GenerationRequest,
    )

    spec = get_spec("llama-tiny", TINY)
    ref = GenerationEngine(spec, init_params(spec, np.random.default_rng(4)),
                           dtype=torch.float32, device="cpu", prefill_chunk=4, **LOOKUP_ENGINE)
    reqs = [GenerationRequest(prompt_ids=p, max_new_tokens=8) for p in LOOKUP_PROMPTS]
    for r in reqs:
        ref.submit(r)
    ref.start()
    try:
        want = [r.result(timeout=120.0) for r in reqs]
    finally:
        ref.stop()
    out = world_out["engine_lookup"][0]
    assert out["tokens"] == want
    # the prefills and verify windows crossed both stages
    assert all(st["collectives"]["calls"].get("collective-permute/pipe", 0) > 0
               for st in out["stats"])


def test_census_of_a_pipelined_decode_step(world_out):
    """At pipe=2 and model=1 a decode step of M microgroups makes M pipe
    hops on every rank (stage 0 to 1, then the last stage back to 0) and
    no collective on any other axis (the sums over size-1 axes are
    no-ops)."""
    for name, m in (("decode", 2), ("decode_mg4", 4)):
        for rank_out in world_out[name]:
            assert collectives_by_axis(rank_out["census"]) == {
                "collective-permute": {"pipe": m}}


def test_pipelined_prefill_matches_jax_pipelined_program(cases, world_out):
    """The JAX ``pipelined_prefill`` itself (shard_map over the virtual
    pipe=2 mesh) against the port's two ranks: logits and every written
    row of the slot."""
    case = cases["prefill_direct"]
    spec = jdec.get_spec("llama-tiny", TINY)
    params = jdec.init_params(spec, np.random.default_rng(case["seed"]))
    mesh = jax_mesh(JMeshAxes(pipe=2))
    stacked = prepare_pipelined_params(params, mesh, jax_rules("llama-tiny"))
    cache, logits = jax_pipelined_prefill(
        spec, stacked, jdec.init_cache(spec, 4, 64, stacked=True), jnp.asarray(case["ids"]),
        jnp.int32(case["length"]), jnp.int32(case["slot"]), mesh, jnp.float32)
    out = world_out["prefill_direct"]
    np.testing.assert_allclose(out[0]["logits"], np.asarray(logits), rtol=2e-4, atol=2e-4)
    assert_cache_close(out, world_out["coords"], _jax_cache(cache),
                       [(case["slot"], slice(0, len(case["ids"])))])


def test_pipelined_decode_matches_jax_pipelined_program(cases, world_out):
    """The JAX ``pipelined_decode_step`` on the virtual pipe=2 mesh from the
    same cache: logits and every cache row but t_max-1 (where the JAX
    program parks its fill / drain garbage) of every slot."""
    case = cases["decode"]
    spec, params, cache = start_cache(case["family"], case["opts"], case["seed"])
    mesh = jax_mesh(JMeshAxes(pipe=2))
    stacked = prepare_pipelined_params(params, mesh, jax_rules("llama-tiny"))
    jcache = jdec.KVCache(*(jnp.asarray(a) for a in cache))
    new, logits = jax_pipelined_decode_step(spec, stacked, jcache, jnp.asarray(case["ids"]),
                                            jnp.asarray(case["active"]), mesh, jnp.float32)
    out = world_out["decode"]
    active = case["active"]
    np.testing.assert_allclose(out[0]["logits"][active], np.asarray(logits)[active],
                               rtol=2e-4, atol=2e-4)
    t_max = cache[0].shape[2]
    assert_cache_close(out, world_out["coords"], _jax_cache(new),
                       [(s, slice(0, t_max - 1)) for s in range(4)])
