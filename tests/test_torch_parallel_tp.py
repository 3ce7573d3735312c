"""Tensor and expert parallelism inside pipeline stages, in spawned
worlds of four CPU ranks: pipe=2 x model=2 (llama-tiny) and pipe=2 x
expert=2 (moe-tiny), against the JAX package's single-device functions
and engine (``test_pipeline_decode.py``'s tolerances; 3e-4 on the
tensor-parallel logits, as ``test_pipeline_parallel.py``), BF16 at
pipe=2 x model=2 within limits set from a first reading, and the census
of a tensor-parallel decode step."""

import jax.numpy as jnp
import numpy as np
import pytest

from starpu_inference_server_tpu.models import decoder as jdec
from starpu_inference_server_tpu_torch.parallel.census import collectives_by_axis
from starpu_inference_server_tpu_torch.parallel.launch import run_world
from torch_parallel_refs import (
    MOE,
    TINY,
    assert_cache_close,
    decode_case,
    jax_decode_reference,
    jax_engine_tokens,
    jax_sequential_prefill,
    prefill_case,
)

PROMPTS = [np.random.default_rng(5).integers(0, TINY["vocab"], (n,), np.int32)
           for n in (5, 7, 8, 6)]
ENGINE = dict(num_slots=4, max_len=64, prefill_buckets=[8], steps_per_sync=2)


def logits_case(name, family, opts, seed, dtype="float32"):
    ids = np.random.default_rng(seed + 1).integers(0, opts["vocab"], (4, 8), np.int32)
    return {"name": name, "kind": "logits", "family": family, "opts": opts, "seed": seed,
            "ids": ids, "microbatches": 2, "dtype": dtype}


def engine_case(family, opts, seed):
    return {"name": "engine", "kind": "engine", "family": family, "opts": opts, "seed": seed,
            "prompts": PROMPTS, "max_new": 6, "engine": ENGINE}


WORLDS = {
    "tp2": ((2, 2, 1), [
        prefill_case("prefill", "llama-tiny", TINY, 0),
        decode_case("decode", "llama-tiny", TINY, 2),
        decode_case("verify", "llama-tiny", TINY, 16, window=3),
        logits_case("logits", "llama-tiny", TINY, 7),
        engine_case("llama-tiny", TINY, 4),
        decode_case("decode_bf16", "llama-tiny", TINY, 2, dtype="bfloat16"),
        logits_case("logits_bf16", "llama-tiny", TINY, 7, dtype="bfloat16"),
    ]),
    "ep2": ((2, 1, 2), [
        decode_case("decode", "moe-tiny", MOE, 12),
        logits_case("logits", "moe-tiny", MOE, 6),
        engine_case("moe-tiny", MOE, 4),
    ]),
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world of four ranks runs its cases once: {world: {case:
    [result of rank 0..3]}, with "coords"}."""
    out = {}
    for name, (axes, cases) in WORLDS.items():
        ranks = run_world("torch_parallel_cases:world", 4, {"axes": axes, "cases": cases},
                          timeout_s=240.0, workdir=str(tmp_path_factory.mktemp(name)))
        out[name] = {key: [r[key] for r in ranks] for key in ranks[0]}
    return out


def case_of(world, name):
    return next(c for c in WORLDS[world][1] if c["name"] == name)


def test_tensor_parallel_prefill_matches_sequential_chunks(worlds):
    case = case_of("tp2", "prefill")
    want_logits, want_cache = jax_sequential_prefill(case)
    out, coords = worlds["tp2"]["prefill"], worlds["tp2"]["coords"]
    for r, c in enumerate(coords):
        if c["pipe"] == 0:  # both model ranks of stage 0 hold the gathered logits
            np.testing.assert_allclose(out[r]["logits"], want_logits, rtol=2e-4, atol=2e-4)
        else:
            assert out[r]["logits"] is None
    # each rank holds its stage's layers and its half of the kv heads
    _assert_head_shards(out, coords, want_cache, [(case["slot"], slice(0, case["length"]))])


def _assert_head_shards(out, coords, want, slot_rows):
    """assert_cache_close per model rank: the rank's kv-head half of the
    whole JAX cache."""
    for m in (0, 1):
        ranks = [r for r, c in enumerate(coords) if c["model"] == m]
        k, v, ks, vs, lengths = want
        h = k.shape[3] // 2
        part = (k[..., m * h:(m + 1) * h, :], v[..., m * h:(m + 1) * h, :],
                ks[..., m * h:(m + 1) * h], vs[..., m * h:(m + 1) * h], lengths)
        assert_cache_close([out[r] for r in ranks], [coords[r] for r in ranks], part, slot_rows)


@pytest.mark.parametrize("world,name", [("tp2", "decode"), ("tp2", "verify"),
                                        ("ep2", "decode")])
def test_parallel_decode_and_verify_match_single_device(worlds, world, name):
    case = case_of(world, name)
    want_logits, want_cache, before = jax_decode_reference(case)
    out, coords = worlds[world][name], worlds[world]["coords"]
    active = case["active"]
    w = case["ids"].shape[1] if case["ids"].ndim == 2 else 1
    for r, c in enumerate(coords):
        if c["pipe"] == 0:
            np.testing.assert_allclose(out[r]["logits"][active], want_logits[active],
                                       rtol=2e-4, atol=2e-4)
    rows = [(s, slice(int(before[s]), int(before[s]) + w)) for s in range(4) if active[s]]
    if w > 1:
        want_cache = want_cache[:4] + (before,)
    if world == "tp2":
        _assert_head_shards(out, coords, want_cache, rows)
    else:  # experts shard; the cache replicates over 'expert'
        for e in (0, 1):
            ranks = [r for r, c in enumerate(coords) if c["expert"] == e]
            assert_cache_close([out[r] for r in ranks], [coords[r] for r in ranks], want_cache,
                               rows)


@pytest.mark.parametrize("world,family,opts,seed", [("tp2", "llama-tiny", TINY, 7),
                                                    ("ep2", "moe-tiny", MOE, 6)])
def test_parallel_decoder_logits_match_forward_logits(worlds, world, family, opts, seed):
    spec = jdec.get_spec(family, opts)
    params = jdec.init_params(spec, np.random.default_rng(seed))
    ids = case_of(world, "logits")["ids"]
    want = np.asarray(jdec.forward_logits(spec, params, jnp.asarray(ids), jnp.float32))
    for rank_out in worlds[world]["logits"]:
        np.testing.assert_allclose(rank_out["logits"], want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("world,family,opts", [("tp2", "llama-tiny", TINY),
                                               ("ep2", "moe-tiny", MOE)])
def test_parallel_engine_matches_jax_chunked_engine(worlds, world, family, opts):
    want = jax_engine_tokens(family, opts, 4, PROMPTS, 6, chunk=4)
    out = worlds[world]["engine"]
    assert out[0]["tokens"] == want
    assert all(o is None for o in out[1:])


# BF16 at tp 2: each model rank's row-parallel partial sum is rounded to
# bf16 before the all-reduce, where the single device rounds one whole
# row once, so the logits differ from the JAX package's BF16 single-device
# ones by bf16 roundings (the port's single-device BF16 forward equals
# JAX's on this tree exactly). First reading, on the CPU: max |diff|
# 2.734e-2 on the decode logits (max |ref| 3.797) and 5.859e-2 on the
# forward logits (max |ref| 4.406), a few bf16 ulps at those magnitudes;
# each limit is twice its reading.
BF16_TP_ATOL = {"decode_bf16": 5.5e-2, "logits_bf16": 1.2e-1}


@pytest.mark.parametrize("name", ["decode_bf16", "logits_bf16"])
def test_tensor_parallel_bf16_logits_within_limit(worlds, name):
    """pipe=2 x model=2 at BF16 against the JAX package's BF16
    ``decode_step`` / ``forward_logits`` of the same tree, within a limit
    set from a first reading (the sums run in another order)."""
    case = case_of("tp2", name)
    out, coords = worlds["tp2"][name], worlds["tp2"]["coords"]
    if name == "decode_bf16":
        want, _, _ = jax_decode_reference(case)
        active = case["active"]
        got = [out[r]["logits"][active] for r, c in enumerate(coords) if c["pipe"] == 0]
        want = want[active]
    else:
        spec = jdec.get_spec("llama-tiny", TINY)
        params = jdec.init_params(spec, np.random.default_rng(case["seed"]))
        want = np.asarray(jdec.forward_logits(spec, params, jnp.asarray(case["ids"]),
                                              jnp.bfloat16), np.float32)
        got = [o["logits"] for o in out]
    assert len(got) >= 2
    for g in got:
        err = float(np.abs(g - want).max())
        print(f"{name}: max |pipelined bf16 - JAX bf16| = {err:.3e} "
              f"(max |ref| {np.abs(want).max():.3e})")
        assert err <= BF16_TP_ATOL[name], err


def test_census_of_a_tensor_parallel_decode_step(worlds):
    """pipe=2 x model=2, 2 layers a stage, 2 microgroups: every rank makes
    2 pipe hops and 2 sums on 'model' per layer and microgroup (after the
    attention output and the MLP down projection); stage 0 also gathers
    the embedding and the logits over 'model'. pipe=2 x expert=2: the MoE
    combine sums once over (expert, model) per layer and microgroup, and
    nothing runs on 'model' (size 1)."""
    tp = worlds["tp2"]
    for r, c in enumerate(tp["coords"]):
        want = {"collective-permute": {"pipe": 2}, "all-reduce": {"model": 2 * 2 * 2}}
        if c["pipe"] == 0:
            want["all-gather"] = {"model": 2}
        assert collectives_by_axis(tp["decode"][r]["census"]) == want
    ep = worlds["ep2"]
    for r in range(4):
        assert collectives_by_axis(ep["decode"][r]["census"]) == {
            "collective-permute": {"pipe": 2}, "all-reduce": {"expert+model": 2 * 2}}
    # the engine's statistics come back from every rank, in rank order
    stats = tp["engine"][0]["stats"]
    assert [s["rank"] for s in stats] == [0, 1, 2, 3]
