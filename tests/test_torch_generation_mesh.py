"""GSPMD-mode generation (``parallel/launch.py:GspmdWorker``): the KV slots
sharded over ``data``, the weights tensor- and expert-parallel, in spawned
worlds of four CPU ranks (gloo). FP32 greedy streams must equal the JAX
single-device engine's token for token, as the JAX
``test_generation_mesh.py`` requires of its mesh engine: llama-tiny at
data=2 x model=2 (bucketed prefill, chunked prefill with int8 weights,
W4A8 with the kernel routes forced on (K6's plain version on the rank's
rows of the row-parallel layers), the dense prefix cache, and
speculation with a draft model on rank 0: its verify windows through the
mesh, as the JAX engine verifies on a mesh), moe-tiny at expert=2 x
model=2; a prefix-cache row copy across data groups; and the
``num_slots % data`` guard and the JAX engine's refusals on a mesh."""

import jax.numpy as jnp
import numpy as np
import pytest

from starpu_inference_server_tpu.ops import nn as jnn
from starpu_inference_server_tpu.models.decoder import get_spec as jax_spec
from starpu_inference_server_tpu.models.decoder import init_params as jax_init
from starpu_inference_server_tpu.serving.generation import GenerationEngine as JaxEngine
from starpu_inference_server_tpu.serving.generation import GenerationRequest as JaxRequest
from starpu_inference_server_tpu_torch.models.decoder import get_spec
from starpu_inference_server_tpu_torch.parallel.census import collectives_by_axis
from starpu_inference_server_tpu_torch.parallel.launch import run_world
from starpu_inference_server_tpu_torch.parallel.mesh import MeshAxes
from starpu_inference_server_tpu_torch.serving.generation import GenerationEngine

TINY = {"layers": 2, "hidden": 128, "q_heads": 4, "kv_heads": 2, "intermediate": 256,
        "vocab": 128}
MOE = dict(TINY, num_experts=4)
SHORT = [[3, 7, 11], [5, 2]]
LONG = [np.random.default_rng(6).integers(0, 128, (n,)).tolist() for n in (13, 5, 19, 9)]
BUCKETED = dict(num_slots=2, max_len=64, prefill_buckets=[8])
CHUNKED = dict(num_slots=4, max_len=64, prefill_buckets=[8], prefill_chunk=8, steps_per_sync=2)
# six prompts on four slots sharing a 12-token prefix: the last two are
# admitted after releases, into slots whose prompts are indexed
_rng = np.random.default_rng(8)
_HEAD = _rng.integers(0, 128, (12,)).tolist()
PREFIXED = [_HEAD + _rng.integers(0, 128, (n,)).tolist() for n in (3, 6, 1, 9, 4, 2)]


DRAFT = {"family": "llama-tiny", "seed": 1,
         "opts": dict(TINY, layers=1, hidden=64, q_heads=2, kv_heads=1, intermediate=96)}


def gen_case(name, family, opts, prompts, engine, quant=None, max_new=6, draft=None,
             w8a8=False, kernels=False):
    return {"name": name, "kind": "generate", "family": family, "opts": opts, "seed": 0,
            "prompts": prompts, "engine": engine, "quant": quant, "max_new": max_new,
            "draft": draft, "w8a8": w8a8, "kernels": kernels}


WORLDS = {
    "dm": ({"data": 2, "model": 2}, [
        gen_case("llama", "llama-tiny", TINY, SHORT, BUCKETED),
        gen_case("chunked_int8", "llama-tiny", TINY, LONG, CHUNKED, quant=8),
        gen_case("speculative", "llama-tiny", TINY, SHORT, dict(BUCKETED, speculate_k=3),
                 max_new=8, draft=DRAFT),
        gen_case("w4a8", "llama-tiny", TINY, LONG, CHUNKED, quant=4, w8a8=True, kernels=True),
        gen_case("prefix", "llama-tiny", TINY, PREFIXED,
                 dict(CHUNKED, prefix_cache=True, prefix_cache_min=8)),
        {"name": "copy_rows", "kind": "copy_rows", "family": "llama-tiny", "opts": TINY,
         "seed": 0, "engine": CHUNKED, "prompt": PREFIXED[0][:8]},
    ]),
    "em": ({"expert": 2, "model": 2}, [
        gen_case("moe", "moe-tiny", MOE, SHORT, BUCKETED),
    ]),
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for name, (axes, cases) in WORLDS.items():
        ranks = run_world("torch_mesh_cases:world", 4, {"axes": axes, "cases": cases},
                          timeout_s=300.0, workdir=str(tmp_path_factory.mktemp(name)))
        out[name] = {key: [r[key] for r in ranks] for key in ranks[0]}
    return out


def jax_tokens(case):
    """Greedy tokens of the JAX single-device engine on the case's tree."""
    spec = jax_spec(case["family"], case["opts"])
    params = jax_init(spec, np.random.default_rng(case["seed"]))
    if case["quant"]:
        from starpu_inference_server_tpu.ops.quant import maybe_quantize_tree

        params = maybe_quantize_tree(params, case["quant"])
    draft = {}
    if case["draft"]:
        d = case["draft"]
        draft_spec = jax_spec(d["family"], d["opts"])
        draft = {"draft_spec": draft_spec,
                 "draft_params": jax_init(draft_spec, np.random.default_rng(d["seed"]))}
    eng = JaxEngine(spec, params, dtype=jnp.float32, family=case["family"], **case["engine"],
                    **draft)
    jnn.set_w8a8(case["w8a8"])
    eng.start()
    try:
        reqs = [JaxRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=case["max_new"])
                for p in case["prompts"]]
        for r in reqs:
            eng.submit(r)
        return [r.result(timeout=180) for r in reqs]
    finally:
        eng.stop()
        jnn.set_w8a8(False)


@pytest.mark.parametrize("world,name", [("dm", "llama"), ("dm", "chunked_int8"),
                                        ("dm", "speculative"), ("dm", "w4a8"), ("dm", "prefix"),
                                        ("em", "moe")])
def test_mesh_generation_matches_single_device(worlds, world, name):
    case = next(c for c in WORLDS[world][1] if c["name"] == name)
    res = worlds[world][name][0]
    assert res["tokens"] == jax_tokens(case)
    assert all(r is None for r in worlds[world][name][1:])  # the followers
    if case["draft"]:  # the verify windows went through the mesh
        assert res["drafted"] > 0
    if case["engine"].get("prefix_cache"):
        assert res["prefix_hits"] > 0
    if case["kernels"]:  # the W4A8 kernel route (K6's plain version)
        assert res["k6_calls"] > 0
    # every rank ran the program: the logits' rows over data, the
    # row-parallel sums over model (over expert+model for the MoE combine)
    for stats in res["stats"]:
        census = collectives_by_axis(stats["collectives"])
        assert census["all-gather"]["model"] > 0  # embedding, lm head
        assert census["all-reduce"]["model"] > 0  # attention's o (and down)
        if world == "dm":
            assert census["all-gather"]["data"] > 0
        else:
            assert census["all-reduce"]["expert+model"] > 0


def test_prefix_rows_copied_across_data_groups(worlds):
    """Slot 0 (data group 0) prefilled, its rows copied over slot 3 (group
    1): a decode step on both slots gives the same logits, and the copy
    went through the all-gather over data."""
    res = worlds["dm"]["copy_rows"][0]
    np.testing.assert_array_equal(res["logits"][0], res["logits"][1])
    assert res["gathered"] > 0


def test_mesh_slots_must_divide_data_axis():
    spec = get_spec("llama-tiny", TINY)
    with pytest.raises(ValueError, match="divisible"):
        GenerationEngine(spec, None, num_slots=3, max_len=64, prefill_buckets=[8],
                         mesh=MeshAxes(data=2, model=1), device="cpu")


@pytest.mark.parametrize("option,value,match", [
    ("prompt_lookup_ngram", 2, "prompt_lookup_ngram"),
    ("kv_page_size", 16, "paged KV cache"),
    ("kv_cache_layout", "flat", "flat"),
])
def test_gspmd_mode_keeps_the_jax_refusals(option, value, match):
    spec = get_spec("llama-tiny", TINY)
    with pytest.raises(ValueError, match=match):
        GenerationEngine(spec, None, num_slots=4, max_len=64, prefill_buckets=[8],
                         mesh=MeshAxes(data=2), device="cpu", **{option: value})
