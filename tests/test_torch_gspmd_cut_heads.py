"""GSPMD decoders whose heads ``model`` cuts, in the port, on the CPU
against the JAX package on the same seeded weights:

- ``model`` not dividing the q heads, or the kv heads neither divided by
  nor dividing ``model`` (6 q over 2 kv heads and 12 over 6 at model=4,
  6 over 3 at model=2, 10 over 5 at model=4; int4, MoE, chunked prefill
  and a speculative engine's verify windows at 6 over 2): the JAX
  ``GenerationEngine`` serves them on a CPU mesh of the same axes, and
  the port's GSPMD engine (gathered heads: the fused qkv cut as it comes,
  gathered over ``model``, every head on every rank) gives the streams of
  both the JAX mesh engine and the JAX one-device engine; ``forward_logits``
  on the mesh is within 2e-4 of JAX's; a decode step adds exactly one
  all-gather over ``model`` a layer to a local-heads mesh's census;
- the route is chosen from the shape alone, every shape served before
  keeps its shard bit for bit, the gathered route's qkv shard is the JAX
  mesh's, and what JAX refuses (a cut dimension ``model`` does not
  divide, int4 rows in odd pairs) the port refuses too.

Spawned worlds of CPU ranks (gloo), one fixture for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from starpu_inference_server_tpu.models import decoder as jdec
from starpu_inference_server_tpu.ops.quant import maybe_quantize_tree as jquantize
from starpu_inference_server_tpu.parallel import tp_layout as jtp
from starpu_inference_server_tpu.parallel.mesh import MeshAxes as JMeshAxes
from starpu_inference_server_tpu.parallel.mesh import make_device_mesh
from starpu_inference_server_tpu.parallel.partition import partition_rules_for as jrules
from starpu_inference_server_tpu.parallel.partition import shard_params as jshard
from starpu_inference_server_tpu.serving.generation import GenerationEngine as JaxEngine
from starpu_inference_server_tpu.serving.generation import GenerationRequest as JaxRequest
from starpu_inference_server_tpu_torch.models.decoder import get_spec, init_params, local_heads
from starpu_inference_server_tpu_torch.parallel import tp_layout
from starpu_inference_server_tpu_torch.parallel.census import collectives_by_axis
from starpu_inference_server_tpu_torch.parallel.launch import run_world
from starpu_inference_server_tpu_torch.weights import rank_shard

BASE = {"layers": 2, "hidden": 128, "q_heads": 4, "kv_heads": 2, "intermediate": 256,
        "vocab": 128}
Q6KV2 = dict(BASE, q_heads=6, hidden=192)                # model=4 divides neither
Q6KV3 = dict(BASE, q_heads=6, kv_heads=3, hidden=192)    # model=2: 3 kv heads
Q12KV6 = dict(BASE, q_heads=12, kv_heads=6, hidden=384)  # model=4: 6 kv heads
Q10KV5 = dict(BASE, q_heads=10, kv_heads=5, hidden=320, intermediate=320)
MOE = dict(Q6KV2, num_experts=4)
PROMPTS = [[3, 7, 11], [5, 2], [9, 1, 4]]
LONG = [np.random.default_rng(6).integers(0, 128, (n,)).tolist() for n in (13, 5, 19, 9)]
ENGINE = dict(num_slots=4, max_len=64, prefill_buckets=[8], steps_per_sync=2)
CHUNKED = dict(ENGINE, prefill_chunk=8)
DRAFT = {"family": "llama-tiny", "seed": 1,
         "opts": dict(BASE, layers=1, hidden=64, q_heads=2, kv_heads=1, intermediate=96)}
MAX_NEW = 6
IDS = np.tile(np.arange(1, 9, dtype=np.int64), (4, 1))


def _gen(name, opts, family="llama-tiny", prompts=PROMPTS, engine=ENGINE, quant=None,
         draft=None, max_new=MAX_NEW):
    return {"name": name, "kind": "generate", "family": family, "opts": opts, "seed": 0,
            "prompts": prompts, "engine": engine, "quant": quant, "max_new": max_new,
            "draft": draft}


def _forward(name, opts):
    return {"name": name, "kind": "forward", "family": "llama-tiny",
            "options": dict(opts, seq_len=8), "quant": "none", "inputs": {"input_ids": IDS}}


def _census(name, opts):
    return {"name": name, "kind": "step_census", "family": "llama-tiny", "opts": opts,
            "seed": 0, "engine": ENGINE, "prompt": [3, 7, 11]}


# name -> (world, case): the generation cases; the JAX engines get the same
GEN = {
    "q6kv2": ("dm4", _gen("q6kv2", Q6KV2)),
    "q12kv6": ("dm4", _gen("q12kv6", Q12KV6)),
    "q10kv5": ("dm4", _gen("q10kv5", Q10KV5)),
    "q6kv3": ("dm2", _gen("q6kv3", Q6KV3)),
    "int4": ("dm4", _gen("int4", Q6KV2, quant=4)),
    "moe": ("dm4", _gen("moe", MOE, family="moe-tiny")),
    "chunk": ("dm4", _gen("chunk", Q6KV2, prompts=LONG, engine=CHUNKED)),
    "verify": ("dm4", _gen("verify", Q6KV2, engine=dict(ENGINE, speculate_k=3), draft=DRAFT,
                           max_new=8)),
}
FORWARD = {"q6kv2": ("dm4", Q6KV2), "q12kv6": ("dm4", Q12KV6), "q10kv5": ("dm4", Q10KV5),
           "q6kv3": ("dm2", Q6KV3)}
# (gathered shape, a local-heads shape of the same depth) on each world
CENSUS = {"dm4": ("q6kv2", Q6KV2, BASE), "dm2": ("q6kv3", Q6KV3, BASE)}
AXES = {"dm4": {"data": 2, "model": 4}, "dm2": {"data": 2, "model": 2}}


def _world_cases(world):
    cases = [c for w, c in GEN.values() if w == world]
    cases += [_forward(f"{n}_logits", o) for n, (w, o) in FORWARD.items() if w == world]
    name, cut, local = CENSUS[world]
    return cases + [_census(f"{name}_census", cut), _census("local_census", local)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world runs its cases once: {world: {case: [result of each rank]}}."""
    out = {}
    for name, axes in AXES.items():
        size = axes["data"] * axes["model"]
        ranks = run_world("torch_mesh_cases:world", size,
                          {"axes": axes, "cases": _world_cases(name)},
                          timeout_s=300.0, workdir=str(tmp_path_factory.mktemp(name)))
        out[name] = {key: [r[key] for r in ranks] for key in ranks[0]}
    return out


def _jax_params(case):
    spec = jdec.get_spec(case["family"], case["opts"])
    params = jdec.init_params(spec, np.random.default_rng(case["seed"]))
    if case["quant"]:
        params = jquantize(params, case["quant"])
    return spec, params


def jax_tokens(case, axes=None):
    """Greedy tokens of the JAX engine on the case's tree: on one device,
    or on a CPU mesh of ``axes``."""
    spec, params = _jax_params(case)
    draft = {}
    if case["draft"]:
        d = case["draft"]
        draft_spec = jdec.get_spec(d["family"], d["opts"])
        draft = {"draft_spec": draft_spec,
                 "draft_params": jdec.init_params(draft_spec, np.random.default_rng(d["seed"]))}
    mesh = make_device_mesh(JMeshAxes(**axes)) if axes else None
    eng = JaxEngine(spec, params, dtype=jnp.float32, family=case["family"], mesh=mesh,
                    **case["engine"], **draft)
    eng.start()
    try:
        reqs = [JaxRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=case["max_new"])
                for p in case["prompts"]]
        for r in reqs:
            eng.submit(r)
        return [r.result(timeout=300) for r in reqs]
    finally:
        eng.stop()


@pytest.mark.parametrize("name", list(GEN))
def test_cut_heads_streams_equal_the_jax_engines(worlds, name):
    """The port's GSPMD streams equal the JAX engine's on one device and
    on a CPU mesh of the same axes (which serves the shape: XLA reshards
    the fused qkv columns); every rank gathers the projection."""
    world, case = GEN[name]
    res = worlds[world][name][0]
    one = jax_tokens(case)
    assert res["tokens"] == one
    assert jax_tokens(case, AXES[world]) == one
    if case["draft"]:  # the verify windows went through the mesh
        assert res["drafted"] > 0
    spec = get_spec(case["family"], case["opts"])
    assert tp_layout.gathered_heads(spec, AXES[world]["model"])
    for stats in res["stats"]:
        census = collectives_by_axis(stats["collectives"])
        assert census["all-gather"]["model"] >= spec.layers + 2
        assert census["all-reduce"]["model"] > 0


@pytest.mark.parametrize("name", list(FORWARD))
def test_cut_heads_forward_logits_match_jax(worlds, name):
    """``forward_logits`` on the mesh (the family's ``apply`` through
    ``sharded_forward``) within the JAX package's 2e-4 of FP32 mesh
    forwards of the JAX one-device forward, on every rank."""
    world, opts = FORWARD[name]
    spec = jdec.get_spec("llama-tiny", opts)
    params = jdec.init_params(spec, np.random.default_rng(0))
    want = np.asarray(jdec.forward_logits(spec, params, jnp.asarray(IDS.astype(np.int32)),
                                          jnp.float32))
    for got in worlds[world][f"{name}_logits"]:
        np.testing.assert_allclose(got["out"]["logits"], want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("world", list(CENSUS))
def test_a_decode_step_gathers_once_a_layer_more_than_local_heads(worlds, world):
    """One decode step of L layers: all-reduce/model 2L (o and down), as on
    a local-heads mesh of the same depth, and exactly L more all-gathers
    over ``model`` (the fused qkv), nothing else added, on every rank. The
    rank holds every head and every kv head's cache."""
    name, cut, local = CENSUS[world]
    res, ref = worlds[world][f"{name}_census"][0], worlds[world]["local_census"][0]
    layers = cut["layers"]
    assert local["layers"] == layers
    assert res["heads"] == (cut["q_heads"], cut["kv_heads"])
    assert res["cache_heads"] == cut["kv_heads"]
    assert ref["heads"] != (local["q_heads"], local["kv_heads"])  # the local route
    for got, want in zip(res["census"], ref["census"]):
        got, want = collectives_by_axis(got), collectives_by_axis(want)
        assert got["all-reduce"] == want["all-reduce"] == {"model": 2 * layers}
        assert got["all-gather"]["model"] == want["all-gather"]["model"] + layers
        got["all-gather"]["model"] -= layers
        assert got == want


# -- the route and the shards, without a world -------------------------------------

class _Model:  # a rank mesh's model size
    def __init__(self, n):
        self.n = n

    def size(self, axis):
        return self.n if axis == "model" else 1


@pytest.mark.parametrize("q,kv,hidden,tp,gathered", [
    (40, 10, 5120, 4, True),   # Phi-3-medium
    (40, 10, 5120, 2, False),
    (28, 4, 3584, 8, True),    # Qwen2.5-7B
    (28, 4, 3584, 4, False),
    (40, 8, 5120, 16, True),   # Qwen2.5-14B
    (40, 40, 5120, 16, True),  # Llama-2-13B
    (71, 1, 4544, 2, True),    # Falcon-7B's MQA
    (32, 8, 2048, 4, False),   # llama-1b
    (32, 8, 2048, 16, False),  # kv heads replicated
    (32, 2, 2048, 4, False),
])
def test_the_route_is_chosen_from_the_shape(q, kv, hidden, tp, gathered):
    """Local heads where ``model`` divides the q heads and divides or is a
    multiple of the kv heads; gathered heads otherwise, where every rank
    runs (and caches) every head."""
    spec = get_spec("llama-1b", {"q_heads": q, "kv_heads": kv, "hidden": hidden})
    assert tp_layout.gathered_heads(spec, tp) is gathered
    heads = local_heads(spec, _Model(tp))
    assert heads == ((q, kv) if gathered else (q // tp, max(1, kv // tp)))
    assert not tp_layout.gathered_heads(spec, 1)


def _tree(spec, quant=None):
    tree = init_params(spec, np.random.default_rng(3))
    if quant:
        from starpu_inference_server_tpu_torch.ops.quant import maybe_quantize_tree, pack_int4_tree
        from starpu_inference_server_tpu_torch.weights import params_from_numpy

        tree = maybe_quantize_tree(params_from_numpy(tree), quant)
        if quant == 4:
            tree = pack_int4_tree(tree)
    return tree


def _np(node):
    import torch

    if isinstance(node, dict):
        return {k: _np(v) for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        return node.numpy()
    return np.asarray(node) if hasattr(node, "shape") else node


def _trees_equal(got, want):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _trees_equal(got[k], want[k])
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("opts,tp,quant", [(Q6KV2, 4, None), (Q12KV6, 4, 8), (Q10KV5, 4, 4),
                                           (Q6KV3, 2, None), (MOE, 4, None)])
def test_gathered_qkv_shard_is_the_jax_mesh_shard(opts, tp, quant):
    """Rank r's fused qkv shard is the contiguous block JAX's ``P(None,
    MODEL)`` puts on the mesh position (``addressable_shards``), bf16,
    int8 and packed int4 alike; ``o``, ``gate_up`` and ``down`` keep the
    layout the local route gives them."""
    family = "moe-tiny" if "num_experts" in opts else "llama-tiny"
    spec = get_spec(family, opts)
    tree = _tree(spec, quant)
    mesh = make_device_mesh(JMeshAxes(model=tp))
    placed = jshard({"layers": [{"attn": {"qkv": _np(tree["layers"][0]["attn"]["qkv"])}}]},
                    mesh, jrules(family))
    leaf = placed["layers"][0]["attn"]["qkv"]["w"]
    arrays = leaf if isinstance(leaf, dict) else {"w": leaf}
    layer = tree["layers"][0]
    for r in range(tp):
        coords = {"pipe": 0, "data": 0, "expert": 0, "model": r}
        shard = rank_shard(tree, spec, family, coords, {"model": tp})["layers"][0]
        got = shard["attn"]["qkv"]["w"]
        got = got if isinstance(got, dict) else {"w": got}
        for key, arr in arrays.items():
            if key == "bits":
                continue
            block = next(s for s in arr.addressable_shards if s.device == mesh.devices.flat[r])
            np.testing.assert_array_equal(_np(got[key]), np.asarray(block.data))
        local = tp_layout.shuffle_decoder_layer_for_tp(spec, layer, tp)
        whole = tp_layout.gspmd_decoder_layer_for_tp(spec, layer, tp)
        _trees_equal({k: whole[k] for k in ("attn_norm", "mlp_norm", "mlp")},
                     {k: local[k] for k in ("attn_norm", "mlp_norm", "mlp")})
        _trees_equal(whole["attn"]["o"], local["attn"]["o"])


def _served_before(q, kv, tp):
    """The rule of the tree this route was added to: model dividing both
    head counts (JAX's ``validate_decoder_tp``), or a multiple of the kv
    heads dividing the q heads."""
    return q % tp == 0 and (kv % tp == 0 or tp % kv == 0)


def _replicated(spec, layer, tp):
    """The layer with each kv head's K and V columns repeated ``tp / kv``
    times, built column by column."""
    d, r = spec.head_dim, tp // spec.kv_heads
    w = layer["attn"]["qkv"]["w"]
    q = w[:, :spec.q_heads * d]
    k0 = spec.q_heads * d
    k = [w[:, k0 + h * d:k0 + (h + 1) * d] for h in range(spec.kv_heads) for _ in range(r)]
    v0 = k0 + spec.kv_heads * d
    v = [w[:, v0 + h * d:v0 + (h + 1) * d] for h in range(spec.kv_heads) for _ in range(r)]
    return dict(layer, attn=dict(layer["attn"], qkv={"w": np.concatenate([q] + k + v, 1)}))


@pytest.mark.parametrize("q,kv", [(4, 2), (8, 4), (8, 2), (8, 1), (12, 4), (16, 8), (16, 16)])
def test_every_shape_served_before_keeps_its_shard(q, kv):
    """Every (q, kv, model) the port served before the gathered route keeps
    the local route and its layer hook's output bit for bit: JAX's
    block-aligned shuffle, after the kv heads' replication where ``model``
    exceeds them; every other shape now takes the gathered route."""
    for tp in (2, 4, 8, 16):
        spec = get_spec("llama-tiny", {"q_heads": q, "kv_heads": kv, "hidden": 16 * q,
                                       "intermediate": 256, "layers": 1, "vocab": 128})
        if not _served_before(q, kv, tp):
            assert tp_layout.gathered_heads(spec, tp)
            continue
        assert not tp_layout.gathered_heads(spec, tp)
        layer = init_params(spec, np.random.default_rng(q * kv + tp))["layers"][0]
        jspec = jdec.get_spec("llama-tiny", dict(vars(spec)))
        if tp > kv:
            layer_r = _replicated(spec, layer, tp)
            jspec = jdec.get_spec("llama-tiny", dict(vars(spec), kv_heads=tp))
        else:
            layer_r = layer
        want = jtp.shuffle_decoder_layer_for_tp(jspec, layer_r, tp)
        _trees_equal(tp_layout.gspmd_decoder_layer_for_tp(spec, layer, tp), want)


def _jax_refuses(opts, tp):
    spec = jdec.get_spec("llama-tiny", opts)
    params = jdec.init_params(spec, np.random.default_rng(0))
    with pytest.raises(ValueError):
        JaxEngine(spec, params, dtype=jnp.float32, family="llama-tiny",
                  mesh=make_device_mesh(JMeshAxes(model=tp)), **ENGINE)


@pytest.mark.parametrize("opts,dim", [
    (dict(BASE, q_heads=12, kv_heads=3, hidden=132), "qkv columns"),  # 198 columns
    (dict(BASE, q_heads=8, kv_heads=4, intermediate=250), "intermediate"),
    (dict(Q6KV2, vocab=130), "vocab"),
])
def test_a_cut_dimension_model_does_not_divide_is_refused_by_both(opts, dim):
    """JAX's one refusal on a GSPMD decoder mesh is ``device_put``'s: a
    dimension the decoder rules cut over ``model`` that ``model`` does not
    divide. The port refuses the same shapes, naming the dimension, before
    any weight is built and again in the layer hook and the cut."""
    tp = 4
    _jax_refuses(opts, tp)
    spec = get_spec("llama-tiny", opts)
    with pytest.raises(ValueError, match=dim):
        tp_layout.validate_gspmd_decoder_tp(spec, tp)
    tree = init_params(spec, np.random.default_rng(0))
    with pytest.raises(ValueError):
        rank_shard(tree, spec, "llama-tiny", {"pipe": 0, "data": 0, "expert": 0, "model": 0},
                   {"model": tp})


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_int4_row_pairs_are_refused_where_the_jax_cut_of_a_packed_leaf_is(tp):
    """A packed int4 row-parallel leaf ``[K / 2, N]`` cut ``P(MODEL, None)``
    (JAX's ``_quant_specs``): JAX's ``device_put`` refuses exactly the K
    whose packed rows ``model`` does not divide, and so does
    ``repack_int4_rows``."""
    mesh = make_device_mesh(JMeshAxes(model=tp))
    for k in range(2, 4 * tp + 2, 2):
        packed = {"w_p4": np.zeros((k // 2, 8), np.uint8), "scale": np.ones((1, 8), np.float32),
                  "bits": 4}
        try:
            jshard({"layers": [{"attn": {"o": {"w": packed}}}]}, mesh, jrules("llama-tiny"))
            jax_ok = True
        except ValueError:
            jax_ok = False
        try:
            tp_layout.repack_int4_rows(packed, tp)
            port_ok = True
        except ValueError:
            port_ok = False
        assert jax_ok == port_ok == ((k // 2) % tp == 0), k
    jax.clear_caches()


@pytest.mark.parametrize("opts,match", [(Q6KV2, "start it from the server CLI"),
                                        (dict(Q6KV2, vocab=130), "vocab")])
def test_the_config_check_takes_what_jax_serves(opts, match):
    """``build_generation_engine``'s check of a config's mesh, before any
    weight is built: ``llama_decoder.yml`` at 6 q over 2 kv heads on
    model=4 passes it (a mesh config then runs from the server CLI), a
    vocab ``model`` does not divide is refused there."""
    import dataclasses
    from pathlib import Path

    from starpu_inference_server_tpu_torch.serving.generation import build_generation_engine
    from starpu_inference_server_tpu_torch.utils.config import MeshSettings, load_config

    cfg = load_config(str(Path(__file__).resolve().parents[1] / "configs" / "llama_decoder.yml"))
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, options=dict(cfg.model.options, **opts)),
        devices=dataclasses.replace(cfg.devices, mesh=MeshSettings(model=4)))
    with pytest.raises(ValueError, match=match):
        build_generation_engine(cfg, device="cpu")
