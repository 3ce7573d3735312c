"""The port's mesh layout and sharding against the JAX package's
``parallel/`` (no processes needed): ``MeshAxes`` and the mesh's error,
the tensor-parallel layouts of ``tp_layout.py`` bit for bit, the
partition rules and specs, every rank's parameter and cache shard
against the JAX leaves' ``addressable_shards`` on the same (pipe,
expert, model) position of the 8-device virtual CPU mesh (dense, int8
and packed-int4 trees), and the pipelined engine's guards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from starpu_inference_server_tpu.models import decoder as jdec
from starpu_inference_server_tpu.ops import quant as jquant
from starpu_inference_server_tpu.parallel import mesh as jmesh
from starpu_inference_server_tpu.parallel import partition as jpart
from starpu_inference_server_tpu.parallel import tp_layout as jtp
from starpu_inference_server_tpu.parallel.pipeline import prepare_pipelined_params
from starpu_inference_server_tpu.parallel.pipeline_decode import _cache_specs
from starpu_inference_server_tpu.parallel.pipeline_decode import (
    validate_pipe_mesh as jax_validate_pipe_mesh,
)
from starpu_inference_server_tpu_torch.models.decoder import get_spec
from starpu_inference_server_tpu_torch.parallel import mesh as tmesh
from starpu_inference_server_tpu_torch.parallel import partition as tpart
from starpu_inference_server_tpu_torch.parallel import tp_layout as ttp
from starpu_inference_server_tpu_torch.parallel.pipeline_decode import (
    cache_specs,
    shard_cache,
    validate_pipe_mesh,
)
from starpu_inference_server_tpu_torch.serving.generation import GenerationEngine
from starpu_inference_server_tpu_torch.weights import rank_shard

TINY = {"layers": 4, "hidden": 64, "q_heads": 4, "kv_heads": 2, "intermediate": 96,
        "vocab": 128}
MOE = dict(TINY, num_experts=4)


def _error(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_mesh_axes_and_the_too_small_error_match_jax():
    for axes in ((1, 1, 1, 1), (1, 2, 1, 2), (2, 1, 2, 2)):
        j = jmesh.MeshAxes(data=axes[0], pipe=axes[1], expert=axes[2], model=axes[3])
        t = tmesh.MeshAxes(data=axes[0], pipe=axes[1], expert=axes[2], model=axes[3])
        assert (t.data, t.pipe, t.expert, t.model, t.size) == \
            (j.data, j.pipe, j.expert, j.model, j.size)
    big = dict(data=2, pipe=2, model=2)
    want = _error(lambda: jmesh.make_device_mesh(jmesh.MeshAxes(**big), jax.devices()[:4]))
    assert _error(lambda: tmesh.device_grid(tmesh.MeshAxes(**big), range(4))) == want
    assert tmesh.AXES == tuple(jmesh.make_device_mesh(jmesh.MeshAxes()).axis_names)
    # the grid's order is the JAX mesh's (model fastest)
    grid = tmesh.device_grid(tmesh.MeshAxes(pipe=2, expert=2, model=2), range(8))
    jgrid = jmesh.make_device_mesh(jmesh.MeshAxes(pipe=2, expert=2, model=2)).devices
    assert [[[[jax.devices().index(d) for d in row] for row in e] for e in p]
            for p in jgrid] == grid.tolist()


@pytest.mark.parametrize("groups,tp", [([8, 4, 4], 2), ([8, 4, 4], 4), ([6, 6], 3), ([5], 2)])
def test_block_tp_permutation_matches_jax(groups, tp):
    if any(g % tp for g in groups):
        assert _error(lambda: ttp.block_tp_permutation(groups, tp)) == \
            _error(lambda: jtp.block_tp_permutation(groups, tp))
    else:
        np.testing.assert_array_equal(ttp.block_tp_permutation(groups, tp),
                                      jtp.block_tp_permutation(groups, tp))


def _trees_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _trees_equal(got[k], want[k])
    elif isinstance(want, int):
        assert got == want
    else:
        g = np.asarray(got)
        w = np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a) if hasattr(a, "shape") else a, tree)


@pytest.mark.parametrize("family,quant", [("llama-tiny", None), ("llama-tiny", 8),
                                          ("llama-tiny", 4), ("moe-tiny", None),
                                          ("moe-tiny", 8)])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_layer_shuffle_matches_jax_bit_for_bit(family, quant, tp):
    """shuffle_decoder_layer_for_tp (permute_out_columns on dense, int8 and
    packed int4 leaves; repack_int4_rows on the row-parallel ones)."""
    opts = MOE if family == "moe-tiny" else TINY
    jspec = jdec.get_spec(family, opts)
    params = jdec.init_params(jspec, np.random.default_rng(1))
    if quant:
        params = jquant.maybe_quantize_tree(params, bits=quant)
    if quant == 4:
        params = jquant.pack_int4_tree(params)
    layer = _np_tree(params["layers"][0])
    spec = get_spec(family, opts)
    want = _np_tree(jtp.shuffle_decoder_layer_for_tp(jspec, layer, tp))
    _trees_equal(ttp.shuffle_decoder_layer_for_tp(spec, layer, tp), want)


def test_tp_layout_errors_match_jax():
    packed = {"w_p4": np.zeros((6, 8), np.uint8), "scale": np.ones((1, 8), np.float32),
              "bits": 4}
    assert _error(lambda: ttp.repack_int4_rows(packed, 4)) == \
        _error(lambda: jtp.repack_int4_rows(packed, 4))
    for opts, tp in ((dict(TINY, kv_heads=1), 2), (dict(TINY, intermediate=97), 2),
                     (dict(TINY, q_heads=4, kv_heads=4, hidden=64), 8)):
        assert _error(lambda: ttp.validate_decoder_tp(get_spec("llama-tiny", opts), tp)) == \
            _error(lambda: jtp.validate_decoder_tp(jdec.get_spec("llama-tiny", opts), tp))


PATHS = ["layers/0/attn/qkv/w", "layers/attn/o/w", "layers/mlp/gate_up/w", "layers/mlp/down/w",
         "layers/mlp/router/w", "layers/mlp/experts/gate_up/w", "layers/mlp/experts/down/w",
         "embed/w", "lm_head/w", "final_norm/gamma", "encoder/0/attn/q/w",
         "encoder/0/attn/k/b", "encoder/0/ffn/fc2/w", "embeddings/word/w", "patch_embed/w",
         "pos_embed", "stem/conv/w"]


@pytest.mark.parametrize("family", ["llama-7b", "moe-tiny", "mixtral-8x7b", "bert-base",
                                    "vit_b_16", "resnet50"])
def test_partition_rules_match_jax(family):
    rules, jrules = tpart.partition_rules_for(family), jpart.partition_rules_for(family)
    assert [p for p, _ in rules] == [p for p, _ in jrules]
    for path in PATHS:
        assert tpart.spec_for_path(path, rules) == tuple(jpart._spec_for_path(path, jrules))
    leaf = np.zeros((4, 8, 16), np.float32)
    qleaf = {"w_q": np.zeros((4, 2, 8, 16), np.int8), "scale": np.ones((4, 2, 1, 16)),
             "bits": 8}
    for path in PATHS:
        for lf in (leaf, qleaf):
            spec = tpart.stacked_layer_spec(path, lf, rules)
            assert spec == tuple(jpart.stacked_layer_spec(path, lf, jrules))
        assert tpart.quant_specs(spec, qleaf) == tuple(
            tuple(s) for s in jpart._quant_specs(jax.sharding.PartitionSpec(*spec), qleaf))


MESHES = {"pipe2": dict(pipe=2), "pipe2_tp2": dict(pipe=2, model=2),
          "pipe2_ep2": dict(pipe=2, expert=2), "pipe2_ep2_tp2": dict(pipe=2, expert=2, model=2),
          "pipe4_tp2": dict(pipe=4, model=2)}


def _positions(mesh):
    """{device: {axis: coordinate}} of a JAX mesh."""
    out = {}
    for idx in np.ndindex(mesh.devices.shape):
        out[mesh.devices[idx]] = dict(zip(mesh.axis_names, (int(i) for i in idx)))
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif hasattr(tree, "shape"):
        yield prefix, tree


@pytest.mark.parametrize("case", [("llama-tiny", None, "pipe2_tp2"),
                                  ("llama-tiny", 8, "pipe2_tp2"),
                                  ("llama-tiny", 4, "pipe2_tp2"),
                                  ("llama-tiny", 8, "pipe4_tp2"),
                                  ("moe-tiny", None, "pipe2_ep2_tp2"),
                                  ("moe-tiny", 8, "pipe2_ep2"),
                                  ("llama-tiny", None, "pipe2")],
                         ids=lambda c: "-".join(str(x) for x in c))
def test_rank_shards_equal_jax_addressable_shards(case):
    """Every leaf of every rank's shard (``weights.rank_shard``: tp shuffle,
    stack, cut) equals the JAX placed leaf's shard on the device at the
    same mesh position (``prepare_pipelined_params`` with the family's
    ``tp_layer_shuffle``)."""
    family, quant, mesh_name = case
    opts = dict(MOE if family == "moe-tiny" else TINY, layers=8)
    jspec = jdec.get_spec(family, opts)
    params = jdec.init_params(jspec, np.random.default_rng(2))
    if quant:
        params = jquant.maybe_quantize_tree(params, bits=quant)
    if quant == 4:
        params = jquant.pack_int4_tree(params)
    params = _np_tree(params)
    axes = jmesh.MeshAxes(**MESHES[mesh_name])
    mesh = jmesh.make_device_mesh(axes)
    tp = axes.model
    shuffle = (lambda layer: jtp.shuffle_decoder_layer_for_tp(jspec, layer, tp)) if tp > 1 \
        else None
    placed = prepare_pipelined_params(params, mesh, jpart.partition_rules_for(family),
                                      layer_shuffle=shuffle)
    sizes = dict(mesh.shape)
    spec = get_spec(family, opts)
    pos = _positions(mesh)
    ours = {}
    for dev, coords in pos.items():
        ours[dev] = dict(_leaves(rank_shard(params, spec, family, coords, sizes)))
    n = 0
    for path, leaf in _leaves(placed):
        for shard in leaf.addressable_shards:
            got = ours[shard.device][path]
            want = np.asarray(shard.data)
            assert got.dtype == want.dtype and got.shape == want.shape, path
            np.testing.assert_array_equal(got, want, err_msg=path)
            n += 1
    assert n >= len(pos) * 9  # every leaf of the dense tree at least


def test_stacked_cache_shards_equal_jax():
    """``shard_cache`` (the cache specs: [L] over pipe, heads over model)
    against the JAX cache sharded by ``_cache_specs``."""
    spec = jdec.get_spec("llama-tiny", TINY)
    rng = np.random.default_rng(3)
    full = jdec.KVCache(
        k=jnp.asarray(rng.integers(-127, 128, (4, 2, 8, 2, 16)), jnp.int8),
        v=jnp.asarray(rng.integers(-127, 128, (4, 2, 8, 2, 16)), jnp.int8),
        k_scale=jnp.asarray(rng.random((4, 2, 8, 2)), jnp.float32),
        v_scale=jnp.asarray(rng.random((4, 2, 8, 2)), jnp.float32),
        lengths=jnp.asarray([3, 5], jnp.int32))
    del spec
    mesh = jmesh.make_device_mesh(jmesh.MeshAxes(pipe=2, model=2))
    kv, scale = _cache_specs(mesh)
    assert cache_specs() == (tuple(kv), tuple(scale))
    numpy_cache = jdec.KVCache(*(np.asarray(a) for a in full))
    for dev, coords in _positions(mesh).items():
        ours = shard_cache(numpy_cache, coords, dict(mesh.shape))
        for name, spec_ in (("k", kv), ("v", kv), ("k_scale", scale), ("v_scale", scale)):
            placed = jax.device_put(getattr(full, name), jax.sharding.NamedSharding(mesh, spec_))
            want = next(np.asarray(s.data) for s in placed.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(getattr(ours, name), want)


def test_validate_pipe_mesh_rejects_data_axis():
    data = tmesh.MeshAxes(pipe=2, data=2)
    want = _error(lambda: jax_validate_pipe_mesh(
        jmesh.make_device_mesh(jmesh.MeshAxes(pipe=2, data=2))))
    assert _error(lambda: validate_pipe_mesh(data)) == want
    assert validate_pipe_mesh(tmesh.MeshAxes(pipe=2, model=2)) == 2
    assert validate_pipe_mesh(tmesh.MeshAxes(pipe=2, expert=2)) == 2


def test_pipelined_engine_guards():
    """The JAX engine's guards, with the same exception types and
    messages, checked before any rank is needed (the mesh's axis sizes
    alone): prefill_chunk, a bucket the stages do not divide, slots the
    microgroups do not divide; and the mesh layouts the port refuses."""
    spec = get_spec("llama-tiny", TINY)
    mesh = tmesh.MeshAxes(pipe=2)
    with pytest.raises(ValueError, match="prefill_chunk"):
        GenerationEngine(spec, None, mesh=mesh, prefill_buckets=[8], prefill_chunk=4,
                         device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        GenerationEngine(spec, None, mesh=mesh, prefill_buckets=[9], device="cpu")
    with pytest.raises(ValueError, match="microgroups"):
        GenerationEngine(spec, None, mesh=mesh, prefill_buckets=[8], num_slots=5,
                         pipe_microgroups=2, device="cpu")
    with pytest.raises(ValueError, match="flat"):
        GenerationEngine(spec, None, mesh=mesh, prefill_buckets=[8],
                         kv_cache_layout="flat", device="cpu")
    with pytest.raises(ValueError, match="paged KV cache does not compose"):
        GenerationEngine(spec, None, mesh=mesh, prefill_buckets=[8], kv_page_size=16,
                         device="cpu")
    with pytest.raises(ValueError, match="'data' mesh axis"):
        GenerationEngine(spec, None, mesh=tmesh.MeshAxes(pipe=2, data=2),
                         prefill_buckets=[8], device="cpu")
    with pytest.raises(ValueError, match="divisible by the mesh data axis"):
        GenerationEngine(spec, None, mesh=tmesh.MeshAxes(data=2), num_slots=3, device="cpu")


def _mesh_cfg(mesh, **options):
    from starpu_inference_server_tpu_torch.utils.config import parse_config

    return parse_config({
        "name": "llama_pipelined_tiny",
        "model": {"family": "llama-tiny", "compute_dtype": "FP32", "quantization": "int8",
                  "options": {**TINY, "num_slots": 4, "max_len": 64, "prefill_buckets": [8],
                              **options}},
        "inputs": [{"name": "input_ids", "dims": [8], "dtype": "INT64"}],
        "outputs": [{"name": "logits", "dims": [8, 128], "dtype": "FP32"}],
        "pool_size": 1, "max_batch_size": 1, "batch_coalesce_timeout_ms": 0,
        "batching_strategy": "disabled", "max_queue_size": 16, "max_inflight_tasks": 1,
        "devices": {"mesh": mesh},
    })


def test_build_generation_engine_checks_a_config_mesh_before_its_ranks():
    """A config with a mesh meets the engine's guards at the door, before
    any weights are built; one that passes them needs its rank processes
    (the server CLI); a rank mesh passed with a one-position config is
    refused."""
    from starpu_inference_server_tpu_torch.serving.generation import build_generation_engine

    with pytest.raises(ValueError, match="start it from the server CLI"):
        build_generation_engine(_mesh_cfg({"data": 2}), device="cpu")
    with pytest.raises(ValueError, match="'data' mesh axis"):
        build_generation_engine(_mesh_cfg({"pipe": 2, "data": 2}), device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        build_generation_engine(_mesh_cfg({"pipe": 2}, prefill_chunk=4), device="cpu")
    with pytest.raises(ValueError, match="microgroups"):
        build_generation_engine(_mesh_cfg({"pipe": 2}, pipe_microgroups=3), device="cpu")
    with pytest.raises(ValueError, match="rank processes"):
        build_generation_engine(_mesh_cfg({"pipe": 2}, pipe_microgroups=2), device="cpu")
    with pytest.raises(ValueError, match="one position"):
        build_generation_engine(_mesh_cfg({}), device="cpu", mesh=tmesh.MeshAxes(pipe=2))
