"""The port's GSPMD mode for the batch families and the batch engine on a
mesh, in spawned worlds of CPU ranks (gloo), against the JAX package on
the same seeds:

- ``parallel.partition.sharded_forward`` at data=2 x model=2: BERT FP32
  (the JAX package's own 2e-4), int8 (its mesh-serving 5e-4) and W8A8
  (the W8A8 limits of ``test_torch_models.py``), ViT at model=2 (1e-4,
  ``test_torch_vit.py``'s), ResNet-18 data-parallel (1e-3 of the logits'
  mean magnitude, ``test_torch_models.py``'s), each against the JAX
  single-device forward; the W8A8 row-parallel dense at model=2 (and the
  W4A8 one, through K6's route) has the single-device layer's s32 sums
  and outputs bit for bit, and ResNet-18
  W8A8 at data=2 the single-device logits (the batch-wide scale);
- the batch pipeline (queue -> collector -> lanes -> ``ModelEngine``) on
  BERT int8 at data=2 x model=2, the counterparts of the JAX
  ``test_mesh_serving.py`` (5e-4), and a hot reload of every rank's shard;
- a decoder's ``serve_logits`` on ``ModelEngine`` at data=2 x model=2 (5e-4);
- ``ModelEngine``'s pipe mode, the counterparts of the JAX
  ``test_pipeline_serving.py:57-116`` (5e-4): llama-tiny FP32 and int8 and
  moe-tiny at pipe=2, composed with data=2 and model=2 (eight ranks), the
  bucket granularity lcm(data, microbatches), and ``DeviceError`` for a
  family without ``pipeline_apply``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from starpu_inference_server_tpu.models import build_model as jax_build
from starpu_inference_server_tpu.ops import nn as jnn
from starpu_inference_server_tpu.utils.config import ModelSettings as JSettings
from starpu_inference_server_tpu.utils.config import QuantMode as JQuant
from starpu_inference_server_tpu_torch.core.engine import ModelEngine
from starpu_inference_server_tpu_torch.models.registry import build_model
from starpu_inference_server_tpu_torch.parallel.census import collectives_by_axis
from starpu_inference_server_tpu_torch.parallel.launch import run_world
from starpu_inference_server_tpu_torch.utils.config import parse_config
from starpu_inference_server_tpu_torch.utils.exceptions import DeviceError

BERT = {"num_layers": 2, "seq_len": 8, "vocab_size": 256}
VIT = {"num_layers": 1, "image_size": 32, "num_classes": 10}
RESNET = {"image_size": 32, "num_classes": 10}
TINY = {"layers": 2, "hidden": 128, "q_heads": 4, "kv_heads": 2, "intermediate": 256,
        "vocab": 128, "seq_len": 8}


def _bert_inputs(rows=4, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, BERT["vocab_size"], (rows, 8)).astype(np.int64)
    mask = np.ones((rows, 8), np.int64)
    mask[1, 5:] = 0  # a padded sample
    return {"input_ids": ids, "attention_mask": mask}


def forward_case(name, family, options, inputs, quant="none", single=False):
    return {"name": name, "kind": "forward", "family": family, "options": options,
            "quant": quant, "inputs": inputs, "single": single}


def _row_dense_case(bits=8):
    rng = np.random.default_rng(9)
    k, n = 96, 48
    top = 2 ** (bits - 1) - 1
    w_q = rng.integers(-top, top + 1, (k, n)).astype(np.int8)
    return {"name": "row_dense" if bits == 8 else f"row_dense_w{bits}a8", "kind": "row_dense",
            "bits": bits, "x": rng.standard_normal((20, k)).astype(np.float32),
            "w_q": w_q, "scale": (rng.random((1, n)) * 0.01 + 1e-3).astype(np.float32),
            "b": rng.standard_normal((n,)).astype(np.float32)}


def bert_cfg(data=2, model=2, quant="int8"):
    return {
        "name": "bert_mesh",
        "model": {"family": "bert-base-uncased", "compute_dtype": "FP32",
                  "quantization": quant, "options": dict(BERT)},
        "inputs": [{"name": "input_ids", "dims": [8], "dtype": "INT64"},
                   {"name": "attention_mask", "dims": [8], "dtype": "INT64"}],
        "outputs": [{"name": "last_hidden_state", "dims": [8, 768], "dtype": "FP32"}],
        "pool_size": 2, "max_batch_size": 4, "batch_coalesce_timeout_ms": 5.0,
        "batching_strategy": "fixed", "fixed_batching": {"batch_size": 4},
        "max_queue_size": 64, "max_inflight_tasks": 4,
        "congestion": {"enabled": False}, "metrics_enabled": False,
        "devices": {"mesh": {"data": data, "model": model}},
    }


def pipe_cfg(quant="none", data=1, pipe=2, model=1, expert=1, micro=2, family="llama-tiny",
             opts=None):
    return {
        "name": "llama_pipe",
        "model": {"family": family, "compute_dtype": "FP32", "quantization": quant,
                  "options": dict(TINY, **(opts or {}))},
        "inputs": [{"name": "input_ids", "dims": [8], "dtype": "INT64"}],
        "outputs": [{"name": "logits", "dims": [8, 128], "dtype": "FP32"}],
        "pool_size": 1, "max_batch_size": 4, "batch_coalesce_timeout_ms": 0,
        "batching_strategy": "disabled", "max_queue_size": 16, "max_inflight_tasks": 2,
        "congestion": {"enabled": False}, "metrics_enabled": False,
        "devices": {"mesh": {"data": data, "pipe": pipe, "model": model, "expert": expert,
                             "microbatches": micro}},
    }


MOE_OPTS = {"num_experts": 2, "experts_per_token": 1}
PIPE_IDS = np.random.default_rng(3).integers(0, 128, (4, 8)).astype(np.int64)
REQUESTS = [{k: v[i:i + 1] for k, v in _bert_inputs(4, seed=7).items()} for i in range(4)]


def pipe_case(name, cfg):
    return {"name": name, "kind": "engine_forward", "config": cfg,
            "batches": [{"input_ids": PIPE_IDS}]}


WORLDS = {
    "dm": ({"data": 2, "model": 2}, 4, [
        forward_case("bert_fp32", "bert-base-uncased", BERT, _bert_inputs()),
        forward_case("bert_int8", "bert-base-uncased", BERT, _bert_inputs(), quant="int8"),
        forward_case("bert_w8a8", "bert-base-uncased", BERT, _bert_inputs(), quant="w8a8"),
        _row_dense_case(),
        _row_dense_case(bits=4),
        forward_case("vit", "vit_b_16", VIT, {"input": np.random.default_rng(4).standard_normal(
            (2, 3, 32, 32)).astype(np.float32)}),
        forward_case("resnet", "resnet18", RESNET, {"input": np.random.default_rng(5)
                                                    .standard_normal((4, 3, 32, 32))
                                                    .astype(np.float32)}),
        forward_case("resnet_w8a8", "resnet18", RESNET, {"input": np.random.default_rng(6)
                                                         .standard_normal((4, 3, 32, 32))
                                                         .astype(np.float32)},
                     quant="w8a8", single=True),
        {"name": "runner", "kind": "runner", "config": bert_cfg(), "requests": REQUESTS},
        pipe_case("serve_logits", pipe_cfg(data=2, pipe=1, model=2)),
    ]),
    "pipe2": ({"pipe": 2}, 2, [
        pipe_case("plain", pipe_cfg()),
        pipe_case("int8", pipe_cfg(quant="int8")),
        pipe_case("moe", pipe_cfg(family="moe-tiny", opts=MOE_OPTS)),
    ]),
    "dpm": ({"data": 2, "pipe": 2, "model": 2}, 8, [
        pipe_case("composed", pipe_cfg(data=2, pipe=2, model=2, micro=2)),
        pipe_case("granularity", pipe_cfg(data=2, pipe=2, model=2, micro=4)),
    ]),
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world runs its cases once: {world: {case: [result of each rank]}}."""
    out = {}
    for name, (axes, size, cases) in WORLDS.items():
        ranks = run_world("torch_mesh_cases:world", size, {"axes": axes, "cases": cases},
                          timeout_s=300.0, workdir=str(tmp_path_factory.mktemp(name)))
        out[name] = {key: [r[key] for r in ranks] for key in ranks[0]}
    return out


def case_of(world, name):
    return next(c for c in WORLDS[world][2] if c["name"] == name)


def jax_apply(family, options, inputs, quant="none", seed=0):
    model = jax_build(JSettings(family=family, compute_dtype="FP32", quantization=JQuant(quant),
                                options=options), seed=seed)
    jnn.set_w8a8(quant == "w8a8")
    try:
        out = model.apply({k: jnp.asarray(v) for k, v in inputs.items()})
    finally:
        jnn.set_w8a8(False)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name,tol", [("bert_fp32", 2e-4), ("bert_int8", 5e-4), ("vit", 1e-4)])
def test_sharded_forward_matches_single_device_jax(worlds, name, tol):
    case = case_of("dm", name)
    want = jax_apply(case["family"], case["options"], case["inputs"], case["quant"])
    for r in range(4):  # every rank returns the whole batch
        got = worlds["dm"][name][r]["out"]
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=tol, atol=tol)
    census = collectives_by_axis(worlds["dm"][name][0]["census"])
    assert census["all-gather"]["data"] == 1  # the outputs' rows
    assert census["all-gather"]["model"] == 1  # the embedding (patch channels)
    layers = case["options"]["num_layers"]
    assert census["all-reduce"]["model"] == 2 * layers  # o and fc2 of every layer


def test_sharded_forward_w8a8_within_the_w8a8_limits(worlds):
    case = case_of("dm", "bert_w8a8")
    want = jax_apply(case["family"], case["options"], case["inputs"], "w8a8")["last_hidden_state"]
    got = worlds["dm"]["bert_w8a8"][0]["out"]["last_hidden_state"]
    # the limits of test_torch_models.py's single-device W8A8 BERT: a few
    # activations round to the neighbouring int8 level in one package
    assert np.abs(got - want).mean() / np.abs(want).mean() < 5e-4
    assert np.abs(got - want).max() < 5e-2
    census = collectives_by_axis(worlds["dm"]["bert_w8a8"][0]["census"])
    assert census["all-reduce-max"]["model"] == 2  # fc2's whole-row amax, a layer


@pytest.mark.parametrize("name", ["row_dense", "row_dense_w4a8"])
def test_row_parallel_w8a8_dense_keeps_the_single_device_s32_sums(worlds, name):
    """W8A8 (the s8 contraction) and W4A8 (K6 on the rank's rows with unit
    scales, the route the card takes): the integer sums and the outputs of
    every rank equal the single-device layer's bit for bit; against the
    JAX layer (packed int4 for W4A8) within f32 rounding."""
    for res in worlds["dm"][name]:
        np.testing.assert_array_equal(res["sums"], res["single_sums"])
        np.testing.assert_array_equal(res["out"], res["single_out"])
    case = case_of("dm", name)
    w = {"w_q": jnp.asarray(case["w_q"]), "scale": jnp.asarray(case["scale"]), "bits": 8}
    if case["bits"] == 4:
        from starpu_inference_server_tpu.ops.quant import pack_int4

        w = {"w_p4": pack_int4(w["w_q"]), "scale": w["scale"], "bits": 4}
    jnn.set_w8a8(True)
    try:
        want = np.asarray(jnn.dense({"w": w, "b": jnp.asarray(case["b"])},
                                    jnp.asarray(case["x"]), jnp.float32))
    finally:
        jnn.set_w8a8(False)
    np.testing.assert_allclose(worlds["dm"][name][0]["out"], want, rtol=1e-6, atol=1e-5)


def test_data_parallel_resnet(worlds):
    case = case_of("dm", "resnet")
    want = jax_apply("resnet18", RESNET, case["inputs"])["output"]
    got = worlds["dm"]["resnet"][0]["out"]["output"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).mean())
    census = collectives_by_axis(worlds["dm"]["resnet"][0]["census"])
    assert census == {"all-gather": {"data": 1}}  # the rows only


def test_data_parallel_w8a8_resnet_keeps_the_batch_wide_scale(worlds):
    """ResNet-18 W8A8 at data=2: each conv's per-tensor activation scale
    spans the whole batch (an all-reduce MAX over data), so every rank's
    logits equal the same model's on one device, bit for bit; against the
    JAX package within test_torch_models.py's W8A8 ResNet limit (2e-2 mean
    relative, the batch norm's rsqrt)."""
    case = case_of("dm", "resnet_w8a8")
    for res in worlds["dm"]["resnet_w8a8"]:
        np.testing.assert_array_equal(res["out"]["output"], res["single"]["output"])
    want = jax_apply("resnet18", RESNET, case["inputs"], "w8a8")["output"]
    got = worlds["dm"]["resnet_w8a8"][0]["out"]["output"]
    assert np.abs(got - want).mean() / np.abs(want).mean() < 2e-2
    assert (got.argmax(-1) == want.argmax(-1)).all()
    census = collectives_by_axis(worlds["dm"]["resnet_w8a8"][0]["census"])
    assert census["all-reduce-max"]["data"] == 20  # the s2d stem, 16 block convs, 3 downsamples


def test_engine_is_single_logical_executor(worlds):
    res = worlds["dm"]["runner"][0]
    assert res["num_devices"] == 1
    assert len(res["lanes"]) == 1 and "mesh" in res["lanes"][0]
    assert res["device_name"] == "mesh(data=2,model=2)"
    assert all(r is None for r in worlds["dm"]["runner"][1:])  # the followers


def test_mesh_pipeline_matches_unsharded_and_reloads(worlds):
    res = worlds["dm"]["runner"][0]
    seed = parse_config(bert_cfg()).seed  # the reload builds seed + 1
    for outputs, seed in ((res["first"], seed), (res["second"], seed + 1)):
        for req, got in zip(REQUESTS, outputs):
            want = jax_apply("bert-base-uncased", BERT, req, "int8", seed=seed)
            np.testing.assert_allclose(got["last_hidden_state"], want["last_hidden_state"],
                                       rtol=5e-4, atol=5e-4)
    assert not np.allclose(res["first"][0]["last_hidden_state"],
                           res["second"][0]["last_hidden_state"])


def test_bucket_granularity_respects_data_axis(worlds):
    res = worlds["dm"]["runner"][0]
    assert res["bucket_1"] == 2 and res["bucket_4"] == 4
    assert 1 not in res["buckets"]


def _pipe_reference(cfg):
    m = cfg["model"]
    return jax_apply(m["family"], m["options"], {"input_ids": PIPE_IDS}, m["quantization"],
                     seed=parse_config(cfg).seed)


@pytest.mark.parametrize("world,name", [("pipe2", "plain"), ("pipe2", "int8"),
                                        ("pipe2", "moe"), ("dpm", "composed")])
def test_pipelined_engine_matches_plain(worlds, world, name):
    case = case_of(world, name)
    res = worlds[world][name][0]
    assert res["pipelined"]
    np.testing.assert_allclose(res["outs"][0]["logits"], _pipe_reference(case["config"])["logits"],
                               rtol=5e-4, atol=5e-4)


def test_gspmd_serve_logits_matches_single_device_jax(worlds):
    """A decoder's serve_logits on the batch engine at data=2 x model=2
    (GSPMD mode: the batch over data, tensor parallelism over model)."""
    res = worlds["dm"]["serve_logits"][0]
    assert not res["pipelined"] and res["granularity"] == 2
    np.testing.assert_allclose(res["outs"][0]["logits"],
                               _pipe_reference(case_of("dm", "serve_logits")["config"])["logits"],
                               rtol=5e-4, atol=5e-4)


def test_bucket_granularity_includes_microbatches(worlds):
    res = worlds["dpm"]["granularity"][0]
    assert res["granularity"] == 4  # lcm(data=2, microbatches=4)
    assert res["bucket_1"] == 4
    np.testing.assert_allclose(res["outs"][0]["logits"],
                               _pipe_reference(case_of("dpm", "granularity")["config"])["logits"],
                               rtol=5e-4, atol=5e-4)


def test_pipe_axis_without_pipeline_apply_raises():
    raw = bert_cfg(data=1, model=1, quant="none")
    raw["devices"] = {"mesh": {"pipe": 2}}
    cfg = parse_config(raw)
    with pytest.raises(DeviceError, match="pipeline_apply"):
        ModelEngine(cfg, build_model(cfg.model, seed=cfg.seed, device="cpu"))


def test_mesh_config_without_rank_meshes_raises():
    cfg = parse_config(bert_cfg())
    with pytest.raises(ValueError, match="start it from the server CLI"):
        ModelEngine(cfg, build_model(cfg.model, seed=cfg.seed, device="cpu"))
