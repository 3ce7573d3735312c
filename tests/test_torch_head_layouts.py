"""Every attention head layout the JAX package serves, in the port, on the
CPU against the JAX package on the same numpy inputs:

- the eight decode-side kernels' and the two prefill kernels' plain
  versions (the functions their CUDA kernels are held to on the card) at
  q/kv ratios 16, 32 and 7 and head widths 80 (Phi-2), 96 (Phi-3-mini)
  and 256 (Gemma), against the JAX kernels in interpret mode at the JAX
  tests' tolerances (2e-3 decode, 2e-2 prefill);
- the wrappers' planning (``decode_split_plan``'s row groups and splits,
  the prefill check) at those shapes, and the shapes they still refuse;
- GSPMD meshes wider than the kv heads, in spawned worlds of CPU ranks
  (gloo): the JAX bring-up test's llama-tiny (2 kv heads) at data=2 x
  model=4 and MQA at model=4 and model=2, greedy streams equal to the JAX
  single-device engine's, and ``forward_logits`` against JAX's; kv heads
  are replicated, not split, and no collective is added for them (the
  shapes ``model`` cuts otherwise: ``tests/test_torch_gspmd_cut_heads.py``);
- encoders whose heads ``model`` does not divide (bert-base and
  vit_b_16, 12 heads, at model=8): every rank runs all heads on the
  gathered q/k/v, within the JAX package's mesh tolerances of the JAX
  one-device ``apply``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starpu_inference_server_tpu.models import build_model as jax_build
from starpu_inference_server_tpu.models import decoder as jdec
from starpu_inference_server_tpu.ops import decode_attention as jda
from starpu_inference_server_tpu.ops import prefill_attention as jpa
from starpu_inference_server_tpu.serving.generation import GenerationEngine as JaxEngine
from starpu_inference_server_tpu.serving.generation import GenerationRequest as JaxRequest
from starpu_inference_server_tpu.utils.config import ModelSettings as JSettings
from starpu_inference_server_tpu.utils.config import QuantMode as JQuant
from starpu_inference_server_tpu_torch.models.decoder import get_spec, init_params, local_heads
from starpu_inference_server_tpu_torch.ops import decode_attention as tda
from starpu_inference_server_tpu_torch.ops import prefill_attention as tpa
from starpu_inference_server_tpu_torch.parallel import tp_layout
from starpu_inference_server_tpu_torch.parallel.census import collectives_by_axis
from starpu_inference_server_tpu_torch.parallel.launch import run_world
from starpu_inference_server_tpu_torch.weights import rank_shard

# (rep, head_dim): the ratios above 8 and a ratio that divides no power of
# two at llama-1b's width, then the new widths at a small ratio
LAYOUTS = [(16, 64), (32, 64), (7, 64), (2, 80), (2, 96), (2, 256)]
PREFILL_LAYOUTS = [(7, 64), (16, 64), (2, 80), (2, 96), (2, 256)]
HKV = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _interpret(fn):
    jda.set_interpret(True)
    jpa.set_interpret(True)
    try:
        return np.asarray(fn())
    finally:
        jda.set_interpret(False)
        jpa.set_interpret(False)


def _cache(rng, s, t, d):
    k = rng.integers(-127, 128, (s, t, HKV, d)).astype(np.int8)
    v = rng.integers(-127, 128, (s, t, HKV, d)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, (s, t, HKV)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (s, t, HKV)).astype(np.float32)
    return k, v, ks, vs


def _flatten(k, v, ks, vs):
    """Standard [.., T, H, D] arrays -> the flat layout's."""
    return (k.reshape(k.shape[:-2] + (-1,)), v.reshape(v.shape[:-2] + (-1,)),
            np.swapaxes(ks, -1, -2).copy(), np.swapaxes(vs, -1, -2).copy())


def _dense_case(rep, d, w, seed, s=3, t=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((s, w, HKV * rep, d)).astype(np.float32)
    cache = _cache(rng, s, t, d)
    lengths = rng.integers(0, t - w + 1, (s,)).astype(np.int32)
    lengths[0], lengths[-1] = 0, t - w
    return q, cache, lengths


def _paged_case(rep, d, w, seed, s=3, page=16, pps=4):
    """A dense cache scattered into a shuffled pool (page 0 unused);
    slot 0's window crosses a page."""
    q, dense, lengths = _dense_case(rep, d, w, seed, s, page * pps)
    rng = np.random.default_rng(seed + 100)
    lengths[0] = page - 2
    n = s * pps + 1
    table = rng.permutation(np.arange(1, n)).reshape(s, pps).astype(np.int32)
    pool = [np.zeros((n, page) + a.shape[2:], a.dtype) for a in dense]
    for i in range(s):
        for j in range(pps):
            for dst, src in zip(pool, dense):
                dst[table[i, j]] = src[i, j * page:(j + 1) * page]
    return q, pool, table, lengths


# -- the decode-side kernels' plain versions (K3, K9, K10, K11, K12a-d) ------------

@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("rep,d", LAYOUTS)
def test_decode_attention_plain_matches_jax_kernel(rep, d, flat):
    q, cache, lengths = _dense_case(rep, d, 1, seed=rep * d)
    if flat:
        cache = _flatten(*cache)
    want = _interpret(lambda: jda.decode_attention(
        jnp.asarray(q[:, 0]), *(jnp.asarray(a) for a in cache), jnp.asarray(lengths), rep=rep,
        chunk=64))
    got = tda.decode_attention(_t(q[:, 0]), *(_t(a) for a in cache), _t(lengths), rep)
    # the JAX package's own tolerance (tests/unit/test_decode_attention.py)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("rep,d", LAYOUTS)
def test_window_decode_attention_plain_matches_jax_kernel(rep, d, flat):
    q, cache, lengths = _dense_case(rep, d, 5, seed=rep * d + 5)
    if flat:
        cache = _flatten(*cache)
    want = _interpret(lambda: jda.window_decode_attention(
        jnp.asarray(q), *(jnp.asarray(a) for a in cache), jnp.asarray(lengths), rep=rep,
        chunk=64, out_dtype=jnp.float32))
    got = tda.window_decode_attention(_t(q), *(_t(a) for a in cache), _t(lengths), rep)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("rep,d", LAYOUTS)
def test_paged_attention_plain_matches_jax_kernel(rep, d, w, flat):
    q, pool, table, lengths = _paged_case(rep, d, w, seed=rep * d + w)
    if flat:
        pool = _flatten(*pool)
    if w == 1:
        q = q[:, 0]
        jfn, tfn = jda.paged_decode_attention, tda.paged_decode_attention
    else:
        jfn, tfn = jda.paged_window_decode_attention, tda.paged_window_decode_attention
    want = _interpret(lambda: jfn(jnp.asarray(q), *(jnp.asarray(a) for a in pool),
                                  jnp.asarray(table), jnp.asarray(lengths), rep=rep,
                                  out_dtype=jnp.float32))
    got = tfn(_t(q), *(_t(a) for a in pool), _t(table), _t(lengths), rep)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


# -- the prefill kernels' plain versions (K5, K4) ---------------------------------

@pytest.mark.parametrize("rep,d", PREFILL_LAYOUTS)
def test_causal_attention_plain_matches_jax_kernel(rep, d):
    rng = np.random.default_rng(rep * d)
    t = 128
    q = rng.standard_normal((1, t, HKV * rep, d)).astype(np.float32)
    k = rng.standard_normal((1, t, HKV, d)).astype(np.float32)
    v = rng.standard_normal((1, t, HKV, d)).astype(np.float32)
    want = _interpret(lambda: jpa.causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), rep=rep, tq=64, chunk=64,
        out_dtype=jnp.float32))
    got = tpa.causal_attention(_t(q), _t(k), _t(v), rep=rep, out_dtype=torch.float32)
    # the JAX package's prefill-kernel tolerance (tests/unit/test_pallas_kernels.py)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("start", [0, 96])
@pytest.mark.parametrize("rep,d", PREFILL_LAYOUTS)
def test_chunk_prefill_attention_plain_matches_jax_kernel(rep, d, start):
    rng = np.random.default_rng(rep * d + start)
    t, c = 256, 64
    k, v, ks, vs = (a[0] for a in _cache(rng, 1, t, d))
    args = [rng.standard_normal((c, HKV * rep, d)).astype(np.float32), k, v, ks, vs,
            rng.standard_normal((c, HKV, d)).astype(np.float32),
            rng.standard_normal((c, HKV, d)).astype(np.float32)]
    want = _interpret(lambda: jpa.chunk_prefill_attention(
        *(jnp.asarray(a) for a in args), jnp.int32(start), rep=rep, chunk=64,
        out_dtype=jnp.float32))
    got = tpa.chunk_prefill_attention(*(_t(a) for a in args), start, rep=rep,
                                      out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


# -- the wrappers' planning, without a card ----------------------------------------

@pytest.mark.parametrize("w", [1, 5, 9])
@pytest.mark.parametrize("rep,d", LAYOUTS + [(71, 64), (4, 256), (1, 256)])
def test_split_plan_takes_every_ratio_and_width(rep, d, w):
    """Row groups of at most 16 * (256 // D) rows, as even as whole rows
    allow, none empty; one plan a shape (no lengths), whose workspace holds
    every row of every (KV head, slot) of each split, whatever the groups."""
    rows = w * rep
    group = tda.decode_group_rows(rows, d)
    groups = math.ceil(rows / group)
    assert 1 <= group <= 16 * (256 // d)
    assert (groups - 1) * group < rows <= groups * group
    assert groups == math.ceil(rows / (16 * (256 // d)))
    for s in (1, 16, 128):
        plan = tda.decode_split_plan(s, HKV, 1024, w, rep, d)
        assert 1 <= plan.splits <= 1024 // tda.DECODE_TILE
        assert plan.workspace == (plan.splits * s * HKV * rows * (d + 2)
                                  if plan.splits > 1 else 0)
        if s * HKV * groups >= tda.DECODE_FILL * tda.H100_SMS:
            assert plan.splits == 1


@pytest.mark.parametrize("rep,d", LAYOUTS + [(71, 64), (8, 64), (8, 128), (1, 256)])
def test_f32_decode_groups_fit_the_f32_body(rep, d):
    """The f32 decode body (K3 and K12a's FP32 witnesses) takes at most 8
    heads and 1024 outputs a block: its groups, as even as whole heads
    allow, never exceed that, and rep <= 8 at D <= 128 stays one group."""
    group = tda.decode_group_rows(rep, d, f32_heads=True)
    groups = math.ceil(rep / group)
    assert 1 <= group <= min(8, 1024 // d)
    assert (groups - 1) * group < rep <= groups * group
    assert groups == math.ceil(rep / min(8, 1024 // d))
    if rep <= 8 and d <= 128:
        assert group == rep


def test_split_plan_keeps_one_group_where_the_rows_fit():
    """Every shape the kernels took before row groups is one group, so its
    grid and bits are unchanged: W * rep * D <= 4096 at D <= 128."""
    for d in (32, 64, 128):
        for rows in range(1, 4096 // d + 1):
            assert tda.decode_group_rows(rows, d) == rows


@pytest.mark.parametrize("rep,d", PREFILL_LAYOUTS + [(71, 128), (5, 128)])
def test_prefill_check_takes_every_ratio_and_width(rep, d):
    for dtype in (torch.float32, torch.bfloat16):
        tpa.check_kernel_args(dtype, rep, d, "causal_attention")


def test_a_shape_no_kernel_takes_raises_instead_of_running_the_plain_version():
    """The wrappers' checks run before any launch: a head dim that no body
    is built for raises there, on any device (the CPU tensors here would
    otherwise take the plain version)."""
    q = torch.zeros((2, 4, 48), dtype=torch.bfloat16)
    cache = (torch.zeros((2, 64, 2, 48), dtype=torch.int8),) * 2 + (torch.ones((2, 64, 2)),) * 2
    with pytest.raises(ValueError, match="D in"):
        tda._decode_launch("decode_attention", q, cache, torch.zeros(2), 64, 2, 2, None)
    with pytest.raises(ValueError, match="D in"):
        tda.decode_split_plan(2, 2, 64, 1, 2, 48)
    for what, dims in (("causal_attention", tpa.PREFILL_HEAD_DIMS),
                       ("bidirectional_attention", tpa.ENCODER_HEAD_DIMS)):
        with pytest.raises(ValueError, match="D in"):
            tpa.check_kernel_args(torch.bfloat16, 2, 48, what, dims)
    with pytest.raises(ValueError, match="rep >= 1"):
        tpa.check_kernel_args(torch.bfloat16, 0, 64, "causal_attention")


# -- GSPMD decoders with model above the kv heads -----------------------------------

# the JAX bring-up test's llama-tiny (tests/integration/test_distributed_bringup.py:489)
SPEC = {"layers": 2, "hidden": 128, "q_heads": 4, "kv_heads": 2, "intermediate": 256,
        "vocab": 128}
MQA = dict(SPEC, kv_heads=1)
PROMPTS = [[3, 7, 11], [5, 2], [9, 1, 4]]
ENGINE = dict(num_slots=4, max_len=64, prefill_buckets=[8], steps_per_sync=2)
MAX_NEW = 6
IDS = np.tile(np.arange(1, 9, dtype=np.int64), (4, 1))


def _gen(name, opts):
    return {"name": name, "kind": "generate", "family": "llama-tiny", "opts": opts, "seed": 0,
            "prompts": PROMPTS, "engine": ENGINE, "quant": None, "max_new": MAX_NEW,
            "draft": None}


def _forward(name, family, options, inputs):
    return {"name": name, "kind": "forward", "family": family, "options": options,
            "quant": "none", "inputs": inputs}


BERT = {"num_layers": 1, "seq_len": 8, "vocab_size": 256}
VIT = {"num_layers": 1, "image_size": 32, "num_classes": 10}
_rng = np.random.default_rng(11)
BERT_INPUTS = {"input_ids": _rng.integers(0, 256, (2, 8)).astype(np.int64),
               "attention_mask": np.array([[1] * 8, [1] * 5 + [0] * 3], np.int64)}
VIT_INPUTS = {"input": _rng.standard_normal((2, 3, 32, 32)).astype(np.float32)}

WORLDS = {
    "dm4": ({"data": 2, "model": 4}, 8, [
        _gen("jax_spec", SPEC),
        _gen("mqa", MQA),
        _forward("logits", "llama-tiny", dict(SPEC, seq_len=8), {"input_ids": IDS}),
        _forward("mqa_logits", "llama-tiny", dict(MQA, seq_len=8), {"input_ids": IDS}),
    ]),
    "m2": ({"model": 2}, 2, [_gen("mqa", MQA)]),
    "m8": ({"model": 8}, 8, [
        _forward("bert", "bert-base-uncased", BERT, BERT_INPUTS),
        _forward("vit", "vit_b_16", VIT, VIT_INPUTS),
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


def jax_tokens(opts):
    spec = jdec.get_spec("llama-tiny", opts)
    params = jdec.init_params(spec, np.random.default_rng(0))
    eng = JaxEngine(spec, params, dtype=jnp.float32, family="llama-tiny", **ENGINE)
    eng.start()
    try:
        reqs = [JaxRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=MAX_NEW)
                for p in PROMPTS]
        for r in reqs:
            eng.submit(r)
        return [r.result(timeout=180) for r in reqs]
    finally:
        eng.stop()


@pytest.mark.parametrize("world,name,opts", [("dm4", "jax_spec", SPEC), ("dm4", "mqa", MQA),
                                             ("m2", "mqa", MQA)])
def test_streams_with_replicated_kv_heads_equal_jax(worlds, world, name, opts):
    """JAX ``:460-504``: the greedy streams of the GSPMD engine equal the
    JAX single-device engine's. Every layer's collectives are those of a
    mesh that splits whole kv heads (o and down summed over ``model``):
    the ranks sharing a kv head compute its K and V alike, with no
    collective of their own."""
    res = worlds[world][name][0]
    assert res["tokens"] == jax_tokens(opts)
    model = WORLDS[world][0]["model"]
    for stats in res["stats"]:
        census = collectives_by_axis(stats["collectives"])
        assert set(census) <= {"all-reduce", "all-gather", "broadcast"}
        assert set(census["all-reduce"]) == {"model"}
        assert census["all-reduce"]["model"] % (2 * SPEC["layers"]) == 0
    assert len(res["stats"]) == WORLDS[world][1]
    assert model > opts["kv_heads"]


@pytest.mark.parametrize("name,opts", [("logits", SPEC), ("mqa_logits", MQA)])
def test_forward_logits_with_replicated_kv_heads_matches_jax(worlds, name, opts):
    """``forward_logits`` (the family's ``apply`` on a mesh) at model=4 over
    2 and 1 kv heads, within the JAX package's 2e-4 of FP32 mesh forwards
    (``test_torch_mesh_engine.py``) of the JAX one-device forward."""
    spec = jdec.get_spec("llama-tiny", opts)
    params = jdec.init_params(spec, np.random.default_rng(0))
    want = np.asarray(jdec.forward_logits(spec, params, jnp.asarray(IDS.astype(np.int32)),
                                          jnp.float32))
    for got in worlds["dm4"][name]:
        np.testing.assert_allclose(got["out"]["logits"], want, rtol=2e-4, atol=2e-4)


def test_rank_heads_and_shards_replicate_the_kv_heads():
    """Rank r of model=4 over 2 kv heads holds q head r and kv head r // 2:
    its qkv shard is exactly those columns of the whole projection."""
    class Model:  # a rank mesh's model size
        def __init__(self, n):
            self.n = n

        def size(self, axis):
            return self.n if axis == "model" else 1

    spec = get_spec("llama-tiny", SPEC)
    d = spec.head_dim
    assert local_heads(spec, Model(4)) == (1, 1)
    assert local_heads(spec, Model(2)) == (2, 1)
    assert local_heads(get_spec("llama-tiny", MQA), Model(4)) == (1, 1)
    w = np.arange(spec.hidden * (spec.q_heads + 2 * spec.kv_heads) * d, dtype=np.float32)
    layer = {"attn_norm": {}, "mlp_norm": {},
             "attn": {"qkv": {"w": w.reshape(spec.hidden, -1)}, "o": {"w": np.zeros(1)}},
             "mlp": {"gate_up": {"w": np.zeros((1, 2 * spec.intermediate))},
                     "down": {"w": np.zeros(1)}}}
    cols = tp_layout.gspmd_decoder_layer_for_tp(spec, layer, 4)["attn"]["qkv"]["w"][0]
    k0, v0 = spec.q_heads * d, (spec.q_heads + spec.kv_heads) * d
    for r in range(4):
        shard = cols[r * 3 * d:(r + 1) * 3 * d]
        want = np.concatenate([np.arange(r * d, (r + 1) * d), k0 + (r // 2) * d + np.arange(d),
                               v0 + (r // 2) * d + np.arange(d)])
        np.testing.assert_array_equal(shard, want)


def test_pipe_mode_keeps_the_jax_head_check():
    """Pipe mode's stage programs, like JAX's (``parallel/pipeline_decode.py``),
    split whole kv heads: model above them stays refused there."""
    with pytest.raises(ValueError, match="must divide"):
        tp_layout.validate_decoder_tp(get_spec("llama-tiny", SPEC), 4)


@pytest.mark.parametrize("pipe", [1, 2])
def test_the_layer_hook_follows_the_mesh_mode(pipe):
    """``weights.rank_shard`` hands the decoder's layer hook the mesh's
    mode: at model=4 over 2 kv heads a pipe-mode stage refuses, as
    ``validate_decoder_tp``, and GSPMD mode replicates the kv heads (the
    rank's qkv columns hold its 1 q head and one whole kv head's K and V)."""
    spec = get_spec("llama-tiny", SPEC)
    tree = init_params(spec, np.random.default_rng(0))
    sizes = {"pipe": pipe, "data": 1, "expert": 1, "model": 4}
    coords = {"pipe": 0, "data": 0, "expert": 0, "model": 1}
    if pipe > 1:
        with pytest.raises(ValueError, match="must divide"):
            rank_shard(tree, spec, "llama-tiny", coords, sizes)
        return
    shard = rank_shard(tree, spec, "llama-tiny", coords, sizes)
    d = spec.head_dim
    assert shard["layers"][0]["attn"]["qkv"]["w"].shape == (spec.hidden, 3 * d)


# -- encoders whose heads model does not divide -----------------------------------------

def _jax_apply(family, options, inputs):
    model = jax_build(JSettings(family=family, compute_dtype="FP32", quantization=JQuant("none"),
                                options=options), seed=0)
    out = model.apply({k: jnp.asarray(v) for k, v in inputs.items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name,family,options,inputs,tol", [
    ("bert", "bert-base-uncased", BERT, BERT_INPUTS, 2e-4),
    ("vit", "vit_b_16", VIT, VIT_INPUTS, 1e-4),
])
def test_encoder_heads_model_does_not_divide_match_jax(worlds, name, family, options, inputs,
                                                       tol):
    """12 heads at model=8: the q/k/v shards (96 columns) cut heads, so
    every rank gathers them, runs all 12 heads and keeps its columns for
    the row-parallel o; within the JAX package's FP32 mesh tolerances
    (``test_torch_mesh_engine.py``: 2e-4 BERT, 1e-4 ViT) of the JAX
    one-device apply."""
    want = _jax_apply(family, options, inputs)
    for got in worlds["m8"][name]:
        for key, w in want.items():
            np.testing.assert_allclose(got["out"][key], w, rtol=tol, atol=tol)
    census = collectives_by_axis(worlds["m8"][name][0]["census"])
    assert census["all-gather"]["model"] == 1 + 3 * options["num_layers"]  # embedding; q, k, v
    assert census["all-reduce"]["model"] == 2 * options["num_layers"]  # o and fc2
