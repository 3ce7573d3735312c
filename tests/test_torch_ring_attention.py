"""Sequence parallelism (``parallel/ring_attention.py``) in spawned worlds
of four CPU ranks (gloo), the counterparts of the JAX
``test_ring_attention.py``: the ring-rotated causal attention at n = 2
(data=2 x model=2; the model ranks of a data group hold the same blocks)
and n = 4 against the full numpy attention (2e-5, the JAX test's), and
the sequence-sharded decoder forward at tp 1 (sp4) and tp 2 (sp2 x tp2),
FP32 and int8, against the JAX single-device ``forward_logits`` (5e-4,
the JAX test's)."""

import jax.numpy as jnp
import numpy as np
import pytest

from starpu_inference_server_tpu.models.decoder import forward_logits, get_spec, init_params
from starpu_inference_server_tpu_torch.parallel.census import collectives_by_axis
from starpu_inference_server_tpu_torch.parallel.launch import run_world

TINY = {"layers": 2, "hidden": 64, "q_heads": 4, "kv_heads": 2, "intermediate": 96,
        "vocab": 128}
B, T, HKV, REP, D = 2, 32, 2, 2, 16
_rng = np.random.default_rng(0)
QKV = {"q": _rng.standard_normal((B, T, HKV * REP, D)).astype(np.float32),
       "k": _rng.standard_normal((B, T, HKV, D)).astype(np.float32),
       "v": _rng.standard_normal((B, T, HKV, D)).astype(np.float32)}


def ring_case():
    return dict(QKV, name="ring", kind="ring", axis="data", rep=REP)


def seqpar_case(name, seed, ids_seed, shape, quant=None):
    ids = np.random.default_rng(ids_seed).integers(0, 128, shape).astype(np.int32)
    return {"name": name, "kind": "seqpar", "family": "llama-tiny", "opts": TINY,
            "seed": seed, "ids": ids, "quant": quant}


WORLDS = {
    "sp2xtp2": ({"data": 2, "model": 2}, [
        ring_case(),
        seqpar_case("fp32", 1, 2, (2, 16)),
        seqpar_case("int8", 3, 4, (1, 8), quant=8),
    ]),
    "sp4": ({"data": 4}, [
        ring_case(),
        seqpar_case("fp32", 1, 2, (2, 16)),
        seqpar_case("int8", 3, 4, (1, 8), quant=8),
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


def full_attention():
    q, k, v = QKV["q"], QKV["k"], QKV["v"]
    kf = np.repeat(k, REP, axis=2)
    vf = np.repeat(v, REP, axis=2)
    logits = np.einsum("bqhd,bkhd->bhqk", q, kf) / np.sqrt(D)
    causal = np.tril(np.ones((T, T), bool))[None, None]
    logits = np.where(causal, logits, -1e30)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", probs, vf)


@pytest.mark.parametrize("world", ["sp2xtp2", "sp4"])
def test_ring_causal_attention_matches_full(worlds, world):
    want = full_attention()
    for res in worlds[world]["ring"]:
        np.testing.assert_allclose(res["out"], want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("world", ["sp2xtp2", "sp4"])
@pytest.mark.parametrize("name", ["fp32", "int8"])
def test_sequence_parallel_forward_matches(worlds, world, name):
    case = next(c for c in WORLDS[world][1] if c["name"] == name)
    spec = get_spec("llama-tiny", TINY)
    params = init_params(spec, np.random.default_rng(case["seed"]))
    if case["quant"]:
        from starpu_inference_server_tpu.ops.quant import maybe_quantize_tree

        params = maybe_quantize_tree(params, case["quant"])
    want = np.asarray(forward_logits(spec, params, jnp.asarray(case["ids"]), jnp.float32))
    for res in worlds[world][name]:
        np.testing.assert_allclose(res["logits"], want, rtol=5e-4, atol=5e-4)
    census = collectives_by_axis(worlds[world][name][0]["census"])
    n = WORLDS[world][0]["data"]
    # K and V go once round the ring in every layer: n hops each
    assert census["collective-permute"]["data"] == 2 * n * TINY["layers"]
    if world == "sp2xtp2":
        assert census["all-reduce"]["model"] == 2 * TINY["layers"]  # o and down
