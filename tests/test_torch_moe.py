"""The port's MoE decoders against the JAX package's, on the CPU.

moe-tiny at the JAX package's own test size (tests/unit/test_moe.py:
2 layers, hidden 128, 4/2 heads, intermediate 256, vocab 128, 4 experts,
top-2): the same parameter tree from the same seed, the routed MLP in
its dense-dispatch form (router, f32 softmax, top-k in ``jax.lax.top_k``'s
order, renormalised one-hot combine, two stacked-expert contractions with
f32 results), ``forward_logits`` and the decode step, quantized expert
stacks (scales [E, 1, out]; int4 experts stay unpacked), and greedy
streams of the port's engine equal to the JAX engine's, dense and paged,
standard and flat, at pipeline depth 1 and 4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starpu_inference_server_tpu.models import decoder as jd
from starpu_inference_server_tpu.ops import nn as jnn
from starpu_inference_server_tpu.ops import quant as jq
from starpu_inference_server_tpu.serving import generation as jgen
from starpu_inference_server_tpu_torch.models import decoder as td
from starpu_inference_server_tpu_torch.ops import nn as tnn
from starpu_inference_server_tpu_torch.ops import quant as tq
from starpu_inference_server_tpu_torch.serving import generation as tgen
from starpu_inference_server_tpu_torch.weights import params_from_numpy

OPTS = {"layers": 2, "hidden": 128, "q_heads": 4, "kv_heads": 2, "intermediate": 256,
        "vocab": 128, "num_experts": 4}


@pytest.fixture(scope="module")
def moe():
    spec = jd.get_spec("moe-tiny", OPTS)
    return spec, td.get_spec("moe-tiny", OPTS), jd.init_params(spec, np.random.default_rng(0))


@pytest.fixture(autouse=True)
def plain_routes():
    tnn.set_use_kernels(False)
    yield
    tnn.set_use_kernels(None)
    jnn.set_use_pallas(False)


def _tree(params, bits):
    return jax.tree.map(np.asarray, jq.maybe_quantize_tree(params, bits) if bits else params)


def test_param_trees_are_equal(moe):
    jspec, tspec, want = moe
    assert tspec.is_moe and tspec.num_experts == 4 and tspec.experts_per_token == 2
    got = td.init_params(tspec, np.random.default_rng(0))
    flat_want, tree_want = jax.tree.flatten(want)
    flat_got, tree_got = jax.tree.flatten(got)
    assert tree_got == tree_want
    assert all(np.array_equal(a, b) for a, b in zip(flat_got, flat_want))
    mlp = got["layers"][0]["mlp"]
    assert mlp["router"]["w"].shape == (128, 4)
    assert mlp["experts"]["gate_up"]["w"].shape == (4, 128, 512)
    assert mlp["experts"]["down"]["w"].shape == (4, 256, 128)


def test_registered_moe_variants_and_the_experts_check():
    for name, experts in (("moe-tiny", 4), ("moe-8x1b", 8), ("mixtral-8x7b", 8)):
        want, got = jd.get_spec(name, {}), td.get_spec(name, {})
        assert (got.hidden, got.layers, got.intermediate, got.num_experts) == \
            (want.hidden, want.layers, want.intermediate, experts)
    with pytest.raises(ValueError, match="cannot exceed num_experts"):
        td.get_spec("moe-tiny", {"experts_per_token": 5})


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_mlp_matches_jax(moe, dtype):
    """FP32: the contractions sum in another order (limit 1e-5 against
    outputs of mean magnitude 0.33, read 8e-7). BF16: both round the
    operands to bf16, keep the contractions' results in f32 and round once
    at the end: equal here (limit one bf16 ulp, 2^-8 relative)."""
    jspec, tspec, params = moe
    x = np.random.default_rng(1).standard_normal((5, 128)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    layer = params["layers"][0]
    want = np.asarray(jd._moe_mlp(jspec, layer, jnp.asarray(x).astype(jdt), jdt)
                      .astype(jnp.float32))
    got = td._moe_mlp(tspec, params_from_numpy(layer), torch.from_numpy(x).to(tdt),
                      tdt).float().numpy()
    tol = 1e-5 if dtype == "f32" else 2 ** -8
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_top_k_order_matches_jax_on_ties():
    """Ties at and inside the top-k boundary: ``jax.lax.top_k`` keeps the
    lower index first; the port's ranks pick the same experts in the same
    order, and the combine weights are equal."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.2, 0.3, 0.2],
                      [0.2, 0.3, 0.2, 0.3],
                      [0.0, 0.5, 0.0, 0.5],
                      [0.7, 0.1, 0.1, 0.1]], np.float32)
    vals, idx = jax.lax.top_k(jnp.asarray(probs), 2)
    ranks = td._top_k_ranks(torch.from_numpy(probs)).numpy()
    for t in range(len(probs)):
        order = [int(np.flatnonzero(ranks[t] == r)[0]) for r in range(4)]
        assert order[:2] == np.asarray(idx[t]).tolist()
        assert sorted(ranks[t].tolist()) == [0, 1, 2, 3]
    np.testing.assert_array_equal(np.take_along_axis(probs, np.asarray(idx), 1),
                                  np.asarray(vals))


def test_moe_mlp_with_tied_router_matches_jax():
    """A router whose logits tie for every token (a zero router weight:
    uniform probabilities) and one whose two columns are equal: the same
    experts are combined with the same weights as in the JAX package."""
    spec_j = jd.get_spec("moe-tiny", OPTS)
    spec_t = td.get_spec("moe-tiny", OPTS)
    layer = jd.init_params(spec_j, np.random.default_rng(3))["layers"][0]
    x = np.random.default_rng(4).standard_normal((6, 128)).astype(np.float32)
    for make in (lambda w: np.zeros_like(w), lambda w: w[:, [0, 0, 2, 2]].copy()):
        tied = dict(layer, mlp=dict(layer["mlp"], router={"w": make(layer["mlp"]["router"]["w"])}))
        want = np.asarray(jd._moe_mlp(spec_j, tied, jnp.asarray(x), jnp.float32))
        got = td._moe_mlp(spec_t, params_from_numpy(tied), torch.from_numpy(x),
                          torch.float32).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["fp32", "int8", "int4"])
def test_forward_and_decode_logits_match_jax(moe, bits):
    """forward_logits over a [2, 8] batch, then a prompt prefilled into a
    slot and three decode steps through the int8 KV cache: logits within
    1e-4 of JAX's (f32 sums in another order; read below 3e-6)."""
    jspec, tspec, params = moe
    tree = _tree(params, bits)
    tparams = params_from_numpy(tree)
    ids = np.random.default_rng(3).integers(0, 128, (2, 8))
    want = np.asarray(jd.forward_logits(jspec, tree, jnp.asarray(ids, jnp.int32), jnp.float32))
    got = td.forward_logits(tspec, tparams, torch.from_numpy(ids), torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    prompt = np.random.default_rng(5).integers(0, 128, 8).astype(np.int32)
    jcache = jd.init_cache(jspec, 2, 32)
    jcache, jl = jd.prefill(jspec, tree, jcache, jnp.asarray(prompt), 8, 0, jnp.float32)
    tcache = td.init_cache(tspec, 2, 32)
    tcache, tl = td.prefill(tspec, tparams, tcache, torch.from_numpy(prompt), 8, 0, torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    active = np.array([True, False])
    cur = np.array([int(np.argmax(np.asarray(jl))), 0], np.int32)
    for _ in range(3):
        jcache, jl = jd.decode_step(jspec, tree, jcache, jnp.asarray(cur), jnp.asarray(active),
                                    jnp.float32)
        tcache, tl = td.decode_step(tspec, tparams, tcache, torch.from_numpy(cur),
                                    torch.from_numpy(active), torch.float32)
        np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0], rtol=1e-4, atol=1e-4)
        cur = np.array([int(np.argmax(np.asarray(jl)[0])), 0], np.int32)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_expert_stacks_keep_per_expert_scales(moe, bits):
    """Stacked experts quantize over the contraction axis only (scale
    [E, 1, out]) in both packages, with equal bits; ``dequantize``
    broadcasts that scale; ``pack_int4_tree`` packs the rank-2 router and
    leaves the rank-3 int4 stacks unpacked, so they reach
    ``resolve_weight`` as in the JAX package."""
    _, _, params = moe
    want = _tree(params, bits)
    got = tq.maybe_quantize_tree(params_from_numpy(params), bits)
    for name in ("gate_up", "down"):
        wl = want["layers"][0]["mlp"]["experts"][name]["w"]
        gl = got["layers"][0]["mlp"]["experts"][name]["w"]
        assert gl["scale"].shape == (4, 1, wl["w_q"].shape[-1]) == wl["scale"].shape
        np.testing.assert_array_equal(gl["w_q"].numpy(), wl["w_q"])
        np.testing.assert_array_equal(gl["scale"].numpy(), wl["scale"])
        np.testing.assert_array_equal(
            tnn.resolve_weight(gl, torch.float32).numpy(),
            np.asarray(jnn.resolve_weight(wl, jnp.float32)))
    packed = tq.pack_int4_tree(got)
    mlp = packed["layers"][0]["mlp"]
    assert ("w_p4" in mlp["router"]["w"]) == (bits == 4)
    assert "w_q" in mlp["experts"]["gate_up"]["w"] and "w_q" in mlp["experts"]["down"]["w"]


LAYOUTS = {
    "dense": dict(),
    "dense_flat": dict(kv_cache_layout="flat"),
    "paged": dict(kv_page_size=8),
    "paged_flat": dict(kv_page_size=8, kv_cache_layout="flat"),
}
ENGINE_KW = dict(num_slots=2, max_len=96, prefill_buckets=[8, 16], steps_per_sync=3,
                 prefill_chunk=16)


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX engine's streams by layout, served once for both depths."""
    return {}


def _prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(0, 128, n).astype(np.int32) for n in (5, 30, 12, 7)]


def _serve(eng, make_request):
    reqs = [make_request(prompt_ids=p, max_new_tokens=10) for p in _prompts()]
    for r in reqs:  # queued before the loop starts: one admission order
        eng.submit(r)
    eng.start()
    try:
        return [r.result(timeout=180) for r in reqs]
    finally:
        eng.stop()


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_streams_equal_the_jax_engine(moe, jax_streams, layout, depth):
    """Four greedy requests on two slots (the 30-token prompt chunked, slots
    released and re-admitted) at FP32 with int8 weights: the port's streams
    equal the JAX engine's token for token."""
    jspec, tspec, params = moe
    tree = _tree(params, 8)
    kw = dict(ENGINE_KW, **LAYOUTS[layout])
    if layout not in jax_streams:
        jax_streams[layout] = _serve(jgen.GenerationEngine(jspec, tree, dtype=jnp.float32, **kw),
                                     jgen.GenerationRequest)
    eng = tgen.GenerationEngine(tspec, tree, dtype=torch.float32, device="cpu",
                                decode_overlap=depth > 1, pipeline_depth=depth, **kw)
    got = _serve(eng, tgen.GenerationRequest)
    assert got == jax_streams[layout]
    assert all(len(s) == 10 for s in got)
