"""The port's decoder vs the JAX package's, on the same weights.

One int4 parameter tree is made with the JAX package's own init and
quantization and handed to the port through ``params_from_numpy``; the
same prompt then goes through ``prefill`` (p = 256, the causal-kernel
bucket), ``prefill_chunk`` at start > 0 (max_len 512 opens the chunk
kernel's gate) and several ``decode_step``s in both packages, with the
kernel routes off and on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starpu_inference_server_tpu.models import decoder as jd
from starpu_inference_server_tpu.ops import decode_attention as jda
from starpu_inference_server_tpu.ops import nn as jnn
from starpu_inference_server_tpu.ops import pallas_kernels as jpk
from starpu_inference_server_tpu.ops import prefill_attention as jpa
from starpu_inference_server_tpu.ops import quant as jq
from starpu_inference_server_tpu_torch.models import decoder as td
from starpu_inference_server_tpu_torch.ops import nn as tnn
from starpu_inference_server_tpu_torch.weights import params_from_numpy

OPTS = {"layers": 2, "hidden": 256, "q_heads": 4, "kv_heads": 2,
        "intermediate": 512, "vocab": 512}
MAX_LEN = 512


@pytest.fixture(scope="module")
def weights():
    spec = jd.get_spec("llama-tiny", OPTS)
    raw = jd.init_params(spec, np.random.default_rng(0))
    unpacked = jax.tree.map(np.asarray, jq.maybe_quantize_tree(raw, 4))
    packed = jax.tree.map(np.asarray, jq.pack_int4_tree(unpacked))
    return spec, td.get_spec("llama-tiny", OPTS), unpacked, packed


@pytest.fixture
def kernels(request):
    on = request.param
    jnn.set_use_pallas(on)
    tnn.set_use_kernels(on)
    for mod in (jpk, jda, jpa):
        mod.set_interpret(on)
    yield on
    jnn.set_use_pallas(False)
    tnn.set_use_kernels(None)
    for mod in (jpk, jda, jpa):
        mod.set_interpret(False)


def test_spec_and_init_params_match(weights):
    jspec, tspec, _, _ = weights
    assert (tspec.hidden, tspec.layers, tspec.q_heads, tspec.kv_heads, tspec.intermediate,
            tspec.vocab, tspec.head_dim) == (jspec.hidden, jspec.layers, jspec.q_heads,
                                             jspec.kv_heads, jspec.intermediate,
                                             jspec.vocab, jspec.head_dim)
    a = jd.init_params(jspec, np.random.default_rng(5))
    b = td.init_params(tspec, np.random.default_rng(5))
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_rope_and_rms_norm_match():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    want = np.asarray(jd.rope(jnp.asarray(x), jnp.asarray(pos)))
    got = td.rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    # f32 pow / sin / cos of the two libraries differ in the last ulp
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    gamma = rng.standard_normal((64,)).astype(np.float32)
    want = np.asarray(jd.rms_norm({"gamma": jnp.asarray(gamma)}, jnp.asarray(x)))
    got = td.rms_norm({"gamma": torch.from_numpy(gamma)}, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    kq_j, ks_j = jd._quantize_kv(jnp.asarray(x))
    kq_t, ks_t = td._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(kq_t.numpy(), np.asarray(kq_j))
    np.testing.assert_array_equal(ks_t.numpy(), np.asarray(ks_j))


# kernels off: both packages run the jnp-style attention; the residual
# difference is f32 summation order, which can move one int8 KV step.
# kernels on: the int4 kernels round activations to bf16, so a sub-ulp
# difference between the libraries can flip one bf16 rounding (2^-8
# relative) of an element; the logits then differ by up to ~1e-2.
TOL = {False: 5e-3, True: 5e-2}


@pytest.mark.parametrize("kernels", [False, True], indirect=True)
def test_prefill_chunk_decode_logits_match_jax(weights, kernels):
    jspec, tspec, unpacked, packed = weights
    tree = packed if kernels else unpacked
    tparams = params_from_numpy(tree)
    rng = np.random.default_rng(2)
    jc = jd.init_cache(jspec, 2, MAX_LEN)
    tc = td.init_cache(tspec, 2, MAX_LEN)

    ids = rng.integers(0, 512, 256).astype(np.int32)
    jc, jl = jd.prefill(jspec, tree, jc, jnp.asarray(ids), jnp.int32(200), jnp.int32(0),
                        jnp.float32)
    tc, tl = td.prefill(tspec, tparams, tc, torch.from_numpy(ids), 200, 0, torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL[kernels], rtol=0)

    chunk = rng.integers(0, 512, 128).astype(np.int32)
    for start, valid in ((0, 128), (128, 128), (256, 100)):
        jc, jl = jd.prefill_chunk(jspec, tree, jc, jnp.asarray(chunk), jnp.int32(start),
                                  jnp.int32(valid), jnp.int32(1), jnp.float32)
        tc, tl = td.prefill_chunk(tspec, tparams, tc, torch.from_numpy(chunk), start, valid,
                                  1, torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL[kernels], rtol=0)

    cur = np.array([3, 9], np.int32)
    for active in ([True, True], [False, True], [True, True]):
        act = np.array(active)
        jc, jl = jd.decode_step(jspec, tree, jc, jnp.asarray(cur), jnp.asarray(act), jnp.float32)
        tc, tl = td.decode_step(tspec, tparams, tc, torch.from_numpy(cur),
                                torch.from_numpy(act), torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL[kernels], rtol=0)
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
        cur = np.asarray(jl).argmax(-1).astype(np.int32)


def test_forward_logits_matches_jax(weights):
    jspec, tspec, unpacked, _ = weights
    ids = np.random.default_rng(4).integers(0, 512, (2, 24)).astype(np.int32)
    want = np.asarray(jd.forward_logits(jspec, unpacked, jnp.asarray(ids), jnp.float32))
    got = td.forward_logits(tspec, params_from_numpy(unpacked), torch.from_numpy(ids),
                            torch.float32)
    assert got.shape == (2, 24, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[False], rtol=0)


def test_inactive_slot_parks_its_write_at_the_last_row(weights):
    """decoder.py:686-693: an inactive slot's discarded write lands at
    t_max-1, never at its length, so rows a chunked prefill just wrote
    survive an interleaved decode step."""
    _, tspec, unpacked, _ = weights
    params = params_from_numpy(unpacked)
    cache = td.init_cache(tspec, 2, MAX_LEN)
    cache.lengths[1] = 7
    before = cache.k[0][1, 7].clone()
    td.decode_step(tspec, params, cache, torch.tensor([1, 2], dtype=torch.int32),
                   torch.tensor([True, False]), torch.float32)
    assert torch.equal(cache.k[0][1, 7], before)
    assert cache.k[0][1, MAX_LEN - 1].abs().sum() > 0
    assert cache.lengths.tolist() == [1, 7]


@pytest.mark.parametrize("seq,min_seq", [(64, 256), (128, 256), (200, 256), (256, 256),
                                         (384, 256), (256, 512), (512, 512), (1000, 512)])
def test_prefill_gate_on_cpu_tensors_is_the_jax_packages(weights, seq, min_seq):
    """Kernel routes forced on CPU tensors: the prefill gate is the JAX
    package's TPU gate (on the card the kernels take every bucket)."""
    jspec, tspec, _, _ = weights
    jnn.set_use_pallas(True)
    tnn.set_use_kernels(True)
    try:
        want = jd._use_fused_prefill_attention(jspec, seq, min_seq=min_seq)
        got = td._use_fused_prefill_attention(tspec, seq, torch.zeros(1), min_seq=min_seq)
    finally:
        jnn.set_use_pallas(False)
        tnn.set_use_kernels(None)
    assert got == want == (seq >= min_seq and seq % 128 == 0)


@pytest.mark.parametrize("bucket", [64, 256])
def test_forced_kernels_route_a_cpu_prefill_as_jax_does(weights, bucket, monkeypatch):
    """Bucket 64 takes the jnp-style attention even with the kernel routes
    forced, bucket 256 the causal kernel's wrapper, as in the JAX package."""
    from starpu_inference_server_tpu_torch.ops import prefill_attention as tpa

    _, tspec, unpacked, _ = weights
    calls = []
    plain = tpa.causal_attention
    monkeypatch.setattr(tpa, "causal_attention", lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, 512, bucket).astype(np.int32))
    tnn.set_use_kernels(True)
    try:
        td.prefill(tspec, params_from_numpy(unpacked), td.init_cache(tspec, 1, MAX_LEN), ids,
                   bucket - 3, 0, torch.float32)
    finally:
        tnn.set_use_kernels(None)
    assert len(calls) == (tspec.layers if bucket == 256 else 0)
