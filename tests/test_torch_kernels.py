"""The port's kernel modules vs the JAX package's Pallas kernels.

Same numpy inputs go through the JAX function (Pallas in interpret mode,
as the JAX package's own tests run it on the CPU) and the port's
function (the plain PyTorch version, since the tensors are on the CPU).
Each tolerance is the JAX package's own for the same kernel. The CUDA
kernels themselves are held against these plain versions on the card
by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starpu_inference_server_tpu.ops import decode_attention as jda
from starpu_inference_server_tpu.ops import nn as jnn
from starpu_inference_server_tpu.ops import pallas_kernels as jpk
from starpu_inference_server_tpu.ops import prefill_attention as jpa
from starpu_inference_server_tpu.ops import quant as jq
from starpu_inference_server_tpu.ops import stem_kernel as jsk
from starpu_inference_server_tpu_torch.ops import decode_attention as tda
from starpu_inference_server_tpu_torch.ops import matmul_kernels as tmk
from starpu_inference_server_tpu_torch.ops import nn as tnn
from starpu_inference_server_tpu_torch.ops import prefill_attention as tpa
from starpu_inference_server_tpu_torch.ops import stem_kernel as tsk
from starpu_inference_server_tpu_torch.weights import params_from_numpy


@pytest.fixture(autouse=True)
def interpret_mode():
    for mod in (jpk, jda, jpa, jsk):
        mod.set_interpret(True)
    yield
    for mod in (jpk, jda, jpa, jsk):
        mod.set_interpret(False)


@pytest.fixture
def kernels_on():
    jnn.set_use_pallas(True)
    tnn.set_use_kernels(True)
    yield
    jnn.set_use_pallas(False)
    tnn.set_use_kernels(None)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- int4_matmul through dense ------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(5, 256, 32000), (37, 256, 128), (128, 512, 384)])
def test_dense_int4_matches_jax_int4_matmul(kernels_on, m, k, n):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    leaf = jq.pack_int4_tree(jq.maybe_quantize_tree({"w": jnp.asarray(w)}, 4))
    got = tnn.dense(params_from_numpy(leaf), _t(x), torch.float32)
    want = np.asarray(jnn.dense(leaf, jnp.asarray(x), jnp.float32))
    # the JAX package's own int4 kernel tolerance (test_pallas_kernels.py)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
    assert tmk.launches["int4_matmul"] == 0  # CPU tensors never launch


@pytest.mark.parametrize("branch", ["w4a8_kernel", "w4a8", "int8_kernel_rows", "w8a8", "dense"])
def test_dense_dispatch_branches_match_jax(branch):
    """The other four branches of dense's five-way dispatch, on CPU (K2
    and K6 run their plain versions here; on CUDA they launch their
    kernels)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    w = rng.standard_normal((128, 96)).astype(np.float32)
    bits = 4 if branch.startswith("w4a8") else 8
    tree = {"w": jnp.asarray(w), "b": jnp.asarray(rng.standard_normal(96).astype(np.float32))}
    if branch != "dense":
        tree = jq.maybe_quantize_tree(tree, bits)
    if bits == 4:
        tree = jq.pack_int4_tree(tree)
    kern = branch.endswith(("_kernel", "_kernel_rows"))
    w8a8 = branch.startswith(("w4a8", "w8a8"))
    jnn.set_use_pallas(kern)
    jnn.set_w8a8(w8a8)
    tnn.set_use_kernels(kern)
    tnn.set_w8a8(w8a8)
    try:
        want = np.asarray(jnn.dense(tree, jnp.asarray(x), jnp.float32))
        got = tnn.dense(params_from_numpy(tree), _t(x), torch.float32)
    finally:
        jnn.set_use_pallas(False)
        jnn.set_w8a8(False)
        tnn.set_use_kernels(None)
        tnn.set_w8a8(False)
    # the JAX package's own int8/int4 kernel tolerance (test_pallas_kernels.py)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def test_int4_matmul_rounds_x_to_bf16_like_the_tpu_kernel():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((9, 64)).astype(np.float32)
    w_q = rng.integers(-7, 8, (64, 32)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, (1, 32)).astype(np.float32)
    w_p4 = np.asarray(jq.pack_int4(jnp.asarray(w_q)))
    got = tmk.int4_matmul(_t(x), _t(w_p4), _t(scale))
    assert got.dtype == torch.float32
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)
    want = (xb @ w_q.astype(np.float32)) * scale
    # f32 products of exact operands: only the summation order differs
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    jax_out = np.asarray(jpk.int4_matmul(jnp.asarray(x), jnp.asarray(w_p4), jnp.asarray(scale)))
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=1e-5, atol=1e-5)


def test_embedding_gathers_packed_rows_exactly():
    rng = np.random.default_rng(2)
    table = rng.standard_normal((64, 16)).astype(np.float32)
    ids = np.array([[0, 1, 63], [62, 7, 7]], np.int32)
    for packed in (False, True):
        tree = jq.maybe_quantize_tree({"w": jnp.asarray(table)}, 4)
        if packed:
            tree = jq.pack_int4_tree(tree)
        want = np.asarray(jnn.embedding(tree, jnp.asarray(ids), jnp.float32))
        got = tnn.embedding(params_from_numpy(tree), _t(ids), torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)


# -- decode_attention ---------------------------------------------------------

def _decode_case(s, t, hkv, rep, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((s, hkv * rep, d)).astype(np.float32)
    k = rng.integers(-127, 128, (s, t, hkv, d)).astype(np.int8)
    v = rng.integers(-127, 128, (s, t, hkv, d)).astype(np.int8)
    ks = (rng.random((s, t, hkv)).astype(np.float32) + 0.5) / 127
    vs = (rng.random((s, t, hkv)).astype(np.float32) + 0.5) / 127
    lengths = rng.integers(0, t - 1, (s,)).astype(np.int32)
    lengths[0] = 0  # a slot whose only live position is 0
    return q, k, v, ks, vs, lengths


@pytest.mark.parametrize("s", [1, 16])
@pytest.mark.parametrize("rep", [1, 4])
def test_decode_attention_matches_jax(s, rep):
    case = _decode_case(s, 256, 2, rep, 64, seed=s + rep)
    want = np.asarray(jda.decode_attention(*(jnp.asarray(a) for a in case), rep=rep))
    got = tda.decode_attention(*(_t(a) for a in case), rep=rep)
    # the JAX package's own tolerance (test_decode_attention.py)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    assert got.shape == (s, 2 * rep, 64)


# -- causal_attention ---------------------------------------------------------

@pytest.mark.parametrize("t", [256, 512])
def test_causal_attention_matches_jax(t):
    rng = np.random.default_rng(t)
    hkv, rep, d = 2, 4, 64
    q = rng.standard_normal((1, t, hkv * rep, d)).astype(np.float32)
    k = rng.standard_normal((1, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((1, t, hkv, d)).astype(np.float32)
    want = np.asarray(jpa.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           rep=rep, out_dtype=jnp.float32))
    got = tpa.causal_attention(_t(q), _t(k), _t(v), rep=rep, out_dtype=torch.float32)
    # the JAX package's own tolerance (test_prefill_attention.py)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# -- chunk_prefill_attention --------------------------------------------------

@pytest.mark.parametrize("start", [0, 128])
def test_chunk_prefill_attention_matches_jax(start):
    rng = np.random.default_rng(start + 1)
    t, cq, hkv, rep, d = 256, 128, 2, 4, 64
    hq = hkv * rep
    args = [
        rng.standard_normal((cq, hq, d)).astype(np.float32),
        rng.integers(-127, 128, (t, hkv, d)).astype(np.int8),
        rng.integers(-127, 128, (t, hkv, d)).astype(np.int8),
        rng.uniform(0.01, 0.1, (t, hkv)).astype(np.float32),
        rng.uniform(0.01, 0.1, (t, hkv)).astype(np.float32),
        rng.standard_normal((cq, hkv, d)).astype(np.float32),
        rng.standard_normal((cq, hkv, d)).astype(np.float32),
    ]
    want = np.asarray(jpa.chunk_prefill_attention(
        *(jnp.asarray(a) for a in args), jnp.int32(start), rep=rep, out_dtype=jnp.float32))
    got = tpa.chunk_prefill_attention(*(_t(a) for a in args), start, rep=rep,
                                      out_dtype=torch.float32)
    # the JAX package's own tolerance (test_prefill_attention.py:94)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


# -- int8_matmul (K2) ---------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(1, 512, 1000), (8, 512, 1000), (32, 512, 1000),
                                   (9, 130, 200)])
def test_int8_matmul_matches_jax(m, k, n):
    rng = np.random.default_rng(m + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_q, scale = jq.quantize_per_channel(jnp.asarray(rng.standard_normal((k, n)).astype(
        np.float32)), bits=8)
    want = np.asarray(jpk.int8_matmul(jnp.asarray(x), w_q, scale))
    got = tmk.int8_matmul(_t(x), _t(w_q), _t(scale))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    # the JAX package's own int8 kernel tolerance (test_pallas_kernels.py)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
    # x rounds to bf16 as in the TPU kernel; the rest is exact f32 products
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)
    np.testing.assert_allclose(got.numpy(), (xb @ np.asarray(w_q, np.float32)) * np.asarray(scale),
                               rtol=1e-5, atol=1e-5)
    assert tmk.launches["int8_matmul"] == 0


# -- bidirectional_attention (K7) ---------------------------------------------

@pytest.mark.parametrize("rep", [1, 2])
def test_bidirectional_attention_matches_jax(rep):
    rng = np.random.default_rng(rep)
    b, t, hkv, d = 3, 512, 2, 64
    q = (3 * rng.standard_normal((b, t, hkv * rep, d))).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    bias = np.zeros((b, t), np.float32)
    bias[0, 400:] = -1e9  # padding
    bias[2] = -1e9        # a fully masked sample (a padding row of a bucket)
    want = np.asarray(jpa.bidirectional_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias)), rep=rep, out_dtype=jnp.float32))
    got = tpa.bidirectional_attention(*(_t(a) for a in (q, k, v, bias)), rep=rep,
                                      out_dtype=torch.float32)
    assert np.isfinite(got.numpy()).all() and np.isfinite(want).all()
    # the JAX package's own tolerance (test_bidirectional_attention.py)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # all keys masked: every logit is -1e9 + (a dot lost in its rounding),
    # so the output is the plain mean of v, as XLA and the TPU kernel give
    mean_v = np.repeat(v[2].mean(axis=0), rep, axis=0)
    np.testing.assert_allclose(got.numpy()[2], np.broadcast_to(mean_v, (t, hkv * rep, d)),
                               rtol=1e-4, atol=1e-4)


# -- fused_stem (K8) ----------------------------------------------------------

def _stem_inputs(case):
    """(zp, w, scale, shift) of one K8 case, from numpy: the padded s2d
    image of B images (zero margins), a weight and a BN affine."""
    b = {"b1": 1, "b5": 5}.get(case, 2)
    rng = np.random.default_rng(5)
    zp = np.zeros((b, 118, 118, 12), np.float32)
    zp[:, 3:115, 3:115] = rng.standard_normal((b, 112, 112, 12))
    w = (rng.standard_normal((192, 64)) * 0.1).astype(np.float32)
    scale = (rng.random(64) + 0.5).astype(np.float32)
    shift = (rng.standard_normal(64) * 0.1).astype(np.float32)
    if case == "negative":
        # every conv value is far below -shift: each pooled output is 0
        shift -= 100.0
    elif case == "margins":
        # large values only in the 3-row / 3-column margins and the first
        # and last image rows: conv row and column -1 (computed from the
        # margin) must take no part in the pool, and the pool's own
        # padding must act as zeros
        zp[:] = 0.0
        edge = np.ones((118, 118), bool)
        edge[3:115, 3:115] = False
        edge[[3, 114], 3:115] = True
        zp[:, edge] = 50.0 * rng.standard_normal((b, int(edge.sum()), 12))
    return zp, w, scale, shift


@pytest.mark.parametrize("case", ["b2", "b1", "b5", "negative", "margins"])
def test_fused_stem_matches_jax(case):
    zp, w, scale, shift = _stem_inputs(case)
    b = zp.shape[0]
    want = np.asarray(jsk.fused_stem(*(jnp.asarray(a) for a in (zp, w, scale, shift)),
                                     out_dtype=jnp.float32))
    got = tsk.fused_stem(*(_t(a) for a in (zp, w, scale, shift)), out_dtype=torch.float32)
    assert got.shape == (b, 56, 56, 64)
    # bf16 operands, f32 sums in another order: far inside a bf16 ulp
    np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -8, atol=1e-3)
    bf = tsk.fused_stem(*(_t(a) for a in (zp, w, scale, shift)))
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), want, rtol=2 ** -7, atol=1e-3)
    if case == "negative":
        assert not want.any() and not got.any() and not bf.float().any()
    if case == "margins":
        # the edges reach pooled rows and columns 0, 1 and 55 only; the
        # rest pools convolutions of zeros: exactly relu(shift)
        inner = np.broadcast_to(np.maximum(shift, 0.0), (b, 53, 53, 64))
        assert np.abs(want[:, :2]).max() > 10 * np.abs(inner).max()
        np.testing.assert_array_equal(want[:, 2:-1, 2:-1], inner)
        np.testing.assert_array_equal(got.numpy()[:, 2:-1, 2:-1], inner)
    assert tsk.launches["fused_stem"] == 0
