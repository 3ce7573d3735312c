"""The port's NN layers against the JAX package's, on the CPU, with the
traps of the translation pinned: population variance in layer norm, the
tanh GELU, probabilities rounded to the compute dtype on the plain
attention path, -inf max-pool padding, NHWC convs with asymmetric
padding, and the exact s8 x s8 contraction of W8A8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starpu_inference_server_tpu.ops import nn as jnn
from starpu_inference_server_tpu.ops import quant as jq
from starpu_inference_server_tpu_torch.ops import nn as tnn
from starpu_inference_server_tpu_torch.weights import params_from_numpy


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.fixture(autouse=True)
def plain_routes():
    tnn.set_use_kernels(False)
    yield
    tnn.set_use_kernels(None)


def test_layer_norm_uses_the_population_variance():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 48)) * 3 + 1).astype(np.float32)
    p = {"gamma": rng.standard_normal(48).astype(np.float32),
         "beta": rng.standard_normal(48).astype(np.float32)}
    want = np.asarray(jnn.layer_norm(p, jnp.asarray(x), eps=1e-12))
    got = tnn.layer_norm(params_from_numpy(p), _t(x), eps=1e-12)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the unbiased variance would be off by a factor 48/47 inside the rsqrt
    unbiased = (_t(x) - _t(x).mean(-1, keepdim=True)) / torch.sqrt(_t(x).var(-1, keepdim=True))
    assert not np.allclose(unbiased.numpy() * p["gamma"] + p["beta"], want, atol=1e-3)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = np.asarray(jnn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(tnn.gelu(_t(x)).numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_attention_rounds_probabilities_like_jax(dtype):
    rng = np.random.default_rng(1)
    b, s, h, d = 2, 128, 2, 64  # s < 512: the plain path in both packages
    q, k, v = (rng.standard_normal((b, s, h * d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), np.int64)
    mask[1, 90:] = 0
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = _np(jnn._attention(*(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(mask), h, jd))
    got = _np(tnn._attention(*(_t(a).to(td) for a in (q, k, v)), _t(mask), h, td))
    # f32: sums in another order; bf16: one rounding of the output (the
    # probabilities round to bf16 before P.V in both)
    tol = 2e-5 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("stride,padding,groups", [
    (1, 1, 1), (2, 1, 1), (2, 0, 1), (1, [(2, 1), (2, 1)], 1), (2, "SAME", 1), (1, 1, 4),
])
@pytest.mark.parametrize("quant", [False, True])
def test_conv2d_matches_jax(stride, padding, groups, quant):
    rng = np.random.default_rng(stride + groups)
    x = rng.standard_normal((2, 15, 14, 8)).astype(np.float32)
    p = {"w": (rng.standard_normal((3, 3, 8 // groups, 12)) * 0.2).astype(np.float32),
         "b": rng.standard_normal(12).astype(np.float32)}
    if quant:
        p = jq.maybe_quantize_tree({k: jnp.asarray(v) for k, v in p.items()}, 8)
    want = np.asarray(jnn.conv2d(p, jnp.asarray(x), stride=stride, padding=padding,
                                 groups=groups, dtype=jnp.float32))
    got = tnn.conv2d(params_from_numpy(p), _t(x), stride=stride, padding=padding,
                     groups=groups, dtype=torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pooling_and_batch_norm_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 10, 4)).astype(np.float32) - 2.0  # mostly negative
    for padding in ([(1, 1), (1, 1)], "SAME", "VALID"):
        want = np.asarray(jnn.max_pool(jnp.asarray(x), 3, 2, padding))
        np.testing.assert_array_equal(tnn.max_pool(_t(x), 3, 2, padding).numpy(), want)
    np.testing.assert_allclose(tnn.global_avg_pool(_t(x)).numpy(),
                               np.asarray(jnn.global_avg_pool(jnp.asarray(x))), rtol=1e-6)
    bn = {"gamma": rng.random(4).astype(np.float32), "beta": rng.random(4).astype(np.float32),
          "mean": rng.random(4).astype(np.float32), "var": rng.random(4).astype(np.float32)}
    np.testing.assert_allclose(
        tnn.batch_norm_inference(params_from_numpy(bn), _t(x)).numpy(),
        np.asarray(jnn.batch_norm_inference(bn, jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rows", [3, 40])
def test_int_dot_is_exact(rows):
    rng = np.random.default_rng(rows)
    x_q = rng.integers(-127, 128, (rows, 3072)).astype(np.int8)
    w = rng.integers(-127, 128, (3072, 64)).astype(np.int8)
    exact = x_q.astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(tnn._int_dot(_t(x_q), _t(w)).numpy(),
                                  exact.astype(np.float32))
