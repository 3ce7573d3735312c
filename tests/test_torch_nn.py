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


@pytest.mark.parametrize("n", [1, 7, 8, 9, 17])
@pytest.mark.parametrize("stride,pads,groups", [(1, (1, 1, 1, 1), 1), (2, (2, 1, 2, 1), 1),
                                                (2, (1, 1, 1, 1), 2)])
def test_chunked_conv_equals_one_conv_over_the_batch(n, stride, pads, groups):
    """``_cudnn_conv``, the card's route (``CONV_ROWS`` images a call, the
    last chunk padded), gives the batch conv's values: no row lost, moved
    or mixed with the padding. Run here on CPU tensors in float64."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((n, 4, 11, 11)))
    w = torch.from_numpy(rng.standard_normal((6, 4 // groups, 3, 3)))
    pt, pb, pl, pr = pads
    want = torch.nn.functional.conv2d(torch.nn.functional.pad(x, (pl, pr, pt, pb)), w,
                                      stride=stride, groups=groups)
    got = tnn._cudnn_conv(x, w, stride, pads, groups)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


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


# -- W8A8 convolutions ---------------------------------------------------------

W8A8_CONVS = {
    # name: (input NHWC, kernel, in/groups, out, stride, padding, groups)
    "stride2_int_pad": ((2, 15, 14, 8), 3, 8, 16, 2, 1, 1),
    "same": ((2, 9, 10, 8), 3, 8, 16, 1, "SAME", 1),
    "valid_stride2": ((2, 11, 11, 8), 3, 8, 24, 2, "VALID", 1),
    "groups4": ((2, 9, 9, 16), 3, 4, 16, 1, 1, 4),
    "groups32_resnext": ((1, 8, 8, 128), 3, 4, 128, 2, 1, 32),
    "s2d_stem_k192": ((2, 12, 12, 12), 4, 12, 64, 1, [(2, 1), (2, 1)], 1),
    "unfolded_stem_k147": ((2, 20, 20, 3), 7, 3, 64, 2, 3, 1),
    "vit_patch_k768": ((2, 32, 32, 3), 16, 3, 40, 16, "VALID", 1),
}


@pytest.fixture
def w8a8_mode():
    jnn.set_w8a8(True)
    tnn.set_w8a8(True)
    yield
    jnn.set_w8a8(False)
    tnn.set_w8a8(False)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(W8A8_CONVS))
def test_w8a8_conv2d_is_bit_equal_to_jax(w8a8_mode, case, dtype):
    """The s8 x s8 -> s32 conv is exact in both packages (XLA's int32
    conv; the port's im2col through ``_int_dot``), the per-tensor
    activation scale and the f32 rescale are the same IEEE operations in
    the same order: the outputs are equal bit for bit (tolerance 0), at
    every stride, padding and group count, and at the s2d stem's K = 192,
    the unfolded stem's K = 147 and the ViT patch conv's K = 768."""
    shape, kh, cin_g, out, stride, padding, groups = W8A8_CONVS[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal(shape).astype(np.float32)
    p = {"w": (rng.standard_normal((kh, kh, cin_g, out)) * 0.2).astype(np.float32),
         "b": rng.standard_normal(out).astype(np.float32)}
    p = jq.maybe_quantize_tree({k: jnp.asarray(v) for k, v in p.items()}, 8)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = _np(jnn.conv2d(p, jnp.asarray(x).astype(jd), stride=stride, padding=padding,
                          groups=groups, dtype=jd))
    got = _np(tnn.conv2d(params_from_numpy(p), _t(x).to(td), stride=stride, padding=padding,
                         groups=groups, dtype=td))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_w8a8_conv2d_keeps_integer_sums_an_f32_conv_would_lose(w8a8_mode):
    """127-valued activations against mostly 127-valued weights over
    3x3x512 windows: the s32 sums reach 6.8e7, past 2^24, where an f32
    conv of the same integers rounds its partial sums (a quarter of these
    outputs come out different). The port's conv, like the JAX
    package's, gives the exact sums, rounded once to f32 and scaled."""
    rng = np.random.default_rng(5)
    w_q = np.where(rng.random((3, 3, 512, 8)) < 0.9, 127,
                   rng.integers(-127, 128, (3, 3, 512, 8))).astype(np.int8)
    scale = (rng.random((1, 1, 1, 8)) * 1e-3 + 1e-3).astype(np.float32)
    leaf = {"w": {"w_q": w_q, "scale": scale, "bits": 8}}
    x = np.full((1, 6, 6, 512), 2.5, np.float32)  # x_q = 127 everywhere
    got = tnn.conv2d(params_from_numpy(leaf), _t(x), padding="VALID", dtype=torch.float32)
    want = np.asarray(jnn.conv2d(leaf, jnp.asarray(x), padding="VALID", dtype=jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    cols = np.stack([np.full((4, 4, 512), 127, np.int64)] * 9, axis=2).reshape(16, -1)
    exact = cols @ w_q.astype(np.int64).reshape(-1, 8)
    assert exact.max() > 2 ** 24
    sx = np.float32(2.5) / np.float32(127.0)
    np.testing.assert_array_equal(
        got.numpy().reshape(16, 8), exact.astype(np.float32) * sx * scale.reshape(1, 8))
    f32_conv = torch.nn.functional.conv2d(
        torch.full((1, 512, 6, 6), 127.0), _t(w_q).permute(3, 2, 0, 1).float())
    lost = f32_conv.permute(0, 2, 3, 1).reshape(16, 8).numpy() != exact.astype(np.float32)
    assert lost.any()


@pytest.mark.parametrize("m,k,n", [(40, 147, 4), (17, 64, 128), (33, 192, 64)])
def test_int_mm_s32_pads_to_exact_sums(m, k, n):
    """``torch._int_mm``'s route (K and N padded with zeros to multiples of
    8, the weight column-major) gives the exact integer sums, at the
    unfolded stem's K = 147, a grouped conv's N = 4 and shapes that the
    row-major form is refused at on the card."""
    rng = np.random.default_rng(m + k + n)
    x_q = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    got = tnn._int_mm_s32(_t(x_q), _t(w))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), x_q.astype(np.int64) @ w.astype(np.int64))
