"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc (sm_90a); without one each test skips.
On the card machine run them with

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

They cover the edges chip_smoke.py does not: ragged M, N and K for the
int4 and int8 kernels (odd N that forbids 4-byte weight loads, M over
one 32-row band), the int4 kernel with and without a split of K and
bit-equal over two calls, f32 and bf16 inputs, rep 1 and 8, head_dim 128,
lengths 0 and T-1, prompts that are not a multiple of the query tile, a
fully masked encoder sample, the bf16 encoder attention with 300 padded
keys bit-equal over two calls, the fused stem at f32 and bf16 output, the
W4A8 kernel exact against its float64 plain version (ragged M, N, K),
verify windows and paged caches with shuffled tables, windows that
cross a page and unallocated table entries past a slot's length, the
four FLAT-layout kernels against their plain versions and bit for bit
against their standard twins on the same logical cache, the bf16 route
of all eight decode-side kernels at split shapes (1 and 4 slots, lengths
at tile and split edges, pages of 16, head_dim 32 and 128) bit-equal
over two calls and as CUDA graphs replayed with other lengths, engines that
serve through each of them, a chained decode block that never syncs
the host, the MoE decode block as a graph, and the W8A8 conv's integer
route (``torch._int_mm``) exact at the shapes cuBLASLt's row-major form
refuses and equal to the CPU's bits."""

import pytest
import torch

from starpu_inference_server_tpu_torch.ops import decode_attention as da
from starpu_inference_server_tpu_torch.ops import matmul_kernels as mk
from starpu_inference_server_tpu_torch.ops import prefill_attention as pa
from starpu_inference_server_tpu_torch.ops import stem_kernel as sk
from starpu_inference_server_tpu_torch.ops.quant import pack_int4

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _close(got, ref, rel):
    # f32 sums in another order (and, in bf16, one output rounding)
    scale = max(1.0, ref.float().abs().max().item())
    assert (got.float() - ref.float()).abs().max().item() <= rel * scale


# the ragged shapes, then llama-1b's down at the decode batch (K split),
# its lm_head at M = 1 (one row, not split) and gate_up at the largest
# prefill bucket (the 128-row tile, not split)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 64, 130), (17, 98, 257), (200, 2048, 384),
                                   (128, 5504, 2048), (1, 2048, 32000), (512, 2048, 11008)])
def test_int4_matmul_kernel(dev, dtype, m, k, n):
    g = _gen(dev, m + n)
    x = torch.randn(m, k, device=dev, generator=g).to(dtype)
    w4 = pack_int4(torch.randint(-7, 8, (k, n), device=dev, generator=g, dtype=torch.int8))
    sc = torch.rand(1, n, device=dev, generator=g) * 0.1
    before = mk.launches["int4_matmul"]
    got = mk.int4_matmul(x, w4, sc)
    torch.cuda.synchronize()
    assert mk.launches["int4_matmul"] == before + 1
    _close(got, mk.int4_matmul_plain(x, w4, sc), 1e-5)


@pytest.mark.parametrize("m,k,n,split", [(128, 5504, 2048, True), (1, 2048, 32000, False),
                                         (17, 98, 257, True)])
def test_int4_matmul_kernel_gives_the_same_bits_twice(dev, m, k, n, split):
    """Split partial sums are added in a fixed order, never by atomics:
    two calls on the same inputs agree bit for bit, split or not."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (mk.matmul_plan("int4_matmul", m, n, k, sms).splits > 1) == split
    g = _gen(dev, m * k)
    x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
    w4 = pack_int4(torch.randint(-7, 8, (k, n), device=dev, generator=g, dtype=torch.int8))
    sc = torch.rand(1, n, device=dev, generator=g) * 0.1
    first = mk.int4_matmul(x, w4, sc)
    second = mk.int4_matmul(x, w4, sc)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _close(first, mk.int4_matmul_plain(x, w4, sc), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t,hkv,rep,d", [(3, 128, 2, 1, 64), (5, 384, 1, 8, 128),
                                           (2, 1024, 8, 4, 64)])
def test_decode_attention_kernel(dev, dtype, s, t, hkv, rep, d):
    g = _gen(dev, s * t)
    q = torch.randn(s, hkv * rep, d, device=dev, generator=g).to(dtype)
    k = torch.randint(-127, 128, (s, t, hkv, d), device=dev, generator=g, dtype=torch.int8)
    v = torch.randint(-127, 128, (s, t, hkv, d), device=dev, generator=g, dtype=torch.int8)
    ks = torch.rand(s, t, hkv, device=dev, generator=g) / 127
    vs = torch.rand(s, t, hkv, device=dev, generator=g) / 127
    lengths = torch.randint(0, t, (s,), device=dev, generator=g, dtype=torch.int32)
    lengths[0], lengths[-1] = 0, t - 1
    got = da.decode_attention(q, k, v, ks, vs, lengths, rep)
    torch.cuda.synchronize()
    _close(got, da.decode_attention_plain(q, k, v, ks, vs, lengths, rep),
           1e-2 if dtype == torch.bfloat16 else 2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,hkv,rep,d", [(2, 200, 2, 4, 64), (1, 96, 2, 1, 128)])
def test_causal_attention_kernel(dev, dtype, b, t, hkv, rep, d):
    g = _gen(dev, t)
    q = torch.randn(b, t, hkv * rep, d, device=dev, generator=g).to(dtype)
    k = torch.randn(b, t, hkv, d, device=dev, generator=g).to(dtype)
    v = torch.randn(b, t, hkv, d, device=dev, generator=g).to(dtype)
    got = pa.causal_attention(q, k, v, rep)
    torch.cuda.synchronize()
    _close(got, pa.causal_attention_plain(q, k, v, rep),
           1e-2 if dtype == torch.bfloat16 else 2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("start", [0, 37, 300])
def test_chunk_prefill_attention_kernel(dev, dtype, start):
    g = _gen(dev, start + 1)
    c, t, hkv, rep, d = 70, 512, 2, 4, 64
    args = (
        torch.randn(c, hkv * rep, d, device=dev, generator=g).to(dtype),
        torch.randint(-127, 128, (t, hkv, d), device=dev, generator=g, dtype=torch.int8),
        torch.randint(-127, 128, (t, hkv, d), device=dev, generator=g, dtype=torch.int8),
        torch.rand(t, hkv, device=dev, generator=g) / 127,
        torch.rand(t, hkv, device=dev, generator=g) / 127,
        torch.randn(c, hkv, d, device=dev, generator=g).to(dtype),
        torch.randn(c, hkv, d, device=dev, generator=g).to(dtype),
    )
    got = pa.chunk_prefill_attention(*args, start, rep)
    torch.cuda.synchronize()
    _close(got, pa.chunk_prefill_attention_plain(*args, start, rep),
           1e-2 if dtype == torch.bfloat16 else 2e-5)


def _attn_limit(got, ref):
    """chip_smoke.py's element limit for attention kernels, 2^-7 |ref| + 1e-3."""
    g, r = got.float(), ref.float()
    return bool(((g - r).abs() <= 2.0 ** -7 * r.abs() + 1e-3).all())


# the tensor-core route: every prefill bucket of llama_decoder.yml, a
# ragged T, rep 1 and 4, D 64 and 128; q = 3 N(0, 1) gives sharp logits
@pytest.mark.parametrize("rep,d", [(1, 64), (4, 64), (1, 128), (4, 128)])
@pytest.mark.parametrize("t", [64, 128, 200, 256, 512])
def test_causal_attention_bf16_tensor_cores(dev, t, rep, d):
    g = _gen(dev, t * rep + d)
    hkv = 2
    q = (3 * torch.randn(1, t, hkv * rep, d, device=dev, generator=g)).to(torch.bfloat16)
    k = torch.randn(1, t, hkv, d, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(1, t, hkv, d, device=dev, generator=g).to(torch.bfloat16)
    before = pa.launches["causal_attention"]
    first = pa.causal_attention(q, k, v, rep)
    second = pa.causal_attention(q, k, v, rep)
    torch.cuda.synchronize()
    assert pa.launches["causal_attention"] == before + 2
    assert torch.equal(first, second)
    assert _attn_limit(first, pa.causal_attention_plain(q, k, v, rep))


# the int8 past at several starts (0: none; 37: a ragged tile), t_max a
# multiple of 128 and not
@pytest.mark.parametrize("t_max", [1024, 1000])
@pytest.mark.parametrize("start", [0, 37, 256, 300, 512])
def test_chunk_prefill_attention_bf16_tensor_cores(dev, start, t_max):
    g = _gen(dev, start + t_max)
    c, hkv, rep, d = 256, 2, 4, 64
    args = (
        (3 * torch.randn(c, hkv * rep, d, device=dev, generator=g)).to(torch.bfloat16),
        torch.randint(-127, 128, (t_max, hkv, d), device=dev, generator=g, dtype=torch.int8),
        torch.randint(-127, 128, (t_max, hkv, d), device=dev, generator=g, dtype=torch.int8),
        torch.rand(t_max, hkv, device=dev, generator=g) * 0.01 + 0.01,
        torch.rand(t_max, hkv, device=dev, generator=g) / 127 + 1e-3,
        torch.randn(c, hkv, d, device=dev, generator=g).to(torch.bfloat16),
        torch.randn(c, hkv, d, device=dev, generator=g).to(torch.bfloat16),
    )
    first = pa.chunk_prefill_attention(*args, start, rep)
    second = pa.chunk_prefill_attention(*args, start, rep)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _attn_limit(first, pa.chunk_prefill_attention_plain(*args, start, rep))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 512, 1000), (7, 300, 37), (50, 512, 1000)])
def test_int8_matmul_kernel(dev, dtype, m, k, n):
    g = _gen(dev, m + n)
    x = torch.randn(m, k, device=dev, generator=g).to(dtype)
    wq = torch.randint(-127, 128, (k, n), device=dev, generator=g, dtype=torch.int8)
    sc = torch.rand(1, n, device=dev, generator=g) * 0.01
    before = mk.launches["int8_matmul"]
    got = mk.int8_matmul(x, wq, sc)
    torch.cuda.synchronize()
    assert mk.launches["int8_matmul"] == before + 1
    _close(got, mk.int8_matmul_plain(x, wq, sc), 1e-5)


# llama-1b's dense layers (K, N), at the rows the int8 decoder gives
# int8_matmul (16 and 64 slots) and the W4A8 one int4_matmul_w4a8 (16,
# and 64 / 128 beside it)
LLAMA_1B_DENSE = {"qkv": (2048, 3072), "o": (2048, 2048), "gate_up": (2048, 11008),
                  "down": (5504, 2048), "lm_head": (2048, 32000)}
# ragged rows (1, 17, 63), N off 16 (no 16-byte weight rows), K off the
# 64-deep stage, and the ResNet-18 fc
RAGGED_QMM = [(1, 98, 257), (17, 300, 37), (63, 2000, 1000), (17, 5504, 2056), (63, 136, 130)]
INT8_PATH = ([(m, k, n) for m in (16, 64) for k, n in LLAMA_1B_DENSE.values()]
             + [(m, 512, 1000) for m in (1, 8, 32)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", INT8_PATH + RAGGED_QMM)
def test_int8_matmul_tensor_cores_at_path_and_ragged_shapes(dev, dtype, m, k, n):
    """K2 on the tensor cores at every shape of its path and at ragged
    ones: within f32 summation order of its plain version (the products
    are exact) and bit-equal over two calls, split or not."""
    g = _gen(dev, 7 * m + n)
    x = torch.randn(m, k, device=dev, generator=g).to(dtype)
    wq = torch.randint(-128, 128, (k, n), device=dev, generator=g, dtype=torch.int8)
    wq[0, : min(n, 8)] = -128  # the int8 extremes convert exactly
    wq[1, : min(n, 8)] = 127
    sc = torch.rand(1, n, device=dev, generator=g) * 0.01 + 1e-3
    before = mk.launches["int8_matmul"]
    first = mk.int8_matmul(x, wq, sc)
    second = mk.int8_matmul(x, wq, sc)
    torch.cuda.synchronize()
    assert mk.launches["int8_matmul"] == before + 2
    assert torch.equal(first, second)
    _close(first, mk.int8_matmul_plain(x, wq, sc), 1e-5)


@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (16, 64, 128)
                                   for k, n in LLAMA_1B_DENSE.values()] + RAGGED_QMM)
def test_int4_matmul_w4a8_tensor_cores_are_exact(dev, m, k, n):
    """K6 on the tensor cores (s8 mma, int32 split partials) at the W4A8
    decoder's shapes and ragged ones: bit-equal to the float64 plain
    version, and over two calls."""
    g = _gen(dev, 5 * m + k)
    x_q = torch.randint(-127, 128, (m, k), device=dev, generator=g, dtype=torch.int8)
    sx = torch.rand(m, 1, device=dev, generator=g) * 0.05 + 1e-3
    wi = torch.randint(-8, 8, (k, n), device=dev, generator=g, dtype=torch.int8)
    w4 = pack_int4(wi)
    sc = torch.rand(1, n, device=dev, generator=g) * 0.1
    first = mk.int4_matmul_w4a8(x_q, sx, w4, sc)
    second = mk.int4_matmul_w4a8(x_q, sx, w4, sc)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, mk.int4_matmul_w4a8_plain(x_q, sx, w4, sc))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,hkv,rep,d", [(3, 512, 2, 1, 64), (2, 200, 2, 2, 128)])
def test_bidirectional_attention_kernel(dev, dtype, b, t, hkv, rep, d):
    g = _gen(dev, t + d)
    q = (3 * torch.randn(b, t, hkv * rep, d, device=dev, generator=g)).to(dtype)
    k = torch.randn(b, t, hkv, d, device=dev, generator=g).to(dtype)
    v = torch.randn(b, t, hkv, d, device=dev, generator=g).to(dtype)
    bias = torch.zeros(b, t, device=dev)
    bias[0, t // 3:] = -1e9
    bias[-1] = -1e9  # a fully masked sample: the mean of v, not NaN
    got = pa.bidirectional_attention(q, k, v, bias, rep)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    _close(got, pa.bidirectional_attention_plain(q, k, v, bias, rep),
           1e-2 if dtype == torch.bfloat16 else 2e-5)


def test_bidirectional_attention_bf16_padded_gives_the_same_bits_twice(dev):
    """The tensor-core route at BERT's T = 512 and H = 12: sample 0 with
    300 padded keys, sample 1 unpadded. Within chip_smoke.py's attention
    limit (2^-7 |ref| + 1e-3 per element: P is rounded to bf16), and two
    calls agree bit for bit (each block owns every key of its rows)."""
    g = _gen(dev, 300)
    b, t, h, d = 2, 512, 12, 64
    q = (3 * torch.randn(b, t, h, d, device=dev, generator=g)).to(torch.bfloat16)
    k = torch.randn(b, t, h, d, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(b, t, h, d, device=dev, generator=g).to(torch.bfloat16)
    bias = torch.zeros(b, t, device=dev)
    bias[0, t - 300:] = -1e9
    before = pa.launches["bidirectional_attention"]
    first = pa.bidirectional_attention(q, k, v, bias)
    second = pa.bidirectional_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert pa.launches["bidirectional_attention"] == before + 2
    assert torch.equal(first, second)
    ref = pa.bidirectional_attention_plain(q, k, v, bias).float()
    assert bool(((first.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-3).all())
    _close(first, ref, 1e-2)


def _stem_inputs(dev, b, case="random"):
    """K8's inputs: the padded s2d image of b images (zero margins), a
    weight and a BN affine; "negative" shifts every conv value below 0,
    "margins" puts large values only in the margins and the first and
    last image rows."""
    g = _gen(dev, b)
    zp = torch.zeros(b, 118, 118, 12, device=dev)
    zp[:, 3:115, 3:115] = torch.randn(b, 112, 112, 12, device=dev, generator=g)
    w = (torch.randn(192, 64, device=dev, generator=g) * 0.1).to(torch.bfloat16)
    scale = torch.rand(64, device=dev, generator=g) + 0.5
    shift = torch.randn(64, device=dev, generator=g) * 0.1
    if case == "negative":
        shift -= 100.0
    elif case == "margins":
        edge = torch.ones(118, 118, dtype=torch.bool, device=dev)
        edge[3:115, 3:115] = False
        edge[[3, 114], 3:115] = True
        zp.zero_()
        zp[:, edge] = 50.0 * torch.randn(b, int(edge.sum()), 12, device=dev, generator=g)
    return zp, w, scale, shift


def _stem_check(zp, w, scale, shift, out_dtype):
    """Two launches of K8, bit-equal, each counted once, against the plain
    version; returns the first output."""
    torch.backends.cudnn.allow_tf32 = False
    before = sk.launches["fused_stem"]
    first = sk.fused_stem(zp, w, scale, shift, out_dtype)
    assert sk.launches["fused_stem"] == before + 1
    second = sk.fused_stem(zp, w, scale, shift, out_dtype)
    assert sk.launches["fused_stem"] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _close(first, sk.fused_stem_plain(zp, w, scale, shift, out_dtype),
           1e-2 if out_dtype == torch.bfloat16 else 2e-5)
    return first


# B = 1 (56 work items), 3, 4 (one block an item), 8, 32, 33 (a
# persistent grid of two blocks an SM, 33 images leaving a ragged last
# round)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3, 4, 8, 32, 33])
def test_fused_stem_kernel(dev, out_dtype, b):
    out = _stem_check(*_stem_inputs(dev, b), out_dtype)
    assert out.shape == (b, 56, 56, 64) and out.dtype == out_dtype


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["negative", "margins"])
def test_fused_stem_kernel_edges(dev, case, out_dtype):
    zp, w, scale, shift = _stem_inputs(dev, 3, case)
    out = _stem_check(zp, w, scale, shift, out_dtype).float()
    if case == "negative":
        assert not out.any()
    else:
        # conv row and column -1 take no part: away from the edges the
        # pool sees convolutions of zeros only
        inner = torch.relu(shift).to(out_dtype).float()
        assert out[:, :2].abs().max() > 10 * inner.abs().max()
        assert torch.equal(out[:, 2:-1, 2:-1], inner.expand(3, 53, 53, 64))


@pytest.mark.parametrize("m,k,n", [(1, 64, 130), (16, 2048, 11008), (17, 98, 257),
                                   (200, 2050, 384)])
def test_int4_matmul_w4a8_kernel(dev, m, k, n):
    g = _gen(dev, m + k)
    x_q = torch.randint(-127, 128, (m, k), device=dev, generator=g, dtype=torch.int8)
    sx = torch.rand(m, 1, device=dev, generator=g) * 0.05 + 1e-3
    w4 = pack_int4(torch.randint(-7, 8, (k, n), device=dev, generator=g, dtype=torch.int8))
    sc = torch.rand(1, n, device=dev, generator=g) * 0.1
    before = mk.launches["int4_matmul_w4a8"]
    got = mk.int4_matmul_w4a8(x_q, sx, w4, sc)
    torch.cuda.synchronize()
    assert mk.launches["int4_matmul_w4a8"] == before + 1
    # exact int32 sums, then the same two f32 multiplies as the plain version
    assert torch.equal(got, mk.int4_matmul_w4a8_plain(x_q, sx, w4, sc))


def _window_case(dev, s, t, w, hkv, rep, d, dtype, seed):
    g = _gen(dev, seed)
    q = torch.randn(s, w, hkv * rep, d, device=dev, generator=g).to(dtype)
    k = torch.randint(-127, 128, (s, t, hkv, d), device=dev, generator=g, dtype=torch.int8)
    v = torch.randint(-127, 128, (s, t, hkv, d), device=dev, generator=g, dtype=torch.int8)
    ks = torch.rand(s, t, hkv, device=dev, generator=g) / 127 * 8
    vs = torch.rand(s, t, hkv, device=dev, generator=g) / 127
    lengths = torch.randint(0, t - w + 1, (s,), device=dev, generator=g, dtype=torch.int32)
    lengths[0], lengths[-1] = 0, t - w
    return q, k, v, ks, vs, lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t,w,hkv,rep,d", [(16, 1024, 5, 8, 4, 64), (3, 200, 9, 8, 4, 64),
                                             (2, 130, 3, 1, 8, 128), (1, 64, 1, 2, 1, 64)])
def test_window_decode_attention_kernel(dev, dtype, s, t, w, hkv, rep, d):
    q, k, v, ks, vs, lengths = _window_case(dev, s, t, w, hkv, rep, d, dtype, s * t + w)
    before = da.launches["window_decode_attention"]
    got = da.window_decode_attention(q, k, v, ks, vs, lengths, rep)
    torch.cuda.synchronize()
    assert da.launches["window_decode_attention"] == before + 1
    _close(got, da.window_decode_attention_plain(q, k, v, ks, vs, lengths, rep),
           1e-2 if dtype == torch.bfloat16 else 2e-5)
    if w == 1:  # a one-row window is the decode function
        _close(got[:, 0], da.decode_attention_plain(q[:, 0], k, v, ks, vs, lengths, rep),
               1e-2 if dtype == torch.bfloat16 else 2e-5)


def _paged_case(dev, s, page, pages_per_slot, n_pages, w, hkv, rep, d, dtype, seed):
    """A pool with a shuffled table: each slot holds pages of its own,
    entries past its length point at page 0 (the garbage page), whose
    rows are NaN so that reading one would show."""
    g = _gen(dev, seed)
    t = page * pages_per_slot
    q = torch.randn(s, w, hkv * rep, d, device=dev, generator=g).to(dtype)
    k = torch.randint(-127, 128, (n_pages, page, hkv, d), device=dev, generator=g,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (n_pages, page, hkv, d), device=dev, generator=g,
                      dtype=torch.int8)
    ks = torch.rand(n_pages, page, hkv, device=dev, generator=g) / 127 * 8
    vs = torch.rand(n_pages, page, hkv, device=dev, generator=g) / 127
    ks[0] = float("nan")
    vs[0] = float("nan")
    lengths = torch.randint(0, t - w + 1, (s,), device=dev, generator=g, dtype=torch.int32)
    lengths[0] = page - 2  # the window crosses into the next page
    lengths[-1] = t - w
    perm = torch.randperm(n_pages - 1, device=dev, generator=g) + 1
    table = torch.zeros(s, pages_per_slot, dtype=torch.int32, device=dev)
    for i in range(s):
        live = (int(lengths[i]) + w - 1) // page + 1
        table[i, :live] = perm[i * pages_per_slot:i * pages_per_slot + live].to(torch.int32)
    return q, k, v, ks, vs, table, lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,page,pps,w", [(64, 256, 4, 1), (64, 256, 4, 5), (5, 16, 8, 9),
                                          (3, 128, 2, 3)])
def test_paged_attention_kernels(dev, dtype, s, page, pps, w):
    hkv, rep, d = 8, 4, 64
    q, k, v, ks, vs, table, lengths = _paged_case(dev, s, page, pps, s * pps + 1, w, hkv,
                                                  rep, d, dtype, s * page + w)
    if w == 1:
        name, fn, plain = ("paged_decode_attention", da.paged_decode_attention,
                           da.paged_decode_attention_plain)
        q = q[:, 0]
    else:
        name, fn, plain = ("paged_window_decode_attention", da.paged_window_decode_attention,
                           da.paged_window_decode_attention_plain)
    before = da.launches[name]
    got = fn(q, k, v, ks, vs, table, lengths, rep)
    torch.cuda.synchronize()
    assert da.launches[name] == before + 1
    assert bool(torch.isfinite(got.float()).all())  # page 0 never read
    # the plain version gathers page 0 too but masks it; compare against
    # a pool whose garbage page is finite
    ks[0], vs[0] = 1.0, 1.0
    _close(got, plain(q, k, v, ks, vs, table, lengths, rep),
           1e-2 if dtype == torch.bfloat16 else 2e-5)


# -- the FLAT layout ---------------------------------------------------------------
#
# The flat cache holds the standard cache's K/V bytes as [.., Hkv*D] rows
# and its scales transposed, [.., Hkv, T]. Each flat kernel runs its
# standard twin's arithmetic with another scale address, so on the same
# logical cache the two agree bit for bit.

def _flat_of(k, v, ks, vs):
    """The same logical cache (or pool) in the flat layout: K/V bytes as
    they are, scales transposed."""
    return (k.flatten(-2), v.flatten(-2), ks.transpose(-1, -2).contiguous(),
            vs.transpose(-1, -2).contiguous())


FLAT_CASES = {
    "decode_s3": ("flat_decode_attention", (3, 128, 2, 1, 64)),
    "decode_s5_rep8_d128": ("flat_decode_attention", (5, 384, 1, 8, 128)),
    "decode_s2_t1024": ("flat_decode_attention", (2, 1024, 8, 4, 64)),
    "window_w5": ("flat_window_decode_attention", (16, 1024, 5, 8, 4, 64)),
    "window_w9_t200": ("flat_window_decode_attention", (3, 200, 9, 8, 4, 64)),
    "paged_page256": ("flat_paged_decode_attention", (64, 256, 4, 1)),
    "paged_page16": ("flat_paged_decode_attention", (5, 16, 8, 1)),
    "paged_window_w5": ("flat_paged_window_decode_attention", (64, 256, 4, 5)),
    "paged_window_page16_w9": ("flat_paged_window_decode_attention", (5, 16, 8, 9)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_kernels_match_plain_and_standard_twin(dev, dtype, case):
    name, shape = FLAT_CASES[case]
    tol = 1e-2 if dtype == torch.bfloat16 else 2e-5
    if "paged" in name:
        s, page, pps, w = shape
        hkv, rep, d = 8, 4, 64
        q, k, v, ks, vs, table, lengths = _paged_case(dev, s, page, pps, s * pps + 1, w, hkv,
                                                      rep, d, dtype, s * page + w + 7)
        if w == 1:
            q = q[:, 0]
        twin = getattr(da, name[len("flat_"):])
        tail = (table, lengths, rep)
    elif "window" in name:
        s, t, w, hkv, rep, d = shape
        q, k, v, ks, vs, lengths = _window_case(dev, s, t, w, hkv, rep, d, dtype, s * t + w + 7)
        twin, tail = da.window_decode_attention, (lengths, rep)
    else:
        s, t, hkv, rep, d = shape
        g = _gen(dev, s * t + 7)
        q = torch.randn(s, hkv * rep, d, device=dev, generator=g).to(dtype)
        k = torch.randint(-127, 128, (s, t, hkv, d), device=dev, generator=g, dtype=torch.int8)
        v = torch.randint(-127, 128, (s, t, hkv, d), device=dev, generator=g, dtype=torch.int8)
        ks = torch.rand(s, t, hkv, device=dev, generator=g) / 127 * 8
        vs = torch.rand(s, t, hkv, device=dev, generator=g) / 127
        lengths = torch.randint(0, t, (s,), device=dev, generator=g, dtype=torch.int32)
        lengths[0], lengths[-1] = 0, t - 1
        twin, tail = da.decode_attention, (lengths, rep)
    flat = _flat_of(k, v, ks, vs)
    before = dict(da.launches)
    got = getattr(da, name)(q, *flat, *tail)
    want = twin(q, k, v, ks, vs, *tail)
    torch.cuda.synchronize()
    assert da.launches[name] == before[name] + 1
    assert da.launches[twin.__name__] == before[twin.__name__] + 1
    assert torch.equal(got, want)  # the same arithmetic, bit for bit
    # the standard entry point takes a 3-D cache as flat
    assert torch.equal(twin(q, *flat, *tail), got)
    assert da.launches[name] == before[name] + 2
    assert bool(torch.isfinite(got.float()).all())  # page 0 (NaN scales) never read
    if "paged" in name:
        ks[0], vs[0] = 1.0, 1.0  # the plain version gathers page 0 and masks it
        flat = _flat_of(k, v, ks, vs)
    _close(got, getattr(da, name + "_plain")(q, *flat, *tail), tol)


# -- the tensor-core, split-context body (csrc/decode_mma.cuh) ----------------------
#
# The bf16 route of all eight decode-side kernels cuts the context into
# splits (ops/decode_attention.py:decode_split_plan) at few slots: S = 1
# and 4 at T = 1024 take 16 splits of 64 positions. Lengths 0, 63 and 64
# put a slot's last live position at the edge of a tile and of a split,
# T - W in the last one. Heads: llama-1b's (8 KV heads, rep 4, D 64),
# llama-tiny's (D 32) and rep 8 at D 128; windows of 9 rows (4 at D 128:
# 32 rows, one row group of two m16 tiles). Paged caches use pages of 16 rows, so a tile
# crosses four pages, with the garbage page's scales NaN.

DECODE_SIDE = ("decode_attention", "window_decode_attention", "paged_decode_attention",
               "paged_window_decode_attention", "flat_decode_attention",
               "flat_window_decode_attention", "flat_paged_decode_attention",
               "flat_paged_window_decode_attention")
SPLIT_HEADS = {"d64_rep4": (8, 4, 64, 9), "d32_rep2": (4, 2, 32, 9), "d128_rep8": (1, 8, 128, 4)}
SPLIT_T = 1024
SPLIT_PAGE = 16


def _split_case(dev, name, heads, lengths, seed, all_pages=False):
    """Inputs of kernel ``name`` at T = 1024 for slots of ``lengths``:
    (q, the caches or pools, the table or nothing). A paged slot holds
    the pages its window reaches (all of them with ``all_pages``), the
    rest of its table points at page 0, whose scales are NaN."""
    hkv, rep, d, w_max = SPLIT_HEADS[heads]
    w = w_max if "window" in name else 1
    s = len(lengths)
    g = _gen(dev, seed)
    q = torch.randn(s, w, hkv * rep, d, device=dev, generator=g).to(torch.bfloat16)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    rows = (s * SPLIT_T // SPLIT_PAGE + 1, SPLIT_PAGE) if "paged" in name else (s, SPLIT_T)
    k = torch.randint(-127, 128, (*rows, hkv, d), device=dev, generator=g, dtype=torch.int8)
    v = torch.randint(-127, 128, (*rows, hkv, d), device=dev, generator=g, dtype=torch.int8)
    ks = torch.rand(*rows, hkv, device=dev, generator=g) / 127 * 8
    vs = torch.rand(*rows, hkv, device=dev, generator=g) / 127
    tail = ()
    if "paged" in name:
        ks[0], vs[0] = float("nan"), float("nan")
        mp = SPLIT_T // SPLIT_PAGE
        perm = (torch.randperm(rows[0] - 1, device=dev, generator=g) + 1).to(torch.int32)
        table = torch.zeros(s, mp, dtype=torch.int32, device=dev)
        for i, n in enumerate(lengths.tolist()):
            live = mp if all_pages else (n + w - 1) // SPLIT_PAGE + 1
            table[i, :live] = perm[i * mp:i * mp + live]
        tail = (table,)
    caches = _flat_of(k, v, ks, vs) if name.startswith("flat_") else (k, v, ks, vs)
    if w == 1:
        q = q[:, 0]
    return q, caches, tail, lengths, rep


def _finite_page0(caches):
    k, v, ks, vs = caches
    ks, vs = ks.clone(), vs.clone()
    ks[0], vs[0] = 1.0, 1.0
    return k, v, ks, vs


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("heads", sorted(SPLIT_HEADS))
@pytest.mark.parametrize("name", DECODE_SIDE)
def test_decode_side_kernels_at_split_shapes(dev, name, heads, s):
    w = SPLIT_HEADS[heads][3] if "window" in name else 1
    edges = [0, 63, 64, SPLIT_T - w]
    cases = [edges] if s == 4 else [[n] for n in edges]
    fn, plain = getattr(da, name), getattr(da, name + "_plain")
    for lengths in cases:
        q, caches, tail, lens, rep = _split_case(dev, name, heads, lengths, sum(lengths) + s)
        hkv, d = SPLIT_HEADS[heads][0], SPLIT_HEADS[heads][2]
        t = SPLIT_T
        assert da.decode_split_plan(s, hkv, t, w, rep, d).splits == 16
        before = da.launches[name]
        got = fn(q, *caches, *tail, lens, rep)
        again = fn(q, *caches, *tail, lens, rep)
        torch.cuda.synchronize()
        assert da.launches[name] == before + 2  # the merge kernel counts no launch
        assert torch.equal(got, again)  # splits merged in order: the same bits
        assert bool(torch.isfinite(got.float()).all())  # page 0 (NaN scales) never read
        if name.startswith("flat_"):  # bit-equal to the standard twin on the same cache
            k, v, ks, vs = caches
            hkv = ks.shape[-2]
            std = (da.std_kv_view(k, hkv), da.std_kv_view(v, hkv),
                   da.std_scale_view(ks).contiguous(), da.std_scale_view(vs).contiguous())
            assert torch.equal(got, getattr(da, name[len("flat_"):])(q, *std, *tail, lens, rep))
        ref_caches = _finite_page0(caches) if "paged" in name else caches
        _close(got, plain(q, *ref_caches, *tail, lens, rep), 1e-2)


@pytest.mark.parametrize("name", DECODE_SIDE)
def test_decode_side_kernel_graph_replays_with_other_lengths(dev, name):
    """A CUDA graph of one call (4 slots, 16 splits: the workspace comes
    from the graph's pool) replayed after new lengths are copied into
    its lengths buffer gives the eager call's bits for those lengths."""
    heads = "d64_rep4"
    w = SPLIT_HEADS[heads][3] if "window" in name else 1
    first, second = [0, 63, 64, SPLIT_T - w], [SPLIT_T - w, 200, 1, 700]
    q, caches, tail, lens, rep = _split_case(dev, name, heads, first, 31, all_pages=True)
    fn = getattr(da, name)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(q, *caches, *tail, lens, rep)  # build, bind and warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(q, *caches, *tail, lens, rep)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fn(q, *caches, *tail, lens, rep))
    lens.copy_(torch.tensor(second, dtype=torch.int32, device=dev))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fn(q, *caches, *tail, lens, rep))
    _close(out, getattr(da, name + "_plain")(q, *caches, *tail, lens, rep), 1e-2)


# -- the engine off the TPU tiling gate --------------------------------------------
#
# The JAX package routes decode, verify and paged attention to its TPU
# kernels only where max_len and the page are multiples of 128 rows. On
# the card the port's kernels take any length and page: an engine at
# max_len 96 with 16-row pages still attends through them.

ENGINE_CASES = {
    "dense": (dict(), "decode_attention"),
    "dense_lookup": (dict(speculate_k=3, prompt_lookup_ngram=2), "window_decode_attention"),
    "paged": (dict(kv_page_size=16), "paged_decode_attention"),
    "paged_lookup": (dict(kv_page_size=16, speculate_k=3, prompt_lookup_ngram=2),
                     "paged_window_decode_attention"),
    "flat": (dict(kv_cache_layout="flat"), "flat_decode_attention"),
    "flat_lookup": (dict(kv_cache_layout="flat", speculate_k=3, prompt_lookup_ngram=2),
                    "flat_window_decode_attention"),
    "flat_paged": (dict(kv_cache_layout="flat", kv_page_size=16), "flat_paged_decode_attention"),
    "flat_paged_lookup": (dict(kv_cache_layout="flat", kv_page_size=16, speculate_k=3,
                               prompt_lookup_ngram=2), "flat_paged_window_decode_attention"),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_with_small_pages_runs_the_attention_kernels(dev, case):
    import numpy as np

    from starpu_inference_server_tpu_torch.models import decoder as td
    from starpu_inference_server_tpu_torch.ops import nn
    from starpu_inference_server_tpu_torch.serving import generation as tgen
    from starpu_inference_server_tpu_torch.weights import params_from_numpy

    kw, kernel = ENGINE_CASES[case]
    spec = td.get_spec("llama-tiny", {"layers": 2, "hidden": 256, "q_heads": 4, "kv_heads": 2,
                                      "intermediate": 256, "vocab": 128})
    params = params_from_numpy(td.init_params(spec, np.random.default_rng(0)))
    prompts = [[3, 7, 11, 3, 7, 11, 3], [5, 2, 9, 1, 13], list(range(1, 21))]

    def serve():
        eng = tgen.GenerationEngine(spec, params, dtype=torch.float32, device="cuda",
                                    num_slots=2, max_len=96, prefill_buckets=[16, 32],
                                    steps_per_sync=2, decode_overlap=True, pipeline_depth=3,
                                    **kw)
        eng.start()
        try:
            reqs = [tgen.GenerationRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=12)
                    for p in prompts]
            for r in reqs:
                eng.submit(r)
            return [r.result(timeout=300) for r in reqs]
        finally:
            eng.stop()

    before = da.launches[kernel]
    got = serve()
    torch.cuda.synchronize()
    assert da.launches[kernel] > before
    nn.set_use_kernels(False)
    try:
        want = serve()
    finally:
        nn.set_use_kernels(None)
    # f32 compute: the kernel and the plain route differ only in the
    # order of f32 sums, far from any greedy tie of these weights
    assert got == want


# -- overlapped dispatch ------------------------------------------------------------

@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("case", ["dense", "paged_lookup"])
def test_chained_block_does_not_sync_the_host(dev, case, sampled):
    """A block chained off the previous block's device carry makes no
    host sync: it is dispatched under sync debug mode "error", which
    raises on any synchronizing call. Both blocks' tokens then arrive on
    the host, the second continuing the first. With ``sampled`` one of
    the two slots samples (temperature 0.8, top-k 40): its draws run on
    the device too."""
    import numpy as np

    from starpu_inference_server_tpu_torch.models import decoder as td
    from starpu_inference_server_tpu_torch.serving import generation as tgen
    from starpu_inference_server_tpu_torch.weights import params_from_numpy

    kw = {"dense": dict(kv_cache_layout="flat"),
          "paged_lookup": dict(kv_page_size=16, speculate_k=3, prompt_lookup_ngram=2)}[case]
    spec = td.get_spec("llama-tiny", {"layers": 2, "hidden": 256, "q_heads": 4, "kv_heads": 2,
                                      "intermediate": 256, "vocab": 128})
    params = params_from_numpy(td.init_params(spec, np.random.default_rng(0)))
    eng = tgen.GenerationEngine(spec, params, dtype=torch.float32, device="cuda", num_slots=2,
                                max_len=96, prefill_buckets=[16], steps_per_sync=2,
                                decode_overlap=True, pipeline_depth=2, **kw)
    for prompt, temp in (([3, 7, 11, 3, 7], 0.8 if sampled else 0.0), ([5, 2, 9], 0.0)):
        eng.submit(tgen.GenerationRequest(prompt_ids=np.asarray(prompt, np.int32),
                                          max_new_tokens=20, temperature=temp, top_k=40,
                                          seed=3))
    eng._admit_pending()
    eng._land_prefills(force=True)
    snap = eng._snapshot_active()
    assert (snap["sample"] is not None) == sampled
    first = eng._dispatch_block(snap["ids_dev"], snap["progress_dev"], snap)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            first["prog"].sum().item()  # the mode is on: a sync raises
        chained = eng._dispatch_block(first["nxt"], first["prog"], snap, first["alive"], 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = [eng._fetch(r["host"], r["event"]).copy() for r in (first, chained)]
    assert got[0].shape == got[1].shape and not np.array_equal(got[0], got[1])


# -- the greedy decode block as one CUDA graph -------------------------------------
#
# Every greedy block of an engine whose block is _decode_and_sample is a
# replay of one captured graph. Each case is an engine of llama-tiny's
# registered widths (2 layers) at bf16 on a tree that routes its dense
# layers through a kernel: int4 (K1) standard and flat, int8 (K2) paged,
# and W4A8 (K6); and moe-tiny's (2 layers, 4 experts) at int8, whose
# router and attention projections run K2 and whose experts run two
# batched contractions on the dequantized stacks.

GRAPH_CASES = {
    "int4": (4, dict(), False, "int4_matmul"),
    "int4_flat": (4, dict(kv_cache_layout="flat"), False, "int4_matmul"),
    "int8_paged": (8, dict(kv_page_size=16), False, "int8_matmul"),
    "w4a8": (4, dict(), True, "int4_matmul_w4a8"),
    "moe_int8": (8, dict(), False, "int8_matmul"),
}


def _graph_engine(case, depth):
    import numpy as np

    from starpu_inference_server_tpu_torch.models import decoder as td
    from starpu_inference_server_tpu_torch.ops import nn
    from starpu_inference_server_tpu_torch.ops.quant import maybe_quantize_tree
    from starpu_inference_server_tpu_torch.serving import generation as tgen
    from starpu_inference_server_tpu_torch.weights import params_from_numpy

    bits, kw, w8a8, _ = GRAPH_CASES[case]
    spec = td.get_spec("moe-tiny" if case.startswith("moe") else "llama-tiny", {"layers": 2})
    params = maybe_quantize_tree(params_from_numpy(td.init_params(spec, np.random.default_rng(0))),
                                 bits)
    nn.set_w8a8(w8a8)
    return tgen.GenerationEngine(spec, params, dtype=torch.bfloat16, device="cuda", num_slots=4,
                                 max_len=128, prefill_buckets=[16, 32], prefill_chunk=32,
                                 steps_per_sync=3, decode_overlap=depth > 1,
                                 pipeline_depth=depth, **kw)


def _graph_prompts():
    return [[3, 7, 11, 3, 7, 11, 3], list(range(1, 41)), [5, 2, 9, 1, 13], [4, 8, 4, 8],
            [9, 9, 2], list(range(40, 52))]


def _admit_all(eng, n):
    import numpy as np

    from starpu_inference_server_tpu_torch.serving import generation as tgen

    for p in _graph_prompts()[:n]:
        eng.submit(tgen.GenerationRequest(prompt_ids=np.asarray(p, np.int32),
                                          max_new_tokens=16))
    for _ in range(8):
        eng._admit_pending()
    eng._land_prefills(force=True)
    assert eng.active_count() == n


def _cache_tensors(cache):
    out = [cache.lengths]
    for leaves in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        out.extend(leaves)
    if hasattr(cache, "table"):
        out.append(cache.table)
    return out


@pytest.fixture
def w8a8_off():
    from starpu_inference_server_tpu_torch.ops import nn

    yield
    nn.set_w8a8(False)


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graphed_block_equals_the_eager_body(dev, w8a8_off, case, depth):
    """``depth`` blocks (one, or one and three chained off the carry) by
    replay, captured and replayed under sync debug mode "error", against
    the body called eagerly on a second engine in the same state: equal
    tokens, equal carry, equal cache bytes; each replay adds the body's
    launches to the counters."""
    import numpy as np

    counter = GRAPH_CASES[case][3]
    eng, ref = _graph_engine(case, depth), _graph_engine(case, depth)
    _admit_all(eng, 4)
    _admit_all(ref, 4)
    snap, rsnap = eng._snapshot_active(), ref._snapshot_active()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        recs = [eng._dispatch_block(snap["ids_dev"], snap["progress_dev"], snap)]
        before = mk.launches[counter]
        for chain in range(1, depth):
            last = recs[-1]
            recs.append(eng._dispatch_block(last["nxt"], last["prog"], snap, last["alive"],
                                            chain))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    replayed = mk.launches[counter] - before
    got = [eng._fetch(r["host"], r["event"]).copy() for r in recs]
    block = eng._greedy
    assert block.graph is not None and block.replays == depth
    # the warm-up the engine ran before its capture: one block on its
    # fresh buffers (ids 0) with no slot alive, whose parked writes (row
    # t_max - 1, or garbage page 0) land in the cache too
    zeros = torch.zeros_like(rsnap["ids_dev"])
    ref._decode_and_sample(zeros, zeros > 0, zeros,
                           {"eos_dev": zeros - 1, "limit_dev": zeros, "sample": None})
    ids, alive, prog = rsnap["ids_dev"], rsnap["active_dev"], rsnap["progress_dev"]
    want = []
    for _ in range(depth):
        b0 = mk.launches[counter]
        tokens, ids, prog, alive = ref._decode_and_sample(ids, alive, prog, rsnap)
        eager_launches = mk.launches[counter] - b0
        want.append(tokens.cpu().numpy())
    # steps x (the kernel's dense layers a layer x 2 layers + lm_head): an
    # MoE layer has three (qkv, o, the router), a dense one four
    assert eager_launches == 3 * ((3 if case.startswith("moe") else 4) * 2 + 1)
    assert replayed == (depth - 1) * eager_launches
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(block.ids, ids) and torch.equal(block.prog, prog)
    assert torch.equal(block.alive, alive)
    for a, b in zip(_cache_tensors(eng.cache), _cache_tensors(ref.cache)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graphed_engine_streams_equal_at_depth_1_and_4(dev, w8a8_off, case):
    """Served greedy streams through the replayed graph, six requests on
    four slots (slot churn, a chunked prompt): depth 4 equals depth 1,
    and both engines replayed their graph."""
    import numpy as np

    from starpu_inference_server_tpu_torch.serving import generation as tgen

    outs = {}
    for depth in (1, 4):
        eng = _graph_engine(case, depth)
        reqs = [tgen.GenerationRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=n)
                for p, n in zip(_graph_prompts(), (14, 9, 17, 6, 12, 10))]
        for r in reqs:
            eng.submit(r)
        eng.start()
        try:
            outs[depth] = [r.result(timeout=300) for r in reqs]
        finally:
            eng.stop()
        assert eng._greedy.replays > 0
    assert outs[1] == outs[4]
    assert [len(o) for o in outs[4]] == [14, 9, 17, 6, 12, 10]


def test_a_failed_capture_raises_and_fails_the_open_requests(dev, monkeypatch):
    """A capture that fails raises out of the block, and the engine loop
    fails the open requests; the body never runs eagerly in its place."""
    import numpy as np

    from starpu_inference_server_tpu_torch.serving import generation as tgen

    eng = _graph_engine("int4", 1)

    def broken(self, body, key):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(tgen._GreedyBlock, "_capture", broken)
    req = tgen.GenerationRequest(prompt_ids=np.asarray([3, 7, 11], np.int32), max_new_tokens=8)
    eng.submit(req)
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="capture failed"):
            req.result(timeout=120)
    finally:
        eng.stop()


def test_engine_prefills_every_bucket_through_the_prefill_kernels(dev):
    """Off the JAX package's TPU gate: at max_len 96 with buckets 16 and 32
    and 32-token chunks, every prefill and chunk of the card's engine runs
    causal_attention or chunk_prefill_attention, and the FP32 streams
    equal the plain route's."""
    import numpy as np

    from starpu_inference_server_tpu_torch.models import decoder as td
    from starpu_inference_server_tpu_torch.ops import nn
    from starpu_inference_server_tpu_torch.serving import generation as tgen
    from starpu_inference_server_tpu_torch.weights import params_from_numpy

    spec = td.get_spec("llama-tiny", {"layers": 2, "hidden": 256, "q_heads": 4, "kv_heads": 2,
                                      "intermediate": 256, "vocab": 128})
    params = params_from_numpy(td.init_params(spec, np.random.default_rng(0)))
    prompts = [[3, 7, 11, 3, 7, 11, 3], list(range(1, 21)), list(range(5, 45))]

    def serve():
        eng = tgen.GenerationEngine(spec, params, dtype=torch.float32, device="cuda",
                                    num_slots=2, max_len=96, prefill_buckets=[16, 32],
                                    prefill_chunk=32, steps_per_sync=2)
        eng.start()
        try:
            reqs = [tgen.GenerationRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=10)
                    for p in prompts]
            for r in reqs:
                eng.submit(r)
            return [r.result(timeout=300) for r in reqs]
        finally:
            eng.stop()

    before = dict(pa.launches)
    got = serve()
    torch.cuda.synchronize()
    # 2 layers x (two bucketed prefills; the 40-token prompt's two chunks)
    assert pa.launches["causal_attention"] - before["causal_attention"] == 4
    assert pa.launches["chunk_prefill_attention"] - before["chunk_prefill_attention"] == 4
    nn.set_use_kernels(False)
    try:
        want = serve()
    finally:
        nn.set_use_kernels(None)
    assert got == want


def test_prefill_at_head_dim_32_runs_the_kernels(dev):
    """llama-tiny's head_dim 32: a prefill runs causal_attention once a
    layer and a chunk chunk_prefill_attention once a layer, each within
    the attention limit of its plain version, at bf16 (tensor cores) and
    f32 (CUDA cores)."""
    import numpy as np

    from starpu_inference_server_tpu_torch.models import decoder as td

    spec = td.get_spec("llama-tiny", {"layers": 2})
    assert spec.head_dim == 32 and spec.rep == 2
    g = _gen(dev, 32)
    for dtype in (torch.bfloat16, torch.float32):
        for t in (64, 100, 256):
            q = (3 * torch.randn(1, t, spec.q_heads, 32, device=dev, generator=g)).to(dtype)
            k = torch.randn(1, t, spec.kv_heads, 32, device=dev, generator=g).to(dtype)
            v = torch.randn(1, t, spec.kv_heads, 32, device=dev, generator=g).to(dtype)
            got = pa.causal_attention(q, k, v, spec.rep)
            assert torch.equal(got, pa.causal_attention(q, k, v, spec.rep))
            torch.cuda.synchronize()
            assert _attn_limit(got, pa.causal_attention_plain(q, k, v, spec.rep))
        c, tmax = 64, 256
        k_row = torch.randint(-127, 128, (tmax, spec.kv_heads, 32), device=dev, generator=g,
                              dtype=torch.int8)
        v_row = torch.randint(-127, 128, (tmax, spec.kv_heads, 32), device=dev, generator=g,
                              dtype=torch.int8)
        ks = torch.rand(tmax, spec.kv_heads, device=dev, generator=g) * 0.01 + 0.01
        vs = torch.rand(tmax, spec.kv_heads, device=dev, generator=g) / 127 + 1e-3
        for start in (0, 37, 128):
            q = (3 * torch.randn(c, spec.q_heads, 32, device=dev, generator=g)).to(dtype)
            kc = torch.randn(c, spec.kv_heads, 32, device=dev, generator=g).to(dtype)
            vc = torch.randn(c, spec.kv_heads, 32, device=dev, generator=g).to(dtype)
            args = (q, k_row, v_row, ks, vs, kc, vc, start, spec.rep)
            got = pa.chunk_prefill_attention(*args)
            torch.cuda.synchronize()
            assert _attn_limit(got, pa.chunk_prefill_attention_plain(*args))
    from starpu_inference_server_tpu_torch.weights import params_from_numpy

    params = params_from_numpy(td.init_params(spec, np.random.default_rng(0)), device=dev)
    cache = td.init_cache(spec, 1, 96, device=dev)
    before = dict(pa.launches)
    td.prefill(spec, params, cache, torch.arange(1, 33, dtype=torch.int32, device=dev), 30, 0,
               torch.bfloat16)
    td.prefill_chunk(spec, params, cache, torch.arange(3, 35, dtype=torch.int32, device=dev),
                     30, 32, 0, torch.bfloat16)
    torch.cuda.synchronize()
    assert pa.launches["causal_attention"] - before["causal_attention"] == spec.layers
    assert (pa.launches["chunk_prefill_attention"] - before["chunk_prefill_attention"]
            == spec.layers)


@pytest.mark.parametrize("head_dim", [48, 112])
def test_prefill_outside_the_kernels_limits_raises(dev, head_dim):
    """On the card a prefill never turns to the plain attention: a
    head_dim the kernels do not take (they take 32, 64, 80, 96, 128 and
    256) raises in the causal kernel's wrapper, and the kernel is never
    launched."""
    import numpy as np

    from starpu_inference_server_tpu_torch.models import decoder as td
    from starpu_inference_server_tpu_torch.weights import params_from_numpy

    spec = td.get_spec("llama-tiny", {"layers": 1, "hidden": 4 * head_dim, "q_heads": 4,
                                      "kv_heads": 2, "intermediate": 256, "vocab": 128})
    assert spec.head_dim == head_dim
    params = params_from_numpy(td.init_params(spec, np.random.default_rng(0)), device=dev)
    cache = td.init_cache(spec, 1, 96, device=dev)
    ids = torch.arange(1, 33, dtype=torch.int32, device=dev)
    before = pa.launches["causal_attention"]
    with pytest.raises(ValueError, match="causal_attention kernel needs D"):
        td.prefill(spec, params, cache, ids, 30, 0, torch.float32)
    assert pa.launches["causal_attention"] == before


# -- W8A8 convolutions and the MoE MLP on the card ------------------------------------

@pytest.mark.parametrize("m,k,n", [(17, 64, 128), (784, 64, 128), (100, 147, 4),
                                   (25088, 576, 64), (40, 4608, 512)])
def test_int_mm_s32_on_the_card_is_exact(dev, m, k, n):
    """``torch._int_mm`` through ``_int_mm_s32`` (K and N padded to
    multiples of 8, the weight column-major): exact s32 sums at shapes the
    row-major form is refused at (K = 64 at 17 and 784 rows), at the
    unfolded stem's K = 147 with a grouped conv's N = 4, and at ResNet's
    widest windows (3x3x512: sums past 2^24)."""
    from starpu_inference_server_tpu_torch.ops import nn

    g = _gen(dev, m + k + n)
    x = torch.randint(-127, 128, (m, k), device=dev, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), device=dev, generator=g, dtype=torch.int8)
    got = nn._int_mm_s32(x, w)
    assert got.dtype == torch.int32
    assert torch.equal(got.double(), x.double() @ w.double())


@pytest.mark.parametrize("case", ["stride2", "groups32", "stem_k147", "s2d_k192", "vit_k768"])
def test_w8a8_conv_on_the_card_equals_the_cpu(dev, case):
    """The W8A8 conv on CUDA tensors (``torch._int_mm``) gives the CPU
    route's bits (float64 sums) at bf16, in every shape class of the
    paths: a strided 3x3, ResNeXt's 32 groups, both ResNet stems and the
    ViT patch conv."""
    from starpu_inference_server_tpu_torch.ops import nn
    from starpu_inference_server_tpu_torch.ops.quant import maybe_quantize_tree

    shape, kh, cin_g, out, stride, padding, groups = {
        "stride2": ((4, 28, 28, 64), 3, 64, 128, 2, 1, 1),
        "groups32": ((2, 14, 14, 128), 3, 4, 128, 2, 1, 32),
        "stem_k147": ((2, 56, 56, 3), 7, 3, 64, 2, 3, 1),
        "s2d_k192": ((2, 56, 56, 12), 4, 12, 64, 1, [(2, 1), (2, 1)], 1),
        "vit_k768": ((2, 224, 224, 3), 16, 3, 1024, 16, "VALID", 1),
    }[case]
    g = torch.Generator().manual_seed(7)
    x = torch.randn(shape, generator=g)
    p = maybe_quantize_tree({"w": torch.randn(kh, kh, cin_g, out, generator=g) * 0.1,
                             "b": torch.randn(out, generator=g)}, 8)
    nn.set_w8a8(True)
    try:
        want = nn.conv2d(p, x, stride=stride, padding=padding, groups=groups)
        cuda_p = {"w": {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                        for k, v in p["w"].items()}, "b": p["b"].to(dev)}
        got = nn.conv2d(cuda_p, x.to(dev), stride=stride, padding=padding, groups=groups)
    finally:
        nn.set_w8a8(False)
    assert torch.equal(got.cpu(), want)



def test_a_served_image_gets_its_batch_1_answer_at_every_bucket(dev):
    """The batch engine's bf16 ResNet answers an image the same, bit for
    bit, alone and inside padded batches of 2-32 rows, as the
    schedule-replay client's ``--validate`` requires: every conv runs on
    chunks of ``CONV_ROWS`` images (``ops/nn.py:_cudnn_conv``); one cuDNN
    call over the batch changes kernels from N = 4 on these shapes."""
    import numpy as np

    from starpu_inference_server_tpu_torch.core.engine import ModelEngine
    from starpu_inference_server_tpu_torch.models.registry import build_model
    from starpu_inference_server_tpu_torch.utils.config import parse_config

    cfg = parse_config({
        "name": "r", "model": {"family": "resnet18", "compute_dtype": "BF16",
                               "quantization": "int8"},
        "inputs": [{"name": "input", "dims": [3, 224, 224], "dtype": "FP32"}],
        "outputs": [{"name": "output", "dims": [1000], "dtype": "FP32"}],
        "pool_size": 1, "max_batch_size": 32, "batch_coalesce_timeout_ms": 0,
        "batching_strategy": "disabled", "metrics_enabled": False,
    })
    engine = ModelEngine(cfg, build_model(cfg.model, seed=42, device=dev))
    images = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (5, 3, 224, 224)).astype(np.float32)).to(torch.bfloat16)

    def answer(batch):
        return engine.fetch(engine.run_padded({"input": batch}))["output"]

    alone = [answer(images[i:i + 1])[0] for i in range(5)]
    for bucket in (2, 4, 8, 16, 32):
        got = answer(images[torch.arange(bucket) % 5])
        for row in range(bucket):
            assert torch.equal(got[row], alone[row % 5]), (bucket, row)
