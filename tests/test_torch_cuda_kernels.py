"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc (sm_90a); without one each test skips.
On the card machine run them with

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

They cover the edges chip_smoke.py does not: ragged M, N and K for the
int4 and int8 kernels (odd N that forbids 4-byte weight loads, M over
one 32-row band), f32 and bf16 inputs, rep 1 and 8, head_dim 128,
lengths 0 and T-1, prompts that are not a multiple of the query tile, a
fully masked encoder sample, and the fused stem at f32 and bf16 output."""

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 64, 130), (17, 98, 257), (200, 2048, 384)])
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


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3])
def test_fused_stem_kernel(dev, out_dtype, b):
    g = _gen(dev, b)
    zp = torch.zeros(b, 118, 118, 12, device=dev)
    zp[:, 3:115, 3:115] = torch.randn(b, 112, 112, 12, device=dev, generator=g)
    w = (torch.randn(192, 64, device=dev, generator=g) * 0.1).to(torch.bfloat16)
    scale = torch.rand(64, device=dev, generator=g) + 0.5
    shift = torch.randn(64, device=dev, generator=g) * 0.1
    torch.backends.cudnn.allow_tf32 = False
    got = sk.fused_stem(zp, w, scale, shift, out_dtype)
    torch.cuda.synchronize()
    _close(got, sk.fused_stem_plain(zp, w, scale, shift, out_dtype),
           1e-2 if out_dtype == torch.bfloat16 else 2e-5)
