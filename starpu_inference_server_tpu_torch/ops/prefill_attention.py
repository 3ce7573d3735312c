"""Fused prefill attention: causal, chunked-prefill and encoder attention.

- ``causal_attention`` replaces the TPU kernel
  ``starpu_inference_server_tpu/ops/prefill_attention.py:causal_attention``
  (``_causal_kernel``) with ``csrc/causal_attention.cu``.
- ``chunk_prefill_attention`` replaces ``chunk_prefill_attention``
  (``_chunk_kernel``) with ``csrc/chunk_prefill_attention.cu``.
- ``bidirectional_attention`` replaces ``bidirectional_attention``
  (``_bidir_kernel``) with ``csrc/bidirectional_attention.cu``: every
  query attends every key, under an ADDITIVE key bias (0 / -1e9), so a
  fully masked sample gives the mean of v and never NaN.

Bound on the H100: at the main-path shapes (64- to 1024-row blocks) the
least time is set by the few MB of inputs and outputs, with the bf16
tensor-core rate close behind. The bf16 route of all three kernels is
one tensor-core flash tile (``csrc/flash_mma.cuh``): 64 query rows a
block, mma.sync for Q K^T and P V, a cp.async double buffer of K/V
tiles, the online softmax on the accumulator fragments and P carried as
two bf16 terms so its weights stay f32-exact. The kernels differ in
their key source: the encoder's additive key bias over every key tile;
the causal kernel's tiles up to the block's last position, masked per
element only on the diagonal tile, longest query tiles first; the
chunked kernel's int8 past, staged as int8 and widened to bf16 in shared
memory with the scales applied in f32 to S's and P's columns, then the
chunk's own keys causally. A block holds 64 positions of one query head:
on the H100 that measured 1-5% ahead of the TPU's KV-major packing of
(position, rep head) rows, which shares each K/V tile among the rep
heads (PERF.md). The f32 route of each keeps the
one-row-per-thread CUDA-core body, whose f32 probabilities the FP32
witnesses hold to 1e-5. The [Hq, T, T] scores never reach device memory.

The ``*_plain`` functions beside them compute the same function in plain
PyTorch: CPU tensors take them, and on the card they are only the
references the kernels are checked against.
Layouts are the JAX package's: q ``[B, T, Hq, D]`` / ``[C, Hq, D]``, K/V
with ``Hkv`` heads and no GQA repeats. The causal and chunked kernels
take any rep and head_dim 32 (llama-tiny), 64, 80 (Phi-2), 96
(Phi-3-mini), 128 and 256 (Gemma; key tiles of 32 there), the encoder
kernel 64 and 128; another head_dim raises in the wrapper.
"""

from __future__ import annotations

import math

import torch

from ..monitoring.trace import ranged
from . import _build

launches = {"causal_attention": 0, "chunk_prefill_attention": 0,
            "bidirectional_attention": 0}

_fns = {}

_NEG = -1e30


def _bound(name: str, symbol: str, n_ptrs: int, n_ints: int):
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = _build.bind(name, symbol, n_ptrs, n_ints)
    return fn


# head dims each kernel is instantiated for; any other raises in the
# wrapper (there is no plain fallback on the card)
PREFILL_HEAD_DIMS = (32, 64, 80, 96, 128, 256)
ENCODER_HEAD_DIMS = (64, 128)


def check_kernel_args(dtype, rep: int, d: int, what: str, dims=PREFILL_HEAD_DIMS) -> None:
    """What a prefill kernel takes: f32 or bf16, a head dim it is built
    for, any ``rep >= 1``; raises otherwise (there is no plain fallback on
    the card)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes f32 or bf16, got {dtype}")
    if d not in dims or rep < 1:
        raise ValueError(f"{what} kernel needs D in {dims} and rep >= 1 (D={d}, rep={rep})")


def causal_attention_plain(q, k, v, rep: int, out_dtype=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D), causal, -1e30 mask) v in f32."""
    b, t, hq, d = q.shape
    out_dtype = out_dtype or q.dtype
    kf = k.to(torch.float32).repeat_interleave(rep, dim=2)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) / math.sqrt(d)
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(causal[None, None], logits, torch.full_like(logits, _NEG))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(out_dtype)


@ranged("ops.attn")
def causal_attention(q, k, v, rep: int, out_dtype=None) -> torch.Tensor:
    """Flash causal attention, q [B, T, Hq, D] against k/v [B, T, Hkv, D].
    Rows attend keys at positions <= their own; padding rows come out as
    garbage callers never read (the TPU kernel's contract)."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    if hq != hkv * rep:
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)}, rep {rep}")
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return causal_attention_plain(q, k, v, rep, out_dtype)
    check_kernel_args(q.dtype, rep, d, "causal_attention")
    q, k, v = (a.to(q.dtype).contiguous() for a in (q, k, v))
    out = torch.empty_like(q)
    fn = _bound("causal_attention", "sis_causal_attention", 4, 6)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, hkv,
            rep, d, _build.BF16 if q.dtype == torch.bfloat16 else _build.F32,
            _build.stream_ptr(q))
    _build.check(rc, "causal_attention")
    launches["causal_attention"] += 1
    return out if out_dtype == q.dtype else out.to(out_dtype)


def chunk_prefill_attention_plain(q, k_row, v_row, k_scale, v_scale, k_cur, v_cur,
                                  start: int, rep: int, out_dtype=None) -> torch.Tensor:
    """prefill_chunk's two-part attention under one f32 softmax: cache
    positions < start (int8 * scale) then in-chunk keys j <= row."""
    c, hq, d = q.shape
    t = k_row.shape[0]
    out_dtype = out_dtype or q.dtype
    qf = q.to(torch.float32)
    inv = 1.0 / math.sqrt(d)
    past_k = (k_row.to(torch.float32) * k_scale.unsqueeze(-1)).repeat_interleave(rep, dim=1)
    past_v = (v_row.to(torch.float32) * v_scale.unsqueeze(-1)).repeat_interleave(rep, dim=1)
    cur_k = k_cur.to(torch.float32).repeat_interleave(rep, dim=1)
    cur_v = v_cur.to(torch.float32).repeat_interleave(rep, dim=1)
    s_past = torch.einsum("qhd,khd->hqk", qf, past_k) * inv
    pos = torch.arange(t, device=q.device)
    s_past = torch.where((pos < start)[None, None, :], s_past,
                         torch.full_like(s_past, _NEG))
    s_cur = torch.einsum("qhd,khd->hqk", qf, cur_k) * inv
    causal = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    s_cur = torch.where(causal[None], s_cur, torch.full_like(s_cur, _NEG))
    probs = torch.softmax(torch.cat([s_past, s_cur], dim=-1), dim=-1)
    out = torch.einsum("hqk,khd->qhd", probs[..., :t], past_v)
    out = out + torch.einsum("hqk,khd->qhd", probs[..., t:], cur_v)
    return out.to(out_dtype)


@ranged("ops.attn")
def chunk_prefill_attention(q, k_row, v_row, k_scale, v_scale, k_cur, v_cur,
                            start: int, rep: int, out_dtype=None) -> torch.Tensor:
    """One prompt chunk q [C, Hq, D] against the slot's int8 cache row
    [T, Hkv, D] (positions < ``start``) and its own keys [C, Hkv, D]
    (causal), under one softmax. ``start`` is a host int: the engine
    tracks chunk offsets on the host, so no layer syncs the device."""
    c, hq, d = q.shape
    t, hkv, _ = k_row.shape
    if hq != hkv * rep:
        raise ValueError(f"q {tuple(q.shape)} vs cache row {tuple(k_row.shape)}, rep {rep}")
    start = int(start)
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return chunk_prefill_attention_plain(q, k_row, v_row, k_scale, v_scale,
                                             k_cur, v_cur, start, rep, out_dtype)
    check_kernel_args(q.dtype, rep, d, "chunk_prefill_attention")
    if k_row.dtype != torch.int8 or v_row.dtype != torch.int8:
        raise TypeError("chunk_prefill_attention needs an int8 cache row")
    tensors = [q.contiguous(), k_row.contiguous(), v_row.contiguous(),
               k_scale.to(torch.float32).contiguous(),
               v_scale.to(torch.float32).contiguous(),
               k_cur.to(q.dtype).contiguous(), v_cur.to(q.dtype).contiguous()]
    out = torch.empty((c, hq, d), dtype=q.dtype, device=q.device)
    fn = _bound("chunk_prefill_attention", "sis_chunk_prefill_attention", 8, 7)
    rc = fn(*(a.data_ptr() for a in tensors), out.data_ptr(), c, t, hkv, rep, d, start,
            _build.BF16 if q.dtype == torch.bfloat16 else _build.F32, _build.stream_ptr(q))
    _build.check(rc, "chunk_prefill_attention")
    launches["chunk_prefill_attention"] += 1
    return out if out_dtype == q.dtype else out.to(out_dtype)


def bidirectional_attention_plain(q, k, v, key_bias, rep: int = 1,
                                  out_dtype=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + key_bias) v with f32 q/k/v and f32
    probabilities (the TPU kernel's arithmetic)."""
    d = q.shape[-1]
    out_dtype = out_dtype or q.dtype
    kf = k.to(torch.float32).repeat_interleave(rep, dim=2)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) / math.sqrt(d)
    logits = logits + key_bias.to(torch.float32)[:, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(out_dtype)


def bidirectional_attention(q, k, v, key_bias, rep: int = 1, out_dtype=None) -> torch.Tensor:
    """Encoder self-attention, q [B, T, Hq, D] against k/v [B, T, Hkv, D]
    with an additive key bias f32 [B, T] (0 = attend, -1e9 = masked)."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    if hq != hkv * rep:
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)}, rep {rep}")
    if tuple(key_bias.shape) != (b, t):
        raise ValueError(f"key_bias {tuple(key_bias.shape)} is not [B, T] = [{b}, {t}]")
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return bidirectional_attention_plain(q, k, v, key_bias, rep, out_dtype)
    check_kernel_args(q.dtype, rep, d, "bidirectional_attention", ENCODER_HEAD_DIMS)
    if 128 % rep:  # its f32 route packs rep heads' rows into a 128-row tile
        raise ValueError(f"bidirectional_attention kernel needs rep dividing 128 (rep={rep})")
    q, k, v = (a.to(q.dtype).contiguous() for a in (q, k, v))
    bias = key_bias.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    fn = _bound("bidirectional_attention", "sis_bidirectional_attention", 5, 6)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, t, hkv, rep, d, _build.BF16 if q.dtype == torch.bfloat16 else _build.F32,
            _build.stream_ptr(q))
    _build.check(rc, "bidirectional_attention")
    launches["bidirectional_attention"] += 1
    return out if out_dtype == q.dtype else out.to(out_dtype)
