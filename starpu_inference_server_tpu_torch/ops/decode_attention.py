"""Fused INT8-KV decode attention.

``decode_attention`` replaces the TPU kernels
``starpu_inference_server_tpu/ops/decode_attention.py:decode_attention``
(``_grouped_kernel`` and ``_kernel``) with the hand-written CUDA kernel
in ``csrc/decode_attention.cu``. Bound on the H100: device-memory bytes
(the live int8 K/V rows and scales, read once per step). Design: one
block per (KV head, slot) serves the head's ``rep`` query heads, so each
K/V byte is read once, and its chunk loop stops at the slot's length.

:func:`decode_attention_plain` is the same function in plain PyTorch:
CPU tensors take it, and on the card it is only the reference the kernel
is checked against.

Standard cache layout only: ``k``/``v`` int8 ``[S, T, Hkv, D]``, scales
f32 ``[S, T, Hkv]``. Slot ``s`` attends positions ``<= lengths[s]``.
"""

from __future__ import annotations

import math

import torch

from . import _build

launches = {"decode_attention": 0}

_fn = None


def decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale, lengths,
                           rep: int, out_dtype=None) -> torch.Tensor:
    """Dequantize, score in f32 (1/sqrt(D)), mask positions > lengths[s]
    with -1e30, softmax in f32, weighted sum of V. Output [S, Hq, D]."""
    s, hq, d = q.shape
    t = k_cache.shape[1]
    out_dtype = out_dtype or q.dtype
    k = k_cache.to(torch.float32) * k_scale.unsqueeze(-1)
    v = v_cache.to(torch.float32) * v_scale.unsqueeze(-1)
    k = k.repeat_interleave(rep, dim=2)  # [S, T, Hq, D]
    v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("shd,sthd->sht", q.to(torch.float32), k) / math.sqrt(d)
    pos = torch.arange(t, device=q.device)
    mask = pos[None, None, :] <= lengths.to(torch.int64)[:, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("sht,sthd->shd", probs, v).to(out_dtype)


def decode_attention(q, k_cache, v_cache, k_scale, v_scale, lengths,
                     rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, Hq, D] against the int8 cache; returns [S, Hq, D] in
    ``out_dtype`` (default q's). CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    s, hq, d = q.shape
    _, t, hkv, dk = k_cache.shape
    if hq != hkv * rep or dk != d:
        raise ValueError(f"q {tuple(q.shape)} vs cache {tuple(k_cache.shape)}, rep {rep}")
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale,
                                      lengths, rep, out_dtype)
    global _fn
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention takes f32 or bf16 queries, got {q.dtype}")
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
        raise TypeError("decode_attention needs an int8 cache")
    if d % 16 or rep > 8 or rep * d > 1024:
        raise ValueError(f"decode_attention kernel needs D % 16 == 0, rep <= 8 and "
                         f"rep * D <= 1024 (D={d}, rep={rep})")
    tensors = [q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
               k_scale.to(torch.float32).contiguous(),
               v_scale.to(torch.float32).contiguous(),
               lengths.to(torch.int32).contiguous()]
    for a in tensors[1:3]:
        if a.data_ptr() % 16:
            raise ValueError("decode_attention needs 16-byte aligned K/V")
    out = torch.empty((s, hq, d), dtype=q.dtype, device=q.device)
    if _fn is None:
        _fn = _build.bind("decode_attention", "sis_decode_attention", 7, 6)
    rc = _fn(*(a.data_ptr() for a in tensors), out.data_ptr(), s, t, hkv, rep, d,
             _build.BF16 if q.dtype == torch.bfloat16 else _build.F32,
             _build.stream_ptr(q))
    _build.check(rc, "decode_attention")
    launches["decode_attention"] += 1
    return out if out_dtype == q.dtype else out.to(out_dtype)
