"""Functional NN layers, quantization-aware (decoder subset).

Counterpart of ``starpu_inference_server_tpu/ops/nn.py``: ``dense``
keeps the JAX package's five-way dispatch, ``resolve_weight`` and
``embedding`` take dense or quantized leaves alike.

The kernel switch (``set_use_kernels``, the counterpart of
``set_use_pallas``) is AUTO by default: kernel routes are taken exactly
when the tensors are on CUDA. ``set_use_kernels(True)`` forces them on
CPU as well, where every kernel wrapper runs its plain version (the
tests compare that route with the JAX package's interpret-mode
kernels); ``set_use_kernels(False)`` turns them off on the card too.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import matmul_kernels as mk
from .quant import (
    dequantize,
    is_packed_int4_leaf,
    is_quantized_leaf,
    quantize_activations,
    unpack_int4,
    unpack_int4_rows,
)

_USE_KERNELS: Optional[bool] = None  # None = auto: on for CUDA tensors
_W8A8 = False


def set_use_kernels(enabled: Optional[bool]) -> None:
    """True / False force the kernel routes on / off; None restores auto."""
    global _USE_KERNELS
    _USE_KERNELS = None if enabled is None else bool(enabled)


def use_kernels(where) -> bool:
    """Whether kernel routes apply on ``where``: a tensor (its device) or
    a device."""
    if _USE_KERNELS is not None:
        return _USE_KERNELS
    if isinstance(where, torch.Tensor):
        return where.is_cuda
    return torch.device(where).type == "cuda"


def set_w8a8(enabled: bool) -> None:
    """W8A8 / W4A8 compute: dense layers quantize their activations per
    row and contract s8 x s8 (the JAX package's ``set_w8a8``)."""
    global _W8A8
    _W8A8 = bool(enabled)


def resolve_weight(w, dtype=torch.bfloat16) -> torch.Tensor:
    """Materialize a (possibly quantized/packed) weight at compute dtype."""
    if is_packed_int4_leaf(w):
        return dequantize(unpack_int4(w["w_p4"]), w["scale"], dtype=dtype)
    if is_quantized_leaf(w):
        return dequantize(w["w_q"], w["scale"], dtype=dtype)
    return w.to(dtype)


def _int_dot(x_q: torch.Tensor, w_int: torch.Tensor) -> torch.Tensor:
    """Exact s8 x s8 contraction (XLA's preferred_element_type=int32),
    computed in float64 where every partial sum is exact."""
    return (x_q.to(torch.float64) @ w_int.to(torch.float64)).to(torch.float32)


def dense(p, x: torch.Tensor, dtype=torch.bfloat16, act_quant: bool = True) -> torch.Tensor:
    """y = x @ w + b with ``p = {'w': [in, out] dense or quantized, 'b'?}``.

    Dispatch, in the JAX package's order (``ops/nn.py:85-160``):
    packed int4 + W8A8 + kernels -> W4A8 kernel (K6, not ported: raises
    on CUDA); packed int4 + kernels -> the CUDA int4 kernel; packed int4
    + W8A8 -> exact s8 contraction; int8 at <= 64 rows + kernels -> int8
    kernel (K2, not ported: raises on CUDA); int8 + W8A8 -> exact s8
    contraction; anything else -> dequantize, then a matmul with f32
    accumulation (plain ``torch.matmul``: XLA did this work on the TPU).
    """
    w = p["w"]
    lead = x.shape[:-1]
    rows = 1
    for d in lead:
        rows *= d
    kern = use_kernels(x)
    use_w8a8 = _W8A8 and act_quant
    if is_packed_int4_leaf(w) and kern and use_w8a8:
        x2 = x.reshape(rows, x.shape[-1])
        x_q, sx = quantize_activations(x2)
        y = mk.int4_matmul_w4a8(x_q, sx, w["w_p4"], w["scale"])
        y = y.reshape(*lead, -1)
    elif is_packed_int4_leaf(w) and kern:
        x2 = x.reshape(rows, x.shape[-1])
        y = mk.int4_matmul(x2.to(dtype), w["w_p4"], w["scale"])
        y = y.reshape(*lead, -1)
    elif is_packed_int4_leaf(w) and use_w8a8:
        x2 = x.reshape(rows, x.shape[-1])
        x_q, sx = quantize_activations(x2)
        y = _int_dot(x_q, unpack_int4(w["w_p4"])) * sx * w["scale"].reshape(1, -1)
        y = y.reshape(*lead, -1)
    elif is_quantized_leaf(w) and kern and rows <= 64:
        x2 = x.reshape(rows, x.shape[-1])
        y = mk.int8_matmul(x2.to(dtype), w["w_q"], w["scale"])
        y = y.reshape(*lead, -1)
    elif is_quantized_leaf(w) and use_w8a8:
        x2 = x.reshape(rows, x.shape[-1])
        x_q, sx = quantize_activations(x2)
        y = _int_dot(x_q, w["w_q"]) * sx * w["scale"].reshape(1, -1)
        y = y.reshape(*lead, -1)
    else:
        # products of dtype-rounded operands, accumulated in f32 (the
        # JAX path's preferred_element_type=float32)
        wm = resolve_weight(w, dtype)
        y = torch.matmul(x.to(dtype).to(torch.float32), wm.to(torch.float32))
    if "b" in p and p["b"] is not None:
        y = y + p["b"].to(torch.float32)
    return y.to(dtype)


def embedding(p, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Token embedding lookup, ``p = {'w': [vocab, dim]}`` dense or
    quantized. A packed int4 table is gathered in its packed form (row r
    is byte row r // 2, low nibble when r is even) and only the gathered
    rows are dequantized: the same numbers as dequantizing the whole
    table first, as the JAX package does, without touching the rest of
    it."""
    w = p["w"]
    if is_packed_int4_leaf(w):
        rows = unpack_int4_rows(w["w_p4"], ids)
        return dequantize(rows, w["scale"].reshape(-1), dtype=dtype)
    if is_quantized_leaf(w):
        return dequantize(w["w_q"][ids.to(torch.int64)], w["scale"].reshape(-1), dtype=dtype)
    return w[ids.to(torch.int64)].to(dtype)
