"""Weight-only quantization: INT8 / INT4 per-channel symmetric.

Counterpart of ``starpu_inference_server_tpu/ops/quant.py``; the same
numbers bit for bit (IEEE f32 division and round-half-to-even in both):

    w ~= w_q.float() * scale        (int8: w_q in [-127, 127]; int4: [-7, 7])

INT4 values live in an int8 carrier until :func:`pack_int4_tree` packs
them PAIRWISE along the first axis: byte row ``a`` of the packed
``[K/2, N]`` uint8 array holds row ``2a`` in its low nibble and row
``2a+1`` in its high nibble, sign-extended on unpack. This is the layout
of the code (``ops/quant.py:pack_int4``), which the CUDA int4 kernel
reads; ``docs/architecture.md`` still describes an older planar layout.
"""

from __future__ import annotations

from typing import Optional

import torch


def quantize_per_channel(
    w: torch.Tensor, bits: int = 8, axis: int = -1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``w`` symmetrically per channel along ``axis``.

    Returns (w_q int8, scale f32) with scale shaped like w reduced over
    all axes except ``axis`` (kept as size-1 dims)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qmax = 127.0 if bits == 8 else 7.0
    w = w.to(torch.float32)
    keep = axis % w.dim()
    reduce_axes = tuple(i for i in range(w.dim()) if i != keep)
    absmax = w.abs().amax(dim=reduce_axes, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    w_q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return w_q, scale


def dequantize(
    w_q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16
) -> torch.Tensor:
    return (w_q.to(torch.float32) * scale).to(dtype)


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric INT8 activation quantization (the W8A8 /
    W4A8 paths). Returns ``(x_q int8 [..., K], scale f32 [..., 1])``;
    all-zero rows get scale 1."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    x_q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x_q, scale


def pack_int4(w_q: torch.Tensor) -> torch.Tensor:
    """Pack an int4-valued int8 tensor pairwise along the first axis into
    one uint8 per two values (low nibble = even row, high = odd row)."""
    if w_q.shape[0] % 2 != 0:
        raise ValueError("int4 packing requires an even leading dim")
    lo = (w_q[0::2].to(torch.int16) & 0x0F).to(torch.uint8)
    hi = (w_q[1::2].to(torch.int16) & 0x0F).to(torch.uint8)
    return lo | (hi << 4)


def _sext4(nib: torch.Tensor) -> torch.Tensor:
    nib = nib.to(torch.int8)
    return torch.where(nib >= 8, nib - 16, nib)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; returns sign-extended int8 values."""
    lo = _sext4(packed & 0x0F)
    hi = _sext4((packed >> 4) & 0x0F)
    return torch.stack([lo, hi], dim=1).reshape(
        packed.shape[0] * 2, *packed.shape[1:]
    )


def unpack_int4_rows(packed: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Rows ``rows`` of ``unpack_int4(packed)`` without unpacking the rest:
    row r lives in byte row r // 2, low nibble when r is even."""
    rows = rows.to(torch.int64)
    byte = packed[rows // 2]
    odd = (rows % 2 == 1).reshape(*rows.shape, *([1] * (packed.dim() - 1)))
    return _sext4(torch.where(odd, byte >> 4, byte & 0x0F))


def _is_float_tensor(value) -> bool:
    return isinstance(value, torch.Tensor) and value.is_floating_point()


def maybe_quantize_tree(params, bits: Optional[int], axis: int = -1):
    """Quantize every float tensor named 'w' / 'kernel' (rank >= 2) in a
    nested dict tree, leaving biases and norm parameters in float.
    Quantized leaves become {'w_q': int8, 'scale': f32, 'bits': bits}."""
    if bits is None:
        return params

    def rec(node):
        if isinstance(node, dict):
            out = {}
            for key, value in node.items():
                if key in ("w", "kernel") and _is_float_tensor(value) and value.dim() >= 2:
                    if value.dim() == 3 and axis in (-1, 2):
                        # stacked [E, in, out] experts: reduce only the
                        # contraction axis -> scale [E, 1, out]
                        w = value.to(torch.float32)
                        qmax = 127.0 if bits == 8 else 7.0
                        absmax = w.abs().amax(dim=1, keepdim=True)
                        scale = torch.where(
                            absmax > 0, absmax / qmax, torch.ones_like(absmax)
                        )
                        w_q = torch.clamp(
                            torch.round(w / scale), -qmax, qmax
                        ).to(torch.int8)
                        out[key] = {"w_q": w_q, "scale": scale, "bits": bits}
                        continue
                    w_q, scale = quantize_per_channel(value, bits=bits, axis=axis)
                    out[key] = {"w_q": w_q, "scale": scale, "bits": bits}
                else:
                    out[key] = rec(value)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return node

    return rec(params)


def is_quantized_leaf(node) -> bool:
    return isinstance(node, dict) and "w_q" in node and "scale" in node


def is_packed_int4_leaf(node) -> bool:
    return isinstance(node, dict) and "w_p4" in node and "scale" in node


def pack_int4_tree(params):
    """Convert int4 quantized leaves (int8 carrier) to the pairwise packed
    format the CUDA int4 kernel reads: {'w_p4': uint8 [K/2, N], 'scale',
    'bits': 4}. Leaves with odd K (or rank != 2) stay unpacked."""

    def rec(node):
        if is_quantized_leaf(node):
            if node.get("bits") == 4 and node["w_q"].dim() == 2 and \
                    node["w_q"].shape[0] % 2 == 0:
                return {
                    "w_p4": pack_int4(node["w_q"]),
                    "scale": node["scale"],
                    "bits": 4,
                }
            return node
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return node

    return rec(params)
