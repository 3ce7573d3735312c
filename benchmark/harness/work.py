"""Operations and bytes of the work a run dispatched, counted from the
model's shapes (``bench.model.Shape``) and the traced run's work records,
never from the calls the port makes.

- A decode step of ``a`` live slots: the linear layers read every weight
  once at its stored width and do ``2 * params * a`` operations; attention
  reads each live slot's int8 keys and values (with their scales) over its
  context and does ``4 * layers * q_heads * head_dim * context`` a slot.
- A prefill pass of ``rows`` valid tokens from ``start``: every weight once,
  ``2 * params * rows`` for the layers and one row through the lm head;
  attention reads the int8 cache before ``start`` and the pass's own bf16
  q, k, v and output, and does the causal products.

The ideal time of a step or pass is ``max(bytes / HBM bandwidth,
operations / dense bf16 peak)``; a roofline share is the ideal time summed
over a slice divided by the device time its kernels took.
"""

from __future__ import annotations

from .model import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_S


def _ideal(bytes_, flops) -> float:
    return max(bytes_ / PEAK_HBM_BYTES_S, flops / PEAK_BF16_FLOPS)


def tally(shape, blocks, prefills, prefill_attention: bool = True) -> dict:
    """Operations and ideal seconds of ``blocks`` (each a list of (context,
    steps) of its live slots) and ``prefills`` ((rows, start) each).
    ``prefill_attention`` False leaves the prefills' attention out of the
    attention ideal (where no timed range encloses it)."""
    lin = 2.0 * shape.linear_params(lm_head=True)
    lin_layers = 2.0 * shape.linear_params(lm_head=False)
    head = 2.0 * shape.hidden * shape.vocab
    wbytes = shape.weight_bytes()
    kvpos = shape.kv_bytes_per_position()
    per_key = shape.attn_flops(1.0)
    out = {"gemm_flops": 0.0, "attn_flops": 0.0, "gemm_ideal_s": 0.0, "attn_ideal_s": 0.0,
           "decode_tokens": 0, "prefill_tokens": 0}
    for live in blocks:
        steps = max((s for _, s in live), default=0)
        for j in range(steps):
            ctx = [c + j + 1 for c, s in live if j < s]
            a = len(ctx)
            f_gemm = lin * a
            f_attn = per_key * sum(ctx)
            out["gemm_flops"] += f_gemm
            out["attn_flops"] += f_attn
            out["gemm_ideal_s"] += _ideal(wbytes, f_gemm)
            out["attn_ideal_s"] += _ideal(kvpos * sum(ctx), f_attn)
            out["decode_tokens"] += a
    qkvo = shape.layers * 2 * 2 * (shape.q_heads + shape.kv_heads) * shape.head_dim
    for rows, start in prefills:
        f_gemm = lin_layers * rows + head
        keys = rows * start + rows * (rows + 1) / 2
        f_attn = per_key * keys
        out["gemm_flops"] += f_gemm
        out["attn_flops"] += f_attn
        out["gemm_ideal_s"] += _ideal(wbytes, f_gemm)
        if prefill_attention:
            out["attn_ideal_s"] += _ideal(kvpos * start + qkvo * rows, f_attn)
        out["prefill_tokens"] += rows
    return out
