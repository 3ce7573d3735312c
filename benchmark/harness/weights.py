"""The model's weights, made on the device from ``--seed``.

One ``torch.Generator`` on the device draws each kind of leaf for every
layer in one call (bf16 normals), and each layer's slice is then quantised
symmetrically per output column to the int8 or int4 values the port serves
(``{'w_q': int8 [K, N], 'scale': f32 [1, N], 'bits': b}``; int4 values in
[-7, 7] in an int8 carrier, which the port packs itself). The same tree is
handed to the port and, once the window has closed, to the reference.
"""

from __future__ import annotations

import math

import torch


def quantize(w: torch.Tensor, bits: int):
    """(int8 values, f32 scale [1, N]) of a [K, N] weight, one symmetric
    scale per column."""
    qmax = 127.0 if bits == 8 else 7.0
    w = w.float()
    absmax = w.abs().amax(dim=0, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    return torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8), scale


def _stacked(gen, layers: int, cin: int, cout: int, bits: int, device):
    """One leaf kind for every layer: drawn in one call, quantised a layer
    at a time into one int8 tensor; returns the per-layer leaves."""
    draw = torch.randn((layers, cin, cout), generator=gen, device=device, dtype=torch.bfloat16)
    values = torch.empty((layers, cin, cout), dtype=torch.int8, device=device)
    scales = torch.empty((layers, 1, cout), dtype=torch.float32, device=device)
    std = 1.0 / math.sqrt(cin)
    for li in range(layers):
        values[li], scales[li] = quantize(draw[li].float() * std, bits)
    del draw
    return [{"w_q": values[li], "scale": scales[li], "bits": bits} for li in range(layers)]


def make(shape, seed: int, device) -> dict:
    """The parameter tree of ``shape`` (a ``bench.model.Shape``) from
    ``seed``, quantised to ``shape.weight_bits``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    bits, h, L = shape.weight_bits, shape.hidden, shape.layers
    qkv = _stacked(gen, L, h, shape.qkv_out, bits, device)
    o = _stacked(gen, L, shape.q_heads * shape.head_dim, h, bits, device)
    gate_up = _stacked(gen, L, h, 2 * shape.intermediate, bits, device)
    down = _stacked(gen, L, shape.intermediate, h, bits, device)
    gammas = 1.0 + 0.1 * torch.randn((2 * L + 1, h), generator=gen, device=device)
    embed_q, embed_s = quantize(torch.randn((shape.vocab, h), generator=gen, device=device), bits)
    head_q, head_s = quantize(torch.randn((h, shape.vocab), generator=gen, device=device)
                              / math.sqrt(h), bits)
    layers = [{
        "attn_norm": {"gamma": gammas[2 * li]},
        "attn": {"qkv": {"w": qkv[li]}, "o": {"w": o[li]}},
        "mlp_norm": {"gamma": gammas[2 * li + 1]},
        "mlp": {"gate_up": {"w": gate_up[li]}, "down": {"w": down[li]}},
    } for li in range(L)]
    return {
        "embed": {"w": {"w_q": embed_q, "scale": embed_s, "bits": bits}},
        "layers": layers,
        "final_norm": {"gamma": gammas[2 * L]},
        "lm_head": {"w": {"w_q": head_q, "scale": head_s, "bits": bits}},
    }
