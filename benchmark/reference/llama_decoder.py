"""Plain PyTorch reference of a llama-class decoder (Phi-3, Mistral): the
forward pass over whole sequences in float32, with no kernel, no cache and no
batching of the program under test. It imports nothing of the port.

From the benchmark's own weight tree (the int8 or int4 values and their f32
per-column scales, exactly as handed to the port) it works out again:

- the weights, ``w_q * scale`` in float32;
- RMSNorm ``x * rsqrt(mean(x^2) + eps) * gamma``;
- rotary embedding over the head's two halves (``rotate_half``), base
  ``rope_theta``;
- grouped-query attention (query head ``h`` reads kv head ``h // rep``),
  causal, scaled by ``1/sqrt(head_dim)``, with every key and value rounded
  through the serving cache's int8 format (symmetric, one f32 scale per
  token and kv head);
- the SwiGLU MLP over the fused ``[gate | up]`` projection.

``precision="fp8"`` is the control: every matrix product takes its
activations rounded to float8 e4m3 with one dynamic scale per row (per
token, the usual fp8 serving recipe), the step below the bfloat16 the
configurations state. TF32 is switched off for the call.
Sliding windows are not modelled: every cell keeps its contexts inside the
configuration's window, so the window has no effect.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

ROW_BLOCK = 2048


def _dequant(leaf, device) -> torch.Tensor:
    return leaf["w_q"].to(device=device, dtype=torch.float32) * leaf["scale"].to(device).float()


def _round_fp8(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    s = amax.clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    out = []
    for i in range(0, x.shape[0], ROW_BLOCK):
        xb = x[i:i + ROW_BLOCK]
        if precision == "fp8":
            xb = _round_fp8(xb, xb.abs().amax(dim=-1, keepdim=True))
        out.append(xb @ w)
    return torch.cat(out)


def _rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * gamma.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, heads, D] at positions 0..T-1."""
    t, _, d = x.shape
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _int8_round_trip(x: torch.Tensor) -> torch.Tensor:
    """[T, heads, D] through the cache's format: int8 with one f32 scale a
    (token, head)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def _attention(q, k, v, rep: int) -> torch.Tensor:
    """Causal GQA over one sequence: q [T, Hq, D], k/v [T, Hkv, D]."""
    t, hq, d = q.shape
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v).reshape(t, hq * d)


def logits(tree, shape, sequences: Sequence[torch.Tensor], scored: Sequence[int],
           device, precision: str = "f32") -> List[torch.Tensor]:
    """For each sequence of token ids, the logits [T - scored, vocab] at
    positions ``scored..T-1`` (``scored[i]`` of sequence ``i``). ``shape``
    gives hidden, heads, intermediate, ``rope_theta`` and ``rms_norm_eps``."""
    if precision not in ("f32", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _logits(tree, shape, sequences, scored, device, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def _logits(tree, shape, sequences, scored, device, precision):
    d, hq, hkv = shape.head_dim, shape.q_heads, shape.kv_heads
    rep, eps = hq // hkv, shape.rms_norm_eps
    ids = torch.cat([s.to(device=device, dtype=torch.int64) for s in sequences])
    bounds = [0]
    for s in sequences:
        bounds.append(bounds[-1] + len(s))
    emb = tree["embed"]["w"]
    x = emb["w_q"].to(device)[ids].float() * emb["scale"].to(device).float().reshape(1, -1)
    for layer in tree["layers"]:
        h = _rms_norm(x, layer["attn_norm"]["gamma"].to(device), eps)
        qkv = _matmul(h, _dequant(layer["attn"]["qkv"]["w"], device), precision)
        attn = torch.empty((x.shape[0], hq * d), dtype=torch.float32, device=device)
        for a, b in zip(bounds[:-1], bounds[1:]):
            part = qkv[a:b]
            q = _rope(part[:, :hq * d].reshape(-1, hq, d), shape.rope_theta)
            k = _rope(part[:, hq * d:(hq + hkv) * d].reshape(-1, hkv, d), shape.rope_theta)
            v = part[:, (hq + hkv) * d:].reshape(-1, hkv, d)
            attn[a:b] = _attention(q, _int8_round_trip(k), _int8_round_trip(v), rep)
        del qkv
        x = x + _matmul(attn, _dequant(layer["attn"]["o"]["w"], device), precision)
        del attn
        h = _rms_norm(x, layer["mlp_norm"]["gamma"].to(device), eps)
        w_gu = _dequant(layer["mlp"]["gate_up"]["w"], device)
        w_d = _dequant(layer["mlp"]["down"]["w"], device)
        inter = w_gu.shape[1] // 2
        for i in range(0, x.shape[0], ROW_BLOCK):
            gu = _matmul(h[i:i + ROW_BLOCK], w_gu, precision)
            act = torch.nn.functional.silu(gu[:, :inter]) * gu[:, inter:]
            x[i:i + ROW_BLOCK] += _matmul(act, w_d, precision)
        del w_gu, w_d
    rows = torch.cat([torch.arange(a + s, b, device=device)
                      for a, b, s in zip(bounds[:-1], bounds[1:], scored)])
    h = _rms_norm(x[rows], tree["final_norm"]["gamma"].to(device), eps)
    out = _matmul(h, _dequant(tree["lm_head"]["w"], device), precision)
    parts, start = [], 0
    for a, b, s in zip(bounds[:-1], bounds[1:], scored):
        n = b - a - s
        parts.append(out[start:start + n])
        start += n
    return parts
