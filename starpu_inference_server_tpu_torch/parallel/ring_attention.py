"""Sequence parallelism: ring-attention causal prefill over a mesh axis.

Counterpart of ``starpu_inference_server_tpu/parallel/ring_attention.py``.
When a prompt is too long for one device's activations, the sequence
dimension itself shards over a mesh axis: each rank holds T/N contiguous
tokens, and attention sees every key by rotating the K/V shards round
the ring (:func:`~.collectives.ppermute_ring` on that axis's ranks, one
hop a step). The online-softmax recurrence folds one K/V block a step
into running (m, l, acc) statistics, so the rotation is exact. Blocks in
the causal future still hop (the ranks after them need them) and fold to
nothing.

The JAX body reaches no Pallas kernel, and neither does this one: it is
the same fold in plain PyTorch, f32 throughout.

Tensor parallelism composes: heads shard over ``model`` inside the same
program, the layer body summing its row-parallel projections over
``model`` (``parallel/stage_body.py``, as in the JAX program).
"""

from __future__ import annotations

import math

import torch

from .collectives import all_gather, ppermute_ring
from .mesh import DATA_AXIS, MODEL_AXIS

_NEG = -1e30


def ring_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                          axis: str, rep: int = 1) -> torch.Tensor:
    """Causal attention with the sequence sharded over ``axis``: ``q``
    [B, Tl, Hq, D] (rope applied), ``k`` / ``v`` [B, Tl, Hkv, D], the
    rank's LOCAL shard; the rank at coordinate i holds global positions
    ``i*Tl .. (i+1)*Tl-1``. The K/V blocks go once round the ring, every
    query sees every key once, folded by the online softmax. Returns
    [B, Tl, Hq, D] at ``q``'s dtype."""
    n = mesh.size(axis)
    my = mesh.coord(axis)
    b, tl, hq, d = q.shape
    inv = 1.0 / math.sqrt(d)
    dev = q.device
    qf = q.to(torch.float32)
    rows = my * tl + torch.arange(tl, dtype=torch.int32, device=dev)  # global q positions
    m = torch.full((b, hq, tl), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, tl), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, tl, d), dtype=torch.float32, device=dev)
    kb, vb = k, v
    for i in range(n):
        # the block resident now arrived after i hops: it started at my - i
        src = (my - i) % n
        kf = kb.repeat_interleave(rep, dim=2).to(torch.float32)
        vf = vb.repeat_interleave(rep, dim=2).to(torch.float32)
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * inv  # [B, H, Tl, Tl]
        cols = src * tl + torch.arange(tl, dtype=torch.int32, device=dev)
        mask = cols[None, None, None, :] <= rows[None, None, :, None]
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vf)
        m = m_new
        kb = ppermute_ring(mesh, kb, axis)
        vb = ppermute_ring(mesh, vb, axis)
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # [B, H, Tl, D]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def sequence_parallel_decoder_logits(spec, params, ids: torch.Tensor, mesh,
                                     dtype=torch.bfloat16,
                                     seq_axis: str = DATA_AXIS) -> torch.Tensor:
    """Teacher-forcing decoder forward with the SEQUENCE dimension sharded
    over ``seq_axis`` (long-context prefill or scoring; the JAX function's
    contract). Every rank passes the whole tree and the whole ``ids``
    [B, T] (T divisible by the axis size); it runs its T/N tokens. Every
    op but attention is token-local; attention is
    :func:`ring_causal_attention`. Tensor parallelism over ``model``
    composes: the layers are block-shuffled and cut by the decoder rules,
    the embedding and lm head stay whole (the JAX program's replicated
    ``rest``). Returns [B, T, vocab] f32 logits on every rank."""
    from ..models.decoder import rms_norm, rope
    from ..ops import nn
    from .partition import _DECODER_RULES, shard_params
    from .stage_body import local_qkv_slices, tp_attn_out, tp_mlp_block, tp_project_qkv
    from .tp_layout import shuffle_decoder_layer_for_tp, validate_decoder_tp

    n = mesh.size(seq_axis)
    tp = mesh.size(MODEL_AXIS)
    validate_decoder_tp(spec, tp)
    b, t = ids.shape
    if t % n != 0:
        raise ValueError(f"sequence {t} not divisible by seq axis {n}")
    tl = t // n
    _, _, qh, kvh = local_qkv_slices(spec, tp)
    d = spec.head_dim
    rep = qh // kvh
    layers = params["layers"]
    if tp > 1:
        layers = [shuffle_decoder_layer_for_tp(spec, layer, tp) for layer in layers]
    layers = shard_params({"layers": layers}, mesh.coords, mesh.shape, _DECODER_RULES)["layers"]

    my = mesh.coord(seq_axis)
    ids_l = ids[:, my * tl:(my + 1) * tl]
    positions = my * tl + torch.arange(tl, dtype=torch.int32, device=ids.device)[None, :]
    x = nn.embedding(params["embed"], ids_l, dtype)  # [B, Tl, D]
    for layer in layers:
        h = rms_norm(layer["attn_norm"], x)
        qf, kf, vf = tp_project_qkv(spec, tp, layer, h, dtype)
        q = rope(qf.reshape(b, tl, qh, d), positions)
        k = rope(kf.reshape(b, tl, kvh, d), positions)
        v = vf.reshape(b, tl, kvh, d)
        attn = ring_causal_attention(q, k, v, mesh, seq_axis, rep=rep)
        attn = attn.reshape(b, tl, qh * d).to(dtype)
        x = x + tp_attn_out(mesh, layer, attn, dtype)
        h = rms_norm(layer["mlp_norm"], x)
        x = x + tp_mlp_block(mesh, spec, layer, h, dtype)
    x = rms_norm(params["final_norm"], x)
    logits = nn.dense(params["lm_head"], x, dtype).to(torch.float32)
    return all_gather(mesh, logits, seq_axis, dim=1)


__all__ = ["ring_causal_attention", "sequence_parallel_decoder_logits"]
