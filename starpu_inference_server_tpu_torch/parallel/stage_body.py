"""Tensor- and expert-parallel decoder pieces of the stage programs.

Counterpart of ``starpu_inference_server_tpu/parallel/stage_body.py``:
written in LOCAL head / intermediate / expert counts (each rank holds
one block-aligned shard, ``parallel/tp_layout.py``), and owning the
collectives GSPMD would insert: one :func:`~.collectives.psum` over
``model`` after each row-parallel projection, one over (``expert``,
``model``) for the MoE combine. With a size-1 ``model`` (and
``expert``) axis the sums are no-ops, so one body serves every mesh.
The dense layers go through ``ops.nn.dense``, so the int8 / int4
kernels (K2, K1, K6) run wherever the single-device gate picks them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import nn
from .collectives import psum
from .mesh import EXPERT_AXIS, MODEL_AXIS, RankMesh


def local_qkv_slices(spec, tp: int):
    """(dq, dkv, qh, kvh): column widths and head counts of one rank's
    block-aligned fused-qkv shard ``[q_d | k_d | v_d]``."""
    qh = spec.q_heads // tp
    kvh = spec.kv_heads // tp
    d = spec.head_dim
    return qh * d, kvh * d, qh, kvh


def tp_project_qkv(spec, tp: int, layer, h, dtype):
    """One fused LOCAL matmul -> (q, k, v) flat column slices of the rank's
    heads (``models/decoder._project_qkv`` at tp 1)."""
    fused = nn.dense(layer["attn"]["qkv"], h, dtype)
    dq, dkv, _, _ = local_qkv_slices(spec, tp)
    return fused[..., :dq], fused[..., dq:dq + dkv], fused[..., dq + dkv:]


def tp_attn_out(mesh: RankMesh, layer, attn, dtype):
    """Row-parallel output projection: the local head columns against the
    local row shard of ``o``, summed over ``model``."""
    return psum(mesh, nn.dense(layer["attn"]["o"], attn, dtype), MODEL_AXIS)


def tp_dense_mlp(mesh: RankMesh, layer, h, dtype):
    """SwiGLU with the column-parallel gate_up (local ``[gate_d | up_d]``)
    and the row-parallel down, summed over ``model``."""
    fused = nn.dense(layer["mlp"]["gate_up"], h, dtype)
    inter = fused.shape[-1] // 2
    act = F.silu(fused[..., :inter].to(torch.float32)).to(dtype) * fused[..., inter:]
    return psum(mesh, nn.dense(layer["mlp"]["down"], act, dtype), MODEL_AXIS)


def tp_moe_mlp(mesh: RankMesh, spec, layer, h, dtype):
    """Routed SwiGLU MoE under manual EP x TP: every rank routes over ALL
    experts (the router replicates), computes its local experts' local
    columns, and one sum over (``expert``, ``model``) completes both the
    combine and the row-parallel reduction (``models/decoder._moe_mlp``'s
    dense-dispatch form)."""
    from ..models.decoder import _expert_matmul, _top_k_ranks

    moe = layer["mlp"]
    lead = h.shape[:-1]
    xf = h.reshape(-1, h.shape[-1])
    logits = nn.dense(moe["router"], xf, dtype).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    ranks = _top_k_ranks(probs)
    picked = [(ranks == r).to(torch.float32) for r in range(spec.experts_per_token)]
    vals = [(probs * p).sum(dim=-1) for p in picked]
    total = sum(vals)
    combine = sum(p * (v / total)[:, None] for p, v in zip(picked, vals))  # [T, E]
    wg = nn.resolve_weight(moe["experts"]["gate_up"]["w"], dtype)  # [E_l, H, 2I_l]
    wd = nn.resolve_weight(moe["experts"]["down"]["w"], dtype)     # [E_l, I_l, H]
    e_local = wg.shape[0]
    off = mesh.coord(EXPERT_AXIS) * e_local
    combine_l = combine[:, off:off + e_local]
    he = _expert_matmul(xf.to(dtype).expand(e_local, *xf.shape), wg)
    inter = he.shape[-1] // 2
    act = (F.silu(he[..., :inter]) * he[..., inter:]).to(dtype)
    y = _expert_matmul(act, wd)
    y = torch.einsum("te,eth->th", combine_l, y)
    y = psum(mesh, y, (EXPERT_AXIS, MODEL_AXIS))
    return y.reshape(*lead, h.shape[-1]).to(dtype)


def tp_mlp_block(mesh: RankMesh, spec, layer, h, dtype):
    """Dense or routed MLP, decided by the param tree (a ``router``)."""
    if "router" in layer["mlp"]:
        return tp_moe_mlp(mesh, spec, layer, h, dtype)
    return tp_dense_mlp(mesh, layer, h, dtype)
