"""Pipeline parallelism over the mesh ``pipe`` axis: stacked layers, the
GPipe microbatch forward and the pipelined decoder forward.

Counterpart of ``starpu_inference_server_tpu/parallel/pipeline.py``.
The L identical layers are STACKED (every leaf gains a leading [L]
axis, :func:`stack_layers`) and the stack is cut over ``pipe``: stage s
holds layers [s L/S, (s+1) L/S). :func:`pipeline_forward` runs the JAX
skewed schedule, M + S - 1 ticks with one ring hop
(:func:`~.collectives.ppermute_ring`) a tick, stage s on microbatch
t - s at tick t; a stage computes nothing on its fill / drain ticks (it
still takes part in the hop, so the ring stays in step), and the last
stage's outputs are summed over ``pipe`` from a buffer that is zero
elsewhere, so every rank returns them, as the JAX masked ``psum`` does.

Tensor and expert parallelism compose inside each stage with the
collectives of ``parallel/stage_body.py`` and the block-shuffled fused
layouts of ``parallel/tp_layout.py``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..ops.quant import is_packed_int4_leaf, is_quantized_leaf
from .collectives import ppermute_ring, psum
from .mesh import MODEL_AXIS, PIPE_AXIS, RankMesh
from .partition import Rules, shard_params, shard_stacked_layers


def _stack(arrays):
    first = arrays[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(list(arrays))
    import numpy as np

    return np.stack(arrays)


def stack_layers(layers):
    """[{...}, {...}] per-layer trees -> one tree whose leaves carry a
    leading [L] axis. Quantized leaves stack their arrays and keep
    ``bits`` (layers must agree on it). numpy or torch leaves."""

    def rec(nodes):
        first = nodes[0]
        if is_quantized_leaf(first) or is_packed_int4_leaf(first):
            wkey = "w_p4" if "w_p4" in first else "w_q"
            bits = first["bits"]
            if any(n["bits"] != bits for n in nodes):
                raise ValueError("cannot stack layers with mixed quant bits")
            return {wkey: _stack([n[wkey] for n in nodes]),
                    "scale": _stack([n["scale"] for n in nodes]), "bits": bits}
        if isinstance(first, dict):
            return {k: rec([n[k] for n in nodes]) for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(rec([n[i] for n in nodes]) for i in range(len(first)))
        return _stack(nodes)

    return rec(list(layers))


def num_stacked(stacked) -> int:
    """The [L] extent of a stacked tree."""
    if is_quantized_leaf(stacked) or is_packed_int4_leaf(stacked):
        return stacked["scale"].shape[0]
    if isinstance(stacked, dict):
        return num_stacked(next(iter(stacked.values())))
    if isinstance(stacked, (list, tuple)):
        return num_stacked(stacked[0])
    return stacked.shape[0]


def unstack_layers(stacked) -> list:
    """A stacked tree -> the list of its per-layer trees (views)."""

    def take(node, i):
        if is_quantized_leaf(node) or is_packed_int4_leaf(node):
            return {k: (v if k == "bits" else v[i]) for k, v in node.items()}
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(take(v, i) for v in node)
        return node[i]

    return [take(stacked, i) for i in range(num_stacked(stacked))]


def pipeline_forward(
    mesh: RankMesh,
    layer_fn: Callable,
    stacked_params,
    x: torch.Tensor,
    num_microbatches: int,
    rules: Rules = None,
    local: bool = False,
) -> torch.Tensor:
    """Run ``x`` through the stacked layers, pipelined over ``pipe``.

    ``layer_fn(layer_params, x) -> x`` applies ONE layer. ``stacked_params``
    is the whole stacked tree (leaves [L, ...], L divisible by the stage
    count); this rank cuts its own slice, and with ``rules`` its
    ``model`` / ``expert`` shard of every layer (``layer_fn`` then owes the
    collectives, ``parallel/stage_body.py``). ``local``: ``stacked_params``
    is already this rank's cut (``prepare_pipelined_params``). ``x`` [B, ...]
    is the same on every rank, B divisible by ``num_microbatches``.
    Returns [B, ...] on every rank."""
    stages = mesh.stages
    batch = x.shape[0]
    if batch % num_microbatches != 0:
        raise ValueError(
            f"batch {batch} not divisible by num_microbatches {num_microbatches}"
        )
    if local:
        mine = unstack_layers(stacked_params)
    else:
        n_layers = num_stacked(stacked_params)
        if n_layers % stages != 0:
            raise ValueError(f"{n_layers} layers not divisible by {stages} pipeline stages")
        coords, sizes = mesh.coords, mesh.shape
        if rules is None:
            rules = []
            sizes = {PIPE_AXIS: stages}
        mine = unstack_layers(shard_stacked_layers(stacked_params, coords, sizes, rules))
    m = num_microbatches
    mb = batch // m
    x_mb = x.reshape(m, mb, *x.shape[1:])
    stage = mesh.stage
    buf = torch.zeros_like(x_mb[0])
    outputs = torch.zeros_like(x_mb)
    for t in range(m + stages - 1):
        if 0 <= t - stage < m:  # this stage's microbatch t - stage
            y = x_mb[t - stage] if stage == 0 else buf
            for layer in mine:
                y = layer_fn(layer, y)
            if stage == stages - 1:
                outputs[t - stage] = y
        else:  # fill / drain: nothing to compute, the hop still runs
            y = torch.zeros_like(buf)
        buf = ppermute_ring(mesh, y)
    # outputs live on the last stage only: the masked sum gives every
    # rank the same result
    return psum(mesh, outputs, PIPE_AXIS).reshape(batch, *x.shape[1:])


def pipelined_decoder_logits(spec, params, ids: torch.Tensor, mesh: RankMesh,
                             num_microbatches: int = 4, dtype=torch.float32,
                             sharded: bool = False) -> torch.Tensor:
    """Teacher-forcing decoder forward with the layer stack pipelined over
    ``pipe`` and tensor / expert parallelism inside the stages (the JAX
    function's contract): ``params`` is the whole tree, its ``layers`` a
    plain list (shuffled here for ``model`` > 1) or already stacked and
    shuffled. The embedding, final norm and lm head run on every rank on
    the whole weights. ``sharded``: ``params`` is instead this rank's cut
    (:func:`prepare_pipelined_params`, the batch engine's placement):
    its stage's stacked layers, the embedding and lm head sharded over
    ``model`` and gathered whole. Returns [B, T, vocab] f32 logits on
    every rank."""
    from ..models.decoder import rms_norm, rope
    from ..ops import nn
    from .partition import _DECODER_RULES
    from .stage_body import local_qkv_slices, tp_attn_out, tp_mlp_block, tp_project_qkv
    from .tp_layout import shuffle_decoder_layer_for_tp, validate_decoder_tp

    tp = mesh.size(MODEL_AXIS)
    validate_decoder_tp(spec, tp)
    _, _, qh, kvh = local_qkv_slices(spec, tp)
    d = spec.head_dim
    b, t = ids.shape
    dev = ids.device
    positions = torch.arange(t, dtype=torch.int32, device=dev)[None, :].expand(b, t)
    causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()[None, None]
    rep = qh // kvh

    def layer_fn(layer, x):
        bt = x.shape[0]
        pos = positions[:bt]
        h = rms_norm(layer["attn_norm"], x)
        qf, kf, vf = tp_project_qkv(spec, tp, layer, h, dtype)
        q = rope(qf.reshape(bt, t, qh, d), pos)
        k = rope(kf.reshape(bt, t, kvh, d), pos)
        v = vf.reshape(bt, t, kvh, d)
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                              k.to(torch.float32)) / math.sqrt(d)
        logits = torch.where(causal, logits, torch.full_like(logits, -1e9))
        probs = torch.softmax(logits, dim=-1).to(dtype).to(torch.float32)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
        attn = attn.reshape(bt, t, qh * d).to(dtype)
        x = x + tp_attn_out(mesh, layer, attn, dtype)
        h = rms_norm(layer["mlp_norm"], x)
        return x + tp_mlp_block(mesh, spec, layer, h, dtype)

    gather = mesh if sharded else None
    x = nn.gather_features(nn.embedding(params["embed"], ids, dtype), gather)
    layers = params["layers"]
    if isinstance(layers, dict):
        stacked = layers
    else:
        if tp > 1:
            layers = [shuffle_decoder_layer_for_tp(spec, layer, tp) for layer in layers]
        stacked = stack_layers(layers)
    x = pipeline_forward(mesh, layer_fn, stacked, x, num_microbatches, rules=_DECODER_RULES,
                         local=sharded)
    x = rms_norm(params["final_norm"], x)
    return nn.gather_features(nn.dense(params["lm_head"], x, dtype), gather).to(torch.float32)


def prepare_pipelined_params(params, coords, sizes, rules: Rules, layer_shuffle=None):
    """The shard of a whole parameter tree that the rank at ``coords``
    holds for pipelined serving (the JAX ``prepare_pipelined_params``
    followed by that position's ``addressable_shards``): ``layer_shuffle``
    (layer -> layer, the family's block-alignment permutation) on every
    layer, the layers stacked and cut by :func:`~.partition.shard_stacked_layers`,
    everything else cut by :func:`~.partition.shard_params`. Only this
    stage's layers are stacked (a contiguous run of the list)."""
    rest = {k: v for k, v in params.items() if k != "layers"}
    placed = shard_params(rest, coords, sizes, rules)
    layers = params["layers"]
    stages = sizes.get(PIPE_AXIS, 1)
    if len(layers) % stages != 0:
        raise ValueError(f"{len(layers)} layers not divisible by {stages} pipeline stages")
    # the pipe cut of the stack is a contiguous run of layers: stack only
    # this stage's, then cut the per-layer dims
    per = len(layers) // stages
    first = coords.get(PIPE_AXIS, 0) * per
    mine = layers[first:first + per]
    if layer_shuffle is not None:
        mine = [layer_shuffle(layer) for layer in mine]
    placed["layers"] = shard_stacked_layers(stack_layers(mine), {**coords, PIPE_AXIS: 0},
                                            {**sizes, PIPE_AXIS: 1}, rules)
    return placed
