"""Block-aligned weight layouts for manual tensor parallelism inside the
stage programs.

Counterpart of ``starpu_inference_server_tpu/parallel/tp_layout.py``,
the same functions on numpy arrays or torch tensors (either leaf type;
the same indices): the decoder stores FUSED projections (qkv as one
``[H, (Hq + 2 Hkv) D]`` matrix, gate+up as one ``[H, 2 I]``), and a rank
of a ``model`` group holds one contiguous column slice of each, so the
columns are permuted once at placement until rank ``d``'s slice is
exactly ``[q_d | k_d | v_d]`` (resp. ``[gate_d | up_d]``). Where
``model`` is a multiple of the kv heads (GSPMD mode only,
:func:`gspmd_decoder_layer_for_tp`), each kv head's K and V columns are
first repeated ``model / kv_heads`` times, so rank ``d``'s ``k_d`` /
``v_d`` is kv head ``d * kv_heads // model``, the one its q heads read:
the ranks sharing a kv head compute the same K and V. Every other
GSPMD shape (``model`` not dividing the q heads, or the kv heads neither
divided by nor dividing ``model``: :func:`gathered_heads`) keeps the
fused qkv columns as they come, rank ``d`` holding the contiguous
``1 / model`` of them, as the JAX package's ``P(None, MODEL)`` cut: the
decoder gathers the projection over ``model`` and every rank runs every
head (``models/decoder.py:local_heads``).
Per-output-channel scales permute alongside, so the shuffle commutes
with quantization. Row-parallel weights (``attn.o``, ``mlp.down``) keep
their rows; pairwise-packed int4 ones row-shard cleanly when every
shard holds an even number of original rows, which
:func:`repack_int4_rows` checks.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..ops.quant import is_packed_int4_leaf, is_quantized_leaf


def block_tp_permutation(group_sizes: Sequence[int], tp: int) -> np.ndarray:
    """Index permutation turning a ``[g0 | g1 | ...]`` concatenated axis
    into ``[g0_0 | g1_0 | ... | g0_1 | g1_1 | ...]`` so that contiguous
    1/tp slices are block-aligned. ``new[j] = old[perm[j]]``."""
    for n in group_sizes:
        if n % tp != 0:
            raise ValueError(
                f"group size {n} not divisible by tensor-parallel size {tp}"
            )
    offsets = np.cumsum([0] + list(group_sizes))
    chunks = []
    for d in range(tp):
        for g, n in enumerate(group_sizes):
            local = n // tp
            start = offsets[g] + d * local
            chunks.append(np.arange(start, start + local))
    return np.concatenate(chunks)


def _take_last_axis(arr, perm: np.ndarray):
    if isinstance(arr, np.ndarray):
        return np.take(arr, perm, axis=arr.ndim - 1)
    import torch

    idx = torch.as_tensor(perm, dtype=torch.int64, device=arr.device)
    return torch.index_select(arr, arr.dim() - 1, idx)


def permute_out_columns(wnode, perm: np.ndarray):
    """Permute a weight node's OUTPUT (last) axis: dense arrays and
    quantized / packed dicts, whose per-output-channel scales permute
    alongside."""
    if is_packed_int4_leaf(wnode):
        return {
            "w_p4": _take_last_axis(wnode["w_p4"], perm),
            "scale": _take_last_axis(wnode["scale"], perm),
            "bits": wnode["bits"],
        }
    if is_quantized_leaf(wnode):
        return {
            "w_q": _take_last_axis(wnode["w_q"], perm),
            "scale": _take_last_axis(wnode["scale"], perm),
            "bits": wnode["bits"],
        }
    return _take_last_axis(wnode, perm)


def repack_int4_rows(wnode, tp: int):
    """Check that a PAIRWISE-packed int4 weight row-shards cleanly over
    ``tp`` (every shard an even number of original rows: then a contiguous
    packed-row shard is the pack of the original row shard) and pass it
    through; dense and int8 nodes pass through unchanged."""
    if not is_packed_int4_leaf(wnode):
        return wnode
    k = wnode["w_p4"].shape[0] * 2
    if k % tp != 0 or (k // tp) % 2 != 0:
        raise ValueError(
            f"int4 row repack needs K ({k}) divisible by 2*tp ({2 * tp})"
        )
    return wnode


def replicated_kv_columns(spec, tp: int) -> np.ndarray:
    """The fused qkv columns with each kv head's K and V columns repeated
    ``tp // kv_heads`` times (the identity where ``tp`` does not exceed
    the kv heads): ``new[j] = old[idx[j]]``, ``[q | k x r | v x r]``."""
    d = spec.head_dim
    r = max(1, tp // spec.kv_heads)
    q = np.arange(spec.q_heads * d)
    heads = np.repeat(np.arange(spec.kv_heads), r)  # kv head of each replica, in order
    cols = (heads[:, None] * d + np.arange(d)[None, :]).reshape(-1)
    k0 = spec.q_heads * d
    return np.concatenate([q, k0 + cols, k0 + spec.kv_heads * d + cols])


def gathered_heads(spec, tp: int) -> bool:
    """GSPMD mode's route for a decoder over ``tp`` model ranks, from the
    shape alone. False, local heads: every rank holds whole q heads and
    the kv heads they read, ``tp`` dividing the q heads and either
    dividing the kv heads or a multiple of them (replicas). True, gathered
    heads: every other shape, where a rank's contiguous cut of the fused
    qkv columns cuts heads; the rank gathers the projection over
    ``model``, runs every head and keeps its block of the output's
    columns, what XLA's reshard computes for the JAX package."""
    if tp <= 1:
        return False
    return bool(spec.q_heads % tp or (spec.kv_heads % tp and tp % spec.kv_heads))


def gspmd_decoder_layer_for_tp(spec, layer, tp: int):
    """GSPMD mode's layout of one decoder layer over ``tp`` ranks: checked
    by :func:`validate_gspmd_decoder_tp`. Gathered heads
    (:func:`gathered_heads`): the fused qkv columns stay as they come, so
    the rank's contiguous shard is the JAX package's; ``o``, ``gate_up``
    and ``down`` as :func:`shuffle_decoder_layer_for_tp` lays them out.
    Local heads: where ``tp`` exceeds the kv heads, each kv head's K and V
    columns are repeated first (:func:`replicated_kv_columns`; bf16, int8
    and packed int4 weights alike, int4 packing along K), so the shuffle
    sees ``tp`` kv heads; then :func:`shuffle_decoder_layer_for_tp`."""
    validate_gspmd_decoder_tp(spec, tp)
    if gathered_heads(spec, tp):
        return _layer_for_tp(spec, layer, tp, layer["attn"]["qkv"]["w"])
    if tp > spec.kv_heads:
        qkv = permute_out_columns(layer["attn"]["qkv"]["w"], replicated_kv_columns(spec, tp))
        layer = dict(layer, attn=dict(layer["attn"], qkv={"w": qkv}))
        spec = dataclasses.replace(spec, kv_heads=tp)
    return shuffle_decoder_layer_for_tp(spec, layer, tp)


def shuffle_decoder_layer_for_tp(spec, layer, tp: int):
    """A copy of one decoder layer's params with the fused projections
    column-shuffled (and packed int4 row-parallel weights checked) for
    ``tp``-way manual tensor parallelism. ``spec`` is a DecoderSpec."""
    if tp <= 1:
        return layer
    d = spec.head_dim
    qkv_perm = block_tp_permutation(
        [spec.q_heads * d, spec.kv_heads * d, spec.kv_heads * d], tp
    )
    return _layer_for_tp(spec, layer, tp,
                         permute_out_columns(layer["attn"]["qkv"]["w"], qkv_perm))


def _layer_for_tp(spec, layer, tp: int, qkv):
    """The layer with ``qkv`` (its fused qkv weight, laid out for ``tp``)
    in place, ``gate_up`` block-shuffled and the packed int4 row-parallel
    weights checked."""
    out = {
        "attn_norm": layer["attn_norm"],
        "attn": {
            "qkv": {"w": qkv},
            "o": {"w": repack_int4_rows(layer["attn"]["o"]["w"], tp)},
        },
        "mlp_norm": layer["mlp_norm"],
    }
    mlp = layer["mlp"]
    gu_perm = block_tp_permutation([spec.intermediate] * 2, tp)
    if "router" in mlp:
        # stacked experts [E, in, out]: the gate|up interleave applies
        # along the last axis of every expert; the router replicates
        out["mlp"] = {
            "router": mlp["router"],
            "experts": {
                "gate_up": {
                    "w": permute_out_columns(mlp["experts"]["gate_up"]["w"], gu_perm)
                },
                "down": {"w": repack_int4_rows(mlp["experts"]["down"]["w"], tp)},
            },
        }
    else:
        out["mlp"] = {
            "gate_up": {"w": permute_out_columns(mlp["gate_up"]["w"], gu_perm)},
            "down": {"w": repack_int4_rows(mlp["down"]["w"], tp)},
        }
    return out


def validate_decoder_tp(spec, tp: int) -> None:
    """Divisibility contract for manual TP over decoder layers."""
    if tp <= 1:
        return
    if spec.kv_heads % tp or spec.q_heads % tp:
        raise ValueError(
            f"tensor-parallel size {tp} must divide q_heads "
            f"({spec.q_heads}) and kv_heads ({spec.kv_heads})"
        )
    if (spec.q_heads // tp) % (spec.kv_heads // tp):
        raise ValueError(
            f"per-device GQA ratio must stay integral: q_heads/tp="
            f"{spec.q_heads // tp}, kv_heads/tp={spec.kv_heads // tp}"
        )
    if spec.intermediate % tp:
        raise ValueError(
            f"tensor-parallel size {tp} must divide intermediate "
            f"({spec.intermediate})"
        )


def validate_gspmd_decoder_tp(spec, tp: int) -> None:
    """The decoder meshes GSPMD mode serves: every head layout, as the JAX
    package's GSPMD (:func:`gathered_heads` picks the route). What is
    refused is the JAX package's own refusal, that of ``device_put``: a dimension the
    decoder rules cut over ``model`` that ``tp`` does not divide, named
    here before any weight is built (the fused qkv columns where they are
    cut as they come: the local route cuts its block-aligned groups)."""
    if tp <= 1:
        return
    gathered = gathered_heads(spec, tp)
    d = spec.head_dim
    dims = [("the o rows (q_heads * head_dim)", spec.q_heads * d),
            ("intermediate", spec.intermediate),
            ("hidden (the embedding's columns)", spec.hidden),
            ("vocab (the lm head's columns)", spec.vocab)]
    if gathered:
        dims.insert(0, ("the fused qkv columns", (spec.q_heads + 2 * spec.kv_heads) * d))
    for name, n in dims:
        if n % tp:
            raise ValueError(
                f"tensor-parallel size {tp} must divide {name} ({n}): GSPMD mode cuts it "
                f"over model"
            )
