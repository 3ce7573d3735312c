"""Partition rules: parameter-tree paths -> partition specs, and the cut
of a whole tree to one rank's shard.

Counterpart of ``starpu_inference_server_tpu/parallel/partition.py``:
the same rules (Megatron column / row parallelism over ``model``,
experts over ``expert``, the decoder's vocab-sized embed and lm head
sharded on their feature / vocab dim), the same first-match lookup and
the same treatment of quantized leaves (:func:`quant_specs`). A spec is a
tuple with one entry per leading dim: an axis name or None (the JAX
``PartitionSpec``). Where the JAX package ``device_put``s every leaf
with a ``NamedSharding`` and XLA keeps the shards, a rank here holds its
own shard: :func:`shard_params` and :func:`shard_stacked_layers` cut a
tree (numpy arrays or torch tensors) to the block of the rank at
``coords``, the same block as the JAX leaf's ``addressable_shards`` on
that mesh position.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

from ..ops.quant import is_packed_int4_leaf, is_quantized_leaf
from .mesh import EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS

Spec = Tuple
Rules = List[Tuple[str, Spec]]


def _is_opaque_leaf(node) -> bool:
    return is_quantized_leaf(node) or is_packed_int4_leaf(node)


_TRANSFORMER_RULES: Rules = [
    # column-parallel: shard output dim
    (r".*/attn/[qkv]/w$", (None, MODEL_AXIS)),
    (r".*/attn/[qkv]/b$", (MODEL_AXIS,)),
    (r".*/(ffn|mlp)/fc1/w$", (None, MODEL_AXIS)),
    (r".*/(ffn|mlp)/fc1/b$", (MODEL_AXIS,)),
    # row-parallel: shard input dim (all-reduce after)
    (r".*/attn/o/w$", (MODEL_AXIS, None)),
    (r".*/(ffn|mlp)/fc2/w$", (MODEL_AXIS, None)),
    # embeddings: shard the feature dim
    (r".*embeddings/word/w$", (None, MODEL_AXIS)),
    (r".*embeddings/position/w$", (None, MODEL_AXIS)),
    (r".*embeddings/token_type/w$", (None, MODEL_AXIS)),
    # ViT patch-embed conv: shard output channels
    (r".*patch_embed/w$", (None, None, None, MODEL_AXIS)),
    (r".*pos_embed$", (None, None, MODEL_AXIS)),
]

_TRANSFORMER_FAMILIES = re.compile(r"^(bert|vit)")
_DECODER_FAMILIES = re.compile(r"^(llama|moe|mixtral)")

# fused-projection decoder layout (models/decoder.py): qkv and gate_up
# column-parallel, o and down row-parallel; MoE stacked experts [E, in,
# out] expert-parallel over 'expert' and tensor-parallel inside each
# expert; the router replicates; embed and lm_head shard their large dim
_DECODER_RULES: Rules = [
    (r".*/attn/qkv/w$", (None, MODEL_AXIS)),
    (r".*/mlp/experts/gate_up/w$", (EXPERT_AXIS, None, MODEL_AXIS)),
    (r".*/mlp/experts/down/w$", (EXPERT_AXIS, MODEL_AXIS, None)),
    (r".*/mlp/router/w$", ()),
    (r".*/(mlp)/gate_up/w$", (None, MODEL_AXIS)),
    (r".*/attn/o/w$", (MODEL_AXIS, None)),
    (r".*/(mlp)/down/w$", (MODEL_AXIS, None)),
    (r".*embed/w$", (None, MODEL_AXIS)),
    (r".*lm_head/w$", (None, MODEL_AXIS)),
]


def partition_rules_for(family: str) -> Rules:
    """Rules for a model family; non-transformer families replicate."""
    if _TRANSFORMER_FAMILIES.match(family):
        return _TRANSFORMER_RULES
    if _DECODER_FAMILIES.match(family):
        return _DECODER_RULES
    return []


def spec_for_path(path: str, rules: Rules) -> Spec:
    for pattern, spec in rules:
        if re.match(pattern, path):
            return spec
    return ()  # replicate


def map_with_paths(node: Any, fn, prefix: str = ""):
    """``fn(path, leaf)`` over a tree, quantized dicts as single leaves."""
    if _is_opaque_leaf(node):
        return fn(prefix, node)
    if isinstance(node, dict):
        return {
            key: map_with_paths(value, fn, f"{prefix}/{key}" if prefix else key)
            for key, value in node.items()
        }
    if isinstance(node, (list, tuple)):
        return type(node)(
            map_with_paths(value, fn, f"{prefix}/{i}" if prefix else str(i))
            for i, value in enumerate(node)
        )
    if node is None:
        return None
    return fn(prefix, node)


def _ndim(a) -> int:
    return len(a.shape) if hasattr(a, "shape") else 0


def quant_specs(spec: Spec, leaf) -> Tuple[Spec, Spec]:
    """A quantized leaf shards its weight like the dense weight; the scale
    keeps the weight spec on every axis where it has real extent and
    replicates its size-1 (reduced) axes: a 2D scale [1, C] shards only
    the channel axis, a 3D MoE scale [E, 1, C] expert and channel."""
    scale = leaf["scale"]
    nd = _ndim(scale)
    if not nd:
        return spec, ()
    entries = list(spec) + [None] * max(0, nd - len(spec))
    scale_spec = tuple(entries[i] if scale.shape[i] != 1 else None for i in range(nd))
    return spec, scale_spec


def stacked_layer_spec(path: str, leaf, rules: Rules) -> Spec:
    """The spec of one STACKED layer leaf: ``pipe`` on the leading [L] axis,
    then the per-layer spec from ``rules``, trimmed / padded to the leaf's
    rank (the weight array's, for a quantized leaf)."""
    spec = spec_for_path(path, rules)
    if _is_opaque_leaf(leaf):
        nd = _ndim(leaf["w_p4" if "w_p4" in leaf else "w_q"])
    else:
        nd = _ndim(leaf)
    entries = [PIPE_AXIS] + list(spec)
    entries = entries[:nd] + [None] * max(0, nd - len(entries))
    return tuple(entries)


def shard_array(arr, spec: Spec, coords: Dict[str, int], sizes: Dict[str, int]):
    """The block of ``arr`` at mesh position ``coords``: every dim whose
    spec entry names an axis is cut into that axis's size in contiguous
    pieces, and the piece at the rank's coordinate is kept (a view)."""
    index = []
    for dim, axis in enumerate(spec):
        if axis is None or sizes.get(axis, 1) == 1:
            index.append(slice(None))
            continue
        n = arr.shape[dim]
        parts = sizes[axis]
        if n % parts:
            raise ValueError(f"dim {dim} of size {n} does not split over {axis}={parts}")
        step = n // parts
        index.append(slice(coords[axis] * step, (coords[axis] + 1) * step))
    return arr[tuple(index)] if index else arr


def _shard_leaf(leaf, spec: Spec, coords, sizes, trim: bool):
    if _is_opaque_leaf(leaf):
        wkey = "w_p4" if "w_p4" in leaf else "w_q"
        w_spec, s_spec = quant_specs(spec, leaf)
        return {
            wkey: shard_array(leaf[wkey], w_spec, coords, sizes),
            "scale": shard_array(leaf["scale"], s_spec, coords, sizes),
            "bits": leaf["bits"],
        }
    nd = _ndim(leaf)
    if trim and len(spec) != nd:
        spec = tuple(list(spec)[:nd] + [None] * max(0, nd - len(spec)))
    return shard_array(leaf, spec, coords, sizes)


def shard_params(params: Any, coords: Dict[str, int], sizes: Dict[str, int],
                 rules: Rules) -> Any:
    """Cut a tree to the shard at ``coords`` by ``rules`` (the torch form
    of the JAX ``shard_params``: a dense leaf's spec is trimmed / padded to
    its rank, a quantized leaf's weight and scale follow :func:`quant_specs`)."""
    return map_with_paths(
        params, lambda path, leaf: _shard_leaf(leaf, spec_for_path(path, rules), coords,
                                               sizes, trim=True))


def shard_stacked_layers(stacked: Any, coords: Dict[str, int], sizes: Dict[str, int],
                         rules: Rules) -> Any:
    """Cut a stacked layer tree (leaves [L, ...]): the [L] axis over
    ``pipe`` (each stage holds L/S contiguous layers), the per-layer dims
    by ``rules`` (the JAX ``shard_stacked_layers``). Paths are prefixed
    ``layers`` as the rules' regexes expect."""
    return map_with_paths(
        stacked, lambda path, leaf: _shard_leaf(leaf, stacked_layer_spec(path, leaf, rules),
                                                coords, sizes, trim=False),
        prefix="layers")


def batch_sharding(mesh, rows: int) -> slice:
    """The rank's rows of a batch whose leading dim is sharded over
    ``data`` (the JAX ``batch_sharding``'s placement): contiguous blocks
    in coordinate order."""
    from .collectives import row_block

    return row_block(mesh, rows)


def sharded_forward(model, mesh, rules: Rules = None):
    """(this rank's shard, forward) for a ``BuiltModel`` holding the whole
    tree, over ``mesh`` (the JAX ``sharded_forward``, with ranks in place
    of devices; every rank of the world calls it). The shard is
    ``weights.rank_shard``'s (the family's rules and layer shuffle), or
    ``shard_params``'s by ``rules`` when given.
    ``forward(inputs)`` takes the WHOLE batch on every rank (a leading
    dim divisible by the data size), runs the family's ``apply`` with the
    mesh on the rank's rows and shard, and returns the whole outputs on
    every rank (gathered over ``data``)."""
    from ..weights import rank_shard
    from .collectives import gather_rows

    definition = model.definition
    if rules is None:
        shard = rank_shard(model.params, definition.spec, definition.family, mesh.coords,
                           mesh.shape)
    else:
        shard = shard_params(model.params, mesh.coords, mesh.shape, rules)

    def forward(inputs):
        rows = batch_sharding(mesh, next(iter(inputs.values())).shape[0])
        local = {name: t[rows].to(mesh.device) for name, t in inputs.items()}
        out = definition.apply(shard, local, model.compute_dtype, mesh=mesh)
        return {name: gather_rows(mesh, t) for name, t in out.items()}

    return shard, forward
