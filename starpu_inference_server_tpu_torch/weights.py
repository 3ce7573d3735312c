"""Parameter trees from numpy.

:func:`params_from_numpy` turns a parameter tree of the JAX package's
shape (nested dicts and lists; leaves numpy arrays, or anything
``np.asarray`` takes, including quantized leaves ``{'w_q', 'scale',
'bits'}`` and packed ones ``{'w_p4', 'scale', 'bits'}``) into the port's
tree of torch tensors on ``device``. Both packages then compute on the
very same weights. Python scalars (``bits``) stay as they are; 0-d
arrays become 0-d tensors, and ``ml_dtypes.bfloat16`` arrays (which an
Orbax checkpoint's bf16 leaves restore to, and ``torch.from_numpy``
refuses) become ``torch.bfloat16`` tensors of the same bits.

For a pipelined mesh, :func:`rank_shard` cuts a whole tree to one mesh
position's shard and :func:`pipelined_params` gives every rank its own:
rank 0 builds the tree once and sends each rank its shard.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu"):
    dev = torch.device(device)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        if node is None or isinstance(node, (bool, int, float, str)):
            return node
        if isinstance(node, torch.Tensor):
            return node.to(dev)
        arr = np.asarray(node)
        if not (arr.flags.c_contiguous and arr.flags.writeable):  # e.g. a jax.Array's view
            arr = arr.copy(order="C")
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(arr).to(dev)

    return rec(tree)


def rank_shard(tree, spec, family: str, coords, sizes):
    """The shard of a whole decoder tree (numpy or torch leaves) that the
    mesh position ``coords`` holds for pipelined serving: every layer
    column-shuffled for ``sizes['model']``-way tensor parallelism first,
    then this stage's layers stacked and every leaf cut by the family's
    partition rules (``parallel/pipeline.py:prepare_pipelined_params``).
    The same block as the JAX leaf's ``addressable_shards`` there."""
    from .parallel.mesh import MODEL_AXIS
    from .parallel.partition import partition_rules_for
    from .parallel.pipeline import prepare_pipelined_params
    from .parallel.tp_layout import shuffle_decoder_layer_for_tp, validate_decoder_tp

    tp = sizes.get(MODEL_AXIS, 1)
    validate_decoder_tp(spec, tp)
    shuffle = (lambda layer: shuffle_decoder_layer_for_tp(spec, layer, tp)) if tp > 1 else None
    return prepare_pipelined_params(tree, coords, sizes, partition_rules_for(family),
                                    layer_shuffle=shuffle)


def _owned(tree, device):
    """Every tensor leaf as a compact tensor of its own on ``device`` (a
    view would keep, or pickle, its whole base)."""
    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        if isinstance(node, torch.Tensor):
            return node.to(device, copy=True).contiguous()
        return node

    return rec(tree)


def pipelined_params(settings, seed: int, spec, mesh):
    """This rank's shard of the configured decoder's parameters, on its
    device. Rank 0 builds the whole tree once (``models.registry.build_model``:
    seeded or loaded, quantized as configured, on its device), cuts every
    rank's shard (:func:`rank_shard`) and sends it over the mesh's control
    group; the other ranks receive theirs. No other rank draws weights."""
    import torch.distributed as dist

    from .models.registry import build_model

    sizes = dict(mesh.shape)
    if mesh.rank != 0:
        box = [None]
        dist.recv_object_list(box, src=0, group=mesh.control)
        return _owned(box[0], mesh.device)
    tree = build_model(settings, seed=seed, device=mesh.device).params
    from .parallel.mesh import AXES

    ranks = np.arange(mesh.world_size).reshape(mesh.axes.shape)
    own = None
    for r in range(mesh.world_size):
        coords = {a: int(c) for a, c in zip(AXES, np.argwhere(ranks == r)[0])}
        shard = rank_shard(tree, spec, settings.family, coords, sizes)
        if r == 0:
            own = _owned(shard, mesh.device)
        else:
            dist.send_object_list([_owned(shard, "cpu")], dst=r, group=mesh.control)
    return own
