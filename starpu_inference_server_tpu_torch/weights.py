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

On a mesh, :func:`rank_shard` cuts a whole tree to one mesh position's
shard (pipe mode: stacked stages; GSPMD mode: the family's partition
rules on the unstacked tree) and :func:`mesh_params` gives every rank its
own: rank 0 builds the tree once and sends each rank its shard
(:func:`scatter_shards`, :func:`receive_shard`; the batch engine's hot
reload sends new shards the same way).
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
    """The shard of a whole tree (numpy or torch leaves) of ``family``
    (``spec``: its DecoderSpec, None for other families) that the mesh
    position ``coords`` holds. With ``sizes['model']`` > 1 every layer is
    first column-shuffled by the family's ``tp_layer_shuffle`` hook in
    the mesh's mode (decoders' fused projections, ``parallel/tp_layout.py``;
    in GSPMD mode kv heads are replicated where ``model`` exceeds them, and
    the fused qkv stays as it comes where ``model`` cuts heads).
    Pipe mode (``sizes['pipe']`` > 1): this stage's layers stacked and
    every leaf cut by the family's partition rules
    (``parallel/pipeline.py:prepare_pipelined_params``); GSPMD mode: the
    tree cut by the rules as it is (``parallel/partition.py:shard_params``).
    The same block as the JAX leaf's ``addressable_shards`` there, but for
    the block-aligned fused projections (GSPMD's split is contiguous; the
    gathered-heads route's qkv shard is JAX's)."""
    import dataclasses

    from .models.registry import get_family
    from .parallel.mesh import MODEL_AXIS, PIPE_AXIS
    from .parallel.partition import partition_rules_for, shard_params
    from .parallel.pipeline import prepare_pipelined_params

    options = dataclasses.asdict(spec) if spec is not None else {}
    hook = get_family(family, options).tp_layer_shuffle
    tp = sizes.get(MODEL_AXIS, 1)
    pipe = sizes.get(PIPE_AXIS, 1) > 1
    shuffle = (lambda layer: hook(layer, tp, pipe=pipe)) if tp > 1 and hook is not None else None
    rules = partition_rules_for(family)
    if pipe:
        return prepare_pipelined_params(tree, coords, sizes, rules, layer_shuffle=shuffle)
    if shuffle is not None:
        tree = dict(tree, layers=[shuffle(layer) for layer in tree["layers"]])
    return shard_params(tree, coords, sizes, rules)


def own_shard(tree, device):
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


def cut_shards(tree, spec, family: str, mesh) -> list:
    """Every rank's shard of ``tree`` (:func:`rank_shard`), in rank order,
    where the tree lies."""
    from .parallel.mesh import AXES

    sizes = dict(mesh.shape)
    ranks = np.arange(mesh.world_size).reshape(mesh.axes.shape)
    return [rank_shard(tree, spec, family,
                       {a: int(c) for a, c in zip(AXES, np.argwhere(ranks == r)[0])}, sizes)
            for r in range(mesh.world_size)]


def send_shards(shards, mesh) -> None:
    """Rank 0: send every other rank its shard of ``shards`` (rank order)
    over the mesh's control group; they call :func:`receive_shard`. Logs
    ``weights sent: {json}``: the shards, MB and host seconds, in all and
    to the ranks of other launchers."""
    import json
    import time

    import torch.distributed as dist

    from .utils.logger import get_logger

    sent = {"shards": 0, "mb": 0.0, "s": 0.0, "other_launchers": {"shards": 0, "mb": 0.0, "s": 0.0}}
    for r in range(1, mesh.world_size):
        t0 = time.perf_counter()
        shard = own_shard(shards[r], "cpu")
        dist.send_object_list([shard], dst=r, group=mesh.control)
        seconds, mb = time.perf_counter() - t0, _tree_bytes(shard) / 1e6
        remote = mesh.process_index(r) != mesh.launcher
        for part in (sent, sent["other_launchers"]) if remote else (sent,):
            part["shards"] += 1
            part["s"] += seconds
            part["mb"] += mb
    get_logger().info("weights sent: %s", json.dumps(sent, sort_keys=True))


def _tree_bytes(node) -> int:
    if isinstance(node, dict):
        return sum(_tree_bytes(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return sum(_tree_bytes(v) for v in node)
    return node.nbytes if isinstance(node, torch.Tensor) else 0


def scatter_shards(tree, spec, family: str, mesh):
    """Rank 0: cut every rank's shard of ``tree`` and send it
    (:func:`cut_shards`, :func:`send_shards`); returns rank 0's own, on
    its device."""
    shards = cut_shards(tree, spec, family, mesh)
    send_shards(shards, mesh)
    return own_shard(shards[0], mesh.device)


def receive_shard(mesh):
    """A rank other than 0: its shard from :func:`scatter_shards`, on its
    device."""
    import torch.distributed as dist

    box = [None]
    dist.recv_object_list(box, src=0, group=mesh.control)
    return own_shard(box[0], mesh.device)


def mesh_params(settings, seed: int, spec, mesh):
    """This rank's shard of the configured model's parameters, on its
    device. Rank 0 builds the whole tree once (``models.registry.build_model``:
    seeded or loaded, quantized as configured, on its device) and sends
    every rank its shard; the other ranks receive theirs. No other rank
    draws weights."""
    from .models.registry import build_model

    if mesh.rank != 0:
        return receive_shard(mesh)
    tree = build_model(settings, seed=seed, device=mesh.device).params
    return scatter_shards(tree, spec, settings.family, mesh)
