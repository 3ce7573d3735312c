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
