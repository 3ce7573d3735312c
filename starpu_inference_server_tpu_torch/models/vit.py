"""Vision Transformer family (ViT-B/16, ViT-L/16).

Counterpart of ``starpu_inference_server_tpu/models/vit.py``: the same
variants, options (``num_layers``, ``image_size``, ``num_classes``),
parameter tree and RNG order, and the same contract: an FP32 NCHW image
[3, H, W] per sample in, FP32 ``output`` logits out. Pre-LN blocks (LN ->
MHA -> residual, LN -> MLP(tanh GELU) -> residual), a 16x16 stride-16
patch conv, a class token and learned position embeddings added in the
compute dtype, a final LN and the head over the class token. At 197
tokens the attention takes the plain path in both packages (the
bidirectional attention kernel's gate wants S % 128 == 0 and S >= 512);
under W8A8 the patch conv runs the exact s8 x s8 conv
(``ops/nn.py:conv2d``) and the head, at <= 64 rows with kernels on, the
int8 matmul kernel, as in the JAX package's dispatch.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ..ops import nn
from ..utils.config import TensorSpec
from .registry import ModelDefinition, register_family

# variant -> (dim, depth, heads, mlp_dim)
_VARIANTS = {
    "vit_b_16": (768, 12, 12, 3072),
    "vit_l_16": (1024, 24, 16, 4096),
}

PATCH = 16
NUM_CLASSES = 1000


def _linear_init(rng: np.random.Generator, cin: int, cout: int) -> Dict[str, Any]:
    std = math.sqrt(2.0 / (cin + cout))
    return {
        "w": (rng.standard_normal((cin, cout)) * std).astype(np.float32),
        "b": np.zeros((cout,), np.float32),
    }


def _ln_init(dim: int) -> Dict[str, Any]:
    return {"gamma": np.ones((dim,), np.float32), "beta": np.zeros((dim,), np.float32)}


def _encoder_block_init(rng, dim, mlp_dim) -> Dict[str, Any]:
    return {
        "ln1": _ln_init(dim),
        "attn": {
            "q": _linear_init(rng, dim, dim),
            "k": _linear_init(rng, dim, dim),
            "v": _linear_init(rng, dim, dim),
            "o": _linear_init(rng, dim, dim),
        },
        "ln2": _ln_init(dim),
        "mlp": {
            "fc1": _linear_init(rng, dim, mlp_dim),
            "fc2": _linear_init(rng, mlp_dim, dim),
        },
    }


def _encoder_block_apply(p, x, heads, dtype, mesh=None):
    h = nn.layer_norm(p["ln1"], x)
    x = x + nn.multi_head_attention(p["attn"], h, None, heads, dtype, mesh=mesh)
    h = nn.layer_norm(p["ln2"], x)
    h = nn.dense(p["mlp"]["fc1"], h, dtype)
    h = nn.gelu(h)
    h = nn.dense(p["mlp"]["fc2"], h, dtype, mesh=mesh)
    return x + h


def _channel_block(t: torch.Tensor, mesh, channels: int) -> torch.Tensor:
    """The rank's ``channels`` of a replicated [..., dim] leaf (the patch
    conv's bias, the class token) where the patch channels shard over
    ``model``; the leaf itself without a mesh."""
    if mesh is None or t.shape[-1] == channels:
        return t
    off = mesh.coord("model") * channels
    return t[..., off:off + channels]


def _build_vit(variant: str, options) -> ModelDefinition:
    dim, depth, heads, mlp_dim = _VARIANTS[variant]
    depth = int(options.get("num_layers", depth))
    image = int(options.get("image_size", 224))
    num_classes = int(options.get("num_classes", NUM_CLASSES))
    num_patches = (image // PATCH) ** 2
    seq = num_patches + 1  # + class token

    def init_params(rng: np.random.Generator):
        return {
            "patch_embed": {
                "w": (rng.standard_normal((PATCH, PATCH, 3, dim))
                      * math.sqrt(2.0 / (PATCH * PATCH * 3))).astype(np.float32),
                "b": np.zeros((dim,), np.float32),
            },
            "cls_token": np.zeros((1, 1, dim), np.float32),
            "pos_embed": (rng.standard_normal((1, seq, dim)) * 0.02).astype(np.float32),
            "blocks": [_encoder_block_init(rng, dim, mlp_dim) for _ in range(depth)],
            "ln_final": _ln_init(dim),
            "head": _linear_init(rng, dim, num_classes),
        }

    def apply(params, inputs, dtype, mesh=None):
        """``mesh``: tensor-parallel over ``model`` on the rank's rows: the
        patch conv's output channels and ``pos_embed`` are the rank's (the
        activation gathered before the first layer norm), the blocks run
        local heads with row-parallel o and fc2, the head replicates."""
        x = inputs["input"].permute(0, 2, 3, 1).to(dtype)  # NCHW wire -> NHWC
        pos = params["pos_embed"]
        local = pos.shape[-1]
        patch = dict(params["patch_embed"],
                     b=_channel_block(params["patch_embed"]["b"], mesh, local))
        x = nn.conv2d(patch, x, stride=PATCH, padding="VALID", dtype=dtype, mesh=mesh)
        b = x.shape[0]
        x = x.reshape(b, num_patches, local)
        cls = _channel_block(params["cls_token"], mesh, local).to(dtype).expand(b, 1, local)
        x = torch.cat([cls, x], dim=1)
        x = nn.gather_features(x + pos.to(dtype), mesh)
        for blk in params["blocks"]:
            x = _encoder_block_apply(blk, x, heads, dtype, mesh)
        x = nn.layer_norm(params["ln_final"], x)
        logits = nn.dense(params["head"], x[:, 0, :], dtype)
        return {"output": logits.to(torch.float32)}

    return ModelDefinition(
        family=variant,
        init_params=init_params,
        apply=apply,
        input_specs=(TensorSpec("input", (3, image, image), "FP32"),),
        output_specs=(TensorSpec("output", (num_classes,), "FP32"),),
    )


for _variant in _VARIANTS:
    register_family(_variant)(lambda options, _v=_variant: _build_vit(_v, options))
