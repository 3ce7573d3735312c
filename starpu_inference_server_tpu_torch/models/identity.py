"""Trivial test models: ``identity``, ``add_one`` and ``matmul``.

Counterpart of ``starpu_inference_server_tpu/models/identity.py``, the
cheap models the batch pipeline's tests run (``add_one`` mirrors the
reference's e2e fixture, whose forward is ``x + 1``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import nn
from ..utils.config import TensorSpec
from .registry import ModelDefinition, register_family


def _spec_from_options(options, default_dims=(8,), dtype="FP32"):
    dims = tuple(options.get("dims", default_dims))
    return (
        (TensorSpec("input", dims, dtype),),
        (TensorSpec("output", dims, dtype),),
    )


@register_family("identity")
def build_identity(options) -> ModelDefinition:
    in_specs, out_specs = _spec_from_options(options)

    def apply(params, inputs, dtype, mesh=None):
        return {"output": inputs["input"]}

    return ModelDefinition("identity", lambda rng: {}, apply, in_specs, out_specs)


@register_family("add_one")
def build_add_one(options) -> ModelDefinition:
    in_specs, out_specs = _spec_from_options(options)

    def apply(params, inputs, dtype, mesh=None):
        return {"output": inputs["input"] + 1}

    return ModelDefinition("add_one", lambda rng: {}, apply, in_specs, out_specs)


@register_family("matmul")
def build_matmul(options) -> ModelDefinition:
    """y = x @ W + b, one dense layer (int8 at <= 64 rows: the int8 kernel)."""
    dim = int(options.get("dim", 64))
    in_specs = (TensorSpec("input", (dim,), "FP32"),)
    out_specs = (TensorSpec("output", (dim,), "FP32"),)

    def init_params(rng):
        return {
            "fc": {
                "w": (rng.standard_normal((dim, dim)) / np.sqrt(dim)).astype(np.float32),
                "b": np.zeros((dim,), np.float32),
            }
        }

    def apply(params, inputs, dtype, mesh=None):
        return {"output": nn.dense(params["fc"], inputs["input"], dtype).to(torch.float32)}

    return ModelDefinition("matmul", init_params, apply, in_specs, out_specs)
