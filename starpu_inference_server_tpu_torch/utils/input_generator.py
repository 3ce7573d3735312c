"""Random input generation per tensor spec.

Counterpart of ``starpu_inference_server_tpu/utils/input_generator.py``,
unchanged.

Reference counterpart: src/utils/input_generator.hpp:20-90 — random
inputs per TensorConfig; integer tensors shaped like [B, S>=64] are
bounded by the BERT vocab size (30522) so token-id inputs are valid.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .config import TensorSpec
from .dtypes import numpy_dtype

BERT_VOCAB_SIZE = 30522


def generate_input(
    spec: TensorSpec, batch: int, rng: np.random.Generator
) -> np.ndarray:
    shape = (batch, *spec.dims)
    dt = numpy_dtype(spec.dtype)
    if dt.kind in ("i", "u"):
        # token-id heuristic: sequence-like int tensors get vocab-bounded ids
        high = BERT_VOCAB_SIZE if (spec.dims and spec.dims[-1] >= 64) else 2
        return rng.integers(0, high, size=shape, dtype=dt)
    if dt.kind == "b":
        return rng.integers(0, 2, size=shape).astype(dt)
    return rng.standard_normal(size=shape).astype(dt)


def generate_inputs(
    specs: Sequence[TensorSpec], batch: int, rng: np.random.Generator
) -> Dict[str, np.ndarray]:
    return {spec.name: generate_input(spec, batch, rng) for spec in specs}

