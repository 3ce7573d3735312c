"""ModelInfer I/O for decoder generation (subset of the JAX package's
``grpc/io.py``): prompt extraction and the per-phase timing fields.
The batch-pipeline validation and response fill wait for that slice."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..utils.clock import wall_ms
from ..utils.dtypes import canonical_dtype_name, numpy_dtype
from ..utils.exceptions import InputValidationError
from . import kserve_v2_pb2 as pb


def extract_prompt(request: pb.ModelInferRequest) -> np.ndarray:
    """The ``input_ids`` tensor of a generation request as int64 [P];
    accepts shape [P] or [1, P] and any integer wire dtype."""
    if not request.inputs or not request.raw_input_contents:
        raise InputValidationError("generation requires an input_ids tensor")
    tensor = request.inputs[0]
    if tensor.name and tensor.name != "input_ids":
        raise InputValidationError(
            f"decoder models take 'input_ids', got {tensor.name!r}"
        )
    wire = canonical_dtype_name(tensor.datatype or "INT64")
    dt = numpy_dtype(wire)
    if dt.kind not in ("i", "u") or wire == "BF16":
        raise InputValidationError("input_ids must be an integer tensor")
    ids = np.frombuffer(request.raw_input_contents[0], dtype=dt)
    shape = tuple(int(d) for d in tensor.shape)
    if len(shape) == 2 and shape[0] == 1:
        shape = (shape[1],)
    if len(shape) != 1 or shape[0] != ids.size:
        raise InputValidationError(
            f"input_ids shape {list(tensor.shape)} inconsistent with "
            f"{ids.size} elements (expect [P] or [1, P])"
        )
    return ids.astype(np.int64)


def generation_params(request: pb.ModelInferRequest) -> Dict[str, object]:
    p = request.parameters
    out = {"max_new_tokens": 32, "eos_id": None, "temperature": 0.0,
           "top_k": 0, "seed": 0}
    if "max_new_tokens" in p:
        out["max_new_tokens"] = int(p["max_new_tokens"].int64_param)
    if "eos_id" in p:
        out["eos_id"] = int(p["eos_id"].int64_param)
    if "temperature" in p:
        out["temperature"] = float(p["temperature"].double_param)
    if "top_k" in p:
        out["top_k"] = int(p["top_k"].int64_param)
    if "seed" in p:
        out["seed"] = int(p["seed"].int64_param)
    return out


def fill_timing_fields(
    response: pb.ModelInferResponse,
    breakdown: Dict[str, float],
    server_receive_ms: float,
    preprocess_ms: float = 0.0,
    postprocess_ms: float = 0.0,
) -> None:
    """Per-phase server timing surfaced to the client (same fields as the
    JAX server)."""
    response.server_receive_ms = int(server_receive_ms)
    response.server_queue_ms = breakdown.get("queue_ms", 0.0)
    response.server_batch_ms = breakdown.get("batch_ms", 0.0)
    response.server_submit_ms = breakdown.get("submit_ms", 0.0)
    response.server_scheduling_ms = breakdown.get("scheduling_ms", 0.0)
    response.server_codelet_ms = breakdown.get("codelet_ms", 0.0)
    response.server_inference_ms = breakdown.get("inference_ms", 0.0)
    response.server_callback_ms = breakdown.get("callback_ms", 0.0)
    response.server_total_ms = breakdown.get("total_ms", 0.0)
    response.server_preprocess_ms = preprocess_ms
    response.server_postprocess_ms = postprocess_ms
    now = wall_ms()
    response.server_send_ms = int(now)
    response.server_overall_ms = max(0.0, now - server_receive_ms)
