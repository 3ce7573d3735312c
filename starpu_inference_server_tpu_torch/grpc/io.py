"""ModelInfer I/O: request validation and conversion, the response
fill, prompt extraction for decoder generation, and the per-phase
timing fields.

Counterpart of ``starpu_inference_server_tpu/grpc/io.py`` (reference:
src/grpc/server/inference_service_io.cpp): the input count, names,
dtypes, shapes (a leading batch dim up to ``max_batch_size``) and raw
byte sizes are checked against the config; accepted inputs are
zero-copy numpy views over the request's bytes (the one copy happens at
batch assembly, into the staging slot); responses carry
``raw_output_contents`` with ``outputN`` fallback names.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..utils.clock import wall_ms
from ..utils.config import RuntimeConfig
from ..utils.dtypes import canonical_dtype_name, numpy_dtype, wire_name
from ..utils.exceptions import InputValidationError
from . import kserve_v2_pb2 as pb


def validate_and_convert_inputs(cfg: RuntimeConfig,
                                request: pb.ModelInferRequest) -> Dict[str, np.ndarray]:
    """Validate a ModelInferRequest against the model config and return
    zero-copy numpy views (one per input, batch-leading)."""
    expected = {spec.name: spec for spec in cfg.inputs}
    inputs = list(request.inputs)
    if len(inputs) != len(cfg.inputs):
        raise InputValidationError(f"expected {len(cfg.inputs)} inputs, got {len(inputs)}")
    if len(request.raw_input_contents) != len(inputs):
        raise InputValidationError(
            f"raw_input_contents count {len(request.raw_input_contents)} "
            f"does not match inputs count {len(inputs)}"
        )
    # named inputs are all-or-nothing
    names = [t.name for t in inputs]
    named = [n for n in names if n]
    if named and len(named) != len(names):
        raise InputValidationError("either name all inputs or none")
    if named:
        if set(named) != set(expected):
            raise InputValidationError(
                f"input names {sorted(named)} do not match expected {sorted(expected)}"
            )
        order = {t.name: i for i, t in enumerate(inputs)}
        pairs = [(expected[spec.name], inputs[order[spec.name]],
                  request.raw_input_contents[order[spec.name]]) for spec in cfg.inputs]
    else:
        pairs = list(zip(cfg.inputs, inputs, request.raw_input_contents))

    batch: Optional[int] = None
    out: Dict[str, np.ndarray] = {}
    for spec, tensor, raw in pairs:
        if canonical_dtype_name(tensor.datatype) != spec.dtype:
            raise InputValidationError(
                f"input {spec.name!r}: dtype {tensor.datatype} does not match "
                f"configured {spec.dtype}"
            )
        shape = tuple(int(d) for d in tensor.shape)
        this_batch = _validate_configured_shape(spec, shape, cfg.max_batch_size)
        if batch is None:
            batch = this_batch
        elif this_batch != batch:
            raise InputValidationError(
                f"input {spec.name!r}: batch dim {this_batch} differs from {batch}"
            )
        dt = numpy_dtype(spec.dtype)
        expected_bytes = this_batch * spec.elements_per_sample * dt.itemsize
        if len(raw) != expected_bytes:
            raise InputValidationError(
                f"input {spec.name!r}: raw size {len(raw)} != expected {expected_bytes}"
            )
        out[spec.name] = np.frombuffer(raw, dtype=dt).reshape((this_batch, *spec.dims))
    return out


def _validate_configured_shape(spec, shape, max_batch: int) -> int:
    """Returns the batch size. Accepts [dims...] (implicit batch 1) or
    [B, dims...] with 1 <= B <= max_batch
    (reference: validate_configured_shape, inference_service_io.cpp:31-114)."""
    dims = spec.dims
    if shape == dims:
        return 1
    if len(shape) == len(dims) + 1 and tuple(shape[1:]) == dims:
        b = shape[0]
        if b < 1 or b > max_batch:
            raise InputValidationError(
                f"input {spec.name!r}: batch dim {b} outside [1, {max_batch}]"
            )
        return b
    raise InputValidationError(
        f"input {spec.name!r}: shape {list(shape)} does not match configured "
        f"dims {list(dims)} (with optional leading batch dim)"
    )


def populate_response(cfg: RuntimeConfig, request: pb.ModelInferRequest,
                      outputs: Dict[str, np.ndarray],
                      response: Optional[pb.ModelInferResponse] = None) -> pb.ModelInferResponse:
    """Fill raw_output_contents and output metadata
    (reference: populate_response, inference_service_io.cpp:377-560)."""
    resp = response or pb.ModelInferResponse()
    resp.model_name = request.model_name or cfg.name
    resp.model_version = request.model_version or "1"
    resp.id = request.id
    requested: List[str] = [t.name for t in request.outputs if t.name]
    order = requested if requested else [s.name for s in cfg.outputs]
    declared = {s.name: s.dtype for s in cfg.outputs}
    for i, name in enumerate(order):
        arr = outputs.get(name)
        if arr is None and not requested:
            arr = outputs.get(f"output{i}")  # positional outputN fallback
        if arr is None:
            raise InputValidationError(f"no output named {name!r}")
        tensor = resp.outputs.add()
        tensor.name = name or f"output{i}"
        # BF16 travels as its uint16 bit patterns: name it from the config
        tensor.datatype = declared.get(name) or wire_name(arr.dtype)
        tensor.shape.extend(int(d) for d in arr.shape)
        resp.raw_output_contents.append(np.ascontiguousarray(arr).tobytes())
    return resp


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
    JAX server; reference: grpc_service.proto:823-908)."""
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
