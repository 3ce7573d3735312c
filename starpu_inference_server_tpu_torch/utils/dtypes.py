"""Datatype mapping: KServe-v2 wire names <-> numpy / torch dtypes.

Counterpart of ``starpu_inference_server_tpu/utils/dtypes.py`` without
``jax`` or ``ml_dtypes``. numpy has no bfloat16, so BF16 wire bytes are
carried as ``np.uint16`` (the same two bytes) and become a torch tensor
through ``.view(torch.bfloat16)`` (see :func:`torch_from_wire`). BYTES
is defined by the protocol but rejected at runtime, as in the reference.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .exceptions import InvalidDtypeError, UnsupportedDtypeError

# wire name -> numpy dtype (BF16: the raw 16-bit pattern)
_WIRE_TO_NUMPY = {
    "BOOL": np.dtype(np.bool_),
    "UINT8": np.dtype(np.uint8),
    "UINT16": np.dtype(np.uint16),
    "UINT32": np.dtype(np.uint32),
    "UINT64": np.dtype(np.uint64),
    "INT8": np.dtype(np.int8),
    "INT16": np.dtype(np.int16),
    "INT32": np.dtype(np.int32),
    "INT64": np.dtype(np.int64),
    "FP16": np.dtype(np.float16),
    "FP32": np.dtype(np.float32),
    "FP64": np.dtype(np.float64),
    "BF16": np.dtype(np.uint16),
}

# numpy -> wire; uint16 maps to UINT16 (a BF16 array has no numpy dtype)
_NUMPY_TO_WIRE = {v: k for k, v in _WIRE_TO_NUMPY.items() if k != "BF16"}

_WIRE_TO_TORCH = {
    "BOOL": torch.bool,
    "UINT8": torch.uint8,
    "UINT16": torch.uint16,
    "UINT32": torch.uint32,
    "UINT64": torch.uint64,
    "INT8": torch.int8,
    "INT16": torch.int16,
    "INT32": torch.int32,
    "INT64": torch.int64,
    "FP16": torch.float16,
    "FP32": torch.float32,
    "FP64": torch.float64,
    "BF16": torch.bfloat16,
}

ALL_WIRE_DTYPES = tuple(_WIRE_TO_NUMPY)


def canonical_dtype_name(name: str) -> str:
    """Normalize a dtype name ('fp32', 'FP32', 'float32' ...) to wire form."""
    upper = str(name).strip().upper()
    aliases = {
        "FLOAT32": "FP32",
        "FLOAT": "FP32",
        "FLOAT64": "FP64",
        "DOUBLE": "FP64",
        "FLOAT16": "FP16",
        "HALF": "FP16",
        "BFLOAT16": "BF16",
        "INT": "INT32",
        "LONG": "INT64",
        "BYTE": "INT8",
    }
    upper = aliases.get(upper, upper)
    if upper in ("BYTES", "STRING", "TYPE_STRING"):
        raise UnsupportedDtypeError(
            "BYTES/STRING tensors are defined by the protocol but not "
            "supported at runtime"
        )
    if upper.startswith("TYPE_"):
        upper = upper[len("TYPE_"):]
    if upper not in _WIRE_TO_NUMPY:
        raise InvalidDtypeError(f"unknown dtype: {name!r}")
    return upper


def numpy_dtype(name: str) -> np.dtype:
    """Wire name -> numpy dtype of the wire bytes (BF16 -> uint16)."""
    return _WIRE_TO_NUMPY[canonical_dtype_name(name)]


def torch_dtype(name: str) -> torch.dtype:
    return _WIRE_TO_TORCH[canonical_dtype_name(name)]


def torch_from_wire(raw: bytes, name: str) -> torch.Tensor:
    """Wire bytes -> 1-D CPU tensor of the wire dtype (BF16 through a
    uint16 view, since numpy has no bfloat16)."""
    wire = canonical_dtype_name(name)
    arr = np.frombuffer(raw, dtype=_WIRE_TO_NUMPY[wire]).copy()
    t = torch.from_numpy(arr)
    if wire == "BF16":
        t = t.view(torch.bfloat16)
    return t


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """Float array -> its bfloat16 bit patterns (uint16), rounded to
    nearest even as ``tensor.to(torch.bfloat16)`` rounds; NaN stays NaN.
    Lets a read-only numpy view (a request's bytes) be staged into a
    bf16 buffer without a torch tensor over it."""
    f = np.asarray(a, dtype=np.float32)
    u = np.ascontiguousarray(f).view(np.uint32)
    rounded = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16).astype(np.uint16)
    return np.where(np.isnan(f), np.uint16(0x7FC0), rounded)


def wire_name(dtype: Union[np.dtype, torch.dtype, type, str]) -> str:
    """numpy or torch dtype -> wire name."""
    if isinstance(dtype, str):
        return canonical_dtype_name(dtype)
    if isinstance(dtype, torch.dtype):
        for wire, td in _WIRE_TO_TORCH.items():
            if td == dtype:
                return wire
        raise InvalidDtypeError(f"no wire name for dtype {dtype!r}")
    dt = np.dtype(dtype)
    try:
        return _NUMPY_TO_WIRE[dt]
    except KeyError:
        raise InvalidDtypeError(f"no wire name for dtype {dtype!r}") from None


def element_size(name: str) -> int:
    return int(numpy_dtype(name).itemsize)
