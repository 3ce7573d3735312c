"""Host staging slot pool: pre-allocated, reusable batch buffers.

Counterpart of ``starpu_inference_server_tpu/core/slot_pool.py``
(reference: ``SlotPoolBase`` / ``InputSlotPool``, slot_pool_base.hpp:16-167):
``pool_size`` slots, each holding one host buffer per model input sized
``max_batch x per-sample elements``, with blocking acquire/release and a
double-release check.

The buffers are torch tensors in the staging dtype: page-locked
(``pin_memory=True``) when the engine runs on CUDA, so the H2D copy of a
batch is asynchronous on the lane's stream; plain CPU tensors on the CPU.
Requests are written into them through numpy views (BF16 buffers through
their uint16 bit patterns, see :func:`utils.dtypes.bf16_bits`), one plain
copy per request input at its batch offset, so the batch is assembled
once and never concatenated.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.config import TensorSpec
from ..utils.dtypes import bf16_bits, canonical_dtype_name, torch_dtype
from ..utils.exceptions import PipelineError


class Slot:
    __slots__ = ("index", "buffers", "_host", "in_use")

    def __init__(self, index: int, specs: Sequence[TensorSpec], max_batch: int,
                 pin_memory: bool):
        self.index = index
        self.buffers: Dict[str, torch.Tensor] = {}
        # numpy views of the same memory, for the per-request copies
        self._host: Dict[str, np.ndarray] = {}
        for spec in specs:
            t = torch.zeros((max_batch, *spec.dims), dtype=torch_dtype(spec.dtype),
                            pin_memory=pin_memory)
            self.buffers[spec.name] = t
            if canonical_dtype_name(spec.dtype) == "BF16":
                self._host[spec.name] = t.view(torch.int16).numpy().view(np.uint16)
            else:
                self._host[spec.name] = t.numpy()
        self.in_use = False

    def write(self, name: str, offset: int, array: np.ndarray) -> None:
        """Copy one request's samples into the batch buffer at ``offset``
        (float wire data staged in a BF16 buffer is rounded on the way)."""
        dst = self._host[name][offset:offset + array.shape[0]]
        if self.buffers[name].dtype == torch.bfloat16 and array.dtype != np.uint16:
            dst[...] = bf16_bits(array)
        else:
            dst[...] = array

    def view(self, bucket: int) -> Dict[str, torch.Tensor]:
        """The first ``bucket`` rows of every buffer (padding rows hold
        whatever an earlier batch left; their outputs are never read)."""
        return {name: buf[:bucket] for name, buf in self.buffers.items()}


class SlotPool:
    """Blocking pool of ``pool_size`` staging slots
    (reference: SlotPoolBase acquire/release semantics)."""

    def __init__(self, specs: Sequence[TensorSpec], max_batch: int, pool_size: int,
                 pin_memory: bool = False):
        self._slots: List[Slot] = [Slot(i, specs, max_batch, pin_memory)
                                   for i in range(pool_size)]
        self._free: List[int] = list(range(pool_size))
        self._lock = threading.Lock()
        self._available = threading.Condition(self._lock)
        self._closed = False

    @property
    def size(self) -> int:
        return len(self._slots)

    def acquire(self, timeout: Optional[float] = None) -> Optional[Slot]:
        """Block until a slot is free; None on timeout or pool shutdown."""
        with self._available:
            while not self._free and not self._closed:
                if not self._available.wait(timeout=timeout):
                    return None
            if self._closed:
                return None
            slot = self._slots[self._free.pop()]
            slot.in_use = True
            return slot

    def release(self, slot: Slot) -> None:
        with self._available:
            if not slot.in_use:
                raise PipelineError(f"double release of slot {slot.index}")
            slot.in_use = False
            self._free.append(slot.index)
            self._available.notify()

    def close(self) -> None:
        with self._available:
            self._closed = True
            self._available.notify_all()

