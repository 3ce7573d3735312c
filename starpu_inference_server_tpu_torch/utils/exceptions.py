"""Exception hierarchy for the inference engine.

Mirrors the capability of the reference's ~22-class hierarchy rooted at
``InferenceEngineException`` (reference: src/utils/exceptions.hpp:11-155)
plus its category classification used for failure logging
(reference: src/utils/exception_classification.hpp).
"""

from __future__ import annotations

import enum
import logging
from typing import Callable, Optional, TypeVar


class InferenceEngineError(Exception):
    """Root of all framework errors."""


# -- configuration ----------------------------------------------------------

class ConfigError(InferenceEngineError):
    """Bad or missing configuration."""


class UnknownConfigKeyError(ConfigError):
    def __init__(self, key: str, suggestion: Optional[str] = None):
        msg = f"unknown config key: {key!r}"
        if suggestion:
            msg += f" (did you mean {suggestion!r}?)"
        super().__init__(msg)
        self.key = key
        self.suggestion = suggestion


class MissingConfigKeyError(ConfigError):
    def __init__(self, key: str):
        super().__init__(f"missing required config key: {key!r}")
        self.key = key


class InvalidConfigValueError(ConfigError):
    pass


# -- model ------------------------------------------------------------------

class ModelError(InferenceEngineError):
    pass


class ModelLoadError(ModelError):
    pass


class UnknownModelFamilyError(ModelError):
    pass


class ModelNotReadyError(ModelError):
    pass


# -- tensors / validation ---------------------------------------------------

class TensorError(InferenceEngineError):
    pass


class InvalidDtypeError(TensorError):
    pass


class ShapeMismatchError(TensorError):
    pass


class InputValidationError(TensorError):
    pass


class UnsupportedDtypeError(TensorError):
    """Datatype defined by the protocol but rejected at runtime
    (reference rejects TYPE_STRING: docs/server_guide.md:103)."""


# -- serving pipeline -------------------------------------------------------

class PipelineError(InferenceEngineError):
    pass


class QueueFullError(PipelineError):
    """Bounded queue rejected a push (maps to gRPC RESOURCE_EXHAUSTED;
    reference: inference_queue.hpp:41-69)."""


class QueueClosedError(PipelineError):
    """Queue closed for push during shutdown (maps to gRPC UNAVAILABLE)."""


class QueueShutdownError(PipelineError):
    pass


class BatchCompositionError(PipelineError):
    pass


class SubmissionError(PipelineError):
    pass


class CancelledError(PipelineError):
    pass


class WarmupTimeoutError(PipelineError):
    pass


class DrainTimeoutError(PipelineError):
    pass


# -- execution --------------------------------------------------------------

class ExecutionError(InferenceEngineError):
    pass


class DeviceError(ExecutionError):
    pass


class CompilationError(ExecutionError):
    pass


class InferenceExecutionError(ExecutionError):
    pass


# -- classification (reference: exception_classification.hpp) ---------------

class ErrorCategory(enum.Enum):
    INFERENCE_ENGINE = "inference_engine"
    RUNTIME_ERROR = "runtime_error"
    LOGIC_ERROR = "logic_error"
    BAD_ALLOC = "bad_alloc"
    STD_EXCEPTION = "std_exception"
    UNKNOWN = "unknown"


def classify_exception(exc: BaseException) -> ErrorCategory:
    """Bucket an exception as the reference's category enum does
    (InferenceEngine/RuntimeError/LogicError/BadAlloc/StdException/Unknown)."""
    if isinstance(exc, InferenceEngineError):
        return ErrorCategory.INFERENCE_ENGINE
    if isinstance(exc, MemoryError):
        return ErrorCategory.BAD_ALLOC
    if isinstance(exc, (ValueError, TypeError, AssertionError, KeyError, IndexError)):
        return ErrorCategory.LOGIC_ERROR
    if isinstance(exc, RuntimeError):
        return ErrorCategory.RUNTIME_ERROR
    if isinstance(exc, Exception):
        return ErrorCategory.STD_EXCEPTION
    return ErrorCategory.UNKNOWN


_T = TypeVar("_T")


def run_with_logged_exceptions(fn: Callable[[], _T], where: str,
                               logger: Optional[logging.Logger] = None) -> Optional[_T]:
    """Run ``fn``, logging (never propagating) any exception: callbacks of
    the serving threads (the result dispatcher, the queue's size observer)
    must not tear the thread down (reference: exception_logging.hpp)."""
    try:
        return fn()
    except BaseException as exc:  # noqa: BLE001 - containment by design
        log = logger or logging.getLogger("sis_tpu")
        log.error("exception in %s [%s]: %s", where, classify_exception(exc).value, exc,
                  exc_info=True)
        return None
