"""Exception hierarchy for the inference engine.

Mirrors the capability of the reference's ~22-class hierarchy rooted at
``InferenceEngineException`` (reference: src/utils/exceptions.hpp:11-155).
"""

from __future__ import annotations

from typing import Optional


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

