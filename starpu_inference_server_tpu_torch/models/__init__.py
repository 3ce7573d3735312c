"""Model zoo of the port (decoder families in this slice)."""

from .registry import ModelDefinition, available_families, build_model, get_family

__all__ = [
    "ModelDefinition",
    "available_families",
    "build_model",
    "get_family",
]
