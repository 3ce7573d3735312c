"""Model registry: family name -> ModelDefinition.

Counterpart of ``starpu_inference_server_tpu/models/registry.py``.
``build_model`` makes the same parameter tree as the JAX package: random
weights come from the same ``np.random.default_rng(seed)`` calls in the
same order (or from an ``.npz`` archive), are quantized per the config
and land on the target device as torch tensors. Orbax checkpoints wait
for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.quant import maybe_quantize_tree
from ..utils.config import ModelSettings, QuantMode, TensorSpec
from ..utils.dtypes import torch_dtype
from ..utils.exceptions import ModelLoadError, UnknownModelFamilyError

InitFn = Callable[[np.random.Generator], Any]

QUANT_BITS = {QuantMode.NONE: None, QuantMode.INT8: 8, QuantMode.INT4: 4,
              QuantMode.W8A8: 8, QuantMode.W4A8: 4}


@dataclasses.dataclass(frozen=True)
class ModelDefinition:
    family: str
    init_params: InitFn           # numpy tree, same RNG order as the JAX package
    apply: Callable               # (params, {name: tensor}, dtype) -> {name: tensor}
    input_specs: Tuple[TensorSpec, ...]
    output_specs: Tuple[TensorSpec, ...]
    supports_generation: bool = False
    spec: Any = None              # family spec (decoder: DecoderSpec)
    # params -> params with constants derived once at build time
    # (ResNet: the folded stem weights); None keeps the tree as it is
    prepare: Optional[Callable[[Any], Any]] = None


_REGISTRY: Dict[str, Callable[[Mapping[str, Any]], ModelDefinition]] = {}


def register_family(name: str):
    def wrap(make_definition):
        _REGISTRY[name] = make_definition
        return make_definition

    return wrap


def _ensure_loaded() -> None:
    from . import bert, decoder, identity, resnet, vit  # noqa: F401


def available_families() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def get_family(name: str, options: Optional[Mapping[str, Any]] = None) -> ModelDefinition:
    _ensure_loaded()
    make_definition = _REGISTRY.get(name)
    if make_definition is None:
        raise UnknownModelFamilyError(
            f"unknown model family {name!r}; available: {', '.join(sorted(_REGISTRY))}"
        )
    return make_definition(options or {})


@dataclasses.dataclass
class BuiltModel:
    """A servable model: definition + params on ``device`` + compute dtype."""

    definition: ModelDefinition
    params: Any
    compute_dtype: torch.dtype
    quant: QuantMode
    device: torch.device

    def apply(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.definition.apply(self.params, inputs, self.compute_dtype)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA
    is asked for (explicitly or by default) and is missing."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the GPU unless the "
            "caller passes device='cpu'"
        )
    return dev


def build_model(settings: ModelSettings, seed: int = 0, device=None) -> BuiltModel:
    """Init (numpy, seeded) or load params, move them to ``device``
    (default ``cuda``) and quantize there per ``settings.quantization``."""
    from ..weights import params_from_numpy

    dev = resolve_device(device)
    definition = get_family(settings.family, settings.options)
    if settings.params == "random":
        tree = definition.init_params(np.random.default_rng(seed))
    else:
        tree = load_params(settings.params)
    params = maybe_quantize_tree(params_from_numpy(tree, dev),
                                 QUANT_BITS[settings.quantization])
    if definition.prepare is not None:
        params = definition.prepare(params)
    return BuiltModel(
        definition=definition,
        params=params,
        compute_dtype=torch_dtype(settings.compute_dtype),
        quant=settings.quantization,
        device=dev,
    )


def load_params(path: str) -> Any:
    """Load a numpy param tree from an ``.npz`` archive ('a/b/c' keys ->
    nested dicts; numeric keys -> lists), as the JAX package writes it."""
    import os

    if os.path.isdir(path):
        raise ModelLoadError(
            f"{path} is a directory: Orbax checkpoints are not yet ported "
            "(ROADMAP); export the tree as .npz"
        )
    try:
        flat = np.load(path, allow_pickle=False)
    except Exception as exc:
        raise ModelLoadError(f"failed to load params from {path}: {exc}") from exc
    tree: Dict[str, Any] = {}
    for key in flat.files:
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = flat[key]
    return _listify(tree)


def _listify(node):
    if isinstance(node, dict):
        conv = {k: _listify(v) for k, v in node.items()}
        if conv and all(k.isdigit() for k in conv):
            return [conv[str(i)] for i in range(len(conv))]
        return conv
    return node
