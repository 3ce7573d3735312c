"""Model registry: family name -> ModelDefinition.

Counterpart of ``starpu_inference_server_tpu/models/registry.py``.
``build_model`` makes the same parameter tree as the JAX package: random
weights come from the same ``np.random.default_rng(seed)`` calls in the
same order (or from an ``.npz`` archive or an Orbax checkpoint
directory), are quantized per the config and land on the target device
as torch tensors.
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
    # (params, {name: tensor}, dtype, mesh=None) -> {name: tensor}. With a
    # mesh (a parallel.mesh.RankMesh, GSPMD mode) ``params`` is the rank's
    # shard by the family's partition rules, the inputs are the rank's rows
    # of the batch, and the body calls the collectives GSPMD would insert
    apply: Callable
    input_specs: Tuple[TensorSpec, ...]
    output_specs: Tuple[TensorSpec, ...]
    supports_generation: bool = False
    spec: Any = None              # family spec (decoder: DecoderSpec)
    # params -> params with constants derived once at build time
    # (ResNet: the folded stem weights); None keeps the tree as it is
    prepare: Optional[Callable[[Any], Any]] = None
    # pipeline-parallel forward: (shard, inputs, mesh, num_microbatches,
    # dtype) -> outputs over the mesh 'pipe' axis, ``shard`` the rank's
    # cut of ``parallel.pipeline.prepare_pipelined_params``. Families
    # without it refuse a pipe axis in the batch engine
    pipeline_apply: Optional[Callable] = None
    # (layer_params, tp, pipe=False) -> layer_params: the block-alignment
    # permutation of fused projections for ``tp``-way tensor parallelism
    # (parallel/tp_layout.py; ``pipe``: a pipe-mode stage's layout, else
    # GSPMD mode's), applied to every layer before the cut
    tp_layer_shuffle: Optional[Callable] = None


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

    def apply(self, inputs: Dict[str, torch.Tensor], mesh=None) -> Dict[str, torch.Tensor]:
        if mesh is None:
            return self.definition.apply(self.params, inputs, self.compute_dtype)
        return self.definition.apply(self.params, inputs, self.compute_dtype, mesh=mesh)


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
    """Load a numpy param tree, as the JAX package's ``load_params`` does:

    - a directory -> an Orbax ``StandardCheckpointer`` checkpoint, read
      with ``tensorstore`` (:func:`_load_orbax`);
    - an ``.npz`` file -> a flat-key archive ('a/b/c' keys -> nested
      dicts; numeric keys -> lists).
    """
    import os

    if os.path.isdir(path):
        return _load_orbax(path)
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


# the value an Orbax checkpoint records for an empty node (skip_deserialize)
_EMPTY_NODES = {"Dict": dict, "List": list, "Tuple": tuple, "None": lambda: None}


class _Seq(dict):
    """A sequence level of a checkpoint's tree while it is rebuilt: index -> child."""


def _load_orbax(path: str) -> Any:
    """Read an Orbax ``StandardCheckpointer`` directory without Orbax (which
    imports jax), with ``tensorstore``, imported here.

    ``_METADATA``'s ``tree_metadata`` lists every leaf: its key path
    (``key_type`` 1 is a sequence index, 2 a dict key) and its value
    metadata. An empty node (``skip_deserialize``, e.g. ``Dict``) is
    restored empty; every other leaf is a zarr array named by its key path
    joined with '.', as Orbax joins it (a key ``x.y`` gives ``x.y.0``), in
    an OCDBT kvstore on the directory (a directory per leaf when
    ``use_ocdbt`` is false; zarr v3 when ``use_zarr3`` is true). Arrays
    come back as numpy arrays (bfloat16 as ``ml_dtypes.bfloat16``),
    ``scalar`` leaves as Python scalars, as Orbax restores them without a
    target tree.
    """
    import json
    import os

    fail = f"failed to restore orbax checkpoint {path}"
    try:
        with open(os.path.join(path, "_METADATA")) as fh:
            meta = json.load(fh)
        entries = [(e["key_metadata"], e["value_metadata"])
                   for e in meta["tree_metadata"].values()]
    except (OSError, ValueError, KeyError, TypeError, AttributeError) as exc:
        raise ModelLoadError(f"{fail}: not an Orbax checkpoint directory ({exc!r})") from exc
    try:
        import tensorstore as ts
    except ImportError as exc:
        raise ModelLoadError(f"{fail}: reading it needs the tensorstore package") from exc

    base = os.path.abspath(path)

    def kvstore(name):
        if meta.get("use_ocdbt", True):
            return {"driver": "ocdbt", "base": f"file://{base}/", "path": name}
        return {"driver": "file", "path": f"{base}/{name}/"}

    driver = "zarr3" if meta.get("use_zarr3", False) else "zarr"
    context = ts.Context()
    pending = []  # (key path, value type, storage name, open future)
    leaves = []   # (key path, value)
    for keys, value in entries:
        if not keys:
            raise ModelLoadError(f"{fail}: a leaf without a key path")
        if value.get("skip_deserialize"):
            empty = _EMPTY_NODES.get(value.get("value_type"))
            if empty is None:
                raise ModelLoadError(f"{fail}: unknown empty node {value!r}")
            leaves.append((keys, empty()))
            continue
        name = ".".join(str(k["key"]) for k in keys)
        spec = {"driver": driver, "kvstore": kvstore(name)}
        pending.append((keys, value.get("value_type"), name,
                        ts.open(spec, open=True, read=True, context=context)))
    for keys, kind, name, opened in pending:
        try:
            arr = np.asarray(opened.result().read().result())
        except Exception as exc:  # tensorstore raises ValueError for a missing leaf
            raise ModelLoadError(f"{fail}: leaf {name!r}: {exc}") from exc
        leaves.append((keys, arr.item() if kind == "scalar" else arr))
    return _finish(_tree_of(leaves, fail), fail)


def _tree_of(leaves, fail: str):
    """Nest ``(key path, value)`` pairs: dicts for dict keys, ``_Seq`` for
    sequence indices."""
    kinds = {1: _Seq, 2: dict}
    root = None
    for keys, value in leaves:
        path = [(int(k["key_type"]), k["key"]) for k in keys]
        if any(kind not in kinds for kind, _ in path):
            raise ModelLoadError(f"{fail}: unknown key type in {keys!r}")
        if root is None:
            root = kinds[path[0][0]]()
        node = root
        for depth, (kind, key) in enumerate(path):
            if type(node) is not kinds[kind]:
                raise ModelLoadError(f"{fail}: key path {keys!r} disagrees with another leaf's")
            key = int(key) if kind == 1 else key
            if depth == len(path) - 1:
                node[key] = value
            else:
                node = node.setdefault(key, kinds[path[depth + 1][0]]())
    return root


def _finish(node, fail: str):
    """``_Seq`` levels to lists (indices 0..n-1, all present)."""
    if isinstance(node, _Seq):
        if sorted(node) != list(range(len(node))):
            raise ModelLoadError(f"{fail}: sequence indices {sorted(node)}")
        return [_finish(node[i], fail) for i in range(len(node))]
    if type(node) is dict:
        return {k: _finish(v, fail) for k, v in node.items()}
    return node
