"""ModelEngine: eager execution of one model on one device or one mesh.

Counterpart of ``starpu_inference_server_tpu/core/engine.py`` (reference:
the StarPU codelet and model loader, starpu_setup.cpp:594-846 and
inference_runner.cpp:243-275). What changes on the card:

- there is no jit: the model runs eagerly, and :meth:`prime` runs each
  batch bucket once at warmup, which builds the CUDA kernels of the path
  and warms cuDNN's algorithm choice for that shape;
- one device, ``cuda`` unless the caller asks for the CPU (the model is
  built there by ``models.registry.build_model``);
- a device mesh (``devices.mesh.size > 1``) is ONE logical executor, as
  in the JAX engine, over a world of rank processes (``parallel/``):
  every rank constructs the engine with its ``mesh``; rank 0, with the
  whole model, cuts every rank's shard by the family's partition rules
  and sends it, and drives each batch through the mesh's
  ``parallel.launch.BatchWorker`` (the batch scattered over ``data``,
  tensor-parallel BERT and ViT, data-parallel ResNet; with a ``pipe``
  axis the family's ``pipeline_apply``, the GPipe forward over
  ``microbatches``); the other ranks follow its commands. Buckets round
  up to the batch granularity (the data size, or its lcm with the
  microbatches in pipe mode); the mesh has no CUDA streams of its own, so
  lanes take turns on it;
- :meth:`put_inputs` is a non-blocking H2D copy from the pinned slot,
  :meth:`fetch` one D2H copy per output and then a synchronise of the
  current stream, which inside an execution lane is the lane's own
  stream (serving/lanes.py), so lanes fence only their own work.

``staging_specs`` keeps the JAX engine's choice: FP32 wire inputs are
staged as BF16 when the compute dtype is bf16 (the model casts at once
anyway), which halves the H2D bytes.

:meth:`reload` swaps in a freshly built model (RepositoryModelLoad), as
the JAX engine's ``reload`` does: same quantization, same leaf shapes and
dtypes, published whole.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models.registry import BuiltModel
from ..ops import nn
from ..ops.quant import pack_int4_tree
from ..utils.config import QuantMode, RuntimeConfig
from ..utils.dtypes import canonical_dtype_name, torch_dtype
from ..utils.exceptions import DeviceError
from ..utils.logger import get_logger


def _leaf_specs(tree, path: str = "") -> List[Tuple[str, object]]:
    """(path, (shape, dtype)) of every tensor leaf of a param tree, and
    (path, value) of every other leaf, in tree order."""
    if isinstance(tree, dict):
        return [spec for key in sorted(tree) for spec in _leaf_specs(tree[key], f"{path}/{key}")]
    if isinstance(tree, (list, tuple)):
        return [spec for i, node in enumerate(tree) for spec in _leaf_specs(node, f"{path}/{i}")]
    if isinstance(tree, torch.Tensor):
        return [(path, (tuple(tree.shape), str(tree.dtype)))]
    return [(path, tree)]


class ModelEngine:
    def __init__(self, cfg: RuntimeConfig, model: BuiltModel, mesh=None):
        """``mesh``: this rank's ``parallel.mesh.RankMesh`` when
        ``cfg.devices.mesh`` has more than one position. Rank 0 passes the
        whole model and each other rank a shell (its ``params`` None) that
        receives the rank's shard; the other ranks then run
        ``parallel.launch.follow(engine.worker)``."""
        mesh_cfg = cfg.devices.mesh
        self.cfg = cfg
        self.mesh = None
        self.worker = None
        self._pipelined = False
        self._microbatches = 1
        if mesh_cfg.size > 1:
            if mesh_cfg.pipe > 1 and model.definition.pipeline_apply is None:
                raise DeviceError(f"devices.mesh.pipe={mesh_cfg.pipe} but model family "
                                  f"{model.definition.family!r} has no pipeline_apply")
            if mesh is None:
                raise ValueError(
                    f"devices.mesh of size {mesh_cfg.size} runs as that many rank "
                    "processes: start it from the server CLI (parallel/launch.py:serve_mesh) "
                    "or pass each rank's mesh"
                )
            self.mesh = mesh
            self._pipelined = mesh_cfg.pipe > 1
            self._microbatches = mesh_cfg.microbatches
        elif mesh is not None:
            raise ValueError("a mesh was passed for a config whose devices.mesh has one position")
        self.device = mesh.device if mesh is not None else model.device
        nn.set_w8a8(model.quant in (QuantMode.W8A8, QuantMode.W4A8))
        self._pack = nn.use_kernels(self.device) and model.quant in (QuantMode.INT4,
                                                                      QuantMode.W4A8)
        self._compile_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self._primed: set = set()  # buckets
        if self.mesh is None:
            self.model = self._placed(model)
            return
        from ..parallel.launch import BatchWorker
        from ..weights import receive_shard, scatter_shards

        spec = model.definition.spec
        if mesh.rank == 0:
            shard = scatter_shards(model.params, spec, model.definition.family, mesh)
        else:
            shard = receive_shard(mesh)
        self.model = dataclasses.replace(model, params=self._place_params(shard),
                                         device=self.device)
        self.worker = BatchWorker(mesh, self.model, self.staging_specs(),
                                  pipelined=self._pipelined, microbatches=self._microbatches,
                                  place=self._place_params)

    def _place_params(self, params):
        """``params`` ready to serve: int4 leaves packed pairwise when the
        int4 kernels read them, and visible to every stream (they were made
        on the default stream; lanes read them on theirs)."""
        if self._pack:
            params = pack_int4_tree(params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return params

    def _placed(self, model: BuiltModel) -> BuiltModel:
        model.params = self._place_params(model.params)
        return model

    def reload(self, model: BuiltModel) -> None:
        """Hot weight reload (RepositoryModelLoad): serve ``model``, a
        fresh build of the same config on this engine's device, in place
        of the current one. A different quantization, device, or any leaf
        whose shape or dtype differs raises ``DeviceError`` before
        anything is published. The swap is one assignment under the
        reload lock: an ``execute`` in flight holds the model it read
        (old or new, never a mix), and the old tree's device memory
        returns to the allocator once the last such call ends. Every
        weight-derived constant (the ResNet stem's folded and staged
        weights) is part of the tree, built with it.

        On a mesh (rank 0) every rank's shard is cut once and the check
        holds rank 0's against its serving one; then, under the mesh
        worker's turn (between two forwards), every other rank is sent its
        shard and every rank swaps its in."""
        with self._reload_lock:  # serialize concurrent RepositoryModelLoad
            old = self.model
            if model.quant is not old.quant:
                raise DeviceError(f"reload quantization {model.quant} != serving {old.quant}")
            if model.device != self.device:
                raise DeviceError(f"reload built on {model.device}, serving on {self.device}")
            if self.worker is not None:
                from ..weights import cut_shards, own_shard

                shards = cut_shards(model.params, model.definition.spec,
                                    model.definition.family, self.mesh)
                mine = self._place_params(own_shard(shards[0], self.device))
                if _leaf_specs(mine) != _leaf_specs(old.params):
                    raise DeviceError("reloaded param tree structure/shapes/dtypes differ "
                                      "from the serving tree")
                self.worker.reload(shards, mine)
                self.model = self.worker.model
                return
            model = self._placed(model)
            if _leaf_specs(model.params) != _leaf_specs(old.params):
                raise DeviceError(
                    "reloaded param tree structure/shapes/dtypes differ from the serving tree"
                )
            self.model = model

    @property
    def pipelined(self) -> bool:
        """True on a mesh with a ``pipe`` axis (the GPipe forward)."""
        return self._pipelined

    def min_batch_granularity(self) -> int:
        """Batches divide evenly over the data axis on a mesh; the
        pipelined forward also splits them into microbatches."""
        if self.mesh is None:
            return 1
        g = self.mesh.size("data")
        if self._pipelined:
            g = g * self._microbatches // math.gcd(g, self._microbatches)
        return g

    def effective_bucket(self, bucket: int) -> int:
        g = self.min_batch_granularity()
        return ((bucket + g - 1) // g) * g

    def num_devices(self) -> int:
        """Logical executors: 1, one device or one mesh."""
        return 1

    @property
    def buckets(self) -> Sequence[int]:
        return sorted({self.effective_bucket(b) for b in self.cfg.buckets})

    def staging_specs(self):
        """Input specs with the dtype the staging buffers hold: float wire
        inputs at bf16 when the model computes in bf16."""
        specs = []
        for spec in self.cfg.inputs:
            if self.model.compute_dtype == torch.bfloat16 and spec.dtype in ("FP32", "FP64"):
                specs.append(dataclasses.replace(spec, dtype="BF16"))
            else:
                specs.append(spec)
        return specs

    def device_name(self) -> str:
        if self.mesh is not None:
            return f"mesh(data={self.mesh.size('data')},model={self.mesh.size('model')})"
        if self.device.type == "cuda":
            return f"cuda:{self.device.index or 0}"
        return str(self.device)

    # ------------------------------------------------------------------

    def put_inputs(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Host -> device copy of a padded batch, asynchronous from pinned
        memory on the current stream (a copy on the CPU too, so nothing
        the model returns aliases the slot, which is reused). On a mesh the
        batch stays on the host (a copy): :meth:`execute` scatters it."""
        if self.worker is not None:
            return {name: t.clone() for name, t in inputs.items()}
        return {name: t.to(self.device, non_blocking=True, copy=True)
                for name, t in inputs.items()}

    def execute(self, inputs_on_device: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Run the model; returns device tensors as soon as the work is
        enqueued (the lane decides when to fence). On a mesh: the whole
        forward over the ranks, the outputs on rank 0's device."""
        if self.worker is not None:
            return self.worker.forward(inputs_on_device)
        model = self.model  # one read: a concurrent reload swaps the whole model
        with torch.inference_mode():
            return model.apply(inputs_on_device)

    def run_padded(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.execute(self.put_inputs(inputs))

    def fetch(self, outputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One D2H copy per output tensor, then a synchronise of the
        current stream: the fence of this batch only."""
        host = {name: t.to("cpu", non_blocking=True) for name, t in outputs.items()}
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return host

    def conform_outputs(self, outputs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """Host tensors -> numpy in their declared wire dtype (the bf16
        staging path would otherwise leak the compute dtype into outputs
        of models that pass inputs through)."""
        declared = {s.name: s.dtype for s in self.cfg.outputs}
        conformed = {}
        for name, t in outputs.items():
            wire = declared.get(name)
            if wire is None:
                conformed[name] = (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()
            elif canonical_dtype_name(wire) == "BF16":
                conformed[name] = t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
            else:
                conformed[name] = t.to(torch_dtype(wire)).numpy()
        return conformed

    # ------------------------------------------------------------------

    def prime(self, bucket: int) -> bool:
        """Run a zero batch of ``bucket`` rows once (kernel builds, cuDNN
        algorithm choice). Returns True the first time for a bucket."""
        with self._compile_lock:
            if bucket in self._primed:
                return False
            self._primed.add(bucket)
        zeros = {spec.name: torch.zeros((bucket, *spec.dims), dtype=torch_dtype(spec.dtype))
                 for spec in self.staging_specs()}
        self.fetch(self.run_padded(zeros))
        return True

    def prime_all(self) -> int:
        """Prime every bucket; returns the number primed now."""
        log = get_logger()
        count = 0
        for bucket in self.buckets:
            if self.prime(bucket):
                count += 1
                log.debug("primed %s bucket=%d", self.device_name(), bucket)
        return count
