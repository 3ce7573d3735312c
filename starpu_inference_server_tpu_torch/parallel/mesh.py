"""The (data, pipe, expert, model) mesh of rank processes.

Counterpart of ``starpu_inference_server_tpu/parallel/mesh.py``. A JAX
mesh is a grid of devices that one program addresses; here every mesh
position is a process (a rank of ``torch.distributed``), and a
``shard_map`` body becomes the program each rank runs on its own shard.
:func:`make_device_mesh` lays the ranks out in the JAX axis order
(``model`` fastest, then ``expert``, ``pipe``, ``data``) with
``torch.distributed.device_mesh.init_device_mesh``, which gives one
process group per axis; :class:`RankMesh` adds this rank's coordinates,
its device and the groups the stage bodies reduce over.

Backend rule (:func:`choose_backend`): ``nccl`` when every rank has a
GPU of its own, ``gloo`` when ranks share a card or run on the CPU. A
backend that fails to start or to communicate is an error; nothing
switches to the other one. NCCL refuses two ranks on one device, so
``nccl`` with ranks sharing a card is refused here with its reason.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, PIPE_AXIS, EXPERT_AXIS, MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: int = 1
    model: int = 1
    expert: int = 1
    pipe: int = 1

    @property
    def size(self) -> int:
        return self.data * self.pipe * self.expert * self.model

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        """Axis sizes in mesh order (data, pipe, expert, model)."""
        return (self.data, self.pipe, self.expert, self.model)


def device_grid(axes: MeshAxes, devices: Sequence) -> np.ndarray:
    """The first ``axes.size`` of ``devices`` as a (data, pipe, expert,
    model) grid; the JAX function's error when there are too few."""
    devs = list(devices)
    if axes.size > len(devs):
        raise ValueError(
            f"mesh of size {axes.size} (data={axes.data} x pipe={axes.pipe}"
            f" x expert={axes.expert} x model={axes.model}) needs more "
            f"than the {len(devs)} available devices"
        )
    grid = np.empty(axes.size, dtype=object)
    grid[:] = devs[: axes.size]
    return grid.reshape(axes.shape)


def choose_backend(world_size: int, device_type: str, device_ids: Sequence[int] = ()) -> str:
    """``nccl`` when each of the ``world_size`` ranks gets a GPU of its own
    (``device_ids``, default the visible cards), ``gloo`` when ranks share
    a card or run on the CPU."""
    if device_type != "cuda":
        return "gloo"
    cards = len(device_ids) if device_ids else torch.cuda.device_count()
    return "nccl" if cards >= world_size else "gloo"


def rank_device(rank: int, device_type: str, device_ids: Sequence[int] = ()) -> torch.device:
    """Rank ``r`` runs on ``cuda:{device_ids[r % len(device_ids)]}`` (all
    visible cards when none are named), or on the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    ids = list(device_ids) or list(range(max(1, torch.cuda.device_count())))
    return torch.device("cuda", ids[rank % len(ids)])


def initialize_distributed(
    init_method: str,
    world_size: int,
    rank: int,
    backend: str,
    device: torch.device,
    timeout_s: float = 300.0,
) -> None:
    """Join the world (``torch.distributed.init_process_group``) as
    ``rank`` of ``world_size`` at ``init_method`` (``tcp://host:port`` or
    ``file://path``). Refuses ``nccl`` for ranks that share a device:
    NCCL rejects duplicate GPUs, and no other backend is tried instead.
    ``timeout_s`` bounds every collective, so a dead or hung rank makes
    the others fail instead of waiting forever."""
    import torch.distributed as dist

    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs every rank on a GPU")
        if world_size > torch.cuda.device_count():
            raise ValueError(
                f"nccl needs a GPU per rank: {world_size} ranks, "
                f"{torch.cuda.device_count()} visible GPUs (NCCL refuses two "
                "ranks on one device; use gloo, which the backend rule picks "
                "when ranks share a card)"
            )
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


class RankMesh:
    """This rank's view of the mesh: axis sizes, its coordinates, its
    device, the per-axis process groups of ``init_device_mesh`` and the
    (expert, model) group the MoE combine sums over.

    Every rank must construct it (group creation is collective), after
    :func:`initialize_distributed`, with the same ``axes``."""

    def __init__(self, axes: MeshAxes, device: torch.device):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        from .collectives import CollectiveStats

        world = dist.get_world_size()
        device_grid(axes, range(world))
        if axes.size != world:
            raise ValueError(f"mesh of size {axes.size} needs a world of {axes.size} ranks, "
                             f"got {world}")
        self.axes = axes
        self.device = device
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        self.world_size = world
        mesh_type = "cuda" if self.backend == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(mesh_type, axes.shape, mesh_dim_names=AXES)
        coord = np.unravel_index(self.rank, axes.shape)
        self.coords: Dict[str, int] = {a: int(c) for a, c in zip(AXES, coord)}
        self.groups = {a: self.device_mesh.get_group(a) for a in AXES}
        # one group per (data, pipe) slice over (expert, model); every rank
        # creates every group, in the same order
        ranks = np.arange(world).reshape(axes.shape)
        self.groups[(EXPERT_AXIS, MODEL_AXIS)] = None
        for d in range(axes.data):
            for p in range(axes.pipe):
                members = ranks[d, p].reshape(-1).tolist()
                group = dist.new_group(members)
                if self.rank in members:
                    self.groups[(EXPERT_AXIS, MODEL_AXIS)] = group
        # ranks along the pipe axis through this rank, by stage
        self._ranks = ranks
        self.pipe_ranks = self.axis_ranks(PIPE_AXIS)
        # CPU-side control group (commands, weights, statistics): gloo over
        # the world; under nccl a gloo group of its own
        self.control = None if self.backend == "gloo" else dist.new_group(backend="gloo")
        self.shape = {a: getattr(axes, a) for a in AXES}
        self.stats = CollectiveStats()  # collectives.py counts every call here

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def world_coords(self, axis: str) -> list:
        """Every world rank's coordinate on ``axis``, in rank order."""
        i = AXES.index(axis)
        return [int(np.unravel_index(r, self.axes.shape)[i]) for r in range(self.world_size)]

    def axis_ranks(self, axis: str) -> list:
        """The world ranks along ``axis`` through this rank, by their
        coordinate on it."""
        index = tuple(slice(None) if a == axis else self.coords[a] for a in AXES)
        return self._ranks[index].tolist()

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    @property
    def stage(self) -> int:
        return self.coords[PIPE_AXIS]

    @property
    def stages(self) -> int:
        return self.axes.pipe

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors go through host buffers (gloo on a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def describe(self) -> str:
        return (f"rank {self.rank}/{self.world_size} {self.backend} on {self.device} at "
                + " ".join(f"{a}={self.coords[a]}/{self.shape[a]}" for a in AXES))


def make_device_mesh(axes: MeshAxes, device: Optional[torch.device] = None) -> RankMesh:
    """Build this rank's :class:`RankMesh` over the initialized world
    (``torch.distributed``, its backend); the counterpart of the JAX
    function, with ranks in place of devices. ``device`` defaults to the
    CPU."""
    return RankMesh(axes, torch.device(device) if device is not None else torch.device("cpu"))
