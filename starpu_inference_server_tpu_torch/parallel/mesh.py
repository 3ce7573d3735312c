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

Launchers (the JAX package's ``jax.distributed`` processes): a world
of ``W`` ranks is started by ``num_processes`` launchers, each owning
``L = W / num_processes`` consecutive global ranks, ``process_id * L +
local rank`` (:func:`local_size`). That is ``jax.devices()``'s order (by
process) reshaped row-major over (data, pipe, expert, model), so the
innermost axes stay inside a launcher and the outer ones cross
(:func:`crossing_axes`). A rank's device comes from its local rank.

Backend rule (:func:`choose_backend`): ``nccl`` when every launcher has a
GPU per local rank, ``gloo`` when ranks share a card or run on the CPU.
The launchers must agree: each rank posts its launcher's choice to the
rendezvous store before ``init_process_group`` (:func:`agree_backend`),
and a disagreement is an error naming both. A backend that fails to
start or to communicate is an error; nothing switches to the other one.
NCCL refuses two ranks on one device, so ``nccl`` with ranks sharing a
card is refused here with its reason.
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


def local_size(world_size: int, num_processes: int) -> int:
    """Ranks a launcher owns: ``world_size / num_processes``; an error
    naming both when ``num_processes`` does not divide the mesh."""
    if num_processes < 1 or world_size % num_processes:
        raise ValueError(f"a mesh of {world_size} positions cannot be split over "
                         f"num_processes={num_processes} launchers: each launcher owns the "
                         "same number of consecutive ranks")
    return world_size // num_processes


def crossing_axes(axes: MeshAxes, local: int) -> list:
    """The axis labels (``AXES`` order, then ``expert+model``) whose groups
    hold ranks of more than one launcher, when a launcher owns ``local``
    consecutive ranks (the JAX mesh axes that cross processes)."""
    launcher = np.arange(axes.size).reshape(axes.shape) // local
    out = []
    for i, axis in enumerate(AXES):
        rows = np.moveaxis(launcher, i, -1).reshape(-1, axes.shape[i])
        if (rows.min(-1) != rows.max(-1)).any():
            out.append(axis)
    pairs = launcher.reshape(axes.data * axes.pipe, -1)
    if axes.expert * axes.model > 1 and (pairs.min(-1) != pairs.max(-1)).any():
        out.append(f"{EXPERT_AXIS}+{MODEL_AXIS}")
    return out


def choose_backend(local_ranks: int, device_type: str, device_ids: Sequence[int] = ()) -> str:
    """``nccl`` when each of a launcher's ``local_ranks`` ranks gets a GPU
    of its own (``device_ids``, default the visible cards), ``gloo`` when
    ranks share a card or run on the CPU."""
    if device_type != "cuda":
        return "gloo"
    cards = len(device_ids) if device_ids else torch.cuda.device_count()
    return "nccl" if cards >= local_ranks else "gloo"


def rank_device(local_rank: int, device_type: str, device_ids: Sequence[int] = ()) -> torch.device:
    """Local rank ``i`` of a launcher runs on
    ``cuda:{device_ids[i % len(device_ids)]}`` (the launcher's visible cards
    when none are named), or on the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    ids = list(device_ids) or list(range(max(1, torch.cuda.device_count())))
    return torch.device("cuda", ids[local_rank % len(ids)])


def rendezvous_store(init_method: str, world_size: int, rank: int, timeout_s: float):
    """The store of ``init_method``: ``tcp://host:port`` (a ``TCPStore``
    that global rank 0 hosts; a rank that starts first waits for it up to
    ``timeout_s``) or ``file://path`` (a ``FileStore``)."""
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=timeout_s)
    scheme, _, where = init_method.partition("://")
    if scheme == "tcp":
        host, _, port = where.rpartition(":")
        return dist.TCPStore(host.strip("[]"), int(port), world_size, is_master=rank == 0,
                             timeout=timeout, wait_for_workers=False)
    if scheme == "file":
        store = dist.FileStore(where, world_size)
        store.set_timeout(timeout)
        return store
    raise ValueError(f"init method {init_method!r}: expected tcp://host:port or file://path")


def agree_backend(store, rank: int, world_size: int, launcher: int, backend: str,
                  card: str = "-") -> None:
    """Post this rank's backend (its launcher's choice) and its card (the
    GPU's UUID, ``-`` on the CPU) to ``store`` and read every rank's; an
    error naming both choices when two launchers differ, and under
    ``nccl`` one naming two ranks that share a card (launchers on one host
    that each count its cards as theirs). Every rank waits for the
    others' posts (the store's timeout)."""
    store.set(f"backend/{rank}", f"{backend} {launcher} {card}")
    cards = {}
    for r in range(world_size):
        theirs, other, their_card = store.get(f"backend/{r}").decode().split()
        if theirs != backend:
            raise ValueError(f"the launchers disagree on the backend: launcher {launcher} chose "
                             f"{backend}, launcher {other} chose {theirs} (nccl needs a GPU per "
                             "local rank on every launcher)")
        if backend == "nccl" and their_card in cards:
            raise ValueError(f"nccl needs a GPU per rank: ranks {cards[their_card]} and {r} "
                             f"(launcher {other}) share card {their_card}; give launchers on one "
                             "host disjoint devices.device_ids")
        cards[their_card] = r


def initialize_distributed(
    init_method: str,
    world_size: int,
    rank: int,
    backend: str,
    device: torch.device,
    timeout_s: float = 300.0,
    local_ranks: Optional[int] = None,
) -> None:
    """Join the world (``torch.distributed.init_process_group``) as
    ``rank`` of ``world_size`` at ``init_method`` (``tcp://host:port`` or
    ``file://path``), after every launcher agreed on ``backend``
    (:func:`agree_backend`). ``local_ranks``: ranks of this rank's
    launcher (default the world). Refuses ``nccl`` for ranks that share a
    device: NCCL rejects duplicate GPUs, and no other backend is tried
    instead. ``timeout_s`` bounds the rendezvous and every collective, so
    a dead or hung rank makes the others fail instead of waiting forever."""
    import torch.distributed as dist

    local = local_ranks or world_size
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs every rank on a GPU")
        if local > torch.cuda.device_count():
            raise ValueError(
                f"nccl needs a GPU per rank: {local} ranks on this launcher, "
                f"{torch.cuda.device_count()} visible GPUs (NCCL refuses two "
                "ranks on one device; use gloo, which the backend rule picks "
                "when ranks share a card)"
            )
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = rendezvous_store(init_method, world_size, rank, timeout_s)
    card = str(torch.cuda.get_device_properties(device).uuid) if device.type == "cuda" else "-"
    agree_backend(store, rank, world_size, rank // local, backend, card)
    dist.init_process_group(
        backend, store=store, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


class RankMesh:
    """This rank's view of the mesh: axis sizes, its coordinates, its
    device, the per-axis process groups of ``init_device_mesh`` and the
    (expert, model) group the MoE combine sums over; the launchers
    (``local`` consecutive ranks each): this rank's (``launcher``), every
    rank's (:meth:`process_index`) and the axes whose groups cross them
    (``crossing``).

    Every rank must construct it (group creation is collective), after
    :func:`initialize_distributed`, with the same ``axes``."""

    def __init__(self, axes: MeshAxes, device: torch.device, local: Optional[int] = None,
                 timeout_s: float = 300.0):
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
        self.local = local or world
        self.launchers = world // self.local
        self.launcher = self.rank // self.local
        self.crossing = crossing_axes(axes, self.local)
        self.timeout_s = timeout_s  # the collectives' timeout
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

    def process_index(self, rank: int) -> int:
        """The launcher of world rank ``rank`` (JAX ``Device.process_index``)."""
        return rank // self.local

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
        return (f"rank {self.rank}/{self.world_size} {self.backend} on {self.device} "
                f"(launcher {self.launcher}/{self.launchers}) at "
                + " ".join(f"{a}={self.coords[a]}/{self.shape[a]}" for a in AXES))


def make_device_mesh(axes: MeshAxes, device: Optional[torch.device] = None,
                     local: Optional[int] = None, timeout_s: float = 300.0) -> RankMesh:
    """Build this rank's :class:`RankMesh` over the initialized world
    (``torch.distributed``, its backend); the counterpart of the JAX
    function, with ranks in place of devices. ``device`` defaults to the
    CPU; ``local``: ranks a launcher owns (default the world: one
    launcher)."""
    return RankMesh(axes, torch.device(device) if device is not None else torch.device("cpu"),
                    local, timeout_s)
