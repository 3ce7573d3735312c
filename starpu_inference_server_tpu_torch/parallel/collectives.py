"""Collectives of the stage programs over the mesh's process groups.

The port's counterpart of what a ``shard_map`` body calls in the JAX
package:

- :func:`psum` (``jax.lax.psum``) over one axis or the (``expert``,
  ``model``) pair: an all-reduce on that axis's group; a no-op on a
  size-1 axis, as XLA compiles it away;
- :func:`pmax` (``jax.lax.pmax``): the all-reduce MAX that GSPMD
  inserts for an abs-max over a sharded dim (the per-row activation
  scale of a row-parallel W8A8 layer over ``model``, the per-tensor one
  of a W8A8 conv over ``data``);
- :func:`all_gather` over one axis: what GSPMD inserts around the
  model-sharded embedding and lm head, and over ``data`` to bring a
  data-sharded batch's rows (outputs, logits) back together;
- :func:`scatter_rows`: rank 0's batch cut into the row blocks of the
  ``data`` coordinates, each rank receiving its own (``batch_sharding``'s
  placement of an input);
- :class:`PipeRing` (``jax.lax.ppermute`` over ``pipe``): sends to the
  next stage and receives from the previous one, the last stage's next
  being stage 0; :func:`ppermute_ring` posts one full rotation over an
  axis at once with ``batch_isend_irecv``, so no order of the ranks can
  deadlock (the ring attention's K/V hops ride it over the sequence
  axis);
- :func:`broadcast` for rank 0's commands (the last stage's results
  reach rank 0 by the ring's hop to stage 0, ``pipeline_decode.py``).

Every call is counted by (operation, axis) in the mesh's
:class:`CollectiveStats`, with the host seconds it took
(``parallel/census.py`` reads the counts). A call on a size-1 axis
counts nothing.

Gloo on a card (ranks sharing one GPU, ``RankMesh.staged``) takes CUDA
tensors for all-reduce, broadcast and all-gather, but its send / recv on
a CUDA tensor abort the process ("writev ... Bad address"; two ranks on
an H100, ``scripts/torch_gloo_probe.py``), so every point-to-point hop
is staged through a pinned host buffer there. Sums run in float32 (in
float64 for a float64 tensor: exact integer partial sums); everything
else moves the tensor's bytes (viewed as uint8, which every backend
takes).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple, Union

import torch

from .mesh import DATA_AXIS, PIPE_AXIS, RankMesh

Axis = Union[str, Tuple[str, ...]]

class CollectiveStats:
    """Calls and host seconds by (operation, axis label)."""

    def __init__(self):
        self.calls: Dict[Tuple[str, str], int] = defaultdict(int)
        self.seconds: Dict[Tuple[str, str], float] = defaultdict(float)

    def add(self, op: str, axis: str, seconds: float) -> None:
        self.calls[(op, axis)] += 1
        self.seconds[(op, axis)] += seconds

    def reset(self) -> None:
        self.calls.clear()
        self.seconds.clear()

    def snapshot(self) -> dict:
        """{"calls": {"op/axis": n}, "ms": {"op/axis": ms}} (JSON-ready)."""
        return {"calls": {f"{o}/{a}": n for (o, a), n in sorted(self.calls.items())},
                "ms": {f"{o}/{a}": s * 1e3 for (o, a), s in sorted(self.seconds.items())}}


def _label(axis: Axis) -> str:
    return axis if isinstance(axis, str) else "+".join(axis)


def _group_size(mesh: RankMesh, axis: Axis) -> int:
    if isinstance(axis, str):
        return mesh.size(axis)
    n = 1
    for a in axis:
        n *= mesh.size(a)
    return n


def _group(mesh: RankMesh, axis: Axis):
    return mesh.groups[axis if isinstance(axis, str) else tuple(axis)]


def _staged(mesh: RankMesh, t: torch.Tensor) -> bool:
    """Whether a point-to-point hop of ``t`` goes through host memory."""
    return mesh.staged and t.is_cuda


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t`` (a synchronous copy)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def psum(mesh: RankMesh, x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``x`` over ``axis`` (one axis or a tuple of axes): every rank of
    the group gets the sum, at ``x``'s dtype (summed in float32). For two
    bf16 addends that is the bf16 sum of ``lax.psum`` bit for bit (their
    float32 sum is exact, or the smaller one is below half a bf16 ulp of
    the larger); over more ranks it rounds once where a bf16 reduction
    rounds at every step. A float64 ``x`` is summed in float64: integer
    partial sums below 2^53 (an s32 contraction's shards) add exactly."""
    if _group_size(mesh, axis) == 1:
        return x
    import torch.distributed as dist

    t0 = time.perf_counter()
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    buf = x.to(acc).contiguous()
    dist.all_reduce(buf, group=_group(mesh, axis))
    out = buf.to(x.dtype)
    mesh.stats.add("all-reduce", _label(axis), time.perf_counter() - t0)
    return out


def pmax(mesh: RankMesh, x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``axis`` on every rank of the
    group (a no-op on a size-1 axis). Exact at any dtype; counted as an
    ``all-reduce-max``."""
    if _group_size(mesh, axis) == 1:
        return x
    import torch.distributed as dist

    t0 = time.perf_counter()
    buf = x.to(torch.float32).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=_group(mesh, axis))
    out = buf.to(x.dtype)
    mesh.stats.add("all-reduce-max", _label(axis), time.perf_counter() - t0)
    return out


def all_gather(mesh: RankMesh, x: torch.Tensor, axis: str, dim: int = -1) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in the order of their
    coordinate on ``axis`` (a no-op on a size-1 axis)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    import torch.distributed as dist

    t0 = time.perf_counter()
    src = _bytes(x)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=_group(mesh, axis))
    out = torch.cat([p.view(x.dtype).reshape(x.shape) for p in parts], dim=dim)
    mesh.stats.add("all-gather", axis, time.perf_counter() - t0)
    return out


def row_block(mesh: RankMesh, rows: int, axis: str = DATA_AXIS) -> slice:
    """This rank's block of ``rows`` rows sharded over ``axis``
    (contiguous, in coordinate order)."""
    n = mesh.size(axis)
    if rows % n:
        raise ValueError(f"{rows} rows do not split over {axis}={n}")
    per = rows // n
    return slice(mesh.coord(axis) * per, (mesh.coord(axis) + 1) * per)


def scatter_rows(mesh: RankMesh, x, shape: Sequence[int], dtype: torch.dtype,
                 axis: str = DATA_AXIS) -> torch.Tensor:
    """Rank 0's host tensor ``x`` [B, ...] (None on the other ranks, which
    pass its ``shape`` and ``dtype``) cut into ``axis``'s row blocks: every
    rank returns the block of its coordinate, on the host. Travels on the
    control group (``torch.distributed.scatter`` from rank 0); counted
    once as a ``scatter`` on ``axis``, on every rank."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    shape = tuple(shape)
    per = shape[0] // mesh.size(axis)
    out = torch.empty((per, *shape[1:]), dtype=dtype)
    parts = None
    if mesh.rank == 0:
        blocks = x.contiguous().reshape(mesh.size(axis), per, *shape[1:])
        parts = [_bytes(blocks[c]) for c in mesh.world_coords(axis)]
    dist.scatter(_bytes(out), parts, src=0, group=mesh.control)
    mesh.stats.add("scatter", axis, time.perf_counter() - t0)
    return out


def gather_rows(mesh: RankMesh, x: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
    """Every data block's rows of ``x`` [B/n, ...] concatenated in
    coordinate order: [B, ...] on every rank of the ``axis`` group, rank 0
    among them (an :func:`all_gather` on dim 0)."""
    return all_gather(mesh, x, axis, dim=0)


def broadcast(mesh: RankMesh, x: torch.Tensor, src: int = 0, group=None,
              axis: str = "world") -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank of ``group`` (default: the world).
    Returns the result."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    buf = _bytes(x)
    dist.broadcast(buf, src=src, group=group)
    mesh.stats.add("broadcast", axis, time.perf_counter() - t0)
    return buf.view(x.dtype).reshape(x.shape)


class PipeRing:
    """Point-to-point hops along the pipe axis: :meth:`send` to the next
    stage (stage 0 after the last), :meth:`recv` from the previous one.
    Sends are posted without waiting (``isend``) and kept, with their
    buffers, until :meth:`wait`; receives block. Each hop counts once as a
    ``collective-permute`` on ``pipe``."""

    def __init__(self, mesh: RankMesh):
        self.mesh = mesh
        s = mesh.stages
        stage = mesh.stage
        self.next = mesh.pipe_ranks[(stage + 1) % s]
        self.prev = mesh.pipe_ranks[(stage - 1) % s]
        self._pending: List[tuple] = []

    def send(self, x: torch.Tensor) -> None:
        import torch.distributed as dist

        t0 = time.perf_counter()
        buf = _bytes(x)
        if _staged(self.mesh, buf):
            buf = _host(buf)
        self._pending.append((dist.isend(buf, dst=self.next), buf))
        self.mesh.stats.add("collective-permute", PIPE_AXIS, time.perf_counter() - t0)

    def recv(self, shape: Sequence[int], dtype: torch.dtype, device) -> torch.Tensor:
        import torch.distributed as dist

        t0 = time.perf_counter()
        nbytes = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
        on_host = self.mesh.staged and torch.device(device).type == "cuda"
        buf = torch.empty(nbytes, dtype=torch.uint8,
                          device="cpu" if on_host else device, pin_memory=on_host)
        dist.recv(buf, src=self.prev)
        out = buf.view(dtype).reshape(tuple(shape)).to(device, non_blocking=True)
        # the hop was counted where it was sent; its wait counts here
        self.mesh.stats.seconds[("collective-permute", PIPE_AXIS)] += time.perf_counter() - t0
        return out

    def wait(self) -> None:
        t0 = time.perf_counter()
        for work, _ in self._pending:
            work.wait()
        self._pending.clear()
        self.mesh.stats.seconds[("collective-permute", PIPE_AXIS)] += time.perf_counter() - t0


def ppermute_ring(mesh: RankMesh, x: torch.Tensor, axis: str = PIPE_AXIS) -> torch.Tensor:
    """``jax.lax.ppermute(x, axis, [(i, (i + 1) % n)])``: every rank of the
    ``axis`` ring sends ``x`` to the next and returns what the previous
    one sent. The send and the receive are posted together
    (``batch_isend_irecv``)."""
    import torch.distributed as dist

    n = mesh.size(axis)
    if n == 1:
        return x
    t0 = time.perf_counter()
    ring = mesh.axis_ranks(axis)
    me = mesh.coord(axis)
    nxt, prev = ring[(me + 1) % n], ring[(me - 1) % n]
    buf = _bytes(x)
    staged = _staged(mesh, buf)
    if staged:
        buf = _host(buf)
    out = torch.empty_like(buf)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, nxt),
                                    dist.P2POp(dist.irecv, out, prev)])
    for w in works:
        w.wait()
    res = out.view(x.dtype).reshape(x.shape)
    if staged:
        res = res.to(x.device, non_blocking=True)
    mesh.stats.add("collective-permute", axis, time.perf_counter() - t0)
    return res


__all__ = ["CollectiveStats", "PipeRing", "all_gather", "broadcast", "gather_rows", "pmax",
           "ppermute_ring", "psum", "row_block", "scatter_rows"]
