"""Rank processes of a mesh server: the workers, the commands rank 0
sends, the follower loop, and the spawning of a world.

The JAX package runs a mesh as ONE program over many devices. Here each
mesh position is a process and rank 0 drives: it runs the gRPC server
and the engine (admission, scheduling, sampling, streams; or the batch
pipeline) and, before each piece of device work, broadcasts a small
command through its worker (:class:`MeshWorker`): the operation, its host
ints and its int32 payload. Every rank then runs the same program on its
own shard; the other ranks sit in :func:`follow` until a stop command.
Commands, weights and statistics travel on the mesh's CPU-side control
group. The workers:

- :class:`PipeWorker`, pipe mode (a ``pipe`` axis): the ``pipelined_*``
  stage programs of ``pipeline_decode.py``;
- :class:`GspmdWorker`, GSPMD-mode generation (no ``pipe`` axis): the
  slots sharded over ``data`` (each data group holds ``S / data`` slots
  of the cache, its kv heads over ``model``), the weights tensor- and
  expert-parallel; a prefill runs on the data group that owns the slot,
  a decode step or verify window on every group's own slots, and the
  logits come back whole to rank 0 (an all-gather over ``data``); a
  prefix-cache hit's row copy may cross groups;
- :class:`BatchWorker`, the batch engine (``core/engine.py``) on any
  mesh: rank 0's padded batch scattered over ``data`` (whole to every
  rank in pipe mode, where the JAX forward replicates it), the family's
  ``apply`` (or ``pipeline_apply``) on the rank's shard, the outputs
  gathered over ``data``; and the hot reload of every rank's shard.

A call that fails on any rank leaves the others inside the same
program, so the world cannot go on: rank 0 calls
``MeshWorker.on_fatal`` (the CLI's exits the process), a follower
raises out of :func:`follow`, and the collectives' timeout
(``initialize_distributed``) turns a hung rank into an error on the
others. On an idle server rank 0 sends a no-op command whenever the
mesh has been quiet for a quarter of that timeout
(:meth:`MeshWorker.keep_alive`), so waiting for the next command never
expires while rank 0 lives.

Launchers (the JAX package's ``jax.distributed`` processes):
:func:`run_launcher` spawns a launcher's local ranks (``parallel/mesh.py``
lays them out), which join the world at one address; global rank 0
(launcher 0's first) hosts the rendezvous store, serves and drives. It
forwards SIGINT / SIGTERM to rank 0 on launcher 0, stops its ranks on
another launcher, and when any of its ranks exits with an error stops the
rest and returns non-zero; a dead rank or launcher elsewhere reaches it
through its ranks' collectives' timeout. :func:`serve_mesh`, the server
CLI, is one launcher: all of the mesh, or with
``distributed.coordinator_address`` launcher ``process_id`` of
``num_processes``.

:func:`run_world` runs a function on every rank of a fresh world, started
by one or several launchers (the tests and ``chip_smoke.py`` use it); the
function is named ``"module:function"`` and must live in a module that
imports no JAX.
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
import signal
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .mesh import DATA_AXIS, MeshAxes, RankMesh

(OP_STOP, OP_PREFILL, OP_DECODE, OP_VERIFY, OP_STATS, OP_RESET, OP_CHUNK, OP_FORWARD,
 OP_RELOAD, OP_COPY, OP_PING) = range(11)
_HEADER = 8  # int64 words: op, payload length, up to six host ints


class MeshWorker:
    """Rank 0's command channel and every rank's side of it: rank 0's
    driven calls broadcast a command, then run the program; a follower
    receives the command (:meth:`receive`) and runs the same program
    (:meth:`execute`, through the subclass's :meth:`run_command`). One
    command and its program at a time: several threads of rank 0 (the
    batch engine's lanes) take turns on the mesh."""

    def __init__(self, mesh: RankMesh):
        self.mesh = mesh
        # rank 0: called with the exception when a driven call fails (the
        # world is broken then); None re-raises only
        self.on_fatal: Optional[Callable[[BaseException], None]] = None
        self._turn = threading.Lock()
        self._last = time.monotonic()  # rank 0: when the last command went out
        self._stopped = threading.Event()

    def _driven(self, op: int, ints: Sequence[int], tensors: Sequence[torch.Tensor], run):
        with self._turn:
            try:
                self._command(op, ints, tensors)
                return run()
            except BaseException as exc:
                if self.on_fatal is not None and not isinstance(exc, KeyboardInterrupt):
                    self.on_fatal(exc)
                raise

    def stop_followers(self) -> None:
        """Send the stop command: every follower leaves :func:`follow`."""
        with self._turn:
            self._stopped.set()
            self._command(OP_STOP, (), ())

    def keep_alive(self) -> threading.Thread:
        """Rank 0: a daemon thread that sends a no-op command whenever no
        command went out for a quarter of the collectives' timeout, until
        :meth:`stop_followers`. The followers wait for each command at most
        that timeout, so an idle server's mesh stays up, and a dead
        follower fails the next no-op (``on_fatal``)."""
        period = self.mesh.timeout_s / 4

        def beat():
            while not self._stopped.wait(period / 4):
                if time.monotonic() - self._last < period:
                    continue
                with self._turn:
                    if self._stopped.is_set():
                        return
                    try:
                        self._command(OP_PING, (), ())
                    except BaseException as exc:
                        if self.on_fatal is not None:
                            self.on_fatal(exc)
                        raise

        thread = threading.Thread(target=beat, name="mesh-keep-alive", daemon=True)
        thread.start()
        return thread

    def gather_stats(self) -> List[dict]:
        """Every rank's kernel launches and collective counts (rank order),
        on rank 0; the followers answer from :func:`follow`."""
        with self._turn:
            self._command(OP_STATS, (), ())
            return self._stats_exchange()

    def reset_stats(self) -> None:
        """Zero every rank's kernel launch and collective counts."""
        with self._turn:
            self._command(OP_RESET, (), ())
            _reset_counts(self.mesh)

    def _stats_exchange(self) -> Optional[List[dict]]:
        import torch.distributed as dist

        from ..ops._build import launch_counters

        mine = {"rank": self.mesh.rank, "coords": dict(self.mesh.coords),
                "launcher": self.mesh.launcher, "crossing": list(self.mesh.crossing),
                "launches": {k: v for t in launch_counters() for k, v in t.items() if v},
                "collectives": self.mesh.stats.snapshot()}
        out = [None] * self.mesh.world_size if self.mesh.rank == 0 else None
        dist.gather_object(mine, out, dst=0, group=self.mesh.control)
        return out

    def _command(self, op: int, ints: Sequence[int], tensors: Sequence[torch.Tensor]) -> None:
        from .collectives import broadcast

        parts = [t.reshape(-1).to(torch.int32).cpu() for t in tensors]
        payload = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int32)
        header = torch.zeros(_HEADER, dtype=torch.int64)
        header[0], header[1] = op, payload.numel()
        header[2:2 + len(ints)] = torch.tensor(list(ints), dtype=torch.int64)
        self._last = time.monotonic()
        broadcast(self.mesh, header, group=self.mesh.control, axis="control")
        if payload.numel():
            broadcast(self.mesh, payload, group=self.mesh.control, axis="control")

    def receive(self):
        """The next command: (op, host ints, int32 payload on the CPU)."""
        from .collectives import broadcast

        header = broadcast(self.mesh, torch.zeros(_HEADER, dtype=torch.int64),
                           group=self.mesh.control, axis="control")
        n = int(header[1])
        payload = torch.zeros(n, dtype=torch.int32)
        if n:
            payload = broadcast(self.mesh, payload, group=self.mesh.control, axis="control")
        return int(header[0]), [int(v) for v in header[2:]], payload

    def execute(self, op: int, ints: List[int], payload: torch.Tensor) -> bool:
        """Run one received command; False after the stop command."""
        if op == OP_STOP:
            return False
        if op == OP_PING:
            pass
        elif op == OP_STATS:
            self._stats_exchange()
        elif op == OP_RESET:
            _reset_counts(self.mesh)
        else:
            self.run_command(op, ints, payload)
        return True

    def run_command(self, op: int, ints: List[int], payload: torch.Tensor) -> None:
        raise ValueError(f"unknown command {op} for {type(self).__name__}")


class _DecoderWorker(MeshWorker):
    """A decoder's worker: rank 0's :meth:`prefill`, :meth:`decode` and
    :meth:`verify` send their command (ids, active mask and every slot's
    length) and run the subclass's ``run_*`` program; a follower runs the
    same program on the command's payload."""

    def prefill(self, ids: torch.Tensor, length: int, slot: int) -> torch.Tensor:
        return self._driven(OP_PREFILL, (ids.shape[0], length, slot),
                            (ids, self.cache.lengths),
                            lambda: self.run_prefill(ids, length, slot))

    def decode(self, ids: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        return self._driven(OP_DECODE, (), (ids, active, self.cache.lengths),
                            lambda: self.run_decode(ids, active))

    def verify(self, ids: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        return self._driven(OP_VERIFY, (ids.shape[1],), (ids, active, self.cache.lengths),
                            lambda: self.run_verify(ids, active))

    def run_command(self, op: int, ints: List[int], payload: torch.Tensor) -> None:
        """A follower's side: the payload is the command's ids (and active
        mask), then the ``num_slots`` slot lengths, which replace the
        rank's own before the program runs."""
        s = self.num_slots
        data = payload.to(self.mesh.device)
        self.cache.lengths.copy_(data[-s:])
        if op == OP_PREFILL:
            p, length, slot = ints[:3]
            self.run_prefill(data[:p], length, slot)
        elif op == OP_CHUNK:
            c, start, valid, slot = ints[:4]
            self.run_chunk(data[:c], start, valid, slot)
        elif op == OP_DECODE:
            self.run_decode(data[:s], data[s:2 * s] > 0)
        elif op == OP_VERIFY:
            w = ints[0]
            self.run_verify(data[:s * w].reshape(s, w), data[s * w:s * w + s] > 0)
        elif op == OP_COPY:
            self.run_copy(*ints[:2])
        else:
            super().run_command(op, ints, payload)


class PipeWorker(_DecoderWorker):
    """One rank's pipelined decoder: its parameter shard, its shard of the
    stacked KV cache (``cache``; lengths replicated) and the three stage
    programs. On rank 0 :meth:`prefill`, :meth:`decode` and :meth:`verify`
    broadcast their command first; the followers run the same programs
    from :func:`follow`."""

    def __init__(self, mesh: RankMesh, spec, params, num_slots: int, max_len: int, dtype,
                 microgroups: int, chunks: int):
        from .pipeline_decode import init_stage_cache

        super().__init__(mesh)
        self.spec = spec
        self.params = params
        self.dtype = dtype
        self.microgroups = microgroups
        self.chunks = chunks
        self.num_slots = num_slots
        self.cache = init_stage_cache(spec, num_slots, max_len, mesh, mesh.device)

    # -- the programs (every rank) ----------------------------------------

    def run_prefill(self, ids: torch.Tensor, length: int, slot: int):
        from .pipeline_decode import pipelined_prefill

        return pipelined_prefill(self.spec, self.params, self.cache, ids, length, slot,
                                 self.mesh, self.dtype, num_chunks=self.chunks)[1]

    def run_decode(self, ids: torch.Tensor, active: torch.Tensor):
        from .pipeline_decode import pipelined_decode_step

        return pipelined_decode_step(self.spec, self.params, self.cache, ids, active,
                                     self.mesh, self.dtype, self.microgroups)[1]

    def run_verify(self, ids: torch.Tensor, active: torch.Tensor):
        from .pipeline_decode import pipelined_verify_step

        return pipelined_verify_step(self.spec, self.params, self.cache, ids, active,
                                     self.mesh, self.dtype, self.microgroups)[1]



class GspmdWorker(_DecoderWorker):
    """One rank's GSPMD-mode decoder: its parameter shard (decoder rules,
    fused projections block-aligned, or cut as they come where ``model``
    cuts heads), the cache of its data group's ``num_slots / data`` slots
    at its kv heads (``models.decoder.local_heads``: every kv head where
    ``model`` cuts heads, the cache replicated over ``model``), and the
    slot lengths of ALL slots (``cache.lengths``, replicated by every
    command; the engine on rank 0 reads and writes them). The programs are
    ``models/decoder.py``'s with ``mesh``: on rank 0 :meth:`prefill`,
    :meth:`prefill_chunk`, :meth:`decode` and :meth:`verify` broadcast
    their command first and return whole logits; the followers run the
    same programs from :func:`follow`."""

    def __init__(self, mesh: RankMesh, spec, params, num_slots: int, max_len: int, dtype):
        import dataclasses

        from ..models.decoder import KVCache, init_cache, local_heads

        super().__init__(mesh)
        self.spec = spec
        self.params = params
        self.dtype = dtype
        self.num_slots = num_slots
        self.per = num_slots // mesh.size(DATA_AXIS)  # check_mesh: divisible
        self.group = mesh.coord(DATA_AXIS)
        lo = self.group * self.per
        _, kvh = local_heads(spec, mesh)
        shard = init_cache(dataclasses.replace(spec, kv_heads=kvh), self.per, max_len,
                           device=mesh.device)
        lengths = torch.zeros((num_slots,), dtype=torch.int32, device=mesh.device)
        # the engine's view: the rank's cache rows, every slot's length
        self.cache = KVCache(k=shard.k, v=shard.v, k_scale=shard.k_scale,
                             v_scale=shard.v_scale, lengths=lengths)
        # the programs' view: the group's slots (its lengths a view of them)
        self.local = KVCache(k=shard.k, v=shard.v, k_scale=shard.k_scale,
                             v_scale=shard.v_scale, lengths=lengths[lo:lo + self.per])

    # -- the programs (every rank) ----------------------------------------

    def _mine(self, t: torch.Tensor) -> torch.Tensor:
        lo = self.group * self.per
        return t[lo:lo + self.per]

    def _owned(self, slot: int, run) -> torch.Tensor:
        """``run(local slot)`` on the data group that owns ``slot``, the
        [V] logits it returns brought to every rank of every group (the
        other groups contribute zeros)."""
        from .collectives import gather_rows

        group, local = divmod(slot, self.per)
        out = torch.zeros((1, self.spec.vocab), dtype=torch.float32, device=self.mesh.device)
        if group == self.group:
            out = run(local)[None]
        return gather_rows(self.mesh, out)[group]

    def run_prefill(self, ids: torch.Tensor, length: int, slot: int) -> torch.Tensor:
        from ..models.decoder import prefill

        out = self._owned(slot, lambda local: prefill(
            self.spec, self.params, self.local, ids, length, local, self.dtype, self.mesh)[1])
        self.cache.lengths[slot] = length
        return out

    def run_chunk(self, ids: torch.Tensor, start: int, valid: int, slot: int) -> torch.Tensor:
        from ..models.decoder import prefill_chunk

        out = self._owned(slot, lambda local: prefill_chunk(
            self.spec, self.params, self.local, ids, start, valid, local, self.dtype,
            self.mesh)[1])
        self.cache.lengths[slot] = start + valid
        return out

    def run_decode(self, ids: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        from ..models.decoder import decode_step
        from .collectives import gather_rows

        before = self.cache.lengths.clone()
        logits = decode_step(self.spec, self.params, self.local, self._mine(ids),
                             self._mine(active), self.dtype, self.mesh)[1]
        self.cache.lengths.copy_(torch.where(active, before + 1, before))
        return gather_rows(self.mesh, logits)

    def run_verify(self, ids: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        from ..models.decoder import verify_step
        from .collectives import gather_rows

        logits = verify_step(self.spec, self.params, self.local, self._mine(ids),
                             self._mine(active), self.dtype, self.mesh)[1]
        return gather_rows(self.mesh, logits)

    def run_copy(self, src: int, dst: int) -> None:
        """Slot ``src``'s cache rows (every layer, the rank's kv heads) over
        slot ``dst``'s, the device side of a dense prefix-cache hit: within
        one data group a copy on its ranks; across groups each leaf's row
        reaches every group by an all-gather over ``data`` (zeros from the
        groups that do not own ``src``) and the group that owns ``dst``
        writes it."""
        from .collectives import gather_rows

        (g_src, src), (g_dst, dst) = divmod(src, self.per), divmod(dst, self.per)
        c = self.local
        for leaves in (c.k, c.v, c.k_scale, c.v_scale):
            for a in leaves:
                if g_src == g_dst:
                    if self.group == g_src:
                        a[dst] = a[src]
                    continue
                row = a[src] if self.group == g_src else torch.zeros_like(a[src])
                rows = gather_rows(self.mesh, row[None])
                if self.group == g_dst:
                    a[dst] = rows[g_src]

    # -- rank 0: command, then the program (prefill, decode, verify: the base's)

    def copy_rows(self, src: int, dst: int) -> None:
        self._driven(OP_COPY, (src, dst), (self.cache.lengths,),
                     lambda: self.run_copy(src, dst))

    def prefill_chunk(self, ids: torch.Tensor, start: int, valid: int,
                      slot: int) -> torch.Tensor:
        return self._driven(OP_CHUNK, (ids.shape[0], start, valid, slot),
                            (ids, self.cache.lengths),
                            lambda: self.run_chunk(ids, start, valid, slot))


class BatchWorker(MeshWorker):
    """One rank's batch engine on a mesh: its shard of a ``BuiltModel``
    (``model.params``) and the forward of one padded batch. GSPMD mode:
    rank 0's batch is scattered over ``data``, every rank runs the family's
    ``apply`` with the mesh on its rows and shard, and the outputs are
    gathered over ``data``. Pipe mode (``pipelined``): every rank gets the
    whole batch and runs the family's ``pipeline_apply`` over
    ``microbatches``. Rank 0's :meth:`forward` returns the whole outputs on
    its device. :meth:`reload` swaps every rank's shard between commands."""

    def __init__(self, mesh: RankMesh, model, specs, pipelined: bool = False,
                 microbatches: int = 1, place: Optional[Callable] = None):
        super().__init__(mesh)
        self.model = model
        self.specs = list(specs)  # the staging specs: name, dims, wire dtype
        self.pipelined = pipelined
        self.microbatches = microbatches
        self.place = place or (lambda params: params)

    def _inputs(self, rows: int, host: Optional[Dict[str, torch.Tensor]]):
        from ..utils.dtypes import torch_dtype
        from .collectives import broadcast, scatter_rows

        out = {}
        for spec in self.specs:
            shape, dt = (rows, *spec.dims), torch_dtype(spec.dtype)
            x = host[spec.name].to(dt) if host is not None else None
            if self.pipelined:  # the JAX pipelined forward replicates the batch
                buf = x.contiguous() if x is not None else torch.empty(shape, dtype=dt)
                out[spec.name] = broadcast(self.mesh, buf, group=self.mesh.control,
                                           axis="world")
            else:
                out[spec.name] = scatter_rows(self.mesh, x, shape, dt)
        return {k: v.to(self.mesh.device, non_blocking=True) for k, v in out.items()}

    def run_forward(self, rows: int, host: Optional[Dict[str, torch.Tensor]] = None):
        from .collectives import gather_rows

        model = self.model  # one read: a reload swaps the whole model
        inputs = self._inputs(rows, host)
        with torch.inference_mode():
            if self.pipelined:
                return model.definition.pipeline_apply(model.params, inputs, self.mesh,
                                                       self.microbatches, model.compute_dtype)
            out = model.apply(inputs, mesh=self.mesh)
            return {k: gather_rows(self.mesh, v) for k, v in out.items()}

    def forward(self, host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        rows = next(iter(host.values())).shape[0]
        return self._driven(OP_FORWARD, (rows,), (), lambda: self.run_forward(rows, host))

    def reload(self, shards, mine) -> None:
        """Rank 0, between two forwards: send every other rank its shard
        (``shards``, rank order, from ``weights.cut_shards``) and swap in
        ``mine``, rank 0's shard placed and checked already."""
        from ..weights import send_shards

        def swap():
            send_shards(shards, self.mesh)
            self._swap(mine)

        self._driven(OP_RELOAD, (), (), swap)

    def _swap(self, params) -> None:
        import dataclasses

        self.model = dataclasses.replace(self.model, params=params)

    def run_command(self, op: int, ints: List[int], payload: torch.Tensor) -> None:
        if op == OP_FORWARD:
            self.run_forward(ints[0])
        elif op == OP_RELOAD:
            from ..weights import receive_shard

            self._swap(self.place(receive_shard(self.mesh)))
        else:
            super().run_command(op, ints, payload)


def mesh_worker(server_or_engine):
    """The :class:`MeshWorker` of an ``InferenceServer``, a generation
    engine or a batch engine on a mesh (None without a mesh)."""
    obj = server_or_engine
    for name in ("generation_engine", "engine"):
        inner = getattr(obj, name, None)
        if inner is not None:
            obj = inner
            break
    return getattr(obj, "worker", None)


def _reset_counts(mesh: RankMesh) -> None:
    from ..ops._build import launch_counters

    for table in launch_counters():
        for name in table:
            table[name] = 0
    mesh.stats.reset()


def follow(worker: MeshWorker) -> None:
    """A follower's loop: run rank 0's commands until the stop command."""
    while worker.execute(*worker.receive()):
        pass


# -- joining and launching -----------------------------------------------------

def join_mesh(axes: MeshAxes, rank: int, world: int, init_method: str, device_type: str,
              device_ids: Sequence[int] = (), timeout_s: float = 300.0,
              launchers: int = 1) -> RankMesh:
    """Join the world as global ``rank`` of a mesh started by ``launchers``
    launchers and build its :class:`RankMesh`. The backend follows
    ``mesh.choose_backend`` on the launcher's local ranks (every launcher
    must choose the same); the device is ``mesh.rank_device``'s for the
    local rank."""
    from .mesh import (
        choose_backend,
        initialize_distributed,
        local_size,
        make_device_mesh,
        rank_device,
    )

    if world != axes.size:
        raise ValueError(f"a mesh of {axes.size} positions needs {axes.size} ranks, got {world}")
    local = local_size(world, launchers)
    backend = choose_backend(local, device_type, device_ids)
    device = rank_device(rank % local, device_type, device_ids)
    initialize_distributed(init_method, world, rank, backend, device, timeout_s, local)
    return make_device_mesh(axes, device, local, timeout_s)


def _die_with_parent() -> None:
    """Ask the kernel to kill this process when its parent dies (Linux
    ``PR_SET_PDEATHSIG``), so a rank never outlives the launcher that
    would stop it."""
    import ctypes

    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass  # not Linux: the launcher's own stop is all there is


def _import(target: str):
    module, _, name = target.partition(":")
    fn = importlib.import_module(module)
    for part in name.split("."):
        fn = getattr(fn, part)
    return fn


def run_launcher(body: Callable, args_of: Callable[[int], tuple], world: int,
                 launchers: int = 1, index: int = 0, signals: bool = True,
                 deadline: Optional[float] = None, grace_s: float = 60.0) -> int:
    """Launcher ``index`` of ``launchers`` (the JAX package's process):
    spawn its local ranks, global ranks ``index * L`` to ``index * L + L -
    1`` (``L = world / launchers``), each running ``body(*args_of(rank))``,
    and wait for them. Returns 0 when every local rank ended with 0
    (launcher 0: once rank 0 has, its other ranks within ``grace_s``), else
    1; every rank is stopped on the way out. With ``signals``, SIGINT and
    SIGTERM to launcher 0 go to rank 0 (the server's own shutdown, which
    stops every rank of every launcher); another launcher stops its ranks
    and fails, and the mesh fails through its collectives' timeout.
    ``deadline`` (``time.monotonic``): a TimeoutError past it."""
    import multiprocessing as mp

    from ..utils.logger import get_logger
    from .mesh import local_size

    log = get_logger()
    local = local_size(world, launchers)
    if not 0 <= index < launchers:
        raise ValueError(f"process_id {index} is not one of the {launchers} launchers")
    ranks = [index * local + i for i in range(local)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=body, args=args_of(r), name=f"rank{r}") for r in ranks]
    for p in procs:
        p.start()
    for r, p in zip(ranks, procs):
        log.info("rank %d pid %d", r, p.pid)
    stopped = []

    def on_signal(signum, _frame):
        if index == 0:
            if procs[0].is_alive():
                os.kill(procs[0].pid, signum)
        else:
            stopped.append(signum)

    old = {s: signal.signal(s, on_signal) for s in (signal.SIGINT, signal.SIGTERM)} \
        if signals else {}
    try:
        code = 0
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in zip(ranks, procs) if p.exitcode not in (None, 0)]
            if stopped or failed:
                if stopped:
                    log.error("launcher %d got signal %d; stopping its ranks", index, stopped[0])
                else:
                    log.error("rank %d exited with %s; stopping the mesh", failed[0],
                              procs[ranks.index(failed[0])].exitcode)
                code = 1
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"launcher {index}'s ranks did not finish in time")
            if index == 0 and procs[0].exitcode == 0:  # rank 0 is done: the rest end soon
                end = min(time.monotonic() + grace_s, deadline or float("inf"))
                while any(p.is_alive() for p in procs) and time.monotonic() < end:
                    time.sleep(0.1)
                break
            time.sleep(0.1)
        if any(p.is_alive() or p.exitcode != 0 for p in procs):
            code = 1
    finally:
        _stop_all(procs)
        for s, h in old.items():
            signal.signal(s, h)
    return code


def _world_rank(target: str, rank: int, world: int, init_method: str, payload: Any,
                result_path: str, launchers: int = 1) -> None:
    """Body of a :func:`run_world` rank: ``target(rank, world,
    init_method, payload)`` (with ``launchers=`` when there are several),
    its return value (or its traceback) pickled to ``result_path``."""
    _die_with_parent()
    torch.set_num_threads(1)
    try:
        extra = {"launchers": launchers} if launchers > 1 else {}
        result = {"ok": True,
                  "value": _import(target)(rank, world, init_method, payload, **extra)}
    except BaseException as exc:  # noqa: BLE001 - reported to the parent, then exit non-zero
        result = {"ok": False, "error": f"{type(exc).__name__}: {exc}",
                  "traceback": traceback.format_exc()}
    with open(result_path, "wb") as fh:
        pickle.dump(result, fh)
    if not result["ok"]:
        os._exit(1)


def _world_launcher(target: str, world: int, launchers: int, index: int, init_method: str,
                    payload: Any, paths: List[str]) -> None:
    """Body of one of :func:`run_world`'s launcher processes."""
    _die_with_parent()
    sys.exit(run_launcher(_world_rank, lambda r: (target, r, world, init_method, payload,
                                                  paths[r], launchers),
                          world, launchers, index))


def run_world(target: str, world: int, payload: Any = None, timeout_s: float = 300.0,
              workdir: Optional[str] = None, launchers: int = 1) -> List[Any]:
    """Run ``target`` (``"module:function"``) on every rank of a new world
    of ``world`` processes, spawned by ``launchers`` launcher processes
    (:func:`run_launcher`, the server CLI's) of ``world / launchers`` ranks
    each, all joined through a ``file://`` store in ``workdir`` (a
    temporary directory by default); ``target`` gets ``launchers=`` when
    there are several. Returns each rank's return value, in rank order;
    raises with the first failing rank's traceback, or when the world
    outlives ``timeout_s`` (every process is stopped first)."""
    from .mesh import local_size

    local_size(world, launchers)
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="world-")
    os.makedirs(workdir, exist_ok=True)
    paths = [os.path.join(workdir, f"rank{r}.pkl") for r in range(world)]
    store = os.path.join(workdir, "store")
    for path in paths + [store]:  # an earlier world's
        if os.path.exists(path):
            os.remove(path)
    init = f"file://{store}"
    try:  # the launchers are this process's ranks, as a launcher's ranks are its own
        code = run_launcher(_world_launcher, lambda i: (target, world, launchers, i, init,
                                                        payload, paths),
                            launchers, signals=False, deadline=time.monotonic() + timeout_s,
                            grace_s=timeout_s)
    except TimeoutError:
        raise TimeoutError(f"world {target} did not finish in {timeout_s:g} s") from None
    loaded = {}
    for r, path in enumerate(paths):
        if os.path.exists(path):
            with open(path, "rb") as fh:
                loaded[r] = pickle.load(fh)
    for r, res in sorted(loaded.items()):  # the failure itself before its casualties
        if not res["ok"]:
            raise RuntimeError(f"rank {r} of {target} failed: {res['error']}\n{res['traceback']}")
    missing = [r for r in range(world) if r not in loaded]
    if missing:
        raise RuntimeError(f"rank {missing[0]} of {target} exited with no result (launchers' "
                           f"exit code {code})")
    results = [loaded[r]["value"] for r in range(world)]
    if own:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return results


def _stop_all(procs, grace_s: float = 10.0) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + grace_s
    for p in procs:
        p.join(timeout=max(0.1, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join(timeout=5.0)


# -- the server CLI ------------------------------------------------------------

def follower_engine(cfg, mesh: RankMesh):
    """A follower rank's engine for ``cfg``: the generation engine of a
    decoder, else the batch engine of a shell model whose shard comes
    from rank 0. Rank 0 builds its own through ``InferenceServer``."""
    from ..models.registry import get_family
    from ..serving.generation import build_generation_engine

    definition = get_family(cfg.model.family, cfg.model.options)
    if definition.supports_generation and not cfg.model.options.get("serve_logits", False):
        return build_generation_engine(cfg, device=str(mesh.device), mesh=mesh)
    from ..core.engine import ModelEngine
    from ..models.registry import BuiltModel
    from ..utils.dtypes import torch_dtype

    shell = BuiltModel(definition=definition, params=None,
                       compute_dtype=torch_dtype(cfg.model.compute_dtype),
                       quant=cfg.model.quantization, device=mesh.device)
    return ModelEngine(cfg, shell, mesh=mesh)


def rank_main(rank: int, world: int, init_method: str, config_path: str, device: str,
              timeout_s: float, launchers: int = 1) -> None:
    """One rank of a mesh server (a :func:`serve_mesh` launcher's process):
    join the mesh, build this rank's engine (rank 0 builds the seeded
    weights once and sends each rank its shard), then serve (rank 0, which
    keeps the idle mesh alive) or follow. Dies with its launcher."""
    import asyncio

    import torch.distributed as dist

    from ..utils.config import load_config
    from ..utils.logger import get_logger

    log = get_logger()
    _die_with_parent()
    if rank != 0:
        signal.signal(signal.SIGINT, signal.SIG_IGN)  # rank 0 decides when to stop
    cfg = load_config(config_path)
    m = cfg.devices.mesh
    axes = MeshAxes(data=m.data, model=m.model, expert=m.expert, pipe=m.pipe)
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    t0 = time.perf_counter()
    mesh = join_mesh(axes, rank, world, init_method, torch.device(device).type,
                     cfg.devices.device_ids, timeout_s, launchers)
    log.info("%s (joined in %.1f s)", mesh.describe(), time.perf_counter() - t0)
    if rank == 0:
        print(f"mesh backend: {mesh.backend}", flush=True)
        print(f"mesh launchers: {mesh.launchers} of {mesh.local} ranks; axes crossing them: "
              f"{json.dumps(mesh.crossing)}", flush=True)
        from ..grpc.server import InferenceServer

        server = InferenceServer(cfg, device=str(mesh.device), mesh=mesh)
        worker = mesh_worker(server)

        def fatal(exc: BaseException) -> None:
            log.error("the mesh failed (%s: %s); exiting", type(exc).__name__, exc)
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(3)

        worker.on_fatal = fatal
        worker.keep_alive()
        log.info("rank 0 ready in %.1f s", time.perf_counter() - t0)
        asyncio.run(server.serve())
        worker.stop_followers()
    else:
        engine = follower_engine(cfg, mesh)
        log.info("rank %d ready in %.1f s", rank, time.perf_counter() - t0)
        follow(mesh_worker(engine))
    dist.destroy_process_group()


def serve_mesh(config_path: str, cfg, device: str, timeout_s: float = 300.0) -> int:
    """The server CLI for a mesh config: one launcher (:func:`run_launcher`)
    of every mesh position, or with ``distributed.coordinator_address``
    launcher ``process_id`` of ``num_processes`` (each a host's process,
    as the JAX server's ``jax.distributed.initialize``; unset values come
    from the SLURM or Open MPI environment, ``utils.config.resolve_distributed``),
    its ranks joining that address. Returns the exit code: 0 when its
    ranks ended after rank 0's clean shutdown, else 1."""
    import shutil

    from ..utils.config import resolve_distributed
    from ..utils.logger import get_logger
    from .mesh import local_size

    world = cfg.devices.mesh.size
    dcfg = resolve_distributed(cfg.distributed)
    workdir = None
    if dcfg.coordinator_address:
        launchers, index = dcfg.num_processes, dcfg.process_id
        init = f"tcp://{dcfg.coordinator_address}"
    else:
        launchers, index = 1, 0
        workdir = tempfile.mkdtemp(prefix="mesh-")
        init = f"file://{os.path.join(workdir, 'store')}"
    local = local_size(world, launchers)
    get_logger().info("launcher %d of %d: ranks %d-%d of %d, joining at %s", index, launchers,
                      index * local, index * local + local - 1, world, init)
    if torch.device(device).type == "cuda":
        from ..ops import _build

        _build.build_all()  # once, before the ranks load the libraries
    try:
        return run_launcher(rank_main, lambda r: (r, world, init, config_path, device, timeout_s,
                                                  launchers), world, launchers, index)
    finally:
        if workdir is not None:
            shutil.rmtree(workdir, ignore_errors=True)


__all__ = ["BatchWorker", "GspmdWorker", "MeshWorker", "PipeWorker", "follow",
           "follower_engine", "join_mesh", "mesh_worker", "rank_main",
           "run_launcher", "run_world", "serve_mesh"]
