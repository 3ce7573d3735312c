"""Continuous-batching generation engine for decoder models.

Counterpart of ``starpu_inference_server_tpu/serving/generation.py``:
the same request object, slot pool, admission with same-bucket batched
prefill, chunked prefill interleaved with decode blocks, decode blocks of
``steps_per_sync`` steps with DEVICE-SIDE completion (a slot that hits
its EOS or budget freezes inside the block), cancellation and release,
and the same serving options:

- speculative decoding with a draft model (``draft_spec``) or with
  prompt lookup (``prompt_lookup_ngram``): drafts of ``speculate_k``
  tokens per block, one verify forward of the target over the window,
  the accepted prefix plus the target's own token committed, clamped on
  the device to the slot's budget and first EOS. Greedy output is the
  target's own greedy sequence;
- the paged KV cache (``kv_page_size``): a page pool with a host-side
  allocator; with ``prefix_cache`` the pages of a shared prefix are
  refcounted and shared, and released slots retain their grant until
  the pool needs the pages;
- the dense prefix cache (``prefix_cache`` without paging): a hit copies
  the source slot's rows and prefills only the tail;
- the FLAT cache layout (``kv_cache_layout: flat``, models/decoder.py),
  for the target cache, its pages and the draft's cache;
- overlapped dispatch (``decode_overlap``, ``pipeline_depth``): up to
  ``pipeline_depth`` blocks in flight, each chained off the previous
  block's device-resident carry (next ids, progress, the alive mask)
  while the host commits the oldest; the pump stops when membership
  changes (an admission lands, a request is cancelled, nothing is left
  alive). Each block's tokens and each prefill's logits are copied to
  pinned host memory as soon as they are dispatched, and a prefill lands
  (its first token sampled, its slot activated) only once a decode block
  dispatched after it has been consumed, or when the engine is idle.
  Every fetch is bounded by ``fetch_timeout_s``: past it the engine
  fails the open requests with ``RuntimeError`` and goes on serving.
  Greedy and seeded-sampling streams are the same at any depth.

Sampled tokens are the JAX engine's: ``serving/sampling.py`` draws them
on the device with the port's copy of ``jax.random`` under the key
``fold_in(PRNGKey(seed), progress)``, so a request samples the same
tokens as there, however it is interleaved, with or without speculation.
Greedy decoding takes the first maximum, as ``jnp.argmax`` does.

Differences from the JAX engine:

- PyTorch runs eagerly; there is no jit, no donation (the caches are
  updated in place, see models/decoder.py) and no executable per bucket.
  The one compiled program is the greedy decode block: on the card it is
  a CUDA graph of ``_decode_and_sample``, captured once per engine and
  replayed for every block of a snapshot with no sampled slot
  (``_GreedyBlock``). Sampled blocks, verify windows and prefills run
  eagerly. Work is ordered by the CUDA stream: a block chained off the
  carry, a prefill, a release's length reset run in the order they were
  dispatched, as the JAX programs did.
- After a failure (a fetch past its deadline, an error in a step) the
  loop fails every open request and keeps running, where the JAX
  engine's loop thread ends.
- A mesh is a world of rank processes (``parallel/``). With a ``pipe``
  axis the engine runs PIPELINED (``parallel/pipeline_decode.py``): each
  rank holds its stage's layers and cache shard (``mesh`` is its
  ``RankMesh``, ``params`` its shard or the whole tree), rank 0 runs
  this engine's loop and drives every prefill, decode step and verify
  window through ``parallel/launch.py:PipeWorker``, and the other ranks
  follow. Its blocks run eagerly (no CUDA graph: the collectives run on
  the host). The JAX engine's guards hold (no ``data`` axis, no
  ``prefill_chunk``, buckets and slots divisible by the stages and
  microgroups, no flat or paged cache); prompt lookup, which the JAX
  engine refuses on any mesh, runs here, its history on rank 0.
- A mesh without a pipe axis runs in GSPMD mode
  (``parallel/launch.py:GspmdWorker``): the KV slots are sharded over
  ``data`` (each data group holds ``num_slots / data`` of them) and, in
  the cache, the kv heads over ``model``, where the JAX engine shards the
  slots only (the same values in another memory layout); the weights are
  tensor- and expert-parallel by the family's rules with the fused
  projections block-aligned. A prefill or prefill chunk runs on the data
  group that owns the slot; every decode step and verify window runs on
  every group's slots, and the whole logits reach rank 0, which runs
  this engine's loop and samples. Its blocks run eagerly. The JAX
  engine's guards hold: ``num_slots`` divisible by ``data``, no flat or
  paged cache, no prompt lookup; a draft model lives on rank 0, its
  verify windows on the mesh. A new request takes the lowest free slot
  of the data group with the fewest slots taken (the JAX engine takes
  the lowest free slot: there every group computes every prefill), so
  prefills spread over the groups. A dense prefix-cache hit copies the
  source slot's rows on the mesh, across data groups where it must
  (``GspmdWorker.copy_rows``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models.decoder import DecoderSpec, decode_step, init_cache, prefill, verify_step
from ..models.decoder import prefill_chunk as prefill_chunk_step
from ..models.paged_decoder import (
    init_paged_cache,
    paged_decode_step,
    paged_prefill,
    paged_prefill_chunk,
    paged_verify_step,
    set_table_row,
)
from ..models.registry import resolve_device
from ..monitoring.trace import SpanTotals
from ..ops import _build, nn
from ..ops.quant import pack_int4_tree
from ..utils.clock import now_s
from ..utils.logger import get_logger
from . import sampling

# the engine loop's phases, host seconds in ``loop_timers`` (and the
# Prometheus gauge): "step" splits into "dispatch" and "consume", the
# "admit.*" spans are parts of "admit", "wait" is a fetch that blocked
LOOP_PHASES = ("admit", "step", "land", "dispatch", "consume",
               "admit.lookup", "admit.grant", "admit.chunk", "admit.prefill", "wait")
# each request's time to its first token, in three parts: submit to
# admission, admission to first token, first token to its stream response
REQUEST_SPANS = ("request.queue", "request.prefill", "request.send")
# the spans that also count, under "<name>.n", how many ended: per-request
# means, the chunks dispatched, the fetches that blocked
COUNTED_SPANS = ("admit.chunk", "wait") + REQUEST_SPANS


@dataclasses.dataclass
class GenerationRequest:
    prompt_ids: np.ndarray            # int32 [P]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    temperature: float = 0.0          # 0 = greedy argmax
    top_k: int = 0                    # 0 = no top-k restriction
    seed: int = 0
    request_id: str = ""
    # filled by the engine
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    error: Optional[BaseException] = None
    on_token: Optional[Callable[[int], None]] = None  # streaming hook
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0
    cancel_flag: threading.Event = dataclasses.field(default_factory=threading.Event)

    def cancel(self) -> None:
        """Drop a pending request at admission, abort an in-flight chunked
        prefill, or release an active slot at the next block; ``done`` is
        set in every case. Safe after completion (no-op)."""
        self.cancel_flag.set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self.done.wait(timeout=timeout):
            raise TimeoutError("generation did not finish in time")
        if self.error is not None:
            raise self.error
        return self.tokens


@dataclasses.dataclass
class _SlotState:
    request: GenerationRequest
    last_token: int
    emitted: int


@dataclasses.dataclass
class _PrefillProgress:
    """A chunked prefill in flight: the slot is reserved but not decoded
    until the last chunk lands."""

    request: GenerationRequest
    slot: int
    prompt: np.ndarray
    offset: int = 0


@dataclasses.dataclass
class _PrefillLanding:
    """A dispatched prefill whose logits are not fetched yet. They are
    copied to pinned host memory at dispatch; the landing completes once
    a decode block dispatched after it has been consumed (the stream runs
    work in dispatch order, so its copy is done by then) or when forced
    because the engine is idle."""

    request: GenerationRequest
    slot: int
    logits: torch.Tensor       # host [N, V]: a batched prefill's logits
    event: object              # the copy's torch.cuda.Event, None on the CPU
    seq: int                   # dispatch sequence number of the prefill
    row: int = 0               # this landing's row of ``logits``


def _ngram_drafts(history: torch.Tensor, len_h: torch.Tensor, k: int, n: int):
    """Prompt-lookup draft proposal on the device (the JAX package's
    ``_ngram_drafts``). ``history`` int32 [S, T] holds each slot's prompt
    and emitted tokens, ``len_h`` int32 [S] the valid count (the last one
    is the current input token). The trailing ``n``-gram is matched
    against every earlier window and the MOST RECENT match wins; the
    ``k`` tokens after it are the drafts, with positions at or past
    ``len_h`` masked to 0 so a reused slot never drafts a previous
    request's tokens. Every gather index is clipped into [0, T), as the
    JAX package's ``take_along_axis`` calls are. Returns (drafts int32
    [S, k], found bool [S])."""
    s, t = history.shape
    dev = history.device
    len_h = len_h.to(torch.int64)
    qidx = (len_h[:, None] - n + torch.arange(n, device=dev)[None, :]).clamp(0, t - 1)
    q = history.gather(1, qidx)
    windows = history.unfold(1, n, 1)                      # [S, T-n+1, n]
    p_idx = torch.arange(t - n + 1, device=dev)[None, :]
    valid = p_idx < (len_h - n)[:, None]                   # strictly before the query
    eq = (windows == q[:, None, :]).all(dim=-1) & valid
    found = eq.any(dim=1)
    # the most recent match: the first maximum of the reversed mask
    p_star = (t - n) - torch.argmax(eq.flip(1).to(torch.int32), dim=1)
    didx = (p_star + n)[:, None] + torch.arange(k, device=dev)[None, :]
    drafts = history.gather(1, didx.clamp(0, t - 1))
    drafts = torch.where(didx < len_h[:, None], drafts, torch.zeros_like(drafts))
    return drafts, found


def _copy_slot_rows(cache, src: int, dst: int) -> None:
    """Copy slot ``src``'s whole KV rows (every layer, full context) over
    slot ``dst``, in place: the device side of a dense prefix-cache hit.
    Rows past the shared prefix are stale and never attended before the
    tail prefill overwrites them; ``lengths`` is set by that prefill."""
    for leaves in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        for a in leaves:
            a[dst] = a[src]


class _GreedyBlock:
    """The greedy decode block, ``_decode_and_sample`` of a snapshot with
    no sampled slot, on static buffers the engine owns: each block's
    inputs (ids, alive, progress, eos, limit) are copied into them on the
    stream, and the block leaves its carry (next ids, progress, alive) in
    the same buffers, so a chained block reads the previous one's carry
    where it lies. The records of the blocks in flight alias these
    buffers; only the newest record's carry is ever read (to chain), and
    each block's tokens are copied to the host on the stream before the
    next block runs.

    On the card the body is captured once as a CUDA graph and every block
    is one replay of it: the counterpart of the JAX engine's jitted
    ``fori_loop``, one launch where the eager body enqueues ~1,600 a step.
    The capture is preceded by one eager run of the body with no slot
    alive (it builds and loads the kernel libraries and the plans, and
    changes no cache row a live slot reads: dead slots park their writes)
    on a side stream, and uses one private memory pool. A kernel wrapper
    counts its launches in Python, which a replay does not run: the counts
    made while capturing are moved to each replay. The graph is captured
    again if the kernel routes or the W8A8 mode change. A failed capture
    or replay raises; the engine then fails its open requests. On the CPU
    the body runs eagerly on the same buffers."""

    def __init__(self, device: torch.device, num_slots: int):
        self.device = dev = device
        s = num_slots
        self.ids = torch.zeros((s,), dtype=torch.int32, device=dev)
        self.alive = torch.zeros((s,), dtype=torch.bool, device=dev)
        self.prog = torch.zeros((s,), dtype=torch.int32, device=dev)
        self.eos = torch.full((s,), -1, dtype=torch.int32, device=dev)
        self.limit = torch.zeros((s,), dtype=torch.int32, device=dev)
        self.graph = None
        self.key = None
        self.tokens = None       # the graph's static output
        self.deltas = ()         # launches per replay, by counter table
        self.pool = None
        self.pool_bytes = 0      # device memory the capture reserved
        self.warmups = 0         # eager blocks with no slot alive, one before each capture
        self.capture_s = 0.0     # host seconds spent warming up and capturing
        self.replays = 0

    def _body(self, body) -> torch.Tensor:
        snap = {"eos_dev": self.eos, "limit_dev": self.limit, "sample": None}
        tokens, ids, prog, alive = body(self.ids, self.alive, self.prog, snap)
        self.ids.copy_(ids)
        self.prog.copy_(prog)
        self.alive.copy_(alive)
        return tokens

    def run(self, body, ids, alive, prog, eos, limit):
        """One block of ``body`` (the engine's ``_decode_and_sample``) from
        these inputs; returns (tokens, next ids, progress, alive), the last
        three being the static buffers."""
        cuda = self.device.type == "cuda"
        if cuda:
            key = (nn.use_kernels(self.device), nn.w8a8_enabled())
            if self.graph is None or self.key != key:
                self._capture(body, key)
        for dst, src in ((self.ids, ids), (self.alive, alive), (self.prog, prog),
                         (self.eos, eos), (self.limit, limit)):
            if src is not dst:
                dst.copy_(src)
        if not cuda:
            return self._body(body), self.ids, self.prog, self.alive
        self.graph.replay()
        self.replays += 1
        for table, delta in zip(_build.launch_counters(), self.deltas):
            for name, n in delta.items():
                table[name] += n
        return self.tokens, self.ids, self.prog, self.alive

    def _capture(self, body, key) -> None:
        t0 = time.perf_counter()
        dev = self.device
        self.graph = None
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        bufs = (self.ids, self.alive, self.prog, self.eos, self.limit)
        saved = [b.clone() for b in bufs]  # a chained block's carry, if one is there
        counters = _build.launch_counters()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.alive.zero_()
            self._body(body)  # the warm-up: its launches are real and stay counted
            self.warmups += 1
            before = [dict(t) for t in counters]
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                tokens = self._body(body)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is invalid already; the body's error is the one to raise
                raise
            graph.capture_end()
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        torch.cuda.current_stream(dev).wait_stream(side)
        self.deltas = tuple({name: t[name] - b[name] for name in t if t[name] != b[name]}
                            for t, b in zip(counters, before))
        for table, delta in zip(counters, self.deltas):
            for name, n in delta.items():
                table[name] -= n  # recorded, not launched
        for b, v in zip(bufs, saved):
            b.copy_(v)
        self.graph, self.key, self.tokens = graph, key, tokens
        self.capture_s += time.perf_counter() - t0


class GenerationEngine:
    def __init__(
        self,
        spec: DecoderSpec,
        params,
        dtype=torch.bfloat16,
        num_slots: int = 8,
        max_len: int = 512,
        prefill_buckets: Optional[List[int]] = None,
        steps_per_sync: int = 1,
        prefill_chunk: int = 0,
        draft_spec: Optional[DecoderSpec] = None,
        draft_params=None,
        speculate_k: int = 4,
        prompt_lookup_ngram: int = 0,
        prefix_cache: bool = False,
        prefix_cache_min: int = 16,
        decode_overlap: bool = False,
        pipeline_depth: int = 2,
        kv_page_size: int = 0,
        kv_pool_pages: int = 0,
        kv_cache_layout: str = "standard",
        pin_cache_layouts: bool = False,
        fetch_timeout_s: float = 120.0,
        device=None,
        metrics=None,
        mesh=None,
        family: str = "llama",
        pipe_microgroups: int = 0,
    ):
        """``params`` / ``draft_params``: the port's parameter trees (torch
        tensors; see ``weights.params_from_numpy``). ``device`` defaults
        to ``cuda`` and raises when CUDA is missing unless
        ``device='cpu'``. ``pin_cache_layouts`` (a TPU layout workaround)
        has no effect here but is refused with the flat layout, as in the
        JAX engine. ``metrics``: a ``monitoring.metrics.MetricsRecorder``
        whose generation families the engine updates, at the JAX engine's
        points and only where the values are already on the host
        (admission, landing, consume, release): nothing inside a decode
        block reads the device for them.

        ``mesh``: this rank's ``parallel.mesh.RankMesh``. A ``pipe`` axis
        selects pipelined decoding (the module docstring); ``family``
        picks the partition rules and ``pipe_microgroups`` the decode
        microgroups (0 = min(stages, num_slots)). ``device`` is then the
        mesh's."""
        if kv_cache_layout not in ("standard", "flat"):
            raise ValueError(
                f"kv_cache_layout must be 'standard' or 'flat', got {kv_cache_layout!r}"
            )
        self.flat_cache = kv_cache_layout == "flat"
        if self.flat_cache and pin_cache_layouts:
            raise ValueError(
                "pin_cache_layouts is redundant with kv_cache_layout="
                "'flat' (the flat layout's standard layout already is "
                "the compact layout) — enable one or the other"
            )
        self.mesh = mesh
        self._family = family
        self.pipe = None  # the rank's PipeWorker in pipe mode
        self.worker = None  # the rank's mesh worker (pipe or GSPMD mode)
        self._pipe_stages = 0
        if mesh is not None:
            self._pipe_stages, self._microgroups = check_mesh(
                spec, mesh, flat=self.flat_cache, prefill_chunk=prefill_chunk,
                prefill_buckets=prefill_buckets, num_slots=num_slots,
                pipe_microgroups=pipe_microgroups, kv_page_size=kv_page_size,
                prompt_lookup_ngram=prompt_lookup_ngram)
            device = mesh.device
        self.device = resolve_device(device)
        self.spec = spec
        self.dtype = dtype
        self.num_slots = num_slots
        self.max_len = max_len
        self.params = self._place_params(params)
        # tokens decoded per host sync: a block of ``steps_per_sync``
        # decode steps (or verify windows) runs before its tokens are
        # fetched; tokens past a request's EOS / limit are discarded
        self.steps_per_sync = max(1, int(steps_per_sync))
        # overlapped dispatch: up to ``pipeline_depth`` blocks in flight,
        # each chained off the previous block's device carry, while
        # membership is unchanged (``_membership_dirty`` stops the pump)
        self.decode_overlap = bool(decode_overlap)
        self.pipeline_depth = max(2, int(pipeline_depth)) if self.decode_overlap else 1
        self._inflight: deque = deque()  # dispatched, not yet consumed
        self._membership_dirty = False
        self.prefill_buckets = sorted(prefill_buckets or [32, 64, 128, 256])
        self.prefill_chunk = max(0, int(prefill_chunk))
        if self.prefill_chunk and max_len % self.prefill_chunk != 0:
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) must divide "
                f"max_len ({max_len}) so every chunk fits the cache row"
            )
        # paged KV cache: a page pool + per-slot table; requests reserve
        # ceil((prompt + max_new + headroom) / page) pages
        self.kv_page_size = max(0, int(kv_page_size))
        if self.kv_page_size:
            page = self.kv_page_size
            if max_len % page:
                raise ValueError(f"kv_page_size ({page}) must divide max_len ({max_len})")
            if self.prefill_chunk and self.prefill_chunk % page:
                raise ValueError(
                    f"prefill_chunk ({self.prefill_chunk}) must be a multiple of "
                    f"kv_page_size ({page}) so chunks cover whole pages"
                )
            # default pool: half the dense footprint, plus the garbage page
            self.kv_pool_pages = int(kv_pool_pages) or (1 + num_slots * (max_len // page) // 2)
            self.cache = init_paged_cache(spec, num_slots, max_len, self.kv_pool_pages, page,
                                          device=self.device, flat=self.flat_cache)
            # host-side allocator: free pool page ids (page 0 is the
            # garbage page), each slot's grant, and refcounts so a prefix
            # hit shares whole pages; released slots RETAIN their grant
            # under prefix_cache until the pool needs it
            self._free_pages: List[int] = list(range(1, self.kv_pool_pages))
            self._slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
            self._page_refs = np.zeros((self.kv_pool_pages,), np.int32)
            self._retained: set = set()
            self._prefill_fn, self._chunk_fn = paged_prefill, paged_prefill_chunk
            self._step_fn, self._verify_fn = paged_decode_step, paged_verify_step
        elif self._pipe_stages:
            from ..parallel.launch import PipeWorker

            self.kv_pool_pages = 0
            self.pipe = self.worker = PipeWorker(mesh, spec, self.params, num_slots, max_len,
                                                 dtype, self._microgroups, self._pipe_stages)
            # rank 0's shard of the stacked cache; its lengths drive every rank
            self.cache = self.pipe.cache
            pipe = self.pipe
            self._prefill_fn = lambda sp, pr, c, ids, length, slot, dt: (
                c, pipe.prefill(ids, length, slot))
            self._step_fn = lambda sp, pr, c, ids, alive, dt: (c, pipe.decode(ids, alive))
            self._verify_fn = lambda sp, pr, c, ids, alive, dt: (c, pipe.verify(ids, alive))
            self._chunk_fn = None  # prefill_chunk is refused with a pipe
        elif mesh is not None:
            from ..parallel.launch import GspmdWorker

            self.kv_pool_pages = 0
            self.worker = GspmdWorker(mesh, spec, self.params, num_slots, max_len, dtype)
            # rank 0's cache rows, every slot's length: the lengths drive every rank
            self.cache = self.worker.cache
            w = self.worker
            self._prefill_fn = lambda sp, pr, c, ids, length, slot, dt: (
                c, w.prefill(ids, length, slot))
            self._chunk_fn = lambda sp, pr, c, ids, start, valid, slot, dt: (
                c, w.prefill_chunk(ids, start, valid, slot))
            self._step_fn = lambda sp, pr, c, ids, alive, dt: (c, w.decode(ids, alive))
            self._verify_fn = lambda sp, pr, c, ids, alive, dt: (c, w.verify(ids, alive))
        else:
            self.kv_pool_pages = 0
            self.cache = init_cache(spec, num_slots, max_len, device=self.device,
                                    flat=self.flat_cache)
            self._prefill_fn, self._chunk_fn = prefill, prefill_chunk_step
            self._step_fn, self._verify_fn = decode_step, verify_step
        # prefix caching: a slot's prompt stays indexed after release, so
        # a new prompt sharing a prefix reuses its rows (dense: a device
        # row copy; paged: the shared whole pages) and prefills the tail
        self.prefix_cache = bool(prefix_cache)
        self.prefix_cache_min = max(1, int(prefix_cache_min))
        if self.prefix_cache and not self.prefill_chunk:
            raise ValueError("prefix_cache requires chunked prefill (set prefill_chunk)")
        self._slot_prompts: List[Optional[np.ndarray]] = [None] * num_slots
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        # speculative decoding with a draft model: its own dense cache,
        # prefilled with every prompt, drafts K greedy tokens per block
        self.draft_spec = draft_spec
        self.speculate_k = max(1, int(speculate_k))
        self._draft_params = None
        self.drafted_tokens = 0
        self.accepted_drafts = 0
        if draft_spec is not None:
            if draft_params is None:
                raise ValueError("draft_spec requires draft_params")
            if draft_spec.vocab != spec.vocab:
                raise ValueError(
                    f"draft vocab ({draft_spec.vocab}) must match target vocab ({spec.vocab})"
                )
            self._draft_params = self._place_local(draft_params)
            self._draft_cache = init_cache(draft_spec, num_slots, max_len, device=self.device,
                                           flat=self.flat_cache)
        # prompt-lookup speculation: drafts from each slot's own token
        # history, kept on the device
        self._lookup_ngram = max(0, int(prompt_lookup_ngram))
        if self._lookup_ngram:
            if draft_spec is not None:
                raise ValueError(
                    "prompt_lookup_ngram and draft_variant are mutually exclusive draft sources"
                )
            self._history = torch.zeros((num_slots, max_len), dtype=torch.int32,
                                        device=self.device)
        self._prefilling: Optional[_PrefillProgress] = None
        # slots whose prefill is dispatched but not landed, the landings
        # in dispatch order, and the sequence numbers that prove a
        # landing's logits are on the host
        self._reserved: set = set()
        self._landings: deque = deque()
        self._dispatch_seq = 0
        self._consumed_seq = 0
        self.fetch_timeout_s = float(fetch_timeout_s)
        self._slots: List[Optional[_SlotState]] = [None] * num_slots
        self._greedy: Optional[_GreedyBlock] = None  # made at the first greedy block
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.steps = 0
        self.generated_tokens = 0
        # cumulative spans: seconds (host clock) of the loop's phases and
        # the requests' parts and, under "<name>.n", the COUNTED_SPANS' counts
        self.spans = SpanTotals(LOOP_PHASES + REQUEST_SPANS, COUNTED_SPANS)
        self.loop_timers = self.spans.totals
        self._metrics = metrics

    # -- placement ---------------------------------------------------------

    def _place_params(self, params):
        """Params on the engine's device; int4 leaves are packed pairwise
        where the int4 kernel route applies (on CUDA, or when kernels are
        forced), as the JAX engine packs them on the TPU. In pipe mode a
        whole tree is cut to this rank's shard first (a shard, whose
        ``layers`` are stacked already, is taken as it is), and the stacked
        layers become a list of per-layer views. In GSPMD mode ``params``
        is this rank's shard (``weights.rank_shard``)."""
        from ..weights import rank_shard

        if self.mesh is None:
            return self._place_local(params)
        if not self._pipe_stages:
            return self._place_local(params)
        from ..parallel.pipeline import unstack_layers

        if not isinstance(params["layers"], dict):
            params = rank_shard(params, self.spec, self._family, self.mesh.coords,
                                self.mesh.shape)
        params = dict(params, layers=unstack_layers(params["layers"]))
        return self._place_local(params)

    def _place_local(self, params):
        """A tree on the engine's device, int4 leaves packed where the int4
        kernel route applies (the draft model's placement in every mode)."""
        from ..weights import params_from_numpy

        params = params_from_numpy(params, self.device)
        if nn.use_kernels(self.device):
            params = pack_int4_tree(params)
        return params

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; on the card through pinned
        memory, so the copy does not sync the host. The array must not
        change afterwards (on the CPU the tensor shares its memory)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    @staticmethod
    def _start_fetch(t: torch.Tensor):
        """Start copying a device result to the host, behind the work that
        produces it. Returns (host tensor, event that marks the copy done;
        None on the CPU, where it is a plain copy)."""
        if not t.is_cuda:
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    @staticmethod
    def _fetch_ready(event) -> bool:
        return event is None or event.query()

    def _fetch(self, host: torch.Tensor, event) -> np.ndarray:
        """Wait for a fetch started by :meth:`_start_fetch`, polling its
        event, for at most ``fetch_timeout_s``: past that the engine
        raises, and the loop fails the open requests instead of hanging
        on a card that stopped answering."""
        if not self._fetch_ready(event):
            with self.spans("wait"):
                deadline = time.monotonic() + self.fetch_timeout_s
                pause = 2e-5
                while not self._fetch_ready(event):
                    if time.monotonic() >= deadline:
                        if self._metrics is not None:
                            self._metrics.fetch_timeouts_total.inc()
                        raise RuntimeError(
                            f"device fetch did not complete within {self.fetch_timeout_s:g} s; "
                            "failing open requests"
                        )
                    time.sleep(pause)
                    pause = min(2 * pause, 1e-3)
        return host.numpy()

    @property
    def _speculating(self) -> bool:
        return self._draft_params is not None or bool(self._lookup_ngram)

    # -- device fns --------------------------------------------------------

    def _sample(self, logits, snap, prog):
        """The JAX engine's ``_sample_tokens``, on the device and without a
        host sync: greedy argmax (first maximum) for every slot, then, for
        the snapshot's sampled slots only, temperature / top-k sampling
        under ``fold_in(PRNGKey(seed), prog)`` (``serving/sampling.py``).
        ``prog`` is the device carry's progress: a live slot's progress is
        the snapshot's plus the steps (verify windows) since it, so a
        request samples the same tokens at any depth. A snapshot with no
        sampled slot draws no noise at all."""
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        smp = snap["sample"]
        if smp is None:
            return nxt
        idx = smp["idx"]
        keys = sampling.fold_in(sampling.prng_key(smp["seeds"]), prog.index_select(0, idx))
        drawn = sampling.sample_rows(logits.index_select(0, idx), smp["temps"], smp["top_k"],
                                     keys, smp["k_max"])
        return nxt.index_copy(0, idx, drawn.to(torch.int32))

    def _decode_and_sample(self, ids, alive, prog, snap):
        """One block of ``steps_per_sync`` decode steps. DEVICE-SIDE
        COMPLETION: a slot whose token hits its eos or exhausts its budget
        drops out of ``alive`` on the device, so later steps (and later
        blocks chained off this carry) stop advancing its cache; frozen
        slots repeat their last id in the token block. Returns (tokens int32 [steps, S, 1], next ids,
        progress, alive): the block and its device carry."""
        steps = self.steps_per_sync
        eos, limit = snap["eos_dev"], snap["limit_dev"]
        tokens = torch.empty((steps, self.num_slots, 1), dtype=torch.int32, device=self.device)
        for i in range(steps):
            _, logits = self._step_fn(self.spec, self.params, self.cache, ids, alive, self.dtype)
            nxt = self._sample(logits, snap, prog)
            nxt = torch.where(alive, nxt, ids)
            prog = prog + alive.to(torch.int32)
            done = alive & ((nxt == eos) | (prog >= limit))
            alive = alive & ~done
            tokens[i, :, 0] = nxt
            ids = nxt
        return tokens, ids, prog, alive

    def _greedy_block(self, ids, alive, prog, snap):
        """``_decode_and_sample`` of a greedy snapshot through the engine's
        static buffers: one CUDA graph replay on the card (``_GreedyBlock``).
        Returns what the body returns."""
        if self._greedy is None:
            self._greedy = _GreedyBlock(self.device, self.num_slots)
        return self._greedy.run(self._decode_and_sample, ids, alive, prog, snap["eos_dev"],
                                snap["limit_dev"])

    def _verify_accept(self, cur, drafts, alive, prog, snap):
        """Shared verify-and-commit of both draft sources: score the
        [cur, drafts] window with ONE target forward, accept the longest
        draft prefix equal to the target's greedy tokens plus the target's
        own next token, then clamp the commit count ON THE DEVICE to the
        slot's remaining budget and to the first EOS inside the window.
        Sampled slots accept no drafts: they commit one token per window,
        sampled under the key of its progress as in the plain engine, so
        a sampled request gets the plain engine's tokens.

        Returns (out [S, K+1], counts [S], accepted [S], nxt [S],
        alive_next [S], progress [S])."""
        k = self.speculate_k
        dev = self.device
        start = self.cache.lengths.clone()
        window = torch.cat([cur[:, None], drafts], dim=1)          # [S, K+1]
        _, logits = self._verify_fn(self.spec, self.params, self.cache, window, alive,
                                    self.dtype)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)      # [S, K+1]
        matches = drafts == greedy[:, :k]
        accepted = torch.cumprod(matches.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
        first = self._sample(logits[:, 0], snap, prog)
        accepted = torch.where(snap["sampled_dev"], torch.zeros_like(accepted), accepted)
        out = greedy.clone()
        out[:, 0] = first
        eos, limit = snap["eos_dev"], snap["limit_dev"]
        # budget clamp first (the host emits at most ``remaining``
        # tokens), then stop at the first EOS among the survivors
        counts = torch.minimum(accepted + 1, (limit - prog).clamp(min=0))
        emit = torch.arange(k + 1, device=dev)[None, :] < counts[:, None]
        hits = emit & (out == eos[:, None]) & (eos[:, None] >= 0)
        any_eos = hits.any(dim=1)
        first_eos = torch.argmax(hits.to(torch.int32), dim=1).to(torch.int32)
        counts = torch.where(any_eos, first_eos + 1, counts)
        counts = torch.where(alive, counts, torch.zeros_like(counts))
        prog = prog + counts
        done = alive & (any_eos | (prog >= limit))
        self.cache.lengths.copy_(start + counts)
        nxt = out.gather(1, (counts - 1).clamp(min=0).to(torch.int64)[:, None])[:, 0]
        nxt = torch.where(counts > 0, nxt, cur)
        return out, counts, accepted, nxt, alive & ~done, prog

    def _speculative_block(self, cur, alive, prog, snap):
        """``steps_per_sync`` windows of draft-K-then-verify. The draft runs
        K+1 greedy steps: the extra step's output is discarded, but it
        writes d_K's KV into the draft cache, which a fully accepted
        window needs. Both caches then commit to the same length. Returns
        (int32 [blocks, S, K+3]: the window, the commit count and the
        accepted-draft count before the budget / EOS clamp; then the
        device carry: next ids, progress, alive)."""
        k = self.speculate_k
        packed = []
        for _ in range(self.steps_per_sync):
            tok = cur
            toks = []
            for _ in range(k + 1):
                _, dl = decode_step(self.draft_spec, self._draft_params, self._draft_cache, tok,
                                    alive, self.dtype)
                tok = torch.argmax(dl, dim=-1).to(torch.int32)
                toks.append(tok)
            drafts = torch.stack(toks[:k], dim=1)                  # [S, K]
            out, counts, accepted, nxt, alive_next, prog = self._verify_accept(
                cur, drafts, alive, prog, snap)
            dl = self._draft_cache.lengths
            dl.copy_(torch.where(alive, self.cache.lengths, dl))
            packed.append(torch.cat([out, counts[:, None],
                                     torch.where(alive, accepted, 0)[:, None]], dim=1))
            cur, alive = nxt, alive_next
        return torch.stack(packed), cur, prog, alive

    def _prompt_lookup_block(self, cur, alive, prog, snap):
        """``steps_per_sync`` windows of PROMPT-LOOKUP speculation: drafts
        are the K tokens after the most recent earlier occurrence of the
        trailing n-gram in (prompt + tokens so far), verified by the
        shared ``_verify_accept``. The on-device history gets the current
        token at position ``lengths`` and the committed tokens behind it.
        Returns (int32 [blocks, S, K+4]: the model-draft columns plus the
        found flag, so the host counts drafted tokens only for windows
        where a match proposed some; then the device carry)."""
        k = self.speculate_k
        n = self._lookup_ngram
        s, t = self._history.shape
        dev = self.device
        hist = self._history
        rows = torch.arange(s, device=dev)
        packed = []
        for _ in range(self.steps_per_sync):
            start = self.cache.lengths.clone().to(torch.int64)
            pos_cur = start.clamp(0, t - 1)
            hist[rows, pos_cur] = torch.where(alive, cur, hist[rows, pos_cur])
            drafts, found = _ngram_drafts(hist, start + 1, k, n)
            drafts = torch.where((found & alive)[:, None], drafts, torch.zeros_like(drafts))
            out, counts, accepted, nxt, alive_next, prog = self._verify_accept(
                cur, drafts, alive, prog, snap)
            # out[j] is the token at position start + 1 + j for j < counts
            pos = (start[:, None] + 1 + torch.arange(k + 1, device=dev)[None, :]).clamp(0, t - 1)
            emit = (torch.arange(k + 1, device=dev)[None, :] < counts[:, None]) & alive[:, None]
            hist[rows[:, None], pos] = torch.where(emit, out, hist[rows[:, None], pos])
            packed.append(torch.cat([out, counts[:, None],
                                     torch.where(alive, accepted, 0)[:, None],
                                     (found & alive).to(torch.int32)[:, None]], dim=1))
            cur, alive = nxt, alive_next
        return torch.stack(packed), cur, prog, alive

    def _bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if b >= length:
                return b
        raise ValueError(
            f"prompt length {length} exceeds largest prefill bucket "
            f"{self.prefill_buckets[-1]}"
        )

    # -- public API --------------------------------------------------------

    def headroom(self) -> int:
        """Cache rows a request needs past prompt + max_new: completion is
        enforced on the device, so only a verify window's K uncommitted
        rows can pass the final length."""
        return self.speculate_k if self._speculating else 0

    def submit(self, request: GenerationRequest) -> GenerationRequest:
        request.submitted_at = now_s()
        if len(request.prompt_ids) == 0:
            raise ValueError("prompt must hold at least one token")
        headroom = self.headroom()
        if len(request.prompt_ids) + request.max_new_tokens + headroom > self.max_len:
            raise ValueError(
                f"prompt({len(request.prompt_ids)}) + max_new_tokens"
                f"({request.max_new_tokens}) + sync headroom({headroom}) "
                f"exceeds max context {self.max_len}"
            )
        if not self.prefill_chunk and len(request.prompt_ids) > self.prefill_buckets[-1]:
            raise ValueError(
                f"prompt length {len(request.prompt_ids)} exceeds largest "
                f"prefill bucket {self.prefill_buckets[-1]} and chunked "
                f"prefill is disabled (set prefill_chunk)"
            )
        if self.kv_page_size and self._pages_needed(request) > self.kv_pool_pages - 1:
            # it could never be granted, and admission is FIFO: refuse it
            # here rather than hold every later request behind it
            raise ValueError(
                f"request needs {self._pages_needed(request)} pages of "
                f"{self.kv_page_size} rows; the pool holds {self.kv_pool_pages - 1}"
            )
        with self._work:
            self._pending.append(request)
            self._work.notify()
        return request

    def generate(self, prompt_ids, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None, timeout: float = 300.0) -> List[int]:
        req = GenerationRequest(
            prompt_ids=np.asarray(prompt_ids, np.int32),
            max_new_tokens=max_new_tokens,
            eos_id=eos_id,
        )
        self.submit(req)
        return req.result(timeout=timeout)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="generation-engine", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._work:
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    def active_count(self) -> int:
        with self._lock:
            return sum(s is not None for s in self._slots)

    def draft_acceptance_rate(self) -> float:
        """Fraction of drafted tokens the target accepted (0 when not
        speculating)."""
        return self.accepted_drafts / max(1, self.drafted_tokens)

    # -- engine loop -------------------------------------------------------

    def _loop(self) -> None:
        while True:
            try:
                self._serve()
                return
            except Exception as exc:  # noqa: BLE001 - the loop's boundary: fail all open requests
                self._fail_open(exc)
                if self._stop.is_set():
                    return

    def _serve(self) -> None:
        span = self.spans
        while not self._stop.is_set():
            with span("admit"):
                admitted = self._admit_pending()
            with span("step"):
                stepped = self._step_active()
            # land the prefills a consumed block has proven done; with no
            # block in flight there is nothing to overlap, so force them
            with span("land"):
                landed = self._land_prefills(force=not stepped)
            if not admitted and not stepped and not landed:
                with self._work:
                    if not self._pending and not self._stop.is_set():
                        self._work.wait(timeout=0.05)
        # deliver every in-flight block's tokens and every landing before
        # the loop exits, so a drain-then-stop shutdown loses nothing
        while self._inflight:
            self._consume_block(self._inflight.popleft())
        self._land_prefills(force=True)

    def _fail_open(self, exc: Exception) -> None:
        """Fail every open request (active, pending, landing, chunking)
        with ``exc`` and reset the slots, so the engine can serve the
        next ones: lengths are zeroed, pages freed, the prefix index
        emptied."""
        get_logger().error("generation engine failed: %s: %s", type(exc).__name__, exc)
        self._inflight.clear()
        self._membership_dirty = True
        with self._lock:
            failures = [s.request for s in self._slots if s is not None]
            failures.extend(self._pending)
            failures.extend(landing.request for landing in self._landings)
            if self._prefilling is not None:
                failures.append(self._prefilling.request)
                self._prefilling = None
            self._pending.clear()
            self._landings.clear()
            self._reserved.clear()
            self._slots = [None] * self.num_slots
        self._slot_prompts = [None] * self.num_slots
        self.cache.lengths.zero_()
        if self._draft_params is not None:
            self._draft_cache.lengths.zero_()
        if self.kv_page_size:
            self._free_pages = list(range(1, self.kv_pool_pages))
            self._slot_pages = [[] for _ in range(self.num_slots)]
            self._page_refs[:] = 0
            self._retained.clear()
            self.cache.table.zero_()
        for req in failures:
            req.error = exc
            req.done.set()

    def _admit_pending(self) -> bool:
        # an in-flight chunked prefill advances exactly one chunk per loop
        # iteration; the decode block for active slots runs in between
        if self._prefilling is not None:
            self._advance_chunk(self._prefilling)
            return True
        batch: List[tuple] = []
        try:
            return self._admit_pending_inner(batch)
        finally:
            self._flush_prefill_batch(batch)

    def _free_slot(self) -> Optional[int]:
        """The slot the next request takes (under the lock), None if none
        is free: the lowest free slot; in GSPMD mode the lowest free slot
        of the data group with the fewest slots taken (active or
        reserved), since a prefill runs on the group that owns the slot."""
        free = [i for i, s in enumerate(self._slots) if s is None and i not in self._reserved]
        if not free or self.worker is None or self._pipe_stages:
            return free[0] if free else None
        per = self.worker.per
        taken = [per] * (self.num_slots // per)
        for i in free:
            taken[i // per] -= 1
        return min(free, key=lambda i: (taken[i // per], i))

    def _admit_pending_inner(self, batch: List[tuple]) -> bool:
        admitted = False
        while True:
            with self._lock:
                free = self._free_slot()
                if free is None or not self._pending:
                    return admitted
                request = self._pending.popleft()
            if request.cancel_flag.is_set():
                request.finished_at = now_s()
                request.done.set()
                continue
            prompt = np.asarray(request.prompt_ids, np.int32)
            # the slot's retained rows are about to be overwritten; its
            # prompt index entry is valid again only at prefill completion
            stale_prompt = self._slot_prompts[free]
            self._slot_prompts[free] = None
            with self.spans("admit.lookup", request.request_id):
                hit = self._find_prefix(prompt, free, stale_prompt)
            if self.kv_page_size:
                # paged prefix reuse is PAGE-GRANULAR and zero-copy: the
                # new slot's table points at the hit's whole pages
                shared: List[int] = []
                src_slot = -1
                if hit is not None:
                    src_slot, l_star = hit
                    n_shared = l_star // self.kv_page_size
                    if n_shared == 0:
                        hit = None
                    else:
                        hit = (src_slot, n_shared * self.kv_page_size)
                        shared = self._slot_pages[src_slot][:n_shared]
                with self.spans("admit.grant", request.request_id):
                    granted = self._grant_pages(free, request, shared, src_slot)
                if not granted:
                    # pool exhausted: requeue at the FRONT and stop
                    # admitting until a release frees pages
                    self._slot_prompts[free] = stale_prompt
                    with self._lock:
                        self._pending.appendleft(request)
                    return admitted
            admitted = True
            request.admitted_at = now_s()
            self.spans.add("request.queue", request.admitted_at - request.submitted_at)
            self._reserved.add(free)  # until the prefill lands (or aborts)
            if self._lookup_ngram:
                # seed the slot's history with the prompt; stale tokens
                # past it are masked by the lookup's valid length
                row = np.zeros((self.max_len,), np.int32)
                row[:len(prompt)] = prompt
                self._history[free] = self._upload(row)
            try:
                if hit is not None:
                    src, l_star = hit
                    if src != free and self.worker is not None:
                        self.worker.copy_rows(src, free)  # GSPMD mode: every rank's rows
                    elif src != free and not self.kv_page_size:
                        _copy_slot_rows(self.cache, src, free)
                    if src != free and self._draft_params is not None:
                        _copy_slot_rows(self._draft_cache, src, free)  # dense in every mode
                    self.prefix_hits += 1
                    self.prefix_tokens_reused += l_star
                    if self._metrics is not None:
                        self._metrics.prefix_cache_hits_total.inc()
                        self._metrics.prefix_tokens_reused_total.inc(l_star)
                    self._prefilling = _PrefillProgress(request=request, slot=free,
                                                        prompt=prompt, offset=l_star)
                    self._advance_chunk(self._prefilling)
                    return True
                if self.prefill_chunk and (
                    len(prompt) > self.prefill_chunk
                    or len(prompt) > self.prefill_buckets[-1]
                ):
                    self._prefilling = _PrefillProgress(request=request, slot=free, prompt=prompt)
                    self._advance_chunk(self._prefilling)
                    return True
                # bucket validation raises inside this per-request containment
                batch.append((self._bucket_for(len(prompt)), free, request, prompt))
            except BaseException as exc:  # noqa: BLE001
                self._prefilling = None
                self._reserved.discard(free)
                self._free_slot_pages(free)
                request.error = exc
                request.done.set()
                if not isinstance(exc, ValueError):
                    raise

    # -- paged allocator ---------------------------------------------------

    def _grant_pages(self, slot: int, request: GenerationRequest, shared=(),
                     src_slot: int = -1) -> bool:
        """Reserve pool pages sized to THIS request (prompt + max_new +
        headroom) and install the slot's table row. ``shared`` page ids (a
        prefix hit's whole pages, owned by ``src_slot``) head the table
        with their refcount bumped. Returns False when the pool is
        exhausted even after reclaiming retained grants."""
        page = self.kv_page_size
        need = self._pages_needed(request)
        shared = list(shared)
        own_needed = need - len(shared)
        if len(self._free_pages) < own_needed:
            # reclaim RETAINED grants before refusing admission; never
            # the hit's source slot or this slot mid-grant
            for victim in [v for v in list(self._retained) if v not in (slot, src_slot)]:
                self._evict_retained(victim)
                if len(self._free_pages) >= own_needed:
                    break
        if len(self._free_pages) < own_needed and slot in self._retained:
            self._evict_retained(slot)
        if len(self._free_pages) < own_needed:
            return False
        old = self._slot_pages[slot]  # retained leftovers being replaced
        for p in shared:
            self._page_refs[p] += 1
        own = [self._free_pages.pop() for _ in range(own_needed)]
        for p in own:
            self._page_refs[p] = 1
        self._retained.discard(slot)
        if old:
            self._decref_pages(old)
        pages = shared + own
        self._slot_pages[slot] = pages
        row = np.zeros((self.max_len // page,), np.int32)
        row[:len(pages)] = pages
        set_table_row(self.cache, slot, self._upload(row))
        return True

    def _pages_needed(self, request: GenerationRequest) -> int:
        need_tokens = len(request.prompt_ids) + request.max_new_tokens + self.headroom()
        return -(-need_tokens // self.kv_page_size)

    def _decref_pages(self, pages) -> None:
        for p in pages:
            self._page_refs[p] -= 1
            if self._page_refs[p] == 0:
                self._free_pages.append(p)

    def _evict_retained(self, slot: int) -> None:
        """Drop a released slot's retained grant: its prompt leaves the
        prefix index and its pages decref (shared pages stay alive under
        other slots' refs)."""
        self._retained.discard(slot)
        self._slot_prompts[slot] = None
        self._decref_pages(self._slot_pages[slot])
        self._slot_pages[slot] = []

    def _free_slot_pages(self, slot: int, retain: bool = False) -> None:
        if not self.kv_page_size or not self._slot_pages[slot]:
            return
        if retain and self.prefix_cache:
            # keep the grant so the slot's rows stay valid for prefix hits
            self._retained.add(slot)
            return
        self._retained.discard(slot)
        self._decref_pages(self._slot_pages[slot])
        self._slot_pages[slot] = []

    def page_accounting(self) -> dict:
        """Pool pages by state: free, granted to live or reserved slots,
        retained by released slots only, and the garbage page. With no
        leak, free + live + retained + garbage == pool."""
        live = {p for i, pages in enumerate(self._slot_pages) if i not in self._retained
                for p in pages}
        retained = {p for i in self._retained for p in self._slot_pages[i]} - live
        return {"pool": self.kv_pool_pages, "free": len(self._free_pages), "live": len(live),
                "retained": len(retained), "garbage": 1}

    def _find_prefix(self, prompt, free, stale_prompt):
        """Longest usable cached prefix of ``prompt`` over the per-slot
        prompt index (completed prefills only). Returns (src_slot,
        prefix_len) or None. Capped at len(prompt)-1 so the tail prefill
        always scores at least one row (the first-token logits)."""
        if not self.prefix_cache:
            return None
        best = None
        candidates = list(enumerate(self._slot_prompts))
        if stale_prompt is not None:
            candidates.append((free, stale_prompt))  # in-place reuse
        for i, stored in candidates:
            if stored is None:
                continue
            n = min(len(stored), len(prompt) - 1)
            if n <= 0:
                continue
            neq = stored[:n] != prompt[:n]
            length = int(neq.argmax()) if neq.any() else n
            if length >= self.prefix_cache_min and (best is None or length > best[1]):
                best = (i, length)
        return best

    # -- prefill -----------------------------------------------------------

    def _zero_lengths(self, slot: int) -> None:
        self.cache.lengths[slot] = 0
        if self._draft_params is not None:
            self._draft_cache.lengths[slot] = 0

    def _advance_chunk(self, pf: _PrefillProgress) -> None:
        if pf.request.cancel_flag.is_set():
            # abort: zero the slot's length (rows written so far are never
            # attended) and free it — the slot was never activated
            self._prefilling = None
            self._reserved.discard(pf.slot)
            self._free_slot_pages(pf.slot)
            self._zero_lengths(pf.slot)
            pf.request.finished_at = now_s()
            pf.request.done.set()
            return
        with self.spans("admit.chunk", pf.request.request_id):
            c = self.prefill_chunk
            chunk = pf.prompt[pf.offset:pf.offset + c]
            valid = len(chunk)
            padded = np.zeros((c,), np.int32)
            padded[:valid] = chunk
            ids = self._upload(padded)
            _, logits = self._chunk_fn(self.spec, self.params, self.cache, ids, pf.offset,
                                       valid, pf.slot, self.dtype)
            if self._draft_params is not None:
                # each chunk advances both caches: the draft must hold the
                # prompt before it can draft
                prefill_chunk_step(self.draft_spec, self._draft_params, self._draft_cache, ids,
                                   pf.offset, valid, pf.slot, self.dtype)
            pf.offset += valid
            if pf.offset >= len(pf.prompt):
                self._prefilling = None
                self._add_landings([(pf.slot, pf.request)], logits[None])

    def _add_landings(self, items, logits: torch.Tensor) -> None:
        """Queue the landings of prefills just dispatched (``items``:
        (slot, request) per row of ``logits`` [N, V]) and start the copy
        of their logits to the host."""
        self._dispatch_seq += 1
        host, event = self._start_fetch(logits)
        for j, (slot, request) in enumerate(items):
            self._landings.append(_PrefillLanding(request=request, slot=slot, logits=host,
                                                  event=event, seq=self._dispatch_seq, row=j))

    def _flush_prefill_batch(self, batch) -> None:
        """Dispatch the admissions collected in one loop, grouped by
        bucket (same-bucket prompts run back to back and their logits come
        back in one [N, V] fetch)."""
        if not batch:
            return
        ids = ",".join(filter(None, (r.request_id for _, _, r, _ in batch)))
        with self.spans("admit.prefill", ids):
            groups: dict = {}
            for bucket, slot, request, prompt in batch:
                groups.setdefault(bucket, []).append((slot, request, prompt))
            for bucket, items in groups.items():
                try:
                    logits_all = self._prefill_many(bucket, items)
                except BaseException as exc:  # noqa: BLE001
                    for slot, request, _ in items:
                        self._reserved.discard(slot)
                        self._free_slot_pages(slot)
                        request.error = exc
                        request.done.set()
                    if not isinstance(exc, ValueError):
                        raise
                    continue
                self._add_landings([(slot, request) for slot, request, _ in items], logits_all)

    def _prefill_many(self, bucket: int, items) -> torch.Tensor:
        """N same-bucket prefills (counterpart of ``_prefill_many_fn``);
        each iteration is exactly the single-prefill body, the draft's
        prefill included. Returns the logits [N, V] on the device."""
        out = torch.empty((len(items), self.spec.vocab), dtype=torch.float32,
                          device=self.device)
        for j, (slot, _, prompt) in enumerate(items):
            padded = np.zeros((bucket,), np.int32)
            padded[:len(prompt)] = prompt
            ids = self._upload(padded)
            _, logits = self._prefill_fn(self.spec, self.params, self.cache, ids, len(prompt),
                                         slot, self.dtype)
            if self._draft_params is not None:
                prefill(self.draft_spec, self._draft_params, self._draft_cache, ids,
                        len(prompt), slot, self.dtype)
            out[j] = logits
        return out

    def _land_prefills(self, force: bool = False) -> bool:
        """Finish dispatched prefills whose logits a consumed decode block
        has proven to be on the host (the stream runs work in dispatch
        order); ``force`` lands them all (idle engine, drain). Returns
        True if any landed."""
        landed = False
        while self._landings:
            landing = self._landings[0]
            if not force and self._consumed_seq <= landing.seq:
                break
            # peek, then fetch: if the fetch raises (the watchdog), the
            # landing is still queued and the failure path fails it too
            if not landing.request.cancel_flag.is_set():
                logits = self._fetch(landing.logits, landing.event)[landing.row]
            self._landings.popleft()
            self._reserved.discard(landing.slot)
            if landing.request.cancel_flag.is_set():
                # cancelled between dispatch and landing: the slot was
                # reserved but never activated — zero its length and free
                self._free_slot_pages(landing.slot)
                self._zero_lengths(landing.slot)
                landing.request.finished_at = now_s()
                landing.request.done.set()
            else:
                self._finish_prefill(landing.slot, landing.request, logits)
            landed = True
        return landed

    def _finish_prefill(self, slot: int, request: GenerationRequest, logits: np.ndarray) -> None:
        """Sample the first token and activate the slot."""
        if self.prefix_cache:
            # the slot now holds this prompt's rows [0, len): index it for
            # prefix reuse (valid until the slot is next admitted)
            self._slot_prompts[slot] = np.asarray(request.prompt_ids, np.int32)
        self._membership_dirty = True  # the in-flight carry lacks this slot
        first = self._sample_first(logits, request)
        request.first_token_at = now_s()
        self.spans.add("request.prefill", request.first_token_at - request.admitted_at)
        m = self._metrics
        if m is not None:
            m.generation_ttft.observe((request.first_token_at - request.submitted_at) * 1e3)
        self._emit(request, first)
        state = _SlotState(request=request, last_token=first, emitted=1)
        with self._lock:
            self._slots[slot] = state
            if m is not None:
                m.generation_active_slots.set(sum(s is not None for s in self._slots))
                m.generation_pending.set(len(self._pending))
        if self._finished(state):
            self._release(slot)

    @staticmethod
    def _sample_first(logits: np.ndarray, request: GenerationRequest) -> int:
        """Sample the prefill's first token on host (single vector)."""
        if request.temperature <= 0:
            return int(logits.argmax())
        rng = np.random.default_rng(request.seed)
        scaled = logits.astype(np.float64) / max(request.temperature, 1e-6)
        if request.top_k > 0:
            kth = np.sort(scaled)[-min(request.top_k, len(scaled))]
            scaled = np.where(scaled < kth, -np.inf, scaled)
        p = np.exp(scaled - scaled.max())
        p /= p.sum()
        return int(rng.choice(len(p), p=p))

    # -- decode ------------------------------------------------------------

    def _snapshot_active(self):
        """Host snapshot of the active slots: per-slot input ids, sampling
        parameters and the exact _SlotState each block is dispatched for
        (a consumed block commits only to a slot whose state is STILL the
        dispatched one: chained blocks may outlive a release). The arrays
        the blocks read on the device are uploaded once per snapshot, in
        one copy, and serve every block chained from it."""
        with self._lock:
            if not any(s is not None for s in self._slots):
                return None
            n = self.num_slots
            snap = {
                "ids": np.zeros((n,), np.int32),
                "active": np.zeros((n,), bool),
                "temps": np.zeros((n,), np.float32),
                "top_k": np.zeros((n,), np.int32),
                "seeds": np.zeros((n,), np.int64),
                "progress": np.zeros((n,), np.int32),
                "eos": np.full((n,), -1, np.int32),
                "limit": np.zeros((n,), np.int32),
                "states": list(self._slots),
            }
            for i, s in enumerate(self._slots):
                if s is not None:
                    snap["ids"][i] = s.last_token
                    snap["active"][i] = True
                    snap["temps"][i] = s.request.temperature
                    snap["top_k"][i] = s.request.top_k
                    snap["seeds"][i] = s.request.seed & 0xFFFFFFFF
                    snap["progress"][i] = s.emitted
                    if s.request.eos_id is not None:
                        snap["eos"][i] = s.request.eos_id
                    snap["limit"][i] = s.request.max_new_tokens
        # blocks that can hold live work: a live slot commits at least one
        # token per step (or window), so none is alive past its budget
        budget = int((snap["limit"] - snap["progress"])[snap["active"]].max())
        snap["blocks"] = -(-budget // self.steps_per_sync)
        dev = self._upload(np.stack([
            snap["ids"], snap["active"], snap["progress"], snap["eos"], snap["limit"],
            snap["temps"] > 0]).astype(np.int32))
        snap["ids_dev"], snap["progress_dev"] = dev[0], dev[2]
        snap["eos_dev"], snap["limit_dev"] = dev[3], dev[4]
        snap["active_dev"], snap["sampled_dev"] = dev[1] > 0, dev[5] > 0
        snap["sample"] = self._upload_sampling(snap)
        return snap

    def _upload_sampling(self, snap):
        """The sampling parameters of the snapshot's sampled slots, on the
        device in one copy (slot indices, temperatures as their f32 bits,
        top-k, seeds), with the largest top-k as a host int; None when no
        active slot samples, so a greedy snapshot draws no noise."""
        idx = np.nonzero(snap["active"] & (snap["temps"] > 0))[0]
        if idx.size == 0:
            return None
        temps = snap["temps"][idx]
        packed = self._upload(np.stack([
            idx, temps.view(np.int32), snap["top_k"][idx], snap["seeds"][idx]]).astype(np.int64))
        return {"idx": packed[0], "temps": packed[1].to(torch.int32).view(torch.float32),
                "top_k": packed[2], "seeds": packed[3],
                "k_max": int(snap["top_k"][idx].max())}

    def _dispatch_block(self, ids, progress, snap, alive=None, chain: int = 0) -> dict:
        """Dispatch one block (no sync): from the snapshot's uploaded
        arrays (``chain`` 0) or from the previous block's device carry
        (``ids``, ``progress``, ``alive``; block ``chain`` of the
        snapshot). Starts the copy of its tokens to the host and returns
        the record that ``_consume_block`` commits."""
        self._dispatch_seq += 1
        if self._lookup_ngram:
            fn = self._prompt_lookup_block
        elif self._draft_params is not None:
            fn = self._speculative_block
        elif snap["sample"] is None and self.mesh is None:
            fn = self._greedy_block
        else:
            fn = self._decode_and_sample
        alive = snap["active_dev"] if alive is None else alive
        tokens, nxt, prog, alive = fn(ids, alive, progress, snap)
        host, event = self._start_fetch(tokens)
        return {"host": host, "event": event, "nxt": nxt, "prog": prog, "alive": alive,
                "snap": snap, "seq": self._dispatch_seq, "chain": chain}

    def _step_active(self) -> bool:
        if not self._inflight and not any(s is not None for s in self._slots):
            return False  # no slot is active: no step, no dispatch time
        with self.spans("dispatch"):
            if not self._inflight:
                snap = self._snapshot_active()
                if snap is None:  # the last slot was released meanwhile
                    return False
                self._membership_dirty = False
                self._inflight.append(self._dispatch_block(snap["ids_dev"],
                                                           snap["progress_dev"], snap))
            # pump: chain blocks off the newest carry until the pipeline is
            # full (or every slot's budget ends before the next block); the
            # card runs them back to back while the host commits the oldest
            while (self.decode_overlap and not self._membership_dirty
                   and len(self._inflight) < self.pipeline_depth
                   and self._inflight[-1]["chain"] + 1 < self._inflight[-1]["snap"]["blocks"]):
                last = self._inflight[-1]
                self._inflight.append(self._dispatch_block(last["nxt"], last["prog"],
                                                           last["snap"], last["alive"],
                                                           last["chain"] + 1))
        with self.spans("consume"):
            self._consume_block(self._inflight.popleft())  # may set the dirty flag
        return True

    def record_first_send(self, request: GenerationRequest) -> None:
        """The front door handed ``request``'s first token to its stream:
        adds the time since the token was sampled to ``request.send``
        (called from the server's thread)."""
        self.spans.add("request.send", now_s() - request.first_token_at)

    def _count_drafts(self, packed: np.ndarray, snap) -> None:
        """Acceptance counters of a speculative block: a (block, slot) pair
        drafted when the slot was alive and greedy (an alive greedy slot
        commits at least one token, so counts > 0 marks it) and, for
        prompt lookup, an n-gram matched; the pre-clamp accepted count
        measures draft quality, not budget / EOS truncation."""
        k1 = self.speculate_k + 1
        greedy = snap["active"] & (snap["temps"] == 0)
        drafted = packed[:, greedy, k1] > 0
        if packed.shape[2] > k1 + 2:
            drafted &= packed[:, greedy, k1 + 2] > 0
        self.drafted_tokens += self.speculate_k * int(drafted.sum())
        self.accepted_drafts += int(packed[:, greedy, k1 + 1][drafted].sum())
        if self._metrics is not None and self.drafted_tokens:
            self._metrics.draft_acceptance_ratio.set(self.accepted_drafts / self.drafted_tokens)

    def _consume_block(self, rec: dict) -> None:
        """Fetch a dispatched block's tokens (the sync point) and commit
        them to the slots it was dispatched for. The tokens are [steps,
        S, 1] (plain decode; EOS and budget were enforced on the device
        and the host stops each column at the same point) or [blocks, S,
        K+3 (+1)] (speculation: the window, then the commit counts, walked
        token by token)."""
        snap = rec["snap"]
        # this block's tokens are on the host, so every prefill dispatched
        # before it is done too
        self._consumed_seq = max(self._consumed_seq, rec["seq"])
        block = self._fetch(rec["host"], rec["event"])
        active = snap["active"]
        spec_mode = self._speculating
        if spec_mode:
            self._count_drafts(block, snap)
            tokens = block[:, :, :self.speculate_k + 1]
            counts = block[:, :, self.speculate_k + 1]
        else:
            tokens = block
        steps_n = tokens.shape[0]
        self.steps += steps_n
        if self._metrics is not None and self.steps % 64 < steps_n:
            for phase in LOOP_PHASES:
                self._metrics.generation_loop_seconds.labels(phase=phase).set(
                    self.loop_timers[phase])
        finished = set()
        for i in range(self.num_slots):
            if not active[i]:
                continue
            with self._lock:
                state = self._slots[i]
            if state is None or state is not snap["states"][i]:
                continue  # slot released (and possibly re-admitted)
            req = state.request
            if req.cancel_flag.is_set():
                finished.add(i)
                continue
            if spec_mode:
                for b in range(steps_n):
                    for j in range(int(counts[b, i])):
                        token = int(tokens[b, i, j])
                        state.last_token = token
                        state.emitted += 1
                        self._emit(req, token)
                        if self._finished(state):
                            finished.add(i)
                            break
                    if i in finished:
                        break
                continue
            col = tokens[:, i, 0]
            n = int(min(steps_n, max(req.max_new_tokens - state.emitted, 0)))
            eos = req.eos_id
            if eos is not None and n > 0:
                hits = np.nonzero(col[:n] == eos)[0]
                if hits.size:
                    n = int(hits[0]) + 1
            if n <= 0:
                finished.add(i)
                continue
            take = col[:n].tolist()
            req.tokens.extend(take)
            if req.on_token is not None:
                for tok in take:
                    req.on_token(tok)
            state.emitted += n
            state.last_token = take[-1]
            self.generated_tokens += n
            if self._metrics is not None:
                self._metrics.generated_tokens_total.inc(n)
            if state.emitted >= req.max_new_tokens or (eos is not None and take[-1] == eos):
                finished.add(i)
        for i in finished:
            # a slot that hit its EOS or budget froze on the device (the
            # alive carry), so the blocks in flight stay valid; only a
            # cancellation, which the device does not see, stops the pump
            state = snap["states"][i]
            self._release(i, invalidate_carry=state is not None
                          and state.request.cancel_flag.is_set())
        if finished:
            with self._lock:
                live = any(s is not None for s in self._slots)
            if not live:
                self._membership_dirty = True  # stop pumping dead blocks

    def _emit(self, request: GenerationRequest, token: int) -> None:
        request.tokens.append(token)
        self.generated_tokens += 1
        if self._metrics is not None:
            self._metrics.generated_tokens_total.inc()
        if request.on_token is not None:
            request.on_token(token)

    def _finished(self, state: _SlotState) -> bool:
        req = state.request
        if req.cancel_flag.is_set():
            return True
        if state.emitted >= req.max_new_tokens:
            return True
        return req.eos_id is not None and req.tokens[-1] == req.eos_id

    def _release(self, slot: int, invalidate_carry: bool = True) -> None:
        if invalidate_carry:
            self._membership_dirty = True  # the in-flight carry is stale
        with self._lock:
            state = self._slots[slot]
            self._slots[slot] = None
            if self._metrics is not None:
                self._metrics.generation_active_slots.set(sum(s is not None for s in self._slots))
        if state is not None:
            state.request.finished_at = now_s()
            state.request.done.set()
            if self._metrics is not None:
                self._metrics.generation_tokens_per_request.observe(state.emitted)
        # paged: return the slot's pages (under prefix_cache the grant is
        # RETAINED so its rows stay valid for hits)
        self._free_slot_pages(slot, retain=True)
        # zero the slot length so the next prefill starts clean
        self._zero_lengths(slot)


def check_mesh(spec: DecoderSpec, mesh, *, flat: bool, prefill_chunk: int,
               prefill_buckets, num_slots: int, pipe_microgroups: int,
               kv_page_size: int, prompt_lookup_ngram: int = 0) -> tuple:
    """The JAX engine's mesh guards, on a ``RankMesh`` or its ``MeshAxes``
    (the engine checks its rank's mesh; ``build_generation_engine`` checks
    a config's before any weights are built), for both modes. Returns pipe
    mode's stage and decode-microgroup counts ((0, 0) in GSPMD mode)."""
    from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS
    from ..parallel.pipeline_decode import _axis, _microgroups, validate_pipe_mesh
    from ..parallel.tp_layout import validate_decoder_tp, validate_gspmd_decoder_tp

    if flat:
        raise ValueError(
            "kv_cache_layout='flat' is single-device only (mesh "
            "decode paths keep the standard layout)"
        )
    if _axis(mesh, PIPE_AXIS) <= 1:
        data = _axis(mesh, DATA_AXIS)
        if num_slots % data != 0:
            raise ValueError(
                f"num_slots ({num_slots}) must be divisible by the "
                f"mesh data axis ({data}) to shard the KV slots"
            )
        # every head layout: whole heads a rank where model allows, else
        # gathered heads (the JAX GSPMD engine runs no head check; pipe
        # mode keeps it, below); a cut dimension model does not divide
        # raises, as JAX's device_put
        validate_gspmd_decoder_tp(spec, _axis(mesh, MODEL_AXIS))
        if kv_page_size:
            raise ValueError(
                "paged KV cache does not compose with mesh decoding "
                "yet (slot-sharded dense cache only)"
            )
        if prompt_lookup_ngram:
            raise ValueError(
                "prompt_lookup_ngram does not compose with mesh "
                "decoding yet (history buffer is unsharded)"
            )
        return 0, 0
    stages = validate_pipe_mesh(mesh)
    validate_decoder_tp(spec, _axis(mesh, MODEL_AXIS))
    if prefill_chunk:
        raise ValueError(
            "prefill_chunk and pipelined decoding do not "
            "compose: the pipelined prefill already chunks "
            "the prompt over the stages (set prefill_chunk=0)"
        )
    for b in prefill_buckets or [32, 64, 128, 256]:
        if b % stages != 0:
            raise ValueError(
                f"prefill bucket {b} not divisible by "
                f"{stages} pipeline stages"
            )
    microgroups = _microgroups(stages, num_slots, pipe_microgroups, "decode")
    if kv_page_size:
        raise ValueError(
            "paged KV cache does not compose with mesh decoding "
            "yet (slot-sharded dense cache only)"
        )
    return stages, microgroups


def build_draft(cfg, spec: DecoderSpec, device):
    """The draft model of ``options.draft_variant`` as the JAX server
    builds it (``grpc/server.py:136-162``): ``draft_options`` with the
    vocab defaulting to the target's, weights from ``seed + 1`` (or
    ``draft_params``, an ``.npz`` path), quantized to the target's bits.
    Returns (draft spec, params on ``device``) or (None, None)."""
    from ..models.registry import QUANT_BITS, get_family, load_params
    from ..ops.quant import maybe_quantize_tree
    from ..weights import params_from_numpy

    opts = cfg.model.options
    variant = opts.get("draft_variant", "")
    if not variant:
        return None, None
    draft_opts = dict(opts.get("draft_options", {}))
    draft_opts.setdefault("vocab", spec.vocab)
    definition = get_family(variant, draft_opts)
    src = opts.get("draft_params", "random")
    if src == "random":
        tree = definition.init_params(np.random.default_rng(cfg.seed + 1))
    else:
        tree = load_params(src)
    params = maybe_quantize_tree(params_from_numpy(tree, device),
                                 QUANT_BITS[cfg.model.quantization])
    return definition.spec, params


def build_generation_engine(cfg, device=None, params=None, metrics=None,
                            mesh=None) -> GenerationEngine:
    """Config -> model -> engine, the part of the server that needs
    neither ``grpc`` nor ``yaml`` (``chip_smoke.py`` drives it directly).
    ``params``: the config's parameter tree already built on ``device``
    (one tree may serve several engines of a process); built from the
    config's seed when None. ``metrics``: the recorder whose generation
    families the engine updates (None: none). ``mesh``: this rank's
    ``parallel.mesh.RankMesh`` for a config whose ``devices.mesh`` has
    more than one position (every rank calls this; without ``params``
    rank 0 builds the weights once and each rank gets its shard,
    ``weights.mesh_params``, and the draft model lives on rank 0).

    Sets the process-wide W8A8 flag from the config, on or off, every
    time (W8A8 and W4A8 quantize the dense layers' activations). Raises
    ``NotImplementedError`` for non-decoder families, and ``ValueError``
    for a config mesh without rank meshes; ``pin_cache_layouts`` is accepted
    as a no-op (a TPU layout workaround) but refused with
    ``kv_cache_layout: flat``, as the JAX engine refuses it."""
    from ..models.registry import build_model, get_family
    from ..utils.config import QuantMode

    opts = cfg.model.options
    definition = get_family(cfg.model.family, opts)
    if not definition.supports_generation:
        raise NotImplementedError(f"{cfg.model.family!r} is not a decoder family")
    layout = str(opts.get("kv_cache_layout", "standard"))
    engine_opts = dict(
        num_slots=int(opts.get("num_slots", 8)),
        max_len=int(opts.get("max_len", 512)),
        prefill_buckets=list(opts.get("prefill_buckets", [32, 64, 128, 256])),
        steps_per_sync=int(opts.get("steps_per_sync", 1)),
        prefill_chunk=int(opts.get("prefill_chunk", 0)),
        speculate_k=int(opts.get("speculate_k", 4)),
        prompt_lookup_ngram=int(opts.get("prompt_lookup_ngram", 0)),
        prefix_cache=bool(opts.get("prefix_cache", False)),
        prefix_cache_min=int(opts.get("prefix_cache_min", 16)),
        decode_overlap=bool(opts.get("decode_overlap", True)),
        pipeline_depth=int(opts.get("decode_pipeline_depth", 2)),
        kv_page_size=int(opts.get("kv_page_size", 0)),
        kv_pool_pages=int(opts.get("kv_pool_pages", 0)),
        kv_cache_layout=layout,
        pin_cache_layouts=bool(opts.get("pin_cache_layouts", False)),
        fetch_timeout_s=float(opts.get("fetch_timeout_s", 120.0)),
        # read as the JAX server reads it; inert without a pipe axis
        pipe_microgroups=int(opts.get("pipe_microgroups", 0)),
    )
    axes = cfg.devices.mesh
    if axes.size > 1 and mesh is None:
        # the engine's guards on the config's mesh, before any rank or weight
        from ..parallel.mesh import MeshAxes

        check_mesh(definition.spec, MeshAxes(data=axes.data, model=axes.model,
                                             expert=axes.expert, pipe=axes.pipe),
                   flat=layout == "flat", **{k: engine_opts[k] for k in (
                       "prefill_chunk", "prefill_buckets", "num_slots",
                       "pipe_microgroups", "kv_page_size", "prompt_lookup_ngram")})
        raise ValueError(
            f"devices.mesh of size {axes.size} runs as that many rank "
            "processes: start it from the server CLI (parallel/launch.py:serve_mesh) "
            "or pass each rank's mesh"
        )
    if axes.size == 1 and mesh is not None:
        raise ValueError("a mesh was passed for a config whose devices.mesh has one position")
    nn.set_w8a8(cfg.model.quantization in (QuantMode.W8A8, QuantMode.W4A8))
    dev = mesh.device if mesh is not None else resolve_device(device)
    if params is None and mesh is not None:
        from ..weights import mesh_params

        params = mesh_params(cfg.model, cfg.seed, definition.spec, mesh)
    elif params is None:
        params = build_model(cfg.model, seed=cfg.seed, device=dev).params
    draft_spec, draft_params = (None, None) if mesh is not None and mesh.rank != 0 else \
        build_draft(cfg, definition.spec, dev)
    return GenerationEngine(
        definition.spec,
        params,
        # as the JAX server: bf16 compute for BF16, f32 otherwise
        dtype=torch.bfloat16 if cfg.model.compute_dtype == "BF16" else torch.float32,
        draft_spec=draft_spec,
        draft_params=draft_params,
        device=dev,
        metrics=metrics,
        mesh=mesh,
        family=cfg.model.family,
        **engine_opts,
    )
