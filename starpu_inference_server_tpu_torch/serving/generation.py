"""Continuous-batching generation engine for decoder models (core engine).

Counterpart of ``starpu_inference_server_tpu/serving/generation.py``:
the same request object, slot pool, admission with same-bucket batched
prefill, chunked prefill interleaved with decode blocks, decode blocks of
``steps_per_sync`` steps with DEVICE-SIDE completion (a slot that hits
its EOS or budget freezes inside the block), cancellation and release.

Differences from the JAX engine:

- PyTorch runs eagerly; there is no jit, no donation (the cache is
  updated in place, see models/decoder.py) and no executable per bucket.
- Dispatch runs at depth 1: each decode block is consumed before the
  next is dispatched, and a prefill's logits are fetched when it is
  dispatched. ``decode_overlap`` / ``pipeline_depth`` are accepted and
  logged; overlapped dispatch is a ROADMAP item.
- Sampled tokens use a ``torch.Generator`` seeded from (seed, absolute
  progress), so a request samples the same tokens however it is
  interleaved; they differ from ``jax.random``'s. Greedy decoding takes
  the first maximum, as ``jnp.argmax`` does.
- Speculation, prompt lookup, prefix cache, paged / flat caches and
  meshes are not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models.decoder import DecoderSpec, decode_step, init_cache, prefill
from ..models.decoder import prefill_chunk as prefill_chunk_step
from ..models.registry import resolve_device
from ..ops import nn
from ..ops.quant import pack_int4_tree
from ..utils.clock import now_s
from ..utils.logger import get_logger


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


def _sample_seed(seed: int, progress: int) -> int:
    """Generator seed of a request's token at absolute ``progress``."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(progress) & 0xFFFFFFFF)


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
        decode_overlap: bool = False,
        pipeline_depth: int = 2,
        device=None,
    ):
        """``params``: the port's parameter tree (torch tensors; see
        ``weights.params_from_numpy``). ``device`` defaults to ``cuda``
        and raises when CUDA is missing unless ``device='cpu'``."""
        self.device = resolve_device(device)
        self.spec = spec
        self.dtype = dtype
        self.num_slots = num_slots
        self.max_len = max_len
        self.params = self._place_params(params)
        # tokens decoded per host sync: a block of ``steps_per_sync``
        # decode steps runs before its [steps, S] tokens are fetched;
        # tokens past a request's EOS / limit are computed and discarded
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.decode_overlap = bool(decode_overlap)
        self.pipeline_depth = 1
        if self.decode_overlap:
            get_logger().info(
                "decode_overlap (depth %d) requested: the PyTorch engine "
                "dispatches at depth 1 (overlapped dispatch is on the ROADMAP)",
                int(pipeline_depth),
            )
        self.prefill_buckets = sorted(prefill_buckets or [32, 64, 128, 256])
        self.prefill_chunk = max(0, int(prefill_chunk))
        if self.prefill_chunk and max_len % self.prefill_chunk != 0:
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) must divide "
                f"max_len ({max_len}) so every chunk fits the cache row"
            )
        self.cache = init_cache(spec, num_slots, max_len, device=self.device)
        self._prefilling: Optional[_PrefillProgress] = None
        self._reserved: set = set()
        self._slots: List[Optional[_SlotState]] = [None] * num_slots
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.steps = 0
        self.generated_tokens = 0
        # cumulative engine-loop phase timers (seconds, host clock)
        self.loop_timers = {"admit": 0.0, "step": 0.0}

    # -- placement ---------------------------------------------------------

    def _place_params(self, params):
        """Params on the engine's device; int4 leaves are packed pairwise
        where the int4 kernel route applies (on CUDA, or when kernels are
        forced), as the JAX engine packs them on the TPU."""
        from ..weights import params_from_numpy

        params = params_from_numpy(params, self.device)
        if nn.use_kernels(self.device):
            params = pack_int4_tree(params)
        return params

    # -- device fns --------------------------------------------------------

    def _sample(self, logits, temps, top_k, seeds, progress, step: int):
        """Greedy argmax (first maximum) where temperature is 0; elsewhere
        temperature / top-k sampling from a Generator seeded by (seed,
        progress + step). ``temps``/``top_k``/``seeds``/``progress`` are
        host arrays of the block's snapshot: the progress of a slot that
        is alive at ``step`` is exactly ``progress + step``."""
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        for i in np.nonzero(temps > 0)[0]:
            scaled = logits[i] / max(float(temps[i]), 1e-6)
            k = int(top_k[i])
            if k > 0:
                kth = torch.topk(scaled, min(k, scaled.shape[-1])).values[-1]
                scaled = torch.where(scaled < kth, torch.full_like(scaled, -float("inf")), scaled)
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(_sample_seed(seeds[i], progress[i] + step))
            probs = torch.softmax(scaled, dim=-1)
            nxt[i] = torch.multinomial(probs, 1, generator=gen)[0].to(torch.int32)
        return nxt

    def _decode_and_sample(self, ids, active, snap):
        """One block of ``steps_per_sync`` decode steps. DEVICE-SIDE
        COMPLETION: a slot whose token hits its eos or exhausts its
        budget drops out of ``alive`` on the device, so later steps of the
        block stop advancing its cache; frozen slots repeat their last id
        in the token block."""
        steps = self.steps_per_sync
        dev = self.device
        eos = torch.as_tensor(snap["eos"], device=dev)
        limit = torch.as_tensor(snap["limit"], device=dev)
        prog = torch.as_tensor(snap["progress"], device=dev)
        alive = active.clone()
        tokens = torch.zeros((steps, self.num_slots), dtype=torch.int32, device=dev)
        for i in range(steps):
            _, logits = decode_step(self.spec, self.params, self.cache, ids, alive, self.dtype)
            nxt = self._sample(logits, snap["temps"], snap["top_k"], snap["seeds"],
                               snap["progress"], i)
            nxt = torch.where(alive, nxt, ids)
            prog = prog + alive.to(torch.int32)
            done = alive & ((nxt == eos) | (prog >= limit))
            alive = alive & ~done
            tokens[i] = nxt
            ids = nxt
        return tokens

    def _bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if b >= length:
                return b
        raise ValueError(
            f"prompt length {length} exceeds largest prefill bucket "
            f"{self.prefill_buckets[-1]}"
        )

    # -- public API --------------------------------------------------------

    def submit(self, request: GenerationRequest) -> GenerationRequest:
        request.submitted_at = now_s()
        if len(request.prompt_ids) == 0:
            raise ValueError("prompt must hold at least one token")
        if len(request.prompt_ids) + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({len(request.prompt_ids)}) + max_new_tokens"
                f"({request.max_new_tokens}) exceeds max context {self.max_len}"
            )
        if not self.prefill_chunk and len(request.prompt_ids) > self.prefill_buckets[-1]:
            raise ValueError(
                f"prompt length {len(request.prompt_ids)} exceeds largest "
                f"prefill bucket {self.prefill_buckets[-1]} and chunked "
                f"prefill is disabled (set prefill_chunk)"
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

    # -- engine loop -------------------------------------------------------

    def _loop(self) -> None:
        log = get_logger()
        try:
            t = self.loop_timers
            while not self._stop.is_set():
                t0 = now_s()
                admitted = self._admit_pending()
                t1 = now_s()
                stepped = self._step_active()
                t["admit"] += t1 - t0
                t["step"] += now_s() - t1
                if not admitted and not stepped:
                    with self._work:
                        if not self._pending and not self._stop.is_set():
                            self._work.wait(timeout=0.05)
        except Exception as exc:  # noqa: BLE001 - the loop's boundary: fail all open requests
            log.error("generation engine failed: %s: %s", type(exc).__name__, exc)
            with self._lock:
                failures = [s.request for s in self._slots if s is not None]
                failures.extend(self._pending)
                if self._prefilling is not None:
                    failures.append(self._prefilling.request)
                    self._prefilling = None
                self._pending.clear()
                self._reserved.clear()
                self._slots = [None] * self.num_slots
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

    def _admit_pending_inner(self, batch: List[tuple]) -> bool:
        admitted = False
        while True:
            with self._lock:
                free = next(
                    (i for i, s in enumerate(self._slots)
                     if s is None and i not in self._reserved),
                    None,
                )
                if free is None or not self._pending:
                    return admitted
                request = self._pending.popleft()
            if request.cancel_flag.is_set():
                request.finished_at = now_s()
                request.done.set()
                continue
            prompt = np.asarray(request.prompt_ids, np.int32)
            admitted = True
            self._reserved.add(free)  # until the prefill lands (or aborts)
            try:
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
                request.error = exc
                request.done.set()
                if not isinstance(exc, ValueError):
                    raise

    def _advance_chunk(self, pf: _PrefillProgress) -> None:
        if pf.request.cancel_flag.is_set():
            # abort: zero the slot's length (rows written so far are never
            # attended) and free it — the slot was never activated
            self._prefilling = None
            self._reserved.discard(pf.slot)
            self.cache.lengths[pf.slot] = 0
            pf.request.finished_at = now_s()
            pf.request.done.set()
            return
        c = self.prefill_chunk
        chunk = pf.prompt[pf.offset:pf.offset + c]
        valid = len(chunk)
        padded = np.zeros((c,), np.int32)
        padded[:valid] = chunk
        _, logits = prefill_chunk_step(
            self.spec, self.params, self.cache,
            torch.as_tensor(padded, device=self.device), pf.offset, valid, pf.slot,
            self.dtype,
        )
        pf.offset += valid
        if pf.offset >= len(pf.prompt):
            self._prefilling = None
            self._land(pf.slot, pf.request, logits.cpu().numpy())

    def _flush_prefill_batch(self, batch) -> None:
        """Dispatch the admissions collected in one loop, grouped by
        bucket (same-bucket prompts run back to back and their logits come
        back in one [N, V] fetch)."""
        groups: dict = {}
        for bucket, slot, request, prompt in batch:
            groups.setdefault(bucket, []).append((slot, request, prompt))
        for bucket, items in groups.items():
            try:
                logits_all = self._prefill_many(bucket, items)
            except BaseException as exc:  # noqa: BLE001
                for slot, request, _ in items:
                    self._reserved.discard(slot)
                    request.error = exc
                    request.done.set()
                if not isinstance(exc, ValueError):
                    raise
                continue
            for j, (slot, request, _) in enumerate(items):
                self._land(slot, request, logits_all[j])

    def _prefill_many(self, bucket: int, items) -> np.ndarray:
        """N same-bucket prefills (counterpart of ``_prefill_many_fn``);
        each iteration is exactly the single-prefill body. Returns the
        host logits [N, V]."""
        out = torch.empty((len(items), self.spec.vocab), dtype=torch.float32,
                          device=self.device)
        for j, (slot, _, prompt) in enumerate(items):
            padded = np.zeros((bucket,), np.int32)
            padded[:len(prompt)] = prompt
            _, logits = prefill(self.spec, self.params, self.cache,
                                torch.as_tensor(padded, device=self.device),
                                len(prompt), slot, self.dtype)
            out[j] = logits
        return out.cpu().numpy()

    def _land(self, slot: int, request: GenerationRequest, logits: np.ndarray) -> None:
        """Finish a prefill: sample the first token and activate the slot
        (or free it if the request was cancelled meanwhile)."""
        self._reserved.discard(slot)
        if request.cancel_flag.is_set():
            self.cache.lengths[slot] = 0
            request.finished_at = now_s()
            request.done.set()
            return
        first = self._sample_first(logits, request)
        request.first_token_at = now_s()
        self._emit(request, first)
        state = _SlotState(request=request, last_token=first, emitted=1)
        with self._lock:
            self._slots[slot] = state
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

    def _snapshot_active(self):
        """Host snapshot of the active slots: per-slot input ids, sampling
        parameters and the exact _SlotState each block is dispatched for."""
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
        return snap

    def _step_active(self) -> bool:
        snap = self._snapshot_active()
        if snap is None:
            return False
        tokens = self._decode_and_sample(
            torch.as_tensor(snap["ids"], device=self.device),
            torch.as_tensor(snap["active"], device=self.device),
            snap,
        )
        self._consume_block(tokens.cpu().numpy(), snap)
        return True

    def _consume_block(self, tokens: np.ndarray, snap) -> None:
        """Commit a fetched [steps, S] token block to the slots it was
        dispatched for. EOS and budget were enforced on the device; the
        host stops each slot's column at the same point."""
        active = snap["active"]
        steps_n = tokens.shape[0]
        self.steps += steps_n
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
            col = tokens[:, i]
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
            if state.emitted >= req.max_new_tokens or (eos is not None and take[-1] == eos):
                finished.add(i)
        for i in finished:
            self._release(i)

    def _emit(self, request: GenerationRequest, token: int) -> None:
        request.tokens.append(token)
        self.generated_tokens += 1
        if request.on_token is not None:
            request.on_token(token)

    def _finished(self, state: _SlotState) -> bool:
        req = state.request
        if req.cancel_flag.is_set():
            return True
        if state.emitted >= req.max_new_tokens:
            return True
        return req.eos_id is not None and req.tokens[-1] == req.eos_id

    def _release(self, slot: int) -> None:
        with self._lock:
            state = self._slots[slot]
            self._slots[slot] = None
        if state is not None:
            state.request.finished_at = now_s()
            state.request.done.set()
        # zero the slot length so the next prefill starts clean
        self.cache.lengths[slot] = 0


# options of the JAX engine that this port does not serve yet
_UNPORTED_OPTIONS = {
    "draft_variant": "", "prompt_lookup_ngram": 0, "prefix_cache": False,
    "kv_page_size": 0, "kv_cache_layout": "standard", "pipe_microgroups": 0,
    "serve_logits": False, "copy_model_cycle": 0,
}


def build_generation_engine(cfg, device=None) -> GenerationEngine:
    """Config -> model -> engine, the part of the server that needs
    neither ``grpc`` nor ``yaml`` (``chip_smoke.py`` drives it directly).
    Raises ``NotImplementedError`` for non-decoder families and for engine
    options that are not ported yet; ``pin_cache_layouts`` is accepted as
    a no-op (a TPU layout workaround)."""
    from ..models.registry import build_model, get_family
    from ..utils.config import QuantMode

    opts = cfg.model.options
    definition = get_family(cfg.model.family, opts)
    if not definition.supports_generation:
        raise NotImplementedError(f"{cfg.model.family!r} is not a decoder family")
    for key, default in _UNPORTED_OPTIONS.items():
        if opts.get(key, default) != default:
            raise NotImplementedError(
                f"model option {key}={opts[key]!r} is not yet ported to the "
                "PyTorch engine (ROADMAP)"
            )
    if cfg.model.quantization in (QuantMode.W8A8, QuantMode.W4A8):
        raise NotImplementedError(
            f"quantization {cfg.model.quantization.value} needs kernels K2/K6, "
            "not yet ported (ROADMAP)"
        )
    if cfg.devices.mesh.size > 1:
        raise NotImplementedError("device meshes are not yet ported (ROADMAP)")
    model = build_model(cfg.model, seed=cfg.seed, device=device)
    return GenerationEngine(
        definition.spec,
        model.params,
        # as the JAX server: bf16 compute for BF16, f32 otherwise
        dtype=torch.bfloat16 if cfg.model.compute_dtype == "BF16" else torch.float32,
        num_slots=int(opts.get("num_slots", 8)),
        max_len=int(opts.get("max_len", 512)),
        prefill_buckets=list(opts.get("prefill_buckets", [32, 64, 128, 256])),
        steps_per_sync=int(opts.get("steps_per_sync", 1)),
        prefill_chunk=int(opts.get("prefill_chunk", 0)),
        decode_overlap=bool(opts.get("decode_overlap", True)),
        pipeline_depth=int(opts.get("decode_pipeline_depth", 2)),
        device=model.device,
    )
