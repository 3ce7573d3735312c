"""Overlapped decode dispatch in the port's generation engine.

Up to ``pipeline_depth`` blocks in flight, each chained off the previous
block's device carry, prefills landing only once a later block has been
consumed, and every fetch bounded by ``fetch_timeout_s``:

- greedy and seeded-sampling streams at depth 2 and 4 equal depth 1's,
  for the plain, speculative (draft model), prompt-lookup and paged
  engines, with chunked prefill and slot churn in the mix;
- greedy streams equal the JAX engine's with ``decode_overlap=True``;
- a cancellation while blocks are in flight, a request cancelled between
  its prefill's dispatch and its landing, ``stop()`` with blocks in
  flight (every token delivered, the stream resumes on restart), and a
  fetch that never completes (the open requests fail with
  ``RuntimeError``; the engine then serves the next request).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starpu_inference_server_tpu.models import decoder as jd
from starpu_inference_server_tpu.serving import generation as jgen
from starpu_inference_server_tpu_torch.models import decoder as td
from starpu_inference_server_tpu_torch.serving import generation as tgen

TINY = {"layers": 2, "hidden": 128, "q_heads": 4, "kv_heads": 2, "intermediate": 256,
        "vocab": 128}
DRAFT = {"layers": 1, "hidden": 64, "q_heads": 2, "kv_heads": 1, "intermediate": 128,
         "vocab": 128}


@pytest.fixture(scope="module")
def target():
    spec = jd.get_spec("llama-tiny", TINY)
    return spec, jd.init_params(spec, np.random.default_rng(0))


@pytest.fixture(scope="module")
def draft():
    spec = jd.get_spec("llama-tiny", DRAFT)
    return td.get_spec("llama-tiny", DRAFT), jd.init_params(spec, np.random.default_rng(1))


def _engine(target, depth, **kw):
    kw = dict(dict(num_slots=2, max_len=96, prefill_buckets=[8, 16], steps_per_sync=3,
                   prefill_chunk=16), **kw)
    return tgen.GenerationEngine(td.get_spec("llama-tiny", TINY), target[1],
                                 dtype=torch.float32, device="cpu", decode_overlap=depth > 1,
                                 pipeline_depth=depth, **kw)


def _requests():
    """Two greedy and two seeded-sampling requests; the 30-token prompt
    goes through chunked prefill, and four requests on two slots release
    and re-admit slots while blocks are in flight."""
    prompts = [[3, 7, 11, 3, 7, 11, 3], list(range(1, 31)), [5, 2, 9, 1, 13], [4, 8, 4, 8]]
    sampling = [dict(), dict(temperature=0.8, top_k=20, seed=123), dict(),
                dict(temperature=1.1, seed=7)]
    return [tgen.GenerationRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=14, **s)
            for p, s in zip(prompts, sampling)]


def _serve(eng, reqs):
    eng.start()
    try:
        for r in reqs:
            eng.submit(r)
        return [r.result(timeout=180) for r in reqs]
    finally:
        eng.stop()


CASES = {
    "plain": dict(),
    "speculative": dict(speculate_k=3, draft=True),
    "lookup": dict(speculate_k=3, prompt_lookup_ngram=2),
    "paged": dict(kv_page_size=8),
}
_DEPTH_1 = {}


@pytest.mark.parametrize("depth", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_streams_are_the_same_at_any_depth(target, draft, case, depth):
    kw = dict(CASES[case])
    if kw.pop("draft", False):
        kw.update(draft_spec=draft[0], draft_params=draft[1])
    if case not in _DEPTH_1:
        _DEPTH_1[case] = _serve(_engine(target, 1, **kw), _requests())
    eng = _engine(target, depth, **kw)
    assert eng.pipeline_depth == depth
    got = _serve(eng, _requests())
    assert got == _DEPTH_1[case]
    assert all(len(out) == 14 for out in got)
    timers = eng.loop_timers
    spans = tgen.LOOP_PHASES + tgen.REQUEST_SPANS
    assert set(timers) == set(spans) | {name + ".n" for name in tgen.COUNTED_SPANS}
    assert {"admit", "step", "land", "dispatch", "consume"} <= set(tgen.LOOP_PHASES)


@pytest.mark.parametrize("paged", [False, True])
def test_overlap_greedy_streams_match_jax_engine(target, paged):
    kw = dict(num_slots=2, max_len=96, prefill_buckets=[8, 16], steps_per_sync=3,
              prefill_chunk=16, decode_overlap=True, pipeline_depth=4)
    if paged:
        kw["kv_page_size"] = 8
    prompts = [np.asarray(p, np.int32) for p in ([3, 7, 11], list(range(1, 31)), [5, 2])]
    jeng = jgen.GenerationEngine(target[0], target[1], dtype=jnp.float32, **kw)
    jeng.start()
    try:
        jreqs = [jgen.GenerationRequest(prompt_ids=p, max_new_tokens=9) for p in prompts]
        for r in jreqs:
            jeng.submit(r)
        want = [r.result(timeout=180) for r in jreqs]
    finally:
        jeng.stop()
    eng = tgen.GenerationEngine(td.get_spec("llama-tiny", TINY), target[1], dtype=torch.float32,
                                device="cpu", **kw)
    got = _serve(eng, [tgen.GenerationRequest(prompt_ids=p, max_new_tokens=9) for p in prompts])
    assert got == want


def _solo(target, prompt, max_new):
    eng = _engine(target, 1, num_slots=1)
    return _serve(eng, [tgen.GenerationRequest(prompt_ids=np.asarray(prompt, np.int32),
                                               max_new_tokens=max_new)])[0]


def test_cancellation_while_blocks_are_in_flight(target):
    """A request cancelled from its own token hook, with three blocks
    chained behind the one being committed: it ends without an error and
    no later token of it is delivered; the slot's next occupant and the
    other slot keep their solo streams."""
    eng = _engine(target, 4, steps_per_sync=2)
    victim = tgen.GenerationRequest(prompt_ids=np.asarray([9, 9, 4], np.int32),
                                    max_new_tokens=40)
    seen = []

    def hook(tok):
        seen.append(tok)
        if len(seen) == 5:
            victim.cancel()

    victim.on_token = hook
    other = tgen.GenerationRequest(prompt_ids=np.asarray([5, 2, 9], np.int32), max_new_tokens=30)
    later = tgen.GenerationRequest(prompt_ids=np.asarray([1, 4, 6, 2], np.int32),
                                   max_new_tokens=12)
    eng.start()
    try:
        eng.submit(victim)
        eng.submit(other)
        victim.result(timeout=180)
        eng.submit(later)
        outs = [other.result(timeout=180), later.result(timeout=180)]
    finally:
        eng.stop()
    assert victim.error is None and 5 <= len(victim.tokens) < 40
    assert victim.tokens == seen[:len(victim.tokens)]
    assert len(seen) == len(victim.tokens)  # nothing delivered after the release
    assert outs == [_solo(target, [5, 2, 9], 30), _solo(target, [1, 4, 6, 2], 12)]
    assert eng.active_count() == 0 and not eng._inflight


def test_stop_delivers_every_in_flight_token_and_the_stream_resumes(target):
    eng = _engine(target, 4, num_slots=1, steps_per_sync=2)
    req = tgen.GenerationRequest(prompt_ids=np.asarray([3, 7, 11], np.int32), max_new_tokens=60)
    started = threading.Event()

    def hook(tok):
        if len(req.tokens) > 3 and not started.is_set():
            # what stop() does first, from the loop's own thread: the loop
            # ends after this block's commit, with blocks still in flight
            eng._stop.set()
            started.set()

    req.on_token = hook
    eng.start()
    eng.submit(req)
    assert started.wait(timeout=180)
    eng.stop()
    assert not eng._inflight and not req.done.is_set()
    # every dispatched block (all but the prefill's sequence number) was
    # committed: one token per step to the only slot, after the first
    assert eng.steps == eng.steps_per_sync * (eng._dispatch_seq - 1)
    assert len(req.tokens) == 1 + eng.steps
    eng.start()
    try:
        out = req.result(timeout=180)
    finally:
        eng.stop()
    assert out == _solo(target, [3, 7, 11], 60)


@pytest.mark.parametrize("paged", [False, True])
def test_cancel_between_prefill_dispatch_and_landing_frees_the_slot(target, paged):
    eng = _engine(target, 4, num_slots=1, **({"kv_page_size": 8} if paged else {}))
    req = eng.submit(tgen.GenerationRequest(prompt_ids=np.asarray([3, 7, 11], np.int32),
                                            max_new_tokens=8))
    eng._admit_pending()  # the prefill is dispatched, its landing queued
    assert eng._reserved == {0} and len(eng._landings) == 1
    assert not eng._land_prefills(force=False)  # no later block consumed yet
    req.cancel()
    assert eng._land_prefills(force=True)
    assert req.done.is_set() and req.tokens == [] and req.error is None
    assert not eng._reserved and eng.active_count() == 0 and int(eng.cache.lengths[0]) == 0
    if paged:
        assert eng.page_accounting()["free"] == eng.kv_pool_pages - 1
    assert _serve(eng, [tgen.GenerationRequest(prompt_ids=np.asarray([5, 2], np.int32),
                                               max_new_tokens=8)])[0] == _solo(target, [5, 2], 8)


@pytest.mark.parametrize("paged", [False, True])
def test_fetch_watchdog_fails_open_requests_and_the_engine_serves_on(target, paged):
    eng = _engine(target, 4, fetch_timeout_s=0.3, **({"kv_page_size": 8} if paged else {}))
    eng._fetch_ready = lambda event: False  # a fetch that never completes
    eng.start()
    try:
        reqs = [eng.submit(tgen.GenerationRequest(prompt_ids=np.asarray(p, np.int32),
                                                  max_new_tokens=8))
                for p in ([3, 7, 11], [5, 2, 9])]
        for r in reqs:
            with pytest.raises(RuntimeError, match="did not complete within 0.3 s"):
                r.result(timeout=60)
        del eng._fetch_ready  # the card answers again
        out = eng.generate(np.asarray([1, 4, 6], np.int32), max_new_tokens=8, timeout=60)
    finally:
        eng.stop()
    assert out == _solo(target, [1, 4, 6], 8)
    if paged:
        acct = eng.page_accounting()
        assert acct["free"] + acct["live"] + acct["retained"] + acct["garbage"] == acct["pool"]


def test_no_block_is_chained_past_every_slots_budget(target):
    """A block whose slots have all exhausted their budgets before it
    starts would compute nothing that is kept: the pump stops there."""
    eng = _engine(target, 4, steps_per_sync=4)
    out = _serve(eng, [tgen.GenerationRequest(prompt_ids=np.asarray([3, 7, 11], np.int32),
                                              max_new_tokens=6)])[0]
    assert out == _solo(target, [3, 7, 11], 6)
    # one prefill, then ceil((6 - 1) / 4) = 2 blocks, not the depth's 4
    assert eng._dispatch_seq == 3 and eng.steps == 8


# -- the greedy block's static buffers -------------------------------------------
#
# A snapshot with no sampled slot runs its blocks through the engine's
# static buffers (``_GreedyBlock``; on the card, one CUDA graph replay a
# block): inputs copied in, the carry left in the same buffers, which the
# records of chained blocks alias. On the CPU the body runs eagerly on
# them, so the chaining is held here.

LAYOUTS = {"standard": dict(), "flat": dict(kv_cache_layout="flat"),
           "paged": dict(kv_page_size=8)}


def _greedy_requests():
    prompts = [[3, 7, 11, 3, 7, 11, 3], list(range(1, 31)), [5, 2, 9, 1, 13], [4, 8, 4, 8],
               [9, 9, 2], list(range(40, 52))]
    return [tgen.GenerationRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=n)
            for p, n in zip(prompts, (14, 9, 17, 6, 12, 10))]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_streams_through_the_static_buffers_equal_depth_1(target, layout):
    """Greedy requests only, so every block goes through the static
    buffers: at depth 4 (three blocks chained off the buffers' carry
    while the host commits the oldest) the streams equal depth 1's, with
    slot churn (six requests on two slots) and a chunked prompt."""
    kw = LAYOUTS[layout]
    want = _serve(_engine(target, 1, **kw), _greedy_requests())
    eng = _engine(target, 4, **kw)
    got = _serve(eng, _greedy_requests())
    assert got == want
    assert [len(out) for out in got] == [14, 9, 17, 6, 12, 10]
    assert eng._greedy is not None and eng._greedy.graph is None  # no graph on the CPU


def _admitted(target, layout):
    eng = _engine(target, 4, steps_per_sync=3, **LAYOUTS[layout])
    for r in _greedy_requests()[:2]:
        eng.submit(r)
    eng._admit_pending()
    while eng._prefilling is not None:  # the chunked prompt
        eng._admit_pending()
    eng._land_prefills(force=True)
    assert eng.active_count() == 2
    return eng


def _cache_tensors(cache):
    out = [cache.lengths]
    for leaves in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        out.extend(leaves)
    if hasattr(cache, "table"):
        out.append(cache.table)
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_chained_greedy_blocks_equal_the_body_called_directly(target, layout):
    """Four blocks dispatched by hand, each chained off the last record's
    carry, which is the engine's static buffers; against the body
    (``_decode_and_sample``) called four times on a second engine in the
    same state, on fresh tensors: equal tokens, equal carry, equal cache
    bytes."""
    eng, ref = _admitted(target, layout), _admitted(target, layout)
    snap = eng._snapshot_active()
    assert snap["sample"] is None
    recs = [eng._dispatch_block(snap["ids_dev"], snap["progress_dev"], snap)]
    for chain in range(1, 4):
        last = recs[-1]
        recs.append(eng._dispatch_block(last["nxt"], last["prog"], snap, last["alive"], chain))
    block = eng._greedy
    for rec in recs:
        assert rec["nxt"] is block.ids and rec["prog"] is block.prog
        assert rec["alive"] is block.alive
    got = [eng._fetch(r["host"], r["event"]).copy() for r in recs]

    rsnap = ref._snapshot_active()
    ids, alive, prog = rsnap["ids_dev"], rsnap["active_dev"], rsnap["progress_dev"]
    want = []
    for _ in range(4):
        tokens, ids, prog, alive = ref._decode_and_sample(ids, alive, prog, rsnap)
        want.append(tokens.numpy().copy())
    assert ref._greedy is None  # the body alone, no static buffers
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(block.ids, ids) and torch.equal(block.prog, prog)
    assert torch.equal(block.alive, alive)
    for a, b in zip(_cache_tensors(eng.cache), _cache_tensors(ref.cache)):
        assert torch.equal(a, b)
