"""The paged KV cache and the prefix cache in the port vs the JAX package.

- K10 ``paged_decode_attention`` and K11 ``paged_window_decode_attention``
  (plain versions here) against the JAX kernels in interpret mode, on a
  shuffled page table, with a window that crosses a page.
- ``paged_prefill``, ``paged_prefill_chunk``, ``paged_decode_step`` and
  ``paged_verify_step`` against the JAX functions on the same table,
  kernel routes off and forced on (pages of 128 open the gate).
- The engine: greedy streams identical to the JAX engine's for the paged
  cache alone, with speculation, with prompt lookup and with the prefix
  cache, and for the dense prefix cache; pool exhaustion queues and
  recovers; refcounts settle after churn and after a cancellation
  storm; bad compositions are refused.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starpu_inference_server_tpu.models import decoder as jd
from starpu_inference_server_tpu.models import paged_decoder as jpd
from starpu_inference_server_tpu.ops import decode_attention as jda
from starpu_inference_server_tpu.ops import nn as jnn
from starpu_inference_server_tpu.serving import generation as jgen
from starpu_inference_server_tpu_torch.models import decoder as td
from starpu_inference_server_tpu_torch.models import paged_decoder as tpd
from starpu_inference_server_tpu_torch.ops import decode_attention as tda
from starpu_inference_server_tpu_torch.ops import nn as tnn
from starpu_inference_server_tpu_torch.serving import generation as tgen
from starpu_inference_server_tpu_torch.weights import params_from_numpy

TINY = {"layers": 2, "hidden": 128, "q_heads": 4, "kv_heads": 2,
        "intermediate": 256, "vocab": 128}
PAGE = 8


def _t(a):
    return torch.from_numpy(np.array(a))


# -- K10 / K11 -------------------------------------------------------------------

def _paged_case(s, w, page, pps, seed):
    """A dense [S, T] cache scattered into a shuffled pool (page 0 is the
    garbage page), q [S, W, Hq, D]; slot 0's window crosses a page."""
    rng = np.random.default_rng(seed)
    hkv, rep, d = 2, 2, 64
    t = page * pps
    q = rng.standard_normal((s, w, hkv * rep, d)).astype(np.float32)
    k = rng.integers(-127, 128, (s, t, hkv, d)).astype(np.int8)
    v = rng.integers(-127, 128, (s, t, hkv, d)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, (s, t, hkv)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (s, t, hkv)).astype(np.float32)
    lengths = rng.integers(0, t - w + 1, (s,)).astype(np.int32)
    lengths[0] = page - 2
    n = s * pps + 1
    table = (rng.permutation(np.arange(1, n)).reshape(s, pps)).astype(np.int32)
    pool = [np.zeros((n, page) + a.shape[2:], a.dtype) for a in (k, v, ks, vs)]
    for i in range(s):
        for j in range(pps):
            for dst, src in zip(pool, (k, v, ks, vs)):
                dst[table[i, j]] = src[i, j * page:(j + 1) * page]
    return q, pool, table, lengths, rep


@pytest.mark.parametrize("s,page,pps", [(3, 128, 2), (16, 16, 8)])
def test_paged_decode_attention_matches_jax_kernel(s, page, pps):
    q, pool, table, lengths, rep = _paged_case(s, 1, page, pps, seed=s)
    jda.set_interpret(True)
    try:
        want = np.asarray(jda.paged_decode_attention(
            jnp.asarray(q[:, 0]), *(jnp.asarray(a) for a in pool), jnp.asarray(table),
            jnp.asarray(lengths), rep=rep))
    finally:
        jda.set_interpret(False)
    got = tda.paged_decode_attention(_t(q[:, 0]), *(_t(a) for a in pool), _t(table),
                                     _t(lengths), rep=rep)
    # the JAX package's own tolerance (test_decode_attention.py:209)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    assert tda.launches["paged_decode_attention"] == 0


@pytest.mark.parametrize("s,w,page,pps", [(2, 4, 128, 2), (5, 9, 16, 8)])
def test_paged_window_decode_attention_matches_jax_kernel(s, w, page, pps):
    q, pool, table, lengths, rep = _paged_case(s, w, page, pps, seed=s + w)
    # slot 0's window (rows page-2 .. page-2+w-1) crosses into its next page
    assert (lengths[0] + w - 1) // page == 1
    jda.set_interpret(True)
    try:
        want = np.asarray(jda.paged_window_decode_attention(
            jnp.asarray(q), *(jnp.asarray(a) for a in pool), jnp.asarray(table),
            jnp.asarray(lengths), rep=rep, out_dtype=jnp.float32))
    finally:
        jda.set_interpret(False)
    got = tda.paged_window_decode_attention(_t(q), *(_t(a) for a in pool), _t(table),
                                            _t(lengths), rep=rep)
    # the JAX package's own tolerance (test_decode_attention.py:234)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    assert tda.launches["paged_window_decode_attention"] == 0


# -- the paged model functions ---------------------------------------------------------

PAGED_SPEC = {"layers": 2, "hidden": 256, "q_heads": 4, "kv_heads": 2,
              "intermediate": 96, "vocab": 64}


def _run_paged_model(pkg, params, kernels, page, rng):
    """Prefill two slots (bucket path, then one chunk of slot 1 at
    page-aligned start), one decode step, one verify window crossing a
    page; returns every logits array and the final lengths."""
    spec = (jd if pkg == "jax" else td).get_spec("llama-tiny", PAGED_SPEC)
    t_max = 2 * page if page >= 128 else 4 * page
    pps = t_max // page
    rows = ([2, 4] + list(range(6, 6 + pps - 2)), [3, 1] + list(range(6 + pps, 4 + 2 * pps)))
    n_pages = 6 + 2 * pps
    prompts = [rng.integers(0, 64, (8,)).astype(np.int32) for _ in range(2)]
    chunk = rng.integers(0, 64, (page,)).astype(np.int32)
    ids = rng.integers(0, 64, (2,)).astype(np.int32)
    window = rng.integers(0, 64, (2, 5)).astype(np.int32)
    active = np.array([True, True])
    out = []
    if pkg == "jax":
        cache = jpd.init_paged_cache(spec, 2, t_max, num_pages=n_pages, page_size=page)
        for slot, row in enumerate(rows):
            cache = jpd.set_table_row(cache, jnp.int32(slot), jnp.asarray(row, jnp.int32))
        for slot, length in ((0, 6), (1, 3)):
            cache, lg = jpd.paged_prefill(spec, params, cache, jnp.asarray(prompts[slot]),
                                          jnp.int32(length), jnp.int32(slot), jnp.float32)
            out.append(np.asarray(lg))
        cache, lg = jpd.paged_prefill_chunk(spec, params, cache, jnp.asarray(chunk),
                                            jnp.int32(page), jnp.int32(page - 3), jnp.int32(1),
                                            jnp.float32)
        out.append(np.asarray(lg))
        cache, lg = jpd.paged_decode_step(spec, params, cache, jnp.asarray(ids),
                                          jnp.asarray(active), jnp.float32)
        out.append(np.asarray(lg))
        cache = cache._replace(lengths=jnp.asarray([page - 2, page + 5], jnp.int32))
        cache, lg = jpd.paged_verify_step(spec, params, cache, jnp.asarray(window),
                                          jnp.asarray(active), jnp.float32)
        out.append(np.asarray(lg))
        return out, np.asarray(cache.lengths)
    tparams = params_from_numpy(params)
    cache = tpd.init_paged_cache(spec, 2, t_max, num_pages=n_pages, page_size=page)
    for slot, row in enumerate(rows):
        tpd.set_table_row(cache, slot, row)
    for slot, length in ((0, 6), (1, 3)):
        _, lg = tpd.paged_prefill(spec, tparams, cache, _t(prompts[slot]), length, slot,
                                  torch.float32)
        out.append(lg.numpy())
    _, lg = tpd.paged_prefill_chunk(spec, tparams, cache, _t(chunk), page, page - 3, 1,
                                    torch.float32)
    out.append(lg.numpy())
    _, lg = tpd.paged_decode_step(spec, tparams, cache, _t(ids), _t(active), torch.float32)
    out.append(lg.numpy())
    cache.lengths.copy_(torch.tensor([page - 2, page + 5], dtype=torch.int32))
    _, lg = tpd.paged_verify_step(spec, tparams, cache, _t(window), _t(active), torch.float32)
    out.append(lg.numpy())
    return out, cache.lengths.numpy()


@pytest.mark.parametrize("kernels,page", [(False, 16), (False, 128), (True, 128)])
def test_paged_model_functions_match_jax(kernels, page):
    """Pages of 128 open both packages' paged-kernel gate: with kernels
    forced on, K10 / K11 run (plain versions here, the JAX kernels in
    interpret mode)."""
    params = jd.init_params(jd.get_spec("llama-tiny", PAGED_SPEC), np.random.default_rng(8))
    jnn.set_use_pallas(kernels)
    jda.set_interpret(kernels)
    tnn.set_use_kernels(kernels)
    try:
        want, want_len = _run_paged_model("jax", params, kernels, page, np.random.default_rng(9))
        got, got_len = _run_paged_model("torch", params, kernels, page, np.random.default_rng(9))
    finally:
        jnn.set_use_pallas(False)
        jda.set_interpret(False)
        tnn.set_use_kernels(None)
    np.testing.assert_array_equal(got_len, want_len)
    for g, w in zip(got, want):
        # kernels on vs off in the JAX package: 2e-4 (test_decode_attention.py:286)
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


def test_paged_decode_step_matches_dense_on_same_contents():
    """The same prompt prefilled into a dense cache and a paged one gives
    the same decode logits (the paged path is a relayout)."""
    spec = td.get_spec("llama-tiny", PAGED_SPEC)
    params = params_from_numpy(jd.init_params(jd.get_spec("llama-tiny", PAGED_SPEC),
                                              np.random.default_rng(8)))
    prompt = _t(np.random.default_rng(1).integers(0, 64, (16,)).astype(np.int32))
    dense = td.init_cache(spec, 1, 64)
    paged = tpd.init_paged_cache(spec, 1, 64, num_pages=9, page_size=8)
    tpd.set_table_row(paged, 0, [5, 2, 7, 1, 3, 8, 4, 6])
    td.prefill(spec, params, dense, prompt, 13, 0, torch.float32)
    tpd.paged_prefill(spec, params, paged, prompt, 13, 0, torch.float32)
    ids, act = torch.tensor([7], dtype=torch.int32), torch.tensor([True])
    for _ in range(3):
        _, a = td.decode_step(spec, params, dense, ids, act, torch.float32)
        _, b = tpd.paged_decode_step(spec, params, paged, ids, act, torch.float32)
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-6)
        ids = a.argmax(-1).to(torch.int32)


# -- the engine ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def target():
    spec = jd.get_spec("llama-tiny", TINY)
    return spec, jd.init_params(spec, np.random.default_rng(0))


def _engine(pkg, target, **kw):
    spec, params = target
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_buckets", [8, 16, 32])
    kw.setdefault("steps_per_sync", 2)
    if pkg == "jax":
        eng = jgen.GenerationEngine(spec, params, dtype=jnp.float32, **kw)
    else:
        if "draft_spec" in kw:
            kw["draft_spec"] = td.get_spec("llama-tiny", TINY)
        eng = tgen.GenerationEngine(td.get_spec("llama-tiny", TINY), params,
                                    dtype=torch.float32, device="cpu", **kw)
    eng.start()
    return eng


def _drain(eng, prompts, max_new=8):
    mod = jgen if isinstance(eng, jgen.GenerationEngine) else tgen
    try:
        reqs = [mod.GenerationRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=max_new)
                for p in prompts]
        for r in reqs:
            eng.submit(r)
        return [r.result(timeout=180) for r in reqs]
    finally:
        eng.stop()


SYSTEM = np.arange(1, 25, dtype=np.int32)  # a 24-token shared prefix


def _shared_prompts(n=4):
    return [np.concatenate([SYSTEM, np.asarray([40 + i, 50 + i], np.int32)]) for i in range(n)]


def _settled(eng):
    """Every pool page accounted exactly once after the engine went idle."""
    deadline = time.time() + 10
    while time.time() < deadline and eng.active_count():
        time.sleep(0.05)
    granted = [p for pages in eng._slot_pages for p in pages]
    free = list(eng._free_pages)
    assert sorted(set(free)) == sorted(free)  # no double free
    for p in free:
        assert eng._page_refs[p] == 0, p
    for p in set(granted):
        assert eng._page_refs[p] == granted.count(p)
    assert len(set(free) | set(granted)) == eng.kv_pool_pages - 1
    acct = eng.page_accounting()
    assert acct["free"] + acct["live"] + acct["retained"] + acct["garbage"] == acct["pool"]


CASES = {
    "paged": dict(kv_page_size=PAGE),
    "paged_chunked": dict(kv_page_size=PAGE, prefill_chunk=16),
    "paged_speculative": dict(kv_page_size=PAGE, speculate_k=3, draft=True),
    "paged_lookup": dict(kv_page_size=PAGE, speculate_k=3, prompt_lookup_ngram=2,
                         kv_pool_pages=17),
    "paged_prefix": dict(kv_page_size=PAGE, prefill_chunk=16, prefix_cache=True,
                         prefix_cache_min=PAGE),
    "paged_prefix_lookup": dict(kv_page_size=PAGE, prefill_chunk=16, prefix_cache=True,
                                prefix_cache_min=PAGE, speculate_k=3, prompt_lookup_ngram=2),
    "dense_prefix": dict(prefill_chunk=16, prefix_cache=True, prefix_cache_min=PAGE),
    "dense_prefix_speculative": dict(prefill_chunk=16, prefix_cache=True,
                                     prefix_cache_min=PAGE, speculate_k=2, draft=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_streams_match_jax_engine(target, case):
    kw = dict(CASES[case])
    if kw.pop("draft", False):
        kw.update(draft_spec=target[0], draft_params=target[1])
    prefix = kw.get("prefix_cache", False)
    prompts = _shared_prompts() if prefix else [[3, 7, 11], [5, 2, 9, 1, 13], [1, 4],
                                                np.arange(1, 29)]
    if not kw.get("prefill_chunk"):
        prompts = prompts[:3]  # the 28-token prompt needs chunked prefill

    def run(pkg):
        eng = _engine(pkg, target, **dict(kw))
        if prefix:
            # one by one, so each prompt finds the previous one's prefix
            try:
                out = [eng.generate(np.asarray(p, np.int32), max_new_tokens=6, timeout=180)
                       for p in prompts]
            finally:
                eng.stop()
        else:
            out = _drain(eng, prompts)
        return out, eng

    want, _ = run("jax")
    got, eng = run("torch")
    assert got == want
    if prefix:
        assert eng.prefix_hits >= 1
        if eng.kv_page_size:
            # paged reuse is rounded down to whole pages
            assert eng.prefix_tokens_reused % PAGE == 0
    if eng.kv_page_size:
        _settled(eng)


def test_pool_exhaustion_queues_and_recovers(target):
    """A pool for about one request at a time: later requests wait for
    pages, all complete in order with their solo-run tokens."""
    prompts = [[i + 2, i + 5, i + 1] for i in range(4)]
    solo = [_drain(_engine("torch", target, kv_page_size=PAGE, num_slots=1), [p], 6)[0]
            for p in prompts]
    eng = _engine("torch", target, kv_page_size=PAGE, kv_pool_pages=4)
    assert _drain(eng, prompts, 6) == solo
    assert sorted(eng._free_pages) == [1, 2, 3]


@pytest.mark.parametrize("paged", [False, True])
def test_prefix_hit_on_a_decoding_source(target, paged):
    """A hit whose source slot is still decoding: the dense cache copies
    the source's rows before its next write, the paged cache shares its
    whole prefix pages (refcount 2) while the source appends to pages of
    its own; both streams equal their solo runs, and after churn every
    page is accounted once."""
    kw = dict(prefill_chunk=16, prefix_cache=True, prefix_cache_min=PAGE)
    if paged:
        kw.update(kv_page_size=PAGE, kv_pool_pages=17)
    a_prompt, b_prompt = _shared_prompts()[:2]
    solo = [_drain(_engine("torch", target, num_slots=1, **kw), [p], n)[0]
            for p, n in ((a_prompt, 30), (b_prompt, 4))]
    eng = _engine("torch", target, **kw)
    try:
        started = []
        first = tgen.GenerationRequest(prompt_ids=a_prompt, max_new_tokens=30,
                                       on_token=started.append)
        eng.submit(first)
        deadline = time.time() + 60
        while len(started) < 3 and time.time() < deadline:
            time.sleep(0.01)  # first is decoding in its slot
        assert eng.generate(b_prompt, max_new_tokens=4) == solo[1]
        assert eng.prefix_hits == 1 and not first.done.is_set()
        if paged:
            grants = [set(p) for p in eng._slot_pages if p]
            shared = grants[0] & grants[1]
            assert len(shared) == 24 // PAGE  # the whole-page prefix, zero copy
            assert all(eng._page_refs[p] == 2 for p in shared)
        assert first.result(timeout=120) == solo[0]
        for p in _shared_prompts() * 2:  # churn
            eng.generate(p, max_new_tokens=5)
        if paged:
            _settled(eng)
    finally:
        eng.stop()


def test_cancellation_storm_keeps_refcounts_sane(target):
    eng = _engine("torch", target, kv_page_size=PAGE, prefill_chunk=16, prefix_cache=True,
                  prefix_cache_min=PAGE, kv_pool_pages=24)
    try:
        reqs = [tgen.GenerationRequest(prompt_ids=p, max_new_tokens=8)
                for p in _shared_prompts() * 3]
        timers = []
        for i, r in enumerate(reqs):
            eng.submit(r)
            if i % 3 == 0:
                timers.append(threading.Timer(0.01 * (i % 5), r.cancel))
                timers[-1].start()
        for r in reqs:
            r.done.wait(180)
            assert r.done.is_set() and r.error is None
        for tm in timers:
            tm.join()
        _settled(eng)
        assert len(eng.generate(_shared_prompts()[0], max_new_tokens=4)) == 4
    finally:
        eng.stop()


def test_a_request_larger_than_the_pool_is_refused_at_the_door(target):
    """A request whose grant exceeds the whole pool could never be
    admitted, and admission is FIFO: the JAX engine requeues it forever
    and every later request waits behind it (ROADMAP queue 3). The port
    refuses it at submit and keeps serving."""
    eng = _engine("torch", target, kv_page_size=PAGE, kv_pool_pages=5)  # 4 usable pages
    try:
        with pytest.raises(ValueError, match="needs 5 pages"):
            eng.submit(tgen.GenerationRequest(prompt_ids=np.arange(1, 27, dtype=np.int32),
                                              max_new_tokens=10))
        fits = eng.generate(np.arange(1, 27, dtype=np.int32), max_new_tokens=6)
        assert len(fits) == 6
    finally:
        eng.stop()


def test_engine_refuses_bad_compositions(target):
    spec, params = td.get_spec("llama-tiny", TINY), target[1]
    with pytest.raises(ValueError, match="multiple of kv_page_size"):
        tgen.GenerationEngine(spec, params, device="cpu", max_len=64, kv_page_size=8,
                              prefill_chunk=4)
    with pytest.raises(ValueError, match="must divide"):
        tgen.GenerationEngine(spec, params, device="cpu", max_len=60, kv_page_size=8)
    with pytest.raises(ValueError, match="requires chunked prefill"):
        tgen.GenerationEngine(spec, params, device="cpu", max_len=64, prefix_cache=True)


def test_chunk_past_max_len_writes_only_the_rows_that_fit():
    """A dense prefix-cache hit can start a chunk so late that its padded
    rows run past max_len. The port writes only the rows that fit; the
    JAX package's ``dynamic_update_slice`` clamps the start instead and
    shifts the whole chunk down over earlier prompt rows (ROADMAP queue
    3). Here a 60-token prompt in a 64-row cache: 40 rows prefilled, then
    the last 20 tokens as a 32-row chunk at 40. The port gives the
    logits of a 20-row chunk that fits, as the JAX package does for
    that chunk; the JAX package's 32-row chunk does not."""
    spec_j = jd.get_spec("llama-tiny", TINY)
    spec_t = td.get_spec("llama-tiny", TINY)
    raw = jd.init_params(spec_j, np.random.default_rng(0))
    params = params_from_numpy(raw)
    prompt = np.random.default_rng(5).integers(0, 128, 60).astype(np.int32)
    first = prompt[:40].copy()
    long_chunk = np.zeros((32,), np.int32)
    long_chunk[:20] = prompt[40:]
    fitting = prompt[40:].copy()

    def port(chunk):
        cache = td.init_cache(spec_t, 1, 64)
        td.prefill_chunk(spec_t, params, cache, _t(first), 0, 40, 0, torch.float32)
        return td.prefill_chunk(spec_t, params, cache, _t(chunk), 40, 20, 0,
                                torch.float32)[1].numpy()

    def jax_pkg(chunk):
        cache = jd.init_cache(spec_j, 1, 64)
        cache, _ = jd.prefill_chunk(spec_j, raw, cache, jnp.asarray(first), jnp.int32(0),
                                    jnp.int32(40), jnp.int32(0), jnp.float32)
        return np.asarray(jd.prefill_chunk(spec_j, raw, cache, jnp.asarray(chunk), jnp.int32(40),
                                           jnp.int32(20), jnp.int32(0), jnp.float32)[1])

    want = port(fitting)
    # f32 sums over 12 masked (zero-weight) keys more: rounding only
    np.testing.assert_allclose(port(long_chunk), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(jax_pkg(fitting), want, rtol=5e-3, atol=5e-3)
    assert np.abs(jax_pkg(long_chunk) - want).max() > 5e-2
