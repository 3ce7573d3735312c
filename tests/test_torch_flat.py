"""The FLAT KV-cache layout in the port vs the JAX package.

- K12: the four flat kernels' entry points (plain versions here, on CPU
  tensors) against the JAX flat kernels in interpret mode, at the JAX
  tests' tolerance (``tests/unit/test_flat_cache.py``), on a shuffled page
  table with a window that crosses a page.
- The model functions on a flat cache (dense ``prefill`` /
  ``prefill_chunk`` / ``decode_step`` / ``verify_step``, and the paged
  ones on flat pools) against the JAX functions on flat caches, with the
  kernel routes off and forced on, at 2e-4.
- The engine: greedy streams on the flat layout equal the standard
  layout's and the JAX flat engine's, dense and paged with the prefix
  cache; the refused compositions raise ``ValueError``.
"""

import dataclasses
from pathlib import Path

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
from starpu_inference_server_tpu_torch.utils import config as tcfg
from starpu_inference_server_tpu_torch.weights import params_from_numpy

ROOT = Path(__file__).resolve().parent.parent


def _t(a):
    return torch.from_numpy(np.array(a))


def _flatten(k, v, ks, vs):
    """Standard [.., T, H, D] arrays -> flat layout arrays (as
    tests/unit/test_flat_cache.py does)."""
    return (k.reshape(k.shape[:-2] + (-1,)), v.reshape(v.shape[:-2] + (-1,)),
            np.swapaxes(ks, -1, -2).copy(), np.swapaxes(vs, -1, -2).copy())


def _interpret(fn):
    jda.set_interpret(True)
    try:
        return np.asarray(fn())
    finally:
        jda.set_interpret(False)


# -- K12: the four flat kernels ------------------------------------------------------

def _dense_case(s, w, t, seed, hkv=2, rep=2, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((s, w, hkv * rep, d)).astype(np.float32)
    k = rng.integers(-127, 128, (s, t, hkv, d)).astype(np.int8)
    v = rng.integers(-127, 128, (s, t, hkv, d)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, (s, t, hkv)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (s, t, hkv)).astype(np.float32)
    lengths = rng.integers(0, t - w + 1, (s,)).astype(np.int32)
    lengths[0], lengths[-1] = 0, t - w
    return q, (k, v, ks, vs), lengths, rep


@pytest.mark.parametrize("s", [2, 16])
def test_flat_decode_attention_matches_jax_kernel(s):
    q, cache, lengths, rep = _dense_case(s, 1, 128, seed=s)
    flat = _flatten(*cache)
    want = _interpret(lambda: jda.decode_attention(
        jnp.asarray(q[:, 0]), *(jnp.asarray(a) for a in flat), jnp.asarray(lengths), rep=rep,
        chunk=64))
    got = tda.flat_decode_attention(_t(q[:, 0]), *(_t(a) for a in flat), _t(lengths), rep)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    # the standard entry point takes a 3-D cache as flat, as in JAX
    via = tda.decode_attention(_t(q[:, 0]), *(_t(a) for a in flat), _t(lengths), rep)
    assert torch.equal(via, got)
    assert tda.launches["flat_decode_attention"] == 0  # CPU: the plain version


@pytest.mark.parametrize("s,w", [(16, 5), (3, 9)])
def test_flat_window_decode_attention_matches_jax_kernel(s, w):
    q, cache, lengths, rep = _dense_case(s, w, 256, seed=s + w)
    flat = _flatten(*cache)
    want = _interpret(lambda: jda.window_decode_attention(
        jnp.asarray(q), *(jnp.asarray(a) for a in flat), jnp.asarray(lengths), rep=rep,
        out_dtype=jnp.float32))
    got = tda.window_decode_attention(_t(q), *(_t(a) for a in flat), _t(lengths), rep)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    assert tda.launches["flat_window_decode_attention"] == 0


def _paged_case(s, w, page, pps, seed):
    """A dense [S, T] cache scattered into a shuffled pool (page 0 is the
    garbage page), flattened; slot 0's window crosses a page."""
    q, (k, v, ks, vs), lengths, rep = _dense_case(s, w, page * pps, seed)
    rng = np.random.default_rng(seed + 100)
    lengths[0] = page - 2
    n = s * pps + 1
    table = rng.permutation(np.arange(1, n)).reshape(s, pps).astype(np.int32)
    pool = [np.zeros((n, page) + a.shape[2:], a.dtype) for a in (k, v, ks, vs)]
    for i in range(s):
        for j in range(pps):
            for dst, src in zip(pool, (k, v, ks, vs)):
                dst[table[i, j]] = src[i, j * page:(j + 1) * page]
    return q, _flatten(*pool), table, lengths, rep


@pytest.mark.parametrize("s,w,page,pps", [(3, 1, 128, 2), (5, 1, 16, 8), (2, 4, 128, 2),
                                          (5, 9, 16, 8)])
def test_flat_paged_attention_matches_jax_kernel(s, w, page, pps):
    q, pool, table, lengths, rep = _paged_case(s, w, page, pps, seed=s * w + page)
    assert (lengths[0] + w - 1) // page == (1 if w > 2 else 0)
    if w == 1:
        q = q[:, 0]
        jfn, tfn, name = (jda.paged_decode_attention, tda.paged_decode_attention,
                          "flat_paged_decode_attention")
    else:
        jfn, tfn, name = (jda.paged_window_decode_attention, tda.paged_window_decode_attention,
                          "flat_paged_window_decode_attention")
    want = _interpret(lambda: jfn(jnp.asarray(q), *(jnp.asarray(a) for a in pool),
                                  jnp.asarray(table), jnp.asarray(lengths), rep=rep,
                                  out_dtype=jnp.float32))
    got = tfn(_t(q), *(_t(a) for a in pool), _t(table), _t(lengths), rep)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    assert torch.equal(getattr(tda, name)(_t(q), *(_t(a) for a in pool), _t(table),
                                          _t(lengths), rep), got)
    assert tda.launches[name] == 0


def test_flat_kernels_refuse_mismatched_scales():
    q, cache, lengths, rep = _dense_case(2, 1, 64, seed=0)
    k, v, ks, vs = _flatten(*cache)
    with pytest.raises(ValueError, match="flat cache"):
        # standard-shaped scales [S, T, Hkv] beside a flat K/V
        tda.flat_decode_attention(_t(q[:, 0]), _t(k), _t(v), _t(cache[2]), _t(cache[3]),
                                  _t(lengths), rep)


# -- the model functions on a flat cache ---------------------------------------------

SPEC = {"layers": 2, "hidden": 256, "q_heads": 4, "kv_heads": 2, "intermediate": 96,
        "vocab": 64}


def _drive_dense(pkg, params, flat, rng):
    """Prefill two slots (bucket path), a chunk of slot 1 that reads back
    its prompt rows, three decode steps and a verify window; returns
    every logits array and the final lengths."""
    spec = (jd if pkg == "jax" else td).get_spec("llama-tiny", SPEC)
    prompts = []
    for length in (6, 3):
        p = np.zeros((8,), np.int32)
        p[:length] = rng.integers(0, 64, (length,))
        prompts.append((p, length))
    chunk = rng.integers(0, 64, (32,)).astype(np.int32)
    steps = [rng.integers(0, 64, (2,)).astype(np.int32) for _ in range(3)]
    window = rng.integers(0, 64, (2, 4)).astype(np.int32)
    active = np.array([True, True])
    out = []
    if pkg == "jax":
        cache = jd.init_cache(spec, 2, 128, flat=flat)
        assert cache.flat == flat
        for slot, (p, length) in enumerate(prompts):
            cache, lg = jd.prefill(spec, params, cache, jnp.asarray(p), jnp.int32(length),
                                   jnp.int32(slot), jnp.float32)
            out.append(np.asarray(lg))
        cache, lg = jd.prefill_chunk(spec, params, cache, jnp.asarray(chunk), jnp.int32(3),
                                     jnp.int32(20), jnp.int32(1), jnp.float32)
        out.append(np.asarray(lg))
        for ids in steps:
            cache, lg = jd.decode_step(spec, params, cache, jnp.asarray(ids),
                                       jnp.asarray(active), jnp.float32)
            out.append(np.asarray(lg))
        _, lg = jd.verify_step(spec, params, cache, jnp.asarray(window), jnp.asarray(active),
                               jnp.float32)
        out.append(np.asarray(lg))
        return out, np.asarray(cache.lengths)
    tparams = params_from_numpy(params)
    cache = td.init_cache(spec, 2, 128, flat=flat)
    assert cache.flat == flat
    for slot, (p, length) in enumerate(prompts):
        _, lg = td.prefill(spec, tparams, cache, _t(p), length, slot, torch.float32)
        out.append(lg.numpy())
    _, lg = td.prefill_chunk(spec, tparams, cache, _t(chunk), 3, 20, 1, torch.float32)
    out.append(lg.numpy())
    for ids in steps:
        _, lg = td.decode_step(spec, tparams, cache, _t(ids), _t(active), torch.float32)
        out.append(lg.numpy())
    _, lg = td.verify_step(spec, tparams, cache, _t(window), _t(active), torch.float32)
    out.append(lg.numpy())
    return out, cache.lengths.numpy()


def _drive_paged(pkg, params, flat, rng, page=128):
    """The paged functions on two slots of a shuffled table: bucket
    prefills, a page-aligned chunk of slot 1, a decode step and a verify
    window that crosses slot 0's first page."""
    spec = (jd if pkg == "jax" else td).get_spec("llama-tiny", SPEC)
    rows = ([2, 4], [3, 1])
    prompts = [rng.integers(0, 64, (8,)).astype(np.int32) for _ in range(2)]
    chunk = rng.integers(0, 64, (page,)).astype(np.int32)
    ids = rng.integers(0, 64, (2,)).astype(np.int32)
    window = rng.integers(0, 64, (2, 5)).astype(np.int32)
    active = np.array([True, True])
    lengths = [page - 2, page + 5]
    out = []
    if pkg == "jax":
        cache = jpd.init_paged_cache(spec, 2, 2 * page, num_pages=5, page_size=page, flat=flat)
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
        cache = cache._replace(lengths=jnp.asarray(lengths, jnp.int32))
        cache, lg = jpd.paged_verify_step(spec, params, cache, jnp.asarray(window),
                                          jnp.asarray(active), jnp.float32)
        out.append(np.asarray(lg))
        return out, np.asarray(cache.lengths)
    tparams = params_from_numpy(params)
    cache = tpd.init_paged_cache(spec, 2, 2 * page, num_pages=5, page_size=page, flat=flat)
    assert cache.flat == flat
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
    cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    _, lg = tpd.paged_verify_step(spec, tparams, cache, _t(window), _t(active), torch.float32)
    out.append(lg.numpy())
    return out, cache.lengths.numpy()


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("drive", ["dense", "paged"])
def test_flat_model_functions_match_jax(drive, kernels):
    """Flat caches in both packages; with the routes forced on, the JAX
    flat kernels (interpret mode) against the port's flat plain versions
    (max_len and pages of 128 open both gates)."""
    fn = _drive_dense if drive == "dense" else _drive_paged
    params = jd.init_params(jd.get_spec("llama-tiny", SPEC), np.random.default_rng(8))
    # inputs on which no int8 K/V entry sits on a rounding boundary: with
    # seed 9 the dense drive's layer-1 V rounds one entry to the
    # neighbouring level in the port (an f32 ulp apart from XLA), and the
    # decode logits then differ by 5.7e-4, in both layouts alike
    seed = 10
    jnn.set_use_pallas(kernels)
    jda.set_interpret(kernels)
    tnn.set_use_kernels(kernels)
    try:
        want, want_len = fn("jax", params, True, np.random.default_rng(seed))
        got, got_len = fn("torch", params, True, np.random.default_rng(seed))
        std, _ = fn("torch", params, False, np.random.default_rng(seed))
    finally:
        jnn.set_use_pallas(False)
        jda.set_interpret(False)
        tnn.set_use_kernels(None)
    np.testing.assert_array_equal(got_len, want_len)
    for g, w, s in zip(got, want, std):
        # the JAX package's flat-vs-standard tolerance (test_flat_cache.py)
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
        # flat and standard caches hold the same numbers: equal logits
        np.testing.assert_array_equal(g, s)


def test_flat_chunk_past_max_len_writes_only_the_rows_that_fit():
    """The port's clamp holds for flat caches: a chunk that starts near
    the end of the context writes only the rows that fit, and scores as
    the same tokens in a chunk that fits."""
    spec = td.get_spec("llama-tiny", SPEC)
    params = params_from_numpy(jd.init_params(jd.get_spec("llama-tiny", SPEC),
                                              np.random.default_rng(8)))
    prompt = np.random.default_rng(2).integers(0, 64, (60,)).astype(np.int32)

    def run(chunk):
        cache = td.init_cache(spec, 1, 64, flat=True)
        td.prefill_chunk(spec, params, cache, _t(prompt[:40]), 0, 40, 0, torch.float32)
        ids = np.zeros((chunk,), np.int32)
        ids[:20] = prompt[40:]
        _, lg = td.prefill_chunk(spec, params, cache, _t(ids), 40, 20, 0, torch.float32)
        return lg.numpy(), cache

    fit, _ = run(20)
    over, cache = run(32)
    np.testing.assert_allclose(over, fit, rtol=1e-5, atol=1e-5)
    assert int(cache.lengths[0]) == 60


def test_inactive_slots_park_their_flat_writes_at_the_last_row():
    spec = td.get_spec("llama-tiny", SPEC)
    params = params_from_numpy(jd.init_params(jd.get_spec("llama-tiny", SPEC),
                                              np.random.default_rng(8)))
    cache = td.init_cache(spec, 2, 32, flat=True)
    td.prefill(spec, params, cache, _t(np.arange(1, 9, dtype=np.int32)), 8, 1, torch.float32)
    before = [a[1].clone() for a in (cache.k[0], cache.k_scale[0])]
    td.decode_step(spec, params, cache, _t(np.array([3, 4], np.int32)),
                   _t(np.array([True, False])), torch.float32)
    # slot 1 was inactive: only its row t_max - 1 may change
    assert torch.equal(cache.k[0][1, :31], before[0][:31])
    assert torch.equal(cache.k_scale[0][1, :, :31], before[1][:, :31])
    assert cache.lengths.tolist() == [1, 8]


def test_slot_rows_copy_over_a_flat_cache():
    """The dense prefix cache's device copy walks the per-layer leaves on
    the slot axis, which the flat layout keeps first too."""
    spec = td.get_spec("llama-tiny", SPEC)
    params = params_from_numpy(jd.init_params(jd.get_spec("llama-tiny", SPEC),
                                              np.random.default_rng(8)))
    cache = td.init_cache(spec, 3, 32, flat=True)
    td.prefill(spec, params, cache, _t(np.arange(1, 9, dtype=np.int32)), 8, 0, torch.float32)
    tgen._copy_slot_rows(cache, 0, 2)
    for leaves in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        for a in leaves:
            assert torch.equal(a[2], a[0]) and a[0].abs().sum() > 0 and not a[1].any()


def test_stacked_flat_cache_is_refused():
    spec = td.get_spec("llama-tiny", SPEC)
    with pytest.raises(ValueError, match="flat cache layout"):
        td.init_cache(spec, 2, 128, stacked=True, flat=True)


# -- the engine ------------------------------------------------------------------------

ENGINE_SPEC = {"layers": 2, "hidden": 256, "q_heads": 4, "kv_heads": 2, "intermediate": 256,
               "vocab": 128}


@pytest.fixture(scope="module")
def target():
    spec = jd.get_spec("llama-tiny", ENGINE_SPEC)
    return spec, jd.init_params(spec, np.random.default_rng(3))


def _serve(pkg, target, prompts, one_by_one=False, **kw):
    spec, params = target
    kw = dict(dict(num_slots=4, max_len=64, prefill_buckets=[8, 16], steps_per_sync=3), **kw)
    if pkg == "jax":
        eng, mod = jgen.GenerationEngine(spec, params, dtype=jnp.float32, **kw), jgen
    else:
        eng = tgen.GenerationEngine(td.get_spec("llama-tiny", ENGINE_SPEC), params,
                                    dtype=torch.float32, device="cpu", **kw)
        mod = tgen
    eng.start()
    try:
        if one_by_one:
            # each prompt finds the previous one's prefix
            return [eng.generate(p, max_new_tokens=6, timeout=180) for p in prompts], eng
        reqs = [mod.GenerationRequest(prompt_ids=p, max_new_tokens=6) for p in prompts]
        for r in reqs:
            eng.submit(r)
        return [r.result(timeout=180) for r in reqs], eng
    finally:
        eng.stop()


SYSTEM = np.arange(1, 25, dtype=np.int32)

ENGINE_CASES = {
    "dense": (dict(), False),
    "paged": (dict(kv_page_size=32, kv_pool_pages=9), False),
    "dense_prefix": (dict(prefill_chunk=16, prefix_cache=True, prefix_cache_min=8), True),
    "paged_prefix": (dict(kv_page_size=8, prefill_chunk=16, prefix_cache=True,
                          prefix_cache_min=8), True),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_flat_engine_streams_match_standard_and_jax(target, case):
    """As tests/integration/test_generation.py's flat-layout test, with
    the JAX flat engine as a third witness."""
    kw, prefix = ENGINE_CASES[case]
    if prefix:
        prompts = [np.concatenate([SYSTEM, np.asarray([40 + i, 50 + i], np.int32)])
                   for i in range(3)]
    else:
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, 128, (rng.integers(3, 12),)).astype(np.int32)
                   for _ in range(5)]
    want, _ = _serve("jax", target, prompts, prefix, kv_cache_layout="flat", **kw)
    got, eng = _serve("torch", target, prompts, prefix, kv_cache_layout="flat", **kw)
    std, _ = _serve("torch", target, prompts, prefix, **kw)
    assert eng.flat_cache and eng.cache.flat
    assert got == want == std
    if prefix:
        assert eng.prefix_hits >= 1


def test_flat_engine_with_a_draft_model_matches_standard(target):
    kw = dict(draft_spec=td.get_spec("llama-tiny", ENGINE_SPEC), draft_params=target[1],
              speculate_k=3)
    prompts = [np.asarray(p, np.int32) for p in ([3, 7, 11], [5, 2, 9, 1, 13], [1, 4])]
    got, eng = _serve("torch", target, prompts, kv_cache_layout="flat", **kw)
    std, _ = _serve("torch", target, prompts, **kw)
    assert eng._draft_cache.flat and got == std


def test_flat_layout_compositions_are_refused(target):
    spec = td.get_spec("llama-tiny", ENGINE_SPEC)
    with pytest.raises(ValueError, match="kv_cache_layout must be"):
        tgen.GenerationEngine(spec, target[1], device="cpu", kv_cache_layout="planar")
    with pytest.raises(ValueError, match="redundant"):
        tgen.GenerationEngine(spec, target[1], device="cpu", kv_cache_layout="flat",
                              pin_cache_layouts=True)
    cfg = tcfg.load_config(str(ROOT / "configs" / "llama_decoder.yml"))
    opts = dict(cfg.model.options, kv_cache_layout="flat", pin_cache_layouts=True,
                **{k: v for k, v in ENGINE_SPEC.items()})
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, options=opts))
    with pytest.raises(ValueError, match="redundant"):
        tgen.build_generation_engine(cfg, device="cpu")
