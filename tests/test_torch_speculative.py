"""Verify windows and speculation in the port vs the JAX package.

- K9 ``window_decode_attention`` (the plain version here, on CPU) against
  the JAX kernel in interpret mode, at S = 1 (the per-slot grid) and
  S = 16 (the slot-grouped grid), mixed lengths including 0.
- ``verify_step`` equals W sequential ``decode_step``s, and matches the
  JAX function with the kernel routes off and forced on.
- ``rig_copy_model`` equals the JAX rig bit for bit.
- The engine: greedy streams identical to the JAX engine's on the same
  weights for model-draft speculation (perfect draft, weak draft, EOS
  inside an accepted window, staggered budgets, ``steps_per_sync`` > 1,
  chunked prefill) and prompt lookup; sampled slots accept no drafts and
  match the port's own plain engine; headroom is exactly K; bad
  combinations are refused.
- The draft the port builds from ``llama_speculative.yml``'s options
  equals the JAX server's leaf by leaf.

Weights are float (the JAX tests' own TINY model, head_dim 32, max_len
64), so every kernel gate is closed in the engine tests: the streams
compare the two packages' plain routes, in FP32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starpu_inference_server_tpu.models import decoder as jd
from starpu_inference_server_tpu.ops import decode_attention as jda
from starpu_inference_server_tpu.ops import nn as jnn
from starpu_inference_server_tpu.serving import generation as jgen
from starpu_inference_server_tpu_torch.models import decoder as td
from starpu_inference_server_tpu_torch.ops import decode_attention as tda
from starpu_inference_server_tpu_torch.ops import nn as tnn
from starpu_inference_server_tpu_torch.serving import generation as tgen
from starpu_inference_server_tpu_torch.weights import params_from_numpy

TINY = {"layers": 2, "hidden": 128, "q_heads": 4, "kv_heads": 2,
        "intermediate": 256, "vocab": 128}
DRAFT = {"layers": 1, "hidden": 64, "q_heads": 2, "kv_heads": 1,
         "intermediate": 128, "vocab": 128}


def _t(a):
    return torch.from_numpy(np.array(a))


# -- K9: window_decode_attention ----------------------------------------------

def _window_case(s, w, t, hkv, rep, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((s, w, hkv * rep, d)).astype(np.float32)
    k = rng.integers(-127, 128, (s, t, hkv, d)).astype(np.int8)
    v = rng.integers(-127, 128, (s, t, hkv, d)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, (s, t, hkv)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (s, t, hkv)).astype(np.float32)
    lengths = rng.integers(0, t - w + 1, (s,)).astype(np.int32)
    lengths[0] = 0
    lengths[-1] = t - w
    return q, k, v, ks, vs, lengths


@pytest.mark.parametrize("s", [1, 16])
@pytest.mark.parametrize("w,rep", [(5, 2), (9, 4)])
def test_window_decode_attention_matches_jax_kernel(s, w, rep):
    case = _window_case(s, w, 256, 2, rep, 64, seed=s * 10 + w)
    # S = 1 runs the per-slot grid (_window_kernel), S = 16 the grouped one
    assert (jda._pick_group(s) > 1) == (s == 16)
    jda.set_interpret(True)
    try:
        want = np.asarray(jda.window_decode_attention(
            *(jnp.asarray(a) for a in case), rep=rep, out_dtype=jnp.float32))
    finally:
        jda.set_interpret(False)
    got = tda.window_decode_attention(*(_t(a) for a in case), rep=rep)
    assert got.shape == (s, w, 2 * rep, 64)
    # the JAX package's own tolerance (test_decode_attention.py:126)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    assert tda.launches["window_decode_attention"] == 0  # CPU tensors never launch


def test_one_row_window_is_decode_attention():
    q, k, v, ks, vs, lengths = _window_case(4, 1, 128, 2, 4, 64, seed=3)
    win = tda.window_decode_attention(*(_t(a) for a in (q, k, v, ks, vs, lengths)), rep=4)
    dec = tda.decode_attention(_t(q[:, 0]), *(_t(a) for a in (k, v, ks, vs, lengths)), rep=4)
    np.testing.assert_allclose(win[:, 0].numpy(), dec.numpy(), rtol=1e-6, atol=1e-6)


# -- verify_step ----------------------------------------------------------------

KERNEL_SPEC = {"layers": 2, "hidden": 128, "q_heads": 2, "kv_heads": 1,
               "intermediate": 96, "vocab": 64}


def _prefilled(pkg, spec, params, rng, t_max=128):
    """Two slots prefilled with 6 and 3 random tokens; returns the cache
    and a [2, 4] window of ids (same draws for both packages)."""
    prompts = []
    for length in (6, 3):
        prompt = np.zeros((8,), np.int32)
        prompt[:length] = rng.integers(0, spec.vocab, (length,))
        prompts.append((prompt, length))
    ids = rng.integers(0, spec.vocab, (2, 4)).astype(np.int32)
    if pkg == "jax":
        cache = jd.init_cache(spec, 2, t_max)
        for slot, (prompt, length) in enumerate(prompts):
            cache, _ = jd.prefill(spec, params, cache, jnp.asarray(prompt), jnp.int32(length),
                                  jnp.int32(slot), jnp.float32)
        return cache, ids
    cache = td.init_cache(spec, 2, t_max)
    for slot, (prompt, length) in enumerate(prompts):
        td.prefill(spec, params, cache, _t(prompt), length, slot, torch.float32)
    return cache, ids


@pytest.mark.parametrize("kernels", [False, True])
def test_verify_step_matches_jax(kernels):
    """Kernel routes off, and forced on (the port's K9 plain version
    against the JAX kernel in interpret mode): port vs JAX logits, and
    lengths not advanced."""
    jspec = jd.get_spec("llama-tiny", KERNEL_SPEC)
    tspec = td.get_spec("llama-tiny", KERNEL_SPEC)
    raw = jd.init_params(jspec, np.random.default_rng(8))
    active = np.array([True, True])
    jnn.set_use_pallas(kernels)
    jda.set_interpret(kernels)
    tnn.set_use_kernels(kernels)
    try:
        jc, ids = _prefilled("jax", jspec, raw, np.random.default_rng(9))
        _, want = jd.verify_step(jspec, raw, jc, jnp.asarray(ids), jnp.asarray(active),
                                 jnp.float32)
        tc, ids = _prefilled("torch", tspec, params_from_numpy(raw), np.random.default_rng(9))
        _, got = td.verify_step(tspec, params_from_numpy(raw), tc, _t(ids), _t(active),
                                torch.float32)
    finally:
        jnn.set_use_pallas(False)
        jda.set_interpret(False)
        tnn.set_use_kernels(None)
    assert tc.lengths.tolist() == [6, 3]
    # the JAX package's own kernel-on vs kernel-off tolerance
    # (test_decode_attention.py:172)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_verify_step_matches_sequential_decode():
    """A W-window in one verify_step gives the logits of W sequential
    decode_steps fed the same tokens (test_speculative.py:57)."""
    spec = td.get_spec("llama-tiny", TINY)
    params = params_from_numpy(jd.init_params(jd.get_spec("llama-tiny", TINY),
                                              np.random.default_rng(0)))
    prompt = np.asarray([3, 7, 11, 2], np.int32)
    window = np.asarray([[5, 9, 4, 1]], np.int32)
    a = td.init_cache(spec, 1, 32)
    td.prefill(spec, params, a, _t(prompt), len(prompt), 0, torch.float32)
    b = td.init_cache(spec, 1, 32)
    td.prefill(spec, params, b, _t(prompt), len(prompt), 0, torch.float32)
    seq = []
    for tok in window[0]:
        _, lg = td.decode_step(spec, params, a, torch.tensor([tok], dtype=torch.int32),
                               torch.tensor([True]), torch.float32)
        seq.append(lg[0].numpy())
    _, ver = td.verify_step(spec, params, b, _t(window), torch.tensor([True]), torch.float32)
    assert int(b.lengths[0]) == len(prompt)
    np.testing.assert_allclose(ver[0].numpy(), np.stack(seq), rtol=2e-4, atol=2e-4)
    # the window's rows went through the int8 cache, as decode's did
    for li in range(spec.layers):
        assert torch.equal(a.k[li][0, :8], b.k[li][0, :8])


def test_verify_step_parks_inactive_rows_at_the_last_row():
    spec = td.get_spec("llama-tiny", TINY)
    params = params_from_numpy(jd.init_params(jd.get_spec("llama-tiny", TINY),
                                              np.random.default_rng(0)))
    cache = td.init_cache(spec, 2, 32)
    cache.lengths[1] = 7
    before = cache.k[0][1, 7:11].clone()
    td.verify_step(spec, params, cache, torch.ones((2, 4), dtype=torch.int32),
                   torch.tensor([True, False]), torch.float32)
    assert torch.equal(cache.k[0][1, 7:11], before)
    assert cache.k[0][1, 31].abs().sum() > 0
    assert cache.lengths.tolist() == [0, 7]


def test_rig_copy_model_matches_jax_bit_for_bit():
    spec_j = jd.get_spec("llama-tiny", TINY)
    spec_t = td.get_spec("llama-tiny", TINY)
    want = jd.rig_copy_model(spec_j, jd.init_params(spec_j, np.random.default_rng(4)), 5)
    got = td.rig_copy_model(spec_t, td.init_params(spec_t, np.random.default_rng(4)), 5)
    for x, y in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(x), y)
    # the registry option builds the same rigged tree
    rigged = td._build_decoder("llama-tiny", dict(TINY, copy_model_cycle=5))
    for x, y in zip(jax.tree.leaves(want),
                    jax.tree.leaves(rigged.init_params(np.random.default_rng(4)))):
        np.testing.assert_array_equal(np.asarray(x), y)


# -- the engine ----------------------------------------------------------------

@pytest.fixture(scope="module")
def target():
    spec = jd.get_spec("llama-tiny", TINY)
    return spec, jd.init_params(spec, np.random.default_rng(0))


@pytest.fixture(scope="module")
def weak_draft():
    spec = jd.get_spec("llama-tiny", DRAFT)
    return spec, jd.init_params(spec, np.random.default_rng(99))


def _engine(pkg, target, draft=None, **kw):
    spec, params = target
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_buckets", [8, 16])
    if pkg == "jax":
        if draft is not None:
            kw.update(draft_spec=draft[0], draft_params=draft[1])
        eng = jgen.GenerationEngine(spec, params, dtype=jnp.float32, **kw)
    else:
        if draft is not None:
            kw.update(draft_spec=td.get_spec("llama-tiny", dict(
                hidden=draft[0].hidden, layers=draft[0].layers, q_heads=draft[0].q_heads,
                kv_heads=draft[0].kv_heads, intermediate=draft[0].intermediate,
                vocab=draft[0].vocab)), draft_params=draft[1])
        eng = tgen.GenerationEngine(td.get_spec("llama-tiny", TINY), params,
                                    dtype=torch.float32, device="cpu", **kw)
    eng.start()
    return eng


def _drain(eng, prompts, budgets, **req_kw):
    mod = jgen if isinstance(eng, jgen.GenerationEngine) else tgen
    if isinstance(budgets, int):
        budgets = [budgets] * len(prompts)
    try:
        reqs = [mod.GenerationRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=b,
                                      **req_kw) for p, b in zip(prompts, budgets)]
        for r in reqs:
            eng.submit(r)
        return [r.result(timeout=120) for r in reqs]
    finally:
        eng.stop()


PROMPTS = [[3, 7, 11, 2], [1, 4], [9, 9, 9], [1, 2, 3, 4, 5]]


@pytest.mark.parametrize("case", ["perfect", "weak", "steps_per_sync", "staggered", "chunked"])
def test_speculative_streams_match_jax_engine(target, weak_draft, case):
    draft = target if case in ("perfect", "staggered", "steps_per_sync") else weak_draft
    kw = {"perfect": dict(speculate_k=3),
          "weak": dict(speculate_k=4),
          "steps_per_sync": dict(speculate_k=2, steps_per_sync=2),
          "staggered": dict(speculate_k=4, steps_per_sync=4),
          "chunked": dict(speculate_k=3, steps_per_sync=2, prefill_chunk=8)}[case]
    prompts, budgets = PROMPTS, 12
    if case == "staggered":
        prompts, budgets = PROMPTS[:3], [5, 17, 11]
    if case == "chunked":  # longer than the largest bucket
        rng = np.random.default_rng(13)
        prompts = [rng.integers(0, 128, (n,)) for n in (20, 25, 18)]
    want = _drain(_engine("jax", target, draft, **kw), prompts, budgets)
    eng = _engine("torch", target, draft, **kw)
    got = _drain(eng, prompts, budgets)
    assert got == want
    assert [len(t) for t in got] == ([budgets] * len(prompts) if isinstance(budgets, int)
                                     else budgets)
    assert eng.drafted_tokens > 0
    if case == "perfect":
        assert eng.draft_acceptance_rate() == pytest.approx(1.0)
        assert eng.steps <= 4 * len(prompts)  # K+1 tokens per verify


def test_eos_inside_accepted_window_matches_jax(target):
    probe = _drain(_engine("jax", target), [[9, 9]], 6)[0]
    eos = probe[3]
    want = _drain(_engine("jax", target, target, speculate_k=4), [[9, 9]], 20, eos_id=eos)
    eng = _engine("torch", target, target, speculate_k=4)
    try:
        req = tgen.GenerationRequest(prompt_ids=np.asarray([9, 9], np.int32),
                                     max_new_tokens=20, eos_id=eos)
        eng.submit(req)
        assert req.result(timeout=120) == want[0] == probe[:4]
        # the slot is free again: a follow-up request works
        assert len(eng.generate(np.asarray([1, 2], np.int32), max_new_tokens=3)) == 3
    finally:
        eng.stop()


def test_sampled_slot_accepts_no_drafts_and_matches_plain_engine(target):
    kw = dict(temperature=0.8, top_k=5, seed=42)
    want = _drain(_engine("torch", target), PROMPTS[:1], 8, **kw)
    for extra in (dict(draft=target, speculate_k=3), dict(prompt_lookup_ngram=2,
                                                           speculate_k=3)):
        eng = _engine("torch", target, **extra)
        assert _drain(eng, PROMPTS[:1], 8, **kw) == want
        assert eng.drafted_tokens == 0 and eng.accepted_drafts == 0


def test_headroom_is_exactly_k(target):
    k = 3
    for extra in (dict(draft=target), dict(prompt_lookup_ngram=2)):
        eng = _engine("torch", target, speculate_k=k, max_len=32, steps_per_sync=2, **extra)
        try:
            prompt = np.asarray([5, 4, 3, 2], np.int32)
            fits = 32 - len(prompt) - k
            with pytest.raises(ValueError, match="headroom"):
                eng.submit(tgen.GenerationRequest(prompt_ids=prompt, max_new_tokens=fits + 1))
            assert len(eng.generate(prompt, max_new_tokens=fits)) == fits
        finally:
            eng.stop()


def test_engine_refuses_bad_draft_combinations(target):
    spec = td.get_spec("llama-tiny", TINY)
    params = target[1]
    bad = td.get_spec("llama-tiny", dict(DRAFT, vocab=64))
    with pytest.raises(ValueError, match="vocab"):
        tgen.GenerationEngine(spec, params, device="cpu", draft_spec=bad,
                              draft_params=td.init_params(bad, np.random.default_rng(1)))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tgen.GenerationEngine(spec, params, device="cpu", draft_spec=spec, draft_params=params,
                              prompt_lookup_ngram=2)


# -- prompt lookup ----------------------------------------------------------------

NGRAM_CASES = {
    # slot 0: 5 6 7 9 | 5 6 -> continuation after the match at 0; slot 1: none
    "continuation": ([[5, 6, 7, 9, 5, 6], [1, 2, 3, 4, 5]], [6, 5], 3, 2),
    # two matches: the most recent wins
    "most_recent": ([[1, 2, 9, 1, 2, 7, 1, 2]], [8], 2, 2),
    # stale tokens past len_h (a previous request's) are never drafted
    "past_len_h": ([[1, 2, 1, 2] + [99] * 12], [4], 4, 2),
    # the query runs off the left edge and the drafts off the right
    "edges": ([[4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4], [7, 0, 0, 0] + [0] * 12],
              [16, 1], 5, 3),
}


@pytest.mark.parametrize("name", sorted(NGRAM_CASES))
def test_ngram_drafts_match_jax(name):
    rows, len_h, k, n = NGRAM_CASES[name]
    hist = np.zeros((len(rows), 16), np.int32)
    for i, r in enumerate(rows):
        hist[i, :len(r)] = r
    len_h = np.asarray(len_h, np.int32)
    want_d, want_f = jgen._ngram_drafts(jnp.asarray(hist), jnp.asarray(len_h), k=k, n=n)
    got_d, got_f = tgen._ngram_drafts(_t(hist), _t(len_h), k, n)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    if name == "continuation":
        assert got_d.tolist() == [[7, 9, 5], [0, 0, 0]]
    if name == "past_len_h":
        assert got_d.tolist() == [[1, 2, 0, 0]]


@pytest.mark.parametrize("case", ["plain", "steps_per_sync", "staggered", "repetitive"])
def test_prompt_lookup_streams_match_jax_engine(target, case):
    kw = {"plain": dict(speculate_k=4), "steps_per_sync": dict(speculate_k=3, steps_per_sync=2),
          "staggered": dict(speculate_k=4, steps_per_sync=2),
          "repetitive": dict(speculate_k=4)}[case]
    prompts, budgets = PROMPTS[:3], 14
    if case == "staggered":
        budgets = [5, 17, 11]
    if case == "repetitive":  # greedy falls into a cycle: drafts land
        prompts, budgets = PROMPTS[:1], 48
    want = _drain(_engine("jax", target, prompt_lookup_ngram=2, **kw), prompts, budgets)
    eng = _engine("torch", target, prompt_lookup_ngram=2, **kw)
    got = _drain(eng, prompts, budgets)
    assert got == want
    if case == "repetitive":
        assert eng.drafted_tokens > 0 and eng.accepted_drafts > 0
        assert eng.steps < 48


def test_prompt_lookup_slot_reuse_is_isolated(target):
    """A reused slot's stale history never leaks into a later request."""
    waves = [[3, 7, 11, 2], [1, 2, 3]]
    want = [_drain(_engine("torch", target), [w], 10)[0] for w in waves]
    eng = _engine("torch", target, prompt_lookup_ngram=2, speculate_k=4, num_slots=1)
    try:
        got = [eng.generate(np.asarray(w, np.int32), max_new_tokens=10) for w in waves]
    finally:
        eng.stop()
    assert got == want


# -- the draft model of llama_speculative.yml ----------------------------------------

def test_draft_from_config_matches_jax_server():
    """The port builds the draft as the JAX server does
    (grpc/server.py:136-162): draft_options with the target's vocab,
    weights from seed + 1, the target's int8 quantization. The target is
    cut to one narrow layer; the draft keeps the yml's widths."""
    from starpu_inference_server_tpu.grpc.server import InferenceServer as JaxServer
    from starpu_inference_server_tpu.utils.config import load_config as jload
    from starpu_inference_server_tpu_torch.utils.config import load_config as tload

    def cut(cfg):
        opts = dict(cfg.model.options, layers=1, hidden=128, q_heads=2, kv_heads=1,
                    intermediate=128, max_len=64, num_slots=2, prefill_buckets=[8])
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, options=opts),
                                   metrics_enabled=False)

    jcfg = cut(jload("configs/llama_speculative.yml"))
    server = JaxServer(jcfg, expose_metrics=False)
    want_spec = server.generation_engine.draft_spec
    want = jax.tree.map(np.asarray, server.generation_engine._draft_params)
    tcfg = cut(tload("configs/llama_speculative.yml"))
    spec, got = tgen.build_draft(tcfg, td.get_spec("llama-1b", tcfg.model.options), "cpu")
    assert (spec.hidden, spec.layers, spec.q_heads, spec.kv_heads, spec.intermediate,
            spec.vocab) == (want_spec.hidden, want_spec.layers, want_spec.q_heads,
                            want_spec.kv_heads, want_spec.intermediate, want_spec.vocab)
    assert (spec.hidden, spec.layers, spec.vocab) == (512, 4, 32000)
    leaves_w, tree_w = jax.tree.flatten(want)
    leaves_g, tree_g = jax.tree.flatten(jax.tree.map(
        lambda a: a.numpy() if isinstance(a, torch.Tensor) else a, got))
    assert tree_w == tree_g
    for x, y in zip(leaves_w, leaves_g):
        np.testing.assert_array_equal(x, y)
