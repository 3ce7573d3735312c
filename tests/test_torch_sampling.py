"""The port's device-side sampling (``serving/sampling.py``) against ``jax.random``.

- Keys: ``prng_key`` and ``fold_in`` equal ``jax.random.key_data`` of
  ``fold_in(PRNGKey(seed), progress)`` for seeds 0, 1, 2^31 - 1 and
  2^32 - 1 (uint32, as the engines hold them) and progress 0..40.
- Bits: ``random_bits``, ``uniform``, ``gumbel`` and the logarithm under
  it equal JAX's exactly.
- Draws: ``categorical`` equals ``jax.random.categorical`` on random
  logits with ``-inf`` holes over a seeded sweep of keys, and
  ``sample_tokens`` equals the JAX engine's ``_sample_tokens`` on [S, V]
  logits with mixed temperatures and top-k; ``sample_rows`` on a subset
  of rows (the engine's path) gives those rows' tokens.
- Engines: on llama-tiny at FP32, sampled streams (temperature 0.8,
  top-k 40, several seeds, greedy requests beside them) equal the JAX
  engine's token for token, in the plain engine and through the verify
  path of a draft model and of prompt lookup.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starpu_inference_server_tpu.models import decoder as jd
from starpu_inference_server_tpu.serving import generation as jgen
from starpu_inference_server_tpu_torch.models import decoder as td
from starpu_inference_server_tpu_torch.serving import generation as tgen
from starpu_inference_server_tpu_torch.serving import sampling

SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 32 - 1]


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _jax_keys(seeds, progress):
    """The JAX engine's step keys (``vmap`` of fold_in over uint32 seeds)."""
    keys = jax.vmap(lambda sd, pg: jax.random.fold_in(jax.random.PRNGKey(sd), pg))(
        jnp.asarray(np.asarray(seeds, np.uint32)), jnp.asarray(np.asarray(progress, np.int32)))
    return np.asarray(keys).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal_jax_key_data(seed):
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(np.uint32(seed))))
    np.testing.assert_array_equal(sampling.prng_key(torch.tensor(seed)).numpy(),
                                  want.astype(np.int64))
    progress = np.arange(41)
    got = sampling.fold_in(sampling.prng_key(_t([seed] * 41)), _t(progress))
    np.testing.assert_array_equal(got.numpy(), _jax_keys([seed] * 41, progress))


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_random_bits_and_uniform_equal_jax(n):
    for seed in (0, 5, 2 ** 32 - 1):
        key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), 3)
        tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
        np.testing.assert_array_equal(
            sampling.random_bits(tkey, n).numpy(),
            np.asarray(jax.random.bits(key, (n,), jnp.uint32)).astype(np.int64))
        tiny = np.finfo(np.float32).tiny
        np.testing.assert_array_equal(
            sampling.uniform(tkey, n, tiny, 1.0).numpy(),
            np.asarray(jax.random.uniform(key, (n,), minval=tiny, maxval=1.0)))
        np.testing.assert_array_equal(sampling.uniform(tkey, n).numpy(),
                                      np.asarray(jax.random.uniform(key, (n,))))


def test_gumbel_and_its_logarithm_equal_jax_bit_for_bit():
    key = jax.random.PRNGKey(7)
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    np.testing.assert_array_equal(sampling.gumbel(tkey, 100_000).numpy(),
                                  np.asarray(jax.random.gumbel(key, (100_000,))))
    # every binade a Gumbel draw feeds the logarithm: u in [tiny, 1), -log(u) in (0, 88)
    rng = np.random.default_rng(0)
    x = np.concatenate([np.exp2(rng.uniform(-126, 7, 100_000)),
                        [np.finfo(np.float32).tiny, 1.0, 0.5, 2.0, 1 - 2 ** -24]]).astype(np.float32)
    np.testing.assert_array_equal(sampling.log_f32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jnp.log)(x)))


@pytest.mark.parametrize("vocab", [2, 129, 32000])
def test_categorical_equals_jax_over_many_keys(vocab):
    rng = np.random.default_rng(vocab)
    n = 64 if vocab > 1000 else 200
    logits = (3 * rng.standard_normal((n, vocab))).astype(np.float32)
    logits[rng.random((n, vocab)) < 0.2] = -np.inf
    logits[:, 0] = rng.standard_normal(n)  # every row keeps a finite logit
    seeds = rng.integers(0, 2 ** 32, n, dtype=np.uint64)
    progress = rng.integers(0, 1000, n)
    keys = _jax_keys(seeds, progress)
    want = np.asarray(jax.vmap(jax.random.categorical)(
        jnp.asarray(keys.astype(np.uint32)), jnp.asarray(logits)))
    got = sampling.categorical(torch.from_numpy(keys), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def _sampling_case(s, vocab, seed):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal((s, vocab))).astype(np.float32)
    logits[rng.random((s, vocab)) < 0.05] = -np.inf
    temps = rng.choice([0.0, 0.3, 0.8, 1.0, 1.7], s).astype(np.float32)
    top_k = rng.choice([0, 1, 5, 40, vocab + 3], s).astype(np.int32)
    seeds = rng.integers(0, 2 ** 32, s, dtype=np.uint64).astype(np.uint32)
    progress = rng.integers(0, 200, s).astype(np.int32)
    return logits, temps, top_k, seeds, progress


@pytest.mark.parametrize("s,vocab,seed", [(16, 128, 0), (64, 512, 1), (8, 32000, 2)])
def test_sample_tokens_equals_jax_sample_tokens(s, vocab, seed):
    logits, temps, top_k, seeds, progress = _sampling_case(s, vocab, seed)
    want = np.asarray(jgen._sample_tokens(jnp.asarray(logits), jnp.asarray(temps),
                                          jnp.asarray(top_k), _jax_keys(seeds, progress)
                                          .astype(np.uint32)))
    got = sampling.sample_tokens(torch.from_numpy(logits), torch.from_numpy(temps),
                                 torch.from_numpy(top_k), _t(seeds), torch.from_numpy(progress))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the engine's path: only the sampled rows draw, top-k read from the
    # largest top-k among them
    idx = np.nonzero(temps > 0)[0]
    keys = sampling.fold_in(sampling.prng_key(_t(seeds[idx])), _t(progress[idx]))
    rows = sampling.sample_rows(torch.from_numpy(logits[idx]), torch.from_numpy(temps[idx]),
                                torch.from_numpy(top_k[idx]), keys, int(top_k[idx].max()))
    np.testing.assert_array_equal(rows.numpy(), want[idx])


# -- engines -------------------------------------------------------------------

TINY = {"layers": 2, "hidden": 128, "q_heads": 4, "kv_heads": 2, "intermediate": 256,
        "vocab": 128}
DRAFT = {"layers": 1, "hidden": 64, "q_heads": 2, "kv_heads": 1, "intermediate": 128,
         "vocab": 128}
PROMPTS = [[3, 7, 11, 2], [1, 4], [9, 9, 9, 9, 9], [1, 2, 3, 4, 5], [6, 5, 6, 5], [8]]
# (temperature, top_k, seed) per request; greedy requests beside sampled ones
SAMPLING = [(0.8, 40, 0), (0.0, 0, 0), (0.8, 40, 1), (0.8, 40, 2 ** 32 - 1), (0.0, 0, 0),
            (0.8, 40, 12345)]


@pytest.fixture(scope="module")
def target():
    spec = jd.get_spec("llama-tiny", TINY)
    return spec, jd.init_params(spec, np.random.default_rng(0))


@pytest.fixture(scope="module")
def draft():
    spec = jd.get_spec("llama-tiny", DRAFT)
    return spec, jd.init_params(spec, np.random.default_rng(1))


def _streams(pkg, target, draft=None, mix=SAMPLING, **kw):
    spec, params = target
    kw = dict(dict(num_slots=4, max_len=64, prefill_buckets=[8], steps_per_sync=3), **kw)
    if draft is not None:
        kw.update(draft_params=draft[1], draft_spec=draft[0] if pkg is jgen
                  else td.get_spec("llama-tiny", DRAFT))
    if pkg is jgen:
        eng = jgen.GenerationEngine(spec, params, dtype=jnp.float32, **kw)
    else:
        eng = tgen.GenerationEngine(td.get_spec("llama-tiny", TINY), params,
                                    dtype=torch.float32, device="cpu", **kw)
    reqs = [pkg.GenerationRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=14,
                                  temperature=t, top_k=k, seed=s)
            for p, (t, k, s) in zip(PROMPTS, mix)]
    eng.start()
    try:
        for r in reqs:
            eng.submit(r)
        return [r.result(timeout=300) for r in reqs]
    finally:
        eng.stop()


@pytest.mark.parametrize("case", ["plain", "draft", "lookup"])
def test_sampled_streams_equal_jax_engine(target, draft, case):
    kw = {"plain": {}, "draft": dict(speculate_k=3), "lookup": dict(speculate_k=3,
                                                                    prompt_lookup_ngram=2)}[case]
    d = draft if case == "draft" else None
    want = _streams(jgen, target, d, **kw)
    got = _streams(tgen, target, d, **kw)
    assert got == want
    assert all(len(t) == 14 for t in got)
    # the sampled streams are draws, not the greedy stream of their prompt
    greedy = _streams(tgen, target, mix=[(0.0, 0, 0)] * len(PROMPTS))
    assert greedy[1] == got[1] and greedy[4] == got[4]
    assert any(got[i] != greedy[i] for i in (0, 2, 3, 5))
