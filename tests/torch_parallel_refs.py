"""JAX-side helpers of the spawned-world parity tests: the cases' inputs
and the JAX package's references (the world itself runs
``torch_parallel_cases.py``, which imports no JAX)."""

import jax.numpy as jnp
import numpy as np

from starpu_inference_server_tpu.models import decoder as jdec

TINY = {"layers": 4, "hidden": 64, "q_heads": 4, "kv_heads": 2, "intermediate": 96,
        "vocab": 128}
MOE = dict(TINY, num_experts=4)


def prefill_case(name, family, opts, seed, bucket=16, length=13, slot=1, quant=None):
    prompt = np.zeros((bucket,), np.int32)
    prompt[:length] = np.random.default_rng(seed + 1).integers(0, opts["vocab"], (length,))
    return {"name": name, "kind": "prefill", "family": family, "opts": opts, "seed": seed,
            "ids": prompt, "length": length, "slot": slot, "num_slots": 4, "max_len": 64,
            "quant": quant}


def start_cache(family, opts, seed, num_slots=4, max_len=32):
    """The JAX package's plain prefill of three of four slots (the JAX
    decode test's starting state), stacked, as numpy."""
    spec = jdec.get_spec(family, opts)
    params = jdec.init_params(spec, np.random.default_rng(seed))
    cache = jdec.init_cache(spec, num_slots, max_len)
    rng = np.random.default_rng(seed + 1)
    for slot, length in [(0, 5), (1, 8), (3, 3)]:
        prompt = np.zeros((8,), np.int32)
        prompt[:length] = rng.integers(0, spec.vocab, (length,))
        cache, _ = jdec.prefill(spec, params, cache, jnp.asarray(prompt), jnp.int32(length),
                                jnp.int32(slot), jnp.float32)
    stacked = jdec.stack_cache(cache)
    return spec, params, tuple(np.asarray(a) for a in (stacked.k, stacked.v, stacked.k_scale,
                                                       stacked.v_scale, stacked.lengths))


def decode_case(name, family, opts, seed, window=0, microgroups=0, dtype="float32"):
    _, _, cache = start_cache(family, opts, seed)
    rng = np.random.default_rng(seed + 2)
    ids = (rng.integers(0, opts["vocab"], (4, window), np.int32) if window
           else np.asarray([7, 11, 0, 3], np.int32))
    return {"name": name, "kind": "decode", "family": family, "opts": opts, "seed": seed,
            "cache": cache, "ids": ids, "active": np.asarray([True, True, False, True]),
            "microgroups": microgroups, "dtype": dtype}


def assert_cache_close(world, coords, want, slot_rows, stages=2, exclude_last=False):
    """Dequantized rows of the ranks' cache shards against the whole JAX
    cache: ``slot_rows`` is [(slot, row slice)]."""
    for r, out in enumerate(world):
        k, v, ks, vs, lengths = out["cache"]
        per = want[0].shape[0] // stages
        lo = coords[r]["pipe"] * per
        for name, (got_q, got_s), want_q, want_s in (
                ("k", (k, ks), want[0], want[2]), ("v", (v, vs), want[1], want[3])):
            for slot, rows in slot_rows:
                g = got_q[:, slot, rows].astype(np.float32) * got_s[:, slot, rows][..., None]
                w = (want_q[lo:lo + per, slot, rows].astype(np.float32)
                     * want_s[lo:lo + per, slot, rows][..., None])
                np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3, err_msg=name)
        np.testing.assert_array_equal(lengths, want[4])


def _jax_cache(cache):
    return tuple(np.asarray(a) for a in (cache.k, cache.v, cache.k_scale, cache.v_scale,
                                         cache.lengths))


def jax_sequential_prefill(case):
    """``prefill_chunk`` run chunk by chunk with the pipeline's boundaries
    (the JAX test's reference)."""
    spec = jdec.get_spec(case["family"], case["opts"])
    params = jdec.init_params(spec, np.random.default_rng(case["seed"]))
    padded, length, slot = case["ids"], case["length"], case["slot"]
    c = len(padded) // 2
    cache = jdec.init_cache(spec, case["num_slots"], case["max_len"])
    logits = None
    for start in range(0, len(padded), c):
        valid = min(c, max(0, length - start))
        cache, lg = jdec.prefill_chunk(spec, params, cache, jnp.asarray(padded[start:start + c]),
                                       jnp.int32(start), jnp.int32(max(valid, 1)),
                                       jnp.int32(slot), jnp.float32)
        if start < length <= start + c:
            logits = np.asarray(lg)
    cache = jdec.stack_cache(cache._replace(lengths=cache.lengths.at[slot].set(length)))
    return logits, _jax_cache(cache)


def jax_decode_reference(case):
    spec, params, cache = start_cache(case["family"], case["opts"], case["seed"])
    layered = jdec.KVCache(k=tuple(jnp.asarray(a) for a in cache[0]),
                           v=tuple(jnp.asarray(a) for a in cache[1]),
                           k_scale=tuple(jnp.asarray(a) for a in cache[2]),
                           v_scale=tuple(jnp.asarray(a) for a in cache[3]),
                           lengths=jnp.asarray(cache[4]))
    fn = jdec.verify_step if case["ids"].ndim == 2 else jdec.decode_step
    new, logits = fn(spec, params, layered, jnp.asarray(case["ids"]),
                     jnp.asarray(case["active"]), getattr(jnp, case.get("dtype", "float32")))
    return np.asarray(logits), _jax_cache(jdec.stack_cache(new)), cache[4]


def jax_engine_tokens(family, opts, seed, prompts, max_new, chunk, bucket=8):
    """Greedy tokens of the JAX single-device engine with prefill_chunk at
    the pipeline's chunk size (the JAX pipelined-engine test's reference)."""
    from starpu_inference_server_tpu.serving.generation import (
        GenerationEngine,
        GenerationRequest,
    )

    spec = jdec.get_spec(family, opts)
    params = jdec.init_params(spec, np.random.default_rng(seed))
    ref = GenerationEngine(spec, params, dtype=jnp.float32, num_slots=4, max_len=64,
                           prefill_buckets=[bucket], steps_per_sync=2, prefill_chunk=chunk,
                           family=family)
    ref.start()
    try:
        reqs = [GenerationRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=max_new)
                for p in prompts]
        for r in reqs:
            ref.submit(r)
        return [r.result(timeout=120.0) for r in reqs]
    finally:
        ref.stop()
