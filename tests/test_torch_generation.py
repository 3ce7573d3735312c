"""The port's GenerationEngine vs the JAX package's, end to end on CPU.

Same int4 weights (made by the JAX package and handed over with
``params_from_numpy``), same FP32 engine configuration, concurrent
prompts of 5, 20 and 100 tokens (prefill_chunk 64 sends the 100-token
prompt down the chunked path while the others decode), steps_per_sync 4:
the greedy token streams must be identical. Sampled streams cannot
match ``jax.random``; they are checked for determinism per seed inside
the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starpu_inference_server_tpu.models import decoder as jd
from starpu_inference_server_tpu.ops import quant as jq
from starpu_inference_server_tpu.serving.generation import GenerationEngine as JaxEngine
from starpu_inference_server_tpu.serving.generation import GenerationRequest as JaxRequest
from starpu_inference_server_tpu_torch.models import decoder as td
from starpu_inference_server_tpu_torch.serving.generation import (
    GenerationEngine,
    GenerationRequest,
)

OPTS = {"layers": 2, "hidden": 256, "q_heads": 4, "kv_heads": 2,
        "intermediate": 512, "vocab": 512}
ENGINE_KW = dict(num_slots=4, max_len=256, prefill_buckets=[8, 32, 64],
                 steps_per_sync=4, prefill_chunk=64)


@pytest.fixture(scope="module")
def params():
    spec = jd.get_spec("llama-tiny", OPTS)
    raw = jd.init_params(spec, np.random.default_rng(0))
    return jax.tree.map(np.asarray, jq.maybe_quantize_tree(raw, 4))


@pytest.fixture(scope="module")
def engine(params):
    eng = GenerationEngine(td.get_spec("llama-tiny", OPTS), params, dtype=torch.float32,
                           device="cpu", **ENGINE_KW)
    eng.start()
    yield eng
    eng.stop()


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (5, 20, 100, 7)]


def _run(eng, make_request, prompts, **kw):
    reqs = [make_request(prompt_ids=p, max_new_tokens=12, **kw) for p in prompts]
    for r in reqs:
        eng.submit(r)
    return [r.result(timeout=120) for r in reqs]


def test_greedy_streams_identical_to_jax_engine(params, engine):
    jax_engine = JaxEngine(jd.get_spec("llama-tiny", OPTS), params, dtype=jnp.float32,
                           **ENGINE_KW)
    jax_engine.start()
    try:
        want = _run(jax_engine, JaxRequest, _prompts())
    finally:
        jax_engine.stop()
    got = _run(engine, GenerationRequest, _prompts())
    assert got == want
    assert all(len(t) == 12 for t in got)


def test_eos_ends_the_stream_at_its_first_occurrence(engine):
    prompt = _prompts()[1]
    full = engine.generate(prompt, max_new_tokens=12)
    eos = full[5]
    cut = engine.generate(prompt, max_new_tokens=12, eos_id=eos)
    assert cut == full[:full.index(eos) + 1]


def test_sampled_stream_is_deterministic_per_seed(engine):
    prompt = _prompts()[2]

    def sample(seed, crowd=0):
        reqs = [GenerationRequest(prompt_ids=prompt, max_new_tokens=10, temperature=0.8,
                                  top_k=40, seed=seed)]
        reqs += [GenerationRequest(prompt_ids=p, max_new_tokens=6) for p in _prompts()[:crowd]]
        for r in reqs:
            engine.submit(r)
        for r in reqs[1:]:
            r.result(timeout=120)
        return reqs[0].result(timeout=120)

    a = sample(5)
    assert sample(5, crowd=2) == a  # interleaving does not change the draw
    assert sample(6) != a
    assert all(0 <= t < 512 for t in a)


def test_cancel_before_admission_and_bad_prompts(engine):
    blockers = [GenerationRequest(prompt_ids=p, max_new_tokens=30) for p in _prompts()]
    for r in blockers:
        engine.submit(r)
    late = GenerationRequest(prompt_ids=_prompts()[0], max_new_tokens=30)
    late.cancel()
    engine.submit(late)
    assert late.done.wait(60)
    assert late.tokens == []  # dropped at admission, never decoded
    for r in blockers:
        r.result(timeout=120)
    with pytest.raises(ValueError):
        engine.submit(GenerationRequest(prompt_ids=np.ones(250, np.int32), max_new_tokens=30))
    assert engine.active_count() == 0


def test_engine_needs_cuda_unless_cpu_is_asked_for(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(td.get_spec("llama-tiny", OPTS), params, **ENGINE_KW)
