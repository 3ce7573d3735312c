"""Rank bodies of the spawned-world tests of the port's parallel package.

``parallel/launch.py:run_world`` runs :func:`world` on every rank of a
fresh world of processes; a spawned process imports this module again,
so it imports torch and the port only (never jax or the JAX package).
Each case gets its inputs as numpy arrays from the parent test (which
computes the JAX references) and returns numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from starpu_inference_server_tpu_torch.models.decoder import KVCache, get_spec, init_params
from starpu_inference_server_tpu_torch.parallel.launch import follow, join_mesh
from starpu_inference_server_tpu_torch.parallel.mesh import MeshAxes
from starpu_inference_server_tpu_torch.parallel.pipeline_decode import shard_cache
from starpu_inference_server_tpu_torch.weights import params_from_numpy, rank_shard


def _setup(mesh, case):
    spec = get_spec(case["family"], case["opts"])
    tree = init_params(spec, np.random.default_rng(case["seed"]))
    if case.get("quant"):
        from starpu_inference_server_tpu_torch.ops.quant import maybe_quantize_tree

        tree = maybe_quantize_tree(params_from_numpy(tree), case["quant"])
    shard = rank_shard(tree, spec, case["family"], mesh.coords, mesh.shape)
    return spec, params_from_numpy(shard)


def _cache_shard(mesh, arrays):
    """This rank's shard (owned copies) of a whole stacked cache given as
    numpy (k, v, k_scale, v_scale, lengths)."""
    k, v, ks, vs, lengths = (torch.from_numpy(np.array(a)) for a in arrays)
    sh = shard_cache(KVCache(k=k, v=v, k_scale=ks, v_scale=vs, lengths=lengths),
                     mesh.coords, mesh.shape)
    return KVCache(k=sh.k.clone(), v=sh.v.clone(), k_scale=sh.k_scale.clone(),
                   v_scale=sh.v_scale.clone(), lengths=lengths.clone())


def _dtype(case):
    return getattr(torch, case.get("dtype", "float32"))


def _cache_out(cache):
    return tuple(np.asarray(t) for t in (cache.k, cache.v, cache.k_scale, cache.v_scale,
                                         cache.lengths))


def case_prefill(mesh, case):
    from starpu_inference_server_tpu_torch.parallel.pipeline_decode import (
        init_stage_cache,
        pipelined_prefill,
    )

    spec, params = _setup(mesh, case)
    cache = init_stage_cache(spec, case["num_slots"], case["max_len"], mesh)
    cache, logits = pipelined_prefill(spec, params, cache, torch.from_numpy(case["ids"]),
                                      case["length"], case["slot"], mesh, torch.float32)
    return {"logits": None if logits is None else logits.numpy(), "cache": _cache_out(cache)}


def case_decode(mesh, case):
    from starpu_inference_server_tpu_torch.parallel.pipeline_decode import (
        pipelined_decode_step,
        pipelined_verify_step,
    )

    spec, params = _setup(mesh, case)
    cache = _cache_shard(mesh, case["cache"])
    fn = pipelined_verify_step if case["ids"].ndim == 2 else pipelined_decode_step
    mesh.stats.reset()
    cache, logits = fn(spec, params, cache, torch.from_numpy(case["ids"]),
                       torch.from_numpy(case["active"]), mesh, _dtype(case),
                       num_microgroups=case.get("microgroups", 0))
    return {"logits": None if logits is None else logits.numpy(), "cache": _cache_out(cache),
            "census": mesh.stats.snapshot()}


def case_prefill_decode(mesh, case):
    """A pipelined prefill of ``ids`` into slot 0, then one pipelined decode
    step of its greedy token (broadcast from rank 0, the same on every
    rank) with only slot 0 active: the first token, the step's logits
    (stage 0) and the step's collectives."""
    import torch.distributed as dist

    from starpu_inference_server_tpu_torch.parallel.pipeline_decode import (
        init_stage_cache,
        pipelined_decode_step,
        pipelined_prefill,
    )

    spec, params = _setup(mesh, case)
    cache = init_stage_cache(spec, case["num_slots"], case["max_len"], mesh)
    cache, logits = pipelined_prefill(spec, params, cache, torch.from_numpy(case["ids"]),
                                      case["length"], 0, mesh, torch.float32)
    first = torch.zeros((1,), dtype=torch.int64)
    if mesh.rank == 0:
        first[0] = int(torch.argmax(logits))
    dist.broadcast(first, 0)
    ids = torch.zeros((case["num_slots"],), dtype=torch.int32)
    active = torch.zeros((case["num_slots"],), dtype=torch.bool)
    ids[0], active[0] = int(first[0]), True
    mesh.stats.reset()
    cache, logits = pipelined_decode_step(spec, params, cache, ids, active, mesh, torch.float32)
    return {"first": int(first[0]), "logits": None if logits is None else logits.numpy(),
            "census": mesh.stats.snapshot()}


def case_logits(mesh, case):
    from starpu_inference_server_tpu_torch.parallel.pipeline import pipelined_decoder_logits

    spec = get_spec(case["family"], case["opts"])
    tree = init_params(spec, np.random.default_rng(case["seed"]))
    if case.get("quant"):
        from starpu_inference_server_tpu_torch.ops.quant import maybe_quantize_tree

        tree = maybe_quantize_tree(params_from_numpy(tree), case["quant"])
    params = params_from_numpy(tree)
    logits = pipelined_decoder_logits(spec, params, torch.from_numpy(case["ids"]), mesh,
                                      case["microbatches"], _dtype(case))
    return {"logits": logits.numpy()}


def _affine(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def case_forward(mesh, case):
    from starpu_inference_server_tpu_torch.parallel.pipeline import (
        pipeline_forward,
        stack_layers,
    )

    layers = [{"w": torch.from_numpy(w), "b": torch.from_numpy(b)} for w, b in case["layers"]]
    out = pipeline_forward(mesh, _affine, stack_layers(layers), torch.from_numpy(case["x"]),
                           case["microbatches"])
    return {"out": out.numpy()}


def case_engine(mesh, case):
    """The pipelined engine on every rank: rank 0 serves the prompts
    (greedy, queued before the loop starts), the others follow."""
    from starpu_inference_server_tpu_torch.serving.generation import (
        GenerationEngine,
        GenerationRequest,
    )

    spec = get_spec(case["family"], case["opts"])
    tree = init_params(spec, np.random.default_rng(case["seed"]))
    eng = GenerationEngine(spec, tree, dtype=torch.float32, mesh=mesh, family=case["family"],
                           **case["engine"])
    if mesh.rank != 0:
        follow(eng.pipe)
        return None
    try:
        reqs = [GenerationRequest(prompt_ids=np.asarray(p, np.int32),
                                  max_new_tokens=case["max_new"]) for p in case["prompts"]]
        for r in reqs:
            eng.submit(r)
        eng.start()
        try:
            tokens = [r.result(timeout=120.0) for r in reqs]
        finally:
            eng.stop()
        stats = eng.pipe.gather_stats()
    finally:
        eng.pipe.stop_followers()
    return {"tokens": tokens, "stats": stats}


CASES = {"prefill": case_prefill, "decode": case_decode, "logits": case_logits,
         "forward": case_forward, "engine": case_engine, "prefill_decode": case_prefill_decode}


def world(rank, world_size, init_method, payload, launchers=1):
    """Join a mesh of ``payload['axes']`` (pipe, model, expert) on the CPU,
    started by ``launchers`` launchers, and run every case of
    ``payload['cases']`` in order on this rank. Returns {case name:
    result}, with the rank's coordinates, launcher and the axes crossing
    launchers."""
    pipe, model, expert = payload["axes"]
    mesh = join_mesh(MeshAxes(pipe=pipe, model=model, expert=expert), rank, world_size,
                     init_method, "cpu", timeout_s=120.0, launchers=launchers)
    out = {"coords": dict(mesh.coords), "launcher": mesh.launcher, "crossing": mesh.crossing}
    for case in payload["cases"]:
        out[case["name"]] = CASES[case["kind"]](mesh, case)
    return out
