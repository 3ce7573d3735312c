"""Rank bodies of the spawned-world tests of the port's GSPMD mode, the
batch engine on a mesh and ring attention.

``parallel/launch.py:run_world`` runs :func:`world` on every rank of a
fresh world of CPU processes; a spawned process imports this module
again, so it imports torch and the port only (never jax or the JAX
package). Every rank builds the same seeded weights; each case gets its
inputs as numpy arrays from the parent test (which computes the JAX
references) and returns numpy arrays (the engine cases: from rank 0).
"""

from __future__ import annotations

import numpy as np
import torch

from starpu_inference_server_tpu_torch.parallel.launch import follow, join_mesh
from starpu_inference_server_tpu_torch.parallel.mesh import MeshAxes


def _settings(case):
    from starpu_inference_server_tpu_torch.utils.config import ModelSettings, QuantMode

    return ModelSettings(family=case["family"], options=dict(case.get("options", {})),
                         compute_dtype=case.get("compute_dtype", "FP32"),
                         quantization=QuantMode(case.get("quant", "none")))


def _w8a8(case) -> None:
    from starpu_inference_server_tpu_torch.ops import nn

    nn.set_w8a8(case.get("quant") in ("w8a8", "w4a8"))


def case_forward(mesh, case):
    """``parallel.partition.sharded_forward`` on the whole batch."""
    from starpu_inference_server_tpu_torch.models.registry import build_model
    from starpu_inference_server_tpu_torch.parallel.partition import sharded_forward

    _w8a8(case)
    model = build_model(_settings(case), seed=case.get("seed", 0), device="cpu")
    mesh.stats.reset()
    shard, forward = sharded_forward(model, mesh)
    inputs = {k: torch.from_numpy(v) for k, v in case["inputs"].items()}
    out = forward(inputs)
    res = {"out": {k: v.to(torch.float32).numpy() for k, v in out.items()},
           "census": mesh.stats.snapshot()}
    if case.get("single"):  # the same model on this rank alone, the whole batch
        with torch.inference_mode():
            res["single"] = {k: v.to(torch.float32).numpy() for k, v in model.apply(inputs).items()}
    _w8a8({})
    return res


def case_row_dense(mesh, case):
    """A W8A8 row-parallel dense layer on the rank's block of the
    contraction dim: its exact s32 sums (the integers, as float64) and its
    output, against the single-device layer on the whole row. With
    ``bits`` 4 the weight is packed int4 and the kernel routes are forced
    on (W4A8: K6, its plain version here), as on the card."""
    from starpu_inference_server_tpu_torch.ops import matmul_kernels as mk
    from starpu_inference_server_tpu_torch.ops import nn
    from starpu_inference_server_tpu_torch.ops.quant import pack_int4, quantize_activations

    nn.set_w8a8(True)
    x = torch.from_numpy(case["x"])
    w = {"w_q": torch.from_numpy(case["w_q"]), "scale": torch.from_numpy(case["scale"]),
         "bits": case.get("bits", 8)}
    b = torch.from_numpy(case["b"])
    tp, m = mesh.size("model"), mesh.coord("model")
    k = x.shape[1] // tp
    xl = x[:, m * k:(m + 1) * k]
    wl = dict(w, w_q=w["w_q"][m * k:(m + 1) * k])
    x_q, _ = nn._quantize_rows(xl, mesh)
    whole_q, _ = quantize_activations(x)
    if w["bits"] == 4:
        nn.set_use_kernels(True)
        w, wl = ({"w_p4": pack_int4(leaf["w_q"]), "scale": leaf["scale"], "bits": 4}
                 for leaf in (w, wl))
        ones = torch.ones(x.shape[0])

        def k6(q, leaf):
            return mk.int4_matmul_w4a8(q, ones, leaf["w_p4"], torch.ones(leaf["scale"].numel()))

        sums = nn._sum_integers(k6(x_q, wl), mesh)
        want_sums = nn._sum_integers(k6(whole_q, w))
    else:
        sums = nn._int_dot(x_q, wl["w_q"], mesh)
        want_sums = nn._int_dot(whole_q, w["w_q"])
    out = nn.dense({"w": wl, "b": b}, xl, torch.float32, mesh=mesh)
    want = nn.dense({"w": w, "b": b}, x, torch.float32)
    nn.set_w8a8(False)
    nn.set_use_kernels(None)
    return {"sums": sums.numpy(), "out": out.numpy(), "single_sums": want_sums.numpy(),
            "single_out": want.numpy()}


def _shell(cfg):
    from starpu_inference_server_tpu_torch.models.registry import BuiltModel, get_family
    from starpu_inference_server_tpu_torch.utils.dtypes import torch_dtype

    return BuiltModel(definition=get_family(cfg.model.family, cfg.model.options), params=None,
                      compute_dtype=torch_dtype(cfg.model.compute_dtype),
                      quant=cfg.model.quantization, device=torch.device("cpu"))


def _engine(mesh, raw):
    """Every rank's ``ModelEngine`` of a config: rank 0 with the whole
    model, the others with a shell."""
    from starpu_inference_server_tpu_torch.core.engine import ModelEngine
    from starpu_inference_server_tpu_torch.models.registry import build_model
    from starpu_inference_server_tpu_torch.utils.config import parse_config

    cfg = parse_config(raw)
    model = build_model(cfg.model, seed=cfg.seed, device="cpu") if mesh.rank == 0 else _shell(cfg)
    return cfg, ModelEngine(cfg, model, mesh=mesh)


def case_engine_forward(mesh, case):
    """``ModelEngine`` on the mesh: rank 0 runs padded batches, the others
    follow. Returns the logits of each batch and the engine's granularity."""
    cfg, engine = _engine(mesh, case["config"])
    if mesh.rank != 0:
        follow(engine.worker)
        return None
    try:
        outs = [engine.conform_outputs(engine.fetch(engine.run_padded(
            {k: torch.from_numpy(v) for k, v in batch.items()})))
            for batch in case["batches"]]
    finally:
        engine.worker.stop_followers()
    return {"outs": outs, "granularity": engine.min_batch_granularity(),
            "buckets": list(engine.buckets), "bucket_1": engine.effective_bucket(1),
            "pipelined": engine.pipelined}


def case_runner(mesh, case):
    """The batch pipeline (queue -> collector -> lanes -> engine) on rank 0
    over a mesh engine: one job per request, each request's outputs; then
    a hot reload (every rank's shard swapped) and the same requests again."""
    import threading

    from starpu_inference_server_tpu_torch.core.job import InferenceJob
    from starpu_inference_server_tpu_torch.models.registry import build_model
    from starpu_inference_server_tpu_torch.serving.queue import InferenceQueue
    from starpu_inference_server_tpu_torch.serving.runner import TaskRunner

    cfg, engine = _engine(mesh, case["config"])
    if mesh.rank != 0:
        follow(engine.worker)
        return None

    def serve(requests):
        queue = InferenceQueue(cfg.max_queue_size)
        runner = TaskRunner(cfg, engine, queue)
        runner.start()
        results, done = {}, threading.Event()

        def completion(job, outputs, error):
            results[job.request_id] = error if error is not None else outputs
            if len(results) == len(requests):
                done.set()

        try:
            for i, inputs in enumerate(requests):
                job = InferenceJob(inputs, request_id=f"m{i}", completion=completion)
                job.timing.stamp("enqueued_at")
                queue.push(job)
            assert done.wait(timeout=120.0), "the mesh pipeline did not complete"
            lanes = [lane.name() for lane in runner.lanes]
        finally:
            runner.stop(drain=False)
        return [results[f"m{i}"] for i in range(len(requests))], lanes

    try:
        first, lanes = serve(case["requests"])
        engine.reload(build_model(cfg.model, seed=cfg.seed + 1, device="cpu"))
        second, _ = serve(case["requests"])
    finally:
        engine.worker.stop_followers()
    return {"first": first, "second": second, "lanes": lanes,
            "num_devices": engine.num_devices(), "device_name": engine.device_name(),
            "buckets": list(engine.buckets), "bucket_1": engine.effective_bucket(1),
            "bucket_4": engine.effective_bucket(4)}


def case_generate(mesh, case):
    """The GSPMD-mode generation engine on every rank (greedy, queued
    before the loop starts): rank 0's token streams and every rank's
    collectives."""
    from starpu_inference_server_tpu_torch.models.decoder import get_spec, init_params
    from starpu_inference_server_tpu_torch.ops import nn
    from starpu_inference_server_tpu_torch.serving.generation import (
        GenerationEngine,
        GenerationRequest,
    )
    from starpu_inference_server_tpu_torch.weights import rank_shard

    spec = get_spec(case["family"], case["opts"])
    tree = init_params(spec, np.random.default_rng(case["seed"]))
    if case.get("quant"):
        from starpu_inference_server_tpu_torch.ops.quant import maybe_quantize_tree
        from starpu_inference_server_tpu_torch.weights import params_from_numpy

        tree = maybe_quantize_tree(params_from_numpy(tree), case["quant"])
    # every rank draws the whole tree from the seed and keeps its shard
    shard = rank_shard(tree, spec, case["family"], mesh.coords, mesh.shape)
    nn.set_w8a8(bool(case.get("w8a8")))
    k6_calls = [0]
    if case.get("kernels"):  # the card's routes, the kernels' plain versions here
        from starpu_inference_server_tpu_torch.ops import matmul_kernels as mk

        nn.set_use_kernels(True)
        real = mk.int4_matmul_w4a8

        def counted(*args):
            k6_calls[0] += 1
            return real(*args)

        mk.int4_matmul_w4a8 = counted
    draft = {}
    if case.get("draft") and mesh.rank == 0:  # the draft model lives on rank 0
        d = case["draft"]
        draft_spec = get_spec(d["family"], d["opts"])
        draft = {"draft_spec": draft_spec,
                 "draft_params": init_params(draft_spec, np.random.default_rng(d["seed"]))}
    eng = GenerationEngine(spec, shard, dtype=torch.float32, mesh=mesh, family=case["family"],
                           device="cpu", **case["engine"], **draft)
    if mesh.rank != 0:
        follow(eng.worker)
        _reset_modes()
        return None
    try:
        eng.worker.reset_stats()
        reqs = [GenerationRequest(prompt_ids=np.asarray(p, np.int32),
                                  max_new_tokens=case["max_new"]) for p in case["prompts"]]
        for r in reqs:
            eng.submit(r)
        eng.start()
        try:
            tokens = [r.result(timeout=120.0) for r in reqs]
        finally:
            eng.stop()
        stats = eng.worker.gather_stats()
    finally:
        eng.worker.stop_followers()
        _reset_modes()
    return {"tokens": tokens, "stats": stats, "drafted": eng.drafted_tokens,
            "prefix_hits": eng.prefix_hits, "k6_calls": k6_calls[0]}


def _gspmd_engine(mesh, case):
    """(spec, the GSPMD-mode generation engine) of the case's seeded FP32
    tree, every rank keeping its shard."""
    from starpu_inference_server_tpu_torch.models.decoder import get_spec, init_params
    from starpu_inference_server_tpu_torch.serving.generation import GenerationEngine
    from starpu_inference_server_tpu_torch.weights import rank_shard

    spec = get_spec(case["family"], case["opts"])
    tree = init_params(spec, np.random.default_rng(case["seed"]))
    shard = rank_shard(tree, spec, case["family"], mesh.coords, mesh.shape)
    return spec, GenerationEngine(spec, shard, dtype=torch.float32, mesh=mesh,
                                  family=case["family"], device="cpu", **case["engine"])


def case_copy_rows(mesh, case):
    """A prefill into slot 0 (data group 0), its rows copied over the last
    slot (the last group) by ``GspmdWorker.copy_rows``, then one decode
    step on both: rank 0's two logits rows and the all-gathers over data
    the copy made."""
    from starpu_inference_server_tpu_torch.parallel.census import collectives_by_axis

    _, eng = _gspmd_engine(mesh, case)
    if mesh.rank != 0:
        follow(eng.worker)
        return None
    w, last = eng.worker, eng.num_slots - 1
    try:
        prompt = torch.tensor(case["prompt"], dtype=torch.int32)
        w.prefill(prompt, len(prompt), 0)
        w.reset_stats()
        w.copy_rows(0, last)
        gathered = [collectives_by_axis(st["collectives"]).get("all-gather", {}).get("data", 0)
                    for st in w.gather_stats()]
        w.cache.lengths[last] = len(prompt)
        ids = torch.zeros(eng.num_slots, dtype=torch.int32)
        active = torch.zeros(eng.num_slots, dtype=torch.bool)
        ids[[0, last]], active[[0, last]] = 5, True
        logits = w.decode(ids, active)[[0, last]]
    finally:
        w.stop_followers()
    return {"logits": logits.numpy(), "gathered": min(gathered)}


def case_step_census(mesh, case):
    """One decode step of the GSPMD worker after a prefill into slot 0:
    every rank's collectives in that step alone, and the rank's (q, kv)
    heads."""
    from starpu_inference_server_tpu_torch.models.decoder import local_heads

    spec, eng = _gspmd_engine(mesh, case)
    if mesh.rank != 0:
        follow(eng.worker)
        return None
    w = eng.worker
    try:
        prompt = torch.tensor(case["prompt"], dtype=torch.int32)
        w.prefill(prompt, len(prompt), 0)
        w.reset_stats()
        ids = torch.zeros(eng.num_slots, dtype=torch.int32)
        active = torch.zeros(eng.num_slots, dtype=torch.bool)
        ids[0], active[0] = 5, True
        w.decode(ids, active)
        stats = w.gather_stats()
    finally:
        w.stop_followers()
    return {"census": [st["collectives"] for st in stats], "heads": local_heads(spec, mesh),
            "cache_heads": w.cache.k[0].shape[2]}


def _reset_modes() -> None:
    from starpu_inference_server_tpu_torch.ops import nn

    nn.set_w8a8(False)
    nn.set_use_kernels(None)


def case_ring(mesh, case):
    """``ring_causal_attention`` on the rank's sequence block of q, k, v,
    the blocks gathered back along the sequence."""
    from starpu_inference_server_tpu_torch.parallel.collectives import all_gather
    from starpu_inference_server_tpu_torch.parallel.ring_attention import ring_causal_attention

    axis = case["axis"]
    n, i = mesh.size(axis), mesh.coord(axis)
    q, k, v = (torch.from_numpy(case[name]) for name in ("q", "k", "v"))
    tl = q.shape[1] // n
    block = slice(i * tl, (i + 1) * tl)
    out = ring_causal_attention(q[:, block], k[:, block], v[:, block], mesh, axis,
                                rep=case["rep"])
    return {"out": all_gather(mesh, out, axis, dim=1).numpy()}


def case_seqpar(mesh, case):
    """``sequence_parallel_decoder_logits`` on the whole tree and ids."""
    from starpu_inference_server_tpu_torch.models.decoder import get_spec, init_params
    from starpu_inference_server_tpu_torch.parallel.ring_attention import (
        sequence_parallel_decoder_logits,
    )
    from starpu_inference_server_tpu_torch.weights import params_from_numpy

    spec = get_spec(case["family"], case["opts"])
    params = params_from_numpy(init_params(spec, np.random.default_rng(case["seed"])))
    if case.get("quant"):
        from starpu_inference_server_tpu_torch.ops.quant import maybe_quantize_tree

        params = maybe_quantize_tree(params, case["quant"])
    mesh.stats.reset()
    logits = sequence_parallel_decoder_logits(spec, params, torch.from_numpy(case["ids"]), mesh,
                                              torch.float32)
    return {"logits": logits.numpy(), "census": mesh.stats.snapshot()}


CASES = {"forward": case_forward, "row_dense": case_row_dense,
         "engine_forward": case_engine_forward, "runner": case_runner,
         "generate": case_generate, "copy_rows": case_copy_rows,
         "step_census": case_step_census, "ring": case_ring,
         "seqpar": case_seqpar}


def world(rank, world_size, init_method, payload, launchers=1):
    """Join a CPU mesh of ``payload['axes']`` (a dict of axis sizes),
    started by ``launchers`` launchers, and run every case of
    ``payload['cases']`` in order on this rank. Returns {case name:
    result}, with the rank's coordinates, launcher and the axes crossing
    launchers."""
    mesh = join_mesh(MeshAxes(**payload["axes"]), rank, world_size, init_method, "cpu",
                     timeout_s=120.0, launchers=launchers)
    out = {"coords": dict(mesh.coords), "launcher": mesh.launcher, "crossing": mesh.crossing}
    for case in payload["cases"]:
        out[case["name"]] = CASES[case["kind"]](mesh, case)
    return out
