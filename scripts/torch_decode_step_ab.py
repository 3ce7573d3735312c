#!/usr/bin/env python3
"""The int4 decode step of configs/llama_decoder.yml, one or more trees in one run.

Run on a machine with an NVIDIA GPU, from the root of a checkout:

    python3 scripts/torch_decode_step_ab.py TREE [TREE ...]

Each TREE is the root of a checkout of the repository (``.`` for this
one, or an older commit unpacked with ``git archive``); each is measured
in a fresh process, in the order given (for an A/B on one card: parent,
change, change, parent). Per tree it builds the port's kernels, builds the
engine from the config (llama-1b, int4, random weights from its seed),
serves the 128 greedy requests of chip_smoke.py's decoder serving phase
(after a short warm-up run) and prints the host clock per decode step and
``admit``; then, with all 128 slots busy, it drives decode blocks by hand at
depth 1 and prints one block's host clock and, from a torch.profiler trace
of the next, its device busy time and the host's self-CPU table (where the
tree replays a CUDA graph for the block, ``cudaGraphLaunch`` stands in the
table in place of the ``cudaLaunchKernel`` calls). The first tokens of
three streams are printed so the trees' outputs can be compared. Last it
times the tree's int8_matmul and int4_matmul_w4a8 at llama-1b's gate_up
(K = 2048, N = 11008) at their decode rows, with the tree's own
``chip_smoke.time_ms`` on weights cycled past the L2. Only the engine and
kernel API that every tree shares is used.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def measure(root: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from starpu_inference_server_tpu_torch.ops import _build
    from starpu_inference_server_tpu_torch.serving.generation import (
        GenerationRequest, build_generation_engine,
    )
    from starpu_inference_server_tpu_torch.utils.config import load_config

    print(f"tree {root}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    engine = build_generation_engine(load_config(f"{root}/configs/llama_decoder.yml"),
                                      device="cuda")
    rng = np.random.default_rng(11)
    vocab = engine.spec.vocab
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in [40, 200, 600, 40] + [64] * 124]

    def serve(new):
        for key in engine.loop_timers:
            engine.loop_timers[key] = 0.0
        steps0 = engine.steps
        reqs = [GenerationRequest(prompt_ids=p, max_new_tokens=new) for p in prompts]
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        engine.start()
        try:
            outs = [r.result(timeout=600) for r in reqs]
        finally:
            engine.stop()
        wall = time.perf_counter() - t0
        steps = engine.steps - steps0
        t = engine.loop_timers
        print(f"serve {new} tokens: wall {wall:.3f} s, {steps} steps, step {t['step']:.3f} s = "
              f"{t['step'] / steps * 1e3:.2f} ms a step, admit {t['admit']:.3f} s, dispatch "
              f"{t['dispatch']:.3f} s, consume {t['consume']:.3f} s", flush=True)
        return outs

    serve(8)  # warm-up
    outs = serve(32)
    steps = engine.steps_per_sync
    reqs = [GenerationRequest(prompt_ids=rng.integers(0, vocab, 16).astype(np.int32),
                              max_new_tokens=4 * steps) for _ in range(engine.num_slots)]
    for r in reqs:
        engine.submit(r)
    for _ in range(len(reqs)):
        if engine.active_count() == engine.num_slots:
            break
        engine._admit_pending()
        engine._land_prefills(force=True)

    def block():
        snap = engine._snapshot_active()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = engine._dispatch_block(snap["ids_dev"], snap["progress_dev"], snap)
        t1 = time.perf_counter()
        engine._consume_block(rec)
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    block()
    dispatch, consume = block()
    print(f"block of {steps} steps x {engine.num_slots} slots: dispatch {dispatch:.2f} ms, consume "
          f"{consume:.2f} ms ({(dispatch + consume) / steps:.2f} ms a step)", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        block()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    print(f"block device busy {busy:.2f} ms ({busy / steps:.2f} ms a step)", flush=True)
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=20,
                                    max_name_column_width=50), flush=True)
    engine.start()
    try:
        for r in reqs:
            r.result(timeout=600)
    finally:
        engine.stop()
    print("streams " + json.dumps([o[:4] for o in outs[:3]]), flush=True)
    del engine
    torch.cuda.empty_cache()
    matmuls(root)


def matmuls(root: str) -> None:
    """int8_matmul (M = 16, 64) and int4_matmul_w4a8 (M = 16) at gate_up."""
    import torch

    import chip_smoke as cs
    from starpu_inference_server_tpu_torch.ops import matmul_kernels as mk
    from starpu_inference_server_tpu_torch.ops.quant import pack_int4

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    k, n = 2048, 11008
    copies = 6  # 6 x 22.5 MB int8 weights: past the 50 MB L2
    wqs = [torch.randint(-128, 128, (k, n), device=dev, generator=g, dtype=torch.int8)
           for _ in range(copies)]
    w4s = [pack_int4(torch.randint(-8, 8, (k, n), device=dev, generator=g, dtype=torch.int8))
           for _ in range(copies)]
    sc = torch.rand(1, n, device=dev, generator=g) * 0.01 + 1e-3
    for m in (16, 64):
        x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
        it = iter(range(10 ** 9))
        ms = cs.time_ms(lambda: mk.int8_matmul(x, wqs[next(it) % copies], sc))
        print(f"int8_matmul M={m} K={k} N={n}: {ms:.4f} ms", flush=True)
    x_q = torch.randint(-127, 128, (16, k), device=dev, generator=g, dtype=torch.int8)
    sx = torch.rand(16, 1, device=dev, generator=g) * 0.02 + 1e-3
    it = iter(range(10 ** 9))
    ms = cs.time_ms(lambda: mk.int4_matmul_w4a8(x_q, sx, w4s[next(it) % copies], sc))
    print(f"int4_matmul_w4a8 M=16 K={k} N={n}: {ms:.4f} ms", flush=True)


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        measure(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in argv:
        rc |= subprocess.call([sys.executable, __file__, "--one", tree])
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
