#!/usr/bin/env python3
"""How far a batch server's answer to one image depends on its batch-mates.

The schedule-replay client's ``--validate`` primes each of its five pool
inputs alone (batch 1) and then holds every response under load against
that answer, element by element (``np.allclose``, rtol = atol = 2e-2).
This probe builds a config's model as the port's server does
(``ModelEngine`` on ``build_model``, bf16 staging), feeds the client's
pool (``generate_inputs`` from seed 7) at batch 1 and inside padded
batches of every bucket, and prints for each bucket and compute route:
the outputs' scale, the largest difference to the batch-1 answer, how
many elements and rows the client's check would fail, whether the same
input in another row of one batch and the batch run again are bit-equal,
and a forward's host-clock ms (median of 5) and device busy ms
(torch.profiler's kernel sum) at bucket 1 and the largest. The routes,
TF32 off: the config as served (``ops/nn.py:conv2d``: cuDNN on chunks of
``CONV_ROWS`` images); one cuDNN call over the whole batch (the port's
route before the chunks), also with ``cudnn.deterministic``; one call an
image; the whole batch in f32 on the same bf16 operands; and FP32
compute. Runs on one GPU:

    python3 scripts/torch_batch_invariance_probe.py [config.yml ...]

(default: ci/perf/resnet152_ci_perf.yml and configs/resnet18_int8.yml).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from starpu_inference_server_tpu_torch.core.engine import ModelEngine  # noqa: E402
from starpu_inference_server_tpu_torch.ops import nn  # noqa: E402
from starpu_inference_server_tpu_torch.models.registry import build_model  # noqa: E402
from starpu_inference_server_tpu_torch.utils.config import load_config  # noqa: E402
from starpu_inference_server_tpu_torch.utils.input_generator import generate_inputs  # noqa: E402

POOL, SEED, RTOL, ATOL = 5, 7, 2e-2, 2e-2
served_conv = nn._cudnn_conv


def _whole_batch(xc, wc, stride, pads, groups):
    """One cuDNN call over the whole batch (the port's route before chunks)."""
    pt, pb, pl, pr = pads
    if pt != pb or pl != pr:
        return nn.F.conv2d(nn.F.pad(xc, (pl, pr, pt, pb)), wc, stride=stride, groups=groups)
    return nn.F.conv2d(xc, wc, stride=stride, padding=(pt, pl), groups=groups)


def _per_row(xc, wc, stride, pads, groups):
    return torch.cat([_whole_batch(xc[i:i + 1].contiguous(), wc, stride, pads, groups)
                      for i in range(xc.shape[0])])


def _fp32_whole_batch(xc, wc, stride, pads, groups):
    return _whole_batch(xc.float(), wc.float(), stride, pads, groups)


# route -> (compute dtype, cudnn.deterministic, conv in place of nn._cudnn_conv); TF32 off
ROUTES = {
    "served": ("BF16", False, served_conv),
    "bf16_whole_batch": ("BF16", False, _whole_batch),
    "bf16_whole_batch_deterministic": ("BF16", True, _whole_batch),
    "bf16_per_row": ("BF16", False, _per_row),
    "fp32_convs_whole_batch": ("BF16", False, _fp32_whole_batch),
    "fp32_compute": ("FP32", False, served_conv),
}


def busy_ms(fn) -> float:
    """Device busy time of ``fn()``: torch.profiler's kernel sum, in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def answers(engine, pool, bucket):
    """Each pool input's output inside a padded batch of ``bucket`` rows
    (row r holds pool input r % POOL)."""
    name = engine.cfg.inputs[0].name
    staged = engine.staging_specs()[0]
    dtype = torch.bfloat16 if staged.dtype == "BF16" else torch.float32
    rows = [pool[r % POOL][name][0] for r in range(bucket)]
    batch = torch.from_numpy(np.stack(rows)).to(dtype)
    out = engine.conform_outputs(engine.fetch(engine.run_padded({name: batch})))
    return out[engine.cfg.outputs[0].name]


def probe(path: str, route: str) -> dict:
    compute, deterministic, conv = ROUTES[route]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic
    nn._cudnn_conv = conv
    cfg = load_config(path)
    model = dataclasses.replace(cfg.model, compute_dtype=compute)
    cfg = dataclasses.replace(cfg, model=model)
    engine = ModelEngine(cfg, build_model(cfg.model, seed=cfg.seed, device="cuda"))
    rng = np.random.default_rng(SEED)
    pool = [generate_inputs(cfg.inputs, 1, rng) for _ in range(POOL)]
    alone = {i: answers(engine, [pool[i]] * POOL, 1)[0] for i in range(POOL)}
    again = {i: answers(engine, [pool[i]] * POOL, 1)[0] for i in range(POOL)}
    report = {"config": Path(path).name, "route": route,
              "batch1_repeat_bit_equal": all(np.array_equal(alone[i], again[i])
                                             for i in range(POOL)),
              "median_abs": float(np.median(np.abs(np.stack(list(alone.values()))))),
              "max_abs": float(np.abs(np.stack(list(alone.values()))).max()), "buckets": {}}
    for bucket in cfg.buckets:
        out = answers(engine, pool, bucket)
        repeat = answers(engine, pool, bucket)
        got = {r: out[r] for r in range(min(bucket, POOL))}
        diffs = [np.abs(got[r].astype(np.float64) - alone[r]) for r in got]
        fails = [int((~np.isclose(got[r].astype(np.float64), alone[r].astype(np.float64),
                                  rtol=RTOL, atol=ATOL)).sum()) for r in got]
        report["buckets"][bucket] = {
            "bit_equal_rows": sum(int(d.max() == 0) for d in diffs),
            "max_diff": float(max(d.max() for d in diffs)),
            "max_diff_over_max_abs": float(max(d.max() for d in diffs) / report["max_abs"]),
            "failing_elements": fails, "rows": len(got),
            # the same input in another row of the same batch, and the batch again
            "same_input_rows_bit_equal": all(np.array_equal(out[r], out[r % POOL])
                                             for r in range(bucket)),
            "repeat_bit_equal": bool(np.array_equal(out, repeat))}
    for bucket in (1, max(cfg.buckets)):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            answers(engine, pool, bucket)
            times.append((time.perf_counter() - t0) * 1e3)
        report[f"forward_host_ms_b{bucket}"] = sorted(times)[2]
        report[f"forward_busy_ms_b{bucket}"] = busy_ms(lambda: answers(engine, pool, bucket))
    nn._cudnn_conv = served_conv
    del engine
    torch.cuda.empty_cache()
    return report


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_batch_invariance_probe: needs a GPU", file=sys.stderr)
        return 1
    paths = argv or [str(ROOT / "ci/perf/resnet152_ci_perf.yml"),
                     str(ROOT / "configs/resnet18_int8.yml")]
    print(torch.cuda.get_device_name(0))
    for path in paths:
        for route in ROUTES:
            print(json.dumps(probe(path, route)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
