#!/usr/bin/env python3
"""Sweep int4_matmul's split of K on the card (PyTorch/CUDA port, kernel K1).

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/torch_int4_split_sweep.py

For llama-1b's dense shapes at the rows the decoder gives them (M = 128
decode, 1, 64, 256 and 512), it times ``csrc/int4_matmul.cu`` at each tile
variant that holds the rows and each split count from 1 to 24 (device time:
chip_smoke.time_ms, weights cycled past the L2), and prints the pick of
``ops/matmul_kernels.py:int4_matmul_plan`` beside the sweep's best, the
cycled ``torch.matmul`` bf16 yardstick, and the wrapper's host time per
call. Every sweep point is checked against the plain version (relative
max error printed).
"""

from __future__ import annotations

import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SPLITS = (1, 2, 3, 4, 6, 8, 9, 11, 12, 15, 16, 24)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_int4_split_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from starpu_inference_server_tpu_torch.models.decoder import get_spec
    from starpu_inference_server_tpu_torch.ops import _build
    from starpu_inference_server_tpu_torch.ops import matmul_kernels as mk
    from starpu_inference_server_tpu_torch.ops.quant import pack_int4, unpack_int4

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    _build.build_all(["int4_matmul"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = mk._bound("int4_matmul", "sis_int4_matmul", 5, 6)

    def call(x, w, sc, variant, splits):
        m, k = x.shape
        n = w.shape[1]
        y = torch.empty((m, n), dtype=torch.float32, device=dev)
        ws = torch.empty(splits * m * n, dtype=torch.float32, device=dev) if splits > 1 else None
        rc = fn(x.data_ptr(), w.data_ptr(), sc.data_ptr(), y.data_ptr(),
                ws.data_ptr() if ws is not None else None, m, n, k, _build.BF16, variant, splits,
                _build.stream_ptr(x))
        _build.check(rc, "int4_matmul")
        return y

    spec = get_spec("llama-1b", {})
    hq, hkv, d = spec.q_heads, spec.kv_heads, spec.head_dim
    shapes = {"qkv": (spec.hidden, (hq + 2 * hkv) * d), "o": (hq * d, spec.hidden),
              "gate_up": (spec.hidden, 2 * spec.intermediate),
              "down": (spec.intermediate, spec.hidden), "lm_head": (spec.hidden, spec.vocab)}
    for m in (128, 1, 64, 256, 512):
        for name, (k, n) in shapes.items():
            if m != 128 and name not in ("o", "gate_up", "lm_head"):
                continue
            copies = cs._copies(k * n // 2)
            w4s = [pack_int4(torch.randint(-7, 8, (k, n), device=dev, generator=g,
                                           dtype=torch.int8)) for _ in range(copies)]
            sc = torch.rand(n, device=dev, generator=g) * 0.02 + 1e-3
            x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
            ref = mk.int4_matmul_plain(x, w4s[0], sc)
            plan = mk.int4_matmul_plan(m, n, k, sms)
            ktiles = math.ceil(k / mk.INT4_BK)
            points = []
            for variant, (bm, bn) in enumerate(mk.INT4_TILES):
                if variant < plan.variant or variant > plan.variant + 1:
                    continue
                for s in SPLITS:
                    if s > ktiles:
                        continue
                    err = ((call(x, w4s[0], sc, variant, s) - ref).abs().max()
                           / ref.abs().max()).item()
                    ms = cs._time_cycled(lambda i: call(x, w4s[i], sc, variant, s), copies)
                    points.append((ms, variant, s, math.ceil(m / bm) * math.ceil(n / bn) * s, err))
            deq = [(unpack_int4(w4s[i % copies]).float() * sc).to(torch.bfloat16)
                   for i in range(cs._copies(k * n * 2))]
            lib_ms = cs._time_cycled(lambda i: torch.matmul(x, deq[i]), len(deq))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                mk.int4_matmul(x, w4s[0], sc)
            host_ms = (time.perf_counter() - t0) / 50 * 1e3
            torch.cuda.synchronize()
            pick = next(p for p in points if p[1] == plan.variant and p[2] == plan.splits)
            best = min(points)
            sweep = " ".join(f"v{v}s{s}({grid})={ms:.4f}" for ms, v, s, grid, _ in
                             sorted(points, key=lambda p: (p[1], p[2])))
            print(f"M={m} {name} K={k} N={n}: plan v{plan.variant} s{plan.splits} "
                  f"{pick[0]:.4f} ms, best v{best[1]} s{best[2]} {best[0]:.4f} ms "
                  f"({pick[0] / best[0]:.2f}x); torch.matmul bf16 cycled {lib_ms:.4f} ms; wrapper "
                  f"host {host_ms:.4f} ms a call; max rel err {max(p[4] for p in points):.1e}; "
                  f"sweep {sweep}", flush=True)
            del w4s, deq
    return 0


if __name__ == "__main__":
    sys.exit(main())
