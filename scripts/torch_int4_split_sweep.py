#!/usr/bin/env python3
"""Sweep the split of K of the port's quantized matmul kernels on the card.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/torch_int4_split_sweep.py [int4_matmul] [int8_matmul] [int4_matmul_w4a8]

(all three without arguments). For llama-1b's dense shapes at the rows
the decoder gives each kernel (int4_matmul, K1: M = 128 decode, 1, 64,
256 and 512; int8_matmul, K2: M = 16 and 64 decode, 1; int4_matmul_w4a8,
K6: M = 16 decode, 64, 128, 1), it times the kernel (``csrc/quant_matmul.cuh``)
at each tile variant that holds the rows and each split count from 1 to
24 (device time: chip_smoke.time_ms, weights cycled past the L2), and
prints the pick of ``ops/matmul_kernels.py:matmul_plan`` beside the
sweep's best, the cycled ``torch.matmul`` bf16 yardstick on the
dequantized weight, and the wrapper's host time per call. Every sweep
point is checked against the plain version (relative max error printed).
"""

from __future__ import annotations

import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SPLITS = (1, 2, 3, 4, 6, 8, 9, 11, 12, 15, 16, 24)
ROWS = {"int4_matmul": (128, 1, 64, 256, 512), "int8_matmul": (16, 64, 1),
        "int4_matmul_w4a8": (16, 64, 128, 1)}
DECODE_ROWS = {"int4_matmul": 128, "int8_matmul": 16, "int4_matmul_w4a8": 16}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_int4_split_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from starpu_inference_server_tpu_torch.models.decoder import get_spec
    from starpu_inference_server_tpu_torch.ops import _build
    from starpu_inference_server_tpu_torch.ops import matmul_kernels as mk
    from starpu_inference_server_tpu_torch.ops.quant import pack_int4, unpack_int4

    kernels = argv or list(ROWS)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    _build.build_all(kernels)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16 = torch.bfloat16

    def operands(kernel, m, k, n, copies):
        """(kernel input, weights, scale, plain, bound C function's leading
        pointers, accumulator dtype, dequantized bf16 weight of copy i)"""
        sc = torch.rand(n, device=dev, generator=g) * 0.02 + 1e-3
        if kernel == "int8_matmul":
            ws = [torch.randint(-128, 128, (k, n), device=dev, generator=g, dtype=torch.int8)
                  for _ in range(copies)]
            x = torch.randn(m, k, device=dev, generator=g).to(bf16)
            return x, ws, sc, lambda w: mk.int8_matmul_plain(x, w, sc), \
                lambda w: (w.float() * sc).to(bf16), x
        ws = [pack_int4(torch.randint(-8, 8, (k, n), device=dev, generator=g, dtype=torch.int8))
              for _ in range(copies)]
        if kernel == "int4_matmul":
            x = torch.randn(m, k, device=dev, generator=g).to(bf16)
            return x, ws, sc, lambda w: mk.int4_matmul_plain(x, w, sc), \
                lambda w: (unpack_int4(w).float() * sc).to(bf16), x
        x_q = torch.randint(-127, 128, (m, k), device=dev, generator=g, dtype=torch.int8)
        sx = torch.rand(m, device=dev, generator=g) * 0.02 + 1e-3
        x_deq = (x_q.float() * sx[:, None]).to(bf16)
        return (x_q, sx), ws, sc, lambda w: mk.int4_matmul_w4a8_plain(x_q, sx, w, sc), \
            lambda w: (unpack_int4(w).float() * sc).to(bf16), x_deq

    def call(kernel, x, w, sc, variant, splits):
        xq = x[0] if isinstance(x, tuple) else x
        m, k = xq.shape
        n = w.shape[1]
        y = torch.empty((m, n), dtype=torch.float32, device=dev)
        acc = torch.int32 if kernel == "int4_matmul_w4a8" else torch.float32
        ws = torch.empty(splits * m * n, dtype=acc, device=dev) if splits > 1 else None
        wsp = ws.data_ptr() if ws is not None else None
        stream = _build.stream_ptr(xq)
        if kernel == "int4_matmul_w4a8":
            rc = mk._bound(kernel, "sis_int4_matmul_w4a8", 6, 5)(
                xq.data_ptr(), x[1].data_ptr(), w.data_ptr(), sc.data_ptr(), y.data_ptr(), wsp,
                m, n, k, variant, splits, stream)
        else:
            rc = mk._bound(kernel, f"sis_{kernel}", 5, 6)(
                xq.data_ptr(), w.data_ptr(), sc.data_ptr(), y.data_ptr(), wsp, m, n, k,
                _build.BF16, variant, splits, stream)
        _build.check(rc, kernel)
        return y

    def wrapper(kernel, x, w, sc):
        if kernel == "int4_matmul_w4a8":
            return mk.int4_matmul_w4a8(x[0], x[1], w, sc)
        return getattr(mk, kernel)(x, w, sc)

    spec = get_spec("llama-1b", {})
    shapes = cs._dense_shapes(spec)
    for kernel in kernels:
        wbytes = 1.0 if kernel == "int8_matmul" else 0.5
        for m in ROWS[kernel]:
            for name, (k, n) in shapes.items():
                if m != DECODE_ROWS[kernel] and name not in ("o", "gate_up", "lm_head"):
                    continue
                copies = cs._copies(k * n * wbytes)
                x, ws, sc, plain, deq, x_lib = operands(kernel, m, k, n, copies)
                ref = plain(ws[0])
                plan = mk.matmul_plan(kernel, m, n, k, sms)
                ktiles = math.ceil(k / mk.QMM_BK)
                points = []
                for variant, (bm, bn) in enumerate(mk.QMM_TILES):
                    if variant < plan.variant or variant > plan.variant + 1:
                        continue
                    for s in sorted(set(SPLITS) | {plan.splits}):
                        if s > ktiles:
                            continue
                        err = ((call(kernel, x, ws[0], sc, variant, s) - ref).abs().max()
                               / ref.abs().max()).item()
                        ms = cs._time_cycled(lambda i: call(kernel, x, ws[i], sc, variant, s),
                                             copies)
                        points.append((ms, variant, s, math.ceil(m / bm) * math.ceil(n / bn) * s,
                                       err))
                deqs = [deq(ws[i % copies]) for i in range(cs._copies(k * n * 2))]
                lib_ms = cs._time_cycled(lambda i: torch.matmul(x_lib, deqs[i]), len(deqs))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    wrapper(kernel, x, ws[0], sc)
                host_ms = (time.perf_counter() - t0) / 50 * 1e3
                torch.cuda.synchronize()
                pick = next(p for p in points if p[1] == plan.variant and p[2] == plan.splits)
                best = min(points)
                sweep = " ".join(f"v{v}s{s}({grid})={ms:.4f}" for ms, v, s, grid, _ in
                                 sorted(points, key=lambda p: (p[1], p[2])))
                print(f"{kernel} M={m} {name} K={k} N={n}: plan v{plan.variant} s{plan.splits} "
                      f"{pick[0]:.4f} ms, best v{best[1]} s{best[2]} {best[0]:.4f} ms "
                      f"({pick[0] / best[0]:.2f}x); torch.matmul bf16 cycled {lib_ms:.4f} ms; "
                      f"wrapper host {host_ms:.4f} ms a call; max rel err "
                      f"{max(p[4] for p in points):.1e}; sweep {sweep}", flush=True)
                del ws, deqs
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
