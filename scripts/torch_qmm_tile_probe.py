#!/usr/bin/env python3
"""Probe the shape of the quantized matmul body on the card (K1, K2, K6).

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/torch_qmm_tile_probe.py

``csrc/quant_matmul.cuh`` fixes a ring of ``kStages`` stages of ``kBK`` k
and three tile variants. This script copies the sources into
``build/qmm_probe/``, rewrites those constants in each copy (3, 4 or 6
stages of 64 k; 3 or 4 stages of 128 k) and adds tile variants to the
launch switch (64 x 128 as 8 warps of 32 rows, 64 x 256, 16 x 256,
32 x 128, 32 x 256), builds int4_matmul, int8_matmul and
int4_matmul_w4a8 from each copy with nvcc (registers and spills
printed), and times each at llama-1b's dense shapes at the rows the
decoder gives it, at the best split among a few (device time:
chip_smoke.time_ms, weights cycled past the L2). Every timed point is
checked against the plain version. Nothing of the port is changed.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

RINGS = ((3, 64), (4, 64), (6, 64), (3, 128), (4, 128))  # (stages, k per stage)
EXTRA_TILES = {  # variant index: (m16 tiles a warp, warps along M, warps along N)
    3: (2, 2, 4), 4: (4, 1, 8), 5: (1, 1, 8), 6: (2, 1, 4), 7: (2, 1, 8)}
KERNELS = ("int4_matmul", "int8_matmul", "int4_matmul_w4a8")
SPLITS = (1, 2, 3, 4, 6, 8, 11, 16, 24)


def tile_rows_cols(variant: int):
    mt, wm, wn = {0: (1, 1, 4), 1: (4, 1, 4), 2: (4, 2, 4), **EXTRA_TILES}[variant]
    return 16 * mt * wm, 32 * wn


def build(nvcc: str):
    """{(stages, bk, kernel): CDLL} of every ring, every kernel."""
    out = ROOT / "build" / "qmm_probe"
    shutil.rmtree(out, ignore_errors=True)
    procs = {}
    for stages, bk in RINGS:
        src = out / f"s{stages}k{bk}"
        shutil.copytree(ROOT / "starpu_inference_server_tpu_torch" / "csrc", src)
        head = (src / "quant_matmul.cuh").read_text()
        head = head.replace("constexpr int kBK = 64;", f"constexpr int kBK = {bk};")
        head = head.replace("constexpr int kStages = 3;", f"constexpr int kStages = {stages};")
        cases = "".join(f"    case {v}: return launch_tile<Op, {mt}, {wm}, {wn}>(args, splits, st);\n"
                        for v, (mt, wm, wn) in EXTRA_TILES.items())
        head = head.replace("    default: return static_cast<int>(cudaErrorInvalidValue);",
                            cases + "    default: return static_cast<int>(cudaErrorInvalidValue);")
        (src / "quant_matmul.cuh").write_text(head)
        for name in KERNELS:
            lib = src / f"{name}.so"
            procs[(stages, bk, name)] = (lib, subprocess.Popen(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                 "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(src), "-o", str(lib),
                 str(src / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{report}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", report))
        print(f"ptxas {key}: at most {max(regs)} registers, {spills} bytes of spill stores",
              flush=True)
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_qmm_tile_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from starpu_inference_server_tpu_torch.models.decoder import get_spec
    from starpu_inference_server_tpu_torch.ops import _build
    from starpu_inference_server_tpu_torch.ops import matmul_kernels as mk
    from starpu_inference_server_tpu_torch.ops.quant import pack_int4

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    libs = build(_build.nvcc_path())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    shapes = cs._dense_shapes(get_spec("llama-1b", {}))

    def bind(lib, kernel):
        if kernel == "int4_matmul_w4a8":
            fn, n_ptrs, n_ints = lib.sis_int4_matmul_w4a8, 6, 5
        else:
            fn, n_ptrs, n_ints = getattr(lib, f"sis_{kernel}"), 5, 6
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn

    for kernel, rows, variants in (
            ("int8_matmul", 16, (0, 5, 6, 7)), ("int8_matmul", 64, (1, 3, 2, 4)),
            ("int4_matmul", 128, (1, 3, 2, 4)), ("int4_matmul", 64, (1, 3, 2, 4)),
            ("int4_matmul_w4a8", 16, (0, 5, 6, 7)), ("int4_matmul_w4a8", 64, (1, 3, 2, 4))):
        for layer, (k, n) in shapes.items():
            copies = cs._copies(k * n * (1.0 if kernel == "int8_matmul" else 0.5))
            sc = torch.ones(n, device=dev)
            if kernel == "int8_matmul":
                ws = [torch.randint(-128, 128, (k, n), device=dev, generator=g, dtype=torch.int8)
                      for _ in range(copies)]
                x = torch.randn(rows, k, device=dev, generator=g).to(torch.bfloat16)
                ref = mk.int8_matmul_plain(x, ws[0], sc)
            else:
                ws = [pack_int4(torch.randint(-8, 8, (k, n), device=dev, generator=g,
                                              dtype=torch.int8)) for _ in range(copies)]
                if kernel == "int4_matmul":
                    x = torch.randn(rows, k, device=dev, generator=g).to(torch.bfloat16)
                    ref = mk.int4_matmul_plain(x, ws[0], sc)
                else:
                    x = torch.randint(-127, 128, (rows, k), device=dev, generator=g,
                                      dtype=torch.int8)
                    sx = torch.ones(rows, device=dev)
                    ref = mk.int4_matmul_w4a8_plain(x, sx, ws[0], sc)
            points = []
            for (stages, bk, name), lib in libs.items():
                if name != kernel:
                    continue
                fn = bind(lib, kernel)
                for variant in variants if (stages, bk) == (3, 64) else variants[:1]:
                    best = None
                    for s in SPLITS:
                        if s > -(-k // bk):
                            continue
                        y = torch.empty(rows, n, device=dev)
                        part = torch.empty(s * rows * n, device=dev) if s > 1 else None
                        ptr = part.data_ptr() if part is not None else None

                        def call(i):
                            if kernel == "int4_matmul_w4a8":
                                return fn(x.data_ptr(), sx.data_ptr(), ws[i].data_ptr(),
                                          sc.data_ptr(), y.data_ptr(), ptr, rows, n, k, variant,
                                          s, _build.stream_ptr(x))
                            return fn(x.data_ptr(), ws[i].data_ptr(), sc.data_ptr(),
                                      y.data_ptr(), ptr, rows, n, k, _build.BF16, variant, s,
                                      _build.stream_ptr(x))

                        _build.check(call(0), kernel)
                        torch.cuda.synchronize()
                        err = ((y - ref).abs().max() / ref.abs().max()).item()
                        if err > 1e-4:
                            raise RuntimeError(f"{kernel} s{stages}k{bk} v{variant} split {s}: "
                                               f"relative error {err:.1e}")
                        ms = cs._time_cycled(call, copies)
                        if best is None or ms < best[0]:
                            best = (ms, s)
                    bm, bn = tile_rows_cols(variant)
                    points.append(f"{stages}x{bk}k {bm}x{bn}={best[0]:.4f}(s{best[1]})")
            print(f"{kernel} M={rows} {layer} K={k} N={n} on {card}: " + " ".join(points),
                  flush=True)
            del ws
    return 0


if __name__ == "__main__":
    sys.exit(main())
