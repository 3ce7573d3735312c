#!/usr/bin/env python3
"""Probe the shape of the decode-side attention body on the card (K3, K9,
K10 and their flat twins: ``csrc/decode_mma.cuh``).

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/torch_decode_attention_probe.py

This script copies the sources of ``csrc/decode_mma.cuh`` into
``build/decode_probe/``, rewrites each copy into a variant
(``VARIANTS``: a 3-stage ring, and a floor in which every warp skips
its arithmetic), builds decode_attention,
window_decode_attention and paged_decode_attention from each copy with nvcc (registers and spills
printed), and times each at llama-1b's heads (8 KV heads, rep 4, D 64)
at the shapes the decoder gives it, at each of a few split counts
(device time: chip_smoke.time_ms, caches cycled past the L2):

- K3 at 128 slots: the graphed decode block's contexts (16-48
  positions), the burst's (80-120) and random lengths up to 1024;
- K3 at 16 slots (the W4A8 engine), 4 and 1, random lengths;
- K9 at 16 slots, W = 5 and 9, and at 4 and 1 slot, W = 5, random
  lengths;
- K10 at 64 slots, pages of 256.

Every timed point of a checked variant is held against the plain version
(2^-7 |ref| + 1e-3). Nothing of the port is changed.
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

# name: (replacements in decode_mma.cuh, checked against the plain version)
VARIANTS = {
    "base": ((), True),
    "3 stages": ((("constexpr int kStages = 2;", "constexpr int kStages = 3;"),), True),
    # the floor of staging and merging: every warp skips its arithmetic
    "loads only": ((("if (pos0 >= end) continue;", "continue;"),), False),
}
LIBS = ("decode_attention", "window_decode_attention", "paged_decode_attention")
HKV, REP, D, T = 8, 4, 64, 1024


def build(nvcc: str) -> dict:
    """{(variant, lib): CDLL}."""
    out = ROOT / "build" / "decode_probe"
    shutil.rmtree(out, ignore_errors=True)
    procs = {}
    for i, (variant, (edits, _)) in enumerate(VARIANTS.items()):
        src = out / f"v{i}"
        shutil.copytree(ROOT / "starpu_inference_server_tpu_torch" / "csrc", src)
        head = (src / "decode_mma.cuh").read_text()
        for old, new in edits:
            if old not in head:
                raise RuntimeError(f"variant {variant}: {old!r} not in decode_mma.cuh")
            head = head.replace(old, new)
        (src / "decode_mma.cuh").write_text(head)
        for lib in LIBS:
            so = src / f"{lib}.so"
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                   "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(src), "-o",
                   str(so), str(src / f"{lib}.cu")]
            procs[(variant, lib)] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{report}")
        regs = {}
        for chunk in report.split("Compiling entry function '")[1:]:
            m = re.search(r"attend_kernelILi(\d+)ELi(\d+)E", chunk.split("'", 1)[0])
            if m and m.group(1) == str(D):
                r = re.search(r"Used (\d+) registers", chunk)
                sp = re.search(r"(\d+) bytes spill stores", chunk)
                regs[f"MT{m.group(2)}"] = (int(r.group(1)) if r else 0,
                                           int(sp.group(1)) if sp else 0)
        print(f"ptxas {key[0]} {key[1]} at D={D} [registers, spill bytes]: {regs}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    import torch

    import chip_smoke as cs
    from starpu_inference_server_tpu_torch.ops import _build
    from starpu_inference_server_tpu_torch.ops import decode_attention as da

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}")
    libs = build(_build.nvcc_path())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(77)
    bf16 = torch.bfloat16
    vp, ci = ctypes.c_void_p, ctypes.c_int

    def cache(rows):
        return (torch.randint(-127, 128, (*rows, HKV, D), device=dev, generator=g,
                              dtype=torch.int8),
                torch.randint(-127, 128, (*rows, HKV, D), device=dev, generator=g,
                              dtype=torch.int8),
                torch.rand(*rows, HKV, device=dev, generator=g) * 0.03 + 0.05,
                torch.rand(*rows, HKV, device=dev, generator=g) / 127 + 1e-3)

    cases = []  # (label, lib, s, w, lengths, page)
    for label, lo, hi in (("block 16-48", 16, 49), ("burst 80-120", 80, 121),
                          ("random", 0, T)):
        cases.append((f"K3 S=128 {label}", "decode_attention", 128, 1, (lo, hi), None))
    for s in (16, 4, 1):
        cases.append((f"K3 S={s} random", "decode_attention", s, 1, (0, T), None))
    for s, w in ((16, 5), (16, 9), (4, 5), (1, 5)):
        cases.append((f"K9 S={s} W={w} random", "window_decode_attention", s, w,
                      (0, T - w + 1), None))
    cases.append(("K10 S=64 page=256", "paged_decode_attention", 64, 1, (0, 2 * 256), 256))

    for label, lib, s, w, (lo, hi), page in cases:
        lens = torch.randint(lo, hi, (s,), device=dev, generator=g, dtype=torch.int32)
        live = int((lens.to(torch.int64) + w).sum())
        nbytes = live * HKV * (2 * D + 8)
        copies = cs._copies(nbytes)
        if page:
            mp, n_pages = 4, 129
            caches = [cache((n_pages, page)) for _ in range(copies)]
            perm = (torch.randperm(n_pages - 1, device=dev, generator=g) + 1).tolist()
            table = torch.zeros(s, mp, dtype=torch.int32)
            for i, n in enumerate(lens.tolist()):
                for j in range((n + w - 1) // page + 1):
                    table[i, j] = perm.pop()
            table = table.to(dev)
            t = mp * page
        else:
            caches = [cache((s, T)) for _ in range(copies)]
            table, t = None, T
        q = torch.randn(s, w, HKV * REP, D, device=dev, generator=g).to(bf16)
        if w == 1:
            q = q[:, 0].contiguous()
        if page:
            ref = da.paged_decode_attention_plain(q, *caches[0], table, lens, REP)
        elif w == 1:
            ref = da.decode_attention_plain(q, *caches[0], lens, REP)
        else:
            ref = da.window_decode_attention_plain(q, *caches[0], lens, REP)
        b_ms, _ = cs.bound_ms(nbytes, 4.0 * live * HKV * REP * D)
        max_splits = t // 64
        plan = da.decode_split_plan(s, HKV, t, w, REP, D)
        for splits in sorted({1, 2, 4, 8, 16} & set(range(1, max_splits + 1)) | {plan.splits}):
            ws_n = splits * s * HKV * w * REP * (D + 2) if splits > 1 else 0
            ws = torch.empty(max(ws_n, 1), dtype=torch.float32, device=dev)
            line = []
            for variant, (_, checked) in VARIANTS.items():
                fn = getattr(libs[(variant, lib)], f"sis_{lib}")
                out = torch.empty_like(q)

                def call(i, fn=fn, out=out, splits=splits):
                    k, v, ks, vs = caches[i]
                    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
                            vs.data_ptr()]
                    if page:
                        ptrs.append(table.data_ptr())
                    ptrs += [lens.data_ptr(), out.data_ptr(),
                             ws.data_ptr() if splits > 1 else None]
                    ints = ([s, 4, page] if page else [s, t] + ([w] if w > 1 else []))
                    ints += [HKV, REP, D, _build.BF16, splits]
                    fn.argtypes = [vp] * len(ptrs) + [ci] * len(ints) + [vp]
                    rc = fn(*ptrs, *ints, torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{lib} launch failed: {rc}")

                call(0)
                torch.cuda.synchronize()
                err = ((out.float() - ref.float()).abs()
                       / (cs.ATTN_RTOL * ref.float().abs() + cs.ATTN_ATOL)).max().item()
                if checked and err > 1.0:
                    raise RuntimeError(f"{label} {variant} splits={splits} disagrees with the "
                                       f"plain version")
                ms = cs._time_cycled(call, copies)
                line.append(f"{variant} {ms:.4f}")
            mark = " (plan)" if splits == plan.splits else ""
            print(f"{label} live={live} splits={splits}{mark} on {card}: ms " + ", ".join(line)
                  + f"; bound {b_ms:.4f}")
        del caches
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
