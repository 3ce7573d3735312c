#!/usr/bin/env python3
"""Probe the fused ResNet stem on the card (K8, ``csrc/fused_stem.cu``):
its grid and where its time goes, and what its glue and the stem choice
cost a ResNet-18 forward.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/torch_stem_probe.py

1. Copies ``csrc/`` into ``build/stem_probe/``, rewrites each copy of
   ``fused_stem.cu`` into a variant (``VARIANTS``: floors with the pool
   or the wgmma skipped; add edits to probe other shapes of the kernel)
   and builds each with nvcc (registers and spills printed).
2. At B = 1, 4, 8 and 32 images, for each variant and grid (one block an
   item, or a persistent grid of 1-3 blocks an SM), holds each checked
   variant against the plain version (bf16 and f32 output, 2^-7 |ref| +
   1e-3, and two calls bit-equal) and times it (device time:
   ``chip_smoke.time_ms``); beside it the plain version, the cuDNN
   sequence (conv2d + affine + relu + max_pool2d in bf16) in NCHW and in
   channels_last, the bound, and the plan's grid
   (``ops/stem_kernel.py:stem_plan``).
3. The stem's glue (space-to-depth rearrange and pad) with the image
   cast to bf16 before it and, as it was, after it; then the ResNet-18
   int8 forward of ``configs/resnet18_int8.yml`` at B = 32 and 8 with
   each glue and with the s2d stem, in turns: host clock (synchronised,
   median of 10) and device busy time (torch.profiler's kernel sum).

Nothing of the port is changed.
"""

from __future__ import annotations

import ctypes
import dataclasses
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BATCHES = (1, 4, 8, 32)
# name: (replacements in fused_stem.cu, checked against the plain version)
VARIANTS = {
    "base": ((), True),
    # floors: the same kernel with its pool, or its wgmma, skipped
    "no pool": ((("if (e >= kPR * kPC * 8) return;", "return;"),), False),
    "no mma": ((("wgmma_m64n64k16(acc[i], a[cur][i], wgmma_desc(w_s + kk * 2 * kLBO));", ";"),),
               False),
}


def build(nvcc: str) -> dict:
    """{variant: its sis_fused_stem}."""
    csrc = ROOT / "starpu_inference_server_tpu_torch" / "csrc"
    texts = {}
    for variant, (edits, _) in VARIANTS.items():  # every edit applies before any build starts
        text = (csrc / "fused_stem.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {variant}: {old!r} not in fused_stem.cu")
            text = text.replace(old, new)
        texts[variant] = text
    out = ROOT / "build" / "stem_probe"
    shutil.rmtree(out, ignore_errors=True)
    procs = {}
    for i, (variant, text) in enumerate(texts.items()):
        src = out / f"v{i}"
        shutil.copytree(csrc, src)
        (src / "fused_stem.cu").write_text(text)
        so = src / "fused_stem.so"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(src), "-o", str(so),
               str(src / "fused_stem.cu")]
        procs[variant] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True))
    libs = {}
    for variant, (so, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {variant}:\n{report}")
        for name, regs, spill in _ptxas(report):
            out = "f32" if "fused_stem_kernelIf" in name else "bf16"  # the template argument
            print(f"ptxas {variant} {out} out: {regs} "
                  f"registers, {spill} bytes spill stores")
        fn = ctypes.CDLL(str(so)).sis_fused_stem
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[variant] = fn
    return libs


def _ptxas(report):
    import chip_smoke as cs

    return cs._ptxas_kernels(report)


def inputs(bsz, dev, g):
    import torch

    zp = torch.zeros(bsz, 118, 118, 12, device=dev)
    zp[:, 3:115, 3:115] = torch.randn(bsz, 112, 112, 12, device=dev, generator=g)
    w = (torch.randn(192, 64, device=dev, generator=g) * 0.1).to(torch.bfloat16)
    scale = torch.rand(64, device=dev, generator=g) + 0.5
    shift = torch.randn(64, device=dev, generator=g) * 0.1
    return zp.to(torch.bfloat16), w, scale, shift


def library_sequences(zp, w, scale, shift):
    """{layout: fn} of the cuDNN sequence on the same bf16 operands."""
    import torch
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    sc4, sh4 = scale.reshape(1, -1, 1, 1).to(bf16), shift.reshape(1, -1, 1, 1).to(bf16)
    seqs = {}
    for layout, fmt in (("NCHW", torch.contiguous_format), ("channels_last", torch.channels_last)):
        zb = zp.permute(0, 3, 1, 2).contiguous(memory_format=fmt)
        wk = w.reshape(4, 4, 12, 64).permute(3, 2, 0, 1).contiguous(memory_format=fmt)

        def seq(zb=zb, wk=wk):
            y = F.conv2d(zb, wk)[:, :, :113, :113]
            return F.max_pool2d(torch.relu(y * sc4 + sh4), kernel_size=3, stride=2)

        seqs[layout] = seq
    return seqs


def kernel_sweep(card, dev, libs):
    import torch

    import chip_smoke as cs
    from starpu_inference_server_tpu_torch.ops import _build
    from starpu_inference_server_tpu_torch.ops import stem_kernel as sk

    g = torch.Generator(device=dev).manual_seed(99)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bsz in BATCHES:
        zp, w, scale, shift = inputs(bsz, dev, g)
        refs = {dt: sk.fused_stem_plain(zp, w, scale, shift, dt)
                for dt in (torch.bfloat16, torch.float32)}
        plan = sk.stem_plan(bsz, sms)
        nbytes = bsz * 118 * 118 * 12 * 2 + 192 * 64 * 2 + 2 * 64 * 4 + bsz * 56 * 56 * 64 * 2
        b_ms, b_by = cs.bound_ms(nbytes, 2.0 * bsz * 112 * 112 * 192 * 64)
        plain_ms = cs.time_ms(lambda: sk.fused_stem_plain(zp, w, scale, shift), iters=5)
        lib = {k: cs.time_ms(f) for k, f in library_sequences(zp, w, scale, shift).items()}
        print(f"B={bsz} on {card}: bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, "
              f"cuDNN sequence NCHW {lib['NCHW']:.4f} ms, channels_last "
              f"{lib['channels_last']:.4f} ms; plan: grid {plan}")
        for variant, fn in libs.items():
            checked = VARIANTS[variant][1]
            items = bsz * sk.STEM_ITEMS_PER_IMAGE
            grids = sorted({items} | {k * sms for k in (1, 2, 3) if k * sms < items})
            line = []
            for blocks in grids:
                outs = {}
                for dt in (torch.bfloat16, torch.float32):
                    out = torch.empty(bsz, 56, 56, 64, dtype=dt, device=dev)

                    def call(fn=fn, out=out, dt=dt, blocks=blocks):
                        rc = fn(zp.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                                out.data_ptr(), bsz,
                                _build.BF16 if dt == torch.bfloat16 else _build.F32, blocks,
                                torch.cuda.current_stream().cuda_stream)
                        _build.check(rc, "fused_stem")
                        return out

                    first = call().clone()
                    torch.cuda.synchronize()
                    ref = refs[dt].float()
                    worst = ((first.float() - ref).abs()
                             / (cs.ATTN_RTOL * ref.abs() + cs.ATTN_ATOL)).max().item()
                    if checked and (worst > 1.0 or not torch.equal(first, call())):
                        print(f"  B={bsz} {variant} grid {blocks} {dt}: DISAGREES with the plain "
                              f"version (worst err/limit {worst:.3f}) or two calls differ")
                        outs = None
                        break
                    outs[dt] = call
                if outs is None:
                    break
                ms = cs.time_ms(outs[torch.bfloat16])
                ms32 = cs.time_ms(outs[torch.float32])
                mark = "*" if variant == "base" and blocks == plan else ""
                line.append(f"{blocks}{mark}: {ms:.4f} (f32 {ms32:.4f})")
            print(f"  B={bsz} {variant} items={items} ms by grid: " + ", ".join(line))
        del zp
        torch.cuda.empty_cache()


def glue_and_forward(card, dev):
    import numpy as np
    import torch

    import chip_smoke as cs
    from starpu_inference_server_tpu_torch.models import resnet
    from starpu_inference_server_tpu_torch.models.registry import build_model, get_family
    from starpu_inference_server_tpu_torch.ops import stem_kernel
    from starpu_inference_server_tpu_torch.utils.config import load_config

    cast_first = resnet._stem_fused

    def cast_after(stem, x, dtype, layout="NCHW"):  # the glue as it was
        z = resnet._s2d_rearrange(x, layout)
        zp = torch.nn.functional.pad(z, (0, 0, 3, 3, 3, 3))
        return stem_kernel.fused_stem(zp, stem["fused_w"], stem["scale"], stem["shift"],
                                      out_dtype=dtype)

    x = torch.from_numpy(np.random.default_rng(22).standard_normal((32, 3, 224, 224))
                         .astype(np.float32)).to(dev)

    def glue(cast):
        if cast:
            return lambda: torch.nn.functional.pad(
                resnet._s2d_rearrange(x.to(torch.bfloat16), "NCHW"), (0, 0, 3, 3, 3, 3))
        return lambda: torch.nn.functional.pad(resnet._s2d_rearrange(x, "NCHW"),
                                               (0, 0, 3, 3, 3, 3)).to(torch.bfloat16)

    for cast in (False, True, True, False):
        print(f"glue B=32 on {card}: rearrange + pad, bf16 cast "
              f"{'first' if cast else 'last'}: {cs.time_ms(glue(cast)):.4f} ms")

    cfg = load_config(str(ROOT / "configs" / "resnet18_int8.yml"))
    options = dict(cfg.model.options, stem_fused=True)
    model = build_model(dataclasses.replace(cfg.model, options=options), seed=cfg.seed,
                        device=dev)
    s2d = get_family("resnet18", dict(options, stem_fused=False))

    def forward(definition):
        def run(inputs):
            with torch.inference_mode():
                return definition.apply(model.params, inputs, model.compute_dtype)
        return run

    def median_ms(run, inputs, reps=10):
        run(inputs)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(inputs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[reps // 2]

    for bsz in (32, 8):
        inp = {"input": x[:bsz]}
        for what in ("cast last", "cast first", "s2d stem", "s2d stem", "cast first",
                     "cast last"):
            resnet._stem_fused = cast_after if what == "cast last" else cast_first
            try:
                run = forward(s2d if what == "s2d stem" else model.definition)
                host = median_ms(run, inp)
                prof = cs._profile_block(lambda: run(inp))
            finally:
                resnet._stem_fused = cast_first
            stem = what if what == "s2d stem" else f"fused stem, {what}"
            busy = "not measured" if prof is None else f"{sum(prof[0].values()):.4f} ms"
            print(f"forward resnet18 int8 B={bsz} on {card}: {stem}: host {host:.3f} ms, "
                  f"device busy (torch.profiler kernel sum) {busy}")


def main() -> int:
    import torch

    import chip_smoke as cs
    from starpu_inference_server_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}")
    libs = build(_build.nvcc_path())
    dev = torch.device("cuda")
    kernel_sweep(card, dev, libs)
    glue_and_forward(card, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
