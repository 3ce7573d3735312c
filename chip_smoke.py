#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``starpu_inference_server_tpu_torch/csrc``
(one nvcc per source, all at once), then runs three phases and fails
(exit 1) if any of them fails:

1. kernels: each kernel of the decoder path at the shapes the main path
   gives it (configs/llama_decoder.yml: llama-1b, 128 slots, max_len
   1024, int4 weights, int8 KV cache, bf16), held against its plain
   PyTorch version on the same inputs, and timed with CUDA events
   beside the plain version, a library yardstick the port never calls,
   and the least time the card could take (bytes or operations);
2. model: llama-1b at full width and depth, one 300-token prompt through
   the chunked-prefill path plus 4 decode steps, kernels on and off;
3. serving: the generation engine built from configs/llama_decoder.yml
   answers concurrent greedy requests (bucket 64, bucket 256, chunked);
   every kernel's launch counter is zeroed just before and must be > 0
   just after. The model phase also counts each kernel's launches in
   one decode step.

It prints the card's name and power limit, one ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``. Without CUDA, or
without the rest of the repository beside it, it exits 1 and prints no
result. Weights are random, from ``seed`` in the config.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "llama_decoder.yml"

# H100 SXM published peaks (dense): HBM3 bytes/s and bf16 tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12

TPU_SITES = {
    "int4_matmul": "starpu_inference_server_tpu/ops/pallas_kernels.py:264",
    "decode_attention": "starpu_inference_server_tpu/ops/decode_attention.py:304",
    "causal_attention": "starpu_inference_server_tpu/ops/prefill_attention.py:182",
    "chunk_prefill_attention": "starpu_inference_server_tpu/ops/prefill_attention.py:453",
}


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# Attention kernels are held element by element: |got - ref| <= 2^-7
# |ref| + 1e-3. Both outputs are bf16 roundings of f32 results, so they
# may differ by one bf16 ulp (at most 2^-7 |ref|); 1e-3 covers f32 sums
# taken in another order, and is half the 2e-3 of the JAX package's own
# decode attention test.
ATTN_RTOL = 2.0 ** -7
ATTN_ATOL = 1e-3


def attn_check(what: str, got, ref) -> float:
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    worst = (diff / (ATTN_RTOL * r.abs() + ATTN_ATOL)).max().item()
    err = diff.max().item()
    print(f"kernel {what}: max_abs_err={err:.3e}, worst err/limit {worst:.3f} "
          f"(limit {ATTN_RTOL:g} |ref| + {ATTN_ATOL:g}; median |ref| "
          f"{r.abs().median().item():.3e}, max |ref| {r.abs().max().item():.3e})")
    require(worst <= 1.0, f"{what} disagrees with its plain version")
    return err


# -- phase 1: kernels ---------------------------------------------------------

def kernel_phase(spec, cfg_opts, dev):
    import torch
    import torch.nn.functional as F

    from starpu_inference_server_tpu_torch.ops import decode_attention as da
    from starpu_inference_server_tpu_torch.ops import matmul_kernels as mk
    from starpu_inference_server_tpu_torch.ops import prefill_attention as pa
    from starpu_inference_server_tpu_torch.ops.quant import pack_int4, unpack_int4

    g = torch.Generator(device=dev).manual_seed(1234)
    bf16 = torch.bfloat16
    S = int(cfg_opts["num_slots"])
    T = int(cfg_opts["max_len"])
    C = int(cfg_opts["prefill_chunk"])
    hq, hkv, d, rep = spec.q_heads, spec.kv_heads, spec.head_dim, spec.rep
    rows = {}

    # int4_matmul at decode M = S over every dense shape of the model,
    # then at the other M the main path gives it: M = 1 (the lm_head of
    # every prefill and chunk, the kernel's one-row template) and the
    # prefill buckets 64 and 256 on gate_up. The row reports gate_up at
    # M = S (the largest per-layer weight); every shape's numbers go in
    # its per_shape list. Several weight copies, cycled, keep each call's
    # weight out of the 50 MB L2 as in a real decode step.
    shapes = {
        "qkv": (spec.hidden, (hq + 2 * hkv) * d),
        "o": (hq * d, spec.hidden),
        "gate_up": (spec.hidden, 2 * spec.intermediate),
        "down": (spec.intermediate, spec.hidden),
        "lm_head": (spec.hidden, spec.vocab),
    }
    cases = [(name, S) for name in shapes] + [("lm_head", 1), ("gate_up", 64), ("gate_up", 256)]
    tol_mm = 1e-4  # x max|ref|: same bf16 operands, f32 sums in another order
    per_shape = []
    for name, m in cases:
        k, n = shapes[name]
        x = torch.randn(m, k, device=dev, generator=g).to(bf16)
        copies = max(1, math.ceil(120e6 / (k * n // 2)))
        w4s, scs = [], []
        for _ in range(copies):
            wq = torch.randint(-7, 8, (k, n), device=dev, generator=g, dtype=torch.int8)
            w4s.append(pack_int4(wq))
            scs.append(torch.rand(1, n, device=dev, generator=g) * 0.02 + 1e-3)
        got = mk.int4_matmul(x, w4s[0], scs[0])
        ref = mk.int4_matmul_plain(x, w4s[0], scs[0])
        err = max_err(got, ref)
        tol = tol_mm * ref.abs().max().item()
        shape = f"M={m} K={k} N={n}"
        print(f"kernel int4_matmul {shape} ({name}): max_abs_err={err:.3e} tol={tol:.3e}")
        require(err <= tol, f"int4_matmul {name} M={m} disagrees with its plain version")
        it = iter(range(10 ** 9))
        ms = time_ms(lambda: mk.int4_matmul(x, w4s[next(it) % copies], scs[0]))
        plain_ms = time_ms(lambda: mk.int4_matmul_plain(x, w4s[0], scs[0]), iters=5)
        w_deq = (unpack_int4(w4s[0]).float() * scs[0]).to(bf16)
        lib_ms = time_ms(lambda: torch.matmul(x, w_deq))
        b_ms, b_by = bound_ms(m * k * 2 + k * n // 2 + n * 4 + m * n * 4, 2.0 * m * k * n)
        print(f"time int4_matmul {shape} ({name}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.matmul bf16 {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms, shape=shape)
        per_shape.append(dict(layer=name, **row))
        if name == "gate_up" and m == S:
            rows["int4_matmul"] = dict(row, per_shape=per_shape)
        del w4s, scs, w_deq

    # decode_attention at S slots (and S = 1). Logits are far from flat
    # (k up to ~10 after its scale, q ~ N(0, 1): logit std ~4), so a wrong
    # logit scale or softmax moves every output. S slots have mixed
    # lengths including 0 and T - 1; the S = 1 slot attends T - 1.
    for s in (S, 1):
        q = torch.randn(s, hq, d, device=dev, generator=g).to(bf16)
        kc = torch.randint(-127, 128, (s, T, hkv, d), device=dev, generator=g, dtype=torch.int8)
        vc = torch.randint(-127, 128, (s, T, hkv, d), device=dev, generator=g, dtype=torch.int8)
        ks = torch.rand(s, T, hkv, device=dev, generator=g) * 0.03 + 0.05
        vs = torch.rand(s, T, hkv, device=dev, generator=g) / 127 + 1e-3
        lens = torch.randint(0, T, (s,), device=dev, generator=g, dtype=torch.int32)
        if s == 1:
            lens[0] = T - 1
        else:
            lens[0], lens[1] = 0, T - 1
        got = da.decode_attention(q, kc, vc, ks, vs, lens, rep)
        ref = da.decode_attention_plain(q, kc, vc, ks, vs, lens, rep)
        err = attn_check(f"decode_attention S={s} T={T}", got, ref)
        if s != S:
            continue
        ms = time_ms(lambda: da.decode_attention(q, kc, vc, ks, vs, lens, rep))
        plain_ms = time_ms(lambda: da.decode_attention_plain(q, kc, vc, ks, vs, lens, rep), iters=3)
        kd = (kc.float() * ks[..., None]).to(bf16).transpose(1, 2)  # [S, Hkv, T, D]
        vd = (vc.float() * vs[..., None]).to(bf16).transpose(1, 2)
        mask = (torch.arange(T, device=dev)[None, :] <= lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask, enable_gqa=True))
        live = (lens.to(torch.int64) + 1).sum().item()
        nbytes = 2 * s * hq * d * 2 + live * hkv * (2 * d + 2 * 4) + 4 * s
        b_ms, b_by = bound_ms(nbytes, 4.0 * live * hq * d)
        print(f"time decode_attention S={s}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        rows["decode_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                                        shape=f"S={s} T={T} live={live}")
        del kc, vc, ks, vs, kd, vd

    # causal_attention at prefill bucket 256 (the row) and 512; q is
    # 3 x N(0, 1), so logits have std ~3 as above
    for t in (256, 512):
        q = (3 * torch.randn(1, t, hq, d, device=dev, generator=g)).to(bf16)
        k = torch.randn(1, t, hkv, d, device=dev, generator=g).to(bf16)
        v = torch.randn(1, t, hkv, d, device=dev, generator=g).to(bf16)
        got = pa.causal_attention(q, k, v, rep)
        ref = pa.causal_attention_plain(q, k, v, rep)
        err = attn_check(f"causal_attention T={t}", got, ref)
        ms = time_ms(lambda: pa.causal_attention(q, k, v, rep))
        plain_ms = time_ms(lambda: pa.causal_attention_plain(q, k, v, rep), iters=5)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes = 2 * t * hq * d * 2 + 2 * t * hkv * d * 2
        b_ms, b_by = bound_ms(nbytes, 4.0 * hq * d * t * (t + 1) / 2)
        print(f"time causal_attention T={t}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        if t == 256:
            rows["causal_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                                            shape=f"B=1 T={t}")

    # chunk_prefill_attention: chunk C at start 0, C (the row), 2C. The
    # cached rows dequantize to std ~1 like the in-chunk keys, and q is
    # 3 x N(0, 1): logits of std ~3 over both sources
    k_row = torch.randint(-127, 128, (T, hkv, d), device=dev, generator=g, dtype=torch.int8)
    v_row = torch.randint(-127, 128, (T, hkv, d), device=dev, generator=g, dtype=torch.int8)
    ks = torch.rand(T, hkv, device=dev, generator=g) * 0.01 + 0.01
    vs = torch.rand(T, hkv, device=dev, generator=g) / 127 + 1e-3
    for start in (0, C, 2 * C):
        q = (3 * torch.randn(C, hq, d, device=dev, generator=g)).to(bf16)
        kc = torch.randn(C, hkv, d, device=dev, generator=g).to(bf16)
        vc = torch.randn(C, hkv, d, device=dev, generator=g).to(bf16)
        args = (q, k_row, v_row, ks, vs, kc, vc, start, rep)
        got = pa.chunk_prefill_attention(*args)
        ref = pa.chunk_prefill_attention_plain(*args)
        err = attn_check(f"chunk_prefill_attention C={C} start={start}", got, ref)
        if start != C:
            continue
        ms = time_ms(lambda: pa.chunk_prefill_attention(*args))
        plain_ms = time_ms(lambda: pa.chunk_prefill_attention_plain(*args), iters=5)
        kd = torch.cat([(k_row[:start].float() * ks[:start, :, None]).to(bf16), kc]).transpose(0, 1)
        vd = torch.cat([(v_row[:start].float() * vs[:start, :, None]).to(bf16), vc]).transpose(0, 1)
        cols = torch.arange(start + C, device=dev)
        mask = cols[None, :] <= (start + torch.arange(C, device=dev))[:, None]
        qt, kd, vd = q.transpose(0, 1)[None], kd[None], vd[None]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kd, vd, attn_mask=mask, enable_gqa=True))
        nbytes = 2 * C * hq * d * 2 + start * hkv * (2 * d + 8) + 2 * C * hkv * d * 2
        b_ms, b_by = bound_ms(nbytes, 4.0 * hq * d * (C * start + C * (C + 1) / 2))
        print(f"time chunk_prefill_attention start={start}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        rows["chunk_prefill_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                                               shape=f"C={C} start={start} T={T}")
    return rows


# -- phase 2: model -----------------------------------------------------------

def zero_counts(counters) -> None:
    for table in counters:
        for key in table:
            table[key] = 0


def read_counts(counters) -> dict:
    return {k: v for table in counters for k, v in table.items()}


def model_phase(engine, dev, counters):
    """Returns each kernel's launches in one decode step of the model."""
    import torch

    from starpu_inference_server_tpu_torch.models.decoder import (
        decode_step, init_cache, prefill_chunk,
    )
    from starpu_inference_server_tpu_torch.ops import nn

    spec, params, dtype = engine.spec, engine.params, engine.dtype
    chunk, t_max = engine.prefill_chunk, engine.max_len
    prompt = torch.randint(0, spec.vocab, (300,), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(7))
    tokens = None
    runs = {}
    per_step = {}
    for kernels in (True, False):
        nn.set_use_kernels(kernels)
        try:
            cache = init_cache(spec, 4, t_max, device=dev)
            logits_seq = []
            for off in range(0, len(prompt), chunk):
                piece = prompt[off:off + chunk]
                ids = torch.zeros(chunk, dtype=torch.int64, device=dev)
                ids[:len(piece)] = piece
                _, logits = prefill_chunk(spec, params, cache, ids, off, len(piece), 0, dtype)
            logits_seq.append(logits[None])
            active = torch.tensor([True, False, False, False], device=dev)
            cur = torch.zeros(4, dtype=torch.int32, device=dev)
            for step in range(4):
                cur[0] = tokens[step] if tokens is not None else logits_seq[-1][0].argmax()
                if kernels and step == 0:
                    torch.cuda.synchronize()
                    zero_counts(counters)
                _, out = decode_step(spec, params, cache, cur, active, dtype)
                if kernels and step == 0:
                    per_step = read_counts(counters)
                logits_seq.append(out[:1])
            torch.cuda.synchronize()
            runs[kernels] = torch.cat(logits_seq).float()
            if tokens is None:
                tokens = [int(runs[kernels][i].argmax()) for i in range(4)]
        finally:
            nn.set_use_kernels(None)
    on, off = runs[True], runs[False]
    require(bool(torch.isfinite(on).all()), "model logits are not finite")
    require(on.shape == (5, spec.vocab), f"model logits shape {tuple(on.shape)}")
    rel = ((on - off).abs().mean() / off.abs().mean()).item()
    agree = (on.argmax(-1) == off.argmax(-1)).float().mean().item()
    # the two routes round to bf16 at different places (f32 softmax and
    # exact int4 weights in the kernels; bf16 probabilities and bf16
    # dequantized weights off them) through 16 layers; the random-weight
    # model amplifies those sub-percent differences layer by layer
    tol = 1e-1
    print(f"model llama-1b {spec.layers} layers: prefill 300 tokens (chunks of {chunk}) "
          f"+ 4 decode steps, kernels on vs off: mean rel err {rel:.3e} (tol {tol}), "
          f"argmax agreement {agree:.2f}")
    print(f"launches in one decode step: {json.dumps(per_step)}")
    require(rel <= tol, "model logits with kernels on and off disagree")
    return per_step


# -- phase 3: serving ---------------------------------------------------------

def serving_phase(engine, counters, card):
    import numpy as np

    from starpu_inference_server_tpu_torch.serving.generation import GenerationRequest

    rng = np.random.default_rng(11)
    vocab = engine.spec.vocab
    check_lens = [40, 200, 600]  # bucket 64, bucket 256 (causal kernel), chunked
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in check_lens]
    prompts.append(prompts[0].copy())  # the same prompt twice
    fill = engine.num_slots - len(prompts)
    prompts += [rng.integers(0, vocab, 64).astype(np.int32) for _ in range(fill)]
    new = 32
    zero_counts(counters)
    engine.start()
    try:
        t0 = time.perf_counter()
        reqs = [GenerationRequest(prompt_ids=p, max_new_tokens=new) for p in prompts]
        for r in reqs:
            engine.submit(r)
        outs = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
    finally:
        engine.stop()
    launches = read_counts(counters)
    for i, out in enumerate(outs):
        require(len(out) == new, f"request {i} returned {len(out)} tokens")
        require(all(0 <= t < vocab for t in out), f"request {i} returned out-of-vocab tokens")
    require(outs[0] == outs[3], "the same prompt twice gave different tokens")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    step_s = engine.loop_timers["step"]
    decode_tokens = len(reqs) * (new - 1)
    print(f"serving on {card}: {len(reqs)} greedy requests (prompts {check_lens} + "
          f"{fill} x 64 tokens), {new} new tokens each, {wall:.2f} s wall; decode "
          f"{decode_tokens} tokens in {engine.steps} steps, {step_s:.2f} s host clock in "
          f"decode blocks = {decode_tokens / step_s:.1f} tok/s (end to end "
          f"{len(reqs) * new / wall:.1f} tok/s)")
    print(f"serving launches: {json.dumps(launches)}")
    return launches


def main() -> int:
    pkg = ROOT / "starpu_inference_server_tpu_torch"
    if not pkg.is_dir() or not CONFIG.is_file():
        print("chip_smoke: FAIL: run from a checkout of the repository "
              "(starpu_inference_server_tpu_torch/ and configs/ not found)", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # the plain references compute f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from starpu_inference_server_tpu_torch.ops import _build
    from starpu_inference_server_tpu_torch.ops import decode_attention as da
    from starpu_inference_server_tpu_torch.ops import matmul_kernels as mk
    from starpu_inference_server_tpu_torch.ops import prefill_attention as pa
    from starpu_inference_server_tpu_torch.serving.generation import build_generation_engine
    from starpu_inference_server_tpu_torch.utils.config import load_config

    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {len(_build.KERNELS)} kernel libraries ready in {time.perf_counter() - t0:.1f} s")

    cfg = load_config(str(CONFIG))
    t0 = time.perf_counter()
    engine = build_generation_engine(cfg, device="cuda")
    print(f"engine: {cfg.model.family} ({cfg.model.quantization.value}, "
          f"{cfg.model.compute_dtype}) built in {time.perf_counter() - t0:.1f} s")

    counters = [mk.launches, da.launches, pa.launches]
    rows = kernel_phase(engine.spec, cfg.model.options, dev)
    per_step = model_phase(engine, dev, counters)
    launches = serving_phase(engine, counters, card)

    kernels = []
    for name in _build.KERNELS:
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"starpu_inference_server_tpu_torch/csrc/{name}.cu",
            "replaces": TPU_SITES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "launches_per_decode_step": per_step[name],
            **({"per_shape": r["per_shape"]} if "per_shape" in r else {}),
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
