#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``starpu_inference_server_tpu_torch/csrc``
(one nvcc per source, all at once), then drives the groups of paths below
and fails (exit 1) if any phase fails.

The decoder path (configs/llama_decoder.yml: llama-1b, 128 slots,
max_len 1024, int4 weights, int8 KV cache, bf16):

1. kernels: each kernel of the path at the shapes the path gives it,
   held against its plain PyTorch version on the same inputs, and timed
   with CUDA events beside the plain version, a library yardstick the
   port never calls, and the least time the card could take (bytes or
   operations); int4_matmul's device time in one decode step, summed
   over its shapes, and its two-call bit-equality; decode_attention at
   the decoder's 128 slots, at 16 (the W4A8 engine's) and at 128 slots
   of the burst's short contexts, each printing the split count of
   ``decode_split_plan`` and bit-equal over two calls; causal_attention at
   every prefill bucket (64 to 512) and chunk_prefill_attention at
   starts 0, 256 and 512 on their tensor-core route, each bit-equal over
   two calls;
2. model: llama-1b at full width and depth, one 300-token prompt through
   the chunked-prefill path plus 4 decode steps, kernels on and off,
   with each kernel's launches in one decode step;
3. serving: the generation engine answers concurrent greedy requests
   (bucket 64, bucket 256, chunked), every prefill through
   causal_attention and every chunk through chunk_prefill_attention
   (launches counted exactly, and decode_attention once a layer for
   every decode step, every greedy block being a replay of the engine's
   CUDA graph); then one decode block with every slot busy, driven by
   hand from one snapshot and cache twice, by the body run eagerly and by
   the graph replay (equal tokens, carry and cache bytes): each one's
   host clock beside its device span (CUDA events), device busy time
   (torch.profiler), its top kernels and the decode attention kernels'
   share, launches a step, and the graph's memory pool;
   then sampling on the device: ``sample_tokens`` on the card against
   the same call on the CPU (equal bits, equal tokens), and 16 sampled
   requests whose streams at depth 4 equal depth 1's; then llama-tiny
   at its registered width (head_dim 32): causal_attention and
   chunk_prefill_attention at D = 32 against their plain versions, and
   an FP32 engine whose every prefill bucket runs causal_attention, whose
   chunks run chunk_prefill_attention, and whose greedy streams equal
   the kernels-off engine's.

The batch ModelInfer path (configs/bert_long.yml: BERT-base s=512 W8A8;
configs/resnet18_int8.yml: ResNet-18 int8 with ``stem_fused`` set on
in code):

4. kernels: bidirectional_attention (and its two-call bit-equality)
   at the path's shapes, checked and timed as in 1; fused_stem at B=1,
   4, 8 (the serving batches) and 32 (the row), f32 and bf16 output,
   each bit-equal over two calls, timed beside the cuDNN sequence in
   NCHW and in channels_last (int8_matmul, which the ResNet fc shares
   with the int8 decoder, is checked and timed at both paths' shapes
   in 7);
5. model: BERT-base at full depth, B=16, kernels on against off;
   ResNet-18 at B=32, fused stem against the s2d stem; launches per
   forward, and the host-clock time of one forward at two batch sizes
   (ResNet: with each stem, beside the device busy time);
6. serving: the port's gRPC InferenceServer on a local port for each
   config, warmed up, answers concurrent ModelInfer calls (64 BERT
   requests with varied padding, 128 ResNet images), each response held
   against a batch-1 ``model.apply`` of the same sample; the mean of the
   server's per-phase timing fields says where a request's time went.
   Then two BERT witnesses, off the main path: the same model and
   requests at int8 weight-only (BF16) and unquantized at FP32, which
   show where the W8A8 model's gap to the batch-1 apply comes from.
   The control and observability plane on these servers (each serves
   ``/metrics`` on an ephemeral port): over the BERT burst, the
   ``/metrics`` counter deltas equal the dispatcher's counts (jobs,
   batches, OK statuses), ``gpu_memory_used_bytes`` equals
   ``torch.cuda.memory_allocated`` and ``gpu_memory_total_bytes`` the
   card's total, the congestion monitor ticked through the burst and its
   gauges equal its last snapshot; the same burst once on a server
   with the monitor off (batches formed and latencies side by side). On the
   ResNet server: the 128-image burst once more on a server without
   metrics and monitor (the cost of observability), then ModelConfig,
   RepositoryIndex, unload (ModelInfer UNAVAILABLE, ModelReady false)
   and load (a hot reload from the config's seed: the response for a
   fixed image bit-equal, no tensor of the old tree alive, the
   allocator's requested bytes back within 1 MiB), LogSettings,
   TraceSetting around 16
   requests (one ``batch`` trace event for each batch formed) and
   reflection.

The decoder extras (configs/llama_w4a8.yml, llama_speculative.yml,
llama_prompt_lookup.yml, llama_paged.yml; llama-1b at full width and
depth):

7. kernels: int8_matmul (K2) at every dense shape of an int8 decode
   step at 16 and 64 slots and at the ResNet fc, int4_matmul_w4a8 (K6)
   at every dense shape at 16, 64, 128, 1 and 256 rows (bit-equal to its
   plain version), each bit-equal over two calls, with its time in one
   decode step; window_decode_attention (K9), paged_decode_attention
   (K10) and paged_window_decode_attention (K11) at the configs' shapes,
   checked and timed as in 1, each with its split count and bit-equal
   over two calls;
8. model: W4A8 llama-1b kernels on vs off (on the int4 tree of phase 1,
   built after the int4 path so each runs under its own W8A8 mode),
   launches per decode step; on one int8 tree shared by the other three
   configs, a verify window against sequential decode steps and the
   paged steps against the dense ones, launches per step and per verify;
9. serving: the W4A8 engine (prompts of 40, 200 and 600 tokens among
   16); the speculative and prompt-lookup engines on the random weights
   (acceptance and streams identical to a plain engine printed) and
   rigged with ``copy_model_cycle`` set in code on target and draft
   (every stream equal to the plain engine's, acceptance above a
   floor); the paged engine with 64 concurrent requests, a third sharing
   a 300-token prefix (prefix hits, no leaked page, streams against a
   dense engine printed), with a metrics recorder whose token, prefix
   and TTFT families equal the engine's counts, then once without it
   (the recorder's cost in decode seconds, every stream equal); the
   paged engine with prompt lookup set in code, rigged
   (streams equal to the plain engine's).

The flat cache layout and overlapped dispatch (``kv_cache_layout: flat``
set in code on llama_decoder.yml, llama_prompt_lookup.yml and
llama_paged.yml; full width and depth):

10. kernels: the four FLAT-layout kernels (K12a-d) at the configs'
    shapes (K12a at each of K3's timed shapes), held against their plain
    versions, bit for bit against their standard twins (K3, K9, K10, K11)
    on the same logical cache and over two calls, and timed beside the
    twins;
11. model: decode and verify steps, dense and paged, flat against
    standard on the same contents (equal logits), launches per step;
12. serving: llama_decoder.yml flat on the int4 tree (its 128 requests,
    every stream equal to the standard engine's, K3 never launched) and
    the same requests at ``decode_overlap: false`` (depth 1: streams
    equal to the config's depth 4, tok/s and loop timers for both); the
    rigged prompt-lookup engine flat; the paged burst flat (prefix hits,
    streams and pages as the standard paged run's) and flat with prompt
    lookup, rigged.

Every model family and quant mode on one device (configs/vit_l_16.yml,
resnet18_nhwc.yml, moe_decoder.yml, and llama_decoder.yml with
``serve_logits: true`` set in code), after the batch path (13-14) and
after the flat group (15-16):

13. ViT-L/16 int8 (BF16, adaptive batching up to 32, two lanes, the
    congestion monitor, traces off): the model at B = 32 against the FP32
    forward of the same tree, its head's int8_matmul launch and a
    forward's device busy time; 64 concurrent one-image requests, each
    held against a batch-1 apply;
14. ResNet-18 W8A8 on the NHWC wire: at B = 32 every conv's s8 x s8 ->
    s32 sums (``torch._int_mm``) equal to float64 on the card, the fc's
    int8_matmul launch and the device busy time; 128 concurrent images
    against a batch-1 apply (the activation scale spans the batch: a
    limit from the first reading), and the same images on an unquantized
    FP32 witness server, element by element. The kernel rows this group
    adds to the kernels' ``per_shape`` lists run after phase 7's:
    int8_matmul at the ViT head (M = 32, K = 1024, N = 1000) and the MoE
    routers (N = 8, 4), int4_matmul at the int4 router (N = 8);
15. moe-8x1b (int8, 16 slots, cut to ``MOE_LAYERS`` layers): 16 greedy
    requests through int8_matmul (router and projections at 16 rows),
    causal_attention, chunk_prefill_attention and decode_attention, every
    block a graph replay, the graphed block equal to the eager body, the
    host clock of a step against its device busy time and the device
    time of dequantizing the expert stacks; moe-tiny at FP32, kernels on
    against off, equal streams;
16. serve_logits: llama-1b int4 (cut to ``LOGITS_LAYERS`` layers) on the
    batch pipeline, 4 requests of 512 ids over gRPC, the logits against forward_logits at batch 1 on the
    card, causal_attention once a layer a forward.

Clients and checkpoints, last: every server is started from the CLI
(``python -m starpu_inference_server_tpu_torch.grpc.server --config
<temp yml>``) as its own process, on a fresh port with ``metrics_port:
0``, and every client runs as its own process; a kernel's launches are
read from its server's log (the counts after warmup and at shutdown):

17. ResNet-152 int8 (ci/perf/resnet152_ci_perf.yml) from a checkpoint of
    its FP32 tree (the config's seed), beside a server of the same yml
    built from the seed. The card's machine has no ``tensorstore``, so the
    checkpoint is the flat-key ``.npz`` that ``load_params`` reads, written
    here (tests/test_torch_checkpoint.py holds the Orbax route). The port
    client replays ci/perf/ci_perf_resnet_smoke.csv with the flags of
    scripts/run_perf_smoke.sh (64 requests handled and validated), then
    scripts/check_perf_summary.py reads the summary (its verdict printed:
    its thresholds were set for another machine; the full
    ci_perf_resnet.csv is not replayed, for the run's time limit); one
    image's response equal, bit for bit, on both servers; int8_matmul (the
    fc) launched, fused_stem not;
18. configs/llama_decoder.yml (its server cut to ``CLIENT_LAYERS`` of 16
    layers for the run's time limit): the generation client, unary first (32
    requests of 32 tokens at concurrency 32, cut from 128 for the run's
    time limit; it pays for the decode graph's capture), then streaming
    (128 requests at concurrency 128, time to first token); a direct
    stream equal to a direct unary response for each of the client's
    pooled prompts;
    int4_matmul, decode_attention and causal_attention launched;
19. configs/bert_long.yml at FP32, unquantized, seed 42: the BERT client at
    s = 512 with ``--validate`` against its reference model on the card;
    bidirectional_attention launched.

Pipelined multi-device decoding, last (``pipelined_path``; the card's
machine has one GPU, so every mesh runs as rank processes sharing it,
over gloo):

20. first, the kernels at the shapes these paths give them inside a
    stage (``pipelined_kernel_rows``; entries of their ``per_shape``
    lists, tagged with the path), each held against its plain version:
    for llama_pipelined, int8_matmul on every llama-7b dense layer and
    the lm head at M = 4 (a decode microgroup) and 16 (a prefill chunk;
    the head over 16 slots) and the head at M = 1, decode_attention at
    S = 4, T = 1024, 32 kv heads, rep 1 on a row-sliced view of a stage's
    stacked cache, chunk_prefill_attention at C = 16, starts 0-48, on a
    slot's row view; for the tiny worlds at FP32, pipe2_model2's
    tensor-parallel shards (int8_matmul, decode_attention,
    chunk_prefill_attention) and pipe2_lookup's window_decode_attention
    (S = 2, W = 4); for the multi-host group's pipe world, llama-7b's
    model=2 shards at pipe=2 (int8_matmul on every dense shard at M = 4
    and 32 and the lm head's vocab shard at M = 16, 1 and 4,
    decode_attention at 16 kv heads, chunk_prefill_attention at C = 32);
    step 0: ``scripts/torch_gloo_probe.py`` (which gloo operations two
    ranks on one card run on CUDA tensors; nccl with two ranks on one
    device must fail); three tiny worlds spawned by
    ``parallel/launch.py:run_world`` (llama-tiny pipe=2 x model=2,
    moe-tiny pipe=2 x expert=2, llama-tiny pipe=2 with prompt lookup;
    registered widths, int8, FP32), each serving 6 greedy requests with
    streams equal to the single-device engine of the same tree (one
    microgroup's slots, ``prefill_chunk`` = bucket / stages), K2 and K4 on
    every rank, K3 (K9 with prompt lookup) on every rank;
    configs/llama_pipelined.yml from the CLI as 4 ranks (llama-7b at full
    width, cut to ``PIPE_LAYERS`` layers; ``pipelined_server_run``, which
    ``scripts/torch_pipelined_serve.py`` also runs): the port's generation client,
    16 greedy requests of 32 tokens at concurrency 16, streaming, every
    stream equal to the in-process single-device engine of
    the same tree (4 slots, ``prefill_chunk`` = 16), beside the config
    served on one device from the same tree (tok/s, TTFT); every rank's
    launches (K2, K3, K4 on each) and collectives from the server's
    ``mesh statistics`` log lines; the backend printed; a tiny pipe=2
    server from the CLI whose rank 1 is killed must exit non-zero.

The GSPMD group, after it (``gspmd_kernel_rows``, ``gspmd_path``; meshes
without a pipe axis, every rank sharing the card over gloo):
K1-K8 at the shapes a rank's shard gives them, each against its plain
version, into the kernels' ``per_shape`` lists (K6 on a row-parallel
layer: the ranks' exact integer sums, scaled, equal to the whole row);
``llama_decoder.yml`` and ``bert_long.yml`` at data=2 x model=2 from the
CLI as 4 ranks (llama-1b cut to ``GSPMD_LAYERS`` layers here and in the
rank world; the generation client's tok/s and TTFT, rank 0's decode
step, every BERT response held against a batch-1 single-device apply,
the census and launches by rank from the ``mesh statistics`` lines);
and one world of 4 rank processes (``gspmd_world``) running eight meshes
in turn, each against one device on rank 0: llama-1b streams at data=4
(and a prefix-cache row copy across its data groups), the
sequence-parallel forward at T = 2048, llama-1b logits at
data=2 x model=2, int4 then W4A8, ResNet-18 at data=4 (bit-equal), ViT-L
at model=4, moe-8x1b (``MOE_LAYERS`` layers) at expert=2 x model=2, and
the pipe-mode ``serve_logits`` of llama_pipelined.yml (``PIPE_LAYERS``
layers, 4 microbatches). Each cut of an earlier path's depth or requests
for the run's time limit is printed as a ``time cut:`` line.

The multi-host group, last (``multihost_path``): launchers, the JAX
package's ``jax.distributed`` processes, each spawning its local ranks,
two of two ranks sharing the card over gloo and joined at
``127.0.0.1:<free port>``. ``llama_decoder.yml`` at data=2 x model=2 as
two CLI launchers (``distributed: {coordinator_address, num_processes:
2, process_id: 0|1}``; ``data`` crosses them, ``model`` stays inside):
the GSPMD group's 32 streamed requests, K1, K3 and K5 on every rank of
both, every all-reduce over ``model``, the start and the weights sent to
launcher 1, tok/s, TTFT and rank 0's step beside the GSPMD group's
one-launcher run, and the streams equal to it counted (not required);
launcher 1 exits 0 after launcher 0's SIGINT. ``multihost_world``
through ``run_launcher`` over 2 launchers and over 1 of 4 ranks, side by
side: llama-1b int4 (full width, ``MH_LAYERS`` layers) at data=2 x
model=2, ``MH_PROMPTS`` prefills and ``MH_STEPS`` decode steps whose
logits must be bit-equal; llama_pipelined.yml (``PIPE_LAYERS`` layers) at
pipe=2 x model=2, a stage a launcher, ``MH_REQUESTS`` greedy streams that
must be equal, only the ``pipe`` hops crossing, K2, K3, K4 in both
stages. A llama-tiny pair at data=2 x model=2 whose rank 3 is killed:
both launchers exit non-zero within ``--timeout-s``.

The head-layout group, last (``head_layout_kernel_rows``,
``head_layouts_path``): every attention head layout the JAX package
serves. First the eight decode-side kernels (K3, K9, K10, K11, K12a-d)
and K5 and K4 at q/kv ratios 16, 32, 7 and 71 (head dim 64) and head dims
80, 96 and 256 (q/kv 8), bf16 and f32, each against its plain version,
bf16 bit-equal over two calls and flat to its standard twin; K1, K3, K4
and K5 timed at the group's path shapes (K1 on every int4 layer of a
model=4 rank and on the one-device qkv), K3 also at the config's 128
slots; the row groups' cost: K3 at 71 heads over one kv head and K9 at
W = 5 and q/kv 16 (two groups each) beside one group on the same cache,
and K3 at D = 256. Then llama_decoder.yml with
``kv_heads: 2`` set in code (llama-1b widths, ``HL_LAYERS`` layers, q/kv 16,
``HL_SLOTS`` slots): the model kernels on vs off, 16 greedy requests
(one of 600 tokens) through K1, K3, K4 and K5, and an FP32 witness of the
same weights whose streams with the kernels on equal those with them
off; the same tree at data=1 x model=4 as 4 rank processes (8 q heads and
one kv head a rank, each kv head replicated on two ranks): streams and
logits against one device and a decode step's census; and bert_long.yml
(cut to ``HL_BERT_LAYERS`` layers) at model=8 as 8 rank processes, all 12
heads through K7 on every rank, against one device. Each library's nvcc
seconds are printed after the build.

The cut-heads group, last, its rank worlds beside the head-layout
group's (``cut_heads_kernel_rows``, ``cut_heads_path``): GSPMD decoders whose heads ``model`` cuts, served
through the gathered-heads route (each rank's contiguous cut of the
fused qkv gathered over ``model``, every head on every rank, the cache
replicated over ``model``). K1 at every int4 shard shape of the group's
two worlds, K3, K5 and K4 at the whole models' head layouts (D = 128, q/kv
4 and 7) and K9 at W = 5, each against its plain version and bit-equal
over two calls; then two rank worlds side by side, each set in code on a
copy of llama_decoder.yml at a published model's widths (depth cut for
the run's time limit, ``time cut:`` lines): Phi-3-medium's layout (40 q
over 10 kv heads) at data=1 x model=4, 16 requests (one of 600 tokens:
K4) served by rank 0's engine against the same tree on one device, with
first-prefill and step logits within ``GSPMD_LOGITS_TOL``; and
Qwen2.5-7B's (28 q over 4 kv heads) at model=8, first-prefill and step
logits against one device; each with a decode step's census on every
rank (all-reduce/model 2L, all-gather/model L + 2) and the kernels'
launches on every rank.

``python3 chip_smoke.py --phase head-layout-kernels`` runs the build and
the head-layout group's kernel rows alone, ``--phase gspmd-cut-heads``
the build and the cut-heads group with all its checks, ``--phase
build-times TREE ...`` builds each checkout's kernel libraries in turn
(``phase_main``).

Every engine runs at its config's ``decode_pipeline_depth`` (4 for the
decoder configs) unless stated. Requests are queued before the engine
starts, so runs of one config admit in the same order. Every serving
phase zeroes the launch counters just before its requests and reads them
just after; each kernel of that path must show > 0.

Every decode-side library (the eight kernels on
``csrc/decode_mma.cuh``) prints the ptxas registers and spill bytes of
each of its instantiations (head dim, m16 tiles), also in its entry of
the kernels line.

It prints the card's name and power limit, one ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``. Without CUDA, or
without the rest of the repository beside it, it exits 1 and prints no
result. Weights are random, from ``seed`` in each config.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import re
import subprocess
import sys
import threading
import time
import types
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "llama_decoder.yml"
BERT_CONFIG = ROOT / "configs" / "bert_long.yml"
RESNET_CONFIG = ROOT / "configs" / "resnet18_int8.yml"

W4A8_CONFIG = ROOT / "configs" / "llama_w4a8.yml"
SPEC_CONFIG = ROOT / "configs" / "llama_speculative.yml"
LOOKUP_CONFIG = ROOT / "configs" / "llama_prompt_lookup.yml"
PAGED_CONFIG = ROOT / "configs" / "llama_paged.yml"

VIT_CONFIG = ROOT / "configs" / "vit_l_16.yml"
NHWC_CONFIG = ROOT / "configs" / "resnet18_nhwc.yml"
MOE_CONFIG = ROOT / "configs" / "moe_decoder.yml"

# H100 SXM published peaks (dense): HBM3 bytes/s, bf16 tensor FLOP/s and
# int8 tensor OP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12

TPU_SITES = {
    "int4_matmul": "starpu_inference_server_tpu/ops/pallas_kernels.py:264",
    "decode_attention": "starpu_inference_server_tpu/ops/decode_attention.py:304",
    "causal_attention": "starpu_inference_server_tpu/ops/prefill_attention.py:182",
    "chunk_prefill_attention": "starpu_inference_server_tpu/ops/prefill_attention.py:453",
    "int8_matmul": "starpu_inference_server_tpu/ops/pallas_kernels.py:193",
    "bidirectional_attention": "starpu_inference_server_tpu/ops/prefill_attention.py:301",
    "fused_stem": "starpu_inference_server_tpu/ops/stem_kernel.py:109",
    "int4_matmul_w4a8": "starpu_inference_server_tpu/ops/pallas_kernels.py:319",
    "window_decode_attention": "starpu_inference_server_tpu/ops/decode_attention.py:1278",
    "paged_decode_attention": "starpu_inference_server_tpu/ops/decode_attention.py:924",
    "paged_window_decode_attention": "starpu_inference_server_tpu/ops/decode_attention.py:1010",
    "flat_decode_attention": "starpu_inference_server_tpu/ops/decode_attention.py:608",
    "flat_window_decode_attention": "starpu_inference_server_tpu/ops/decode_attention.py:676",
    "flat_paged_decode_attention": "starpu_inference_server_tpu/ops/decode_attention.py:746",
    "flat_paged_window_decode_attention":
        "starpu_inference_server_tpu/ops/decode_attention.py:807",
}
DECODER_KERNELS = ("int4_matmul", "decode_attention", "causal_attention",
                   "chunk_prefill_attention")
BERT_KERNELS = ("bidirectional_attention",)
RESNET_KERNELS = ("int8_matmul", "fused_stem")

# Model-level tolerances, by mean relative error |a - b|.mean() / |b|.mean().
# BERT kernels on vs off: the off path rounds the attention probabilities
# to bf16 before P.V (the kernel keeps them f32) and the W8A8 FFN
# requantizes activations per row, so a last-bit difference can move an
# activation to the neighbouring int8 level; 12 layers of that stay in
# the low 1e-2. ResNet fused vs s2d stem: the JAX package's own limit
# (tests/unit/test_stem_kernel.py), at FP32 compute as there, where the
# fused stem's bf16 stem operands are the only difference. ResNet served
# vs batch-1 apply, at the config's BF16 compute: logits of magnitude
# 30-60 carry one bf16 ulp of 2^-8 (4e-3 relative), and convolutions at
# another batch size may sum in another order, so the limit is 1e-2,
# with the argmax equal.
BERT_TOL = 5e-2
RESNET_TOL = 2e-3
RESNET_SERVE_TOL = 1e-2
# Witnesses of where the BERT W8A8 gap comes from, run after the main
# path (their launches are not the path's): the same model and requests
# at int8 weight-only (BF16 compute, no activation requantization) and
# with no quantization at FP32 compute, each with its own limits on the
# kernels on/off and the served/batch-1 mean relative errors; the FP32
# responses are also held element by element, |got - ref| <= atol +
# rtol |ref|, which a padding or slicing fault would break. On an H100
# the FP32 witness read ~1e-6 for both errors and 4e-3 of a (1e-3, 1e-3)
# element limit, the int8/BF16 one ~1.0e-2, against ~2.4e-2 at W8A8: the
# limits below keep about 10x and 3x headroom over those readings, and
# BERT_TOL's 2x over W8A8 rests on them (padding and slicing are exact,
# the rest is bf16 and int8 requantization).
# (quantization, compute dtype, on/off tol, served tol, (atol, rtol) or None)
BERT_CONTROLS = (
    ("int8", "BF16", 3e-2, 3e-2, None),
    ("none", "FP32", 1e-5, 1e-5, (1e-4, 1e-4)),
)

BERT_REQUESTS = 64
RESNET_IMAGES = 128


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


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_BF16):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_SLEEP_CYCLES_PER_MS = []


def _hold_device(ms: float) -> None:
    """Keep the card busy for about ``ms`` (torch.cuda._sleep spins a
    kernel for a number of clock cycles, calibrated once)."""
    import torch

    if not _SLEEP_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append(1e7 / start.elapsed_time(end))
    torch.cuda._sleep(int(ms * _SLEEP_CYCLES_PER_MS[0]))


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn()``: CUDA events around ``iters`` calls,
    queued behind a spin kernel that outlasts their enqueue, so the card
    runs them back to back and the host's launch overhead (the Python
    wrapper, ctypes) is not timed. A ``fn`` that syncs the host is timed
    with its host gaps, as before."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold = 2.0
    for _ in range(2):
        _hold_device(hold)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if enqueue < hold:
            break
        hold = 2 * enqueue + 1.0
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
    # every prefill and chunk, the kernel's 16-row tile) and the prefill
    # buckets 64 and 256 on gate_up. The row reports gate_up at M = S
    # (the largest per-layer weight); every shape's numbers go in its
    # per_shape list. Several weight copies, cycled, keep each call's
    # weight out of the 50 MB L2 as in a real decode step; the library
    # yardstick (torch.matmul on the dequantized bf16 weight) cycles its
    # own copies the same way, so both read their weights from device
    # memory (its time on one warm weight is printed beside it).
    shapes = _dense_shapes(spec)
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
        plan = mk.matmul_plan("int4_matmul", m, n, k,
                              torch.cuda.get_device_properties(dev).multi_processor_count)
        print(f"kernel int4_matmul {shape} ({name}): max_abs_err={err:.3e} tol={tol:.3e}; tile "
              f"{mk.QMM_TILES[plan.variant]}, {plan.splits} splits, {plan.grid} blocks")
        require(err <= tol, f"int4_matmul {name} M={m} disagrees with its plain version")
        if name == "gate_up" and m == S:
            again = mk.int4_matmul(x, w4s[0], scs[0])
            print(f"kernel int4_matmul {shape} ({name}): two calls bit-equal "
                  f"{bool(torch.equal(got, again))}")
            require(torch.equal(got, again), "int4_matmul gave other bits on a second call")
        ms = _time_cycled(lambda i: mk.int4_matmul(x, w4s[i], scs[0]), copies)
        plain_ms = time_ms(lambda: mk.int4_matmul_plain(x, w4s[0], scs[0]), iters=5)
        w_deqs = [(unpack_int4(w4s[i % copies]).float() * scs[0]).to(bf16)
                  for i in range(_copies(k * n * 2))]
        lib_ms = _time_cycled(lambda i: torch.matmul(x, w_deqs[i]), len(w_deqs))
        warm_ms = time_ms(lambda: torch.matmul(x, w_deqs[0]))
        b_ms, b_by = bound_ms(m * k * 2 + k * n // 2 + n * 4 + m * n * 4, 2.0 * m * k * n)
        print(f"time int4_matmul {shape} ({name}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.matmul bf16 {lib_ms:.4f} ms ({len(w_deqs)} weights cycled; one warm "
              f"weight {warm_ms:.4f} ms), bound {b_ms:.4f} ms ({b_by})")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms, library_warm_ms=warm_ms, shape=shape,
                   splits=plan.splits, grid=plan.grid)
        per_shape.append(dict(layer=name, m=m, **row))
        if name == "gate_up" and m == S:
            rows["int4_matmul"] = dict(row, per_shape=per_shape)
        del w4s, scs, w_deqs
    # K1's device time in one decode step: every layer's four dense
    # shapes at M = S, then the lm_head
    step_ms = _step_ms(spec, per_shape, S)
    lib_step_ms = _step_ms(spec, per_shape, S, "library_ms")
    print(f"int4_matmul per decode step ({spec.layers} layers x qkv, o, gate_up, down + lm_head "
          f"at M={S}): kernel {step_ms:.4f} ms, torch.matmul bf16 (cycled) {lib_step_ms:.4f} ms")
    rows["int4_matmul"]["decode_step_ms"] = step_ms

    # decode_attention at S slots (the row), S = 1, and two more shapes of
    # the path, each printing the split count decode_split_plan chose: S
    # = 16 (the W4A8 engine's slots) and S slots at the burst's short
    # contexts (80-120 positions a slot). Logits are far from flat (k up
    # to ~10 after its scale, q ~ N(0, 1): logit std ~4), so a wrong logit
    # scale or softmax moves every output. The row's slots have mixed
    # lengths including 0 and T - 1; the S = 1 slot attends T - 1. Each is
    # bit-equal over two calls. The row's cache (134 MB) is past the L2;
    # the others are timed on cycled copies (``_copies``).
    per_shape = []
    for s, what in ((S, "row"), (1, "check"), (16, "w4a8 slots"), (S, "short contexts")):
        lens = torch.randint(0, T, (s,), device=dev, generator=g, dtype=torch.int32)
        if what == "check":
            lens[0] = T - 1
        elif what == "short contexts":
            lens = torch.randint(80, 121, (s,), device=dev, generator=g, dtype=torch.int32)
        else:
            lens[0], lens[1] = 0, T - 1
        live = (lens.to(torch.int64) + 1).sum().item()
        nbytes = 2 * s * hq * d * 2 + live * hkv * (2 * d + 2 * 4) + 4 * s
        copies = 1 if what in ("row", "check") else _copies(nbytes)
        q = torch.randn(s, hq, d, device=dev, generator=g).to(bf16)
        caches = [(torch.randint(-127, 128, (s, T, hkv, d), device=dev, generator=g,
                                 dtype=torch.int8),
                   torch.randint(-127, 128, (s, T, hkv, d), device=dev, generator=g,
                                 dtype=torch.int8),
                   torch.rand(s, T, hkv, device=dev, generator=g) * 0.03 + 0.05,
                   torch.rand(s, T, hkv, device=dev, generator=g) / 127 + 1e-3)
                  for _ in range(copies)]
        got = da.decode_attention(q, *caches[0], lens, rep)
        ref = da.decode_attention_plain(q, *caches[0], lens, rep)
        splits = da.decode_split_plan(s, hkv, T, 1, rep, d).splits
        err = attn_check(f"decode_attention S={s} T={T} ({what}, {splits} splits)", got, ref)
        require(torch.equal(got, da.decode_attention(q, *caches[0], lens, rep)),
                f"decode_attention S={s} ({what}) gave other bits on a second call")
        if what == "check":
            continue
        ms = _time_cycled(lambda i: da.decode_attention(q, *caches[i], lens, rep), copies)
        plain_ms = _time_cycled(lambda i: da.decode_attention_plain(q, *caches[i], lens, rep),
                                copies, iters=3)
        deq = [((kc.float() * ks[..., None]).to(bf16).transpose(1, 2),  # [S, Hkv, T, D]
                (vc.float() * vs[..., None]).to(bf16).transpose(1, 2))
               for kc, vc, ks, vs in caches[:_copies(2 * s * T * hkv * d * 2)]]
        mask = (torch.arange(T, device=dev)[None, :] <= lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        lib_ms = _time_cycled(lambda i: F.scaled_dot_product_attention(
            q4, *deq[i], attn_mask=mask, enable_gqa=True), len(deq))
        b_ms, b_by = bound_ms(nbytes, 4.0 * live * hq * d)
        print(f"time decode_attention S={s} ({what}, {splits} splits): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); two calls "
              f"bit-equal; {copies} cache copies cycled")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms, shape=f"S={s} T={T} live={live}", splits=splits,
                   lengths=lens.tolist())  # K12a reuses them
        per_shape.append(row)
        if what == "row":
            rows["decode_attention"] = row
        del caches, deq
    rows["decode_attention"] = dict(rows["decode_attention"], per_shape=per_shape)

    # causal_attention at every prefill bucket (the row: 256); q is
    # 3 x N(0, 1), so logits have std ~3 as above; each bit-equal over
    # two calls
    per_shape = []
    for t in (64, 128, 256, 512):
        q = (3 * torch.randn(1, t, hq, d, device=dev, generator=g)).to(bf16)
        k = torch.randn(1, t, hkv, d, device=dev, generator=g).to(bf16)
        v = torch.randn(1, t, hkv, d, device=dev, generator=g).to(bf16)
        got = pa.causal_attention(q, k, v, rep)
        err = attn_check(f"causal_attention T={t}", got, pa.causal_attention_plain(q, k, v, rep))
        require(torch.equal(got, pa.causal_attention(q, k, v, rep)),
                f"causal_attention T={t} gave other bits on a second call")
        ms = time_ms(lambda: pa.causal_attention(q, k, v, rep))
        plain_ms = time_ms(lambda: pa.causal_attention_plain(q, k, v, rep), iters=5)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes = 2 * t * hq * d * 2 + 2 * t * hkv * d * 2
        b_ms, b_by = bound_ms(nbytes, 4.0 * hq * d * t * (t + 1) / 2)
        print(f"time causal_attention T={t}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); two calls bit-equal")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms, shape=f"B=1 T={t}")
        per_shape.append(row)
        if t == 256:
            rows["causal_attention"] = dict(row, per_shape=per_shape)

    # chunk_prefill_attention: chunk C at start 0, C (the row), 2C, each
    # bit-equal over two calls. The cached rows
    # dequantize to std ~1 like the in-chunk keys, and q is 3 x N(0, 1):
    # logits of std ~3 over both sources
    k_row = torch.randint(-127, 128, (T, hkv, d), device=dev, generator=g, dtype=torch.int8)
    v_row = torch.randint(-127, 128, (T, hkv, d), device=dev, generator=g, dtype=torch.int8)
    ks = torch.rand(T, hkv, device=dev, generator=g) * 0.01 + 0.01
    vs = torch.rand(T, hkv, device=dev, generator=g) / 127 + 1e-3
    per_shape = []
    for start in (0, C, 2 * C):
        q = (3 * torch.randn(C, hq, d, device=dev, generator=g)).to(bf16)
        kc = torch.randn(C, hkv, d, device=dev, generator=g).to(bf16)
        vc = torch.randn(C, hkv, d, device=dev, generator=g).to(bf16)
        args = (q, k_row, v_row, ks, vs, kc, vc, start, rep)
        got = pa.chunk_prefill_attention(*args)
        err = attn_check(f"chunk_prefill_attention C={C} start={start}", got,
                         pa.chunk_prefill_attention_plain(*args))
        require(torch.equal(got, pa.chunk_prefill_attention(*args)),
                f"chunk_prefill_attention start={start} gave other bits on a second call")
        if not start:
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
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); two calls "
              f"bit-equal")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms, shape=f"C={C} start={start} T={T}")
        per_shape.append(row)
        if start == C:
            rows["chunk_prefill_attention"] = dict(row, per_shape=per_shape)
    return rows


# -- phase 2: model -----------------------------------------------------------

def zero_counts(counters) -> None:
    for table in counters:
        for key in table:
            table[key] = 0


def read_counts(counters) -> dict:
    return {k: v for table in counters for k, v in table.items()}


def model_phase(engine, dev, counters, what="int4", tol=1e-1):
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
    # int4: the two routes round to bf16 at different places (f32
    # softmax and exact int4 weights in the kernels; bf16 probabilities
    # and bf16 dequantized weights off them) through 16 layers; the
    # random-weight model amplifies those sub-percent differences layer
    # by layer. W4A8: see W4A8_TOL.
    print(f"model llama-1b {what} {spec.layers} layers: prefill 300 tokens (chunks of {chunk}) "
          f"+ 4 decode steps, kernels on vs off: mean rel err {rel:.3e} (tol {tol}), "
          f"argmax agreement {agree:.2f}")
    print(f"launches in one decode step: {json.dumps(per_step)}")
    require(rel <= tol, "model logits with kernels on and off disagree")
    return per_step


# -- phase 3: serving ---------------------------------------------------------

def _timers(engine) -> str:
    """The loop timers, and the host seconds the greedy block's warm-up and
    capture took inside ``dispatch`` (once per engine)."""
    block = engine._greedy
    capture = f"; graph warm-up and capture {block.capture_s:.3f} s" if block is not None else ""
    return json.dumps({k: round(v, 3) for k, v in engine.loop_timers.items()}) + capture


def require_prefill_launches(engine, prompts, launches, what) -> None:
    """Serving ``prompts`` on a dense engine without prefix reuse or a
    draft must launch causal_attention once a layer for every bucketed
    prefill, whatever its bucket, and chunk_prefill_attention once a layer
    for every chunk."""
    causal = chunks = 0
    c = engine.prefill_chunk
    for prompt in prompts:
        if c and (len(prompt) > c or len(prompt) > engine.prefill_buckets[-1]):
            chunks += -(-len(prompt) // c)
        else:
            causal += 1
    layers = engine.spec.layers
    for name, want in (("causal_attention", layers * causal),
                       ("chunk_prefill_attention", layers * chunks)):
        require(launches[name] == want, f"{what}: {name} launched {launches[name]} times, want "
                                        f"{want} (one a layer for every dense prefill or chunk)")


def _decode_marks(engine):
    block = engine._greedy
    return engine.steps, (block.warmups if block is not None else 0)


def require_decode_launches(engine, launches, kernel, marks, what) -> None:
    """Every decode step of the greedy engine ran ``kernel`` once a layer,
    whether its block was a graph replay (whose launches the engine adds
    to the counters) or eager: the steps of the consumed blocks since
    ``marks`` (``_decode_marks``), plus one block for each warm-up run
    before a capture. Every block was a replay."""
    steps0, warm0 = marks
    block = engine._greedy
    require(block is not None and block.replays > 0, f"{what}: no decode block was a graph replay")
    want = engine.spec.layers * (engine.steps - steps0
                                 + engine.steps_per_sync * (block.warmups - warm0))
    require(launches[kernel] == want, f"{what}: {kernel} launched {launches[kernel]} times, want "
                                      f"{want} (one a layer for every decode step)")
    print(f"{what}: {kernel} launched {want} times, once a layer for each of "
          f"{engine.steps - steps0} decode steps in {block.replays} graph replays and "
          f"{block.warmups - warm0} warm-up block(s): exact")


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
    marks = _decode_marks(engine)
    t0 = time.perf_counter()
    reqs = [GenerationRequest(prompt_ids=p, max_new_tokens=new) for p in prompts]
    for r in reqs:  # all queued before the loop starts: one admission order
        engine.submit(r)
    engine.start()
    try:
        outs = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
    finally:
        engine.stop()
    launches = read_counts(counters)
    require_decode_launches(engine, launches, "decode_attention", marks, "llama_decoder")
    for i, out in enumerate(outs):
        require(len(out) == new, f"request {i} returned {len(out)} tokens")
        require(all(0 <= t < vocab for t in out), f"request {i} returned out-of-vocab tokens")
    require(outs[0] == outs[3], "the same prompt twice gave different tokens")
    for name in DECODER_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the decoder path")
    require_prefill_launches(engine, prompts, launches, "llama_decoder")
    step_s = engine.loop_timers["step"]
    decode_tokens = len(reqs) * (new - 1)
    print(f"serving on {card}: {len(reqs)} greedy requests (prompts {check_lens} + "
          f"{fill} x 64 tokens), {new} new tokens each, {wall:.2f} s wall; decode "
          f"{decode_tokens} tokens in {engine.steps} steps at pipeline depth "
          f"{engine.pipeline_depth}, {step_s:.2f} s host clock in decode blocks = "
          f"{decode_tokens / step_s:.1f} tok/s (end to end {len(reqs) * new / wall:.1f} tok/s); "
          f"loop_timers {_timers(engine)}")
    print(f"serving launches: {json.dumps(launches)}")
    return launches, prompts, outs


def _cache_tensors(cache) -> list:
    out = [cache.lengths]
    for leaves in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        out.extend(leaves)
    if hasattr(cache, "table"):
        out.append(cache.table)
    return out


def _profile_block(fn):
    """Run ``fn`` under torch.profiler: (device ms by kernel name, host
    [(op, self CPU ms, count)]), or None where the profiler fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()),
                      key=lambda t: -t[1])
        return by_name, host
    except Exception as exc:  # noqa: BLE001 - profiling may be unavailable on a machine
        print(f"torch.profiler failed ({exc!r}); device busy time not measured")
        return None


def decode_block_phase(engine, card, k1_step_ms=None, label="decode block"):
    """Where one decode block's time goes, the body run eagerly against
    the engine's CUDA graph: every slot busy (16-token prompts), blocks
    driven by hand at depth 1 after the serving phase. From one snapshot
    and the same cache contents (saved before, restored between), one
    block by the body called directly (``_decode_and_sample``) and one by
    the engine's dispatch, a replay of its graph: equal tokens, carry and
    cache bytes. For each, the host clock of the dispatch (the enqueue)
    and of the wait for its tokens, and the device span between CUDA
    events around the dispatch; under torch.profiler, each one's device
    busy time (the sum of its kernels' times) and its cudaLaunchKernel and
    cudaGraphLaunch calls a step. The engine then serves the requests to
    their end."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.serving.generation import GenerationRequest

    steps = engine.steps_per_sync
    rng = np.random.default_rng(13)
    reqs = [GenerationRequest(prompt_ids=rng.integers(0, engine.spec.vocab, 16).astype(np.int32),
                              max_new_tokens=4 * steps) for _ in range(engine.num_slots)]
    for r in reqs:
        engine.submit(r)
    for _ in range(len(reqs)):  # admission may take the queue in pieces
        if engine.active_count() == engine.num_slots:
            break
        engine._admit_pending()
        engine._land_prefills(force=True)
    require(engine.active_count() == engine.num_slots,
            f"{label}: {engine.active_count()} of {engine.num_slots} slots active")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    snap = engine._snapshot_active()
    require(snap["sample"] is None, f"{label}: the snapshot samples")
    cache = _cache_tensors(engine.cache)
    saved = [t.clone() for t in cache]

    def restore():
        for t, v in zip(cache, saved):
            t.copy_(v)
        torch.cuda.synchronize()

    def eager():
        return engine._decode_and_sample(snap["ids_dev"], snap["active_dev"],
                                         snap["progress_dev"], snap)

    def timed(dispatch, fetch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = dispatch()
        end.record()
        t1 = time.perf_counter()
        tokens = fetch(out)
        return out, tokens, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    e_out, e_tokens, e_dispatch, e_wait = timed(eager, lambda o: o[0].cpu().numpy())
    e_span = start.elapsed_time(end)
    e_cache = [t.clone() for t in cache]
    restore()
    e_prof = _profile_block(eager)
    restore()
    rec, g_tokens, g_dispatch, g_wait = timed(
        lambda: engine._dispatch_block(snap["ids_dev"], snap["progress_dev"], snap),
        lambda r: engine._fetch(r["host"], r["event"]).copy())
    g_span = start.elapsed_time(end)
    same_tokens = bool(np.array_equal(e_tokens, g_tokens))
    same_carry = all(bool(torch.equal(a, b)) for a, b in
                     zip(e_out[1:], (rec["nxt"], rec["prog"], rec["alive"])))
    same_cache = all(bool(torch.equal(a, b)) for a, b in zip(cache, e_cache))
    engine._consume_block(rec)  # commit the replayed block
    del saved, e_cache
    torch.cuda.empty_cache()

    def replayed():
        nsnap = engine._snapshot_active()
        engine._consume_block(engine._dispatch_block(nsnap["ids_dev"], nsnap["progress_dev"],
                                                     nsnap))

    g_prof = _profile_block(replayed)
    engine.start()
    try:
        outs = [r.result(timeout=600) for r in reqs]
    finally:
        engine.stop()
    require(all(len(o) == 4 * steps for o in outs), f"{label}: a request came back short")
    block = engine._greedy
    print(f"{label} on {card}: {steps} steps x {engine.num_slots} slots, the body eager "
          f"against the graph replay from the same snapshot and cache: tokens equal {same_tokens}, "
          f"carry equal {same_carry}, cache bytes equal {same_cache}; graph memory pool "
          f"{block.pool_bytes / 2 ** 20:.1f} MiB (torch.cuda.memory_reserved around the capture), "
          f"{block.replays} replays, {block.warmups} warm-up block(s)")
    require(same_tokens and same_carry and same_cache,
            f"{label}: the graph replay differs from the body run eagerly")
    result = {}
    for what, dispatch_ms, wait_ms, span, prof in (
            ("eager", e_dispatch, e_wait, e_span, e_prof),
            ("graph", g_dispatch, g_wait, g_span, g_prof)):
        host_ms = dispatch_ms + wait_ms
        busy_ms, line, attn_ms = None, "", None
        if prof is not None:
            by_name, host = prof
            busy_ms = sum(by_name.values()) if by_name else None
            calls = {key: n for key, _, n in host if key in ("cudaLaunchKernel", "cudaGraphLaunch")}
            line = (f"; device busy (torch.profiler kernel sum) "
                    + ("not measured" if busy_ms is None else
                       f"{busy_ms:.3f} ms ({busy_ms / steps:.3f} a step)")
                    + f"; cudaLaunchKernel {calls.get('cudaLaunchKernel', 0) / steps:.1f} a step, "
                      f"cudaGraphLaunch {calls.get('cudaGraphLaunch', 0)} in the block")
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            if top:
                line += ("; device ms by kernel (top 6): "
                         + json.dumps({k[:70]: round(v, 4) for k, v in top}))
            # decode attention: csrc/decode_mma.cuh's main and merge kernels
            attn_ms = sum(v for k, v in by_name.items()
                          if "dmma::attend_kernel" in k or "dmma::merge_kernel" in k)
            line += f"; decode attention (decode_mma.cuh) {attn_ms:.4f} ms in the block"
        print(f"{label} {what} on {card}: host clock {host_ms:.3f} ms ({host_ms / steps:.3f} a "
              f"step) = dispatch {dispatch_ms:.3f} + wait for the tokens {wait_ms:.3f}; device "
              f"span (CUDA events around the dispatch) {span:.3f} ms{line}")
        result[what] = dict(host_ms=host_ms, dispatch_ms=dispatch_ms, span_ms=span,
                            busy_ms=busy_ms, attention_ms=attn_ms if prof is not None else None)
    if k1_step_ms is not None:
        print(f"{label}: int4_matmul per step from the kernel phase {k1_step_ms:.3f} ms")
    return result


def sampling_phase(spec, int4_params, counters, card, dev):
    """Device-side sampling (serving/sampling.py). ``sample_tokens`` at
    the decoder's slots and vocab on the card against the same call on a
    CPU copy of its inputs: equal random bits, equal Gumbel noise, equal
    tokens (a near-tie flip is printed before the check fails), and the
    time of the engine's own draw, ``sample_rows`` on 16 rows. Then 16
    sampled requests (temperature 0.8, top-k 40, 16 seeds; prompts in
    buckets 64, 128 and 256) through llama_decoder.yml at its depth and
    at depth 1 (``decode_overlap: false``): equal streams, every prefill
    through causal_attention; and the same prompts greedy at its depth,
    whose host clock a step is printed beside the sampled run's."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.serving import sampling
    from starpu_inference_server_tpu_torch.serving.generation import (
        GenerationRequest, build_generation_engine,
    )
    from starpu_inference_server_tpu_torch.utils.config import load_config

    cfg = load_config(str(CONFIG))
    s, vocab = int(cfg.model.options["num_slots"]), spec.vocab
    rng = np.random.default_rng(17)
    host = {
        "logits": torch.from_numpy((3 * rng.standard_normal((s, vocab))).astype(np.float32)),
        "temps": torch.from_numpy(rng.choice([0.0, 0.5, 0.8, 1.2], s).astype(np.float32)),
        "top_k": torch.from_numpy(rng.choice([0, 1, 40, vocab], s).astype(np.int32)),
        "seeds": torch.from_numpy(rng.integers(0, 2 ** 32, s, dtype=np.uint64).astype(np.int64)),
        "progress": torch.from_numpy(rng.integers(0, 1000, s).astype(np.int32)),
    }
    card_in = {k: v.to(dev) for k, v in host.items()}
    keys = {where: sampling.fold_in(sampling.prng_key(a["seeds"]), a["progress"])
            for where, a in (("cpu", host), ("card", card_in))}
    bits_equal = torch.equal(sampling.random_bits(keys["card"], vocab).cpu(),
                             sampling.random_bits(keys["cpu"], vocab))
    noise_equal = torch.equal(sampling.gumbel(keys["card"], vocab).cpu(),
                              sampling.gumbel(keys["cpu"], vocab))
    want = sampling.sample_tokens(**host)
    got = sampling.sample_tokens(**card_in).cpu()
    flips = torch.nonzero(got != want).flatten().tolist()
    for i in flips:
        row = host["logits"][i]
        print(f"sampling: slot {i} drew {int(got[i])} on the card, {int(want[i])} on the CPU "
              f"(logits {row[int(got[i])]:.6f} / {row[int(want[i])]:.6f})")
    ms = time_ms(lambda: sampling.sample_tokens(**card_in), iters=5)
    print(f"sampling sample_tokens S={s} V={vocab} on {card}: random bits card == CPU "
          f"{bits_equal}, Gumbel noise card == CPU {noise_equal}, {s - len(flips)} of {s} tokens "
          f"equal ({int((host['temps'] > 0).sum())} sampled slots); {ms:.4f} ms a call (every "
          f"row drawn)")
    require(bits_equal and noise_equal, "sampling: the card's random bits or noise differ")
    require(not flips, "sampling: a token drawn on the card differs from the CPU's")

    # prompts in every dense bucket the config reaches (64, 128, 256;
    # longer prompts are chunked at its prefill_chunk of 256)
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, vocab, (40, 100, 200)[i % 3]).astype(np.int32) for i in range(16)]
    new = 16

    # the engine's draw for these rows: sample_rows on the 16 sampled
    # slots' logits at top-k 40, as GenerationEngine._sample calls it
    idx = torch.arange(len(prompts), device=dev)
    rows_in = (card_in["logits"].index_select(0, idx), torch.full((len(idx),), 0.8, device=dev),
               torch.full((len(idx),), 40, dtype=torch.int32, device=dev),
               keys["card"].index_select(0, idx), 40)
    rows_ms = time_ms(lambda: sampling.sample_rows(*rows_in), iters=5)
    print(f"sampling sample_rows N={len(idx)} V={vocab} top-k 40 on {card}: {rows_ms:.4f} ms a "
          f"call (the engine's draw for {len(idx)} sampled slots, once a decode step)")

    # sampled at the config's depth and at depth 1, then greedy at the
    # config's depth: the same prompts, so the step times compare
    streams, timers = {}, {}
    for kind, depth_cfg, timed in (("sampled", cfg, True),
                                   ("sampled", _cfg_with(cfg, decode_overlap=False), False),
                                   ("greedy", cfg, True)):
        engine = build_generation_engine(depth_cfg, device=dev, params=int4_params)
        temp = 0.8 if kind == "sampled" else 0.0
        reqs = [GenerationRequest(prompt_ids=p, max_new_tokens=new, temperature=temp, top_k=40,
                                  seed=1000 + i) for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        zero_counts(counters)
        for r in reqs:
            engine.submit(r)
        engine.start()
        try:
            outs = [r.result(timeout=600) for r in reqs]
        finally:
            engine.stop()
        torch.cuda.synchronize()
        launches = read_counts(counters)
        require(all(len(o) == new and all(0 <= t < vocab for t in o) for o in outs),
                f"{kind} requests: a stream is short or out of vocab")
        require_prefill_launches(engine, prompts, launches, f"{kind} requests")
        if kind == "sampled":
            streams[engine.pipeline_depth] = outs
        if timed:
            block = engine._greedy
            timers[kind] = (engine.steps, dict(engine.loop_timers,
                                               capture=block.capture_s if block else 0.0))
        del engine
    (d_hi, hi), (d_lo, lo) = sorted(streams.items(), reverse=True)
    same = sum(a == b for a, b in zip(hi, lo))
    distinct = len({tuple(o) for o in hi})
    print(f"sampling: {len(prompts)} sampled requests, {same} of {len(prompts)} streams at depth "
          f"{d_hi} identical to depth {d_lo}; {distinct} distinct streams")
    for kind, (steps, t) in timers.items():
        print(f"sampling: {len(prompts)} {kind} requests at depth {d_hi} on {card}: {steps} decode "
              f"steps, host clock in decode blocks {t['step'] * 1e3 / steps:.3f} ms a step, "
              f"dispatch {t['dispatch'] * 1e3 / steps:.3f} ms a step (graph warm-up and capture "
              f"{t['capture']:.3f} s of it, once); loop_timers "
              + json.dumps({k: round(v, 3) for k, v in t.items()}))
    require(same == len(prompts), "a sampled stream at depth 1 differs from the config's depth")
    torch.cuda.empty_cache()


def tiny_phase(rows, counters, card, dev):
    """A llama-tiny decoder at its registered width (hidden 256, 8 query
    and 4 KV heads: head_dim 32; 4 layers, vocab 2048), random FP32
    weights from seed 0. First causal_attention and
    chunk_prefill_attention at head_dim 32 against their plain versions,
    bf16 (tensor cores) and f32, each bit-equal over two calls (added to
    the kernels' per_shape lists). Then an FP32 engine (buckets 16-128,
    128-row chunks, max_len 256) serves prompts at every bucket and one
    chunked: every prefill through causal_attention, every chunk through
    chunk_prefill_attention, one launch a layer each, every decode block a
    graph replay; its greedy streams must equal the same engine's with the
    kernels off."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.models.decoder import get_spec, init_params
    from starpu_inference_server_tpu_torch.ops import prefill_attention as pa

    spec = get_spec("llama-tiny", {})
    hq, hkv, d, rep = spec.q_heads, spec.kv_heads, spec.head_dim, spec.rep
    require(d == 32, f"llama-tiny's head_dim is {d}, not 32")
    g = torch.Generator(device=dev).manual_seed(32)
    for dtype in (torch.bfloat16, torch.float32):
        for t in (64, 128):
            q = (3 * torch.randn(1, t, hq, d, device=dev, generator=g)).to(dtype)
            k = torch.randn(1, t, hkv, d, device=dev, generator=g).to(dtype)
            v = torch.randn(1, t, hkv, d, device=dev, generator=g).to(dtype)
            got = pa.causal_attention(q, k, v, rep)
            err = attn_check(f"causal_attention D=32 {dtype} T={t}", got,
                             pa.causal_attention_plain(q, k, v, rep))
            require(torch.equal(got, pa.causal_attention(q, k, v, rep)),
                    f"causal_attention D=32 T={t} gave other bits on a second call")
            if dtype == torch.bfloat16:
                ms = time_ms(lambda: pa.causal_attention(q, k, v, rep))
                print(f"time causal_attention D=32 T={t} (llama-tiny): kernel {ms:.4f} ms")
                rows["causal_attention"]["per_shape"].append(
                    dict(max_abs_err=err, ms=ms, shape=f"B=1 T={t} Hq={hq} D={d}"))
        c, tmax = 128, 256
        k_row = torch.randint(-127, 128, (tmax, hkv, d), device=dev, generator=g, dtype=torch.int8)
        v_row = torch.randint(-127, 128, (tmax, hkv, d), device=dev, generator=g, dtype=torch.int8)
        ks = torch.rand(tmax, hkv, device=dev, generator=g) * 0.01 + 0.01
        vs = torch.rand(tmax, hkv, device=dev, generator=g) / 127 + 1e-3
        q = (3 * torch.randn(c, hq, d, device=dev, generator=g)).to(dtype)
        kc = torch.randn(c, hkv, d, device=dev, generator=g).to(dtype)
        vc = torch.randn(c, hkv, d, device=dev, generator=g).to(dtype)
        args = (q, k_row, v_row, ks, vs, kc, vc, 128, rep)
        got = pa.chunk_prefill_attention(*args)
        err = attn_check(f"chunk_prefill_attention D=32 {dtype} C={c} start=128", got,
                         pa.chunk_prefill_attention_plain(*args))
        require(torch.equal(got, pa.chunk_prefill_attention(*args)),
                "chunk_prefill_attention D=32 gave other bits on a second call")
        if dtype == torch.bfloat16:
            ms = time_ms(lambda: pa.chunk_prefill_attention(*args))
            print(f"time chunk_prefill_attention D=32 C={c} start=128 (llama-tiny): kernel "
                  f"{ms:.4f} ms")
            rows["chunk_prefill_attention"]["per_shape"].append(
                dict(max_abs_err=err, ms=ms, shape=f"C={c} start=128 T={tmax} Hq={hq} D={d}"))

    params = init_params(spec, np.random.default_rng(0))
    rng = np.random.default_rng(33)
    lens = [10, 20, 50, 100, 200, 7, 64, 128]  # buckets 16, 32, 64, 128; 200 in two chunks
    prompts = [rng.integers(0, spec.vocab, n).astype(np.int32) for n in lens]
    kernels_on_off_streams(spec, params, prompts, counters, card, dev, "llama-tiny (head_dim 32)")


def kernels_on_off_streams(spec, params, prompts, counters, card, dev, what):
    """An FP32 engine of ``spec`` (4 slots, buckets 16-128, 128-row
    chunks, max_len 256, depth 4) serves ``prompts`` greedily twice, with
    the kernels on and off: with them on, every prefill through
    causal_attention and every chunk through chunk_prefill_attention, one
    launch a layer each, every decode block a graph replay; with them off,
    no kernel launched; the streams must be equal."""
    import torch

    from starpu_inference_server_tpu_torch.ops import nn
    from starpu_inference_server_tpu_torch.serving.generation import (
        GenerationEngine,
        GenerationRequest,
    )

    streams = {}
    for kernels in (True, False):
        nn.set_use_kernels(None if kernels else False)
        try:
            engine = GenerationEngine(spec, params, dtype=torch.float32, device=dev, num_slots=4,
                                      max_len=256, prefill_buckets=[16, 32, 64, 128],
                                      prefill_chunk=128, steps_per_sync=4, decode_overlap=True,
                                      pipeline_depth=4)
            torch.cuda.synchronize()
            zero_counts(counters)
            marks = _decode_marks(engine)
            reqs = [GenerationRequest(prompt_ids=p, max_new_tokens=24) for p in prompts]
            for r in reqs:
                engine.submit(r)
            engine.start()
            try:
                streams[kernels] = [r.result(timeout=600) for r in reqs]
            finally:
                engine.stop()
            torch.cuda.synchronize()
            launches = read_counts(counters)
        finally:
            nn.set_use_kernels(None)
        if kernels:
            require_prefill_launches(engine, prompts, launches, what)
            require_decode_launches(engine, launches, "decode_attention", marks, what)
            print(f"{what} on {card}: {len(prompts)} requests at buckets 16-128 "
                  f"and one chunked prompt, launches "
                  + json.dumps({k: v for k, v in launches.items() if v}))
        else:
            require(not any(launches.values()), f"{what} with the kernels off launched one")
        del engine
    same = sum(a == b for a, b in zip(streams[True], streams[False]))
    print(f"{what} FP32: {same} of {len(prompts)} greedy streams with the "
          f"kernels on identical to the kernels off")
    require(same == len(prompts), f"{what}: a stream with the kernels on differs from off")


# -- phase 4: kernels of the batch ModelInfer path ------------------------------

def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().mean() / b.abs().mean()).item()


def batch_kernel_phase(dev):
    import torch
    import torch.nn.functional as F

    from starpu_inference_server_tpu_torch.ops import prefill_attention as pa
    from starpu_inference_server_tpu_torch.ops import stem_kernel as sk

    g = torch.Generator(device=dev).manual_seed(4321)
    bf16 = torch.bfloat16
    rows = {}

    # bidirectional_attention at BERT-base s=512, B=16: sharp logits
    # (q = 3 N(0,1), so q.k/8 has std ~3); samples 0-2 padded at three
    # lengths, sample 3 fully masked (every key -1e9: the mean of v)
    b, t, h, d = 16, 512, 12, 64
    q = (3 * torch.randn(b, t, h, d, device=dev, generator=g)).to(bf16)
    kk = torch.randn(b, t, h, d, device=dev, generator=g).to(bf16)
    v = torch.randn(b, t, h, d, device=dev, generator=g).to(bf16)
    bias = torch.zeros(b, t, device=dev)
    for i, length in enumerate((100, 300, 450)):
        bias[i, length:] = -1e9
    bias[3] = -1e9
    got = pa.bidirectional_attention(q, kk, v, bias)
    ref = pa.bidirectional_attention_plain(q, kk, v, bias)
    require(bool(torch.isfinite(got.float()).all()), "bidirectional_attention gave non-finite values")
    err = attn_check(f"bidirectional_attention B={b} T={t} H={h} D={d}", got, ref)
    same = bool(torch.equal(got, pa.bidirectional_attention(q, kk, v, bias)))
    print(f"kernel bidirectional_attention B={b} T={t}: two calls bit-equal {same}")
    require(same, "bidirectional_attention gave other bits on a second call")
    ms = time_ms(lambda: pa.bidirectional_attention(q, kk, v, bias))
    plain_ms = time_ms(lambda: pa.bidirectional_attention_plain(q, kk, v, bias), iters=3)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, kk, v))
    mask = bias[:, None, None, :].to(bf16)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    b_ms, b_by = bound_ms(4 * b * t * h * d * 2 + b * t * 4, 4.0 * b * h * t * t * d)
    print(f"time bidirectional_attention B={b} T={t}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, sdpa (float mask) {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    rows["bidirectional_attention"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, shape=f"B={b} T={t} H={h} D={d}",
        library="scaled_dot_product_attention with a float mask")
    del q, kk, v, qt, kt, vt

    # fused_stem at B=1, 4, 8 (the serving batches) and 32 (the row): the
    # padded s2d image of a random input, a folded random stem weight and
    # a BN affine; f32 and bf16 output held against the plain version, two
    # calls bit-equal, timed beside the cuDNN sequence in NCHW and in
    # channels_last (the faster is the row's library time)
    per_shape = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for bsz in (1, 4, 8, 32):
        zp = torch.zeros(bsz, 118, 118, 12, device=dev)
        zp[:, 3:115, 3:115] = torch.randn(bsz, 112, 112, 12, device=dev, generator=g)
        zp = zp.to(bf16)
        w = (torch.randn(192, 64, device=dev, generator=g) * 0.1).to(bf16)
        scale = torch.rand(64, device=dev, generator=g) + 0.5
        shift = torch.randn(64, device=dev, generator=g) * 0.1
        for out_dtype in (torch.float32, bf16):
            got = sk.fused_stem(zp, w, scale, shift, out_dtype)
            ref = sk.fused_stem_plain(zp, w, scale, shift, out_dtype)
            what = "bf16" if out_dtype == bf16 else "f32"
            err = attn_check(f"fused_stem B={bsz} {what} out", got, ref)
            same = bool(torch.equal(got, sk.fused_stem(zp, w, scale, shift, out_dtype)))
            print(f"kernel fused_stem B={bsz} {what} out: two calls bit-equal {same}")
            require(same, f"fused_stem B={bsz} gave other bits on a second call")
        ms = time_ms(lambda: sk.fused_stem(zp, w, scale, shift))
        plain_ms = time_ms(lambda: sk.fused_stem_plain(zp, w, scale, shift), iters=5)
        sc4, sh4 = scale.reshape(1, -1, 1, 1).to(bf16), shift.reshape(1, -1, 1, 1).to(bf16)
        library = {}
        for layout, fmt in (("NCHW", torch.contiguous_format),
                            ("channels_last", torch.channels_last)):
            zb = zp.permute(0, 3, 1, 2).contiguous(memory_format=fmt)
            wk = w.reshape(4, 4, 12, 64).permute(3, 2, 0, 1).contiguous(memory_format=fmt)

            def sequence(zb=zb, wk=wk):
                y = F.conv2d(zb, wk)[:, :, :113, :113]
                return F.max_pool2d(torch.relu(y * sc4 + sh4), kernel_size=3, stride=2)

            library[layout] = time_ms(sequence)
        best = min(library, key=library.get)
        nbytes = bsz * 118 * 118 * 12 * 2 + 192 * 64 * 2 + 2 * 64 * 4 + bsz * 56 * 56 * 64 * 2
        b_ms, b_by = bound_ms(nbytes, 2.0 * bsz * 112 * 112 * 192 * 64)
        print(f"time fused_stem B={bsz} (grid {sk.stem_plan(bsz, sms)}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sequence conv2d+affine+relu+max_pool2d (bf16 cuDNN) NCHW "
              f"{library['NCHW']:.4f} ms, channels_last {library['channels_last']:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=library[best], shape=f"B={bsz} zp [118,118,12] -> [56,56,64]",
                   library=f"sequence, not one call: conv2d + affine + relu + max_pool2d "
                           f"(bf16 cuDNN, {best}, the faster of NCHW and channels_last)",
                   library_nchw_ms=library["NCHW"], library_channels_last_ms=library[
                       "channels_last"], grid=sk.stem_plan(bsz, sms))
        per_shape.append(row)
        del zp
    rows["fused_stem"] = dict(per_shape[-1], per_shape=per_shape)
    return rows


# -- phase 5: models of the batch path -----------------------------------------

def forward_ms(model, inputs, reps: int = 3) -> float:
    """Median host-clock time of ``reps`` forwards, each ended by a
    synchronise: the time of one batch on an otherwise idle host."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            model.apply(inputs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]

def bert_model_phase(model, dev, counters, what="w8a8", tol=BERT_TOL, timed=True):
    """BERT-base s=512 at full depth, B=16, kernels on against off;
    returns each kernel's launches in one forward."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.ops import nn

    rng = np.random.default_rng(21)
    b, s = 16, 512
    ids = torch.from_numpy(rng.integers(0, 30522, (b, s))).to(dev)
    mask = torch.ones(b, s, dtype=torch.int64)
    for i in range(b):
        mask[i, int(rng.integers(64, s + 1)):] = 0
    inputs = {"input_ids": ids, "attention_mask": mask.to(dev)}
    outs = {}
    per_forward = {}
    for kernels in (True, False):
        nn.set_use_kernels(kernels)
        try:
            torch.cuda.synchronize()
            zero_counts(counters)
            with torch.inference_mode():
                outs[kernels] = model.apply(inputs)["last_hidden_state"]
            torch.cuda.synchronize()
            if kernels:
                per_forward = read_counts(counters)
        finally:
            nn.set_use_kernels(None)
    on, off = outs[True], outs[False]
    require(bool(torch.isfinite(on).all()), "BERT hidden states are not finite")
    require(tuple(on.shape) == (b, s, 768), f"BERT output shape {tuple(on.shape)}")
    rel = rel_err(on, off)
    layers = len(model.params["layers"])
    print(f"model bert-base {layers} layers s={s} B={b} {what}: kernels on vs off: mean rel err "
          f"{rel:.3e} (tol {tol}); launches in one forward: {json.dumps(per_forward)}")
    require(rel <= tol, f"BERT {what} with kernels on and off disagree")
    require(per_forward["bidirectional_attention"] == layers,
            f"bidirectional_attention ran {per_forward['bidirectional_attention']} times in "
            f"one forward of {layers} layers")
    if timed:
        one = {k: v[:1] for k, v in inputs.items()}
        print(f"model bert-base forward, kernels on (host clock, synchronised, median of 3): "
              f"B={b} {forward_ms(model, inputs):.2f} ms, B=1 {forward_ms(model, one):.2f} ms")
    return per_forward


def resnet_model_phase(model, options, dev, counters):
    """ResNet-18 int8 at B=32, fused stem against the s2d stem, both with
    kernels on: at the config's BF16 compute (launches per forward, the
    difference printed) and at FP32 compute, where the JAX package's
    limit holds; returns each kernel's launches in one forward."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.models.registry import get_family

    x = torch.from_numpy(np.random.default_rng(22).standard_normal((32, 3, 224, 224))
                         .astype(np.float32)).to(dev)
    unfused = get_family("resnet18", dict(options, stem_fused=False))
    torch.cuda.synchronize()
    zero_counts(counters)
    with torch.inference_mode():
        fused_out = model.apply({"input": x})["output"]
    torch.cuda.synchronize()
    per_forward = read_counts(counters)
    require(bool(torch.isfinite(fused_out).all()), "ResNet logits are not finite")
    require(tuple(fused_out.shape) == (32, 1000), f"ResNet output shape {tuple(fused_out.shape)}")
    outs = {}
    with torch.inference_mode():
        ref_bf16 = unfused.apply(model.params, {"input": x}, model.compute_dtype)["output"]
        for name, definition in (("fused", model.definition), ("s2d", unfused)):
            outs[name] = definition.apply(model.params, {"input": x}, torch.float32)["output"]
    rel_bf16 = rel_err(fused_out, ref_bf16)
    rel = rel_err(outs["fused"], outs["s2d"])
    agree = (outs["fused"].argmax(-1) == outs["s2d"].argmax(-1)).float().mean().item()
    print(f"model resnet18 int8 B=32: fused stem vs s2d stem: FP32 compute mean rel err "
          f"{rel:.3e} (tol {RESNET_TOL}), argmax agreement {agree:.3f}; BF16 compute mean rel "
          f"err {rel_bf16:.3e}; launches in one forward: {json.dumps(per_forward)}")
    require(rel <= RESNET_TOL, "ResNet with the fused and the s2d stem disagree")
    require(agree == 1.0, "ResNet argmax differs between the fused and the s2d stem")
    require(per_forward["fused_stem"] == 1 and per_forward["int8_matmul"] == 1,
            "ResNet forward did not run fused_stem and int8_matmul once each")
    # the forward with each stem: the host clock a batch takes, and the
    # device busy time (torch.profiler's kernel sum), which resolves the stem
    s2d = types.SimpleNamespace(
        apply=lambda inputs: unfused.apply(model.params, inputs, model.compute_dtype))
    for bsz in (32, 8):
        inputs = {"input": x[:bsz]}
        line = []
        for stem, target in (("fused", model), ("s2d", s2d)):
            host = forward_ms(target, inputs)

            def run(target=target):
                with torch.inference_mode():
                    target.apply(inputs)
                torch.cuda.synchronize()

            prof = _profile_block(run)
            busy = "not measured" if prof is None else f"{sum(prof[0].values()):.4f} ms"
            line.append(f"{stem} stem host {host:.2f} ms, device busy {busy}")
        print(f"model resnet18 int8 forward B={bsz} (host clock, synchronised, median of 3; "
              f"device busy: torch.profiler kernel sum of one forward): " + "; ".join(line))
    return per_forward


# -- phase 6: serving the batch path over gRPC --------------------------------

class LocalServer:
    """The port's InferenceServer on a local port, on its own asyncio
    loop thread; warmup runs before it reports ready. ``metrics_port`` is
    set to 0: with the config's ``metrics_enabled`` every server of the
    run serves ``/metrics`` on an ephemeral port, freed at its stop."""

    def __init__(self, cfg, params=None):
        from starpu_inference_server_tpu_torch.grpc.server import InferenceServer

        cfg = dataclasses.replace(cfg, metrics_port=0, server=dataclasses.replace(
            cfg.server, address="127.0.0.1:0"))
        self.server = InferenceServer(cfg, device="cuda", params=params)
        self.ready = threading.Event()
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.error = None

    def _run(self):
        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_until_complete(self.server.serve(warmup=True, ready_event=self.ready))
        except BaseException as exc:  # noqa: BLE001 - reported by start()
            self.error = exc
            self.ready.set()

    def start(self, timeout=900):
        t0 = time.perf_counter()
        self.thread.start()
        require(self.ready.wait(timeout) and self.error is None,
                f"server {self.server.cfg.name} failed to start: {self.error!r}")
        cfg = self.server.cfg
        require((self.server.metrics_port is not None) == cfg.metrics_enabled,
                f"server {cfg.name}: metrics_enabled {cfg.metrics_enabled} but /metrics port "
                f"{self.server.metrics_port}")
        print(f"server {cfg.name}: built, warmed up and serving in "
              f"{time.perf_counter() - t0:.1f} s on port {self.server.bound_port}; "
              f"/metrics on port {self.server.metrics_port}; congestion monitor "
              f"{'on' if cfg.congestion.enabled else 'off'}")
        return f"127.0.0.1:{self.server.bound_port}"

    def stop(self):
        self.loop.call_soon_threadsafe(self.server.request_stop)
        self.thread.join(timeout=120)
        require(not self.thread.is_alive(), f"server {self.server.cfg.name} did not stop")


def infer_all(target, requests):
    """Send every request at once; returns (responses, per-request
    latency in ms on the host clock, wall seconds)."""
    import grpc

    from starpu_inference_server_tpu_torch.grpc import kserve_v2_pb2 as pb

    async def go():
        opts = [("grpc.max_receive_message_length", 64 << 20)]
        async with grpc.aio.insecure_channel(target, options=opts) as channel:
            call = channel.unary_unary(
                "/inference.GRPCInferenceService/ModelInfer",
                request_serializer=pb.ModelInferRequest.SerializeToString,
                response_deserializer=pb.ModelInferResponse.FromString)

            async def one(req):
                t0 = time.perf_counter()
                resp = await call(req, timeout=600)
                return resp, (time.perf_counter() - t0) * 1e3

            t0 = time.perf_counter()
            done = await asyncio.gather(*(one(r) for r in requests))
            return done, time.perf_counter() - t0

    done, wall = asyncio.run(go())
    return [d[0] for d in done], [d[1] for d in done], wall


def make_request(name, arrays, rid):
    from starpu_inference_server_tpu_torch.grpc import kserve_v2_pb2 as pb

    req = pb.ModelInferRequest(model_name=name, id=rid)
    for key, arr in arrays.items():
        t = req.inputs.add()
        t.name, t.datatype = key, {"float32": "FP32", "int64": "INT64"}[arr.dtype.name]
        t.shape.extend(arr.shape)
        req.raw_input_contents.append(arr.tobytes())
    return req


def batch_serving_phase(what, bundle, samples, output, tol, counters, path_kernels, card,
                        unit, check_argmax=False, elem_tol=None):
    """Serve ``samples`` (one request each) through the batch pipeline;
    hold every response against a batch-1 apply of the same sample (mean
    relative error <= ``tol``; with ``elem_tol`` = (atol, rtol) also
    |got - ref| <= atol + rtol |ref| at every element)."""
    import numpy as np
    import torch

    server = bundle.server
    target = bundle.target
    requests = [make_request(server.cfg.name, arrays, str(i)) for i, arrays in enumerate(samples)]
    dispatcher = server.runner.dispatcher
    torch.cuda.synchronize()
    zero_counts(counters)
    before = {size: agg["count"] for size, agg in dispatcher.batch_stats.items()}
    done_before = dispatcher.completed_jobs
    t_burst = time.perf_counter()
    resps, lat, wall = infer_all(target, requests)
    burst = (t_burst, time.perf_counter())
    # the dispatcher counts a batch just after its responses went out
    require(dispatcher.wait_for_drain(done_before + len(requests), 30.0),
            f"{what}: the dispatcher did not count every request")
    torch.cuda.synchronize()
    launches = read_counts(counters)
    formed = {size: int(agg["count"] - before.get(size, 0))
              for size, agg in sorted(dispatcher.batch_stats.items())}
    formed = {size: c for size, c in formed.items() if c}
    for name in path_kernels:
        require(launches[name] > 0, f"kernel {name} was not launched on the {what} path")
    model = server.engine.model
    worst, worst_elem, argmax_ok = 0.0, 0.0, True
    for arrays, resp in zip(samples, resps):
        spec = next(s for s in server.cfg.outputs if s.name == output)
        got = np.frombuffer(resp.raw_output_contents[0], np.float32).reshape(1, *spec.dims)
        with torch.inference_mode():
            ref = model.apply({k: torch.from_numpy(v).to(model.device)
                               for k, v in arrays.items()})[output].float().cpu()
        got_t = torch.from_numpy(got.copy())
        require(bool(torch.isfinite(got_t).all()), f"{what}: a response is not finite")
        worst = max(worst, rel_err(got_t, ref))
        if elem_tol is not None:
            limit = elem_tol[0] + elem_tol[1] * ref.abs()
            worst_elem = max(worst_elem, ((got_t - ref).abs() / limit).max().item())
        if check_argmax:
            argmax_ok &= bool((got_t.argmax(-1) == ref.argmax(-1)).all())
    lat_sorted = sorted(lat)
    p50 = lat_sorted[len(lat) // 2]
    p99 = lat_sorted[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)]
    print(f"serving {what} on {card}: {len(requests)} concurrent ModelInfer requests in "
          f"{wall:.3f} s = {len(requests) / wall:.1f} {unit}/s; latency p50 {p50:.1f} ms, "
          f"p99 {p99:.1f} ms (host clock, client side); batches formed {json.dumps(formed)}; "
          f"worst response vs batch-1 apply: mean rel err {worst:.3e} (tol {tol})"
          + (f", worst element err/limit {worst_elem:.3f} (limit {elem_tol[0]} + "
             f"{elem_tol[1]} |ref|)" if elem_tol is not None else ""))
    # where a request's time went, from the server's own timing fields
    # (host clock; overall = receive to send, the rest is gRPC and client)
    phases = ("preprocess", "queue", "batch", "submit", "scheduling", "codelet", "inference",
              "callback", "total", "postprocess", "overall")
    mean_ms = {p: sum(getattr(r, f"server_{p}_ms") for r in resps) / len(resps) for p in phases}
    mean_ms["client"] = sum(lat) / len(lat)
    print(f"serving {what} mean ms per request by phase: {json.dumps(mean_ms)}")
    print(f"serving {what} launches: {json.dumps(launches)}")
    require(worst <= tol, f"{what}: a served response disagrees with a batch-1 apply")
    require(worst_elem <= 1.0, f"{what}: a served element disagrees with the batch-1 apply")
    require(argmax_ok, f"{what}: a served argmax differs from the batch-1 apply")
    stats = dict(wall_s=wall, rate=len(requests) / wall, p50_ms=p50, p99_ms=p99, formed=formed,
                 completed=dispatcher.completed_jobs - done_before, responses=resps, burst=burst)
    return launches, stats


# -- the control and observability plane on the batch servers ---------------

# the congestion gauges and the snapshot field each one publishes
CONGESTION_GAUGES = {
    "inference_congestion_flag": lambda s: 1.0 if s.congested else 0.0,
    "inference_congestion_score": lambda s: s.score,
    "inference_lambda_rps": lambda s: s.ewma_lambda,
    "inference_mu_rps": lambda s: s.ewma_mu,
    "inference_rho_ewma": lambda s: s.ewma_rho,
    "inference_queue_fill_ratio_ewma": lambda s: s.ewma_queue_fill,
    "inference_e2e_latency_p95_ms": lambda s: s.p95_ms,
    "inference_e2e_latency_p99_ms": lambda s: s.p99_ms,
}


def scrape_metrics(port) -> dict:
    """{sample with its labels: value} of one HTTP scrape of /metrics."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
        text = resp.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


class TickLog:
    """Every snapshot a server's congestion monitor publishes, with the
    host clock it came at, taken by chaining onto the monitor's public
    ``on_tick`` hook."""

    def __init__(self, monitor):
        self.snaps = []
        inner = monitor.on_tick

        def on_tick(snap):
            self.snaps.append((time.perf_counter(), snap))
            if inner is not None:
                inner(snap)

        monitor.on_tick = on_tick

    def within(self, span) -> list:
        return [s for t, s in self.snaps if span[0] <= t <= span[1]]

    def largest_gap_ms(self, span) -> float:
        """The longest time between two ticks in ``span``."""
        stamps = [t for t, _ in self.snaps if span[0] <= t <= span[1]]
        return max((b - a for a, b in zip(stamps, stamps[1:])), default=0.0) * 1e3


def metrics_checks(what, bundle, before, stats, card):
    """/metrics after a burst against the dispatcher's counts, and the
    device-memory gauges against the allocator."""
    import torch

    server = bundle.server
    port = server.metrics_port
    after = scrape_metrics(port)

    def delta(key):
        return after.get(key, 0.0) - before.get(key, 0.0)

    formed = sum(stats["formed"].values())
    counters = {"inference_completed_total": (delta("inference_completed_total"),
                                              stats["completed"]),
                "inference_batch_size_count": (delta("inference_batch_size_count"), formed),
                'requests_by_status_total{code="OK"}': (
                    delta('requests_by_status_total{code="OK"}'), len(stats["responses"]))}
    print(f"{what} /metrics deltas over the burst against the dispatcher's counts: "
          f"{json.dumps({k: list(v) for k, v in counters.items()})}")
    for key, (got, want) in counters.items():
        require(got == want, f"{what}: /metrics {key} rose by {got}, the dispatcher counted {want}")
    # device memory: the allocator's bytes in use, read with the server idle
    torch.cuda.synchronize()
    used = torch.cuda.memory_allocated(0)
    server.recorder.sample_process_stats()
    total = torch.cuda.mem_get_info(0)[1]
    mem = scrape_metrics(port)
    got_used = mem.get('gpu_memory_used_bytes{device="cuda:0"}')
    got_total = mem.get('gpu_memory_total_bytes{device="cuda:0"}')
    print(f"{what} /metrics device memory on {card}: gpu_memory_used_bytes {got_used} "
          f"(torch.cuda.memory_allocated {used}), gpu_memory_total_bytes {got_total} "
          f"(mem_get_info total {total}), gpu_device_count {mem.get('gpu_device_count')}")
    require(got_used == used, f"{what}: gpu_memory_used_bytes {got_used} != allocated {used}")
    require(got_total == total, f"{what}: gpu_memory_total_bytes {got_total} != {total}")


def congestion_checks(what, bundle, stats, ticks, card):
    """The monitor's ticks across a burst, and its gauges against its last
    snapshot (the monitor stopped first, so no tick falls between the two
    reads)."""
    server = bundle.server
    port = server.metrics_port
    mon = server.congestion
    interval_s = server.cfg.congestion.tick_interval_ms / 1000.0
    burst = ticks.within(stats["burst"])
    rose = len(burst)
    mon.stop()
    last = mon.snapshot()
    gauges = scrape_metrics(port)
    need = stats["wall_s"] / interval_s - 2
    print(f"{what} congestion on {card}: {rose} ticks across a {stats['wall_s']:.3f} s burst "
          f"(at least {need:.1f} required; tick {interval_s * 1e3:g} ms, the longest gap "
          f"between two {ticks.largest_gap_ms(stats['burst']):.1f} ms), congested in "
          f"{sum(s.congested for s in burst)} of {len(burst)}, entered "
          f"{sum(1 for a, b in zip(burst, burst[1:]) if b.congested and not a.congested)} "
          f"times; last snapshot tick {last.tick}: congested {last.congested}, score "
          f"{last.score:.3f}, lambda {last.ewma_lambda:.2f}/s, mu {last.ewma_mu:.2f}/s, rho "
          f"{last.ewma_rho:.3f}, fill {last.ewma_queue_fill}, p95 {last.p95_ms:.1f} ms, p99 "
          f"{last.p99_ms:.1f} ms; batches formed {json.dumps(stats['formed'])}")
    require(rose >= need, f"{what}: the congestion monitor ticked {rose} times in "
                          f"{stats['wall_s']:.3f} s")
    for key, field in CONGESTION_GAUGES.items():
        require(gauges.get(key) == field(last),
                f"{what}: /metrics {key} {gauges.get(key)} != the last snapshot's {field(last)}")
    return dict(ticks=rose, congested_ticks=sum(s.congested for s in burst),
                last=dataclasses.asdict(last))


def bert_path(counters, card):
    import numpy as np

    from starpu_inference_server_tpu_torch.utils.config import QuantMode, load_config

    cfg = load_config(str(BERT_CONFIG))
    rng = np.random.default_rng(31)
    samples = []
    for i in range(BERT_REQUESTS):
        ids = rng.integers(0, 30522, (1, 512)).astype(np.int64)
        mask = np.zeros((1, 512), np.int64)
        mask[0, :int(rng.integers(16, 513))] = 1  # varied padding
        samples.append({"input_ids": ids, "attention_mask": mask})
    bundle = LocalServer(cfg)
    bundle.target = bundle.start()
    try:
        per_forward = bert_model_phase(bundle.server.engine.model, bundle.server.engine.device,
                                       counters)
        before = scrape_metrics(bundle.server.metrics_port)
        ticks = TickLog(bundle.server.congestion)
        launches, main = batch_serving_phase("bert_long", bundle, samples, "last_hidden_state",
                                             BERT_TOL, counters, BERT_KERNELS, card, "seq")
        metrics_checks("bert_long", bundle, before, main, card)
        # the same config and burst with the congestion monitor off (the
        # adaptive strategy on raw fill ratios)
        off_cfg = dataclasses.replace(cfg, name="bert_long_congestion_off",
                                      congestion=dataclasses.replace(cfg.congestion,
                                                                     enabled=False))
        control = LocalServer(off_cfg)
        control.target = control.start()
        try:
            off = batch_serving_phase("bert_long congestion off", control, samples,
                                      "last_hidden_state", BERT_TOL, counters, BERT_KERNELS,
                                      card, "seq")[1]
            require(control.server.congestion.snapshot().tick == -1,
                    "bert_long congestion off: the monitor ticked")
        finally:
            control.stop()
        congestion = congestion_checks("bert_long", bundle, main, ticks, card)
    finally:
        bundle.stop()
    print(f"bert_long congestion on vs off on {card}: batches formed {json.dumps(main['formed'])} "
          f"vs {json.dumps(off['formed'])}; p50 {main['p50_ms']:.1f} vs {off['p50_ms']:.1f} ms, "
          f"p99 {main['p99_ms']:.1f} vs {off['p99_ms']:.1f} ms; {main['rate']:.1f} vs "
          f"{off['rate']:.1f} seq/s; congested ticks in the burst {congestion['congested_ticks']} "
          f"of {congestion['ticks']}")
    for quant, dtype, model_tol, serve_tol, elem_tol in BERT_CONTROLS:
        what = f"bert_long_{quant}_{dtype.lower()}"
        model = dataclasses.replace(cfg.model, quantization=QuantMode(quant), compute_dtype=dtype)
        control = LocalServer(dataclasses.replace(cfg, name=what, model=model))
        control.target = control.start()
        try:
            bert_model_phase(control.server.engine.model, control.server.engine.device,
                             counters, what, model_tol, timed=False)
            batch_serving_phase(what, control, samples, "last_hidden_state", serve_tol,
                                counters, BERT_KERNELS, card, "seq", elem_tol=elem_tol)
        finally:
            control.stop()
    return launches, per_forward


def control_call(target, method, req, resp_cls=None, service="inference.GRPCInferenceService"):
    """(status code name, details, response) of one unary call."""
    import grpc

    from starpu_inference_server_tpu_torch.grpc import kserve_v2_pb2 as pb

    resp_cls = resp_cls or getattr(pb, f"{method}Response")

    async def go():
        async with grpc.aio.insecure_channel(target) as channel:
            call = channel.unary_unary(f"/{service}/{method}",
                                       request_serializer=type(req).SerializeToString,
                                       response_deserializer=resp_cls.FromString)
            return await call(req, timeout=600)

    try:
        return "OK", "", asyncio.run(go())
    except grpc.aio.AioRpcError as err:
        return err.code().name, err.details(), None


def reflect_services(target) -> list:
    import grpc

    from starpu_inference_server_tpu_torch.grpc import reflection_v1alpha_pb2 as rpb

    async def go():
        async with grpc.aio.insecure_channel(target) as channel:
            call = channel.stream_stream(
                "/grpc.reflection.v1alpha.ServerReflection/ServerReflectionInfo",
                request_serializer=rpb.ServerReflectionRequest.SerializeToString,
                response_deserializer=rpb.ServerReflectionResponse.FromString)()
            await call.write(rpb.ServerReflectionRequest(list_services="*"))
            resp = await call.read()
            await call.done_writing()
            return [s.name for s in resp.list_services_response.service]

    return asyncio.run(go())


def _tensors(node):
    """Every tensor leaf of a parameter tree."""
    import torch

    if isinstance(node, dict):
        for value in node.values():
            yield from _tensors(value)
    elif isinstance(node, (list, tuple)):
        for value in node:
            yield from _tensors(value)
    elif isinstance(node, torch.Tensor):
        yield node


def control_plane_phase(bundle, samples, card):
    """The KServe-v2 control RPCs on the ResNet server, over the socket:
    ModelConfig, RepositoryIndex, the unload / load cycle (infers
    UNAVAILABLE between; the load a hot reload from the config's seed,
    its response bit-equal, every tensor of the old tree freed and the
    allocator's requested bytes back where they were), LogSettings,
    TraceSetting around 16 requests (one trace event a batch formed),
    reflection."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.grpc import kserve_v2_pb2 as pb
    from starpu_inference_server_tpu_torch.grpc.service import PLATFORM

    server, target = bundle.server, bundle.target
    cfg = server.cfg
    name = cfg.name
    code, _, resp = control_call(target, "ModelConfig", pb.ModelConfigRequest(name=name))
    want = [(s.name, list(s.dims)) for s in cfg.inputs + cfg.outputs]
    got = [(t.name, list(t.dims)) for t in (*resp.config.input, *resp.config.output)] \
        if resp is not None else None
    require(code == "OK" and resp.config.name == name and resp.config.platform == PLATFORM
            and resp.config.max_batch_size == cfg.max_batch_size and got == want,
            f"{name}: ModelConfig {code} {resp} does not equal the config")
    code, _, index = control_call(target, "RepositoryIndex", pb.RepositoryIndexRequest())
    require(code == "OK" and [(m.name, m.state) for m in index.models] == [(name, "READY")],
            f"{name}: RepositoryIndex {code} {index}")
    image = make_request(name, samples[0], "fixed")
    code, _, first = control_call(target, "ModelInfer", image)
    require(code == "OK", f"{name}: ModelInfer before the cycle {code}")
    code, _, _ = control_call(target, "RepositoryModelUnload",
                              pb.RepositoryModelUnloadRequest(model_name=name))
    unloaded = control_call(target, "ModelInfer", image)[0]
    ready = control_call(target, "ModelReady", pb.ModelReadyRequest(name=name))[2].ready
    require(code == "OK" and unloaded == "UNAVAILABLE" and not ready,
            f"{name}: unload {code}, then ModelInfer {unloaded}, ModelReady {ready}")
    # the old tree: a weak reference to each of its tensors, and the
    # allocator's requested bytes (memory_allocated counts whole cached
    # blocks, so it moves by a block's slack when a request of the new
    # tree lands in a larger cached block)
    old_leaves = [weakref.ref(t) for t in _tensors(server.engine.model.params)]
    tree_bytes = sum(t().numel() * t().element_size() for t in old_leaves)
    gc.collect()
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    req_before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    t0 = time.perf_counter()
    code, details, _ = control_call(target, "RepositoryModelLoad",
                                    pb.RepositoryModelLoadRequest(model_name=name))
    reload_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    req_after = torch.cuda.memory_stats()["requested_bytes.all.current"]
    alive = sum(ref() is not None for ref in old_leaves)
    code2, _, second = control_call(target, "ModelInfer", image)
    same = code2 == "OK" and list(second.raw_output_contents) == list(first.raw_output_contents)
    ready = control_call(target, "ModelReady", pb.ModelReadyRequest(name=name))[2].ready
    print(f"{name} repository cycle on {card}: unload -> ModelInfer {unloaded}, ModelReady false; "
          f"RepositoryModelLoad {code} (hot reload from seed {cfg.seed}) in {reload_s:.3f} s; "
          f"response for a fixed image bit-equal after the cycle: {same}; old tree "
          f"{len(old_leaves)} tensors, {tree_bytes} bytes, {alive} still alive; requested bytes "
          f"{req_before} -> {req_after} ({req_after - req_before:+d}); "
          f"torch.cuda.memory_allocated {mem_before} -> {mem_after} ({mem_after - mem_before:+d})")
    require(code == "OK" and ready, f"{name}: RepositoryModelLoad {code} {details}")
    require(same, f"{name}: the response after the reload differs")
    require(alive == 0, f"{name}: {alive} tensors of the old tree outlived the reload")
    require(abs(req_after - req_before) <= 1 << 20, f"{name}: the old tree was not freed")
    # LogSettings: a round trip at the current verbosity
    setting = pb.LogSettingsRequest.SettingValue(uint32_param=1)
    code, _, log = control_call(target, "LogSettings",
                                pb.LogSettingsRequest(settings={"verbosity": setting}))
    require(code == "OK" and log.settings["verbosity"].uint32_param == 1
            and log.settings["verbosity_name"].string_param == "INFO",
            f"{name}: LogSettings {code} {log}")
    # TraceSetting around 16 requests
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    dispatcher = server.runner.dispatcher
    with tempfile.TemporaryDirectory(dir=build) as trace_dir:
        value = pb.TraceSettingRequest.SettingValue
        on = pb.TraceSettingRequest(settings={"trace_enabled": value(value=["true"]),
                                              "trace_output": value(value=[trace_dir])})
        code_on = control_call(target, "TraceSetting", on)[0]
        before = sum(a["count"] for a in dispatcher.batch_stats.values())
        done = dispatcher.completed_jobs
        infer_all(target, [make_request(name, s, f"trace{i}") for i, s in enumerate(samples[:16])])
        require(dispatcher.wait_for_drain(done + 16, 30.0), f"{name}: traced requests not counted")
        formed = sum(a["count"] for a in dispatcher.batch_stats.values()) - before
        off = pb.TraceSettingRequest(settings={"trace_enabled": value(value=["false"])})
        code_off, _, resp = control_call(target, "TraceSetting", off)
        events = json.loads((Path(trace_dir) / "batching_trace.json").read_text())["traceEvents"]
    batches = sum(e["name"] == "batch" for e in events)
    enqueued = sum(e["name"] == "request_enqueued" for e in events)
    services = reflect_services(target)
    print(f"{name} TraceSetting on {card}: enable {code_on}, 16 requests, disable {code_off} "
          f"({list(resp.settings['trace_enabled'].value)}): {batches} batch events for {formed} "
          f"batches formed, {enqueued} request_enqueued events; LogSettings round trip OK; "
          f"reflection lists {services}")
    require(code_on == code_off == "OK", f"{name}: TraceSetting {code_on} / {code_off}")
    require(batches == formed and enqueued == 16, f"{name}: the trace holds {batches} batch "
                                                  f"events for {formed} batches formed")
    require("inference.GRPCInferenceService" in services, f"{name}: reflection lists {services}")
    return dict(reload_s=reload_s, reload_mem_delta=mem_after - mem_before)


def resnet_path(counters, card):
    import numpy as np

    from starpu_inference_server_tpu_torch.utils.config import load_config

    cfg = load_config(str(RESNET_CONFIG))
    options = dict(cfg.model.options, stem_fused=True)  # the K8 route, set in code
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, options=options))
    bundle = LocalServer(cfg)
    bundle.target = bundle.start()
    try:
        per_forward = resnet_model_phase(bundle.server.engine.model, options,
                                         bundle.server.engine.device, counters)
        rng = np.random.default_rng(32)
        samples = [{"input": rng.standard_normal((1, 3, 224, 224)).astype(np.float32)}
                   for _ in range(RESNET_IMAGES)]
        launches, on = batch_serving_phase("resnet18_int8", bundle, samples, "output",
                                           RESNET_SERVE_TOL, counters, RESNET_KERNELS, card,
                                           "img", check_argmax=True)
        # the cost of observability: the same burst on a server without
        # metrics and congestion monitor
        off_cfg = dataclasses.replace(cfg, name="resnet18_int8_observability_off",
                                      metrics_enabled=False,
                                      congestion=dataclasses.replace(cfg.congestion,
                                                                     enabled=False))
        quiet = LocalServer(off_cfg)
        quiet.target = quiet.start()
        try:
            off = batch_serving_phase("resnet18_int8 observability off", quiet, samples,
                                      "output", RESNET_SERVE_TOL, counters, RESNET_KERNELS,
                                      card, "img", check_argmax=True)[1]
        finally:
            quiet.stop()
        print(f"cost of observability, resnet18_int8 ({RESNET_IMAGES}-image burst) on {card}: "
              f"with the config's metrics and congestion monitor {on['rate']:.1f} img/s, p50 "
              f"{on['p50_ms']:.1f} ms; without {off['rate']:.1f} img/s, p50 "
              f"{off['p50_ms']:.1f} ms")
        control_plane_phase(bundle, samples, card)
    finally:
        bundle.stop()
    return launches, per_forward


# -- the decoder extras: W4A8, verify windows, the paged cache -------------------

EXTRA_KERNELS = ("int4_matmul_w4a8", "window_decode_attention", "paged_decode_attention",
                 "paged_window_decode_attention")
# model-level limits (mean relative error of logits), set from a first
# reading on the card with the headroom stated in PERF.md
# (first readings on one H100 80GB HBM3, 700 W, in parentheses). At BF16
# every route rounds to bf16 at its own places and the random-weight
# model amplifies that layer by layer, as for the int4 model (2.3e-2 on
# vs off): W4A8 kernels on vs off also requantizes activations (5.96e-2);
# a verify window runs its 80 rows through the dequantize-and-matmul
# route where a decode step of 16 rows takes int8_matmul (4.36e-2), and
# with kernels off its attention rounds probabilities to bf16 (5.10e-2);
# the paged steps differ from the dense ones only in the attention
# kernel (9.3e-3, 1.04e-2). The FP32 witness shows what is left where
# the routes agree: f32 sums in another order.
W4A8_TOL = 1e-1       # W4A8 llama-1b, kernels on vs off (1.7x the reading)
VERIFY_TOL = 1e-1     # verify_step vs W sequential decode_steps (2.3x)
VERIFY_KERNEL_TOL = 1e-1  # verify_step, kernels on vs off (2.0x)
PAGED_TOL = 3e-2      # paged_decode_step / paged_verify_step vs the dense steps (2.9x)
FP32_TOL = 1e-4       # the FP32 witness (read 2.4e-5, 0 and 1.5e-6: 4.2x the largest)
RIG_CYCLE = 8         # copy_model_cycle of the rigged runs
# the rig's greedy output is a permutation cycle of RIG_CYCLE tokens, so
# a rigged draft and an n-gram lookup both propose it exactly
RIG_ACCEPT_FLOOR = {"speculative": 0.9, "lookup": 0.9, "paged_lookup": 0.9}


def _copies(nbytes: float) -> int:
    """Copies of a call's inputs that, cycled, make the calls read 120 MB
    in turn, well past the H100's 50 MB L2: each call then reads its
    bytes from device memory, as the bound assumes."""
    return max(1, math.ceil(120e6 / nbytes))


def _time_cycled(fn, copies, iters: int = 20):
    """``time_ms`` of ``fn(i)`` with ``i`` cycling over the copies."""
    it = iter(range(10 ** 9))
    return time_ms(lambda: fn(next(it) % copies), iters=iters)


def _dense_shapes(spec) -> dict:
    """(K, N) of the decoder's dense layers: four a layer, then the lm_head."""
    hq, hkv, d = spec.q_heads, spec.kv_heads, spec.head_dim
    return {"qkv": (spec.hidden, (hq + 2 * hkv) * d), "o": (hq * d, spec.hidden),
            "gate_up": (spec.hidden, 2 * spec.intermediate),
            "down": (spec.intermediate, spec.hidden), "lm_head": (spec.hidden, spec.vocab)}


def _step_ms(spec, per_shape, m, key="ms") -> float:
    """A kernel's time in one decode step at ``m`` rows: every layer's
    four dense shapes, then the lm_head."""
    at = {r["layer"]: r[key] for r in per_shape if r["m"] == m}
    return spec.layers * sum(at[n] for n in ("qkv", "o", "gate_up", "down")) + at["lm_head"]


def k2_entry(g, dev, dtype, m, k, n, label, card) -> dict:
    """int8_matmul at [m, k] x [k, n], x in ``dtype`` as its caller passes
    it: held against its plain version (the products are exact, f32 sums
    in another order: 1e-4 max|ref|), bit-equal over two calls, and timed
    beside the plain version, the bf16 ``torch.matmul`` on the dequantized
    weight and the bound, kernel and library each on cycled copies of the
    weight (past the 50 MB L2)."""
    import torch

    from starpu_inference_server_tpu_torch.ops import matmul_kernels as mk

    x = torch.randn(m, k, device=dev, generator=g).to(dtype)
    copies = _copies(k * n)
    wqs = [torch.randint(-128, 128, (k, n), device=dev, generator=g, dtype=torch.int8)
           for _ in range(copies)]
    sc = torch.rand(1, n, device=dev, generator=g) * 0.01 + 1e-3
    got = mk.int8_matmul(x, wqs[0], sc)
    ref = mk.int8_matmul_plain(x, wqs[0], sc)
    err = max_err(got, ref)
    tol = 1e-4 * ref.abs().max().item()
    same = bool(torch.equal(got, mk.int8_matmul(x, wqs[0], sc)))
    plan = mk.matmul_plan("int8_matmul", m, n, k,
                          torch.cuda.get_device_properties(dev).multi_processor_count)
    shape = f"M={m} K={k} N={n}" + ("" if dtype == torch.bfloat16 else f" x {str(dtype)[6:]}")
    print(f"kernel int8_matmul {shape} ({label}): max_abs_err={err:.3e} tol={tol:.3e} "
          f"(1e-4 max|ref|); two calls bit-equal {same}; tile {mk.QMM_TILES[plan.variant]}, "
          f"{plan.splits} splits, {plan.grid} blocks")
    require(err <= tol, f"int8_matmul {label} M={m} disagrees with its plain version")
    require(same, f"int8_matmul {label} M={m} gave other bits on a second call")
    ms = _time_cycled(lambda i: mk.int8_matmul(x, wqs[i], sc), copies)
    plain_ms = time_ms(lambda: mk.int8_matmul_plain(x, wqs[0], sc), iters=5)
    xb = x.to(torch.bfloat16)
    w_deqs = [(wqs[i % copies].float() * sc).to(torch.bfloat16)
              for i in range(_copies(k * n * 2))]
    lib_ms = _time_cycled(lambda i: torch.matmul(xb, w_deqs[i]), len(w_deqs))
    b_ms, b_by = bound_ms(m * k * x.element_size() + k * n + n * 4 + m * n * 4, 2.0 * m * k * n)
    print(f"time int8_matmul {shape} ({label}) on {card}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.matmul bf16 {lib_ms:.4f} ms ({len(w_deqs)} dequantized "
          f"weights cycled), bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, shape=shape, splits=plan.splits, grid=plan.grid)


def int8_kernel_phase(spec, dev, card=""):
    """int8_matmul (K2) at the shapes its paths give it: every dense layer
    of an int8 decode step at 16 slots (llama_speculative.yml's and
    llama_prompt_lookup.yml's plain and draft decode) and 64
    (llama_paged.yml), and the ResNet-18 fc at batch 1, 8 and 32 (K = 512,
    N = 1000: the ragged N is masked in the kernel), each through
    ``k2_entry``. The row reports gate_up at 64 slots."""
    import torch

    g = torch.Generator(device=dev).manual_seed(4321)
    bf16 = torch.bfloat16
    cases = [(name, m, k, n) for m in (16, 64) for name, (k, n) in _dense_shapes(spec).items()]
    cases += [("fc", m, 512, 1000) for m in (1, 8, 32)]
    per_shape = [dict(layer=name, m=m, **k2_entry(g, dev, bf16, m, k, n, name, card))
                 for name, m, k, n in cases]
    row = next({k: v for k, v in e.items() if k not in ("layer", "m")} for e in per_shape
               if e["layer"] == "gate_up" and e["m"] == 64)
    steps = {m: (_step_ms(spec, per_shape, m), _step_ms(spec, per_shape, m, "library_ms"))
             for m in (16, 64)}
    for m, (k_ms, l_ms) in steps.items():
        print(f"int8_matmul per decode step ({spec.layers} layers x qkv, o, gate_up, down + "
              f"lm_head at M={m}): kernel {k_ms:.4f} ms, torch.matmul bf16 (cycled) {l_ms:.4f} ms")
    return {"int8_matmul": dict(row, per_shape=per_shape,
                                decode_step_ms={str(m): v[0] for m, v in steps.items()},
                                library="torch.matmul bf16 on the dequantized weight, cycled")}


def extras_kernel_phase(spec, dev, card=""):
    """K6, K9, K10 and K11 at the shapes their configs give them, held
    against their plain versions and timed beside the plain version, a
    library yardstick the port never calls and the bound."""
    import torch
    import torch.nn.functional as F

    from starpu_inference_server_tpu_torch.ops import decode_attention as da
    from starpu_inference_server_tpu_torch.ops import matmul_kernels as mk
    from starpu_inference_server_tpu_torch.ops.quant import pack_int4, unpack_int4

    g = torch.Generator(device=dev).manual_seed(4242)
    bf16 = torch.bfloat16
    hq, hkv, d, rep = spec.q_heads, spec.kv_heads, spec.head_dim, spec.rep
    rows = {}

    # int4_matmul_w4a8 at M = 16 (the decode step of llama_w4a8.yml), 64
    # and 128 (wider decode batches), 1 (the lm_head of a prefill) and 256
    # (a prefill chunk) over every dense shape. The integer product is
    # exact and the kernel scales it as the plain version does, so it must
    # equal the plain version bit for bit, and itself over two calls.
    # Library: torch._int_mm on the unpacked int8 weight where its shape
    # rules allow it (M > 16), else torch.matmul bf16 on a
    # pre-dequantized weight.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_shape = []
    for m in (16, 64, 128, 1, 256):
        for name, (k, n) in _dense_shapes(spec).items():
            x_q = torch.randint(-127, 128, (m, k), device=dev, generator=g, dtype=torch.int8)
            sx = torch.rand(m, 1, device=dev, generator=g) * 0.02 + 1e-3
            copies = max(1, math.ceil(120e6 / (k * n // 2)))
            w4s, scs = [], []
            for _ in range(copies):
                w4s.append(pack_int4(torch.randint(-8, 8, (k, n), device=dev, generator=g,
                                                   dtype=torch.int8)))
                scs.append(torch.rand(1, n, device=dev, generator=g) * 0.02 + 1e-3)
            got = mk.int4_matmul_w4a8(x_q, sx, w4s[0], scs[0])
            ref = mk.int4_matmul_w4a8_plain(x_q, sx, w4s[0], scs[0])
            err = max_err(got, ref)
            exact = bool(torch.equal(got, ref))
            twice = bool(torch.equal(got, mk.int4_matmul_w4a8(x_q, sx, w4s[0], scs[0])))
            plan = mk.matmul_plan("int4_matmul_w4a8", m, n, k, sms)
            shape = f"M={m} K={k} N={n}"
            print(f"kernel int4_matmul_w4a8 {shape} ({name}): max_abs_err={err:.3e}, bit-equal "
                  f"to the plain version {exact}, two calls bit-equal {twice}; tile "
                  f"{mk.QMM_TILES[plan.variant]}, {plan.splits} splits, {plan.grid} blocks")
            require(exact, f"int4_matmul_w4a8 {name} M={m} is not bit-equal to its plain version")
            require(twice, f"int4_matmul_w4a8 {name} M={m} gave other bits on a second call")
            ms = _time_cycled(lambda i: mk.int4_matmul_w4a8(x_q, sx, w4s[i], scs[0]), copies)
            plain_ms = time_ms(lambda: mk.int4_matmul_w4a8_plain(x_q, sx, w4s[0], scs[0]), iters=3)
            if m > 16:
                w8 = unpack_int4(w4s[0]).contiguous()
                lib_ms = time_ms(lambda: torch._int_mm(x_q, w8))
                library = "torch._int_mm on the unpacked int8 weight (no scales)"
            else:
                w8 = (unpack_int4(w4s[0]).float() * scs[0]).to(bf16)
                xb = (x_q.float() * sx).to(bf16)
                lib_ms = time_ms(lambda: torch.matmul(xb, w8))
                library = "torch.matmul bf16 on the pre-dequantized weight"
            b_ms, b_by = bound_ms(m * k + m * 4 + k * n // 2 + n * 4 + m * n * 4, 2.0 * m * k * n,
                                  PEAK_INT8)
            print(f"time int4_matmul_w4a8 {shape} ({name}) on {card}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, {library} {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms, shape=shape, library=library, splits=plan.splits,
                       grid=plan.grid)
            per_shape.append(dict(layer=name, m=m, **row))
            if name == "gate_up" and m == 16:
                rows["int4_matmul_w4a8"] = dict(row, per_shape=per_shape)
            del w4s, scs, w8
    rows["int4_matmul_w4a8"]["decode_step_ms"] = _step_ms(spec, per_shape, 16)
    print(f"int4_matmul_w4a8 per decode step ({spec.layers} layers + lm_head at M=16): kernel "
          f"{rows['int4_matmul_w4a8']['decode_step_ms']:.4f} ms")

    # window_decode_attention at the verify of llama_speculative.yml
    # (W = 5) and llama_prompt_lookup.yml (W = 9): S = 16, T = 1024, mixed
    # lengths including 0 and T - W, sharp logits as for decode_attention.
    # The row reports W = 5. Library: SDPA with a float mask on the
    # dequantized bf16 cache. The kernel, the plain version and SDPA are
    # each timed on cycled copies of their cache (``_copies``), so that
    # every call reads it from device memory.
    s_, t_ = 16, 1024
    per_shape = []
    for w in (5, 9):
        q = torch.randn(s_, w, hq, d, device=dev, generator=g).to(bf16)
        lens = torch.randint(0, t_ - w + 1, (s_,), device=dev, generator=g, dtype=torch.int32)
        lens[0], lens[1] = 0, t_ - w
        live = (lens.to(torch.int64) + w).sum().item()
        nbytes = 2 * s_ * w * hq * d * 2 + live * hkv * (2 * d + 8) + 4 * s_
        caches = []
        for _ in range(_copies(nbytes)):
            caches.append((
                torch.randint(-127, 128, (s_, t_, hkv, d), device=dev, generator=g,
                              dtype=torch.int8),
                torch.randint(-127, 128, (s_, t_, hkv, d), device=dev, generator=g,
                              dtype=torch.int8),
                torch.rand(s_, t_, hkv, device=dev, generator=g) * 0.03 + 0.05,
                torch.rand(s_, t_, hkv, device=dev, generator=g) / 127 + 1e-3))
        got = da.window_decode_attention(q, *caches[0], lens, rep)
        ref = da.window_decode_attention_plain(q, *caches[0], lens, rep)
        splits = da.decode_split_plan(s_, hkv, t_, w, rep, d).splits
        err = attn_check(f"window_decode_attention S={s_} T={t_} W={w} ({splits} splits)", got,
                         ref)
        require(torch.equal(got, da.window_decode_attention(q, *caches[0], lens, rep)),
                f"window_decode_attention W={w} gave other bits on a second call")
        ms = _time_cycled(lambda i: da.window_decode_attention(q, *caches[i], lens, rep),
                          len(caches))
        plain_ms = _time_cycled(
            lambda i: da.window_decode_attention_plain(q, *caches[i], lens, rep), len(caches),
            iters=3)
        last = lens.to(torch.int64)[:, None] + torch.arange(w, device=dev)[None, :]
        allowed = torch.arange(t_, device=dev)[None, None, :] <= last[:, :, None]
        mask = torch.zeros(allowed.shape, device=dev).masked_fill(~allowed, float("-inf"))
        mask = mask[:, None].to(bf16)
        qt = q.transpose(1, 2)
        deq = [((kc.float() * ks[..., None]).to(bf16).transpose(1, 2),
                (vc.float() * vs[..., None]).to(bf16).transpose(1, 2))
               for kc, vc, ks, vs in caches[:_copies(2 * s_ * t_ * hkv * d * 2)]]
        lib_ms = _time_cycled(lambda i: F.scaled_dot_product_attention(
            qt, *deq[i], attn_mask=mask, enable_gqa=True), len(deq))
        attended = (last + 1).sum().item()
        b_ms, b_by = bound_ms(nbytes, 4.0 * attended * hq * d)
        print(f"time window_decode_attention S={s_} W={w} ({splits} splits): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa (float mask) {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); two calls bit-equal; {len(caches)} cache copies cycled")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms, shape=f"S={s_} W={w} T={t_} live={live}", splits=splits,
                   library="scaled_dot_product_attention with a float mask",
                   copies=len(caches))
        per_shape.append(row)
        if w == 5:
            rows["window_decode_attention"] = dict(row, per_shape=per_shape)
        del caches, deq

    # paged_decode_attention and paged_window_decode_attention at
    # llama_paged.yml: S = 64 slots, pages of 256 rows, a pool of 129
    # pages (page 0 the garbage page), max_pages 4, a shuffled table.
    # Lengths are mixed (0, a window across a page, up to two pages per
    # slot so all 64 fit the pool); table entries past a slot's pages
    # point at page 0, whose scales are NaN here: a read past a length
    # would show. W = 5 is the verify window of speculate_k 4. No one
    # PyTorch call reads a page table: the library time is the sequence
    # gather + dequantize + SDPA. Every call is timed on cycled copies of
    # the pools, as for window_decode_attention.
    s_, page, n_pages, mp = 64, 256, 129, 4

    def pool():
        kp = torch.randint(-127, 128, (n_pages, page, hkv, d), device=dev, generator=g,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, (n_pages, page, hkv, d), device=dev, generator=g,
                           dtype=torch.int8)
        ksp = torch.rand(n_pages, page, hkv, device=dev, generator=g) * 0.03 + 0.05
        vsp = torch.rand(n_pages, page, hkv, device=dev, generator=g) / 127 + 1e-3
        ksp[0], vsp[0] = float("nan"), float("nan")
        return kp, vp, ksp, vsp

    pools = [pool()]
    for w, name in ((1, "paged_decode_attention"), (5, "paged_window_decode_attention")):
        lens = torch.randint(0, 2 * page - w + 1, (s_,), device=dev, generator=g,
                             dtype=torch.int32)
        lens[0], lens[1], lens[2] = 0, page - 2, 2 * page - w
        perm = (torch.randperm(n_pages - 1, device=dev, generator=g) + 1).tolist()
        table = torch.zeros(s_, mp, dtype=torch.int32)
        for i, length in enumerate(lens.tolist()):
            live_pages = (length + w - 1) // page + 1
            table[i, :live_pages] = torch.tensor([perm.pop() for _ in range(live_pages)])
        table = table.to(dev)
        crossing = int(((lens.to(torch.int64) + w - 1) // page != lens.to(torch.int64) // page).sum())
        q = torch.randn(s_, w, hq, d, device=dev, generator=g).to(bf16)
        if w == 1:
            q = q[:, 0]
            fn, plain = da.paged_decode_attention, da.paged_decode_attention_plain
        else:
            fn, plain = da.paged_window_decode_attention, da.paged_window_decode_attention_plain
        live = (lens.to(torch.int64) + w).sum().item()
        nbytes = 2 * s_ * w * hq * d * 2 + live * hkv * (2 * d + 8) + 4 * s_ * (mp + 1)
        while len(pools) < _copies(nbytes):
            pools.append(pool())
        kp, vp, ksp, vsp = pools[0]
        got = fn(q, kp, vp, ksp, vsp, table, lens, rep)
        require(bool(torch.isfinite(got.float()).all()),
                f"{name} read the garbage page (non-finite output)")
        require(torch.equal(got, fn(q, kp, vp, ksp, vsp, table, lens, rep)),
                f"{name} gave other bits on a second call")
        splits = da.decode_split_plan(s_, hkv, mp * page, w, rep, d).splits
        # the plain version gathers page 0 and masks it: finite scales there
        refs = []
        for kp, vp, ksp, vsp in pools:
            ks_ref, vs_ref = ksp.clone(), vsp.clone()
            ks_ref[0], vs_ref[0] = 1.0, 1.0
            refs.append((kp, vp, ks_ref, vs_ref))
        ref = plain(q, *refs[0], table, lens, rep)
        err = attn_check(f"{name} S={s_} page={page} W={w} ({crossing} windows cross a page, "
                         f"{splits} splits)", got, ref)
        ms = _time_cycled(lambda i: fn(q, *pools[i], table, lens, rep), len(pools))
        plain_ms = _time_cycled(lambda i: plain(q, *refs[i], table, lens, rep), len(pools),
                                iters=3)
        last = lens.to(torch.int64)[:, None] + torch.arange(w, device=dev)[None, :]
        allowed = torch.arange(mp * page, device=dev)[None, None, :] <= last[:, :, None]
        mask = torch.zeros(allowed.shape, device=dev).masked_fill(~allowed, float("-inf"))
        mask = mask[:, None].to(bf16)
        q4 = q.reshape(s_, w, hq, d).transpose(1, 2)
        tl = table.to(torch.int64)

        def sequence(i):
            kp, vp, ks_ref, vs_ref = refs[i]
            kd = (kp[tl].float() * ks_ref[tl][..., None]).to(bf16).reshape(s_, mp * page, hkv, d)
            vd = (vp[tl].float() * vs_ref[tl][..., None]).to(bf16).reshape(s_, mp * page, hkv, d)
            return F.scaled_dot_product_attention(q4, kd.transpose(1, 2), vd.transpose(1, 2),
                                                  attn_mask=mask, enable_gqa=True)

        lib_ms = _time_cycled(sequence, len(refs))
        attended = (last + 1).sum().item()
        b_ms, b_by = bound_ms(nbytes, 4.0 * attended * hq * d)
        print(f"time {name} S={s_} W={w}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"gather + dequantize + sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"two calls bit-equal; {len(pools)} pool copies cycled")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=lib_ms, splits=splits,
                          shape=f"S={s_} W={w} page={page} pool={n_pages} live={live}",
                          library="no one call; sequence gather + dequantize + "
                                  "scaled_dot_product_attention", copies=len(pools))
        del refs
    del pools
    return rows


def _cfg_with(cfg, **options):
    """``cfg`` with model options replaced (None drops a key)."""
    opts = dict(cfg.model.options)
    for key, value in options.items():
        if value is None:
            opts.pop(key, None)
        else:
            opts[key] = value
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, options=opts))


def _rigged(cfg):
    """The copy_model_cycle rig set in code on target and draft."""
    extra = {"copy_model_cycle": RIG_CYCLE}
    if cfg.model.options.get("draft_variant"):
        extra["draft_options"] = dict(cfg.model.options.get("draft_options", {}),
                                      copy_model_cycle=RIG_CYCLE)
    return _cfg_with(cfg, **extra)


def _plain_cfg(cfg):
    """The same config without speculation (the reference engine)."""
    return _cfg_with(cfg, draft_variant=None, draft_options=None, draft_params=None,
                     prompt_lookup_ngram=None)


def generate_all(engine, prompts, new, counters, kernels, what, card, absent=(),
                 dense_prefills=False, decode_kernel=None):
    """Serve ``prompts`` concurrently through ``engine`` (counters zeroed
    just before, read just after); every kernel of ``kernels`` must have
    launched and none of ``absent``; with ``dense_prefills``, every
    prefill and chunk through its kernel (``require_prefill_launches``);
    with ``decode_kernel``, the greedy engine's every block a graph replay
    and that kernel launched once a layer a decode step
    (``require_decode_launches``). Returns (token lists, launches)."""
    import torch

    from starpu_inference_server_tpu_torch.serving.generation import GenerationRequest

    torch.cuda.synchronize()
    zero_counts(counters)
    marks = _decode_marks(engine)
    t0 = time.perf_counter()
    reqs = [GenerationRequest(prompt_ids=p, max_new_tokens=new) for p in prompts]
    for r in reqs:  # all queued before the loop starts: one admission order
        engine.submit(r)
    engine.start()
    try:
        outs = [r.result(timeout=900) for r in reqs]
        wall = time.perf_counter() - t0
    finally:
        engine.stop()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    vocab = engine.spec.vocab
    for i, out in enumerate(outs):
        require(len(out) == new, f"{what}: request {i} returned {len(out)} tokens")
        require(all(0 <= t < vocab for t in out), f"{what}: request {i} out of vocab")
    for name in kernels:
        require(launches[name] > 0, f"kernel {name} was not launched on the {what} path")
    for name in absent:
        require(launches[name] == 0, f"kernel {name} was launched on the {what} path")
    if dense_prefills:
        require_prefill_launches(engine, prompts, launches, what)
    if decode_kernel is not None:
        require_decode_launches(engine, launches, decode_kernel, marks, what)
    step_s = engine.loop_timers["step"]
    extra = ""
    if engine.draft_spec is not None or engine.headroom():
        extra += (f", acceptance {engine.draft_acceptance_rate():.3f} "
                  f"({engine.accepted_drafts}/{engine.drafted_tokens} drafts)")
    if engine.prefix_cache:
        extra += f", prefix hits {engine.prefix_hits} ({engine.prefix_tokens_reused} tokens reused)"
    print(f"serving {what} on {card}: {len(prompts)} greedy requests, {new} new tokens each, "
          f"{wall:.2f} s wall, {engine.steps} decode steps or verify windows at pipeline depth "
          f"{engine.pipeline_depth}, {step_s:.2f} s host clock in them = "
          f"{len(prompts) * (new - 1) / max(step_s, 1e-9):.1f} tok/s (end to end "
          f"{len(prompts) * new / wall:.1f} tok/s){extra}; loop_timers {_timers(engine)}")
    print(f"serving {what} launches: {json.dumps({k: v for k, v in launches.items() if v})}")
    return outs, launches


def w4a8_path(int4_params, counters, card, dev):
    """llama_w4a8.yml on the int4 tree of llama_decoder.yml (same family,
    weight bits and seed, checked): the model kernels on vs off, launches per decode step,
    and 16 greedy requests (40, 200 and 600 tokens, the last chunked).
    Built after the int4 decoder path, whose W8A8 flag was off; this
    engine turns it on, and int4_matmul must not run."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.models.registry import QUANT_BITS
    from starpu_inference_server_tpu_torch.ops import nn
    from starpu_inference_server_tpu_torch.serving.generation import build_generation_engine
    from starpu_inference_server_tpu_torch.utils.config import load_config

    cfg = load_config(str(W4A8_CONFIG))
    int4_cfg = load_config(str(CONFIG))
    require(len({(c.model.family, QUANT_BITS[c.model.quantization], c.seed)
                 for c in (cfg, int4_cfg)}) == 1,
            "llama_w4a8.yml and llama_decoder.yml no longer share one int4 tree")
    engine = build_generation_engine(cfg, device=dev, params=int4_params)
    require(nn._W8A8, "the W4A8 engine did not turn the W8A8 flag on")
    per_step = model_phase(engine, dev, counters, "w4a8", W4A8_TOL)
    require(per_step["int4_matmul_w4a8"] == 65 and per_step["int4_matmul"] == 0,
            f"a W4A8 decode step ran int4_matmul_w4a8 {per_step['int4_matmul_w4a8']} and "
            f"int4_matmul {per_step['int4_matmul']} times (want 65 and 0)")
    rng = np.random.default_rng(12)
    lens = [40, 200, 600] + [64] * (engine.num_slots - 3)
    prompts = [rng.integers(0, engine.spec.vocab, n).astype(np.int32) for n in lens]
    _, launches = generate_all(engine, prompts, 24, counters,
                               ("int4_matmul_w4a8", "decode_attention", "causal_attention",
                                "chunk_prefill_attention"), "llama_w4a8", card,
                               absent=("int4_matmul",), dense_prefills=True,
                               decode_kernel="decode_attention")
    del engine
    torch.cuda.empty_cache()
    return launches, per_step


def _dequantized(tree):
    """``tree`` with every quantized weight (int8, or packed int4)
    dequantized to f32."""
    from starpu_inference_server_tpu_torch.ops import nn
    from starpu_inference_server_tpu_torch.ops.quant import is_packed_int4_leaf, is_quantized_leaf

    if is_quantized_leaf(tree) or is_packed_int4_leaf(tree):
        import torch

        return nn.resolve_weight(tree, torch.float32)
    if isinstance(tree, dict):
        return {k: _dequantized(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_dequantized(v) for v in tree]
    return tree


def window_model_phase(params, spec, counters, dev):
    """llama-1b int8 at full depth on the card: a verify window against W
    sequential decode steps on the same dense cache, and the paged decode
    and verify steps against the dense steps on the same contents (a
    shuffled table of 256-row pages); launches per step and per verify."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.models import paged_decoder as pd
    from starpu_inference_server_tpu_torch.models.decoder import (
        decode_step, init_cache, prefill, verify_step,
    )
    from starpu_inference_server_tpu_torch.ops import nn

    dtype = torch.bfloat16
    s_, t_, w, page = 16, 1024, 5, 256
    rng = np.random.default_rng(14)
    lens = [300, 255, 100, 45]  # slot 1's window crosses into its second page
    dense = init_cache(spec, s_, t_, device=dev)
    for slot, n in enumerate(lens):
        prompt = np.zeros((512,), np.int32)
        prompt[:n] = rng.integers(0, spec.vocab, n)
        prefill(spec, params, dense, torch.as_tensor(prompt, device=dev), n, slot, dtype)

    def dense_copy():
        copy = init_cache(spec, s_, t_, device=dev)
        for a, b in zip((dense.k, dense.v, dense.k_scale, dense.v_scale),
                        (copy.k, copy.v, copy.k_scale, copy.v_scale)):
            for x, y in zip(a, b):
                y.copy_(x)
        copy.lengths.copy_(dense.lengths)
        return copy

    # the same contents in a paged cache: each live slot's rows scattered
    # into two pool pages of a shuffled table
    perm = list(rng.permutation(np.arange(1, 129)))
    rows = [[int(perm.pop()), int(perm.pop()), 0, 0] for _ in lens]

    def paged_copy():
        paged = pd.init_paged_cache(spec, s_, t_, num_pages=129, page_size=page, device=dev)
        for slot, row in enumerate(rows):
            pd.set_table_row(paged, slot, row)
            for j, pid in enumerate(row[:2]):
                for a, b in zip((dense.k, dense.v, dense.k_scale, dense.v_scale),
                                (paged.k, paged.v, paged.k_scale, paged.v_scale)):
                    for x, y in zip(a, b):
                        y[pid] = x[slot, j * page:(j + 1) * page]
        paged.lengths.copy_(dense.lengths)
        return paged

    paged = paged_copy()
    verify_cache, verify_plain = dense_copy(), dense_copy()
    window = torch.as_tensor(rng.integers(0, spec.vocab, (s_, w)).astype(np.int32), device=dev)
    active = torch.zeros(s_, dtype=torch.bool, device=dev)
    active[:len(lens)] = True
    live = slice(0, len(lens))

    def counted(fn, *args, dtype=dtype):
        torch.cuda.synchronize()
        zero_counts(counters)
        out = fn(spec, params, *args, dtype)[1]
        torch.cuda.synchronize()
        return out.float(), read_counts(counters)

    ver, per_verify = counted(verify_step, verify_cache, window, active)
    nn.set_use_kernels(False)
    try:
        ver_plain, _ = counted(verify_step, verify_plain, window, active)
    finally:
        nn.set_use_kernels(None)
    seq = []
    for j in range(w):
        out, per_step = counted(decode_step, dense, window[:, j], active)
        seq.append(out)
    seq = torch.stack(seq, dim=1)
    pdec, per_paged_step = counted(pd.paged_decode_step, paged, window[:, 0], active)
    pver, per_paged_verify = counted(pd.paged_verify_step, paged, window[:, 1:], active)
    for what, got in (("verify", ver), ("paged decode", pdec), ("paged verify", pver)):
        require(bool(torch.isfinite(got).all()), f"{what} logits are not finite")
    # FP32 witness: the same steps at FP32 compute on the weights
    # dequantized to f32 (int8_matmul would round activations to bf16,
    # and a sub-ulp attention difference would then flip roundings), so
    # the kernel and plain attention and the dense and paged caches
    # differ only in the order of f32 sums
    f32 = torch.float32
    dense_params = _dequantized(params)

    def counted32(fn, *args):
        return fn(spec, dense_params, *args, f32)[1].float()

    nn.set_use_kernels(False)
    try:
        ver32_plain = counted32(verify_step, dense_copy(), window, active)
    finally:
        nn.set_use_kernels(None)
    ver32 = counted32(verify_step, dense_copy(), window, active)
    pver32 = counted32(pd.paged_verify_step, paged_copy(), window, active)
    dec32 = counted32(decode_step, dense_copy(), window[:, 0], active)
    pdec32 = counted32(pd.paged_decode_step, paged_copy(), window[:, 0], active)
    del dense_params
    fp32 = {"verify kernels on vs off": rel_err(ver32[live], ver32_plain[live]),
            "paged verify vs verify": rel_err(pver32[live], ver32[live]),
            "paged decode vs decode": rel_err(pdec32[live], dec32[live])}
    print(f"model llama-1b int8 at FP32 compute (witness): "
          + ", ".join(f"{k} {v:.3e}" for k, v in fp32.items()) + f" (tol {FP32_TOL})")
    require(max(fp32.values()) <= FP32_TOL, "the FP32 witness of the verify and paged steps")
    rel_v = rel_err(ver[live], seq[live])
    rel_k = rel_err(ver[live], ver_plain[live])
    rel_pd = rel_err(pdec[live], seq[live, 0])
    rel_pv = rel_err(pver[live], seq[live, 1:])
    agree_v = (ver[live].argmax(-1) == seq[live].argmax(-1)).float().mean().item()
    print(f"model llama-1b int8 {spec.layers} layers, 16 slots ({len(lens)} live, lengths {lens}):"
          f" verify_step W={w} vs {w} sequential decode_steps: mean rel err {rel_v:.3e} (tol "
          f"{VERIFY_TOL}), argmax agreement {agree_v:.2f}; verify_step kernels on vs off "
          f"{rel_k:.3e} (tol {VERIFY_KERNEL_TOL}); on the same contents, paged_decode_step vs "
          f"decode_step {rel_pd:.3e}, paged_verify_step vs decode_steps {rel_pv:.3e} (tol "
          f"{PAGED_TOL})")
    print(f"launches in one verify: {json.dumps({k: v for k, v in per_verify.items() if v})}; "
          f"one decode step: {json.dumps({k: v for k, v in per_step.items() if v})}; one paged "
          f"decode step: {json.dumps({k: v for k, v in per_paged_step.items() if v})}; one paged "
          f"verify: {json.dumps({k: v for k, v in per_paged_verify.items() if v})}")
    require(rel_v <= VERIFY_TOL, "verify_step disagrees with sequential decode_steps")
    require(rel_k <= VERIFY_KERNEL_TOL, "verify_step with kernels on and off disagree")
    require(max(rel_pd, rel_pv) <= PAGED_TOL, "the paged steps disagree with the dense steps")
    layers = spec.layers
    require(per_verify["window_decode_attention"] == layers,
            f"window_decode_attention ran {per_verify['window_decode_attention']} times per verify")
    require(per_step["decode_attention"] == layers, "decode_attention count per step")
    require(per_paged_step["paged_decode_attention"] == layers,
            f"paged_decode_attention ran {per_paged_step['paged_decode_attention']} times per step")
    require(per_paged_verify["paged_window_decode_attention"] == layers,
            "paged_window_decode_attention count per verify")
    require(per_step["int8_matmul"] == 4 * layers + 1,
            f"int8_matmul ran {per_step['int8_matmul']} times in an int8 decode step (want "
            f"{4 * layers + 1}: four dense layers a layer and the lm_head)")
    return {"int8_matmul": per_step["int8_matmul"],
            "window_decode_attention": per_verify["window_decode_attention"],
            "paged_decode_attention": per_paged_step["paged_decode_attention"],
            "paged_window_decode_attention": per_paged_verify["paged_window_decode_attention"]}


def speculation_path(spec, params, rigged_params, counters, card, dev):
    """llama_speculative.yml and llama_prompt_lookup.yml, each twice: on
    the config's random weights (acceptance near 0; streams vs a plain
    engine of the same weights counted and printed), and rigged with
    copy_model_cycle (acceptance above a floor; every stream equal to
    the plain engine's). Returns the random-weight speculative run's
    launches and the rigged plain streams with their prompts."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.serving.generation import build_generation_engine
    from starpu_inference_server_tpu_torch.utils.config import load_config

    rng = np.random.default_rng(15)
    vocab = spec.vocab
    lens = [40, 200] + [64] * 14
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    rig_prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    spec_cfg = load_config(str(SPEC_CONFIG))
    lookup_cfg = load_config(str(LOOKUP_CONFIG))
    results = {}
    plain_runs = {}  # greedy streams do not depend on steps_per_sync: one per tree
    for what, cfg, tree, prm, new in (
        ("speculative", spec_cfg, params, prompts, 32),
        ("lookup", lookup_cfg, params, prompts, 32),
        ("speculative_rigged", _rigged(spec_cfg), rigged_params, rig_prompts, 48),
        ("lookup_rigged", _rigged(lookup_cfg), rigged_params, rig_prompts, 48),
    ):
        if id(tree) not in plain_runs:
            plain = build_generation_engine(_plain_cfg(cfg), device=dev, params=tree)
            plain_runs[id(tree)], _ = generate_all(
                plain, prm, new, counters, ("int8_matmul", "decode_attention"),
                f"{what} (plain reference)", card, decode_kernel="decode_attention")
            del plain
        want = plain_runs[id(tree)]
        engine = build_generation_engine(cfg, device=dev, params=tree)
        kernels = ("window_decode_attention", "int8_matmul", "causal_attention")
        if engine.draft_spec is not None:
            kernels += ("decode_attention",)
        got, launches = generate_all(engine, prm, new, counters, kernels, what, card)
        same = sum(a == b for a, b in zip(got, want))
        rate = engine.draft_acceptance_rate()
        print(f"{what}: {same} of {len(prm)} streams identical to the plain engine; "
              f"acceptance {rate:.3f}")
        if what.endswith("rigged"):
            floor = RIG_ACCEPT_FLOOR[what.split("_")[0]]
            require(same == len(prm), f"{what}: a stream differs from the plain engine's")
            require(rate >= floor, f"{what}: acceptance {rate:.3f} under the floor {floor}")
        results[what] = dict(launches=launches, identical=same, acceptance=rate,
                             blocks=engine.steps, want=want)
        del engine
        torch.cuda.empty_cache()
    return results, rig_prompts


def generation_metrics_checks(recorder, engine, outs, requests) -> None:
    """The engine's Prometheus families against its own counts."""
    served = sum(len(o) for o in outs)
    want = {"generation_tokens_total": served,
            "generation_prefix_cache_hits_total": engine.prefix_hits,
            "generation_prefix_tokens_reused_total": engine.prefix_tokens_reused,
            "generation_time_to_first_token_ms_count": requests}
    got = {k: recorder.registry.get_sample_value(k) for k in want}
    print(f"llama_paged generation metrics against the engine's counts: "
          f"{json.dumps({k: [got[k], want[k]] for k in got})}; generation_active_slots "
          f"{recorder.registry.get_sample_value('generation_active_slots')}")
    for key in got:
        require(got[key] == want[key], f"llama_paged: {key} {got[key]} != {want[key]}")
    require(engine.generated_tokens == served, "llama_paged: the engine's token count differs")


def paged_path(spec, params, rigged_params, rig_prompts, rig_want, counters, card, dev):
    """llama_paged.yml: 64 concurrent requests, a third sharing a
    300-token prefix, against a dense engine of the same weights (the
    dense prefix cache); then the same config with prompt_lookup_ngram
    set in code, rigged, against the plain rigged streams."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.monitoring.metrics import MetricsRecorder
    from starpu_inference_server_tpu_torch.serving.generation import build_generation_engine
    from starpu_inference_server_tpu_torch.utils.config import load_config

    cfg = load_config(str(PAGED_CONFIG))
    rng = np.random.default_rng(16)
    vocab = spec.vocab
    prefix = rng.integers(0, vocab, 300).astype(np.int32)
    prompts = []
    for i in range(64):
        if i % 3 == 0:
            prompts.append(np.concatenate([prefix, rng.integers(0, vocab, 20).astype(np.int32)]))
        else:
            prompts.append(rng.integers(0, vocab, int(rng.integers(40, 200))).astype(np.int32))
    recorder = MetricsRecorder(port=None, model_name=cfg.name)
    engine = build_generation_engine(cfg, device=dev, params=params, metrics=recorder)
    got, launches = generate_all(engine, prompts, 16, counters,
                                 ("paged_decode_attention", "int8_matmul"), "llama_paged", card,
                                 decode_kernel="paged_decode_attention")
    paged_got = got
    generation_metrics_checks(recorder, engine, got, len(prompts))
    with_s = engine.loop_timers["step"]
    acct = engine.page_accounting()
    refs = int((engine._page_refs > 0).sum())
    print(f"llama_paged pages after the burst: {json.dumps(acct)}; pages with a reference "
          f"{refs}; prefix hits {engine.prefix_hits}, {engine.prefix_tokens_reused} tokens reused")
    require(engine.prefix_hits > 0, "llama_paged: no prefix hit")
    require(acct["live"] == 0 and acct["free"] + acct["retained"] + acct["garbage"] == acct["pool"]
            and refs == acct["retained"], "llama_paged: pages leaked")
    paged_stats = dict(prefix_hits=engine.prefix_hits, reused=engine.prefix_tokens_reused,
                       pages=acct)
    del engine
    # the cost of the recorder: the same burst without it, every stream equal
    engine = build_generation_engine(cfg, device=dev, params=params)
    what = "llama_paged without metrics"
    again, _ = generate_all(engine, prompts, 16, counters,
                            ("paged_decode_attention", "int8_matmul"), what, card,
                            decode_kernel="paged_decode_attention")
    require(again == paged_got, f"{what}: a stream differs from the first run's")
    without_s = engine.loop_timers["step"]
    del engine
    print(f"cost of observability, llama_paged decode (64 requests, 16 tokens; loop_timers "
          f"step, host seconds in decode blocks) on {card}: with the recorder {with_s:.3f} s, "
          f"without {without_s:.3f} s")
    paged_stats["decode_s_with_recorder"] = with_s
    paged_stats["decode_s_without"] = without_s
    dense = build_generation_engine(_cfg_with(cfg, kv_page_size=None, kv_pool_pages=None),
                                    device=dev, params=params)
    want, _ = generate_all(dense, prompts, 16, counters, ("decode_attention",),
                           "llama_paged as a dense engine (reference)", card,
                           decode_kernel="decode_attention")
    same = sum(a == b for a, b in zip(got, want))
    print(f"llama_paged: {same} of {len(prompts)} streams identical to the dense engine "
          f"(dense prefix hits {dense.prefix_hits})")
    paged_stats["identical_to_dense"] = same
    del dense
    torch.cuda.empty_cache()
    rig_cfg = _rigged(_cfg_with(cfg, prompt_lookup_ngram=2))
    engine = build_generation_engine(rig_cfg, device=dev, params=rigged_params)
    got, lookup_launches = generate_all(engine, rig_prompts, 48, counters,
                                        ("paged_window_decode_attention", "int8_matmul"),
                                        "llama_paged + prompt lookup (rigged)", card)
    rate = engine.draft_acceptance_rate()
    same = sum(a == b for a, b in zip(got, rig_want))
    floor = RIG_ACCEPT_FLOOR["paged_lookup"]
    print(f"llama_paged + prompt lookup (rigged): {same} of {len(got)} streams identical to "
          f"the plain rigged engine; acceptance {rate:.3f} (floor {floor})")
    require(same == len(got), "paged + lookup (rigged): a stream differs from the plain engine's")
    require(rate >= floor, f"paged + lookup (rigged): acceptance {rate:.3f} under {floor}")
    paged_stats["lookup_rigged_acceptance"] = rate
    del engine
    torch.cuda.empty_cache()
    return launches, lookup_launches, paged_stats, (prompts, paged_got)


def extras_path(spec, int4_params, counters, card, dev):
    """The model and serving phases of the third group: the W4A8 path;
    one int8 tree (and its rigged twin) for the speculative, lookup and
    paged configs, which share family, bits and seed."""
    from concurrent.futures import ThreadPoolExecutor

    from starpu_inference_server_tpu_torch.models.registry import build_model
    from starpu_inference_server_tpu_torch.utils.config import load_config

    w4a8_launches, w4a8_step = w4a8_path(int4_params, counters, card, dev)
    cfgs = [load_config(str(p)) for p in (SPEC_CONFIG, LOOKUP_CONFIG, PAGED_CONFIG)]
    require(len({(c.model.family, c.model.quantization, c.seed) for c in cfgs}) == 1,
            "the int8 configs no longer share one tree")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # numpy draws both without the interpreter lock
        trees = [pool.submit(lambda c: build_model(c.model, seed=c.seed, device=dev).params, c)
                 for c in (cfgs[0], _rigged(cfgs[0]))]
        params, rigged = (t.result() for t in trees)
    print(f"int8 llama-1b trees (random and rigged, side by side) built in "
          f"{time.perf_counter() - t0:.1f} s")
    per_step = window_model_phase(params, spec, counters, dev)
    spec_results, rig_prompts = speculation_path(spec, params, rigged, counters, card, dev)
    paged_launches, lookup_launches, paged_stats, paged_streams = paged_path(
        spec, params, rigged, rig_prompts, spec_results["lookup_rigged"]["want"], counters, card,
        dev)
    launches = {
        "int8_matmul": paged_launches["int8_matmul"],
        "int4_matmul_w4a8": w4a8_launches["int4_matmul_w4a8"],
        "window_decode_attention": spec_results["speculative"]["launches"][
            "window_decode_attention"],
        "paged_decode_attention": paged_launches["paged_decode_attention"],
        "paged_window_decode_attention": lookup_launches["paged_window_decode_attention"],
    }
    per_step["int4_matmul_w4a8"] = w4a8_step["int4_matmul_w4a8"]
    summary = {k: {kk: vv for kk, vv in v.items() if kk not in ("want", "launches")}
               for k, v in spec_results.items()}
    summary["paged"] = paged_stats
    print(f"extras summary: {json.dumps(summary)}")
    # what the flat group is held against
    ctx = dict(params=params, rigged=rigged, rig_prompts=rig_prompts,
               lookup_rigged_want=spec_results["lookup_rigged"]["want"],
               paged_streams=paged_streams, paged_stats=paged_stats)
    return launches, per_step, ctx

# -- the flat layout and overlapped dispatch -------------------------------------

FLAT_KERNELS = ("flat_decode_attention", "flat_window_decode_attention",
                "flat_paged_decode_attention", "flat_paged_window_decode_attention")
# the eight kernels on csrc/decode_mma.cuh
DECODE_SIDE = ("decode_attention", "window_decode_attention", "paged_decode_attention",
               "paged_window_decode_attention") + FLAT_KERNELS


def _flat_of(k, v, ks, vs):
    """The same logical cache or pool in the FLAT layout: the K/V bytes as
    they are (a view), the scales transposed (a copy)."""
    return (k.flatten(-2), v.flatten(-2), ks.transpose(-1, -2).contiguous(),
            vs.transpose(-1, -2).contiguous())


def _flat_row(name, q, std, tail, nbytes, flops, library, lib_fn, shape, garbage_page=False):
    """One K12 kernel on the flat form of the standard caches ``std``
    (cycled copies): bit-equal to its standard twin on the same logical
    cache, held against its plain version, then timed beside the twin (in
    this call), its plain version and the twin's library yardstick."""
    import torch

    from starpu_inference_server_tpu_torch.ops import decode_attention as da

    twin_name = name[len("flat_"):]
    fn, twin, plain = getattr(da, name), getattr(da, twin_name), getattr(da, name + "_plain")
    flat = [_flat_of(*c) for c in std]
    got = fn(q, *flat[0], *tail)
    want = twin(q, *std[0], *tail)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"{name} is not bit-equal to {twin_name} on the same cache")
    require(torch.equal(got, fn(q, *flat[0], *tail)), f"{name} gave other bits on a second call")
    refs = flat
    if garbage_page:
        require(bool(torch.isfinite(got.float()).all()),
                f"{name} read the garbage page (non-finite output)")
        refs = []
        for k, v, ks, vs in flat:  # the plain version gathers page 0 and masks it
            ks, vs = ks.clone(), vs.clone()
            ks[0], vs[0] = 1.0, 1.0
            refs.append((k, v, ks, vs))
    err = attn_check(f"{name} {shape}", got, plain(q, *refs[0], *tail))
    n = len(std)
    ms = _time_cycled(lambda i: fn(q, *flat[i], *tail), n)
    twin_ms = _time_cycled(lambda i: twin(q, *std[i], *tail), n)
    plain_ms = _time_cycled(lambda i: plain(q, *refs[i], *tail), n, iters=3)
    lib_ms = lib_fn()
    b_ms, b_by = bound_ms(nbytes, flops)
    print(f"time {name} {shape}: kernel {ms:.4f} ms, its standard twin {twin_name} {twin_ms:.4f} "
          f"ms in this call, plain {plain_ms:.4f} ms, {library} {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}); bit-equal to the twin and over two calls; {n} copies cycled")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, shape=shape, library=library, twin=twin_name,
                twin_ms=twin_ms, bit_equal_to_twin=True, copies=n)


def flat_kernel_phase(spec, k3_lengths, dev):
    """K12a-d at the shapes their configs give them: K12a at the lengths of
    each timed K3 shape (``k3_lengths``, llama_decoder.yml's S = 128 row
    first), K12b at S = 16 with W = 5 and 9, K12c and K12d at llama_paged.yml's S =
    64, pages of 256, a pool of 129 (page 0 NaN). The bytes and the
    library yardsticks are their standard twins'."""
    import torch
    import torch.nn.functional as F

    from starpu_inference_server_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device=dev).manual_seed(4343)
    bf16 = torch.bfloat16
    hq, hkv, d, rep = spec.q_heads, spec.kv_heads, spec.head_dim, spec.rep
    rows = {}

    def dense_cache(s_, t_):
        return (torch.randint(-127, 128, (s_, t_, hkv, d), device=dev, generator=g,
                              dtype=torch.int8),
                torch.randint(-127, 128, (s_, t_, hkv, d), device=dev, generator=g,
                              dtype=torch.int8),
                torch.rand(s_, t_, hkv, device=dev, generator=g) * 0.03 + 0.05,
                torch.rand(s_, t_, hkv, device=dev, generator=g) / 127 + 1e-3)

    def deq(kc, vc, ks, vs):
        return ((kc.float() * ks[..., None]).to(bf16).transpose(1, 2),
                (vc.float() * vs[..., None]).to(bf16).transpose(1, 2))

    # K12a at each of K3's timed shapes (the row first), with its lengths
    t_ = 1024
    per_shape = []
    for lengths in k3_lengths:
        s_ = len(lengths)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        live = int((lens.to(torch.int64) + 1).sum())
        nbytes = 2 * s_ * hq * d * 2 + live * hkv * (2 * d + 8) + 4 * s_
        caches = [dense_cache(s_, t_) for _ in range(_copies(nbytes))]
        q = torch.randn(s_, hq, d, device=dev, generator=g).to(bf16)
        dq = [deq(*c) for c in caches[:_copies(2 * s_ * t_ * hkv * d * 2)]]
        mask = (torch.arange(t_, device=dev)[None, :] <= lens[:, None])[:, None, None, :]
        splits = da.decode_split_plan(s_, hkv, t_, 1, rep, d).splits
        row = _flat_row(
            "flat_decode_attention", q, caches, (lens, rep), nbytes, 4.0 * live * hq * d,
            "sdpa on the dequantized cache", lambda: _time_cycled(
                lambda i: F.scaled_dot_product_attention(
                    q[:, :, None, :], *dq[i], attn_mask=mask, enable_gqa=True), len(dq)),
            f"S={s_} T={t_} live={live} ({splits} splits)")
        per_shape.append(dict(row, splits=splits))
        del caches, dq
    rows["flat_decode_attention"] = dict(per_shape[0], per_shape=per_shape)

    # K12b
    s_, t_ = 16, 1024
    per_shape = []
    for w in (5, 9):
        q = torch.randn(s_, w, hq, d, device=dev, generator=g).to(bf16)
        lens = torch.randint(0, t_ - w + 1, (s_,), device=dev, generator=g, dtype=torch.int32)
        lens[0], lens[1] = 0, t_ - w
        live = int((lens.to(torch.int64) + w).sum())
        nbytes = 2 * s_ * w * hq * d * 2 + live * hkv * (2 * d + 8) + 4 * s_
        caches = [dense_cache(s_, t_) for _ in range(_copies(nbytes))]
        last = lens.to(torch.int64)[:, None] + torch.arange(w, device=dev)[None, :]
        allowed = torch.arange(t_, device=dev)[None, None, :] <= last[:, :, None]
        mask = torch.zeros(allowed.shape, device=dev).masked_fill(~allowed, float("-inf"))
        mask = mask[:, None].to(bf16)
        qt = q.transpose(1, 2)
        dq = [deq(*c) for c in caches[:_copies(2 * s_ * t_ * hkv * d * 2)]]
        splits = da.decode_split_plan(s_, hkv, t_, w, rep, d).splits
        row = _flat_row(
            "flat_window_decode_attention", q, caches, (lens, rep), nbytes,
            4.0 * int((last + 1).sum()) * hq * d, "sdpa (float mask) on the dequantized cache",
            lambda: _time_cycled(lambda i: F.scaled_dot_product_attention(
                qt, *dq[i], attn_mask=mask, enable_gqa=True), len(dq)),
            f"S={s_} W={w} T={t_} live={live} ({splits} splits)")
        row["splits"] = splits
        per_shape.append(row)
        if w == 5:
            rows["flat_window_decode_attention"] = dict(row, per_shape=per_shape)
        del caches, dq

    # K12c, K12d
    s_, page, n_pages, mp = 64, 256, 129, 4

    def pool():
        c = dense_cache(n_pages, page)
        c[2][0], c[3][0] = float("nan"), float("nan")
        return c

    for w, name in ((1, "flat_paged_decode_attention"), (5, "flat_paged_window_decode_attention")):
        lens = torch.randint(0, 2 * page - w + 1, (s_,), device=dev, generator=g,
                             dtype=torch.int32)
        lens[0], lens[1], lens[2] = 0, page - 2, 2 * page - w
        perm = (torch.randperm(n_pages - 1, device=dev, generator=g) + 1).tolist()
        table = torch.zeros(s_, mp, dtype=torch.int32)
        for i, length in enumerate(lens.tolist()):
            live_pages = (length + w - 1) // page + 1
            table[i, :live_pages] = torch.tensor([perm.pop() for _ in range(live_pages)])
        table = table.to(dev)
        q = torch.randn(s_, w, hq, d, device=dev, generator=g).to(bf16)
        if w == 1:
            q = q[:, 0]
        live = int((lens.to(torch.int64) + w).sum())
        nbytes = 2 * s_ * w * hq * d * 2 + live * hkv * (2 * d + 8) + 4 * s_ * (mp + 1)
        pools = [pool() for _ in range(_copies(nbytes))]
        last = lens.to(torch.int64)[:, None] + torch.arange(w, device=dev)[None, :]
        allowed = torch.arange(mp * page, device=dev)[None, None, :] <= last[:, :, None]
        mask = torch.zeros(allowed.shape, device=dev).masked_fill(~allowed, float("-inf"))
        mask = mask[:, None].to(bf16)
        q4 = q.reshape(s_, w, hq, d).transpose(1, 2)
        tl = table.to(torch.int64)
        finite = []
        for kp, vp, ksp, vsp in pools:
            ksp, vsp = ksp.clone(), vsp.clone()
            ksp[0], vsp[0] = 1.0, 1.0
            finite.append((kp, vp, ksp, vsp))

        def sequence(i):
            kp, vp, ksp, vsp = finite[i]
            kd = (kp[tl].float() * ksp[tl][..., None]).to(bf16).reshape(s_, mp * page, hkv, d)
            vd = (vp[tl].float() * vsp[tl][..., None]).to(bf16).reshape(s_, mp * page, hkv, d)
            return F.scaled_dot_product_attention(q4, kd.transpose(1, 2), vd.transpose(1, 2),
                                                  attn_mask=mask, enable_gqa=True)

        splits = da.decode_split_plan(s_, hkv, mp * page, w, rep, d).splits
        rows[name] = dict(_flat_row(
            name, q, pools, (table, lens, rep), nbytes, 4.0 * int((last + 1).sum()) * hq * d,
            "no one call; sequence gather + dequantize + sdpa",
            lambda: _time_cycled(sequence, len(finite)),
            f"S={s_} W={w} page={page} pool={n_pages} live={live} ({splits} splits)",
            garbage_page=True), splits=splits)
        del pools, finite
    torch.cuda.empty_cache()
    return rows


def flat_step_phase(spec, params, counters, dev):
    """llama-1b int8 at full depth: a decode step and a verify window on a
    dense cache, and one of each on a paged cache (a shuffled table of
    256-row pages), in the standard and the flat layout on the same
    prefilled contents. Each flat step must give the standard step's
    logits exactly on the live slots (idle ones read the row their parked
    writes race for) and launch its K12 kernel once per layer (its
    standard twin never); returns those launches per step or verify."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.models import paged_decoder as pd
    from starpu_inference_server_tpu_torch.models.decoder import (
        decode_step, init_cache, prefill, verify_step,
    )

    dtype = torch.bfloat16
    s_, t_, w, page = 16, 1024, 5, 256
    rng = np.random.default_rng(17)
    lens = [300, 255, 100, 45]  # slot 1's window crosses into its second page
    prompts = []
    for n in lens:
        p = np.zeros((512,), np.int32)
        p[:n] = rng.integers(0, spec.vocab, n)
        prompts.append(torch.as_tensor(p, device=dev))
    window = torch.as_tensor(rng.integers(0, spec.vocab, (s_, w)).astype(np.int32), device=dev)
    active = torch.zeros(s_, dtype=torch.bool, device=dev)
    active[:len(lens)] = True
    perm = [int(x) for x in rng.permutation(np.arange(1, 129))]
    table_rows = [[perm.pop(), perm.pop(), 0, 0] for _ in lens]
    logits, counts = {}, {}
    for flat in (False, True):
        dense = init_cache(spec, s_, t_, device=dev, flat=flat)
        paged = pd.init_paged_cache(spec, s_, t_, num_pages=129, page_size=page, device=dev,
                                    flat=flat)
        for slot, (ids, n) in enumerate(zip(prompts, lens)):
            pd.set_table_row(paged, slot, table_rows[slot])
            prefill(spec, params, dense, ids, n, slot, dtype)
            pd.paged_prefill(spec, params, paged, ids, n, slot, dtype)
        for what, fn, cache, ids in (("decode", decode_step, dense, window[:, 0]),
                                     ("verify", verify_step, dense, window),
                                     ("paged decode", pd.paged_decode_step, paged, window[:, 0]),
                                     ("paged verify", pd.paged_verify_step, paged, window)):
            torch.cuda.synchronize()
            zero_counts(counters)
            logits[flat, what] = fn(spec, params, cache, ids, active, dtype)[1]
            torch.cuda.synchronize()
            counts[flat, what] = read_counts(counters)
        del dense, paged
    per = {}
    live = slice(0, len(lens))  # idle slots park their writes on one shared row
    for what, name in (("decode", "flat_decode_attention"),
                       ("verify", "flat_window_decode_attention"),
                       ("paged decode", "flat_paged_decode_attention"),
                       ("paged verify", "flat_paged_window_decode_attention")):
        twin = name[len("flat_"):]
        require(bool(torch.isfinite(logits[True, what][live]).all()),
                f"flat {what} logits not finite")
        require(torch.equal(logits[True, what][live], logits[False, what][live]),
                f"flat {what} logits differ from the standard layout's")
        require(counts[True, what][name] == spec.layers and counts[True, what][twin] == 0,
                f"a flat {what} launched {name} {counts[True, what][name]} and {twin} "
                f"{counts[True, what][twin]} times (want {spec.layers} and 0)")
        require(counts[False, what][twin] == spec.layers and counts[False, what][name] == 0,
                f"a standard {what} launched {twin} {counts[False, what][twin]} times")
        per[name] = counts[True, what][name]
    print(f"model llama-1b int8 {spec.layers} layers, flat vs standard layout on the same "
          f"contents (lengths {lens}): decode, verify W={w}, paged decode and paged verify "
          f"logits bit-equal; launches per step or verify: {json.dumps(per)}")
    return per


def flat_path(int4_params, decoder_serving, ctx, counters, card, dev):
    """The serving phases of the fourth group, each against a run the
    earlier groups made: llama_decoder.yml flat on the int4 tree (every
    stream equal to the standard engine's, K3 never launched) and at
    depth 1 (``decode_overlap: false``; streams equal to the config's
    depth 4); llama_prompt_lookup.yml flat, rigged (streams equal to the
    plain engine's); llama_paged.yml flat (prefix hits, tokens reused and
    streams equal to the standard paged run's, no leaked page), then with
    prompt lookup, rigged. Returns each K12 kernel's launches."""
    import torch

    from starpu_inference_server_tpu_torch.serving.generation import build_generation_engine
    from starpu_inference_server_tpu_torch.utils.config import load_config

    launches = {}
    cfg = load_config(str(CONFIG))
    prompts, want = decoder_serving
    flat_cfg = _cfg_with(cfg, kv_cache_layout="flat")
    engine = build_generation_engine(flat_cfg, device=dev, params=int4_params)
    got, ran = generate_all(engine, prompts, 32, counters,
                            ("flat_decode_attention", "int4_matmul", "causal_attention",
                             "chunk_prefill_attention"), "llama_decoder flat", card,
                            absent=("decode_attention",), dense_prefills=True,
                            decode_kernel="flat_decode_attention")
    same = sum(a == b for a, b in zip(got, want))
    print(f"llama_decoder flat: {same} of {len(want)} streams identical to the standard layout's")
    require(same == len(want), "llama_decoder flat: a stream differs from the standard engine's")
    launches["flat_decode_attention"] = ran["flat_decode_attention"]
    del engine
    engine = build_generation_engine(_cfg_with(cfg, decode_overlap=False), device=dev,
                                     params=int4_params)
    require(engine.pipeline_depth == 1, "decode_overlap: false did not give depth 1")
    got, _ = generate_all(engine, prompts, 32, counters, DECODER_KERNELS,
                          "llama_decoder at depth 1 (decode_overlap: false)", card,
                          dense_prefills=True, decode_kernel="decode_attention")
    same = sum(a == b for a, b in zip(got, want))
    print(f"overlap: {same} of {len(want)} streams at depth 1 identical to depth "
          f"{int(cfg.model.options['decode_pipeline_depth'])}")
    require(same == len(want), "a stream at depth 1 differs from the config's depth")
    del engine
    torch.cuda.empty_cache()

    lookup_cfg = _rigged(_cfg_with(load_config(str(LOOKUP_CONFIG)), kv_cache_layout="flat"))
    engine = build_generation_engine(lookup_cfg, device=dev, params=ctx["rigged"])
    got, ran = generate_all(engine, ctx["rig_prompts"], 48, counters,
                            ("flat_window_decode_attention", "int8_matmul"),
                            "llama_prompt_lookup flat (rigged)", card,
                            absent=("window_decode_attention",))
    rate, floor = engine.draft_acceptance_rate(), RIG_ACCEPT_FLOOR["lookup"]
    same = sum(a == b for a, b in zip(got, ctx["lookup_rigged_want"]))
    print(f"llama_prompt_lookup flat (rigged): {same} of {len(got)} streams identical to the "
          f"plain engine's; acceptance {rate:.3f} (floor {floor})")
    require(same == len(got), "lookup flat (rigged): a stream differs from the plain engine's")
    require(rate >= floor, f"lookup flat (rigged): acceptance {rate:.3f} under {floor}")
    launches["flat_window_decode_attention"] = ran["flat_window_decode_attention"]
    del engine

    paged_cfg = _cfg_with(load_config(str(PAGED_CONFIG)), kv_cache_layout="flat")
    prompts, want = ctx["paged_streams"]
    engine = build_generation_engine(paged_cfg, device=dev, params=ctx["params"])
    got, ran = generate_all(engine, prompts, 16, counters,
                            ("flat_paged_decode_attention", "int8_matmul"), "llama_paged flat",
                            card, absent=("paged_decode_attention",),
                            decode_kernel="flat_paged_decode_attention")
    acct = engine.page_accounting()
    refs = int((engine._page_refs > 0).sum())
    std = ctx["paged_stats"]
    same = sum(a == b for a, b in zip(got, want))
    print(f"llama_paged flat: {same} of {len(want)} streams identical to the standard paged "
          f"run's; prefix hits {engine.prefix_hits} ({engine.prefix_tokens_reused} tokens) "
          f"against {std['prefix_hits']} ({std['reused']}); pages after the burst "
          f"{json.dumps(acct)}, with a reference {refs}")
    require((engine.prefix_hits, engine.prefix_tokens_reused) == (std["prefix_hits"],
                                                                  std["reused"]),
            "llama_paged flat: prefix reuse differs from the standard paged run's")
    require(acct["live"] == 0 and acct["free"] + acct["retained"] + acct["garbage"] == acct["pool"]
            and refs == acct["retained"], "llama_paged flat: pages leaked")
    require(same == len(want), "llama_paged flat: a stream differs from the standard paged run's")
    launches["flat_paged_decode_attention"] = ran["flat_paged_decode_attention"]
    del engine
    engine = build_generation_engine(_rigged(_cfg_with(paged_cfg, prompt_lookup_ngram=2)),
                                     device=dev, params=ctx["rigged"])
    got, ran = generate_all(engine, ctx["rig_prompts"], 48, counters,
                            ("flat_paged_window_decode_attention", "int8_matmul"),
                            "llama_paged flat + prompt lookup (rigged)", card,
                            absent=("paged_window_decode_attention",))
    same = sum(a == b for a, b in zip(got, ctx["lookup_rigged_want"]))
    print(f"llama_paged flat + prompt lookup (rigged): {same} of {len(got)} streams identical "
          f"to the plain rigged engine's; acceptance {engine.draft_acceptance_rate():.3f}")
    require(same == len(got), "paged flat + lookup (rigged): a stream differs")
    launches["flat_paged_window_decode_attention"] = ran["flat_paged_window_decode_attention"]
    del engine
    torch.cuda.empty_cache()
    return launches


# -- every family and quant mode on one device: ViT, W8A8 ResNet, MoE, serve_logits -

# Limits of this group, by mean relative error |a - b|.mean() / |b|.mean(),
# set from the first reading on an H100 80GB HBM3 at 700 W (PERF.md
# section 6), each about 3x over it:
# - ViT-L/16 int8 at BF16 against the FP32 forward of the same int8 tree
#   (bf16 activations through 24 layers of random weights): read 1.16e-2;
# - ViT served against a batch-1 apply at BF16 (GEMMs of another batch
#   size sum in another order, and a last-bit change flips a bf16
#   rounding; through 24 layers that reaches the size of the BF16-against-
#   FP32 gap): read 1.27e-2 and 1.29e-2;
# - ResNet-18 W8A8 served against a batch-1 apply: the activation scale of
#   every conv spans the whole batch in both packages, so a response
#   depends on its batch-mates (ROADMAP queue 3): read 7.2e-3; the FP32
#   unquantized witness, served the same images, carries the hard check
#   (read 4.7e-7 against 1e-5, and element by element);
# - serve_logits: the served logits against forward_logits at batch 1 on
#   the card, the same computation: read 0 (bit-equal); the limit only
#   leaves room for a library that picks another algorithm on a lane's
#   stream.
VIT_FP32_TOL = 3.5e-2
VIT_SERVE_TOL = 4e-2
NHWC_SERVE_TOL = 2e-2
NHWC_WITNESS = ("none", "FP32", 1e-5, (1e-4, 1e-4))
LOGITS_TOL = 1e-6
VIT_IMAGES = 64
# moe-8x1b's depth in this run: numpy draws its 4.4e9 weights at 16
# layers in about a minute on the card's host, more than the run can spare;
# every layer has the same shapes, so the per-layer and per-step numbers
# scale with it
MOE_LAYERS = 1  # moe-8x1b cut from 16 layers for the run's time limit
LOGITS_REQUESTS = 4
LOGITS_LAYERS = 4  # serve_logits' llama-1b cut from 16 layers for the run's time limit


def narrow_matmul_rows(dev, card):
    """K2 (int8_matmul) and K1 (int4_matmul) at the shapes this group
    gives them that no earlier path did: the ViT-L/16 head (M = 32, K =
    1024, N = 1000), the moe-8x1b router at 16 slots (K = 2048, N = 8:
    int8, and int4, where the rank-2 router is packed) and the moe-tiny
    router (K = 256, N = 4). Each held against its plain version (1e-4
    max|ref|), bit-equal over two calls, timed on cycled copies beside the
    plain version, torch.matmul bf16 on the dequantized weight and the
    bound; at most 64 copies, so the routers' weights (4-16 KB) stay in
    the L2, where a decode step's router may well find them. Returns
    per-shape entries by kernel."""
    import torch

    from starpu_inference_server_tpu_torch.ops import matmul_kernels as mk
    from starpu_inference_server_tpu_torch.ops.quant import pack_int4, unpack_int4

    g = torch.Generator(device=dev).manual_seed(4711)
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = (("int8_matmul", "vit_l_16 head", 32, 1024, 1000),
             ("int8_matmul", "moe-8x1b router", 16, 2048, 8),
             ("int8_matmul", "moe-tiny router", 16, 256, 4),
             ("int4_matmul", "moe-8x1b router (int4)", 16, 2048, 8))
    out = {"int8_matmul": [], "int4_matmul": []}
    for kernel, name, m, k, n in cases:
        int4 = kernel == "int4_matmul"
        wbytes = k * n // 2 if int4 else k * n
        copies = min(_copies(wbytes), 64)
        x = torch.randn(m, k, device=dev, generator=g).to(bf16)
        lo, hi = (-7, 8) if int4 else (-128, 128)
        wqs = [torch.randint(lo, hi, (k, n), device=dev, generator=g, dtype=torch.int8)
               for _ in range(copies)]
        ws = [pack_int4(w) for w in wqs] if int4 else wqs
        sc = torch.rand(1, n, device=dev, generator=g) * 0.01 + 1e-3
        fn, plain = ((mk.int4_matmul, mk.int4_matmul_plain) if int4
                     else (mk.int8_matmul, mk.int8_matmul_plain))
        got = fn(x, ws[0], sc)
        ref = plain(x, ws[0], sc)
        err = max_err(got, ref)
        tol = 1e-4 * ref.abs().max().item()
        same = bool(torch.equal(got, fn(x, ws[0], sc)))
        plan = mk.matmul_plan(kernel, m, n, k, sms)
        shape = f"M={m} K={k} N={n}"
        print(f"kernel {kernel} {shape} ({name}): max_abs_err={err:.3e} tol={tol:.3e} (1e-4 "
              f"max|ref|); two calls bit-equal {same}; tile {mk.QMM_TILES[plan.variant]}, "
              f"{plan.splits} splits, {plan.grid} blocks")
        require(err <= tol, f"{kernel} {name} disagrees with its plain version")
        require(same, f"{kernel} {name} gave other bits on a second call")
        ms = _time_cycled(lambda i: fn(x, ws[i], sc), copies)
        plain_ms = time_ms(lambda: plain(x, ws[0], sc), iters=5)
        deq = [((unpack_int4(ws[i]) if int4 else ws[i]).float() * sc).to(bf16)
               for i in range(copies)]
        lib_ms = _time_cycled(lambda i: torch.matmul(x, deq[i]), copies)
        b_ms, b_by = bound_ms(m * k * 2 + wbytes + n * 4 + m * n * 4, 2.0 * m * k * n)
        print(f"time {kernel} {shape} ({name}) on {card}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, torch.matmul bf16 {lib_ms:.4f} ms ({copies} dequantized "
              f"weights cycled), bound {b_ms:.4f} ms ({b_by})")
        out[kernel].append(dict(layer=name, m=m, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, shape=shape,
                                splits=plan.splits, grid=plan.grid))
        del wqs, ws, deq
    return out


def forward_busy(model, inputs, what):
    """The host clock of one forward (median of 3) and its device busy
    time (torch.profiler's kernel sum), printed; returns the busy ms (None
    where the profiler fails)."""
    import torch

    host = forward_ms(model, inputs)

    def run():
        with torch.inference_mode():
            model.apply(inputs)
        torch.cuda.synchronize()

    prof = _profile_block(run)
    busy = None if prof is None else sum(prof[0].values())
    print(f"model {what} forward (host clock, synchronised, median of 3): {host:.2f} ms; device "
          f"busy (torch.profiler kernel sum of one forward): "
          + ("not measured" if busy is None else f"{busy:.4f} ms"))
    return busy


def vit_path(counters, card):
    """configs/vit_l_16.yml (ViT-L/16, int8 weights, BF16, adaptive
    batching up to 32, two lanes, the congestion monitor) on a local
    server: the model at B = 32 against the FP32 forward of the same
    tree, with the head's int8_matmul launch and the forward's device busy
    time; then 64 concurrent one-image requests, each held against a
    batch-1 apply. The config's batching traces are turned off in code
    (a server that traces forks the plot script at its shutdown)."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.utils.config import load_config

    cfg = load_config(str(VIT_CONFIG))
    cfg = dataclasses.replace(cfg, trace_enabled=False)
    bundle = LocalServer(cfg)
    bundle.target = bundle.start()
    try:
        model = bundle.server.engine.model
        dev = bundle.server.engine.device
        x = torch.from_numpy(np.random.default_rng(41).standard_normal((32, 3, 224, 224))
                             .astype(np.float32)).to(dev)
        torch.cuda.synchronize()
        zero_counts(counters)
        with torch.inference_mode():
            out = model.apply({"input": x})["output"]
        torch.cuda.synchronize()
        per_forward = read_counts(counters)
        require(bool(torch.isfinite(out).all()), "ViT logits are not finite")
        require(tuple(out.shape) == (32, 1000), f"ViT output shape {tuple(out.shape)}")
        with torch.inference_mode():
            ref = model.definition.apply(model.params, {"input": x}, torch.float32)["output"]
        rel = rel_err(out, ref)
        agree = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
        print(f"model vit_l_16 int8 BF16 B=32: against the FP32 forward of the same tree, mean "
              f"rel err {rel:.3e} (tol {VIT_FP32_TOL}), argmax agreement {agree:.3f}; launches "
              f"in one forward: {json.dumps({k: v for k, v in per_forward.items() if v})}")
        require(rel <= VIT_FP32_TOL, "ViT at BF16 disagrees with its FP32 forward")
        require(per_forward["int8_matmul"] == 1,
                f"ViT forward ran int8_matmul {per_forward['int8_matmul']} times (the head: 1)")
        busy = forward_busy(model, {"input": x}, "vit_l_16 int8 B=32")
        rng = np.random.default_rng(42)
        samples = [{"input": rng.standard_normal((1, 3, 224, 224)).astype(np.float32)}
                   for _ in range(VIT_IMAGES)]
        launches, stats = batch_serving_phase("vit_l_16", bundle, samples, "output",
                                              VIT_SERVE_TOL, counters, ("int8_matmul",), card,
                                              "img")
    finally:
        bundle.stop()
    return launches, dict(per_forward, busy_ms=busy, rate=stats["rate"])


def resnet_w8a8_path(counters, card):
    """configs/resnet18_nhwc.yml (ResNet-18 W8A8, NHWC wire, adaptive
    batching up to 32) on a local server. The model at B = 32: every
    integer contraction of the forward (each conv, by im2col) is held
    against the same product in float64 on the card (the s32 sums of
    ``nn._int_mm_s32`` equal,
    and the f32 the conv uses equal to the exact sum rounded once), with
    the fc's int8_matmul launch and the device busy time. Then 128
    concurrent one-image requests, each against a batch-1 apply within
    ``NHWC_SERVE_TOL`` (the activation scale spans the batch), and the same
    requests on a witness server of the config unquantized at FP32, within
    ``NHWC_WITNESS``'s limits and element by element."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.ops import nn
    from starpu_inference_server_tpu_torch.utils.config import QuantMode, load_config

    cfg = load_config(str(NHWC_CONFIG))
    require(cfg.model.options.get("input_layout") == "NHWC", "resnet18_nhwc.yml is not NHWC")
    rng = np.random.default_rng(43)
    samples = [{"input": rng.standard_normal((1, 224, 224, 3)).astype(np.float32)}
               for _ in range(RESNET_IMAGES)]
    bundle = LocalServer(cfg)
    bundle.target = bundle.start()
    try:
        require(nn.w8a8_enabled(), "the W8A8 server did not turn the W8A8 flag on")
        model = bundle.server.engine.model
        dev = bundle.server.engine.device
        x = torch.from_numpy(np.random.default_rng(44).standard_normal((32, 224, 224, 3))
                             .astype(np.float32)).to(dev)
        plain_dot = nn._int_dot
        checks = []

        def checked(x_q, w):
            y = plain_dot(x_q, w)
            exact = x_q.double() @ w.double()  # every partial sum exact below 2^53
            checks.append((tuple(x_q.shape), tuple(w.shape),
                           bool(torch.equal(nn._int_mm_s32(x_q, w).double(), exact)),
                           bool(torch.equal(y, exact.float())), exact.abs().max().item()))
            return y

        torch.cuda.synchronize()
        zero_counts(counters)
        nn._int_dot = checked
        try:
            with torch.inference_mode():
                out = model.apply({"input": x})["output"]
            torch.cuda.synchronize()
        finally:
            nn._int_dot = plain_dot
        per_forward = read_counts(counters)
        require(bool(torch.isfinite(out).all()) and tuple(out.shape) == (32, 1000),
                "ResNet W8A8 logits are not finite or of the wrong shape")
        exact_ok = all(c[2] and c[3] for c in checks)
        print(f"model resnet18 W8A8 NHWC B=32 on {card}: {len(checks)} integer contractions (M x "
              f"K by K x N: {', '.join(f'{a[0]}x{a[1]} by {b[1]}' for a, b, *_ in checks[:4])}, "
              f"...), s32 sums of torch._int_mm equal to float64 on the card: {exact_ok}; largest "
              f"|sum| {max(c[4] for c in checks):.0f} (2^24 = 16777216); launches in one forward: "
              f"{json.dumps({k: v for k, v in per_forward.items() if v})}")
        require(len(checks) == 20, f"{len(checks)} integer contractions in a ResNet-18 forward "
                                   f"(its 20 convs)")
        require(exact_ok, "a W8A8 conv's integer sums differ from float64 on the card")
        require(per_forward["int8_matmul"] == 1, "the W8A8 fc did not run int8_matmul once")
        busy = forward_busy(model, {"input": x}, "resnet18 W8A8 NHWC B=32")
        launches, stats = batch_serving_phase("resnet18_nhwc (W8A8)", bundle, samples, "output",
                                              NHWC_SERVE_TOL, counters, ("int8_matmul",), card,
                                              "img")
    finally:
        bundle.stop()
    quant, dtype, tol, elem = NHWC_WITNESS
    wcfg = dataclasses.replace(cfg, name=f"resnet18_nhwc_{quant}_{dtype.lower()}",
                               model=dataclasses.replace(cfg.model, quantization=QuantMode(quant),
                                                         compute_dtype=dtype))
    witness = LocalServer(wcfg)
    witness.target = witness.start()
    try:
        require(not nn.w8a8_enabled(), "the unquantized witness left the W8A8 flag on")
        batch_serving_phase(f"resnet18_nhwc witness ({quant}, {dtype})", witness, samples,
                            "output", tol, counters, (), card, "img", check_argmax=True,
                            elem_tol=elem)
    finally:
        witness.stop()
    return launches, dict(per_forward, busy_ms=busy, rate=stats["rate"])


def moe_path(counters, card, dev):
    """configs/moe_decoder.yml (moe-8x1b at full width, ``MOE_LAYERS``
    layers, int8 weights and KV cache, 16 slots, the 1x1x1 expert mesh) on
    the generation engine: 16 greedy requests of 32 tokens (prompts of 40,
    200 and 600 tokens, the last chunked, and 13 of 64), every prefill and
    chunk through its kernel, every decode block a graph replay, the
    router and attention projections through int8_matmul at 16 rows; the
    decode block phase (eager body against the graph replay: equal
    tokens, carry and cache bytes; host clock, device busy time); the
    device time of dequantizing one layer's expert stacks, and its share
    of a step. Then moe-tiny at its registered width (head_dim 32, 4
    experts) at FP32, kernels on against off: equal streams."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.models.decoder import get_spec, init_params
    from starpu_inference_server_tpu_torch.ops import nn
    from starpu_inference_server_tpu_torch.serving.generation import build_generation_engine
    from starpu_inference_server_tpu_torch.utils.config import load_config

    cfg = load_config(str(MOE_CONFIG))
    require(cfg.devices.mesh.size == 1, "moe_decoder.yml's mesh is not one device")
    opts = dict(cfg.model.options, layers=MOE_LAYERS)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, options=opts))
    print(f"time cut: moe_decoder at {MOE_LAYERS} of 16 layers (formerly 4, then 2), here and "
          "in the GSPMD world")
    t0 = time.perf_counter()
    engine = build_generation_engine(cfg, device=dev)
    spec = engine.spec
    print(f"engine: {cfg.model.family} ({cfg.model.quantization.value}, "
          f"{cfg.model.compute_dtype}; {spec.layers} layers, {spec.num_experts} experts, top "
          f"{spec.experts_per_token}) built in {time.perf_counter() - t0:.1f} s")
    require(spec.is_moe and spec.hidden == 2048 and spec.num_experts == 8, "not moe-8x1b")
    rng = np.random.default_rng(52)
    lens = [40, 200, 600] + [64] * (engine.num_slots - 3)
    prompts = [rng.integers(0, spec.vocab, n).astype(np.int32) for n in lens]
    t0 = time.perf_counter()
    _, launches = generate_all(engine, prompts, 32, counters,
                               ("int8_matmul", "decode_attention", "causal_attention",
                                "chunk_prefill_attention"), "moe_decoder", card,
                               dense_prefills=True, decode_kernel="decode_attention")
    wall = time.perf_counter() - t0
    admit = engine.loop_timers["admit"]
    print(f"moe_decoder: admit {admit:.3f} s of a {wall:.3f} s wall ({admit / wall:.1%})")
    block = decode_block_phase(engine, card, label="moe decode block")
    steps = engine.steps_per_sync
    experts = engine.params["layers"][0]["mlp"]["experts"]
    bf16 = torch.bfloat16

    def dequantize():
        nn.resolve_weight(experts["gate_up"]["w"], bf16)
        nn.resolve_weight(experts["down"]["w"], bf16)

    deq_ms = time_ms(dequantize, iters=5)
    busy = block["graph"]["busy_ms"]
    step_ms = None if busy is None else busy / steps
    mb = sum(experts[n]["w"]["w_q"].numel() for n in ("gate_up", "down")) * 2 / 1e6
    print(f"moe decode step on {card}: dequantizing one layer's expert stacks ({mb:.0f} MB of "
          f"bf16 out) takes {deq_ms:.4f} ms of device time, {spec.layers} layers "
          f"{spec.layers * deq_ms:.3f} ms a step against a step's device busy time "
          + ("not measured" if step_ms is None else
             f"{step_ms:.3f} ms ({spec.layers * deq_ms / step_ms:.1%})"))
    del engine, experts
    torch.cuda.empty_cache()

    tiny = get_spec("moe-tiny", {})
    require(tiny.head_dim == 32 and tiny.num_experts == 4, "moe-tiny is not head_dim 32, 4 experts")
    rng = np.random.default_rng(53)
    prompts = [rng.integers(0, tiny.vocab, n).astype(np.int32)
               for n in (10, 20, 50, 100, 200, 7, 64, 128)]
    kernels_on_off_streams(tiny, init_params(tiny, np.random.default_rng(0)), prompts, counters,
                           card, dev, "moe-tiny (4 experts, head_dim 32)")
    return launches, dict(block=block, dequantize_layer_ms=deq_ms, step_busy_ms=step_ms,
                          admit_s=admit, wall_s=wall)


def serve_logits_path(counters, card):
    """configs/llama_decoder.yml (llama-1b, int4) with ``serve_logits:
    true`` set in code: the decoder on the batch pipeline, no generation
    engine. 4 concurrent ModelInfer requests of 512 ids; every response's
    logits held against forward_logits at batch 1 on the card (the
    model's ``apply``), causal_attention once a layer a forward."""
    import numpy as np

    from starpu_inference_server_tpu_torch.utils.config import load_config

    cfg = load_config(str(CONFIG))
    opts = dict(cfg.model.options, serve_logits=True, layers=LOGITS_LAYERS)
    print(f"time cut: llama_decoder.yml with serve_logits at {LOGITS_LAYERS} of 16 layers "
          "(formerly 16)")
    cfg = dataclasses.replace(cfg, name="llama_logits",
                              model=dataclasses.replace(cfg.model, options=opts))
    seq = cfg.inputs[0].dims[0]
    bundle = LocalServer(cfg)
    bundle.target = bundle.start()
    try:
        require(bundle.server.generation_engine is None and bundle.server.runner is not None,
                "the serve_logits server is not a batch server")
        rng = np.random.default_rng(54)
        samples = [{"input_ids": rng.integers(0, 32000, (1, seq)).astype(np.int64)}
                   for _ in range(LOGITS_REQUESTS)]
        launches, stats = batch_serving_phase("llama_decoder serve_logits", bundle, samples,
                                              "logits", LOGITS_TOL, counters,
                                              ("int4_matmul", "causal_attention"), card, "seq")
        layers = len(bundle.server.engine.model.params["layers"])
        want = layers * LOGITS_REQUESTS
        require(launches["causal_attention"] == want,
                f"serve_logits: causal_attention launched {launches['causal_attention']} times, "
                f"want {want} (one a layer a forward of T = {seq})")
    finally:
        bundle.stop()
    return launches, stats


# -- clients and checkpoints: the CLI entry points as separate processes ----------

PERF_CONFIG = ROOT / "ci" / "perf" / "resnet152_ci_perf.yml"
SMOKE_SCHEDULE = ROOT / "ci" / "perf" / "ci_perf_resnet_smoke.csv"
FULL_SCHEDULE = ROOT / "ci" / "perf" / "ci_perf_resnet.csv"
SMOKE_REQUESTS = 64
# the reference's gates (scripts/run_perf_smoke.sh: MAX_P95_MS, MIN_RPS)
MAX_P95_MS = 500
MIN_RPS = 10
GEN_TOKENS, GEN_PROMPT, GEN_REQUESTS = 32, 64, 128
GEN_UNARY_REQUESTS = 32  # the unary client run's, cut from 128 for the run's time limit
CLIENT_LAYERS = 4  # the clients' llama_decoder.yml server, cut from 16 layers for the same
BERT_TEXTS = ("The quick brown fox jumps over the lazy dog.",
              "Serving a long BERT sequence through the port's bidirectional attention kernel.")
# the subprocesses read no model hub: the BERT client's tokenizer falls back offline
CHILD_ENV = {"HF_HUB_OFFLINE": "1", "TRANSFORMERS_OFFLINE": "1"}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env() -> dict:
    import os

    return dict(os.environ, PYTHONPATH=str(ROOT), **CHILD_ENV)


class ServerProcess:
    """``python -m starpu_inference_server_tpu_torch.grpc.server --config
    <yml> [args]`` as its own process. The yml is a temp copy of ``base``
    with ``changes`` (dotted keys), a fresh port and ``metrics_port: 0``;
    the server's log goes to a file beside it."""

    def __init__(self, base: Path, workdir: Path, tag: str, changes: dict = None,
                 args: list = ()):
        import yaml

        raw = yaml.safe_load(base.read_text())
        for dotted, value in (changes or {}).items():
            node = raw
            *parents, last = dotted.split(".")
            for key in parents:
                node = node.setdefault(key, {})
            node[last] = value
        self.address = f"127.0.0.1:{free_port()}"
        raw["server"] = dict(raw.get("server") or {}, address=self.address)
        raw["metrics_port"] = 0
        self.name, self.tag = raw["name"], tag
        self.config = workdir / f"{tag}.yml"
        self.config.write_text(yaml.safe_dump(raw))
        self.log = workdir / f"{tag}.log"
        self.proc = None
        self.start_s = None
        self.args = list(args)  # more CLI arguments (``--timeout-s``)

    def command(self) -> list:
        return [sys.executable, "-m", "starpu_inference_server_tpu_torch.grpc.server",
                "--config", str(self.config), *self.args]

    def start(self) -> "ServerProcess":
        self._wall0 = time.time()
        with open(self.log, "w") as fh:
            self.proc = subprocess.Popen(self.command(), cwd=ROOT, env=child_env(), stdout=fh,
                                         stderr=subprocess.STDOUT)
        return self

    def wait_ready(self, timeout: float = 900) -> str:
        marker = f"serving {self.name} on {self.address}"
        deadline = time.monotonic() + timeout
        while (m := re.search(rf"^\[(\d+):(\d+):([\d.]+)\] .*{re.escape(marker)}",
                              self.log.read_text(), re.M)) is None:
            require(self.proc.poll() is None,
                    f"server {self.tag} exited with {self.proc.returncode} before serving")
            require(time.monotonic() < deadline, f"server {self.tag} not serving in {timeout} s")
            time.sleep(0.25)
        # from the start of the process to its log line (local clock, as the log writes it)
        t0 = time.localtime(self._wall0)
        since_midnight = t0.tm_hour * 3600 + t0.tm_min * 60 + t0.tm_sec + self._wall0 % 1
        served = int(m.group(1)) * 3600 + int(m.group(2)) * 60 + float(m.group(3))
        self.start_s = (served - since_midnight) % 86400
        print(f"server {self.tag} ({self.name}, pid {self.proc.pid}): started from the CLI and "
              f"serving on {self.address} in {self.start_s:.1f} s")
        return self.address

    def stop(self) -> dict:
        """SIGINT (the server's own shutdown), then its kernel launches
        between warmup and shutdown, by kernel, from its log."""
        import signal

        self.proc.send_signal(signal.SIGINT)
        rc = self.proc.wait(timeout=120)
        require(rc == 0, f"server {self.tag} exited with {rc} at shutdown")
        text = self.log.read_text()
        counts = {}
        for when in ("after warmup", "at shutdown"):
            m = re.search(rf"kernel launches {when}: (\{{.*\}})", text)
            require(m is not None, f"server {self.tag}: no 'kernel launches {when}' line")
            counts[when] = json.loads(m.group(1))
        before, after = counts["after warmup"], counts["at shutdown"]
        return {k: v - before.get(k, 0) for k, v in after.items() if v > before.get(k, 0)}

    def kill(self) -> None:
        """Ends the process by its PID if it still runs."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)

    def tail(self, lines: int = 40) -> str:
        return "\n".join(self.log.read_text().splitlines()[-lines:]) if self.log.exists() else ""


def show_logs(servers) -> None:
    for server in servers:
        print(f"server {server.tag} log (last lines):\n{server.tail()}", file=sys.stderr)


def run_client(module: str, args: list, what: str, timeout: float = 600) -> str:
    """``python -m starpu_inference_server_tpu_torch.clients.<module> args``
    as its own process; fails the run when it exits non-zero."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", f"starpu_inference_server_tpu_torch.clients."
                          f"{module}", *args], cwd=ROOT, env=child_env(), capture_output=True,
                         text=True, timeout=timeout)
    if out.returncode != 0:
        print(out.stdout[-4000:], out.stderr[-4000:], sep="\n", file=sys.stderr)
    require(out.returncode == 0, f"{what}: the client exited with {out.returncode}")
    print(f"{what}: client process done in {time.perf_counter() - t0:.1f} s")
    return out.stdout


def replay(target: str, model: str, schedule: Path, summary: Path, what: str) -> dict:
    """The port client with the flags of scripts/run_perf_smoke.sh."""
    run_client("client", ["--target", target, "--model", model, "--input",
                          "input:3x224x224:FP32", "--schedule", str(schedule),
                          "--ready-timeout-s", "900", "--summary-json", str(summary),
                          "--validate"], what, timeout=900)
    return json.loads(summary.read_text())


def _pcts(block: dict) -> str:
    return ", ".join(f"{p} {block[p]:.1f}" for p in ("p50", "p95", "p100"))


def batches_formed(target: str, model: str) -> dict:
    """{batch size: [batches, mean compute ms]} from the server's
    ModelStatistics (every batch since it started)."""
    from starpu_inference_server_tpu_torch.grpc import kserve_v2_pb2 as pb

    status, details, resp = control_call(target, "ModelStatistics",
                                         pb.ModelStatisticsRequest(name=model))
    require(status == "OK", f"ModelStatistics: {status} {details}")
    return {b.batch_size: [b.compute_infer.count,
                           round(b.compute_infer.ns / max(1, b.compute_infer.count) / 1e6, 2)]
            for b in resp.model_stats[0].batch_stats}


def write_params_npz(tree, path: Path) -> int:
    """The flat-key ``.npz`` that ``load_params`` reads ('a/b/c' keys;
    list items under their index); returns its bytes."""
    import numpy as np

    flat = {}

    def rec(node, prefix):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for key, value in items:
            name = f"{prefix}{key}"
            if isinstance(value, (dict, list)):
                rec(value, name + "/")
            else:
                flat[name] = np.asarray(value)

    rec(tree, "")
    np.savez(path, **flat)
    return sum(a.nbytes for a in flat.values())


def one_image_response(target: str, model: str, image) -> bytes:
    """The raw output of one ModelInfer of ``image`` (sent alone)."""
    responses, _, _ = infer_all(target, [make_request(model, {"input": image}, "one")])
    return responses[0].raw_output_contents[0]


def resnet152_checkpoint_phase(workdir: Path, card: str) -> dict:
    """ResNet-152 int8 (ci/perf/resnet152_ci_perf.yml) served from a
    checkpoint of its FP32 tree, under the reference's CI replay. The
    card's machine has no tensorstore (PERF.md §6), so the checkpoint
    is the flat-key ``.npz`` (written here: the package gains no writer);
    the Orbax route is held by tests/test_torch_checkpoint.py."""
    import numpy as np

    from starpu_inference_server_tpu_torch.models.registry import get_family
    from starpu_inference_server_tpu_torch.utils.config import load_config

    cfg = load_config(str(PERF_CONFIG))
    t0 = time.perf_counter()
    tree = get_family(cfg.model.family, cfg.model.options).init_params(
        np.random.default_rng(cfg.seed))
    npz = workdir / "resnet152_fp32.npz"
    nbytes = write_params_npz(tree, npz)
    del tree
    print(f"resnet152 checkpoint: the FP32 tree from seed {cfg.seed} ({nbytes / 1e6:.1f} MB) "
          f"written as {npz.name} in {time.perf_counter() - t0:.1f} s")
    ckpt = ServerProcess(PERF_CONFIG, workdir, "resnet152_checkpoint",
                         {"model.params": str(npz)})
    seeded = ServerProcess(PERF_CONFIG, workdir, "resnet152_seeded")
    servers = [ckpt, seeded]
    try:
        for server in servers:
            server.start()
        for server in servers:
            server.wait_ready()
        smoke = replay(ckpt.address, cfg.name, SMOKE_SCHEDULE, workdir / "smoke.json",
                       "resnet152 CI smoke replay")
        req, val = smoke["requests"], smoke.get("validation", {})
        print(f"resnet152 CI smoke replay ({SMOKE_SCHEDULE.name}) on {card}: requests "
              f"{json.dumps(req)}, validation {json.dumps(val)}, {smoke['throughput_rps']:.1f} "
              f"req/s; roundtrip ms {_pcts(smoke['latency_ms']['roundtrip'])}; server_overall "
              f"ms {_pcts(smoke['latency_ms']['server_overall'])}; batches formed [count, "
              f"mean compute ms] {json.dumps(batches_formed(ckpt.address, cfg.name))}")
        require(req["sent"] == req["handled"] == SMOKE_REQUESTS and req["rejected"] == 0
                and req["errors"] == 0, "resnet152 smoke replay: not every request handled")
        require(val.get("checked") == SMOKE_REQUESTS and val.get("failures") == 0,
                "resnet152 smoke replay: a response failed validation")
        # the reference's gate, with run_perf_smoke.sh's flags; its latency and
        # throughput thresholds were set for another machine, so its verdict
        # is a reading for this card, not a pass condition of the run
        gate = subprocess.run(
            [sys.executable, "scripts/check_perf_summary.py", "--summary",
             str(workdir / "smoke.json"), "--latency-metric", "server_overall",
             "--max-latency-p95-ms", str(MAX_P95_MS), "--min-throughput-rps", str(MIN_RPS),
             "--max-rejected", "0", "--expected-requests", str(SMOKE_REQUESTS)],
            cwd=ROOT, capture_output=True, text=True, timeout=60)
        verdict = (gate.stdout + gate.stderr).strip()
        print(f"check_perf_summary.py on the smoke summary: exit code {gate.returncode}: "
              f"{verdict}")
        print(f"time cut: the CI full replay ({FULL_SCHEDULE.name}, 6300 requests over ~21 s) "
              "is no longer run; the smoke replay and the gate stand")
        image = np.random.default_rng(152).standard_normal((1, 3, 224, 224)).astype(np.float32)
        same = one_image_response(ckpt.address, cfg.name, image) == one_image_response(
            seeded.address, cfg.name, image)
        print(f"resnet152: the checkpointed server's response to one image "
              f"{'equals' if same else 'DIFFERS from'} the seeded server's, bit for bit")
        require(same, "resnet152: the checkpointed server answers unlike the seeded one")
        launches = ckpt.stop()
        seeded.stop()
    except BaseException:
        show_logs(servers)
        raise
    finally:
        for server in servers:
            server.kill()
    print(f"resnet152 server launches over both replays (its log): {json.dumps(launches)}")
    require(launches.get("int8_matmul", 0) > 0, "resnet152: int8_matmul (fc) was not launched")
    require("fused_stem" not in launches, "resnet152: fused_stem ran without stem_fused")
    return {"launches": launches, "servers": servers, "smoke": smoke, "gate_rc": gate.returncode}


def _generation(target: str, prompt, stream: bool):
    """Tokens of one direct generation call (ModelStreamInfer or ModelInfer)."""
    import grpc
    import numpy as np

    from starpu_inference_server_tpu_torch.grpc import kserve_v2_pb2 as pb

    req = pb.ModelInferRequest(model_name="llama", id="direct")
    t = req.inputs.add()
    t.name, t.datatype = "input_ids", "INT64"
    t.shape.extend([1, len(prompt)])
    req.raw_input_contents.append(np.asarray(prompt, np.int64).tobytes())
    req.parameters["max_new_tokens"].int64_param = GEN_TOKENS

    async def go():
        async with grpc.aio.insecure_channel(target) as channel:
            if not stream:
                call = channel.unary_unary(
                    "/inference.GRPCInferenceService/ModelInfer",
                    request_serializer=pb.ModelInferRequest.SerializeToString,
                    response_deserializer=pb.ModelInferResponse.FromString)
                resp = await call(req, timeout=600)
                return np.frombuffer(resp.raw_output_contents[0], np.int32).tolist()
            call = channel.stream_stream(
                "/inference.GRPCInferenceService/ModelStreamInfer",
                request_serializer=pb.ModelInferRequest.SerializeToString,
                response_deserializer=pb.ModelStreamInferResponse.FromString)
            tokens = []
            async for msg in call(iter([req]), timeout=600):
                require(not msg.error_message, f"stream error: {msg.error_message}")
                tokens += np.frombuffer(msg.infer_response.raw_output_contents[0],
                                        np.int32).tolist()
            return tokens

    return asyncio.run(go())


def generation_client_phase(server: ServerProcess, workdir: Path, card: str) -> dict:
    """configs/llama_decoder.yml (llama-1b int4, 128 slots) from the CLI,
    driven by the port's GenerationClient as its own process: unary first
    (``GEN_UNARY_REQUESTS`` requests of 32 tokens at that concurrency; it
    pays for the decode graph's capture), then streaming (128 at
    concurrency 128, time to first token); then one direct unary and one
    streaming call for each pooled prompt, equal."""
    from starpu_inference_server_tpu_torch.clients.client import pooled_prompts

    target = server.wait_ready()
    runs = {}
    print(f"time cut: the generation client's unary run at {GEN_UNARY_REQUESTS} requests "
          f"(formerly {GEN_REQUESTS}); the streaming run keeps {GEN_REQUESTS}")
    for mode, n in (("unary", GEN_UNARY_REQUESTS), ("stream", GEN_REQUESTS)):
        path = workdir / f"generate_{mode}.json"
        run_client("client", ["--target", target, "--model", "llama", "--generate",
                              str(GEN_TOKENS), "--prompt-len", str(GEN_PROMPT),
                              "--request-number", str(n), "--concurrency", str(n),
                              "--summary-json", str(path),
                              *(["--stream"] if mode == "stream" else [])],
                   f"generation client ({mode})")
        s = runs[mode] = json.loads(path.read_text())
        req, gen = s["requests"], s["generation"]
        print(f"generation client ({mode}, {n} requests of {GEN_TOKENS} tokens, prompts of "
              f"{GEN_PROMPT}, concurrency {n}) on {card}: requests {json.dumps(req)}; "
              f"{gen['tokens_total']} tokens, {gen['tokens_per_s']:.1f} tok/s, "
              f"{s['throughput_rps']:.2f} req/s over {s['elapsed_s']:.2f} s; roundtrip ms "
              f"{_pcts(s['latency_ms']['roundtrip'])}"
              + (f"; TTFT ms {_pcts(gen['ttft_ms'])}" if "ttft_ms" in gen else ""))
        require(req["sent"] == req["handled"] == n and req["rejected"] == 0
                and req["errors"] == 0, f"generation client ({mode}): not every request handled")
        require(gen["tokens_total"] == n * GEN_TOKENS,
                f"generation client ({mode}): {gen['tokens_total']} tokens")
        require(("ttft_ms" in gen) == (mode == "stream"), f"generation ({mode}): TTFT field")
    # the client's defaults: vocab 32000, seed 7, no shared prefix
    for i, prompt in enumerate(pooled_prompts(GEN_PROMPT)):
        unary, streamed = _generation(target, prompt, False), _generation(target, prompt, True)
        require(len(unary) == GEN_TOKENS and streamed == unary,
                f"pooled prompt {i}: the stream's tokens differ from the unary response's")
    print(f"generation: for each of the client's {len(pooled_prompts(GEN_PROMPT))} pooled "
          f"prompts, a direct stream's {GEN_TOKENS} tokens equal the unary response's")
    return runs


def bert_client_phase(server: ServerProcess, card: str) -> str:
    """The BERT client (s = 512, two texts) against configs/bert_long.yml at
    FP32, unquantized, seed 42, with ``--validate``: its reference model is
    built on the card."""
    target = server.wait_ready()
    args = ["--target", target, "--model", server.name, "--seq-len", "512", "--validate"]
    for text in BERT_TEXTS:
        args += ["--text", text]
    out = run_client("bert_client", args, "bert client")
    print(f"bert client on {card}:\n" + "\n".join(f"  {line}" for line in out.splitlines()))
    require("reference validation: OK" in out, "bert client: the reference validation failed")
    return out


def clients_path(card: str) -> dict:
    """The group "clients and checkpoints": every server started from the
    CLI as its own process (a fresh port, ``metrics_port: 0``), killed by
    its PID in a ``finally``, its log printed if it fails; every client its
    own process. Launches are read from each server's log."""
    import tempfile

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        workdir = Path(tmp)
        resnet = resnet152_checkpoint_phase(workdir, card)
        print(f"time cut: the clients' llama_decoder.yml server at {CLIENT_LAYERS} of 16 layers "
              f"(formerly 16)")
        llama = ServerProcess(CONFIG, workdir, "llama_decoder",
                              {"model.options.layers": CLIENT_LAYERS})
        bert = ServerProcess(BERT_CONFIG, workdir, "bert_long_fp32",
                             {"model.quantization": "none", "model.compute_dtype": "FP32",
                              "seed": 42})
        servers = [llama, bert]
        try:
            for server in servers:  # both start together; the BERT server waits its turn
                server.start()
            generation = generation_client_phase(llama, workdir, card)
            gen_launches = llama.stop()
            bert_client_phase(bert, card)
            bert_launches = bert.stop()
        except BaseException:
            show_logs(servers)
            raise
        finally:
            for server in servers:
                server.kill()
    print(f"llama_decoder server launches over both client runs and the direct calls (its "
          f"log): {json.dumps(gen_launches)}")
    for name in ("int4_matmul", "decode_attention", "causal_attention"):
        require(gen_launches.get(name, 0) > 0, f"generation: {name} was not launched")
    print(f"bert_long server launches (its log): {json.dumps(bert_launches)}")
    require(bert_launches.get("bidirectional_attention", 0) > 0,
            "bert client: bidirectional_attention was not launched at s = 512")
    return {"resnet": resnet, "generation": generation, "gen_launches": gen_launches,
            "bert_launches": bert_launches,
            "start_s": {s.tag: round(s.start_s, 1) for s in resnet["servers"] + servers}}


PIPE_CONFIG = ROOT / "configs" / "llama_pipelined.yml"
PIPE_LAYERS = 4        # llama-7b cut from 32 layers to 4 (1 a stage) for the run's time limit
PIPE_REQUESTS, PIPE_TOKENS, PIPE_PROMPT = 16, 32, 64
PIPE_KERNELS = ("int8_matmul", "decode_attention", "chunk_prefill_attention",
                "window_decode_attention")
# llama-tiny / moe-tiny at their registered widths (head_dim 32), int8, FP32
TINY_PIPE = {"num_slots": 4, "max_len": 256, "prefill_buckets": [64], "steps_per_sync": 4,
             "pipe_microgroups": 2}
PIPE_WORLDS = {
    "pipe2_model2_llama": {"axes": {"pipe": 2, "model": 2}, "family": "llama-tiny"},
    "pipe2_expert2_moe": {"axes": {"pipe": 2, "expert": 2}, "family": "moe-tiny"},
    "pipe2_lookup_llama": {"axes": {"pipe": 2}, "family": "llama-tiny", "lookup": 2},
}


def _pipe_cache(g, dev, layers, slots, t, hkv, d):
    """A stage's stacked int8 cache [L, S, T, Hkv, D] (K, V) and its f32
    scales [L, S, T, Hkv], random: the attention kernels read views of it
    as the stage programs do."""
    import torch

    kv = [torch.randint(-127, 128, (layers, slots, t, hkv, d), device=dev, generator=g,
                        dtype=torch.int8) for _ in range(2)]
    return (kv[0], kv[1], torch.rand(layers, slots, t, hkv, device=dev, generator=g) * 0.03 + 0.05,
            torch.rand(layers, slots, t, hkv, device=dev, generator=g) / 127 + 1e-3)


def _pipe_window_entry(g, dev, dtype, cache, groups, w, hq, rep, label, card):
    """decode_attention (``w`` = 0) or window_decode_attention (``w`` > 0)
    on the row-sliced views ``cache[li][rows]`` a stage passes them (one
    per layer and microgroup, cycled when timed), G = S / ``groups``
    slots of mixed lengths including 0 and the last position; held
    against the plain version at the attention tolerance and timed beside
    it, SDPA on the dequantized rows and the bound."""
    import torch
    import torch.nn.functional as F

    from starpu_inference_server_tpu_torch.ops import decode_attention as da

    kc, vc, ks, vs = cache
    layers, slots, t, hkv, d = kc.shape
    s = slots // groups
    views = [tuple(a[li][mb * s:(mb + 1) * s] for a in cache)
             for li in range(layers) for mb in range(groups)]
    wn = max(w, 1)
    lens = torch.randint(0, t - wn + 1, (s,), device=dev, generator=g, dtype=torch.int32)
    lens[0], lens[-1] = 0, t - wn
    if w:
        q = torch.randn(s, w, hq, d, device=dev, generator=g).to(dtype)
        kern, plain, name = da.window_decode_attention, da.window_decode_attention_plain, \
            "window_decode_attention"
    else:
        q = torch.randn(s, hq, d, device=dev, generator=g).to(dtype)
        kern, plain, name = da.decode_attention, da.decode_attention_plain, "decode_attention"
    got = kern(q, *views[0], lens, rep)
    shape = f"S={s} W={wn} T={t} Hkv={hkv} rep={rep} D={d} q {str(dtype)[6:]}"
    err = attn_check(f"{name} {shape} ({label}, a view of the stacked cache)", got,
                     plain(q, *views[0], lens, rep))
    require(torch.equal(got, kern(q, *views[0], lens, rep)),
            f"{name} {label} gave other bits on a second call")
    ms = _time_cycled(lambda i: kern(q, *views[i], lens, rep), len(views))
    plain_ms = _time_cycled(lambda i: plain(q, *views[i], lens, rep), len(views), iters=3)
    last = lens.to(torch.int64)[:, None] + torch.arange(wn, device=dev)[None, :]
    mask = torch.arange(t, device=dev)[None, None, :] <= last[:, :, None]       # [S, W, T]
    deq = [((k.float() * a[..., None]).to(dtype).transpose(1, 2),
            (v.float() * b[..., None]).to(dtype).transpose(1, 2))
           for k, v, a, b in views[:min(len(views), _copies(2 * s * t * hkv * d * 2))]]
    qt = (q if w else q[:, None]).transpose(1, 2)
    lib_ms = _time_cycled(lambda i: F.scaled_dot_product_attention(
        qt, *deq[i], attn_mask=mask[:, None], enable_gqa=True), len(deq))
    live = (lens.to(torch.int64) + wn).sum().item()
    attended = (last + 1).sum().item()
    nbytes = 2 * s * wn * hq * d * q.element_size() + live * hkv * (2 * d + 8) + 4 * s
    b_ms, b_by = bound_ms(nbytes, 4.0 * attended * hq * d)
    print(f"time {name} {shape} ({label}) on {card}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); {len(views)} views cycled")
    return name, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                      library_ms=lib_ms, shape=f"{shape} live={live}", path=label,
                      copies=len(views))


def _pipe_chunk_entries(g, dev, dtype, cache, bucket, c, hq, rep, label, card) -> list:
    """chunk_prefill_attention at every chunk start of a ``bucket``-row
    prompt, on the row view ``cache[li][slot]`` a stage
    passes it (cycled over layers and slots when timed); held against the
    plain version and timed beside it, SDPA on the dequantized past plus
    the chunk, and the bound."""
    import torch
    import torch.nn.functional as F

    from starpu_inference_server_tpu_torch.ops import prefill_attention as pa

    kc, vc, ks, vs = cache
    layers, slots, t, hkv, d = kc.shape
    views = [tuple(a[li][slot] for a in cache) for li in range(layers) for slot in range(slots)]
    out = []
    for start in range(0, bucket, c):
        q = (3 * torch.randn(c, hq, d, device=dev, generator=g)).to(dtype)
        kcur = torch.randn(c, hkv, d, device=dev, generator=g).to(dtype)
        vcur = torch.randn(c, hkv, d, device=dev, generator=g).to(dtype)

        def args(i):
            return (q, *views[i], kcur, vcur, start, rep)

        got = pa.chunk_prefill_attention(*args(0), out_dtype=dtype)
        shape = f"C={c} start={start} T={t} Hkv={hkv} rep={rep} D={d} q {str(dtype)[6:]}"
        err = attn_check(f"chunk_prefill_attention {shape} ({label}, a row view of the stacked "
                         "cache)", got, pa.chunk_prefill_attention_plain(*args(0), out_dtype=dtype))
        require(torch.equal(got, pa.chunk_prefill_attention(*args(0), out_dtype=dtype)),
                f"chunk_prefill_attention {label} start={start} gave other bits on a second call")
        ms = _time_cycled(lambda i: pa.chunk_prefill_attention(*args(i), out_dtype=dtype),
                          len(views))
        plain_ms = time_ms(lambda: pa.chunk_prefill_attention_plain(*args(0), out_dtype=dtype),
                           iters=5)
        k_row, v_row, k_s, v_s = views[0]
        kd = torch.cat([(k_row[:start].float() * k_s[:start, :, None]).to(dtype), kcur])
        vd = torch.cat([(v_row[:start].float() * v_s[:start, :, None]).to(dtype), vcur])
        mask = torch.arange(start + c, device=dev)[None, :] <= \
            (start + torch.arange(c, device=dev))[:, None]
        qt, kd, vd = q.transpose(0, 1)[None], kd.transpose(0, 1)[None], vd.transpose(0, 1)[None]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask,
                                                                enable_gqa=True))
        nbytes = 2 * c * hq * d * q.element_size() + start * hkv * (2 * d + 8) + \
            2 * c * hkv * d * q.element_size()
        b_ms, b_by = bound_ms(nbytes, 4.0 * hq * d * (c * start + c * (c + 1) / 2))
        print(f"time chunk_prefill_attention {shape} ({label}) on {card}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        out.append(dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms, shape=shape, path=label,
                        copies=len(views)))
    return out


def pipelined_kernel_rows(dev, card) -> tuple:
    """K2, K3, K4 and K9 at the shapes the pipelined paths give them inside
    a stage, each held against its plain version and timed. Returns the
    entries for the kernels' per_shape lists, tagged with their path, and
    K2's ms in a llama_pipelined stage's decode step:

    - llama_pipelined (llama-7b, BF16, 4 stages of ``PIPE_LAYERS`` / 4
      layers, 16 slots in 4 microgroups, T = 1024, prompts of
      ``PIPE_PROMPT`` in chunks of 16): K2 at M = 4 (a decode microgroup)
      and 16 (a prefill chunk; the lm head over every slot) on each dense
      layer and the lm head, and the lm head at M = 1 (a prefill's last
      row); K3 at S = 4, Hkv = 32, rep 1 on ``cache[li][rows]``; K4 at C =
      16 on ``cache[li][slot]`` at starts 0-48;
    - the tiny worlds (llama-tiny at its registered widths, FP32, 4 slots
      in 2 microgroups, T = 256, chunks of 32): pipe2_model2's
      tensor-parallel shard (K2 on each dense shard at M = 2 and 32 and
      the lm head's vocab shard at 4 and 1, K3 at 2 of 4 kv heads, K4);
      pipe2_lookup's K9 at S = 2, W = 4 (speculate_k 3 + 1);
    - the multi-host group's pipe world (llama_pipelined at pipe=2 x
      model=2, a stage a launcher: BF16, 2 stages of ``PIPE_LAYERS`` / 2
      layers, 16 slots in 4 microgroups, T = 1024, prompts of
      ``PIPE_PROMPT`` in chunks of 32): a rank's tensor-parallel shard,
      K2 on each dense shard at M = 4 (a decode microgroup) and 32 (a
      prefill chunk) and the lm head's vocab shard at M = 16 (the head over
      every slot), 1 (a prefill's last row) and 4; K3 at S = 4, 16 of 32
      kv heads, rep 1; K4 at C = 32 on 16 heads, starts 0 and 32."""
    import torch

    from starpu_inference_server_tpu_torch.models.decoder import get_spec

    g = torch.Generator(device=dev).manual_seed(1313)
    out = {name: [] for name in PIPE_KERNELS}
    stages = 4
    tiny_bucket = TINY_PIPE["prefill_buckets"][0]
    for family, dtype, tp, slots, groups, t, bucket, c, layers, label in (
            ("llama-7b", torch.bfloat16, 1, 16, 4, 1024, PIPE_PROMPT, PIPE_PROMPT // stages,
             PIPE_LAYERS // stages, "llama_pipelined"),
            ("llama-tiny", torch.float32, 2, 4, 2, 256, tiny_bucket, tiny_bucket // 2, 2,
             "pipe2_model2_llama"),
            ("llama-7b", torch.bfloat16, 2, 16, 4, 1024, PIPE_PROMPT, PIPE_PROMPT // 2,
             PIPE_LAYERS // 2, "multihost_pipe2_model2")):
        spec = get_spec(family, {})
        hq, hkv, d = spec.q_heads // tp, spec.kv_heads // tp, spec.head_dim
        h, inter, g_rows = spec.hidden, spec.intermediate // tp, slots // groups
        dense = {"qkv": (h, (hq + 2 * hkv) * d), "o": (hq * d, h), "gate_up": (h, 2 * inter),
                 "down": (inter, h)}
        cases = [(n, m, *kn) for m in (g_rows, c) for n, kn in dense.items()]
        cases += [("lm_head", m, h, spec.vocab // tp) for m in (slots, 1)]
        if family == "llama-7b":
            cases.append(("lm_head", g_rows, h, spec.vocab // tp))
        for name, m, k, n in cases:
            out["int8_matmul"].append(dict(
                k2_entry(g, dev, dtype, m, k, n, f"{label} {name}", card), layer=f"{label} {name}",
                m=m, path=label))
        cache = _pipe_cache(g, dev, layers, slots, t, hkv, d)
        out["decode_attention"].append(
            _pipe_window_entry(g, dev, dtype, cache, groups, 0, hq, hq // hkv, label, card)[1])
        out["chunk_prefill_attention"] += _pipe_chunk_entries(g, dev, dtype, cache, bucket, c,
                                                              hq, hq // hkv, label, card)
        del cache
    spec = get_spec("llama-tiny", {})
    cache = _pipe_cache(g, dev, 2, 4, 256, spec.kv_heads, spec.head_dim)
    out["window_decode_attention"].append(_pipe_window_entry(
        g, dev, torch.float32, cache, 2, 4, spec.q_heads, spec.rep, "pipe2_lookup_llama",
        card)[1])
    # K2's device time in a llama_pipelined stage's decode step: its layers'
    # four shapes in every microgroup, and stage 0's lm head over 16 slots
    at = {e["layer"]: e["ms"] for e in out["int8_matmul"] if e["path"] == "llama_pipelined"
          and e["m"] == 4}
    head = next(e["ms"] for e in out["int8_matmul"]
                if e["layer"] == "llama_pipelined lm_head" and e["m"] == 16)
    step = (PIPE_LAYERS // stages) * 4 * sum(at[f"llama_pipelined {n}"]
                                             for n in ("qkv", "o", "gate_up", "down"))
    print(f"int8_matmul per llama_pipelined stage decode step ({PIPE_LAYERS // stages} layers x "
          f"4 microgroups at M=4) on {card}: {step:.4f} ms, stage 0's lm head at M=16 "
          f"{head:.4f} ms")
    return out, {"layers": step, "lm_head": head}


def pipe_world(rank, world, init_method, payload):
    """One rank of a tiny pipelined engine on the card (``run_world``): the
    same seeded int8 tree on every rank, cut to the rank's shard by the
    engine; rank 0 serves the prompts greedily, gathers every rank's
    kernel launches and collectives, then runs the single-device engine
    of the same tree with one microgroup's slots and ``prefill_chunk`` =
    bucket / stages. Returns both streams (rank 0) and the backend."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.models.decoder import get_spec, init_params
    from starpu_inference_server_tpu_torch.ops.quant import maybe_quantize_tree
    from starpu_inference_server_tpu_torch.parallel.launch import follow, join_mesh
    from starpu_inference_server_tpu_torch.parallel.mesh import MeshAxes
    from starpu_inference_server_tpu_torch.serving.generation import (
        GenerationEngine,
        GenerationRequest,
    )
    from starpu_inference_server_tpu_torch.weights import params_from_numpy

    mesh = join_mesh(MeshAxes(**payload["axes"]), rank, world, init_method,
                     payload.get("device", "cuda"), timeout_s=300.0)
    spec = get_spec(payload["family"], {})
    tree = maybe_quantize_tree(params_from_numpy(init_params(spec, np.random.default_rng(0)),
                                                 mesh.device), 8)
    lookup = {"prompt_lookup_ngram": payload["lookup"], "speculate_k": 3} \
        if payload.get("lookup") else {}
    opts = dict(TINY_PIPE)
    microgroups = opts.pop("pipe_microgroups")
    eng = GenerationEngine(spec, tree, dtype=torch.float32, mesh=mesh, family=payload["family"],
                           pipe_microgroups=microgroups, **opts, **lookup)
    if rank != 0:
        follow(eng.pipe)
        return {"backend": mesh.backend}

    def run(engine):
        reqs = [GenerationRequest(prompt_ids=np.asarray(p, np.int32), max_new_tokens=24)
                for p in payload["prompts"]]
        for r in reqs:
            engine.submit(r)
        engine.start()
        try:
            return [r.result(timeout=300.0) for r in reqs]
        finally:
            engine.stop()

    try:
        eng.pipe.reset_stats()
        got = run(eng)
        stats = eng.pipe.gather_stats()
    finally:
        eng.pipe.stop_followers()
    del eng
    bucket = opts["prefill_buckets"][0]
    ref = GenerationEngine(spec, tree, dtype=torch.float32, family=payload["family"],
                           device=mesh.device, **dict(
                               opts, num_slots=opts["num_slots"] // microgroups,
                               prefill_chunk=bucket // payload["axes"]["pipe"]), **lookup)
    return {"backend": mesh.backend, "tokens": got, "ref": run(ref), "stats": stats}


def step0_start(workdir: Path) -> tuple:
    """scripts/torch_gloo_probe.py as its own process (two-rank worlds on
    this card: which gloo operations take CUDA tensors, and nccl with two
    ranks on one device)."""
    out = workdir / "gloo_probe.json"
    proc = subprocess.Popen([sys.executable, str(ROOT / "scripts" / "torch_gloo_probe.py"),
                             "--out", str(out)], cwd=ROOT, env=child_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def step0_check(proc, out: Path, card: str) -> dict:
    text, _ = proc.communicate(timeout=600)
    require(proc.returncode == 0 and out.exists(), f"step 0 probe failed:\n{text[-2000:]}")
    report = json.loads(out.read_text())
    cases = report["cases"]
    ok = {op: all(r.get("ok") for r in cases[op]) for op in cases if op not in ("nccl",
                                                                               "timing")}
    print(f"step 0 on {card}: torch.distributed.is_nccl_available() = "
          f"{report['nccl_available']}; gloo on CUDA tensors, two ranks on one card: "
          f"{json.dumps(ok)}")
    print(f"step 0 timing (ms a call, host clock): {json.dumps(cases['timing'][0].get('timing'))}")
    nccl = " ".join(str(r.get("error", r)) for r in cases["nccl"])
    print(f"step 0: nccl with two ranks on cuda:0: {nccl[:300]}")
    # parallel/collectives.py runs these on CUDA tensors and stages only the hops
    for op in ("all_reduce", "broadcast", "all_gather"):
        require(ok.get(op), f"step 0: gloo {op} on CUDA tensors failed on this card")
    require(not any(r.get("ok") for r in cases["nccl"]),
            "step 0: nccl ran two ranks on one device; the backend rule assumes it cannot")
    return {"gloo_cuda": ok, "nccl_same_device": nccl[:200]}


def _gen_client(target: str, model: str, stream: bool) -> tuple:
    """The port's generation client in this process: PIPE_REQUESTS greedy
    requests of PIPE_TOKENS at that concurrency. Returns (summary, tokens
    by request id, the pooled prompts)."""
    from starpu_inference_server_tpu_torch.clients.client import GenerationClient

    async def go():
        gen = GenerationClient(target, model, prompt_len=PIPE_PROMPT, max_new_tokens=PIPE_TOKENS)
        elapsed = await gen.run(PIPE_REQUESTS, PIPE_REQUESTS, stream)
        await gen.close()
        return gen.summary(elapsed), gen.tokens_by_request, gen.prompts

    return asyncio.run(go())


def _mesh_stats(server: "ServerProcess") -> dict:
    """A pipelined server's ``mesh statistics`` log lines (every rank's
    kernel launches and collectives, rank 0's steps and loop timers)."""
    text = server.log.read_text()
    out = {}
    for when in ("after warmup", "at shutdown"):
        m = re.search(rf"mesh statistics {when}: (\{{.*\}})", text)
        require(m is not None, f"server {server.tag}: no 'mesh statistics {when}' line")
        out[when] = json.loads(m.group(1))
    return out


def _rank_launches(before: dict, after: dict) -> list:
    """Per rank, the kernel launches between two mesh statistics lines."""
    return [{k: v - b["launches"].get(k, 0) for k, v in a["launches"].items()
             if v > b["launches"].get(k, 0)} for b, a in zip(before["ranks"], after["ranks"])]


def pipelined_server_run(server: "ServerProcess", layers: int, card: str) -> dict:
    """configs/llama_pipelined.yml cut to ``layers``, served by ``server``
    (started from the CLI, still loading), against the single-device
    engine of the same weights in this process: the config on one device
    (16 slots; tok/s, TTFT) and the chunked engine (one microgroup's 4
    slots, ``prefill_chunk`` = prompt / stages, so its kernel calls have a
    stage's shapes) whose streams every pipelined stream must equal, then
    the generation client on ``server``, streaming and unary. Stops the
    server and reads its ``mesh statistics`` lines. Prints and returns
    the numbers, every rank's launches and collectives over the client
    runs, and the backend from the server's ``mesh backend:`` line."""
    import dataclasses as dc

    import torch

    from starpu_inference_server_tpu_torch.models.registry import build_model
    from starpu_inference_server_tpu_torch.parallel.census import collectives_by_axis
    from starpu_inference_server_tpu_torch.serving.generation import build_generation_engine
    from starpu_inference_server_tpu_torch.utils.config import DeviceSettings, load_config

    cfg = load_config(str(PIPE_CONFIG))
    opts = dict(cfg.model.options, layers=layers)
    single = dc.replace(cfg, devices=DeviceSettings(), metrics_port=0,
                        model=dc.replace(cfg.model, options=opts))
    t0 = time.perf_counter()
    tree = build_model(single.model, seed=single.seed, device="cuda").params
    tree_s = time.perf_counter() - t0
    chunked = dc.replace(single, model=dc.replace(single.model, options=dict(
        opts, num_slots=opts["num_slots"] // opts["pipe_microgroups"],
        prefill_chunk=PIPE_PROMPT // cfg.devices.mesh.pipe)))
    ref_engine = build_generation_engine(chunked, device="cuda", params=tree)
    local = LocalServer(single, params=tree)
    single_run, _, pool = _gen_client(local.start(), cfg.name, True)
    local.stop()
    ref_engine.start()
    try:
        ref = [ref_engine.generate(p, PIPE_TOKENS, timeout=600.0) for p in pool]
    finally:
        ref_engine.stop()
    del ref_engine, local, tree
    torch.cuda.empty_cache()
    target = server.wait_ready(timeout=900)
    runs = {}
    for mode in ("stream",):
        summary, tokens, _ = _gen_client(target, cfg.name, mode == "stream")
        runs[mode] = summary
        req = summary["requests"]
        require(req["handled"] == PIPE_REQUESTS and req["errors"] == 0,
                f"llama_pipelined ({mode}): {json.dumps(req)}")
        for rid, toks in tokens.items():
            require(toks == ref[rid % len(pool)],
                    f"llama_pipelined ({mode}): request {rid}'s stream differs from the "
                    "single-device engine's")
    server_launches = server.stop()
    stats = _mesh_stats(server)
    backend = re.search(r"mesh backend: (\w+)", server.log.read_text())
    require(backend is not None, "llama_pipelined: the server printed no backend line")
    before, after = stats["after warmup"], stats["at shutdown"]
    steps = after["steps"] - before["steps"]
    timers = {k: after["loop_timers"][k] - before["loop_timers"][k]
              for k in after["loop_timers"]}
    # collectives over the client runs: calls and host ms, by rank (a
    # follower's "broadcast/control" time is its wait for the next
    # command, so the mesh axes' collectives alone are reported)
    calls = [{k: v - b["collectives"]["calls"].get(k, 0) for k, v in a["collectives"]["calls"].items()}
             for b, a in zip(before["ranks"], after["ranks"])]
    coll = [{k: round(v - b["collectives"]["ms"].get(k, 0.0), 1)
             for k, v in a["collectives"]["ms"].items() if not k.endswith("/control")}
            for b, a in zip(before["ranks"], after["ranks"])]
    per_rank = _rank_launches(before, after)
    census = [collectives_by_axis({"calls": c}) for c in calls]
    s, p = single_run["generation"], runs["stream"]["generation"]
    print(f"mesh backend: {backend.group(1)}")
    print(f"llama_pipelined ({cfg.model.family} x {layers} layers, 4 ranks on {card}, "
          f"{backend.group(1)}): started in {server.start_s:.1f} s; {PIPE_REQUESTS} greedy "
          f"requests of {PIPE_TOKENS} tokens (prompts of {PIPE_PROMPT}), streams equal to the "
          f"single-device engine's; stream {p['tokens_per_s']:.1f} tok/s, TTFT ms "
          f"{_pcts(p['ttft_ms'])}; single-device (16 slots, same tree, built in {tree_s:.1f} s) "
          f"{s['tokens_per_s']:.1f} tok/s, TTFT ms {_pcts(s['ttft_ms'])}")
    print(f"llama_pipelined: {steps} decode steps, rank 0's loop host seconds "
          f"{json.dumps({k: round(v, 3) for k, v in timers.items()})}, "
          f"{1e3 * timers['step'] / max(steps, 1):.2f} ms a step (dispatch + consume)")
    print(f"llama_pipelined collectives by rank over the client runs (census): "
          f"{json.dumps(census)}; host ms in them: {json.dumps(coll)}")
    print(f"llama_pipelined launches by rank over the client runs: {json.dumps(per_rank)}; "
          f"rank 0's log: {json.dumps(server_launches)}")
    return dict(backend=backend.group(1), per_rank=per_rank, steps=steps, timers=timers,
                calls=calls, coll_ms=coll, pipelined=runs, single=single_run,
                start_s=server.start_s)


def pipelined_path(card: str) -> dict:
    """configs/llama_pipelined.yml from the CLI as 4 rank processes sharing
    this card (gloo; llama-7b at full width, cut to ``PIPE_LAYERS``
    layers), against the single-device engine of the same weights in this
    process (``pipelined_server_run``); the tiny pipe x model, pipe x
    expert and prompt-lookup engines; a killed rank; step 0. Returns the
    launches and numbers."""
    import os
    import signal
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from starpu_inference_server_tpu_torch.parallel.launch import run_world

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    result = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        workdir = Path(tmp)
        probe = step0_start(workdir)
        server = ServerProcess(PIPE_CONFIG, workdir, "llama_pipelined",
                               {"model.options.layers": PIPE_LAYERS})
        tiny_opts = dict(TINY_PIPE, layers=4)
        killed = ServerProcess(PIPE_CONFIG, workdir, "pipe2_killed", {
            "model.family": "llama-tiny", "model.compute_dtype": "FP32",
            "model.options": tiny_opts, "devices.mesh": {"pipe": 2},
            "inputs": [{"name": "input_ids", "dims": [64], "dtype": "INT64"}],
            "outputs": [{"name": "logits", "dims": [64, 2048], "dtype": "FP32"}]})
        servers = [server, killed]
        print(f"time cut: llama_pipelined at {PIPE_LAYERS} of 32 layers (formerly 8), one "
              "streaming client run (formerly also a unary one)")
        try:
            for srv in servers:
                srv.start()
            # the tiny worlds, all at once, while the server builds
            rng = np.random.default_rng(11)
            prompts = [rng.integers(1, 2048, (n,)).tolist() for n in (40, 64, 33, 57, 48, 61)]
            prompts[2] = (prompts[2][:11] * 3)[:33]  # repetition for the lookup drafts
            worlds = {}

            def size_of(w):
                return w["axes"].get("pipe", 1) * w["axes"].get("model", 1) * \
                    w["axes"].get("expert", 1)

            def tiny(name, w):
                t1 = time.perf_counter()
                ranks = run_world("chip_smoke:pipe_world", size_of(w), dict(w, prompts=prompts),
                                  timeout_s=600.0, workdir=str(workdir / name))
                return ranks, round(time.perf_counter() - t1, 1)

            with ThreadPoolExecutor(len(PIPE_WORLDS)) as pool:
                runs = {name: pool.submit(tiny, name, w) for name, w in PIPE_WORLDS.items()}
                runs = {name: run.result() for name, run in runs.items()}
            for name, w in PIPE_WORLDS.items():
                size = size_of(w)
                ranks, took = runs[name]
                r0 = ranks[0]
                require(all(r["backend"] == "gloo" for r in ranks),
                        f"{name}: backend {[r['backend'] for r in ranks]}")
                require(r0["tokens"] == r0["ref"],
                        f"{name}: pipelined streams differ from the single-device engine's")
                launches = [st["launches"] for st in r0["stats"]]
                kernels = ("window_decode_attention",) if w.get("lookup") else \
                    ("int8_matmul", "decode_attention", "chunk_prefill_attention")
                for kname in kernels + ("int8_matmul", "chunk_prefill_attention"):
                    require(all(la.get(kname, 0) > 0 for la in launches),
                            f"{name}: {kname} not launched on every rank: {launches}")
                worlds[name] = {"launches": launches, "s": took,
                                "collectives": [st["collectives"] for st in r0["stats"]]}
                print(f"{name} ({size} ranks on {card}, gloo, FP32 int8, the three worlds at "
                      f"once): streams of {len(prompts)} greedy requests equal to the "
                      f"single-device engine's; launches by rank {json.dumps(launches)}; "
                      f"{worlds[name]['s']} s")
            result["worlds"] = worlds
            result.update(pipelined_server_run(server, PIPE_LAYERS, card))
            for kname in PIPE_KERNELS[:3]:
                require(all(la.get(kname, 0) > 0 for la in result["per_rank"]),
                        f"llama_pipelined: {kname} not launched on every rank: "
                        f"{result['per_rank']}")
            require(result["backend"] == "gloo",
                    f"llama_pipelined: backend {result['backend']} with 4 ranks on one card")
            # a killed rank fails the server
            killed.wait_ready(timeout=600)
            pid = int(re.search(r"rank 1 pid (\d+)", killed.log.read_text()).group(1))
            os.kill(pid, signal.SIGKILL)
            t1 = time.perf_counter()
            rc = killed.proc.wait(timeout=120)
            require(rc != 0, "pipe2_killed: the server exited 0 after a rank was killed")
            print(f"pipe2_killed: rank 1 (pid {pid}) killed; the server exited with {rc} in "
                  f"{time.perf_counter() - t1:.1f} s")
            result["step0"] = step0_check(*probe, card)
        except BaseException:
            show_logs(servers)
            raise
        finally:
            for srv in servers:
                srv.kill()
            if probe[0].poll() is None:
                probe[0].kill()
    return result


# -- the GSPMD group: meshes without a pipe axis --------------------------------

GSPMD_MESH = {"data": 2, "model": 2}   # the CLI servers' mesh
# llama_decoder.yml and llama_w4a8.yml (llama-1b) cut from 16 layers to 4
# at full width in the GSPMD group (its rank world and CLI server) and the
# multi-host group's CLI launchers, for the run's time limit
GSPMD_LAYERS = 4
GSPMD_REQUESTS, GSPMD_TOKENS, GSPMD_PROMPT = 32, 32, 64
GSPMD_BERT_REQUESTS = 64
DATA4_REQUESTS, DATA4_LONG = 32, 300  # the data=4 world: 32 slots a group, 8 long prompts
SEQ_T = 2048                            # the sequence-parallel forward's length
# bf16 logits of a tensor-parallel (or sequence-parallel, pipelined) mesh
# against one device: max |mesh - one device| <= this x max |one device|
# (the sums and the attention's splits run in another order; set before
# the first card reading from the pipe x model tiny worlds' 5.5e-2 at
# logits of magnitude ~1)
GSPMD_LOGITS_TOL = 5e-2
GSPMD_KERNELS = ("int4_matmul", "decode_attention", "chunk_prefill_attention",
                 "causal_attention", "int8_matmul", "bidirectional_attention", "fused_stem",
                 "int4_matmul_w4a8")


def _k1_entry(g, dev, m, k, n, label, card) -> dict:
    """int4_matmul at [m, k] x [k, n] held against its plain version (1e-4
    max|ref|), bit-equal over two calls, timed beside the plain version,
    ``torch.matmul`` on the dequantized bf16 weight and the bound (weights
    cycled past the L2)."""
    import torch

    from starpu_inference_server_tpu_torch.ops import matmul_kernels as mk
    from starpu_inference_server_tpu_torch.ops.quant import pack_int4, unpack_int4

    bf16 = torch.bfloat16
    x = torch.randn(m, k, device=dev, generator=g).to(bf16)
    copies = _copies(k * n // 2)
    w4s = [pack_int4(torch.randint(-7, 8, (k, n), device=dev, generator=g, dtype=torch.int8))
           for _ in range(copies)]
    sc = torch.rand(1, n, device=dev, generator=g) * 0.02 + 1e-3
    got = mk.int4_matmul(x, w4s[0], sc)
    ref = mk.int4_matmul_plain(x, w4s[0], sc)
    err, tol = max_err(got, ref), 1e-4 * ref.abs().max().item()
    same = bool(torch.equal(got, mk.int4_matmul(x, w4s[0], sc)))
    plan = mk.matmul_plan("int4_matmul", m, n, k,
                          torch.cuda.get_device_properties(dev).multi_processor_count)
    shape = f"M={m} K={k} N={n}"
    require(err <= tol, f"int4_matmul {label} {shape} disagrees with its plain version")
    require(same, f"int4_matmul {label} {shape} gave other bits on a second call")
    ms = _time_cycled(lambda i: mk.int4_matmul(x, w4s[i], sc), copies)
    plain_ms = time_ms(lambda: mk.int4_matmul_plain(x, w4s[0], sc), iters=5)
    w_deqs = [(unpack_int4(w4s[i % copies]).float() * sc).to(bf16)
              for i in range(_copies(k * n * 2))]
    lib_ms = _time_cycled(lambda i: torch.matmul(x, w_deqs[i]), len(w_deqs))
    b_ms, b_by = bound_ms(m * k * 2 + k * n // 2 + n * 4 + m * n * 4, 2.0 * m * k * n)
    print(f"time int4_matmul {shape} ({label}) on {card}: max_abs_err={err:.3e} tol={tol:.3e}, "
          f"two calls bit-equal, {plan.splits} splits; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, torch.matmul bf16 {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, shape=shape, splits=plan.splits, layer=label, m=m)


def _k6_entry(g, dev, m, k, n, label, card, row: bool) -> dict:
    """int4_matmul_w4a8 at a rank's [m, k] x [k, n], bit-equal to its plain
    version and over two calls, timed beside the plain version, the
    library call and the bound (weights cycled past the L2). ``row``: a
    row-parallel layer at model=2, where the kernel runs with unit scales
    and the ranks' integer sums are summed exactly before the scales
    (``ops/nn.py:dense``): the two halves' sums, scaled, must equal the
    kernel on the whole row bit for bit."""
    import torch

    from starpu_inference_server_tpu_torch.ops import matmul_kernels as mk
    from starpu_inference_server_tpu_torch.ops.quant import pack_int4, unpack_int4

    bf16 = torch.bfloat16
    x_q = torch.randint(-127, 128, (m, k), device=dev, generator=g, dtype=torch.int8)
    sx = torch.rand(m, 1, device=dev, generator=g) * 0.02 + 1e-3
    copies = _copies(k * n // 2)
    w4s = [pack_int4(torch.randint(-7, 8, (k, n), device=dev, generator=g, dtype=torch.int8))
           for _ in range(copies)]
    sc = torch.rand(1, n, device=dev, generator=g) * 0.02 + 1e-3
    if row:
        sx_k, sc_k = torch.ones(m, 1, device=dev), torch.ones(1, n, device=dev)
        other_x = torch.randint(-127, 128, (m, k), device=dev, generator=g, dtype=torch.int8)
        other_w = pack_int4(torch.randint(-7, 8, (k, n), device=dev, generator=g,
                                          dtype=torch.int8))
        whole = mk.int4_matmul_w4a8(torch.cat([x_q, other_x], 1), sx,
                                    torch.cat([w4s[0], other_w], 0), sc)
        parts = (mk.int4_matmul_w4a8(x_q, sx_k, w4s[0], sc_k).double()
                 + mk.int4_matmul_w4a8(other_x, sx_k, other_w, sc_k).double())
        summed = bool(torch.equal(parts.float() * sx * sc, whole))
        require(summed, f"int4_matmul_w4a8 {label}: the ranks' exact sums, scaled, differ from "
                        "the kernel on the whole row")
    else:
        sx_k, sc_k = sx, sc
    got = mk.int4_matmul_w4a8(x_q, sx_k, w4s[0], sc_k)
    ref = mk.int4_matmul_w4a8_plain(x_q, sx_k, w4s[0], sc_k)
    err = max_err(got, ref)
    require(bool(torch.equal(got, ref)), f"int4_matmul_w4a8 {label} M={m} is not bit-equal to "
                                         "its plain version")
    require(bool(torch.equal(got, mk.int4_matmul_w4a8(x_q, sx_k, w4s[0], sc_k))),
            f"int4_matmul_w4a8 {label} M={m} gave other bits on a second call")
    plan = mk.matmul_plan("int4_matmul_w4a8", m, n, k,
                          torch.cuda.get_device_properties(dev).multi_processor_count)
    ms = _time_cycled(lambda i: mk.int4_matmul_w4a8(x_q, sx_k, w4s[i], sc_k), copies)
    plain_ms = time_ms(lambda: mk.int4_matmul_w4a8_plain(x_q, sx_k, w4s[0], sc_k), iters=3)
    if m > 16:
        w8 = unpack_int4(w4s[0]).contiguous()
        lib_ms = time_ms(lambda: torch._int_mm(x_q, w8))
        library = "torch._int_mm on the unpacked int8 weight (no scales)"
    else:
        w8 = (unpack_int4(w4s[0]).float() * sc).to(bf16)
        xb = (x_q.float() * sx).to(bf16)
        lib_ms = time_ms(lambda: torch.matmul(xb, w8))
        library = "torch.matmul bf16 on the pre-dequantized weight"
    b_ms, b_by = bound_ms(m * k + m * 4 + k * n // 2 + n * 4 + m * n * 4, 2.0 * m * k * n,
                          PEAK_INT8)
    shape = f"M={m} K={k} N={n}"
    print(f"time int4_matmul_w4a8 {shape} ({label}) on {card}: bit-equal to the plain version"
          f"{', unit scales, exact sums over model = the whole row' if row else ''}; "
          f"{plan.splits} splits; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {library} "
          f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library=library, shape=shape, splits=plan.splits,
                layer=label, m=m)


def _k3_entry(g, dev, s, t, hq, hkv, d, label, card) -> dict:
    """decode_attention at ``s`` slots of mixed lengths (0 and t - 1 among
    them) against its plain version, bit-equal over two calls, timed on
    cycled cache copies beside SDPA on the dequantized cache and the bound."""
    import torch
    import torch.nn.functional as F

    from starpu_inference_server_tpu_torch.ops import decode_attention as da

    bf16, rep = torch.bfloat16, hq // hkv
    lens = torch.randint(0, t, (s,), device=dev, generator=g, dtype=torch.int32)
    lens[0], lens[-1] = 0, t - 1
    live = (lens.to(torch.int64) + 1).sum().item()
    nbytes = 2 * s * hq * d * 2 + live * hkv * (2 * d + 8) + 4 * s
    copies = _copies(nbytes)
    q = torch.randn(s, hq, d, device=dev, generator=g).to(bf16)
    caches = [(torch.randint(-127, 128, (s, t, hkv, d), device=dev, generator=g, dtype=torch.int8),
               torch.randint(-127, 128, (s, t, hkv, d), device=dev, generator=g, dtype=torch.int8),
               torch.rand(s, t, hkv, device=dev, generator=g) * 0.03 + 0.05,
               torch.rand(s, t, hkv, device=dev, generator=g) / 127 + 1e-3)
              for _ in range(copies)]
    got = da.decode_attention(q, *caches[0], lens, rep)
    splits = da.decode_split_plan(s, hkv, t, 1, rep, d).splits
    err = attn_check(f"decode_attention S={s} Hq={hq} Hkv={hkv} T={t} ({label}, {splits} splits)",
                     got, da.decode_attention_plain(q, *caches[0], lens, rep))
    require(torch.equal(got, da.decode_attention(q, *caches[0], lens, rep)),
            f"decode_attention ({label}) gave other bits on a second call")
    ms = _time_cycled(lambda i: da.decode_attention(q, *caches[i], lens, rep), copies)
    plain_ms = _time_cycled(lambda i: da.decode_attention_plain(q, *caches[i], lens, rep),
                            copies, iters=3)
    deq = [((kc.float() * ks[..., None]).to(bf16).transpose(1, 2),
            (vc.float() * vs[..., None]).to(bf16).transpose(1, 2))
           for kc, vc, ks, vs in caches[:_copies(2 * s * t * hkv * d * 2)]]
    mask = (torch.arange(t, device=dev)[None, :] <= lens[:, None])[:, None, None, :]
    lib_ms = _time_cycled(lambda i: F.scaled_dot_product_attention(
        q[:, :, None, :], *deq[i], attn_mask=mask, enable_gqa=True), len(deq))
    b_ms, b_by = bound_ms(nbytes, 4.0 * live * hq * d)
    print(f"time decode_attention S={s} Hq={hq} ({label}) on {card}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, shape=f"S={s} T={t} Hq={hq} Hkv={hkv} live={live}",
                splits=splits, layer=label)


def gspmd_kernel_rows(dev, card) -> dict:
    """Every kernel of the GSPMD paths at the shapes those paths give it on
    a rank, each held against its plain version and timed: K1 at the local
    N of llama-1b's int4 layers at model=2 (decode M = 128 slots / data 2,
    the 256-token chunk, the lm head's last row); K3 at those 64 slots and
    16 of 32 query heads, and at data=4's 32 slots and all heads; K4 on a
    256-token chunk and K5 on a 64-token prompt at 16 / 4 heads; K2 at
    moe-8x1b's shard at expert=2 x model=2 (16 slots; a 64-token prompt)
    and ViT-L's head (B = 32); K7 at bert_long's 6 of 12 heads on B = 16 /
    data 2; K8 at resnet18_int8's B = 32 / data 4. Returns the entries for
    the kernels' per_shape lists, tagged with their path."""
    import torch
    import torch.nn.functional as F

    from starpu_inference_server_tpu_torch.models.decoder import get_spec
    from starpu_inference_server_tpu_torch.ops import prefill_attention as pa
    from starpu_inference_server_tpu_torch.ops import stem_kernel as sk

    g = torch.Generator(device=dev).manual_seed(1414)
    bf16 = torch.bfloat16
    out = {name: [] for name in GSPMD_KERNELS}
    spec = get_spec("llama-1b", {})
    tp, d, h = 2, spec.head_dim, spec.hidden
    hq, hkv, inter = spec.q_heads // tp, spec.kv_heads // tp, spec.intermediate // tp
    label = "llama_decoder data=2 model=2"
    dense = {"qkv": (h, (hq + 2 * hkv) * d), "o": (hq * d, h), "gate_up": (h, 2 * inter),
             "down": (inter, h), "lm_head": (h, spec.vocab // tp)}
    for name, m in [(n, 64) for n in dense] + [("gate_up", 256), ("lm_head", 1)]:
        out["int4_matmul"].append(dict(_k1_entry(g, dev, m, *dense[name], f"{label} {name}", card),
                                       path=label))
    # K6: llama_w4a8.yml at data=2 x model=2 (8 of its 16 slots a group, a
    # 64-token prompt): the row-parallel o and down, and gate_up at local N
    w4 = "llama_w4a8 data=2 model=2"
    for name, m in (("o", 8), ("down", 8), ("down", 64), ("gate_up", 8)):
        out["int4_matmul_w4a8"].append(dict(_k6_entry(
            g, dev, m, *dense[name], f"{w4} {name}", card, row=name in ("o", "down")), path=w4))
    out["decode_attention"].append(dict(_k3_entry(g, dev, 64, 1024, hq, hkv, d, label, card),
                                        path=label))
    out["decode_attention"].append(dict(_k3_entry(
        g, dev, 32, 1024, spec.q_heads, spec.kv_heads, d, "llama_decoder data=4", card),
        path="llama_decoder data=4"))
    # K4: a 256-token chunk at start 256 of a slot's 1024-row cache
    c, t, start, rep = 256, 1024, 256, hq // hkv
    k_row = torch.randint(-127, 128, (t, hkv, d), device=dev, generator=g, dtype=torch.int8)
    v_row = torch.randint(-127, 128, (t, hkv, d), device=dev, generator=g, dtype=torch.int8)
    ks = torch.rand(t, hkv, device=dev, generator=g) * 0.01 + 0.01
    vs = torch.rand(t, hkv, device=dev, generator=g) / 127 + 1e-3
    q = (3 * torch.randn(c, hq, d, device=dev, generator=g)).to(bf16)
    kc = torch.randn(c, hkv, d, device=dev, generator=g).to(bf16)
    vc = torch.randn(c, hkv, d, device=dev, generator=g).to(bf16)
    args = (q, k_row, v_row, ks, vs, kc, vc, start, rep)
    got = pa.chunk_prefill_attention(*args)
    err = attn_check(f"chunk_prefill_attention C={c} start={start} Hq={hq} ({label})", got,
                     pa.chunk_prefill_attention_plain(*args))
    require(torch.equal(got, pa.chunk_prefill_attention(*args)),
            "chunk_prefill_attention (GSPMD shard) gave other bits on a second call")
    ms = time_ms(lambda: pa.chunk_prefill_attention(*args))
    plain_ms = time_ms(lambda: pa.chunk_prefill_attention_plain(*args), iters=5)
    kd = torch.cat([(k_row[:start].float() * ks[:start, :, None]).to(bf16), kc]).transpose(0, 1)
    vd = torch.cat([(v_row[:start].float() * vs[:start, :, None]).to(bf16), vc]).transpose(0, 1)
    mask = torch.arange(start + c, device=dev)[None, :] <= (start + torch.arange(c, device=dev))[:, None]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(0, 1)[None], kd[None], vd[None], attn_mask=mask, enable_gqa=True))
    b_ms, b_by = bound_ms(2 * c * hq * d * 2 + start * hkv * (2 * d + 8) + 2 * c * hkv * d * 2,
                          4.0 * hq * d * (c * start + c * (c + 1) / 2))
    print(f"time chunk_prefill_attention C={c} start={start} Hq={hq} ({label}) on {card}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    out["chunk_prefill_attention"].append(dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"C={c} start={start} T={t} Hq={hq} Hkv={hkv}", path=label))
    # K5: a 64-token prompt at the local heads
    t = GSPMD_PROMPT
    q = (3 * torch.randn(1, t, hq, d, device=dev, generator=g)).to(bf16)
    k = torch.randn(1, t, hkv, d, device=dev, generator=g).to(bf16)
    v = torch.randn(1, t, hkv, d, device=dev, generator=g).to(bf16)
    got = pa.causal_attention(q, k, v, rep)
    err = attn_check(f"causal_attention T={t} Hq={hq} ({label})", got,
                     pa.causal_attention_plain(q, k, v, rep))
    require(torch.equal(got, pa.causal_attention(q, k, v, rep)),
            "causal_attention (GSPMD shard) gave other bits on a second call")
    ms = time_ms(lambda: pa.causal_attention(q, k, v, rep))
    plain_ms = time_ms(lambda: pa.causal_attention_plain(q, k, v, rep), iters=5)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                             enable_gqa=True))
    b_ms, b_by = bound_ms(2 * t * hq * d * 2 + 2 * t * hkv * d * 2, 4.0 * hq * d * t * (t + 1) / 2)
    print(f"time causal_attention T={t} Hq={hq} ({label}) on {card}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    out["causal_attention"].append(dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"B=1 T={t} Hq={hq} Hkv={hkv}", path=label))
    # K2: moe-8x1b at expert=2 x model=2 (its shard of the attention and the
    # lm head, the replicated router; 16 slots and a 64-token prompt), the
    # ViT-L head at B = 32 (replicated: model=4 leaves its shape whole)
    moe = get_spec("moe-8x1b", {})
    mq, mkv = moe.q_heads // 2, moe.kv_heads // 2
    moe_dense = {"qkv": (moe.hidden, (mq + 2 * mkv) * d), "o": (mq * d, moe.hidden),
                 "router": (moe.hidden, moe.num_experts), "lm_head": (moe.hidden, moe.vocab // 2)}
    for m in (16, 64):
        for name, (k, n) in moe_dense.items():
            lab = f"moe_decoder expert=2 model=2 {name}"
            out["int8_matmul"].append(dict(k2_entry(g, dev, bf16, m, k, n, lab, card), layer=lab,
                                           m=m, path="moe_decoder expert=2 model=2"))
    out["int8_matmul"].append(dict(k2_entry(g, dev, bf16, 32, 1024, 1000, "vit_l_16 head", card),
                                   layer="vit_l_16 model=4 head", m=32, path="vit_l_16 model=4"))
    # K7: bert_long at data=2 x model=2: B = 16 / 2 rows, 12 / 2 heads
    b, t, hh = 8, 512, 6
    q = (3 * torch.randn(b, t, hh, d, device=dev, generator=g)).to(bf16)
    kk = torch.randn(b, t, hh, d, device=dev, generator=g).to(bf16)
    v = torch.randn(b, t, hh, d, device=dev, generator=g).to(bf16)
    bias = torch.zeros(b, t, device=dev)
    bias[0, 100:], bias[1, 300:] = -1e9, -1e9
    got = pa.bidirectional_attention(q, kk, v, bias)
    err = attn_check(f"bidirectional_attention B={b} T={t} H={hh} (bert_long data=2 model=2)",
                     got, pa.bidirectional_attention_plain(q, kk, v, bias))
    require(torch.equal(got, pa.bidirectional_attention(q, kk, v, bias)),
            "bidirectional_attention (GSPMD shard) gave other bits on a second call")
    ms = time_ms(lambda: pa.bidirectional_attention(q, kk, v, bias))
    plain_ms = time_ms(lambda: pa.bidirectional_attention_plain(q, kk, v, bias), iters=3)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, kk, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bias[:, None, None, :].to(bf16)))
    b_ms, b_by = bound_ms(4 * b * t * hh * d * 2 + b * t * 4, 4.0 * b * hh * t * t * d)
    print(f"time bidirectional_attention B={b} H={hh} (bert_long data=2 model=2) on {card}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa (float mask) {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    out["bidirectional_attention"].append(dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"B={b} T={t} H={hh} D={d}", path="bert_long data=2 model=2"))
    # K8: resnet18_int8 at data=4: B = 32 / 4 on a rank
    bsz = 8
    zp = torch.zeros(bsz, 118, 118, 12, device=dev)
    zp[:, 3:115, 3:115] = torch.randn(bsz, 112, 112, 12, device=dev, generator=g)
    zp = zp.to(bf16)
    w = (torch.randn(192, 64, device=dev, generator=g) * 0.1).to(bf16)
    scale = torch.rand(64, device=dev, generator=g) + 0.5
    shift = torch.randn(64, device=dev, generator=g) * 0.1
    got = sk.fused_stem(zp, w, scale, shift)
    err = attn_check(f"fused_stem B={bsz} (resnet18_int8 data=4)", got,
                     sk.fused_stem_plain(zp, w, scale, shift))
    require(torch.equal(got, sk.fused_stem(zp, w, scale, shift)),
            "fused_stem (GSPMD rows) gave other bits on a second call")
    ms = time_ms(lambda: sk.fused_stem(zp, w, scale, shift))
    plain_ms = time_ms(lambda: sk.fused_stem_plain(zp, w, scale, shift), iters=5)
    zb = zp.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    wk = w.reshape(4, 4, 12, 64).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    sc4, sh4 = scale.reshape(1, -1, 1, 1).to(bf16), shift.reshape(1, -1, 1, 1).to(bf16)
    lib_ms = time_ms(lambda: F.max_pool2d(torch.relu(F.conv2d(zb, wk)[:, :, :113, :113] * sc4
                                                     + sh4), kernel_size=3, stride=2))
    b_ms, b_by = bound_ms(bsz * 118 * 118 * 12 * 2 + 192 * 64 * 2 + 2 * 64 * 4
                          + bsz * 56 * 56 * 64 * 2, 2.0 * bsz * 112 * 112 * 192 * 64)
    print(f"time fused_stem B={bsz} (resnet18_int8 data=4) on {card}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sequence (channels_last cuDNN) {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    out["fused_stem"].append(dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"B={bsz} zp [118,118,12] -> [56,56,64]", path="resnet18_int8 data=4",
        library="sequence, not one call: conv2d + affine + relu + max_pool2d (channels_last)"))
    return out


def _on_mesh(cfg, **axes):
    """``cfg`` with ``devices.mesh`` set to ``axes`` (and the metrics port free)."""
    import dataclasses as dc

    from starpu_inference_server_tpu_torch.utils.config import MeshSettings

    return dc.replace(cfg, metrics_port=0, devices=dc.replace(cfg.devices, mesh=MeshSettings(
        **axes)))


def _with_options(cfg, **options):
    import dataclasses as dc

    return dc.replace(cfg, model=dc.replace(cfg.model, options=dict(cfg.model.options,
                                                                      **options)))


def _logits_close(what: str, got, ref) -> dict:
    """Held at GSPMD_LOGITS_TOL: max |got - ref| against max |ref|; prints
    both errors and the argmax agreement."""
    import torch

    g, r = got.float().cpu(), ref.float().cpu()
    worst = (g - r).abs().max().item() / r.abs().max().item()
    agree = (g.argmax(-1) == r.argmax(-1)).float().mean().item()
    print(f"{what}: max |mesh - one device| / max |one device| {worst:.3e} (limit "
          f"{GSPMD_LOGITS_TOL}), mean rel err {rel_err(g, r):.3e}, argmax agreement {agree:.3f}")
    require(bool(torch.isfinite(g).all()), f"{what}: non-finite logits")
    require(worst <= GSPMD_LOGITS_TOL, f"{what}: logits beyond the limit")
    return {"max_rel": worst, "mean_rel": rel_err(g, r), "argmax_agree": agree}


def _phase_stats(worker):
    """Every rank's launches (and collectives' calls) since ``reset_stats``."""
    stats = worker.gather_stats()
    return [{"launches": s["launches"], "census": s["collectives"]["calls"]} for s in stats]


def _require_on_every_rank(stats, kernels, what, on_card: bool = True):
    """Each of ``kernels`` launched on every rank (``stats`` by rank). Off
    the card (a CPU rehearsal) the plain versions count nothing: printed."""
    for name in kernels:
        counts = [s["launches"].get(name, 0) for s in stats]
        if not on_card:
            print(f"{what}: {name} launches by rank {counts} (not on a card)")
            continue
        require(all(c > 0 for c in counts), f"{what}: {name} not launched on every rank: {counts}")


def _decoder_logits_check(eng, ref_eng, prompts, slots, what):
    """Rank 0 of a GSPMD-mode engine: a prefill of each of ``prompts`` into
    its slot of ``slots`` (spread over the data groups) and one decode step
    over them, against the single-device engine ``ref_eng``'s prefills
    (its slots 0, 1, ...) and decode step on the same tree. The argmax
    agreement of the prefills is the share of first tokens equal. Returns
    the two comparisons."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.models.decoder import decode_step, prefill

    dev = eng.device
    ids = [torch.from_numpy(np.asarray(p, np.int32)).to(dev) for p in prompts]
    got = torch.stack([eng.worker.prefill(i, len(i), s) for i, s in zip(ids, slots)])
    ref_slots = list(range(len(slots)))
    ref = torch.stack([prefill(ref_eng.spec, ref_eng.params, ref_eng.cache, i, len(i), s,
                               ref_eng.dtype)[1] for i, s in zip(ids, ref_slots)])
    out = {"prefill": _logits_close(f"{what} first prefill", got, ref)}
    nxt = ref.argmax(-1).to(torch.int32)
    ids_m = torch.zeros(eng.num_slots, dtype=torch.int32, device=dev)
    act_m = torch.zeros(eng.num_slots, dtype=torch.bool, device=dev)
    ids_m[slots], act_m[slots] = nxt, True
    ids_r = torch.zeros(ref_eng.num_slots, dtype=torch.int32, device=dev)
    act_r = torch.zeros(ref_eng.num_slots, dtype=torch.bool, device=dev)
    ids_r[ref_slots], act_r[ref_slots] = nxt, True
    got = eng.worker.decode(ids_m, act_m)[slots]
    ref = decode_step(ref_eng.spec, ref_eng.params, ref_eng.cache, ids_r, act_r,
                      ref_eng.dtype)[1][ref_slots]
    out["step"] = _logits_close(f"{what} first decode step", got, ref)
    return out


def gspmd_world(rank, world, init_method, payload):
    """The rank worlds of the GSPMD group: one world of four ranks sharing
    the card (gloo), one mesh after another, each held against one device
    on rank 0:

    1. llama_decoder.yml at data=4 (llama-1b int4 cut to ``GSPMD_LAYERS``
       layers, as every llama-1b tree here, 128 slots, 32 a rank):
       ``DATA4_REQUESTS`` greedy requests of 32 tokens (prompts of 64, eight
       of ``DATA4_LONG``: chunked prefill), every stream equal to the
       single-device engine that runs 32 slots;
    2. ``sequence_parallel_decoder_logits`` on that tree at T = ``SEQ_T``
       over the 4 ranks, against ``forward_logits`` on one device;
    3. the same tree at data=2 x model=2: 32 first prefills (16 slots of
       each data group) and a decode step against one device; then
       llama_w4a8.yml on it (W4A8: K6, 8 prompts in 4 slots of each group);
    4. resnet18_int8.yml with ``stem_fused`` at data=4 through
       ``ModelEngine`` (B = 32), bit-equal to one device;
    5. vit_l_16.yml at model=4 through ``ModelEngine`` (B = 32);
    6. moe_decoder.yml cut to ``MOE_LAYERS`` layers at expert=2 x model=2:
       the first prefill and decode step against one device;
    7. llama_pipelined.yml cut to ``PIPE_LAYERS`` layers with
       ``serve_logits`` through ``ModelEngine``'s pipe mode (4
       microbatches), against ``forward_logits`` on one device.

    Every phase's launches and collectives are read from every rank.
    ``payload`` may name another ``device`` and other config files (keys
    ``llama``, ``w4a8``, ``resnet``, ``vit``, ``moe``, ``pipe``). Returns rank 0's
    results."""
    import dataclasses as dc

    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.core.engine import ModelEngine
    from starpu_inference_server_tpu_torch.models.decoder import forward_logits
    from starpu_inference_server_tpu_torch.models.registry import build_model, get_family
    from starpu_inference_server_tpu_torch.ops import nn
    from starpu_inference_server_tpu_torch.parallel.launch import (
        follow,
        follower_engine,
        join_mesh,
    )
    from starpu_inference_server_tpu_torch.parallel.mesh import MeshAxes, make_device_mesh
    from starpu_inference_server_tpu_torch.parallel.ring_attention import (
        sequence_parallel_decoder_logits,
    )
    from starpu_inference_server_tpu_torch.serving.generation import (
        GenerationRequest,
        build_generation_engine,
    )
    from starpu_inference_server_tpu_torch.utils.config import load_config
    from starpu_inference_server_tpu_torch.weights import receive_shard, scatter_shards

    paths = {"llama": CONFIG, "w4a8": W4A8_CONFIG, "resnet": RESNET_CONFIG, "vit": VIT_CONFIG,
             "moe": MOE_CONFIG, "pipe": PIPE_CONFIG}
    paths = {k: str(payload.get(k, v)) for k, v in paths.items()}
    mesh = join_mesh(MeshAxes(data=4), rank, world, init_method, payload.get("device", "cuda"),
                     timeout_s=900.0)
    dev = mesh.device
    on_card = dev.type == "cuda"
    res = {"backend": mesh.backend, "seconds": {}}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        res["seconds"][name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    def shard_of(tree, cfg, m):
        spec = get_family(cfg.model.family, cfg.model.options).spec
        return scatter_shards(tree, spec, cfg.model.family, m) if rank == 0 else receive_shard(m)

    def batch_engine(cfg, m):
        """(rank 0's engine and whole model) or (None, None) after following."""
        if rank != 0:
            follow(follower_engine(cfg, m).worker)
            return None, None
        model = build_model(cfg.model, seed=cfg.seed, device=dev)
        return ModelEngine(cfg, model, mesh=m), model

    # 1. llama_decoder at data=4
    base = _with_options(load_config(paths["llama"]), layers=GSPMD_LAYERS)
    cfg = _on_mesh(base, data=4)
    vocab = get_family(base.model.family, base.model.options).spec.vocab
    tree = build_model(cfg.model, seed=cfg.seed, device=dev).params if rank == 0 else None
    eng = build_generation_engine(cfg, mesh=mesh, params=shard_of(tree, cfg, mesh))
    if rank != 0:
        follow(eng.worker)
    else:
        ref = build_generation_engine(_with_options(base, num_slots=base.model.options[
            "num_slots"] // 4), device=dev, params=tree)
        rng = np.random.default_rng(14)
        # the long prompts last: the short ones are admitted together, six
        # into each data group (the least-loaded group's lowest free slot),
        # then the long ones chunk, two in each group
        prompts = [rng.integers(1, vocab, (DATA4_LONG if i >= DATA4_REQUESTS - 8 else
                                           GSPMD_PROMPT,)) for i in range(DATA4_REQUESTS)]

        def run(engine):
            reqs = [GenerationRequest(prompt_ids=p.astype(np.int32), max_new_tokens=GSPMD_TOKENS)
                    for p in prompts]
            for r in reqs:
                engine.submit(r)
            t1 = time.perf_counter()
            engine.start()
            try:
                return [r.result(timeout=600.0) for r in reqs], time.perf_counter() - t1
            finally:
                engine.stop()

        try:
            eng.worker.reset_stats()
            got, wall = run(eng)
            stats = _phase_stats(eng.worker)
            steps, step_s = eng.steps, eng.loop_timers["step"]
            want, ref_wall = run(ref)
            require(got == want, "llama_decoder data=4: a stream differs from the single-device "
                                 "engine's (32 slots)")
            _require_on_every_rank(stats, ("int4_matmul", "decode_attention", "causal_attention",
                                           "chunk_prefill_attention"),
                                   "llama_decoder data=4", on_card)
            res["data4"] = {"launches": [s["launches"] for s in stats],
                            "census": [s["census"] for s in stats], "wall_s": wall,
                            "ref_wall_s": ref_wall, "steps": steps,
                            "step_ms": 1e3 * step_s / max(steps, 1)}
            # a dense prefix-cache hit's row copy across data groups: slot 0
            # (group 0) prefilled, copied over the last slot (group 3), one
            # decode step on both
            w, last = eng.worker, eng.num_slots - 1
            w.prefill(torch.from_numpy(prompts[0].astype(np.int32)).to(dev), GSPMD_PROMPT, 0)
            w.copy_rows(0, last)
            w.cache.lengths[last] = GSPMD_PROMPT
            ids = torch.zeros(eng.num_slots, dtype=torch.int32, device=dev)
            act = torch.zeros(eng.num_slots, dtype=torch.bool, device=dev)
            ids[[0, last]], act[[0, last]] = 5, True
            pair = w.decode(ids, act)[[0, last]]
            res["data4"]["copy"] = dict(_logits_close(
                "llama_decoder data=4 prefix rows copied from group 0 to group 3", pair[1:],
                pair[:1]), bit_equal=bool(torch.equal(pair[0], pair[1])))
        finally:
            eng.worker.stop_followers()
    lap("llama_decoder data=4")

    # 2. sequence parallelism over the same 4 ranks, on the engine's tree
    ids = torch.from_numpy(np.random.default_rng(15).integers(1, vocab, (1, SEQ_T))).to(dev)
    mesh.stats.reset()
    got = sequence_parallel_decoder_logits(eng.spec, eng.params, ids, mesh, torch.bfloat16)
    census = mesh.stats.snapshot()["calls"]
    if rank == 0:
        want = forward_logits(eng.spec, eng.params, ids, torch.bfloat16)
        res["seqpar"] = dict(_logits_close(f"sequence_parallel_decoder_logits T={SEQ_T} "
                                           "(4 ranks)", got[0], want[0]), census=census)
        del want
    del got, eng
    torch.cuda.empty_cache()
    lap("sequence parallel")

    # 3. the same tree at data=2 x model=2
    dm = make_device_mesh(MeshAxes(**GSPMD_MESH), dev)
    cfg = _on_mesh(base, **GSPMD_MESH)
    eng = build_generation_engine(cfg, mesh=dm, params=shard_of(tree, cfg, dm))
    if rank != 0:
        follow(eng.worker)
    else:
        try:
            eng.worker.reset_stats()
            half = eng.num_slots // 2
            # 32 prompts of GSPMD_PROMPT: 16 slots of each data group
            short = list(np.random.default_rng(141).integers(1, vocab, (32, GSPMD_PROMPT)))
            res["dm"] = _decoder_logits_check(eng, ref, short,
                                              list(range(16)) + list(range(half, half + 16)),
                                              "llama_decoder data=2 model=2")
            res["dm"]["stats"] = _phase_stats(eng.worker)
            _require_on_every_rank(res["dm"]["stats"], ("int4_matmul", "decode_attention",
                                                        "causal_attention"),
                                   "llama_decoder data=2 model=2", on_card)
        finally:
            eng.worker.stop_followers()
        del ref
    del eng
    torch.cuda.empty_cache()
    lap("llama_decoder data=2 model=2")

    # 3b. llama_w4a8.yml on the same int4 tree at data=2 x model=2: K6 on
    # every rank, the row-parallel o and down through its exact sums
    w4_base = _with_options(load_config(paths["w4a8"]), layers=GSPMD_LAYERS)
    require((w4_base.model.family, w4_base.seed) == (base.model.family, base.seed),
            "llama_w4a8.yml and llama_decoder.yml no longer share one int4 tree")
    cfg = _on_mesh(w4_base, **GSPMD_MESH)
    eng = build_generation_engine(cfg, mesh=dm, params=shard_of(tree, cfg, dm))
    if rank != 0:
        follow(eng.worker)
    else:
        try:
            require(nn.w8a8_enabled(), "the W4A8 mesh engine did not turn the W8A8 flag on")
            ref = build_generation_engine(_with_options(w4_base, num_slots=eng.num_slots // 2),
                                          device=dev, params=tree)
            eng.worker.reset_stats()
            half = eng.num_slots // 2
            res["w4a8"] = _decoder_logits_check(eng, ref, prompts[:8],
                                                list(range(4)) + list(range(half, half + 4)),
                                                "llama_w4a8 data=2 model=2")
            res["w4a8"]["stats"] = _phase_stats(eng.worker)
            _require_on_every_rank(res["w4a8"]["stats"], ("int4_matmul_w4a8", "decode_attention",
                                                          "causal_attention"),
                                   "llama_w4a8 data=2 model=2", on_card)
            del ref
        finally:
            eng.worker.stop_followers()
    nn.set_w8a8(False)
    del eng, tree
    torch.cuda.empty_cache()
    lap("llama_w4a8 data=2 model=2")

    # 4. resnet18_int8 (fused stem) at data=4 through ModelEngine
    cfg = _on_mesh(_with_options(load_config(paths["resnet"]), stem_fused=True), data=4)
    engine, model = batch_engine(cfg, mesh)
    if rank == 0:
        try:
            x = torch.randn(32, *cfg.inputs[0].dims, generator=torch.Generator().manual_seed(16))
            x = x.to(torch.bfloat16)
            engine.worker.reset_stats()
            got = engine.fetch(engine.run_padded({"input": x}))["output"]
            stats = _phase_stats(engine.worker)
            with torch.inference_mode():
                want = model.apply({"input": x.to(dev)})["output"].float().cpu()
            same = bool(torch.equal(got.float(), want))
            print(f"resnet18_int8 data=4 (B=32, stem_fused): bit-equal to one device {same}, "
                  f"max abs diff {max_err(got, want):.3e}")
            require(same, "resnet18_int8 data=4: outputs differ from one device's")
            _require_on_every_rank(stats, ("fused_stem",), "resnet18_int8 data=4", on_card)
            res["resnet"] = {"bit_equal": same, "stats": stats}
        finally:
            engine.worker.stop_followers()
    del engine, model
    torch.cuda.empty_cache()
    lap("resnet18_int8 data=4")

    # 5. vit_l_16 at model=4 through ModelEngine
    m4 = make_device_mesh(MeshAxes(model=4), dev)
    cfg = _on_mesh(load_config(paths["vit"]), model=4)
    nn.set_w8a8(False)
    engine, model = batch_engine(cfg, m4)
    if rank == 0:
        try:
            image = cfg.inputs[0].dims
            x = torch.randn(32, *image, generator=torch.Generator().manual_seed(17))
            x = x.to(torch.bfloat16)
            engine.worker.reset_stats()
            got = engine.fetch(engine.run_padded({"input": x}))["output"]
            stats = _phase_stats(engine.worker)
            with torch.inference_mode():
                want = model.apply({"input": x.to(dev)})["output"].float().cpu()
            err = rel_err(got, want)
            agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
            print(f"vit_l_16 model=4 (B=32): mean rel err vs one device {err:.3e} (tol "
                  f"{VIT_SERVE_TOL}), argmax agreement {agree:.3f}")
            require(err <= VIT_SERVE_TOL, "vit_l_16 model=4 disagrees with one device")
            _require_on_every_rank(stats, ("int8_matmul",), "vit_l_16 model=4", on_card)
            res["vit"] = {"rel_err": err, "argmax_agree": agree, "stats": stats}
        finally:
            engine.worker.stop_followers()
    del engine, model
    torch.cuda.empty_cache()
    lap("vit_l_16 model=4")

    # 6. moe_decoder at expert=2 x model=2, cut to MOE_LAYERS layers
    em = make_device_mesh(MeshAxes(expert=2, model=2), dev)
    base = _with_options(load_config(paths["moe"]), layers=MOE_LAYERS)
    cfg = _on_mesh(base, expert=2, model=2)
    tree = build_model(cfg.model, seed=cfg.seed, device=dev).params if rank == 0 else None
    eng = build_generation_engine(cfg, mesh=em, params=shard_of(tree, cfg, em))
    if rank != 0:
        follow(eng.worker)
    else:
        try:
            ref = build_generation_engine(base, device=dev, params=tree)
            eng.worker.reset_stats()
            res["moe"] = _decoder_logits_check(
                eng, ref, prompts[:8], list(range(8)),
                f"moe_decoder expert=2 model=2 (cut to {MOE_LAYERS} of 16 layers)")
            res["moe"]["stats"] = _phase_stats(eng.worker)
            _require_on_every_rank(res["moe"]["stats"], ("int8_matmul", "decode_attention",
                                                         "causal_attention"),
                                   "moe_decoder expert=2 model=2", on_card)
            del ref
        finally:
            eng.worker.stop_followers()
    del eng, tree
    torch.cuda.empty_cache()
    lap("moe_decoder expert=2 model=2")

    # 7. llama_pipelined serve_logits: ModelEngine's pipe mode
    p4 = make_device_mesh(MeshAxes(pipe=4), dev)
    cfg = _with_options(load_config(paths["pipe"]), layers=PIPE_LAYERS, serve_logits=True)
    cfg = dc.replace(cfg, metrics_port=0, devices=dc.replace(cfg.devices, mesh=dc.replace(
        cfg.devices.mesh, microbatches=4)))
    engine, model = batch_engine(cfg, p4)
    if rank == 0:
        try:
            ids = torch.from_numpy(np.random.default_rng(18).integers(
                1, model.definition.spec.vocab, (4, *cfg.inputs[0].dims)))
            engine.worker.reset_stats()
            got = engine.fetch(engine.run_padded({"input_ids": ids}))["logits"]
            stats = _phase_stats(engine.worker)
            with torch.inference_mode():
                want = forward_logits(model.definition.spec, model.params, ids.to(dev),
                                      model.compute_dtype).cpu()
            res["pipe"] = dict(_logits_close(
                f"llama_pipelined serve_logits pipe=4 (llama-7b cut to {PIPE_LAYERS} of 32 "
                "layers, 4 microbatches)", got, want), stats=stats)
        finally:
            engine.worker.stop_followers()
    del engine, model
    torch.cuda.empty_cache()
    lap("llama_pipelined serve_logits pipe=4")
    return res if rank == 0 else {"backend": mesh.backend}


def _gspmd_client(target: str, model: str) -> tuple:
    """The port's generation client in this process: GSPMD_REQUESTS greedy
    requests of GSPMD_TOKENS, prompts of GSPMD_PROMPT, streaming."""
    from starpu_inference_server_tpu_torch.clients.client import GenerationClient

    async def go():
        gen = GenerationClient(target, model, prompt_len=GSPMD_PROMPT,
                               max_new_tokens=GSPMD_TOKENS)
        elapsed = await gen.run(GSPMD_REQUESTS, GSPMD_REQUESTS, True)
        await gen.close()
        return gen.summary(elapsed), gen.tokens_by_request, gen.prompts

    return asyncio.run(go())


def _mesh_window(server: "ServerProcess") -> dict:
    """A mesh server's statistics between warmup and shutdown: every rank's
    launches and collectives' calls and host ms, rank 0's steps and loop
    timers (generation)."""
    from starpu_inference_server_tpu_torch.parallel.census import collectives_by_axis

    stats = _mesh_stats(server)
    before, after = stats["after warmup"], stats["at shutdown"]
    calls = [{k: v - b["collectives"]["calls"].get(k, 0)
              for k, v in a["collectives"]["calls"].items()}
             for b, a in zip(before["ranks"], after["ranks"])]
    out = {"launches": _rank_launches(before, after),
           "census": [collectives_by_axis({"calls": c}) for c in calls]}
    if "steps" in after:
        out["steps"] = after["steps"] - before["steps"]
        out["step_ms"] = 1e3 * (after["loop_timers"]["step"] - before["loop_timers"]["step"]) \
            / max(out["steps"], 1)
    return out


def gspmd_server_run(server: "ServerProcess", card: str,
                     what: str = "llama_decoder data=2 model=2") -> dict:
    """configs/llama_decoder.yml at data=2 x model=2 served by ``server``
    (started from the CLI): the port's generation client, streaming; every
    request handled with all its tokens. Stops the server and reads its
    mesh statistics. Prints and returns tok/s, TTFT, rank 0's decode-step
    host ms, the census by rank and the launches by rank (K1, K3 and K5 on
    every rank; with the streams and the client's pooled prompts)."""
    target = server.wait_ready(timeout=900)
    summary, tokens, pool = _gspmd_client(target, server.name)
    req, gen = summary["requests"], summary["generation"]
    require(req["handled"] == GSPMD_REQUESTS and req["errors"] == 0,
            f"{what}: {json.dumps(req)}")
    require(all(len(t) == GSPMD_TOKENS for t in tokens.values()),
            f"{what}: a stream is short")
    server.stop()
    window = _mesh_window(server)
    backend = re.search(r"mesh backend: (\w+)", server.log.read_text())
    require(backend is not None, f"{what}: no backend line")
    # every data group decodes its slots each step; a prefill runs on the
    # group whose slot the request got (the least-loaded group's)
    _require_on_every_rank([{"launches": la} for la in window["launches"]],
                           ("int4_matmul", "decode_attention", "causal_attention"),
                           f"{what} (CLI)")
    import yaml

    layers = yaml.safe_load(server.config.read_text())["model"]["options"].get("layers", 16)
    print(f"{what} (llama-1b int4 x {layers} layers, 128 slots, 4 ranks on {card}, "
          f"{backend.group(1)}): started in {server.start_s:.1f} s; {GSPMD_REQUESTS} greedy "
          f"requests of {GSPMD_TOKENS} tokens (prompts of {GSPMD_PROMPT}), streaming: "
          f"{gen['tokens_per_s']:.1f} tok/s, TTFT ms {_pcts(gen['ttft_ms'])}; rank 0's decode "
          f"step {window['step_ms']:.2f} ms (host clock, dispatch + consume, {window['steps']} "
          f"steps)")
    print(f"{what} census by rank (op, axis): {json.dumps(window['census'])}")
    print(f"{what} launches by rank: {json.dumps(window['launches'])}")
    return dict(window, backend=backend.group(1), summary=summary, start_s=server.start_s,
                tokens=tokens, prompts=pool)


def gspmd_bert_run(server: "ServerProcess", card: str, device: str = "cuda") -> dict:
    """configs/bert_long.yml (W8A8, s = 512) at data=2 x model=2 served by
    ``server`` (started from the CLI): GSPMD_BERT_REQUESTS concurrent
    requests through the BERT client's ``infer``, each held against a
    batch-1 apply of the single-device model (same seed) within BERT_TOL.
    Stops the server; K7's launches by rank."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.clients import bert_client
    from starpu_inference_server_tpu_torch.models.registry import build_model
    from starpu_inference_server_tpu_torch.ops import nn
    from starpu_inference_server_tpu_torch.utils.config import load_config

    target = server.wait_ready(timeout=900)
    words = "the quick brown fox jumps over the lazy dog while servers answer".split()
    rng = np.random.default_rng(19)
    texts = [" ".join(rng.choice(words, int(rng.integers(5, 400)))) for _ in
             range(GSPMD_BERT_REQUESTS)]
    ids, mask = bert_client.tokenize(texts, 512)

    async def go():
        return await asyncio.gather(*(bert_client.infer(target, server.name, ids[i:i + 1],
                                                        mask[i:i + 1], timeout=600.0)
                                      for i in range(len(texts))))

    t1 = time.perf_counter()
    resps = asyncio.run(go())
    wall = time.perf_counter() - t1
    server.stop()
    window = _mesh_window(server)
    cfg = load_config(str(BERT_CONFIG))
    nn.set_w8a8(True)
    try:
        model = build_model(cfg.model, seed=cfg.seed, device=device)
        worst = 0.0
        for i, resp in enumerate(resps):
            got = torch.from_numpy(np.frombuffer(resp.raw_output_contents[0], np.float32)
                                   .reshape(1, 512, -1).copy())
            with torch.inference_mode():
                want = model.apply({"input_ids": torch.from_numpy(ids[i:i + 1]).to(device),
                                    "attention_mask": torch.from_numpy(mask[i:i + 1]).to(device)}
                                   )["last_hidden_state"].float().cpu()
            require(bool(torch.isfinite(got).all()),
                    "bert_long data=2 model=2: a response is not finite")
            worst = max(worst, rel_err(got, want))
    finally:
        nn.set_w8a8(False)
    _require_on_every_rank([{"launches": la} for la in window["launches"]],
                           ("bidirectional_attention",), "bert_long data=2 model=2 (CLI)")
    print(f"bert_long data=2 model=2 (W8A8, 4 ranks on {card}): started in {server.start_s:.1f} "
          f"s; {len(resps)} concurrent requests through the BERT client in {wall:.2f} s "
          f"({len(resps) / wall:.1f} seq/s); worst mean rel err vs a batch-1 single-device "
          f"apply {worst:.3e} (tol {BERT_TOL}); K7 launches by rank "
          f"{[la.get('bidirectional_attention', 0) for la in window['launches']]}; census by "
          f"rank {json.dumps(window['census'])}")
    require(worst <= BERT_TOL, "bert_long data=2 model=2: a response disagrees with one device")
    return dict(window, worst=worst, wall_s=wall, start_s=server.start_s)


def gspmd_path(card: str) -> dict:
    """The GSPMD group: llama_decoder.yml and bert_long.yml at data=2 x
    model=2 from the CLI (4 rank processes each, sharing this card over
    gloo), started first, and the rank worlds of ``gspmd_world`` while they
    build. Returns the numbers and every phase's launches by rank."""
    import tempfile

    from starpu_inference_server_tpu_torch.parallel.launch import run_world

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        workdir = Path(tmp)
        llama = ServerProcess(CONFIG, workdir, "llama_gspmd", {
            "devices.mesh": GSPMD_MESH, "model.options.layers": GSPMD_LAYERS})
        bert = ServerProcess(BERT_CONFIG, workdir, "bert_gspmd", {"devices.mesh": GSPMD_MESH})
        servers = [llama, bert]
        try:
            for srv in servers:
                srv.start()
            t1 = time.perf_counter()
            print(f"time cut: llama_decoder.yml and llama_w4a8.yml at {GSPMD_LAYERS} of 16 layers "
                  "in the GSPMD group and the multi-host CLI launchers (formerly 16)")
            world = run_world("chip_smoke:gspmd_world", 4, {}, timeout_s=900.0,
                              workdir=str(workdir / "gspmd_world"))[0]
            require(world["backend"] == "gloo", f"gspmd world backend {world['backend']}")
            print(f"gspmd rank worlds (4 ranks on {card}, gloo) in "
                  f"{time.perf_counter() - t1:.1f} s, by phase {json.dumps(world['seconds'])}")
            d4 = world["data4"]
            print(f"llama_decoder data=4: {DATA4_REQUESTS} greedy streams of {GSPMD_TOKENS} tokens "
                  f"equal to the single-device engine's (32 slots); mesh {d4['wall_s']:.1f} s "
                  f"({d4['steps']} steps, rank 0's step {d4['step_ms']:.2f} ms host), one device "
                  f"{d4['ref_wall_s']:.1f} s; launches by rank {json.dumps(d4['launches'])}")
            print(f"llama_decoder data=2 model=2 (rank world) launches by rank "
                  f"{json.dumps([s['launches'] for s in world['dm']['stats']])}; census "
                  f"{json.dumps([s['census'] for s in world['dm']['stats']])}")
            print(f"sequence parallel census (rank 0): {json.dumps(world['seqpar']['census'])}")
            for name in ("w4a8", "resnet", "vit", "moe", "pipe"):
                print(f"{name} (rank world) launches by rank "
                      f"{json.dumps([s['launches'] for s in world[name]['stats']])}")
            served = gspmd_server_run(llama, card)
            bert_run = gspmd_bert_run(bert, card)
        except BaseException:
            show_logs(servers)
            raise
        finally:
            for srv in servers:
                srv.kill()
    return {"world": world, "llama": served, "bert": bert_run}


# -- the multi-host group: launchers of local ranks joining one coordinator ---

MH_LAYERS = 4             # llama-1b cut from 16 layers to 4 in the rank worlds (full width)
MH_PROMPTS, MH_STEPS = 8, 4  # the data=2 x model=2 world's prefills and decode steps
MH_REQUESTS, MH_TOKENS = 8, 16  # the pipe=2 x model=2 world's greedy requests
MH_KILL_TIMEOUT_S = 60    # the killed pair's --timeout-s
MH_KERNELS = ("int4_matmul", "int8_matmul", "decode_attention", "chunk_prefill_attention",
              "causal_attention")


def launcher_pair(base: Path, workdir: Path, tag: str, changes: dict, args: list = (),
                  device_ids: list = None) -> list:
    """Two ``ServerProcess`` launchers of ``base`` with ``changes``, joining
    at a fresh local coordinator as ``distributed.process_id`` 0 and 1 of
    ``num_processes: 2``; ``device_ids``: each launcher's cards (default:
    the visible ones)."""
    coordinator = f"127.0.0.1:{free_port()}"
    pair = []
    for i in range(2):
        mine = dict(changes, distributed={"coordinator_address": coordinator,
                                          "num_processes": 2, "process_id": i})
        if device_ids is not None:
            mine["devices.device_ids"] = device_ids[i]
        pair.append(ServerProcess(base, workdir, f"{tag}{i}", mine, args=args))
    return pair


def _crossing_census(stats: list, what: str) -> list:
    """Each rank's collectives over the axes crossing its launchers
    (``parallel/census.py:crossing_calls``)."""
    from starpu_inference_server_tpu_torch.parallel.census import (
        collectives_by_axis,
        crossing_calls,
    )

    out = [crossing_calls(collectives_by_axis({"calls": s["census"]}), s["crossing"])
           for s in stats]
    print(f"{what}: collectives crossing launchers by rank {json.dumps(out)}")
    return out


def multihost_world(rank, world, init_method, payload, launchers=1):
    """The rank worlds of the multi-host group, run by ``run_world`` with 2
    launchers of 2 ranks (and again with 1 launcher of 4, the reference),
    all sharing the card over gloo:

    1. llama_decoder.yml (llama-1b int4, full width, cut to ``MH_LAYERS``
       layers) at data=2 x model=2: ``MH_PROMPTS`` prefills of 64 tokens
       into slots of both data groups, then ``MH_STEPS`` greedy decode steps
       over them; rank 0 returns every logits row;
    2. llama_pipelined.yml (llama-7b int8, ``PIPE_LAYERS`` layers) at pipe=2
       x model=2, stage 0 in launcher 0 and stage 1 in launcher 1:
       ``MH_REQUESTS`` greedy requests of ``MH_TOKENS`` tokens through the
       pipe-mode engine; rank 0 returns the streams.

    Every phase's launches, collectives and crossing axes are read from
    every rank. ``payload`` may name another ``device`` and config files
    (keys ``llama``, ``pipe``)."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.parallel.launch import follow, join_mesh
    from starpu_inference_server_tpu_torch.parallel.mesh import MeshAxes, make_device_mesh
    from starpu_inference_server_tpu_torch.serving.generation import (
        GenerationRequest,
        build_generation_engine,
    )
    from starpu_inference_server_tpu_torch.utils.config import load_config

    mesh = join_mesh(MeshAxes(**GSPMD_MESH), rank, world, init_method,
                     payload.get("device", "cuda"), timeout_s=600.0, launchers=launchers)
    dev = mesh.device
    res = {"backend": mesh.backend, "seconds": {}}

    def stats_of(worker):
        """Every rank's launches, collectives' calls, launcher, coordinates
        and crossing axes since ``reset_stats``."""
        return [{"launches": s["launches"], "census": s["collectives"]["calls"],
                 "launcher": s["launcher"], "coords": s["coords"], "crossing": s["crossing"]}
                for s in worker.gather_stats()]

    # 1. llama-1b int4 at data=2 x model=2: prefills and decode steps by hand
    t0 = time.perf_counter()
    cfg = _with_options(_on_mesh(load_config(str(payload.get("llama", CONFIG))), **GSPMD_MESH),
                        layers=MH_LAYERS)
    eng = build_generation_engine(cfg, mesh=mesh)
    if rank != 0:
        follow(eng.worker)
    else:
        try:
            w = eng.worker
            w.reset_stats()
            half = eng.num_slots // 2
            slots = list(range(MH_PROMPTS // 2)) + list(range(half, half + MH_PROMPTS // 2))
            rng = np.random.default_rng(151)
            prompts = [torch.from_numpy(rng.integers(1, eng.spec.vocab, (GSPMD_PROMPT,))
                                        .astype(np.int32)).to(dev) for _ in slots]
            rows = [torch.stack([w.prefill(p, len(p), s) for p, s in zip(prompts, slots)])]
            ids = torch.zeros(eng.num_slots, dtype=torch.int32, device=dev)
            active = torch.zeros(eng.num_slots, dtype=torch.bool, device=dev)
            active[slots] = True
            for _ in range(MH_STEPS):
                ids[slots] = rows[-1].argmax(-1).to(torch.int32)
                rows.append(w.decode(ids, active)[slots])
            res["dm"] = {"logits": torch.stack(rows).float().cpu(), "stats": stats_of(w)}
        finally:
            eng.worker.stop_followers()
    del eng
    torch.cuda.empty_cache()
    res["seconds"]["llama_decoder data=2 model=2"] = round(time.perf_counter() - t0, 1)

    # 2. llama_pipelined at pipe=2 x model=2: one stage a launcher
    t0 = time.perf_counter()
    pm = make_device_mesh(MeshAxes(pipe=2, model=2), dev, mesh.local, mesh.timeout_s)
    pcfg = _with_options(_on_mesh(load_config(str(payload.get("pipe", PIPE_CONFIG))), pipe=2,
                                  model=2), layers=PIPE_LAYERS)
    eng = build_generation_engine(pcfg, mesh=pm)
    if rank != 0:
        follow(eng.worker)
    else:
        try:
            eng.worker.reset_stats()
            rng = np.random.default_rng(152)
            reqs = [GenerationRequest(prompt_ids=rng.integers(1, eng.spec.vocab, (PIPE_PROMPT,))
                                      .astype(np.int32), max_new_tokens=MH_TOKENS)
                    for _ in range(MH_REQUESTS)]
            for r in reqs:
                eng.submit(r)
            eng.start()
            try:
                tokens = [r.result(timeout=600.0) for r in reqs]
            finally:
                eng.stop()
            res["pipe"] = {"tokens": tokens, "stats": stats_of(eng.worker)}
        finally:
            eng.worker.stop_followers()
    del eng
    res["seconds"]["llama_pipelined pipe=2 model=2"] = round(time.perf_counter() - t0, 1)
    return res if rank == 0 else {"backend": mesh.backend}


def multihost_worlds(workdir: Path, card: str, payload: dict = None) -> dict:
    """``multihost_world`` over 2 launchers of 2 ranks, then over 1
    launcher of 4: the data=2 x model=2 logits bit-equal, the pipelined
    streams equal; K1, K3, K5 (data=2 x model=2) and K2, K3, K4 (pipe) on
    every rank of both launchers; every all-reduce over ``model``, and only
    ``data`` (then ``pipe``) crossing the launchers."""
    import torch

    from starpu_inference_server_tpu_torch.parallel.launch import run_world

    from concurrent.futures import ThreadPoolExecutor

    payload = payload or {}
    on_card = payload.get("device", "cuda") == "cuda"

    def world(n):
        t1 = time.perf_counter()
        ranks = run_world("chip_smoke:multihost_world", 4, payload, timeout_s=900.0,
                          workdir=str(workdir / f"multihost_world{n}"), launchers=n)
        return ranks, round(time.perf_counter() - t1, 1)

    runs = {}
    with ThreadPoolExecutor(2) as pool:  # both worlds at once, sharing the card
        futures = {n: pool.submit(world, n) for n in (2, 1)}
        for n, future in futures.items():
            ranks, wall = future.result()
            require(all(r["backend"] == "gloo" for r in ranks),
                    f"multihost world ({n} launchers): backends {[r['backend'] for r in ranks]}")
            runs[n] = dict(ranks[0], wall_s=wall)
            print(f"multihost rank world, {n} launcher(s) of {4 // n} ranks on {card} (gloo, "
                  f"both worlds at once): {wall} s, by phase {json.dumps(runs[n]['seconds'])}")
    two, one = runs[2], runs[1]
    dm, pipe = two["dm"], two["pipe"]
    # 1. data=2 x model=2: bit-equal logits, data crossing, all-reduces inside a launcher
    require(torch.equal(dm["logits"], one["dm"]["logits"]),
            "multihost data=2 model=2: logits over 2 launchers differ from 1 launcher's")
    require(bool(torch.isfinite(dm["logits"]).all()), "multihost data=2 model=2: non-finite")
    require([s["launcher"] for s in dm["stats"]] == [0, 0, 1, 1],
            f"multihost data=2 model=2: launchers by rank {[s['launcher'] for s in dm['stats']]}")
    require(all(s["crossing"] == ["data"] for s in dm["stats"]),
            f"multihost data=2 model=2: crossing axes {[s['crossing'] for s in dm['stats']]}")
    dm_cross = _crossing_census(dm["stats"], "multihost data=2 model=2")
    for s, c in zip(dm["stats"], dm_cross):
        reduce_axes = {k.split("/")[1] for k in s["census"] if k.startswith("all-reduce/")}
        require(reduce_axes == {"model"}, f"multihost data=2 model=2: all-reduces over "
                                          f"{sorted(reduce_axes)}")
        require(set(c) == {"all-gather"}, f"multihost data=2 model=2: crossing {c}")
    _require_on_every_rank(dm["stats"], ("int4_matmul", "decode_attention", "causal_attention"),
                           "multihost data=2 model=2", on_card)
    print(f"multihost data=2 model=2 (llama-1b int4 x {MH_LAYERS} layers, 2 launchers): "
          f"{MH_PROMPTS} prefills and {MH_STEPS} decode steps, logits {tuple(dm['logits'].shape)} "
          f"bit-equal to 1 launcher's; crossing axes data; census by rank "
          f"{json.dumps([s['census'] for s in dm['stats']])}; launches by rank "
          f"{json.dumps([s['launches'] for s in dm['stats']])}")
    # 2. pipe=2 x model=2: equal streams, only the pipe hops crossing
    require(pipe["tokens"] == one["pipe"]["tokens"],
            "multihost pipe=2 model=2: streams over 2 launchers differ from 1 launcher's")
    require(all(len(t) == MH_TOKENS for t in pipe["tokens"]), "multihost pipe: a short stream")
    require([(s["coords"]["pipe"], s["launcher"]) for s in pipe["stats"]] ==
            [(0, 0), (0, 0), (1, 1), (1, 1)],
            f"multihost pipe=2 model=2: (stage, launcher) by rank "
            f"{[(s['coords']['pipe'], s['launcher']) for s in pipe['stats']]}")
    require(all(s["crossing"] == ["pipe"] for s in pipe["stats"]),
            f"multihost pipe=2 model=2: crossing axes {[s['crossing'] for s in pipe['stats']]}")
    pipe_cross = _crossing_census(pipe["stats"], "multihost pipe=2 model=2")
    require(all(set(c) == {"collective-permute"} for c in pipe_cross),
            f"multihost pipe=2 model=2: crossing collectives {pipe_cross}")
    _require_on_every_rank(pipe["stats"], ("int8_matmul", "decode_attention",
                                           "chunk_prefill_attention"),
                           "multihost pipe=2 model=2", on_card)
    print(f"multihost pipe=2 model=2 (llama-7b int8 x {PIPE_LAYERS} layers, stage 0 in launcher "
          f"0, stage 1 in launcher 1): {MH_REQUESTS} greedy streams of {MH_TOKENS} equal to 1 "
          f"launcher's; census by rank {json.dumps([s['census'] for s in pipe['stats']])}; "
          f"launches by rank {json.dumps([s['launches'] for s in pipe['stats']])}")
    return {"dm": dm["stats"], "pipe": pipe["stats"], "walls": {n: r["wall_s"]
                                                                for n, r in runs.items()}}


def multihost_server_run(launchers: list, card: str, one: dict = None) -> dict:
    """llama_decoder.yml at data=2 x model=2 served by two CLI launchers
    (``launchers``, started): ``gspmd_server_run`` through launcher 0, then
    launcher 1 must exit 0 after launcher 0's SIGINT. Prints the axes
    crossing launchers, each rank's collectives over them (every
    all-reduce over ``model``), the weights rank 0 sent to the other
    launcher and their seconds, and tok/s, TTFT p50, rank 0's step and the
    streams equal to ``one`` (the one-launcher CLI run's, ``gspmd_path``;
    None: no comparison)."""
    what = "llama_decoder data=2 model=2, 2 launchers"
    run = gspmd_server_run(launchers[0], card, what)
    rc = launchers[1].proc.wait(timeout=120)
    require(rc == 0, f"{what}: launcher 1 exited with {rc} after launcher 0's shutdown")
    text = launchers[0].log.read_text()
    crossing = re.search(r"axes crossing them: (\[.*\])", text)
    require(crossing is not None and json.loads(crossing.group(1)) == ["data"],
            f"{what}: crossing axes {crossing and crossing.group(1)}")
    weights = re.search(r"weights sent: (\{.*\})", text)
    require(weights is not None, f"{what}: no 'weights sent' line")
    weights = json.loads(weights.group(1))
    stats = [{"census": {f"{op}/{axis}": n for op, by in c.items() for axis, n in by.items()},
              "crossing": ["data"]} for c in run["census"]]
    crossing_by_rank = _crossing_census(stats, what)
    for c, x in zip(run["census"], crossing_by_rank):
        require(set(c.get("all-reduce", {})) == {"model"}, f"{what}: all-reduces {c}")
        require(set(x) <= {"all-gather"}, f"{what}: crossing collectives {x}")
    g = run["summary"]["generation"]
    print(f"{what} on {card}: started in {run['start_s']:.1f} s; weights sent by rank 0 "
          f"{weights['mb']:.1f} MB in {weights['s']:.2f} s, to launcher 1 "
          f"{weights['other_launchers']['mb']:.1f} MB in {weights['other_launchers']['s']:.2f} "
          f"s; {g['tokens_per_s']:.1f} tok/s, TTFT p50 {g['ttft_ms']['p50']:.1f} ms, rank 0's "
          f"decode step {run['step_ms']:.2f} ms")
    equal = None
    if one is not None:
        equal = sum(toks == one["tokens"].get(rid) for rid, toks in run["tokens"].items())
        o = one["summary"]["generation"]
        print(f"{what}, the 1-launcher CLI run beside it: started in {one['start_s']:.1f} s; "
              f"{o['tokens_per_s']:.1f} tok/s, TTFT p50 {o['ttft_ms']['p50']:.1f} ms, rank 0's "
              f"decode step {one['step_ms']:.2f} ms; {equal} of {len(run['tokens'])} streams "
              "equal (reported, not required: bf16 ties)")
    return dict(run, weights=weights, streams_equal=equal, crossing=crossing_by_rank)


def multihost_killed(pair: list, card: str) -> dict:
    """Two launchers of llama-tiny at data=2 x model=2 (two ranks each, over
    gloo: a launcher of one rank would count the shared card as its own
    and choose nccl), serving: launcher 1's rank 3 is killed, and both
    launchers must exit non-zero within ``MH_KILL_TIMEOUT_S``."""
    import os
    import signal

    pair[0].wait_ready(timeout=600)
    pid = int(re.search(r"rank 3 pid (\d+)", pair[1].log.read_text()).group(1))
    os.kill(pid, signal.SIGKILL)
    t1 = time.perf_counter()
    codes = [srv.proc.wait(timeout=MH_KILL_TIMEOUT_S + 60) for srv in pair]
    took = time.perf_counter() - t1
    require(all(c != 0 for c in codes), f"multihost killed rank: launcher exit codes {codes}")
    require(took <= MH_KILL_TIMEOUT_S, f"multihost killed rank: the launchers took {took:.1f} s")
    print(f"multihost killed rank (llama-tiny data=2 x model=2, 2 launchers of 2 ranks on "
          f"{card}, --timeout-s {MH_KILL_TIMEOUT_S}): launcher 1's rank 3 (pid {pid}) killed; the "
          f"launchers exited with {codes} in {took:.1f} s")
    return {"codes": codes, "s": took}


def multihost_path(card: str, one: dict) -> dict:
    """The multi-host group: llama_decoder.yml at data=2 x model=2 from the
    CLI as two launchers of two ranks joined at a local coordinator and a
    killed pair of llama-tiny launchers, started first, and the rank
    worlds over 2 launchers and over 1 (side by side) while they build;
    ``one``: the
    one-launcher CLI run of ``gspmd_path``. Returns the numbers and the
    launches by rank."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        workdir = Path(tmp)
        served = launcher_pair(CONFIG, workdir, "llama_multihost", {
            "devices.mesh": GSPMD_MESH, "model.options.layers": GSPMD_LAYERS})
        tiny = {"model.family": "llama-tiny", "model.compute_dtype": "FP32",
                "model.options": {k: v for k, v in dict(TINY_PIPE, layers=2).items()
                                  if k != "pipe_microgroups"},
                "devices.mesh": GSPMD_MESH,
                "inputs": [{"name": "input_ids", "dims": [64], "dtype": "INT64"}],
                "outputs": [{"name": "logits", "dims": [64, 2048], "dtype": "FP32"}]}
        killed = launcher_pair(CONFIG, workdir, "multihost_killed", tiny,
                               args=["--timeout-s", str(MH_KILL_TIMEOUT_S)])
        servers = served + killed
        try:
            for srv in servers:
                srv.start()
            with ThreadPoolExecutor(1) as pool:  # the kill as soon as its pair serves
                kill = pool.submit(multihost_killed, killed, card)
                worlds = multihost_worlds(workdir, card)
                run = multihost_server_run(served, card, one)
                kill = kill.result()
        except BaseException:
            show_logs(servers)
            raise
        finally:
            for srv in servers:
                srv.kill()
    return {"worlds": worlds, "llama": run, "killed": kill}


# -- the head-layout group: every q/kv ratio and head width, model > kv heads ---

HL_KV_HEADS = 2      # llama_decoder.yml's llama-1b with kv_heads 2 set in code: q/kv 16
HL_LAYERS = 4        # its 16 layers cut to 4 in the group's engines for the run's time limit
HL_SLOTS = 16        # its engines' slots (cut from 128: the phase serves 16 requests)
HL_REQUESTS, HL_TOKENS, HL_PROMPT, HL_LONG = 16, 32, 64, 600  # one prompt of 600 chunks (K4)
HL_MESH_TOKENS = 16  # the model=4 world's streams (cut from 32 for the run's time limit)
HL_MODEL = 4         # the GSPMD world: data=1 x model=4, one replicated kv head a rank
HL_BERT_MODEL = 8    # bert_long.yml at model=8: 12 heads over 8 ranks
HL_BERT_LAYERS = 2   # bert_long.yml cut from 12 layers for the run's time limit
HL_BERT_ROWS = 8
# (q/kv ratio, head dim) of the kernel checks: ratios above 8 (ChatGLM2 and
# Falcon-40B's 16, a 32, Qwen2.5-7B's 7, Falcon-7B's MQA 71) at llama-1b's
# D = 64, then the widths of Phi-2 (80), Phi-3-mini (96) and Gemma (256)
HL_CHECKS = ((16, 64), (32, 64), (7, 64), (71, 64), (8, 80), (8, 96), (8, 256))
HL_CHECK_S, HL_CHECK_T, HL_CHECK_HKV, HL_CHECK_W, HL_PAGE = 8, 256, 2, 5, 16
HL_KERNELS = ("int4_matmul", "decode_attention", "causal_attention", "chunk_prefill_attention")


def _hl_cache(g, dev, s, t, hkv, d):
    """An int8 cache [S, T, Hkv, D] with its f32 scales (logits of std ~4
    against q ~ N(0, 1))."""
    import torch

    return (torch.randint(-127, 128, (s, t, hkv, d), device=dev, generator=g, dtype=torch.int8),
            torch.randint(-127, 128, (s, t, hkv, d), device=dev, generator=g, dtype=torch.int8),
            torch.rand(s, t, hkv, device=dev, generator=g) * 0.03 + 0.05,
            torch.rand(s, t, hkv, device=dev, generator=g) / 127 + 1e-3)


def _hl_paged(g, dense, page):
    """``dense`` scattered into a shuffled pool of ``page``-row pages (page
    0 unused, its scales NaN: a read of it shows) and the table."""
    import torch

    s, t = dense[0].shape[:2]
    pps = t // page
    dev = dense[0].device
    table = (torch.randperm(s * pps, device=dev, generator=g) + 1).reshape(s, pps).to(torch.int32)
    pools = []
    for a in dense:
        pool = torch.zeros((s * pps + 1, page) + tuple(a.shape[2:]), dtype=a.dtype, device=dev)
        pool[table.reshape(-1).long()] = a.reshape((s * pps, page) + tuple(a.shape[2:]))
        if a.dtype == torch.float32:
            pool[0] = float("nan")
        pools.append(pool)
    return pools, table


def _hl_flat(k, v, ks, vs):
    """A standard cache or pool as the FLAT layout's tensors."""
    return (k.flatten(-2), v.flatten(-2), ks.transpose(-1, -2).contiguous(),
            vs.transpose(-1, -2).contiguous())


def head_layout_checks(dev) -> dict:
    """Every decode-side kernel (K3, K9, K10, K11 and their FLAT twins
    K12a-d) and both prefill kernels (K5, K4) at each (q/kv ratio, head
    dim) of ``HL_CHECKS``, on their bf16 (tensor-core) and f32 routes,
    against their plain versions: S = ``HL_CHECK_S`` slots of T =
    ``HL_CHECK_T`` positions over 2 kv heads, windows of 5, pages of 16,
    mixed lengths (0 and the last position included); K5 at T = 128, K4 at
    C = 64 from start 64. Each bf16 call is bit-equal over two calls, and
    a flat kernel to its standard twin. Then K3 at rep 71 on 128 slots,
    where the (KV head, row group, slot) items fill the card in one split.
    Returns {kernel: [per_shape entries]}."""
    import torch

    from starpu_inference_server_tpu_torch.ops import decode_attention as da
    from starpu_inference_server_tpu_torch.ops import prefill_attention as pa

    g = torch.Generator(device=dev).manual_seed(1616)
    s, t, hkv, w = HL_CHECK_S, HL_CHECK_T, HL_CHECK_HKV, HL_CHECK_W
    out = {}

    def check(name, what, call, plain, twin=None, **info):
        got = call()
        err = attn_check(f"{name} {what}", got, plain())
        if got.dtype == torch.bfloat16:
            require(torch.equal(got, call()), f"{name} {what} gave other bits on a second call")
            if twin is not None:
                require(torch.equal(got, twin), f"{name} {what} differs from its standard twin")
        out.setdefault(name, []).append(dict(path="head_layouts", shape=what,
                                             max_abs_err=err, **info))
        return got

    for rep, d in HL_CHECKS:
        hq = hkv * rep
        for dtype in (torch.bfloat16, torch.float32):
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            info = dict(rep=rep, head_dim=d, dtype=tag)
            cache = _hl_cache(g, dev, s, t, hkv, d)
            flat = _hl_flat(*cache)
            lens = torch.randint(0, t, (s,), device=dev, generator=g, dtype=torch.int32)
            lens[0], lens[-1] = 0, t - 1
            q = torch.randn(s, hq, d, device=dev, generator=g).to(dtype)
            groups = math.ceil(rep / da.decode_group_rows(rep, d))
            splits = da.decode_split_plan(s, hkv, t, 1, rep, d).splits
            shape = f"S={s} T={t} Hq={hq} Hkv={hkv} D={d} rep={rep} {tag}"
            std = check("decode_attention", shape,
                        lambda: da.decode_attention(q, *cache, lens, rep),
                        lambda: da.decode_attention_plain(q, *cache, lens, rep),
                        row_groups=groups, splits=splits, **info)
            check("flat_decode_attention", shape,
                  lambda: da.flat_decode_attention(q, *flat, lens, rep),
                  lambda: da.flat_decode_attention_plain(q, *flat, lens, rep), twin=std, **info)
            wl = torch.randint(0, t - w + 1, (s,), device=dev, generator=g, dtype=torch.int32)
            wl[0], wl[-1] = 0, t - w
            qw = torch.randn(s, w, hq, d, device=dev, generator=g).to(dtype)
            groups = math.ceil(w * rep / da.decode_group_rows(w * rep, d))
            splits = da.decode_split_plan(s, hkv, t, w, rep, d).splits
            wshape = f"S={s} W={w} T={t} Hq={hq} Hkv={hkv} D={d} rep={rep} {tag}"
            std = check("window_decode_attention", wshape,
                        lambda: da.window_decode_attention(qw, *cache, wl, rep),
                        lambda: da.window_decode_attention_plain(qw, *cache, wl, rep),
                        row_groups=groups, splits=splits, **info)
            check("flat_window_decode_attention", wshape,
                  lambda: da.flat_window_decode_attention(qw, *flat, wl, rep),
                  lambda: da.flat_window_decode_attention_plain(qw, *flat, wl, rep), twin=std,
                  **info)
            pools, table = _hl_paged(g, cache, HL_PAGE)
            fpools = _hl_flat(*pools)
            pshape = f"S={s} page={HL_PAGE} T={t} Hq={hq} Hkv={hkv} D={d} rep={rep} {tag}"
            std = check("paged_decode_attention", pshape,
                        lambda: da.paged_decode_attention(q, *pools, table, lens, rep),
                        lambda: da.paged_decode_attention_plain(q, *pools, table, lens, rep),
                        **info)
            check("flat_paged_decode_attention", pshape,
                  lambda: da.flat_paged_decode_attention(q, *fpools, table, lens, rep),
                  lambda: da.flat_paged_decode_attention_plain(q, *fpools, table, lens, rep),
                  twin=std, **info)
            std = check("paged_window_decode_attention", f"W={w} {pshape}",
                        lambda: da.paged_window_decode_attention(qw, *pools, table, wl, rep),
                        lambda: da.paged_window_decode_attention_plain(qw, *pools, table, wl,
                                                                       rep), **info)
            check("flat_paged_window_decode_attention", f"W={w} {pshape}",
                  lambda: da.flat_paged_window_decode_attention(qw, *fpools, table, wl, rep),
                  lambda: da.flat_paged_window_decode_attention_plain(qw, *fpools, table, wl,
                                                                      rep), twin=std, **info)
            # K5 at T = 128 (two query tiles, a ragged key tile at D = 256)
            tp = 128
            qp = (3 * torch.randn(1, tp, hq, d, device=dev, generator=g)).to(dtype)
            kp = torch.randn(1, tp, hkv, d, device=dev, generator=g).to(dtype)
            vp = torch.randn(1, tp, hkv, d, device=dev, generator=g).to(dtype)
            check("causal_attention", f"B=1 T={tp} Hq={hq} Hkv={hkv} D={d} rep={rep} {tag}",
                  lambda: pa.causal_attention(qp, kp, vp, rep),
                  lambda: pa.causal_attention_plain(qp, kp, vp, rep), **info)
            # K4: a 64-row chunk from start 64 against a 256-row cache row
            c, start = 64, 64
            k_row, v_row, ks, vs = (a[0] for a in cache)
            args = ((3 * torch.randn(c, hq, d, device=dev, generator=g)).to(dtype), k_row, v_row,
                    ks * 0.2, vs, torch.randn(c, hkv, d, device=dev, generator=g).to(dtype),
                    torch.randn(c, hkv, d, device=dev, generator=g).to(dtype), start, rep)
            check("chunk_prefill_attention",
                  f"C={c} start={start} T={t} Hq={hq} Hkv={hkv} D={d} rep={rep} {tag}",
                  lambda: pa.chunk_prefill_attention(*args),
                  lambda: pa.chunk_prefill_attention_plain(*args), **info)
            del cache, flat, pools, fpools
    # one split with row groups: rep 71 (2 groups) on 128 slots of 2 kv heads
    big, rep, d = 128, 71, 64
    cache = _hl_cache(g, dev, big, t, hkv, d)
    lens = torch.randint(0, t, (big,), device=dev, generator=g, dtype=torch.int32)
    q = torch.randn(big, hkv * rep, d, device=dev, generator=g).to(torch.bfloat16)
    splits = da.decode_split_plan(big, hkv, t, 1, rep, d).splits
    require(splits == 1, f"decode_split_plan gave {splits} splits at S={big} rep {rep}")
    check("decode_attention", f"S={big} T={t} Hq={hkv * rep} Hkv={hkv} D={d} rep={rep} bf16",
          lambda: da.decode_attention(q, *cache, lens, rep),
          lambda: da.decode_attention_plain(q, *cache, lens, rep),
          rep=rep, head_dim=d, dtype="bf16", row_groups=2, splits=splits)
    return out


def _hl_decode_row(g, dev, s, t, hq, hkv, d, label, card, w=1, caches=None, lens=None) -> dict:
    """K3 (``w`` = 1) or K9 (``w`` > 1) at a path's or a row group's
    shape, timed as in ``kernel_phase``: lengths drawn in [0, T - W]
    unless given, cycled cache copies past the L2 (``caches``: a pair of
    rows at the same K/V bytes shares them), SDPA on dequantized bf16
    caches as the library yardstick. The bound reads each live K/V row
    once, whatever the row groups."""
    import torch
    import torch.nn.functional as F

    from starpu_inference_server_tpu_torch.ops import decode_attention as da

    bf16, rep = torch.bfloat16, hq // hkv
    if lens is None:
        lens = torch.randint(0, t - w + 1, (s,), device=dev, generator=g, dtype=torch.int32)
    last = lens.to(torch.int64)[:, None] + torch.arange(w, device=dev)[None, :]  # [S, W]
    live = (lens.to(torch.int64) + w).sum().item()
    nbytes = 2 * s * w * hq * d * 2 + live * hkv * (2 * d + 2 * 4) + 4 * s
    if caches is None:
        caches = [_hl_cache(g, dev, s, t, hkv, d) for _ in range(_copies(nbytes))]
    copies = len(caches)
    if w == 1:
        q = torch.randn(s, hq, d, device=dev, generator=g).to(bf16)
        name, kern, plain = "decode_attention", da.decode_attention, da.decode_attention_plain
    else:
        q = torch.randn(s, w, hq, d, device=dev, generator=g).to(bf16)
        name, kern, plain = ("window_decode_attention", da.window_decode_attention,
                             da.window_decode_attention_plain)
    got = kern(q, *caches[0], lens, rep)
    plan = da.decode_split_plan(s, hkv, t, w, rep, d)
    groups = math.ceil(w * rep / da.decode_group_rows(w * rep, d))
    shape = (f"S={s}{f' W={w}' if w > 1 else ''} T={t} Hq={hq} Hkv={hkv}"
             f"{f' D={d}' if d != 64 else ''} rep={rep} live={live}")
    err = attn_check(f"{name} {shape} ({label})", got, plain(q, *caches[0], lens, rep))
    require(torch.equal(got, kern(q, *caches[0], lens, rep)),
            f"{name} {shape} gave other bits on a second call")
    ms = _time_cycled(lambda i: kern(q, *caches[i], lens, rep), copies)
    plain_ms = _time_cycled(lambda i: plain(q, *caches[i], lens, rep), copies, iters=3)
    deq = [((kc.float() * ks[..., None]).to(bf16).transpose(1, 2),
            (vc.float() * vs[..., None]).to(bf16).transpose(1, 2))
           for kc, vc, ks, vs in caches[:_copies(2 * s * t * hkv * d * 2)]]
    mask = (torch.arange(t, device=dev)[None, None, :] <= last[:, :, None])[:, None]
    qt = (q[:, None] if w == 1 else q).transpose(1, 2)  # [S, Hq, W, D]
    lib_ms = _time_cycled(lambda i: F.scaled_dot_product_attention(
        qt, *deq[i], attn_mask=mask, enable_gqa=True), len(deq))
    b_ms, b_by = bound_ms(nbytes, 4.0 * (last + 1).sum().item() * hq * d)
    print(f"time {name} {shape} ({label}, {plan.splits} splits, {groups} row group(s)) on "
          f"{card}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}); {copies} cache copies cycled")
    return dict(path=label, shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, splits=plan.splits,
                row_groups=groups)


def _hl_k5_row(g, dev, t, hq, hkv, d, label, card) -> dict:
    import torch
    import torch.nn.functional as F

    from starpu_inference_server_tpu_torch.ops import prefill_attention as pa

    bf16, rep = torch.bfloat16, hq // hkv
    q = (3 * torch.randn(1, t, hq, d, device=dev, generator=g)).to(bf16)
    k = torch.randn(1, t, hkv, d, device=dev, generator=g).to(bf16)
    v = torch.randn(1, t, hkv, d, device=dev, generator=g).to(bf16)
    shape = f"B=1 T={t} Hq={hq} Hkv={hkv} rep={rep}"
    got = pa.causal_attention(q, k, v, rep)
    err = attn_check(f"causal_attention {shape} ({label})", got,
                     pa.causal_attention_plain(q, k, v, rep))
    require(torch.equal(got, pa.causal_attention(q, k, v, rep)),
            f"causal_attention {shape} gave other bits on a second call")
    ms = time_ms(lambda: pa.causal_attention(q, k, v, rep))
    plain_ms = time_ms(lambda: pa.causal_attention_plain(q, k, v, rep), iters=5)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                            enable_gqa=True))
    b_ms, b_by = bound_ms(2 * t * hq * d * 2 + 2 * t * hkv * d * 2,
                          4.0 * hq * d * t * (t + 1) / 2)
    print(f"time causal_attention {shape} ({label}) on {card}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(path=label, shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def _hl_k4_row(g, dev, c, start, t, hq, hkv, d, label, card) -> dict:
    import torch
    import torch.nn.functional as F

    from starpu_inference_server_tpu_torch.ops import prefill_attention as pa

    bf16, rep = torch.bfloat16, hq // hkv
    k_row, v_row, ks, vs = (a[0] for a in _hl_cache(g, dev, 1, t, hkv, d))
    ks = ks * 0.2  # the cached rows dequantize to std ~1, as the chunk's keys
    q = (3 * torch.randn(c, hq, d, device=dev, generator=g)).to(bf16)
    kc = torch.randn(c, hkv, d, device=dev, generator=g).to(bf16)
    vc = torch.randn(c, hkv, d, device=dev, generator=g).to(bf16)
    args = (q, k_row, v_row, ks, vs, kc, vc, start, rep)
    shape = f"C={c} start={start} T={t} Hq={hq} Hkv={hkv} rep={rep}"
    got = pa.chunk_prefill_attention(*args)
    err = attn_check(f"chunk_prefill_attention {shape} ({label})", got,
                     pa.chunk_prefill_attention_plain(*args))
    require(torch.equal(got, pa.chunk_prefill_attention(*args)),
            f"chunk_prefill_attention {shape} gave other bits on a second call")
    ms = time_ms(lambda: pa.chunk_prefill_attention(*args))
    plain_ms = time_ms(lambda: pa.chunk_prefill_attention_plain(*args), iters=5)
    kd = torch.cat([(k_row[:start].float() * ks[:start, :, None]).to(bf16), kc]).transpose(0, 1)
    vd = torch.cat([(v_row[:start].float() * vs[:start, :, None]).to(bf16), vc]).transpose(0, 1)
    cols = torch.arange(start + c, device=dev)
    mask = cols[None, :] <= (start + torch.arange(c, device=dev))[:, None]
    qt = q.transpose(0, 1)[None]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kd[None], vd[None],
                                                            attn_mask=mask, enable_gqa=True))
    b_ms, b_by = bound_ms(2 * c * hq * d * 2 + start * hkv * (2 * d + 8) + 2 * c * hkv * d * 2,
                          4.0 * hq * d * (c * start + c * (c + 1) / 2))
    print(f"time chunk_prefill_attention {shape} ({label}) on {card}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(path=label, shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def head_layout_kernel_rows(dev, card) -> dict:
    """``head_layout_checks``, then timed rows. K1, K3, K5 and K4 at the
    shapes the group's paths give them: llama-1b with 2 kv heads on one
    device (32 q heads, q/kv 16; K1 on the fused qkv, N = 2304; K3 at
    ``HL_SLOTS`` slots of 1024 positions and at llama_decoder.yml's own 128
    slots; K5 at the 64-token bucket, K4 at a 256-row chunk from 256) and
    a rank's shard at model=4 (8 q heads over 1 replicated kv head, q/kv
    8; K1 on every int4 layer's shard). K1 at the decode M (16 slots), the
    64-token prompt and the 256-token chunk (the lm head at M = 1 for a
    prefill's last row), each held against its plain version (1e-4
    max|ref|) and bit-equal over two calls. Then the row groups' cost:
    K3 at Falcon-7B's MQA (71 heads over one kv head: 2 groups) beside 64
    heads (one group) on the same cache, K9 at W = 5 and q/kv 16 (80 rows:
    2 groups) beside q/kv 12 (60 rows: one group), and K3 at Gemma-2B's
    D = 256 (8 heads over one kv head). Returns {kernel: [per_shape
    entries]}; the timed ones have ``ms``."""
    import torch

    t0 = time.perf_counter()
    rows = head_layout_checks(dev)
    print(f"head layouts: {sum(len(v) for v in rows.values())} kernel checks at q/kv ratios and "
          f"head dims {list(HL_CHECKS)} in {time.perf_counter() - t0:.1f} s, every one within its "
          "tolerance of its plain version")
    g = torch.Generator(device=dev).manual_seed(1617)
    d, h, inter, vocab = 64, 2048, 5504, 32000  # llama-1b
    one, shard = "head_layouts_rep16", f"head_layouts_model{HL_MODEL}_shard"
    qh, kvh = 32 // HL_MODEL, 1
    k1 = [(one, "qkv", m, h, (32 + 2 * HL_KV_HEADS) * d) for m in (HL_SLOTS, HL_PROMPT, 256)]
    for m in (HL_SLOTS, HL_PROMPT, 256):
        k1 += [(shard, "qkv", m, h, (qh + 2 * kvh) * d), (shard, "o", m, qh * d, h),
               (shard, "gate_up", m, h, 2 * inter // HL_MODEL),
               (shard, "down", m, inter // HL_MODEL, h)]
    k1 += [(shard, "lm_head", m, h, vocab // HL_MODEL) for m in (HL_SLOTS, 1)]
    rows.setdefault("int4_matmul", [])
    for path, layer, m, k, n in k1:
        rows["int4_matmul"].append(dict(_k1_entry(g, dev, m, k, n, f"{path} {layer}", card),
                                        path=path))
    for hq, hkv, label in ((32, HL_KV_HEADS, one), (qh, kvh, shard)):
        rows["decode_attention"].append(_hl_decode_row(g, dev, HL_SLOTS, 1024, hq, hkv, d, label,
                                                       card))
        rows["causal_attention"].append(_hl_k5_row(g, dev, HL_PROMPT, hq, hkv, d, label, card))
        rows["chunk_prefill_attention"].append(_hl_k4_row(g, dev, 256, 256, 1024, hq, hkv, d,
                                                          label, card))
    rows["decode_attention"].append(_hl_decode_row(g, dev, 128, 1024, 32, HL_KV_HEADS, d,
                                                   "head_layouts_rep16_128_slots", card))
    # row groups beside one group at the same K/V bytes (the same cache
    # copies and lengths): each further group reads the KV head again
    t = 1024
    for name, s, w, hkv, (rep, rep1) in (("decode_attention", 128, 1, 1, (71, 64)),
                                         ("window_decode_attention", 16, 5, 2, (16, 12))):
        lens = torch.randint(0, t - w + 1, (s,), device=dev, generator=g, dtype=torch.int32)
        caches = [_hl_cache(g, dev, s, t, hkv, d)
                  for _ in range(_copies(s * t * hkv * (2 * d + 8) / 2))]
        multi, single = (_hl_decode_row(g, dev, s, t, hkv * r, hkv, d, "head_layouts_row_groups",
                                        card, w=w, caches=caches, lens=lens)
                         for r in (rep, rep1))
        require(multi["row_groups"] > 1 and single["row_groups"] == 1,
                f"{name}: row groups {multi['row_groups']} / {single['row_groups']} at q/kv "
                f"{rep} / {rep1}")
        multi["one_group"] = dict(shape=single["shape"], ms=single["ms"],
                                  bound_ms=single["bound_ms"])
        print(f"row groups of {name} S={s} W={w} T={t} Hkv={hkv} on {card}: q/kv {rep} in "
              f"{multi['row_groups']} groups {multi['ms']:.4f} ms "
              f"({multi['ms'] / multi['bound_ms']:.2f}x its bound), q/kv {rep1} in one group "
              f"{single['ms']:.4f} ms ({single['ms'] / single['bound_ms']:.2f}x); ratio "
              f"{multi['ms'] / single['ms']:.2f}")
        rows.setdefault(name, []).extend([multi, single])
        del caches
    rows["decode_attention"].append(_hl_decode_row(g, dev, 128, t, 8, 1, 256,
                                                   "head_layouts_gemma_d256", card))
    return rows


def _hl_prompts(spec) -> list:
    """The group's requests: prompts of 64 and, fourth, one of 600 (it
    chunks: K4)."""
    import numpy as np

    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, spec.vocab, HL_PROMPT).astype(np.int32)
               for _ in range(HL_REQUESTS - 1)]
    prompts.insert(3, rng.integers(0, spec.vocab, HL_LONG).astype(np.int32))
    return prompts


def head_layout_one_device(engine, counters, card, dev) -> dict:
    """``engine``: llama_decoder.yml with ``kv_heads: 2`` set in code
    (llama-1b widths, ``HL_LAYERS`` layers, int4 weights, int8 cache, q/kv 16) on one
    device, ``HL_SLOTS`` slots. The model kernels on vs off
    (``model_phase``), then ``HL_REQUESTS`` greedy requests of
    ``HL_TOKENS`` (``_hl_prompts``) through K1, K3, K4 and K5 (every
    prefill and chunk through its kernel, every block a graph replay);
    then the same weights dequantized to f32 in an FP32 engine, kernels on
    against off (``kernels_on_off_streams``: the f32 routes at q/kv 16),
    whose streams must be equal. Returns the launches, the streams and
    their prompts."""
    import numpy as np
    import torch

    spec = engine.spec
    require((spec.hidden, spec.q_heads, spec.kv_heads, spec.head_dim) == (2048, 32, 2, 64),
            f"llama_decoder with kv_heads 2: spec {spec}")
    what = f"llama_decoder q/kv {spec.q_heads}/{spec.kv_heads}"
    per_step = model_phase(engine, dev, counters, what=f"int4 q/kv {spec.rep}")
    prompts = _hl_prompts(spec)
    outs, launches = generate_all(engine, prompts, HL_TOKENS, counters, HL_KERNELS, what, card,
                                  dense_prefills=True, decode_kernel="decode_attention")
    f32 = _dequantized(engine.params)
    rng = np.random.default_rng(17)
    lens = [10, 20, 50, 100, 200, 7, 64, 128]  # buckets 16-128; 200 in two chunks
    witness = [rng.integers(0, spec.vocab, n).astype(np.int32) for n in lens]
    kernels_on_off_streams(spec, f32, witness, counters, card, dev,
                           f"{what} (its int4 weights dequantized)")
    del f32
    torch.cuda.empty_cache()
    return {"per_step": per_step, "launches": launches, "outs": outs, "prompts": prompts}


def head_layout_world(rank, world, init_method, payload):
    """llama_decoder.yml with ``kv_heads: 2`` set in code at data=1 x
    model=``HL_MODEL`` (4 ranks sharing the card, gloo): each rank computes
    8 q heads and 1 kv head, replicated on the 2 ranks whose q heads read
    it. Rank 0 draws the tree once and first serves it on one device
    (``head_layout_one_device``, the followers waiting), then holds the
    mesh against that engine: the same requests at ``HL_MESH_TOKENS``
    tokens (streams equal to the one-device streams' first tokens counted,
    not required: bf16 sums in another order), 16 first prefills and a
    decode step within ``GSPMD_LOGITS_TOL``; K1, K3, K4, K5 on every rank;
    and the census of one decode step on every rank (2 all-reduces over
    ``model`` a layer and 2 all-gathers: none for the replicated heads).
    ``payload`` may name another ``device`` and config (``llama``), and
    the ``card``."""
    from starpu_inference_server_tpu_torch.models.decoder import local_heads
    from starpu_inference_server_tpu_torch.models.registry import build_model, get_family
    from starpu_inference_server_tpu_torch.ops import _build
    from starpu_inference_server_tpu_torch.parallel.launch import follow, join_mesh
    from starpu_inference_server_tpu_torch.parallel.mesh import MeshAxes
    from starpu_inference_server_tpu_torch.serving.generation import (
        GenerationRequest,
        build_generation_engine,
    )
    from starpu_inference_server_tpu_torch.utils.config import load_config
    from starpu_inference_server_tpu_torch.weights import receive_shard, scatter_shards

    mesh = join_mesh(MeshAxes(model=HL_MODEL), rank, world, init_method,
                     payload.get("device", "cuda"), timeout_s=900.0)
    dev = mesh.device
    on_card = dev.type == "cuda"
    base = _cfg_with(load_config(str(payload.get("llama", CONFIG))), kv_heads=HL_KV_HEADS,
                     num_slots=HL_SLOTS, layers=HL_LAYERS)
    cfg = _on_mesh(base, model=HL_MODEL)
    spec = get_family(cfg.model.family, cfg.model.options).spec
    tree = build_model(cfg.model, seed=cfg.seed, device=dev).params if rank == 0 else None
    shard = (scatter_shards(tree, spec, cfg.model.family, mesh) if rank == 0
             else receive_shard(mesh))
    eng = build_generation_engine(cfg, mesh=mesh, params=shard)
    if rank != 0:
        follow(eng.worker)
        return {"backend": mesh.backend}
    what = f"llama_decoder q/kv {spec.q_heads}/{spec.kv_heads} data=1 model={HL_MODEL}"
    res = {"backend": mesh.backend, "local_heads": local_heads(spec, mesh)}
    try:
        require(res["local_heads"] == (spec.q_heads // HL_MODEL, 1),
                f"{what}: a rank's (q, kv) heads {res['local_heads']}")
        ref = build_generation_engine(base, device=dev, params=tree)
        res["one"] = one = head_layout_one_device(ref, _build.launch_counters(),
                                                  payload.get("card", "cpu"), dev)
        reqs = [GenerationRequest(prompt_ids=p, max_new_tokens=HL_MESH_TOKENS)
                for p in one["prompts"]]
        eng.worker.reset_stats()
        for r in reqs:
            eng.submit(r)
        t1 = time.perf_counter()
        eng.start()
        try:
            got = [r.result(timeout=600.0) for r in reqs]
        finally:
            eng.stop()
        wall = time.perf_counter() - t1
        stats = _phase_stats(eng.worker)
        steps, step_s = eng.steps, eng.loop_timers["step"]
        equal = sum(a == b[:HL_MESH_TOKENS] for a, b in zip(got, one["outs"]))
        _require_on_every_rank(stats, HL_KERNELS, what, on_card)
        short = [p for p in one["prompts"] if len(p) == HL_PROMPT]
        res["logits"] = _decoder_logits_check(eng, ref, short, list(range(len(short))), what)
        step_census = _step_census(eng, spec, len(short), what)
        res.update(streams_equal=equal, wall_s=wall, steps=steps,
                   step_ms=1e3 * step_s / max(steps, 1), stats=stats, step_census=step_census)
        del ref
    finally:
        eng.worker.stop_followers()
    return res


def head_layout_bert_world(rank, world, init_method, payload):
    """bert_long.yml (BERT-base W8A8, s = 512, cut to ``HL_BERT_LAYERS``
    layers) at model=``HL_BERT_MODEL`` (8 ranks sharing the card, gloo)
    through ``ModelEngine``: 12 heads that 8 ranks do not divide, so every
    rank gathers q, k and v and runs all 12 heads through K7. Rank 0 holds
    ``HL_BERT_ROWS`` padded samples against one device's apply within
    ``GSPMD_LOGITS_TOL``; K7 once a layer on every rank. ``payload`` may
    name another ``device`` and config (``bert``)."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.core.engine import ModelEngine
    from starpu_inference_server_tpu_torch.models.registry import build_model
    from starpu_inference_server_tpu_torch.parallel.census import collectives_by_axis
    from starpu_inference_server_tpu_torch.parallel.launch import (
        follow,
        follower_engine,
        join_mesh,
    )
    from starpu_inference_server_tpu_torch.parallel.mesh import MeshAxes
    from starpu_inference_server_tpu_torch.utils.config import load_config

    mesh = join_mesh(MeshAxes(model=HL_BERT_MODEL), rank, world, init_method,
                     payload.get("device", "cuda"), timeout_s=900.0)
    dev = mesh.device
    cfg = _on_mesh(_with_options(load_config(str(payload.get("bert", BERT_CONFIG))),
                                 num_layers=HL_BERT_LAYERS), model=HL_BERT_MODEL)
    if rank != 0:
        follow(follower_engine(cfg, mesh).worker)
        return {"backend": mesh.backend}
    model = build_model(cfg.model, seed=cfg.seed, device=dev)
    engine = ModelEngine(cfg, model, mesh=mesh)
    what = (f"bert_long model={HL_BERT_MODEL} ({cfg.model.quantization.value}, "
            f"{HL_BERT_LAYERS} of 12 layers)")
    try:
        seq = cfg.inputs[0].dims[0]
        rng = np.random.default_rng(20)
        ids = torch.from_numpy(rng.integers(1, 30522, (HL_BERT_ROWS, seq)))
        mask = torch.ones((HL_BERT_ROWS, seq), dtype=torch.int64)
        for i in range(HL_BERT_ROWS):
            mask[i, int(rng.integers(seq // 8, seq + 1)):] = 0
        inputs = {"input_ids": ids, "attention_mask": mask}
        engine.worker.reset_stats()
        got = engine.fetch(engine.run_padded(inputs))["last_hidden_state"]
        stats = _phase_stats(engine.worker)
        with torch.inference_mode():
            want = model.apply({k: v.to(dev) for k, v in inputs.items()})["last_hidden_state"]
        close = _logits_close(f"{what}: last hidden state", got, want.float().cpu())
        launches = [s["launches"].get("bidirectional_attention", 0) for s in stats]
        if dev.type == "cuda":
            require(all(n == HL_BERT_LAYERS for n in launches),
                    f"{what}: bidirectional_attention launches by rank {launches}")
        census = [collectives_by_axis({"calls": s["census"]}) for s in stats]
        print(f"{what}: K7 launches by rank {launches} (one a layer, all 12 heads); census by "
              f"rank {json.dumps(census)}")
        return {"backend": mesh.backend, "close": close, "stats": stats, "census": census}
    finally:
        engine.worker.stop_followers()


def head_layouts_path(card: str) -> dict:
    """The head-layout group's two rank worlds at once, sharing the card:
    ``head_layout_world`` (4 ranks; rank 0 serves the one-device engine
    first) and ``head_layout_bert_world`` (8 ranks)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from starpu_inference_server_tpu_torch.parallel.launch import run_world

    print(f"time cut: llama_decoder.yml with kv_heads 2 at {HL_LAYERS} of 16 layers in the "
          f"head-layout group (formerly 16)")
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        def world(body, size, tag):
            t1 = time.perf_counter()
            rank0 = run_world(f"chip_smoke:{body}", size, {"card": card}, timeout_s=900.0,
                              workdir=str(Path(tmp) / tag))[0]
            return rank0, time.perf_counter() - t1

        with ThreadPoolExecutor(2) as pool:
            decoder = pool.submit(world, "head_layout_world", HL_MODEL, "decoder")
            encoder = pool.submit(world, "head_layout_bert_world", HL_BERT_MODEL, "bert")
            (mesh, mesh_s), (bert, bert_s) = decoder.result(), encoder.result()
    require(mesh["backend"] == "gloo" and bert["backend"] == "gloo",
            f"head-layout worlds' backends {mesh['backend']}, {bert['backend']}")
    print(f"head layouts data=1 model={HL_MODEL} (4 ranks on {card}, gloo, {mesh_s:.1f} s, rank 0 "
          f"first serving one device): (q, kv) heads a rank {mesh['local_heads']}; "
          f"{mesh['streams_equal']} of {HL_REQUESTS} greedy streams of {HL_MESH_TOKENS} tokens "
          f"equal to one device's (reported, not required: bf16 sums in another order); mesh "
          f"{mesh['wall_s']:.1f} s ({mesh['steps']} steps, rank 0's step {mesh['step_ms']:.2f} "
          f"ms host); launches by rank {json.dumps([s['launches'] for s in mesh['stats']])}; a "
          f"decode step's census by rank {json.dumps(mesh['step_census'])}")
    print(f"head layouts bert_long model={HL_BERT_MODEL} (8 ranks on {card}, gloo, {bert_s:.1f} "
          f"s, beside the model={HL_MODEL} world): max |mesh - one device| / max |one device| "
          f"{bert['close']['max_rel']:.3e}, mean rel {bert['close']['mean_rel']:.3e}")
    return {"one": mesh["one"], "mesh": mesh, "bert": bert,
            "seconds": {f"model{HL_MODEL}": round(mesh_s, 1),
                        f"bert_model{HL_BERT_MODEL}": round(bert_s, 1)}}


# -- the cut-heads group: GSPMD decoders whose heads model cuts -------------------

# published widths set in code on copies of llama_decoder.yml (int4, int8
# cache, its 1024 positions and prefill_chunk 256): Phi-3-medium (40 q over
# 10 kv heads, D = 128; 40 layers) at model=4, whose 10 kv heads 4 ranks
# neither divide nor multiply, and Qwen2.5-7B (28 q over 4 kv heads, D =
# 128; 28 layers) at model=8, which does not divide its q heads
CH_LAYOUTS = {
    "phi3": {"name": "Phi-3-medium", "model": 4, "published_layers": 40,
             "widths": {"hidden": 5120, "q_heads": 40, "kv_heads": 10, "intermediate": 17920,
                        "vocab": 32064}},
    "qwen": {"name": "Qwen2.5-7B", "model": 8, "published_layers": 28,
             "widths": {"hidden": 3584, "q_heads": 28, "kv_heads": 4, "intermediate": 18944,
                        "vocab": 152064}},
}
CH_LAYERS = {"phi3": 1, "qwen": 1}  # cut from 40 and 28 layers for the run's time limit
CH_SLOTS = 16        # every engine's slots (data=1: all of them on every rank)
CH_TOKENS = 16       # the Phi-3-medium layout's 16 requests, one device and the mesh
CH_QWEN_PROMPTS = 4  # the Qwen2.5-7B layout's first prefills and decode step


def cut_heads_cache_gb(widths: dict, layers: int, model: int, slots: int, positions: int):
    """A rank's int8 KV cache (K and V bytes, an f32 scale each a token and
    kv head) in GB, (gathered route, a per-rank route, kv heads a rank in
    that route): the gathered route holds every kv head; a per-rank route
    would hold the kv heads its block of q heads (q_heads / model of
    them, rounded up) reads, padded to the most any rank reads."""
    hq, hkv = widths["q_heads"], widths["kv_heads"]
    d, rep, block = widths["hidden"] // hq, hq // hkv, -(-hq // model)
    per_rank = max(len({q // rep for q in range(r * block, min((r + 1) * block, hq))})
                   for r in range(model))
    row = layers * slots * positions * 2 * (d + 4)  # bytes a kv head
    return hkv * row / 1e9, per_rank * row / 1e9, per_rank


def _ch_path(key) -> str:
    return f"cut_heads_{key}_model{CH_LAYOUTS[key]['model']}"


def cut_heads_kernel_rows(dev, card) -> dict:
    """Every kernel of the cut-heads worlds at the shapes they give it. K1
    at a rank's int4 shard of each layer (the fused qkv's contiguous
    columns, o's rows, gate_up's and down's blocks) at the decode M
    (``CH_SLOTS``), the 64-token prefill bucket's M (``HL_PROMPT``) and
    the chunk M (256), and at the lm head's vocab shard
    at M = ``CH_SLOTS`` and 1 (a prefill's last row); K3 at ``CH_SLOTS``
    slots of 1024 positions, K5 at the 64-token bucket and K4 at a
    256-row chunk from 256, at the whole model's head layout every rank
    runs (Hq 40 over Hkv 10, Hq 28 over Hkv 4, D = 128); K9 at W = 5 at
    Phi-3-medium's. Each held against its plain version (K1 1e-4 max|ref|,
    the attention kernels element by element) and bit-equal over two
    calls, and timed. Returns {kernel: [per_shape entries]}, each tagged
    with its world's path."""
    import torch

    g = torch.Generator(device=dev).manual_seed(1717)
    rows = {}
    for key, lay in CH_LAYOUTS.items():
        w, tp, path = lay["widths"], lay["model"], _ch_path(key)
        h, hq, hkv = w["hidden"], w["q_heads"], w["kv_heads"]
        d = h // hq
        shard = {"qkv": (h, (hq + 2 * hkv) * d // tp), "o": (hq * d // tp, h),
                 "gate_up": (h, 2 * w["intermediate"] // tp), "down": (w["intermediate"] // tp, h)}
        k1 = [(layer, m, k, n) for m in (CH_SLOTS, HL_PROMPT, 256)
              for layer, (k, n) in shard.items()]
        k1 += [("lm_head", m, h, w["vocab"] // tp) for m in (CH_SLOTS, 1)]
        for layer, m, k, n in k1:
            rows.setdefault("int4_matmul", []).append(
                dict(_k1_entry(g, dev, m, k, n, f"{path} {layer}", card), path=path))
        rows.setdefault("decode_attention", []).append(
            _hl_decode_row(g, dev, CH_SLOTS, 1024, hq, hkv, d, path, card))
        rows.setdefault("causal_attention", []).append(
            _hl_k5_row(g, dev, HL_PROMPT, hq, hkv, d, path, card))
        rows.setdefault("chunk_prefill_attention", []).append(
            _hl_k4_row(g, dev, 256, 256, 1024, hq, hkv, d, path, card))
    w = CH_LAYOUTS["phi3"]["widths"]
    rows["window_decode_attention"] = [_hl_decode_row(
        g, dev, CH_SLOTS, 1024, w["q_heads"], w["kv_heads"], w["hidden"] // w["q_heads"],
        _ch_path("phi3"), card, w=5)]
    return rows


def _step_census(eng, spec, n, what) -> list:
    """One decode step of ``n`` active slots on a data=1 GSPMD mesh, every
    rank's census of it: all-reduce/model 2L (o and down), all-gather/model
    2 (the embedding and the lm head) and L more where the ranks gather
    heads (the fused qkv a layer), nothing over ``data`` and nothing
    else."""
    import torch

    from starpu_inference_server_tpu_torch.parallel.census import collectives_by_axis
    from starpu_inference_server_tpu_torch.parallel.tp_layout import gathered_heads

    dev = eng.device
    gathers = 2 + (spec.layers if gathered_heads(spec, eng.worker.mesh.size("model")) else 0)
    eng.worker.reset_stats()
    ids = torch.zeros(eng.num_slots, dtype=torch.int32, device=dev)
    act = torch.zeros(eng.num_slots, dtype=torch.bool, device=dev)
    act[:n] = True
    eng.worker.decode(ids, act)
    census = [collectives_by_axis({"calls": s["census"]}) for s in _phase_stats(eng.worker)]
    for c in census:
        require(c.get("all-reduce") == {"model": 2 * spec.layers},
                f"{what}: a decode step's all-reduces {c}")
        require(c.get("all-gather") == {"model": gathers},
                f"{what}: a decode step's all-gathers {c}")
        require(set(c) <= {"all-reduce", "all-gather", "broadcast"},
                f"{what}: a decode step's collectives {c}")
        require(not any("data" in axis for ops in c.values() for axis in ops),
                f"{what}: a decode step's collectives over data {c}")
    return census


def cut_heads_world(rank, world, init_method, payload):
    """One world of the cut-heads group: ``payload['layout']`` (a key of
    ``CH_LAYOUTS``) set in code on a copy of llama_decoder.yml at
    ``CH_LAYERS`` layers and ``CH_SLOTS`` slots, at data=1 x model=its
    size (the ranks sharing the card, gloo). Rank 0 draws the tree once,
    sends each rank its shard, and holds the mesh (every rank every head,
    the fused qkv gathered over ``model``) against one device of the same
    tree: Phi-3-medium's layout serves ``HL_REQUESTS`` requests (one of 600
    tokens) of ``CH_TOKENS`` tokens through both engines (the one-device
    run through K1, K3, K4 and K5, every prefill and chunk through its
    kernel, every block a graph replay; the mesh's streams equal to it
    counted, not required: bf16 sums in another order) with K1, K3, K4 and
    K5 on every rank; both layouts check first-prefill and step logits
    within ``GSPMD_LOGITS_TOL`` (Qwen2.5-7B's then with K1, K3 and K5 on
    every rank in one more prefill and a decode step of the mesh alone)
    and a decode step's census (``_step_census``). ``payload``
    may name another ``device`` and config (``llama``), and the ``card``."""
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.models.decoder import local_heads
    from starpu_inference_server_tpu_torch.models.registry import build_model, get_family
    from starpu_inference_server_tpu_torch.ops import _build
    from starpu_inference_server_tpu_torch.parallel.launch import follow, join_mesh
    from starpu_inference_server_tpu_torch.parallel.mesh import MeshAxes
    from starpu_inference_server_tpu_torch.parallel.tp_layout import gathered_heads
    from starpu_inference_server_tpu_torch.serving.generation import (
        GenerationRequest,
        build_generation_engine,
    )
    from starpu_inference_server_tpu_torch.utils.config import load_config
    from starpu_inference_server_tpu_torch.weights import receive_shard, scatter_shards

    key = payload["layout"]
    lay = CH_LAYOUTS[key]
    tp, serve = lay["model"], key == "phi3"
    mesh = join_mesh(MeshAxes(model=tp), rank, world, init_method,
                     payload.get("device", "cuda"), timeout_s=900.0)
    dev = mesh.device
    on_card = dev.type == "cuda"
    base = _cfg_with(load_config(str(payload.get("llama", CONFIG))), num_slots=CH_SLOTS,
                     layers=CH_LAYERS[key], **lay["widths"])
    cfg = _on_mesh(base, model=tp)
    spec = get_family(cfg.model.family, cfg.model.options).spec
    t0 = time.perf_counter()
    tree = build_model(cfg.model, seed=cfg.seed, device=dev).params if rank == 0 else None
    tree_s = time.perf_counter() - t0
    shard = (scatter_shards(tree, spec, cfg.model.family, mesh) if rank == 0
             else receive_shard(mesh))
    eng = build_generation_engine(cfg, mesh=mesh, params=shard)
    if rank != 0:
        follow(eng.worker)
        return {"backend": mesh.backend}
    what = (f"{lay['name']}'s layout (q/kv {spec.q_heads}/{spec.kv_heads}, "
            f"{spec.layers} of {lay['published_layers']} layers) data=1 model={tp}")
    res = {"backend": mesh.backend, "local_heads": local_heads(spec, mesh), "tree_s": tree_s,
           "layers": spec.layers}
    try:
        widths = {k: getattr(spec, k) for k in lay["widths"]}
        require(widths == lay["widths"] and spec.head_dim == 128, f"{what}: spec {spec}")
        require(gathered_heads(spec, tp) and res["local_heads"] == (spec.q_heads, spec.kv_heads),
                f"{what}: a rank's (q, kv) heads {res['local_heads']}")
        require(eng.worker.cache.k[0].shape[2] == spec.kv_heads,
                f"{what}: a rank's cache holds {eng.worker.cache.k[0].shape[2]} kv heads")
        ref = build_generation_engine(base, device=dev, params=tree)
        del tree
        if serve:
            prompts = _hl_prompts(spec)
            one, res["one_launches"] = generate_all(
                ref, prompts, CH_TOKENS, _build.launch_counters(), HL_KERNELS,
                f"{what} on one device", payload.get("card", "cpu"), dense_prefills=True,
                decode_kernel="decode_attention")
            reqs = [GenerationRequest(prompt_ids=p, max_new_tokens=CH_TOKENS) for p in prompts]
            eng.worker.reset_stats()
            for r in reqs:
                eng.submit(r)
            t1 = time.perf_counter()
            eng.start()
            try:
                got = [r.result(timeout=600.0) for r in reqs]
            finally:
                eng.stop()
            res["wall_s"] = time.perf_counter() - t1
            res["stats"] = stats = _phase_stats(eng.worker)
            res["steps"], step_s = eng.steps, eng.loop_timers["step"]
            res["step_ms"] = 1e3 * step_s / max(eng.steps, 1)
            res["streams_equal"] = sum(a == b for a, b in zip(got, one))
            for i, out in enumerate(got):
                require(len(out) == CH_TOKENS and all(0 <= t < spec.vocab for t in out),
                        f"{what}: request {i} returned {out}")
            _require_on_every_rank(stats, HL_KERNELS, what, on_card)
            short = [p for p in prompts if len(p) == HL_PROMPT]
            res["logits"] = _decoder_logits_check(eng, ref, short, list(range(len(short))), what)
        else:
            rng = np.random.default_rng(17)
            short = [rng.integers(0, spec.vocab, HL_PROMPT).astype(np.int32)
                     for _ in range(CH_QWEN_PROMPTS + 1)]
            res["logits"] = _decoder_logits_check(eng, ref, short[:-1],
                                                  list(range(CH_QWEN_PROMPTS)), what)
            # the mesh alone (rank 0's counters also count the one-device
            # engine of its process): one more prefill, then a decode step
            eng.worker.reset_stats()
            eng.worker.prefill(torch.from_numpy(short[-1]).to(dev), HL_PROMPT, CH_QWEN_PROMPTS)
            ids = torch.zeros(eng.num_slots, dtype=torch.int32, device=dev)
            act = torch.arange(eng.num_slots, device=dev) <= CH_QWEN_PROMPTS
            eng.worker.decode(ids, act)
            res["stats"] = stats = _phase_stats(eng.worker)
            _require_on_every_rank(stats, ("int4_matmul", "decode_attention", "causal_attention"),
                                   what, on_card)
        res["step_census"] = _step_census(eng, spec, len(short), what)
        del ref
    finally:
        eng.worker.stop_followers()
    return res


def cut_heads_path(card: str) -> dict:
    """The cut-heads group's two rank worlds at once, sharing the card:
    ``cut_heads_world`` at Phi-3-medium's layout (4 ranks) and at
    Qwen2.5-7B's (8 ranks)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from starpu_inference_server_tpu_torch.parallel.launch import run_world

    for key, lay in CH_LAYOUTS.items():
        print(f"time cut: {lay['name']}'s layout at {CH_LAYERS[key]} of {lay['published_layers']} "
              f"layers (widths as published), {CH_SLOTS} slots, in the cut-heads group")
        whole, part, heads = cut_heads_cache_gb(lay["widths"], lay["published_layers"],
                                                lay["model"], 128, 4096)
        print(f"{lay['name']} at model={lay['model']}, {lay['published_layers']} layers, 128 slots "
              f"of 4096 positions: a rank's int8 KV cache {whole:.1f} GB on the gathered route "
              f"(every kv head), {part:.1f} GB on a per-rank route ({heads} of "
              f"{lay['widths']['kv_heads']} kv heads)")
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        def world(key):
            t1 = time.perf_counter()
            rank0 = run_world("chip_smoke:cut_heads_world", CH_LAYOUTS[key]["model"],
                              {"card": card, "layout": key}, timeout_s=900.0,
                              workdir=str(Path(tmp) / key))[0]
            return rank0, time.perf_counter() - t1

        with ThreadPoolExecutor(2) as pool:
            futures = {key: pool.submit(world, key) for key in CH_LAYOUTS}
            done = {key: f.result() for key, f in futures.items()}
    out = {key: r for key, (r, _) in done.items()}
    out["seconds"] = {_ch_path(key): round(s, 1) for key, (_, s) in done.items()}
    for key, res in done.items():
        res, seconds = res
        lay = CH_LAYOUTS[key]
        require(res["backend"] == "gloo", f"{lay['name']} world's backend {res['backend']}")
        served = (f"{res['streams_equal']} of {HL_REQUESTS} greedy streams of {CH_TOKENS} tokens "
                  f"equal to one device's (reported, not required: bf16 sums in another order); "
                  f"mesh {res['wall_s']:.1f} s ({res['steps']} steps, rank 0's step "
                  f"{res['step_ms']:.2f} ms host); " if "streams_equal" in res else "")
        print(f"cut heads {lay['name']}'s layout data=1 model={lay['model']} ({lay['model']} ranks "
              f"on {card}, gloo, {seconds:.1f} s, the tree drawn in {res['tree_s']:.1f} s): (q, kv) "
              f"heads a rank {res['local_heads']}; {served}logits max rel prefill "
              f"{res['logits']['prefill']['max_rel']:.3e} step "
              f"{res['logits']['step']['max_rel']:.3e}; launches by rank "
              f"{json.dumps([s['launches'] for s in res['stats']])}; a decode step's census by rank "
              f"{json.dumps(res['step_census'])}")
    return out


def _ptxas_kernels(report: str) -> list:
    """(mangled name, registers, spill store bytes) of each entry function
    in a ``ptxas -v`` report."""
    out = []
    for chunk in report.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        out.append((chunk.split("'", 1)[0], int(regs.group(1)) if regs else 0,
                    int(spill.group(1)) if spill else 0))
    return out


def report_build(reports: dict, build_s: dict) -> dict:
    """Print each library's nvcc seconds (all started at once on the
    host's cores; ``--phase build-times`` sets them beside another tree's)
    and its ptxas registers and spills: the attention libraries by route,
    each ``decode_mma.cuh`` instantiation by head dim and m16 tiles.
    Returns the per-instantiation tables of fused_stem and the decode-side
    kernels."""
    ptxas = {}
    print(f"build seconds by library: "
          f"{json.dumps({k: round(v, 1) for k, v in build_s.items()})}")
    for name, report in reports.items():  # ptxas -v: registers and spills of each library
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", report))
        print(f"ptxas {name}: {len(regs)} kernels, at most {max(regs, default=0)} registers, "
              f"{spills} bytes of spill stores")
        if name in ("causal_attention", "chunk_prefill_attention", "bidirectional_attention",
                    *DECODE_SIDE):
            # the attention libraries by route: the bf16 tensor-core kernels
            # (``*_mma``; ``sis::dmma`` for the decode side) and the f32
            # CUDA-core ones
            for route, tc in (("tensor-core (bf16)", True), ("CUDA-core (f32)", False)):
                ks = [k for k in _ptxas_kernels(report) if ("mma" in k[0]) == tc]
                print(f"ptxas {name} {route}: {len(ks)} kernels, registers "
                      f"{min((k[1] for k in ks), default=0)}-{max((k[1] for k in ks), default=0)}, "
                      f"spill stores {sum(k[2] for k in ks)} bytes")
        if name == "fused_stem":  # one instantiation per output type (its template argument)
            ptxas[name] = {("f32" if "fused_stem_kernelIf" in k else "bf16"): [regs_, spill]
                           for k, regs_, spill in _ptxas_kernels(report)}
            print(f"ptxas fused_stem [registers, spill store bytes]: {json.dumps(ptxas[name])}")
        if name in DECODE_SIDE:  # each instantiation of decode_mma.cuh: head dim, m16 tiles
            ptxas[name] = {f"D{m[1]}_MT{m[2]}": [regs_, spill]
                           for k, regs_, spill in _ptxas_kernels(report)
                           for m in [re.search(r"attend_kernelILi(\d+)ELi(\d+)E", k)] if m}
            print(f"ptxas {name} decode_mma.cuh [registers, spill store bytes]: "
                  f"{json.dumps(ptxas[name])}")

    return ptxas


def timed(phase_s: dict, name: str, fn, *args):
    """fn(*args), its host seconds kept in ``phase_s[name]``."""
    t0 = time.perf_counter()
    out = fn(*args)
    phase_s[name] = round(time.perf_counter() - t0, 1)
    return out


PHASES = ("head-layout-kernels", "gspmd-cut-heads", "build-times")


def phase_main(argv) -> int:
    """One group alone, for a short call to the card:

        python3 chip_smoke.py --phase head-layout-kernels
        python3 chip_smoke.py --phase gspmd-cut-heads
        python3 chip_smoke.py --phase build-times TREE [TREE ...]

    ``head-layout-kernels``: the build (nvcc seconds and ptxas reports)
    and ``head_layout_kernel_rows``, every row printed as JSON.
    ``gspmd-cut-heads``: the build and the cut-heads group with every
    check the whole run makes there (``cut_heads_kernel_rows``,
    ``cut_heads_path``), every row printed as JSON.
    ``build-times``: the kernel libraries of each TREE (the root of a
    checkout; ``.`` for this one, another commit unpacked with ``git
    archive <commit> | tar -x -C build/parent``) built in turn by
    ``ops/_build.py``'s command, one nvcc per source all started together,
    each tree into a fresh directory; give them as parent, change, change,
    parent to see the spread. Exits 1 at the first failure."""
    if len(argv) < 2 or argv[0] != "--phase" or argv[1] not in PHASES:
        print(f"usage: chip_smoke.py [--phase {{{','.join(PHASES)}}} [TREE ...]]",
              file=sys.stderr)
        return 2
    if not (ROOT / "starpu_inference_server_tpu_torch").is_dir():
        print("chip_smoke: FAIL: run from a checkout of the repository", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from starpu_inference_server_tpu_torch.ops import _build

    card = card_line()
    print(f"card: {card}")
    if argv[1] == "build-times":
        for i, tree in enumerate(argv[2:] or ["."]):
            out = ROOT / "build" / "build_times" / str(i)
            if out.is_dir():
                for lib in out.iterdir():
                    lib.unlink()
            seconds = {}
            t0 = time.perf_counter()
            _build.build_all(seconds=seconds, out=out,
                             csrc=Path(tree).resolve() / "starpu_inference_server_tpu_torch" /
                             "csrc")
            print(f"build times of {tree} (run {i}) on {card}: wall "
                  f"{time.perf_counter() - t0:.1f} s; by library "
                  f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
        return 0
    t0 = time.perf_counter()
    build_s = {}
    report_build(_build.build_all(seconds=build_s), build_s)
    print(f"build: {time.perf_counter() - t0:.1f} s")
    if argv[1] == "gspmd-cut-heads":
        rows = cut_heads_kernel_rows(torch.device("cuda"), card)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cut_heads_path(card)
        print(f"cut-heads worlds: {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"cut_heads_rows": rows}))
        return 0
    rows = head_layout_kernel_rows(torch.device("cuda"), card)
    print(json.dumps({"head_layout_rows": rows}))
    return 0


def main() -> int:
    pkg = ROOT / "starpu_inference_server_tpu_torch"
    configs = (CONFIG, BERT_CONFIG, RESNET_CONFIG, W4A8_CONFIG, SPEC_CONFIG, LOOKUP_CONFIG,
               PAGED_CONFIG, VIT_CONFIG, NHWC_CONFIG, MOE_CONFIG, PIPE_CONFIG)
    if not pkg.is_dir() or not all(c.is_file() for c in configs):
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

    from concurrent.futures import ThreadPoolExecutor

    from starpu_inference_server_tpu_torch.models.registry import build_model
    from starpu_inference_server_tpu_torch.ops import _build
    from starpu_inference_server_tpu_torch.serving.generation import build_generation_engine
    from starpu_inference_server_tpu_torch.utils.config import load_config

    t_run = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build_s = {}
    cfg = load_config(str(CONFIG))
    # nvcc runs while the host draws the decoder's int4 tree (numpy), which
    # launches no kernel of the port
    with ThreadPoolExecutor(1) as pool:
        build = pool.submit(_build.build_all, seconds=build_s)
        tree = build_model(cfg.model, seed=cfg.seed, device=dev).params
        tree_s = time.perf_counter() - t0
        reports = build.result()
    phase_s = {"build": round(time.perf_counter() - t0, 1)}
    print(f"build: {len(_build.KERNELS)} kernel libraries ready in {phase_s['build']} s (the "
          f"{cfg.model.family} int4 tree drawn beside it in {tree_s:.1f} s)")
    ptxas = report_build(reports, build_s)

    t0 = time.perf_counter()
    engine = build_generation_engine(cfg, device="cuda", params=tree)
    del tree
    print(f"engine: {cfg.model.family} ({cfg.model.quantization.value}, "
          f"{cfg.model.compute_dtype}) built in {time.perf_counter() - t0:.1f} s")

    counters = _build.launch_counters()
    rows = timed(phase_s, "kernels (int4 decoder)", kernel_phase, engine.spec,
                 cfg.model.options, dev)
    per_step = timed(phase_s, "model (int4 decoder)", model_phase, engine, dev, counters)
    launches, dec_prompts, dec_outs = timed(phase_s, "serving (int4 decoder)", serving_phase,
                                            engine, counters, card)
    block = timed(phase_s, "decode block", decode_block_phase, engine, card,
                  rows["int4_matmul"]["decode_step_ms"])
    rows["decode_attention"]["graph_block_ms"] = block["graph"]["attention_ms"]
    spec, int4_params = engine.spec, engine.params  # the W4A8 path reuses the int4 tree
    del engine
    torch.cuda.empty_cache()
    timed(phase_s, "sampling", sampling_phase, spec, int4_params, counters, card, dev)
    timed(phase_s, "tiny", tiny_phase, rows, counters, card, dev)

    rows.update(timed(phase_s, "kernels (batch)", batch_kernel_phase, dev))
    bert_launches, bert_forward = timed(phase_s, "bert_long", bert_path, counters, card)
    resnet_launches, resnet_forward = timed(phase_s, "resnet18_int8", resnet_path, counters,
                                            card)
    for name in BERT_KERNELS:
        launches[name] = bert_launches[name]
    for name in RESNET_KERNELS:
        launches[name] = resnet_launches[name]
    vit_launches, vit_forward = timed(phase_s, "vit_l_16", vit_path, counters, card)
    nhwc_launches, nhwc_forward = timed(phase_s, "resnet18_nhwc (W8A8)", resnet_w8a8_path,
                                        counters, card)

    rows.update(timed(phase_s, "kernels (int8)", int8_kernel_phase, spec, dev, card))
    for name, entries in timed(phase_s, "kernels (narrow N)", narrow_matmul_rows, dev,
                               card).items():
        rows[name]["per_shape"].extend(entries)
    rows.update(timed(phase_s, "kernels (extras)", extras_kernel_phase, spec, dev, card))
    extra_launches, extra_step, ctx = timed(phase_s, "extras", extras_path, spec, int4_params,
                                            counters, card, dev)
    launches.update(extra_launches)

    k3 = rows["decode_attention"]
    k3.pop("lengths")
    rows.update(timed(phase_s, "kernels (flat)", flat_kernel_phase, spec,
                      [r.pop("lengths") for r in k3["per_shape"]], dev))
    extra_step.update(timed(phase_s, "model (flat)", flat_step_phase, spec, ctx["params"],
                            counters, dev))
    launches.update(timed(phase_s, "flat", flat_path, int4_params, (dec_prompts, dec_outs), ctx,
                          counters, card, dev))
    del int4_params, ctx
    torch.cuda.empty_cache()
    moe_launches, moe = timed(phase_s, "moe_decoder", moe_path, counters, card, dev)
    logits_launches, _ = timed(phase_s, "serve_logits", serve_logits_path, counters, card)
    torch.cuda.empty_cache()
    clients = timed(phase_s, "clients and checkpoints", clients_path, card)
    gen_launches = clients["gen_launches"]
    torch.cuda.empty_cache()
    pipe_rows, pipe_k2_step = timed(phase_s, "kernels (pipelined)", pipelined_kernel_rows, dev,
                                    card)
    for name, entries in pipe_rows.items():
        rows[name]["per_shape"].extend(entries)
    torch.cuda.empty_cache()
    pipe = timed(phase_s, "pipelined (llama_pipelined, 4 ranks)", pipelined_path, card)
    torch.cuda.empty_cache()
    for name, entries in timed(phase_s, "kernels (gspmd)", gspmd_kernel_rows, dev, card).items():
        rows[name].setdefault("per_shape", []).extend(entries)
    torch.cuda.empty_cache()
    gspmd = timed(phase_s, "gspmd (data, expert, model meshes; 4 ranks)", gspmd_path, card)
    torch.cuda.empty_cache()
    multihost = timed(phase_s, "multihost (2 launchers of 2 ranks)", multihost_path, card,
                      gspmd["llama"])
    torch.cuda.empty_cache()
    hl_rows = timed(phase_s, "kernels (head layouts)", head_layout_kernel_rows, dev, card)
    ch_rows = timed(phase_s, "kernels (cut heads)", cut_heads_kernel_rows, dev, card)
    torch.cuda.empty_cache()

    def head_and_cut_worlds():  # the two groups' four rank worlds side by side on the card
        with ThreadPoolExecutor(2) as pool:
            heads_f, cut_f = pool.submit(head_layouts_path, card), pool.submit(cut_heads_path, card)
            return heads_f.result(), cut_f.result()

    heads, cut = timed(phase_s, "head layouts (q/kv 16; model=4 over 2 kv heads; bert model=8) "
                       "beside gspmd cut heads (Phi-3-medium model=4; Qwen2.5-7B model=8)",
                       head_and_cut_worlds)
    # launches on the head-layout paths: the one-device engine's serving
    # run, and by rank the model=4 world's streams and the bert world's
    # forward; the timed rows carry the launches of the run they stand for
    hm = heads["mesh"]["stats"]
    head_launches = {name: {"llama_decoder_kv2_one_device": heads["one"]["launches"][name],
                            "llama_decoder_kv2_model4_by_rank": [s["launches"].get(name, 0)
                                                                 for s in hm]}
                     for name in HL_KERNELS}
    head_launches["bidirectional_attention"] = {"bert_long_model8_by_rank": [
        s["launches"].get("bidirectional_attention", 0) for s in heads["bert"]["stats"]]}
    for name, entries in hl_rows.items():
        for e in entries:
            if e["path"] == "head_layouts_rep16":
                e["launches"] = heads["one"]["launches"][name]
            elif e["path"].startswith("head_layouts_model"):
                e["launches_by_rank"] = [s["launches"].get(name, 0) for s in hm]
        rows[name].setdefault("per_shape", []).extend(entries)
    # launches on the cut-heads paths: Phi-3-medium's one-device run, and by
    # rank each world's counted run (the served requests; Qwen2.5-7B's
    # prefills and step); the timed rows carry their world's by rank
    cut_launches = {name: {f"{_ch_path(key)}_by_rank": [s["launches"].get(name, 0)
                                                         for s in cut[key]["stats"]]
                           for key in CH_LAYOUTS
                           if any(s["launches"].get(name, 0) for s in cut[key]["stats"])}
                    for name in HL_KERNELS}
    for name in HL_KERNELS:
        cut_launches[name]["cut_heads_phi3_one_device"] = cut["phi3"]["one_launches"][name]
    for name, entries in ch_rows.items():
        for e in entries:
            key = next(k for k in CH_LAYOUTS if e["path"] == _ch_path(k))
            e["launches_by_rank"] = ([s["launches"].get(name, 0) for s in cut[key]["stats"]]
                                     if name in HL_KERNELS else "not on a path (no verify window)")
        rows[name].setdefault("per_shape", []).extend(entries)
    # launches on the multi-host paths, by rank: the two CLI launchers over
    # their client run, and each phase of the 2-launcher rank world
    mw = multihost["worlds"]
    multihost_runs = {"llama_decoder_cli_2_launchers": multihost["llama"]["launches"],
                      "llama_decoder_data2_model2_2_launchers": [s["launches"] for s in mw["dm"]],
                      "llama_pipelined_pipe2_model2_2_launchers": [s["launches"]
                                                                   for s in mw["pipe"]]}
    multihost_launches = {name: {f"{run}_by_rank": [la.get(name, 0) for la in ranks]
                                 for run, ranks in multihost_runs.items()
                                 if any(la.get(name, 0) for la in ranks)}
                          for name in MH_KERNELS}
    # launches on the GSPMD paths, by rank: the two CLI servers over their
    # client runs, and each phase of the rank worlds
    gw = gspmd["world"]
    gspmd_runs = {"llama_decoder_cli_data2_model2": gspmd["llama"]["launches"],
                  "bert_long_cli_data2_model2": gspmd["bert"]["launches"],
                  "llama_decoder_data4": gw["data4"]["launches"],
                  "llama_decoder_data2_model2": [s["launches"] for s in gw["dm"]["stats"]],
                  "llama_w4a8_data2_model2": [s["launches"] for s in gw["w4a8"]["stats"]],
                  "resnet18_int8_data4": [s["launches"] for s in gw["resnet"]["stats"]],
                  "vit_l_16_model4": [s["launches"] for s in gw["vit"]["stats"]],
                  "moe_decoder_expert2_model2": [s["launches"] for s in gw["moe"]["stats"]],
                  "llama_pipelined_serve_logits_pipe4": [s["launches"]
                                                         for s in gw["pipe"]["stats"]]}
    gspmd_launches = {name: {f"{run}_by_rank": [la.get(name, 0) for la in ranks]
                             for run, ranks in gspmd_runs.items()
                             if any(la.get(name, 0) for la in ranks)}
                      for name in GSPMD_KERNELS}
    # launches on the pipelined paths, by rank: the llama_pipelined server
    # over its client runs, and each tiny world's serving run
    pipe_launches = {name: {"llama_pipelined_by_rank": [r.get(name, 0) for r in pipe["per_rank"]],
                            **{f"{w}_by_rank": [la.get(name, 0) for la in v["launches"]]
                               for w, v in pipe["worlds"].items()}}
                     for name in PIPE_KERNELS}
    # launches on this slice's paths, by kernel (each path's own counted run)
    slice_launches = {
        "int8_matmul": {"resnet152_ci_replays": clients["resnet"]["launches"]["int8_matmul"],
                        "vit_l_16_serving": vit_launches["int8_matmul"],
                        "per_vit_forward": vit_forward["int8_matmul"],
                        "resnet18_nhwc_serving": nhwc_launches["int8_matmul"],
                        "per_resnet18_nhwc_forward": nhwc_forward["int8_matmul"],
                        "moe_decoder_serving": moe_launches["int8_matmul"]},
        "decode_attention": {"moe_decoder_serving": moe_launches["decode_attention"],
                             "generation_client": gen_launches["decode_attention"]},
        "chunk_prefill_attention": {
            "moe_decoder_serving": moe_launches["chunk_prefill_attention"]},
        "causal_attention": {"moe_decoder_serving": moe_launches["causal_attention"],
                             "serve_logits": logits_launches["causal_attention"],
                             "generation_client": gen_launches["causal_attention"]},
        "int4_matmul": {"serve_logits": logits_launches["int4_matmul"],
                        "generation_client": gen_launches["int4_matmul"]},
        "bidirectional_attention": {
            "bert_client": clients["bert_launches"]["bidirectional_attention"]},
    }

    kernels = []
    for name in _build.KERNELS:
        r = rows[name]
        if name in DECODER_KERNELS:
            extra = {"launches_per_decode_step": per_step[name]}
            if name == "int4_matmul":
                extra.update(decode_step_ms=r["decode_step_ms"],
                             library="torch.matmul bf16 on dequantized weights, cycled")
        elif name == "int8_matmul":  # launches: the llama_paged burst (64 slots, the row's M)
            extra = {"launches_per_decode_step": extra_step[name],
                     "decode_step_ms": r["decode_step_ms"], "library": r["library"],
                     "llama_pipelined_stage_step_ms": pipe_k2_step,
                     "launches_resnet_serving": resnet_launches[name],
                     "launches_per_resnet_forward": resnet_forward[name]}
        elif name in EXTRA_KERNELS + FLAT_KERNELS:
            per = "verify" if "window" in name else "decode_step"
            extra = {f"launches_per_{per}": extra_step[name], "library": r["library"]}
            if "decode_step_ms" in r:
                extra["decode_step_ms"] = r["decode_step_ms"]
            if name in FLAT_KERNELS:
                extra.update(twin=r["twin"], twin_ms=r["twin_ms"],
                             bit_equal_to_twin=r["bit_equal_to_twin"])
        else:
            forward = bert_forward if name in BERT_KERNELS else resnet_forward
            extra = {"launches_per_forward": forward[name], "library": r["library"]}
            if name == "fused_stem":
                extra["ptxas"] = ptxas.get(name, "built before this run")
        if name in DECODE_SIDE:
            extra.update(splits=r.get("splits"), ptxas=ptxas.get(name, "built before this run"))
            if name == "decode_attention":
                extra["graph_block_ms"] = r["graph_block_ms"]
        if name in slice_launches:
            extra["launches_on_this_slices_paths"] = slice_launches[name]
        if name in pipe_launches:
            extra["launches_on_the_pipelined_paths"] = pipe_launches[name]
        if name in gspmd_launches:
            extra["launches_on_the_gspmd_paths"] = gspmd_launches[name]
        if name in multihost_launches:
            extra["launches_on_the_multihost_paths"] = multihost_launches[name]
        if name in head_launches:
            extra["launches_on_the_head_layout_paths"] = head_launches[name]
        if name in cut_launches:
            extra["launches_on_the_cut_heads_paths"] = cut_launches[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"starpu_inference_server_tpu_torch/csrc/{name}.cu",
            "replaces": TPU_SITES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"], **extra,
            **({"per_shape": r["per_shape"]} if "per_shape" in r else {}),
        })
    print(f"this slice's paths on {card}: vit_l_16 {vit_forward['rate']:.1f} img/s, forward "
          f"B=32 busy {vit_forward['busy_ms']} ms; resnet18_nhwc W8A8 {nhwc_forward['rate']:.1f} "
          f"img/s, forward B=32 busy {nhwc_forward['busy_ms']} ms; moe_decoder admit "
          f"{moe['admit_s']:.3f} s of {moe['wall_s']:.3f} s, a step's device busy "
          f"{moe['step_busy_ms']} ms, expert dequantize {moe['dequantize_layer_ms']:.4f} ms a layer")
    smoke, stream = clients["resnet"]["smoke"], clients["generation"]["stream"]
    print(f"clients and checkpoints on {card}: server starts (s) "
          f"{json.dumps(clients['start_s'])}; "
          f"resnet152 CI smoke replay {smoke['throughput_rps']:.1f} req/s, server_overall p95 "
          f"{smoke['latency_ms']['server_overall']['p95']:.1f} ms; check_perf_summary.py on the "
          f"smoke exit code {clients['resnet']['gate_rc']}; generation TTFT p50 "
          f"{stream['generation']['ttft_ms']['p50']:.1f} ms, "
          f"{stream['generation']['tokens_per_s']:.1f} tok/s (stream)")
    gl, gb = gspmd["llama"], gspmd["bert"]
    print(f"gspmd paths on {card}: llama_decoder data=2 model=2 from the CLI "
          f"{gl['summary']['generation']['tokens_per_s']:.1f} tok/s, TTFT p50 "
          f"{gl['summary']['generation']['ttft_ms']['p50']:.1f} ms, rank 0's decode step "
          f"{gl['step_ms']:.2f} ms; bert_long data=2 model=2 "
          f"{GSPMD_BERT_REQUESTS / gb['wall_s']:.1f} seq/s; data=4 streams equal; logits vs one "
          f"device (max rel): data=2 model=2 prefill {gw['dm']['prefill']['max_rel']:.3e} step "
          f"{gw['dm']['step']['max_rel']:.3e}, moe {gw['moe']['step']['max_rel']:.3e}, "
          f"sequence parallel {gw['seqpar']['max_rel']:.3e}, pipe serve_logits "
          f"{gw['pipe']['max_rel']:.3e}; vit mean rel {gw['vit']['rel_err']:.3e}")
    ml = multihost["llama"]
    print(f"multihost paths on {card}: llama_decoder data=2 model=2 from 2 CLI launchers "
          f"{ml['summary']['generation']['tokens_per_s']:.1f} tok/s, TTFT p50 "
          f"{ml['summary']['generation']['ttft_ms']['p50']:.1f} ms, rank 0's decode step "
          f"{ml['step_ms']:.2f} ms, started in {ml['start_s']:.1f} s, weights to launcher 1 "
          f"{ml['weights']['other_launchers']['mb']:.1f} MB in "
          f"{ml['weights']['other_launchers']['s']:.2f} s, {ml['streams_equal']} of "
          f"{GSPMD_REQUESTS} streams equal to 1 launcher's; rank worlds bit-equal / equal to 1 "
          f"launcher's ({json.dumps(mw['walls'])} s); killed rank: exits "
          f"{multihost['killed']['codes']} in {multihost['killed']['s']:.1f} s")
    ho = heads["one"]["per_step"]
    print(f"head-layout paths on {card}: llama_decoder with kv_heads 2 (q/kv 16) on one device, "
          f"launches a decode step {json.dumps({k: v for k, v in ho.items() if v})}; at model="
          f"{HL_MODEL} {heads['mesh']['streams_equal']} of {HL_REQUESTS} streams equal to one "
          f"device's, logits max rel prefill {heads['mesh']['logits']['prefill']['max_rel']:.3e} "
          f"step {heads['mesh']['logits']['step']['max_rel']:.3e}; bert_long model="
          f"{HL_BERT_MODEL} max rel {heads['bert']['close']['max_rel']:.3e}; worlds "
          f"{json.dumps(heads['seconds'])} s")
    cp, cq = cut["phi3"], cut["qwen"]
    print(f"cut-heads paths on {card}: Phi-3-medium's layout at model={CH_LAYOUTS['phi3']['model']} "
          f"{cp['streams_equal']} of {HL_REQUESTS} streams equal to one device's, logits max rel "
          f"prefill {cp['logits']['prefill']['max_rel']:.3e} step "
          f"{cp['logits']['step']['max_rel']:.3e}, rank 0's step {cp['step_ms']:.2f} ms host; "
          f"Qwen2.5-7B's at model={CH_LAYOUTS['qwen']['model']} prefill "
          f"{cq['logits']['prefill']['max_rel']:.3e} step {cq['logits']['step']['max_rel']:.3e}; "
          f"worlds {json.dumps(cut['seconds'])} s")
    print(f"phase seconds (host clock): {json.dumps(phase_s)}")
    print(f"wall time of the run: {time.perf_counter() - t_run:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(phase_main(sys.argv[1:]) if sys.argv[1:] else main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
