"""Quantized matmul kernels: counterpart of ``ops/pallas_kernels.py``.

Three kernels replace the TPU kernels of
``starpu_inference_server_tpu/ops/pallas_kernels.py``, all on one
tensor-core body (``csrc/quant_matmul.cuh``) with an unpack policy each:

- ``int4_matmul`` (``int4_matmul``, ``_int4_matmul_kernel``;
  ``csrc/int4_matmul.cu``): bf16(x) times the pairwise-packed int4
  weight, mma.sync m16n8k16 bf16 -> f32, every dense layer of the int4
  decoder. Bound on the H100: at the decode batch of 128 rows the bf16
  tensor-core rate (512 FLOPs per packed weight byte); at one row, the
  packed-weight bytes.
- ``int8_matmul`` (``int8_matmul``, ``_matmul_kernel``;
  ``csrc/int8_matmul.cu``): bf16(x) times the int8 weight, the same
  mma, every dense layer of an int8 decode step (<= 64 rows) and the
  ResNet fc. Bound: the int8 weight bytes.
- ``int4_matmul_w4a8`` (``int4_matmul_w4a8``, ``_int4_w4a8_kernel``;
  ``csrc/int4_matmul_w4a8.cu``): int8 activations times the packed int4
  weight, mma.sync m16n8k32 s8 x s8 -> s32, exact, scaled once by
  ``x_scale[m] * scale[n]``. Bound: the packed weight bytes.

Design, shared: B fragments are unpacked from the weight bytes in
registers (device memory only ever holds the quantized weight), a
cp.async ring of weight tiles, a tile variant and a split of K that
:func:`matmul_plan` chooses so every shape fills the card, and a
fixed-order reduction of the splits (see the sources).

Beside each kernel, a ``*_plain`` function computes the same function
in plain PyTorch: CPU tensors take it, and on the card it only serves as
the reference the kernel is checked against.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import _build
from .quant import unpack_int4

# launches of the CUDA kernel (not of the plain version)
launches = {"int4_matmul": 0, "int8_matmul": 0, "int4_matmul_w4a8": 0}

_fns = {}


def _bound(name: str, symbol: str, n_ptrs: int = 4, n_ints: int = 4):
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = _build.bind(name, symbol, n_ptrs, n_ints)
    return fn


# (rows, columns) of each tile variant of the quantized matmul body, by the
# index the C entry points take (csrc/quant_matmul.cuh:launch), the most
# rows each variant is chosen for (the 64-row tile, twice over, measured
# ahead of the 128-row one at 128 rows on the H100), and the k-tile
QMM_TILES = ((16, 128), (64, 128), (128, 128))
QMM_MAX_ROWS = (16, 128, None)
QMM_BK = 64

# what one k-tile of a block costs, in bytes of device memory moved in the
# same time, by kernel; fitted to split sweeps of llama-1b's shapes on an
# H100 (scripts/torch_int4_split_sweep.py, PERF.md)
KTILE_BYTES = {"int4_matmul": 5e6, "int8_matmul": 10e6, "int4_matmul_w4a8": 5e6}


class MatmulPlan(NamedTuple):
    variant: int     # index into QMM_TILES
    splits: int      # K is cut into this many ranges of whole k-tiles
    grid: int        # blocks of the GEMM launch: output tiles x splits
    workspace: int   # 4-byte elements of partial sums (0 when not split)


@functools.lru_cache(maxsize=None)
def matmul_plan(kernel: str, m: int, n: int, k: int, sms: int) -> MatmulPlan:
    """Tile variant and split of K for ``kernel`` (a key of
    ``KTILE_BYTES``) on a card of ``sms`` SMs. The tile is the first
    whose ``QMM_MAX_ROWS`` holds the rows. K is cut into S ranges of
    whole k-tiles (split ``s`` of KT k-tiles takes [s KT / S,
    (s + 1) KT / S)), S chosen among the splits that give every SM a
    block (output tiles x S >= sms; S = 1 where the tiles alone do): the
    least time on the busiest SM, counted in k-tiles of one block (blocks
    are dealt out one per SM a round, so it runs ceil(tiles S / sms)
    blocks of ceil(KT / S) k-tiles and about two k-tiles' worth of
    start-up each), plus what each further split's partial sums cost to
    write and read back (8 bytes an output, against the kernel's
    ``KTILE_BYTES``)."""
    variant = next(i for i, rows in enumerate(QMM_MAX_ROWS) if rows is None or m <= rows)
    bm, bn = QMM_TILES[variant]
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    ktiles = math.ceil(k / QMM_BK)
    reduce = m * n * 8 / KTILE_BYTES[kernel]

    def cost(s):
        return math.ceil(tiles * s / sms) * (math.ceil(ktiles / s) + 2) + (s - 1) * reduce

    fill = [s for s in range(1, ktiles + 1) if tiles * s >= sms] or [ktiles]
    splits = min(fill, key=lambda s: (cost(s), s))
    return MatmulPlan(variant, splits, tiles * splits, splits * m * n if splits > 1 else 0)


def _plan_and_workspace(kernel: str, m: int, n: int, k: int, device, dtype):
    """The launch plan of ``kernel`` and its split workspace (None when K
    is not split), allocated on the current stream like the output."""
    plan = matmul_plan(kernel, m, n, k, _sm_count(device))
    ws = torch.empty(plan.workspace, dtype=dtype, device=device) if plan.workspace else None
    return plan, ws


def _ptr(t):
    return None if t is None else t.data_ptr()


_sms = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def int4_matmul_plain(x: torch.Tensor, w_p4: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """y[M,N] f32 = (bf16(x[M,K]) @ unpack(w_p4[K/2,N])) * scale[1,N]:
    x is rounded to bfloat16 (as the kernel does, also at FP32 compute),
    the int4 values are exact in f32, the product accumulates in f32."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    w = unpack_int4(w_p4).to(torch.float32)
    return (xb @ w) * scale.reshape(1, -1).to(torch.float32)


def int4_matmul(x: torch.Tensor, w_p4: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """y = (x[M,K] @ unpack(w_p4[K//2,N])) * scale[1,N], f32 output.

    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    m, k = x.shape
    khalf, n = w_p4.shape
    if k != 2 * khalf:
        raise ValueError(f"x {tuple(x.shape)} does not match packed w {tuple(w_p4.shape)}")
    if not x.is_cuda:
        return int4_matmul_plain(x, w_p4, scale)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int4_matmul takes f32 or bf16 activations, got {x.dtype}")
    if w_p4.dtype != torch.uint8 or not w_p4.is_cuda:
        raise TypeError("int4_matmul needs a uint8 packed weight on the same device")
    x = x.contiguous()
    w_p4 = w_p4.contiguous()
    scale = scale.reshape(-1).to(torch.float32).contiguous()
    if scale.numel() != n:
        raise ValueError(f"scale has {scale.numel()} entries for {n} columns")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    plan, ws = _plan_and_workspace("int4_matmul", m, n, k, x.device, torch.float32)
    rc = _bound("int4_matmul", "sis_int4_matmul", 5, 6)(
        x.data_ptr(), w_p4.data_ptr(), scale.data_ptr(), y.data_ptr(), _ptr(ws), m, n, k,
        _build.BF16 if x.dtype == torch.bfloat16 else _build.F32, plan.variant, plan.splits,
        _build.stream_ptr(x))
    _build.check(rc, "int4_matmul")
    launches["int4_matmul"] += 1
    return y


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """(bf16(x) @ w_q) * scale[1,N], f32 accumulation (TPU kernel K2)."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    return (xb @ w_q.to(torch.float32)) * scale.reshape(1, -1).to(torch.float32)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y = (x[M,K] @ w_q[K,N]) * scale[1,N], f32 output.

    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    m, k = x.shape
    k2, n = w_q.shape
    if k != k2:
        raise ValueError(f"x {tuple(x.shape)} does not match w_q {tuple(w_q.shape)}")
    if not x.is_cuda:
        return int8_matmul_plain(x, w_q, scale)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_matmul takes f32 or bf16 activations, got {x.dtype}")
    if w_q.dtype != torch.int8 or not w_q.is_cuda:
        raise TypeError("int8_matmul needs an int8 weight on the same device")
    x = x.contiguous()
    w_q = w_q.contiguous()
    scale = scale.reshape(-1).to(torch.float32).contiguous()
    if scale.numel() != n:
        raise ValueError(f"scale has {scale.numel()} entries for {n} columns")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    plan, ws = _plan_and_workspace("int8_matmul", m, n, k, x.device, torch.float32)
    rc = _bound("int8_matmul", "sis_int8_matmul", 5, 6)(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), _ptr(ws), m, n, k,
        _build.BF16 if x.dtype == torch.bfloat16 else _build.F32, plan.variant, plan.splits,
        _build.stream_ptr(x))
    _build.check(rc, "int8_matmul")
    launches["int8_matmul"] += 1
    return y


def int4_matmul_w4a8_plain(x_q: torch.Tensor, x_scale: torch.Tensor,
                           w_p4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(x_q int8 @ unpack(w_p4)) * x_scale[M,1] * scale[1,N]; the integer
    contraction runs in float64, where every partial sum is exact."""
    acc = x_q.to(torch.float64) @ unpack_int4(w_p4).to(torch.float64)
    return (acc.to(torch.float32) * x_scale.reshape(-1, 1)
            * scale.reshape(1, -1).to(torch.float32))


def int4_matmul_w4a8(x_q: torch.Tensor, x_scale: torch.Tensor,
                     w_p4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y = (x_q[M,K] @ unpack(w_p4[K//2,N])) * x_scale[M,1] * scale[1,N],
    f32 output, the integer contraction exact.

    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    m, k = x_q.shape
    khalf, n = w_p4.shape
    if k != 2 * khalf:
        raise ValueError(f"x_q {tuple(x_q.shape)} does not match packed w {tuple(w_p4.shape)}")
    if not x_q.is_cuda:
        return int4_matmul_w4a8_plain(x_q, x_scale, w_p4, scale)
    if x_q.dtype != torch.int8:
        raise TypeError(f"int4_matmul_w4a8 takes int8 activations, got {x_q.dtype}")
    if w_p4.dtype != torch.uint8 or not w_p4.is_cuda:
        raise TypeError("int4_matmul_w4a8 needs a uint8 packed weight on the same device")
    x_q = x_q.contiguous()
    w_p4 = w_p4.contiguous()
    x_scale = x_scale.reshape(-1).to(torch.float32).contiguous()
    scale = scale.reshape(-1).to(torch.float32).contiguous()
    if x_scale.numel() != m or scale.numel() != n:
        raise ValueError(f"scales of {x_scale.numel()} rows and {scale.numel()} columns "
                         f"for a [{m}, {n}] product")
    y = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if m == 0:
        return y
    plan, ws = _plan_and_workspace("int4_matmul_w4a8", m, n, k, x_q.device, torch.int32)
    rc = _bound("int4_matmul_w4a8", "sis_int4_matmul_w4a8", 6, 5)(
        x_q.data_ptr(), x_scale.data_ptr(), w_p4.data_ptr(), scale.data_ptr(), y.data_ptr(),
        _ptr(ws), m, n, k, plan.variant, plan.splits, _build.stream_ptr(x_q))
    _build.check(rc, "int4_matmul_w4a8")
    launches["int4_matmul_w4a8"] += 1
    return y


__all__ = [
    "KTILE_BYTES", "MatmulPlan", "QMM_BK", "QMM_MAX_ROWS", "QMM_TILES", "int4_matmul", "int4_matmul_plain",
    "matmul_plan", "int8_matmul", "int8_matmul_plain",
    "int4_matmul_w4a8", "int4_matmul_w4a8_plain", "launches",
]
