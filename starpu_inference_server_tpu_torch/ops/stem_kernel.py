"""Fused ResNet stem: space-to-depth conv + BN + ReLU + 3x3/2 max pool.

``fused_stem`` replaces the TPU kernel
``starpu_inference_server_tpu/ops/stem_kernel.py:fused_stem``
(``_stem_kernel``) with ``csrc/fused_stem.cu``. It takes the padded
space-to-depth input ``zp [B, 118, 118, 12]`` and the folded 4x4 stem
weight ``w [192, 64]`` (rows ``(s, t, channel)``, see
``models/resnet.py:_stem_fused``) and returns the pooled ``[B, 56, 56,
64]`` activation; the [B, 112, 112, 64] conv activation never reaches
device memory. Bound on the H100: operations (308 MFLOP per image
against 0.7 MB); the kernel is an implicit GEMM on the tensor cores,
design in the source. :func:`stem_plan` picks its grid from the batch.

:func:`fused_stem_plain` is the same function in plain PyTorch: a conv
in f32 on bf16-rounded operands, then BN, ReLU and the pool. CPU tensors
take it; on the card it is only the reference the kernel is checked
against (with ``torch.backends.cudnn.allow_tf32 = False``, or cuDNN would
run the f32 conv in TF32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .decode_attention import H100_SMS
from .matmul_kernels import _sm_count

launches = {"fused_stem": 0}

_fns = {}

ZP_SHAPE = (118, 118, 12)

# work items: 7 x 8 pooled outputs (all 64 channels) of one image
STEM_ITEMS_PER_IMAGE = 8 * 7
# blocks of the kernel resident on one SM (shared memory and registers)
STEM_BLOCKS_PER_SM = 2


def stem_plan(batch: int, sms: int = H100_SMS) -> int:
    """The grid of ``fused_stem`` for ``batch`` images on a card of
    ``sms`` SMs: one block a work item up to what the card holds at once,
    past that a persistent grid of that many blocks, each looping over
    every grid-th item (it stages the weight once, and the next item's
    input streams in while it computes)."""
    if batch < 1:
        raise ValueError(f"fused_stem plans batches of at least one image, got {batch}")
    return min(batch * STEM_ITEMS_PER_IMAGE, STEM_BLOCKS_PER_SM * sms)


def _check_shapes(zp, w, scale, shift) -> None:
    if tuple(zp.shape[1:]) != ZP_SHAPE:
        raise ValueError(f"fused_stem takes zp [B, 118, 118, 12], got {tuple(zp.shape)}")
    if tuple(w.shape) != (192, 64) or scale.numel() != 64 or shift.numel() != 64:
        raise ValueError(f"fused_stem takes w [192, 64] and 64 scales/shifts, got w "
                         f"{tuple(w.shape)}")


def fused_stem_plain(zp, w, scale, shift, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain reference: bf16-rounded zp and w, f32 conv, BN, ReLU, conv
    row/col -1 zeroed, 3x3/2 max pool."""
    _check_shapes(zp, w, scale, shift)
    z = zp.to(torch.bfloat16).to(torch.float32).permute(0, 3, 1, 2)  # [B, 12, 118, 118]
    wk = w.to(torch.bfloat16).to(torch.float32).reshape(4, 4, 12, 64).permute(3, 2, 0, 1)
    # conv output row p' is the stem's conv row p' - 1: rows -1..111
    y = F.conv2d(z, wk)[:, :, :113, :113]
    y = y * scale.to(torch.float32).reshape(1, -1, 1, 1) + shift.to(torch.float32).reshape(1, -1, 1, 1)
    y = torch.relu(y)
    y[:, :, 0, :] = 0.0  # row -1 and column -1 lie outside the image:
    y[:, :, :, 0] = 0.0  # zero is exact padding under a max of values >= 0
    return F.max_pool2d(y, kernel_size=3, stride=2).permute(0, 2, 3, 1).to(out_dtype)


def fused_stem(zp, w, scale, shift, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Pooled stem activation [B, 56, 56, 64] in ``out_dtype`` (bf16 or
    f32). CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    _check_shapes(zp, w, scale, shift)
    if not zp.is_cuda:
        return fused_stem_plain(zp, w, scale, shift, out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_stem writes f32 or bf16, got {out_dtype}")
    zp = zp.to(torch.bfloat16).contiguous()
    w = w.to(device=zp.device, dtype=torch.bfloat16).contiguous()
    if zp.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("fused_stem reads zp and w 16 bytes at a time: both must start "
                         "16-byte aligned")
    scale = scale.to(device=zp.device, dtype=torch.float32).reshape(-1).contiguous()
    shift = shift.to(device=zp.device, dtype=torch.float32).reshape(-1).contiguous()
    b = zp.shape[0]
    out = torch.empty((b, 56, 56, 64), dtype=out_dtype, device=zp.device)
    if b == 0:
        return out
    fn = _fns.get("fused_stem")
    if fn is None:
        fn = _fns["fused_stem"] = _build.bind("fused_stem", "sis_fused_stem", 5, 3)
    rc = fn(zp.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
            b, _build.BF16 if out_dtype == torch.bfloat16 else _build.F32,
            stem_plan(b, _sm_count(zp.device)), _build.stream_ptr(zp))
    _build.check(rc, "fused_stem")
    launches["fused_stem"] += 1
    return out
