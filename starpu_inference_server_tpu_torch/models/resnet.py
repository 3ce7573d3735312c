"""ResNet / ResNeXt / WideResNet family, NHWC.

Counterpart of ``starpu_inference_server_tpu/models/resnet.py``: the
nine torchvision variants, the same options (``image_size``,
``num_classes``, ``stem_s2d``, ``stem_fused``, ``input_layout``), the
same parameter tree and RNG order, and the same stems:

- the space-to-depth stem (default at even image sizes): the 7x7/s2
  conv recomputed as a 4x4/s1 conv over the 2x2 space-to-depth input
  with a folded kernel (:func:`_stem_space_to_depth`), then BN, ReLU and
  the 3x3/2 max pool;
- the fused stem (``options.stem_fused`` at image 224 with kernels on):
  the whole stem in the ``fused_stem`` kernel, the conv activation never
  in device memory (:func:`_stem_fused`). Stem weights run bf16 in every
  quantization mode there.

The stem's constants (the folded kernel; for the fused stem also its
dequantized bf16 weight and the BN affine) are derived once, when the
model is built (:func:`_prepare_stem`, kept under ``params["stem"]``),
not on every forward.

The wire keeps the reference's NCHW sample dims [3, H, W] (or NHWC with
``input_layout: NHWC``); activations are NHWC inside.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from ..ops import nn
from ..ops import stem_kernel
from ..utils.config import TensorSpec
from .registry import ModelDefinition, register_family

NUM_CLASSES = 1000

# variant -> (block kind, stage depths, groups, width_per_group)
_VARIANTS = {
    "resnet18": ("basic", (2, 2, 2, 2), 1, 64),
    "resnet34": ("basic", (3, 4, 6, 3), 1, 64),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 1, 64),
    "resnet101": ("bottleneck", (3, 4, 23, 3), 1, 64),
    "resnet152": ("bottleneck", (3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": ("bottleneck", (3, 4, 6, 3), 32, 4),
    "resnext101_32x8d": ("bottleneck", (3, 4, 23, 3), 32, 8),
    "wide_resnet50_2": ("bottleneck", (3, 4, 6, 3), 1, 128),
    "wide_resnet101_2": ("bottleneck", (3, 4, 23, 3), 1, 128),
}

_STAGE_PLANES = (64, 128, 256, 512)


def _conv_init(rng: np.random.Generator, kh, kw, cin, cout) -> Dict[str, Any]:
    std = math.sqrt(2.0 / (kh * kw * cin))
    return {"w": (rng.standard_normal((kh, kw, cin, cout)) * std).astype(np.float32)}


def _bn_init(rng: np.random.Generator, c) -> Dict[str, Any]:
    return {
        "gamma": np.ones((c,), np.float32),
        "beta": np.zeros((c,), np.float32),
        "mean": np.zeros((c,), np.float32),
        "var": np.ones((c,), np.float32),
    }


def _fc_init(rng: np.random.Generator, cin, cout) -> Dict[str, Any]:
    bound = 1.0 / math.sqrt(cin)
    return {
        "w": rng.uniform(-bound, bound, (cin, cout)).astype(np.float32),
        "b": rng.uniform(-bound, bound, (cout,)).astype(np.float32),
    }


def _init_basic_block(rng, cin, planes, stride) -> Dict[str, Any]:
    block = {
        "conv1": _conv_init(rng, 3, 3, cin, planes),
        "bn1": _bn_init(rng, planes),
        "conv2": _conv_init(rng, 3, 3, planes, planes),
        "bn2": _bn_init(rng, planes),
    }
    if stride != 1 or cin != planes:
        block["downsample"] = {"conv": _conv_init(rng, 1, 1, cin, planes),
                               "bn": _bn_init(rng, planes)}
    return block


def _init_bottleneck_block(rng, cin, planes, stride, groups, width_per_group):
    width = int(planes * (width_per_group / 64.0)) * groups
    cout = planes * 4
    block = {
        "conv1": _conv_init(rng, 1, 1, cin, width),
        "bn1": _bn_init(rng, width),
        "conv2": _conv_init(rng, 3, 3, width // groups, width),
        "bn2": _bn_init(rng, width),
        "conv3": _conv_init(rng, 1, 1, width, cout),
        "bn3": _bn_init(rng, cout),
    }
    if stride != 1 or cin != cout:
        block["downsample"] = {"conv": _conv_init(rng, 1, 1, cin, cout),
                               "bn": _bn_init(rng, cout)}
    return block


def _apply_basic_block(p, x, stride, dtype, mesh=None):
    identity = x
    out = nn.conv2d(p["conv1"], x, stride=stride, padding=1, dtype=dtype, mesh=mesh)
    out = torch.relu(nn.batch_norm_inference(p["bn1"], out))
    out = nn.conv2d(p["conv2"], out, stride=1, padding=1, dtype=dtype, mesh=mesh)
    out = nn.batch_norm_inference(p["bn2"], out)
    if "downsample" in p:
        identity = nn.conv2d(p["downsample"]["conv"], x, stride=stride, padding=0,
                             dtype=dtype, mesh=mesh)
        identity = nn.batch_norm_inference(p["downsample"]["bn"], identity)
    return torch.relu(out + identity)


def _apply_bottleneck_block(p, x, stride, groups, dtype, mesh=None):
    identity = x
    out = nn.conv2d(p["conv1"], x, stride=1, padding=0, dtype=dtype, mesh=mesh)
    out = torch.relu(nn.batch_norm_inference(p["bn1"], out))
    out = nn.conv2d(p["conv2"], out, stride=stride, padding=1, groups=groups, dtype=dtype,
                    mesh=mesh)
    out = torch.relu(nn.batch_norm_inference(p["bn2"], out))
    out = nn.conv2d(p["conv3"], out, stride=1, padding=0, dtype=dtype, mesh=mesh)
    out = nn.batch_norm_inference(p["bn3"], out)
    if "downsample" in p:
        identity = nn.conv2d(p["downsample"]["conv"], x, stride=stride, padding=0,
                             dtype=dtype, mesh=mesh)
        identity = nn.batch_norm_inference(p["downsample"]["bn"], identity)
    return torch.relu(out + identity)


def _s2d_rearrange(x, layout: str):
    """Wire tensor -> the 2x2 space-to-depth layout [B, H/2, W/2, 4C],
    channel index (a*2 + b)*C + c for the pixel (2p+a, 2q+b)."""
    if layout == "NCHW":
        bsz, c, h, wd = x.shape
        z = x.reshape(bsz, c, h // 2, 2, wd // 2, 2)
        return z.permute(0, 2, 4, 3, 5, 1).reshape(bsz, h // 2, wd // 2, 4 * c)
    bsz, h, wd, c = x.shape
    z = x.reshape(bsz, h // 2, 2, wd // 2, 2, c)
    return z.permute(0, 1, 3, 2, 4, 5).reshape(bsz, h // 2, wd // 2, 4 * c)


def _fold(w: torch.Tensor) -> torch.Tensor:
    """[7, 7, C, O] stem kernel -> [4, 4, 4C, O] over s2d coordinates:
    tap (u, v) lands at (d, e, a, b) with a = (u+1) % 2,
    d = (u - 3 - a) // 2 + 2 (and likewise for v)."""
    kh, kw, cin, out = w.shape
    w8 = torch.zeros((4, 4, 2, 2, cin, out), dtype=w.dtype, device=w.device)
    for u in range(kh):
        a = (u + 1) % 2
        d = (u - 3 - a) // 2 + 2
        for v in range(kw):
            b = (v + 1) % 2
            e = (v - 3 - b) // 2 + 2
            w8[d, e, a, b] = w[u, v]
    return w8.reshape(4, 4, 4 * cin, out)


def _prepare_stem(params, fused: bool):
    """The stem's constants, derived once at build time: the s2d conv's
    folded kernel (int8 per-channel scales fold unchanged) and, for the
    fused stem, the weight dequantized to f32, folded and rounded to
    bf16 (every quantization mode), with the BN affine in f32."""
    node = params["conv1"]["w"]
    if isinstance(node, dict) and "w_q" in node:
        folded = dict(node, w_q=_fold(node["w_q"]))
    else:
        folded = _fold(node)
    stem = {"s2d_conv": dict(params["conv1"], w=folded)}
    if fused:
        w7 = nn.resolve_weight(node, torch.float32)  # [7, 7, 3, 64]
        bn = params["bn1"]
        scale = bn["gamma"].to(torch.float32) * torch.rsqrt(bn["var"].to(torch.float32) + 1e-5)
        stem["fused_w"] = _fold(w7).reshape(4 * 4 * 12, 64).to(torch.bfloat16).contiguous()
        stem["scale"] = scale.contiguous()
        stem["shift"] = (bn["beta"].to(torch.float32)
                         - bn["mean"].to(torch.float32) * scale).contiguous()
    return dict(params, stem=stem)


def _stem_space_to_depth(stem, x, dtype, layout: str = "NCHW", mesh=None):
    """The 7x7/s2 stem conv recomputed as a 4x4/s1 conv on the
    space-to-depth input with the folded kernel, padding (2, 1): the
    same products per output."""
    z = _s2d_rearrange(x, layout)
    return nn.conv2d(stem["s2d_conv"], z, stride=1, padding=[(2, 1), (2, 1)], dtype=dtype,
                     mesh=mesh)


def _stem_fused(stem, x, dtype, layout: str = "NCHW"):
    """The whole stem (s2d conv + BN + ReLU + 3x3/2 max pool) in the
    ``fused_stem`` kernel, on the weights :func:`_prepare_stem` made.
    The image is rounded to bf16 first, so the rearrange and the pad
    move half the bytes; rounding is elementwise, so the kernel reads
    the same bits."""
    z = _s2d_rearrange(x.to(torch.bfloat16), layout)
    zp = torch.nn.functional.pad(z, (0, 0, 3, 3, 3, 3))
    return stem_kernel.fused_stem(zp, stem["fused_w"], stem["scale"], stem["shift"],
                                  out_dtype=dtype)


def _build_resnet(variant: str, options) -> ModelDefinition:
    kind, depths, groups, width_per_group = _VARIANTS[variant]
    expansion = 1 if kind == "basic" else 4
    image = int(options.get("image_size", 224))
    num_classes = int(options.get("num_classes", NUM_CLASSES))
    stem_s2d = bool(options.get("stem_s2d", image % 2 == 0))
    stem_fused = bool(options.get("stem_fused", False))
    layout = str(options.get("input_layout", "NCHW")).upper()
    if layout not in ("NCHW", "NHWC"):
        raise ValueError(f"input_layout must be NCHW or NHWC, got {layout!r}")

    def init_params(rng: np.random.Generator):
        params: Dict[str, Any] = {"conv1": _conv_init(rng, 7, 7, 3, 64), "bn1": _bn_init(rng, 64)}
        cin = 64
        for stage, (planes, depth) in enumerate(zip(_STAGE_PLANES, depths), start=1):
            blocks: List[Dict[str, Any]] = []
            for i in range(depth):
                stride = 2 if (stage > 1 and i == 0) else 1
                if kind == "basic":
                    blocks.append(_init_basic_block(rng, cin, planes, stride))
                    cin = planes
                else:
                    blocks.append(_init_bottleneck_block(rng, cin, planes, stride, groups,
                                                         width_per_group))
                    cin = planes * 4
            params[f"layer{stage}"] = blocks
        params["fc"] = _fc_init(rng, 512 * expansion, num_classes)
        return params

    def apply(params, inputs, dtype, mesh=None):
        """``mesh``: data-parallel on a mesh (the rank's rows; only a W8A8
        conv's batch-wide activation scale reaches across ranks)."""
        x = inputs["input"]
        # the kernel gate of the JAX package (models/resnet.py:219-230)
        if stem_s2d and stem_fused and image == 224 and nn.use_kernels(x):
            x = _stem_fused(params["stem"], x, dtype, layout)
        else:
            if stem_s2d:
                x = _stem_space_to_depth(params["stem"], x.to(dtype), dtype, layout, mesh)
            else:
                if layout == "NCHW":
                    x = x.permute(0, 2, 3, 1)
                x = nn.conv2d(params["conv1"], x.to(dtype), stride=2, padding=3, dtype=dtype,
                              mesh=mesh)
            x = torch.relu(nn.batch_norm_inference(params["bn1"], x))
            x = nn.max_pool(x, window=3, stride=2, padding=[(1, 1), (1, 1)])
        for stage, depth in enumerate(depths, start=1):
            for i in range(depth):
                stride = 2 if (stage > 1 and i == 0) else 1
                p = params[f"layer{stage}"][i]
                if kind == "basic":
                    x = _apply_basic_block(p, x, stride, dtype, mesh)
                else:
                    x = _apply_bottleneck_block(p, x, stride, groups, dtype, mesh)
        x = nn.global_avg_pool(x)
        logits = nn.dense(params["fc"], x, dtype)
        return {"output": logits.to(torch.float32)}

    sample_dims = (3, image, image) if layout == "NCHW" else (image, image, 3)
    return ModelDefinition(
        family=variant,
        init_params=init_params,
        apply=apply,
        input_specs=(TensorSpec("input", sample_dims, "FP32"),),
        output_specs=(TensorSpec("output", (num_classes,), "FP32"),),
        prepare=(lambda params: _prepare_stem(params, stem_fused and image == 224))
        if stem_s2d else None,
    )


for _variant in _VARIANTS:
    register_family(_variant)(lambda options, _v=_variant: _build_resnet(_v, options))
