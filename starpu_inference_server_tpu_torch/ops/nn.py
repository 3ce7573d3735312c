"""Functional NN layers, quantization-aware.

Counterpart of ``starpu_inference_server_tpu/ops/nn.py``: ``dense``
keeps the JAX package's five-way dispatch, ``resolve_weight`` and
``embedding`` take dense or quantized leaves alike. Image tensors are
NHWC at every public function (the JAX package's layout); ``conv2d`` and
``max_pool`` move to PyTorch's NCHW only inside.

The kernel switch (``set_use_kernels``, the counterpart of
``set_use_pallas``) is AUTO by default: kernel routes are taken exactly
when the tensors are on CUDA. ``set_use_kernels(True)`` forces them on
CPU as well, where every kernel wrapper runs its plain version (the
tests compare that route with the JAX package's interpret-mode
kernels); ``set_use_kernels(False)`` turns them off on the card too.

On a mesh (GSPMD mode, ``parallel/``) a rank holds its shard of every
weight and computes on it; the ``mesh`` arguments make the collectives
that XLA inserts under GSPMD explicit. Without a mesh every call is
unchanged:

- ``dense(..., mesh=)`` is a ROW-parallel layer (o, fc2, down): its
  input is the rank's shard of the contraction dim and the partial
  products are summed over ``model`` before the bias. Under W8A8 the
  per-row activation scale comes from the abs-max of the WHOLE row (an
  all-reduce MAX over ``model``) and the s32 partial sums are summed
  exactly, so the result is the single-device layer's (under W4A8 the
  partial sums come from the W4A8 kernel at unit scales);
- ``multi_head_attention(..., mesh=)`` attends over the rank's
  ``heads / model`` local heads and projects through the row-parallel o;
- ``gather_features`` is the all-gather of a feature-sharded activation
  (embeddings, ViT's patch channels);
- ``conv2d(..., mesh=)``: a W8A8 conv's per-tensor activation scale
  spans the whole batch, so its abs-max is all-reduced over ``data``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..monitoring.trace import ranged
from . import matmul_kernels as mk
from . import prefill_attention as pa
from .quant import (
    dequantize,
    is_packed_int4_leaf,
    is_quantized_leaf,
    quantize_activations,
    unpack_int4,
    unpack_int4_rows,
)

_USE_KERNELS: Optional[bool] = None  # None = auto: on for CUDA tensors
_W8A8 = False


def set_use_kernels(enabled: Optional[bool]) -> None:
    """True / False force the kernel routes on / off; None restores auto."""
    global _USE_KERNELS
    _USE_KERNELS = None if enabled is None else bool(enabled)


def use_kernels(where) -> bool:
    """Whether kernel routes apply on ``where``: a tensor (its device) or
    a device."""
    if _USE_KERNELS is not None:
        return _USE_KERNELS
    if isinstance(where, torch.Tensor):
        return where.is_cuda
    return torch.device(where).type == "cuda"


def set_w8a8(enabled: bool) -> None:
    """W8A8 / W4A8 compute: dense layers quantize their activations per
    row and contract s8 x s8 (the JAX package's ``set_w8a8``)."""
    global _W8A8
    _W8A8 = bool(enabled)


def w8a8_enabled() -> bool:
    return _W8A8


def resolve_weight(w, dtype=torch.bfloat16) -> torch.Tensor:
    """Materialize a (possibly quantized/packed) weight at compute dtype."""
    if is_packed_int4_leaf(w):
        return dequantize(unpack_int4(w["w_p4"]), w["scale"], dtype=dtype)
    if is_quantized_leaf(w):
        return dequantize(w["w_q"], w["scale"], dtype=dtype)
    return w.to(dtype)


def _int_mm_s32(x_q: torch.Tensor, w_int: torch.Tensor) -> torch.Tensor:
    """s8 [M, K] x s8 [K, N] -> exact s32 [M, N] by ``torch._int_mm``
    (cuBLASLt) on CUDA, M > 16. K and N are padded with zeros to the
    multiples of 8 it needs (zeros add nothing); the weight goes in
    column-major order, the "TN" form that cuBLASLt's int8 GEMM takes at
    every shape (the row-major form is refused at small K on an H100)."""
    k, n = w_int.shape
    kp, np_ = -k % 8, -n % 8
    if kp or np_:
        x_q = F.pad(x_q, (0, kp))
        w_int = F.pad(w_int, (0, np_, 0, kp))
    y = torch._int_mm(x_q.contiguous(), w_int.t().contiguous().t())
    return y[:, :n] if np_ else y


def _int_dot(x_q: torch.Tensor, w_int: torch.Tensor, mesh=None) -> torch.Tensor:
    """Exact s8 x s8 contraction (XLA's preferred_element_type=int32) as
    f32: on CUDA above 16 rows the s32 product of :func:`_int_mm_s32`,
    elsewhere float64, where every partial sum is exact. Both give the
    same integers, rounded once to f32 as XLA's int32 -> f32 cast does.
    With ``mesh`` (a row-parallel layer) the ranks' integer partial sums
    are summed over ``model`` first (:func:`_sum_integers`)."""
    if x_q.is_cuda and x_q.shape[0] > 16:
        y = _int_mm_s32(x_q, w_int)
    else:
        y = x_q.to(torch.float64) @ w_int.to(torch.float64)
    return _sum_integers(y, mesh)


def _sum_integers(y: torch.Tensor, mesh=None) -> torch.Tensor:
    """Integer partial sums (each exact in its dtype) summed over
    ``model`` in float64, exactly, then rounded once to f32: the
    single-device contraction's value whatever the split of K."""
    if mesh is not None:
        from ..parallel.collectives import psum
        from ..parallel.mesh import MODEL_AXIS

        y = psum(mesh, y.to(torch.float64), MODEL_AXIS)
    return y.to(torch.float32)


def _quantize_rows(x2: torch.Tensor, mesh=None):
    """Per-row int8 activations (``quantize_activations``); with ``mesh``
    the row's abs-max is taken over every ``model`` shard of it (an
    all-reduce MAX), as XLA reduces it under GSPMD."""
    if mesh is None:
        return quantize_activations(x2)
    from ..parallel.collectives import pmax
    from ..parallel.mesh import MODEL_AXIS

    xf = x2.to(torch.float32)
    absmax = pmax(mesh, xf.abs().amax(dim=-1, keepdim=True), MODEL_AXIS)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


@ranged("ops.dense")
def dense(p, x: torch.Tensor, dtype=torch.bfloat16, act_quant: bool = True,
          mesh=None) -> torch.Tensor:
    """y = x @ w + b with ``p = {'w': [in, out] dense or quantized, 'b'?}``.

    Dispatch, in the JAX package's order (``ops/nn.py:85-160``):
    packed int4 + W8A8 + kernels -> the CUDA W4A8 kernel (K6); packed
    int4 + kernels -> the CUDA int4 kernel; packed int4
    + W8A8 -> exact s8 contraction; int8 at <= 64 rows + kernels -> the
    CUDA int8 kernel; int8 + W8A8 -> exact s8 contraction; anything else
    -> dequantize, then a matmul with f32 accumulation (plain
    ``torch.matmul``: XLA did this work on the TPU).

    ``act_quant=False`` keeps this call weight-only under W8A8 (the JAX
    package's attention projections).

    ``mesh``: this is a row-parallel layer on a mesh (the module
    docstring): the products are summed over ``model`` before the bias,
    exactly under W8A8. The W4A8 kernel then runs on the rank's rows with
    unit scales, so its f32 output is the rank's integer partial sum
    (exact below 2**24, which holds for K / model < 16,513: |x_q w| <=
    127 * 8 a term), and the scales follow the exact sum, in the kernel's
    order ``(acc * x_scale) * scale``.
    """
    w = p["w"]
    row = mesh if mesh is not None and mesh.size("model") > 1 else None  # sums over model
    lead = x.shape[:-1]
    rows = 1
    for d in lead:
        rows *= d
    kern = use_kernels(x)
    use_w8a8 = _W8A8 and act_quant
    exact = False  # the partial sums were summed exactly over the mesh
    if is_packed_int4_leaf(w) and kern and use_w8a8:
        x2 = x.reshape(rows, x.shape[-1])
        x_q, sx = _quantize_rows(x2, row)
        if row is None:
            y = mk.int4_matmul_w4a8(x_q, sx, w["w_p4"], w["scale"])
        else:
            ones = torch.ones((), dtype=torch.float32, device=x_q.device)
            acc = mk.int4_matmul_w4a8(x_q, ones.expand(rows), w["w_p4"],
                                      ones.expand(w["scale"].numel()))
            y, exact = _sum_integers(acc, row) * sx * w["scale"].reshape(1, -1), True
        y = y.reshape(*lead, -1)
    elif is_packed_int4_leaf(w) and kern:
        x2 = x.reshape(rows, x.shape[-1])
        y = mk.int4_matmul(x2.to(dtype), w["w_p4"], w["scale"])
        y = y.reshape(*lead, -1)
    elif is_packed_int4_leaf(w) and use_w8a8:
        x2 = x.reshape(rows, x.shape[-1])
        x_q, sx = _quantize_rows(x2, row)
        y = _int_dot(x_q, unpack_int4(w["w_p4"]), row) * sx * w["scale"].reshape(1, -1)
        y, exact = y.reshape(*lead, -1), True
    elif is_quantized_leaf(w) and kern and rows <= 64:
        x2 = x.reshape(rows, x.shape[-1])
        y = mk.int8_matmul(x2.to(dtype), w["w_q"], w["scale"])
        y = y.reshape(*lead, -1)
    elif is_quantized_leaf(w) and use_w8a8:
        x2 = x.reshape(rows, x.shape[-1])
        x_q, sx = _quantize_rows(x2, row)
        y = _int_dot(x_q, w["w_q"], row) * sx * w["scale"].reshape(1, -1)
        y, exact = y.reshape(*lead, -1), True
    else:
        # products of dtype-rounded operands, accumulated in f32 (the
        # JAX path's preferred_element_type=float32)
        wm = resolve_weight(w, dtype)
        y = torch.matmul(x.to(dtype).to(torch.float32), wm.to(torch.float32))
    if row is not None and not exact:
        from ..parallel.collectives import psum
        from ..parallel.mesh import MODEL_AXIS

        y = psum(row, y, MODEL_AXIS)  # the f32 partial products, before the bias
    if "b" in p and p["b"] is not None:
        y = y + p["b"].to(torch.float32)
    return y.to(dtype)


def embedding(p, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Token embedding lookup, ``p = {'w': [vocab, dim]}`` dense or
    quantized. A packed int4 table is gathered in its packed form (row r
    is byte row r // 2, low nibble when r is even) and only the gathered
    rows are dequantized: the same numbers as dequantizing the whole
    table first, as the JAX package does, without touching the rest of
    it."""
    w = p["w"]
    if is_packed_int4_leaf(w):
        rows = unpack_int4_rows(w["w_p4"], ids)
        return dequantize(rows, w["scale"].reshape(-1), dtype=dtype)
    if is_quantized_leaf(w):
        return dequantize(w["w_q"][ids.to(torch.int64)], w["scale"].reshape(-1), dtype=dtype)
    return w[ids.to(torch.int64)].to(dtype)


def _same_pads(size: int, window: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _spatial_pads(padding, h: int, w: int, kh: int, kw: int, stride: int):
    """JAX padding spec ('SAME', 'VALID', an int or [(lo, hi), (lo, hi)])
    -> ((top, bottom), (left, right))."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return (0, 0), (0, 0)
        return _same_pads(h, kh, stride), _same_pads(w, kw, stride)
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    (t, b), (l, r) = padding
    return (int(t), int(b)), (int(l), int(r))


def _patches(x: torch.Tensor, kh: int, kw: int, stride: int, pads) -> torch.Tensor:
    """im2col of an NHWC tensor: [B, Ho, Wo, kh * kw, C] (taps major,
    channels minor: the order of an HWIO kernel reshaped to [kh kw C, O]),
    padded with zeros, by strided slices, so any dtype (int8 too) works."""
    (pt, pb), (pl, pr) = pads
    if pt or pb or pl or pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
    ho = (x.shape[1] - kh) // stride + 1
    wo = (x.shape[2] - kw) // stride + 1
    taps = [x[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride]
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, dim=3)


def _conv2d_w8a8(wnode, x: torch.Tensor, stride: int, pads, groups: int,
                 mesh=None) -> torch.Tensor:
    """The W8A8 conv of the JAX package (``ops/nn.py:183-198``): ONE
    per-tensor activation scale over the whole batch (absmax / 127, 1 for
    an all-zero input), ``x_q = clip(round(x / sx), -127, 127)``, an exact
    s8 x s8 -> s32 conv (im2col and :func:`_int_dot`, group by group),
    then ``f32(y) * sx * scale[O]`` in that order. An f32 conv of the
    int8 values would not be exact: a 3x3x512 window reaches 127^2 x 4608,
    past 2^24. With ``mesh`` (a batch sharded over ``data``) the abs-max is
    all-reduced over ``data``: the scale spans the whole batch, as under
    GSPMD. Returns f32 [B, Ho, Wo, O]."""
    w_q = wnode["w_q"]
    kh, kw, cin_g, out = w_q.shape
    xf = x.to(torch.float32)
    absmax = xf.abs().amax()
    if mesh is not None:
        from ..parallel.collectives import pmax
        from ..parallel.mesh import DATA_AXIS

        absmax = pmax(mesh, absmax, DATA_AXIS)
    sx = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    x_q = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    cols = _patches(x_q, kh, kw, stride, pads)  # [B, Ho, Wo, kh kw, C]
    b, ho, wo = cols.shape[:3]
    cols = cols.reshape(b * ho * wo, kh * kw, groups, cin_g)
    w = w_q.reshape(kh * kw, cin_g, groups, out // groups)
    y = torch.cat([_int_dot(cols[:, :, g].reshape(-1, kh * kw * cin_g),
                            w[:, :, g].reshape(kh * kw * cin_g, -1)) for g in range(groups)],
                  dim=1)
    y = y * sx * wnode["scale"].reshape(1, -1).to(torch.float32)
    return y.reshape(b, ho, wo, out)


# cuDNN picks its kernels by the batch size, and kernels picked for two
# sizes sum in other orders (ResNet-152's answers change from N = 8, ResNet-18's
# from N = 4: scripts/torch_batch_invariance_probe.py), so a served image's
# answer would depend on its batch-mates. Every conv on the card runs on
# chunks of this many images instead: one size and layout for any batch.
CONV_ROWS = 8


def _cudnn_conv(xc: torch.Tensor, wc: torch.Tensor, stride: int, pads, groups: int):
    """NCHW conv of ``xc`` through cuDNN, ``CONV_ROWS`` images a call: the
    batch (padded by ``pads`` = (top, bottom, left, right)) is copied into
    a channels-last buffer of whole chunks (zero rows after it), each chunk
    convolved alone, the zero rows' outputs dropped. Every image meets the same kernel, at
    the same chunk offset alignment, whatever the batch size."""
    pt, pb, pl, pr = pads
    n = xc.shape[0]
    if pt != pb or pl != pr:
        xc, padding = F.pad(xc, (pl, pr, pt, pb)), 0
    else:
        padding = (pt, pl)
    rows = -(-n // CONV_ROWS) * CONV_ROWS
    chunks = torch.empty((rows, *xc.shape[1:]), dtype=xc.dtype, device=xc.device,
                         memory_format=torch.channels_last)
    chunks[:n].copy_(xc)
    chunks[n:].zero_()
    ys = [F.conv2d(c, wc, stride=stride, padding=padding, groups=groups)
          for c in chunks.split(CONV_ROWS)]
    return (ys[0] if len(ys) == 1 else torch.cat(ys))[:n]


def conv2d(p, x: torch.Tensor, stride: int = 1, padding="SAME", groups: int = 1,
           dtype=torch.bfloat16, mesh=None) -> torch.Tensor:
    """NHWC conv, ``p = {'w': [kh, kw, in/groups, out] dense or int8, 'b'?}``.

    Products of dtype-rounded operands accumulated in f32, as the JAX
    path's ``preferred_element_type=float32``; an int8 weight dequantizes
    first (weight-only). On CUDA the conv runs in ``dtype`` through cuDNN
    (at bf16 it accumulates in f32 and rounds the output once, as the JAX
    path does before its bias), in chunks of :data:`CONV_ROWS` images (see
    :func:`_cudnn_conv`); elsewhere it runs in f32 on the rounded
    operands. Under W8A8 an int8 (or int4-valued) weight takes the exact
    s8 x s8 conv of :func:`_conv2d_w8a8`, whose per-tensor activation
    scale spans the batch, in both packages (the whole batch over a
    ``mesh``'s ``data`` axis)."""
    wnode = p["w"]
    if is_quantized_leaf(wnode) and _W8A8:
        kh, kw = wnode["w_q"].shape[:2]
        pads = _spatial_pads(padding, x.shape[1], x.shape[2], kh, kw, stride)
        y = _conv2d_w8a8(wnode, x, stride, pads, groups, mesh)
    else:
        w = resolve_weight(wnode, dtype)
        kh, kw = w.shape[0], w.shape[1]
        (pt, pb), (pl, pr) = _spatial_pads(padding, x.shape[1], x.shape[2], kh, kw, stride)
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1)
        if x.is_cuda:
            y = _cudnn_conv(xc.to(dtype), wc.to(dtype), stride, (pt, pb, pl, pr), groups)
        else:
            xc, wc = xc.to(dtype).to(torch.float32), wc.to(torch.float32)
            if pt == pb and pl == pr:
                y = F.conv2d(xc, wc, stride=stride, padding=(pt, pl), groups=groups)
            else:
                y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), wc, stride=stride, groups=groups)
        y = y.permute(0, 2, 3, 1).to(torch.float32)
    if "b" in p and p["b"] is not None:
        y = y + p["b"].to(torch.float32)
    return y.to(dtype)


def batch_norm_inference(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference batch norm over the channel (last) axis, in f32, cast
    back to ``x.dtype``."""
    scale = p["gamma"].to(torch.float32) * torch.rsqrt(p["var"].to(torch.float32) + eps)
    shift = p["beta"].to(torch.float32) - p["mean"].to(torch.float32) * scale
    return (x.to(torch.float32) * scale + shift).to(x.dtype)


def layer_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Layer norm over the last axis in f32 with the POPULATION variance
    (``jnp.var``; ``torch.var`` would default to the unbiased one)."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * p["gamma"].to(torch.float32) + p["beta"].to(torch.float32)).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def _attention(q, k, v, mask, num_heads: int, dtype) -> torch.Tensor:
    """Multi-head attention over q/k/v [B, S, H*D] with an optional mask
    ([B, S] with 1 = attend, or [B, 1, Sq, Sk]).

    Kernel gate (the JAX package's, ``ops/nn.py:258-279``): kernels on,
    head_dim % 64 == 0, S % 128 == 0, S >= 512 and a 2-D mask -> the
    bidirectional attention kernel with an additive key bias. Otherwise
    the plain path: f32 scores, -1e9 at masked keys, f32 softmax, the
    probabilities rounded to the compute dtype before P.V (as
    ``nn.py:297``; the kernel keeps them in f32). The JAX path's batch
    chunking against an XLA fusion threshold changes no number; the
    batch is computed whole here."""
    b, s, d = q.shape
    head_dim = d // num_heads
    if (use_kernels(q) and head_dim % 64 == 0 and s % 128 == 0 and s >= 512
            and (mask is None or mask.dim() == 2)):
        if mask is None:
            key_bias = torch.zeros((b, s), dtype=torch.float32, device=q.device)
        else:
            key_bias = torch.where(mask.to(torch.bool), 0.0, -1e9).to(torch.float32)
        out = pa.bidirectional_attention(
            q.reshape(b, s, num_heads, head_dim).to(dtype),
            k.reshape(b, s, num_heads, head_dim).to(dtype),
            v.reshape(b, s, num_heads, head_dim).to(dtype),
            key_bias, rep=1, out_dtype=dtype,
        )
        return out.reshape(b, s, d)

    def split(t):
        return t.to(dtype).reshape(b, s, num_heads, head_dim).transpose(1, 2).to(torch.float32)

    qh, kh, vh = split(q), split(k), split(v)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(head_dim)
    if mask is not None:
        mask4 = mask[:, None, None, :] if mask.dim() == 2 else mask
        logits = torch.where(mask4.to(torch.bool), logits, torch.full_like(logits, -1e9))
    probs = torch.softmax(logits, dim=-1).to(dtype).to(torch.float32)
    out = torch.matmul(probs, vh)
    return out.transpose(1, 2).reshape(b, s, d).to(dtype)


def multi_head_attention(p, x: torch.Tensor, mask: Optional[torch.Tensor], num_heads: int,
                         dtype=torch.bfloat16, mesh=None) -> torch.Tensor:
    """Post-LN transformer MHA block body: q/k/v projections, attention,
    output projection; ``p = {'q', 'k', 'v', 'o'}``, each a dense layer.
    The projections run weight-only (``act_quant=False``) under W8A8, as
    in the JAX package. On a ``mesh`` q/k/v are the rank's column shards
    and o is row-parallel. Where ``model`` divides the heads, the shards
    are the rank's ``num_heads / model`` heads and the attention runs on
    them; otherwise a shard cuts heads (bert-base's 12 at model=8: 96
    columns each), so, as GSPMD reshards there, the shards are gathered
    over ``model``, every rank runs all the heads, and it keeps its block
    of the result's columns, the rows of its shard of o."""
    tp = mesh.size("model") if mesh is not None else 1
    q = dense(p["q"], x, dtype, act_quant=False)
    k = dense(p["k"], x, dtype, act_quant=False)
    v = dense(p["v"], x, dtype, act_quant=False)
    if num_heads % tp == 0:
        out = _attention(q, k, v, mask, num_heads // tp, dtype)
    else:
        q, k, v = (gather_features(t, mesh) for t in (q, k, v))
        out = model_block(_attention(q, k, v, mask, num_heads, dtype), mesh)
    return dense(p["o"], out, dtype, act_quant=False, mesh=mesh)


def gather_features(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """A feature-sharded activation (its last dim over ``model``) made
    whole on every rank: the all-gather GSPMD inserts after a
    feature-sharded embedding or conv. The identity without a mesh."""
    if mesh is None:
        return x
    from ..parallel.collectives import all_gather
    from ..parallel.mesh import MODEL_AXIS

    return all_gather(mesh, x, MODEL_AXIS, dim=-1)



def model_block(x: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's ``1 / model`` block of a whole last dim, the inverse of
    :func:`gather_features`: the rows of its shard of the row-parallel
    layer that follows (a block may cut a head)."""
    width = x.shape[-1] // mesh.size("model")
    off = mesh.coord("model") * width
    return x[..., off:off + width].contiguous()
def max_pool(x: torch.Tensor, window: int, stride: int, padding="SAME") -> torch.Tensor:
    """NHWC max pool; padding positions hold -inf (``lax.reduce_window``
    with the max identity)."""
    (pt, pb), (pl, pr) = _spatial_pads(padding, x.shape[1], x.shape[2], window, window, stride)
    xc = x.permute(0, 3, 1, 2)
    if pt or pb or pl or pr:
        xc = F.pad(xc, (pl, pr, pt, pb), value=float("-inf"))
    return F.max_pool2d(xc, kernel_size=window, stride=stride).permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, C], the mean in f32 cast back to ``x.dtype``."""
    return x.to(torch.float32).mean(dim=(1, 2)).to(x.dtype)
