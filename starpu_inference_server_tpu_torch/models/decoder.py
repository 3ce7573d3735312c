"""Llama-class decoder with an INT8 KV cache (layered: one tensor per
layer, in the standard or the FLAT layout).

Counterpart of ``starpu_inference_server_tpu/models/decoder.py``: the
same variants, parameter tree (fused qkv and gate_up projections), RNG
order, RMSNorm, half-split rotary embedding, per-(token, head) int8 KV
quantization and the same ``forward_logits`` / ``prefill`` /
``prefill_chunk`` / ``decode_step`` / ``verify_step`` contracts, with the
same kernel gates, and the ``copy_model_cycle`` benchmark rig. Where a
gate is closed the attention runs the JAX package's jnp path, written in
torch (-1e9 masks, probabilities cast to the compute dtype).

PyTorch runs eagerly and its tensors are mutable, so the cache is
updated IN PLACE: where the JAX functions returned a new cache whose
buffers XLA aliased through donation, these write into ``cache.k[li]``
etc. and return the same ``KVCache`` object.

The FLAT layout (``init_cache(..., flat=True)``) keeps each layer's K/V
as int8 ``[S, T, Hkv*D]`` and its scales as f32 ``[S, Hkv, T]``. The K/V
bytes are the standard layout's; the scales of one (slot, head) are
contiguous along positions. Decode and verify attention read it in place
through the flat kernels (``ops/decode_attention.py``); the plain routes
and prefill attention read it through standard-shaped views
(``_std_kv_view``, ``_std_scale_view``), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.decode_attention import std_kv_view
from ..ops.decode_attention import std_scale_view as _std_scale_view
from ..parallel import tp_layout
from ..utils.config import TensorSpec
from .registry import ModelDefinition, register_family

# variant -> (hidden, layers, q_heads, kv_heads, intermediate, vocab,
#             num_experts, experts_per_token); num_experts 0 = dense MLP
_VARIANTS = {
    "llama-tiny": (256, 4, 8, 4, 688, 2048, 0, 2),
    "llama-1b": (2048, 16, 32, 8, 5504, 32000, 0, 2),
    "llama-7b": (4096, 32, 32, 32, 11008, 32000, 0, 2),
    # MoE decoders (mixtral-style routed SwiGLU experts, top-2)
    "moe-tiny": (256, 4, 8, 4, 688, 2048, 4, 2),
    "moe-8x1b": (2048, 16, 32, 8, 5504, 32000, 8, 2),
    "mixtral-8x7b": (4096, 32, 32, 8, 14336, 32000, 8, 2),
}

ROPE_THETA = 10000.0


@dataclasses.dataclass(frozen=True)
class DecoderSpec:
    hidden: int
    layers: int
    q_heads: int
    kv_heads: int
    intermediate: int
    vocab: int
    # mixture-of-experts MLP (0 experts = dense SwiGLU)
    num_experts: int = 0
    experts_per_token: int = 2

    def __post_init__(self):
        if self.num_experts and self.experts_per_token > self.num_experts:
            raise ValueError(
                f"experts_per_token ({self.experts_per_token}) cannot "
                f"exceed num_experts ({self.num_experts})"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden // self.q_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def rep(self) -> int:
        return self.q_heads // self.kv_heads


@dataclasses.dataclass
class KVCache:
    """INT8 KV cache, LAYERED: ``k``/``v`` are per-layer lists of int8
    [S, T, H_kv, D] (FLAT: [S, T, H_kv*D]), scales per-layer f32
    [S, T, H_kv] (FLAT: [S, H_kv, T]), ``lengths`` int32 [S]; or STACKED
    (pipe mode): one int8 [L, S, T, H_kv, D] tensor per field, f32
    [L, S, T, H_kv] scales. Updated in place (the JAX package's donated
    buffers)."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    k_scale: List[torch.Tensor]
    v_scale: List[torch.Tensor]
    lengths: torch.Tensor

    @property
    def flat(self) -> bool:
        return self.k[0].dim() == 3

    @property
    def num_slots(self) -> int:
        return self.k[0].shape[0]

    @property
    def max_len(self) -> int:
        return self.k[0].shape[1]


def _flat_rows(t: torch.Tensor) -> torch.Tensor:
    """[..., H, D] new-token K/V -> [..., H*D] flat rows."""
    return t.flatten(-2)


def _std_kv_view(spec: DecoderSpec, a: torch.Tensor) -> torch.Tensor:
    """FLAT [..., T, H*D] K/V -> standard [..., T, H, D] (a view)."""
    return std_kv_view(a, spec.kv_heads)


def init_cache(spec: DecoderSpec, num_slots: int, max_len: int, device="cpu",
               stacked: bool = False, flat: bool = False) -> KVCache:
    """Zeroed cache tensors: per-layer lists, standard or ``flat``; or,
    ``stacked``, one [L, ...] tensor per field (the pipe-mode layout whose
    [L] axis is cut over the stages, ``parallel/pipeline_decode.py``).
    Every function here reads ``cache.k[li]`` the same way in both (a
    stacked field's row is a view). ``stacked`` with ``flat`` raises
    ``ValueError``, as in the JAX package."""
    if stacked:
        if flat:
            raise ValueError(
                "flat cache layout does not compose with the stacked "
                "(pipe-mode) layout: the pipe stages' cache specs shard "
                "the head axis over 'model', which the flat [T, H*D] "
                "rows fold away"
            )
        shape = (spec.layers, num_slots, max_len, spec.kv_heads, spec.head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            lengths=torch.zeros((num_slots,), dtype=torch.int32, device=device),
        )
    if flat:
        shape = (num_slots, max_len, spec.kv_heads * spec.head_dim)
        sshape = (num_slots, spec.kv_heads, max_len)
    else:
        shape = (num_slots, max_len, spec.kv_heads, spec.head_dim)
        sshape = shape[:-1]

    def zeros(shp, dt):
        return [torch.zeros(shp, dtype=dt, device=device) for _ in range(spec.layers)]

    return KVCache(
        k=zeros(shape, torch.int8),
        v=zeros(shape, torch.int8),
        k_scale=zeros(sshape, torch.float32),
        v_scale=zeros(sshape, torch.float32),
        lengths=torch.zeros((num_slots,), dtype=torch.int32, device=device),
    )


def _dequantized_layer(spec: DecoderSpec, cache: KVCache, li: int, dtype):
    """Layer ``li``'s whole cache dequantized to [S, T, H_kv, D], in
    either layout (the plain decode and verify routes)."""
    k, v, ks, vs = cache.k[li], cache.v[li], cache.k_scale[li], cache.v_scale[li]
    if cache.flat:
        k, v = _std_kv_view(spec, k), _std_kv_view(spec, v)
        ks, vs = _std_scale_view(ks), _std_scale_view(vs)
    return _dequantize_kv(k, ks, dtype), _dequantize_kv(v, vs, dtype)


def _write_kv(cache: KVCache, li: int, slots, positions, kq, vq, kscale, vscale) -> None:
    """Write new rows of layer ``li`` in place at (``slots``,
    ``positions``), int indices, slices or index tensors broadcast
    together; ``kq``/``vq`` [..., H_kv, D], scales [..., H_kv]."""
    if cache.flat:
        cache.k[li][slots, positions] = _flat_rows(kq)
        cache.v[li][slots, positions] = _flat_rows(vq)
        sk, sv = cache.k_scale[li], cache.v_scale[li]
        if isinstance(positions, slice):
            # basic indexing keeps the head axis in place: [H_kv, rows]
            sk[slots, :, positions] = kscale.transpose(-1, -2)
            sv[slots, :, positions] = vscale.transpose(-1, -2)
        else:
            # advanced indices around a slice put their dims first
            sk[slots, :, positions] = kscale
            sv[slots, :, positions] = vscale
        return
    cache.k[li][slots, positions] = kq
    cache.v[li][slots, positions] = vq
    cache.k_scale[li][slots, positions] = kscale
    cache.v_scale[li][slots, positions] = vscale


# -- params ----------------------------------------------------------------

def _linear(rng, cin, cout):
    return {"w": (rng.standard_normal((cin, cout)) * (1.0 / math.sqrt(cin))).astype(np.float32)}


def init_params(spec: DecoderSpec, rng: np.random.Generator):
    """numpy tree, drawn in the JAX package's order (``decoder.py:225``).
    An MoE layer's MLP is a router [H, E] and stacked experts, ``gate_up``
    [E, H, 2I] and ``down`` [E, I, H], drawn before the attention
    projections, as there."""
    qkv_out = (spec.q_heads + 2 * spec.kv_heads) * spec.head_dim
    layers = []
    for _ in range(spec.layers):
        if spec.is_moe:
            e = spec.num_experts
            scale_g = 1.0 / math.sqrt(spec.hidden)
            scale_d = 1.0 / math.sqrt(spec.intermediate)
            mlp = {
                "router": _linear(rng, spec.hidden, e),
                "experts": {
                    "gate_up": {"w": (rng.standard_normal(
                        (e, spec.hidden, 2 * spec.intermediate)) * scale_g).astype(np.float32)},
                    "down": {"w": (rng.standard_normal(
                        (e, spec.intermediate, spec.hidden)) * scale_d).astype(np.float32)},
                },
            }
        else:
            mlp = {
                "gate_up": _linear(rng, spec.hidden, 2 * spec.intermediate),
                "down": _linear(rng, spec.intermediate, spec.hidden),
            }
        layers.append({
            "attn_norm": {"gamma": np.ones((spec.hidden,), np.float32)},
            "attn": {
                "qkv": _linear(rng, spec.hidden, qkv_out),
                "o": _linear(rng, spec.q_heads * spec.head_dim, spec.hidden),
            },
            "mlp_norm": {"gamma": np.ones((spec.hidden,), np.float32)},
            "mlp": mlp,
        })
    return {
        "embed": {"w": (rng.standard_normal((spec.vocab, spec.hidden)) * 0.02).astype(np.float32)},
        "layers": layers,
        "final_norm": {"gamma": np.ones((spec.hidden,), np.float32)},
        "lm_head": _linear(rng, spec.hidden, spec.vocab),
    }


# -- building blocks -------------------------------------------------------

def local_heads(spec: DecoderSpec, mesh=None):
    """(q heads, kv heads) a rank computes: all of them, or on a mesh its
    ``1 / model`` block of the q heads and the kv heads they read (the
    fused projections are block-aligned by ``parallel/tp_layout.py``):
    ``kv_heads / model`` of them, or one where ``model`` is a multiple of
    ``kv_heads`` (each kv head replicated on ``model / kv_heads`` ranks).
    Where ``model`` cuts heads otherwise (``tp_layout.gathered_heads``), all of
    them again: every rank runs every head and holds the cache of every kv
    head, as the JAX package's cache sharded over ``data`` only. The
    rank's GQA ratio is ``q / kv`` of these."""
    tp = mesh.size("model") if mesh is not None else 1
    if tp_layout.gathered_heads(spec, tp):
        return spec.q_heads, spec.kv_heads
    return spec.q_heads // tp, max(1, spec.kv_heads // tp)


def _project_qkv(spec: DecoderSpec, layer, h, dtype, mesh=None):
    """The fused qkv projection split into q, k and v at the rank's heads.
    In the gathered route the rank's column shard is made whole by one
    all-gather over ``model``."""
    fused = nn.dense(layer["attn"]["qkv"], h, dtype)
    if mesh is not None and tp_layout.gathered_heads(spec, mesh.size("model")):
        fused = nn.gather_features(fused, mesh)
    qh, kvh = local_heads(spec, mesh)
    dq = qh * spec.head_dim
    dkv = kvh * spec.head_dim
    return fused[..., :dq], fused[..., dq:dq + dkv], fused[..., dq + dkv:]


def _attn_out(spec: DecoderSpec, layer, attn, dtype, mesh=None):
    """The output projection of the attention's ``[..., heads * D]``
    result, row-parallel on a mesh. In the gathered route every rank holds
    every head's output and keeps its block of the columns, the rows of
    its ``o`` shard (a block may cut a head)."""
    if mesh is not None and tp_layout.gathered_heads(spec, mesh.size("model")):
        attn = nn.model_block(attn, mesh)
    return nn.dense(layer["attn"]["o"], attn, dtype, mesh=mesh)


def _fused_mlp(layer, x, dtype, mesh=None):
    fused = nn.dense(layer["mlp"]["gate_up"], x, dtype)
    inter = fused.shape[-1] // 2
    gate, up = fused[..., :inter], fused[..., inter:]
    act = F.silu(gate.to(torch.float32)).to(dtype) * up
    return nn.dense(layer["mlp"]["down"], act, dtype, mesh=mesh)


def _top_k_ranks(probs: torch.Tensor) -> torch.Tensor:
    """The place of each expert in ``jax.lax.top_k``'s order: probability
    descending, ties to the lower index. rank[t, e] = #{j: p_j > p_e} +
    #{j < e: p_j == p_e}. Elementwise over [T, E, E], so no sort, no host
    sync and no data-dependent shape (``torch.topk`` promises no order
    among ties on CUDA)."""
    e = probs.shape[-1]
    pe, pj = probs[..., :, None], probs[..., None, :]
    lower = torch.ones((e, e), dtype=torch.bool, device=probs.device).tril(-1)  # j < e
    return ((pj > pe) | ((pj == pe) & lower)).sum(dim=-1)


def _expert_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[E, T, K] x [E, K, N] -> f32 [E, T, N]: operands at their dtype,
    products accumulated in f32 and the result kept in f32 (the JAX
    einsum's preferred_element_type=float32; a plain bf16 ``torch.bmm``
    would round the result to bf16). On CUDA at bf16 it is cuBLAS's bf16
    GEMM with an f32 output; elsewhere an f32 product of the same
    (exactly widened) operands."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), w.to(torch.float32))


def _moe_mlp(spec: DecoderSpec, layer, x, dtype):
    """Mixtral-style routed SwiGLU MoE in the JAX package's dense-dispatch
    form (``decoder.py:295-328``): the router dense, softmax in f32, top-k
    with renormalisation, a one-hot combine [T, E]; every expert computes
    every token through two batched contractions over the stacked
    weights (dequantized whole by ``resolve_weight``), and the combine
    sums over E in f32. Static shapes throughout, so a decode block that
    runs it captures as one CUDA graph."""
    moe = layer["mlp"]
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])  # [T, H]
    logits = nn.dense(moe["router"], xf, dtype).to(torch.float32)  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    ranks = _top_k_ranks(probs)
    picked = [(ranks == r).to(torch.float32) for r in range(spec.experts_per_token)]
    vals = [(probs * p).sum(dim=-1) for p in picked]  # the k largest, in top_k's order
    total = sum(vals)  # in top_k's order (0 + v is v: exact)
    combine = sum(p * (v / total)[:, None] for p, v in zip(picked, vals))  # [T, E]
    wg = nn.resolve_weight(moe["experts"]["gate_up"]["w"], dtype)  # [E, H, 2I]
    wd = nn.resolve_weight(moe["experts"]["down"]["w"], dtype)     # [E, I, H]
    e = wg.shape[0]
    h = _expert_matmul(xf.to(dtype).expand(e, *xf.shape), wg)     # f32 [E, T, 2I]
    inter = h.shape[-1] // 2
    act = (F.silu(h[..., :inter]) * h[..., inter:]).to(dtype)
    y = _expert_matmul(act, wd)                                     # f32 [E, T, H]
    y = torch.einsum("te,eth->th", combine, y)
    return y.reshape(*lead, x.shape[-1]).to(dtype)


def _mlp_block(spec: DecoderSpec, layer, x, dtype, mesh=None):
    """Dense or routed MLP, decided by the param tree (a ``router``). On a
    mesh the MoE runs the rank's experts and columns, one sum over
    (``expert``, ``model``) completing it (``parallel/stage_body.py``)."""
    if "router" in layer["mlp"]:
        if mesh is not None:
            from ..parallel.stage_body import tp_moe_mlp

            return tp_moe_mlp(mesh, spec, layer, x, dtype)
        return _moe_mlp(spec, layer, x, dtype)
    return _fused_mlp(layer, x, dtype, mesh)


def _embed(params, ids: torch.Tensor, dtype, mesh=None) -> torch.Tensor:
    """Token embeddings; on a mesh the table's feature dim is sharded over
    ``model`` and the rows are gathered whole."""
    return nn.gather_features(nn.embedding(params["embed"], ids, dtype), mesh)


def _lm_head(params, x: torch.Tensor, dtype, mesh=None) -> torch.Tensor:
    """The lm head at the compute dtype; on a mesh the rank's vocab slice,
    gathered over ``model`` into the whole vocab."""
    return nn.gather_features(nn.dense(params["lm_head"], x, dtype), mesh)


def rms_norm(p, x, eps=1e-5):
    xf = x.to(torch.float32)
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * p["gamma"].to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Half-split rotary embedding. x: [..., T, H, D]; positions: [..., T]."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # a Python base: no tensor is made on the host and copied over (that
    # copy would sync the host with the card on every call)
    freqs = torch.pow(ROPE_THETA, exps)
    angles = positions.unsqueeze(-1).to(torch.float32) * freqs  # [..., T, half]
    cos = torch.cos(angles).unsqueeze(-2)  # [..., T, 1, half]
    sin = torch.sin(angles).unsqueeze(-2)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _quantize_kv(t: torch.Tensor):
    """Per-(token, head) symmetric int8: [..., H, D] -> (int8, f32 [..., H])."""
    tf = t.to(torch.float32)
    absmax = tf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(tf / scale.unsqueeze(-1)), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.to(torch.float32) * scale.unsqueeze(-1)).to(dtype)


def _softmax_cast(logits: torch.Tensor, dtype) -> torch.Tensor:
    """jax.nn.softmax(...).astype(dtype), then back to f32 for the
    f32-accumulated product (bf16 products are exact in f32)."""
    return torch.softmax(logits, dim=-1).to(dtype).to(torch.float32)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


# -- kernel gates (decoder.py:622-652) ---------------------------------------

def _use_fused_decode_attention(spec: DecoderSpec, t_max: int, ref: torch.Tensor) -> bool:
    """Decode and verify attention. On the card the kernels take any
    ``t_max`` (shapes outside their own limits raise in the wrapper);
    where the kernel routes are forced on CPU tensors, the JAX package's
    TPU tiling gate applies, so parity tests route as JAX does."""
    if not nn.use_kernels(ref) or spec.q_heads % spec.kv_heads:
        return False
    return ref.is_cuda or (spec.head_dim >= 64 and t_max % 128 == 0)


def _use_fused_prefill_attention(spec: DecoderSpec, seq: int, ref: torch.Tensor,
                                 min_seq: int = 256) -> bool:
    """Causal and chunked-prefill attention (``forward_logits``,
    ``prefill``, ``prefill_chunk``). On the card the kernels take any
    sequence and ``max_len`` (shapes outside their own limits raise in the
    wrapper); where the kernel routes are forced on CPU tensors, the JAX
    package's TPU gate applies (``seq`` >= ``min_seq``, a multiple of
    128), so parity tests route as JAX does."""
    if not nn.use_kernels(ref) or spec.q_heads % spec.kv_heads:
        return False
    return ref.is_cuda or (spec.head_dim >= 64 and seq >= min_seq and seq % 128 == 0)


# -- full (teacher-forcing) forward ----------------------------------------

def forward_logits(spec: DecoderSpec, params, ids: torch.Tensor, dtype,
                   mesh=None) -> torch.Tensor:
    """Causal forward over a [B, T] batch, returns [B, T, vocab] f32 logits.
    ``mesh``: GSPMD mode, ``params`` the rank's shard (decoder rules, fused
    projections block-aligned) and ``ids`` its rows; the attention runs on
    the rank's local heads and the logits come back whole."""
    b, t = ids.shape
    dev = ids.device
    qh, kvh = local_heads(spec, mesh)
    positions = torch.arange(t, dtype=torch.int32, device=dev)[None, :].expand(b, t)
    x = _embed(params, ids, dtype, mesh)
    causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()[None, None]
    rep = qh // kvh
    for layer in params["layers"]:
        h = rms_norm(layer["attn_norm"], x)
        qf, kf, vf = _project_qkv(spec, layer, h, dtype, mesh)
        q = rope(qf.reshape(b, t, qh, spec.head_dim), positions)
        k = rope(kf.reshape(b, t, kvh, spec.head_dim), positions)
        v = vf.reshape(b, t, kvh, spec.head_dim)
        if _use_fused_prefill_attention(spec, t, ids):
            from ..ops.prefill_attention import causal_attention

            attn = causal_attention(q, k, v, rep=rep, out_dtype=dtype)
        else:
            kr = k.repeat_interleave(rep, dim=2)
            vr = v.repeat_interleave(rep, dim=2)
            logits = torch.einsum("bqhd,bkhd->bhqk", _f32(q), _f32(kr)) / math.sqrt(spec.head_dim)
            logits = torch.where(causal, logits, torch.full_like(logits, -1e9))
            probs = _softmax_cast(logits, dtype)
            attn = torch.einsum("bhqk,bkhd->bqhd", probs, _f32(vr))
        attn = attn.reshape(b, t, qh * spec.head_dim).to(dtype)
        x = x + _attn_out(spec, layer, attn, dtype, mesh)
        h = rms_norm(layer["mlp_norm"], x)
        x = x + _mlp_block(spec, layer, h, dtype, mesh)
    x = rms_norm(params["final_norm"], x)
    return _lm_head(params, x, dtype, mesh).to(torch.float32)


# -- prefill: write a prompt into one cache slot ---------------------------

def prefill(spec: DecoderSpec, params, cache: KVCache, ids: torch.Tensor,
            length: int, slot: int, dtype, mesh=None):
    """``ids`` int [P] padded prompt, ``length`` true prompt length,
    ``slot`` target slot (host ints). Writes the prompt's int8 KV into
    slot rows [0, P) and returns (cache, last_logits f32 [vocab]).
    ``mesh``: GSPMD mode (``forward_logits``); the cache holds the rank's
    kv heads."""
    p = ids.shape[0]
    dev = ids.device
    qh, kvh = local_heads(spec, mesh)
    positions = torch.arange(p, dtype=torch.int32, device=dev)
    x = _embed(params, ids[None, :], dtype, mesh)  # [1, P, D]
    valid = positions < length
    causal = (torch.ones((p, p), dtype=torch.bool, device=dev).tril() & valid[None, :])[None, None]
    rep = qh // kvh
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(layer["attn_norm"], x)
        qf, kf, vf = _project_qkv(spec, layer, h, dtype, mesh)
        q = rope(qf.reshape(1, p, qh, spec.head_dim), positions[None])
        k = rope(kf.reshape(1, p, kvh, spec.head_dim), positions[None])
        v = vf.reshape(1, p, kvh, spec.head_dim)
        kq, kscale = _quantize_kv(k[0])
        vq, vscale = _quantize_kv(v[0])
        # in-place write of slot rows [0, P); rows past ``length`` hold
        # stale values that are overwritten before they can be attended
        _write_kv(cache, li, slot, slice(0, p), kq, vq, kscale, vscale)
        if _use_fused_prefill_attention(spec, p, ids):
            from ..ops.prefill_attention import causal_attention

            # pure causal == causal & valid for every row < length (rows
            # past length are garbage either way and never read)
            attn = causal_attention(q, k, v, rep=rep, out_dtype=dtype)
        else:
            kr = k.repeat_interleave(rep, dim=2)
            vr = v.repeat_interleave(rep, dim=2)
            logits = torch.einsum("bqhd,bkhd->bhqk", _f32(q), _f32(kr)) / math.sqrt(spec.head_dim)
            logits = torch.where(causal, logits, torch.full_like(logits, -1e9))
            probs = _softmax_cast(logits, dtype)
            attn = torch.einsum("bhqk,bkhd->bqhd", probs, _f32(vr))
        attn = attn.reshape(1, p, qh * spec.head_dim).to(dtype)
        x = x + _attn_out(spec, layer, attn, dtype, mesh)
        h = rms_norm(layer["mlp_norm"], x)
        x = x + _mlp_block(spec, layer, h, dtype, mesh)
    cache.lengths[slot] = length
    x = rms_norm(params["final_norm"], x)
    last = x[0, length - 1]
    logits = _lm_head(params, last[None, :], dtype, mesh)[0]
    return cache, logits.to(torch.float32)


# -- chunked prefill: write one prompt chunk into a cache slot --------------

def prefill_chunk(spec: DecoderSpec, params, cache: KVCache, ids: torch.Tensor,
                  start: int, valid: int, slot: int, dtype, mesh=None):
    """Process ``C`` prompt tokens at absolute positions start..start+C-1
    and write their int8 KV into slot rows [start, start+C). Returns
    (cache, logits f32 [vocab]) for chunk row ``valid-1``. Keys before
    ``start`` are read back from the int8 cache (decode numerics); the
    in-chunk keys stay at compute precision, causally masked. ``start``,
    ``valid`` and ``slot`` are host ints (the engine tracks them).
    ``mesh``: GSPMD mode, as ``prefill``."""
    c = ids.shape[0]
    dev = ids.device
    qh, kvh = local_heads(spec, mesh)
    t_max = cache.max_len
    positions = start + torch.arange(c, dtype=torch.int32, device=dev)
    x = _embed(params, ids[None, :], dtype, mesh)
    key_pos = torch.arange(t_max, device=dev)
    past_mask = (key_pos[None, :] < start)[None, None]
    cur_mask = torch.ones((c, c), dtype=torch.bool, device=dev).tril()[None, None]
    inv = 1.0 / math.sqrt(spec.head_dim)
    rep = qh // kvh
    fit = min(c, t_max - start)
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(layer["attn_norm"], x)
        qf, kf, vf = _project_qkv(spec, layer, h, dtype, mesh)
        q = rope(qf.reshape(1, c, qh, spec.head_dim), positions[None])
        k = rope(kf.reshape(1, c, kvh, spec.head_dim), positions[None])
        v = vf.reshape(1, c, kvh, spec.head_dim)
        kq, kscale = _quantize_kv(k[0])
        vq, vscale = _quantize_kv(v[0])
        # a chunk that starts at a prefix-cache hit may run past t_max:
        # only padding rows lie there, so only the rows that fit are written
        _write_kv(cache, li, slot, slice(start, start + fit), kq[:fit], vq[:fit],
                  kscale[:fit], vscale[:fit])
        row_ck, row_cv = cache.k[li][slot], cache.v[li][slot]
        row_cks, row_cvs = cache.k_scale[li][slot], cache.v_scale[li][slot]
        if cache.flat:
            # standard-shaped views of the slot's row (the read-back of a
            # chunk; decode and verify read the flat cache in place)
            row_ck, row_cv = _std_kv_view(spec, row_ck), _std_kv_view(spec, row_cv)
            row_cks, row_cvs = _std_scale_view(row_cks), _std_scale_view(row_cvs)
        if _use_fused_prefill_attention(spec, t_max, ids, min_seq=512):
            from ..ops.prefill_attention import chunk_prefill_attention

            attn = chunk_prefill_attention(
                q[0], row_ck, row_cv, row_cks, row_cvs, k[0], v[0], start,
                rep=rep, out_dtype=dtype,
            ).reshape(1, c, qh * spec.head_dim)
        else:
            row_k = _dequantize_kv(row_ck, row_cks, dtype).repeat_interleave(rep, dim=1)[None]
            row_v = _dequantize_kv(row_cv, row_cvs, dtype).repeat_interleave(rep, dim=1)[None]
            s_past = torch.einsum("bqhd,bkhd->bhqk", _f32(q), _f32(row_k)) * inv
            s_past = torch.where(past_mask, s_past, torch.full_like(s_past, -1e9))
            kc = k.repeat_interleave(rep, dim=2)
            vc = v.repeat_interleave(rep, dim=2)
            s_cur = torch.einsum("bqhd,bkhd->bhqk", _f32(q), _f32(kc)) * inv
            s_cur = torch.where(cur_mask, s_cur, torch.full_like(s_cur, -1e9))
            probs = _softmax_cast(torch.cat([s_past, s_cur], dim=-1), dtype)
            p_past, p_cur = probs[..., :t_max], probs[..., t_max:]
            attn = torch.einsum("bhqk,bkhd->bqhd", p_past, _f32(row_v))
            attn = attn + torch.einsum("bhqk,bkhd->bqhd", p_cur, _f32(vc))
            attn = attn.reshape(1, c, qh * spec.head_dim)
        x = x + _attn_out(spec, layer, attn.to(dtype), dtype, mesh)
        h = rms_norm(layer["mlp_norm"], x)
        x = x + _mlp_block(spec, layer, h, dtype, mesh)
    cache.lengths[slot] = start + valid
    x = rms_norm(params["final_norm"], x)
    last = x[0, valid - 1]
    logits = _lm_head(params, last[None, :], dtype, mesh)[0]
    return cache, logits.to(torch.float32)


# -- decode: advance every active slot one token ---------------------------

def decode_step(spec: DecoderSpec, params, cache: KVCache, ids: torch.Tensor,
                active: torch.Tensor, dtype, mesh=None):
    """``ids`` int [S] current token per slot, ``active`` bool [S].
    Returns (cache, logits f32 [S, vocab]); inactive slots are computed
    and masked (the continuous-batching contract). ``mesh``: GSPMD mode
    (``prefill``); the slots are the rank's data block."""
    s = ids.shape[0]
    dev = ids.device
    qh, kvh = local_heads(spec, mesh)
    positions = cache.lengths.clone()  # the new token goes at ``length``
    x = _embed(params, ids[:, None], dtype, mesh)  # [S, 1, D]
    t_max = cache.max_len
    key_pos = torch.arange(t_max, device=dev)[None, :]
    mask = (key_pos <= positions.to(torch.int64)[:, None])[:, None, None, :]  # [S,1,1,T]
    slot_idx = torch.arange(s, device=dev)
    # INACTIVE slots park their (discarded) write at t_max-1, so a decode
    # block interleaved with another slot's chunked prefill never
    # clobbers that slot's fresh prompt rows (decoder.py:686-693)
    write_pos = torch.where(active, positions, torch.full_like(positions, t_max - 1)).to(torch.int64)
    rep = qh // kvh
    fused = _use_fused_decode_attention(spec, t_max, ids)
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(layer["attn_norm"], x)
        qf, kf, vf = _project_qkv(spec, layer, h, dtype, mesh)
        q = rope(qf.reshape(s, 1, qh, spec.head_dim), positions[:, None])
        k = rope(kf.reshape(s, 1, kvh, spec.head_dim), positions[:, None])
        v = vf.reshape(s, 1, kvh, spec.head_dim)
        kq, kscale = _quantize_kv(k[:, 0])
        vq, vscale = _quantize_kv(v[:, 0])
        _write_kv(cache, li, slot_idx, write_pos, kq, vq, kscale, vscale)
        if fused:
            from ..ops.decode_attention import decode_attention

            attn = decode_attention(
                q[:, 0], cache.k[li], cache.v[li], cache.k_scale[li],
                cache.v_scale[li], positions, rep=rep,
            ).reshape(s, 1, qh * spec.head_dim).to(dtype)
        else:
            k_all, v_all = _dequantized_layer(spec, cache, li, dtype)
            k_all = k_all.repeat_interleave(rep, dim=2)
            v_all = v_all.repeat_interleave(rep, dim=2)
            logits = torch.einsum("sqhd,skhd->shqk", _f32(q), _f32(k_all)) / math.sqrt(spec.head_dim)
            logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
            probs = _softmax_cast(logits, dtype)
            attn = torch.einsum("shqk,skhd->sqhd", probs, _f32(v_all)).reshape(
                s, 1, qh * spec.head_dim).to(dtype)
        x = x + _attn_out(spec, layer, attn, dtype, mesh)
        h = rms_norm(layer["mlp_norm"], x)
        x = x + _mlp_block(spec, layer, h, dtype, mesh)
    x = rms_norm(params["final_norm"], x)
    logits = _lm_head(params, x[:, 0], dtype, mesh).to(torch.float32)
    cache.lengths.copy_(torch.where(active, positions + 1, positions))
    return cache, logits


# -- verify: score a window of draft tokens against the model --------------

def verify_step(spec: DecoderSpec, params, cache: KVCache, ids: torch.Tensor,
                active: torch.Tensor, dtype, mesh=None):
    """Speculative-decoding verification: advance every active slot ``W``
    tokens in one call. ``ids`` int [S, W] (row i's token sits at
    ``lengths + i``), ``active`` bool [S]. Returns (cache, logits f32
    [S, W, vocab]).

    The KV of all ``W`` positions is written first (rows ``lengths ..
    lengths+W-1``), then attended: every key, the in-window ones too,
    round-trips the int8 cache, so the numbers are those of ``W``
    sequential ``decode_step``s. ``lengths`` is NOT advanced: the caller
    commits the accepted prefix. Inactive slots park their writes at
    ``t_max-1``, as in ``decode_step``. ``mesh``: GSPMD mode, as there."""
    s, w = ids.shape
    dev = ids.device
    qh, kvh = local_heads(spec, mesh)
    start = cache.lengths.clone()
    positions = start[:, None] + torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    x = _embed(params, ids, dtype, mesh)  # [S, W, D]
    t_max = cache.max_len
    key_pos = torch.arange(t_max, device=dev)
    # query row i attends positions <= lengths + i
    mask = key_pos[None, None, None, :] <= positions.to(torch.int64)[:, None, :, None]
    slot_idx = torch.arange(s, device=dev)[:, None]
    # past t_max only inside a window that ran out of admission headroom
    # (never under the engine's contract): clamp instead of raising
    write_pos = torch.where(active[:, None], positions,
                            torch.full_like(positions, t_max - 1)).clamp(max=t_max - 1)
    write_pos = write_pos.to(torch.int64)
    inv = 1.0 / math.sqrt(spec.head_dim)
    rep = qh // kvh
    fused = _use_fused_decode_attention(spec, t_max, ids)
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(layer["attn_norm"], x)
        qf, kf, vf = _project_qkv(spec, layer, h, dtype, mesh)
        q = rope(qf.reshape(s, w, qh, spec.head_dim), positions)
        k = rope(kf.reshape(s, w, kvh, spec.head_dim), positions)
        v = vf.reshape(s, w, kvh, spec.head_dim)
        kq, kscale = _quantize_kv(k)  # [S, W, H, D], [S, W, H]
        vq, vscale = _quantize_kv(v)
        _write_kv(cache, li, slot_idx, write_pos, kq, vq, kscale, vscale)
        if fused:
            from ..ops.decode_attention import window_decode_attention

            attn = window_decode_attention(
                q, cache.k[li], cache.v[li], cache.k_scale[li], cache.v_scale[li], start,
                rep=rep,
            ).reshape(s, w, qh * spec.head_dim).to(dtype)
        else:
            k_all, v_all = _dequantized_layer(spec, cache, li, dtype)
            k_all = k_all.repeat_interleave(rep, dim=2)
            v_all = v_all.repeat_interleave(rep, dim=2)
            logits = torch.einsum("swhd,skhd->shwk", _f32(q), _f32(k_all)) * inv
            logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
            probs = _softmax_cast(logits, dtype)
            attn = torch.einsum("shwk,skhd->swhd", probs, _f32(v_all)).reshape(
                s, w, qh * spec.head_dim).to(dtype)
        x = x + _attn_out(spec, layer, attn, dtype, mesh)
        h = rms_norm(layer["mlp_norm"], x)
        x = x + _mlp_block(spec, layer, h, dtype, mesh)
    x = rms_norm(params["final_norm"], x)
    logits = _lm_head(params, x.reshape(s * w, -1), dtype, mesh)
    return cache, logits.reshape(s, w, spec.vocab).to(torch.float32)


def rig_copy_model(spec: DecoderSpec, params, cycle_len: int):
    """Benchmark rig on a numpy tree (the JAX package's
    ``rig_copy_model``): zero every layer's ``o`` and ``down`` weights, so
    the residual stream stays the token embedding, and make the lm head
    the permuted embedding, so GREEDY output follows permutation cycles
    of ``cycle_len`` tokens while every matmul keeps its full shape.
    Drives the accept-and-commit machinery of speculation with long
    accepted windows; never enable for accuracy work."""
    cycle = int(cycle_len)
    v = spec.vocab - spec.vocab % cycle
    perm = np.arange(spec.vocab)
    blocks = perm[:v].reshape(-1, cycle)
    perm[:v] = np.roll(blocks, -1, axis=1).reshape(-1)
    inv = np.argsort(perm)
    for layer in params["layers"]:
        layer["attn"]["o"]["w"][:] = 0
        layer["mlp"]["down"]["w"][:] = 0
    params["lm_head"]["w"] = np.ascontiguousarray(params["embed"]["w"][inv].T)
    return params


# -- registry glue ---------------------------------------------------------

def get_spec(variant: str, options) -> DecoderSpec:
    if variant not in _VARIANTS:
        raise NotImplementedError(
            f"decoder variant {variant!r} is not yet ported; ported: "
            f"{', '.join(sorted(_VARIANTS))}"
        )
    hidden, layers, qh, kvh, inter, vocab, experts, top_k = _VARIANTS[variant]
    return DecoderSpec(
        hidden=int(options.get("hidden", hidden)),
        layers=int(options.get("layers", layers)),
        q_heads=int(options.get("q_heads", qh)),
        kv_heads=int(options.get("kv_heads", kvh)),
        intermediate=int(options.get("intermediate", inter)),
        vocab=int(options.get("vocab", vocab)),
        num_experts=int(options.get("num_experts", experts)),
        experts_per_token=int(options.get("experts_per_token", top_k)),
    )


def _build_decoder(variant: str, options) -> ModelDefinition:
    spec = get_spec(variant, options)
    seq_len = int(options.get("seq_len", 128))
    copy_cycle = int(options.get("copy_model_cycle", 0))

    def init(rng):
        params = init_params(spec, rng)
        if copy_cycle:
            params = rig_copy_model(spec, params, copy_cycle)
        return params

    def apply(params, inputs, dtype, mesh=None):
        ids = inputs["input_ids"].to(torch.int64)
        return {"logits": forward_logits(spec, params, ids, dtype, mesh)}

    def pipeline_apply(shard, inputs, mesh, num_microbatches, dtype):
        from ..parallel.pipeline import pipelined_decoder_logits

        ids = inputs["input_ids"].to(torch.int64)
        return {"logits": pipelined_decoder_logits(spec, shard, ids, mesh, num_microbatches,
                                                   dtype, sharded=True)}

    def tp_layer_shuffle(layer, tp, pipe=False):
        if pipe:  # the stage programs split whole kv heads, as JAX's
            tp_layout.validate_decoder_tp(spec, tp)
            return tp_layout.shuffle_decoder_layer_for_tp(spec, layer, tp)
        return tp_layout.gspmd_decoder_layer_for_tp(spec, layer, tp)

    return ModelDefinition(
        family=variant,
        init_params=init,
        apply=apply,
        input_specs=(TensorSpec("input_ids", (seq_len,), "INT64"),),
        output_specs=(TensorSpec("logits", (seq_len, spec.vocab), "FP32"),),
        supports_generation=True,
        spec=spec,
        pipeline_apply=pipeline_apply,
        tp_layer_shuffle=tp_layer_shuffle,
    )


for _variant in _VARIANTS:
    register_family(_variant)(
        lambda options, _v=_variant: _build_decoder(_v, options)
    )
