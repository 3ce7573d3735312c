"""Pipelined continuous-batching decoding over the mesh ``pipe`` axis.

Counterpart of ``starpu_inference_server_tpu/parallel/pipeline_decode.py``:
each stage holds L/S contiguous layers and those layers' slice of the
INT8 KV cache (the cache's [L] axis over ``pipe``, its head axis over
``model``), and three programs move work through the stages:

- :func:`pipelined_prefill`: TeraPipe sequence pipelining. The padded
  prompt splits into C chunks that flow through the stages in order;
  in-chunk attention runs at compute precision under a causal mask,
  attention to earlier chunks reads the int8 rows those chunks wrote at
  this stage. Numbers of ``models/decoder.prefill_chunk`` run chunk by
  chunk; chunk prefill attention is K4 wherever the single-device gate
  picks it;
- :func:`pipelined_decode_step`: slot microgroups. The S slots split
  into M groups of G that flow through the stages, each advancing one
  token (``models/decoder.decode_step``'s numbers; attention is K3);
- :func:`pipelined_verify_step`: the same for a window of W tokens a
  slot (``models/decoder.verify_step``; attention is K9).

Here a stage is a rank process and each call is that rank's program.
A stage works only on its valid ticks: it receives a microgroup (or
chunk) from the previous stage, runs its layers and sends it on
(:class:`~.collectives.PipeRing`); there are no fill / drain ticks of
masked garbage. The last stage sends its outputs round the ring to
stage 0, which embeds the tokens and holds the head: the final norm,
the lm head and, on a ``model`` axis, the gather of the logits' vocab
shards. So the results land on stage 0, rank 0 among them (the JAX
programs' masked ``psum`` to every device). Every rank updates the slot
lengths, which stay replicated.

The JAX decode program parks its fill / drain ticks' garbage writes at
row ``t_max - 1`` of some slots; this one writes nothing on those ticks,
so that row (never attended before it is written, decode_step's own
argument) may differ between the two packages. Inactive slots park
their writes there as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models.decoder import (
    KVCache,
    _dequantize_kv,
    _quantize_kv,
    _softmax_cast,
    _use_fused_decode_attention,
    _use_fused_prefill_attention,
    init_cache,
    rms_norm,
    rope,
)
from ..ops import nn
from .collectives import PipeRing, all_gather
from .mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, MeshAxes
from .pipeline import unstack_layers
from .stage_body import local_qkv_slices, tp_attn_out, tp_mlp_block, tp_project_qkv
from .tp_layout import validate_decoder_tp


def _axis(mesh, axis: str) -> int:
    return getattr(mesh, axis) if isinstance(mesh, MeshAxes) else mesh.size(axis)


def validate_pipe_mesh(mesh) -> int:
    """The pipelined decode path's mesh contract (a ``RankMesh`` or its
    ``MeshAxes``): ``model`` / ``expert`` compose inside the stages, but
    ``data`` must be 1, since slots flow through the stages whole.
    Returns the stage count."""
    stages = _axis(mesh, PIPE_AXIS)
    data = _axis(mesh, DATA_AXIS)
    if data > 1:
        raise ValueError(
            f"pipelined decoding does not compose with the 'data' mesh "
            f"axis (got data={data}): slots microgroup over 'pipe' "
            "instead — use GSPMD mesh mode (data/model/expert without "
            "pipe) for slot-sharded decoding"
        )
    return stages


def cache_specs():
    """Partition specs of the stacked cache: the [L] axis over ``pipe``,
    the head axis over ``model`` (the JAX ``_cache_specs``)."""
    kv = (PIPE_AXIS, None, None, MODEL_AXIS, None)   # [L, S, T, Hkv, D]
    scale = (PIPE_AXIS, None, None, MODEL_AXIS)      # [L, S, T, Hkv]
    return kv, scale


def shard_cache(cache: KVCache, coords, sizes) -> KVCache:
    """The shard of a whole stacked cache at mesh position ``coords``
    (views); ``lengths`` replicates."""
    from .partition import shard_array

    kv, scale = cache_specs()
    return KVCache(k=shard_array(cache.k, kv, coords, sizes),
                   v=shard_array(cache.v, kv, coords, sizes),
                   k_scale=shard_array(cache.k_scale, scale, coords, sizes),
                   v_scale=shard_array(cache.v_scale, scale, coords, sizes),
                   lengths=cache.lengths)


def init_stage_cache(spec, num_slots: int, max_len: int, mesh, device="cpu") -> KVCache:
    """This rank's zeroed shard of the stacked cache: ``init_cache``'s
    stacked layout for the stage's L/S layers and Hkv/tp kv heads."""
    stages, tp = _axis(mesh, PIPE_AXIS), _axis(mesh, MODEL_AXIS)
    if spec.layers % stages:
        raise ValueError(f"{spec.layers} layers not divisible by {stages} pipeline stages")
    local = dataclasses.replace(spec, layers=spec.layers // stages,
                                kv_heads=spec.kv_heads // tp)
    return init_cache(local, num_slots, max_len, device=device, stacked=True)


def _local_layers(params) -> list:
    layers = params["layers"]
    return unstack_layers(layers) if isinstance(layers, dict) else layers


def embed(mesh, params, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Token embedding on stage 0: the rank's feature shard of the table,
    gathered over ``model``."""
    return all_gather(mesh, nn.embedding(params["embed"], ids, dtype), MODEL_AXIS)


def head(mesh, params, x: torch.Tensor, dtype) -> torch.Tensor:
    """Final norm and lm head on stage 0: the rank's vocab shard of the
    logits, gathered over ``model``; f32."""
    x = rms_norm(params["final_norm"], x)
    return all_gather(mesh, nn.dense(params["lm_head"], x, dtype), MODEL_AXIS).to(torch.float32)


def _attend_window(q, k_all, v_all, mask, hd: int, dtype):
    """Plain attention of [G, W] queries over the whole dequantized rows,
    as ``decode_step`` (W = 1: divided by sqrt(D)) and ``verify_step``
    (times 1/sqrt(D)) compute it."""
    logits = torch.einsum("swhd,skhd->shwk", q.to(torch.float32), k_all.to(torch.float32))
    logits = logits / math.sqrt(hd) if q.shape[1] == 1 else logits * (1.0 / math.sqrt(hd))
    logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    probs = _softmax_cast(logits, dtype)
    return torch.einsum("shwk,skhd->swhd", probs, v_all.to(torch.float32))


def _slot_rows_layer(mesh, spec, tp, layer, li, xg, cache, rows: slice, pos, write_pos,
                     fused: bool, dtype):
    """One layer of a decode (W = 1) or verify (W > 1) microgroup: the
    group's slots ``rows`` at positions ``pos`` [G, W] write their int8 KV
    at ``write_pos`` [G, W], then attend every cache row up to their own
    position."""
    g, w = pos.shape
    hd = spec.head_dim
    _, _, qh, kvh = local_qkv_slices(spec, tp)
    rep = qh // kvh
    h = rms_norm(layer["attn_norm"], xg)
    qf, kf, vf = tp_project_qkv(spec, tp, layer, h, dtype)
    q = rope(qf.reshape(g, w, qh, hd), pos)
    k = rope(kf.reshape(g, w, kvh, hd), pos)
    v = vf.reshape(g, w, kvh, hd)
    kq, kscale = _quantize_kv(k)
    vq, vscale = _quantize_kv(v)
    ck, cv = cache.k[li][rows], cache.v[li][rows]            # [G, T, Hkv_l, D] views
    cks, cvs = cache.k_scale[li][rows], cache.v_scale[li][rows]
    idx = torch.arange(g, device=xg.device)[:, None]
    wp = write_pos.to(torch.int64)
    ck[idx, wp] = kq
    cv[idx, wp] = vq
    cks[idx, wp] = kscale
    cvs[idx, wp] = vscale
    start = pos[:, 0].contiguous()
    if fused and w == 1:
        from ..ops.decode_attention import decode_attention

        attn = decode_attention(q[:, 0], ck, cv, cks, cvs, start, rep=rep)
    elif fused:
        from ..ops.decode_attention import window_decode_attention

        attn = window_decode_attention(q, ck, cv, cks, cvs, start, rep=rep)
    else:
        t_max = ck.shape[1]
        key_pos = torch.arange(t_max, device=xg.device)
        mask = key_pos[None, None, None, :] <= pos.to(torch.int64)[:, None, :, None]  # [G,1,W,T]
        k_all = _dequantize_kv(ck, cks, dtype).repeat_interleave(rep, dim=2)
        v_all = _dequantize_kv(cv, cvs, dtype).repeat_interleave(rep, dim=2)
        attn = _attend_window(q, k_all, v_all, mask, hd, dtype)
    attn = attn.reshape(g, w, qh * hd).to(dtype)
    xg = xg + tp_attn_out(mesh, layer, attn, dtype)
    h = rms_norm(layer["mlp_norm"], xg)
    return xg + tp_mlp_block(mesh, spec, layer, h, dtype)


def _microgroups(stages: int, s: int, num_microgroups: int, what: str) -> int:
    m = num_microgroups or min(stages, s)
    if s % m != 0:
        raise ValueError(f"num_slots ({s}) not divisible by {what} microgroups ({m})")
    return m


def _slot_pipeline(spec, params, cache, ids, active, mesh, dtype, num_microgroups, what):
    """The decode / verify program of one rank: ``ids`` [S, W]. Returns the
    last stage's hidden states [S, W, H] on stage 0, None elsewhere."""
    stages = validate_pipe_mesh(mesh)
    tp = mesh.size(MODEL_AXIS)
    validate_decoder_tp(spec, tp)
    s, w = ids.shape
    m = _microgroups(stages, s, num_microgroups, what)
    g = s // m
    t_max = cache.max_len
    dev = ids.device
    win = torch.arange(w, dtype=torch.int32, device=dev)
    pos_all = cache.lengths[:, None] + win[None, :]                       # [S, W]
    # inactive slots park their writes at t_max-1 (decode_step's rule);
    # past t_max only in a window without admission headroom: clamped
    write_all = torch.where(active[:, None], pos_all,
                            torch.full_like(pos_all, t_max - 1)).clamp(max=t_max - 1)
    fused = _use_fused_decode_attention(spec, t_max, ids)
    layers = _local_layers(params)
    stage = mesh.stage
    ring = PipeRing(mesh)
    x = embed(mesh, params, ids, dtype) if stage == 0 else None          # [S, W, H]
    for mb in range(m):
        rows = slice(mb * g, (mb + 1) * g)
        xg = x[rows] if stage == 0 else ring.recv((g, w, spec.hidden), dtype, dev)
        for li, layer in enumerate(layers):
            xg = _slot_rows_layer(mesh, spec, tp, layer, li, xg, cache, rows, pos_all[rows],
                                  write_all[rows], fused, dtype)
        ring.send(xg)
    out = None
    if stage == 0:  # the last stage's microgroups, round the ring
        out = torch.cat([ring.recv((g, w, spec.hidden), dtype, dev) for _ in range(m)])
    ring.wait()
    return out


def pipelined_decode_step(spec, params, cache: KVCache, ids: torch.Tensor,
                          active: torch.Tensor, mesh, dtype=torch.bfloat16,
                          num_microgroups: int = 0):
    """This rank's part of one pipelined decode step (``decode_step``'s
    contract): ``params`` is the rank's shard (``prepare_pipelined_params``),
    ``cache`` its cache shard, ``ids`` int [S] and ``active`` bool [S] the
    same on every rank. Advances the active slots' lengths on every rank
    and returns (cache, logits f32 [S, vocab]) on stage 0, (cache, None)
    elsewhere."""
    out = _slot_pipeline(spec, params, cache, ids[:, None], active, mesh, dtype,
                         num_microgroups, "decode")
    lengths = cache.lengths
    lengths.copy_(torch.where(active, lengths + 1, lengths))
    if out is None:
        return cache, None
    return cache, head(mesh, params, out[:, 0], dtype)


def pipelined_verify_step(spec, params, cache: KVCache, ids: torch.Tensor,
                          active: torch.Tensor, mesh, dtype=torch.bfloat16,
                          num_microgroups: int = 0):
    """This rank's part of one pipelined verify window (``verify_step``'s
    contract): ``ids`` int [S, W], row w at ``lengths + w``. Writes the KV
    of all W positions and does not advance ``lengths``. Returns (cache,
    logits f32 [S, W, vocab]) on stage 0, (cache, None) elsewhere."""
    s, w = ids.shape
    out = _slot_pipeline(spec, params, cache, ids, active, mesh, dtype, num_microgroups,
                         "verify")
    if out is None:
        return cache, None
    return cache, head(mesh, params, out.reshape(s * w, -1), dtype).reshape(s, w, -1)


def _chunk_layer(mesh, spec, tp, layer, li, xc, cache, slot: int, start: int, fused: bool,
                 dtype):
    """One layer of a prefill chunk: rows [start, start + C) of ``slot``."""
    c = xc.shape[1]
    hd = spec.head_dim
    _, _, qh, kvh = local_qkv_slices(spec, tp)
    rep = qh // kvh
    dev = xc.device
    t_max = cache.max_len
    positions = start + torch.arange(c, dtype=torch.int32, device=dev)
    h = rms_norm(layer["attn_norm"], xc)
    qf, kf, vf = tp_project_qkv(spec, tp, layer, h, dtype)
    q = rope(qf.reshape(1, c, qh, hd), positions[None])
    k = rope(kf.reshape(1, c, kvh, hd), positions[None])
    v = vf.reshape(1, c, kvh, hd)
    kq, kscale = _quantize_kv(k[0])
    vq, vscale = _quantize_kv(v[0])
    row_ck, row_cv = cache.k[li][slot], cache.v[li][slot]              # [T, Hkv_l, D]
    row_cks, row_cvs = cache.k_scale[li][slot], cache.v_scale[li][slot]
    row_ck[start:start + c] = kq
    row_cv[start:start + c] = vq
    row_cks[start:start + c] = kscale
    row_cvs[start:start + c] = vscale
    if fused:
        from ..ops.prefill_attention import chunk_prefill_attention

        attn = chunk_prefill_attention(q[0], row_ck, row_cv, row_cks, row_cvs, k[0], v[0],
                                       start, rep=rep, out_dtype=dtype).reshape(1, c, qh * hd)
    else:
        inv = 1.0 / math.sqrt(hd)
        key_pos = torch.arange(t_max, device=dev)
        past_mask = (key_pos[None, :] < start)[None, None]
        cur_mask = torch.ones((c, c), dtype=torch.bool, device=dev).tril()[None, None]
        row_k = _dequantize_kv(row_ck, row_cks, dtype).repeat_interleave(rep, dim=1)[None]
        row_v = _dequantize_kv(row_cv, row_cvs, dtype).repeat_interleave(rep, dim=1)[None]
        qf32 = q.to(torch.float32)
        s_past = torch.einsum("bqhd,bkhd->bhqk", qf32, row_k.to(torch.float32)) * inv
        s_past = torch.where(past_mask, s_past, torch.full_like(s_past, -1e9))
        kc = k.repeat_interleave(rep, dim=2)
        vc = v.repeat_interleave(rep, dim=2)
        s_cur = torch.einsum("bqhd,bkhd->bhqk", qf32, kc.to(torch.float32)) * inv
        s_cur = torch.where(cur_mask, s_cur, torch.full_like(s_cur, -1e9))
        probs = _softmax_cast(torch.cat([s_past, s_cur], dim=-1), dtype)
        p_past, p_cur = probs[..., :t_max], probs[..., t_max:]
        attn = torch.einsum("bhqk,bkhd->bqhd", p_past, row_v.to(torch.float32))
        attn = attn + torch.einsum("bhqk,bkhd->bqhd", p_cur, vc.to(torch.float32))
        attn = attn.reshape(1, c, qh * hd)
    xc = xc + tp_attn_out(mesh, layer, attn.to(dtype), dtype)
    h = rms_norm(layer["mlp_norm"], xc)
    return xc + tp_mlp_block(mesh, spec, layer, h, dtype)


def pipelined_prefill(spec, params, cache: KVCache, ids: torch.Tensor, length: int,
                      slot: int, mesh, dtype=torch.bfloat16, num_chunks: int = 0):
    """This rank's part of a pipelined prefill of one prompt: ``ids`` int
    [P] padded, ``length`` its true length and ``slot`` its slot (host
    ints, the same on every rank). Chunks of P / C rows flow through the
    stages in order; the last stage sends stage 0 only the hidden state
    of row ``length - 1``. Sets ``lengths[slot]`` on every rank and returns
    (cache, last_logits f32 [vocab]) on stage 0, (cache, None) elsewhere."""
    stages = validate_pipe_mesh(mesh)
    tp = mesh.size(MODEL_AXIS)
    validate_decoder_tp(spec, tp)
    p = ids.shape[0]
    n_chunks = num_chunks or stages
    if p % n_chunks != 0:
        raise ValueError(
            f"prefill bucket ({p}) not divisible by pipeline chunks ({n_chunks})"
        )
    c = p // n_chunks
    dev = ids.device
    fused = _use_fused_prefill_attention(spec, cache.max_len, ids, min_seq=512)
    layers = _local_layers(params)
    stage = mesh.stage
    ring = PipeRing(mesh)
    x = embed(mesh, params, ids[None, :], dtype) if stage == 0 else None   # [1, P, H]
    last_chunk, last_row = divmod(length - 1, c)
    for ci in range(n_chunks):
        start = ci * c
        xc = x[:, start:start + c] if stage == 0 else ring.recv((1, c, spec.hidden), dtype, dev)
        for li, layer in enumerate(layers):
            xc = _chunk_layer(mesh, spec, tp, layer, li, xc, cache, slot, start, fused, dtype)
        if stage < stages - 1:
            ring.send(xc)
        elif ci == last_chunk:
            ring.send(xc[:, last_row])
    last = ring.recv((1, spec.hidden), dtype, dev) if stage == 0 else None
    ring.wait()
    cache.lengths[slot] = length
    if last is None:
        return cache, None
    return cache, head(mesh, params, last, dtype)[0]
