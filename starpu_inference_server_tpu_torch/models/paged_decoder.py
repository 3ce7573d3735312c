"""Paged (block) INT8 KV cache for decoder serving.

Counterpart of ``starpu_inference_server_tpu/models/paged_decoder.py``:
a global POOL of fixed-size pages per layer plus a per-slot page table
replaces the dense ``[S, max_len]`` rows, so device memory is sized by
the pool and a request holds only the pages it needs.

- ``k``/``v`` pools are per-layer int8 ``[N, page, H_kv, D]`` (scales f32
  ``[N, page, H_kv]``), or in the FLAT layout int8 ``[N, page, H_kv*D]``
  (scales f32 ``[N, H_kv, page]``: one head's scales of a page are
  contiguous);
- ``table`` int32 ``[S, max_pages]`` maps a slot's logical page to a pool
  page; the engine's host-side allocator fills it;
- pool page 0 is the GARBAGE page: unallocated table entries point at
  it and inactive slots park their discarded writes there.

Numbers are the dense path's: the same int8 round trip, masks and
write-before-attend order. Decode and verify attention read the pool
through the table (the CUDA kernels of ``ops/decode_attention.py`` where
the kernel gate is open, a gather of the slot's logical rows elsewhere);
prefill attention is plain torch, as the JAX package leaves it to XLA.

As in ``models/decoder.py``, the pools are updated IN PLACE. Writes go
row by row to (``table[slot, pos // page]``, ``pos % page``), so no host
sync reads the table; a row past the slot's last logical page (padding
of a chunk that runs past ``max_len``) goes to the garbage page.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

from ..monitoring.trace import device_range
from ..ops import nn
from ..ops.decode_attention import (
    gather_flat_scale_pages,
    gather_pages,
    paged_decode_attention,
    paged_window_decode_attention,
)
from .decoder import (
    DecoderSpec,
    _dequantize_kv,
    _f32,
    _flat_rows,
    _mlp_block,
    _project_qkv,
    _quantize_kv,
    _softmax_cast,
    _std_kv_view,
    rms_norm,
    rope,
)


@dataclasses.dataclass
class PagedKVCache:
    """Per-layer page pools (``k``/``v`` int8 [N, page, H_kv, D],
    ``k_scale``/``v_scale`` f32 [N, page, H_kv]; FLAT: [N, page, H_kv*D]
    and [N, H_kv, page]), the page table int32 [S, max_pages] and
    ``lengths`` int32 [S]. Updated in place."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    k_scale: List[torch.Tensor]
    v_scale: List[torch.Tensor]
    table: torch.Tensor
    lengths: torch.Tensor

    @property
    def flat(self) -> bool:
        return self.k[0].dim() == 3

    @property
    def num_slots(self) -> int:
        return self.table.shape[0]

    @property
    def page_size(self) -> int:
        return self.k[0].shape[1]

    @property
    def num_pages(self) -> int:
        return self.k[0].shape[0]

    @property
    def max_len(self) -> int:
        return self.table.shape[1] * self.page_size


def init_paged_cache(spec: DecoderSpec, num_slots: int, max_len: int, num_pages: int,
                     page_size: int = 128, device="cpu", flat: bool = False) -> PagedKVCache:
    """``num_pages`` INCLUDES the reserved garbage page 0 (the allocator
    hands out 1..num_pages-1). ``flat`` selects the FLAT pool layout."""
    if max_len % page_size != 0:
        raise ValueError(f"max_len ({max_len}) % page_size ({page_size}) != 0")
    if num_pages < 2:
        raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
    if flat:
        shape = (num_pages, page_size, spec.kv_heads * spec.head_dim)
        sshape = (num_pages, spec.kv_heads, page_size)
    else:
        shape = (num_pages, page_size, spec.kv_heads, spec.head_dim)
        sshape = shape[:-1]

    def zeros(shp, dt):
        return [torch.zeros(shp, dtype=dt, device=device) for _ in range(spec.layers)]

    return PagedKVCache(
        k=zeros(shape, torch.int8),
        v=zeros(shape, torch.int8),
        k_scale=zeros(sshape, torch.float32),
        v_scale=zeros(sshape, torch.float32),
        table=torch.zeros((num_slots, max_len // page_size), dtype=torch.int32, device=device),
        lengths=torch.zeros((num_slots,), dtype=torch.int32, device=device),
    )


def set_table_row(cache: PagedKVCache, slot: int, row) -> PagedKVCache:
    """Install a slot's page mapping (``row`` int [max_pages], unallocated
    tail = 0), before the prefill that writes through it."""
    cache.table[slot] = torch.as_tensor(row, dtype=torch.int32, device=cache.table.device)
    return cache


def _gather_std(spec: DecoderSpec, cache: PagedKVCache, li: int, dtype, table=None):
    """Logical [S, T, H_kv, D] dequantized K/V of layer ``li`` through
    ``table`` (default the cache's: every slot), in either pool layout."""
    table = cache.table if table is None else table
    if cache.flat:
        k = _dequantize_kv(_std_kv_view(spec, gather_pages(cache.k[li], table)),
                           gather_flat_scale_pages(cache.k_scale[li], table), dtype)
        v = _dequantize_kv(_std_kv_view(spec, gather_pages(cache.v[li], table)),
                           gather_flat_scale_pages(cache.v_scale[li], table), dtype)
        return k, v
    k = _dequantize_kv(gather_pages(cache.k[li], table),
                       gather_pages(cache.k_scale[li], table), dtype)
    v = _dequantize_kv(gather_pages(cache.v[li], table),
                       gather_pages(cache.v_scale[li], table), dtype)
    return k, v


def _row_targets(cache: PagedKVCache, slots: torch.Tensor, positions: torch.Tensor):
    """(pool page, row in page) of logical ``positions`` of ``slots``
    (broadcast together); positions past the last logical page map to the
    garbage page 0."""
    page = cache.page_size
    max_pages = cache.table.shape[1]
    pidx = positions.to(torch.int64) // page
    pid = cache.table[slots.to(torch.int64), pidx.clamp(max=max_pages - 1)].to(torch.int64)
    pid = torch.where(pidx < max_pages, pid, torch.zeros_like(pid))
    return pid, positions.to(torch.int64) % page


def _write_rows(cache: PagedKVCache, li: int, pid, off, kq, vq, kscale, vscale) -> None:
    """Rows ``kq``/``vq`` [..., H_kv, D] and scales [..., H_kv] to pool
    rows (``pid``, ``off``), index tensors of the rows' leading shape."""
    if cache.flat:
        cache.k[li][pid, off] = _flat_rows(kq)
        cache.v[li][pid, off] = _flat_rows(vq)
        # advanced indices around a slice put their dims first: [..., H_kv]
        cache.k_scale[li][pid, :, off] = kscale
        cache.v_scale[li][pid, :, off] = vscale
        return
    cache.k[li][pid, off] = kq
    cache.v[li][pid, off] = vq
    cache.k_scale[li][pid, off] = kscale
    cache.v_scale[li][pid, off] = vscale


def _use_fused_paged_attention(spec: DecoderSpec, page_size: int, ref: torch.Tensor) -> bool:
    """On the card the paged kernels take any page (shapes outside their
    own limits raise in the wrapper). Where the kernel routes are forced
    on CPU tensors, the JAX package's gate (``paged_decoder.py:568``)
    applies, so parity tests route as JAX does: its TPU kernels tile one
    page per step, so the page is a multiple of 128 rows."""
    if not nn.use_kernels(ref) or spec.q_heads % spec.kv_heads:
        return False
    return ref.is_cuda or (spec.head_dim >= 64 and page_size % 128 == 0)


# -- prefill (bucket path): a whole padded prompt into one slot -------------

def paged_prefill(spec: DecoderSpec, params, cache: PagedKVCache, ids: torch.Tensor,
                  length: int, slot: int, dtype):
    """Paged ``decoder.prefill``: the same compute, the prompt's KV lands
    in the slot's pages. ``length`` and ``slot`` are host ints. Returns
    (cache, last_logits f32 [vocab])."""
    p = ids.shape[0]
    dev = ids.device
    positions = torch.arange(p, dtype=torch.int32, device=dev)
    x = nn.embedding(params["embed"], ids[None, :], dtype)
    valid = positions < length
    causal = (torch.ones((p, p), dtype=torch.bool, device=dev).tril() & valid[None, :])[None, None]
    rep = spec.rep
    pid, off = _row_targets(cache, torch.full_like(positions, slot), positions)
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(layer["attn_norm"], x)
        qf, kf, vf = _project_qkv(spec, layer, h, dtype)
        q = rope(qf.reshape(1, p, spec.q_heads, spec.head_dim), positions[None])
        k = rope(kf.reshape(1, p, spec.kv_heads, spec.head_dim), positions[None])
        v = vf.reshape(1, p, spec.kv_heads, spec.head_dim)
        kq, kscale = _quantize_kv(k[0])
        vq, vscale = _quantize_kv(v[0])
        _write_rows(cache, li, pid, off, kq, vq, kscale, vscale)
        with device_range("ops.attn"):
            # in-prompt attention needs no cache read
            kr = k.repeat_interleave(rep, dim=2)
            vr = v.repeat_interleave(rep, dim=2)
            logits = torch.einsum("bqhd,bkhd->bhqk", _f32(q), _f32(kr)) / math.sqrt(spec.head_dim)
            logits = torch.where(causal, logits, torch.full_like(logits, -1e9))
            probs = _softmax_cast(logits, dtype)
            attn = torch.einsum("bhqk,bkhd->bqhd", probs, _f32(vr))
            attn = attn.reshape(1, p, spec.q_heads * spec.head_dim).to(dtype)
        x = x + nn.dense(layer["attn"]["o"], attn, dtype)
        h = rms_norm(layer["mlp_norm"], x)
        x = x + _mlp_block(spec, layer, h, dtype)
    cache.lengths[slot] = length
    x = rms_norm(params["final_norm"], x)
    logits = nn.dense(params["lm_head"], x[0, length - 1][None, :], dtype)[0]
    return cache, logits.to(torch.float32)


# -- chunked prefill ---------------------------------------------------------

def paged_prefill_chunk(spec: DecoderSpec, params, cache: PagedKVCache, ids: torch.Tensor,
                        start: int, valid: int, slot: int, dtype):
    """Paged ``decoder.prefill_chunk``: ``C`` prompt tokens at positions
    start..start+C-1 (C a multiple of the page, ``start`` page-aligned, as
    the engine guarantees). Keys before ``start`` are read back through
    the table; the in-chunk keys stay at compute precision, causally
    masked. Returns (cache, logits f32 [vocab]) of chunk row
    ``valid-1``."""
    c = ids.shape[0]
    page = cache.page_size
    if c % page or start % page:
        raise ValueError(f"chunk {c} at {start} is not page-aligned (page {page})")
    dev = ids.device
    t_max = cache.max_len
    positions = start + torch.arange(c, dtype=torch.int32, device=dev)
    x = nn.embedding(params["embed"], ids[None, :], dtype)
    key_pos = torch.arange(t_max, device=dev)
    past_mask = (key_pos[None, :] < start)[None, None]
    cur_mask = torch.ones((c, c), dtype=torch.bool, device=dev).tril()[None, None]
    inv = 1.0 / math.sqrt(spec.head_dim)
    rep = spec.rep
    pid, off = _row_targets(cache, torch.full_like(positions, slot), positions)
    row = cache.table[slot:slot + 1]
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(layer["attn_norm"], x)
        qf, kf, vf = _project_qkv(spec, layer, h, dtype)
        q = rope(qf.reshape(1, c, spec.q_heads, spec.head_dim), positions[None])
        k = rope(kf.reshape(1, c, spec.kv_heads, spec.head_dim), positions[None])
        v = vf.reshape(1, c, spec.kv_heads, spec.head_dim)
        kq, kscale = _quantize_kv(k[0])
        vq, vscale = _quantize_kv(v[0])
        _write_rows(cache, li, pid, off, kq, vq, kscale, vscale)
        with device_range("ops.attn"):  # the past read back through the table
            row_k, row_v = _gather_std(spec, cache, li, dtype, row)
            row_k = row_k.repeat_interleave(rep, dim=2)
            row_v = row_v.repeat_interleave(rep, dim=2)
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
            attn = attn.reshape(1, c, spec.q_heads * spec.head_dim).to(dtype)
        x = x + nn.dense(layer["attn"]["o"], attn, dtype)
        h = rms_norm(layer["mlp_norm"], x)
        x = x + _mlp_block(spec, layer, h, dtype)
    cache.lengths[slot] = start + valid
    x = rms_norm(params["final_norm"], x)
    logits = nn.dense(params["lm_head"], x[0, valid - 1][None, :], dtype)[0]
    return cache, logits.to(torch.float32)


# -- decode -------------------------------------------------------------------

def paged_decode_step(spec: DecoderSpec, params, cache: PagedKVCache, ids: torch.Tensor,
                      active: torch.Tensor, dtype):
    """Paged ``decoder.decode_step``: the new token's KV goes through the
    table (inactive slots park it in garbage page 0), attention reads the
    pool through the table. Returns (cache, logits f32 [S, vocab])."""
    s = ids.shape[0]
    dev = ids.device
    page = cache.page_size
    positions = cache.lengths.clone()
    x = nn.embedding(params["embed"], ids[:, None], dtype)
    t_max = cache.max_len
    key_pos = torch.arange(t_max, device=dev)[None, :]
    mask = (key_pos <= positions.to(torch.int64)[:, None])[:, None, None, :]
    pid, off = _row_targets(cache, torch.arange(s, device=dev), positions)
    pid = torch.where(active, pid, torch.zeros_like(pid))
    off = torch.where(active, off, torch.zeros_like(off))
    rep = spec.rep
    fused = _use_fused_paged_attention(spec, page, ids)
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(layer["attn_norm"], x)
        qf, kf, vf = _project_qkv(spec, layer, h, dtype)
        q = rope(qf.reshape(s, 1, spec.q_heads, spec.head_dim), positions[:, None])
        k = rope(kf.reshape(s, 1, spec.kv_heads, spec.head_dim), positions[:, None])
        v = vf.reshape(s, 1, spec.kv_heads, spec.head_dim)
        kq, kscale = _quantize_kv(k[:, 0])
        vq, vscale = _quantize_kv(v[:, 0])
        _write_rows(cache, li, pid, off, kq, vq, kscale, vscale)
        if fused:
            attn = paged_decode_attention(
                q[:, 0], cache.k[li], cache.v[li], cache.k_scale[li], cache.v_scale[li],
                cache.table, positions, rep=rep,
            ).reshape(s, 1, spec.q_heads * spec.head_dim).to(dtype)
        else:
            k_all, v_all = _gather_std(spec, cache, li, dtype)
            k_all = k_all.repeat_interleave(rep, dim=2)
            v_all = v_all.repeat_interleave(rep, dim=2)
            logits = torch.einsum("sqhd,skhd->shqk", _f32(q), _f32(k_all)) / math.sqrt(spec.head_dim)
            logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
            probs = _softmax_cast(logits, dtype)
            attn = torch.einsum("shqk,skhd->sqhd", probs, _f32(v_all)).reshape(
                s, 1, spec.q_heads * spec.head_dim).to(dtype)
        x = x + nn.dense(layer["attn"]["o"], attn, dtype)
        h = rms_norm(layer["mlp_norm"], x)
        x = x + _mlp_block(spec, layer, h, dtype)
    x = rms_norm(params["final_norm"], x)
    logits = nn.dense(params["lm_head"], x[:, 0], dtype).to(torch.float32)
    cache.lengths.copy_(torch.where(active, positions + 1, positions))
    return cache, logits


# -- verify (speculative decoding) --------------------------------------------

def paged_verify_step(spec: DecoderSpec, params, cache: PagedKVCache, ids: torch.Tensor,
                      active: torch.Tensor, dtype):
    """Paged ``decoder.verify_step``: the W in-window rows go through the
    table (a window may cross a page boundary); ``lengths`` is NOT
    advanced (the caller commits). Returns (cache, logits f32
    [S, W, vocab])."""
    s, w = ids.shape
    dev = ids.device
    page = cache.page_size
    start = cache.lengths.clone()
    positions = start[:, None] + torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    x = nn.embedding(params["embed"], ids, dtype)
    t_max = cache.max_len
    key_pos = torch.arange(t_max, device=dev)
    mask = key_pos[None, None, None, :] <= positions.to(torch.int64)[:, None, :, None]
    pid, off = _row_targets(cache, torch.arange(s, device=dev)[:, None], positions)
    pid = torch.where(active[:, None], pid, torch.zeros_like(pid))
    off = torch.where(active[:, None], off, torch.zeros_like(off))
    inv = 1.0 / math.sqrt(spec.head_dim)
    rep = spec.rep
    fused = _use_fused_paged_attention(spec, page, ids)
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(layer["attn_norm"], x)
        qf, kf, vf = _project_qkv(spec, layer, h, dtype)
        q = rope(qf.reshape(s, w, spec.q_heads, spec.head_dim), positions)
        k = rope(kf.reshape(s, w, spec.kv_heads, spec.head_dim), positions)
        v = vf.reshape(s, w, spec.kv_heads, spec.head_dim)
        kq, kscale = _quantize_kv(k)
        vq, vscale = _quantize_kv(v)
        _write_rows(cache, li, pid, off, kq, vq, kscale, vscale)
        if fused:
            attn = paged_window_decode_attention(
                q, cache.k[li], cache.v[li], cache.k_scale[li], cache.v_scale[li],
                cache.table, start, rep=rep,
            ).reshape(s, w, spec.q_heads * spec.head_dim).to(dtype)
        else:
            k_all, v_all = _gather_std(spec, cache, li, dtype)
            k_all = k_all.repeat_interleave(rep, dim=2)
            v_all = v_all.repeat_interleave(rep, dim=2)
            logits = torch.einsum("swhd,skhd->shwk", _f32(q), _f32(k_all)) * inv
            logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
            probs = _softmax_cast(logits, dtype)
            attn = torch.einsum("shwk,skhd->swhd", probs, _f32(v_all)).reshape(
                s, w, spec.q_heads * spec.head_dim).to(dtype)
        x = x + nn.dense(layer["attn"]["o"], attn, dtype)
        h = rms_norm(layer["mlp_norm"], x)
        x = x + _mlp_block(spec, layer, h, dtype)
    x = rms_norm(params["final_norm"], x)
    logits = nn.dense(params["lm_head"], x.reshape(s * w, -1), dtype)
    return cache, logits.reshape(s, w, spec.vocab).to(torch.float32)
