"""Fused INT8-KV decode attention: plain decode, verify windows, paged.

Each function replaces TPU kernels of
``starpu_inference_server_tpu/ops/decode_attention.py`` with a CUDA
kernel written by hand in ``csrc/``:

- ``decode_attention`` (``_grouped_kernel`` and ``_kernel``):
  ``csrc/decode_attention.cu``. One query row per slot against the dense
  cache.
- ``window_decode_attention`` (``_grouped_window_kernel`` and
  ``_window_kernel``): ``csrc/window_decode_attention.cu``. W query rows
  per slot (the speculative verify window); row ``w`` attends positions
  ``<= lengths[s] + w``.
- ``paged_decode_attention`` (``_paged_kernel``):
  ``csrc/paged_decode_attention.cu``. The decode function over a page
  pool ``[N, page, Hkv, D]`` read through a table ``[S, max_pages]``.
- ``paged_window_decode_attention`` (``_paged_window_kernel``):
  ``csrc/paged_window_decode_attention.cu``. The window function through
  the table; a window may cross a page.

Bound on the H100: device-memory bytes (the live int8 K/V rows and
scales, read once per call). Design: one block per (KV head, slot)
serves every query row of the head (``rep`` heads, times W for a
window), so each K/V byte is read once, and the chunk loop stops at the
last live position (see the sources; the last three share
``csrc/common.cuh:window_attention``).

Beside each, a ``*_plain`` function computes the same thing in plain
PyTorch: CPU tensors take it, and on the card it is only the reference
the kernel is checked against.

Standard cache layout only (the flat layout waits for a later slice):
``k``/``v`` int8 ``[S, T, Hkv, D]`` or pools ``[N, page, Hkv, D]``,
scales f32 ``[S, T, Hkv]`` or ``[N, page, Hkv]``.
"""

from __future__ import annotations

import math

import torch

from . import _build

launches = {"decode_attention": 0, "window_decode_attention": 0,
            "paged_decode_attention": 0, "paged_window_decode_attention": 0}

_fns = {}

# the window kernels' limits (csrc/common.cuh: kWinThreads * kWinMaxOut
# outputs per block)
_WINDOW_MAX_OUT = 16 * 256


def _bound(name: str, n_ptrs: int, n_ints: int):
    """The ctypes entry ``sis_<name>`` of ``csrc/<name>.cu``, bound once."""
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = _build.bind(name, f"sis_{name}", n_ptrs, n_ints)
    return fn


def decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale, lengths,
                           rep: int, out_dtype=None) -> torch.Tensor:
    """Dequantize, score in f32 (1/sqrt(D)), mask positions > lengths[s]
    with -1e30, softmax in f32, weighted sum of V. Output [S, Hq, D]."""
    s, hq, d = q.shape
    t = k_cache.shape[1]
    out_dtype = out_dtype or q.dtype
    k = k_cache.to(torch.float32) * k_scale.unsqueeze(-1)
    v = v_cache.to(torch.float32) * v_scale.unsqueeze(-1)
    k = k.repeat_interleave(rep, dim=2)  # [S, T, Hq, D]
    v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("shd,sthd->sht", q.to(torch.float32), k) / math.sqrt(d)
    pos = torch.arange(t, device=q.device)
    mask = pos[None, None, :] <= lengths.to(torch.int64)[:, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("sht,sthd->shd", probs, v).to(out_dtype)


def decode_attention(q, k_cache, v_cache, k_scale, v_scale, lengths,
                     rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, Hq, D] against the int8 cache; returns [S, Hq, D] in
    ``out_dtype`` (default q's). CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    s, hq, d = q.shape
    _, t, hkv, dk = k_cache.shape
    if hq != hkv * rep or dk != d:
        raise ValueError(f"q {tuple(q.shape)} vs cache {tuple(k_cache.shape)}, rep {rep}")
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale,
                                      lengths, rep, out_dtype)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention takes f32 or bf16 queries, got {q.dtype}")
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
        raise TypeError("decode_attention needs an int8 cache")
    if d % 16 or rep > 8 or rep * d > 1024:
        raise ValueError(f"decode_attention kernel needs D % 16 == 0, rep <= 8 and "
                         f"rep * D <= 1024 (D={d}, rep={rep})")
    tensors = [q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
               k_scale.to(torch.float32).contiguous(),
               v_scale.to(torch.float32).contiguous(),
               lengths.to(torch.int32).contiguous()]
    for a in tensors[1:3]:
        if a.data_ptr() % 16:
            raise ValueError("decode_attention needs 16-byte aligned K/V")
    out = torch.empty((s, hq, d), dtype=q.dtype, device=q.device)
    rc = _bound("decode_attention", 7, 6)(
        *(a.data_ptr() for a in tensors), out.data_ptr(), s, t, hkv, rep, d,
        _build.BF16 if q.dtype == torch.bfloat16 else _build.F32, _build.stream_ptr(q))
    _build.check(rc, "decode_attention")
    launches["decode_attention"] += 1
    return out if out_dtype == q.dtype else out.to(out_dtype)


# -- verify windows and paged caches ----------------------------------------

def window_decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale, lengths,
                                  rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, W, Hq, D]: dequantize, score in f32 (1/sqrt(D)), mask
    positions > lengths[s] + w with -1e30, softmax in f32, weighted sum
    of V. Output [S, W, Hq, D]."""
    s, w, hq, d = q.shape
    t = k_cache.shape[1]
    out_dtype = out_dtype or q.dtype
    k = (k_cache.to(torch.float32) * k_scale.unsqueeze(-1)).repeat_interleave(rep, dim=2)
    v = (v_cache.to(torch.float32) * v_scale.unsqueeze(-1)).repeat_interleave(rep, dim=2)
    logits = torch.einsum("swhd,sthd->swht", q.to(torch.float32), k) / math.sqrt(d)
    pos = torch.arange(t, device=q.device)
    last = lengths.to(torch.int64)[:, None] + torch.arange(w, device=q.device)[None, :]
    mask = pos[None, None, None, :] <= last[:, :, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("swht,sthd->swhd", probs, v).to(out_dtype)


def gather_pages(pool, table):
    """[N, page, ...] pool + [S, MP] table -> [S, MP * page, ...] logical
    rows (the paged decoder's plain route reads its cache through it)."""
    g = pool[table.to(torch.int64)]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def paged_window_decode_attention_plain(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                                        rep: int, out_dtype=None) -> torch.Tensor:
    """The window function on the slots' logical rows, gathered through
    the table."""
    return window_decode_attention_plain(
        q, gather_pages(k_pool, table), gather_pages(v_pool, table),
        gather_pages(k_scale, table), gather_pages(v_scale, table), lengths, rep, out_dtype)


def paged_decode_attention_plain(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                                 rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, Hq, D]: :func:`decode_attention_plain` on the slots' logical
    rows, gathered through the table."""
    return decode_attention_plain(
        q, gather_pages(k_pool, table), gather_pages(v_pool, table),
        gather_pages(k_scale, table), gather_pages(v_scale, table), lengths, rep, out_dtype)


def _window_args(name, q, w, rep, hkv, d, caches):
    """Checks shared by the three window kernels; returns the contiguous
    cache tensors and the dtype code."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes f32 or bf16 queries, got {q.dtype}")
    if caches[0].dtype != torch.int8 or caches[1].dtype != torch.int8:
        raise TypeError(f"{name} needs an int8 cache")
    if d % 16 or w * rep * d > _WINDOW_MAX_OUT:
        raise ValueError(f"{name} kernel needs D % 16 == 0 and W * rep * D <= "
                         f"{_WINDOW_MAX_OUT} (W={w}, rep={rep}, D={d})")
    out = [caches[0].contiguous(), caches[1].contiguous(),
           caches[2].to(torch.float32).contiguous(), caches[3].to(torch.float32).contiguous()]
    for a in out[:2]:
        if a.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned K/V")
    return out, _build.BF16 if q.dtype == torch.bfloat16 else _build.F32


def window_decode_attention(q, k_cache, v_cache, k_scale, v_scale, lengths,
                            rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, W, Hq, D] (row w at position lengths[s] + w, its KV already
    written) against the int8 cache; returns [S, W, Hq, D] in
    ``out_dtype`` (default q's). CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    s, w, hq, d = q.shape
    _, t, hkv, dk = k_cache.shape
    if hq != hkv * rep or dk != d:
        raise ValueError(f"q {tuple(q.shape)} vs cache {tuple(k_cache.shape)}, rep {rep}")
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return window_decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale, lengths,
                                             rep, out_dtype)
    caches, code = _window_args("window_decode_attention", q, w, rep, hkv, d,
                                (k_cache, v_cache, k_scale, v_scale))
    q = q.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    rc = _bound("window_decode_attention", 7, 7)(
        q.data_ptr(), *(a.data_ptr() for a in caches), lengths.data_ptr(), out.data_ptr(),
        s, t, w, hkv, rep, d, code, _build.stream_ptr(q))
    _build.check(rc, "window_decode_attention")
    launches["window_decode_attention"] += 1
    return out if out_dtype == q.dtype else out.to(out_dtype)


def paged_decode_attention(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                           rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, Hq, D] against the paged int8 cache (pools [N, page, Hkv, D],
    table [S, max_pages]); slot s attends logical positions <=
    lengths[s]. Returns [S, Hq, D]. CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    s, hq, d = q.shape
    _, page, hkv, dk = k_pool.shape
    if hq != hkv * rep or dk != d:
        raise ValueError(f"q {tuple(q.shape)} vs pool {tuple(k_pool.shape)}, rep {rep}")
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_pool, v_pool, k_scale, v_scale, table,
                                            lengths, rep, out_dtype)
    caches, code = _window_args("paged_decode_attention", q, 1, rep, hkv, d,
                                (k_pool, v_pool, k_scale, v_scale))
    q = q.contiguous()
    table = table.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    rc = _bound("paged_decode_attention", 8, 7)(
        q.data_ptr(), *(a.data_ptr() for a in caches), table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), s, table.shape[1], page, hkv, rep, d, code, _build.stream_ptr(q))
    _build.check(rc, "paged_decode_attention")
    launches["paged_decode_attention"] += 1
    return out if out_dtype == q.dtype else out.to(out_dtype)


def paged_window_decode_attention(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                                  rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, W, Hq, D] against the paged int8 cache: the window function
    through the table. Returns [S, W, Hq, D]. CUDA tensors launch the
    kernel, CPU tensors take the plain version."""
    s, w, hq, d = q.shape
    _, page, hkv, dk = k_pool.shape
    if hq != hkv * rep or dk != d:
        raise ValueError(f"q {tuple(q.shape)} vs pool {tuple(k_pool.shape)}, rep {rep}")
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return paged_window_decode_attention_plain(q, k_pool, v_pool, k_scale, v_scale, table,
                                                   lengths, rep, out_dtype)
    caches, code = _window_args("paged_window_decode_attention", q, w, rep, hkv, d,
                                (k_pool, v_pool, k_scale, v_scale))
    q = q.contiguous()
    table = table.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    rc = _bound("paged_window_decode_attention", 8, 8)(
        q.data_ptr(), *(a.data_ptr() for a in caches), table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), s, table.shape[1], page, w, hkv, rep, d, code, _build.stream_ptr(q))
    _build.check(rc, "paged_window_decode_attention")
    launches["paged_window_decode_attention"] += 1
    return out if out_dtype == q.dtype else out.to(out_dtype)
